"""Closed-form batched 3x3 determinant and inverse.

The same cofactor formulas as the reference's hand-unrolled numba code
(``source code/fcVM.py:436-453``), batched over arbitrary leading
dimensions.  Kept closed-form (not ``torch.linalg``) so the port rounds like
the JAX package does.
"""

from __future__ import annotations

import torch


def det3(a: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3), cofactor expansion (``fcVM.py:436-441``)."""
    return (
        a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
        - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
        + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
        - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
        + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
        - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2]
    )


def inv3(a: torch.Tensor, det=None):
    """Inverse of (..., 3, 3) via the adjugate (``fcVM.py:445-453``).

    Returns (inverse, determinant).
    """
    if det is None:
        det = det3(a)
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 2, 1] * a[..., 1, 2]
    c01 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c02 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c10 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 1, 0] * a[..., 0, 2] - a[..., 0, 0] * a[..., 1, 2]
    c20 = a[..., 1, 0] * a[..., 2, 1] - a[..., 2, 0] * a[..., 1, 1]
    c21 = a[..., 2, 0] * a[..., 0, 1] - a[..., 0, 0] * a[..., 2, 1]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 1, 0] * a[..., 0, 1]
    row0 = torch.stack([c00, c01, c02], dim=-1)
    row1 = torch.stack([c10, c11, c12], dim=-1)
    row2 = torch.stack([c20, c21, c22], dim=-1)
    inv = torch.stack([row0, row1, row2], dim=-2) / det[..., None, None]
    return inv, det


def inv3_spd(a: torch.Tensor) -> torch.Tensor:
    """Inverse of symmetric (..., 3, 3) blocks (preconditioner path)."""
    inv, _ = inv3(a)
    return inv
