"""Dof-vector padding to a multiple of 384 dofs.

The padding came from TPU gather/scatter alignment; the port keeps it for
now because it fixes the Morton cluster partition and the coarse dimension
of the two-level preconditioner (``ops/precond.py``), so the port and the
JAX package solve with the same coarse space and their f64 runs take equal
CG iteration counts.  Padding dofs carry ``fixmask = 0`` and zero loads, so
they behave as decoupled identity rows of ``K_hat``.
"""

from __future__ import annotations

import numpy as np

DOF_ALIGN = 384


def pad_ndof(ndof: int) -> int:
    return -(-ndof // DOF_ALIGN) * DOF_ALIGN


def pad_vector(v: np.ndarray, ndof_pad: int, fill=0.0) -> np.ndarray:
    out = np.full(ndof_pad, fill, dtype=v.dtype)
    out[: len(v)] = v
    return out
