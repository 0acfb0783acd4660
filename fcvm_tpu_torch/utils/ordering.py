"""Locality-preserving node ordering (host-side, one-time per mesh).

The two-level preconditioner aggregates *index-contiguous* node ranges into
clusters (:mod:`fcvm_tpu_torch.ops.precond`), so the node numbering is part
of the solver: a Morton (Z-order) numbering makes every contiguous range a
spatially compact blob, whose cluster modes approximate the smooth error
well.
"""

from __future__ import annotations

import numpy as np


def morton_perm(coords: np.ndarray, bits: int = 16) -> np.ndarray:
    """Permutation sorting nodes by 3D Morton (Z-order) code.

    Returns ``perm`` such that ``coords[perm]`` is Z-ordered;
    ``bits`` quantization bits per axis (16 -> 48-bit codes).
    """
    c = np.asarray(coords, dtype=np.float64)
    lo = c.min(axis=0)
    span = float(max((c - lo).max(), 1e-300))
    q = np.minimum(((c - lo) / span * ((1 << bits) - 1)).astype(np.int64), (1 << bits) - 1)
    code = np.zeros(len(q), dtype=np.int64)
    for b in range(bits):
        code |= ((q[:, 0] >> b) & 1) << (3 * b + 2)
        code |= ((q[:, 1] >> b) & 1) << (3 * b + 1)
        code |= ((q[:, 2] >> b) & 1) << (3 * b)
    return np.argsort(code, kind="stable")
