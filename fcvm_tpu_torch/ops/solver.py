"""Preconditioned conjugate gradients, the port of :func:`fcvm_tpu.ops.solver.pcg`.

The JAX solver runs its Krylov loop on the device in ``lax.while_loop``.
Here the loop is a Python loop that reads the residual norm on the host
every iteration: the same update order and the same ``rnorm > tol`` test,
so an f64 solve takes exactly the JAX package's iteration count.  The
per-iteration host sync is the price; a sync-free loop is ROADMAP Queue 2
item K6.  :func:`pcg_harvest` runs the same iteration and keeps its Lanczos
byproducts for Ritz deflation (:mod:`fcvm_tpu_torch.ops.deflation`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    relres: float


class HarvestData(NamedTuple):
    """Lanczos byproducts of a PCG solve (see :mod:`fcvm_tpu_torch.ops.deflation`).

    Slots beyond ``min(iters, nstore - 2)`` may be overwritten when the solve
    runs longer than the buffer; ``ritz_coefficients`` reads only the valid
    prefix."""

    zs: torch.Tensor  # (nstore, n) preconditioned residuals z_j
    rzs: torch.Tensor  # (nstore,) r_j^T z_j
    alphas: torch.Tensor  # (nstore,) CG step lengths
    betas: torch.Tensor  # (nstore,) CG direction updates


def pcg(
    matvec: Callable,
    b: torch.Tensor,
    precond: Optional[Callable] = None,
    x0: Optional[torch.Tensor] = None,
    rtol: float = 1.0e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    stall: int = 0,
    dot: Optional[Callable] = None,
) -> CGResult:
    """Solve ``matvec(x) = b`` by preconditioned conjugate gradients.

    Stops when ``||r|| <= max(rtol ||b||, atol)`` or after ``maxiter``
    iterations.  ``stall > 0`` adds a stagnation exit: stop once the
    residual norm has not improved by more than 0.1% for ``stall``
    consecutive iterations, armed only once ``||r|| < 1e-3 ||b||``.
    ``dot`` overrides the inner product (default ``torch.dot``).
    """
    return _pcg(matvec, b, precond, x0, rtol, atol, maxiter, stall, dot)


def pcg_harvest(
    matvec: Callable,
    b: torch.Tensor,
    precond: Optional[Callable] = None,
    x0: Optional[torch.Tensor] = None,
    rtol: float = 1.0e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    nstore: int = 64,
    stall: int = 0,
):
    """:func:`pcg` that also records its Lanczos byproducts.

    The same iteration; it also stores the first ``nstore`` preconditioned
    residuals and the alpha/beta coefficients (slot ``min(k, nstore - 1)``,
    as the JAX package clamps them), from which the caller extracts Ritz
    vectors.  Returns ``(CGResult, HarvestData)``.
    """
    h = HarvestData(
        torch.zeros((nstore, b.shape[0]), dtype=b.dtype, device=b.device),
        torch.zeros(nstore, dtype=b.dtype, device=b.device),
        torch.zeros(nstore, dtype=b.dtype, device=b.device),
        torch.zeros(nstore, dtype=b.dtype, device=b.device),
    )
    cap = nstore - 1

    def record(j, z, rz, alpha=None, beta=None):
        h.zs[min(j, cap)] = z
        h.rzs[min(j, cap)] = rz
        if j > 0:
            h.alphas[min(j - 1, cap)] = alpha
            h.betas[min(j - 1, cap)] = beta

    return _pcg(matvec, b, precond, x0, rtol, atol, maxiter, stall, None, record), h


def _pcg(matvec, b, precond, x0, rtol, atol, maxiter, stall, dot, record=None) -> CGResult:
    """The loop of :func:`pcg`.  ``record(j, z_j, r_j^T z_j, alpha, beta)``,
    when given, sees each preconditioned residual with the step length and
    direction update that produced it (none for ``j = 0``)."""
    if precond is None:
        precond = lambda r: r  # noqa: E731
    if dot is None:
        dot = torch.dot
        norm = torch.linalg.vector_norm
    else:
        def norm(v):
            return torch.sqrt(dot(v, v))

    bnorm = float(norm(b))
    tol = max(rtol * bnorm, atol)
    stall_lim = int(stall) if stall and stall > 0 else int(maxiter) + 1
    stall_gate = 1.0e-3 * bnorm

    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - matvec(x) if x0 is not None else b.clone()
    z = precond(r)
    p = z
    rz = dot(r, z)
    if record is not None:
        record(0, z, rz)
    rnorm = float(norm(r))
    best, since, k = rnorm, 0, 0
    while rnorm > tol and k < maxiter and not (since >= stall_lim and rnorm < stall_gate):
        ap = matvec(p)
        pap = dot(p, ap)
        alpha = rz / torch.where(pap == 0.0, torch.ones_like(pap), pap)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz == 0.0, torch.ones_like(rz), rz)
        p = z + beta * p
        if record is not None:
            record(k + 1, z, rz_new, alpha, beta)
        rz = rz_new
        rnorm = float(norm(r))
        k += 1
        if rnorm < 0.999 * best:
            since = 0
        else:
            since += 1
        best = min(best, rnorm)
    return CGResult(x, k, rnorm / (bnorm if bnorm != 0.0 else 1.0))
