"""Preconditioned conjugate gradients, the port of :func:`fcvm_tpu.ops.solver.pcg`.

The JAX solver runs its Krylov loop on the device in ``lax.while_loop``.
Here the loop is a Python loop that reads the residual norm on the host
every iteration: the same update order and the same ``rnorm > tol`` test,
so an f64 solve takes exactly the JAX package's iteration count.  The
per-iteration host sync is the price; a sync-free loop is ROADMAP Queue 2
item K6.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    relres: float


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
        rz = rz_new
        rnorm = float(norm(r))
        k += 1
        if rnorm < 0.999 * best:
            since = 0
        else:
            since += 1
        best = min(best, rnorm)
    return CGResult(x, k, rnorm / (bnorm if bnorm != 0.0 else 1.0))
