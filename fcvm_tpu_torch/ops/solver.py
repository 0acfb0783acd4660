"""Preconditioned conjugate gradients, the port of :func:`fcvm_tpu.ops.solver.pcg`.

The JAX solver runs its Krylov loop on the device in ``lax.while_loop``, so
its convergence test never leaves the chip.  Here the vector work of each
iteration and that test are K6 (:func:`fcvm_tpu_torch.ops.kernels.cg_iteration`):
two passes, one after the caller's matvec and one after its preconditioner
apply, on a state of the solve's scalars that lives on its device.  The
loop queues ``CG_BATCH`` iterations at a time and reads the state on the
host once per batch: iterations queued after the test failed change nothing (each pass
leaves a finished column as it is), so results do not depend on
``CG_BATCH``; their count is kept in ``CG_STATS``.  The same update order
and tests as the JAX package, so an f64 solve takes exactly its iteration
count.  A deflation space (``defl=``, on a vector or a block) is folded
into K6's passes; a harvesting solve (:func:`pcg_harvest`) keeps the Lanczos byproducts for
Ritz deflation (:mod:`fcvm_tpu_torch.ops.deflation`) in K6's second pass.
:func:`pcg_block` runs ``m`` independent solves as the columns of one block,
the counterpart of the JAX package's ``vmap`` of :func:`pcg`: a finished
column is frozen within a batch and dropped from the block at the next
batch's start (on the CPU, where a read costs no sync, at every
iteration).  A solve with its own inner product (``dot=``, the sharded
backend's node-partitioned PCG) keeps a host loop that reads the residual
norm every iteration.

The scipy direct tier (:class:`ScipyDirectSolver`) assembles ``K_hat``
from the device's element blocks on the host and factorises it with
scipy's sparse LU, as the reference factorises its stiffness.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from fcvm_tpu_torch.ops import kernels

# iterations queued between two reads of the solve's state on the host; the
# value comes from the smoke's batch sweep on the card (PERF.md)
CG_BATCH = 8

# the device loop's counts since the last clear: solves, host reads of the
# state, iterations queued, and of those the idle ones (queued after the
# solve's test failed)
CG_STATS = Counter()


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


def _stall_lim(stall, maxiter) -> int:
    return int(stall) if stall and stall > 0 else int(maxiter) + 1


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
    defl=None,
) -> CGResult:
    """Solve ``matvec(x) = b`` by preconditioned conjugate gradients.

    Stops when ``||r|| <= max(rtol ||b||, atol)`` or after ``maxiter``
    iterations.  ``stall > 0`` adds a stagnation exit: stop once the
    residual norm has not improved by more than 0.1% for ``stall``
    consecutive iterations, armed only once ``||r|| < 1e-3 ||b||``.
    ``defl``, a :class:`fcvm_tpu_torch.ops.deflation.DeflationSpace`, adds
    its correction ``W K_w^+ W^T r`` to ``precond`` inside K6's passes.
    ``dot`` overrides the inner product (default ``torch.dot``) and takes
    the host loop (not with ``defl``).
    """
    if dot is not None:
        if defl is not None:
            raise ValueError("pcg: a custom dot takes the host loop, which has no folded "
                             "deflation; wrap precond with deflation.deflated instead")
        return _pcg_host(matvec, b, precond, x0, rtol, atol, maxiter, stall, dot)
    return _pcg_device(matvec, b, precond, x0, rtol, atol, maxiter, stall, defl, None)


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
    defl=None,
):
    """:func:`pcg` that also records its Lanczos byproducts.

    The same iteration; it also stores the first ``nstore`` preconditioned
    residuals and the alpha/beta coefficients (slot ``min(k, nstore - 1)``,
    as the JAX package clamps them), from which the caller extracts Ritz
    vectors.  Returns ``(CGResult, HarvestData)``.
    """
    zs = torch.zeros((nstore, b.shape[0]), dtype=b.dtype, device=b.device)
    coef = torch.zeros((3, nstore), dtype=b.dtype, device=b.device)  # rzs, alphas, betas
    res = _pcg_device(matvec, b, precond, x0, rtol, atol, maxiter, stall, defl, (zs, coef))
    return res, HarvestData(zs, coef[0], coef[1], coef[2])


def _relres(row) -> float:
    bn = row[kernels.SLOT_BNORM]
    return row[kernels.SLOT_RNORM] / (bn if bn != 0.0 else 1.0)


def _queue(plan, matvec, precond, x, r, p, count):
    """``count`` iterations of K6 around ``matvec`` and ``precond``, with no
    read of the device."""
    step = kernels.cg_iteration
    for _ in range(count):
        ap = matvec(p)
        step(0, plan, x, r, p, ap)
        step(1, plan, x, r, p, precond(r))
    CG_STATS["queued"] += count


def _start(plan, matvec, b, precond, x0):
    """x0, r0 = b - A x0, z0 = M r0 (deflated), p0 = z0, the state's start
    (||r0||, the tolerance, rz0) and the harvest's slot 0: K6's start form
    of both passes."""
    x = torch.zeros_like(b) if x0 is None else x0.clone(memory_format=torch.contiguous_format)
    r = b - matvec(x) if x0 is not None else b.clone()
    p = torch.empty_like(r)
    step = kernels.cg_iteration
    step(0, plan, x, r, r, r, start=True)
    step(1, plan, x, r, p, precond(r), start=True)
    CG_STATS["solves"] += 1
    return x, r, p


def _pcg_device(matvec, b, precond, x0, rtol, atol, maxiter, stall, defl, harvest):
    """The loop of :func:`pcg` and :func:`pcg_harvest` on K6: the state read
    once per batch of ``CG_BATCH`` iterations (each batch cut to what
    ``maxiter`` leaves)."""
    if precond is None:
        precond = lambda r: r  # noqa: E731
    b = b.contiguous()
    plan = kernels.cg_plan(b, rtol, atol, maxiter, _stall_lim(stall, maxiter),
                           None if defl is None else (defl.w, defl.kw_inv), harvest)
    x, r, p = _start(plan, matvec, b, precond, x0)
    last = None  # the last batch: k at its start, its count
    while True:
        (row,) = plan.read()
        CG_STATS["reads"] += 1
        k = int(row[kernels.SLOT_K])
        if last is not None:
            CG_STATS["idle"] += last[1] - (k - last[0])
        if not row[kernels.SLOT_NEXT]:
            return CGResult(x, k, _relres(row))
        count = min(CG_BATCH, int(maxiter) - k)
        _queue(plan, matvec, precond, x, r, p, count)
        last = (k, count)


class BlockCGResult(NamedTuple):
    x: torch.Tensor  # (n, m)
    iters: list  # per column
    relres: list  # per column


def pcg_block(
    matvec: Callable,
    b: torch.Tensor,
    precond: Optional[Callable] = None,
    x0: Optional[torch.Tensor] = None,
    rtol: float = 1.0e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    stall: int = 0,
    defl=None,
) -> BlockCGResult:
    """:func:`pcg` on each column of ``b`` (n, m), all columns at once.

    Column ``c`` follows exactly the iterates of ``pcg(matvec, b[:, c],
    ...)``: its own step length, direction update, convergence test and
    stagnation exit, and it is frozen once done.  ``matvec`` and
    ``precond`` take (n, m') blocks and act on each column as on a vector.
    K6 keeps a state a column on the device, read on the host once per
    batch of ``CG_BATCH`` iterations on the card, and after every iteration
    on the CPU, where the read costs no sync; the columns found done are
    then dropped from the block (``matvec`` and ``precond`` see the others
    only).  A block's width can change a column's rounding (a GEMM's
    blocking), so on the CPU a column leaves the block at the iteration it
    is done, as it always has.  More than ``CG_MAX_COLS`` columns run as
    several blocks, one after the other.  ``defl``, a
    :class:`fcvm_tpu_torch.ops.deflation.DeflationSpace` of at most
    ``CG_MAX_DEFL_BLOCK`` vectors, corrects every column's ``precond`` as
    :func:`fcvm_tpu_torch.ops.deflation.deflated` does, inside K6's passes
    (on the CPU with its products in that order: the same bits); a
    dropped column leaves the others deflated.
    """
    if b.dim() != 2:
        raise ValueError(f"pcg_block: b {tuple(b.shape)}; expected (n, m)")
    return _pcg_block(matvec, b, precond, x0, rtol, atol, maxiter, stall,
                      CG_BATCH if b.is_cuda else 1, defl)


def _pcg_block(matvec, b, precond, x0, rtol, atol, maxiter, stall, batch,
               defl=None) -> BlockCGResult:
    """The loop of :func:`pcg_block`: the states read once per ``batch``
    iterations, a column dropped from the block at the read that finds it
    done."""
    step = kernels.CG_MAX_COLS
    if b.shape[1] > step:
        parts = [_pcg_block(matvec, b[:, j:j + step].contiguous(), precond,
                            None if x0 is None else x0[:, j:j + step].contiguous(), rtol, atol,
                            maxiter, stall, batch, defl) for j in range(0, b.shape[1], step)]
        return BlockCGResult(torch.cat([q.x for q in parts], dim=1),
                             sum((q.iters for q in parts), []),
                             sum((q.relres for q in parts), []))
    if precond is None:
        precond = lambda r: r  # noqa: E731
    m = b.shape[1]
    b = b.contiguous()
    plan = kernels.cg_plan(b, rtol, atol, maxiter, _stall_lim(stall, maxiter),
                           None if defl is None else (defl.w, defl.kw_inv))
    x, r, p = _start(plan, matvec, b, precond, x0)
    out = x  # the solutions: a column is written back when it leaves the block
    cols = list(range(m))  # the block's columns, by their index in b
    iters, relres = [0] * m, [0.0] * m
    last = None
    while True:
        rows = plan.read()
        CG_STATS["reads"] += 1
        k = None
        for c, row in zip(cols, rows):
            iters[c], relres[c] = int(row[kernels.SLOT_K]), _relres(row)
            if row[kernels.SLOT_NEXT]:
                k = iters[c]  # every running column has taken the same iterations
        if last is not None:  # block iterations in which no column ran
            CG_STATS["idle"] += last[1] - max(iters[c] - last[0] for c in cols)
        keep = [i for i, row in enumerate(rows) if row[kernels.SLOT_NEXT]]
        if len(keep) < len(cols):
            if x is not out:
                done = [i for i in range(len(cols)) if i not in keep]
                out[:, [cols[i] for i in done]] = x[:, done]
            if not keep:
                return BlockCGResult(out, iters, relres)
            sel = torch.as_tensor(keep, device=b.device)
            x, r, p = (t.index_select(1, sel) for t in (x, r, p))
            plan = plan.select(keep)
            cols = [cols[i] for i in keep]
        count = min(batch, int(maxiter) - k)
        _queue(plan, matvec, precond, x, r, p, count)
        last = (k, count)


def _pcg_host(matvec, b, precond, x0, rtol, atol, maxiter, stall, dot) -> CGResult:
    """The loop of :func:`pcg` with a custom inner product: torch vector work
    and the residual norm read on the host every iteration."""
    if precond is None:
        precond = lambda r: r  # noqa: E731

    def norm(v):
        return torch.sqrt(dot(v, v))

    bnorm = float(norm(b))
    tol = max(rtol * bnorm, atol)
    stall_lim = _stall_lim(stall, maxiter)
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


# ---------------------------------------------------------------------------
# Host-side scipy direct tier
# ---------------------------------------------------------------------------


def assemble_scipy_csc(esm, eldofs, fixmask, ndof):
    """``K_hat`` as a scipy CSC matrix from element blocks ``esm`` (ne, 30,
    30) and dofs ``eldofs`` (ne, 30), tensors on any device: the Dirichlet
    elimination of :func:`fcvm_tpu_torch.ops.assembly.make_bc_matvec`
    (identity rows and columns on fixed dofs)."""
    import scipy.sparse as sp

    esm = esm.detach().cpu().numpy()
    eldofs = eldofs.cpu().numpy()
    fixmask = fixmask.cpu().numpy()
    rows = np.repeat(eldofs, 30, axis=1).reshape(-1)
    cols = np.tile(eldofs, (1, 30)).reshape(-1)
    vals = esm.reshape(-1)
    free = fixmask > 0.5
    keep = free[rows] & free[cols]
    k = sp.coo_matrix((vals[keep], (rows[keep], cols[keep])), shape=(ndof, ndof)).tocsc()
    fixed_idx = np.where(~free)[0]
    return k + sp.coo_matrix(
        (np.ones(len(fixed_idx)), (fixed_idx, fixed_idx)), shape=(ndof, ndof)
    ).tocsc()


class ScipyDirectSolver:
    """LU-factorised host solve of ``K_hat``, the reference's Cholesky tier.

    Built from the device's element blocks (:func:`assemble_scipy_csc`);
    :meth:`solve` takes a right-hand side (ndof,) or a block (ndof, m) on
    any device and returns the solution on that device in its dtype.  The
    class counts its factorisations and column solves."""

    factorizations = 0
    solves = 0

    def __init__(self, esm, eldofs, fixmask, ndof):
        from scipy.sparse.linalg import splu

        self._lu = splu(assemble_scipy_csc(esm, eldofs, fixmask, ndof))
        ScipyDirectSolver.factorizations += 1

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        bn = b.detach().cpu().double().numpy()
        x = self._lu.solve(bn)
        ScipyDirectSolver.solves += 1 if bn.ndim == 1 else bn.shape[1]
        return torch.as_tensor(x, device=b.device).to(b.dtype)
