"""The port's device-resident CG loop (K6's plain passes, the state read once
per batch) against the JAX package's ``lax.while_loop`` PCG, CPU float64.

The operator is ``K_hat`` of a 3x3x3 tension box, assembled once as a dense
matrix, and the preconditioner the port's two-level preconditioner of it,
applied to the identity once and kept dense too: both packages get the same
numbers, so the comparison is of the loops.
Each case holds the port's ``pcg``, ``pcg_harvest`` and ``pcg_block``
against the JAX package's ``pcg``, ``pcg_harvest`` and ``vmap`` of ``pcg``
(equal iteration counts; solutions and harvests to 1e-10 of their max), its
folded deflation, on a vector and on a block, against the JAX ``deflated``
preconditioner (the block's under ``vmap``), the folded block's bits
against the wrapped preconditioner's, and the port's bits across
``CG_BATCH`` values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import F64, port_config, tension_model

import fcvm_tpu_torch as ft
from fcvm_tpu.ops import deflation as jdfl
from fcvm_tpu.ops import solver as jslv
from fcvm_tpu_torch.ops import deflation as tdfl
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import solver as tslv

TOL = 1e-10
BATCHES = (1, 3, 64)


@pytest.fixture(scope="module")
def system():
    """Dense K_hat (ndof, ndof) of the tension box in its solve space, its
    two-level preconditioner as a dense symmetric matrix, the fixed-dof
    mask, a seeded (ndof, 4) block of right-hand sides (zero on fixed dofs)
    and their exact solutions, as numpy float64."""
    model = ft.model_from_arrays(tension_model(n=3))
    be = ft.runtime.backend.TorchSystem(model, port_config(precond="two_level"), F64,
                                        torch.device("cpu"))
    khat, pinv, *_ = be.assemble_operator(be.tensor(model.mesh.coords))
    sp = be.space
    kmat = tslv.assemble_scipy_csc(khat.esm_t.permute(2, 0, 1), sp.eldofs_m, sp.fixmask_m,
                                   be.ndof_pad).toarray()
    mmat = be.operator_pc(khat, pinv).apply(torch.eye(be.ndof_pad, dtype=F64)).numpy()
    fm = sp.fixmask_m.numpy()
    b = fm[:, None] * np.random.default_rng(11).normal(size=(be.ndof_pad, 4))
    b[:, 1] *= 1e3  # the columns finish apart: other scales, other directions
    b[:, 3] = kmat @ b[:, 3]
    return dict(k=kmat, m=0.5 * (mmat + mmat.T), fm=fm, b=b, x=np.linalg.solve(kmat, b))


def _ops(sys_):
    kt, mt = torch.as_tensor(sys_["k"]), torch.as_tensor(sys_["m"])
    kj, mj = jnp.asarray(sys_["k"]), jnp.asarray(sys_["m"])
    return (lambda v: kt @ v, lambda r: mt @ r), (lambda v: kj @ v, lambda r: mj @ r)


def _close(port, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


# case -> (pcg keywords, x0 as a multiple of another column's solution
# (None: cold), rhs scale)
CASES = {
    "cold": (dict(rtol=1e-10, maxiter=2000), None, 1.0),
    "x0": (dict(rtol=1e-10, maxiter=2000), 0.3, 1.0),
    "stall": (dict(rtol=1e-16, maxiter=2000, stall=5), None, 1.0),
    "maxiter": (dict(rtol=1e-12, maxiter=7), None, 1.0),
    "zero_rhs": (dict(rtol=1e-10, maxiter=2000), None, 0.0),
}


def _x0(system, frac, cols=slice(0, 1)):
    """A warm start: ``frac`` times the solution of the columns after
    ``cols`` (zero on the fixed dofs, scaled as a solution)."""
    if frac is None:
        return None
    x = frac * np.roll(system["x"], -1, axis=1)[:, cols]
    return x[:, 0].copy() if x.shape[1] == 1 else x.copy()


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("case", list(CASES))
def test_pcg_matches_jax(system, case, batch, monkeypatch):
    """``pcg`` on one column: the JAX count, x to 1e-10; with ``x0``, the
    stagnation exit, a ``maxiter`` cut and a zero right-hand side."""
    monkeypatch.setattr(tslv, "CG_BATCH", batch)
    kw, frac, scale = CASES[case]
    (tk, tm), (jk, jm) = _ops(system)
    b = scale * system["b"][:, 0]
    x0 = _x0(system, frac)
    ref = jslv.pcg(jk, jnp.asarray(b), precond=jm, x0=None if x0 is None else jnp.asarray(x0),
                   **kw)
    res = tslv.pcg(tk, torch.as_tensor(b), precond=tm,
                   x0=None if x0 is None else torch.as_tensor(x0), **kw)
    assert res.iters == int(ref.iters)
    _close(res.x, ref.x)
    # the residual recurrence at 1e-10 of ||b|| is rounding: its norm agrees to a few %
    assert res.relres == pytest.approx(float(ref.relres), rel=0.1, abs=1e-14)
    if case == "maxiter":
        assert res.iters == 7
    if case == "zero_rhs":
        assert res.iters == 0 and not bool(res.x.any())
    if case == "stall":
        assert 5 < res.iters < 2000


# harvests stopped by maxiter while the residual is well above rounding: the
# last coefficients of a solve run to 1e-10 are themselves rounding noise
HARVESTS = {"cold": (dict(rtol=1e-10, maxiter=40), None),
            "x0": (dict(rtol=1e-10, maxiter=30), 0.3),
            "converged": (dict(rtol=1e-3, maxiter=2000), None)}


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("case,nstore", [("cold", 64), ("cold", 8), ("x0", 16),
                                         ("converged", 64)])
def test_pcg_harvest_matches_jax(system, case, nstore, batch, monkeypatch):
    """``pcg_harvest``: the JAX count, x and every harvest buffer to 1e-10,
    its slots clamped when the solve outruns ``nstore``; the same bits as
    ``pcg``."""
    monkeypatch.setattr(tslv, "CG_BATCH", batch)
    kw, frac = HARVESTS[case]
    (tk, tm), (jk, jm) = _ops(system)
    b = system["b"][:, 0]
    x0 = _x0(system, frac)
    ref, hr = jslv.pcg_harvest(jk, jnp.asarray(b), precond=jm, nstore=nstore,
                               x0=None if x0 is None else jnp.asarray(x0), **kw)
    t_x0 = None if x0 is None else torch.as_tensor(x0)
    res, h = tslv.pcg_harvest(tk, torch.as_tensor(b), precond=tm, nstore=nstore, x0=t_x0,
                              **kw)
    assert res.iters == int(ref.iters)
    _close(res.x, ref.x)
    for name in ("zs", "rzs", "alphas", "betas"):
        _close(getattr(h, name), getattr(hr, name))
    plain = tslv.pcg(tk, torch.as_tensor(b), precond=tm, x0=t_x0, **kw)
    assert plain.iters == res.iters and torch.equal(plain.x, res.x)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("case", ["cold", "x0", "stall", "maxiter"])
def test_pcg_block_matches_jax_vmap(system, case, batch):
    """``pcg_block``'s loop on four columns that finish apart against
    ``jax.vmap`` of ``pcg``: every column's count, the solutions to 1e-10.
    The loop reads the states once a batch, as on the card (``pcg_block``
    itself reads them every iteration on the CPU), so finished columns
    stay frozen in the block until the batch ends."""
    kw, frac, _ = CASES[case]
    (tk, tm), (jk, jm) = _ops(system)
    b = system["b"]
    x0 = _x0(system, frac, slice(None))

    def solve_col(bc, x0c):
        return jslv.pcg(jk, bc, precond=jm, x0=x0c, **kw)

    if x0 is None:
        ref = jax.vmap(lambda bc: solve_col(bc, None), in_axes=1, out_axes=jslv.CGResult(1, 0, 0))(
            jnp.asarray(b))
    else:
        ref = jax.vmap(solve_col, in_axes=(1, 1), out_axes=jslv.CGResult(1, 0, 0))(jnp.asarray(b),
                                                                   jnp.asarray(x0))
    kw = {"atol": 0.0, "stall": 0, **kw}
    res = tslv._pcg_block(tk, torch.as_tensor(b), tm, None if x0 is None else torch.as_tensor(x0),
                          kw["rtol"], kw["atol"], kw["maxiter"], kw["stall"], batch)
    assert res.iters == [int(i) for i in ref.iters]
    if case in ("cold", "x0"):
        assert len(set(res.iters)) > 1  # the columns finish apart
    _close(res.x, ref.x)


def _deflation(system, kd=8):
    """The kd lowest eigenvectors of K_hat on the free dofs and the
    pseudo-inverse of their Galerkin matrix, numpy."""
    free = system["fm"] > 0.5
    evals, evecs = np.linalg.eigh(system["k"][np.ix_(free, free)])
    w = np.zeros((system["k"].shape[0], kd))
    w[free] = evecs[:, :kd]
    return w, np.asarray(jdfl.pinv_psd(jnp.asarray(w.T @ system["k"] @ w)))


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("x0", [False, True])
def test_folded_deflation_matches_jax(system, x0, batch, monkeypatch):
    """``pcg(defl=...)``, the correction folded into K6's passes, against
    the JAX package's ``pcg`` with its ``deflated`` preconditioner: the
    same count, fewer iterations than undeflated, x to 1e-10."""
    monkeypatch.setattr(tslv, "CG_BATCH", batch)
    (tk, tm), (jk, jm) = _ops(system)
    w, kw_inv = _deflation(system)
    b = system["b"][:, 0]
    x0v = _x0(system, 0.3 if x0 else None)
    kw = dict(rtol=1e-10, maxiter=2000)
    ref = jslv.pcg(jk, jnp.asarray(b), precond=jdfl.deflated(
        jm, jdfl.DeflationSpace(jnp.asarray(w), jnp.asarray(kw_inv))),
        x0=None if x0v is None else jnp.asarray(x0v), **kw)
    res = tslv.pcg(tk, torch.as_tensor(b), precond=tm,
                   x0=None if x0v is None else torch.as_tensor(x0v),
                   defl=tdfl.DeflationSpace(torch.as_tensor(w), torch.as_tensor(kw_inv)), **kw)
    plain = jslv.pcg(jk, jnp.asarray(b), precond=jm,
                     x0=None if x0v is None else jnp.asarray(x0v), **kw)
    assert res.iters == int(ref.iters) < int(plain.iters)
    _close(res.x, ref.x)
    # the folded correction is the wrapped one's arithmetic
    wrapped = tslv.pcg(tk, torch.as_tensor(b), precond=tdfl.deflated(tm, tdfl.DeflationSpace(
        torch.as_tensor(w), torch.as_tensor(kw_inv))),
        x0=None if x0v is None else torch.as_tensor(x0v), **kw)
    assert wrapped.iters == res.iters and torch.equal(wrapped.x, res.x)


def _space(system):
    """The port's and the JAX package's DeflationSpace of ``_deflation``."""
    w, kw_inv = _deflation(system)
    return (tdfl.DeflationSpace(torch.as_tensor(w), torch.as_tensor(kw_inv)),
            jdfl.DeflationSpace(jnp.asarray(w), jnp.asarray(kw_inv)))


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("x0", [False, True])
def test_block_folded_deflation_matches_jax_vmap(system, x0, batch):
    """``pcg_block``'s loop with ``defl=`` (the block form of the folded
    deflation, read once a batch as on the card) on four columns that
    finish apart, against ``jax.vmap`` of ``pcg`` with the JAX
    ``deflated`` preconditioner: every column's count (warm-started, within
    one: the block's column sums and products round in another order than
    the vector's, and a warm column ends at 9.8e-11 of ``||b||``, at the
    tolerance's edge, one iteration before JAX's; the wrapped
    preconditioner's block takes the same count), fewer iterations than
    undeflated, the solutions to 1e-12 of their max."""
    (tk, tm), (jk, jm) = _ops(system)
    space, jspace = _space(system)
    b = system["b"]
    x0b = _x0(system, 0.3 if x0 else None, slice(None))
    kw = dict(rtol=1e-10, maxiter=2000)

    def solve_col(bc, x0c, precond):
        return jslv.pcg(jk, bc, precond=precond, x0=x0c, **kw)

    out = jslv.CGResult(1, 0, 0)
    refs = []
    for precond in (jdfl.deflated(jm, jspace), jm):
        if x0b is None:
            refs.append(jax.vmap(lambda bc: solve_col(bc, None, precond), in_axes=1,
                                 out_axes=out)(jnp.asarray(b)))
        else:
            refs.append(jax.vmap(lambda bc, xc: solve_col(bc, xc, precond), in_axes=(1, 1),
                                 out_axes=out)(jnp.asarray(b), jnp.asarray(x0b)))
    ref, plain = refs
    res = tslv._pcg_block(tk, torch.as_tensor(b), tm,
                          None if x0b is None else torch.as_tensor(x0b), kw["rtol"], 0.0,
                          kw["maxiter"], 0, batch, space)
    if x0:
        assert all(abs(a - int(b_)) <= 1 for a, b_ in zip(res.iters, ref.iters))
    else:
        assert res.iters == [int(i) for i in ref.iters]
    assert len(set(res.iters)) > 1  # the columns finish apart: dropped ones leave the rest deflated
    assert sum(res.iters) < sum(int(i) for i in plain.iters)
    _close(res.x, ref.x, 1e-12)


@pytest.mark.parametrize("batch", BATCHES)
def test_block_folded_deflation_has_the_wrapped_bits(system, batch):
    """On the CPU ``pcg_block(defl=...)`` gives bit for bit the counts and
    x of ``pcg_block`` with ``deflation.deflated`` wrapped round its
    preconditioner (the plain passes take its products in its order), at
    every batch of its loop."""
    (tk, tm), _ = _ops(system)
    space, _ = _space(system)
    b = torch.as_tensor(system["b"])
    folded = tslv._pcg_block(tk, b, tm, None, 1e-10, 0.0, 2000, 0, batch, space)
    wrapped = tslv._pcg_block(tk, b, tdfl.deflated(tm, space), None, 1e-10, 0.0, 2000, 0, batch)
    assert folded.iters == wrapped.iters
    assert torch.equal(folded.x, wrapped.x)
    assert folded.relres == wrapped.relres
    if batch == 1:  # pcg_block's own loop on the CPU
        res = tslv.pcg_block(tk, b, precond=tm, rtol=1e-10, maxiter=2000, defl=space)
        assert res.iters == folded.iters and torch.equal(res.x, folded.x)


@pytest.mark.parametrize("solver", ["pcg", "pcg_harvest", "pcg_block"])
def test_bits_do_not_depend_on_the_batch(system, solver, monkeypatch):
    """The same bits and counts at every ``CG_BATCH`` tested (for
    ``pcg_block``, its loop reading once a batch, as on the card):
    iterations queued after a column's test failed change nothing."""
    (tk, tm), _ = _ops(system)
    b = torch.as_tensor(system["b"] if solver == "pcg_block" else system["b"][:, 0])
    outs = []
    for batch in BATCHES:
        monkeypatch.setattr(tslv, "CG_BATCH", batch)
        if solver == "pcg_harvest":
            res, h = tslv.pcg_harvest(tk, b, precond=tm, rtol=1e-10, nstore=16)
            outs.append((res.iters, res.x, torch.cat([h.zs.reshape(-1), h.rzs, h.alphas,
                                                      h.betas])))
        else:
            res = (tslv._pcg_block(tk, b, tm, None, 1e-10, 0.0, 1000, 0, batch)
                   if solver == "pcg_block" else tslv.pcg(tk, b, precond=tm, rtol=1e-10))
            outs.append((res.iters, res.x, torch.as_tensor(res.relres)))
    for iters, x, extra in outs[1:]:
        assert iters == outs[0][0]
        assert torch.equal(x, outs[0][1]) and torch.equal(extra, outs[0][2])


def test_solve_converging_mid_batch_stops_there(system, monkeypatch):
    """A solve that converges inside one batch of 100: ``iters`` is where
    its test failed, not the batch's end; the queued rest is idle, and the
    state was read once before the batch and once after it."""
    (tk, tm), (jk, jm) = _ops(system)
    b = system["b"][:, 0]
    ref = jslv.pcg(jk, jnp.asarray(b), precond=jm, rtol=1e-4)
    tslv.CG_STATS.clear()
    monkeypatch.setattr(tslv, "CG_BATCH", 100)
    res = tslv.pcg(tk, torch.as_tensor(b), precond=tm, rtol=1e-4)
    assert 0 < res.iters == int(ref.iters) < 100
    stats = dict(tslv.CG_STATS)
    assert stats == {"solves": 1, "reads": 2, "queued": 100, "idle": 100 - res.iters}
    # the frozen state: x is the JAX package's, whatever was queued after it
    _close(res.x, ref.x)


def test_reads_per_solve_are_bounded(system, monkeypatch):
    """At most ceil(iters / CG_BATCH) + 2 reads of the state per solve."""
    (tk, tm), _ = _ops(system)
    b = torch.as_tensor(system["b"][:, 0])
    for batch in BATCHES:
        monkeypatch.setattr(tslv, "CG_BATCH", batch)
        tslv.CG_STATS.clear()
        res = tslv.pcg(tk, b, precond=tm, rtol=1e-10)
        assert tslv.CG_STATS["reads"] <= -(-res.iters // batch) + 2


def test_plan_rejects_what_k6_does_not_take():
    b = torch.zeros(12, dtype=F64)
    with pytest.raises(TypeError):
        kernels.cg_plan(b.to(torch.int64), 1e-6, 0.0, 10, 11)
    with pytest.raises(ValueError):
        kernels.cg_plan(torch.zeros((12, kernels.CG_MAX_COLS + 1), dtype=F64), 1e-6, 0.0, 10, 11)
    blk = torch.zeros((12, 2), dtype=F64)
    kd = kernels.CG_MAX_DEFL_BLOCK + 1
    with pytest.raises(ValueError):  # a block's deflation past its limit, on every device
        kernels.cg_plan(blk, 1e-6, 0.0, 10, 11,
                        defl=(torch.zeros((12, kd), dtype=F64), torch.zeros((kd, kd), dtype=F64)))
    with pytest.raises(ValueError):
        tslv.pcg_block(lambda v: v, blk, defl=tdfl.DeflationSpace(
            torch.zeros((12, kd), dtype=F64), torch.zeros((kd, kd), dtype=F64)))
    for w, kw_inv in (((11, 3), (3, 3)), ((12, 3), (3, 4)), ((12, 3, 1), (3, 3))):
        with pytest.raises(ValueError):  # a block's basis or inverse of the wrong shape
            kernels.cg_plan(blk, 1e-6, 0.0, 10, 11,
                            defl=(torch.zeros(w, dtype=F64), torch.zeros(kw_inv, dtype=F64)))
    with pytest.raises(ValueError):  # a harvest on a block
        kernels.cg_plan(blk, 1e-6, 0.0, 10, 11,
                        harvest=(torch.zeros((4, 12), dtype=F64), torch.zeros((3, 4), dtype=F64)))
    plan = kernels.cg_plan(blk, 1e-6, 0.0, 10, 11, defl=(torch.zeros((12, 64), dtype=F64),
                                                          torch.zeros((64, 64), dtype=F64)))
    assert plan.form == "block deflated" and plan.c.shape == (64, 2)
    assert plan.select([1]).c.shape == (64, 1) and plan.select([1]).w is plan.w
    with pytest.raises(ValueError):  # a basis of other rows
        kernels.cg_plan(b, 1e-6, 0.0, 10, 11,
                        defl=(torch.zeros((11, 3), dtype=F64), torch.zeros((3, 3), dtype=F64)))
    with pytest.raises(ValueError):
        kernels.cg_plan(b, 1e-6, 0.0, 10, 11,
                        harvest=(torch.zeros((4, 12), dtype=F64), torch.zeros((3, 5), dtype=F64)))
    with pytest.raises(ValueError):
        tslv.pcg(lambda v: v, b, dot=torch.dot,
                 defl=tdfl.DeflationSpace(torch.zeros((12, 1), dtype=F64),
                                          torch.zeros((1, 1), dtype=F64)))
