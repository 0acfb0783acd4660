"""K6's two passes an iteration on the CPU against the JAX package's iterates.

The plain version of K6 (``kernels.cg_iteration`` on CPU tensors) runs a
solve's start and then k = 1 to 5 iterations of its two passes (the update
after ``ap = K p``, the direction after ``z = M r``), float64.  The JAX
package's ``pcg`` runs with ``maxiter = k`` and ``jax.lax.while_loop``
replaced by a Python loop that keeps its last state, so its x, r, p, r.z
and ||r|| after k iterations can be read; alpha and beta come from
``pcg_harvest`` of the same solve (the same iteration, which stores them).
Each is held to 1e-12 of its size.

The operator is K_hat of a 2x2x2 tension box as a dense matrix and the
preconditioner the port's two-level preconditioner of it, dense: both
packages get the same numbers.  Forms: a vector; a vector deflated by 8
seeded vectors (the JAX side's ``deflated`` preconditioner); a harvest of
8 slots (its residuals and coefficients too); a block of 5 columns, one of
them frozen from the start (a zero right-hand side), against the JAX
``pcg`` of each column, as its ``vmap`` runs them; the same block deflated
by the 8 vectors (the block form of the folded deflation), against the JAX
``pcg`` of each column with the ``deflated`` preconditioner.
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
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import solver as tslv

RTOL = 1e-12
NSTORE = 8
KD = 8
COLS = 5


@pytest.fixture(scope="module")
def system():
    """Dense K_hat and two-level preconditioner of the box in its solve
    space, seeded right-hand sides (column 2 zero) and a seeded deflation
    basis with its Galerkin pseudo-inverse, as numpy float64."""
    model = ft.model_from_arrays(tension_model(n=2))
    be = ft.runtime.backend.TorchSystem(model, port_config(precond="two_level"), F64,
                                        torch.device("cpu"))
    khat, pinv, *_ = be.assemble_operator(be.tensor(model.mesh.coords))
    sp = be.space
    kmat = tslv.assemble_scipy_csc(khat.esm_t.permute(2, 0, 1), sp.eldofs_m, sp.fixmask_m,
                                   be.ndof_pad).toarray()
    mmat = be.operator_pc(khat, pinv).apply(torch.eye(be.ndof_pad, dtype=F64)).numpy()
    fm = sp.fixmask_m.numpy()
    rng = np.random.default_rng(17)
    b = fm[:, None] * rng.normal(size=(be.ndof_pad, COLS))
    b[:, 2] = 0.0
    w = fm[:, None] * rng.normal(size=(be.ndof_pad, KD))
    return dict(k=kmat, m=0.5 * (mmat + mmat.T), b=b, w=w,
                kw_inv=np.linalg.pinv(w.T @ kmat @ w))


def _port(system, form, k):
    """The plan and x, r, p after the start and k iterations of K6's plain
    passes."""
    kt, mt = torch.as_tensor(system["k"]), torch.as_tensor(system["m"])
    b = torch.as_tensor(np.ascontiguousarray(
        system["b"] if form.startswith("block") else system["b"][:, 0]))
    n = b.shape[0]
    defl = harvest = None
    if form in ("deflated", "block_deflated"):
        defl = (torch.as_tensor(system["w"]), torch.as_tensor(system["kw_inv"]))
    if form == "harvest":
        harvest = (torch.zeros((NSTORE, n), dtype=F64), torch.zeros((3, NSTORE), dtype=F64))
    plan = kernels.cg_plan(b, 1e-14, 0.0, k, k + 1, defl, harvest)
    x, r, p = torch.zeros_like(b), b.clone(), torch.empty_like(b)
    kernels.cg_iteration(0, plan, x, r, r, r, start=True)
    kernels.cg_iteration(1, plan, x, r, p, mt @ r, start=True)
    for _ in range(k):
        kernels.cg_iteration(0, plan, x, r, p, kt @ p)
        kernels.cg_iteration(1, plan, x, r, p, mt @ r)
    return plan, x, r, p


def _jax(system, form, k, col, monkeypatch):
    """The JAX package's state after k iterations on column ``col``: x, r,
    p, rz, ||r||, alpha and beta, and the harvest."""
    kj, mj = jnp.asarray(system["k"]), jnp.asarray(system["m"])
    precond = lambda r: mj @ r  # noqa: E731
    if form in ("deflated", "block_deflated"):
        precond = jdfl.deflated(precond, jdfl.DeflationSpace(jnp.asarray(system["w"]),
                                                             jnp.asarray(system["kw_inv"])))
    b = jnp.asarray(system["b"][:, col])
    kw = dict(precond=precond, rtol=1e-14, maxiter=k)
    states = []

    def loop(cond, body, init):
        state = init
        while bool(cond(state)):
            state = body(state)
        states.append(state)
        return state

    with monkeypatch.context() as mp:
        mp.setattr(jax.lax, "while_loop", loop)
        jslv.pcg(lambda v: kj @ v, b, **kw)
        _, h = jslv.pcg_harvest(lambda v: kj @ v, b, nstore=NSTORE, **kw)
    x, r, p, rz, iters, rnorm = states[0][:6]
    last = max(int(iters) - 1, 0)
    return dict(x=x, r=r, p=p, rz=rz, rnorm=rnorm, alpha=h.alphas[last], beta=h.betas[last],
                iters=int(iters), h=h)


def _close(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=0,
                               atol=RTOL * max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("form", ["vector", "deflated", "harvest", "block", "block_deflated"])
def test_pass_split_matches_jax_iterates(system, form, k, monkeypatch):
    """x, r, p and the state's rz, alpha, beta and ||r|| after k iterations
    of the two passes, each column against the JAX iterates at ``maxiter =
    k`` (the block's frozen column against a JAX solve of no iteration); a
    harvest's residuals and coefficients against the JAX harvest."""
    plan, x, r, p = _port(system, form, k)
    rows = plan.read()
    block = form.startswith("block")
    cols = range(COLS) if block else [0]
    for c, row in zip(cols, rows):
        ref = _jax(system, form, k, c, monkeypatch)
        assert int(row[kernels.SLOT_K]) == ref["iters"] == (0 if c == 2 and block else k)
        assert row[kernels.SLOT_NEXT] == 0.0
        for port, name in ((x, "x"), (r, "r"), (p, "p")):
            _close(port[:, c] if block else port, ref[name])
        for slot, name in ((kernels.SLOT_RZ, "rz"), (kernels.SLOT_ALPHA, "alpha"),
                           (kernels.SLOT_BETA, "beta"), (kernels.SLOT_RNORM, "rnorm")):
            _close(row[slot], ref[name])
        if form == "harvest":
            h = ref["h"]
            _close(plan.zs, h.zs)
            for i, name in enumerate(("rzs", "alphas", "betas")):
                _close(plan.coef[i], getattr(h, name))
