"""Ritz-deflation recycling in the port against the JAX package
(``tests/test_deflation.py``), CPU float64: the harvesting PCG, the Ritz
extraction, the block Galerkin product, the pseudo-inverse, a deflated
solve, and the collapse driver with deflation on.

Where a test demands equal CG iteration counts, the port is fed the JAX
package's preconditioner state (``to_torch``): the JAX package inverts its
coarse matrix in float32, the port in the working dtype.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import F64, newton_per_step, port_config, t64, tension_model

import fcvm_tpu
from fcvm_tpu.config import get_config
from fcvm_tpu.ops import assembly as asm
from fcvm_tpu.ops import deflation as jdfl
from fcvm_tpu.ops import solver as jslv
from fcvm_tpu.runtime.backend import LocalSystem
import fcvm_tpu_torch as ft
from fcvm_tpu_torch.models.spec import model_from_arrays, to_torch
from fcvm_tpu_torch.ops import deflation as tdfl
from fcvm_tpu_torch.ops import precond as tpre
from fcvm_tpu_torch.ops import solver as tslv
from fcvm_tpu_torch.runtime.backend import TorchSystem

NSTORE = 48


def _close(a, b, rtol=1e-10):
    """``a`` (tensor) equals ``b`` (array) to ``rtol`` of ``b``'s largest entry."""
    b = np.asarray(b)
    np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=rtol * max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def system():
    """The elastic system of a 3x3x3 tension box on both sides, the JAX
    package's two-level preconditioner, and its harvesting solve."""
    model = tension_model(n=3)
    mesh = model.mesh
    be = LocalSystem(model, get_config(), jnp.float64)
    esm, pinv, _, rhs, *_ = be.assemble(mesh.coords)
    pc = be.make_pc(esm, pinv, jnp.asarray(mesh.coords, jnp.float64))
    res, h = be.solve_harvest(esm, pc, rhs, nstore=NSTORE)

    tbe = TorchSystem(model_from_arrays(model), port_config(), F64, torch.device("cpu"))
    tesm, _, _, trhs, *_ = tbe.assemble(tbe.tensor(mesh.coords))
    tpc = tpre.TwoLevelPrecond(*to_torch((pc.pinv, pc.qmat, pc.coarse_inv, pc.fixmask),
                                         "cpu", F64))
    return dict(be=be, esm=esm, pc=pc, rhs=rhs, res=res, h=h, tbe=tbe,
                khat=tbe.operator(tesm), tpc=tpc, trhs=trhs)


@pytest.mark.parametrize("nstore", [8, 64])
def test_pcg_harvest_matches_jax(nstore):
    """Dense SPD system, stopped by ``maxiter`` while the residual is still
    well above rounding (the last coefficients of a solve run to roundoff
    are themselves rounding noise); ``nstore = 8`` is shorter than the
    solve, so the slot clamping is exercised."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(40, 40))
    spd = a @ a.T + 4.0 * np.eye(40)
    b = rng.normal(size=40)
    pre = 1.0 / np.diag(spd)
    ref, hr = jslv.pcg_harvest(lambda v: jnp.asarray(spd) @ v, jnp.asarray(b),
                               precond=lambda r: jnp.asarray(pre) * r, rtol=1e-10,
                               maxiter=16, nstore=nstore)
    out, h = tslv.pcg_harvest(lambda v: torch.as_tensor(spd) @ v, torch.as_tensor(b),
                              precond=lambda r: torch.as_tensor(pre) * r, rtol=1e-10,
                              maxiter=16, nstore=nstore)
    assert out.iters == int(ref.iters) == 16
    _close(out.x, ref.x)
    for name in ("zs", "rzs", "alphas", "betas"):
        _close(getattr(h, name), getattr(hr, name))
    # same iteration as the plain solver
    plain = tslv.pcg(lambda v: torch.as_tensor(spd) @ v, torch.as_tensor(b),
                     precond=lambda r: torch.as_tensor(pre) * r, rtol=1e-10, maxiter=16)
    assert plain.iters == out.iters and torch.equal(plain.x, out.x)


def test_harvesting_solve_matches_jax(system):
    res, h = system["tbe"].solve_harvest(system["khat"], system["tpc"], system["trhs"],
                                         nstore=NSTORE)
    assert res.iters == int(system["res"].iters) > 10
    _close(res.x, system["res"].x, 1e-9)
    for name in ("zs", "rzs", "alphas", "betas"):
        _close(getattr(h, name), getattr(system["h"], name), 1e-9)


@pytest.mark.parametrize("k", [6, 12])
def test_ritz_coefficients_match_jax(system, k):
    h, iters = system["h"], int(system["res"].iters)
    args = [np.asarray(a) for a in (h.alphas, h.betas, h.rzs)]
    coef = tdfl.ritz_coefficients(*args, iters, k)
    ref = jdfl.ritz_coefficients(*args, iters, k)
    assert coef.dtype == np.float32 and coef.shape == (NSTORE, k)
    np.testing.assert_array_equal(coef, ref)


def test_ritz_coefficients_rejects_degenerate():
    z = np.zeros(8)
    assert tdfl.ritz_coefficients(z, z, z, iters=2, k=4) is None
    a = np.full(8, -1.0)  # negative alpha: lost positive-definiteness
    assert tdfl.ritz_coefficients(a, np.ones(8), np.ones(8), 6, 4) is None
    assert jdfl.ritz_coefficients(a, np.ones(8), np.ones(8), 6, 4) is None


def test_block_galerkin_matches_jax_and_explicit(system):
    be, h = system["be"], system["h"]
    coef = jdfl.ritz_coefficients(h.alphas, h.betas, h.rzs, int(system["res"].iters), 6)
    sp = be.space
    w = jdfl.build_w(h.zs, jnp.asarray(coef), sp.fixmask_m)
    esm_m = system["esm"][sp.eperm]
    eldofs = asm.element_dof_ids(sp.elnodes_m)
    tsp = system["tbe"].space
    tw = tdfl.build_w(t64(h.zs), coef, tsp.fixmask_m)
    _close(tw, w)
    esm_t = system["khat"].esm_t
    kw = tdfl.block_khat_matvec(esm_t, tsp.eldofs_m, tsp.fixmask_m, tw)
    _close(kw, jdfl.block_khat_matvec(esm_m, eldofs, sp.fixmask_m, sp.plan_m, w))
    # W^T K_hat W column by column through the port's own operator
    cols = torch.stack([system["khat"](tw[:, j]) for j in range(tw.shape[1])], dim=1)
    g = tdfl.galerkin(esm_t, tsp.eldofs_m, tsp.fixmask_m, tw)
    np.testing.assert_allclose(g.numpy(), (tw.T @ cols).numpy(), rtol=1e-10, atol=1e-8)
    _close(g, jdfl.galerkin(esm_m, eldofs, sp.fixmask_m, sp.plan_m, w))


def test_pinv_psd_matches_jax():
    """A rank-5 PSD matrix in 8 dimensions, with an exactly zero column."""
    rng = np.random.default_rng(5)
    v = rng.normal(size=(8, 5))
    v[3] = 0.0
    kw = v @ v.T
    p = tdfl.pinv_psd(torch.as_tensor(kw))
    _close(p, jdfl.pinv_psd(jnp.asarray(kw)))
    np.testing.assert_allclose((torch.as_tensor(kw) @ p @ torch.as_tensor(kw)).numpy(), kw,
                               rtol=0, atol=1e-10 * np.abs(kw).max())


def test_deflated_solve_matches_jax(system):
    """The JAX package's deflation space, applied by the port: the same CG
    count and solution; the port's own space from the same harvest equals
    the JAX package's."""
    be, h = system["be"], system["h"]
    coef = jdfl.ritz_coefficients(h.alphas, h.betas, h.rzs, int(system["res"].iters), 12)
    defl = be.build_deflation(system["esm"], h.zs, coef)
    ref = be.solve(system["esm"], system["pc"], system["rhs"], defl=defl)
    tdefl = system["tbe"].build_deflation(system["khat"], t64(h.zs), coef)
    _close(tdefl.w, defl.w)
    _close(tdefl.kw_inv, defl.kw_inv, 1e-9)
    fixed = system["tbe"].space.fixmask_m < 0.5
    assert bool((tdefl.w[fixed] == 0.0).all())
    res = system["tbe"].solve(system["khat"], system["tpc"], system["trhs"],
                              defl=to_torch(defl, "cpu", F64))
    assert res.iters == int(ref.iters) < int(system["res"].iters)
    _close(res.x, ref.x, 1e-9)
    assert res.relres <= system["tbe"].rtol


# -- the collapse driver with deflation on (tests/test_deflation.py:111-196) --


@pytest.fixture
def jax_defl_cfg():
    """The JAX package's global config with its deflation defaults; every
    field a test sets is restored afterwards."""
    c = get_config()
    fields = ("deflation", "load_deflation", "deflation_min_iters", "residual_refinement",
              "precision_failover", "cg_rtol")
    saved = {f: getattr(c, f) for f in fields}
    yield c
    for f, v in saved.items():
        setattr(c, f, v)


def _both(params_kw, jcfg):
    """Run the JAX package (with ``jcfg`` set by the caller) and the port
    (its default configuration with ``jcfg``'s deflation fields) on the
    2x2x2 tension box; return results and log lines."""
    model = tension_model(2)
    lines_ref, lines = [], []
    ref = fcvm_tpu.solve_collapse(model, fcvm_tpu.ControlParams(**params_kw),
                                  progress=lines_ref.append)
    cfg = ft.FcvmConfig(device="cpu", dtype="float64", deflation=jcfg.deflation,
                        deflation_min_iters=jcfg.deflation_min_iters)
    res = ft.solve_collapse(ft.model_from_arrays(model), ft.ControlParams(**params_kw),
                            progress=lines.append, config=cfg)
    return ref, lines_ref, res, lines


def _spaces_built(lines):
    return sum("deflation space: k=" in ln for ln in lines)


def _assert_same_run(ref, lines_ref, res, lines):
    assert len(res.history.lbd) == len(ref.history.lbd) > 1
    assert newton_per_step(lines) == newton_per_step(lines_ref)
    np.testing.assert_allclose(res.history.lbd, ref.history.lbd, rtol=1e-8, atol=0)
    np.testing.assert_allclose(res.disp_total, ref.disp_total, rtol=0,
                               atol=1e-8 * np.abs(ref.disp_total).max())
    assert _spaces_built(lines) == _spaces_built(lines_ref)


def test_driver_deflation_matches_jax(jax_defl_cfg):
    """Recycling forced on (min_iters below this mesh's solve counts): the
    same steps, Newton iterations and harvests as the JAX package, one space
    kept across load steps, and the physics of the run without deflation."""
    kw = dict(nstep=8, sig_yield=240.0, et_e=0.1, error_max=1e-8, target_lf=2.8)
    jax_defl_cfg.deflation_min_iters = 5
    ref, lines_ref, res, lines = _both(kw, jax_defl_cfg)
    _assert_same_run(ref, lines_ref, res, lines)
    n_steps = sum(ln.startswith("Step:") for ln in lines)
    assert 1 <= _spaces_built(lines) < n_steps
    harvests = res.cg_stats["harvests"]
    assert sum(hv["k"] > 0 for hv in harvests) == _spaces_built(lines)
    assert [int(m.group(1)) for ln in lines_ref
            if (m := re.search(r"harvest solve: (\d+) iters", ln))] == \
        [hv["iters"] for hv in harvests if hv["k"] > 0]
    off = ft.solve_collapse(ft.model_from_arrays(tension_model(2)), ft.ControlParams(**kw),
                            config=port_config())
    assert len(off.history.lbd) == len(res.history.lbd)
    np.testing.assert_allclose(res.history.lbd, off.history.lbd, atol=5e-7)
    np.testing.assert_allclose(res.disp_total, off.disp_total, atol=1e-9)


def test_driver_deflation_gate_skips_small_solves(jax_defl_cfg):
    """At the default min_iters gate the tiny mesh never builds a space; the
    port's deflated and undeflated runs are then identical."""
    kw = dict(nstep=4, sig_yield=240.0, et_e=0.1, error_max=1e-9, target_lf=2.6)
    ref, lines_ref, res, lines = _both(kw, jax_defl_cfg)
    _assert_same_run(ref, lines_ref, res, lines)
    assert _spaces_built(lines) == 0 and res.cg_stats["harvests"]
    off = ft.solve_collapse(ft.model_from_arrays(tension_model(2)), ft.ControlParams(**kw),
                            config=port_config())
    np.testing.assert_array_equal(res.history.lbd, off.history.lbd)
    np.testing.assert_array_equal(res.disp_total, off.disp_total)


@pytest.mark.parametrize("load_deflation", [True, False])
def test_driver_load_deflation_switch(jax_defl_cfg, load_deflation):
    """The JAX package's ``load_deflation`` recycles the GNL tangent
    predictor's load space, so in small strain it changes nothing there:
    the port, which takes the option only with the GNL port, runs as the JAX
    package does with it on or off.  (The GNL case of
    ``tests/test_deflation.py:168`` waits for the GNL port: ``gnl='GNLY'``
    raises, and so does the option.)"""
    kw = dict(nstep=6, sig_yield=240.0, et_e=0.1, error_max=1e-8, target_lf=2.8)
    jax_defl_cfg.deflation_min_iters = 5
    jax_defl_cfg.load_deflation = load_deflation
    ref, lines_ref, res, lines = _both(kw, jax_defl_cfg)
    _assert_same_run(ref, lines_ref, res, lines)
    assert not any("load-deflation space" in ln for ln in lines_ref + lines)
    with pytest.raises(TypeError, match="load_deflation"):
        ft.FcvmConfig(load_deflation=load_deflation)
    with pytest.raises(NotImplementedError, match="GNLY"):
        ft.solve_collapse(ft.model_from_arrays(tension_model(2)),
                          ft.ControlParams(**kw, gnl="GNLY", max_imp=0.0),
                          config=port_config(deflation=True))
