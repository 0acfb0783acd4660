"""End-to-end parity of the port's ``solve_collapse`` with the JAX package's
on the cases of ``tests/test_driver_collapse.py`` and the small plate with
a hole, CPU float64, the JAX package's default solver tiers off on both
sides (``test_default_config_matches_jax`` runs them).

Both sides solve with ``cg_rtol = 1e-12``, so their solutions agree to far
below the compared tolerances although the coarse inverse is float32 in the
JAX package (a TPU rule) and float64 in the port.
"""

import numpy as np
import pytest
from torch_parity import (  # noqa: F401
    disp_control_model, jax_cfg, newton_per_step, plate_model, port_config, tension_model)

import fcvm_tpu
import fcvm_tpu_torch as ft

CG_RTOL = 1e-12
RTOL = 1e-8

CASES = {
    "elastic_exact": (tension_model, dict(sig_yield=240.0, nstep=4, error_max=1e-10,
                                          et_e=0.1, target_lf=1.0)),
    "hardening": (tension_model, dict(sig_yield=240.0, nstep=22, iterat_max=20,
                                      error_max=1e-11, et_e=0.1, target_lf=99.0,
                                      ultimate_strain=0.25)),
    "target_lf": (tension_model, dict(sig_yield=240.0, nstep=10, error_max=1e-9,
                                      et_e=0.1, target_lf=1.5)),
    "disp_control": (lambda: disp_control_model(0.05),
                     dict(sig_yield=240.0, nstep=6, error_max=1e-10, et_e=0.1,
                          target_lf=0.9)),
    "plate": (plate_model, dict(sig_yield=100.0, nstep=6, iterat_max=20,
                                error_max=5e-4, et_e=0.0, target_lf=1.62,
                                ultimate_strain=0.25)),
    "elastic_only": (tension_model, dict(sig_yield=240.0, nstep=1, error_max=1e-10)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_solve_collapse_matches_jax(case, jax_cfg):  # noqa: F811
    build, kw = CASES[case]
    model = build()
    jax_cfg.cg_rtol = CG_RTOL
    lines_ref, lines = [], []
    ref = fcvm_tpu.solve_collapse(model, fcvm_tpu.ControlParams(**kw), progress=lines_ref.append)
    res = ft.solve_collapse(ft.model_from_arrays(model), ft.ControlParams(**kw),
                            progress=lines.append, config=port_config(cg_rtol=CG_RTOL))
    h, hr = res.history, ref.history
    assert len(h.lbd) == len(hr.lbd) > 1
    assert newton_per_step(lines) == newton_per_step(lines_ref)
    assert res.cg_stats.get("newton_iterations", 0) == ref.cg_stats.get("newton_iterations", 0)
    np.testing.assert_allclose(h.lbd, hr.lbd, rtol=RTOL, atol=0)
    np.testing.assert_allclose(h.un, hr.un, rtol=RTOL, atol=0)
    np.testing.assert_allclose(h.load, hr.load, rtol=RTOL, atol=0)
    for name in ("csr", "peeq", "peeqmax", "svm", "pressure", "triax", "ecr"):
        np.testing.assert_allclose(getattr(h, name), getattr(hr, name), rtol=RTOL, atol=1e-12)
    if case == "plate":
        # the critical Gauss point; the box cases are homogeneous, where
        # every point ties and rounding picks the argmax
        assert h.crip == hr.crip
    np.testing.assert_allclose(res.peeq_gp.max(), ref.peeq_gp.max(), rtol=RTOL, atol=0)
    np.testing.assert_allclose(res.disp_total, ref.disp_total, rtol=0,
                               atol=RTOL * np.abs(ref.disp_total).max())
    np.testing.assert_allclose(res.sig_gp, ref.sig_gp, rtol=0,
                               atol=RTOL * max(np.abs(ref.sig_gp).max(), 1.0))
    np.testing.assert_allclose(res.loadsums, ref.loadsums, rtol=1e-12, atol=1e-9)
    if case in ("hardening", "plate", "disp_control"):
        assert ref.peeq_gp.max() > 0.0  # the case is plastic


# options that raised before they were ported: each now runs (the first,
# n_devices, as a world of one: force_sharded)
PORTED = [
    (dict(n_devices=1, force_sharded=True), {}),
    (dict(smoother="cluster"), {}),
    (dict(solver="scipy"), {}),
    # GNL with an imperfection or one step runs the buckling eigensolve
    ({}, dict(gnl="GNLY", max_imp=0.05)),
    ({}, dict(gnl="GNLY", nstep=1)),
]


@pytest.mark.parametrize("cfg_kw,param_kw", PORTED,
                         ids=["n_devices", "smoother", "solver", "gnl", "gnl_nstep1"])
def test_unported_options_raise(cfg_kw, param_kw):
    """Options that raised ``NotImplementedError`` before they were ported
    now run: the sharded backend on a world of one (which it starts and
    this test stops; worlds of several ranks: ``test_torch_sharded_*.py``),
    the cluster smoother built once, the scipy tier with no CG iteration,
    the GNL buckling branch with its two factors, negative under the box's
    tension pre-stress."""
    from fcvm_tpu_torch.ops.precond import COARSE_BUILD_STATS
    from fcvm_tpu_torch.parallel import dist as pdist

    model = ft.model_from_arrays(tension_model())
    params = ft.ControlParams(**{"nstep": 2, **param_kw})
    built = COARSE_BUILD_STATS["smoother_builds"]
    try:
        res = ft.solve_collapse(model, params, config=port_config(**cfg_kw))
        assert (pdist.group() is not None) == ("force_sharded" in cfg_kw)
    finally:
        pdist.destroy_process_group()
    assert np.all(np.isfinite(res.history.lbd)) and len(res.history.lbd) >= 2
    if "smoother" in cfg_kw:
        assert COARSE_BUILD_STATS["smoother_builds"] == built + 1
        assert res.cg_stats["iters"] > 0 and res.eigenvalues is None
    elif "solver" in cfg_kw:
        assert res.cg_stats["iters"] == 0 and res.eigenvalues is None
    elif "force_sharded" in cfg_kw:
        assert res.cg_stats["iters"] > 0 and res.sig_gp.shape == (model.mesh.n_elements, 4, 6)
    else:
        assert res.eigenvalues.shape == (2,) and np.all(res.eigenvalues < 0.0)


def _restart_params():
    # tests/test_restart_resume.py:27-42: yield at LF 0.4, inside the first
    # dl = 0.5, with 5 Newton iterations allowed
    return dict(sig_yield=40.0, nstep=2, iterat_max=5, error_max=1e-5, et_e=0.0,
                target_lf=99.0, scale_re=2.0)


def _two_phase(first):
    """A continuation that answers ``first`` once, then stops."""
    calls = []

    def cont(history, info):
        calls.append(info)
        return first(history) if len(calls) == 1 else "stop"

    return cont


CONTINUED = {  # control parameters, continuation factory, what the run must show
    # tests/test_restart_resume.py:27: the divergence restart recovers
    "restart": (_restart_params(), lambda: None, "RESTART"),
    # tests/test_restart_resume.py:75: "rev" unloads after the first nstep
    "rev": (dict(sig_yield=240.0, nstep=8, error_max=1e-9, et_e=0.1, target_lf=99.0),
            lambda: _two_phase(lambda h: "rev"), None),
    # ("target", v): a new target above the reached level resumes the loop
    "target": (dict(sig_yield=240.0, nstep=4, error_max=1e-9, et_e=0.1, target_lf=99.0),
               lambda: _two_phase(lambda h: ("target", h.lbd[-1] + 0.35)),
               "REACHED TARGET LOAD"),
}


@pytest.mark.parametrize("case", list(CONTINUED))
def test_continued_paths_match_jax(case, jax_cfg):  # noqa: F811
    """The divergence restart, load reversal and a retarget against the JAX
    driver: the same steps, Newton iterations (restarts included) and load
    factors, and the path's own mark."""
    kw, make_cont, mark = CONTINUED[case]
    model = tension_model()
    jax_cfg.cg_rtol = CG_RTOL
    lines_ref, lines = [], []
    ref = fcvm_tpu.solve_collapse(model, fcvm_tpu.ControlParams(**kw), continuation=make_cont(),
                                  progress=lines_ref.append)
    res = ft.solve_collapse(ft.model_from_arrays(model), ft.ControlParams(**kw),
                            continuation=make_cont(), progress=lines.append,
                            config=port_config(cg_rtol=CG_RTOL))
    assert len(res.history.lbd) == len(ref.history.lbd) > 2
    assert newton_per_step(lines) == newton_per_step(lines_ref)
    np.testing.assert_allclose(res.history.lbd, ref.history.lbd, rtol=RTOL, atol=0)
    np.testing.assert_allclose(res.peeq_gp, ref.peeq_gp, rtol=0,
                               atol=RTOL * max(ref.peeq_gp.max(), 1e-12))
    if mark is not None:
        assert sum(mark in ln for ln in lines) == sum(mark in ln for ln in lines_ref) > 0
    lbd = np.asarray(res.history.lbd)
    if case == "restart":
        assert abs(lbd.max() - 0.4) < 1e-3 and res.peeq_gp.max() > 0.0
    elif case == "rev":
        assert int(np.argmax(lbd)) < len(lbd) - 1 and res.peeq_gp.max() > 0.0
    else:
        assert abs(lbd[-1] - (lbd[4] + 0.35)) < 1e-12


@pytest.mark.parametrize("first_dtype", ["float64", "float32"])
def test_checkpoint_resume_matches_jax(tmp_path, jax_cfg, first_dtype):  # noqa: F811
    """tests/test_restart_resume.py:58: 5 steps with checkpoints, then a
    resume for 5 more, equal a straight run of 10; the JAX driver resumed
    from the port's checkpoints lands on the same state.  Checkpoints of a
    float32 run resume in float64 on both sides (cast as they are read)."""
    kw = dict(sig_yield=240.0, nstep=5, error_max=1e-10, et_e=0.1, target_lf=99.0)
    model, pmodel = tension_model(), ft.model_from_arrays(tension_model())
    cfg = port_config(cg_rtol=CG_RTOL)
    jax_cfg.cg_rtol = CG_RTOL
    ck = str(tmp_path / "ck")
    # a float32 run converges to its own floor, not to 1e-10
    kw_first = {**kw, "error_max": 1e-10 if first_dtype == "float64" else 1e-5}
    first = ft.solve_collapse(pmodel, ft.ControlParams(**kw_first), checkpoint_path=ck,
                              config=port_config(cg_rtol=CG_RTOL, dtype=first_dtype))
    assert len(first.history.lbd) == 6 and len(list((tmp_path / "ck").iterdir())) == 5
    lines = []
    resumed = ft.solve_collapse(pmodel, ft.ControlParams(**kw), resume_from=ck,
                                progress=lines.append, config=cfg)
    assert "resuming from checkpoint step 5" in lines
    ref = fcvm_tpu.solve_collapse(model, fcvm_tpu.ControlParams(**kw), resume_from=ck)
    assert len(resumed.history.lbd) == len(ref.history.lbd) == 11
    np.testing.assert_allclose(resumed.history.lbd, ref.history.lbd, rtol=RTOL, atol=0)
    np.testing.assert_allclose(resumed.disp_total, ref.disp_total, rtol=0,
                               atol=RTOL * np.abs(ref.disp_total).max())
    np.testing.assert_allclose(resumed.peeq_gp, ref.peeq_gp, rtol=0, atol=RTOL * ref.peeq_gp.max())
    assert resumed.sig_gp.dtype == np.float64 and ref.peeq_gp.max() > 0.0
    if first_dtype == "float64":
        full = ft.solve_collapse(pmodel, ft.ControlParams(**kw), config=cfg,
                                 continuation=lambda h, i: "add" if len(h.lbd) <= 6 else "stop")
        np.testing.assert_allclose(resumed.history.lbd, full.history.lbd, rtol=1e-9)
        np.testing.assert_allclose(resumed.disp_total, full.disp_total, rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(resumed.peeq_gp, full.peeq_gp, rtol=1e-6, atol=1e-15)


def test_default_config_matches_jax():
    """``FcvmConfig()`` keeps the JAX package's defaults (deflation,
    refinement and the float64 failover on) and runs them: the hardening
    case with the default config on both sides (both at ``cg_rtol =
    1e-12``, where every correction solve harvests or deflates) takes the
    same steps, Newton iterations and deflation spaces as the JAX package."""
    build, kw = CASES["hardening"]
    model = build()
    c = fcvm_tpu.config.get_config()
    saved = c.cg_rtol
    c.cg_rtol = CG_RTOL
    lines_ref, lines = [], []
    try:
        ref = fcvm_tpu.solve_collapse(model, fcvm_tpu.ControlParams(**kw),
                                      progress=lines_ref.append)
    finally:
        c.cg_rtol = saved
    cfg = ft.FcvmConfig(device="cpu", dtype="float64", cg_rtol=CG_RTOL)
    assert cfg.deflation and cfg.residual_refinement and cfg.precision_failover
    res = ft.solve_collapse(ft.model_from_arrays(model), ft.ControlParams(**kw),
                            progress=lines.append, config=cfg)
    assert len(res.history.lbd) == len(ref.history.lbd) > 1
    assert newton_per_step(lines) == newton_per_step(lines_ref)
    np.testing.assert_allclose(res.history.lbd, ref.history.lbd, rtol=RTOL, atol=0)
    built = [sum("deflation space: k=" in ln for ln in lg) for lg in (lines, lines_ref)]
    assert built[0] == built[1] > 0


def test_cuda_device_without_gpu_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ft.solve_collapse(ft.model_from_arrays(tension_model()), ft.ControlParams(nstep=2),
                          config=port_config(device="cuda"))


def test_continuation_actions():
    """("scale", v) records a display scale without resuming; "add" runs
    nstep more steps; an action that is neither a known one nor iterable
    raises ValueError."""
    model = ft.model_from_arrays(tension_model())
    params = ft.ControlParams(sig_yield=240.0, nstep=2, error_max=1e-10, et_e=0.1,
                              target_lf=99.0)
    actions = iter([[("scale", 25.0), "add"], None])
    res = ft.solve_collapse(model, params, continuation=lambda h, s: next(actions, None),
                            config=port_config())
    assert res.disp_scale == 25.0
    assert len(res.history.lbd) - 1 == 4
    with pytest.raises(ValueError, match="unrecognized continuation action"):
        ft.solve_collapse(model, params, continuation=lambda h, s: 5, config=port_config())
