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


UNPORTED = [
    (dict(solver="scipy"), {}),
    (dict(smoother="cluster"), {}),
    (dict(arc_length="crisfield"), {}),
    (dict(n_devices=2), {}),
    ({}, dict(gnl="GNLY")),
]


@pytest.mark.parametrize("cfg_kw,param_kw", UNPORTED,
                         ids=[next(iter({**c, **p})) for c, p in UNPORTED])
def test_unported_options_raise(cfg_kw, param_kw):
    model = ft.model_from_arrays(tension_model())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ft.solve_collapse(model, ft.ControlParams(nstep=2, **param_kw),
                          config=port_config(**cfg_kw))


def test_checkpointing_raises(tmp_path):
    model = ft.model_from_arrays(tension_model())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ft.solve_collapse(model, ft.ControlParams(nstep=2), checkpoint_path=str(tmp_path),
                          config=port_config())


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
