"""The port's float32 precision governance against the JAX package's
(``tests/test_precision_failover.py``): the residual-floor detector, the
tolerance clamp, float64 residual refinement and the float64 rerun.

The detector is fed the same error sequences on both sides and must take
the same decisions.  ``test_f32_floor_matches_jax`` runs both drivers in
float32 on the same model and holds the port's residual floors to the JAX
package's.  The other driver cases run the port alone in float32 on the
CPU and assert what the JAX tests assert.  Both packages' floors on this
model are about 1.4e-7 to 1.5e-7 on a step's first attempt and 4e-8 to 5e-8
(median) after the restart halves the increment, but the port's floor
errors scatter lower, down to 2.5e-8 against the JAX package's 3.1e-8, so
at the JAX clamp case's ``error_max`` of 3e-8 the port's Newton loop
converges on a low draw where the JAX one clamps.  The port's clamp case
therefore sits at 1.5e-8, below both packages' lowest floor error, where
the two clamp at the same steps.
"""

import re
import warnings

import numpy as np
import pytest
from torch_parity import tension_model

import fcvm_tpu
import fcvm_tpu_torch as ft
from fcvm_tpu.config import get_config
from fcvm_tpu.runtime import driver as jdrv
from fcvm_tpu_torch.runtime import driver as tdrv

# -- the floor detector: same sequences, same decisions ----------------------

_SEQ = [1e-3, 1e-5, 3e-7, 1.2e-7, 1.1e-7, 1.0e-7, 1.05e-7, 1.02e-7, 1.04e-7]
_LEVEL = 10.0 * jdrv._FLOOR_ESCALATE_CAP

# each case: (error_max, enabled, script); a script step is ("reset", attempt),
# ("observe", error) or ("mrr",), and every step's return value is compared
WATCH_CASES = {
    "converging_sequence_is_silent": (1e-10, True, [
        *[("observe", 10.0 * 0.5**i) for i in range(20)],
        *[("observe", e) for e in (1e-6, 5e-7, 2e-7, 1e-7)]]),
    "clamps_near_floor": (5e-8, True, [("reset", 1), *[("observe", e) for e in _SEQ]]),
    "escalates_far_above_error_max": (1e-12, True, [("reset", 1),
                                                    *[("observe", e) for e in _SEQ]]),
    "first_attempt_never_fires": (5e-8, True, [*[("observe", e) for e in _SEQ],
                                               ("reset", 1),
                                               *[("observe", e) for e in _SEQ]]),
    "rising_tail_is_divergence_not_floor": (1e-2, True, [
        ("reset", 1),
        *[("observe", e) for e in (2.43e-2, 1.75e-2, 1.57e-2, 1.55e-2, 1.62e-2, 1.72e-2,
                                   1.70e-2, 1.78e-2, 1.9e-2)],
        ("reset", 1),
        *[("observe", e) for e in (3.97e-2, 4.18e-2, 4.48e-2, 4.84e-2, 5.23e-2)],
        ("reset", 1),
        *[("observe", e) for e in (2.43e-2, 1.60e-2, 1.57e-2, 1.55e-2, 1.58e-2, 1.56e-2)]]),
    "physical_stagnation_is_left_to_restarts": (1e-6, True, [
        ("observe", _LEVEL * f) for f in (3.0, 1.5, 1.1, 1.0, 0.98, 1.02, 1.0)]),
    "disabled_and_mrr_predicate": (1e-12, False, [*[("observe", 1e-7)] * 10, ("mrr",)]),
    "mrr_near_converged": (1e-12, True, [*[("observe", e) for e in (1e-4, 1e-6, 2e-7,
                                                                    1.5e-7)], ("mrr",)]),
    "mrr_divergence": (1e-2, True, [*[("observe", e) for e in (5.0, 1.0, 0.4, 0.5)],
                                    ("mrr",)]),
}


def _play(cls, error_max, enabled, script):
    w = cls(error_max=error_max, enabled=enabled)
    out = []
    for op, *arg in script:
        if op == "reset":
            out.append(w.reset(attempt=arg[0]))
        elif op == "observe":
            out.append(w.observe(arg[0]))
        else:
            out.append(w.escalate_at_mrr())
    return out


@pytest.mark.parametrize("case", list(WATCH_CASES))
def test_floor_watch_decides_as_jax(case):
    error_max, enabled, script = WATCH_CASES[case]
    port = _play(tdrv._FloorWatch, error_max, enabled, script)
    assert port == _play(jdrv._FloorWatch, error_max, enabled, script)
    # the JAX tests' own claims, on the port's decisions
    acts = [a for a in port if a is not None]
    if case == "clamps_near_floor":
        assert port[-1][0] == "clamp"
        np.testing.assert_allclose(port[-1][1], 2.0e-7, rtol=0.2)
    elif case == "escalates_far_above_error_max":
        assert port[-1] == "escalate"
    elif case == "first_attempt_never_fires":
        assert all(a is None for a in port[: len(_SEQ)]) and port[-1][0] == "clamp"
    elif case == "rising_tail_is_divergence_not_floor":
        assert acts == [("clamp", pytest.approx(2 * 1.55e-2))]
    elif case == "mrr_near_converged":
        assert port[-1] is True
    elif case in ("mrr_divergence", "disabled_and_mrr_predicate"):
        assert port[-1] is False and not [a for a in port[:-1] if a is not None]
    else:
        assert not acts


def test_precision_constants_match_jax():
    for name in ("_FLOOR_WINDOW", "_FLOOR_IMPROVE", "_FLOOR_CLAMP_FACTOR",
                 "_FLOOR_ESCALATE_CAP", "_FLOOR_RISE"):
        assert getattr(tdrv, name) == getattr(jdrv, name), name


# -- the driver in float32 on the CPU ---------------------------------------


def _run(error_max, nstep=6, iterat_max=30, dtype="float32", **cfg_kw):
    model = ft.model_from_arrays(tension_model())
    kw = {} if iterat_max is None else dict(iterat_max=iterat_max)
    params = ft.ControlParams(sig_yield=240.0, nstep=nstep, error_max=error_max, et_e=0.1,
                              target_lf=99.0, **kw)
    lines = []
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res = ft.solve_collapse(model, params, progress=lines.append,
                                config=ft.FcvmConfig(device="cpu", dtype=dtype, **cfg_kw))
    return res, lines, [str(w.message) for w in rec]


def _last_error_per_step(lines):
    out = []
    for line in lines:
        if line.startswith("Step:"):
            out.append(None)
        m = re.search(r"Error: ([0-9.e+-]+)", line)
        if m and out:
            out[-1] = float(m.group(1))
    return out


def _floors(lines):
    """The Newton error's float32 floor of a run: the median error of step
    0's first attempt from its fourth iteration on, and the median and the
    least of the errors below 2e-7 after the first restart."""
    errs, first, later = [], None, []
    for ln in lines:
        if "RESTART" in ln and first is None:
            first = float(np.median(errs[3:]))
        m = re.search(r"Error: ([0-9.e+-]+)", ln)
        if m:
            errs.append(float(m.group(1)))
            if first is not None and errs[-1] < 2e-7:
                later.append(errs[-1])
    return first, float(np.median(later)), min(later)


FLOOR_BAND = 2.0  # the port's floors within this factor of the JAX package's


@pytest.mark.parametrize("error_max", [3e-8, 1.5e-8])
def test_f32_floor_matches_jax(error_max):
    """Both drivers in float32 on the tension box, at the JAX clamp case's
    error_max and at the port's: every step completes on both sides, the
    floors before and after the restart agree within ``FLOOR_BAND``, and
    below both floors (1.5e-8) both clamp the same steps after the same
    restarts.  Each side's floors, clamps and per-step last errors are
    printed."""
    params = dict(sig_yield=240.0, nstep=6, error_max=error_max, et_e=0.1, target_lf=99.0,
                  iterat_max=30)
    cfg = get_config()
    saved = cfg.dtype
    cfg.dtype = "float32"
    lines_ref = []
    try:
        ref = fcvm_tpu.solve_collapse(tension_model(), fcvm_tpu.ControlParams(**params),
                                      progress=lines_ref.append)
    finally:
        cfg.dtype = saved
    res, lines, _ = _run(error_max)
    runs = {"jax": (ref, lines_ref), "port": (res, lines)}
    floors = {}
    for side, (r, lg) in runs.items():
        floors[side] = _floors(lg)
        last = _last_error_per_step(lg)
        print(f"{side}: floors (first attempt, after restart: median, least) "
              f"{floors[side]}; clamps at steps {r.cg_stats['floor_clamp_steps']}; "
              f"restarts {sum('RESTART' in ln for ln in lg)}; last error per step {last}")
        assert len(r.history.lbd) == 7 and not any("MAXIMUM RESTARTS" in ln for ln in lg)
        for step, err in enumerate(last):
            if step not in r.cg_stats["floor_clamp_steps"]:
                assert err <= error_max
    for i in range(2):
        assert 1 / FLOOR_BAND <= floors["port"][i] / floors["jax"][i] <= FLOOR_BAND
    if error_max < min(floors["jax"][2], floors["port"][2]):
        assert res.cg_stats["floor_clamp_steps"] == ref.cg_stats["floor_clamp_steps"]
        assert (sum("RESTART" in ln for ln in lines)
                == sum("RESTART" in ln for ln in lines_ref))


def test_noise_floor_stepping_completes_f32():
    """error_max just under the first-attempt floor: every step completes,
    with at most one re-probe restart per step and never MAXIMUM RESTARTS."""
    res, lines, _ = _run(5e-8)
    lbd = np.asarray(res.history.lbd)
    assert len(lbd) == 7 and np.all(np.diff(lbd) > 0)
    assert not any("MAXIMUM RESTARTS" in ln for ln in lines)
    assert sum("RESTART" in ln for ln in lines) <= 6


def test_noise_clamped_stepping_completes_f32():
    """error_max below even the restart-halved floor (1.5e-8, where the JAX
    test has 3e-8: see the module's note and ``test_f32_floor_matches_jax``):
    the second attempt of the first floored step clamps, and later floored
    steps clamp on their first attempt."""
    res, lines, _ = _run(1.5e-8)
    assert res.cg_stats["floor_clamps"] >= 3
    assert len(res.history.lbd) == 7
    assert 1 <= sum("RESTART" in ln for ln in lines) <= 2


def test_refinement_converges_below_f32_floor():
    """error_max two decades below the float32 floor: the float64 residual
    refinement fires and the run converges in place (no rerun).  Every step
    that was not clamped ends at or below error_max; at most one clamp."""
    error_max = 1e-9
    res, lines, warned = _run(error_max, iterat_max=25)
    assert not any("residual floor" in w for w in warned)
    assert not any(ln.startswith("PRECISION FAILOVER") for ln in lines)
    assert any("f64 residual refinement" in ln for ln in lines)
    assert res.cg_stats["refinement_activations"] >= 1
    clamped = res.cg_stats["floor_clamp_steps"]
    print(f"floor clamps: {res.cg_stats['floor_clamps']} at steps {clamped}")
    assert res.cg_stats["floor_clamps"] <= 1
    assert len(res.history.lbd) == 7
    last = _last_error_per_step(lines)
    assert len(last) == 6
    for step, err in enumerate(last):
        assert err is not None and err <= (5.0 if step in clamped else 1.0) * error_max
    # every step is elastic (yield at LF 2.4): the path is the linear one
    np.testing.assert_allclose(res.disp_total, res.history.lbd[-1] * res.disp_el,
                               rtol=2e-5, atol=1e-12)


def test_refinement_keeps_float32_state():
    """A refined run keeps its Gauss state float32 and leaves the caller's
    config as it was."""
    cfg = ft.FcvmConfig(device="cpu", dtype="float32")
    model = ft.model_from_arrays(tension_model())
    params = ft.ControlParams(sig_yield=240.0, nstep=3, error_max=1e-9, et_e=0.1,
                              target_lf=99.0, iterat_max=25)
    res = ft.solve_collapse(model, params, config=cfg)
    assert res.cg_stats["refinement_activations"] >= 1
    assert len(res.history.lbd) == 4
    assert res.sig_gp.dtype == np.float32 and res.disp_total.dtype == np.float64
    assert cfg.dtype == "float32"


def test_escalation_reruns_in_f64():
    """error_max far below the float32 floor with refinement off: the run
    escalates and reruns in float64, which converges to error_max."""
    res, lines, warned = _run(1e-12, iterat_max=25, residual_refinement=False)
    assert any("residual floor" in w for w in warned)
    assert any(ln.startswith("PRECISION FAILOVER") for ln in lines)
    ref, _, _ = _run(1e-12, iterat_max=25, dtype="float64")
    np.testing.assert_allclose(res.history.lbd, ref.history.lbd, rtol=1e-12)
    np.testing.assert_allclose(res.disp_total, ref.disp_total, rtol=1e-10)
    assert res.cg_stats["floor_clamps"] == 0


def test_failover_disabled_raises():
    """With the watch off the reference restart ladder runs and abandons the
    first step (MAXIMUM RESTARTS)."""
    res, lines, _ = _run(1e-12, iterat_max=25, precision_failover=False)
    assert list(res.history.lbd) == [0.0]
    assert any("MAXIMUM RESTARTS" in ln for ln in lines)


def test_f64_tier_never_watches():
    res, _, _ = _run(1e-11, nstep=4, iterat_max=None, dtype="float64")
    assert res.cg_stats["floor_clamps"] == 0
    assert len(res.history.lbd) == 5
