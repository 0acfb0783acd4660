"""The port's ``solve_collapse`` with geometric nonlinearity
(``gnl="GNLY"``, ``max_imp = 0``, ``nstep > 1``) against the JAX package's,
CPU float64, on the tension box of ``tests/test_fused_newton.py`` and its
pressure-loaded twin; and the port alone on the GNL cases of
``tests/test_buckling_gnl.py``.

The JAX side runs its unfused Newton path (``fused_newton = False``; the
fused one agrees with it to 1e-12, ``tests/test_fused_newton.py:61-78``),
which goes through ``LocalSystem.solve`` and ``LocalSystem.tangent_refresh``;
wrapping those two records the CG count of every correction solve and of
every tangent predictor.  With the block-Jacobi preconditioner both sides
run the same arithmetic, so at ``cg_rtol = 1e-10`` the counts must be
equal.  (At the default 1e-6 Newton takes more iterations, and the last
ones solve a residual that is mostly rounding, whose CG count moves by a
few between two implementations; at 1e-12, near the attainable float64
accuracy, a stop moves by one or two.)  The two-level preconditioner differs
in its coarse inverse (float32 in the JAX package, the working dtype in the
port), so that case solves to 1e-12 and compares the equilibrium path only.

The shallow-arch snap-through of ``tests/test_buckling_gnl.py:167-202``
takes about five minutes on the port's CPU path, far over this file's
budget, so it is not run here.
"""

import numpy as np
import pytest
from torch_parity import E, L, NU, TIERS_OFF, newton_per_step, port_config, symmetry_bcs

import fcvm_tpu
import fcvm_tpu_torch as ft
from fcvm_tpu.config import get_config
from fcvm_tpu.models import meshgen
from fcvm_tpu.runtime.backend import LocalSystem

RTOL = 1e-8
# tests/test_fused_newton.py:43-46
GNL = dict(sig_yield=60.0, nstep=3, error_max=1e-8, et_e=0.1, target_lf=99.0,
           gnl="GNLY", max_imp=0.0)


def _box(kind):
    """The 2x2x2 symmetry box pulled on its x = L face by a uniform
    traction, or by a pressure (a follower load in GNL)."""
    mesh = meshgen.box_tet10(2, 2, 2, L, L, L)
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    if kind == "traction":
        loads = fcvm_tpu.Loads(traction_faces=faces,
                               tractions=np.tile([100.0, 0, 0], (len(faces), 1)))
    else:
        loads = fcvm_tpu.Loads(pressure_faces=faces, pressures=np.full(len(faces), 100.0))
    return fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), symmetry_bcs(mesh), loads)


@pytest.fixture
def jax_run(monkeypatch):
    """Run the JAX package's unfused driver with config ``fields`` set
    (restored afterwards); returns its result, log lines and CG counts."""
    cfg = get_config()
    counts = {"cg": [], "predictor": []}
    solve, refresh = LocalSystem.solve, LocalSystem.tangent_refresh

    def counted_solve(self, *a, **kw):
        res = solve(self, *a, **kw)
        counts["cg"].append(int(res.iters))
        return res

    def counted_refresh(self, *a, **kw):
        out = refresh(self, *a, **kw)
        counts["predictor"].append(int(out[4]))
        return out

    monkeypatch.setattr(LocalSystem, "solve", counted_solve)
    monkeypatch.setattr(LocalSystem, "tangent_refresh", counted_refresh)

    def run(model, params_kw, **fields):
        for f, v in {"fused_newton": False, **fields}.items():
            monkeypatch.setattr(cfg, f, v)
        lines = []
        res = fcvm_tpu.solve_collapse(model, fcvm_tpu.ControlParams(**params_kw),
                                      progress=lines.append)
        return res, lines, counts

    return run


def _flat(steps, key):
    return [n for s in steps for n in s[key]]


CASES = {  # load, preconditioner, arc length, cg_rtol
    "traction_block_jacobi": ("traction", "block_jacobi", "riks", 1e-10),
    "traction_two_level": ("traction", "two_level", "riks", 1e-12),
    "pressure_block_jacobi": ("pressure", "block_jacobi", "riks", 1e-10),
    "crisfield_block_jacobi": ("traction", "block_jacobi", "crisfield", 1e-10),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gnl_collapse_matches_jax(case, jax_run):
    """The solver tiers off on both sides: the same steps, Newton iterations
    per step, tangent refreshes and predictor solves, ``lbd``/``un`` to
    1e-8 and the displacements and stresses to 1e-8 of their largest entry;
    with the block-Jacobi preconditioner also the CG count of every
    correction solve and every predictor."""
    load, precond, arc, cg_rtol = CASES[case]
    model = _box(load)
    ref, lines_ref, counts = jax_run(model, GNL, **TIERS_OFF, load_deflation=False,
                                     cg_rtol=cg_rtol, precond=precond, arc_length=arc)
    lines = []
    res = ft.solve_collapse(ft.model_from_arrays(model), ft.ControlParams(**GNL),
                            progress=lines.append,
                            config=port_config(cg_rtol=cg_rtol, precond=precond,
                                               arc_length=arc))
    h, hr = res.history, ref.history
    assert len(h.lbd) == len(hr.lbd) == GNL["nstep"] + 1
    assert newton_per_step(lines) == newton_per_step(lines_ref)
    assert sum(newton_per_step(lines)) > GNL["nstep"]
    steps = res.cg_stats["steps"]
    assert res.cg_stats["predictor_solves"] == ref.cg_stats["predictor_solves"] \
        == len(_flat(steps, "predictor")) == len(counts["predictor"]) > 0
    assert res.cg_stats["solves"] == ref.cg_stats["solves"] == len(counts["cg"])
    if precond == "block_jacobi":
        assert _flat(steps, "cg") == counts["cg"][1:]
        assert _flat(steps, "predictor") == counts["predictor"]
        assert res.cg_stats["iters"] == ref.cg_stats["iters"]
        assert res.cg_stats["predictor_iters"] == ref.cg_stats["predictor_iters"]
    assert res.cg_stats["tangent_time"] > 0.0
    np.testing.assert_allclose(h.lbd, hr.lbd, rtol=RTOL, atol=0)
    np.testing.assert_allclose(h.un, hr.un, rtol=RTOL, atol=0)
    np.testing.assert_allclose(h.peeqmax, hr.peeqmax, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(res.disp_total, ref.disp_total, rtol=0,
                               atol=RTOL * np.abs(ref.disp_total).max())
    np.testing.assert_allclose(res.sig_gp, ref.sig_gp, rtol=0,
                               atol=RTOL * np.abs(ref.sig_gp).max())
    assert ref.peeq_gp.max() > 0.0  # the case is plastic


def test_gnl_small_strain_matches_linear():
    """At strain 5e-5 the GNL path agrees with small strain
    (``tests/test_buckling_gnl.py:132-164``), and GNL reports the total
    displacement whatever ``disp_output`` says."""
    mesh = meshgen.box_tet10(2, 2, 2, L, L, L)
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    model = ft.model_from_arrays(fcvm_tpu.Model(
        mesh, fcvm_tpu.Material(E, NU), symmetry_bcs(mesh),
        fcvm_tpu.Loads(traction_faces=faces, tractions=np.tile([10.0, 0, 0], (len(faces), 1)))))
    end = mesh.select_nodes(lambda x, y, z: x > L - 1e-9)
    kw = dict(sig_yield=240.0, nstep=4, error_max=1e-10, target_lf=1.0,
              disp_output="incremental")
    lin = ft.solve_collapse(model, ft.ControlParams(**kw), config=port_config())
    gnl = ft.solve_collapse(model, ft.ControlParams(**kw, gnl="GNLY", max_imp=0.0),
                            config=port_config())
    ux_lin = lin.disp_total.reshape(-1, 3)[end, 0].mean()
    ux_gnl = gnl.disp_total.reshape(-1, 3)[end, 0].mean()
    assert abs(ux_gnl - ux_lin) / abs(ux_lin) < 5e-4
    assert abs(ux_gnl - ux_lin) > 0.0
    np.testing.assert_array_equal(gnl.disp, gnl.disp_total)
    assert gnl.cg_stats["predictor_solves"] > 0 == lin.cg_stats["predictor_solves"]
