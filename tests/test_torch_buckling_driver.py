"""The port's ``solve_collapse`` through the buckling branch against the JAX
package's, CPU float64: elastic buckling only (``gnl="GNLY"``, ``nstep ==
1``), imperfection seeding then collapse (``max_imp != 0``), and the scipy
direct tier (``solver="scipy"``) in small strain and in GNL; and the port
alone on the driver cases of ``tests/test_buckling_gnl.py`` (lines 43, 84).

Where eigenpairs are compared, both eigensolves start from the JAX
package's start block (``jax.random.normal(PRNGKey(0), (ndof, m))``, handed
to the port's ``buckling_from_arrays`` as ``v0``), both run the
block-Jacobi preconditioner and every CG solve runs to 1e-10 (at the
default 1e-6 the two pre-stress solves differ by ~1e-8, and so do the
factors).  The JAX side runs its unfused Newton path, as
``tests/test_torch_gnl_driver.py`` explains.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import E, L, NU, TIERS_OFF, newton_per_step, port_config, symmetry_bcs
from torch_parity import tension_model

import fcvm_tpu
import fcvm_tpu_torch as ft
from fcvm_tpu.config import get_config
from fcvm_tpu.models import meshgen
from fcvm_tpu_torch.runtime import backend as tbackend
from fcvm_tpu_torch.utils.indexing import pad_ndof

RTOL = 1e-8
CG_RTOL = 1e-10


def column_model(nx=6, ny=2, lc=20.0, p=1000.0):
    """The clamped-free column of ``tests/test_buckling_gnl.py:16-26`` with
    an ny x 1 section (unit cells) under an end traction ``p`` per unit
    force: ny = 2 makes its two lowest modes distinct (weak and strong
    axis), so the imperfection blend is determined."""
    mesh = meshgen.box_tet10(nx, ny, 1, lc, float(ny), 1.0)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, 0.0, 0.0))])
    faces = mesh.faces_on(lambda x, y, z: x > lc - 1e-9)
    loads = fcvm_tpu.Loads(traction_faces=faces,
                           tractions=np.tile([-p / ny, 0, 0], (len(faces), 1)))
    return fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), bcs, loads)


@pytest.fixture
def both(monkeypatch):
    """Run a model through both drivers with the solver tiers off, the
    block-Jacobi preconditioner, CG to 1e-10 and the JAX start block;
    ``fields`` set on both configurations (restored afterwards)."""
    cfg = get_config()

    def run(model, params_kw, **fields):
        fields = {**TIERS_OFF, "precond": "block_jacobi", "cg_rtol": CG_RTOL, **fields}
        for f, v in {"fused_newton": False, "load_deflation": False, **fields}.items():
            monkeypatch.setattr(cfg, f, v)
        m = max(cfg.n_eig_vectors, 2 * 2, 2 + 4)  # k = 2 modes
        v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                          (pad_ndof(model.mesh.ndof), m), dtype=jnp.float64))
        monkeypatch.setattr(tbackend, "buckling_from_arrays",
                            functools.partial(tbackend.buckling_from_arrays, v0=v0))
        lines_ref, lines = [], []
        ref = fcvm_tpu.solve_collapse(model, fcvm_tpu.ControlParams(**params_kw),
                                      progress=lines_ref.append)
        res = ft.solve_collapse(ft.model_from_arrays(model), ft.ControlParams(**params_kw),
                                progress=lines.append, config=port_config(**fields))
        return res, ref, lines, lines_ref

    return run


def test_elastic_buckling_through_driver(both):
    """``tests/test_buckling_gnl.py:43-56`` on both drivers: ``nstep == 1``
    returns the two factors, the modes and the elastic displacement at
    full load; the factors to 1e-8, the modes and displacements to 1e-8 of
    their max, the factors within 5% of Euler's clamped-free load, and the
    end's axial shortening within 5% of ``P L / (E A)``."""
    lc, ny, p = 20.0, 2, 1000.0
    model = column_model(nx=6, ny=ny, lc=lc, p=p)
    res, ref, _, _ = both(model, dict(gnl="GNLY", nstep=1, max_imp=0.0))
    assert res.eigenvalues.shape == (2,) and res.eigenvectors.shape == (model.mesh.ndof, 2)
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=RTOL)
    np.testing.assert_allclose(res.eigenvectors, ref.eigenvectors, rtol=0,
                               atol=RTOL * np.abs(ref.eigenvectors).max())
    np.testing.assert_allclose(res.disp_total, ref.disp_total, rtol=0,
                               atol=RTOL * np.abs(ref.disp_total).max())
    assert res.history.lbd == [0.0, 1.0]
    euler = np.pi**2 * E * np.array([ny * 1.0**3, 1.0 * ny**3]) / 12 / (4 * lc**2) / p
    np.testing.assert_allclose(res.eigenvalues, euler, rtol=0.05)  # 6 cells along
    end = model.mesh.select_nodes(lambda x, y, z: x > lc - 1e-9)
    ux = res.disp_total.reshape(-1, 3)[end, 0].mean()
    assert abs(ux + p * lc / (E * ny)) < 0.05 * p * lc / (E * ny)


def test_imperfection_seeding_matches_jax(both):
    """``tests/test_buckling_gnl.py:84-93`` with a blend of both modes (ev1
    1, ev2 0.3) and three GNL load steps after it: equal perturbed
    coordinates (``max_imp`` applied to 1e-9), equal steps and Newton
    iterations per step, ``lbd`` to 1e-8, factors to 1e-8."""
    model = column_model(nx=4, ny=2, p=100.0)
    params = dict(gnl="GNLY", nstep=3, max_imp=0.05, ev1=1.0, ev2=0.3, sig_yield=60.0,
                  et_e=0.1, error_max=1e-8, target_lf=99.0)
    res, ref, lines, lines_ref = both(model, params)
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=RTOL)
    np.testing.assert_array_equal(res.coords_old, model.mesh.coords)
    np.testing.assert_allclose(np.abs(res.coords - res.coords_old).max(), 0.05, rtol=1e-9)
    np.testing.assert_allclose(res.coords, ref.coords, rtol=0, atol=1e-9 * 0.05)
    assert len(res.history.lbd) == len(ref.history.lbd) == params["nstep"] + 1
    assert newton_per_step(lines) == newton_per_step(lines_ref)
    np.testing.assert_allclose(res.history.lbd, ref.history.lbd, rtol=RTOL, atol=0)
    np.testing.assert_allclose(res.disp_total, ref.disp_total, rtol=0,
                               atol=RTOL * np.abs(ref.disp_total).max())
    # the imperfection bends the column from the first step on
    v = res.disp_total.reshape(-1, 3)
    assert np.abs(v[:, 1:]).max() > 0.1 * np.abs(v[:, 0]).max()


def _box_gnl(n=2):
    """The 2x2x2 symmetry box pulled on its x = L face by a uniform
    traction (``tests/test_fused_newton.py:43-46``)."""
    mesh = meshgen.box_tet10(n, n, n, L, L, L)
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    loads = fcvm_tpu.Loads(traction_faces=faces, tractions=np.tile([100.0, 0, 0], (len(faces), 1)))
    return fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), symmetry_bcs(mesh), loads)


SCIPY_CASES = {  # model, control parameters
    "small_strain": (tension_model, dict(sig_yield=100.0, nstep=4, error_max=1e-8,
                                         target_lf=99.0, et_e=0.05)),
    "gnl": (_box_gnl, dict(sig_yield=60.0, nstep=3, error_max=1e-8, et_e=0.1,
                           target_lf=99.0, gnl="GNLY", max_imp=0.0)),
}


@pytest.mark.parametrize("case", list(SCIPY_CASES))
def test_scipy_tier_driver_matches_jax(case, both):
    """``solver="scipy"`` on both drivers: every linear solve a host LU
    (0 CG iterations, no harvest), the same steps and Newton iterations per
    step, ``lbd``, displacements and stresses to 1e-8."""
    make, params = SCIPY_CASES[case]
    res, ref, lines, lines_ref = both(make(), params, solver="scipy")
    h, hr = res.history, ref.history
    assert len(h.lbd) == len(hr.lbd) == params["nstep"] + 1
    assert newton_per_step(lines) == newton_per_step(lines_ref)
    assert sum(newton_per_step(lines)) >= params["nstep"]
    assert res.cg_stats["iters"] == 0 and res.cg_stats["harvests"] == []
    assert res.cg_stats["solves"] == ref.cg_stats["solves"] > params["nstep"]
    np.testing.assert_allclose(h.lbd, hr.lbd, rtol=RTOL, atol=0)
    np.testing.assert_allclose(res.disp_total, ref.disp_total, rtol=0,
                               atol=RTOL * np.abs(ref.disp_total).max())
    np.testing.assert_allclose(res.sig_gp, ref.sig_gp, rtol=0,
                               atol=RTOL * np.abs(ref.sig_gp).max())
    assert ref.peeq_gp.max() > 0.0  # the case is plastic
