"""Per-element materials (``Model.materials_by_element``) in the port against
the JAX package, CPU float64: the series bar and the gravity densities of
``tests/test_physics_cases.py:127-184`` on both sides, and a geometrically
nonlinear plastic case and a buckling case with a stiffer region, where a
single (6, 6) elasticity matrix left anywhere (elastic or tangent formation,
the residual, the tangent refresh's element order, the buckling pencil)
would change the answer.
"""

import dataclasses

import numpy as np
import pytest
from torch_parity import L, jax_cfg, newton_per_step, port_config, symmetry_bcs  # noqa: F401

import fcvm_tpu
import fcvm_tpu_torch as ft
from fcvm_tpu.models import meshgen
from fcvm_tpu_torch.runtime.backend import TorchSystem

CG_RTOL = 1e-12
RTOL = 1e-8


def _both(model, kw, jax_cfg):  # noqa: F811
    jax_cfg.cg_rtol = CG_RTOL
    lines_ref, lines = [], []
    ref = fcvm_tpu.solve_collapse(model, fcvm_tpu.ControlParams(**kw), progress=lines_ref.append)
    res = ft.solve_collapse(ft.model_from_arrays(model), ft.ControlParams(**kw),
                            progress=lines.append, config=port_config(cg_rtol=CG_RTOL))
    return ref, res, lines_ref, lines


def _series_bar():
    """tests/test_physics_cases.py:127-158: E 100,000 for x < 5, 200,000
    beyond, nu 0, uniform tension 100."""
    mesh = meshgen.box_tet10(4, 2, 2, L, 5.0, 5.0)
    centroids = mesh.coords[mesh.elnodes[:, :4]].mean(axis=1)
    mbe = np.zeros((mesh.n_elements, 3))
    mbe[:, 0] = np.where(centroids[:, 0] < L / 2, 100000.0, 200000.0)
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    loads = fcvm_tpu.Loads(traction_faces=faces, tractions=np.tile([100.0, 0, 0], (len(faces), 1)))
    return fcvm_tpu.Model(mesh, fcvm_tpu.Material(100000.0, 0.0), symmetry_bcs(mesh), loads,
                          name="series", materials_by_element=mbe)


def test_multi_material_series_bar(jax_cfg):  # noqa: F811
    """u(L) = sigma (L1/E1 + L2/E2) on both sides, and the same field."""
    model = _series_bar()
    ref, res, *_ = _both(model, dict(sig_yield=1e6, nstep=2, error_max=1e-10, target_lf=1.0),
                         jax_cfg)
    end = model.mesh.select_nodes(lambda x, y, z: x > L - 1e-9)
    ux = res.disp_total.reshape(-1, 3)[end, 0]
    np.testing.assert_allclose(ux, 100.0 * (L / 2 / 100000.0 + L / 2 / 200000.0), rtol=1e-7)
    np.testing.assert_allclose(res.disp_total, ref.disp_total, rtol=0,
                               atol=RTOL * np.abs(ref.disp_total).max())
    np.testing.assert_allclose(res.sig_gp, ref.sig_gp, rtol=0, atol=RTOL * np.abs(ref.sig_gp).max())


def test_multi_material_gravity_density(jax_cfg):  # noqa: F811
    """tests/test_physics_cases.py:161-184: total weight sum(rho_i g V_i),
    and the same load sums, displacements and backend arrays as JAX's."""
    mesh = meshgen.box_tet10(2, 2, 4, 2.0, 2.0, 8.0)
    centroids = mesh.coords[mesh.elnodes[:, :4]].mean(axis=1)
    mbe = np.zeros((mesh.n_elements, 3))
    mbe[:, 0], mbe[:, 1] = 210000.0, 0.3
    rho1, rho2, g = 1.0e-6, 3.0e-6, 9810.0
    mbe[:, 2] = np.where(centroids[:, 2] < 4.0, rho1, rho2)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: z < 1e-9), (0.0, 0.0, 0.0))])
    model = fcvm_tpu.Model(mesh, fcvm_tpu.Material(210000.0, 0.3, rho1), bcs,
                           fcvm_tpu.Loads(gravity=[0.0, 0.0, -g]), materials_by_element=mbe)
    ref, res, *_ = _both(model, dict(sig_yield=1e9, nstep=1), jax_cfg)
    np.testing.assert_allclose(res.loadsums[2], -g * 16.0 * (rho1 + rho2), rtol=1e-9)
    np.testing.assert_allclose(res.loadsums, ref.loadsums, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(res.disp_total, ref.disp_total, rtol=0,
                               atol=RTOL * np.abs(ref.disp_total).max())
    be = TorchSystem(ft.model_from_arrays(model), port_config(), ft.FcvmConfig().resolve_dtype(),
                     port_config().resolve_device())
    assert be.dmat.shape == (mesh.n_elements, 6, 6) and be.density.shape == (mesh.n_elements,)


def _region_box(kind):
    """A 2x3x2 symmetry box (whose solve-space element order moves a third
    of the elements across the region boundary) with E doubled and nu 0.25
    for x > 5, pulled on x = L by a traction or a (follower) pressure."""
    mesh = meshgen.box_tet10(2, 3, 2, L, L, L)
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    if kind == "traction":
        loads = fcvm_tpu.Loads(traction_faces=faces,
                               tractions=np.tile([100.0, 0, 0], (len(faces), 1)))
    else:
        loads = fcvm_tpu.Loads(pressure_faces=faces, pressures=np.full(len(faces), 100.0))
    centroids = mesh.coords[mesh.elnodes[:, :4]].mean(axis=1)
    mbe = np.tile([210000.0, 0.3, 0.0], (mesh.n_elements, 1))
    mbe[centroids[:, 0] > L / 2, :2] = [420000.0, 0.25]
    return fcvm_tpu.Model(mesh, fcvm_tpu.Material(210000.0, 0.3), symmetry_bcs(mesh), loads,
                          materials_by_element=mbe)


@pytest.mark.parametrize("kind", ["traction", "pressure"])
def test_gnl_region_matches_jax(kind, jax_cfg):  # noqa: F811
    """GNL plastic steps with a stiffer region: the tangent refresh forms
    its blocks in the solve space's element order, so the per-element
    materials must follow; the same steps, Newton iterations, load factors
    and plastic strain as the JAX package's."""
    kw = dict(sig_yield=60.0, nstep=3, error_max=1e-8, et_e=0.1, target_lf=99.0,
              gnl="GNLY", max_imp=0.0)
    ref, res, lines_ref, lines = _both(_region_box(kind), kw, jax_cfg)
    assert len(res.history.lbd) == len(ref.history.lbd) == 4
    assert newton_per_step(lines) == newton_per_step(lines_ref)
    assert res.cg_stats["predictor_solves"] > 0
    np.testing.assert_allclose(res.history.lbd, ref.history.lbd, rtol=RTOL, atol=0)
    np.testing.assert_allclose(res.history.peeqmax, ref.history.peeqmax, rtol=RTOL, atol=1e-12)
    assert ref.peeq_gp.max() > 0.0
    np.testing.assert_allclose(res.peeq_gp, ref.peeq_gp, rtol=0, atol=RTOL * ref.peeq_gp.max())


def test_buckling_region_matches_jax(jax_cfg):  # noqa: F811
    """``gnl="GNLY"``, ``nstep == 1``: the buckling factors of a column whose
    clamped half is three times stiffer, on both sides, and against the
    uniform column's (the region must move them)."""
    mesh = meshgen.box_tet10(8, 1, 1, 20.0, 1.0, 1.0)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, 0.0, 0.0))])
    end = mesh.faces_on(lambda x, y, z: x > 20.0 - 1e-9)
    loads = fcvm_tpu.Loads(traction_faces=end, tractions=np.tile([-1000.0, 0, 0], (len(end), 1)))
    centroids = mesh.coords[mesh.elnodes[:, :4]].mean(axis=1)
    mbe = np.tile([210000.0, 0.3, 0.0], (mesh.n_elements, 1))
    mbe[centroids[:, 0] < 10.0, 0] = 630000.0
    model = fcvm_tpu.Model(mesh, fcvm_tpu.Material(210000.0, 0.3), bcs, loads,
                           materials_by_element=mbe)
    kw = dict(gnl="GNLY", nstep=1)
    ref, res, *_ = _both(model, kw, jax_cfg)
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=1e-7)
    uniform = dataclasses.replace(ft.model_from_arrays(model), materials_by_element=None)
    lam_uniform = ft.solve_collapse(uniform, ft.ControlParams(**kw),
                                    config=port_config(cg_rtol=CG_RTOL)).eigenvalues
    assert np.all(res.eigenvalues > 1.2 * lam_uniform)
