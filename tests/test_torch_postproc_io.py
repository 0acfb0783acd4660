"""The port's post-processing, report writers, VTK export, ``.inp`` files
and ``run_analysis`` against the JAX package's (``tests/test_postproc_io.py``),
CPU float64.

The host functions get the same seeded numpy inputs on both sides (nodal
and Gauss fields on the small plate with a hole, whose fields are not
uniform) and must agree to 1e-12; the writers get one JAX ``AnalysisResults``
and must write the same bytes.
"""

import numpy as np
import pytest
from torch_parity import jax_cfg, plate_model, port_config, tension_model  # noqa: F401

import fcvm_tpu
import fcvm_tpu_torch as ft
from fcvm_tpu.models.inp import ControlParams as JaxParams
from fcvm_tpu.models.inp import read_inp as jax_read_inp
from fcvm_tpu.models.inp import write_inp as jax_write_inp
from fcvm_tpu.ops import postproc as jpp
from fcvm_tpu.runtime import report as jrep
from fcvm_tpu.runtime import vtk as jvtk
from fcvm_tpu_torch.models.inp import read_inp, write_inp
from fcvm_tpu_torch.ops import postproc as tpp
from fcvm_tpu_torch.runtime import report as trep
from fcvm_tpu_torch.runtime import vtk as tvtk

TOL = 1e-12


@pytest.fixture(scope="module")
def plate():
    """The small plate's mesh and seeded Gauss fields (ne, 4, ...)."""
    mesh = plate_model().mesh
    rng = np.random.default_rng(7)
    ne = mesh.n_elements
    gauss = dict(sig_gp=rng.normal(scale=80.0, size=(ne, 4, 6)),
                 peeq_gp=rng.uniform(0.0, 0.02, size=(ne, 4)),
                 csr_gp=rng.uniform(0.0, 1.5, size=(ne, 4)),
                 svm_gp=rng.uniform(0.0, 120.0, size=(ne, 4)))
    return mesh, gauss


@pytest.mark.parametrize("averaged", [True, False], ids=["averaged", "unaveraged"])
def test_map_stresses_matches_jax(plate, averaged):
    mesh, g = plate
    args = (averaged, mesh.elnodes, mesh.n_nodes, g["sig_gp"], g["peeq_gp"], g["csr_gp"],
            g["svm_gp"], mesh.elements_per_node(), 100.0)
    ft_mesh = ft.model_from_arrays(plate_model()).mesh
    np.testing.assert_array_equal(ft_mesh.elements_per_node(), mesh.elements_per_node())
    for got, want in zip(tpp.map_stresses(*args), jpp.map_stresses(*args)):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.abs(want).max())


def test_principal_stresses_matches_jax(plate):
    stress = plate[1]["sig_gp"].reshape(-1, 6)
    for got, want in zip(tpp.principal_stresses(stress), jpp.principal_stresses(stress)):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.abs(want).max())


def test_integrate_edges_faces_matches_jax(plate):
    """Length and area averages over the plate's loaded face, its hole and
    edges on its boundary, of seeded nodal fields; the port batches a
    group's faces through ``tri6_surface_frame`` where the JAX package
    loops over them."""
    mesh = plate[0]
    rng = np.random.default_rng(8)
    fields = [rng.normal(size=mesh.n_nodes) for _ in range(3)]
    faces = [mesh.faces_on(lambda x, y, z: y > 100 - 1e-6),
             mesh.faces_on(lambda x, y, z: x**2 + y**2 < 10.0**2 + 1e-6),
             np.zeros((0, 6), np.int32)]
    edges = [mesh.edges_on(lambda x, y, z: (z < 1e-9) & (y > 100 - 1e-6)),
             mesh.edges_on(lambda x, y, z: (x < 1e-9) & (z > 5.0 - 1e-9))]
    ft_mesh = ft.model_from_arrays(plate_model()).mesh
    np.testing.assert_array_equal(ft_mesh.boundary_edges(), mesh.boundary_edges())
    np.testing.assert_array_equal(
        ft_mesh.edges_on(lambda x, y, z: x < 1e-9), mesh.edges_on(lambda x, y, z: x < 1e-9))
    for fn_t, fn_j, groups in ((tpp.integrate_faces, jpp.integrate_faces, faces),
                               (tpp.integrate_edges, jpp.integrate_edges, edges)):
        (m_t, avg_t), (m_j, avg_j) = fn_t(groups, mesh.coords, *fields), fn_j(
            groups, mesh.coords, *fields)
        np.testing.assert_allclose(m_t, m_j, rtol=TOL, atol=0)
        np.testing.assert_allclose(avg_t, avg_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tpp.integrate_faces(faces[:1], mesh.coords)[0], [250.0], rtol=TOL)


def test_reinforcement_and_mohr_coulomb_match_jax(plate):
    stress = plate[1]["sig_gp"].reshape(-1, 6)[:500]
    np.testing.assert_allclose(tpp.reinforcement_rho(stress, 435.0),
                               jpp.reinforcement_rho(stress, 435.0), rtol=TOL, atol=1e-14)
    s1, s3 = stress[:, 0], stress[:, 1]
    np.testing.assert_allclose(tpp.mohr_coulomb(s1, s3, 0.5, 30.0),
                               jpp.mohr_coulomb(s1, s3, 0.5, 30.0), rtol=TOL, atol=1e-12)


@pytest.fixture(scope="module")
def jax_results():
    """Two JAX results: the small-strain uniaxial run of
    tests/test_postproc_io.py (target 2.6) and a GNL buckling run, whose
    export adds the elastic displacement and the mode shapes."""
    model = tension_model()
    model.name = "uniax"
    params = fcvm_tpu.ControlParams(sig_yield=240.0, nstep=8, error_max=1e-9, et_e=0.1,
                                    target_lf=2.6, ultimate_strain=0.25)
    res = fcvm_tpu.solve_collapse(
        model, params, continuation=lambda h, i: "add" if abs(h.lbd[-1] - 2.6) > 1e-9 else "stop")
    col = tension_model(sigma=-1000.0)
    bparams = fcvm_tpu.ControlParams(gnl="GNLY", nstep=1)
    return {"plastic": (model, params, res),
            "buckling": (col, bparams, fcvm_tpu.solve_collapse(col, bparams))}


@pytest.mark.parametrize("case", ["plastic", "buckling"])
def test_writers_byte_identical(tmp_path, jax_results, case):
    """``write_out``, ``write_avr`` and ``export_results`` (with the
    reinforcement ratios) on the same results write the same bytes, and
    ``export_results`` returns the same fields; ``read_point_fields``
    reads them back."""
    model, params, res = jax_results[case]
    mesh = model.mesh
    out = {}
    for tag, rep, vtk in (("jax", jrep, jvtk), ("port", trep, tvtk)):
        d = tmp_path / tag
        d.mkdir()
        rep.write_out(d / "m.out", model.name, res, params, mesh.n_elements, mesh.n_nodes)
        rep.write_avr(d / "m.avr", model.name, ["Edge1", "e2"], [10.0, 5.5], [0.1, 0.0],
                      [1.2e-3, 2.0], [240.0, 1e5], ["Face1"], [100.0], [0.2], [0.3], [250.5])
        out[tag] = vtk.export_results(d / "m.vtk", res, mesh.elnodes, params,
                                      params.sig_yield, include_rho=True)
        if tag == "port":
            for name in ("m.out", "m.avr", "m.vtk"):
                assert (d / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    assert list(out["port"]) == list(out["jax"])
    for k, want in out["jax"].items():
        np.testing.assert_allclose(out["port"][k], want, rtol=TOL, atol=TOL * np.abs(want).max())
    back = tvtk.read_point_fields(tmp_path / "port" / "m.vtk")
    assert back.keys() == jvtk.read_point_fields(tmp_path / "jax" / "m.vtk").keys()
    np.testing.assert_allclose(back["von_Mises_Stress"], out["jax"]["von Mises Stress"],
                               rtol=1e-9, atol=1e-9 * np.abs(out["jax"]["von Mises Stress"]).max())


def test_inp_round_trips_both_ways(tmp_path):
    """The port writes, the JAX package reads, and the reverse; both equal
    the parameters written."""
    kw = dict(sig_yield=100.0, grav_z=-9.81, nstep=10, error_max=5e-3, et_e=0.0,
              target_lf=1.5, csr_option="CSR", averaged_option="averaged", gnl="GNLY",
              max_imp=10.0, ev1=1.0, ev2=0.3, disp_output="incremental")
    write_inp(ft.ControlParams(**kw), tmp_path / "port.inp")
    jax_write_inp(JaxParams(**kw), tmp_path / "jax.inp")
    assert (tmp_path / "port.inp").read_bytes() == (tmp_path / "jax.inp").read_bytes()
    assert jax_read_inp(tmp_path / "port.inp") == JaxParams(**kw)
    assert read_inp(tmp_path / "jax.inp") == ft.ControlParams(**kw)
    assert read_inp(tmp_path / "port.inp") == ft.ControlParams(**kw)


def test_run_analysis_matches_jax(tmp_path, jax_cfg):  # noqa: F811
    """``run_analysis`` on the small plastic box, both sides at cg_rtol 1e-12
    with the solver tiers off: the same history to 1e-8, the same files,
    the timers logged, ``run_sum``'s averages to 1e-8."""
    model = tension_model()
    model.name = "pipe"
    kw = dict(sig_yield=60.0, nstep=6, error_max=1e-10, et_e=0.1, target_lf=99.0,
              ultimate_strain=0.25)
    jax_cfg.cg_rtol = 1e-12
    ref = fcvm_tpu.run_analysis(model, fcvm_tpu.ControlParams(**kw), outdir=str(tmp_path / "jax"))
    lines = []
    pmodel = ft.model_from_arrays(model)
    res = ft.run_analysis(pmodel, ft.ControlParams(**kw), outdir=str(tmp_path / "port"),
                          progress=lines.append, config=port_config(cg_rtol=1e-12))
    for name in ("lbd", "un", "load", "csr", "peeq", "peeqmax", "svm", "triax"):
        np.testing.assert_allclose(getattr(res.history, name), getattr(ref.history, name),
                                   rtol=1e-8, atol=1e-12)
    assert ref.peeq_gp.max() > 0.0
    for name in ("pipe.out", "pipe.vtk", "pipe.png", "pipe_views.png", "pipe_psv.png"):
        assert (tmp_path / "port" / name).exists(), name
    for timer in ("solve", "report", "vtk", "plots", "stepping"):
        assert any(ln.startswith(timer + ".") for ln in lines), timer
    faces = model.mesh.faces_on(lambda x, y, z: x > 10.0 - 1e-9)
    edges = model.mesh.edges_on(lambda x, y, z: (y < 1e-9) & (z < 1e-9))
    groups = ({"Edge1": edges}, {"Face1": faces})
    s_ref = fcvm_tpu.run_sum(model, ref, fcvm_tpu.ControlParams(**kw), *groups)
    s_port = ft.run_sum(pmodel, res, ft.ControlParams(**kw), *groups, outdir=str(tmp_path))
    for kind, name, key in (("edges", "Edge1", "length"), ("faces", "Face1", "area"),
                            ("faces", "Face1", "svm"), ("edges", "Edge1", "peeq")):
        np.testing.assert_allclose(s_port[kind][name][key], s_ref[kind][name][key], rtol=1e-8)
    assert "Face1" in (tmp_path / "pipe.avr").read_text()
