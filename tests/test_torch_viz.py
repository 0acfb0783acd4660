"""The port's headless viewers and curves against the JAX package's
(``tests/test_viz.py``): the view bundle, the clip surface's face set, the
``disp_scale`` warp, the orbit GIF, and ``ImportError`` without matplotlib.
"""

import sys

import numpy as np
import pytest
from torch_parity import port_config

import fcvm_tpu_torch as ft
from fcvm_tpu.models import meshgen
from fcvm_tpu.runtime import viz as jax_viz
from fcvm_tpu_torch.runtime import plots
from fcvm_tpu_torch.runtime import viz


@pytest.fixture(scope="module")
def result():
    """The cantilever box of tests/test_viz.py:12-27, solved by the port."""
    mesh = meshgen.box_tet10(2, 2, 2, 10.0, 10.0, 10.0)
    bcs = ft.BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, 0.0, 0.0))])
    faces = mesh.faces_on(lambda x, y, z: x > 10.0 - 1e-9)
    loads = ft.Loads(traction_faces=faces, tractions=np.tile([0, 0, -20.0], (len(faces), 1)))
    model = ft.Model(ft.Mesh(mesh.coords, mesh.elnodes), ft.Material(210000.0, 0.3), bcs,
                     loads, name="viz")
    params = ft.ControlParams(sig_yield=100.0, nstep=3, error_max=1e-9, et_e=0.1, target_lf=99.0)
    return model, ft.solve_collapse(model, params, config=port_config()), params


def test_result_view_bundle(tmp_path, result):
    model, res, params = result
    viz.save_result_views(tmp_path, "viz", model, res, params)
    plots.save_curves(tmp_path / "viz.png", res.history, params)
    for name in ("viz_views.png", "viz_psv.png", "viz.png"):
        assert (tmp_path / name).stat().st_size > 10_000, name


@pytest.mark.parametrize("normal,offset", [((1.0, 0, 0), 0.5), ((0.3, -1.0, 0.5), 0.1)])
def test_clip_surface_matches_jax(normal, offset):
    """The kept half's closed surface: the same tri faces as the JAX
    package's, all on the kept side."""
    mesh = meshgen.box_tet10(3, 3, 3, 1.0, 1.0, 1.0)
    n = np.asarray(normal) / np.linalg.norm(normal)
    faces = viz._clip_surface(mesh.coords, mesh.elnodes, n, offset)
    np.testing.assert_array_equal(faces, jax_viz._clip_surface(mesh.coords, mesh.elnodes, n,
                                                               offset))
    assert len(faces) > 0


def test_orbit_gif(tmp_path):
    mesh = meshgen.box_tet10(2, 2, 2, 1.0, 1.0, 1.0)
    out = tmp_path / "orbit.gif"
    viz.save_orbit_gif(out, mesh.coords, mesh.elnodes, np.linspace(0.0, 1.0, mesh.n_nodes),
                       frames=4)
    assert out.stat().st_size > 5_000


def test_view_bundle_warps_by_disp_scale(tmp_path, monkeypatch, result):
    """save_result_views draws on coords + ds * disp_total, ds from
    res.disp_scale unless given (tests/test_viz.py:74-95)."""
    model, res, params = result
    seen = {}

    def spy(path, coords, elnodes, fields, **kw):
        seen["coords"] = np.asarray(coords).copy()

    monkeypatch.setattr(res, "disp_scale", 40.0)
    monkeypatch.setattr(viz, "save_clip_views", spy)
    monkeypatch.setattr(viz, "save_psv_glyphs", lambda *a, **k: None)
    viz.save_result_views(tmp_path, "viz", model, res, params)
    np.testing.assert_allclose(seen["coords"], res.coords + 40.0 * res.disp_total.reshape(-1, 3))
    viz.save_result_views(tmp_path, "viz", model, res, params, disp_scale=0.0)
    np.testing.assert_allclose(seen["coords"], res.coords)


def test_plots_raise_without_matplotlib(tmp_path, monkeypatch, result):
    """No matplotlib: asking for plots raises ImportError, nothing skips."""
    model, res, params = result
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        plots.save_curves(tmp_path / "c.png", res.history, params)
    with pytest.raises(ImportError):
        ft.run_analysis(model, params, outdir=str(tmp_path), config=port_config())
    assert (tmp_path / "viz.out").exists() and not (tmp_path / "viz.png").exists()
