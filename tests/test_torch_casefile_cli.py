"""The port's TOML case files and CLI against the JAX package's
(``tests/test_casefile_cli.py``), CPU float64.

``load_case`` must give the same arrays for every case file of that test
(``test_fcvm_dtype_env_selects_f64_tier`` has no twin: the port has no
environment override; ``test_reads_reference_corpus`` needs the absent
corpus).  The CLI commands run with ``--cpu --x64`` on both sides, each with
its package's default solver configuration (``cg_rtol`` 1e-6), so their
numbers are compared to 1e-5 and their structure exactly.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest

import fcvm_tpu.__main__ as jax_cli
from fcvm_tpu.models.casefile import load_case as jax_load_case
from fcvm_tpu.models.casefile import parse_sum_groups as jax_parse_sum_groups
from fcvm_tpu.models.inp import ControlParams as JaxParams
from fcvm_tpu.models.inp import write_inp as jax_write_inp
from fcvm_tpu.runtime.vtk import read_point_fields as jax_read_point_fields
from fcvm_tpu_torch.__main__ import main
from fcvm_tpu_torch.models.casefile import load_case, parse_sum_groups
from fcvm_tpu_torch.runtime.vtk import read_point_fields

ROOT = Path(__file__).resolve().parent.parent

CASE = """
name = "cli_box"
[mesh.generator]
kind = "box"
nx = 2
lx = 10.0

[material]
e = 210000.0
nu = 0.3

[control]
sig_yield = 240.0
nstep = 3
error_max = 1e-8
target_lf = 1.0

[[bc]]
where = "x < 1e-9"
ux = 0.0
uy = 0.0
uz = 0.0

[[load.face]]
where = "x > 10.0 - 1e-9"
traction = [50.0, 0.0, 0.0]
"""

SUM = """
[[sum.face]]
name = "loaded_face"
where = "x > 10.0 - 1e-9"

[[sum.edge]]
name = "bottom_edge"
where = "(y < 1e-9) & (z < 1e-9)"
"""

COLUMN = """
name = "col"
[mesh.generator]
kind = "box"
nx = 6
ny = 1
nz = 1
lx = 20.0
ly = 1.0
lz = 1.0
[control]
gnl = "GNLY"
nstep = 1
[[bc]]
where = "x < 1e-9"
ux = 0.0
uy = 0.0
uz = 0.0
[[load.face]]
where = "x > 20.0 - 1e-9"
traction = [-1000.0, 0.0, 0.0]
"""

INP_CASE = """
[mesh.generator]
kind = "box"
nx = 1
lx = 1.0
[control]
inp = "ref.inp"
[[bc]]
where = "z < 1e-9"
uz = 0.0
"""

FORCE = """
[mesh.generator]
kind = "box"
nx = 2
lx = 10.0
[[bc]]
where = "x < 1e-9"
ux = 0.0
uy = 0.0
uz = 0.0
[[load.force]]
where = "x > 10.0 - 1e-9"
on = "face"
total = [500.0, 0.0, 0.0]
[[load.force]]
where = "(x > 10.0 - 1e-9) & (y < 1e-9) & (z < 1e-9)"
on = "vertex"
total = [0.0, 7.0, 0.0]
[[load.force]]
where = "(x > 10.0 - 1e-9) & (z > 10.0 - 1e-9)"
on = "edge"
total = [0.0, 0.0, -3.0]
[[load.face_pressure]]
where = "z < 1e-9"
pressure = -2.0
[[load.vertex]]
where = "(x > 10.0 - 1e-9) & (y > 10.0 - 1e-9) & (z > 10.0 - 1e-9)"
force = [1.0, 2.0, 3.0]
[loads]
gravity = [0.0, 0.0, -9810.0]
[material]
density = 7.85e-9
"""

REGIONS = """
[mesh.generator]
kind = "box"
nx = 2
lx = 10.0
[material]
e = 100000.0
nu = 0.0
[[material.region]]
where = "x > 5.0"
e = 200000.0
[[material.region]]
where = "z > 5.0"
nu = 0.2
density = 1e-9
[[bc]]
where = "x < 1e-9"
ux = 0.0
"""

PLATE_RCM = """
[mesh]
rcm = true
[mesh.generator]
kind = "plate_with_hole"
n_circ = 6
n_rad = 4
n_thick = 2
[control]
sig_yield = 100.0
[[bc]]
where = "y < 1e-9"
uy = 0.0
[[load.face]]
where = "y > 100.0 - 1e-6"
traction = [0.0, 50.0, 0.0]
"""

CASES = {"box": CASE + SUM, "column": COLUMN, "inp": INP_CASE, "force": FORCE,
         "regions": REGIONS, "plate_rcm": PLATE_RCM,
         "cruciform": "examples/cruciform_torsional_buckling.toml",
         "plate_example": "examples/plate_with_hole.toml"}


def _case_path(tmp_path, case):
    text = CASES[case]
    if text.startswith("examples/"):
        return ROOT / text
    if case == "inp":
        jax_write_inp(JaxParams(sig_yield=123.0, nstep=7, gnl="GNLN", grav_z=-9.81),
                      tmp_path / "ref.inp")
    p = tmp_path / "case.toml"
    p.write_text(text)
    return p


@pytest.mark.parametrize("case", list(CASES))
def test_load_case_matches_jax(tmp_path, case):
    """The same mesh, material (and regions), constraints, load tables,
    control parameters, name and sum groups as the JAX package's."""
    p = _case_path(tmp_path, case)
    ref, ref_params = jax_load_case(p)
    model, params = load_case(p)
    assert model.name == ref.name
    np.testing.assert_array_equal(model.mesh.coords, ref.mesh.coords)
    np.testing.assert_array_equal(model.mesh.elnodes, ref.mesh.elnodes)
    assert (model.material.e, model.material.nu, model.material.density) == (
        ref.material.e, ref.material.nu, ref.material.density)
    if ref.materials_by_element is None:
        assert model.materials_by_element is None
    else:
        np.testing.assert_array_equal(model.materials_by_element, ref.materials_by_element)
    np.testing.assert_array_equal(model.bcs.fixed_dofs, ref.bcs.fixed_dofs)
    np.testing.assert_array_equal(model.bcs.fixed_values, ref.bcs.fixed_values)
    for name in ("pressure_faces", "pressures", "traction_faces", "tractions", "edges",
                 "edge_tractions", "vertices", "vertex_forces", "gravity"):
        np.testing.assert_allclose(getattr(model.loads, name), getattr(ref.loads, name),
                                   rtol=1e-15, atol=0, err_msg=name)
    assert vars(params) == vars(ref_params)
    groups, ref_groups = parse_sum_groups(p, model.mesh), jax_parse_sum_groups(p, ref.mesh)
    for got, want in zip(groups, ref_groups):
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    if case == "regions":
        assert len(np.unique(model.materials_by_element, axis=0)) == 4
    if case == "force":
        assert len(model.loads.edges) and len(model.loads.pressure_faces) and len(
            model.loads.vertices)


def _rows(out_file):
    """The history rows of a ``.out`` report as numbers."""
    text = Path(out_file).read_text().splitlines()
    return np.array([[float(v) for v in ln.split()] for ln in text
                     if ln.strip() and ln.lstrip()[0].isdigit()])


def test_cli_info_matches_jax(tmp_path, capsys):
    p = _case_path(tmp_path, "regions")
    assert jax_cli.main(["info", str(p), "--cpu", "--x64"]) == 0
    want = capsys.readouterr().out
    assert main(["info", str(p), "--cpu", "--x64"]) == 0
    assert capsys.readouterr().out == want
    assert "elements: 48" in want


def test_cli_run_and_sum_match_jax(tmp_path):
    """``run`` writes the same files as the JAX CLI, with the same history
    rows, nodal fields and averages to 1e-5; the post-hoc ``sum`` rewrites
    the in-run ``.avr`` byte for byte."""
    p = _case_path(tmp_path, "box")
    for tag, cli in (("jax", jax_cli.main), ("port", main)):
        assert cli(["run", str(p), "--cpu", "--x64", "--outdir", str(tmp_path / tag)]) == 0
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    assert sorted(f.name for f in port_dir.iterdir()) == sorted(f.name for f in jax_dir.iterdir())
    np.testing.assert_allclose(_rows(port_dir / "cli_box.out"), _rows(jax_dir / "cli_box.out"),
                               rtol=1e-5, atol=0)
    fields, ref = read_point_fields(port_dir / "cli_box.vtk"), jax_read_point_fields(
        jax_dir / "cli_box.vtk")
    assert list(fields) == list(ref) and len(fields) == 12
    for k, want in ref.items():
        np.testing.assert_allclose(fields[k], want, rtol=0, atol=1e-5 * np.abs(want).max())
    avr = (port_dir / "cli_box.avr").read_text()
    want = (jax_dir / "cli_box.avr").read_text()
    nums = [re.findall(r"-?\d\.\d\de[+-]\d\d", t) for t in (avr, want)]
    np.testing.assert_allclose(np.float64(nums[0]), np.float64(nums[1]), rtol=1e-5)
    row = [ln for ln in avr.splitlines() if "loaded_face" in ln][0]
    assert abs(float(row.split()[0]) - 100.0) < 1e-6
    (port_dir / "cli_box.avr").unlink()
    assert main(["sum", str(p), "--outdir", str(port_dir)]) == 0
    assert (port_dir / "cli_box.avr").read_text() == avr


def test_cli_buckle_and_bench_match_jax(tmp_path, capsys):
    p = _case_path(tmp_path, "column")
    factors = {}
    for tag, cli in (("jax", jax_cli.main), ("port", main)):
        assert cli(["buckle", str(p), "--cpu", "--x64"]) == 0
        out = capsys.readouterr().out
        line = [ln for ln in out.splitlines() if ln.startswith("buckling load factors")][0]
        factors[tag] = np.float64(re.findall(r"[-\d.e+]+", line.split(":", 1)[1]))
    assert factors["port"].shape == (2,)
    np.testing.assert_allclose(factors["port"], factors["jax"], rtol=1e-5)
    p = _case_path(tmp_path, "box")
    bench = {}
    for tag, cli in (("jax", jax_cli.main), ("port", main)):
        assert cli(["bench", str(p), "--cpu", "--x64", "--steps", "2"]) == 0
        bench[tag] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert bench["port"].keys() == bench["jax"].keys()
    assert bench["port"]["steps"] == bench["jax"]["steps"] == 2
    assert bench["port"]["metric"] == "case_step_wall_ms" and bench["port"]["cg_iters"] > 0


def test_cli_checkpoint_then_resume(tmp_path):
    """--checkpoint writes per-step state; --resume continues from it and
    lands on the same final row as the original run; the JAX CLI resumes
    from the port's checkpoints to the same row."""
    p = _case_path(tmp_path, "box")
    out1 = tmp_path / "out1"
    assert main(["run", str(p), "--cpu", "--x64", "--outdir", str(out1), "--checkpoint",
                 "--no-plots"]) == 0
    ckdir = out1 / "checkpoints"
    assert sorted(f.name for f in ckdir.iterdir()) == [f"step_0000{k}.npz" for k in (1, 2, 3)]
    rows1 = _rows(out1 / "cli_box.out")
    for tag, cli in (("port", main), ("jax", jax_cli.main)):
        out2 = tmp_path / tag
        assert cli(["run", str(p), "--cpu", "--x64", "--outdir", str(out2), "--resume",
                    str(ckdir)]) == 0
        rows2 = _rows(out2 / "cli_box.out")
        np.testing.assert_allclose(rows2[-1], rows1[-1], rtol=1e-6, atol=0)
        if tag == "port":
            t1 = (out1 / "cli_box.out").read_text().splitlines()
            t2 = (out2 / "cli_box.out").read_text().splitlines()
            assert [ln for ln in t1 if ln.lstrip()[:1].isdigit()][-1] == [
                ln for ln in t2 if ln.lstrip()[:1].isdigit()][-1]


def test_cli_refuses_what_is_not_ported(tmp_path):
    """The multi-process flags are ported (``tests/test_torch_sharded_ops.py``
    runs them); what the CLI still refuses: ``--distributed`` outside a
    launch, the launch flags without ``--distributed``, ``--coordinator``
    without the world's size and this process's rank, and a case without
    [[sum.*]] groups (``sum`` returns 2).  (FreeCAD documents run:
    ``tests/test_torch_fcstd.py``.)"""
    p = _case_path(tmp_path, "column")
    with pytest.raises(ValueError, match="torchrun"):
        main(["run", str(p), "--cpu", "--distributed"])
    with pytest.raises(SystemExit):
        main(["run", str(p), "--cpu", "--coordinator", "127.0.0.1:1"])
    with pytest.raises(SystemExit):
        main(["run", str(p), "--cpu", "--distributed", "--coordinator", "127.0.0.1:1"])
    assert main(["sum", str(p), "--outdir", str(tmp_path)]) == 2
