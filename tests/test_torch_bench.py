"""The port's benchmark (``fcvm_tpu_torch.tools.bench``) against the
repository's ``bench.py`` on the CPU, at small sizes: the builders, the
plastic step's yield factor, CG count and plastic fraction, a capacity
row's CG count, the CPU baseline's matrix and stress update, and the
cumulative JSON lines of ``main``."""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fcvm_tpu.config import get_config
from fcvm_tpu.ops import assembly as jasm
from fcvm_tpu.ops import solver as jsolver
from fcvm_tpu_torch.ops import material as tmat
from fcvm_tpu_torch.ops.stress_update import update_stress_load
from fcvm_tpu_torch.tools import bench as tb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLATE = (4, 2, 2)
TINY = ["--cpu", "--plate", "4,2,2", "--plate-small", "4,2,2", "--box-nx", "2"]


@pytest.fixture(scope="module")
def bench():
    """The repository's ``bench.py``, imported without the persistent
    compilation cache (its import enables it otherwise), with the
    preconditioner prewarm threads off."""
    saved_env = os.environ.get("FCVM_NO_COMPILE_CACHE")
    os.environ["FCVM_NO_COMPILE_CACHE"] = "1"
    cfg = get_config()
    saved_prewarm = cfg.prewarm
    cfg.prewarm = False
    try:
        yield importlib.import_module("bench")
    finally:
        cfg.prewarm = saved_prewarm
        if saved_env is None:
            os.environ.pop("FCVM_NO_COMPILE_CACHE", None)
        else:
            os.environ["FCVM_NO_COMPILE_CACHE"] = saved_env


@pytest.mark.parametrize("which", ["box", "plate"])
def test_builders_match(bench, which):
    if which == "box":
        (m_ref, ref), (m, mod) = bench.build(3), tb.build(3)
    else:
        (m_ref, ref), (m, mod) = bench.build_plate(PLATE), tb.build_plate(PLATE)
    np.testing.assert_allclose(m.coords, m_ref.coords, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(m.elnodes, m_ref.elnodes)
    for a, b in zip(mod.bcs.masks(m.ndof), ref.bcs.masks(m_ref.ndof)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mod.loads.traction_faces, ref.loads.traction_faces)
    np.testing.assert_array_equal(mod.loads.tractions, ref.loads.tractions)


def test_step_time_matches(bench):
    """One plastic step on the plate in float32: the yield factor, the
    elastic CG count, the plastic fraction and the size."""
    _, ndof_ref, _, it_ref, d_ref = bench.tpu_step_time(
        lambda: bench.build_plate(PLATE), bench.PLATE_SY, drive=1.25)
    _, ndof, _, it, d = tb.step_time(lambda: tb.build_plate(PLATE), tb.PLATE_SY, drive=1.25,
                                     device="cpu")
    assert ndof == ndof_ref
    assert abs(d["lbd_yield"] / d_ref["lbd_yield"] - 1) <= 1e-4
    assert abs(it - it_ref) <= 1 and abs(d["elastic_iters"] - d_ref["elastic_iters"]) <= 1
    assert abs(d["plastic_gp_fraction"] - d_ref["plastic_gp_fraction"]) <= 1e-3
    assert d["plastic_gp_fraction"] > 0
    assert d["launches"] == dict.fromkeys(tb.ROW_KERNELS, 0)  # CPU: plain versions


def test_capacity_row_matches(bench):
    ref, row = bench.capacity_row(3), tb.capacity_row(3, device="cpu")
    assert row["ndof"] == ref["ndof"]
    assert abs(row["elastic_iters"] - ref["elastic_iters"]) <= 1
    assert "peak_mib" not in row  # no device memory on the CPU


def test_cpu_matrix_matches(bench):
    mesh, model = tb.build_plate(PLATE)
    esm = tb.cpu_blocks(mesh)
    fixmask, _, _ = model.bcs.masks(mesh.ndof)
    k = tb.cpu_matrix(esm, mesh.elnodes, fixmask, mesh.ndof)
    k_ref = jsolver.assemble_scipy_csc(esm, np.asarray(jasm.element_dof_ids(mesh.elnodes)),
                                       fixmask, mesh.ndof)
    diff = abs(k - k_ref).max()
    assert diff <= 1e-12 * abs(k_ref).max()


def test_numpy_stress_update_matches_port():
    """On an elastic increment the numpy update's internal force is the
    port's ``update_stress_load``'s, in float64."""
    mesh, _ = tb.build_plate(PLATE)
    du = 1e-5 * np.random.default_rng(0).standard_normal(mesh.ndof)
    q = tb.numpy_stress_update(mesh.coords, mesh.elnodes, du, 1e9)
    f64 = torch.float64
    ne = mesh.n_elements
    *_, q_ref = update_stress_load(
        torch.as_tensor(mesh.coords, dtype=f64), torch.as_tensor(mesh.elnodes.astype(np.int64)),
        tmat.hooke_dmat(tb.E, tb.NU, f64, torch.device("cpu")),
        torch.full((ne, 4), 1e9, dtype=f64), torch.zeros(mesh.ndof, dtype=f64),
        torch.as_tensor(du), torch.zeros((ne, 4, 6), dtype=f64), tb.E, tb.NU, tb.ET_E)
    q_ref = q_ref.numpy()
    assert np.abs(q - q_ref).max() <= 1e-10 * np.abs(q_ref).max()


def _keys(line):
    return set(line) | {("extra", k) for k in line["extra"]}


def test_main_emits_cumulative_lines():
    lines = []
    assert tb.main(TINY + ["--capacity", "3"], emit=lines.append) == 0
    lines = [json.loads(ln) for ln in lines]
    assert len(lines) >= 2
    assert lines[0]["metric"] is None and "headline" not in lines[0]["extra"]
    assert "matched_size" in lines[0]["extra"]
    for a, b in zip(lines, lines[1:]):
        assert _keys(a) <= _keys(b)
    last = lines[-1]
    assert last["metric"] == "newton_load_step_wall_ms_plate_with_hole_1kdof"
    assert last["vs_baseline"] is not None and "same-size" in last["extra"]["vs_baseline_from"]
    assert [r["ndof"] for r in last["extra"]["capacity"]] == [1029]
    assert last["extra"]["sharded_1dev"]["lbd_within_tol"]
    assert last["extra"]["headline"]["plastic_gp_fraction"] > 0


def test_main_matched_ratio_without_same_size():
    lines = []
    tb.main(TINY + ["--capacity", "", "--no-box", "--no-sharded", "--no-same-size"],
            emit=lines.append)
    last = json.loads(lines[-1])
    assert "same_size" not in last["extra"]
    assert last["vs_baseline"] == last["extra"]["matched_size"]["collapse_ratio"]
    assert last["extra"]["vs_baseline_from"].startswith("matched-size")


def test_failed_row_ends_the_run(monkeypatch):
    """A row that raises ends ``main`` with that exception, after the rows
    before it were emitted."""
    def boom(nx, device):
        raise RuntimeError("capacity row failed")

    monkeypatch.setattr(tb, "capacity_row", boom)
    lines = []
    with pytest.raises(RuntimeError, match="capacity row failed"):
        tb.main(TINY + ["--capacity", "3", "--no-box", "--no-same-size"], emit=lines.append)
    assert len(lines) == 2 and "headline" in json.loads(lines[-1])["extra"]


def test_runs_on_cuda_by_default():
    """Without ``--cpu`` the bench asks for the GPU: with none, a non-zero
    exit and no JSON line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the bench would run on it")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "fcvm_tpu_torch.tools.bench"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert '"metric"' not in proc.stdout
