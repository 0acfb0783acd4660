"""The port stands alone: importing it loads neither JAX nor the JAX
package, and ``chip_smoke.py`` refuses to run without a GPU."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "fcvm_tpu_torch",
    "fcvm_tpu_torch.ops.kernels",
    "fcvm_tpu_torch.ops.deflation",
    "fcvm_tpu_torch.runtime.driver",
    "fcvm_tpu_torch.runtime.buckling",
    "fcvm_tpu_torch.ops.solver",
    "fcvm_tpu_torch.tools.bw_probe",
    "fcvm_tpu_torch.tools.turns",
    "fcvm_tpu_torch.tools.k1_atomic",
    "fcvm_tpu_torch.tools.bench",
    "fcvm_tpu_torch.models.meshgen",
    "fcvm_tpu_torch.api",
    "fcvm_tpu_torch.__main__",
    "fcvm_tpu_torch.models.casefile",
    "fcvm_tpu_torch.models.meshio_io",
    "fcvm_tpu_torch.native",
    "fcvm_tpu_torch.ops.postproc",
    "fcvm_tpu_torch.runtime.vtk",
    "fcvm_tpu_torch.runtime.viz",
    "fcvm_tpu_torch.runtime.plots",
    "fcvm_tpu_torch.models.fcstd",
    "fcvm_tpu_torch.tools.fcstd_doc",
    "fcvm_tpu_torch.parallel",
    "fcvm_tpu_torch.parallel.dist",
    "fcvm_tpu_torch.parallel.system",
    "chip_smoke",
]


def _run(code, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("module", PORT_MODULES)
def test_port_imports_no_jax(module):
    proc = _run(
        "import importlib, json, sys\n"
        f"importlib.import_module({module!r})\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or m.startswith"
        "(('jax.', 'jaxlib', 'fcvm_tpu.')) or m == 'fcvm_tpu')))"
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_fails_without_gpu():
    """No CUDA device: non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run in full")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_cli_run_without_gpu_fails(tmp_path):
    """``python -m fcvm_tpu_torch run case.toml`` without ``--cpu`` asks for
    the GPU: with none, a non-zero exit and no report written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the CLI would run on it")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "fcvm_tpu_torch", "run", "examples/uniaxial_tension.toml",
         "--outdir", str(out)], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert not out.exists() or not list(out.glob("*.out"))


def test_turns_fails_without_gpu():
    """The in-turns timing script: no CUDA device, non-zero exit and no
    JSON line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; turns.py would run in full")
    proc = subprocess.run([sys.executable, "fcvm_tpu_torch/tools/turns.py", ".", "kernels"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"part"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """A directory holding only chip_smoke.py: non-zero exit, no result."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
