"""K1 against its atomic variant on one NVIDIA GPU, once.

    python -m fcvm_tpu_torch.tools.k1_atomic

K1 (``kernels.khat_matvec``) sums each node's element rows in the fixed
order of its incidence table, in a second pass.  Its atomic variant
(``csrc/khat_atomic_probe.cu``: one pass over the elements that adds each
row into the zeroed output with ``red.global.add``, then the mask) is what
K1 would be without that pass.  This probe builds the variant with ``nvcc``
into ``fcvm_tpu_torch/_build/`` (a plain C interface, loaded with
``ctypes``; the solver never loads it), and on the masked K_hat·v of the
502,599-dof plate in float32 and float64 prints the CUDA-event median of
each, both held against K1's plain version, and whether each gives the same
bits on ten calls.  The card's ``nvidia-smi`` name and power limit come
first, one JSON line last.  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
from pathlib import Path

import torch

from fcvm_tpu_torch.ops import kernels

ROOT = Path(__file__).resolve().parents[2]
SOURCE = kernels.CSRC / "khat_atomic_probe.cu"
LIBRARY = kernels.BUILD_DIR / "libkhat_atomic.so"
NVCC = "/usr/local/cuda/bin/nvcc"


def build() -> ctypes.CDLL:
    """Compile the atomic variant (a failed build raises) and bind it."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = NVCC if Path(NVCC).exists() else "nvcc"
    subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(LIBRARY), str(SOURCE)], check=True)
    lib = ctypes.CDLL(str(LIBRARY))
    ptr, ll = ctypes.c_void_p, ctypes.c_longlong
    for name in ("fcvm_khat_atomic_f32", "fcvm_khat_atomic_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ll, ll, ptr]
        fn.restype = ctypes.c_int
    return lib


def atomic_khat(lib, esm_t, inc, u, fixmask):
    """The atomic variant's masked K_hat·u (raises on a failed launch)."""
    y = torch.empty_like(u)
    fn = lib.fcvm_khat_atomic_f32 if u.dtype == torch.float32 else lib.fcvm_khat_atomic_f64
    err = fn(esm_t.data_ptr(), inc.elnodes_t.data_ptr(), u.data_ptr(), fixmask.data_ptr(),
             y.data_ptr(), esm_t.shape[2], u.shape[0] // 3,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"k1_atomic: launch failed with CUDA error {err}")
    return y


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("k1_atomic: torch.cuda.is_available() is false")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from fcvm_tpu_torch import FcvmConfig
    from fcvm_tpu_torch.config import pin_full_fp32
    from fcvm_tpu_torch.runtime.backend import TorchSystem

    pin_full_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    kernels.build()
    lib = build()
    plate = smoke.plate_model(smoke.PLATE_BIG)
    out = {"card": smi, "rows": []}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).removeprefix("torch.")
        be = TorchSystem(plate, FcvmConfig(device="cuda", dtype=dname), dtype,
                         torch.device("cuda"))
        op, sp = be.assemble_operator(be.tensor(plate.mesh.coords))[0], be.space
        esm_t, packed = op.esm_t, op.packed
        del op
        gen = torch.Generator(device="cuda").manual_seed(7)
        u = torch.randn(be.ndof_pad, generator=gen, device="cuda", dtype=dtype)
        args = (esm_t, sp.incidence, u, sp.fixmask_m)
        ref = kernels.khat_matvec_ref(*args)
        scale = float(ref.abs().max())
        row = {"dtype": dname, "ne": esm_t.shape[2]}
        for name, fn in (("k1", lambda _, *a: kernels.khat_matvec(packed, *a)),
                         ("atomic", lambda *a: atomic_khat(lib, *a))):
            runs = [fn(*args) for _ in range(10)]
            torch.cuda.synchronize()
            row[f"{name}_rel_err"] = float((runs[0] - ref).abs().max()) / scale
            row[f"{name}_same_bits"] = all(torch.equal(r, runs[0]) for r in runs)
            row[f"{name}_ms"] = smoke.cuda_ms(fn, *args)
        print(f"{dname} plate ne={row['ne']}: K1 {row['k1_ms']:.4f} ms (rel err "
              f"{row['k1_rel_err']:.2e}, same bits on ten calls: {row['k1_same_bits']}); "
              f"atomic variant {row['atomic_ms']:.4f} ms (rel err {row['atomic_rel_err']:.2e}, "
              f"same bits: {row['atomic_same_bits']}); median of 20 ({smi})")
        out["rows"].append(row)
        del be, esm_t, packed, sp, u, ref, args
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    print(json.dumps(main()))
