"""K1m's element pass in each of its two layouts, at every width, on one
NVIDIA GPU, once.

    python -m fcvm_tpu_torch.tools.k1m_layout

K1m (``kernels.khat_matmat``, ``csrc/khat_matmat.cu``) has two layouts
of its element pass: collapse (a sub-tile's blocks read once for every
column, two columns a thread in float32, each node's rows of its first
sub-tile summed on chip into compacted rows) and direct (a thread an
(element, column), K1's element output written whole); its
``layout_of`` picks one for each dtype and chunk width.
``csrc/khat_matmat_probe.cu`` runs either layout at any width.  This
probe builds it with ``nvcc`` into ``fcvm_tpu_torch/_build/`` (a plain C
interface, loaded with ``ctypes``; the solver never loads it) and times
K1m and both layouts on the beam-column's operator of ``chip_smoke.py``
(451,875 dof), masked, at m = 1, 2, 4, 8, 32 and 64, float32 and
float64, with each pass's device time (torch.profiler).  Each layout must
give K1m's bits.  It prints the share of compacted element rows on the
beam-column and the plate, the card's ``nvidia-smi`` name and power
limit, and one JSON line last.  Without a CUDA device it exits non-zero.
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
SOURCE = kernels.CSRC / "khat_matmat_probe.cu"
LIBRARY = kernels.BUILD_DIR / "libk1m_layout.so"
NVCC = "/usr/local/cuda/bin/nvcc"
LAYOUTS = {"collapse": 0, "direct": 1}  # enum Layout of csrc/khat_matmat.cu
WIDTHS = (1, 2, 4, 8, 32, 64)


def build() -> ctypes.CDLL:
    """Compile the probe (a failed build raises; ``ptxas`` prints each
    kernel's registers, shared memory and spills) and bind it."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = NVCC if Path(NVCC).exists() else "nvcc"
    subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                    "-Xptxas=-v", "-o", str(LIBRARY), str(SOURCE)], check=True)
    lib = ctypes.CDLL(str(LIBRARY))
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in ("fcvm_k1m_probe_f32", "fcvm_k1m_probe_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [i] + [ptr] * 12 + [ll, ll, i, i, i, ptr]
        fn.restype = ctypes.c_int
    lib.fcvm_k1m_probe_rows.argtypes = [i, ll, ll]
    lib.fcvm_k1m_probe_rows.restype = ll
    return lib


def probe_call(lib, plan, u, layout):
    """The masked K1m of ``plan`` on ``u`` with its element pass in
    ``layout`` (a key of ``LAYOUTS``)."""
    fn = lib.fcvm_k1m_probe_f32 if u.dtype == torch.float32 else lib.fcvm_k1m_probe_f64
    inc, tab, m = plan.inc, plan.tables, u.shape[1]
    ne = inc.elnodes_t.shape[1]
    rows = lib.fcvm_k1m_probe_rows(LAYOUTS[layout], ne, tab.node_rows.shape[0])
    fe = torch.empty((rows, 3, m), dtype=u.dtype, device=u.device)
    y = torch.empty_like(u)
    err = fn(LAYOUTS[layout], plan.map.data_ptr(), *(t.data_ptr() for t in inc[:3]),
             *(t.data_ptr() for t in tab), u.data_ptr(), plan.fixmask.data_ptr(),
             fe.data_ptr(), y.data_ptr(), ne, inc.offsets.shape[0] - 1, m, 2, 0,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"k1m_layout: layout {layout} failed with {err}")
    return y


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("k1m_layout: torch.cuda.is_available() is false")
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
    out = {"card": smi, "shares": {}, "rows": []}
    models = {"plate": smoke.plate_model(smoke.PLATE_BIG),
              "column": smoke.column_model(smoke.COL_BIG, smoke.COL_W, smoke.COL_T)}
    gen = torch.Generator(device="cuda").manual_seed(21)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).removeprefix("torch.")
        for name, model in models.items():
            if name == "plate" and name in out["shares"]:
                continue  # its share once: the tables do not depend on the dtype
            be = TorchSystem(model, FcvmConfig(device="cuda", dtype=dname), dtype,
                             torch.device("cuda"))
            op, sp = be.assemble_operator(be.tensor(model.mesh.coords))[0], be.space
            inc, fm = sp.incidence, sp.fixmask_m
            ne = inc.elnodes_t.shape[1]
            share = inc.k1m.node_rows.shape[0] / (10 * ne)
            out["shares"][name] = share
            print(f"{name}: {ne} elements, compacted rows {inc.k1m.node_rows.shape[0]} = "
                  f"{share:.4f} of 10 ne at sub-tiles of {kernels.K1M_SUB}")
            if name != "column":
                del be, op
                torch.cuda.empty_cache()
                continue
            plan = kernels.khat_matmat_plan(op.packed, inc, fm)
            for m in WIDTHS:
                u = torch.randn((be.ndof_pad, m), generator=gen, device="cuda", dtype=dtype)

                def k1m(v):
                    return kernels.khat_matmat(op.packed, inc, v, fm, plan=plan)

                want = k1m(u)
                row = {"dtype": dname, "m": m, "K1m": smoke.cuda_ms(k1m, u),
                       "K1m passes": smoke.device_ms_by_kernel(k1m, u)}
                for layout in LAYOUTS:

                    def call(v, layout=layout):
                        return probe_call(lib, plan, v, layout)

                    got = call(u)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise SystemExit(f"k1m_layout: {layout} gives other bits ({dname}, "
                                         f"m={m})")
                    row[layout] = smoke.cuda_ms(call, u)
                    row[f"{layout} passes"] = smoke.device_ms_by_kernel(call, u)
                print(f"{dname} column m={m}: " + "; ".join(
                    f"{k} {v:.4f} ms" if isinstance(v, float) else
                    f"{k} " + ", ".join(f"{n} {t:.4f}" for n, t in v.items())
                    for k, v in row.items() if k not in ("dtype", "m"))
                    + f"; median of 20 ({smi})", flush=True)
                out["rows"].append(row)
                del u, want
            del be, op, plan
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    print(json.dumps(main()))
