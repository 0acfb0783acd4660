"""K8's schedule against the other schedules its kernels take, on one
NVIDIA GPU, once.

    python -m fcvm_tpu_torch.tools.k8_schedule

K8 (``kernels.segment_sum``) sums the long groups of wide rows through a
ring of bulk copies (4 slots of stages of up to 32 rows) and every other
group on its register path, one column a thread (``csrc/segment_sum.cu``,
``kernels.ring_groups``).  Its kernels take other shapes as template
parameters; ``csrc/segment_schedule_probe.cu`` instantiates them.  This
probe builds it with ``nvcc`` into ``fcvm_tpu_torch/_build/`` (a plain C
interface, loaded with ``ctypes``; the solver never loads it), and at the
sites of ``chip_smoke.py`` phase 3c (``chip_smoke.k8_sites``: the plate's
and the beam-column's plans, float32 and float64) times against K8: at the
write-form sites (the internal force, block Jacobi) the register path with
all 3 or 9 columns of a row a thread; at the coarse
table's chunks the ring with other stage sizes and slot counts, and no
ring (every group on the register path).  Each must give K8's bits, which
phase 3c holds to the CPU's ``index_add_``.  CUDA-event medians of 20; the
card's ``nvidia-smi`` name and power limit first, one JSON line last.
Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import math
import subprocess
from pathlib import Path

import torch

from fcvm_tpu_torch.ops import kernels

ROOT = Path(__file__).resolve().parents[2]
SOURCE = kernels.CSRC / "segment_schedule_probe.cu"
LIBRARY = kernels.BUILD_DIR / "libk8_schedule.so"
NVCC = "/usr/local/cuda/bin/nvcc"
# the probe's rings at the coarse table's sites: (label, slots, rows a stage)
RING_VARIANTS = (("stages of 32 rows, 2 slots", 2, 32), ("stages of 32 rows, 8 slots", 8, 32),
                 ("stages of 16 rows, 4 slots", 4, 16), ("stages of 8 rows, 4 slots", 4, 8))


def build() -> ctypes.CDLL:
    """Compile the probe (a failed build raises) and bind it."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = NVCC if Path(NVCC).exists() else "nvcc"
    subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(LIBRARY), str(SOURCE)], check=True)
    lib = ctypes.CDLL(str(LIBRARY))
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in ("fcvm_k8_probe_f32", "fcvm_k8_probe_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ll, ll, ll, ll, i, i, i, ptr]
        fn.restype = ctypes.c_int
    return lib


def probe_sum(lib, vals, plan, out, nlong, columns=1, slots=0, rows=0):
    """The probe's sum into ``out`` (raises on a failed launch): the write
    form with ``columns`` > 1, else the accumulating form."""
    fn = lib.fcvm_k8_probe_f32 if vals.dtype == torch.float32 else lib.fcvm_k8_probe_f64
    holes = plan.holes if columns > 1 else None
    err = fn(vals.data_ptr(), plan.order.data_ptr(), plan.walk.data_ptr(),
             holes.data_ptr() if holes is not None else None, out.data_ptr(), plan.walk.shape[1],
             nlong, holes.shape[0] if holes is not None else 0, out.numel() // out.shape[0],
             columns, slots, rows, torch.cuda.current_stream().cuda_stream)
    if err == -1:
        return None  # the ring does not fit a block's shared memory
    if err:
        raise RuntimeError(f"k8_schedule: launch failed with CUDA error {err}")
    return out


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("k8_schedule: torch.cuda.is_available() is false")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from fcvm_tpu_torch.config import pin_full_fp32

    pin_full_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    kernels.build()
    lib = build()
    models = {"plate": smoke.plate_model(smoke.PLATE_BIG),
              "column": smoke.column_model(smoke.COL_BIG, smoke.COL_W, smoke.COL_T)}
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {"card": smi, "rows": []}
    for name, model in models.items():
        for site, plan, nout, trail, form, _ in smoke.k8_sites(model):
            if site.startswith("smoother"):
                continue
            w = math.prod(trail)
            for dtype in (torch.float32, torch.float64):
                vals = torch.randn((plan.keys.shape[0], *trail), generator=gen, device="cuda",
                                   dtype=dtype)
                start = torch.randn((nout, *trail), generator=gen, device="cuda", dtype=dtype)
                write = form == "write"
                nlong = kernels.ring_groups(plan, w, vals.element_size())
                variants = [("the schedule", lambda o: kernels.segment_sum(vals, plan, rows=nout)
                             if write else kernels.segment_sum(vals, plan, o))]
                if write and w in (3, 9, 24):
                    variants.append((f"{w} columns a thread",
                                     lambda o: probe_sum(lib, vals, plan, o, 0, columns=w)))
                if nlong:
                    variants += [(label, lambda o, s=slots, r=rows: probe_sum(
                        lib, vals, plan, o, nlong, slots=s, rows=r))
                        for label, slots, rows in RING_VARIANTS]
                    variants.append(("no ring", lambda o: probe_sum(lib, vals, plan, o, 0)))
                want = variants[0][1](start.clone())
                acc = start.clone()
                row = {"model": name, "site": site, "dtype": str(dtype).removeprefix("torch."),
                       "width": w, "nlong": nlong, "segments": plan.segs.shape[0]}
                for label, call in variants:
                    got = call(torch.empty_like(start) if write else start.clone())
                    torch.cuda.synchronize()
                    if got is None:
                        row[label] = None
                        continue
                    if not torch.equal(got, want):
                        raise SystemExit(f"k8_schedule: {label} gives other bits ({name}, {site})")
                    row[label] = smoke.cuda_ms(call, acc)
                print(f"{row['dtype']} {name} {site} (width {w}, {row['segments']} groups, "
                      f"{nlong} on the ring): " + "; ".join(
                          f"{label} " + ("does not fit" if row[label] is None
                                         else f"{row[label]:.4f} ms") for label, _ in variants)
                      + f"; median of 20 ({smi})", flush=True)
                out["rows"].append(row)
                del vals, start, acc, want
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    print(json.dumps(main()))
