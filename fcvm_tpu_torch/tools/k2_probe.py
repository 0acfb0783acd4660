"""Where K2's element pass spends its time, on one NVIDIA GPU, once.

    python -m fcvm_tpu_torch.tools.k2_probe

K2's element pass (``kernels.stress_update``, ``csrc/stress_update.cu``)
reads about 59 MB of the plate's update in float32, a bound of about 0.018
ms, and does about 1,200 instructions a Gauss point.
``csrc/stress_update_probe.cu`` instantiates, for the small-strain update
with one material, the pass (a thread a Gauss point reading its nodes from
global memory where it needs them) and two staged designs that share its
arithmetic on operands in shared memory: one tile a block (each distinct
node of the tile gathered once, by tables this probe makes with
:func:`tile_tables`; sig and sig_yield by bulk copies; 16-byte staged
stores; its phases one after another) and a persistent, pipelined variant
(a producer warp for each 32 elements staging the next tile while the
consumers compute one), each at 32 and 64 elements a tile and three
occupancy targets of its ``__launch_bounds__``, in modes: the pass, its
memory traffic alone (the copies, the gathers and the staged stores, no
Gauss-point arithmetic), its arithmetic alone (every gather on the first
tile's nodes, cache hits), and for one tile a block also its copies and
stores alone and its copies and gathers alone.  This probe builds it with
``nvcc`` into ``fcvm_tpu_torch/_build/`` (a plain C interface, loaded with
``ctypes``; the solver never loads it), prints each variant's registers
and spills from ``ptxas``, and on the plate's inputs of ``chip_smoke.py``
phase 3f (``chip_smoke.k2_inputs``), float32 and float64, times every
variant (CUDA events around 20 launches in a row, divided by 20, the
median of 5 such runs: the device time of a launch, the host's launch
time hidden behind the queue) with the blocks an SM holds; and a
``Tensor.copy_`` of as many bytes (the card's mixed read and write rate, a
yardstick).  Every variant's pass must give the pass's bits.  The card's
``nvidia-smi`` name and power limit first, one JSON line last.  Without a
CUDA device it exits non-zero.
"""

from __future__ import annotations

import ctypes
import importlib.util
import itertools
import json
import re
import subprocess
from pathlib import Path

import torch

from fcvm_tpu_torch.ops import kernels

ROOT = Path(__file__).resolve().parents[2]
SOURCE = kernels.CSRC / "stress_update_probe.cu"
LIBRARY = kernels.BUILD_DIR / "libk2_probe.so"
NVCC = "/usr/local/cuda/bin/nvcc"
MODES = ("the pass", "memory alone", "arithmetic alone", "copies and stores alone",
         "copies and gathers alone")
# the staged designs: (code, modes each runs); the pass is code 0, its mode 0
DESIGNS = {"one tile a block": (1, 5), "pipelined": (2, 3)}
BASE = {torch.float32: 1024, torch.float64: 512}  # csrc/stress_update.cu: kThreadsPerSm


def build() -> tuple[ctypes.CDLL, list]:
    """Compile the probe (a failed build raises), bind it, and return it
    with ptxas's (kernel, registers, spill bytes) of each element pass."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = NVCC if Path(NVCC).exists() else "nvcc"
    done = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-std=c++17", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v", "-o", str(LIBRARY), str(SOURCE)],
                          capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"k2_probe: the build failed:\n{done.stderr[-4000:]}")
    regs, name, spill = [], None, 0
    for line in done.stderr.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = int(m.group(1))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            for design, pattern in (("one tile a block", "tile_kernel"),
                                    ("pipelined", "pipelined_kernel")):
                if t := re.search(pattern + r"I([fd])Li(\d+)ELb(\d)ELb(\d)ELi(\d+)ELi(\d)",
                                  name):
                    dt, e, given, large, sm, mode = t.groups()
                    regs.append(dict(design=design,
                                     dtype="float32" if dt == "f" else "float64",
                                     elements=int(e), threads=int(sm), mode=int(mode),
                                     registers=int(m.group(1)), spill_bytes=spill))
            if t := re.search(r"stress_update_kernelI([fd])Lb(\d)ELb(\d)E", name):
                dt, given, large = t.groups()
                regs.append(dict(design="the pass", dtype="float32" if dt == "f" else "float64",
                                 given=given == "1", gnl=large == "1",
                                 registers=int(m.group(1)), spill_bytes=spill))
            name = None
    lib = ctypes.CDLL(str(LIBRARY))
    ptr, ll, i, d = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
    for fn in (lib.fcvm_k2_probe_f32, lib.fcvm_k2_probe_f64):
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i, ptr, ptr, ptr, ptr, d, d, ptr, ptr, ptr, ptr,
                       ll, i, i, i, i, ptr, ptr]
        fn.restype = ctypes.c_int
    return lib, regs


def tile_tables(elnodes: torch.Tensor, elements: int):
    """The staged variants' tables of ``elnodes`` (ne, 10) for tiles of
    ``elements``: node k of element e is ``nodes[offsets[e // elements] +
    local[k, e]]``, each tile's distinct nodes ascending; (local (10, ne)
    int16, offsets int32, nodes int32, the most distinct nodes a tile has)."""
    ne, dev = elnodes.shape[0], elnodes.device
    tiles = -(-ne // elements)
    span = int(elnodes.max()) + 1
    tile = torch.arange(ne, device=dev) // elements
    keys, inverse = torch.unique(tile[:, None] * span + elnodes, sorted=True,
                                 return_inverse=True)
    counts = torch.bincount(keys // span, minlength=tiles)
    offsets = torch.zeros(tiles + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=offsets[1:])
    local = (inverse - offsets[tile][:, None]).t().to(torch.int16).contiguous()
    return (local, offsets.to(torch.int32), (keys % span).to(torch.int32),
            int(counts.max()))


def queued_ms(fn, launches=20, runs=5):
    """The median over ``runs`` of CUDA-event time around ``launches`` calls
    of ``fn`` in a row, divided by ``launches``."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return sorted(times)[runs // 2]


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("k2_probe: torch.cuda.is_available() is false")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from fcvm_tpu_torch.config import pin_full_fp32

    pin_full_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    kernels.build()
    lib, regs = build()
    for r in regs:
        print(f"registers: {r}")
    model = smoke.plate_model(smoke.PLATE_BIG)
    out = {"card": smi, "registers": regs, "rows": []}
    for dtype in (torch.float32, torch.float64):
        args, kw, _ = smoke.k2_inputs(model, dtype, False, False)
        coords, eln, _, sig, _ = args
        ne = eln.shape[0]
        g_s, h3g_s = float(kw["g"]), float(kw["h"] + 3.0 * kw["g"])
        table = kernels.element_table(eln)
        want = kernels.stress_update(*args, table=table, **kw)
        nbytes, ops = smoke.k2_work(args, {**kw, "table": table}, False)
        bound_ms, _ = smoke.bound(nbytes, ops, dtype)
        fn = lib.fcvm_k2_probe_f32 if dtype == torch.float32 else lib.fcvm_k2_probe_f64

        def timed(code, elements, threads, mode, tiles, per_sm):
            outs = (torch.empty_like(sig), torch.empty_like(sig),
                    torch.empty((ne, 4), dtype=torch.bool, device="cuda"),
                    torch.empty((ne, 30), dtype=dtype, device="cuda"))

            def launch():
                err = fn(coords.data_ptr(), table.data_ptr(),
                         *(t.data_ptr() for t in tiles[:3]), tiles[3], kw["du"].data_ptr(),
                         sig.data_ptr(), kw["sig_yield"].data_ptr(), kw["dmat"].data_ptr(), g_s,
                         h3g_s, *(t.data_ptr() for t in outs), ne, elements, threads, code,
                         mode, ctypes.byref(per_sm), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"k2_probe: launch failed with CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            if mode == 0 and not all(torch.equal(a, b) for a, b in zip(outs, want)):
                raise SystemExit(f"k2_probe: design {code}, {elements} elements, {threads} "
                                 "threads gave other bits than the pass")
            return queued_ms(launch)

        per_sm = ctypes.c_int(0)
        tiles = tile_tables(eln, 32)
        row = {"dtype": str(dtype).removeprefix("torch."), "design": "the pass",
               "bound_ms": bound_ms, "the pass": timed(0, 0, 0, 0, tiles, per_sm)}
        row["the pass blocks an SM"] = per_sm.value
        print(f"K2 element pass {row['dtype']} plate update, the pass: {row['the pass']:.4f} ms "
              f"({per_sm.value} blocks an SM); bound {bound_ms:.4f} ms; CUDA events, 20 "
              f"launches a run, median of 5 runs ({smi})", flush=True)
        out["rows"].append(row)
        for elements in (32, 64):
            tiles = tile_tables(eln, elements)
            for (design, (code, nmodes)), threads in itertools.product(
                    DESIGNS.items(), (BASE[dtype] * 3 // 4, BASE[dtype], BASE[dtype] * 3 // 2)):
                row = {"dtype": str(dtype).removeprefix("torch."), "design": design,
                       "elements": elements, "threads": threads, "bound_ms": bound_ms}
                for mode, label in enumerate(MODES[:nmodes]):
                    row[label] = timed(code, elements, threads, mode, tiles, per_sm)
                    row[f"{label} blocks an SM"] = per_sm.value
                print(f"K2 element pass {row['dtype']} plate update, {design}, {elements} "
                      f"elements a tile, at least {threads} threads an SM: "
                      + "; ".join(f"{label} {row[label]:.4f} ms ({row[label + ' blocks an SM']} "
                                  "blocks an SM)" for label in MODES[:nmodes])
                      + f"; bound {bound_ms:.4f} ms; CUDA events, 20 launches a run, median "
                      f"of 5 runs ({smi})", flush=True)
                out["rows"].append(row)
        if dtype == torch.float32:
            out["copy"] = copy_row(nbytes, smi)
        del args, kw, want
        torch.cuda.empty_cache()
    return out


def copy_row(nbytes, smi) -> dict:
    """A yardstick of the card's mixed rate: ``Tensor.copy_`` of half the
    element pass's bytes into the other half (as much read as written)."""
    n = nbytes // 8
    src = torch.ones(n, device="cuda")
    dst = torch.empty_like(src)
    ms = queued_ms(lambda: dst.copy_(src))
    print(f"Tensor.copy_ of {4 * n / 1e6:.1f} MB into {4 * n / 1e6:.1f} MB: {ms:.4f} ms, "
          f"{2 * 4 * n / ms / 1e9:.2f} TB/s; CUDA events, 20 launches a run, median of 5 runs "
          f"({smi})", flush=True)
    return {"bytes": 8 * n, "ms": ms}


if __name__ == "__main__":
    print(json.dumps(main()))
