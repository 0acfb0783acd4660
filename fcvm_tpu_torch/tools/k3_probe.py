"""K3's and K5's design choices on one NVIDIA GPU, once.

    python -m fcvm_tpu_torch.tools.k3_probe

K3 (``kernels.form_blocks``, ``csrc/form_blocks.cu``) forms each tile's
geometry (in float64's elastic and tangent forms after gathering each
element's nodes once into shared memory), then sums each node pair's block
a thread.  ``csrc/form_blocks_probe.cu`` instantiates, from the same
geometry, the layouts of ``VARIANTS``: K3 with the gather in every form and
dtype or in none, and the column layout (D_g B_b formed once a column of
node pairs and held across them) at 16, 32 or 64 elements a block, the
blocks an SM its ``__launch_bounds__`` asks for (so its register bound),
its Gauss points on one lane or split over two, its outputs stored from
registers or staged in shared memory for a pass of their own, and, for the
measurement, modes that leave out stage 2's stores, its arithmetic, or the
whole of stage 2.  This probe builds that file and
``csrc/jacobi_inverse_probe.cu`` with ``nvcc`` into
``fcvm_tpu_torch/_build/`` (plain C interfaces, loaded with ``ctypes``; the
solver never loads them), prints ``ptxas``'s registers, spills and shared
memory of every instantiation and of K5's (``csrc/jacobi_inverse.cu``
alone), and at phase 3g's inputs of ``chip_smoke.py`` (``K3_CASES``, their
outputs ``K3_OUTPUTS``), float32 and float64, times every variant against
K3 (CUDA events around 20 launches in a row, divided by 20, the median of 5
such runs); each of mode 0 must give K3's bits.  K5
(``kernels.jacobi_inverse``) takes the plan's units in row order; at
``K5_CASES`` it is timed against its probe over the plan's walk (longest
first) and over the units sorted by count within windows of ``WINDOW``
rows (the same bits).  Then the incidence counts of the plate's and the
beam-column's block-Jacobi plans (user and solve-space order): how many
nodes have each count, and, for warps of 32 units in row order and in the
walk, the sum over warps of the busiest lane's count against the sum of
the lanes' mean.  The card's ``nvidia-smi`` name and power limit first,
one JSON line last.  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import subprocess
from collections import Counter
from pathlib import Path

import torch

from fcvm_tpu_torch.ops import kernels

ROOT = Path(__file__).resolve().parents[2]
SOURCE = kernels.CSRC / "form_blocks_probe.cu"
LIBRARY = kernels.BUILD_DIR / "libk3_probe.so"
K5_SOURCE = kernels.CSRC / "jacobi_inverse_probe.cu"
K5_LIBRARY = kernels.BUILD_DIR / "libk5_probe.so"
NVCC = "/usr/local/cuda/bin/nvcc"
# the probe's variants (csrc/form_blocks_probe.cu): code, the layout
# ("pairs": K3's node pairs, 128 / sizeof(T) elements and 256 threads a
# block; an int: the column layout at that many elements a block), nodes
# gathered once into shared memory, blocks an SM asked of
# __launch_bounds__, threads an element's column pair, outputs staged in
# shared memory, the mode (0 the blocks; 1 stage 2's arithmetic without its
# stores; 2 its stores of zeros without its arithmetic; 3 stages 0 and 1
# alone: their bits unchecked)
VARIANTS = ((0, "pairs", False, 1, 8, False, 0), (13, "pairs", True, 1, 8, False, 0),
            (1, 64, True, 1, 1, False, 0),
            (2, 32, True, 3, 1, False, 0), (3, 32, True, 1, 1, False, 0),
            (4, 64, True, 2, 1, False, 0), (5, 16, True, 3, 2, False, 0),
            (6, 32, True, 2, 2, False, 0), (7, 16, False, 3, 2, False, 0),
            (8, 32, True, 2, 1, True, 0), (9, 16, True, 2, 2, True, 0),
            (10, 32, True, 3, 1, False, 1), (11, 32, True, 3, 1, False, 2),
            (12, 32, True, 3, 1, False, 3))
MODES = ("", ", arithmetic without stores", ", stores without arithmetic",
         ", stages 0 and 1 alone")
WINDOW = 256  # rows a window of the windowed count sort


def _nvcc():
    return NVCC if Path(NVCC).exists() else "nvcc"


def ptxas(args: list, pattern: str) -> list:
    """Run ``nvcc -Xptxas -v`` with ``args`` (a failed build raises) and
    return ptxas's (kernel, registers, spill bytes, shared bytes) of each
    entry whose mangled name matches ``pattern``."""
    done = subprocess.run([_nvcc(), *kernels.NVCC_FLAGS, "-std=c++17", "-Xptxas", "-v", *args],
                          capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"k3_probe: the build failed:\n{done.stderr[-4000:]}")
    out, name, spill = [], None, 0
    for line in done.stderr.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = int(m.group(1))
        elif (m := re.search(r"Used (\d+) registers", line)) and name and re.search(pattern,
                                                                                   name):
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(dict(kernel=name, registers=int(m.group(1)), spill_bytes=spill,
                            static_shared_bytes=int(smem.group(1)) if smem else 0))
            name = None
    return out


def build() -> tuple[ctypes.CDLL, ctypes.CDLL, list]:
    """Compile both probes and bind them; return them with ptxas's report
    of every K3 instantiation (``form_blocks_kernel<T, form, gathered>`` and
    ``column_kernel<T, form, Tile<elements, gathered, blocks an SM, threads
    a column pair, outputs staged, mode>>``)."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    regs = ptxas(["-shared", "-Xcompiler", "-fPIC", "-o", str(LIBRARY), str(SOURCE)],
                 "form_blocks_kernel|column_kernel")
    ptxas(["-shared", "-Xcompiler", "-fPIC", "-o", str(K5_LIBRARY), str(K5_SOURCE)], "$^")
    lib, k5 = ctypes.CDLL(str(LIBRARY)), ctypes.CDLL(str(K5_LIBRARY))
    ptr, ll, i, d = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
    for fn in (lib.fcvm_k3_probe_f32, lib.fcvm_k3_probe_f64):
        fn.argtypes = [i, i, ptr, ptr, ptr, ll, ptr, ptr, ll, ptr, ptr, ptr, ptr, d, ptr, ptr,
                       ptr, ptr, ll, ll, ll, ptr]
        fn.restype = ctypes.c_int
    for fn in (k5.fcvm_k5_probe_f32, k5.fcvm_k5_probe_f64):
        fn.argtypes = [i, ptr, ptr, ptr, ptr, ll, ll, ll, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    return lib, k5, regs


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


def probe_launcher(lib, args, kw, outs):
    """``(launch(variant), outputs)``: the probe's K3 on one case's inputs,
    prepared as ``kernels.form_blocks`` prepares them, into the outputs the
    case writes."""
    form, coords, eln = args
    dtype, nt = coords.dtype, eln.shape[0]
    ne = kw["perm"].shape[0] if "perm" in kw else nt
    tile = kernels.PACK_TILE[dtype]
    npad = -(-ne // tile) * tile if outs["packed"] else ne
    out = dict(full=torch.empty((30, 30, ne), dtype=dtype, device="cuda") if outs["full"]
               else None,
               packed=torch.empty((npad // tile, kernels.NPACK, tile), dtype=dtype,
                                  device="cuda") if outs["packed"] else None,
               diag=torch.empty((10, ne, kernels.DIAG), dtype=dtype, device="cuda")
               if outs["diag"] else None)
    g = h = None
    g3fac = 0.0
    if form == "tangent":
        if torch.is_tensor(kw["g"]) or torch.is_tensor(kw["h"]):
            g, h = (kernels._per_element(kw[k], nt, coords) for k in ("g", "h"))
        else:
            g3fac = 3.0 * float(kw["g"]) / (1.0 + float(kw["h"]) / (3.0 * float(kw["g"])))
    dmat = kw.get("dmat")
    fn = lib.fcvm_k3_probe_f32 if dtype == torch.float32 else lib.fcvm_k3_probe_f64

    def p(t):
        return None if t is None else t.data_ptr()

    def launch(variant):
        err = fn(variant, kernels.FORMS.index(form), coords.data_ptr(), p(kw.get("disp")),
                 kw["table"].data_ptr(), nt, p(kw.get("perm")),
                 p(dmat) if form != "geometric" else None,
                 36 if dmat is not None and dmat.dim() == 3 else 0,
                 p(kw.get("sig")) if form != "elastic" else None,
                 p(kw.get("pgp")) if form == "tangent" else None, p(g), p(h), g3fac,
                 p(kw.get("weights")), p(out["full"]), p(out["packed"]), p(out["diag"]), ne,
                 npad, tile, torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"k3_probe: variant {variant} failed with CUDA error {err}")

    return launch, out


def k3_variants(smoke, lib, setup, smi) -> list:
    """Every probe variant against K3 at each ``K3_CASES`` case."""
    rows = []
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).removeprefix("torch.")
        for model, form, case in smoke.K3_CASES:
            args, kw, outs = smoke.k3_inputs(setup, model, form, case, dtype)
            want = kernels.form_blocks(*args, **kw, **outs)
            launch, out = probe_launcher(lib, args, kw, outs)
            row = dict(dtype=dname, model=model, form=form, case=case,
                       k3=queued_ms(lambda: kernels.form_blocks(*args, **kw, **outs)))
            for code, elements, staged, per_sm, halves, outs_staged, mode in VARIANTS:
                label = ((f"node pairs, {halves} threads an element, nodes "
                          + ("gathered in every form" if staged else "read by each Gauss "
                             "point's thread in every form") if elements == "pairs"
                          else f"columns, {elements} elements, {per_sm} blocks an SM, {halves} "
                          "threads a column pair" + (", nodes gathered" if staged else ""))
                         + (", outputs staged" if outs_staged else "") + MODES[mode])
                launch(code)
                torch.cuda.synchronize()
                same = mode or all(w is None or torch.equal(w, out[k])
                                   for k, w in zip(("full", "packed", "diag"), want))
                if not same:
                    raise SystemExit(f"k3_probe: {dname} {model} {form} ({case}), {label}: not "
                                     "K3's bits")
                row[label] = queued_ms(lambda: launch(code))
            nbytes, ops = smoke.k3_work(args, kw, outs, dtype)
            row["bound_ms"] = smoke.bound(nbytes, ops, dtype)[0]
            print(f"K3 {dname} {model} {form} ({case}; {', '.join(smoke.K3_OUTPUTS[case])}): "
                  + "; ".join(f"{k} {v:.4f} ms" for k, v in row.items()
                              if isinstance(v, float))
                  + f" (CUDA events, 20 launches a run, median of 5; every variant of mode 0 "
                  f"K3's bits; {smi})", flush=True)
            rows.append(row)
            del args, kw, want, out
            torch.cuda.empty_cache()
    return rows


def windowed(plan) -> torch.Tensor:
    """The plan's units (3, nu) sorted by count, longest first, within each
    window of ``WINDOW`` rows (ties in row order)."""
    begin, end, segs = plan.offsets[:-1].long(), plan.offsets[1:].long(), plan.segs.long()
    window = torch.arange(segs.shape[0], device=segs.device) // WINDOW
    perm = torch.sort(window * 2**32 - (end - begin), stable=True).indices
    return torch.stack([begin[perm], end[perm], segs[perm]]).int().contiguous()


def k5_orders(smoke, k5lib, setup, smi) -> list:
    """K5 (the units in row order) against its probe over the plan's walk
    and over the windowed count sort, at each ``K5_CASES`` case; every
    order gives K5's bits."""
    rows = []
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).removeprefix("torch.")
        fn = k5lib.fcvm_k5_probe_f32 if dtype == torch.float32 else k5lib.fcvm_k5_probe_f64
        for model, case in smoke.K5_CASES:
            diag, plan, fixmask, kw, _ = smoke.k5_inputs(setup, model, case, dtype)
            cols = kw.get("cols")
            form = 1 if "reduce" in kw else 0
            rows_n = fixmask.shape[0] // 3
            want = torch.ops.fcvm.jacobi_inverse(form, diag, plan.order, plan.offsets,
                                                 plan.segs, plan.holes, rows_n, cols,
                                                 None if form else fixmask, None)
            out = torch.empty_like(want)

            def probe(units):
                err = fn(form, diag.data_ptr(), plan.order.data_ptr(), units.data_ptr(),
                         plan.holes.data_ptr(), units.shape[1], plan.holes.shape[0],
                         diag.shape[1], None if cols is None else cols.data_ptr(),
                         fixmask.data_ptr(), out.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"k3_probe: K5's probe failed with CUDA error {err}")

            row = dict(dtype=dname, model=model, case=case, form="sum" if form else "fused",
                       row_order_ms=queued_ms(lambda: kernels.jacobi_inverse(diag, plan, fixmask,
                                                                             **kw)))
            for name, units in (("walk", plan.walk), (f"windows of {WINDOW}", windowed(plan))):
                probe(units)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise SystemExit(f"k3_probe: K5 {dname} {model} ({case}) over the {name}: "
                                     "not K5's bits")
                row[f"{name}_ms"] = queued_ms(lambda: probe(units))
            print(f"K5 {dname} {model} ({case}, {row['form']}): "
                  + "; ".join(f"{k} {v:.4f}" for k, v in row.items() if k.endswith("_ms"))
                  + f" ms; every order K5's bits (CUDA events, 20 launches a run, median of 5; "
                  f"{smi})", flush=True)
            rows.append(row)
            del diag, plan, fixmask, kw
            torch.cuda.empty_cache()
    return rows


def warp_spread(counts: torch.Tensor) -> float:
    """Over warps of 32 consecutive units: the sum of each warp's largest
    count against the sum of its mean count."""
    n = counts.shape[0]
    pad = torch.zeros(-(-n // 32) * 32, dtype=torch.float64)
    pad[:n] = counts.double()
    warps = pad.reshape(-1, 32)
    live = torch.clamp(n - 32 * torch.arange(warps.shape[0]), max=32).double()
    return float(warps.max(dim=1).values.sum() / (warps.sum(dim=1) / live).sum())


def incidence_table(setup) -> list:
    """Each plan's nodes by incidence count, and the busiest lane against
    the mean in row order and in the walk."""
    from fcvm_tpu_torch.ops import assembly as asm

    rows = []
    for model, st in setup.items():
        be = st["be"]
        for order, plan in (("user", asm.jacobi_plan(be.elnodes, be.ndof_pad // 3)),
                            ("solve space", be.space.jacobi_plan)):
            rows_counts = (plan.offsets[1:] - plan.offsets[:-1]).cpu()
            walk_counts = (plan.walk[1] - plan.walk[0]).cpu()
            hist = dict(sorted(Counter(rows_counts.tolist()).items()))
            row = dict(model=model, order=order, units=rows_counts.shape[0],
                       holes=plan.holes.shape[0], incidences=int(rows_counts.sum()),
                       mean=float(rows_counts.double().mean()), nodes_by_count=hist,
                       busiest_over_mean_row_order=warp_spread(rows_counts),
                       busiest_over_mean_walk=warp_spread(walk_counts))
            print(f"{model} block-Jacobi plan ({order} order): {row['units']} nodes, "
                  f"{row['incidences']} incidences, {row['mean']:.3f} a node; nodes by count "
                  f"{hist}; a warp's busiest lane against its mean, summed over warps: row "
                  f"order {row['busiest_over_mean_row_order']:.4f}, the walk "
                  f"{row['busiest_over_mean_walk']:.4f}", flush=True)
            rows.append(row)
    return rows


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("k3_probe: torch.cuda.is_available() is false")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from fcvm_tpu_torch.config import pin_full_fp32

    pin_full_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    kernels.build()
    lib, k5lib, regs = build()
    regs += ptxas(["-c", "-o", str(kernels.BUILD_DIR / "jacobi_inverse_probe.o"),
                   str(kernels.CSRC / "jacobi_inverse.cu")], "jacobi_kernel")
    for r in regs:
        print(f"ptxas: {r}")
    models = {"plate": smoke.plate_model(smoke.PLATE_BIG),
              "column": smoke.column_model(smoke.COL_BIG, smoke.COL_W, smoke.COL_T)}
    setup = smoke.form_setup(models)
    out = {"card": smi, "ptxas": regs, "incidences": incidence_table(setup),
           "k3": k3_variants(smoke, lib, setup, smi), "k5": k5_orders(smoke, k5lib, setup, smi)}
    return out


if __name__ == "__main__":
    print(json.dumps(main()))
