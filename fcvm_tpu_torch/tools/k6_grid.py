"""K6's two passes at several grid sizes, on one card.

    python -m fcvm_tpu_torch.tools.k6_grid

Times one CG iteration's passes on the inputs of ``chip_smoke.py`` phase
3e (the plate's vector in float32 and float64, the beam-column's block at
m = 8 in float32) with the plan's grid at its resident size
(``kernels.cg_grid``) and at a half, a quarter and an eighth of it: the
CUDA-event time of the iteration and each pass's device time
(torch.profiler), in turns (largest grid first, then the reverse order).
A smaller grid has fewer blocks at each barrier and fewer partials for
every block to add, and more items a thread.  Prints the card's
``nvidia-smi`` name and power limit, then one JSON line.  Needs a CUDA
device.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
CASES = (("plate", torch.float32, 0), ("plate", torch.float64, 0), ("column", torch.float32, 8))


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("k6_grid: torch.cuda.is_available() is false")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from fcvm_tpu_torch.ops import kernels
    from fcvm_tpu_torch.utils.indexing import pad_ndof

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    ndof = {"plate": smoke.NDOF_BIG, "column": 451_875}
    rows = []
    for name, dtype, m in CASES:
        n = pad_ndof(ndof[name])
        plan, vecs = smoke.k6_inputs(n, m, dtype)
        resident = plan.grid
        grids = [resident // d for d in (1, 2, 4, 8)]
        times = {g: [] for g in grids}
        for order in (grids, grids[::-1]):
            for g in order:
                plan.grid = g
                plan.scratch = torch.empty(kernels.cg_layout(g, max(m, 1), 0)[3], dtype=dtype,
                                           device="cuda")

                def iteration():
                    for step in range(len(kernels.CG_PASSES)):
                        kernels.cg_iteration(step, plan, *vecs)

                by = smoke.device_ms_by_kernel(iteration)
                times[g].append(dict(ms=smoke.cuda_ms(iteration),
                                     device_ms={k: v for k, v in by.items()
                                                if k.startswith("cg_")}))
        for g in grids:
            dev = [sum(t["device_ms"].values()) for t in times[g]]
            print(f"K6 {str(dtype).removeprefix('torch.')} {name} m={max(m, 1)} n={n} grid {g} "
                  f"(resident {resident}): device {dev[0]:.4f} / {dev[1]:.4f} ms, events "
                  f"{times[g][0]['ms']:.4f} / {times[g][1]['ms']:.4f} ms (turns 1 / 2); per pass "
                  f"{times[g][0]['device_ms']}")
            rows.append(dict(model=name, dtype=str(dtype).removeprefix("torch."), m=max(m, 1),
                             n=n, grid=g, resident=resident, runs=times[g]))
        del plan, vecs
        torch.cuda.empty_cache()
    return {"k6_grid": rows}


if __name__ == "__main__":
    print(json.dumps(main()))
