"""Run one part of ``chip_smoke.py`` against the port of a given checkout.

Compares two trees of the port on one card, in turns (A B B A, each turn a
process of its own):

    python fcvm_tpu_torch/tools/turns.py TREE kernels  # K0, K0p, K0m, K1, K4 at the paths' shapes
    python fcvm_tpu_torch/tools/turns.py TREE plate    # phases 5 and 7 (stepping times)
    python fcvm_tpu_torch/tools/turns.py TREE column   # phase 9 (eigensolve, stepping)

``TREE`` is the root of a checkout (``.`` for this one, or a ``git archive``
of another commit unpacked in a directory that ``.gitignore`` lists); its
``fcvm_tpu_torch`` is imported and built, while the phases' code is this
checkout's ``chip_smoke.py``.  Prints the card's ``nvidia-smi`` name and
power limit, then one JSON line.  Needs a CUDA device.  A tree from before
K1 and K4 (``kernels.khat_matvec``, ``two_level_apply``) times and launches
K0 where they would be: its plate runs are held to K0's launches, and its
``kernels`` part has no K1 and K4 rows.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parents[2]


def main(tree: str, part: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("turns.py: torch.cuda.is_available() is false")
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from fcvm_tpu_torch import FcvmConfig
    from fcvm_tpu_torch.config import pin_full_fp32
    from fcvm_tpu_torch.ops import kernels

    # an older tree's wrappers keep no counts by shape, and a tree from
    # before K1 and K4 has neither: give them empty ones
    fused = hasattr(kernels, "khat_matvec")
    if not fused:
        for name in smoke.CG_KERNELS:
            setattr(kernels, name, SimpleNamespace(launches=0, dtypes=Counter()))
    for fn, attr in ((kernels.block_matvec, "dtypes"), (kernels.block_matmat, "shapes")):
        if not hasattr(fn, attr):
            setattr(fn, attr, Counter())
    pin_full_fp32()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"port from {kernels.__file__}; build {kernels.build().seconds:.1f} s", flush=True)
    out = {"tree": tree, "part": part}
    if part == "kernels":
        k0 = smoke.k0_phase()
        out["k0"] = [{"dtype": str(dt).removeprefix("torch."), "ne": ne, **row}
                     for (dt, ne), row in k0.items()]
        # K0p, K0's contraction in the probe's layout (a thread over all 30
        # rows), float32 only, at a tile that divides ne
        gen = torch.Generator(device="cuda").manual_seed(5)
        out["k0p"] = []
        for ne in smoke.K0_SHAPES:
            tile = max(t for t in range(32, 1025, 16) if ne % t == 0)
            esm_t = torch.randn((30, 30, ne), generator=gen, device="cuda")
            ue_t = torch.randn((30, ne), generator=gen, device="cuda")
            ms = smoke.cuda_ms(kernels.soa_matvec, esm_t, ue_t, tile)
            print(f"K0p float32 ne={ne} tile={tile}: {ms:.4f} ms")
            out["k0p"].append({"ne": ne, "tile": tile, "ms": ms})
            del esm_t, ue_t
        k0m = smoke.k0m_phase()
        out["k0m"] = [{"dtype": str(dt).removeprefix("torch."), "ne": ne, "m": m, **row}
                      for (dt, ne, m), row in k0m.items()]
        if fused:  # K1 and K4 on the plate's and the beam-column's operators
            models = {"plate": smoke.plate_model(smoke.PLATE_BIG),
                      "column": smoke.column_model(smoke.COL_BIG, smoke.COL_W, smoke.COL_T)}
            out["k1_k4"] = [{"kernel": k, "dtype": dt, "model": m, "variant": v, **row}
                            for (k, dt, m, v), row in smoke.cg_kernel_phase(models).items()]
    elif part == "plate":
        big = smoke.plate_model(smoke.PLATE_BIG)
        for label, cfg in (("phase 5", FcvmConfig(device="cuda", dtype="float32",
                                                  precond="two_level", **smoke.TIERS_OFF)),
                           ("phase 7", FcvmConfig(device="cuda", dtype="float32"))):
            r = smoke.run_plate(big, cfg, label,
                                required=smoke.CG_KERNELS if fused else ("block_matvec",))
            out[label] = dict(stepping=r["stepping"], step_iters=r["step_iters"],
                              cg_iters=r["cg_stats"]["iters"], launches=r["launches"])
    elif part == "column":
        out["phase 9"] = smoke.run_column(
            FcvmConfig(device="cuda", dtype="float32"),
            required=(*smoke.CG_KERNELS, "block_matmat") if fused else ("block_matvec",))
    else:
        raise SystemExit(f"turns.py: unknown part {part!r}")
    return out


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    print(json.dumps(main(sys.argv[1], sys.argv[2])))
