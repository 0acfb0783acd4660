"""Run one part of ``chip_smoke.py`` against the port of a given checkout.

Compares two trees of the port on one card, in turns (A B B A, each turn a
process of its own):

    python fcvm_tpu_torch/tools/turns.py TREE kernels  # K0, K0p, K0m, K1, K4, K8, K1m, K4m
                                                       # and K4c alone at the paths' shapes
    python fcvm_tpu_torch/tools/turns.py TREE cg       # TREE's own phase 3c on the plate
    python fcvm_tpu_torch/tools/turns.py TREE k6       # K6's passes of an iteration at the
                                                       # paths' shapes (phase 3e's timings)
    python fcvm_tpu_torch/tools/turns.py TREE plate    # phases 5 and 7 (stepping times, the
                                                       # Newton and CG counts, lbd's bits)
    python fcvm_tpu_torch/tools/turns.py TREE column   # phases 9 (eigensolve, stepping, peak
                                                       # memory) and 9b (its pieces)
    python fcvm_tpu_torch/tools/turns.py TREE smoother # phase 11 (stepping, the counts, lbd's
                                                       # bits; the two-level build and its split)
    python fcvm_tpu_torch/tools/turns.py TREE blocks   # phase 3d alone: K1m, K4m and K4c at
                                                       # the paths' widths, cuSPARSE beside
                                                       # K1m, torch.mm beside K4c
    python fcvm_tpu_torch/tools/turns.py TREE k2       # TREE's own phase 3f: K2 at the paths'
                                                       # shapes, the plate's residual
    python fcvm_tpu_torch/tools/turns.py TREE headline # TREE's bench headline: one plastic
                                                       # step of the plate (min of 3)

``TREE`` is the root of a checkout (``.`` for this one, or a ``git archive``
of another commit unpacked in a directory that ``.gitignore`` lists); its
``fcvm_tpu_torch`` is imported and built, while the phases' code is this
checkout's ``chip_smoke.py``, except for ``cg``, which runs TREE's own
``chip_smoke.py`` phase 3c (K1 and K4 as that tree calls them, against
its plain versions, the chain K1 replaced and cuSPARSE) on the plate, and
``k2``, which runs TREE's own phase 3f (K2 and the residual as that tree
runs them) on the plate and the beam-column, and ``headline``, TREE's
``tools.bench.step_time`` of the plate.  Prints the card's ``nvidia-smi`` name and
power limit, then one JSON line.  Needs a CUDA device.  A tree from before
K1 and K4 (``kernels.khat_matvec``, ``two_level_apply``) times and launches
K0 where they would be: its plate runs are held to K0's launches, and its
``kernels`` part has no K1 and K4 rows.  A tree from before K8
(``segment_sum``) and K1's packed blocks is held to the kernels it has, and
its ``kernels`` part has no K1, K4 and K8 rows.  A tree from before K8's
write form times, at the sites that use it, what its paths run there:
``torch.zeros``, then K8 accumulating.  A tree from before K1m and K4m
(``kernels.khat_matmat``, ``two_level_apply_block``) is held to K0m's
launches in its column run, times its chains in 9b, and its ``kernels``
part has no K1m and K4m rows.  A tree from before K4c (``kernels.pack_coarse``)
keeps the dense coarse inverse: its K4 and K4m rows time its coarse product,
cuBLAS's GEMV or GEMM on that inverse, where K4c would be, and count their
bounds on the stored triangle as this checkout's do.
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


def block_rows(smoke, models) -> list:
    """Phase 3d's K1m and K4m rows on ``models``, one dict a row."""
    return [{"kernel": k, "dtype": dt, "model": mo, "variant": v, "m": m, **row}
            for (k, dt, mo, v, m), row in smoke.block_kernel_phase(models).items()]


def keyed_rows(rows) -> list:
    """``{key tuple: row}`` as a list of rows with their keys (``key``);
    other entries (a dict of them, or numbers) under their names."""
    out = []
    for k, v in rows.items():
        if isinstance(k, tuple):
            out.append({"key": list(k), **v})
        elif isinstance(v, dict) and v and all(isinstance(x, tuple) for x in v):
            out += [{"key": [k, *x], **row} for x, row in v.items()]
        else:
            out.append({"key": [k], "value": v})
    return out


def tree_smoke(tree: str):
    """TREE's own ``chip_smoke.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "tree_smoke", Path(tree).resolve() / "chip_smoke.py")
    tsmoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tsmoke)
    return tsmoke


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

    # an older tree's wrappers keep no counts by shape, and an older tree
    # lacks the newer kernels: give them empty ones
    fused = hasattr(kernels, "khat_matvec")
    blocks = hasattr(kernels, "khat_matmat")
    has = tuple(name for name in smoke.CG_KERNELS if hasattr(kernels, name))
    for name in smoke.PATH_KERNELS:
        if not hasattr(kernels, name):
            setattr(kernels, name, SimpleNamespace(launches=0, dtypes=Counter(),
                                                   shapes=Counter()))
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
        if hasattr(kernels, "pack_blocks"):  # K1, K4 and K8 on the paths' operators
            models = {"plate": smoke.plate_model(smoke.PLATE_BIG),
                      "column": smoke.column_model(smoke.COL_BIG, smoke.COL_W, smoke.COL_T)}
            out["k1_k4"] = [{"kernel": k, "dtype": dt, "model": m, "variant": v, **row}
                            for (k, dt, m, v), row in smoke.cg_kernel_phase(models).items()]
            out["k8"] = [{"dtype": dt, "model": m, "site": site, **row}
                         for (dt, m, site), row in smoke.k8_phase(models).items()]
            if blocks:
                out["k1m_k4m"] = block_rows(smoke, models)
    elif part == "blocks":
        if not blocks:
            raise SystemExit("turns.py: this tree has no K1m and K4m")
        out["k1m_k4m"] = block_rows(smoke, {
            "plate": smoke.plate_model(smoke.PLATE_BIG),
            "column": smoke.column_model(smoke.COL_BIG, smoke.COL_W, smoke.COL_T)})
    elif part == "k6":
        models = {"plate": smoke.plate_model(smoke.PLATE_BIG),
                  "column": smoke.column_model(smoke.COL_BIG, smoke.COL_W, smoke.COL_T)}
        out["k6"] = [{"dtype": dt, "model": m, "form": f, **row}
                     for (dt, m, f), row in smoke.k6_times(models, compare=False).items()]
    elif part == "k2":
        tsmoke = tree_smoke(tree)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        models = {"plate": tsmoke.plate_model(tsmoke.PLATE_BIG),
                  "column": tsmoke.column_model(tsmoke.COL_BIG, tsmoke.COL_W, tsmoke.COL_T)}
        out["k2"] = keyed_rows(tsmoke.k2_phase(models, smi))
    elif part == "headline":
        from fcvm_tpu_torch.tools import bench as tb

        t_step, ndof, t_asm, iters, diag = tb.step_time(lambda: tb.build_plate(tb.PLATE_BIG),
                                                        label="plate ")
        print(f"headline plastic step of the plate ({ndof} dof): {1e3 * t_step:.2f} ms; "
              f"elastic CG {iters}; launches {diag['launches']}")
        out["headline"] = dict(step_ms=1e3 * t_step, ndof=ndof, assembly_s=t_asm,
                               elastic_iters=iters, launches=diag["launches"],
                               peak_mib=diag.get("peak_mib"))
    elif part == "cg":
        tsmoke = tree_smoke(tree)
        rows = tsmoke.cg_kernel_phase({"plate": tsmoke.plate_model(tsmoke.PLATE_BIG)})
        out["cg"] = [{"kernel": k, "dtype": dt, "model": m, "variant": v, **row}
                     for (k, dt, m, v), row in rows.items()]
    elif part == "plate":
        big = smoke.plate_model(smoke.PLATE_BIG)
        for label, cfg in (("phase 5", FcvmConfig(device="cuda", dtype="float32",
                                                  precond="two_level", **smoke.TIERS_OFF)),
                           ("phase 7", FcvmConfig(device="cuda", dtype="float32"))):
            r = smoke.run_plate(big, cfg, label, required=has if fused else ("block_matvec",))
            out[label] = dict(stepping=r["stepping"], step_iters=r["step_iters"],
                              cg_iters=r["cg_stats"]["iters"], launches=r["launches"],
                              newton=[s["newton"] for s in r["cg_stats"]["steps"]],
                              cg=[s["cg"] for s in r["cg_stats"]["steps"]],
                              lbd_bits=[float(x).hex() for x in r["lbd"]])
    elif part == "smoother":
        big = smoke.plate_model(smoke.PLATE_BIG)
        cfg = FcvmConfig(device="cuda", dtype="float32", smoother="cluster")
        r = smoke.run_plate(big, cfg, "phase 11", required=has)
        out["phase 11"] = dict(stepping=r["stepping"], step_iters=r["step_iters"],
                               cg_iters=r["cg_stats"]["iters"],
                               peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                               newton=[s["newton"] for s in r["cg_stats"]["steps"]],
                               cg=[s["cg"] for s in r["cg_stats"]["steps"]],
                               lbd_bits=[float(x).hex() for x in r["lbd"]])
        build, split = smoke.build_split(big, cfg)
        for table, pieces in split.items():
            print(f"{table}: " + "; ".join(f"{k.strip()} {v:.4f} ms" for k, v in pieces.items()
                                           if k != "chunks") + f" ({pieces['chunks']} chunks)")
        print(f"build: {build}")
        out["build"], out["split"] = build, split
    elif part == "column":
        cfg = FcvmConfig(device="cuda", dtype="float32")
        out["phase 9"] = smoke.run_column(
            cfg, required=((*has, *smoke.BLOCK_KERNELS) if blocks else
                           (*has, "block_matmat") if fused else ("block_matvec",)),
            absent=("block_matmat",) if blocks else ())
        out["phase 9b"] = smoke.column_breakdown(cfg)
    else:
        raise SystemExit(f"turns.py: unknown part {part!r}")
    return out


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    print(json.dumps(main(sys.argv[1], sys.argv[2])))
