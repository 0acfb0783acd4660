#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fcvm_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its numbers before the next starts:

1. device: the card's name, its ``nvidia-smi`` name and power limit, the
   torch and CUDA versions; float32 products must be full float32 (no TF32);
2. build: compile the port's CUDA kernels from ``fcvm_tpu_torch/csrc``;
3. kernel vs plain: K0 (``block_matvec``) against its plain PyTorch version
   at the headline plate's element count, float32 and float64;
3b. bandwidth probe: K0p (``soa_matvec``) and Kbw (``bw_read``, each k)
   against their plain versions on seeded data, then the probe
   (``fcvm_tpu_torch.tools.bw_probe``) at its full sizes, whose launches of
   K0p and Kbw are counted; the probe fails when a Kbw k takes less than 0.9
   of the time of a plain full read of the same 2 GiB (Kbw's result shows
   only the chunk heads, so its time is what shows it read every byte);
4. cross-check: a small plate-with-hole collapse in float64 on the GPU and
   on the CPU; the load-factor histories must agree;
5. the slice at full size: the quarter plate with a hole at 502,599 dof,
   float32, two-level PCG without deflation or the precision tiers, plastic
   Riks steps through ``fcvm_tpu_torch.solve_collapse``; the launch count
   of every kernel on that path must be > 0;
6. layers: on the same plate, the CUDA-event time of each piece of one CG
   iteration (K_hat·v and its stages, the preconditioner apply and its
   coarse product) and of one residual, and torch.profiler's share of
   device time per operation over one elastic solve;
7. the same plate and steps with the default configuration (Ritz deflation,
   residual refinement and the float64 failover on): phase 5's checks, at
   least one deflation space built, and the ratios of stepping time and CG
   iterations against phase 5.

Each phase prints its wall time.

Any failed check raises and the script exits non-zero.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists each kernel
with its launches, error and times.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

E, NU = 210000.0, 0.3
PLATE_SY, PLATE_SIGMA = 100.0, 50.0  # net-section limit LF (50-10)/50*100/50 = 1.6
PLATE_BIG = (54, 26, 14)  # n_circ, n_rad, n_thick -> 502,599 dof
PLATE_SMALL = (10, 8, 1)
NE_BIG = 117_936  # tet10 elements of PLATE_BIG
TOL_F32, TOL_F64 = 1e-5, 1e-12  # K0 vs plain: max |diff| / max |plain|
# K0p: max |diff| / max |plain| on standard normal data; Kbw: relative
# difference of the chunk sum on uniform [0, 1) data (no cancellation)
TOL_K0P, TOL_KBW = 1e-5, 1e-5
LBD_RTOL = 1e-9  # GPU vs CPU float64 load-factor histories
# the default solver tiers off: Ritz deflation and the float32 precision tiers
TIERS_OFF = dict(deflation=False, residual_refinement=False, precision_failover=False)


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"FAILED: {what}")


_phase = {}


def phase(name=None):
    """Print the wall time of the phase that ends here and start ``name``
    (``None``: the last phase ends)."""
    now = time.perf_counter()
    if _phase:
        print(f"(phase {_phase['name']}: {now - _phase['t0']:.1f} s wall)", flush=True)
    if name is not None:
        _phase.update(name=name.split()[0], t0=now)
        print(f"\n== {name}", flush=True)


def plate_model(size):
    from fcvm_tpu_torch.models import meshgen
    from fcvm_tpu_torch.models.spec import BoundaryConditions, Loads, Material, Model

    nc, nr, nt = size
    mesh = meshgen.plate_with_hole_tet10(
        radius=10.0, width=50.0, height=100.0, thickness=5.0,
        n_circ=nc, n_rad=nr, n_thick=nt,
    )
    bcs = BoundaryConditions.from_node_sets([
        (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
        (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
        (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
    ])
    top = mesh.faces_on(lambda x, y, z: y > 100.0 - 1e-6)
    loads = Loads(traction_faces=top,
                  tractions=np.tile([0.0, PLATE_SIGMA, 0.0], (len(top), 1)))
    return Model(mesh, Material(E, NU), bcs, loads, name="plate")


def plate_params(nstep):
    from fcvm_tpu_torch import ControlParams

    return ControlParams(sig_yield=PLATE_SY, nstep=nstep, iterat_max=20,
                         error_max=5e-4, et_e=0.0, target_lf=1.62,
                         ultimate_strain=0.25)


def cuda_ms(fn, *args, runs=20):
    """Median of ``runs`` CUDA-event timings of one call each (after a warm-up)."""
    fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def layer_breakdown(model, cfg):
    """Print where one CG iteration and one residual spend their time on
    ``model``: CUDA-event medians of each piece (the deflation correction
    and a deflation-space build included), the wall time per iteration of
    one elastic solve, and torch.profiler's device-time shares over it."""
    from fcvm_tpu_torch.ops import assembly as asm
    from fcvm_tpu_torch.ops import kernels
    from fcvm_tpu_torch.ops.deflation import NSTORE, RITZ_K, deflated, ritz_coefficients
    from fcvm_tpu_torch.runtime.backend import TorchSystem

    backend = TorchSystem(model, cfg, cfg.resolve_dtype(), cfg.resolve_device())
    coords = backend.tensor(model.mesh.coords)
    esm, pinv, glv, rhs, *_ = backend.assemble(coords)
    khat = backend.operator(esm)
    pc = backend.make_pc(esm, pinv)
    space = backend.space
    esm_t = khat.esm_t
    del esm, pinv
    eldofs_t = space.eldofs_m.T.contiguous()
    u = space.to_m(rhs)
    ue_t = u[eldofs_t]
    fe = kernels.block_matvec(esm_t, ue_t).reshape(-1)
    zc = torch.ones(pc.coarse_inv.shape[0], dtype=u.dtype, device=u.device)
    rows = [
        ("K_hat.v", cuda_ms(khat, u)),
        ("  gather (30, ne)", cuda_ms(lambda: u[eldofs_t])),
        ("  K0", cuda_ms(kernels.block_matvec, esm_t, ue_t)),
        ("  index_add_", cuda_ms(
            lambda: torch.zeros_like(u).index_add_(0, eldofs_t.reshape(-1), fe))),
        ("preconditioner apply", cuda_ms(pc.apply, u)),
        ("  block Jacobi", cuda_ms(asm.apply_block_precond, pc.pinv, u)),
        (f"  coarse GEMV ({zc.numel()})", cuda_ms(lambda: pc.coarse_inv @ zc)),
    ]
    del ue_t, fe
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = backend.solve(khat, pc, rhs, x0=backend.u_fix)
    torch.cuda.synchronize()
    solve_ms = 1e3 * (time.perf_counter() - t0)
    qnorm = max(float(torch.linalg.vector_norm(glv)), 1.0)
    sig_yield, sig0 = backend.gauss_full(PLATE_SY), backend.gauss_zeros((6,))
    zero = torch.zeros_like(res.x)
    rows.append(("residual (stress update + internal force), per Newton iteration",
                 cuda_ms(lambda: backend.residual(coords, sig_yield, zero, res.x, sig0,
                                                  glv, 1.0, qnorm, 0.0))))
    # a deflation space from a harvest of the same elastic solve, at the
    # driver's sizes
    res_h, h = backend.solve_harvest(khat, pc, rhs, x0=backend.u_fix, nstore=NSTORE)
    alphas, betas, rzs = torch.stack([h.alphas, h.betas, h.rzs]).cpu().numpy()
    coef = ritz_coefficients(alphas, betas, rzs, res_h.iters, RITZ_K)
    defl = backend.build_deflation(khat, h.zs, coef)
    res_d = backend.solve(khat, pc, rhs, x0=backend.u_fix, defl=defl)
    print(f"elastic solve: {res_h.iters} CG iterations harvesting, {res_d.iters} deflated "
          "by the space built from that harvest")
    rows += [
        (f"preconditioner apply + deflation correction (k = {RITZ_K})",
         cuda_ms(deflated(pc.apply, defl), u)),
        (f"deflation space build (k = {RITZ_K}, {NSTORE}-slot harvest), per harvest "
         "[median of 5]",
         cuda_ms(lambda: backend.build_deflation(khat, h.zs, coef), runs=5)),
    ]
    del h, defl
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"right after the timed loops: SM clock, memory clock, power, "
          f"temperature = {clocks}")
    print(f"elastic solve: {res.iters} CG iterations, {solve_ms:.1f} ms, "
          f"{solve_ms / res.iters:.4f} ms per iteration (wall, host sync included)")
    print("CUDA-event times, median of 20 runs unless marked:")
    for name, ms in rows:
        print(f"{name}: {ms:.4f} ms")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        backend.solve(khat, pc, rhs, x0=backend.u_fix)
        torch.cuda.synchronize()

    kernels_seen = sorted(
        (ev for ev in prof.key_averages()
         if ev.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda ev: ev.self_device_time_total, reverse=True)
    total = sum(ev.self_device_time_total for ev in kernels_seen)
    print(f"torch.profiler, one elastic solve: {total / 1e3:.1f} ms of device time "
          f"in {len(kernels_seen)} kernels")
    for ev in kernels_seen[:8]:
        print(f"  {100 * ev.self_device_time_total / total:5.1f}%  {ev.count:6d} x  "
              f"{ev.key[:90]}")


def probe_phase():
    """K0p and Kbw against their plain versions on seeded data, then the
    bandwidth probe at its full sizes with the launch counts set to 0 just
    before it; returns the kernels' JSON rows."""
    from fcvm_tpu_torch.ops import kernels
    from fcvm_tpu_torch.tools import bw_probe

    gen = torch.Generator(device="cuda").manual_seed(1)
    esm_t = torch.randn((30, 30, bw_probe.NE), generator=gen, device="cuda")
    ue_t = torch.randn((30, bw_probe.NE), generator=gen, device="cuda")
    out = kernels.soa_matvec(esm_t, ue_t, bw_probe.TILE)
    torch.cuda.synchronize()
    ref = kernels.soa_matvec_ref(esm_t, ue_t)
    k0p_err = float((out - ref).abs().max())
    rel = k0p_err / float(ref.abs().max())
    print(f"K0p vs plain, standard normal (30, 30, {bw_probe.NE}): max |diff| / max |plain| "
          f"{rel:.3e} (limit {TOL_K0P:g})")
    check(rel <= TOL_K0P, "K0p disagrees with its plain version")
    del esm_t, ue_t, out, ref
    x = torch.rand((bw_probe.ROWS, 128), generator=gen, device="cuda")
    kbw_err = {}
    for k in bw_probe.KS:
        out = kernels.bw_read(x, k, bw_probe.CHUNK_ROWS)
        torch.cuda.synchronize()
        ref = kernels.bw_read_ref(x, bw_probe.CHUNK_ROWS)
        kbw_err[k] = float((out - ref).abs().max())
        rel = kbw_err[k] / float(ref.abs().max())
        print(f"Kbw k={k} vs plain, uniform [0, 1) (2^22, 128): relative difference "
              f"{rel:.3e} (limit {TOL_KBW:g})")
        check(rel <= TOL_KBW, f"Kbw (k={k}) disagrees with its plain version")
    del x, out, ref
    torch.cuda.empty_cache()

    kernels.soa_matvec.launches = 0
    kernels.bw_read.launches = 0
    res = bw_probe.run(seed=0, report=lambda line: print(line, flush=True))
    launches = {"soa_matvec": kernels.soa_matvec.launches, "bw_read": kernels.bw_read.launches}
    print(f"launches in the probe run: {launches}")
    check(launches["soa_matvec"] > 0, "K0p was not launched by the probe")
    k0p = res["K0p soa_matvec"]
    rows = [{
        "name": "soa_matvec", "route": "cuda", "source": "fcvm_tpu_torch/csrc/bw_probe.cu",
        "replaces": "tools/bw_probe.py:106", "launches": launches["soa_matvec"],
        "max_abs_err": k0p_err, "ms": k0p["ms"],
        "plain_ms": res["plain einsum (soa_matvec_ref)"]["ms"],
    }]
    for k in bw_probe.KS:
        kbw = res[f"Kbw bw_read k={k}"]
        check(kbw["launches"] > 0, f"Kbw (k={k}) was not launched by the probe")
        rows.append({
            "name": "bw_read", "k": k, "route": "cuda",
            "source": "fcvm_tpu_torch/csrc/bw_probe.cu", "replaces": "tools/bw_probe.py:137",
            "launches": kbw["launches"], "max_abs_err": kbw_err[k], "ms": kbw["ms"],
            "plain_ms": res["plain bw_read_ref"]["ms"],
            "full_read_ms": res["plain full read x.sum()"]["ms"],
            "full_read_share": kbw["ms"] / res["plain full read x.sum()"]["ms"],
        })
    torch.cuda.empty_cache()
    return rows


def run_plate(big, cfg, label):
    """Drive ``solve_collapse`` on the full-size plate with ``cfg``, print
    every step, apply the slice's checks, and return the numbers."""
    from fcvm_tpu_torch import solve_collapse
    from fcvm_tpu_torch.ops import kernels
    from fcvm_tpu_torch.utils.indexing import pad_ndof

    lines, stamps = [], [time.perf_counter()]

    def monitor(disp_nodes, history):
        stamps.append(time.perf_counter())

    def continuation(history, info):
        # at least three plastic steps: add nstep more once if needed
        plastic = sum(p > 0.0 for p in history.peeqmax)
        return "add" if plastic < 3 and len(history.lbd) <= 5 else "stop"

    torch.cuda.reset_peak_memory_stats()
    kernels.block_matvec.launches = 0
    stamps[0] = time.perf_counter()
    res = solve_collapse(big, plate_params(4), continuation=continuation,
                         progress=lines.append, monitor=monitor, config=cfg)
    torch.cuda.synchronize()
    launches = kernels.block_matvec.launches
    wall = time.perf_counter() - stamps[0]
    t = res.timers
    cs = cfg.resolve_cluster_size(big.mesh.n_nodes)
    coarse_dim = cfg.coarse_modes * -(-pad_ndof(big.mesh.ndof) // 3 // cs)
    step_iters = sum(sum(s["cg"]) for s in res.cg_stats["steps"])
    step_solves = sum(len(s["cg"]) for s in res.cg_stats["steps"])
    elastic_iters = res.cg_stats["iters"] - step_iters
    print(f"assemble {t['assemble']:.3f} s, precond build {t['precond_build']:.3f} s "
          f"(coarse dim {coarse_dim}), elastic solve {t['elastic_solve']:.3f} s "
          f"({elastic_iters} CG iterations)")
    h = res.history
    for k, s in enumerate(res.cg_stats["steps"]):
        print(f"step {k}: lbd {h.lbd[k + 1]:.6f}, Newton {s['newton']}, restarts "
              f"{s['restarts']}, CG per solve {s['cg']}, {stamps[k + 1] - stamps[k]:.2f} s, "
              f"peeq max {h.peeqmax[k + 1]:.3e}")
    print(f"total {wall:.2f} s (stepping {t['stepping']:.2f} s), {res.cg_stats['solves']} "
          f"solves, {res.cg_stats['iters']} CG iterations ({step_iters} in {step_solves} "
          f"stepping solves), {1e3 * res.cg_stats['time'] / max(res.cg_stats['iters'], 1):.3f} "
          f"ms per CG iteration incl. stress updates, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, K0 launches {launches}")
    lbd = np.asarray(h.lbd)
    check(not any("MAXIMUM RESTARTS" in ln for ln in lines), f"{label}: a load step did not converge")
    check(len(res.cg_stats["steps"]) == len(lbd) - 1 >= 4, f"{label}: fewer than 4 recorded steps")
    check(bool(np.all(np.isfinite(lbd))), f"{label}: non-finite load factor")
    check(bool(np.all(np.diff(lbd) >= 0.0)), f"{label}: load factor decreased")
    check(lbd.max() < 1.76, f"{label}: peak load factor {lbd.max():.4f} above 1.1 x the 1.6 bound")
    check(sum(p > 0.0 for p in h.peeqmax) >= 3, f"{label}: fewer than 3 plastic steps")
    check(float(res.peeq_gp.max()) > 0.0 and h.peeqmax[-1] > 0.0, f"{label}: no plastic strain")
    check(res.sig_gp.shape == (NE_BIG, 4, 6) and bool(np.isfinite(res.sig_gp).all()),
          f"{label}: stresses are not finite (ne, 4, 6)")
    check(launches > 0, f"{label}: K0 was not launched on the main path")
    return dict(lines=lines, cg_stats=res.cg_stats,
                stepping=t["stepping"], step_iters=step_iters, step_solves=step_solves,
                launches=launches, lbd=lbd)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: torch.cuda.is_available() is false; this "
                         "script runs the port on an NVIDIA GPU")
    from fcvm_tpu_torch import FcvmConfig, solve_collapse
    from fcvm_tpu_torch.config import pin_full_fp32
    from fcvm_tpu_torch.ops import kernels

    t_start = time.perf_counter()
    phase("1 device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    print(smi)
    pin_full_fp32()
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is allowed")

    phase("2 build")
    info = kernels.build()
    print(f"built and loaded {info.path} in {info.seconds:.2f} s (sm_90a, "
          "torch.ops.fcvm)")

    phase(f"3 kernel vs plain, ne = {NE_BIG} ({smi})")
    rng = np.random.default_rng(0)
    k0 = {}
    for dtype, tol in ((torch.float32, TOL_F32), (torch.float64, TOL_F64)):
        esm_t = torch.as_tensor(rng.standard_normal((30, 30, NE_BIG)), device="cuda").to(dtype)
        ue_t = torch.as_tensor(rng.standard_normal((30, NE_BIG)), device="cuda").to(dtype)
        out = kernels.block_matvec(esm_t, ue_t)
        torch.cuda.synchronize()
        ref = kernels.block_matvec_ref(esm_t, ue_t)
        abs_err = float((out - ref).abs().max())
        rel_err = abs_err / float(ref.abs().max())
        ms = cuda_ms(kernels.block_matvec, esm_t, ue_t)
        plain_ms = cuda_ms(kernels.block_matvec_ref, esm_t, ue_t)
        gbs = esm_t.numel() * esm_t.element_size() / ms / 1e6
        print(f"{dtype}: max rel err {rel_err:.3e} (limit {tol:g}), kernel "
              f"{ms:.4f} ms ({gbs:.0f} GB/s esm read), plain {plain_ms:.4f} ms, "
              f"median of 20")
        check(rel_err <= tol, f"K0 disagrees with its plain version in {dtype}")
        k0[dtype] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)
        del esm_t, ue_t, out, ref
    torch.cuda.empty_cache()

    phase(f"3b bandwidth probe: K0p and Kbw vs plain, then the probe ({smi})")
    probe_rows = probe_phase()

    phase("4 small plate, float64, GPU vs CPU")
    small = plate_model(PLATE_SMALL)
    lbds = {}
    for dev in ("cuda", "cpu"):
        cfg = FcvmConfig(device=dev, dtype="float64", cg_rtol=1e-10, **TIERS_OFF)
        t0 = time.perf_counter()
        res = solve_collapse(small, plate_params(6), config=cfg)
        lbds[dev] = np.asarray(res.history.lbd)
        print(f"{dev}: {time.perf_counter() - t0:.2f} s, lbd {lbds[dev].round(6).tolist()}")
    check(len(lbds["cuda"]) == len(lbds["cpu"]) == 7, "step counts differ from 6")
    diff = float(np.max(np.abs(lbds["cuda"] - lbds["cpu"]) / np.maximum(np.abs(lbds["cpu"]), 1e-300)))
    print(f"max rel lbd difference {diff:.3e} (limit {LBD_RTOL:g})")
    check(diff <= LBD_RTOL, "GPU and CPU load-factor histories disagree")

    phase("5 plate with hole at full size, float32, deflation and precision tiers off")
    t0 = time.perf_counter()
    big = plate_model(PLATE_BIG)
    print(f"{big.mesh.n_nodes} nodes, {big.mesh.n_elements} elements, "
          f"{big.mesh.ndof} dof (mesh built in {time.perf_counter() - t0:.1f} s)")
    check(big.mesh.ndof == 502_599 and big.mesh.n_elements == NE_BIG, "unexpected mesh size")
    cfg = FcvmConfig(device="cuda", dtype="float32", precond="two_level", **TIERS_OFF)
    off = run_plate(big, cfg, "phase 5")

    phase("6 layers of one CG iteration, plate at full size, float32")
    layer_breakdown(big, cfg)

    phase("7 plate with hole at full size, float32, default configuration")
    cfg7 = FcvmConfig(device="cuda", dtype="float32")
    check(cfg7.deflation and cfg7.residual_refinement and cfg7.precision_failover,
          "the default configuration has a tier off")
    on = run_plate(big, cfg7, "phase 7")
    cs = on["cg_stats"]
    built = [hv for hv in cs["harvests"] if hv["k"] > 0]
    print(f"harvesting solves: {len(cs['harvests'])} (step, CG iterations, Ritz vectors "
          f"kept): {[(hv['step'], hv['iters'], hv['k']) for hv in cs['harvests']]}")
    print(f"deflation spaces built: {len(built)}; dropped as stale: "
          f"{sum('deflation space stale' in ln for ln in on['lines'])}")
    failover = any(ln.startswith("PRECISION FAILOVER") for ln in on["lines"])
    print(f"refinement activations {cs['refinement_activations']} (from step "
          f"{cs['refined_from_step']}), floor clamps {cs['floor_clamps']}, "
          f"float64 failover {'fired' if failover else 'not fired'}")
    check(len(built) >= 1, "phase 7: no deflation space was built")
    mean = {k: v["step_iters"] / max(v["step_solves"], 1) for k, v in (("off", off), ("on", on))}
    print(f"default vs phase 5: stepping time {on['stepping']:.2f} / {off['stepping']:.2f} s "
          f"= {on['stepping'] / off['stepping']:.3f}; stepping CG iterations "
          f"{on['step_iters']} / {off['step_iters']} = {on['step_iters'] / off['step_iters']:.3f}; "
          f"CG iterations per solve {mean['on']:.1f} / {mean['off']:.1f} = "
          f"{mean['on'] / mean['off']:.3f}")
    phase()
    print(f"all phases: {time.perf_counter() - t_start:.1f} s wall")

    print(json.dumps({"kernels": [{
        "name": "block_matvec", "route": "cuda",
        "source": "fcvm_tpu_torch/csrc/block_matvec.cu",
        "replaces": "fcvm_tpu/ops/pallas_kernels.py:60",
        "launches": off["launches"], **k0[torch.float32],
    }, *probe_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
