#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fcvm_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its numbers before the next starts:

1. device: the card's name, its ``nvidia-smi`` name and power limit, the
   torch and CUDA versions; float32 products must be full float32 (no TF32);
2. build: compile the port's CUDA kernels from ``fcvm_tpu_torch/csrc``;
3. kernel vs plain: K0 (``block_matvec``) against its plain PyTorch version
   and ``torch.bmm`` at the plate's and the beam-column's element counts
   (``K0_SHAPES``), float32 and float64; K0m
   (``block_matmat``) against its plain version and ``torch.bmm`` at every
   shape the paths give it (``K0M_SHAPES``: the beam-column's element count
   with m = 1 to 8, 32 and 64, the plate's with m = 32), float32 and
   float64, timed beside m launches of K0;
3b. bandwidth probe: K0p (``soa_matvec``) and Kbw (``bw_read``, each k)
   against their plain versions on seeded data, then the probe
   (``fcvm_tpu_torch.tools.bw_probe``) at its full sizes, whose launches of
   K0, K0p and Kbw are counted (the probe is K0's path: the solver's
   K_hat·v runs K1); the probe fails when a Kbw k takes less than 0.9
   of the time of a plain full read of the same 2 GiB (Kbw's result shows
   only the chunk heads, so its time is what shows it read every byte);
3c. the kernels of the CG iteration: K1 (``khat_matvec``, the fused
   K_hat·v, masked and raw) on the plate's and the beam-column's operators
   and K4 (``two_level_apply``, with block Jacobi and with the cluster
   smoother's output) on the plate's preconditioner, float32 and float64,
   against their plain versions, K1 bit for bit the same on a second call;
   timed against their plain versions, against the chain K1 replaced
   (gather, K0, ``index_add_``, masks) and, for K1, against a cuSPARSE CSR
   matvec of the assembled K_hat (``torch.sparse``, built once here);
4. cross-check: a small plate-with-hole collapse in float64 on the GPU and
   on the CPU, small strain and geometrically nonlinear (``gnl="GNLY"``);
   the load-factor histories must agree; and ``linear_buckling`` of a small
   clamped-free column on both, whose factors must agree;
5. the slice at full size: the quarter plate with a hole at 502,599 dof,
   float32, two-level PCG without deflation or the precision tiers, plastic
   Riks steps through ``fcvm_tpu_torch.solve_collapse``; the launch counts
   of K1 and K4, the kernels on that path, must be > 0;
6. layers: on the same plate, the CUDA-event time of each piece of one CG
   iteration (K_hat·v through K1 and the stages of the chain it replaced,
   the preconditioner apply through K4 and its coarse product, the plain
   apply) and of one residual, and torch.profiler's share of device time
   per operation over one elastic solve;
7. the same plate and steps with the default configuration (Ritz deflation,
   residual refinement and the float64 failover on): phase 5's checks, at
   least one deflation space built, and the ratios of stepping time and CG
   iterations against phase 5;
8. the same plate and steps with geometric nonlinearity (``gnl="GNLY"``,
   ``max_imp = 0``) and the default configuration: phase 5's checks, at
   least one tangent predictor solve, the Newton iterations, correction and
   predictor CG counts of every step, the refreshes' time and the stepping
   time against phase 7;
8b. one tangent refresh in pieces, on the plastic end state of phase 8:
   CUDA-event times of the tangent formation, the follower loads, the
   operator build, the block-Jacobi rebuild, the predictor solve cold and
   warm-started, and the GNL residual against the small-strain one;
9. the imperfect beam-column of ``examples/imperfect_column_collapse.toml``
   refined to 451,875 dof, float32, default configuration: the linear
   buckling eigensolve (its tier, sweeps, pencil residuals and inner CG
   iterations), imperfection seeding and a few GNL steps; both factors
   within 3% of the clamped-free Euler value, the imperfection applied
   exactly, every step converged below the squash factor, and K1, K4 and
   K0m launched on the path (K1 and K4 by dtype, K0m by dtype and column
   count);
9b. the eigensolve in pieces on the same mesh: CUDA-event times of the
   geometric-block formation, one K_hat·V and one -G_hat·V at m = 8, the
   block preconditioner apply against 8 vector applies, and one pcg_block
   iteration against one pcg iteration (wall, host sync included);
10. the case-file path at full size: a TOML case of the phase-5 plate with
   a region ``y > 75`` twice as stiff and Sum groups on the loaded face and
   edge, through ``load_case``, ``run_analysis`` (float32, default
   configuration, no plots) and ``run_sum``, then the CLI's ``info`` and
   ``sum``: the ``.out``/``.vtk``/``.avr`` written and read back, the face
   area and edge length, phase 5's bars on the steps, a per-element
   elasticity in the backend, K1 and K4 launched and the native formatter
   loaded;
   the timers of every stage and of the host-side export pieces;
10b. ``python -m fcvm_tpu_torch run --x64`` on the small plate with the same
   region, on the GPU and with ``--cpu``: load factors and the ``.vtk``
   fields to CLI_RTOL; then ``--resume`` from the first half of the GPU
   run's checkpoints lands on the straight run's last ``.out`` row; K1 and
   K4 launched by the GPU run only;
11. the phase-7 plate and steps with the cluster block-Cholesky smoother
   (``smoother="cluster"``, 64-node clusters): phase 5's checks, one
   smoother per operator, the stepping time, CG iterations and ms per CG
   iteration against phase 7's; then the smoother's pieces (the build with
   and without it and the memory it adds, its accumulate and factorization,
   its apply against block Jacobi's and against the bound of reading its
   inverses once);
11b. the same with ``gnl="GNLY"`` (``max_imp = 0``): the tangent refreshes
   keep the elastic smoother (one build per analysis), against phase 8;
11c. the small plate in float64 with the smoother on the GPU and on the
   CPU at ``cg_rtol`` 1e-10, small strain and GNL: the load factors to
   LBD_RTOL;
12. a synthetic FreeCAD ``.FCStd`` document of the phase-5 plate
   (``fcvm_tpu_torch.tools.fcstd_doc``: symmetry planes as Displacement
   constraints, a Fixed corner, a Force on the top face) through
   ``python -m fcvm_tpu_torch run doc.FCStd --inp doc.inp --x64`` on the
   GPU against the same model's TOML case through the CLI: the load
   factors to CLI_RTOL, no ``.avr`` for the document, phase 5's bars on the
   steps, K1 and K4 launched; the host times of ``read_fcstd``, the resolver and
   ``build_model``;
11d. (before 12) the phase-5 plate written with ``meshio_io.write_gmsh`` and
   read back through the native Gmsh reader in this process, after the CUDA
   extension has loaded: the same coordinates and connectivity;
13. the sharded backend (``fcvm_tpu_torch.parallel``) on a world of one over
   NCCL, this process its rank (``force_sharded``): the phase-7 plate with
   phase 7's configuration and checks, held against phase 7 (the same
   steps, the final lbd within 1e-3, stepping CG iterations within 3%),
   K1, K4 and K0m launched, the time of one ``all_reduce`` of the plate's
   vector; then the beam-column's eigensolve, seeding and two GNL steps on
   the sharded backend with phase 9's bars;
13b. two gloo ranks spawned on ``cuda:0`` (NCCL refuses two ranks on one
   card): phase 4's small plate, small strain and GNL, and the small
   column's buckling (``nstep = 1``) in float64 against the CPU's
   single-device runs (lbd to LBD_RTOL, factors to EIG_RTOL), both ranks'
   histories identical, K1, K4 and K0m launched on each rank.
14. the port's benchmark (``fcvm_tpu_torch.tools.bench.main`` with
   ``--no-same-size``, in this process): the matched plate, the 502,599-dof
   headline plate (plastic, ``assembly_gdof_s`` > 0), the box at 499,125
   dof, the capacity rows at 1,073,733 and 1,975,509 dof (converged below
   the CG cap) with each row's peak device memory, the sharded row within
   its ``lbd_tol``, a ``vs_baseline`` from the CPU child, and K1 and K4
   launched in every row.

Each phase prints its wall time.

Any failed check raises and the script exits non-zero.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists each kernel
with its launches, error and times.
"""

from __future__ import annotations

import faulthandler
import json
import math
import subprocess
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

E, NU = 210000.0, 0.3
PLATE_SY, PLATE_SIGMA = 100.0, 50.0  # net-section limit LF (50-10)/50*100/50 = 1.6
PLATE_BIG = (54, 26, 14)  # n_circ, n_rad, n_thick -> 502,599 dof
PLATE_SMALL = (10, 8, 1)
NE_BIG = 117_936  # tet10 elements of PLATE_BIG
NDOF_BIG = 502_599
TOL_F32, TOL_F64 = 1e-5, 1e-12  # K0 vs plain: max |diff| / max |plain|
# K0p: max |diff| / max |plain| on standard normal data; Kbw: relative
# difference of the chunk sum on uniform [0, 1) data (no cancellation)
TOL_K0P, TOL_KBW = 1e-5, 1e-5
LBD_RTOL = 1e-9  # GPU vs CPU float64 load-factor histories
# GPU vs CPU float64 through the CLI (phase 10b): it runs the default solver,
# whose CG stops at a relative residual of 1e-6 (FcvmConfig.cg_rtol) with
# deflation on, so the rounding of the two devices' reductions is carried
# through every solve (measured 3e-12 to 3e-10 in lbd and up to 8.3e-10 in
# the .vtk fields between runs of one tree); the bar is the solver's
# tolerance, and phase 4 keeps LBD_RTOL at cg_rtol 1e-10
CLI_RTOL = 1e-6
# the default solver tiers off: Ritz deflation and the float32 precision tiers
TIERS_OFF = dict(deflation=False, residual_refinement=False, precision_failover=False)
# the beam-column of examples/imperfect_column_collapse.toml: 20 x 2 x 2, end
# traction 200, sigma_y 240 (squash factor 1.2), Et/E 0.1, max_imp 0.05,
# modes blended 1.0 / 0.3; its 10 x 3 x 3 mesh refined to 120 x 12 x 12
COL_BIG = (120, 12, 12)  # -> 150,625 nodes, 451,875 dof
NE_COL = 103_680  # tet10 elements of COL_BIG
COL_L, COL_W, COL_T, COL_SY = 20.0, 2.0, 200.0, 240.0
# clamped-free Euler factor pi^2 E I / (4 L^2) / P, I = w^4 / 12, P = t w^2
EULER_COL = math.pi**2 * E * COL_W**4 / 12 / (4 * COL_L**2) / (COL_T * COL_W**2)
COL_NSTEP = 5  # the example's 60 steps cut to 5 (increments of 0.2 in lbd)
EIG_RTOL = 1e-10  # GPU vs CPU float64 buckling factors
# published H100 SXM peaks (NVIDIA data sheet): HBM3 rate, and the float32 /
# float64 rates outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def bound(nbytes, flops, dtype):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` and do ``flops`` of ``dtype`` arithmetic."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def plate_params(nstep, gnl=False):
    from fcvm_tpu_torch import ControlParams

    return ControlParams(sig_yield=PLATE_SY, nstep=nstep, iterat_max=20,
                         error_max=5e-4, et_e=0.0, target_lf=1.62,
                         ultimate_strain=0.25, gnl="GNLY" if gnl else "GNLN", max_imp=0.0)


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


# the kernels of the solver's paths: K1 and K4 in every CG iteration (the
# vector paths), K0m in the block products (the eigensolve, the deflation
# builds), K0 in none since K1 carries K_hat·v
CG_KERNELS = ("khat_matvec", "two_level_apply")
PATH_KERNELS = (*CG_KERNELS, "block_matmat", "block_matvec")


def reset_launches():
    """Set the launch counts of every path kernel to 0."""
    from fcvm_tpu_torch.ops import kernels

    for name in PATH_KERNELS:
        fn = getattr(kernels, name)
        fn.launches = 0
        getattr(fn, "shapes" if name == "block_matmat" else "dtypes").clear()


def read_launches():
    """``({kernel: launches}, {kernel: {dtype: launches}})`` of the path
    kernels; K0m's by dtype and column count."""
    from fcvm_tpu_torch.ops import kernels

    counts = {name: getattr(kernels, name).launches for name in PATH_KERNELS}
    by = {name: dict(getattr(kernels, name).dtypes) for name in PATH_KERNELS
          if name != "block_matmat"}
    by["block_matmat"] = {f"{dt} m={m}": n
                          for (dt, m), n in sorted(kernels.block_matmat.shapes.items())}
    return counts, by


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
    fm = space.fixmask_m
    ue_t = u[eldofs_t]
    fe = kernels.block_matvec(esm_t, ue_t).reshape(-1)
    zc = torch.ones(pc.coarse_inv.shape[0], dtype=u.dtype, device=u.device)
    pc_args = (pc.pinv, pc.qmat, pc.coarse_inv, pc.fixmask, u)
    rows = [
        ("K_hat.v (K1)", cuda_ms(khat, u)),
        ("  K1, raw K.v", cuda_ms(kernels.khat_matvec, esm_t, space.incidence, u)),
        ("K_hat.v by the chain K1 replaced (gather, K0, index_add_, masks)",
         cuda_ms(k0_chain, esm_t, eldofs_t, u, fm)),
        ("  gather (30, ne)", cuda_ms(lambda: u[eldofs_t])),
        ("  K0", cuda_ms(kernels.block_matvec, esm_t, ue_t)),
        ("  index_add_", cuda_ms(
            lambda: torch.zeros_like(u).index_add_(0, eldofs_t.reshape(-1), fe))),
        ("preconditioner apply (K4)", cuda_ms(pc.apply, u)),
        ("  K4 alone", cuda_ms(kernels.two_level_apply, *pc_args)),
        ("preconditioner apply by the code K4 replaced (its plain version)",
         cuda_ms(kernels.two_level_apply_ref, *pc_args)),
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


def refresh_breakdown(model, cfg, res):
    """Print the CUDA-event time of each piece of one GNL tangent refresh on
    the end state of a GNL run ``res`` (its total displacement and
    stresses; the plastic points are those on the yield surface): tangent
    formation, follower loads, operator build, block-Jacobi rebuild, the
    predictor solve cold and warm-started from the predictor of a nearby
    state (5% less displacement, standing for the previous Newton
    iteration's), and one residual with and without GNL."""
    from fcvm_tpu_torch.ops import assembly as asm
    from fcvm_tpu_torch.ops import material as mat
    from fcvm_tpu_torch.ops.precond import refresh_blocks
    from fcvm_tpu_torch.runtime import system as sysm
    from fcvm_tpu_torch.runtime.backend import TorchSystem
    from fcvm_tpu_torch.utils.indexing import pad_vector

    backend = TorchSystem(model, cfg, cfg.resolve_dtype(), cfg.resolve_device())
    coords = backend.tensor(model.mesh.coords)
    esm, pinv, glv, *_ = backend.assemble(coords)
    pc = backend.make_pc(esm, pinv)
    del esm, pinv
    space = backend.space
    disp = backend.tensor(pad_vector(res.disp_total, backend.ndof_pad))
    sig = backend.tensor(res.sig_gp)
    sig_yield = backend.tensor(res.sig_yield_gp)
    pgp = mat.von_mises(sig)[2] >= (1.0 - 1e-4) * sig_yield
    print(f"plastic end state: lbd {res.history.lbd[-1]:.6f}, {int(pgp.sum())} of "
          f"{pgp.numel()} Gauss points plastic")
    check(bool(pgp.any()), "phase 8b: no plastic Gauss point in the end state")
    et_e = 0.0
    eperm = space.eperm
    coords_def = coords + disp.reshape(-1, 3)[: coords.shape[0]]

    def form():
        return asm.tangent_stiffness_blocks(
            coords_def, backend.elnodes[eperm], backend.dmat, sig[eperm], pgp[eperm],
            backend.g, mat.hardening_modulus(backend.e, et_e))

    esm_m = form()
    rows = [
        ("tangent formation (ne, 30, 30), solve-space element order [median of 5]",
         cuda_ms(form, runs=5)),
        ("follower loads (pressure and gravity on the deformed geometry)",
         cuda_ms(lambda: sysm.external_loads(coords, disp, backend.elnodes, backend.loads,
                                             backend.density, follower=True))),
        ("operator build (blocks to element-major (30, 30, ne))",
         cuda_ms(lambda: sysm.make_operator(esm_m, space))),
        ("block-Jacobi rebuild", cuda_ms(
            lambda: refresh_blocks(pc, esm_m, space.elnodes_m, space.fixmask_m))),
    ]
    del esm_m
    rows.append(("whole refresh without the predictor solve [median of 5]", cuda_ms(
        lambda: backend.tangent_refresh(coords, sig, pgp, disp, pc, et_e,
                                        solve_predictor=False), runs=5)))
    prev = backend.tangent_refresh(coords, sig, pgp, 0.95 * disp, pc, et_e)[3]
    khat, pc_t, _, rhs, _ = backend.tangent_refresh(coords, sig, pgp, disp, pc, et_e,
                                                     solve_predictor=False)
    for name, x0 in (("cold", None), ("warm", prev)):
        iters = backend.solve(khat, pc_t, rhs, x0=x0).iters
        rows.append((f"predictor solve, {name}: {iters} CG iterations [median of 3]",
                     cuda_ms(lambda: backend.solve(khat, pc_t, rhs, x0=x0), runs=3)))
    del khat, pc_t, prev
    qnorm = max(float(torch.linalg.vector_norm(glv)), 1.0)
    du = 0.02 * disp
    for name, large_disp in (("small strain", False), ("GNL", True)):
        rows.append((f"residual, {name}", cuda_ms(
            lambda: backend.residual(coords, sig_yield, disp, du, sig, glv, 1.0, qnorm, et_e,
                                     large_disp))))
    print("CUDA-event times, median of 20 runs unless marked:")
    for name, ms in rows:
        print(f"{name}: {ms:.4f} ms")
    torch.cuda.empty_cache()


def probe_phase():
    """K0p and Kbw against their plain versions on seeded data, then the
    bandwidth probe at its full sizes with the launch counts set to 0 just
    before it; returns the kernels' JSON rows and K0's launches in the
    probe (its path)."""
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
    esm = esm_t.permute(2, 0, 1).contiguous()  # (ne, 30, 30), bmm's layout
    k0p_bmm_ms = cuda_ms(torch.bmm, esm, ue_t.T.contiguous()[:, :, None])
    del esm_t, esm, ue_t, out, ref
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
    kernels.block_matvec.launches = 0
    res = bw_probe.run(seed=0, report=lambda line: print(line, flush=True))
    launches = {"soa_matvec": kernels.soa_matvec.launches, "bw_read": kernels.bw_read.launches,
                "block_matvec": kernels.block_matvec.launches}
    print(f"launches in the probe run: {launches}")
    check(launches["soa_matvec"] > 0, "K0p was not launched by the probe")
    check(launches["block_matvec"] > 0, "K0 was not launched by the probe")
    k0p = res["K0p soa_matvec"]
    rows = [{
        "name": "soa_matvec", "route": "cuda", "source": "fcvm_tpu_torch/csrc/bw_probe.cu",
        "replaces": "tools/bw_probe.py:106", "launches": launches["soa_matvec"],
        "max_abs_err": k0p_err, "ms": k0p["ms"],
        "plain_ms": res["plain einsum (soa_matvec_ref)"]["ms"],
        **dict(zip(("bound_ms", "bound_by"),
                   bound(960 * bw_probe.NE * 4, 1800 * bw_probe.NE, torch.float32))),
        "library_ms": k0p_bmm_ms,
    }]
    full_read_ms = res["plain full read x.sum()"]["ms"]
    kbw_bound = bound(bw_probe.ROWS * 128 * 4, bw_probe.ROWS * 128, torch.float32)
    for k in bw_probe.KS:
        kbw = res[f"Kbw bw_read k={k}"]
        check(kbw["launches"] > 0, f"Kbw (k={k}) was not launched by the probe")
        rows.append({
            "name": "bw_read", "k": k, "route": "cuda",
            "source": "fcvm_tpu_torch/csrc/bw_probe.cu", "replaces": "tools/bw_probe.py:137",
            "launches": kbw["launches"], "max_abs_err": kbw_err[k], "ms": kbw["ms"],
            "plain_ms": res["plain bw_read_ref"]["ms"],
            "bound_ms": kbw_bound[0], "bound_by": kbw_bound[1],
            "library_ms": full_read_ms, "full_read_share": kbw["ms"] / full_read_ms,
        })
    torch.cuda.empty_cache()
    return rows, launches["block_matvec"]


def run_plate(big, cfg, label, gnl=False, required=CG_KERNELS):
    """Drive ``solve_collapse`` on the full-size plate with ``cfg`` (with
    geometric nonlinearity when ``gnl``) with the launch counts set to 0
    just before it, print every step, apply the slice's checks (the kernels
    ``required`` launched), and return the numbers and the results."""
    from fcvm_tpu_torch import solve_collapse
    from fcvm_tpu_torch.utils.indexing import pad_ndof

    lines, stamps = [], [time.perf_counter()]

    def monitor(disp_nodes, history):
        stamps.append(time.perf_counter())

    def continuation(history, info):
        # at least three plastic steps: add nstep more once if needed
        plastic = sum(p > 0.0 for p in history.peeqmax)
        return "add" if plastic < 3 and len(history.lbd) <= 5 else "stop"

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    stamps[0] = time.perf_counter()
    res = solve_collapse(big, plate_params(4, gnl), continuation=continuation,
                         progress=lines.append, monitor=monitor, config=cfg)
    torch.cuda.synchronize()
    launches, by_dtype = read_launches()
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
        pred = f", predictor CG per refresh {s['predictor']}" if gnl else ""
        print(f"step {k}: lbd {h.lbd[k + 1]:.6f}, Newton {s['newton']}, restarts "
              f"{s['restarts']}, CG per solve {s['cg']}{pred}, "
              f"{stamps[k + 1] - stamps[k]:.2f} s, peeq max {h.peeqmax[k + 1]:.3e}")
    print(f"total {wall:.2f} s (stepping {t['stepping']:.2f} s), {res.cg_stats['solves']} "
          f"solves, {res.cg_stats['iters']} CG iterations ({step_iters} in {step_solves} "
          f"stepping solves), {1e3 * res.cg_stats['time'] / max(res.cg_stats['iters'], 1):.3f} "
          f"ms per CG iteration incl. stress updates, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches} "
          f"{by_dtype}")
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
    check(all(launches[k] > 0 for k in required),
          f"{label}: {required} not all launched on the main path")
    return dict(lines=lines, cg_stats=res.cg_stats, res=res,
                stepping=t["stepping"], step_iters=step_iters, step_solves=step_solves,
                launches=launches, by_dtype=by_dtype, lbd=lbd)


def column_model(size, width, traction, length=COL_L):
    """A clamped-free column along x, ``width`` x ``width`` section, under
    an end traction (per unit area) along -x."""
    from fcvm_tpu_torch.models import meshgen
    from fcvm_tpu_torch.models.spec import BoundaryConditions, Loads, Material, Model

    nx, ny, nz = size
    mesh = meshgen.box_tet10(nx, ny, nz, length, width, width)
    bcs = BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, 0.0, 0.0))])
    end = mesh.faces_on(lambda x, y, z: x > length - 1e-9)
    loads = Loads(traction_faces=end, tractions=np.tile([-traction, 0.0, 0.0], (len(end), 1)))
    return Model(mesh, Material(E, NU), bcs, loads, name="column")


def column_params(nstep):
    """The control block of ``examples/imperfect_column_collapse.toml``."""
    from fcvm_tpu_torch import ControlParams

    return ControlParams(gnl="GNLY", sig_yield=COL_SY, nstep=nstep, error_max=1e-5,
                         et_e=0.1, target_lf=99.0, max_imp=0.05, ev1=1.0, ev2=0.3)


K0_SHAPES = (NE_BIG, NE_COL)  # element counts at which the paths launch K0


def k0_phase():
    """K0 against its plain version and ``torch.bmm`` at every ``K0_SHAPES``
    entry, float32 and float64 (the float64 tiers launch it in float64);
    CUDA-event medians.  Returns ``{(dtype, ne): numbers}``."""
    from fcvm_tpu_torch.ops import kernels

    rng = np.random.default_rng(0)
    rows = {}
    for dtype, tol in ((torch.float32, TOL_F32), (torch.float64, TOL_F64)):
        for ne in K0_SHAPES:
            esm_t = torch.as_tensor(rng.standard_normal((30, 30, ne)), device="cuda").to(dtype)
            ue_t = torch.as_tensor(rng.standard_normal((30, ne)), device="cuda").to(dtype)
            out = kernels.block_matvec(esm_t, ue_t)
            torch.cuda.synchronize()
            ref = kernels.block_matvec_ref(esm_t, ue_t)
            abs_err = float((out - ref).abs().max())
            rel_err = abs_err / float(ref.abs().max())
            ms = cuda_ms(kernels.block_matvec, esm_t, ue_t)
            plain_ms = cuda_ms(kernels.block_matvec_ref, esm_t, ue_t)
            gbs = esm_t.numel() * esm_t.element_size() / ms / 1e6
            esm = esm_t.permute(2, 0, 1).contiguous()  # (ne, 30, 30), bmm's layout
            bmm_ms = cuda_ms(torch.bmm, esm, ue_t.T.contiguous()[:, :, None])
            bound_ms, bound_by = bound(960 * ne * esm_t.element_size(), 1800 * ne, dtype)
            print(f"K0 {dtype} ne={ne}: max rel err {rel_err:.3e} (limit {tol:g}), kernel "
                  f"{ms:.4f} ms ({gbs:.0f} GB/s esm read), plain {plain_ms:.4f} ms, bmm "
                  f"{bmm_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} "
                  "of it; median of 20")
            check(rel_err <= tol, f"K0 disagrees with its plain version ({dtype}, ne={ne})")
            rows[(dtype, ne)] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                                     bound_ms=bound_ms, bound_by=bound_by, library_ms=bmm_ms)
            del esm_t, esm, ue_t, out, ref
    torch.cuda.empty_cache()
    return rows


K0M_SHAPES = (  # (ne, m) at which the paths launch K0m
    # the beam-column's eigensolve: its block of 8 and every width of a
    # sweep's tail (pcg_block runs only the columns still iterating; the
    # recycled inverse's first solve has 7); the eigensolve's deflation k = 64
    *((NE_COL, m) for m in (1, 2, 3, 4, 5, 6, 7, 8, 32, 64)),
    (NE_BIG, 32),  # the plate's deflation builds, k = 32
)


def k0m_phase():
    """K0m against its plain version and ``torch.bmm`` at every ``K0M_SHAPES``
    entry, float32 and float64; CUDA-event medians of the kernel, the plain
    version, ``bmm`` and m launches of K0.  Returns ``{(dtype, ne, m):
    numbers}``."""
    from fcvm_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    groups = [(dtype, tol, ne) for dtype, tol in ((torch.float32, TOL_F32),
                                                  (torch.float64, TOL_F64))
              for ne in sorted({ne for ne, _ in K0M_SHAPES})]
    for dtype, tol, ne in groups:
        esm_t = torch.randn((30, 30, ne), generator=gen, device="cuda", dtype=dtype)
        esm = esm_t.permute(2, 0, 1).contiguous()  # (ne, 30, 30), bmm's layout
        for m in [m for n, m in K0M_SHAPES if n == ne]:
            ue = torch.randn((ne, 30, m), generator=gen, device="cuda", dtype=dtype)
            out = kernels.block_matmat(esm_t, ue)
            torch.cuda.synchronize()
            ref = kernels.block_matmat_ref(esm_t, ue)
            scale = float(ref.abs().max())
            abs_err = float((out - ref).abs().max())
            rel, rel_bmm = abs_err / scale, float((out - torch.bmm(esm, ue)).abs().max()) / scale
            del out, ref
            cols = [ue[:, :, c].T.contiguous() for c in range(m)]
            ms = cuda_ms(kernels.block_matmat, esm_t, ue)
            plain_ms = cuda_ms(kernels.block_matmat_ref, esm_t, ue)
            bmm_ms = cuda_ms(torch.bmm, esm, ue)
            k0_ms = cuda_ms(lambda: [kernels.block_matvec(esm_t, u) for u in cols])
            bound_ms, bound_by = bound((900 + 60 * m) * ne * esm_t.element_size(),
                                       2 * 900 * m * ne, dtype)
            print(f"K0m {dtype} ne={ne} m={m}: max rel err {rel:.3e} vs plain, {rel_bmm:.3e} "
                  f"vs bmm (limit {tol:g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bmm "
                  f"{bmm_ms:.4f} ms, {m} x K0 {k0_ms:.4f} ms; bound {bound_ms:.4f} ms "
                  f"({bound_by}), {bound_ms / ms:.1%} of it; median of 20")
            check(rel <= tol and rel_bmm <= tol, f"K0m disagrees with its plain version "
                  f"({dtype}, ne={ne}, m={m})")
            rows[(dtype, ne, m)] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                                        library_ms=bmm_ms, k0_ms=k0_ms, bound_ms=bound_ms,
                                        bound_by=bound_by)
            del ue, cols
        del esm_t, esm
    torch.cuda.empty_cache()
    return rows


def k0_chain(esm_t, eldofs_t, u, fm=None):
    """The K_hat·v (``fm`` given) or K·v the solver ran before K1: the
    per-dof gather, K0, ``index_add_`` and the masks."""
    from fcvm_tpu_torch.ops import kernels

    v = u if fm is None else fm * u
    out = torch.zeros_like(u).index_add_(0, eldofs_t.reshape(-1),
                                         kernels.block_matvec(esm_t, v[eldofs_t]).reshape(-1))
    return out if fm is None else fm * out + (1.0 - fm) * u


def assembled_khat(esm_t, eldofs, fm):
    """K_hat = P K P + (I - P) of the element-major blocks as a sparse CSR
    matrix (``torch.sparse``, duplicates summed), for cuSPARSE's matvec."""
    ne, n = esm_t.shape[2], fm.numel()
    rows = eldofs[:, :, None].expand(ne, 30, 30).reshape(-1)
    cols = eldofs[:, None, :].expand(ne, 30, 30).reshape(-1)
    vals = esm_t.permute(2, 0, 1).reshape(-1) * fm[rows] * fm[cols]
    diag = torch.arange(n, device=fm.device)
    idx = torch.stack([torch.cat([rows, diag]), torch.cat([cols, diag])])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the beta-state notices of sparse CSR
        return torch.sparse_coo_tensor(idx, torch.cat([vals, 1.0 - fm]),
                                       (n, n)).coalesce().to_sparse_csr()


def cg_kernel_phase(models):
    """Phase 3c: K1 (masked and raw) on the operators of ``models`` (name ->
    model: the plate and the beam-column) and K4 (block Jacobi and the
    cluster smoother's output) on the plate's preconditioner, float32 and
    float64, against their plain versions on a seeded vector (K1 also bit
    for bit against a second call); CUDA-event medians of each, of its
    plain version, of the chain K1 replaced and of cuSPARSE's CSR matvec of
    the assembled K_hat.  Returns ``{(kernel, dtype, model, variant):
    numbers}``."""
    from fcvm_tpu_torch import FcvmConfig
    from fcvm_tpu_torch.ops import kernels
    from fcvm_tpu_torch.runtime.backend import TorchSystem

    rows = {}
    for dtype, tol in ((torch.float32, TOL_F32), (torch.float64, TOL_F64)):
        dname, size = str(dtype).removeprefix("torch."), torch.finfo(dtype).bits // 8
        for name, model in models.items():
            cfg = FcvmConfig(device="cuda", dtype=dname)
            be = TorchSystem(model, cfg, dtype, torch.device("cuda"))
            esm, pinv, *_ = be.assemble(be.tensor(model.mesh.coords))
            sp = be.space
            esm_t = be.operator(esm).esm_t
            ne, nn = esm_t.shape[2], be.ndof_pad // 3
            gen = torch.Generator(device="cuda").manual_seed(7)
            u = torch.randn(be.ndof_pad, generator=gen, device="cuda", dtype=dtype)
            eldofs_t = sp.eldofs_m.T.contiguous()
            kcsr = assembled_khat(esm_t, sp.eldofs_m, sp.fixmask_m)
            for form in ("masked", "raw"):
                fm = sp.fixmask_m if form == "masked" else None
                out = kernels.khat_matvec(esm_t, sp.incidence, u, fm)
                again = kernels.khat_matvec(esm_t, sp.incidence, u, fm)
                torch.cuda.synchronize()
                ref = kernels.khat_matvec_ref(esm_t, sp.incidence, u, fm)
                abs_err = float((out - ref).abs().max())
                rel = abs_err / float(ref.abs().max())
                same = bool(torch.equal(out, again))
                row = dict(max_abs_err=abs_err, ms=cuda_ms(kernels.khat_matvec, esm_t,
                                                             sp.incidence, u, fm),
                           plain_ms=cuda_ms(kernels.khat_matvec_ref, esm_t, sp.incidence, u, fm),
                           chain_ms=cuda_ms(k0_chain, esm_t, eldofs_t, u, fm), library_ms=None)
                # the blocks, the node table and pos, offsets, u (and the
                # mask) read once, the result written once
                nvec = 2 if fm is None else 3
                nbytes = (900 * size + 80) * ne + 4 * (nn + 1) + nvec * 3 * nn * size
                row["bound_ms"], row["bound_by"] = bound(nbytes, 1830 * ne, dtype)
                lib = ""
                if fm is not None:
                    row["library_ms"] = cuda_ms(torch.mv, kcsr, u)
                    lib_err = float((torch.mv(kcsr, u) - ref).abs().max()) / float(ref.abs().max())
                    lib = (f", cuSPARSE CSR matvec ({kcsr.values().numel()} stored values) "
                           f"{row['library_ms']:.4f} ms (its max rel err {lib_err:.2e})")
                print(f"K1 {dname} {name} ne={ne} {form}: max rel err {rel:.3e} (limit {tol:g}), "
                      f"second call {'the same bits' if same else 'DIFFERENT BITS'}; kernel "
                      f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, the chain it "
                      f"replaced (gather, K0, index_add_, masks) {row['chain_ms']:.4f} ms{lib}; "
                      f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                      f"{row['bound_ms'] / row['ms']:.1%} of it; median of 20")
                check(rel <= tol, f"K1 disagrees with its plain version ({dname}, {name}, {form})")
                check(same, f"K1 gave other bits on a second call ({dname}, {name}, {form})")
                rows[("khat_matvec", dname, name, form)] = dict(ne=ne, **row)
                del out, again, ref
            del kcsr, u, eldofs_t
            if name != "plate":
                del be, esm, pinv, esm_t
                torch.cuda.empty_cache()
                continue
            r = torch.randn(be.ndof_pad, generator=gen, device="cuda", dtype=dtype)
            for fine in ("jacobi3", "cluster"):
                be.cfg = FcvmConfig(device="cuda", dtype=dname, smoother=fine)
                pc = be.make_pc(esm, pinv)
                check((pc.smooth_inv is not None) == (fine == "cluster"),
                      f"phase 3c: the {fine} preconditioner was not built")
                z_fine = None if fine == "jacobi3" else pc.fine(r)
                args = (pc.pinv, pc.qmat, pc.coarse_inv, pc.fixmask, r, z_fine)
                out = kernels.two_level_apply(*args)
                again = kernels.two_level_apply(*args)
                torch.cuda.synchronize()
                ref = kernels.two_level_apply_ref(*args)
                abs_err = float((out - ref).abs().max())
                rel = abs_err / float(ref.abs().max())
                same = bool(torch.equal(out, again))
                nm, nn_cl, ncf = pc.qmat.shape[2], pc.qmat.shape[0], pc.coarse_inv.shape[0]
                nbytes = (3 * nm * nn_cl + ncf * ncf + (9 if z_fine is None else 3) * nn
                          + 9 * nn) * size
                row = dict(max_abs_err=abs_err, ms=cuda_ms(kernels.two_level_apply, *args),
                           plain_ms=cuda_ms(kernels.two_level_apply_ref, *args),
                           apply_ms=cuda_ms(pc.apply, r), library_ms=None,
                           gemv_ms=cuda_ms(torch.mv, pc.coarse_inv, r[:ncf].contiguous()))
                row["bound_ms"], row["bound_by"] = bound(
                    nbytes, 2 * ncf * ncf + 12 * nm * nn + 18 * nn, dtype)
                print(f"K4 {dname} {name} {fine}: coarse {ncf} = {nm} x {ncf // nm} clusters of "
                      f"{nn_cl // (ncf // nm)} nodes; max rel err {rel:.3e} (limit {tol:g}), "
                      f"second call {'the same bits' if same else 'other bits'}; kernel "
                      f"{row['ms']:.4f} ms (its coarse GEMV alone {row['gemv_ms']:.4f} ms), "
                      f"plain {row['plain_ms']:.4f} ms, the whole apply (with the fine level) "
                      f"{row['apply_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms "
                      f"({row['bound_by']}), {row['bound_ms'] / row['ms']:.1%} of it; median "
                      "of 20")
                check(rel <= tol, f"K4 disagrees with its plain version ({dname}, {fine})")
                rows[("two_level_apply", dname, name, fine)] = dict(nn=nn, **row)
                del pc, out, again, ref, args, z_fine
            del be, esm, pinv, esm_t, r
            torch.cuda.empty_cache()
    return rows


def run_column(cfg, nstep=COL_NSTEP, label="phase 9", required=(*CG_KERNELS, "block_matmat")):
    """Drive ``solve_collapse`` on the imperfect beam-column at 451,875 dof
    (buckling, seeding, ``nstep`` GNL steps) with the launch counts set to
    0 just before it; print the eigensolve and the steps, apply the checks
    (the kernels ``required`` launched) and return the launch counts."""
    from fcvm_tpu_torch import solve_collapse
    from fcvm_tpu_torch.ops.solver import ScipyDirectSolver

    t0 = time.perf_counter()
    col = column_model(COL_BIG, COL_W, COL_T)
    print(f"{col.mesh.n_nodes} nodes, {col.mesh.n_elements} elements, {col.mesh.ndof} dof "
          f"(mesh built in {time.perf_counter() - t0:.1f} s); Euler factor {EULER_COL:.4f}, "
          f"squash factor {COL_SY / COL_T:.2f}")
    check(col.mesh.ndof == 451_875 and col.mesh.n_elements == NE_COL, "unexpected column mesh")
    lines, stamps = [], [0.0]

    def monitor(disp_nodes, history):
        stamps.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    direct0 = (ScipyDirectSolver.factorizations, ScipyDirectSolver.solves)
    reset_launches()
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        stamps[0] = time.perf_counter()
        res = solve_collapse(col, column_params(nstep), progress=lines.append,
                             monitor=monitor, config=cfg)
        torch.cuda.synchronize()
    launches, by_dtype = read_launches()
    wall = time.perf_counter() - stamps[0]
    direct = (ScipyDirectSolver.factorizations - direct0[0], ScipyDirectSolver.solves - direct0[1])
    for w in warned:
        print(f"warning: {str(w.message)[:200]}")
    t, cs = res.timers, res.cg_stats
    tiers = cs["buckling"]
    for r in tiers:
        per_sweep = [sum(it) for it in r["inner_iters"]]
        print(f"eigensolve tier {r['dtype']} / {r['solver']}: {r['sweeps']} sweeps, harvest "
              f"{r['harvest']}, pencil residuals {r['pencil_residuals']}, "
              f"{'broke down: ' + r['error'][:160] if r['error'] else 'served'}")
        print(f"  inner CG iterations per sweep (all columns): {per_sweep}; per column, "
              f"first and last sweep: {r['inner_iters'][:1]} ... {r['inner_iters'][-1:]}")
    served = [r for r in tiers if r["error"] is None]
    lam = np.asarray(res.eigenvalues)
    print(f"buckling factors {lam.tolist()} ({(lam / EULER_COL - 1).tolist()} off Euler), "
          f"served by tier {[(r['dtype'], r['solver']) for r in served]}; eigensolve "
          f"{t['buckling']:.2f} s wall")
    h = res.history
    dc = float(np.abs(res.coords - res.coords_old).max())
    print(f"imperfection: max |coords - coords_old| = {dc:.9f} (max_imp 0.05)")
    for k, s in enumerate(cs["steps"]):
        print(f"step {k}: lbd {h.lbd[k + 1]:.6f}, Newton {s['newton']}, restarts "
              f"{s['restarts']}, CG per solve {s['cg']}, predictor CG {s['predictor']}, "
              f"{stamps[k + 1] - stamps[k]:.2f} s, peeq max {h.peeqmax[k + 1]:.3e}")
    print(f"total {wall:.2f} s: assemble {t['assemble']:.2f} s, precond build "
          f"{t['precond_build']:.2f} s, elastic solves {t['elastic_solve']:.2f} s, buckling "
          f"{t['buckling']:.2f} s, stepping {t['stepping']:.2f} s; Newton iterations per step "
          f"{[s['newton'] for s in cs['steps']]}; launches {launches}; ScipyDirectSolver "
          f"factorisations {direct[0]}, column solves {direct[1]}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    lbd = np.asarray(h.lbd)
    check(len(served) == 1 and lam.shape == (2,) and bool(np.all(np.isfinite(lam))),
          f"{label}: the eigensolve served no tier")
    check(bool(np.all(np.abs(lam / EULER_COL - 1) <= 0.03)),
          f"{label}: factors {lam} not within 3% of {EULER_COL:.4f}")
    check(abs(dc / 0.05 - 1) <= 1e-6, f"{label}: imperfection {dc} is not max_imp 0.05")
    check(not any("MAXIMUM RESTARTS" in ln for ln in lines), f"{label}: a step did not converge")
    check(len(cs["steps"]) == len(lbd) - 1 == nstep, f"{label}: not every step recorded")
    check(bool(np.all(np.isfinite(lbd))) and lbd.max() < COL_SY / COL_T,
          f"{label}: load factors {lbd} not finite or not below the squash factor")
    check(bool(np.isfinite(res.sig_gp).all()), f"{label}: stresses are not finite")
    check(all(launches[k] > 0 for k in required),
          f"{label}: {required} not all launched on the path")
    print(f"launches by dtype (K0m by dtype and m) {by_dtype}")
    return dict(launches=launches, by_dtype=by_dtype, buckling=t["buckling"],
                stepping=t["stepping"], wall=wall, factors=lam.tolist())


def column_breakdown(cfg):
    """Print the CUDA-event time of each piece of the eigensolve on the
    beam-column at 451,875 dof: geometric-block formation, K_hat·V and
    -G_hat·V at m = 8, the block preconditioner apply against 8 vector
    applies, and one pcg_block iteration against one pcg iteration (wall
    time per iteration over 20 iterations, host syncs included)."""
    from fcvm_tpu_torch.ops import assembly as asm
    from fcvm_tpu_torch.ops import solver as slv
    from fcvm_tpu_torch.runtime.backend import TorchSystem

    col = column_model(COL_BIG, COL_W, COL_T)
    backend = TorchSystem(col, cfg, cfg.resolve_dtype(), cfg.resolve_device())
    coords = backend.tensor(col.mesh.coords)
    esm, pinv, _, rhs, *_ = backend.assemble(coords)
    khat = backend.operator(esm)
    pc = backend.make_pc(esm, pinv)
    del esm, pinv
    ue = backend.solve(khat, pc, rhs, x0=backend.u_fix).x
    sig, *_ = backend.stress_update(coords, backend.gauss_full(1.0e30), torch.zeros_like(ue),
                                    ue, backend.gauss_zeros((6,)), 0.0)
    sp = backend.space

    def form():
        return asm.geometric_stiffness_blocks(coords, backend.elnodes, sig)

    nsm_t = form()[sp.eperm].permute(1, 2, 0).contiguous()
    kmv = asm.make_multi_matvec(khat.esm_t, sp.eldofs_m, sp.fixmask_m)
    minus_g = asm.make_multi_matvec(nsm_t, sp.eldofs_m, sp.fixmask_m, identity_on_fixed=False,
                                    negate=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    v = sp.fixmask_m[:, None] * torch.randn((backend.ndof_pad, 8), generator=gen,
                                            device="cuda", dtype=ue.dtype)
    cols = [v[:, c].contiguous() for c in range(8)]
    rows = [
        ("geometric-block formation (ne, 30, 30) [median of 5]", cuda_ms(form, runs=5)),
        ("K_hat.V, m = 8", cuda_ms(kmv, v)),
        ("-G_hat.V, m = 8", cuda_ms(minus_g, v)),
        ("K_hat.v, one column", cuda_ms(khat, cols[0])),
        ("preconditioner apply, block m = 8", cuda_ms(pc.apply, v)),
        ("preconditioner apply, 8 vectors", cuda_ms(lambda: [pc.apply(c) for c in cols])),
    ]
    b = minus_g(v)

    def per_iteration(solve):
        walls = []
        for iters in (1, 21):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve(iters)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return 1e3 * (walls[1] - walls[0]) / 20

    def block(iters):
        return slv.pcg_block(kmv, b, precond=pc.apply, rtol=1e-10, maxiter=iters)

    def single(iters):
        return slv.pcg(khat, b[:, 0].contiguous(), precond=pc.apply, rtol=1e-10, maxiter=iters)

    block(1), single(1)
    rows += [("pcg_block iteration, m = 8 (wall)", per_iteration(block)),
             ("pcg iteration, one column (wall)", per_iteration(single))]
    print("CUDA-event times, median of 20 runs unless marked:")
    for name, ms in rows:
        print(f"{name}: {ms:.4f} ms")
    del khat, pc, nsm_t
    torch.cuda.empty_cache()


def case_toml(size, nstep):
    """The plate of ``examples/plate_with_hole.toml`` at ``size`` as a TOML
    case with the control values of ``plate_params(nstep)``, a region
    ``y > 75`` twice as stiff, and the Sum groups of the loaded face (area
    250) and of its edge at z = 0 (length 50)."""
    p = plate_params(nstep)
    nc, nr, nt = size
    return f"""name = "plate"
[mesh.generator]
kind = "plate_with_hole"
radius = 10.0
width = 50.0
height = 100.0
thickness = 5.0
n_circ = {nc}
n_rad = {nr}
n_thick = {nt}
[material]
e = {E}
nu = {NU}
[[material.region]]
where = "y > 75.0"
e = {2 * E}
[control]
sig_yield = {p.sig_yield}
nstep = {p.nstep}
iterat_max = {p.iterat_max}
error_max = {p.error_max}
et_e = {p.et_e}
target_lf = {p.target_lf}
ultimate_strain = {p.ultimate_strain}
[[bc]]
where = "x < 1e-9"
ux = 0.0
[[bc]]
where = "y < 1e-9"
uy = 0.0
[[bc]]
where = "z < 1e-9"
uz = 0.0
[[load.face]]
where = "y > 100.0 - 1e-6"
traction = [0.0, {PLATE_SIGMA}, 0.0]
[[sum.face]]
name = "loaded_face"
where = "y > 100.0 - 1e-6"
[[sum.edge]]
name = "loaded_edge_z0"
where = "(y > 100.0 - 1e-6) & (z < 1e-9)"
"""


def out_rows(path):
    """The history rows of a ``.out`` report, one per recorded step."""
    return [ln for ln in Path(path).read_text().splitlines() if ln.strip()[:1].isdigit()]


def run_cli(args):
    """``python -m fcvm_tpu_torch`` in this process: (exit code, its output)."""
    import contextlib
    import io

    from fcvm_tpu_torch.__main__ import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli([str(a) for a in args])
    return rc, buf.getvalue()


def case_phase(tmp, smi):
    """Phase 10: the case-file path at full width on the card. A TOML case
    of the 502,599-dof plate with a stiffer region goes ``load_case`` ->
    ``run_analysis`` (float32, default configuration) -> ``run_sum``, with
    the launch counts set to 0 just before ``run_analysis``; then the CLI's
    ``info`` and ``sum`` run on the case and the files written. Returns the
    launch counts."""
    from fcvm_tpu_torch import FcvmConfig, native, run_analysis, run_sum
    from fcvm_tpu_torch.models.casefile import load_case, parse_sum_groups
    from fcvm_tpu_torch.ops import postproc
    from fcvm_tpu_torch.runtime import backend as backend_mod
    from fcvm_tpu_torch.runtime.viz import _clip_surface
    from fcvm_tpu_torch.runtime.vtk import _elements_per_node, read_point_fields

    case = tmp / "plate.toml"
    case.write_text(case_toml(PLATE_BIG, 8))
    outdir = tmp / "out"
    t0 = time.perf_counter()
    model, params = load_case(case)
    t_load = time.perf_counter() - t0
    mesh, mbe = model.mesh, model.materials_by_element
    n_stiff = int((mbe[:, 0] == 2 * E).sum()) if mbe is not None else 0
    print(f"load_case: {mesh.n_nodes} nodes, {mesh.n_elements} elements, {mesh.ndof} dof, "
          f"{n_stiff} elements in the region, {t_load:.2f} s; native library "
          f"{'loaded' if native.available() else 'NOT loaded'}")
    check(mesh.ndof == NDOF_BIG and mesh.n_elements == NE_BIG, "phase 10: unexpected mesh size")
    check(0 < n_stiff < NE_BIG, "phase 10: the region selects no element or every one")
    check(native.available(), "phase 10: the native formatter did not load")

    dmat_shapes = []

    class Recording(backend_mod.TorchSystem):
        """The driver's backend, recording the shape of its elasticity."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            dmat_shapes.append(tuple(self.dmat.shape))

    lines = []
    backend = backend_mod.TorchSystem
    backend_mod.TorchSystem = Recording  # what make_backend builds on one device
    reset_launches()
    try:
        res = run_analysis(model, params, outdir=str(outdir), progress=lines.append,
                           save_plots=False, config=FcvmConfig(device="cuda", dtype="float32"))
        torch.cuda.synchronize()
    finally:
        backend_mod.TorchSystem = backend
    launches, by_dtype = read_launches()
    t0 = time.perf_counter()
    sums = run_sum(model, res, params, *parse_sum_groups(case, model.mesh), outdir=str(outdir))
    t_sum = time.perf_counter() - t0

    t, h, cs = res.timers, res.history, res.cg_stats
    print(f"run_analysis timers ({smi}): " + ", ".join(
        f"{k} {t[k]:.3f} s" for k in ("assemble", "precond_build", "elastic_solve", "stepping",
                                      "solve", "report", "vtk")))
    print(f"run_sum {t_sum:.3f} s; {len(h.lbd) - 1} steps, lbd {np.round(h.lbd, 6).tolist()}, "
          f"Newton per step {[s['newton'] for s in cs['steps']]}, {cs['iters']} CG iterations, "
          f"backend elasticity {dmat_shapes}, launches {launches} {by_dtype}")
    for group, measure in (("faces", "area"), ("edges", "length")):
        for name, row in sums[group].items():
            print(f"sum {group} {name}: {measure} {row[measure]:.9f}, peeq {row['peeq']:.4e}, "
                  f"csr {row['csr']:.4e}, svm {row['svm']:.4e}")

    # the host side of the export, each piece timed alone on the same results
    nn = mesh.n_nodes
    t0 = time.perf_counter()
    noce = _elements_per_node(mesh.elnodes, nn)
    t_noce = time.perf_counter() - t0
    t0 = time.perf_counter()
    stress, *_ = postproc.map_stresses(params.averaged_option == "averaged", mesh.elnodes, nn,
                                       res.sig_gp, res.peeq_gp, res.csr_gp, res.svm_gp, noce,
                                       params.sig_yield)
    t_map = time.perf_counter() - t0
    t0 = time.perf_counter()
    postproc.principal_stresses(stress)
    t_prin = time.perf_counter() - t0
    proj = res.coords[:, 0]
    t0 = time.perf_counter()
    clip = _clip_surface(res.coords, mesh.elnodes, np.array([1.0, 0.0, 0.0]),
                         proj.min() + 0.5 * (proj.max() - proj.min()))
    t_clip = time.perf_counter() - t0
    vtk = outdir / "plate.vtk"
    t0 = time.perf_counter()
    fields = read_point_fields(vtk)
    t_read = time.perf_counter() - t0
    edge_groups, face_groups = parse_sum_groups(case, model.mesh)
    nodal = [fields[k] for k in ("Equivalent_Plastic_Strain", "Critical_Strain_Ratio",
                                 "von_Mises_Stress")]
    t0 = time.perf_counter()
    postproc.integrate_faces(list(face_groups.values()), res.coords, *nodal)
    t_faces = time.perf_counter() - t0
    t0 = time.perf_counter()
    postproc.integrate_edges(list(edge_groups.values()), res.coords, *nodal)
    t_edges = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_sum(model, res, params, edge_groups, face_groups)
    t_sum2 = time.perf_counter() - t0
    print(f"host side ({smi}): elements per node {t_noce:.3f} s, map_stresses "
          f"({4 * NE_BIG} Gauss values) {t_map:.3f} s, principal_stresses {t_prin:.3f} s, "
          f"clip surface ({len(clip)} faces) {t_clip:.3f} s, .vtk export {t['vtk']:.3f} s for "
          f"{vtk.stat().st_size / 1e6:.1f} MB, read_point_fields {t_read:.3f} s, "
          f"integrate_faces ({sum(map(len, face_groups.values()))} faces) {t_faces:.3f} s, "
          f"integrate_edges ({sum(map(len, edge_groups.values()))} edges) {t_edges:.3f} s, "
          f"run_sum again {t_sum2:.3f} s")

    rc, out = run_cli(["info", case])
    print("CLI info: " + "; ".join(out.splitlines()[1:3]))
    check(rc == 0 and f"elements: {NE_BIG}" in out, "phase 10: the CLI's info failed")
    avr = outdir / "plate.avr"
    in_run = avr.read_bytes()
    avr.unlink()
    t0 = time.perf_counter()
    rc, out = run_cli(["sum", case, "--outdir", outdir])
    print(f"CLI sum {time.perf_counter() - t0:.3f} s (its load_case and .vtk read included)")
    check(rc == 0 and avr.read_bytes() == in_run,
          "phase 10: the CLI's sum did not rewrite the in-run .avr")

    lbd = np.asarray(h.lbd)
    check((outdir / "plate.out").exists() and vtk.exists(), "phase 10: .out or .vtk missing")
    check(len(out_rows(outdir / "plate.out")) == len(lbd), "phase 10: not one .out row per step")
    check(len(fields) == 12 and all(len(v) == nn for v in fields.values()),
          f"phase 10: the .vtk holds {len(fields)} fields, not 12 at {nn} nodes")
    face, edge = sums["faces"]["loaded_face"], sums["edges"]["loaded_edge_z0"]
    check(abs(face["area"] / 250.0 - 1) <= 1e-6 and abs(edge["length"] / 50.0 - 1) <= 1e-6,
          "phase 10: the Sum groups' area or length is wrong")
    check(not any("MAXIMUM RESTARTS" in ln for ln in lines), "phase 10: a step did not converge")
    check(len(cs["steps"]) == len(lbd) - 1 >= 4, "phase 10: fewer than 4 recorded steps")
    check(bool(np.all(np.isfinite(lbd)) and np.all(np.diff(lbd) >= 0.0)),
          "phase 10: load factors not finite or decreasing")
    check(lbd.max() < 1.76, f"phase 10: peak load factor {lbd.max():.4f} above 1.76")
    check(float(res.peeq_gp.max()) > 0.0, "phase 10: no plastic strain")
    check(bool(dmat_shapes) and all(s == (NE_BIG, 6, 6) for s in dmat_shapes),
          f"phase 10: the backend's elasticity is {dmat_shapes}, not per element")
    check(all(launches[k] > 0 for k in CG_KERNELS), "phase 10: K1 or K4 was not launched")
    return dict(launches=launches)


def cli_phase(tmp):
    """Phase 10b: ``python -m fcvm_tpu_torch run`` on the small plate with
    the region, float64, on the GPU and with ``--cpu``: the load factors
    (read from the last checkpoint) and the ``.vtk`` fields to CLI_RTOL
    (the default solver's tolerance); then the GPU run's checkpoints cut to the first half of its steps
    and ``--resume`` for the rest: the last ``.out`` row equals the
    straight run's."""
    from fcvm_tpu_torch.runtime.checkpoint import latest_step
    from fcvm_tpu_torch.runtime.vtk import read_point_fields

    case = tmp / "small.toml"
    case.write_text(case_toml(PLATE_SMALL, 6))
    lbd, fields = {}, {}
    for dev in ("cuda", "cpu"):
        args = ["run", case, "--x64", "--no-plots", "--checkpoint", "--outdir", tmp / dev]
        before = read_launches()[0]
        t0 = time.perf_counter()
        rc, out = run_cli(args + (["--cpu"] if dev == "cpu" else []))
        launches = {k: n - before[k] for k, n in read_launches()[0].items() if k in CG_KERNELS}
        check(rc == 0 and "MAXIMUM RESTARTS" not in out, f"phase 10b: the {dev} run failed")
        lbd[dev] = latest_step(tmp / dev / "checkpoints")[1]["lbd"]
        fields[dev] = read_point_fields(tmp / dev / "plate.vtk")
        print(f"CLI run --x64{' --cpu' if dev == 'cpu' else ''}: {time.perf_counter() - t0:.2f} s, "
              f"lbd {np.round(lbd[dev], 6).tolist()}, K1 and K4 launches {launches}")
        check(all((n > 0) == (dev == "cuda") for n in launches.values()),
              f"phase 10b: K1 and K4 launches {launches} on {dev}")
    check(len(lbd["cuda"]) == len(lbd["cpu"]) == 7, "phase 10b: step counts differ from 6")
    diff = float(np.max(np.abs(lbd["cuda"] - lbd["cpu"]) / np.maximum(np.abs(lbd["cpu"]), 1e-300)))
    fdiff, fname = max((float(np.abs(fields["cuda"][k] - v).max() / max(np.abs(v).max(), 1.0)), k)
                       for k, v in fields["cpu"].items())
    print(f"max rel lbd difference {diff:.3e}; max .vtk field difference {fdiff:.3e} of the "
          f"field's largest value, in {fname} (limit {CLI_RTOL:g} for both)")
    check(diff <= CLI_RTOL, "phase 10b: GPU and CPU load-factor histories disagree")
    check(list(fields["cuda"]) == list(fields["cpu"]) and fdiff <= CLI_RTOL,
          "phase 10b: GPU and CPU .vtk fields disagree")

    ckdir = tmp / "cuda" / "checkpoints"
    steps = sorted(ckdir.glob("step_*.npz"))
    half = len(steps) // 2
    for f in steps[half:]:  # what a run cut after the first half leaves
        f.unlink()
    t0 = time.perf_counter()
    rc, out = run_cli(["run", case, "--x64", "--no-plots", "--steps", len(steps) - half,
                       "--resume", ckdir, "--outdir", tmp / "resumed"])
    straight, resumed = out_rows(tmp / "cuda" / "plate.out"), out_rows(tmp / "resumed" / "plate.out")
    print(f"CLI run --resume from step {half} of {len(steps)}: {time.perf_counter() - t0:.2f} s; "
          f"last .out row {resumed[-1].split() if resumed else None}")
    check(rc == 0 and f"resuming from checkpoint step {half}" in out,
          "phase 10b: the resumed run did not resume")
    check(len(resumed) == len(straight) and resumed[-1] == straight[-1],
          "phase 10b: the resumed run's last .out row differs from the straight run's")


def smoother_breakdown(model, cfg):
    """Print the cluster smoother's pieces on ``model`` with ``cfg``
    (``smoother="cluster"``): the preconditioner build with and without it
    (wall, synchronised) and the device memory each adds, the smoother's
    accumulate and batched Cholesky inverse alone, and the apply of the
    fine level and of the whole preconditioner against block Jacobi's, in
    the run's dtype and with the inverses in float64; CUDA-event medians
    against the bound of reading the inverses once."""
    import dataclasses

    from fcvm_tpu_torch.ops import assembly as asm
    from fcvm_tpu_torch.ops import precond as pre
    from fcvm_tpu_torch.runtime.backend import TorchSystem

    backend = TorchSystem(model, cfg, cfg.resolve_dtype(), cfg.resolve_device())
    esm, pinv, _, rhs, *_ = backend.assemble(backend.tensor(model.mesh.coords))
    builds = {}
    for name, c in (("jacobi3", dataclasses.replace(cfg, smoother="jacobi3")), ("cluster", cfg)):
        backend.cfg = c
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pc = backend.make_pc(esm, pinv)
        torch.cuda.synchronize()
        builds[name] = (time.perf_counter() - t0, (torch.cuda.memory_allocated() - base) / 2**20,
                        (torch.cuda.max_memory_allocated() - base) / 2**20)
    backend.cfg = cfg
    check(pc.smooth_inv is not None, "phase 11: the cluster smoother was not built")
    sp, cs = backend.space, cfg.smoother_cluster_nodes
    esm_m = esm[sp.eperm]
    del esm, pinv
    ncl, m, _ = pc.smooth_inv.shape
    blocks = pre.cluster_diag_blocks(esm_m, sp.elnodes_m, sp.fixmask_m, cs)
    rows = [
        (f"smoother accumulate ({ncl}, {m}, {m}) by index_add_ [median of 5]",
         cuda_ms(lambda: pre.cluster_diag_blocks(esm_m, sp.elnodes_m, sp.fixmask_m, cs), runs=5)),
        ("smoother batched cholesky_ex + cholesky_inverse [median of 5]",
         cuda_ms(lambda: torch.cholesky_inverse(torch.linalg.cholesky_ex(blocks)[0]), runs=5)),
    ]
    del blocks, esm_m
    u = sp.to_m(rhs)
    jacobi = pc._replace(smooth_inv=None)
    inv64, u64 = pc.smooth_inv.double(), u.double()
    apply = {
        "cluster": cuda_ms(pc.fine, u),
        "jacobi3": cuda_ms(asm.apply_block_precond, pc.pinv, u),
        "cluster64": cuda_ms(lambda: torch.bmm(inv64, u64.view(ncl, m, 1))),
        "whole_cluster": cuda_ms(pc.apply, u),
        "whole_jacobi3": cuda_ms(jacobi.apply, u),
    }
    del inv64, u64
    nbytes = pc.smooth_inv.numel() * pc.smooth_inv.element_size()
    b32 = bound(nbytes + 2 * u.numel() * u.element_size(), 2 * pc.smooth_inv.numel(), u.dtype)
    b64 = bound(2 * nbytes + 2 * u.numel() * 8, 2 * pc.smooth_inv.numel(), torch.float64)
    rows += [
        (f"fine level: cluster smoother bmm ({ncl}, {m}, {m}) x ({ncl}, {m}, 1), masks "
         f"included; bound {b32[0]:.4f} ms ({b32[1]}), {b32[0] / apply['cluster']:.1%} of it",
         apply["cluster"]),
        ("fine level: block Jacobi (3x3 nodal blocks)", apply["jacobi3"]),
        (f"fine level: the bmm in float64; bound {b64[0]:.4f} ms ({b64[1]}), "
         f"{b64[0] / apply['cluster64']:.1%} of it", apply["cluster64"]),
        ("preconditioner apply with the cluster smoother", apply["whole_cluster"]),
        ("preconditioner apply with block Jacobi", apply["whole_jacobi3"]),
    ]
    for name, (wall, resident, peak) in builds.items():
        print(f"preconditioner build, smoother {name}: {wall:.3f} s wall, resident "
              f"{resident:.1f} MiB, peak {peak:.1f} MiB above what was allocated before")
    print(f"smoother inverses: {nbytes / 1e6:.1f} MB ({ncl} clusters of {cs} nodes)")
    print("CUDA-event times, median of 20 runs unless marked:")
    for name, ms in rows:
        print(f"{name}: {ms:.4f} ms")
    del pc, jacobi, backend
    torch.cuda.empty_cache()


def cluster_small_phase():
    """Phase 11c: the small plate in float64 with the cluster smoother on the
    GPU and on the CPU at cg_rtol 1e-10, small strain and GNL, as phase 4:
    the load-factor histories to LBD_RTOL, one smoother built per run."""
    from fcvm_tpu_torch import FcvmConfig, solve_collapse
    from fcvm_tpu_torch.ops.precond import COARSE_BUILD_STATS

    small = plate_model(PLATE_SMALL)
    cpu_small = {}
    for gnl in (False, True):
        lbds = {}
        for dev in ("cuda", "cpu"):
            cfg = FcvmConfig(device=dev, dtype="float64", cg_rtol=1e-10, smoother="cluster",
                             **TIERS_OFF)
            builds = COARSE_BUILD_STATS["smoother_builds"]
            t0 = time.perf_counter()
            res = solve_collapse(small, plate_params(6, gnl), config=cfg)
            lbds[dev] = np.asarray(res.history.lbd)
            built = COARSE_BUILD_STATS["smoother_builds"] - builds
            print(f"{'GNL' if gnl else 'small strain'}, {dev}: {time.perf_counter() - t0:.2f} s, "
                  f"lbd {lbds[dev].round(6).tolist()}, {res.cg_stats['iters']} CG iterations, "
                  f"smoother builds {built}, predictor solves {res.cg_stats['predictor_solves']}")
            check(built == 1, f"phase 11c: {built} smoother builds on {dev}, not 1")
        check(len(lbds["cuda"]) == len(lbds["cpu"]) == 7, "phase 11c: step counts differ from 6")
        diff = float(np.max(np.abs(lbds["cuda"] - lbds["cpu"])
                            / np.maximum(np.abs(lbds["cpu"]), 1e-300)))
        print(f"max rel lbd difference {diff:.3e} (limit {LBD_RTOL:g})")
        check(diff <= LBD_RTOL, "phase 11c: GPU and CPU load-factor histories disagree")


FCSTD_NSTEP = 6  # the document's .inp: six steps, the last three plastic


def fcstd_phase(tmp, smi):
    """Phase 12: a synthetic FreeCAD document of the 502,599-dof plate
    (``fcvm_tpu_torch.tools.fcstd_doc``) through the CLI on the card, in
    float64 (``--x64``), against the same model from its TOML case: the
    load factors (from each run's last checkpoint) to CLI_RTOL. Host times of writing the document,
    ``read_fcstd``, the resolver and ``build_model``, and of each CLI run;
    the launch counts set to 0 just before the document's run. Returns
    them."""
    from fcvm_tpu_torch.models import fcstd
    from fcvm_tpu_torch.models.inp import read_inp
    from fcvm_tpu_torch.runtime.checkpoint import latest_step
    from fcvm_tpu_torch.tools import fcstd_doc

    t0 = time.perf_counter()
    params = plate_params(FCSTD_NSTEP)
    mesh, (doc, inp, toml) = fcstd_doc.plate_document(tmp / "doc", PLATE_BIG, params,
                                                      sigma=PLATE_SIGMA, e=E, nu=NU)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    parsed = fcstd.read_fcstd(doc)
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    fcstd.CloudResolver(parsed.mesh)
    t_resolver = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = fcstd.build_model(parsed, read_inp(inp))
    t_build = time.perf_counter() - t0
    nfix = int((model.bcs.masks(model.mesh.ndof)[0] < 0.5).sum())
    print(f"document {doc.stat().st_size / 1e6:.1f} MB written in {t_write:.2f} s; read_fcstd "
          f"{t_read:.2f} s ({parsed.mesh.n_nodes} nodes, {len(parsed.constraints)} constraints); "
          f"CloudResolver {t_resolver:.2f} s; build_model (its resolver included) {t_build:.2f} "
          f"s: {nfix} fixed dofs, {len(model.loads.traction_faces)} loaded faces ({smi})")
    check(model.mesh.ndof == NDOF_BIG and len(model.loads.traction_faces) > 0 and nfix > 0,
          "phase 12: the document resolved to the wrong model")
    del parsed, model
    lbd, walls = {}, {}
    for tag, case in (("fcstd", [doc, "--inp", inp]), ("toml", [toml])):
        if tag == "fcstd":
            reset_launches()
        t0 = time.perf_counter()
        rc, out = run_cli(["run", *case, "--x64", "--no-plots", "--checkpoint", "--outdir",
                           tmp / tag])
        walls[tag] = time.perf_counter() - t0
        if tag == "fcstd":
            launches = read_launches()[0]
        check(rc == 0 and "MAXIMUM RESTARTS" not in out, f"phase 12: the {tag} run failed")
        lbd[tag] = latest_step(tmp / tag / "checkpoints")[1]["lbd"]
        check(len(out_rows(tmp / tag / "plate.out")) == len(lbd[tag]),
              f"phase 12: the {tag} run's .out has not one row per step")
        final = [ln for ln in out.splitlines() if ln.startswith("final load level")][-1]
        print(f"CLI run {tag} --x64: {walls[tag]:.2f} s wall; lbd {np.round(lbd[tag], 6).tolist()}; "
              f"{final}")
        check(float(final.split("PEEQ max:")[1].split()[0]) > 0.0, f"phase 12: the {tag} run "
              "stayed elastic")
    check(not (tmp / "fcstd" / "plate.avr").exists(), "phase 12: an .avr was written for a document")
    check(len(lbd["fcstd"]) == len(lbd["toml"]) == FCSTD_NSTEP + 1,
          "phase 12: the histories have different or wrong lengths")
    diff = float(np.max(np.abs(lbd["fcstd"] - lbd["toml"]) / np.maximum(np.abs(lbd["toml"]), 1e-300)))
    print(f"max rel lbd difference, document against TOML: {diff:.3e} (limit {CLI_RTOL:g}); "
          f"the document's launches {launches}")
    check(diff <= CLI_RTOL, "phase 12: the document's history differs from the TOML case's")
    check(bool(np.all(np.diff(lbd["fcstd"]) >= 0.0)) and lbd["fcstd"].max() < 1.76,
          "phase 12: load factors decreasing or above 1.76")
    check(all(launches[k] > 0 for k in CG_KERNELS), "phase 12: K1 or K4 was not launched")
    return dict(launches=launches, t_read=t_read, t_resolver=t_resolver, t_build=t_build,
                walls=walls)


def gmsh_phase(big, tmp: Path):
    """Write the plate with ``meshio_io.write_gmsh`` and read it back through
    the native Gmsh reader in this process (the CUDA extension loaded), the
    conditions under which the iostream UNV reader crashed; host times."""
    from fcvm_tpu_torch import native
    from fcvm_tpu_torch.models import meshio_io

    path = tmp / "plate.msh"
    t0 = time.perf_counter()
    meshio_io.write_gmsh(path, big.mesh)
    t1 = time.perf_counter()
    out = native.read_gmsh_native(str(path))
    t2 = time.perf_counter()
    check(out is not None, "phase 11d: the native Gmsh reader returned nothing")
    coords, elnodes = out
    err = float(np.abs(coords - big.mesh.coords).max())
    print(f"write_gmsh {t1 - t0:.2f} s ({path.stat().st_size / 2**20:.1f} MiB), native read "
          f"{t2 - t1:.2f} s: {len(coords)} nodes, {len(elnodes)} elements, max |coords diff| "
          f"{err:.3e}, connectivity {'equal' if np.array_equal(elnodes, big.mesh.elnodes) else 'DIFFERENT'}")
    check(coords.shape == big.mesh.coords.shape and err <= 1e-12
          and np.array_equal(elnodes, big.mesh.elnodes),
          "phase 11d: the native Gmsh read-back differs from the written mesh")


def sharded_phase(big, on, smi):
    """Phase 13: the sharded backend on a world of one over NCCL
    (``force_sharded``), this process its rank: the phase-7 plate against
    phase 7, one all_reduce of the plate's vector, then the beam-column's
    eigensolve, seeding and two steps against phase 9's bars."""
    from fcvm_tpu_torch import FcvmConfig
    from fcvm_tpu_torch.parallel import dist as pdist
    from fcvm_tpu_torch.utils.indexing import pad_ndof

    g = pdist.init_process_group("cuda")
    print(f"process group: rank {g.rank} of {g.world_size}, backend {g.backend}, {g.device}")
    try:
        cfg = FcvmConfig(device="cuda", dtype="float32", force_sharded=True)
        sh = run_plate(big, cfg, "phase 13")
        steps = (len(sh["cg_stats"]["steps"]), len(on["cg_stats"]["steps"]))
        rel = abs(sh["lbd"][-1] / on["lbd"][-1] - 1)
        ratio = sh["step_iters"] / on["step_iters"]
        per_it = [1e3 * v["cg_stats"]["time"] / v["cg_stats"]["iters"] for v in (sh, on)]
        vec = torch.ones(pad_ndof(NDOF_BIG), device="cuda")
        ar_ms = cuda_ms(pdist.all_reduce, vec)
        ar = allreduce_pieces(big, cfg, vec)
        print(f"sharded (world 1, NCCL) vs phase 7 ({smi}): steps {steps[0]} / {steps[1]}, final "
              f"lbd {sh['lbd'][-1]:.6f} / {on['lbd'][-1]:.6f} (rel diff {rel:.2e}), stepping CG "
              f"iterations {sh['step_iters']} / {on['step_iters']} = {ratio:.3f}, stepping "
              f"{sh['stepping']:.2f} / {on['stepping']:.2f} s, ms per CG iteration incl. stress "
              f"updates {per_it[0]:.3f} / {per_it[1]:.3f}; one all_reduce of the "
              f"{vec.numel()}-float32 vector {ar_ms:.4f} ms (median of 20)")
        check(steps[0] == steps[1], "phase 13: not phase 7's number of steps")
        check(rel <= 1e-3, "phase 13: final lbd not within 1e-3 of phase 7's")
        check(abs(ratio - 1) <= 0.03, "phase 13: stepping CG iterations not within 3% of phase 7's")
        check(sh["launches"]["block_matmat"] > 0,
              "phase 13: K0m was not launched on the sharded plate")
        print(f"all_reduce pieces: one float {ar['one_ms']:.4f} ms (CUDA events), the plate's "
              f"vector {ar['host_ms']:.4f} ms of host time per call (100 calls, one sync); the "
              f"sharded K_hat.v {ar['khat_ms']:.4f} ms against its unreduced body "
              f"{ar['body_ms']:.4f} ms (medians of 20)")
        print("beam-column at 451,875 dof on the sharded backend, eigensolve, seeding, 2 steps:")
        col = run_column(cfg, nstep=2, label="phase 13 column")
    finally:
        pdist.destroy_process_group()
    return dict(plate=sh, column=col, all_reduce_ms=ar_ms, **ar)


def allreduce_pieces(big, cfg, vec):
    """Where phase 13's all_reduce spends its time: one of a single float,
    the host time per call of the plate's vector, and the sharded operator's
    K_hat.v against the same steps without the collective."""
    from fcvm_tpu_torch.parallel import dist as pdist
    from fcvm_tpu_torch.parallel.system import ShardedSystem

    one_ms = cuda_ms(pdist.all_reduce, torch.ones(1, device="cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        pdist.all_reduce(vec)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 10.0
    be = ShardedSystem(big, cfg, torch.float32, torch.device("cuda"))
    esm, *_ = be.assemble(be.tensor(big.mesh.coords))
    khat = be.operator(esm)
    del esm
    fm = be.space.fixmask_m
    u = torch.randn(be.ndof_pad, device="cuda")
    out = dict(one_ms=one_ms, host_ms=host_ms, khat_ms=cuda_ms(khat, u),
               body_ms=cuda_ms(lambda v: fm * khat.local(fm * v) + (1.0 - fm) * v, u))
    del khat, be
    torch.cuda.empty_cache()
    return out


def gloo_rank():
    """Phase 13b on one rank (a process of its own): the small plate in
    small strain and GNL and the small column's buckling, float64, on a
    world of two gloo ranks sharing ``cuda:0``; its load and buckling
    factors, CG counts and kernel launches."""
    from fcvm_tpu_torch import ControlParams, FcvmConfig, solve_collapse

    reset_launches()
    out = {}
    for gnl in (False, True):
        res = solve_collapse(plate_model(PLATE_SMALL), plate_params(6, gnl), config=FcvmConfig(
            device="cuda:0", dtype="float64", cg_rtol=1e-10, n_devices=2, **TIERS_OFF))
        out[gnl] = (np.asarray(res.history.lbd), [s["cg"] for s in res.cg_stats["steps"]])
    res = solve_collapse(column_model((8, 1, 1), 1.0, 1000.0), ControlParams(gnl="GNLY", nstep=1),
                         config=FcvmConfig(device="cuda:0", dtype="float64", cg_rtol=1e-12,
                                           n_devices=2))
    out["eig"] = np.asarray(res.eigenvalues)
    out["launches"] = read_launches()[0]
    return out


def gloo_phase(cpu_small):
    """Phase 13b: two gloo ranks spawned on ``cuda:0`` against the CPU's
    single-device runs (phase 4's plate, and the column here)."""
    from fcvm_tpu_torch import ControlParams, FcvmConfig, solve_collapse
    from fcvm_tpu_torch.parallel import dist as pdist

    print("two ranks share one card here (gloo, each collective staged through the host): "
          "correctness numbers, not speed; NCCL with two or more cards is unmeasured")
    t0 = time.perf_counter()
    outs = pdist.spawn(gloo_rank, 2, device="cuda:0", backend="gloo", timeout=600)
    print(f"spawned world of 2: {time.perf_counter() - t0:.1f} s wall")
    ref_col = solve_collapse(column_model((8, 1, 1), 1.0, 1000.0),
                             ControlParams(gnl="GNLY", nstep=1),
                             config=FcvmConfig(device="cpu", dtype="float64", cg_rtol=1e-12))
    same = all(np.array_equal(outs[0][k][0], outs[1][k][0]) and outs[0][k][1] == outs[1][k][1]
               for k in (False, True)) and np.array_equal(outs[0]["eig"], outs[1]["eig"])
    for gnl in (False, True):
        lbd = outs[0][gnl][0]
        diff = float(np.max(np.abs(lbd - cpu_small[gnl]) / np.maximum(np.abs(cpu_small[gnl]),
                                                                       1e-300)))
        print(f"{'GNL' if gnl else 'small strain'}: lbd {lbd.round(6).tolist()}, max rel diff "
              f"against the CPU {diff:.3e} (limit {LBD_RTOL:g}), CG per solve "
              f"{outs[0][gnl][1]}")
        check(len(lbd) == len(cpu_small[gnl]) and diff <= LBD_RTOL,
              "phase 13b: the gloo ranks' load factors disagree with the CPU")
    eig_diff = float(np.max(np.abs(outs[0]["eig"] / ref_col.eigenvalues - 1)))
    print(f"column buckling factors {outs[0]['eig'].tolist()}, max rel diff against the CPU "
          f"{eig_diff:.3e} (limit {EIG_RTOL:g}); ranks identical: {same}; launches per rank "
          f"{[o['launches'] for o in outs]}")
    check(eig_diff <= EIG_RTOL, "phase 13b: buckling factors disagree with the CPU")
    check(same, "phase 13b: the two ranks' histories differ")
    check(all(o["launches"][k] > 0 for o in outs for k in (*CG_KERNELS, "block_matmat")),
          "phase 13b: K1, K4 or K0m was not launched on a rank")
    return [o["launches"] for o in outs]


def bench_phase(smi):
    """Phase 14: the port's benchmark, in this process, with the CPU
    baseline at the matched size only; its checks and each row's peak
    device memory.  Returns its launches."""
    from fcvm_tpu_torch.tools import bench

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lines = []
    reset_launches()
    rc = bench.main(["--no-same-size"], emit=lines.append)
    launches = read_launches()[0]
    check(rc == 0 and len(lines) >= 2, "phase 14: the bench did not finish")
    g = json.loads(lines[-1])
    x = g["extra"]
    print(f"bench's last line ({len(lines)} lines): {lines[-1]}")
    head, cap, sh = x["headline"], x["capacity"], x["sharded_1dev"]
    rows = {"matched": x["matched_size"], "headline": head, "box": x["box_crosscheck"],
            **{f"capacity {r['ndof']}": r for r in cap}, "sharded": sh}
    print(f"headline ({smi}): {g['metric']} = {g['value']:.3f} ms per step (runs "
          f"{[round(t, 3) for t in head['step_ms_runs']]}), assembly {head['assembly_ms']:.3f} "
          f"ms = {head['assembly_gdof_s']:.4f} GDOF/s, precond {head['precond_first_s']:.3f} / "
          f"{head['precond_repeat_s']:.3f} s, elastic {head['elastic_iters']} CG iterations, "
          f"per-solve {head['iters_per_solve']}, plastic GP fraction "
          f"{head['plastic_gp_fraction']:.4f}; vs_baseline {g['vs_baseline']} "
          f"({x['vs_baseline_from']})")
    for name, r in rows.items():
        print(f"{name}: peak device memory {r['peak_mib'] / 1024:.2f} GiB, launches "
              f"{r['launches']}")
    for r in cap:
        print(f"capacity {r['ndof']} dof ({smi}): assembly {r['assembly_ms']:.2f} ms (first "
              f"{r['assembly_cold_s']:.2f} s), precond {r['precond_first_s']:.3f} / "
              f"{r['precond_repeat_s']:.3f} s, elastic {r['elastic_iters']} CG iterations in "
              f"{r['elastic_solve_ms']:.1f} ms = {r['ms_per_cg_iter']:.4f} ms each; host: mesh "
              f"{r['host_mesh_s']:.2f} s, tensors and solve space {r['host_setup_s']:.2f} s")
    print(f"sharded (world of one) vs local, {sh['ndof']} dof: step {sh['step_ms_sharded']:.1f} "
          f"/ {sh['step_ms_local']:.1f} ms, max lbd diff {sh['max_lbd_diff']:.3e} (tol "
          f"{sh['lbd_tol']:g}); launches in the bench: {launches}")
    check(g["metric"] == "newton_load_step_wall_ms_plate_with_hole_503kdof"
          and head["ndof"] == NDOF_BIG, "phase 14: not the 502,599-dof headline")
    check(head["plastic_gp_fraction"] > 0, "phase 14: the headline step is not plastic")
    check(head["assembly_gdof_s"] > 0, "phase 14: no assembly rate")
    check([r["ndof"] for r in cap] == [1_073_733, 1_975_509],
          "phase 14: the capacity rows are not at 1,073,733 and 1,975,509 dof")
    check(all(r["elastic_iters"] < bench.CG_MAXITER for r in cap),
          "phase 14: a capacity row's elastic solve reached the CG cap")
    check(sh["lbd_within_tol"], "phase 14: sharded and local load factors differ")
    check(g["vs_baseline"] is not None, "phase 14: no vs_baseline")
    check(all(r["launches"][k] > 0 for r in rows.values() for k in CG_KERNELS),
          "phase 14: a row of the bench did not launch K1 or K4")
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: torch.cuda.is_available() is false; this "
                         "script runs the port on an NVIDIA GPU")
    faulthandler.enable()  # a crash in native code prints where it happened
    from fcvm_tpu_torch import ControlParams, FcvmConfig, linear_buckling, solve_collapse
    from fcvm_tpu_torch.config import pin_full_fp32
    from fcvm_tpu_torch.ops import kernels
    from fcvm_tpu_torch.ops.precond import COARSE_BUILD_STATS

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

    phase(f"3 kernels vs plain, ne = {NE_BIG} and {NE_COL} ({smi})")
    k0 = k0_phase()
    k0m = k0m_phase()

    phase(f"3b bandwidth probe: K0p and Kbw vs plain, then the probe ({smi})")
    probe_rows, k0_probe_launches = probe_phase()

    phase(f"3c K1 and K4 vs plain, the chain they replaced and cuSPARSE, on the plate's and "
          f"the beam-column's operators ({smi})")
    t0 = time.perf_counter()
    big = plate_model(PLATE_BIG)
    print(f"plate: {big.mesh.n_nodes} nodes, {big.mesh.n_elements} elements, "
          f"{big.mesh.ndof} dof (mesh built in {time.perf_counter() - t0:.1f} s)")
    check(big.mesh.ndof == NDOF_BIG and big.mesh.n_elements == NE_BIG, "unexpected mesh size")
    cg_rows = cg_kernel_phase({"plate": big, "column": column_model(COL_BIG, COL_W, COL_T)})

    phase("4 small plate, float64, GPU vs CPU, small strain and GNL")
    small = plate_model(PLATE_SMALL)
    cpu_small = {}
    for gnl in (False, True):
        lbds = {}
        for dev in ("cuda", "cpu"):
            cfg = FcvmConfig(device=dev, dtype="float64", cg_rtol=1e-10, **TIERS_OFF)
            t0 = time.perf_counter()
            res = solve_collapse(small, plate_params(6, gnl), config=cfg)
            lbds[dev] = np.asarray(res.history.lbd)
            print(f"{'GNL' if gnl else 'small strain'}, {dev}: {time.perf_counter() - t0:.2f} s, "
                  f"lbd {lbds[dev].round(6).tolist()}, predictor solves "
                  f"{res.cg_stats['predictor_solves']}")
            if gnl:
                check(res.cg_stats["predictor_solves"] > 0, "GNL: no tangent predictor solve")
        cpu_small[gnl] = lbds["cpu"]
        check(len(lbds["cuda"]) == len(lbds["cpu"]) == 7, "step counts differ from 6")
        diff = float(np.max(np.abs(lbds["cuda"] - lbds["cpu"])
                            / np.maximum(np.abs(lbds["cpu"]), 1e-300)))
        print(f"max rel lbd difference {diff:.3e} (limit {LBD_RTOL:g})")
        check(diff <= LBD_RTOL, "GPU and CPU load-factor histories disagree")
    # the clamped-free 8 x 1 x 1 column of tests/test_buckling_gnl.py:29
    col = column_model((8, 1, 1), 1.0, 1000.0)
    lams = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        lams[dev], _ = linear_buckling(col, ControlParams(gnl="GNLY", nstep=1), config=FcvmConfig(
            device=dev, dtype="float64", cg_rtol=1e-12))
        print(f"linear_buckling, small column, {dev}: {time.perf_counter() - t0:.2f} s, "
              f"factors {lams[dev].tolist()}")
    diff = float(np.max(np.abs(lams["cuda"] / lams["cpu"] - 1)))
    print(f"max rel factor difference {diff:.3e} (limit {EIG_RTOL:g})")
    check(diff <= EIG_RTOL, "GPU and CPU buckling factors disagree")

    phase("5 plate with hole at full size, float32, deflation and precision tiers off")
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

    phase("8 plate with hole at full size, GNL, float32, default configuration")
    gnl = run_plate(big, cfg7, "phase 8", gnl=True)
    cs = gnl["cg_stats"]
    check(cs["predictor_solves"] > 0, "phase 8: no tangent predictor solve")
    newton = [s["newton"] for s in cs["steps"]]
    print(f"Newton iterations per step {newton}; tangent refreshes {cs['predictor_solves']}, "
          f"tangent_time {cs['tangent_time']:.2f} s ({cs['tangent_time'] / cs['predictor_solves']:.3f} "
          f"s per refresh); correction CG per solve {gnl['step_iters'] / max(gnl['step_solves'], 1):.1f}, "
          f"predictor CG per refresh {cs['predictor_iters'] / cs['predictor_solves']:.1f}")
    print(f"load-deflation spaces built: "
          f"{sum('load-deflation space (' in ln for ln in gnl['lines'])}; dropped as stale: "
          f"{sum('load-deflation space stale' in ln for ln in gnl['lines'])}; correction-space "
          f"harvests: {len(cs['harvests'])}")
    print(f"GNL vs phase 7: stepping time {gnl['stepping']:.2f} / {on['stepping']:.2f} s "
          f"= {gnl['stepping'] / on['stepping']:.3f}")

    phase(f"8b one tangent refresh in pieces, plate at full size, float32 ({smi})")
    refresh_breakdown(big, cfg7, gnl.pop("res"))

    phase("9 imperfect beam-column at 451,875 dof, GNL, float32, default configuration")
    col = run_column(cfg7)

    phase(f"9b the eigensolve in pieces, beam-column at 451,875 dof, float32 ({smi})")
    column_breakdown(cfg7)

    with tempfile.TemporaryDirectory() as tmp:
        phase("10 case file at full size: load_case -> run_analysis -> run_sum, the CLI's "
              "info and sum, float32, default configuration")
        case = case_phase(Path(tmp), smi)

        phase("10b CLI run --x64 on the GPU and with --cpu, small plate; checkpoint and resume")
        cli_phase(Path(tmp))

        phase("11 plate with hole at full size, cluster smoother, float32, default configuration")
        cfg11 = FcvmConfig(device="cuda", dtype="float32", smoother="cluster")
        builds = dict(COARSE_BUILD_STATS)
        clus = run_plate(big, cfg11, "phase 11")
        built = {k: COARSE_BUILD_STATS[k] - builds[k] for k in ("smoother_builds",
                                                                 "smoother_fallbacks")}
        failover = sum(ln.startswith("PRECISION FAILOVER") for ln in clus["lines"])
        print(f"smoother builds {built['smoother_builds']}, fallbacks to block Jacobi "
              f"{built['smoother_fallbacks']}, float64 failovers {failover}")
        check(built == {"smoother_builds": 1 + failover, "smoother_fallbacks": 0},
              "phase 11: not one cluster smoother per operator")
        mean = {k: v["step_iters"] / max(v["step_solves"], 1) for k, v in (("7", on), ("11", clus))}
        per_it = {k: 1e3 * v["cg_stats"]["time"] / v["cg_stats"]["iters"]
                  for k, v in (("7", on), ("11", clus))}
        print(f"cluster smoother vs phase 7 ({smi}): stepping time {clus['stepping']:.2f} / "
              f"{on['stepping']:.2f} s = {clus['stepping'] / on['stepping']:.3f}; stepping CG "
              f"iterations {clus['step_iters']} / {on['step_iters']} = "
              f"{clus['step_iters'] / on['step_iters']:.3f}; CG iterations per solve "
              f"{mean['11']:.1f} / {mean['7']:.1f}; ms per CG iteration incl. stress updates "
              f"{per_it['11']:.3f} / {per_it['7']:.3f}")
        print("the smoother's pieces, same plate and configuration:")
        smoother_breakdown(big, cfg11)

        phase("11b plate with hole at full size, GNL, cluster smoother, float32, default "
              "configuration")
        builds = COARSE_BUILD_STATS["smoother_builds"]
        clus_gnl = run_plate(big, cfg11, "phase 11b", gnl=True)
        built = COARSE_BUILD_STATS["smoother_builds"] - builds
        failover = sum(ln.startswith("PRECISION FAILOVER") for ln in clus_gnl["lines"])
        cs = clus_gnl["cg_stats"]
        print(f"smoother builds {built} (float64 failovers {failover}) over "
              f"{cs['predictor_solves']} tangent refreshes; predictor CG per refresh "
              f"{cs['predictor_iters'] / max(cs['predictor_solves'], 1):.1f} (phase 8: "
              f"{gnl['cg_stats']['predictor_iters'] / gnl['cg_stats']['predictor_solves']:.1f}); "
              f"stepping {clus_gnl['stepping']:.2f} s against phase 8's {gnl['stepping']:.2f} s, "
              f"stepping CG iterations {clus_gnl['step_iters']} against {gnl['step_iters']}")
        check(cs["predictor_solves"] > 0, "phase 11b: no tangent predictor solve")
        check(built == 1 + failover, "phase 11b: the refreshes rebuilt the smoother")

        phase("11d the plate through write_gmsh and the native Gmsh reader, in this process")
        gmsh_phase(big, Path(tmp))

        phase("11c small plate, float64, cluster smoother, GPU vs CPU, small strain and GNL")
        cluster_small_phase()

        phase(f"12 FreeCAD document of the plate at full size through the CLI, float64 ({smi})")
        doc = fcstd_phase(Path(tmp), smi)

    phase(f"13 sharded backend, world of 1 over NCCL: the plate (phase 7's configuration) and "
          f"the beam-column ({smi})")
    sharded = sharded_phase(big, on, smi)
    del big

    phase("13b sharded backend, world of 2 over gloo on one card, float64, GPU ranks vs CPU")
    gloo_launches = gloo_phase(cpu_small)

    phase(f"14 the port's benchmark: tools.bench --no-same-size ({smi})")
    bench_launches = bench_phase(smi)
    phase()
    print(f"all phases: {time.perf_counter() - t_start:.1f} s wall")

    paths = {"plate": off, "default": on, "gnl": gnl, "column": col, "case": case,
             "cluster": clus, "cluster_gnl": clus_gnl, "fcstd_f64": doc,
             "sharded": sharded["plate"], "sharded_column": sharded["column"]}

    def path_launches(name):
        """A kernel's launches in each path phase (5 to 14)."""
        out = {f"launches_{k}": v["launches"][name] for k, v in paths.items()}
        return {**out, "launches_gloo_ranks_f64": [g[name] for g in gloo_launches],
                "launches_bench": bench_launches[name]}

    def cg_shapes(name):
        return [{"dtype": dt, "model": m, "variant": v, **row}
                for (kname, dt, m, v), row in cg_rows.items() if kname == name]

    print(json.dumps({"kernels": [{
        "name": "khat_matvec", "route": "cuda", "source": "fcvm_tpu_torch/csrc/khat_matvec.cu",
        "replaces": "fcvm_tpu/ops/assembly.py:525",
        "replaces_also": "fcvm_tpu/ops/assembly.py:576 (make_bc_matvec), :386 "
                         "(scatter_node_rows); XLA-lowered",
        "launches": off["launches"]["khat_matvec"], **path_launches("khat_matvec"),
        "launches_column_by_dtype": col["by_dtype"]["khat_matvec"],
        "dtype": "float32", "model": "plate", "variant": "masked",
        **cg_rows[("khat_matvec", "float32", "plate", "masked")],
        "shapes": cg_shapes("khat_matvec"),
    }, {
        "name": "two_level_apply", "route": "cuda", "source": "fcvm_tpu_torch/csrc/two_level.cu",
        "replaces": "fcvm_tpu/ops/precond.py:108", "replaces_also": "XLA-lowered",
        "launches": off["launches"]["two_level_apply"], **path_launches("two_level_apply"),
        "launches_column_by_dtype": col["by_dtype"]["two_level_apply"],
        "dtype": "float32", "model": "plate", "variant": "jacobi3",
        **cg_rows[("two_level_apply", "float32", "plate", "jacobi3")],
        "shapes": cg_shapes("two_level_apply"),
    }, {
        # K1 carries the solver's K_hat·v: K0's path is the bandwidth probe
        "name": "block_matvec", "route": "cuda", "source": "fcvm_tpu_torch/csrc/block_matvec.cu",
        "replaces": "fcvm_tpu/ops/pallas_kernels.py:60", "path": "bandwidth probe (phase 3b)",
        "launches": k0_probe_launches, **path_launches("block_matvec"),
        "dtype": "float32", "ne": NE_BIG, **k0[(torch.float32, NE_BIG)],
        "shapes": [{"dtype": str(dtype).removeprefix("torch."), "ne": ne, **row}
                   for (dtype, ne), row in k0.items()],
    }, *probe_rows, {
        "name": "block_matmat", "route": "cuda",
        "source": "fcvm_tpu_torch/csrc/block_matmat.cu",
        "replaces": "fcvm_tpu/ops/pallas_kernels.py:60 under vmap; "
                    "fcvm_tpu/runtime/buckling.py:318",
        "launches": col["launches"]["block_matmat"], **path_launches("block_matmat"),
        "launches_by_shape": col["by_dtype"]["block_matmat"],
        "launches_sharded_column_by_shape": sharded["column"]["by_dtype"]["block_matmat"],
        "ne": NE_COL, "m": 8, **k0m[(torch.float32, NE_COL, 8)],
        "shapes": [{"dtype": str(dtype).removeprefix("torch."), "ne": ne, "m": m, **row}
                   for (dtype, ne, m), row in k0m.items()],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
