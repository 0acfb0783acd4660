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
   with m = 1 to 8, 32 and 64, the plate's with m = 32: the widths at which
   the paths ran it before K1m took its place), float32 and float64, timed
   beside m launches of K0;
3b. bandwidth probe: K0p (``soa_matvec``) and Kbw (``bw_read``, each k)
   against their plain versions on seeded data, then the probe
   (``fcvm_tpu_torch.tools.bw_probe``) at its full sizes, whose launches of
   K0, K0p and Kbw are counted (the probe is K0's path: the solver's
   K_hat·v runs K1); the probe fails when a Kbw k takes less than 0.9
   of the time of a plain full read of the same 2 GiB (Kbw's result shows
   only the chunk heads, so its time is what shows it read every byte);
3c. the kernels of the CG iteration: K1 (``khat_matvec``, the fused
   K_hat·v, masked and raw, reading the packed upper triangles of the
   blocks) on the plate's and the beam-column's operators and K4
   (``two_level_apply``, with block Jacobi and with the cluster smoother's
   output) on the plate's preconditioner, float32 and float64, against
   their plain versions, each bit for bit the same on a second call; K4's
   coarse product K4c alone (``coarse_product`` on a vector, on the packed
   upper tiles of the coarse inverse) against its plain version and the build's dense
   inverse (its asymmetry ``max |A - A^T| / max |A|``), timed against
   ``torch.mv`` of the dense inverse, its bound the stored triangle; timed
   against their plain versions, against the chain K1 replaced (gather, K0,
   ``index_add_``, masks) and, for K1, against a cuSPARSE CSR matvec of the
   assembled K_hat (``torch.sparse``, built once here); the blocks'
   asymmetry ``max |K - K^T| / max |K|`` and the packed copy's size; then
   K8 (``segment_sum``, the fixed-order node sum) at every site the paths
   give it, float32 and float64 (the internal force's and the
   block-Jacobi blocks' in its write form, two chunks of the coarse table's
   and the first of the cluster smoother's accumulation in its accumulating
   form, at their real keys), in both forms against its plain version on
   the card (``index_add_``, the library call) and bit for bit against it
   on the CPU, whose order is the kernel's, with each site's group sizes
   and the launches by path;
3d. the block kernels of the eigensolve: K1m (``khat_matmat``, K1 on an
   (ndof, m) block, reading K1's packed blocks and incidence table) in its
   three forms (K_hat·V; -G_hat·V, projected and negated; the raw K·V) on
   the beam-column's operator at every width of its eigensolve and
   deflation (``K1M_WIDTHS``) and on the plate's at its deflation width,
   and K4m (``two_level_apply_block``, with block Jacobi and with the
   cluster smoother's output) on the beam-column's preconditioner at the
   widths of its block solves, float32 and float64, against their plain
   versions and bit for bit against a second call, K4c alone
   (``coarse_product`` on a block) at each width against its plain version and
   ``torch.mm`` of the dense inverse (K1m: through its
   operator's plan, as the paths call it, and against a call that makes
   its own); K1m's share of compacted element rows on each mesh, and on the
   beam-column at m = 8 each column of K_hat·V and of the raw K·V K1's
   bits; timed against their plain versions, the chains they replaced (K1m:
   gather, K0m, K8, masks; K4m: the torch steps, and m vector applies) and,
   for K1m's K_hat·V, a cuSPARSE CSR product (``torch.sparse.mm``) of the
   assembled K_hat at every width, with the device time of each of K1m's
   two passes (torch.profiler);
3e. K6 (``cg_iteration``), the rest of a CG iteration: each of its two
   passes (the update; the direction) and their start forms on the plate's
   vectors (float32 and float64, float32 with a 32-vector deflation space,
   that space on the block form at m = 1, and with a 64-slot harvest) and
   the beam-column's block at m = 8 (both dtypes, a third of the columns
   frozen), undeflated and deflated by 64 vectors at m = 2 to 8 in both
   dtypes (the eigensolve's block fold), against its plain version on
   inputs whose W c is of the size of z (the
   counters, flags and harvested residuals bit for bit, x, r and p bit for
   bit as the plain updates make them with the kernel's own step lengths,
   the sums and a deflated direction to the tolerance, z never written)
   and bit for bit against a second launch; one iteration's two passes
   timed against their plain versions, their bound (10 vectors), the torch
   chain they replaced and (deflated) the three torch products of the
   correction, with each pass's device time;
   then one elastic solve of the plate at each ``CG_BATCH`` of
   ``K6_BATCHES``, in turns: the same bits and count at every batch, at
   most ceil(iters / batch) + 2 host reads, the wall time per iteration;
3f. K2, the stress update and internal force of every residual, in two
   passes.  Its element pass (``stress_update``): on the plate's and the
   beam-column's meshes (``K2_CASES``: the update and the given-stress form,
   each in small strain and GNL; on the plate the GNL update with phase 10's
   region, a D, G and H per element, and element weights with zeros),
   float32 and float64, seeded with about half the Gauss points plastic,
   against its plain version (every output to ``K2_TOL``, in float32 no
   farther from the float64 plain version than twice the float32 plain
   version, the plastic flags equal but within ``K2_FLIP`` of the yield
   surface, the flips counted) and bit for bit against a second launch;
   timed (CUDA events, device time) against its plain version (the chain
   it replaced) and its bound.  Its node pass (``node_force``) on both meshes' node plans, the
   internal force and the residual form: bit for bit K8's write form and
   the torch tail, error within 4 ulps, to ``K2_TOL`` of its plain version,
   timed against it, its bound and ``index_add_``.  Then the plate's whole
   ``backend.residual``: one launch of each pass and none of K8, the bits of
   the unfused composition (element pass, K8, torch tail), timed against it
   in turns, and a profile that shows K2's two kernels and nothing else;
3g. K3 and K5, the element blocks and the block-Jacobi rebuild.  K3
   (``form_blocks``) at every shape the paths give it (``K3_CASES``, with
   the outputs each writes, ``K3_OUTPUTS``: the plate's tangent as a
   refresh forms it, its packed tiles and compact diagonal in the solve
   space's order, and with phase 10's region, a D, G and H per element,
   both blocks, on a seeded state with about half the Gauss points
   plastic; the plate's and the beam-column's elastic operators, every
   output; the beam-column's geometric pencil, its tiles, on a seeded
   pre-stress; the sharded weights with zeros, every output), float32 and
   float64, against its plain version (the einsum chain and
   ``pack_blocks``) to ``K3_TOL``, in float32 no farther from the float64
   plain version than twice the float32 plain version, its blocks exactly
   symmetric, its packed tiles bit for bit ``pack_blocks`` of its own
   element-major blocks and its compact diagonal their ``diag_sectors``, a
   second launch the same bits; K5 (``jacobi_inverse``) on K3's compact
   diagonal as the refresh, the assembly (the user plan, ``cols``), the
   sharded form (its sum, a reduce, its tail) and the eigensolve (the
   beam-column) read it, its sum bit for bit K8's write form, its
   inverses within 4 ulps of the torch tail; each timed (CUDA events,
   device time) against its plain version and its bound, each row's
   SHA-256 printed;
4. cross-check: a small plate-with-hole collapse in float64 on the GPU and
   on the CPU, small strain and geometrically nonlinear (``gnl="GNLY"``);
   the load-factor histories must agree; and ``linear_buckling`` of a small
   clamped-free column on both, whose factors must agree;
5. the slice at full size: the quarter plate with a hole at 502,599 dof,
   float32, two-level PCG without deflation or the precision tiers, plastic
   Riks steps through ``fcvm_tpu_torch.solve_collapse``; the launch counts
   of K1, K4, K8, K6, K2's two passes, K3 and K5, the kernels on that path,
   must be > 0 (K2's are the residual count, printed by form; K3 and K5 by
   form as well: every path phase, 5 to 14, holds them), and K6's
   exactly two passes for each queued CG iteration and each solve's start
   (as in every plate phase, 9, 9c and 14); the CG loop's host reads per
   solve and idle queued iterations (as in 7, 9, 9b);
5b. phase 5 again in the same process: the same Newton and CG counts of
   every step and the same load factors, bit for bit (every node sum runs
   in a fixed order);
6. layers: on the same plate, the CUDA-event time of each piece of one CG
   iteration (K_hat·v through K1 and the stages of the chain it replaced,
   the preconditioner apply through K4 and its coarse product K4c against
   ``torch.mv`` of the dense inverse, the plain apply) and of one
   residual, and torch.profiler's share of device time per operation over
   one elastic solve;
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
   CUDA-event times of the tangent formation (K3, and the plain chain it
   replaced), the block-Jacobi rebuild (K5, and its plain chain), the
   follower loads, the right-hand side, the whole refresh without the
   predictor, the predictor solve cold and warm-started, and the GNL
   residual against the small-strain one; a profile of four refreshes
   without the predictor, its raw totals printed: K3 and K5 launched four
   times each by their wrappers' counts and recorded at least three times
   each (the tracer misses records of a profile's first call), and beside
   them only kernels that the follower loads and the right-hand side launch
   on their own, per call;
9. the imperfect beam-column of ``examples/imperfect_column_collapse.toml``
   refined to 451,875 dof, float32, default configuration: the linear
   buckling eigensolve (its tier, sweeps, pencil residuals and inner CG
   iterations), imperfection seeding and a few GNL steps; both factors
   within 3% of the clamped-free Euler value, the imperfection applied
   exactly, every step converged below the squash factor, and K1, K4, K8,
   K1m, K4m and K3's geometric form launched on the path, K0m not (K1, K4 and K8 by dtype, K1m
   and K4m by dtype and column count), K6 in its deflated block form (by
   form: as in 9c and 13); its peak device memory;
9b. the eigensolve in pieces on the same mesh: CUDA-event times of the
   geometric-block formation, one K_hat·V and one -G_hat·V at m = 8 through
   K1m and through the chain it replaced, the block preconditioner apply
   through K4m, through the steps it replaced and as 8 vector applies, and
   one pcg_block iteration through each against one pcg iteration (wall,
   host sync included); one pcg_block iteration deflated by the
   eigensolve's own space (kd = 64), the correction folded into K6's
   passes (``defl=``), beside the same iteration with the preconditioner
   wrapped in ``deflation.deflated`` and that deflation's three torch
   products alone; a profile of 8 more folded iterations (9 less 1, over
   10 calls each, rounded): no torch kernel beyond the undeflated
   iteration's (no product for the correction);
9c. phase 9 with the cluster smoother (``smoother="cluster"``), its checks,
   against phase 9: the eigensolve's tier, sweeps and inner CG iterations,
   the factors, the stepping and the peak device memory (the smoother's
   fine level reaches K4m as the caller's output);
10. the case-file path at full size: a TOML case of the phase-5 plate with
   a region ``y > 75`` twice as stiff and Sum groups on the loaded face and
   edge, through ``load_case``, ``run_analysis`` (float32, default
   configuration, no plots) and ``run_sum``, then the CLI's ``info`` and
   ``sum``: the ``.out``/``.vtk``/``.avr`` written and read back, the face
   area and edge length, phase 5's bars on the steps, a per-element
   elasticity in the backend, K1, K4 and K8 launched and the native formatter
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
   and without it and the memory it adds, the coarse table's accumulate and
   the smoother's, both by K8, each split into its pair products, its
   plans (``segment_plan``: the stable sort, then the groups and the
   host's read) and K8, and the smoother's factorization,
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
   steps, K1, K4 and K8 launched; the host times of ``read_fcstd``, the resolver and
   ``build_model``;
11d. (before 12) the phase-5 plate written with ``meshio_io.write_gmsh`` and
   read back through the native Gmsh reader in this process, after the CUDA
   extension has loaded: the same coordinates and connectivity;
13. the sharded backend (``fcvm_tpu_torch.parallel``) on a world of one over
   NCCL, this process its rank (``force_sharded``): the phase-7 plate with
   phase 7's configuration and checks, held against phase 7 (the same
   steps, the final lbd within 1e-3, stepping CG iterations within 3%),
   K1, K4, K8 and K1m launched and K0m not, the time of one ``all_reduce``
   of the plate's vector; then the beam-column's eigensolve, seeding and
   two GNL steps on the sharded backend with phase 9's bars;
13b. two gloo ranks spawned on ``cuda:0`` (NCCL refuses two ranks on one
   card): phase 4's small plate, small strain and GNL, and the small
   column's buckling (``nstep = 1``) in float64 against the CPU's
   single-device runs (lbd to LBD_RTOL, factors to EIG_RTOL), both ranks'
   histories identical, K1, K4, K8, K6 and K1m launched on each rank, K0m not.
14. the port's benchmark (``fcvm_tpu_torch.tools.bench.main`` with
   ``--no-same-size``, in this process): the matched plate, the 502,599-dof
   headline plate (plastic, ``assembly_gdof_s`` > 0), the box at 499,125
   dof, the capacity rows at 1,073,733 and 1,975,509 dof (converged below
   the CG cap) with each row's peak device memory, the sharded row within
   its ``lbd_tol``, a ``vs_baseline`` from the CPU child, and K1, K4, K8
   and K6 launched in every row, K2 in every row but the capacity rows
   (which evaluate no residual).

Each phase prints its wall time.

Any failed check raises and the script exits non-zero.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists each kernel
with its launches, error and times.
"""

from __future__ import annotations

import faulthandler
import inspect
import itertools
import json
import math
import subprocess
import tempfile
import time
import warnings
from collections import Counter
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


def device_ms(fn, *args, calls=10):
    """Mean device time of one call of ``fn``: the CUDA kernels
    torch.profiler records over ``calls`` calls (after a warm-up), with no
    host time between them."""
    return sum(device_ms_by_kernel(fn, *args, calls=calls).values())


def device_ms_by_kernel(fn, *args, calls=10, tries=3):
    """``{kernel name: mean device time of one call in ms}`` of the CUDA
    kernels torch.profiler records over ``calls`` calls of ``fn`` (after a
    warm-up), each named by its function's name alone (no namespace,
    template arguments or parameters).  A profile that recorded no kernel
    (the tracer can miss a window) is taken again, up to ``tries`` times;
    after that the dict is empty."""
    fn(*args)
    torch.cuda.synchronize()
    out = Counter()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                name = ev.key.split("<")[0].split("::")[-1].split("(")[0].split()[-1]
                out[name] += ev.self_device_time_total / calls / 1e3
        if out:
            break
    return dict(out)


def kernel_launches(fn, *args, calls=1):
    """``(port, other)``: ``{kernel name: launches}`` of the CUDA kernels
    torch.profiler records over ``calls`` calls of ``fn``, totals, the
    port's (the functions in the anonymous namespaces of
    ``fcvm_tpu_torch/csrc``) and every other (PyTorch's, cuBLAS's), each
    named as in ``device_ms_by_kernel``.  The tracer can miss the first
    kernels of a profile: in the whole smoke on the card, the first five to
    nine of every profile of 8b, K3 and K5 in the refresh's, with or without
    a traced warm-up step or a 20 ms spin kernel before them; in 9b's
    profiles of pcg_block, in some and not others, the torch kernels of a
    solve's start (the port's kernels recorded), so 9b counts over 10 calls."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    port, other = Counter(), Counter()
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.key.split("<")[0].split("::")[-1].split("(")[0].split()[-1]
            ours = ev.key.removeprefix("void ").startswith("(anonymous namespace)::")
            (port if ours else other)[name] += ev.count
    return port, other


# the kernels of the solver's paths: K1 and K4 in every CG iteration (the
# vector paths), K8 in every residual and build, K1m in the block products
# (the eigensolve, the deflation builds), K4m in the eigensolve's block
# preconditioner applies; K0m and K0 in none since K1m and K1 carry K_hat·V
# and K_hat·v
# and K6 the rest of every CG iteration (and K2's two passes, stress_update
# and node_force, every residual and internal force; K3, form_blocks, every
# element block an assembly, a refresh or the pencil forms, and K5,
# jacobi_inverse, every block-Jacobi rebuild): the sharded backend's
# too, whose
# element-partitioned solves run the local loop around an all_reduced
# operator; only its node-partitioned PCG (config.node_partition, off by
# default and in no phase) passes its own inner product and keeps the host
# loop (ROADMAP.md queues K6's partials through all_reduce there)
CG_KERNELS = ("khat_matvec", "two_level_apply", "segment_sum", "cg_iteration", "stress_update",
              "node_force", "form_blocks", "jacobi_inverse")
BLOCK_KERNELS = ("khat_matmat", "two_level_apply_block")
PATH_KERNELS = (*CG_KERNELS, *BLOCK_KERNELS, "block_matmat", "block_matvec")
BY_SHAPE = ("block_matmat", *BLOCK_KERNELS)  # counted by dtype and column count


def reset_launches():
    """Set the launch counts of every path kernel to 0."""
    from fcvm_tpu_torch.ops import kernels

    for name in PATH_KERNELS:
        fn = getattr(kernels, name)
        fn.launches = 0
        getattr(fn, "shapes" if name in BY_SHAPE else "dtypes").clear()
    getattr(kernels.segment_sum, "paths", Counter()).clear()
    getattr(kernels.cg_iteration, "passes", Counter()).clear()
    getattr(kernels.cg_iteration, "forms", Counter()).clear()
    for name in ("stress_update", "node_force", "form_blocks", "jacobi_inverse"):
        getattr(getattr(kernels, name), "forms", Counter()).clear()
    getattr(kernels.form_blocks, "outputs", Counter()).clear()


def cg_stats_reset():
    """Clear the CG loop's counts (an older tree has none: None)."""
    from fcvm_tpu_torch.ops import solver as slv

    stats = getattr(slv, "CG_STATS", None)
    if stats is not None:
        stats.clear()
    return stats


def cg_loop_line(stats, iters, wall_s):
    """The CG loop's host reads per solve and idle queued iterations, beside
    the wall time per CG iteration ``wall_s`` / ``iters``."""
    per = 1e3 * wall_s / max(iters, 1)
    if stats is None:
        return f"{per:.4f} ms wall per CG iteration; host read every iteration (this tree)"
    solves = max(stats["solves"], 1)
    return (f"{per:.4f} ms wall per CG iteration; {stats['solves']} device-loop solves, "
            f"{stats['reads'] / solves:.2f} host reads per solve ({stats['reads']} reads), "
            f"{stats['queued']} iterations queued, {stats['idle']} of them idle "
            f"({stats['idle'] / max(stats['queued'], 1):.2%})")


def k6_two_passes(launches, stats, label):
    """Check that K6 launched its two passes for each queued CG iteration
    and each solve's start, and no other kernel: ``2 (queued + solves)`` of
    the CG loop's counts ``stats``.  A tree of another design (four passes,
    ``tools/turns.py``) or without the counts is not held to it."""
    from fcvm_tpu_torch.ops import kernels

    if stats is None or len(getattr(kernels, "CG_PASSES", ())) != 2:
        return
    want = 2 * (stats["queued"] + stats["solves"])
    print(f"K6: {launches['cg_iteration']} launches, two passes for each of {stats['queued']} "
          f"queued iterations and {stats['solves']} starts: {want}")
    check(launches["cg_iteration"] == want,
          f"{label}: K6 launched {launches['cg_iteration']} times, not two passes an iteration "
          f"queued and a start ({want})")


def read_launches():
    """``({kernel: launches}, {kernel: {dtype: launches}})`` of the path
    kernels; K0m's, K1m's and K4m's by dtype and column count; K8's also by
    form and path (``"segment_sum paths"``), K6's by pass and by its plan's
    form (``"cg_iteration forms"``), K2's, K3's and K5's by form, K3's by
    output (``"form_blocks outputs"``: a launch that wrote the compact
    diagonal counts under ``diag``)."""
    from fcvm_tpu_torch.ops import kernels

    counts = {name: getattr(kernels, name).launches for name in PATH_KERNELS}
    by = {name: dict(getattr(kernels, name).dtypes) for name in PATH_KERNELS
          if name not in BY_SHAPE}
    for name in BY_SHAPE:
        by[name] = {f"{dt} m={m}": n
                    for (dt, m), n in sorted(getattr(kernels, name).shapes.items())}
    by["segment_sum paths"] = dict(getattr(kernels.segment_sum, "paths", {}))
    by["cg_iteration passes"] = dict(getattr(kernels.cg_iteration, "passes", {}))
    by["cg_iteration forms"] = dict(getattr(kernels.cg_iteration, "forms", {}))
    for name in ("stress_update", "node_force", "form_blocks", "jacobi_inverse"):
        by[f"{name} forms"] = dict(getattr(getattr(kernels, name), "forms", {}))
    by["form_blocks outputs"] = dict(getattr(kernels.form_blocks, "outputs", {}))
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
    khat, pinv, glv, rhs, *_ = backend.assemble_operator(coords)
    pc = backend.operator_pc(khat, pinv)
    space = backend.space
    esm_t = khat.esm_t
    del pinv
    eldofs_t = space.eldofs_m.T.contiguous()
    u = space.to_m(rhs)
    fm = space.fixmask_m
    ue_t = u[eldofs_t]
    fe = kernels.block_matvec(esm_t, ue_t).reshape(-1)
    zc = torch.ones(pc.coarse_inv.shape[0], dtype=u.dtype, device=u.device)
    pc_args = (pc.pinv, pc.qmat, pc.coarse_inv, pc.fixmask, u)
    mirrored = dense_coarse(pc.coarse_inv)  # the plain version's coarse inverse
    rows = [
        ("K_hat.v (K1)", cuda_ms(khat, u)),
        ("  K1, raw K.v", cuda_ms(kernels.khat_matvec, khat.packed, space.incidence, u)),
        ("K_hat.v by the chain K1 replaced (gather, K0, index_add_, masks)",
         cuda_ms(k0_chain, esm_t, eldofs_t, u, fm)),
        ("  gather (30, ne)", cuda_ms(lambda: u[eldofs_t])),
        ("  K0", cuda_ms(kernels.block_matvec, esm_t, ue_t)),
        ("  index_add_", cuda_ms(
            lambda: torch.zeros_like(u).index_add_(0, eldofs_t.reshape(-1), fe))),
        ("preconditioner apply (K4)", cuda_ms(pc.apply, u)),
        ("  K4 alone", cuda_ms(kernels.two_level_apply, *pc_args)),
        ("preconditioner apply by the code K4 replaced (its plain version)",
         cuda_ms(kernels.two_level_apply_ref, pc.pinv, pc.qmat, mirrored, pc.fixmask, u)),
        ("  block Jacobi", cuda_ms(asm.apply_block_precond, pc.pinv, u)),
        (f"  coarse product ({zc.numel()}), as K4 runs it", cuda_ms(pc.coarse, zc)
         if hasattr(pc, "coarse") else cuda_ms(torch.mv, pc.coarse_inv, zc)),
        ("  the same by torch.mv of the dense inverse", cuda_ms(torch.mv, mirrored, zc)),
    ]
    del ue_t, fe, mirrored
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = backend.solve(khat, pc, rhs, x0=backend.u_fix)
    torch.cuda.synchronize()
    solve_ms = 1e3 * (time.perf_counter() - t0)
    qnorm = max(float(torch.linalg.vector_norm(glv)), 1.0)
    sig_yield, sig0 = backend.gauss_full(PLATE_SY), backend.gauss_zeros((6,))
    zero = torch.zeros_like(res.x)
    rows.append(("residual (K2's element pass and node pass), per Newton iteration",
                 cuda_ms(lambda: backend.residual(coords, sig_yield, zero, res.x, sig0,
                                                  glv, 1.0, qnorm, 0.0))))
    rows_k8 = torch.ones((backend.ne * 10, 3), dtype=u.dtype, device=u.device)
    nn = backend.ndof_pad // 3
    rows += [("  its node sum (K8, the write form)", cuda_ms(
                 lambda: kernels.segment_sum(rows_k8, backend.node_plan, rows=nn))),
             ("  the same by torch.zeros + index_add_", cuda_ms(lambda: torch.zeros(
                 (nn, 3), dtype=u.dtype, device=u.device).index_add_(
                 0, backend.node_plan.keys, rows_k8)))]
    del rows_k8
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


def refresh_breakdown(model, cfg, res, calls=4):
    """Print the pieces of one GNL tangent refresh on the end state of a GNL
    run ``res`` (its total displacement and stresses; the plastic points are
    those on the yield surface), CUDA events: the tangent formation, K3's
    packed tiles and compact diagonal in the solve space's order, beside
    the plain chain it replaced (the einsums, the element-major copy,
    ``pack_blocks``); the block-Jacobi rebuild, K5 on that diagonal, beside
    its plain chain (the diagonal slice, K8, the torch tail); the follower
    loads; the right-hand
    side (K1 on the tiles); the whole refresh without the predictor solve;
    the predictor solve cold and warm-started from the predictor of a
    nearby state (5% less displacement, standing for the previous Newton
    iteration's); one residual with and without GNL.  Then a profile of
    ``calls`` refreshes without the predictor (:func:`kernel_launches`),
    whose raw totals it prints, checked: K3's and K5's wrappers count
    ``calls`` launches each, the profile records each at least ``calls -
    1`` times, and beside them only kernels that the follower loads and
    the right-hand side launch on their own, as often a call (each total
    over ``calls``, rounded up: the tracer misses records of a profile's
    first call only, :func:`kernel_launches`).  Returns the rows."""
    from fcvm_tpu_torch.ops import assembly as asm
    from fcvm_tpu_torch.ops import kernels
    from fcvm_tpu_torch.ops import material as mat
    from fcvm_tpu_torch.ops.precond import refresh_blocks
    from fcvm_tpu_torch.runtime import system as sysm
    from fcvm_tpu_torch.runtime.backend import TorchSystem
    from fcvm_tpu_torch.utils.indexing import pad_vector

    backend = TorchSystem(model, cfg, cfg.resolve_dtype(), cfg.resolve_device())
    coords = backend.tensor(model.mesh.coords)
    khat, pinv, glv, *_ = backend.assemble_operator(coords)
    pc = backend.operator_pc(khat, pinv)
    del khat, pinv
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
    g, h = backend.g, mat.hardening_modulus(backend.e, et_e)
    tangent = dict(dmat=backend.dmat, sig=sig, pgp=pgp, g=g, h=h)

    def chain():  # the formation before K3: the einsums, the element-major copy, the packing
        coords_def = coords + disp.reshape(-1, 3)[: coords.shape[0]]
        esm_t = kernels.form_blocks_ref("tangent", coords_def, backend.elnodes, perm=eperm,
                                        **tangent)[0].contiguous()
        return esm_t, kernels.pack_blocks(esm_t)

    def form():
        return asm.operator_blocks("tangent", coords, backend.elnodes, disp=disp, perm=eperm,
                                   table=backend.element_table, diag=True, **tangent)

    def loads():
        return sysm.external_loads(coords, disp, backend.elnodes, backend.loads,
                                   backend.density, follower=True, plan=backend.node_plan)

    esm_t, packed = chain()
    glv_t = loads()[0]
    blocks = form()

    def rebuild():
        return refresh_blocks(pc, None, space.elnodes_m, space.fixmask_m, space.jacobi_plan,
                              diag=blocks.diag)

    rows = [("tangent formation, K3: the packed tiles and the compact diagonal, solve-space "
             "order", cuda_ms(form)),
            ("  K3's device time (torch.profiler, mean of 10)", device_ms(form)),
            ("tangent formation, the plain chain (the einsums, the element-major copy, "
             "pack_blocks) [median of 5]", cuda_ms(chain, runs=5)),
            ("block-Jacobi rebuild, K5 on the compact diagonal", cuda_ms(rebuild)),
            ("  K5's device time (torch.profiler, mean of 10)", device_ms(rebuild)),
            ("block-Jacobi rebuild, the plain chain (the diagonal slice, K8, the torch tail)",
             cuda_ms(lambda: kernels.jacobi_inverse_ref(esm_t, space.jacobi_plan,
                                                        space.fixmask_m)))]
    op = sysm.make_operator(blocks, space)

    def rhs():  # in user dof order, as the refresh returns it without the predictor
        return space.from_m(asm.dirichlet_rhs(op.esm_t, space.eldofs_m, space.fixmask_m,
                                              space.to_m(backend.u_fix), space.to_m(glv_t),
                                              space.incidence, op.packed))

    rows += [("follower loads (pressure and gravity on the deformed geometry)", cuda_ms(loads)),
             ("the right-hand side (K1 on the tangent's tiles)", cuda_ms(rhs))]

    def refresh():
        return backend.tangent_refresh(coords, sig, pgp, disp, pc, et_e, solve_predictor=False)

    rows.append(("whole refresh without the predictor solve [median of 5]",
                 cuda_ms(refresh, runs=5)))
    del esm_t, packed, blocks
    counted = kernels.form_blocks.launches, kernels.jacobi_inverse.launches
    port, other = kernel_launches(refresh, calls=calls)
    counted = (kernels.form_blocks.launches - counted[0],
               kernels.jacobi_inverse.launches - counted[1])
    allowed = Counter()
    for piece in (loads, rhs):
        allowed.update(sum(kernel_launches(piece, calls=calls), Counter()))
    print(f"profile of {calls} refreshes without the predictor, totals: the port's kernels "
          f"{dict(port)}; every other kernel {dict(other)}; those the follower loads and the "
          f"right-hand side launch on their own over as many calls: {dict(allowed)}; K3's and "
          f"K5's wrappers counted {counted}")

    def per_call(totals):
        return {k: -(-n // calls) for k, n in totals.items()}

    allowed_call = per_call(allowed)
    beyond = {k: n for k, n in per_call(port + other).items()
              if k not in ("form_blocks_kernel", "jacobi_kernel") and n > allowed_call.get(k, 0)}
    check(counted == (calls, calls), f"phase 8b: {calls} refreshes launched K3 and K5 {counted} "
          f"times")
    check(min(port["form_blocks_kernel"], port["jacobi_kernel"]) >= calls - 1,
          f"phase 8b: the profile of {calls} refreshes recorded K3 {port['form_blocks_kernel']} "
          f"and K5 {port['jacobi_kernel']} times")
    check(not beyond, f"phase 8b: a refresh launched kernels beyond K3, K5, the follower "
          f"loads' and the right-hand side's (a call's): {beyond}")
    del op
    prev = backend.tangent_refresh(coords, sig, pgp, 0.95 * disp, pc, et_e)[3]
    khat, pc_t, _, rhs_t, _ = refresh()
    for name, x0 in (("cold", None), ("warm", prev)):
        iters = backend.solve(khat, pc_t, rhs_t, x0=x0).iters
        rows.append((f"predictor solve, {name}: {iters} CG iterations [median of 3]",
                     cuda_ms(lambda: backend.solve(khat, pc_t, rhs_t, x0=x0), runs=3)))
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
    return dict(rows) | {"profile totals": dict(port + other), "profile calls": calls,
                         "wrapper launches": counted}


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
    stats = cg_stats_reset()
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
    print(f"CG loop: {cg_loop_line(stats, res.cg_stats['iters'], res.cg_stats['time'])}")
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
    k6_two_passes(launches, stats, label)
    return dict(lines=lines, cg_stats=res.cg_stats, res=res,
                stepping=t["stepping"], step_iters=step_iters, step_solves=step_solves,
                launches=launches, by_dtype=by_dtype, lbd=lbd,
                loop=None if stats is None else dict(stats))


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


def dense_coarse(coarse):
    """The dense coarse inverse that a plain version or a library call
    reads (``kernels.dense_coarse``: a packed copy's mirrored tiles); a
    tree from before K4c keeps it dense."""
    from fcvm_tpu_torch.ops import kernels

    return kernels.dense_coarse(coarse) if hasattr(kernels, "dense_coarse") else coarse


def built_coarse(be, op, pc):
    """The dense coarse inverse as the two-level build computes it before it
    packs it: the coarse table of the operator ``op``'s blocks on pc's
    modes, inverted with the ridge ladder; a tree from before K4c keeps it
    in pc as it is."""
    from fcvm_tpu_torch.ops import kernels, precond

    if not hasattr(kernels, "PackedCoarse"):
        return pc.coarse_inv
    sp = be.space
    ncl = pc.coarse_inv.shape[0] // pc.qmat.shape[2]
    kc = precond.coarse_accumulate(op.esm_t.permute(2, 0, 1).contiguous(), sp.elnodes_m,
                                   pc.qmat, pc.qmat.shape[0] // ncl)
    return precond.invert_coarse_with_ladder(kc)


def coarse_rows(be, op, pc, dtype, tol, widths, vector, gen, label):
    """K4c alone (``coarse_product`` on a vector when ``vector``, else on
    blocks at each of ``widths``) on pc's packed coarse inverse,
    against its plain version (the mirrored tiles' dense product) and,
    timed, against the library call on the build's dense inverse
    (``torch.mv`` / ``torch.mm``), bit for bit against a second call; its
    bound counts the stored triangle, n (n + 1) / 2 values.  The dense
    inverse's asymmetry ``max |A - A^T| / max |A|`` and the product's error
    against it.  A tree from before K4c times its coarse product, cuBLAS's
    on the dense inverse.  Returns ``{m: numbers}``."""
    from fcvm_tpu_torch.ops import kernels

    size = torch.finfo(dtype).bits // 8
    ncf = pc.coarse_inv.shape[0]
    dense = built_coarse(be, op, pc)
    asym = float((dense - dense.T).abs().max() / dense.abs().max())
    new = hasattr(kernels, "PackedCoarse")
    mirrored = dense_coarse(pc.coarse_inv)
    same_pack = bool(torch.equal(kernels.pack_coarse(dense).tiles, pc.coarse_inv.tiles)) if new \
        else None
    rows = {}
    for m in widths:
        x = torch.randn((ncf,) if vector else (ncf, m), generator=gen, device="cuda", dtype=dtype)
        lib = torch.mv if vector else torch.mm
        fn, ref_fn = (kernels.coarse_product, kernels.coarse_product_ref) if new else (None, None)
        if new:
            out, again = fn(pc.coarse_inv, x), fn(pc.coarse_inv, x)
        else:  # the tree's coarse product: cuBLAS on the dense inverse
            out, again = lib(dense, x), lib(dense, x)
        torch.cuda.synchronize()
        plain, full = lib(mirrored, x), lib(dense, x)
        abs_err = float((out - plain).abs().max())
        rel = abs_err / float(plain.abs().max())
        rel_dense = float((out - full).abs().max()) / float(full.abs().max())
        same = bool(torch.equal(out, again))
        del out, again, plain, full
        row = dict(m=m, max_abs_err=abs_err, rel_err=rel, rel_err_vs_dense=rel_dense,
                   coarse_asymmetry=asym, same_bits=same, packed_is_the_builds=same_pack,
                   ms=cuda_ms(fn, pc.coarse_inv, x) if new else cuda_ms(lib, dense, x),
                   plain_ms=cuda_ms(ref_fn, pc.coarse_inv, x) if new else None,
                   library_ms=cuda_ms(lib, dense, x))
        nbytes = (ncf * (ncf + 1) // 2 + 2 * ncf * m) * size
        row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * ncf * ncf * m, dtype)
        print(f"K4c {label} m={m}: coarse {ncf}; max rel err {rel:.3e} against its plain "
              f"version (limit {tol:g}), {rel_dense:.3e} against the build's dense inverse "
              f"(its max |A - A^T| / max |A| {asym:.3e}; the packed copy the build's: "
              f"{same_pack}), second call {'the same bits' if same else 'DIFFERENT BITS'}; "
              f"{'K4c' if new else 'this tree: cuBLAS on the dense inverse'} {row['ms']:.4f} ms, "
              f"{lib.__name__} of the dense inverse {row['library_ms']:.4f} ms; bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}, the triangle), "
              f"{row['bound_ms'] / row['ms']:.1%} of it; median of 20")
        if new:
            check(rel <= tol, f"K4c disagrees with its plain version ({label}, m={m})")
            check(same, f"K4c gave other bits on a second call ({label}, m={m})")
        rows[m] = row
        del x
    del dense, mirrored
    return rows


def cg_kernel_phase(models):
    """Phase 3c: K1 (masked and raw) on the operators of ``models`` (name ->
    model: the plate and the beam-column) and K4 (block Jacobi and the
    cluster smoother's output) on the plate's preconditioner, float32 and
    float64, against their plain versions on a seeded vector (K1 also bit
    for bit against a second call); CUDA-event medians of each, of its
    plain version, of the chain K1 replaced and of cuSPARSE's CSR matvec of
    the assembled K_hat; the blocks' asymmetry and the packed copy's size.
    Returns ``{(kernel, dtype, model, variant): numbers}``."""
    from fcvm_tpu_torch import FcvmConfig
    from fcvm_tpu_torch.ops import kernels
    from fcvm_tpu_torch.runtime.backend import TorchSystem

    rows = {}
    for dtype, tol in ((torch.float32, TOL_F32), (torch.float64, TOL_F64)):
        dname, size = str(dtype).removeprefix("torch."), torch.finfo(dtype).bits // 8
        for name, model in models.items():
            cfg = FcvmConfig(device="cuda", dtype=dname)
            be = TorchSystem(model, cfg, dtype, torch.device("cuda"))
            op, pinv, *_ = be.assemble_operator(be.tensor(model.mesh.coords))
            esm = op.esm_t.permute(2, 0, 1)
            asym = float((esm - esm.transpose(1, 2)).abs().max() / esm.abs().max())
            del esm
            sp = be.space
            esm_t, packed = op.esm_t, op.packed
            ne, nn = esm_t.shape[2], be.ndof_pad // 3
            print(f"{name} {dname}: blocks' max |K - K^T| / max |K| = {asym:.3e}; packed copy "
                  f"{tuple(packed.shape)}, {packed.numel() * size / 1e9:.4f} GB against the "
                  f"full blocks' {esm_t.numel() * size / 1e9:.4f} GB")
            gen = torch.Generator(device="cuda").manual_seed(7)
            u = torch.randn(be.ndof_pad, generator=gen, device="cuda", dtype=dtype)
            eldofs_t = sp.eldofs_m.T.contiguous()
            kcsr = assembled_khat(esm_t, sp.eldofs_m, sp.fixmask_m)

            def k1(fm):
                return kernels.khat_matvec(packed, sp.incidence, u, fm)

            for form in ("masked", "raw"):
                fm = sp.fixmask_m if form == "masked" else None
                out, again = k1(fm), k1(fm)
                torch.cuda.synchronize()
                ref = kernels.khat_matvec_packed_ref(packed, sp.incidence, u, fm)
                full = kernels.khat_matvec_ref(esm_t, sp.incidence, u, fm)
                abs_err = float((out - ref).abs().max())
                rel = abs_err / float(ref.abs().max())
                rel_full = float((out - full).abs().max()) / float(full.abs().max())
                same = bool(torch.equal(out, again))
                row = dict(max_abs_err=abs_err, ms=cuda_ms(k1, fm),
                           plain_ms=cuda_ms(kernels.khat_matvec_packed_ref, packed,
                                            sp.incidence, u, fm),
                           chain_ms=cuda_ms(k0_chain, esm_t, eldofs_t, u, fm), library_ms=None,
                           block_asymmetry=asym, rel_err_vs_full_blocks=rel_full)
                # the packed upper triangles, the node table and pos, offsets,
                # u (and the mask) read once, the result written once
                nvec = 2 if fm is None else 3
                nbytes = (465 * size + 80) * ne + 4 * (nn + 1) + nvec * 3 * nn * size
                row["bound_ms"], row["bound_by"] = bound(nbytes, 1830 * ne, dtype)
                lib = ""
                if fm is not None:
                    row["library_ms"] = cuda_ms(torch.mv, kcsr, u)
                    lib_err = float((torch.mv(kcsr, u) - full).abs().max()) / float(full.abs().max())
                    lib = (f", cuSPARSE CSR matvec ({kcsr.values().numel()} stored values) "
                           f"{row['library_ms']:.4f} ms (its max rel err {lib_err:.2e})")
                print(f"K1 {dname} {name} ne={ne} {form}: max rel err {rel:.3e} (limit {tol:g}; "
                      f"{rel_full:.3e} against the full blocks), second call "
                      f"{'the same bits' if same else 'DIFFERENT BITS'}; kernel "
                      f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, the chain it "
                      f"replaced (gather, K0, index_add_, masks) {row['chain_ms']:.4f} ms{lib}; "
                      f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                      f"{row['bound_ms'] / row['ms']:.1%} of it; median of 20")
                check(rel <= tol, f"K1 disagrees with its plain version ({dname}, {name}, {form})")
                check(same, f"K1 gave other bits on a second call ({dname}, {name}, {form})")
                rows[("khat_matvec", dname, name, form)] = dict(ne=ne, **row)
                del out, again, ref, full
            del kcsr, u, eldofs_t, packed
            if name != "plate":
                del be, op, pinv, esm_t
                torch.cuda.empty_cache()
                continue
            r = torch.randn(be.ndof_pad, generator=gen, device="cuda", dtype=dtype)
            coarse = None
            for fine in ("jacobi3", "cluster"):
                be.cfg = FcvmConfig(device="cuda", dtype=dname, smoother=fine)
                pc = be.operator_pc(op, pinv)
                check((pc.smooth_inv is not None) == (fine == "cluster"),
                      f"phase 3c: the {fine} preconditioner was not built")
                if coarse is None:  # K4c alone, on the coarse inverse of either build
                    (coarse,) = coarse_rows(be, op, pc, dtype, tol, (1,), True, gen,
                                            f"{dname} {name}").values()
                z_fine = None if fine == "jacobi3" else pc.fine(r)
                args = (pc.pinv, pc.qmat, pc.coarse_inv, pc.fixmask, r, z_fine)
                # the plain version on the mirrored tiles, unpacked once
                ref_args = (pc.pinv, pc.qmat, dense_coarse(pc.coarse_inv), pc.fixmask, r, z_fine)
                out = kernels.two_level_apply(*args)
                again = kernels.two_level_apply(*args)
                torch.cuda.synchronize()
                ref = kernels.two_level_apply_ref(*ref_args)
                abs_err = float((out - ref).abs().max())
                rel = abs_err / float(ref.abs().max())
                same = bool(torch.equal(out, again))
                nm, nn_cl, ncf = pc.qmat.shape[2], pc.qmat.shape[0], pc.coarse_inv.shape[0]
                # the coarse inverse's stored triangle once, qmat twice, pinv
                # (block Jacobi), r, the mask, z (and z_fine) once each
                nbytes = (3 * nm * nn_cl + ncf * (ncf + 1) // 2
                          + (9 if z_fine is None else 3) * nn + 9 * nn) * size
                row = dict(max_abs_err=abs_err, ms=cuda_ms(kernels.two_level_apply, *args),
                           plain_ms=cuda_ms(kernels.two_level_apply_ref, *ref_args),
                           apply_ms=cuda_ms(pc.apply, r), library_ms=None,
                           coarse_ms=coarse["ms"], coarse_library_ms=coarse["library_ms"],
                           coarse_bound_ms=coarse["bound_ms"],
                           coarse_asymmetry=coarse["coarse_asymmetry"],
                           coarse_rel_err_vs_dense=coarse["rel_err_vs_dense"])
                row["bound_ms"], row["bound_by"] = bound(
                    nbytes, 2 * ncf * ncf + 12 * nm * nn + 18 * nn, dtype)
                print(f"K4 {dname} {name} {fine}: coarse {ncf} = {nm} x {ncf // nm} clusters of "
                      f"{nn_cl // (ncf // nm)} nodes; max rel err {rel:.3e} (limit {tol:g}), "
                      f"second call {'the same bits' if same else 'DIFFERENT BITS'}; kernel "
                      f"{row['ms']:.4f} ms (its coarse product alone {row['coarse_ms']:.4f} ms, "
                      f"torch.mv of the dense inverse {row['coarse_library_ms']:.4f} ms), "
                      f"plain {row['plain_ms']:.4f} ms, the whole apply (with the fine level) "
                      f"{row['apply_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms "
                      f"({row['bound_by']}, the stored triangle), "
                      f"{row['bound_ms'] / row['ms']:.1%} of it; median of 20")
                check(rel <= tol, f"K4 disagrees with its plain version ({dname}, {fine})")
                check(same, f"K4 gave other bits on a second call ({dname}, {fine})")
                rows[("two_level_apply", dname, name, fine)] = dict(nn=nn, **row)
                del pc, out, again, ref, args, ref_args, z_fine
            del be, op, pinv, esm_t, r
            torch.cuda.empty_cache()
    return rows


def _bits(t):
    """A float tensor's bits as integers, so -0 and 0 differ."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def old_multi_matvec(esm_t, eldofs, fixmask, identity_on_fixed=True, negate=False):
    """The K_hat·V (or, projected and negated, -G_hat·V) the eigensolve ran
    before K1m: the node-row gather of ``P U``, K0m, K8's write form over
    the elements' plan and the masks."""
    from fcvm_tpu_torch.ops import kernels

    elnodes = eldofs[:, ::3] // 3
    ne, nn = elnodes.shape[0], fixmask.shape[0] // 3
    plan = kernels.segment_plan(elnodes, rows=nn)
    pm = fixmask[:, None]

    def mv(u):
        m = u.shape[1]
        ue = (pm * u).reshape(nn, 3, m)[elnodes].reshape(ne, 30, m)
        out = kernels.segment_sum(kernels.block_matmat(esm_t, ue).reshape(ne * 10, 3, m), plan,
                                  rows=nn)
        y = pm * out.reshape(nn * 3, m)
        if identity_on_fixed:
            y = y + (1.0 - pm) * u
        return -y if negate else y

    return mv


# the widths at which the paths launch K1m (K0m's before it): K0M_SHAPES by model
K1M_WIDTHS = {"column": tuple(m for ne, m in K0M_SHAPES if ne == NE_COL),
              "plate": tuple(m for ne, m in K0M_SHAPES if ne == NE_BIG)}
K4M_WIDTHS = (1, 2, 3, 4, 5, 6, 7, 8)  # the eigensolve's block of 8 and its tails
# form -> (with fixmask, identity_on_fixed, negate): K_hat·V, -G_hat·V, the raw K·V
K1M_FORMS = {"masked": (True, True, False), "projected_negated": (True, False, True),
             "raw": (False, False, False)}


def block_kernel_phase(models):
    """Phase 3d: K1m in each form on the operators of ``models`` (the plate
    at its deflation width, the beam-column at every width of its
    eigensolve and deflation) and K4m (block Jacobi and the cluster
    smoother's output) on the beam-column's preconditioner at the widths of
    its block solves, float32 and float64, against their plain versions on
    seeded blocks, each bit for bit against a second call; CUDA-event
    medians of each, of its plain version, of the chain it replaced (K1m:
    gather, K0m, K8, masks; K4m: the torch steps, which are its plain
    version), K4m against m applies of K4 and, for K1m's K_hat·V, against
    cuSPARSE's CSR product (``torch.sparse.mm``) of the assembled K_hat.
    Returns ``{(kernel, dtype, model, variant, m): numbers}``."""
    from fcvm_tpu_torch import FcvmConfig
    from fcvm_tpu_torch.ops import kernels
    from fcvm_tpu_torch.runtime.backend import TorchSystem

    rows = {}
    for dtype, tol in ((torch.float32, TOL_F32), (torch.float64, TOL_F64)):
        dname, size = str(dtype).removeprefix("torch."), torch.finfo(dtype).bits // 8
        for name, model in models.items():
            be = TorchSystem(model, FcvmConfig(device="cuda", dtype=dname), dtype,
                             torch.device("cuda"))
            op, pinv, *_ = be.assemble_operator(be.tensor(model.mesh.coords))
            sp = be.space
            esm_t, packed, inc, fm = op.esm_t, op.packed, sp.incidence, sp.fixmask_m
            ne, nn = esm_t.shape[2], be.ndof_pad // 3
            kcsr = assembled_khat(esm_t, sp.eldofs_m, fm)
            gen = torch.Generator(device="cuda").manual_seed(13)
            # K1m's plan of each form's operator, made once as the paths make it
            # (a tree from before the plans calls the kernel without one)
            planned = hasattr(kernels, "khat_matmat_plan")
            plans = {masked: kernels.khat_matmat_plan(packed, inc, fm if masked else None)
                     for masked in (True, False)} if planned else {}
            share = None
            if planned:
                share = inc.k1m.node_rows.shape[0] / (10 * ne)
                print(f"K1m's compacted element rows on the {name}: "
                      f"{inc.k1m.node_rows.shape[0]} of 10 ne = {10 * ne}, a share of "
                      f"{share:.4f} (sub-tiles of {kernels.K1M_SUB} elements)")
            for m in K1M_WIDTHS[name]:
                u = torch.randn((be.ndof_pad, m), generator=gen, device="cuda", dtype=dtype)
                for form, (masked, ident, neg) in K1M_FORMS.items():
                    f = fm if masked else None
                    args = (packed, inc, u, f, ident, neg)
                    kargs = args + ((plans[masked],) if planned else ())
                    out, again = kernels.khat_matmat(*kargs), kernels.khat_matmat(*kargs)
                    torch.cuda.synchronize()
                    ref = kernels.khat_matmat_packed_ref(*args)
                    abs_err = float((out - ref).abs().max())
                    rel = abs_err / float(ref.abs().max())
                    same = bool(torch.equal(out, again))
                    if planned:  # a call that makes its own plan gives the same bits
                        same = same and bool(torch.equal(kernels.khat_matmat(*args), out))
                    row = dict(max_abs_err=abs_err, ms=cuda_ms(kernels.khat_matmat, *kargs),
                               plain_ms=None, chain_ms=None, library_ms=None,
                               fe_rows_share=share)
                    if planned and name == "column" and m == 8 and form != "projected_negated":
                        # each column K1's bits (the same entries and adds in the same order)
                        cols = [kernels.khat_matvec(packed, inc, u[:, c].contiguous(), f)
                                for c in range(m)]
                        k1_bits = all(torch.equal(_bits(out[:, c].contiguous()), _bits(col))
                                      for c, col in enumerate(cols))
                        print(f"K1m {dname} {name} m={m} {form}: each column K1's bits "
                              f"{'yes' if k1_bits else 'NO'}")
                        check(k1_bits, f"K1m's columns are not K1's bits ({dname}, {form})")
                        row["k1_bits"] = k1_bits
                        del cols
                    del out, again, ref
                    # the packed blocks, the node table, pos and offsets, U (and
                    # the mask) read once, Y written once
                    nbytes = ((465 * size + 80) * ne + 4 * (nn + 1)
                              + (2 * m + (1 if masked else 0)) * 3 * nn * size)
                    row["bound_ms"], row["bound_by"] = bound(nbytes, 1830 * ne * m, dtype)
                    extra = ""
                    if form == "masked":
                        chain = old_multi_matvec(esm_t, sp.eldofs_m, fm)
                        row.update(plain_ms=cuda_ms(kernels.khat_matmat_packed_ref, *args),
                                   chain_ms=cuda_ms(chain, u),
                                   library_ms=cuda_ms(torch.sparse.mm, kcsr, u),
                                   passes_ms=device_ms_by_kernel(kernels.khat_matmat, *kargs))
                        del chain
                        extra = (f"; device time by pass " + ", ".join(
                            f"{k} {v:.4f} ms" for k, v in row["passes_ms"].items())
                            + f"; plain {row['plain_ms']:.4f} ms, the chain it replaced "
                            f"(gather, K0m, K8, masks) {row['chain_ms']:.4f} ms, cuSPARSE "
                            f"CSR product {row['library_ms']:.4f} ms")
                    print(f"K1m {dname} {name} ne={ne} m={m} {form}: max rel err {rel:.3e} "
                          f"(limit {tol:g}), second call "
                          f"{'the same bits' if same else 'DIFFERENT BITS'}; kernel "
                          f"{row['ms']:.4f} ms{extra}; bound {row['bound_ms']:.4f} ms "
                          f"({row['bound_by']}), {row['bound_ms'] / row['ms']:.1%} of it; "
                          "median of 20")
                    check(rel <= tol, f"K1m disagrees with its plain version ({dname}, {name}, "
                                      f"m={m}, {form})")
                    check(same, f"K1m gave other bits on a second call ({dname}, {name}, m={m}, "
                                f"{form})")
                    rows[("khat_matmat", dname, name, form, m)] = dict(ne=ne, **row)
                del u
            del kcsr, packed, plans
            if name != "column":
                del be, op, pinv, esm_t
                torch.cuda.empty_cache()
                continue
            coarse = None
            for fine in ("jacobi3", "cluster"):
                be.cfg = FcvmConfig(device="cuda", dtype=dname, smoother=fine)
                pc = be.operator_pc(op, pinv)
                check((pc.smooth_inv is not None) == (fine == "cluster"),
                      f"phase 3d: the {fine} preconditioner was not built")
                if coarse is None:  # K4c alone at each width
                    coarse = coarse_rows(be, op, pc, dtype, tol, K4M_WIDTHS, False, gen,
                                         f"{dname} {name}")
                nm, nn_cl, ncf = pc.qmat.shape[2], pc.qmat.shape[0], pc.coarse_inv.shape[0]
                mirrored = dense_coarse(pc.coarse_inv)  # the plain version's, unpacked once
                for m in K4M_WIDTHS:
                    r = torch.randn((be.ndof_pad, m), generator=gen, device="cuda", dtype=dtype)
                    z_fine = None if fine == "jacobi3" else pc.fine(r)
                    args = (pc.pinv, pc.qmat, pc.coarse_inv, pc.fixmask, r, z_fine)
                    ref_args = (pc.pinv, pc.qmat, mirrored, pc.fixmask, r, z_fine)
                    out = kernels.two_level_apply_block(*args)
                    again = kernels.two_level_apply_block(*args)
                    torch.cuda.synchronize()
                    ref = kernels.two_level_apply_block_ref(*ref_args)
                    abs_err = float((out - ref).abs().max())
                    rel = abs_err / float(ref.abs().max())
                    same = bool(torch.equal(out, again))
                    del out, again, ref
                    # the coarse inverse's stored triangle once, qmat twice, pinv
                    # (block Jacobi), the mask, r and z (and z_fine) once each
                    nbytes = (ncf * (ncf + 1) // 2 + 6 * nm * nn_cl
                              + (9 * nn if z_fine is None else 0)
                              + 3 * nn + (2 if z_fine is None else 3) * 3 * nn * m) * size
                    row = dict(max_abs_err=abs_err,
                               ms=cuda_ms(kernels.two_level_apply_block, *args),
                               plain_ms=cuda_ms(kernels.two_level_apply_block_ref, *ref_args),
                               apply_ms=cuda_ms(pc.apply, r),
                               vectors_ms=cuda_ms(lambda: [pc.apply(r[:, c]) for c in range(m)]),
                               library_ms=None, coarse_ms=coarse[m]["ms"],
                               coarse_library_ms=coarse[m]["library_ms"],
                               coarse_bound_ms=coarse[m]["bound_ms"],
                               coarse_asymmetry=coarse[m]["coarse_asymmetry"],
                               coarse_rel_err_vs_dense=coarse[m]["rel_err_vs_dense"])
                    row["bound_ms"], row["bound_by"] = bound(
                        nbytes, (2 * ncf * ncf + 12 * nm * nn + 18 * nn) * m, dtype)
                    print(f"K4m {dname} {name} {fine} m={m}: coarse {ncf} = {nm} x {ncf // nm} "
                          f"clusters; max rel err {rel:.3e} (limit {tol:g}), second call "
                          f"{'the same bits' if same else 'DIFFERENT BITS'}; kernel "
                          f"{row['ms']:.4f} ms (its coarse product alone "
                          f"{row['coarse_ms']:.4f} ms, torch.mm of the dense inverse "
                          f"{row['coarse_library_ms']:.4f} ms), plain (the chain it replaced) "
                          f"{row['plain_ms']:.4f} ms; the whole apply (fine level included) "
                          f"{row['apply_ms']:.4f} ms, {m} vector applies (K4) "
                          f"{row['vectors_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms "
                          f"({row['bound_by']}, the stored triangle), "
                          f"{row['bound_ms'] / row['ms']:.1%} of it; median of 20")
                    check(rel <= tol, f"K4m disagrees with its plain version ({dname}, {fine}, "
                                      f"m={m})")
                    check(same, f"K4m gave other bits on a second call ({dname}, {fine}, m={m})")
                    rows[("two_level_apply_block", dname, name, fine, m)] = dict(nn=nn, **row)
                    del r, z_fine, args, ref_args
                del pc, mirrored
            del be, op, pinv, esm_t
            torch.cuda.empty_cache()
    return rows


K6_BATCHES = (1, 2, 4, 8, 16, 32)  # the CG_BATCH sweep of phase 3e
# the paths' forms: the plate's vectors, the eigensolve's block at m = 8 and
# at the widths its block solves drop to as their columns finish
K6_CASES = (("plate", torch.float32, "vector"), ("plate", torch.float64, "vector"),
            ("plate", torch.float32, "deflated"), ("plate", torch.float32, "m=1 deflated"),
            ("plate", torch.float32, "harvest"),
            ("column", torch.float32, "m=8"), ("column", torch.float64, "m=8"),
            *(("column", torch.float32, f"m={m}") for m in (7, 6, 5, 4, 3, 2)),
            *(("column", dtype, f"m={m} deflated") for dtype in (torch.float32, torch.float64)
              for m in (8, 7, 6, 5, 4, 3, 2)))
# deflation vectors: the plate's (the driver's space; its m = 1 block form
# beside the vector form), the beam-column's (the eigensolve's)
K6_KD = {"plate": 32, "column": 64}


def k6_form(name, form):
    """(m (0: a vector), kd, harvest) of a ``K6_CASES`` model and form."""
    m = int(form[2:].split()[0]) if form.startswith("m=") else 0
    kd = K6_KD[name] if form.endswith("deflated") else 0
    return m, kd, form == "harvest"


def k6_inputs(n, m, dtype, defl=False, harvest=False, seed=16, kd=32, held=False):
    """A K6 plan of n rows (a vector for m = 0, else m columns) mid-solve on
    the card, and seeded x, r, p and v: a running state that stays running
    (no tolerance, gate or iteration cap in reach), every third column of a
    block frozen; with ``defl`` a ``kd``-vector space, with ``harvest`` 64
    slots.  W c is of the size of z / sqrt(n), so the iterates stay finite
    however many passes are timed; with ``held``, of the size of z itself,
    so a direction pass's W c is held through p to the tolerance of z."""
    from fcvm_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def vec(*shape):
        return torch.randn(shape or ((n,) if m == 0 else (n, m)), generator=gen,
                           device="cuda", dtype=dtype)

    dfl = hv = None
    if defl:  # W c ~ |W|^2 kd sqrt(n) |r|: a scale of W for each of the two sizes
        a = torch.randn((kd, kd), generator=gen, device="cuda", dtype=dtype)
        scale = 2.0 / math.sqrt(kd * math.sqrt(n)) if held else 1.0 / math.sqrt(n)
        dfl = (vec(n, kd) * scale, a @ a.T / kd)
    if harvest:
        hv = (torch.zeros((64, n), dtype=dtype, device="cuda"),
              torch.zeros((3, 64), dtype=dtype, device="cuda"))
    plan = kernels.cg_plan(vec(), 0.0, 0.0, 1e15, 1e15, dfl, hv)
    if defl:  # a c before any pass
        plan.c.copy_(vec(*plan.c.shape))
    st, cols = plan.state, plan.state.shape[0]
    st[:, kernels.SLOT_RZ] = float(n)
    st[:, kernels.SLOT_ALPHA] = 0.25
    st[:, kernels.SLOT_BETA] = 0.5
    st[:, kernels.SLOT_K] = 70.0  # past the harvest's 64 slots: the clamped slot
    st[:, kernels.SLOT_BEST] = 1e30
    run = torch.ones(cols, dtype=torch.float64, device="cuda")
    if cols > 1:
        run[::3] = 0.0
    st[:, kernels.SLOT_RUN] = run
    st[:, kernels.SLOT_NEXT] = run
    # x, r, p and v near one vector, so no inner product cancels: each sum
    # is then held to the tolerance of its own size
    base = vec()
    return plan, [base + 0.1 * vec() for _ in range(4)]


def k6_compare(plan, vecs):
    """Each of K6's two passes (and their start forms) on copies of ``plan``
    and ``vecs``, kernel against plain version, the direction pass on the
    partials an update pass's start form leaves: (the max relative and
    absolute errors of the sums and what follows from them, and of a
    deflated direction; whether the counters and flags, the harvest's
    residuals and x, r and p agree bit for bit, x, r and p with what the
    plain version's updates make of the inputs with the kernel's own step
    lengths, z is left unwritten, and a second launch repeats the first's
    bits)."""
    from fcvm_tpu_torch.ops import kernels

    near = [kernels.SLOT_RZ, kernels.SLOT_ALPHA, kernels.SLOT_BETA, kernels.SLOT_RNORM,
            kernels.SLOT_BEST, kernels.SLOT_TOL, kernels.SLOT_GATE]
    exact = [i for i in range(len(kernels.CG_SLOTS)) if i not in near]
    rel, abs_err, same = 0.0, 0.0, True

    def err(a, b):
        nonlocal abs_err
        diff = float((a - b).abs().max())
        abs_err = max(abs_err, diff)
        return diff / max(float(b.abs().max()), 1e-300)

    for start in (False, True):
        for step in (0, 1):
            base, vin = plan.copy(), [v.clone() for v in vecs]
            if step == 1:  # the partials of r, as the update pass leaves them
                kernels.cg_iteration(0, base, *vin, start=True)
            (pk, vk), (pk2, vk2), (pr, vr) = ((base.copy(), [v.clone() for v in vin])
                                             for _ in range(3))
            kernels.cg_iteration(step, pk, *vk, start=start)
            kernels.cg_iteration(step, pk2, *vk2, start=start)
            torch.cuda.synchronize()
            kernels.cg_iteration_ref(step, start, pr, *vr)
            rows = pk.state.tolist()
            run = [bool(row[kernels.SLOT_RUN]) for row in rows]
            alpha = [row[kernels.SLOT_ALPHA] for row in rows]
            x, r, p, z = (t.clone() for t in vin)
            if step == 0 and not start and any(run):
                kernels.cg_update_r(r, z, alpha, run)
            elif step == 1 and start:
                p.copy_(z)
            elif step == 1 and any(run):
                kernels.cg_update_direction(x, p, z, alpha,
                                            [row[kernels.SLOT_BETA] for row in rows], run)
            deflated = plan.w is not None and step == 1
            for i, (a, want) in enumerate(zip(vk, (x, r, p, vin[3]))):
                if deflated and i == 2:
                    rel = max(rel, err(a, vr[2]))
                else:
                    same &= bool(torch.equal(a, want))
            for slot in near:  # each scalar against its own size
                rel = max(rel, err(pk.state[:, slot], pr.state[:, slot]))
            same &= bool(torch.equal(pk.state[:, exact], pr.state[:, exact]))
            if deflated:
                rel = max(rel, err(pk.c, pr.c))
            elif plan.w is not None and getattr(plan, "block", False):  # the update pass's c
                rel = max(rel, err(pk.c, pk.kw_inv @ (pk.w.T @ vk[1])))
            if plan.zs is not None:
                same &= bool(torch.equal(pk.zs, pr.zs))
                rel = max(rel, err(pk.coef, pr.coef))
            same &= bool(torch.equal(pk.state, pk2.state)) and all(
                torch.equal(a, b) for a, b in zip(vk, vk2))
            del base, vin, pk, vk, pk2, vk2, pr, vr
    return rel, abs_err, same


def k6_chain(plan, vecs):
    """The torch chain K6 replaced, one iteration of the parent's loop on the
    same vectors: the inner products, the step length and direction update
    with their zero guards, the three updates, the norms and their read on
    the host."""
    from fcvm_tpu_torch.ops import kernels

    x, r, p, v = vecs
    rows = plan.state.shape[0]
    rz = plan.state[:, kernels.SLOT_RZ].to(x.dtype)
    if x.dim() == 1:
        rz = rz[0]

    def dot(a, b):
        return torch.dot(a, b) if a.dim() == 1 else (a * b).sum(dim=0)

    def one():
        pap = dot(p, v)
        alpha = rz / torch.where(pap == 0.0, torch.ones_like(pap), pap)
        xn, rn = x + alpha * p, r - alpha * v
        rz_new = dot(rn, v)
        beta = rz_new / torch.where(rz == 0.0, torch.ones_like(rz), rz)
        pn = v + beta * p
        norms = torch.linalg.vector_norm(rn, dim=0 if rows > 1 else None)
        return xn, pn, norms.cpu()

    return one


def k6_times(models, compare=True, skip_missing=False):
    """K6 (``cg_iteration``) on the plate's vectors (float32 and float64;
    float32 with a 32-vector deflation space and with a 64-slot harvest)
    and the beam-column's block at m = 2 to 8 (float32; float64 at m = 8),
    deflated by 64 vectors at m = 2 to 8 (float32, float64): with
    ``compare``, each pass and its start form against its plain version
    (``k6_compare``); one iteration's passes (as many as the tree's
    ``CG_PASSES``) timed with CUDA events and each pass's device time
    (torch.profiler), against their plain versions, their bound, the torch
    chain they replaced and (deflated) the deflation's three torch products
    (the parent design's times: ``tools/turns.py TREE k6``, which sets
    ``skip_missing``, so a tree whose plan refuses a form skips it; else a
    refused form fails).  The comparison runs on inputs whose W c is of the
    size of z (``k6_inputs``'s ``held``), the timings on their own.  Returns
    ``{(dtype, model, form): numbers}``."""
    from fcvm_tpu_torch.ops import kernels
    from fcvm_tpu_torch.utils.indexing import pad_ndof

    rows = {}
    passes = len(kernels.CG_PASSES)
    for name, dtype, form in K6_CASES:
        dname, size = str(dtype).removeprefix("torch."), torch.finfo(dtype).bits // 8
        tol = TOL_F32 if dtype == torch.float32 else TOL_F64
        n = pad_ndof(models[name].mesh.ndof)
        m, kd, harvest = k6_form(name, form)
        try:
            plan, vecs = k6_inputs(n, m, dtype, kd > 0, harvest, kd=kd or 32)
        except ValueError as err:
            if not skip_missing:
                raise
            print(f"K6 {dname} {name} {form}: not in this tree ({err})")  # an older tree's plan
            continue
        rel, abs_err, same, wc_z = None, None, None, None
        if compare:
            held = k6_inputs(n, m, dtype, kd > 0, harvest, kd=kd or 32, held=True)
            if kd:  # the size of the W c that the comparison holds, against z's
                hp, (_, hr, _, hv) = held
                wc_z = float((hp.w @ (hp.kw_inv @ (hp.w.T @ hr))).abs().max() / hv.abs().max())
                del hp, hr, hv
            rel, abs_err, same = k6_compare(*held)
            del held
        x, r, p, v = vecs

        def iteration():
            for step in range(passes):
                kernels.cg_iteration(step, plan, x, r, p, v)

        def plain():
            for step in range(passes):
                kernels.cg_iteration_ref(step, False, plan, x, r, p, v)

        ms = cuda_ms(iteration)
        row = dict(n=n, m=max(m, 1), passes=passes, max_abs_err=abs_err, max_rel_err=rel, ms=ms,
                   plain_ms=cuda_ms(plain), chain_ms=cuda_ms(k6_chain(plan, vecs)),
                   library_ms=None, grid=getattr(plan, "grid", None))
        # 10 vectors of n m values an iteration (the update: p, ap, r, r; the
        # direction: r, z, p, x, x, p); deflated W twice (and its two
        # products' 4 n kd m operations); a harvest z once more
        nvec = 10 * max(m, 1) + 2 * kd + harvest
        row["kd"], row["wc_over_z"] = kd, wc_z
        row["bound_ms"], row["bound_by"] = bound(nvec * n * size,
                                                 10 * n * max(m, 1) + 4 * n * kd * max(m, 1),
                                                 dtype)
        extra = ""
        if kd:
            w, kw_inv = plan.w, plan.kw_inv
            row["defl_products_ms"] = cuda_ms(lambda: v + w @ (kw_inv @ (w.T @ r)))
            extra = (f", the deflation's three torch products (with the add) "
                     f"{row['defl_products_ms']:.4f} ms")
        # the same pass kernels, each alone (device time, torch.profiler)
        by = device_ms_by_kernel(iteration)
        running = plan.state[:, kernels.SLOT_RUN].clone()
        iteration()
        check(torch.equal(plan.state[:, kernels.SLOT_NEXT], running)
              and bool(torch.isfinite(plan.state[:, kernels.SLOT_RNORM]).all()),
              f"K6's timed passes let a column finish or overflow ({dname}, {name}, {form}): the "
              f"times would be of idle passes")
        row["pass_device_ms"] = {k: v_ for k, v_ in by.items() if k.startswith("cg_")}
        # None where the profiler recorded no pass: not measured
        row["device_ms"] = sum(row["pass_device_ms"].values()) or None
        dev = row["device_ms"]
        dev_text, share = ("not recorded", "") if dev is None else (
            f"{dev:.4f} ms", f"{row['bound_ms'] / dev:.1%} of the device time, ")
        checked = "" if not compare else (
            f"max rel err {rel:.3e} (limit {tol:g}"
            f"{'' if wc_z is None else f'; max |W c| / max |z| {wc_z:.3f}'}), "
            f"updates, counters, flags and second launch "
            f"{'the same bits' if same else 'DIFFERENT BITS'}; ")
        print(f"K6 {dname} {name} {form} n={n} (grid {row['grid']}): {checked}{passes} passes "
              f"{ms:.4f} ms (CUDA events), device time {dev_text}; plain "
              f"{row['plain_ms']:.4f} ms (host reads of the state in each), the torch chain they "
              f"replaced {row['chain_ms']:.4f} ms{extra}; bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}, {nvec} vectors), {share}{row['bound_ms'] / ms:.1%} of the "
              f"events'; median of 20")
        print(f"  device time per pass: " + ", ".join(
            f"{k} {v_:.4f} ms" for k, v_ in sorted(row["pass_device_ms"].items())))
        if compare:
            check(wc_z is None or wc_z >= 0.1,
                  f"K6's comparison holds a W c too small against z ({dname}, {name}, {form})")
            check(rel <= tol, f"K6 disagrees with its plain version ({dname}, {name}, {form})")
            check(same, f"K6's bits differ from its plain version's or a second launch's "
                        f"({dname}, {name}, {form})")
        rows[(dname, name, form)] = row
        del plan, vecs, x, r, p, v
        torch.cuda.empty_cache()
    return rows


def k6_phase(models):
    """Phase 3e: K6 on the paths' vectors (``k6_times``), then the
    ``CG_BATCH`` sweep: one elastic solve of the plate in float32 at each
    batch, in turns.  Returns ``{(dtype, model, form): numbers, "sweep":
    ...}``."""
    from fcvm_tpu_torch import FcvmConfig
    from fcvm_tpu_torch.ops import solver as slv
    from fcvm_tpu_torch.runtime.backend import TorchSystem

    rows = k6_times(models)
    missing = [(str(dt).removeprefix("torch."), name, form) for name, dt, form in K6_CASES
               if (str(dt).removeprefix("torch."), name, form) not in rows]
    check(not missing, f"phase 3e: K6 forms without a row: {missing}")

    # CG_BATCH: one elastic solve of the plate at each batch, in turns
    big = models["plate"]
    be = TorchSystem(big, FcvmConfig(device="cuda", dtype="float32"), torch.float32,
                     torch.device("cuda"))
    khat, pinv, _, rhs, *_ = be.assemble_operator(be.tensor(big.mesh.coords))
    pc = be.operator_pc(khat, pinv)
    del pinv
    be.solve(khat, pc, rhs, x0=be.u_fix)  # warm
    sweep = {b: [] for b in K6_BATCHES}
    saved = slv.CG_BATCH
    try:
        for order in (K6_BATCHES, K6_BATCHES[::-1]):
            for batch in order:
                slv.CG_BATCH = batch
                slv.CG_STATS.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = be.solve(khat, pc, rhs, x0=be.u_fix)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                sweep[batch].append(dict(ms=1e3 * wall, iters=res.iters,
                                         reads=slv.CG_STATS["reads"],
                                         idle=slv.CG_STATS["idle"], x=res.x))
    finally:
        slv.CG_BATCH = saved
    ref = sweep[1][0]["x"]
    for batch, runs in sweep.items():
        same = all(torch.equal(r_["x"], ref) and r_["iters"] == sweep[1][0]["iters"]
                   for r_ in runs)
        print(f"CG_BATCH {batch}: elastic solve {runs[0]['iters']} CG iterations, wall "
              f"{runs[0]['ms']:.2f} / {runs[1]['ms']:.2f} ms (turns 1 / 2) = "
              f"{runs[0]['ms'] / runs[0]['iters']:.4f} / {runs[1]['ms'] / runs[1]['iters']:.4f} "
              f"ms per iteration, {runs[0]['reads']} host reads, {runs[0]['idle']} idle "
              f"iterations; x and count {'those of CG_BATCH 1' if same else 'DIFFER'}")
        check(same, f"phase 3e: CG_BATCH {batch} changed the solve's bits or count")
        check(runs[0]["reads"] <= -(-runs[0]["iters"] // batch) + 2,
              f"phase 3e: more than ceil(iters / {batch}) + 2 host reads")
    print(f"CG_BATCH in the port: {saved}")
    rows["sweep"] = {b: [{k: v_ for k, v_ in r_.items() if k != "x"} for r_ in runs]
                     for b, runs in sweep.items()}
    del khat, pc, be, sweep, ref
    torch.cuda.empty_cache()
    return rows


# K2's cases in phase 3f: (model, form, large_disp, region): the update in
# small strain and GNL, the given-stress form (the reaction's) in both, and
# on the plate the update in GNL with phase 10's region (y > 75, E doubled:
# a D, G and H per element) and element weights with 10% zeros (the sharded
# backend's padding)
K2_CASES = tuple((m, f, gnl, False) for m in ("plate", "column") for f in ("update", "given")
                 for gnl in (False, True)) + (("plate", "update", True, True),)
K2_TOL = {torch.float32: 2e-5, torch.float64: 1e-12}  # max |kernel - plain| / max |plain|
K2_FLIP = {torch.float32: 1e-5, torch.float64: 1e-12}  # |svm - sy| / sy where pgp may flip
K2_ET_E = 0.1


def k2_inputs(model, dtype, gnl, region, seed=18):
    """K2's inputs at a path's shapes on ``model``: its coordinates and
    connectivity, a seeded step-start displacement (GNL) and increment, old
    stresses of 30 MPa, one D (or per element with phase 10's region), and
    yield stresses that make about half the Gauss points plastic (the float64
    plain version's trial von Mises stress times a uniform factor in [0.5,
    1.5]); with ``region`` also element weights with 10% zeros.  Returns
    (the wrapper's positional and keyword arguments, the float64 plain
    version's trial von Mises stress)."""
    from fcvm_tpu_torch.ops import kernels
    from fcvm_tpu_torch.ops import material as mat
    from fcvm_tpu_torch.utils.indexing import pad_ndof

    mesh = model.mesh
    rng = np.random.default_rng(seed)
    ne, nd = mesh.n_elements, pad_ndof(mesh.ndof)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device="cuda").to(dt)

    if region:
        y = mesh.coords[mesh.elnodes].mean(axis=1)[:, 1]
        e = t(np.where(y > 75.0, 2 * E, E))
        nu = t(np.full(ne, NU))
    else:
        e, nu = E, NU
    pe, pn = mat.per_gauss(e), mat.per_gauss(nu)
    args = [t(mesh.coords), torch.as_tensor(mesh.elnodes.astype(np.int64), device="cuda"),
            t(3e-3 * rng.normal(size=nd)), t(rng.normal(scale=30.0, size=(ne, 4, 6))), gnl]
    kw = dict(du=t(3e-4 * rng.normal(size=nd)), dmat=mat.hooke_dmat(e, nu, dtype, "cuda"),
              g=mat.shear_modulus(pe, pn), h=mat.hardening_modulus(pe, K2_ET_E))
    if region:
        kw["weights"] = t(rng.uniform(size=ne) > 0.1)

    def f64(v):
        return v.double() if torch.is_tensor(v) and v.is_floating_point() else v

    trial = kernels.stress_update_ref(*map(f64, args), **{k: f64(v) for k, v in kw.items()},
                                      sig_yield=t(np.full((ne, 4), 1e30), torch.float64))[1]
    svm = mat.von_mises(trial)[2]
    kw["sig_yield"] = (svm * t(rng.uniform(0.5, 1.5, size=(ne, 4)), torch.float64)).to(dtype)
    return args, kw, svm


def k2_work(args, kw, given):
    """(bytes, operations) of one launch of K2's element pass on these
    inputs: each input read once (the node arrays at the mesh's nodes, the
    int32 node table ``kw["table"]``, or without it the int64
    connectivity), each output written once; the kernel's own
    arithmetic, an FMA as two operations, per Gauss point
    (csrc/stress_update.cu: J 180, J^-1 50, dN/dx 180 a pass over the nodes,
    elv 210 and its two shuffle adds 60; the update's B du 180, D deps 78,
    the return 40; GNL's grad du 180 and F sig F^T / det F 115)."""
    coords, eln, disp, sig, gnl = args
    size = coords.element_size()
    ne, nn = eln.shape[0], coords.shape[0]
    table = kw.get("table")
    nbytes = eln.numel() * 8 if table is None else table.numel() * table.element_size()
    nbytes += coords.numel() * size + sig.numel() * size + ne * 30 * size
    nbytes += 3 * nn * size if gnl else 0
    nbytes += kw["weights"].numel() * size if "weights" in kw else 0
    per_gp = 180 + 50 + 180 + 210 + 60
    if not given:
        nbytes += 3 * nn * size + kw["sig_yield"].numel() * size + kw["dmat"].numel() * size
        nbytes += 2 * ne * size if torch.is_tensor(kw["g"]) else 0  # G and H + 3 G
        nbytes += 2 * sig.numel() * size + ne * 4  # sig_new, sig_test; pgp
        per_gp += 180 + 180 + 78 + 40 + ((180 + 115) if gnl else 0)
    return nbytes, 4 * ne * per_gp


def node_work(plan, size, residual):
    """Bytes of one launch of K2's node pass over ``plan`` (values of
    ``size`` bytes): elv's rows and the plan (order, offsets, segs, holes)
    read once, qin written; in the residual form glv and fixmask read and r
    written too (the block partials, 8 bytes a block of 256, besides)."""
    rows = plan.rows
    nbytes = plan.keys.shape[0] * 3 * size + 4 * (plan.order.shape[0] + plan.offsets.shape[0]
                                                  + plan.segs.shape[0] + plan.holes.shape[0])
    nbytes += 3 * rows * size * (4 if residual else 1)
    return nbytes + (8 * -(-rows // 256) if residual else 0)


def k2_element_rows(models, smi):
    """Phase 3f's element pass (``kernels.stress_update``) against its plain
    version at the plate's and the beam-column's element counts
    (``K2_CASES``), float32 and float64: every output to ``K2_TOL``; in
    float32 no farther from the float64 plain version than twice the float32
    plain version; the plastic flags equal but where |svm - sy| <=
    ``K2_FLIP`` sy (the flips counted); a second launch the same bits;
    timed (CUDA events and device time) against the plain version (the
    chain it replaced) and its bound.  Returns ``{(dtype, model, case):
    numbers}``."""
    from fcvm_tpu_torch.ops import kernels

    rows = {}
    tabled = hasattr(kernels, "element_table")
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).removeprefix("torch.")
        for name, form, gnl, region in K2_CASES:
            case = form + (" gnl" if gnl else "") + (" region weighted" if region else "")
            args, kw, svm = k2_inputs(models[name], dtype, gnl, region)
            given = form == "given"
            if given:
                kw = {k: v for k, v in kw.items() if k == "weights"}
            if tabled:  # the node table a backend makes once
                kw["table"] = kernels.element_table(args[1])
            out = kernels.stress_update(*args, **kw)
            again = kernels.stress_update(*args, **kw)
            torch.cuda.synchronize()
            out, again = ((out,), (again,)) if given else (out, again)
            same = all(torch.equal(a, b) for a, b in zip(out, again))
            ref = kernels.stress_update_ref(*args, **kw)
            ref = (ref,) if given else ref
            f64 = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
                   for k, v in kw.items()}
            exact = kernels.stress_update_ref(*(a.double() if torch.is_tensor(a)
                                                and a.is_floating_point() else a for a in args),
                                              **f64)
            exact = (exact,) if given else exact
            names = ("elv",) if given else ("sig_new", "sig_test", "pgp", "elv")
            errs, flips = {}, 0
            for n, a, b, c in zip(names, out, ref, exact):
                if n == "pgp":
                    differ = a != b
                    near = (svm - kw["sig_yield"].double()).abs() <= K2_FLIP[dtype] * \
                        kw["sig_yield"].double()
                    flips = int(differ.sum())
                    check(bool((~differ | near).all()),
                          f"K2 {dname} {name} {case}: a plastic flag differs away from the "
                          "yield surface")
                    continue
                scale = float(b.abs().max())
                errs[n] = dict(abs=float((a - b).abs().max()),
                               rel=float((a - b).abs().max()) / scale,
                               vs_f64=float((a.double() - c).abs().max()) / float(c.abs().max()),
                               plain_vs_f64=float((b.double() - c).abs().max())
                               / float(c.abs().max()))
            plastic = float(out[2].float().mean()) if not given else None
            del ref, exact
            ms = cuda_ms(lambda: kernels.stress_update(*args, **kw))
            plain_ms = cuda_ms(lambda: kernels.stress_update_ref(*args, **kw))
            by = device_ms_by_kernel(lambda: kernels.stress_update(*args, **kw))
            dev = sum(v for k, v in by.items() if k.startswith("stress_update")) or None
            nbytes, ops = k2_work(args, kw, given)
            bound_ms, bound_by = bound(nbytes, ops, dtype)
            row = dict(ne=args[1].shape[0], max_abs_err=max(e["abs"] for e in errs.values()),
                       max_rel_err=max(e["rel"] for e in errs.values()), errors=errs,
                       pgp_flips=flips, plastic_share=plastic, same_bits=same, ms=ms,
                       device_ms=dev, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       bytes=nbytes, operations=ops, library_ms=None)
            share = "" if dev is None else f", {bound_ms / dev:.1%} of the device time"
            print(f"K2 element pass {dname} {name} {case} ne={row['ne']}: max rel err "
                  + ", ".join(f"{n} {e['rel']:.2e} (vs f64 {e['vs_f64']:.2e}, plain's "
                              f"{e['plain_vs_f64']:.2e})" for n, e in errs.items())
                  + f" (limit {K2_TOL[dtype]:g}); pgp flips {flips}"
                  + ("" if given else f" (plastic share {plastic:.3f})")
                  + f"; second launch {'the same bits' if same else 'DIFFERENT BITS'}; "
                  f"{ms:.4f} ms (CUDA events), device time "
                  + ("not recorded" if dev is None else f"{dev:.4f} ms")
                  + f"; plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, "
                  f"{nbytes / 1e6:.1f} MB){share}, {bound_ms / ms:.1%} of the events'; no "
                  f"single library call; median of 20 ({smi})")
            for n, e in errs.items():
                check(e["rel"] <= K2_TOL[dtype],
                      f"K2 {dname} {name} {case}: {n} disagrees with its plain version")
                if dtype == torch.float32:
                    check(e["vs_f64"] <= 2 * max(e["plain_vs_f64"], 1e-7),
                          f"K2 {dname} {name} {case}: {n} farther from float64 than twice the "
                          "float32 plain version")
            check(same, f"K2 {dname} {name} {case}: a second launch gave other bits")
            check(given or 0.3 < plastic < 0.7,
                  f"K2 {dname} {name} {case}: not a mix of plastic and elastic points")
            rows[(dname, name, case)] = row
            del args, kw, svm, out, again
            torch.cuda.empty_cache()
    return rows


def ulps(a, b, dtype):
    """|a - b| in units of ``dtype``'s last place at b."""
    return abs(float(a) - float(b)) / (torch.finfo(dtype).eps * abs(float(b)))


def k2_node_rows(models, smi):
    """Phase 3f's node pass (``kernels.node_force``; the residual form
    through ``kernels.stress_residual_bound``) on the plate's and the
    beam-column's node plans, float32 and float64, on the element pass's
    rows of the update with seeded loads and a mask with 20% fixed dofs:
    the internal force bit for bit K8's write form and to ``K2_TOL`` of its
    plain version (``index_add_``); the residual form's qin and r bit for
    bit the unfused composition on the card (K8's write form, the torch
    tail) and its error within 4 ulps; a second launch the same bits; timed
    (CUDA events, device time) against its plain version and its bound, the
    internal force also against ``index_add_`` into zeros.  Returns
    ``{(dtype, model, form): numbers}``."""
    from fcvm_tpu_torch.ops import kernels

    rows = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).removeprefix("torch.")
        for name in ("plate", "column"):
            args, kw, _ = k2_inputs(models[name], dtype, False, False)
            coords, eln, disp, sig, _ = args
            kw["table"] = kernels.element_table(eln)
            elv = kernels.stress_update(*args, **kw)[3]
            nd = disp.shape[0]
            plan = kernels.segment_plan(eln, rows=nd // 3)
            gen = np.random.default_rng(19)
            glv = torch.as_tensor(gen.normal(scale=1e3, size=nd), device="cuda").to(dtype)
            fixmask = torch.as_tensor(gen.uniform(size=nd) > 0.2, device="cuda").to(dtype)
            lbd1, qnorm, relax = 1.3, 7.0, 0.7
            k2 = kernels.stress_residual_bound(eln, plan, fixmask, kw["dmat"], kw["g"],
                                               kw["h"], table=kw["table"])
            rest = (coords, disp, kw["du"], sig, kw["sig_yield"], glv, lbd1, qnorm, False,
                    relax)
            # the residual form of the node pass alone, on the element pass's elv
            node = torch.ops.fcvm.node_force
            tables = (plan.order, plan.offsets, plan.segs, plan.holes, plan.rows)
            ticket = torch.zeros(1, dtype=torch.int32, device="cuda")

            def residual_form():
                return node(elv, *tables, glv, fixmask, ticket, lbd1, relax, qnorm)

            def unfused_tail():
                qin = kernels.segment_sum(elv.reshape(-1, 3).contiguous(), plan, rows=nd // 3)
                raw = fixmask * (torch.as_tensor(lbd1, dtype=torch.float64, device="cuda")
                                 .to(dtype) * glv - qin.reshape(-1))
                return qin.reshape(-1), relax * raw, torch.linalg.vector_norm(raw) / qnorm

            def plain_tail():
                qin = kernels.node_force_ref(elv, plan, nd // 3)
                raw = fixmask * (lbd1 * glv - qin)
                return qin, relax * raw, torch.linalg.vector_norm(raw) / qnorm

            for form in ("force", "residual"):
                if form == "force":
                    got = (kernels.node_force(elv, plan, rows=nd // 3),)
                    again = (kernels.node_force(elv, plan, rows=nd // 3),)
                    want = (kernels.segment_sum(elv.reshape(-1, 3).contiguous(), plan,
                                                rows=nd // 3).reshape(-1),)
                    plain = (kernels.node_force_ref(elv, plan, nd // 3),)
                else:
                    got, again = residual_form(), residual_form()
                    want, plain = unfused_tail(), plain_tail()
                    # through both passes: the element pass's elv, so the force form's qin
                    check(torch.equal(k2(*rest)[3], kernels.node_force(elv, plan,
                                                                       rows=nd // 3)),
                          f"K2 node pass {dname} {name}: the two passes' qin is not the force "
                          "form's")
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                bits = all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
                err_ulps = ulps(got[2], want[2], dtype) if form == "residual" else 0.0
                errs = [float((a - b).abs().max()) for a, b in zip(got, plain)]
                rels = [e / max(float(b.abs().max()), 1e-300) for e, b in zip(errs, plain)]
                if form == "force":
                    ms = cuda_ms(lambda: kernels.node_force(elv, plan, rows=nd // 3))
                    by = device_ms_by_kernel(lambda: kernels.node_force(elv, plan,
                                                                        rows=nd // 3))
                    plain_ms = cuda_ms(lambda: kernels.node_force_ref(elv, plan, nd // 3))
                    keys = elv.reshape(-1, 3)
                    library_ms = cuda_ms(lambda: torch.zeros((nd // 3, 3), dtype=dtype,
                                                             device="cuda").index_add_(
                        0, plan.keys, keys))
                else:
                    ms = cuda_ms(residual_form)
                    by = device_ms_by_kernel(residual_form)
                    plain_ms = cuda_ms(plain_tail)
                    library_ms = None
                dev = sum(v for k, v in by.items() if k.startswith("stress_node")) or None
                nbytes = node_work(plan, elv.element_size(), form == "residual")
                bound_ms, bound_by = bound(nbytes, 0, dtype)
                row = dict(rows=nd // 3, max_abs_err=max(errs), max_rel_err=max(rels),
                           error_ulps=err_ulps, same_bits=same, unfused_bits=bits, ms=ms,
                           device_ms=dev, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, bytes=nbytes, library_ms=library_ms)
                share = "" if dev is None else f", {bound_ms / dev:.1%} of the device time"
                print(f"K2 node pass {dname} {name} {form}: {nd // 3} rows; max rel err "
                      f"{max(rels):.2e} against the plain version (limit {K2_TOL[dtype]:g}); "
                      + ("qin, r bit for bit the unfused composition (K8, torch tail): "
                         f"{bits}, error {err_ulps:.2f} ulps from it"
                         if form == "residual" else f"bit for bit K8's write form: {bits}")
                      + f"; second launch {'the same bits' if same else 'DIFFERENT BITS'}; "
                      f"{ms:.4f} ms (CUDA events), device time "
                      + ("not recorded" if dev is None else f"{dev:.4f} ms")
                      + f"; plain {plain_ms:.4f} ms"
                      + ("" if library_ms is None else f"; index_add_ into zeros "
                         f"{library_ms:.4f} ms")
                      + f"; bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB){share}; median of "
                      f"20 ({smi})")
                check(max(rels) <= K2_TOL[dtype],
                      f"K2 node pass {dname} {name} {form}: disagrees with its plain version")
                check(bits, f"K2 node pass {dname} {name} {form}: not the unfused bits")
                check(err_ulps <= 4, f"K2 node pass {dname} {name}: error {err_ulps:.2f} ulps "
                      "from the unfused composition's")
                check(same, f"K2 node pass {dname} {name} {form}: a second launch gave other "
                      "bits")
                rows[(dname, name, form)] = row
            del args, kw, elv, plan, glv, fixmask, k2
            torch.cuda.empty_cache()
    return rows


def k2_residual(big, smi):
    """Phase 3f's residual of the plate (``backend.residual``, float32, at
    a seeded increment): through K2's two passes against the unfused
    composition (the element pass, K8's write form, the torch tail with
    ``lbd1`` copied to the card) in turns, and the plain version once; the
    two passes' bits against the composition's; where its device time goes
    (torch.profiler), which must show K2's two kernels and nothing else: no
    K8 kernel, no torch kernel, no copy to the card.  Returns the numbers."""
    from fcvm_tpu_torch import FcvmConfig
    from fcvm_tpu_torch.ops import kernels
    from fcvm_tpu_torch.ops import material as mat
    from fcvm_tpu_torch.runtime.backend import TorchSystem

    be = TorchSystem(big, FcvmConfig(device="cuda", dtype="float32"), torch.float32,
                     torch.device("cuda"))
    coords = be.tensor(big.mesh.coords)
    gen = torch.Generator(device="cuda").manual_seed(6)
    du = 1e-3 * torch.randn(be.ndof_pad, generator=gen, device="cuda")
    glv = torch.randn(be.ndof_pad, generator=gen, device="cuda")
    sig_y, sig0 = be.gauss_full(PLATE_SY), be.gauss_zeros((6,))
    zero = torch.zeros_like(du)
    lbd1, qnorm, et_e = 1.0, 1.0, 0.0
    mat_g = mat.shear_modulus(mat.per_gauss(be.e), mat.per_gauss(be.nu))
    mat_h = mat.hardening_modulus(mat.per_gauss(be.e), et_e)

    def residual():
        return be.residual(coords, sig_y, zero, du, sig0, glv, lbd1, qnorm, et_e)

    def unfused_residual():
        out = kernels.stress_update(coords, be.elnodes, zero, sig0, False, du=du, dmat=be.dmat,
                                    sig_yield=sig_y, g=mat_g, h=mat_h, table=be.element_table)
        qin = kernels.segment_sum(out[3].reshape(-1, 3), be.node_plan,
                                  rows=be.ndof_pad // 3).reshape(-1)
        raw = be.fixmask * (be.tensor(lbd1) * glv - qin)
        return out[0], out[1], out[2], qin, raw, torch.linalg.vector_norm(raw) / qnorm

    def plain():
        return kernels.stress_residual_ref(coords, be.elnodes, zero, du, sig0, sig_y, glv,
                                           be.fixmask, lbd1, qnorm, dmat=be.dmat, g=mat_g,
                                           h=mat_h, plan=be.node_plan)

    reset_launches()
    got = residual()
    torch.cuda.synchronize()
    counts, _ = read_launches()
    want = unfused_residual()
    torch.cuda.synchronize()
    bits = all(torch.equal(a, b) for a, b in zip(got[:5], want[:5]))
    err_ulps = ulps(got[5], want[5], torch.float32)
    print(f"backend.residual of the plate, float32: launches {counts['stress_update']} element "
          f"pass, {counts['node_force']} node pass, {counts['segment_sum']} K8; sig_new, "
          f"sig_test, pgp, qin, r bit for bit the unfused composition: {bits}; error "
          f"{err_ulps:.2f} ulps from it")
    check(counts["stress_update"] == 1 and counts["node_force"] == 1
          and counts["segment_sum"] == 0,
          "backend.residual: not one launch of each K2 pass and none of K8")
    check(bits, "backend.residual: the two passes' bits differ from the unfused composition's")
    check(err_ulps <= 4, "backend.residual: error more than 4 ulps from the composition's")
    times = {}
    for label in ("K2", "unfused", "unfused", "K2"):
        times.setdefault(label, []).append(cuda_ms(residual if label == "K2"
                                                   else unfused_residual))
    plain_ms = cuda_ms(plain)
    print(f"backend.residual of the plate, float32, turns K2's two passes / the unfused "
          f"composition / again / K2: {times['K2'][0]:.4f} / {times['unfused'][0]:.4f} / "
          f"{times['unfused'][1]:.4f} / {times['K2'][1]:.4f} ms; its plain version "
          f"{plain_ms:.4f} ms ({smi})")
    # where its time goes: device time by kernel against its CUDA-event time
    by = device_ms_by_kernel(residual)
    events = cuda_ms(residual)
    by_unfused = device_ms_by_kernel(unfused_residual)
    print(f"backend.residual of the plate, float32, device time by kernel (torch.profiler, "
          f"mean of 10): " + ", ".join(f"{n} {ms:.4f}" for n, ms in
                                       sorted(by.items(), key=lambda kv: -kv[1]))
          + f"; {sum(by.values()):.4f} in all against {events:.4f} ms of CUDA events; the "
          f"unfused composition: " + ", ".join(
              f"{n} {ms:.4f}" for n, ms in sorted(by_unfused.items(), key=lambda kv: -kv[1]))
          + f", {sum(by_unfused.values()):.4f} in all ({smi})")
    check(set(by) == {"stress_update_kernel", "stress_node_kernel"},
          f"backend.residual: the profile shows {sorted(by)}, not K2's two passes alone (no "
          "K8 kernel, no torch kernel, no copy to the card)")
    del be, coords, du, glv, sig_y, sig0, zero
    torch.cuda.empty_cache()
    return dict(turns_ms=times, plain_ms=plain_ms, device_ms_by_kernel=by, events_ms=events,
                unfused_device_ms_by_kernel=by_unfused, unfused_bits=bits,
                error_ulps=err_ulps)


def k2_digests(models):
    """SHA-256 of K2's element-pass outputs at each ``K2_CASES`` input, both
    dtypes: two trees whose K2 gives the same bits give the same digests
    (``tools/turns.py TREE k2bits``).  Returns ``{"dtype model case": hex}``."""
    import hashlib

    from fcvm_tpu_torch.ops import kernels

    out = {}
    for dtype in (torch.float32, torch.float64):
        for name, form, gnl, region in K2_CASES:
            args, kw, _ = k2_inputs(models[name], dtype, gnl, region)
            if form == "given":
                kw = {k: v for k, v in kw.items() if k == "weights"}
            got = kernels.stress_update(*args, **kw)
            got = (got,) if form == "given" else got
            h = hashlib.sha256()
            for t in got:
                h.update(t.contiguous().cpu().numpy().tobytes())
            key = (f"{str(dtype).removeprefix('torch.')} {name} {form}"
                   + (" gnl" if gnl else "") + (" region weighted" if region else ""))
            out[key] = h.hexdigest()
            del args, kw, got
    torch.cuda.empty_cache()
    return out


def k2_phase(models, smi):
    """Phase 3f: K2's element pass (:func:`k2_element_rows`), its node pass
    (:func:`k2_node_rows`) and the plate's residual through both
    (:func:`k2_residual`).  Returns ``{(dtype, model, case): numbers}`` of
    the element pass, ``"node"``: the node pass's and ``"residual"``."""
    rows = k2_element_rows(models, smi)
    rows["node"] = k2_node_rows(models, smi)
    rows["residual"] = k2_residual(models["plate"], smi)
    digests = k2_digests(models)
    print("K2 element pass, SHA-256 of its outputs by case (tools/turns.py TREE k2bits holds "
          "two trees' against each other): " + "; ".join(f"{k} {v[:16]}"
                                                        for k, v in digests.items()))
    return rows


# K3's cases of phase 3g: (model, form, what the paths form: the case's
# inputs and outputs, K3_OUTPUTS); each in float32 and float64
K3_CASES = (("plate", "tangent", "refresh"),  # phase 8's refresh: packed tiles and diagonal
            ("plate", "tangent", "region"),  # phase 10's region, a D, G and H per element
            ("plate", "elastic", "assembly"),  # the elastic operator: every output
            ("column", "elastic", "assembly"),
            ("column", "geometric", "pencil"),  # -G_hat's packed tiles, a seeded pre-stress
            ("plate", "elastic", "sharded weights"))  # weights with zeros, no perm
# the outputs each case writes (form_blocks' full, packed, diag): a refresh
# the packed tiles and the compact diagonal K5 reads, an assembly and the
# sharded backend's all three, the pencil's -G_hat its tiles alone
K3_OUTPUTS = {"refresh": ("packed", "diag"), "region": ("full", "packed"),
              "assembly": ("full", "packed", "diag"), "pencil": ("packed",),
              "sharded weights": ("full", "packed", "diag")}
# K5's: (model, the path whose diagonal it reads)
K5_CASES = (("plate", "refresh"),  # the diagonal in the solve space's order, its plan
            ("plate", "assembly"),  # the diagonal in that order, the user plan, cols
            ("plate", "sharded"),  # the sum, a reduce, the tail
            ("column", "eigensolve"))  # the diagonal, the solve space's plan
K3_TOL = {torch.float32: 2e-5, torch.float64: 1e-12}  # max |kernel - plain| / max |plain|


def form_setup(models):
    """Per model: a float32 backend (its solve space, element table and
    masks) and the seeded state K3 forms from (about half the Gauss points
    plastic, stresses of 30 MPa, a displacement, phase 10's region)."""
    from fcvm_tpu_torch import FcvmConfig
    from fcvm_tpu_torch.runtime.backend import TorchSystem

    out = {}
    for name, model in models.items():
        be = TorchSystem(model, FcvmConfig(device="cuda", dtype="float32"), torch.float32,
                         torch.device("cuda"))
        mesh = model.mesh
        rng = np.random.default_rng(19)
        y = mesh.coords[mesh.elnodes].mean(axis=1)[:, 1]
        out[name] = dict(be=be, rng_state=dict(
            disp=3e-3 * rng.normal(size=be.ndof_pad),
            sig=rng.normal(scale=30.0, size=(mesh.n_elements, 4, 6)),
            pgp=rng.uniform(size=(mesh.n_elements, 4)) < 0.5,
            e=np.where(y > 75.0, 2 * E, E) if name == "plate" else np.full(mesh.n_elements, E),
            weights=(rng.uniform(size=mesh.n_elements) > 0.1).astype(float)))
    return out


def k3_inputs(setup, model, form, case, dtype):
    """K3's arguments and keywords for a ``K3_CASES`` entry in ``dtype``,
    and the outputs the case writes (``K3_OUTPUTS``) as keywords."""
    from fcvm_tpu_torch.ops import material as mat

    st = setup[model]
    be, r = st["be"], st["rng_state"]

    def t(a):
        return torch.as_tensor(np.asarray(a), device="cuda").to(dtype)

    kw = dict(table=be.element_table)
    if case != "sharded weights":
        kw["perm"] = be.space.eperm
    else:
        kw["weights"] = t(r["weights"])
    e = t(r["e"]) if case == "region" else E
    if form in ("elastic", "tangent"):
        kw["dmat"] = mat.hooke_dmat(e, NU, dtype, "cuda")
    if form in ("tangent", "geometric"):
        kw["sig"] = t(r["sig"])
    if form == "tangent":
        kw.update(disp=t(r["disp"]), pgp=torch.as_tensor(r["pgp"], device="cuda"),
                  g=mat.shear_modulus(e, NU), h=mat.hardening_modulus(e, K2_ET_E))
    outs = {k: k in K3_OUTPUTS[case] for k in ("full", "packed", "diag")}
    return (form, t(be.mesh.coords), be.elnodes), kw, outs


def k3_work(args, kw, outs, dtype):
    """(bytes, operations) of one K3 launch: each input read once (the
    coordinates and displacements at every node, the int32 table, perm, the
    per-element stresses, flags, D, G, H and weights), each output written
    once (the packed tiles with their padding, the element-major blocks and
    the compact diagonal's 6 values an incidence when written); the
    arithmetic, an FMA as two operations: per Gauss point the geometry (J
    90, J^-1 40, dN/dx 90, D_g 60 FMAs), D_g B_b once a node (54 FMAs;
    geometric sigma_g dN_b, 9) and B_a^T (D_g B_b) once a node pair (27;
    geometric 4)."""
    form, coords, eln = args
    size = coords.element_size()
    ne = kw["perm"].shape[0] if "perm" in kw else eln.shape[0]
    nbytes = coords.numel() * size + 40 * eln.shape[0] + (8 * ne if "perm" in kw else 0)
    for k in ("disp", "sig", "dmat", "g", "h", "weights"):
        v = kw.get(k)
        nbytes += v.numel() * size if torch.is_tensor(v) else 0
    nbytes += kw["pgp"].numel() if "pgp" in kw else 0
    tile = {torch.float32: 256, torch.float64: 128}[dtype]
    nbytes += ((465 * -(-ne // tile) * tile if outs["packed"] else 0)
               + (900 * ne if outs["full"] else 0) + (60 * ne if outs["diag"] else 0)) * size
    column, pair = (9, 4) if form == "geometric" else (54, 27)
    return nbytes, 2 * ne * 4 * (280 + 10 * column + 55 * pair)


def k3_rows(setup, smi):
    """Phase 3g's K3 rows (``K3_CASES``), float32 and float64: against its
    plain version (the einsum chain and ``pack_blocks``) on the same
    tensors, to ``K3_TOL``, in float32 no farther from the float64 plain
    version than twice the float32 plain version; its blocks exactly
    symmetric, its packed tiles bit for bit ``pack_blocks`` of its own
    element-major blocks and its compact diagonal their ``diag_sectors``, a
    second launch of the case's outputs the same bits; timed (CUDA events,
    device time) against its plain version and its bound, with the SHA-256
    of the case's outputs."""
    from fcvm_tpu_torch.ops import kernels

    rows = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).removeprefix("torch.")
        for model, form, case in K3_CASES:
            args, kw, outs = k3_inputs(setup, model, form, case, dtype)
            got = kernels.form_blocks(*args, **kw, full=True, packed=True, diag=True)
            again = kernels.form_blocks(*args, **kw, **outs)
            torch.cuda.synchronize()
            same = all(b is None or torch.equal(a, b) for a, b in zip(got, again))
            sym = torch.equal(got[0], got[0].transpose(0, 1))
            packs = torch.equal(got[1], kernels.pack_blocks(got[0]))
            slices = torch.equal(got[2], kernels.diag_sectors(got[0]))
            digest = sha256(b for b in again if b is not None)
            want = kernels.form_blocks_ref(*args, **kw)[0]
            scale = float(want.abs().max())
            err = float((got[0] - want).abs().max())
            f64 = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
                   for k, v in kw.items()}
            exact = kernels.form_blocks_ref(args[0], args[1].double(), args[2], **f64)[0]
            vs_f64 = float((got[0].double() - exact).abs().max()) / float(exact.abs().max())
            plain_vs_f64 = float((want.double() - exact).abs().max()) / float(exact.abs().max())
            del got, again, want, exact
            torch.cuda.empty_cache()
            ms = cuda_ms(lambda: kernels.form_blocks(*args, **kw, **outs))
            plain_ms = cuda_ms(lambda: kernels.form_blocks_ref(*args, **kw, **outs), runs=5)
            by = device_ms_by_kernel(lambda: kernels.form_blocks(*args, **kw, **outs))
            dev = sum(v for k, v in by.items() if k.startswith("form_blocks")) or None
            nbytes, ops = k3_work(args, kw, outs, dtype)
            bound_ms, bound_by = bound(nbytes, ops, dtype)
            ne = kw["perm"].shape[0] if "perm" in kw else args[2].shape[0]
            row = dict(ne=ne, outputs=", ".join(K3_OUTPUTS[case]), max_abs_err=err,
                       max_rel_err=err / scale, vs_f64=vs_f64, plain_vs_f64=plain_vs_f64,
                       same_bits=same, symmetric=sym, packed_is_pack_blocks=packs,
                       diag_is_slices=slices, sha256=digest, ms=ms, device_ms=dev,
                       plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                       operations=ops, library_ms=None)
            share = "" if dev is None else f", {bound_ms / dev:.1%} of the device time"
            print(f"K3 {dname} {model} {form} ({case}) ne={ne}, {row['outputs']}: max rel err "
                  f"{err / scale:.2e} (vs f64 {vs_f64:.2e}, plain's {plain_vs_f64:.2e}; limit "
                  f"{K3_TOL[dtype]:g}); symmetric {sym}; packed tiles pack_blocks' {packs}; "
                  f"diagonal their slices {slices}; second launch "
                  f"{'the same bits' if same else 'DIFFERENT BITS'}, SHA-256 {digest[:16]}; "
                  f"{ms:.4f} ms (CUDA events), device time "
                  + ("not recorded" if dev is None else f"{dev:.4f} ms")
                  + f"; plain (the einsum chain, pack_blocks) {plain_ms:.4f} ms [median of 5]; "
                  f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB){share}; no "
                  f"library call ({smi})")
            check(err / scale <= K3_TOL[dtype], f"K3 {dname} {model} {form} ({case}): disagrees "
                  "with its plain version")
            if dtype == torch.float32:
                check(vs_f64 <= 2 * max(plain_vs_f64, 1e-7), f"K3 {dname} {model} {form} "
                      f"({case}): farther from float64 than twice the float32 plain version")
            check(same and sym and packs and slices, f"K3 {dname} {model} {form} ({case}): a "
                  "second launch gave other bits, or its blocks are not symmetric or its tiles "
                  "or diagonal not theirs")
            rows[(dname, model, f"{form} {case}")] = row
            del args, kw
            torch.cuda.empty_cache()
    return rows


def k5_inputs(setup, model, case, dtype):
    """K5's compact diagonal, plan, mask and keywords for a ``K5_CASES``
    entry, and the element-major blocks K8's check reads: K3's elastic
    blocks of ``model`` as the case's path forms them."""
    from fcvm_tpu_torch.ops import assembly as asm
    from fcvm_tpu_torch.ops import kernels
    from fcvm_tpu_torch.ops import material as mat

    be = setup[model]["be"]
    sp = be.space
    coords = torch.as_tensor(be.mesh.coords, device="cuda").to(dtype)
    dmat = mat.hooke_dmat(E, NU, dtype, "cuda")
    perm = None if case == "sharded" else sp.eperm
    esm_t, _, diag = kernels.form_blocks("elastic", coords, be.elnodes, dmat=dmat, perm=perm,
                                         table=be.element_table, diag=True)
    kw = {}
    if case in ("assembly", "sharded"):
        plan, fixmask = asm.jacobi_plan(be.elnodes, be.ndof_pad // 3), be.fixmask
        kw = {"cols": sp.epos} if case == "assembly" else {"reduce": lambda nodal: nodal}
    else:
        plan, fixmask = sp.jacobi_plan, sp.fixmask_m
    return diag, plan, fixmask.to(dtype), kw, esm_t


def k5_work(blocks, plan, fixmask, kw):
    """Bytes of one K5 call: the diagonal values it must read (6 of each
    (element, slot) block), the plan (order, offsets, segs, holes), cols,
    the mask and the inverses written (the sum form's nodal blocks written
    and read again once more); its arithmetic is below the bytes' time."""
    size = blocks.element_size()
    inc = plan.keys.shape[0]
    nbytes = inc * 6 * size
    nbytes += 4 * (plan.order.shape[0] + plan.offsets.shape[0] + plan.segs.shape[0]
                   + plan.holes.shape[0])
    nbytes += 8 * kw["cols"].shape[0] if "cols" in kw else 0
    rows = fixmask.shape[0] // 3
    nbytes += fixmask.numel() * size + 9 * rows * size * (3 if "reduce" in kw else 1)
    return nbytes, 2 * rows * 60


def k5_rows(setup, smi):
    """Phase 3g's K5 rows (``K5_CASES``), float32 and float64, on K3's
    compact diagonal: its sum bit for bit K8's write form on the same
    element-major blocks' diagonal slices (the sum form's output, read
    through a reduce), its inverses within 4 ulps of the torch tail, a
    second call and the reduce form the same bits; timed against its plain
    version (the blocks made of the diagonal, K8, the torch tail) and its
    bound, with the SHA-256 of its fused, sum and tail outputs."""
    from fcvm_tpu_torch.ops import kernels

    rows = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).removeprefix("torch.")
        for model, case in K5_CASES:
            blocks, plan, fixmask, kw, esm_t = k5_inputs(setup, model, case, dtype)
            seen = {}

            def keep(nodal):
                seen["nodal"] = nodal.clone()
                return nodal

            got = kernels.jacobi_inverse(blocks, plan, fixmask, **kw)
            again = kernels.jacobi_inverse(blocks, plan, fixmask, **kw)
            summed = kernels.jacobi_inverse(blocks, plan, fixmask, cols=kw.get("cols"),
                                            reduce=keep)
            torch.cuda.synchronize()
            digest = sha256([got, seen["nodal"], summed])
            ne = esm_t.shape[2]
            cols = kw.get("cols")
            src = esm_t if cols is None else esm_t[:, :, cols]
            idx = torch.arange(10, device="cuda")
            diag = src.permute(2, 0, 1).reshape(ne, 10, 3, 10, 3)[:, idx, :, idx, :]
            nodal = kernels.segment_sum(diag.reshape(-1, 3, 3).contiguous(), plan,
                                        rows=fixmask.shape[0] // 3)
            sum_bits = torch.equal(seen["nodal"], nodal)
            tail = kernels._jacobi_tail_ref(nodal, fixmask)
            tiny = torch.finfo(dtype).tiny
            max_ulps = float(((got - tail).abs() / (torch.finfo(dtype).eps
                                                    * tail.abs().clamp_min(tiny))).max())
            err = float((got - tail).abs().max())
            same = torch.equal(got, again) and torch.equal(got, summed)
            del again, summed, src, diag, nodal, tail
            ms = cuda_ms(lambda: kernels.jacobi_inverse(blocks, plan, fixmask, **kw))
            plain_ms = cuda_ms(lambda: kernels.jacobi_inverse_ref(blocks, plan, fixmask, **kw))
            by = device_ms_by_kernel(lambda: kernels.jacobi_inverse(blocks, plan, fixmask, **kw))
            dev = sum(v for k, v in by.items() if k.startswith("jacobi")) or None
            nbytes, ops = k5_work(blocks, plan, fixmask, kw)
            bound_ms, bound_by = bound(nbytes, ops, dtype)
            form = "sum, reduce, tail" if "reduce" in kw else "fused"
            row = dict(nodes=fixmask.shape[0] // 3, ne=ne, form=form, layout="compact diagonal",
                       cols="cols" in kw, max_abs_err=err, max_ulps=max_ulps,
                       sum_bit_for_bit=sum_bits, same_bits=same, sha256=digest, ms=ms,
                       device_ms=dev, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       bytes=nbytes, operations=ops, library_ms=None)
            share = "" if dev is None else f", {bound_ms / dev:.1%} of the device time"
            print(f"K5 {dname} {model} ({case}: {form}, compact diagonal"
                  + (", cols" if "cols" in kw else "") + f"), {row['nodes']} nodes: sum bit for "
                  f"bit K8's write form {sum_bits}; inverses {max_ulps:.2f} ulps from the torch "
                  f"tail (max abs {err:.2e}); second call and the reduce form "
                  f"{'the same bits' if same else 'DIFFERENT BITS'}, SHA-256 {digest[:16]}; "
                  f"{ms:.4f} ms (CUDA events), device time "
                  + ("not recorded" if dev is None else f"{dev:.4f} ms")
                  + f"; plain (the blocks of the diagonal, K8, the torch tail) {plain_ms:.4f} "
                  f"ms; bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB){share}; no "
                  f"library call ({smi})")
            check(sum_bits, f"K5 {dname} {model} ({case}): its sum is not K8's bits")
            check(max_ulps <= 4, f"K5 {dname} {model} ({case}): inverses more than 4 ulps from "
                  "the torch tail")
            check(same, f"K5 {dname} {model} ({case}): a second call or the reduce form gave "
                  "other bits")
            rows[(dname, model, case)] = row
            del blocks, plan, fixmask, kw, esm_t, got
            torch.cuda.empty_cache()
    return rows


def form_phase(models, smi):
    """Phase 3g: K3 (:func:`k3_rows`) and K5 (:func:`k5_rows`) at every shape
    the paths give them.  Returns ``{"form_blocks": rows, "jacobi_inverse":
    rows}``."""
    setup = form_setup(models)
    out = {"form_blocks": k3_rows(setup, smi), "jacobi_inverse": k5_rows(setup, smi)}
    del setup
    torch.cuda.empty_cache()
    return out


def sha256(tensors) -> str:
    """The SHA-256 of ``tensors``' bytes, one after the other."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def form_digests(models):
    """SHA-256 of K3's and K5's outputs at phase 3g's inputs, both dtypes,
    by this checkout's code against the port it imports, which may be an
    older tree's (``tools/turns.py TREE formbits``): K3's element-major
    blocks and packed tiles in each ``K3_CASES`` case; its compact diagonal
    where the case writes one (a tree whose K3 writes none: the same
    layout sliced out of its packed tiles); K5's fused output, its sum (read
    through a reduce) and its tail in each ``K5_CASES`` case, on the input
    the tree's K5 takes (the compact diagonal, or a tree's packed tiles or
    element-major blocks, as its paths gave them).  Two trees with the same
    bits give the same digests.  Returns ``{"dtype model case output":
    hex}``."""
    from fcvm_tpu_torch.ops import assembly as asm
    from fcvm_tpu_torch.ops import kernels
    from fcvm_tpu_torch.ops import material as mat

    has_diag = hasattr(kernels, "diag_sectors")

    def sectors(packed, ne):  # the compact diagonal's layout, sliced out of packed tiles
        esm_t = kernels.unpack_blocks(packed, ne)
        idx = torch.arange(10, device=esm_t.device)
        blocks = esm_t.reshape(10, 3, 10, 3, ne)[idx, :, idx]
        out = esm_t.new_zeros((10, ne, 8))
        out[:, :, :6] = blocks[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].transpose(1, 2)
        return out

    setup = form_setup(models)
    out = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).removeprefix("torch.")
        for model, form, case in K3_CASES:
            args, kw, outs = k3_inputs(setup, model, form, case, dtype)
            esm_t, packed = kernels.form_blocks(*args, **kw, full=True, packed=True)[:2]
            key = f"{dname} {model} {form} {case}"
            out[f"{key} element-major"] = sha256([esm_t])
            out[f"{key} packed"] = sha256([packed])
            if outs["diag"]:
                ne = esm_t.shape[2]
                diag = (kernels.form_blocks(*args, **kw, full=False, diag=True)[2] if has_diag
                        else sectors(packed, ne))
                out[f"{key} diagonal"] = sha256([diag])
            del args, kw, esm_t, packed
        for model, case in K5_CASES:
            be = setup[model]["be"]
            sp = be.space
            coords = torch.as_tensor(be.mesh.coords, device="cuda").to(dtype)
            perm = None if case == "sharded" else sp.eperm
            got = kernels.form_blocks("elastic", coords, be.elnodes,
                                      dmat=mat.hooke_dmat(E, NU, dtype, "cuda"), perm=perm,
                                      table=be.element_table, packed=True,
                                      **({"diag": True} if has_diag else {}))
            esm_t, packed = got[:2]
            kw = {"cols": sp.epos} if case == "assembly" else {}
            if case in ("assembly", "sharded"):
                plan, fixmask = asm.jacobi_plan(be.elnodes, be.ndof_pad // 3), be.fixmask
                blocks = got[2] if has_diag else esm_t
            else:
                plan, fixmask = sp.jacobi_plan, sp.fixmask_m
                blocks = got[2] if has_diag else packed
            fixmask = fixmask.to(dtype)
            seen = {}

            def keep(nodal):
                seen["nodal"] = nodal.clone()
                return nodal

            fused = kernels.jacobi_inverse(blocks, plan, fixmask, **kw)
            tail = kernels.jacobi_inverse(blocks, plan, fixmask, reduce=keep, **kw)
            key = f"{dname} {model} {case}"
            out[f"{key} fused"] = sha256([fused])
            out[f"{key} sum"] = sha256([seen["nodal"]])
            out[f"{key} tail"] = sha256([tail])
            del got, esm_t, packed, blocks, fused, tail, seen
            torch.cuda.empty_cache()
    del setup
    torch.cuda.empty_cache()
    return out


# where the coarse table's later chunk starts (its longest group: 7,473 rows
# on the plate)
COARSE_LATER = 57_344


def k8_phase(models):
    """Phase 3c, K8: the fixed-order node sum at every site the paths give
    it, float32 and float64, on seeded values over the plans the paths
    build: the internal force's (3-wide rows of the user-order elements)
    and the block-Jacobi blocks' (9-wide, slot-major), each in the write form the
    path uses; the coarse Galerkin table's first chunk and its chunk from
    element ``COARSE_LATER`` (144-wide pair blocks keyed by cluster pair,
    the plans of their real cluster keys: few groups of thousands of rows)
    and, where the cluster smoother divides the padded nodes, the
    smoother's plan of every element (3-wide rows of the element blocks,
    most of them keyed to the dump row, which the kernel skips and no
    comparison reads), each in the
    accumulating form the path uses; on the plate's and the beam-column's
    meshes.  Each against its plain version on the card (``index_add_``,
    whose order varies) within the tolerance and bit for bit against it on
    the CPU (the kernel's order), the same bits on a second call, in both
    forms; the groups' count, median and longest, the launches by path;
    CUDA-event medians of the path's form against its library call (the
    write form against ``torch.zeros`` + ``index_add_``) and its device
    time alone (torch.profiler), and CUDA-event medians of the
    accumulating form and ``index_add_`` into one held output.  A tree
    without the write form (``tools/turns.py``) runs its path's call
    there: ``torch.zeros``, then K8 accumulating.  Returns ``{(dtype,
    model, site): numbers}``."""
    from fcvm_tpu_torch.ops import kernels

    written = "rows" in kernels.SegmentPlan._fields  # K8 has its write form
    paths = getattr(kernels.segment_sum, "paths", Counter())
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(11)
    for name, model in models.items():
        sites = k8_sites(model)
        for (site, plan, nout, trail, form, dump), dtype in itertools.product(
                sites, (torch.float32, torch.float64)):
            tol = TOL_F32 if dtype == torch.float32 else TOL_F64
            size = torch.finfo(dtype).bits // 8
            n, w, nu = plan.keys.shape[0], math.prod(trail), plan.segs.shape[0]
            nread = plan.order.shape[0]  # the rows the kernel sums (no dump rows)
            keep = nout - 1 if dump else nout  # the rows anyone reads
            deg = (plan.offsets[1:] - plan.offsets[:-1]).long()
            median, longest = int(deg.median()), int(deg.max())
            vals = torch.randn((n, *trail), generator=gen, device="cuda", dtype=dtype)

            def zeros(device="cuda"):
                return torch.zeros((nout, *trail), dtype=dtype, device=device)

            def write():  # the write form, or a tree's call without it
                if written:
                    return kernels.segment_sum(vals, plan, rows=nout)
                return kernels.segment_sum(vals, plan, zeros())

            cpu = zeros("cpu").index_add_(0, plan.keys.cpu(), vals.cpu())[:keep]
            ref = zeros().index_add_(0, plan.keys, vals)[:keep]
            forms = {"accumulate": lambda: kernels.segment_sum(vals, plan, zeros())}
            if form == "write":
                forms["write"] = write
            before = Counter(paths)
            errs, launched = {}, {}
            for f, call in forms.items():
                p0 = Counter(paths)
                out, again = call(), call()
                torch.cuda.synchronize()
                launched[f] = {k: v for k, v in (paths - p0).items()}
                out, again = out[:keep], again[:keep]
                errs[f] = float((out - ref).abs().max())
                rel = errs[f] / float(ref.abs().max())
                same, same_cpu = bool(torch.equal(out, again)), bool(torch.equal(out.cpu(), cpu))
                check(rel <= tol, f"K8 disagrees with its plain version ({dtype}, {name}, {site}, "
                                  f"{f})")
                check(same and same_cpu, f"K8 is not the fixed-order sum ({dtype}, {name}, "
                                         f"{site}, {f}): second call {same}, the CPU's {same_cpu}")
            del out, again, ref, cpu
            path_counts = dict(paths - before)
            acc = zeros()
            plan_bytes = 4 * (nread + 3 * nu)  # order, and each group's range and key
            # the summed values and the plan read once; accumulating, the
            # touched rows read and written once; writing, every row written once
            acc_bytes = nread * w * size + plan_bytes + 2 * nu * w * size
            row = dict(form=form, max_abs_err=max(errs.values()), n=n, n_summed=nread, width=w,
                       segments=nu, median_rows=median, longest_rows=longest, out_rows=nout,
                       paths=path_counts,
                       accumulate_ms=cuda_ms(kernels.segment_sum, vals, plan, acc),
                       accumulate_library_ms=cuda_ms(lambda: acc.index_add_(0, plan.keys, vals)))
            row["accumulate_bound_ms"] = bound(acc_bytes, nread * w, dtype)[0]
            if form == "write":
                row.update(ms=cuda_ms(write), device_ms=device_ms(write),
                           plain_ms=cuda_ms(lambda: zeros().index_add_(0, plan.keys, vals)))
                row["library_ms"] = row["plain_ms"]  # torch.zeros + index_add_
                nbytes = nread * w * size + plan_bytes + 4 * (nout - nu) + nout * w * size
            else:
                row.update(ms=row["accumulate_ms"], plain_ms=cuda_ms(
                    kernels.segment_sum_ref, vals, plan, acc), library_ms=row[
                    "accumulate_library_ms"], device_ms=device_ms(kernels.segment_sum, vals,
                                                                  plan, acc))
                nbytes = acc_bytes
            row["bound_ms"], row["bound_by"] = bound(nbytes, nread * w, dtype)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            dname = str(dtype).removeprefix("torch.")
            print(f"K8 {dname} {name} {site}: {n} rows of {w}"
                  f"{f' ({nread} summed, the rest to the dump row)' if dump else ''} into {nu} "
                  f"groups (median {median} rows, longest {longest}) of {nout} output rows; "
                  f"launches by path {path_counts}; max abs err {row['max_abs_err']:.3e} vs "
                  f"index_add_ on the card (rel limit {tol:g}), bit for bit the CPU's "
                  f"index_add_ and the same bits on a second call, "
                  f"{' and '.join(forms)}; the path's {form}: kernel {row['ms']:.4f} ms "
                  f"(device time {row['device_ms']:.4f} ms), "
                  f"{'torch.zeros + ' if form == 'write' else ''}index_add_ "
                  f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}), {row['bound_share']:.1%} of it; into a held output: "
                  f"kernel {row['accumulate_ms']:.4f} ms, index_add_ "
                  f"{row['accumulate_library_ms']:.4f} ms, bound "
                  f"{row['accumulate_bound_ms']:.4f} ms; median of 20")
            need = "accumulate ring" if site.startswith("coarse") else (
                "write register" if form == "write" else None)
            check(not written or need is None or launched[form].get(need, 0) > 0,
                  f"K8 did not take the {need} path at {site} ({name}): {launched}")
            rows[(dname, name, site)] = row
            del vals, acc
        del sites
        torch.cuda.empty_cache()
    return rows


def k8_sites(model):
    """K8's sites on ``model``'s paths, each ``(site, plan, output rows,
    trailing shape, the path's form, last row a dump row)``: the internal
    force's and the block-Jacobi blocks' plans in the write form, the coarse table's first chunk and its chunk from element
    ``COARSE_LATER`` and, where the cluster smoother divides the padded
    nodes, the smoother's plan of every element (a tree that sums it by
    chunks: its first chunk) accumulating; a tree without K8's write form
    builds its plans without their rows."""
    from fcvm_tpu_torch import FcvmConfig
    from fcvm_tpu_torch.ops import kernels
    from fcvm_tpu_torch.ops import precond as pre
    from fcvm_tpu_torch.runtime.backend import TorchSystem

    cfg = FcvmConfig(device="cuda", dtype="float32")
    be = TorchSystem(model, cfg, torch.float32, torch.device("cuda"))
    sp, nn = be.space, be.ndof_pad // 3
    sites = [("internal force", be.node_plan, nn, (3,), "write", False),
             ("block Jacobi", sp.jacobi_plan, nn, (3, 3), "write", False)]
    csz = cfg.resolve_cluster_size(model.mesh.n_nodes)
    qmat = pre.qmat_bc(sp.coords_m, sp.fixmask_m, csz, cfg.coarse_modes)
    ncl, nm = qmat.shape[0] // csz, qmat.shape[2]
    for start in (0, COARSE_LATER):
        keys = pre.coarse_keys(sp.elnodes_m[start:start + pre.COARSE_CHUNK], csz, ncl)
        sites.append((f"coarse accumulate, chunk of {pre.COARSE_CHUNK} elements from {start}",
                      kernels.segment_plan(keys), ncl * ncl, (nm * nm,), "accumulate", False))
    cs = cfg.smoother_cluster_nodes
    if nn % cs == 0:
        nrow = (nn // cs) * 3 * cs * cs
        chunk = getattr(pre, "SMOOTHER_CHUNK", None)  # a tree that sums the smoother by chunks
        if chunk:
            key, site = (pre.cluster_diag_keys(sp.elnodes_m[:chunk], cs, nrow),
                         f"smoother blocks, first chunk of {chunk} elements")
        else:  # the blocks' rows [e, 3i + a, j]
            key, site = (pre.cluster_diag_keys(sp.elnodes_m, cs, nrow).transpose(2, 3),
                         "smoother blocks, every element")
        sites.append((site, kernels.segment_plan(key, drop=nrow), nrow + 1, (3,), "accumulate",
                      True))
    return sites


def run_column(cfg, nstep=COL_NSTEP, label="phase 9", required=(*CG_KERNELS, *BLOCK_KERNELS),
               absent=("block_matmat",)):
    """Drive ``solve_collapse`` on the imperfect beam-column at 451,875 dof
    (buckling, seeding, ``nstep`` GNL steps) with the launch counts set to
    0 just before it; print the eigensolve and the steps, apply the checks
    (the kernels ``required`` launched, those ``absent`` not, and where the
    tree counts K6 by form, K6's deflated block form: the eigensolve's
    solves deflated by its Ritz space) and return the launch counts, the
    times, the factors and the peak device memory."""
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
    stats = cg_stats_reset()
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
    check(all(launches[k] == 0 for k in absent), f"{label}: {absent} launched on the path")
    from fcvm_tpu_torch.ops import kernels

    if hasattr(kernels.cg_iteration, "forms"):  # a tree that counts K6 by form
        check(by_dtype["cg_iteration forms"].get("block deflated", 0) > 0,
              f"{label}: K6's deflated block form was not launched (harvests "
              f"{[r['harvest'] for r in tiers]})")
    if hasattr(kernels, "form_blocks_ref"):  # the pencil's -G_hat through K3's geometric form
        check(by_dtype["form_blocks forms"].get("geometric", 0) > 0,
              f"{label}: K3's geometric form was not launched")
    print(f"launches by dtype (K0m, K1m and K4m by dtype and m) {by_dtype}")
    inner = sum(sum(map(sum, r["inner_iters"])) for r in tiers)
    print(f"CG loop, eigensolve (block iterations and their columns' inner CG {inner}): "
          f"{cg_loop_line(stats, inner, t['buckling'])}")
    k6_two_passes(launches, stats, label)
    return dict(launches=launches, by_dtype=by_dtype, buckling=t["buckling"],
                stepping=t["stepping"], wall=wall, factors=lam.tolist(), tiers=tiers,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def column_breakdown(cfg):
    """Print the CUDA-event time of each piece of the eigensolve on the
    beam-column at 451,875 dof: geometric-block formation, K_hat·V and
    -G_hat·V at m = 8 through K1m and through the chain it replaced
    (gather, K0m, K8, masks), the block preconditioner apply through K4m,
    through the torch steps it replaced and as 8 vector applies, and one
    pcg_block iteration through each against one pcg iteration (wall time
    per iteration over 20 iterations, host syncs included); then one
    pcg_block iteration deflated by the eigensolve's own space (a harvest of
    the first column, kd Ritz vectors), folded into K6's passes
    (``pcg_block(defl=)``), against the same iteration with the
    preconditioner wrapped in ``deflation.deflated`` and that deflation's
    three torch products alone; then the kernels 8 more iterations launch
    (torch.profiler, 9 iterations less 1 over 10 calls each, rounded: the
    tracer may lose the records of a profile's first call,
    :func:`kernel_launches`): the folded ones no torch kernel beyond the
    undeflated iteration's (checked), the wrapped ones the products'.  A tree without
    K1m (``tools/turns.py``) times its own path, the chain; a tree without
    the fold, the wrapped iteration alone.  Returns the rows."""
    from fcvm_tpu_torch.ops import assembly as asm
    from fcvm_tpu_torch.ops import deflation as dfl
    from fcvm_tpu_torch.ops import kernels
    from fcvm_tpu_torch.ops import solver as slv
    from fcvm_tpu_torch.runtime.backend import TorchSystem
    from fcvm_tpu_torch.runtime.buckling import STALL, _recycling_params

    col = column_model(COL_BIG, COL_W, COL_T)
    backend = TorchSystem(col, cfg, cfg.resolve_dtype(), cfg.resolve_device())
    coords = backend.tensor(col.mesh.coords)
    khat, pinv, _, rhs, *_ = backend.assemble_operator(coords)
    pc = backend.operator_pc(khat, pinv)
    del pinv
    ue = backend.solve(khat, pc, rhs, x0=backend.u_fix).x
    sig, *_ = backend.stress_update(coords, backend.gauss_full(1.0e30), torch.zeros_like(ue),
                                    ue, backend.gauss_zeros((6,)), 0.0)
    sp = backend.space

    def form():
        return asm.geometric_stiffness_blocks(coords, backend.elnodes, sig)

    nsm_t = form()[sp.eperm].permute(1, 2, 0).contiguous()
    fused = hasattr(kernels, "khat_matmat_ref")  # turns.py stubs an older tree's counts
    chain = {"kmv": old_multi_matvec(khat.esm_t, sp.eldofs_m, sp.fixmask_m),
             "minus_g": old_multi_matvec(nsm_t, sp.eldofs_m, sp.fixmask_m, False, True),
             "apply": pc.apply}  # an older tree's block apply is the chain
    if fused:
        mirrored = dense_coarse(pc.coarse_inv)  # the plain version's coarse inverse

        def chain_apply(r):  # K4m's plain version is the chain it replaced
            z_fine = None if pc.smooth_inv is None else pc.fine(r)
            return kernels.two_level_apply_block_ref(pc.pinv, pc.qmat, mirrored,
                                                     pc.fixmask, r, z_fine)

        chain["apply"] = chain_apply
        new = {"kmv": asm.make_multi_matvec(khat.esm_t, sp.eldofs_m, sp.fixmask_m,
                                            incidence=sp.incidence, packed=khat.packed),
               "minus_g": asm.make_multi_matvec(nsm_t, sp.eldofs_m, sp.fixmask_m, False, True,
                                                incidence=sp.incidence,
                                                packed=kernels.pack_blocks(nsm_t)),
               "apply": pc.apply}
    else:
        new = chain
    gen = torch.Generator(device="cuda").manual_seed(4)
    v = sp.fixmask_m[:, None] * torch.randn((backend.ndof_pad, 8), generator=gen,
                                            device="cuda", dtype=ue.dtype)
    cols = [v[:, c].contiguous() for c in range(8)]
    rows = [("geometric-block formation (ne, 30, 30) [median of 5]", cuda_ms(form, runs=5))]
    for key, what, kernel in (("kmv", "K_hat.V, m = 8", "K1m"),
                              ("minus_g", "-G_hat.V, m = 8", "K1m"),
                              ("apply", "preconditioner apply, block m = 8", "K4m")):
        if fused:
            rows += [(f"{what}, {kernel}", cuda_ms(new[key], v)),
                     (f"{what}, the chain before them", cuda_ms(chain[key], v))]
        else:
            rows.append((f"{what}, this tree's chain", cuda_ms(chain[key], v)))
    rows += [("K_hat.v, one column (K1)", cuda_ms(khat, cols[0])),
             ("preconditioner apply, 8 vectors (K4)",
              cuda_ms(lambda: [pc.apply(c) for c in cols]))]
    if hasattr(kernels, "coarse_product"):  # the coarse product alone, m = 8
        xc = v[:pc.coarse_inv.shape[0]].contiguous()
        rows += [("coarse product, m = 8, K4c", cuda_ms(kernels.coarse_product, pc.coarse_inv, xc)),
                 ("coarse product, m = 8, torch.mm of the dense inverse",
                  cuda_ms(torch.mm, dense_coarse(pc.coarse_inv), xc))]
        del xc
    b = new["minus_g"](v)

    def per_iteration(solve):
        walls = []
        for iters in (1, 21):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve(iters)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return 1e3 * (walls[1] - walls[0]) / 20

    def block(ops):
        return lambda iters: slv.pcg_block(ops["kmv"], b, precond=ops["apply"], rtol=1e-10,
                                           maxiter=iters)

    def single(iters):
        return slv.pcg(khat, b[:, 0].contiguous(), precond=pc.apply, rtol=1e-10, maxiter=iters)

    block(new)(1), block(chain)(1), single(1)
    if fused:
        rows += [("pcg_block iteration, m = 8 (wall), K1m and K4m", per_iteration(block(new))),
                 ("pcg_block iteration, m = 8 (wall), the chains before them",
                  per_iteration(block(chain)))]
    else:
        rows.append(("pcg_block iteration, m = 8 (wall), this tree's chains",
                     per_iteration(block(chain))))
    rows.append(("pcg iteration, one column (wall)", per_iteration(single)))
    # the block deflation fold the eigensolve leaves to torch products: its
    # own space (a harvest of the first column, its Ritz vectors on this
    # operator), one deflated pcg_block iteration and the products alone
    nstore, k_defl = _recycling_params(backend.ndof_pad, ue.element_size())
    res0, h = slv.pcg_harvest(khat, b[:, 0].contiguous(), precond=pc.apply, rtol=1e-10,
                              maxiter=2000, nstore=nstore, stall=STALL)
    alphas, betas, rzs = torch.stack([h.alphas, h.betas, h.rzs]).cpu().numpy()
    coef = dfl.ritz_coefficients(alphas, betas, rzs, res0.iters, k_defl)
    space = dfl.build_space(khat.esm_t, sp.eldofs_m, sp.fixmask_m, h.zs, coef, sp.incidence,
                            getattr(khat, "packed", None))
    del h, res0
    kd = space.w.shape[1]
    deflated = dfl.deflated(new["apply"], space)
    folds = "defl" in inspect.signature(slv.pcg_block).parameters

    def wrapped(iters):
        return slv.pcg_block(new["kmv"], b, precond=deflated, rtol=1e-10, maxiter=iters)

    def folded(iters):
        return slv.pcg_block(new["kmv"], b, precond=new["apply"], rtol=1e-10, maxiter=iters,
                             defl=space)

    if folds:
        folded(1)
        rows.append((f"pcg_block iteration, m = 8 (wall), deflated by the eigensolve's space, "
                     f"folded into K6's passes (kd = {kd}, {nstore} slots harvested)",
                     per_iteration(folded)))
    rows += [(f"pcg_block iteration, m = 8 (wall), deflated by the eigensolve's space (kd = "
              f"{kd}, {nstore} slots harvested)", per_iteration(wrapped)),
             (f"the deflation's three torch products alone, m = 8, kd = {kd}",
              cuda_ms(lambda: space.w @ (space.kw_inv @ (space.w.T @ v))))]
    if folds:  # the kernels of 8 iterations: 9 less 1, the same start and reads
        calls = 10  # a profile's first call may lose the records of its start's torch
        raw = {}  # kernels (kernel_launches), under half a launch a call over 10 calls

        def per_8(solve, name):
            (p9, o9), (p1, o1) = (kernel_launches(solve, n, calls=calls) for n in (9, 1))
            raw[name] = dict(o9), dict(o1)

            def each(nine, one):
                return Counter({k: n for k in nine.keys() | one.keys()
                                if (n := round((nine[k] - one[k]) / calls)) > 0})

            return each(p9, p1), each(o9, o1)

        fp, fo = per_8(folded, "folded")
        _, uo = per_8(block(new), "undeflated")
        _, wo = per_8(wrapped, "wrapped")
        print(f"kernels of 8 more pcg_block iterations, m = 8 (torch.profiler, 9 iterations less "
              f"1, over {calls} calls each): folded: the port's {dict(fp)}, others {dict(fo)}; "
              f"undeflated: others {dict(uo)}; wrapped in deflation.deflated: others "
              f"{dict(wo)}; raw totals of the other kernels, 9 / 1 iterations: {raw}")
        check(fp["cg_pass_update_kernel"] >= 8 and fp["cg_pass_direction_kernel"] >= 8,
              "phase 9b: the profile of the folded iterations recorded no K6 pass")
        check(fo == uo, f"phase 9b: the folded deflated iterations launched torch kernels beyond "
                        f"the undeflated ones' ({dict(fo - uo)})")
    del space, deflated
    print("CUDA-event times, median of 20 runs unless marked:")
    for name, ms in rows:
        print(f"{name}: {ms:.4f} ms")
    del khat, pc, nsm_t, new, chain
    torch.cuda.empty_cache()
    return dict(rows)


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
    check(all(launches[k] > 0 for k in CG_KERNELS),
          "phase 10: K1, K4, K8, K6, K2, K3 or K5 was not launched")
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
              f"lbd {np.round(lbd[dev], 6).tolist()}, K1, K4, K8, K6, K2, K3 and K5 launches "
              f"{launches}")
        check(all((n > 0) == (dev == "cuda") for n in launches.values()),
              f"phase 10b: K1, K4, K8, K6, K2, K3 and K5 launches {launches} on {dev}")
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


def accumulate_split(esm_m, sp, qmat, csz, cs):
    """The two-level build's accumulations on the Morton blocks ``esm_m``:
    each whole (``coarse_accumulate``, ``cluster_diag_blocks``), then in
    pieces over all of its chunks: the keys and their plans
    (``segment_plan``), their device time alone (torch.profiler; the rest
    of their time is the host's: its calls and its reads, which it waits
    on), their stable sort alone; and, where the tree splits them out, the
    pair products and K8's accumulating sums over plans made before.  The
    smoother's blocks are one plan over every element's rows, or, in a
    tree that sums them by chunks (``SMOOTHER_CHUNK``), a plan a chunk.
    CUDA-event medians of 5.  Returns ``{table: {piece: ms}}``."""
    from fcvm_tpu_torch.ops import kernels
    from fcvm_tpu_torch.ops import precond as pre

    ncl, nm, ne = qmat.shape[0] // csz, qmat.shape[2], esm_m.shape[0]
    nrow = (sp.fixmask_m.shape[0] // 3) * 3 * cs
    split = hasattr(pre, "coarse_pairs")  # the coarse pair products as a function of their own
    chunk = getattr(pre, "SMOOTHER_CHUNK", None)
    smoother_parts = ([(s, s + chunk) for s in range(0, ne, chunk)] if chunk else [(0, ne)])
    tables = {
        "coarse": ([(s, s + pre.COARSE_CHUNK) for s in range(0, ne, pre.COARSE_CHUNK)],
                   lambda: pre.coarse_accumulate(esm_m, sp.elnodes_m, qmat, csz),
                   split and (lambda a, b: pre.coarse_pairs(esm_m[a:b], sp.elnodes_m[a:b], qmat)),
                   lambda a, b: pre.coarse_keys(sp.elnodes_m[a:b], csz, ncl), None,
                   lambda: torch.zeros((ncl * ncl, nm * nm), dtype=esm_m.dtype, device="cuda")),
        "smoother": (smoother_parts,
                     lambda: pre.cluster_diag_blocks(esm_m, sp.elnodes_m, sp.fixmask_m, cs),
                     not chunk and (lambda a, b: esm_m.reshape(-1, 3)),
                     lambda a, b: (pre.cluster_diag_keys(sp.elnodes_m[a:b], cs, nrow)
                                   if chunk else pre.cluster_diag_keys(sp.elnodes_m, cs, nrow)
                                   .transpose(2, 3)), nrow,
                     lambda: torch.zeros((nrow + 1, 3), dtype=esm_m.dtype, device="cuda")),
    }
    out = {}
    for name, (parts, whole, pairs_of, keys_of, drop, zeros) in tables.items():
        keys = [keys_of(a, b) for a, b in parts]

        def plans():
            return [kernels.segment_plan(keys_of(a, b), drop=drop) for a, b in parts]

        out[name] = {
            "whole": cuda_ms(whole, runs=5),
            "keys and segment_plan": cuda_ms(plans, runs=5),
            "  their device time": device_ms(plans, calls=5),
            "  their stable sort": cuda_ms(lambda: [torch.sort(k.reshape(-1), stable=True)
                                                    for k in keys], runs=5),
            "chunks": len(parts),
        }
        if pairs_of:
            made, acc = plans(), zeros()
            pairs = [pairs_of(a, b) for a, b in parts]
            out[name]["pair products"] = cuda_ms(lambda: [pairs_of(a, b) for a, b in parts],
                                                 runs=5)
            out[name]["K8"] = cuda_ms(lambda: [kernels.segment_sum(p, pl, acc)
                                               for p, pl in zip(pairs, made)], runs=5)
            del pairs, made, acc
        del keys
    return out


def build_split(model, cfg):
    """Phase 11's build of the two-level preconditioner with ``cfg``'s
    smoother on ``model`` (float32): the whole build (wall, synchronised,
    median of 5) and :func:`accumulate_split`.  Returns ``{piece: ms}``
    and the split."""
    from fcvm_tpu_torch.runtime.backend import TorchSystem

    backend = TorchSystem(model, cfg, cfg.resolve_dtype(), cfg.resolve_device())
    khat, pinv, *_ = backend.assemble_operator(backend.tensor(model.mesh.coords))
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pc = backend.operator_pc(khat, pinv)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    sp = backend.space
    split = accumulate_split(khat.esm_t.permute(2, 0, 1).contiguous(), sp, pc.qmat,
                             cfg.resolve_cluster_size(model.mesh.n_nodes),
                             cfg.smoother_cluster_nodes)
    del backend, khat, pinv, pc
    torch.cuda.empty_cache()
    return {"build (wall, median of 5 after one)": float(np.median(walls[1:]))}, split


def smoother_breakdown(model, cfg):
    """Print the cluster smoother's pieces on ``model`` with ``cfg``
    (``smoother="cluster"``): the preconditioner build with and without it
    (wall, synchronised) and the device memory each adds, the coarse table's
    accumulate, the smoother's accumulate and its batched Cholesky inverse
    alone, and the apply of the
    fine level and of the whole preconditioner against block Jacobi's, in
    the run's dtype and with the inverses in float64; CUDA-event medians
    against the bound of reading the inverses once."""
    import dataclasses

    from fcvm_tpu_torch.ops import assembly as asm
    from fcvm_tpu_torch.ops import precond as pre
    from fcvm_tpu_torch.runtime.backend import TorchSystem

    backend = TorchSystem(model, cfg, cfg.resolve_dtype(), cfg.resolve_device())
    khat, pinv, _, rhs, *_ = backend.assemble_operator(backend.tensor(model.mesh.coords))
    builds = {}
    for name, c in (("jacobi3", dataclasses.replace(cfg, smoother="jacobi3")), ("cluster", cfg)):
        backend.cfg = c
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pc = backend.operator_pc(khat, pinv)
        torch.cuda.synchronize()
        builds[name] = (time.perf_counter() - t0, (torch.cuda.memory_allocated() - base) / 2**20,
                        (torch.cuda.max_memory_allocated() - base) / 2**20)
    backend.cfg = cfg
    check(pc.smooth_inv is not None, "phase 11: the cluster smoother was not built")
    sp, cs = backend.space, cfg.smoother_cluster_nodes
    esm_m = khat.esm_t.permute(2, 0, 1).contiguous()
    del khat, pinv
    ncl, m, _ = pc.smooth_inv.shape
    blocks = pre.cluster_diag_blocks(esm_m, sp.elnodes_m, sp.fixmask_m, cs)
    csz = cfg.resolve_cluster_size(model.mesh.n_nodes)
    split = accumulate_split(esm_m, sp, pc.qmat, csz, cs)
    rows = [
        *((f"{table} accumulate by K8, fixed order: {piece}, its {pieces['chunks']} plans "
           "[median of 5]", ms)
          for table, pieces in split.items() for piece, ms in pieces.items()
          if piece != "chunks"),
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
    check(all(launches[k] > 0 for k in CG_KERNELS),
          "phase 12: K1, K4, K8, K6, K2, K3 or K5 was not launched")
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
        check(sh["launches"]["khat_matmat"] > 0 and sh["launches"]["block_matmat"] == 0,
              "phase 13: K1m was not launched on the sharded plate, or K0m was")
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
    khat = be.assemble_operator(be.tensor(big.mesh.coords))[0]
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
    check(all(o["launches"][k] > 0 for o in outs for k in (*CG_KERNELS, "khat_matmat")),
          "phase 13b: K1, K4, K8, K6, K2, K3, K5 or K1m was not launched on a rank")
    check(all(o["launches"]["block_matmat"] == 0 for o in outs),
          "phase 13b: K0m was launched on a rank")
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
    stats = cg_stats_reset()
    rc = bench.main(["--no-same-size"], emit=lines.append)
    launches = read_launches()[0]
    k6_two_passes(launches, stats, "phase 14")
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
          f"{sh['lbd_tol']:g}), decisions {sh['decisions_local']} / {sh['decisions_sharded']}, "
          f"first-step margins {sh['first_step_margin_local']:.2f} / "
          f"{sh['first_step_margin_sharded']:.2f} (at least {sh['first_step_margin_min']:g}); "
          f"launches in the bench: {launches}")
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
    # the capacity rows solve once and evaluate no residual: K2 in the others
    check(all(r["launches"][k] > 0 for name, r in rows.items() for k in CG_KERNELS
              if k not in ("stress_update", "node_force") or not name.startswith("capacity")),
          "phase 14: a row of the bench did not launch K1, K4, K8, K6, K3 or K5, or one with "
          "residuals K2")
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

    phase(f"3c K1, K4 and K8 vs plain, the chain they replaced and cuSPARSE, on the plate's "
          f"and the beam-column's operators ({smi})")
    t0 = time.perf_counter()
    big = plate_model(PLATE_BIG)
    print(f"plate: {big.mesh.n_nodes} nodes, {big.mesh.n_elements} elements, "
          f"{big.mesh.ndof} dof (mesh built in {time.perf_counter() - t0:.1f} s)")
    check(big.mesh.ndof == NDOF_BIG and big.mesh.n_elements == NE_BIG, "unexpected mesh size")
    cg_models = {"plate": big, "column": column_model(COL_BIG, COL_W, COL_T)}
    cg_rows = cg_kernel_phase(cg_models)
    k8 = k8_phase(cg_models)

    phase(f"3d K1m and K4m vs plain, the chains they replaced and cuSPARSE, on the plate's and "
          f"the beam-column's operators ({smi})")
    block_rows = block_kernel_phase(cg_models)

    phase(f"3e K6, the CG iteration's passes, vs plain, the torch chain it replaced and the "
          f"deflation's products; the CG_BATCH sweep ({smi})")
    k6 = k6_phase(cg_models)

    phase(f"3f K2's element pass and node pass, vs plain and their bounds; the residual "
          f"through both against the unfused composition ({smi})")
    k2 = k2_phase(cg_models, smi)

    phase(f"3g K3 and K5, the element blocks and the block-Jacobi rebuild, vs plain and their "
          f"bounds, at the paths' shapes ({smi})")
    form = form_phase(cg_models, smi)
    del cg_models

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

    phase("5b phase 5 again: the same counts and load factors, bit for bit")
    again = run_plate(big, cfg, "phase 5b")
    counts = [[(s["newton"], s["cg"]) for s in r["cg_stats"]["steps"]] for r in (off, again)]
    print(f"Newton and CG counts per step equal: {counts[0] == counts[1]}; load factors equal "
          f"bit for bit: {np.array_equal(off['lbd'], again['lbd'])}; CG iterations "
          f"{off['cg_stats']['iters']} / {again['cg_stats']['iters']}; stepping "
          f"{off['stepping']:.2f} / {again['stepping']:.2f} s")
    check(counts[0] == counts[1], "phase 5b: Newton or CG counts differ from phase 5's")
    check(np.array_equal(off["lbd"], again["lbd"]), "phase 5b: load factors differ from phase 5's")
    del again

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

    phase("9c phase 9 with the cluster smoother (smoother=\"cluster\"), float32")
    builds = COARSE_BUILD_STATS["smoother_builds"]
    col_cl = run_column(FcvmConfig(device="cuda", dtype="float32", smoother="cluster"),
                        label="phase 9c")
    built = COARSE_BUILD_STATS["smoother_builds"] - builds

    def served(run):  # (dtype, sweeps) of the tier that served
        return [(r["dtype"], r["sweeps"]) for r in run["tiers"] if r["error"] is None]

    def inner(run):  # the eigensolve's inner CG iterations, by tier
        return [sum(map(sum, r["inner_iters"])) for r in run["tiers"]]

    print(f"cluster smoother vs phase 9 ({smi}): smoother builds {built}; eigensolve "
          f"{col_cl['buckling']:.2f} / {col['buckling']:.2f} s, served by {served(col_cl)} / "
          f"{served(col)} (dtype, sweeps); inner CG iterations by tier {inner(col_cl)} / "
          f"{inner(col)}; factors {col_cl['factors']} / {col['factors']}; stepping "
          f"{col_cl['stepping']:.2f} / {col['stepping']:.2f} s; whole run {col_cl['wall']:.2f} / "
          f"{col['wall']:.2f} s; peak device memory {col_cl['peak_gib']:.2f} / "
          f"{col['peak_gib']:.2f} GiB")
    check(built >= 1, "phase 9c: no cluster smoother was built")

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

    paths = {"plate": off, "default": on, "gnl": gnl, "column": col, "column_cluster": col_cl,
             "case": case,
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
        "source_also": "fcvm_tpu_torch/csrc/bulk.cuh, segment.cuh; packed by "
                       "fcvm_tpu_torch/ops/kernels.py:pack_blocks",
        "replaces": "fcvm_tpu/ops/assembly.py:525",
        "replaces_also": "fcvm_tpu/ops/assembly.py:576 (make_bc_matvec), :386 "
                         "(scatter_node_rows); XLA-lowered",
        "launches": off["launches"]["khat_matvec"], **path_launches("khat_matvec"),
        "launches_column_by_dtype": col["by_dtype"]["khat_matvec"],
        "dtype": "float32", "model": "plate", "variant": "masked",
        **cg_rows[("khat_matvec", "float32", "plate", "masked")],
        "shapes": cg_shapes("khat_matvec"),
    }, {
        "name": "cg_iteration", "route": "cuda", "source": "fcvm_tpu_torch/csrc/cg_iteration.cu",
        "source_also": "its plan and plain version fcvm_tpu_torch/ops/kernels.py:cg_plan, "
                       "cg_iteration_ref; its loop fcvm_tpu_torch/ops/solver.py (CG_BATCH)",
        "replaces": "fcvm_tpu/ops/solver.py:107",
        "replaces_also": "the body and cond of the lax.while_loop of pcg and pcg_harvest "
                         "(fcvm_tpu/ops/solver.py:107-122, :175-197), the products of "
                         "fcvm_tpu/ops/deflation.py:74 (deflated), the same body and those "
                         "products under the vmap of fcvm_tpu/runtime/buckling.py:552 (the "
                         "block form, deflated by the eigensolve's Ritz space); XLA-lowered",
        "launches": off["launches"]["cg_iteration"], **path_launches("cg_iteration"),
        "launches_by_pass": {k: v["by_dtype"]["cg_iteration passes"] for k, v in paths.items()
                             if "by_dtype" in v},
        "launches_by_form": {k: v["by_dtype"]["cg_iteration forms"] for k, v in paths.items()
                             if "by_dtype" in v},
        "block_deflated": {"form": "m=8 deflated", "kd": K6_KD["column"],
                           "float32": k6[("float32", "column", "m=8 deflated")],
                           "float64": k6[("float64", "column", "m=8 deflated")]},
        "host_loop": "the sharded backend's node-partitioned PCG (config.node_partition, in "
                     "no phase) passes its own inner product and keeps the host loop",
        "dtype": "float32", "model": "plate", "form": "vector",
        **k6[("float32", "plate", "vector")],
        "shapes": [{"dtype": dt, "model": mo, "form": f, **row}
                   for key, row in k6.items() if key != "sweep" for dt, mo, f in [key]],
        "cg_batch_sweep": k6["sweep"],
    }, {
        "name": "stress_update", "route": "cuda", "source": "fcvm_tpu_torch/csrc/stress_update.cu",
        "pass": "element",
        "source_also": "fcvm_tpu_torch/csrc/bulk.cuh; its plain version "
                       "fcvm_tpu_torch/ops/kernels.py:stress_update_ref; its node sum K2's node "
                       "pass (node_force)",
        "replaces": "fcvm_tpu/ops/stress_update.py:66",
        "replaces_also": "_element_stress_update_hp, update_stress_load, "
                         "internal_force_from_stress (fcvm_tpu/ops/stress_update.py:66-195), "
                         "radial_return and von_mises (fcvm_tpu/ops/material.py:52-88), "
                         "tet10_element_geometry (fcvm_tpu/ops/elements.py:126); XLA-lowered",
        "launches": off["launches"]["stress_update"], **path_launches("stress_update"),
        "launches_by_form": {k: v["by_dtype"]["stress_update forms"] for k, v in paths.items()
                             if "by_dtype" in v},
        "dtype": "float32", "model": "plate", "case": "update",
        **k2[("float32", "plate", "update")],
        "residual": k2["residual"],
        "shapes": [{"dtype": dt, "model": mo, "case": c, **row}
                   for key, row in k2.items() if key not in ("node", "residual")
                   for dt, mo, c in [key]],
    }, {
        "name": "node_force", "route": "cuda", "source": "fcvm_tpu_torch/csrc/stress_update.cu",
        "pass": "node",
        "source_also": "fcvm_tpu_torch/csrc/segment.cuh; K8's write-form plan; its plain "
                       "version fcvm_tpu_torch/ops/kernels.py:node_force_ref (the residual "
                       "form's: stress_residual_ref's tail)",
        "replaces": "fcvm_tpu/ops/stress_update.py:151",
        "replaces_also": "the segment_sum of update_stress_load and internal_force_from_stress "
                         "(fcvm_tpu/ops/stress_update.py:151-157) and the residual's tail "
                         "(fcvm_tpu/runtime/system.py:364-365); XLA-lowered",
        "launches": off["launches"]["node_force"], **path_launches("node_force"),
        "launches_by_form": {k: v["by_dtype"]["node_force forms"] for k, v in paths.items()
                             if "by_dtype" in v},
        "dtype": "float32", "model": "plate", "form": "residual",
        **k2["node"][("float32", "plate", "residual")],
        "shapes": [{"dtype": dt, "model": mo, "form": f, **row}
                   for (dt, mo, f), row in k2["node"].items()],
    }, {
        "name": "form_blocks", "route": "cuda", "source": "fcvm_tpu_torch/csrc/form_blocks.cu",
        "source_also": "fcvm_tpu_torch/csrc/tet10.cuh (K2's Gauss-point geometry); its plain "
                       "version fcvm_tpu_torch/ops/kernels.py:form_blocks_ref (the einsum chain "
                       "and pack_blocks)",
        "replaces": "fcvm_tpu/ops/assembly.py:59",
        "replaces_also": "_single_elastic_esm / elastic_stiffness_blocks "
                         "(fcvm_tpu/ops/assembly.py:59-74, :105-114), _single_tangent_esm / "
                         "tangent_stiffness_blocks (:117-162), _single_geometric_nsm / "
                         "geometric_stiffness_blocks (:165-188); XLA-lowered",
        "launches": off["launches"]["form_blocks"], **path_launches("form_blocks"),
        "launches_by_form": {k: v["by_dtype"]["form_blocks forms"] for k, v in paths.items()
                             if "by_dtype" in v},
        "launches_by_output": {k: v["by_dtype"]["form_blocks outputs"]
                               for k, v in paths.items() if "by_dtype" in v},
        "dtype": "float32", "model": "plate", "case": "tangent refresh",
        **form["form_blocks"][("float32", "plate", "tangent refresh")],
        "shapes": [{"dtype": dt, "model": mo, "case": c, **row}
                   for (dt, mo, c), row in form["form_blocks"].items()],
    }, {
        "name": "jacobi_inverse", "route": "cuda",
        "source": "fcvm_tpu_torch/csrc/jacobi_inverse.cu",
        "source_also": "its plain version fcvm_tpu_torch/ops/kernels.py:jacobi_inverse_ref (the "
                       "diagonal slice, K8's write form, the torch tail)",
        "replaces": "fcvm_tpu/ops/assembly.py:614",
        "replaces_also": "block_jacobi_inverse_blocks (fcvm_tpu/ops/assembly.py:614-633): the "
                         "slice, its segment_sum, the mask and inv3; XLA-lowered",
        "launches": off["launches"]["jacobi_inverse"], **path_launches("jacobi_inverse"),
        "launches_by_form": {k: v["by_dtype"]["jacobi_inverse forms"] for k, v in paths.items()
                             if "by_dtype" in v},
        "dtype": "float32", "model": "plate", "case": "refresh",
        **form["jacobi_inverse"][("float32", "plate", "refresh")],
        "shapes": [{"dtype": dt, "model": mo, "case": c, **row}
                   for (dt, mo, c), row in form["jacobi_inverse"].items()],
    }, {
        "name": "segment_sum", "route": "cuda", "source": "fcvm_tpu_torch/csrc/segment_sum.cu",
        "replaces": "fcvm_tpu/ops/assembly.py:386",
        "replaces_also": "fcvm_tpu/ops/assembly.py:324 (ScatterPlan), "
                         "fcvm_tpu/ops/stress_update.py:151 (segment_sum); XLA-lowered",
        "launches": off["launches"]["segment_sum"], **path_launches("segment_sum"),
        "launches_column_by_dtype": col["by_dtype"]["segment_sum"],
        "launches_by_path": {k: v["by_dtype"]["segment_sum paths"] for k, v in paths.items()
                             if "by_dtype" in v},
        "dtype": "float32", "model": "plate", "site": "internal force",
        **k8[("float32", "plate", "internal force")],
        "shapes": [{"dtype": dt, "model": m, "site": site, **row}
                   for (dt, m, site), row in k8.items()],
    }, {
        "name": "two_level_apply", "route": "cuda", "source": "fcvm_tpu_torch/csrc/two_level.cu",
        "source_also": "its coarse product K4c on the packed upper tiles of "
                       "fcvm_tpu_torch/ops/kernels.py:pack_coarse (coarse_* keys: K4c alone, "
                       "torch.mv of the dense inverse, the triangle's bound)",
        "replaces": "fcvm_tpu/ops/precond.py:108",
        "replaces_also": "the coarse product at fcvm_tpu/ops/precond.py:137; XLA-lowered",
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
        "name": "khat_matmat", "route": "cuda", "source": "fcvm_tpu_torch/csrc/khat_matmat.cu",
        "source_also": "fcvm_tpu_torch/csrc/packed.cuh, bulk.cuh, ring.cuh, segment.cuh; K1's "
                       "packed blocks and incidence table, K1m's compacted tables",
        "replaces": "fcvm_tpu/runtime/buckling.py:292",
        "replaces_also": "fcvm_tpu/ops/deflation.py:166 (block_khat_matvec), "
                         "fcvm_tpu/ops/pallas_kernels.py:60 under the vmap of "
                         "fcvm_tpu/runtime/buckling.py:552; XLA-lowered",
        "launches": col["launches"]["khat_matmat"], **path_launches("khat_matmat"),
        "launches_by_shape": col["by_dtype"]["khat_matmat"],
        "launches_sharded_column_by_shape": sharded["column"]["by_dtype"]["khat_matmat"],
        "dtype": "float32", "model": "column", "variant": "masked", "m": 8,
        **block_rows[("khat_matmat", "float32", "column", "masked", 8)],
        "shapes": [{"dtype": dt, "model": mo, "variant": v, "m": m, **row}
                   for (k, dt, mo, v, m), row in block_rows.items() if k == "khat_matmat"],
    }, {
        "name": "two_level_apply_block", "route": "cuda",
        "source": "fcvm_tpu_torch/csrc/two_level.cu",
        "source_also": "its coarse product K4c on m columns, on the packed upper tiles of "
                       "fcvm_tpu_torch/ops/kernels.py:pack_coarse (coarse_* keys: K4c alone, "
                       "torch.mm of the dense inverse, the triangle's bound)",
        "replaces": "fcvm_tpu/ops/precond.py:108",
        "replaces_also": "under the vmap of fcvm_tpu/runtime/buckling.py:552, its coarse "
                         "product at fcvm_tpu/ops/precond.py:137; XLA-lowered",
        "launches": col["launches"]["two_level_apply_block"],
        **path_launches("two_level_apply_block"),
        "launches_by_shape": col["by_dtype"]["two_level_apply_block"],
        "dtype": "float32", "model": "column", "variant": "jacobi3", "m": 8,
        **block_rows[("two_level_apply_block", "float32", "column", "jacobi3", 8)],
        "shapes": [{"dtype": dt, "model": mo, "variant": v, "m": m, **row}
                   for (k, dt, mo, v, m), row in block_rows.items()
                   if k == "two_level_apply_block"],
    }, {
        # K1m carries the block products: K0m runs on no path
        "name": "block_matmat", "route": "cuda",
        "source": "fcvm_tpu_torch/csrc/block_matmat.cu",
        "replaces": "fcvm_tpu/ops/pallas_kernels.py:60 under vmap; "
                    "fcvm_tpu/runtime/buckling.py:318",
        "path": "none: K1m carries K_hat.V and -G_hat.V; held against its plain version in "
                "phase 3",
        "launches": col["launches"]["block_matmat"], **path_launches("block_matmat"),
        "ne": NE_COL, "m": 8, **k0m[(torch.float32, NE_COL, 8)],
        "shapes": [{"dtype": str(dtype).removeprefix("torch."), "ne": ne, "m": m, **row}
                   for (dtype, ne, m), row in k0m.items()],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
