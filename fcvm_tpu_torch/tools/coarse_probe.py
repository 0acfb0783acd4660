"""K4c, the symmetric coarse product of K4 and K4m, alone, on one NVIDIA
GPU, once.

    python -m fcvm_tpu_torch.tools.coarse_probe

Prints the registers and spills ``nvcc -Xptxas -v`` reports for each
instantiation of K4c's tile pass, on the CUDA cores and (8 columns in
float64) on the tensor cores (``csrc/two_level.cu``, compiled to an
object file under ``fcvm_tpu_torch/_build/``), then, on the 3x3x3 tension
box's two-level preconditioner in float32 (block Jacobi and the cluster
smoother of 16-node clusters), how far K4 and its plain version (whose
coarse product is cuBLAS's) each lie from the plain version in float64,
and K4c alone and ``torch.mv`` against float64; then, on a random
symmetric matrix of the plate's 12,264 coarse dofs, K4c at m = 1, 2, 4 and
8 columns in float32 and float64 against the dense product: its error,
whether a second call gives the same bits, its CUDA-event time (median of
20) beside ``torch.mv``/``torch.mm`` of the dense matrix and the bound of
reading its stored triangle once, and the device time of its tile and sum
passes (torch.profiler).  The first line is the card's ``nvidia-smi`` name
and power limit.  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from fcvm_tpu_torch import FcvmConfig
from fcvm_tpu_torch.models import meshgen
from fcvm_tpu_torch.models.spec import BoundaryConditions, Loads, Material, Model
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.runtime.backend import TorchSystem

NVCC = "/usr/local/cuda/bin/nvcc"
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
NCF = 12_264  # the 502,599-dof plate's coarse dofs: 12 modes on 1,022 clusters


def ms(fn, *args, runs=20):
    """Median of ``runs`` CUDA-event timings of one call (after a warm-up)."""
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


def by_kernel(fn, *args, calls=10):
    """``{kernel: mean device ms a call}`` over ``calls`` calls."""
    fn(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    return {ev.key.split("<")[0].split("::")[-1][:40]:
            round(ev.self_device_time_total / calls / 1e3, 4)
            for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA}


def registers():
    """ptxas's registers and spills of each instantiation of the tile pass."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([NVCC, "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                        "-Xptxas", "-v", "-c", str(kernels.CSRC / "two_level.cu"),
                        "-o", str(kernels.BUILD_DIR / "coarse_probe.o")],
                       capture_output=True, text=True, check=True)
    lines = r.stderr.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and "coarse_tiles_" in ln:
            name = ln.split("coarse_tiles_")[1][:16]
            print("coarse_tiles_", name, " | ".join(x.strip() for x in lines[i + 2:i + 4]))


def tension_box(n):
    """An n x n x n symmetry-constrained box pulled by 100 MPa on x = 10."""
    mesh = meshgen.box_tet10(n, n, n, 10.0, 10.0, 10.0)
    bcs = BoundaryConditions.from_node_sets([
        (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
        (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
        (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
    ])
    faces = mesh.faces_on(lambda x, y, z: x > 10.0 - 1e-9)
    loads = Loads(traction_faces=faces, tractions=np.tile([100.0, 0, 0], (len(faces), 1)))
    return Model(mesh, Material(210000.0, 0.3), bcs, loads)


def box_accuracy():
    """K4 and K4c in float32 on the box against float64 references."""
    for fine in ("jacobi3", "cluster"):
        cfg = FcvmConfig(device="cuda", dtype="float64", smoother=fine, smoother_cluster_nodes=16)
        be = TorchSystem(tension_box(3), cfg, torch.float32, torch.device("cuda"))
        pc = be.operator_pc(*be.assemble_operator(be.tensor(be.mesh.coords))[:2])
        r = torch.randn(be.ndof_pad, generator=torch.Generator(device="cuda").manual_seed(4),
                        device="cuda", dtype=torch.float32)
        z_fine = pc.fine(r) if fine == "cluster" else None
        args = (pc.pinv, pc.qmat, pc.coarse_inv, pc.fixmask, r, z_fine)
        out = kernels.two_level_apply(*args)
        ref = kernels.two_level_apply_ref(*args)
        p64 = kernels.PackedCoarse(pc.coarse_inv.tiles.double(), pc.coarse_inv.n)
        ref64 = kernels.two_level_apply_ref(
            pc.pinv.double(), pc.qmat.double(), p64, pc.fixmask.double(), r.double(),
            None if z_fine is None else z_fine.double())
        top = float(ref64.abs().max())
        dense = kernels.unpack_coarse(pc.coarse_inv)
        rc = torch.randn(dense.shape[0], device="cuda")
        zk, zl = kernels.coarse_product(pc.coarse_inv, rc), dense @ rc
        z64 = dense.double() @ rc.double()

        def rel(a, b, scale):
            return float((a.double() - b).abs().max()) / scale

        z_top = float(z64.abs().max())
        print(f"box {fine} f32 ncf={dense.shape[0]}: K4 vs plain f32 "
              f"{rel(out, ref.double(), top):.2e}, K4 vs f64 {rel(out, ref64, top):.2e}, "
              f"plain f32 vs f64 {rel(ref, ref64, top):.2e}; "
              f"K4c vs f64 {rel(zk, z64, z_top):.2e}, mv vs f64 {rel(zl, z64, z_top):.2e}; "
              f"out max {top:.3e}", flush=True)


def timings():
    """K4c on a random symmetric NCF x NCF matrix at 1, 2, 4 and 8 columns."""
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device="cuda").manual_seed(1)
        a = torch.randn((NCF, NCF), generator=gen, device="cuda", dtype=dtype) / NCF**0.5
        a = 0.5 * (a + a.T)
        packed = kernels.pack_coarse(a)
        tri = NCF * (NCF + 1) / 2 * a.element_size() / PEAK_BYTES * 1e3
        for m in (1, 2, 4, 8):
            x = torch.randn((NCF,) if m == 1 else (NCF, m), generator=gen, device="cuda",
                            dtype=dtype)
            fn = kernels.coarse_product
            y, again = fn(packed, x), fn(packed, x)
            ref = a @ x
            err = float((y - ref).abs().max() / ref.abs().max())
            t = ms(fn, packed, x)
            lib = ms(torch.mv if m == 1 else torch.mm, a, x)
            print(f"{dtype} n={NCF} m={m}: err {err:.2e} same {bool(torch.equal(y, again))} "
                  f"K4c {t:.4f} ms lib {lib:.4f} tri-bound {tri:.4f} ({tri / t:.1%}); by kernel "
                  f"{by_kernel(fn, packed, x)}", flush=True)
        del a, packed


def main():
    if not torch.cuda.is_available():
        raise SystemExit("coarse_probe: torch.cuda.is_available() is false")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    registers()
    kernels.build()
    box_accuracy()
    timings()


if __name__ == "__main__":
    main()
