"""The port's CUDA kernels on the card, against their plain versions.

Needs an NVIDIA GPU and ``nvcc``; every test skips where
``torch.cuda.is_available()`` is false.  The file imports neither JAX nor
the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from fcvm_tpu_torch import FcvmConfig
from fcvm_tpu_torch.models import meshgen
from fcvm_tpu_torch.models.spec import BoundaryConditions, Loads, Material, Model
from fcvm_tpu_torch.ops import assembly as tasm
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import material as tmat
from fcvm_tpu_torch.ops.deflation import ritz_coefficients
from fcvm_tpu_torch.runtime.backend import TorchSystem
from fcvm_tpu_torch.tools import bw_probe
from fcvm_tpu_torch.utils.indexing import pad_ndof, pad_vector

pytestmark = pytest.mark.cuda

# max |kernel - plain| / max |plain|: f32 rounding of a 30-term sum, f64 the same
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("ne", [1, 5003])
def test_block_matvec_kernel_matches_plain(cuda, dtype, ne):
    """K0 on a ragged element count (no tile padding), counted once."""
    rng = np.random.default_rng(2)
    esm_t = torch.as_tensor(rng.normal(size=(30, 30, ne)), device=cuda).to(dtype)
    ue_t = torch.as_tensor(rng.normal(size=(30, ne)), device=cuda).to(dtype)
    launches = kernels.block_matvec.launches
    out = kernels.block_matvec(esm_t, ue_t)
    torch.cuda.synchronize()
    assert kernels.block_matvec.launches == launches + 1
    ref = kernels.block_matvec_ref(esm_t, ue_t)
    assert float((out - ref).abs().max()) <= TOL[dtype] * float(ref.abs().max())


def test_block_matvec_rejects_what_it_does_not_take(cuda):
    esm_t = torch.zeros((30, 30, 8), device=cuda)
    with pytest.raises(TypeError):
        kernels.block_matvec(esm_t, torch.zeros((30, 8), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        kernels.block_matvec(esm_t, torch.zeros((29, 8), device=cuda))
    with pytest.raises(ValueError):
        kernels.block_matvec(esm_t, torch.zeros((30, 8)))
    with pytest.raises(ValueError):
        kernels.block_matvec(esm_t.transpose(0, 1), torch.zeros((30, 8), device=cuda))


def test_bc_matvec_cuda_matches_cpu(cuda):
    """K_hat·v through K0 on the card against the plain path on the CPU,
    float64, on a 3x3x3 box with one face clamped."""
    mesh = meshgen.box_tet10(3, 3, 3, 10.0, 10.0, 10.0)
    nd = pad_ndof(mesh.ndof)
    fixed = 3 * mesh.select_nodes(lambda x, y, z: x < 1e-9)
    fixmask = np.ones(mesh.ndof)
    fixmask[np.concatenate([fixed, fixed + 1, fixed + 2])] = 0.0
    coords = torch.as_tensor(mesh.coords)
    eln = torch.as_tensor(mesh.elnodes.astype(np.int64))
    esm = tasm.elastic_stiffness_blocks(
        coords, eln, tmat.hooke_dmat(210000.0, 0.3, torch.float64, "cpu"))
    esm_t = esm.permute(1, 2, 0).contiguous()
    eldofs = tasm.element_dof_ids(eln)
    fm = torch.as_tensor(pad_vector(fixmask, nd))
    u = torch.as_tensor(np.random.default_rng(3).normal(size=nd))
    ref = tasm.make_bc_matvec(esm_t, eldofs, fm)(u)
    launches = kernels.block_matvec.launches
    out = tasm.make_bc_matvec(esm_t.to(cuda), eldofs.to(cuda), fm.to(cuda))(u.to(cuda))
    assert kernels.block_matvec.launches == launches + 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=1e-12 * float(ref.abs().max()))


@pytest.mark.parametrize("ne,tile", [(4096, 1024), (3000, 1000), (512, 512)])
def test_soa_matvec_kernel_matches_plain(cuda, ne, tile):
    """K0p, one thread block per tile, counted once."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    esm_t = torch.randn((30, 30, ne), generator=gen, device=cuda)
    ue_t = torch.randn((30, ne), generator=gen, device=cuda)
    launches = kernels.soa_matvec.launches
    out = kernels.soa_matvec(esm_t, ue_t, tile)
    torch.cuda.synchronize()
    assert kernels.soa_matvec.launches == launches + 1
    ref = kernels.soa_matvec_ref(esm_t, ue_t)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("rows,chunk_rows", [(1024, 16), (4096, 2048), (1000, 100)])
def test_bw_read_kernel_matches_plain(cuda, k, rows, chunk_rows):
    """Kbw on uniform [0, 1) data (no cancellation in the chunk sum),
    whole and cut sub-copies, counted once."""
    x = torch.rand((rows, 128), generator=torch.Generator(device=cuda).manual_seed(k),
                   device=cuda)
    launches = kernels.bw_read.launches
    out = kernels.bw_read(x, k, chunk_rows)
    torch.cuda.synchronize()
    assert kernels.bw_read.launches == launches + 1
    ref = kernels.bw_read_ref(x, chunk_rows)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("k", [1, 4, 8])
def test_bw_read_takes_a_full_read_time(cuda, k):
    """Kbw's result shows only the chunk heads, so its time is what shows
    that it copied every byte: on 512 MiB it takes at least the probe's
    ``MIN_FULL_READ_SHARE`` of the time of a plain full read (``x.sum()``)."""
    x = torch.rand((2**20, 128), generator=torch.Generator(device=cuda).manual_seed(k),
                   device=cuda)
    ms = bw_probe.cuda_ms(lambda: kernels.bw_read(x, k, bw_probe.CHUNK_ROWS))
    full_ms = bw_probe.cuda_ms(lambda: x.sum())
    assert ms >= bw_probe.MIN_FULL_READ_SHARE * full_ms, (ms, full_ms)


def test_probe_kernels_reject_what_they_do_not_take(cuda):
    esm_t, ue_t = torch.zeros((30, 30, 2000), device=cuda), torch.zeros((30, 2000), device=cuda)
    with pytest.raises(ValueError, match="multiple of tile"):
        kernels.soa_matvec(esm_t, ue_t, 1024)
    with pytest.raises(TypeError):
        kernels.soa_matvec(esm_t.double(), ue_t.double(), 1000)
    x = torch.zeros((256, 128), device=cuda)
    with pytest.raises(TypeError):
        kernels.bw_read(x.double(), 4, 16)
    with pytest.raises(ValueError, match="multiple of chunk_rows"):
        kernels.bw_read(x, 4, 100)
    with pytest.raises(ValueError):
        kernels.bw_read(x[:, :64].contiguous(), 4, 16)
    with pytest.raises(ValueError):
        kernels.bw_read(torch.zeros((128, 256), device=cuda)[:, ::2], 4, 16)


def _deflated_solve(device):
    """A deflated float64 solve of a 3x3x3 tension box on ``device``: harvest,
    Ritz space, then the deflated solve, all at cg_rtol 1e-12."""
    mesh = meshgen.box_tet10(3, 3, 3, 10.0, 10.0, 10.0)
    bcs = BoundaryConditions.from_node_sets([
        (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
        (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
        (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
    ])
    faces = mesh.faces_on(lambda x, y, z: x > 10.0 - 1e-9)
    loads = Loads(traction_faces=faces, tractions=np.tile([100.0, 0, 0], (len(faces), 1)))
    cfg = FcvmConfig(device=device, dtype="float64", cg_rtol=1e-12)
    be = TorchSystem(Model(mesh, Material(210000.0, 0.3), bcs, loads), cfg, torch.float64,
                     torch.device(device))
    esm, pinv, _, rhs, *_ = be.assemble(be.tensor(mesh.coords))
    khat, pc = be.operator(esm), be.make_pc(esm, pinv)
    res, h = be.solve_harvest(khat, pc, rhs, nstore=64)
    alphas, betas, rzs = torch.stack([h.alphas, h.betas, h.rzs]).cpu().numpy()
    defl = be.build_deflation(khat, h.zs, ritz_coefficients(alphas, betas, rzs, res.iters, 16))
    return res.iters, be.solve(khat, pc, rhs, defl=defl)


def test_deflated_solve_cuda_matches_cpu(cuda):
    """The deflation space built and applied on the card against the CPU:
    CG counts within one (atomic float64 sums in another order), the same
    solution."""
    h_cpu, ref = _deflated_solve("cpu")
    h_gpu, res = _deflated_solve("cuda")
    assert abs(h_gpu - h_cpu) <= 1 and abs(res.iters - ref.iters) <= 1
    assert res.iters < h_cpu
    x_ref = ref.x.numpy()
    np.testing.assert_allclose(res.x.cpu().numpy(), x_ref, rtol=0,
                               atol=1e-10 * np.abs(x_ref).max())
