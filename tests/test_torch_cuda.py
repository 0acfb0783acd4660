"""The port's CUDA kernels on the card, against their plain versions.

Needs an NVIDIA GPU and ``nvcc``; every test skips where
``torch.cuda.is_available()`` is false.  The file imports neither JAX nor
the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from fcvm_tpu_torch.models import meshgen
from fcvm_tpu_torch.ops import assembly as tasm
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import material as tmat
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
