"""K0 and K0m, the port's CUDA block products: their plain versions against
the Pallas TPU kernel (interpret mode) and, for K0m, the eigensolve's block
einsum; and the port's K_hat·v (K1) against the JAX package's.  The CUDA
kernels themselves are tested in ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import E, NU, t64, ti

import fcvm_tpu
from fcvm_tpu.models import meshgen
from fcvm_tpu.ops import assembly as asm
from fcvm_tpu.ops import material as mat
from fcvm_tpu.ops import pallas_kernels as pk
from fcvm_tpu.utils.indexing import pad_ndof, pad_vector
from fcvm_tpu_torch.ops import assembly as tasm
from fcvm_tpu_torch.ops import kernels

# (numpy dtype, rtol, atol): f32 as tests/test_pallas_kernels.py; f64 to
# the rounding of a 30-term sum of O(1) products
CASES = {"float32": (np.float32, 2e-5, 1e-4), "float64": (np.float64, 1e-12, 1e-12)}


@pytest.mark.parametrize("dtype", list(CASES))
def test_block_matvec_plain_matches_pallas(dtype):
    np_dt, rtol, atol = CASES[dtype]
    rng = np.random.default_rng(0)
    ne = pk.ELEM_TILE  # one tile
    esm_t = rng.normal(size=(30, 30, ne)).astype(np_dt)
    ue_t = rng.normal(size=(30, ne)).astype(np_dt)
    ref = pk.block_matvec(jnp.asarray(esm_t), jnp.asarray(ue_t), interpret=True)
    launches = kernels.block_matvec.launches
    out = kernels.block_matvec(torch.as_tensor(esm_t), torch.as_tensor(ue_t))
    assert out.dtype == torch.as_tensor(esm_t).dtype
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=rtol, atol=atol)
    # CPU tensors take the plain version: no kernel launch is counted
    assert kernels.block_matvec.launches == launches


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("dtype", list(CASES))
def test_block_matmat_plain_matches_jax(dtype, m):
    """K0m's plain version on one tile of elements against K0 under
    ``jax.vmap`` over the columns (interpret mode) and against the block
    einsum of ``fcvm_tpu/runtime/buckling.py`` at HIGHEST precision."""
    np_dt, rtol, atol = CASES[dtype]
    rng = np.random.default_rng(m)
    ne = pk.ELEM_TILE
    esm_t = rng.normal(size=(30, 30, ne)).astype(np_dt)
    ue = rng.normal(size=(ne, 30, m)).astype(np_dt)
    cols = jnp.transpose(jnp.asarray(ue), (2, 1, 0))  # (m, 30, ne): K0's ue_t per column
    by_col = jax.vmap(lambda u: pk.block_matvec(jnp.asarray(esm_t), u, interpret=True))(cols)
    blocks = jnp.transpose(jnp.asarray(esm_t), (2, 0, 1)).reshape(ne, 10, 3, 30)
    by_einsum = jnp.einsum("eabj,ejm->eabm", blocks, jnp.asarray(ue),
                           precision=jax.lax.Precision.HIGHEST).reshape(ne, 30, m)
    launches = kernels.block_matmat.launches
    out = kernels.block_matmat(torch.as_tensor(esm_t), torch.as_tensor(ue))
    assert out.dtype == torch.as_tensor(ue).dtype and kernels.block_matmat.launches == launches
    np.testing.assert_allclose(out.numpy(), np.transpose(np.asarray(by_col), (2, 1, 0)),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(out.numpy(), np.asarray(by_einsum), rtol=rtol, atol=atol)


def _box_operator():
    mesh = meshgen.box_tet10(2, 2, 2, 10.0, 10.0, 10.0)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, 0.0, 0.0))]
    )
    eln = jnp.asarray(mesh.elnodes)
    dmat = mat.hooke_dmat(jnp.float64(E), jnp.float64(NU))
    esm = asm.elastic_stiffness_blocks(jnp.asarray(mesh.coords), eln, dmat)
    fixmask_np, _, _ = bcs.masks(mesh.ndof)
    fixmask = jnp.asarray(pad_vector(fixmask_np, pad_ndof(mesh.ndof)))
    return esm, asm.element_dof_ids(eln), fixmask


@pytest.mark.parametrize("reference", ["pallas", "xla"])
def test_bc_matvec_matches_jax(reference):
    """The port's K_hat·v (K1's plain version: gather, K0's plain version,
    ``index_add_``, the BC mask) against
    ``make_pallas_matvec`` and ``make_bc_matvec`` of the JAX package."""
    esm, eldofs, fixmask = _box_operator()
    make = pk.make_pallas_matvec if reference == "pallas" else asm.make_bc_matvec
    khat_ref = make(esm, eldofs, fixmask)
    khat = tasm.make_bc_matvec(t64(esm).permute(1, 2, 0).contiguous(), ti(eldofs),
                               t64(fixmask))
    u = np.random.default_rng(1).normal(size=fixmask.shape[0])
    np.testing.assert_allclose(khat(t64(u)).numpy(), np.asarray(khat_ref(jnp.asarray(u))),
                               rtol=1e-10, atol=1e-8)
