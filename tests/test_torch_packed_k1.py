"""K1's packed blocks on the CPU, float64.

On the card K1 reads each element block's upper triangle, packed tile by
tile (``kernels.pack_blocks``), so it needs symmetric blocks.

* The blocks are symmetric: elastic, tangent with plastic Gauss points, the
  GNL tangent on deformed coordinates, and geometric, each to 1e-12 of
  its largest entry.
* ``pack_blocks`` and ``unpack_blocks``: the upper triangle in row-major
  order, exact; the padding zero; ragged element counts; the round trip
  exact on symmetric blocks, in both tile sizes.
* ``khat_matvec_packed_ref``, the plain version of the kernel, against the
  JAX package's ``make_bc_matvec``/``make_matvec`` (its ``segment_sum`` and
  its ``ScatterPlan`` node sums) to 1e-12, masked and raw; the CPU path of
  the operators keeps reading the full blocks, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import E, F64, NU, t64

import fcvm_tpu
from fcvm_tpu.models import meshgen
from fcvm_tpu.ops import assembly as asm
from fcvm_tpu.ops import material as mat
from fcvm_tpu.runtime import system as sysm
from fcvm_tpu.utils.indexing import pad_ndof, pad_vector
from fcvm_tpu_torch.ops import assembly as tasm
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import material as tmat
from fcvm_tpu_torch.runtime import system as tsys

RTOL = 1e-12  # max |port - JAX| / max |JAX|: float64 sums in another order
SYM_RTOL = 1e-12  # max |K - K^T| / max |K|: the blocks' float64 rounding


def _close(got, want, rel=RTOL):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _asymmetry(esm):
    return float((esm - esm.transpose(1, 2)).abs().max() / esm.abs().max())


@pytest.fixture(scope="module")
def box_state():
    """A 3 x 2 x 2 box, its Hooke matrix, a small displacement field and a
    stress field of which about half the Gauss points are plastic."""
    mesh = meshgen.box_tet10(3, 2, 2, 10.0, 6.0, 6.0)
    rng = np.random.default_rng(5)
    coords = t64(mesh.coords)
    eln = t64(mesh.elnodes).long()
    sig = t64(rng.normal(scale=100.0, size=(mesh.n_elements, 4, 6)))
    pgp = torch.as_tensor(rng.uniform(size=(mesh.n_elements, 4)) > 0.5)
    disp = t64(0.05 * rng.normal(size=mesh.coords.shape))
    return dict(coords=coords, eln=eln, sig=sig, pgp=pgp, disp=disp,
                dmat=tmat.hooke_dmat(E, NU, F64, "cpu"))


@pytest.mark.parametrize("kind", ["elastic", "tangent", "gnl_tangent", "geometric"])
def test_blocks_are_symmetric(box_state, kind):
    """Packing keeps the upper triangle only, so every block the solver
    packs must be symmetric up to rounding: ``B^T D B``, ``B^T (D - fac s
    s^T) B`` at plastic points, the same on deformed coordinates, and
    ``m (x) I_3``."""
    s = box_state
    g, h = tmat.shear_modulus(E, NU), tmat.hardening_modulus(E, 0.1)
    if kind == "elastic":
        esm = tasm.elastic_stiffness_blocks(s["coords"], s["eln"], s["dmat"])
    elif kind == "geometric":
        esm = tasm.geometric_stiffness_blocks(s["coords"], s["eln"], s["sig"])
    else:
        coords = s["coords"] + (s["disp"] if kind == "gnl_tangent" else 0.0)
        assert bool(s["pgp"].any())
        esm = tasm.tangent_stiffness_blocks(coords, s["eln"], s["dmat"], s["sig"], s["pgp"],
                                            g, h)
    assert esm.dtype == F64 and float(esm.abs().max()) > 0.0
    assert _asymmetry(esm) <= SYM_RTOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("ne", [1, 127, 128, 256, 300, 513])
def test_pack_blocks_round_trip(dtype, ne):
    """The packed copy: (ceil(ne / E), 465, E), entry q of tile t, element
    k the upper-triangle entry (i_q, j_q) of element t E + k, exactly; the
    padding zero; unpacking symmetric blocks gives them back bit for bit;
    unpacking mirrors the upper triangle of blocks that are not."""
    tile = kernels.PACK_TILE[dtype]
    rng = np.random.default_rng(ne)
    a = torch.as_tensor(rng.normal(size=(30, 30, ne))).to(dtype)
    sym = (a + a.transpose(0, 1)).contiguous()
    packed = kernels.pack_blocks(sym)
    ntiles = -(-ne // tile)
    assert packed.shape == (ntiles, kernels.NPACK, tile) and packed.dtype == dtype
    assert packed.is_contiguous()
    iu = torch.triu_indices(30, 30)
    assert kernels.NPACK == iu.shape[1] == kernels.PACK_ROWS * 15
    flat = packed.transpose(0, 1).reshape(kernels.NPACK, ntiles * tile)
    assert torch.equal(flat[:, :ne], sym[iu[0], iu[1]])
    assert not bool(flat[:, ne:].any())
    i, j = iu[:, 37].tolist()  # a spot check of the row-major order
    assert (i, j) == (1, 8) and torch.equal(packed[0, 37, :min(ne, tile)], sym[1, 8, :tile])
    assert torch.equal(kernels.unpack_blocks(packed, ne), sym)
    up = kernels.unpack_blocks(kernels.pack_blocks(a.contiguous()), ne)
    assert torch.equal(up[iu[0], iu[1]], a[iu[0], iu[1]])
    assert torch.equal(up, up.transpose(0, 1))


def test_pack_blocks_rejects_what_it_does_not_take():
    with pytest.raises(ValueError):
        kernels.pack_blocks(torch.zeros((30, 29, 4)))
    with pytest.raises(TypeError):
        kernels.pack_blocks(torch.zeros((30, 30, 4), dtype=torch.float16))
    with pytest.raises(ValueError):
        kernels.unpack_blocks(torch.zeros((2, 465, 256)), 100)


@pytest.fixture(scope="module")
def box():
    """A 3 x 2 x 2 box clamped on x = 0 (525 dof, padded to 768) in the JAX
    package's Morton solve space, its blocks in that element order and
    packed, and the port's solve space of the same mesh."""
    mesh = meshgen.box_tet10(3, 2, 2, 10.0, 6.0, 6.0)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, 0.0, 0.0))])
    nd = pad_ndof(mesh.ndof)
    fixmask = jnp.asarray(pad_vector(bcs.masks(mesh.ndof)[0], nd))
    esm = asm.elastic_stiffness_blocks(jnp.asarray(mesh.coords), jnp.asarray(mesh.elnodes),
                                       mat.hooke_dmat(jnp.float64(E), jnp.float64(NU)))
    space = sysm.build_solve_space(mesh.coords, mesh.elnodes, fixmask, nd)
    tspace = tsys.build_solve_space(mesh.coords, mesh.elnodes, t64(fixmask), nd)
    esm_m = esm[space.eperm]
    esm_t = t64(esm_m).permute(1, 2, 0).contiguous()
    return dict(mesh=mesh, nd=nd, space=space, tspace=tspace, esm_m=esm_m, esm_t=esm_t,
                packed=kernels.pack_blocks(esm_t), eldofs_m=asm.element_dof_ids(space.elnodes_m))


@pytest.mark.parametrize("reference", ["segment_sum", "scatter_plan"])
@pytest.mark.parametrize("form", ["masked", "raw"])
def test_packed_plain_matches_jax(box, form, reference):
    """``khat_matvec_packed_ref`` on a vector that is non-zero on every dof against the JAX
    package's ``make_bc_matvec`` (masked) and ``make_matvec`` (raw), with
    its plain node sum and with its ``ScatterPlan``, to 1e-12."""
    sp, tsp, nd = box["space"], box["tspace"], box["nd"]
    plan = sp.plan_m if reference == "scatter_plan" else None
    u = np.random.default_rng(3).normal(size=nd)
    if form == "masked":
        want = asm.make_bc_matvec(box["esm_m"], box["eldofs_m"], sp.fixmask_m, plan)(
            jnp.asarray(u))
        fm = tsp.fixmask_m
    else:
        want = asm.make_matvec(box["esm_m"], box["eldofs_m"], nd, plan)(jnp.asarray(u))
        fm = None
    _close(kernels.khat_matvec_packed_ref(box["packed"], tsp.incidence, t64(u), fm), want)


@pytest.mark.parametrize("form", ["masked", "raw"])
def test_cpu_operators_keep_reading_the_full_blocks(box, form):
    """On CPU tensors the wrapper and the operators read the full blocks,
    the operators even when given the packed copy, so CPU results keep
    their bits, and the wrapper launches nothing; the
    packed plain version is the same chain on the unpacked blocks."""
    tsp, esm_t, packed = box["tspace"], box["esm_t"], box["packed"]
    u = t64(np.random.default_rng(4).normal(size=box["nd"]))
    fm = tsp.fixmask_m if form == "masked" else None
    full = kernels.khat_matvec_ref(esm_t, tsp.incidence, u, fm)
    launches = kernels.khat_matvec.launches
    assert torch.equal(kernels.khat_matvec(esm_t, tsp.incidence, u, fm), full)
    assert kernels.khat_matvec.launches == launches
    if fm is None:
        op = tasm.make_matvec(esm_t, tsp.eldofs_m, box["nd"], tsp.incidence, packed)
    else:
        op = tasm.make_bc_matvec(esm_t, tsp.eldofs_m, fm, tsp.incidence, packed)
    assert torch.equal(op(u), full)
    unpacked = kernels.unpack_blocks(packed, esm_t.shape[2])
    assert torch.equal(kernels.khat_matvec_packed_ref(packed, tsp.incidence, u, fm),
                       kernels.khat_matvec_ref(unpacked, tsp.incidence, u, fm))
    _close(kernels.khat_matvec_packed_ref(packed, tsp.incidence, u, fm), full.numpy())


def test_operator_packs_only_on_the_card(box):
    """``blocks_of`` and ``make_operator`` keep no packed copy for CPU
    tensors (the CPU reads the full blocks); the wrapper refuses the packed copy on the CPU."""
    tsp = box["tspace"]
    op = tsys.make_operator(tasm.blocks_of(box["esm_t"].permute(2, 0, 1)), tsp)
    assert op.packed is None and torch.equal(op.esm_t, box["esm_t"])
    with pytest.raises(ValueError):
        kernels.khat_matvec(box["packed"], tsp.incidence, torch.zeros(box["nd"], dtype=F64))
