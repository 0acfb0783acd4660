"""The port's CUDA kernels on the card, against their plain versions.

Needs an NVIDIA GPU and ``nvcc``; every test skips where
``torch.cuda.is_available()`` is false.  The file imports neither JAX nor
the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from fcvm_tpu_torch import ControlParams, FcvmConfig, linear_buckling, solve_collapse
from fcvm_tpu_torch.models import meshgen
from fcvm_tpu_torch.models.spec import BoundaryConditions, Loads, Material, Model
from fcvm_tpu_torch.ops import assembly as tasm
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import material as tmat
from fcvm_tpu_torch.ops import solver as tslv
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


def _cg_launches():
    """The launches so far of the kernels of the CG iteration, K1 and K4."""
    return kernels.khat_matvec.launches, kernels.two_level_apply.launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("ne", [1, 100, 1003, 5003, 103_680])
def test_block_matvec_kernel_matches_plain(cuda, dtype, ne):
    """K0 on element counts below one tile of its ring (1, 100), not a
    multiple of 4 (its one-value copies: 1003, 5003) and large enough that
    each persistent block walks many tiles (103,680); two launches in a row
    on different inputs, so stale ring contents would show; counted once
    each."""
    rng = np.random.default_rng(2)
    launches = kernels.block_matvec.launches
    for _ in range(2):
        esm_t = torch.as_tensor(rng.normal(size=(30, 30, ne)), device=cuda).to(dtype)
        ue_t = torch.as_tensor(rng.normal(size=(30, ne)), device=cuda).to(dtype)
        out = kernels.block_matvec(esm_t, ue_t)
        torch.cuda.synchronize()
        ref = kernels.block_matvec_ref(esm_t, ue_t)
        assert float((out - ref).abs().max()) <= TOL[dtype] * float(ref.abs().max())
    assert kernels.block_matvec.launches == launches + 2


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
    """K_hat·v through K1 on the card against the plain path on the CPU,
    float64, on a 3x3x3 box with one face clamped; and on a column of a
    block, which K1 reads after a copy."""
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
    launches = kernels.khat_matvec.launches
    khat = tasm.make_bc_matvec(esm_t.to(cuda), eldofs.to(cuda), fm.to(cuda))
    out = khat(u.to(cuda))
    assert kernels.khat_matvec.launches == launches + 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=1e-12 * float(ref.abs().max()))
    # a column of a block (strided) gives the same bits
    block = torch.stack([torch.zeros_like(u), u], dim=1).to(cuda)
    assert torch.equal(khat(block[:, 1]), out)


# the element and node counts of the paths: the 502,599-dof plate, the
# 451,875-dof beam-column; and a ragged count (no whole tile in either dtype)
PATH_SIZES = {"plate": (117_936, 167_533), "column": (103_680, 150_625),
              "ragged": (1_001, 1_500)}


def _random_operator(ne, nn, dtype, seed):
    """Random symmetric element blocks (30, 30, ne) and their packed copy,
    a random connectivity of ne elements over nn nodes (ten distinct nodes
    an element, spread as a mesh's are: element e's nodes near node e nn /
    ne) with its node-incidence table, a dof vector and a mask with a tenth
    of the dofs fixed, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((30, 30, ne), generator=gen, device="cuda", dtype=dtype)
    esm_t = (a + a.transpose(0, 1)).contiguous()
    base = torch.arange(ne, device="cuda")[:, None] * nn // ne
    off = torch.argsort(torch.rand((ne, 40), generator=gen, device="cuda"), dim=1)[:, :10]
    elnodes = (base + off) % nn
    inc = tasm.node_incidence(elnodes, nn)
    u = torch.randn(3 * nn, generator=gen, device="cuda", dtype=dtype)
    fm = (torch.rand(3 * nn, generator=gen, device="cuda") > 0.1).to(dtype)
    return esm_t, kernels.pack_blocks(esm_t), inc, u, fm


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("form", ["masked", "raw"])
@pytest.mark.parametrize("size", ["box", "plate", "column", "ragged"])
def test_khat_matvec_kernel_matches_plain(cuda, dtype, form, size):
    """K1 against its plain version on the card, masked and raw: on the
    3x3x3 box's operator and mask in its solve space, and on random
    symmetric blocks and connectivity at the plate's and the beam-column's
    element and node counts and at a ragged count; the kernel reads only
    the packed blocks (the full ones are not passed); max |kernel - plain|
    / max |plain| within TOL against the packed plain version and against
    the full blocks' (symmetric, so the same operator); the same bits on a
    second call; one launch counted each."""
    if size == "box":
        be = TorchSystem(_tension_box(3), FcvmConfig(device="cuda", dtype="float64"), dtype,
                         cuda)
        esm, *_ = be.assemble(be.tensor(be.mesh.coords))
        op = be.operator(esm)
        esm_t, packed, inc, fm = op.esm_t, op.packed, be.space.incidence, be.space.fixmask_m
        u = torch.randn(be.ndof_pad, generator=torch.Generator(device="cuda").manual_seed(1),
                        device="cuda", dtype=dtype)
    else:
        esm_t, packed, inc, u, fm = _random_operator(*PATH_SIZES[size], dtype, seed=2)
    fm = fm if form == "masked" else None
    launches = kernels.khat_matvec.launches
    out = kernels.khat_matvec(packed, inc, u, fm)
    again = kernels.khat_matvec(packed, inc, u, fm)
    torch.cuda.synchronize()
    assert kernels.khat_matvec.launches == launches + 2
    assert torch.equal(out, again)  # fixed-order sums: deterministic
    for ref in (kernels.khat_matvec_packed_ref(packed, inc, u, fm),
                kernels.khat_matvec_ref(esm_t, inc, u, fm)):
        assert float((out - ref).abs().max()) <= TOL[dtype] * float(ref.abs().max())


def test_khat_matvec_rejects_what_it_does_not_take(cuda):
    esm_t, packed, inc, u, fm = _random_operator(50, 120, torch.float32, seed=3)
    with pytest.raises(ValueError):
        kernels.khat_matvec(esm_t, inc, u, fm)  # the full blocks, not the packed copy
    with pytest.raises(TypeError):
        kernels.khat_matvec(packed, inc, u.double(), fm)
    with pytest.raises(TypeError):
        kernels.khat_matvec(packed, inc._replace(pos=inc.pos.long()), u, fm)
    with pytest.raises(ValueError):
        kernels.khat_matvec(packed, inc, u.cpu(), fm)
    with pytest.raises(ValueError):
        kernels.khat_matvec(packed, inc, u[:-3], fm)
    with pytest.raises(ValueError):
        kernels.khat_matvec(packed[:, :, :128].contiguous(), inc, u, fm)
    with pytest.raises(ValueError):
        kernels.khat_matvec(torch.cat([packed, packed]), inc, u, fm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("width", [1, 3, 9, 144])
def test_segment_sum_kernel_matches_index_add(cuda, dtype, width):
    """K8 on the card against ``index_add_`` on the CPU on the same values:
    the same order of adds, so the same bits; into zeros and into a
    non-zero accumulator, with a dropped dump key; the same bits on a
    second call; one launch counted each."""
    rng = np.random.default_rng(width)
    n, nseg = 50_000, 7_000
    keys = torch.as_tensor(np.sort(rng.integers(0, nseg, size=n)) if width == 144
                           else rng.integers(0, nseg, size=n))
    vals = torch.as_tensor(rng.normal(size=(n, width))).to(dtype)
    start = torch.as_tensor(rng.normal(size=(nseg, width))).to(dtype)
    launches = kernels.segment_sum.launches
    for out0 in (torch.zeros_like(start), start):
        want = out0.clone().index_add_(0, keys, vals)
        plan = kernels.segment_plan(keys.to(cuda))
        got = kernels.segment_sum(vals.to(cuda), plan, out0.to(cuda))
        again = kernels.segment_sum(vals.to(cuda), plan, out0.to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert torch.equal(got.cpu(), want)
    drop = kernels.segment_plan(keys.to(cuda), drop=0)
    got = kernels.segment_sum(vals.to(cuda), drop, start.to(cuda)).cpu()
    want = start.clone().index_add_(0, keys, vals)
    assert torch.equal(got[1:], want[1:]) and torch.equal(got[0], start[0])
    assert kernels.segment_sum.launches == launches + 5


def _long_groups(rng, long_rows, n_long, nseg, n):
    """Keys of ``n`` random rows in ``nseg`` groups plus ``n_long`` groups
    of ``long_rows`` rows, the rows in random order."""
    keys = np.concatenate([np.full(long_rows, 5 * k + 2) for k in range(n_long)]
                          + [rng.integers(0, nseg, size=n)])
    return torch.as_tensor(rng.permutation(keys))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("form", ["accumulate", "write"])
def test_segment_sum_streams_long_groups_through_the_ring(cuda, dtype, form):
    """K8's ring path on groups of 7,473 and more rows of 144 values (576-
    and 1,152-byte rows, the coarse table's), among 2,000 groups of tens of
    rows: bit for bit ``index_add_`` on the CPU on the same values, the
    same bits on a second call, the ring and the register paths launched
    (counted by form and path)."""
    rng = np.random.default_rng(7)
    keys = _long_groups(rng, 7_473, 3, 2_000, 60_000)
    vals = torch.as_tensor(rng.normal(size=(keys.shape[0], 144))).to(dtype)
    start = torch.as_tensor(rng.normal(size=(2_050, 144))).to(dtype)
    write = form == "write"
    plan = kernels.segment_plan(keys.to(cuda), rows=2_050 if write else None)
    assert kernels.ring_groups(plan, 144, vals.element_size()) >= 3
    paths = dict(kernels.segment_sum.paths)
    v = vals.to(cuda)
    if write:
        got, again = (kernels.segment_sum(v, plan, rows=2_050) for _ in range(2))
        want = torch.zeros_like(start).index_add_(0, keys, vals)
    else:
        got, again = (kernels.segment_sum(v, plan, start.to(cuda)) for _ in range(2))
        want = start.clone().index_add_(0, keys, vals)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got.cpu(), want)
    for path in ("ring", "register"):
        assert kernels.segment_sum.paths[f"{form} {path}"] == paths.get(f"{form} {path}", 0) + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("width", [1, 3, 5, 9, 24, 144])
def test_segment_sum_write_form_matches_index_add_into_zeros(cuda, dtype, width):
    """K8's write form: a new output of which every row is written, the
    summed ones bit for bit ``index_add_`` into zeros on the CPU and the
    rows that no key names (a quarter of them) 0, at the paths' widths
    (5: rows not a multiple of 16 bytes in float32); values at an address
    that is not 16-byte aligned take the register path, with the same
    bits."""
    rng = np.random.default_rng(width)
    n, nseg = 40_000, 8_000
    keys = torch.as_tensor(rng.integers(0, nseg, size=n) * 4 // 3)
    rows = nseg * 4 // 3 + 7
    vals = torch.as_tensor(rng.normal(size=(n, width))).to(dtype)
    want = torch.zeros((rows, width), dtype=dtype).index_add_(0, keys, vals)
    plan = kernels.segment_plan(keys.to(cuda), rows=rows)
    assert plan.holes.shape[0] >= rows // 4
    launches = kernels.segment_sum.launches
    got = kernels.segment_sum(vals.to(cuda), plan, rows=rows)
    buf = torch.empty(n * width + 1, dtype=dtype, device=cuda)
    shifted = buf[1:].view(n, width)
    shifted.copy_(vals)
    ring = kernels.segment_sum.paths["write ring"]
    again = kernels.segment_sum(shifted, plan, rows=rows)
    torch.cuda.synchronize()
    assert kernels.segment_sum.paths["write ring"] == ring
    assert torch.equal(got.cpu(), want) and torch.equal(again, got)
    assert kernels.segment_sum.launches == launches + 2


def test_residual_and_block_products_give_the_same_bits(cuda):
    """The residual (K2's element pass and node pass) twice at one state,
    and K_hat·V and the block-Jacobi blocks twice: the same bits, float32,
    on the 3x3x3 box; the node pass launched for each residual, K8 for
    none."""
    be = TorchSystem(_tension_box(3), FcvmConfig(device="cuda", dtype="float32"),
                     torch.float32, cuda)
    coords = be.tensor(be.mesh.coords)
    esm, pinv, glv, rhs, *_ = be.assemble(coords)
    gen = torch.Generator(device="cuda").manual_seed(4)
    du = 1e-3 * torch.randn(be.ndof_pad, generator=gen, device="cuda")
    sig_y, sig0 = be.gauss_full(100.0), be.gauss_zeros((6,))
    launches = kernels.segment_sum.launches, kernels.node_force.launches
    res = [be.residual(coords, sig_y, torch.zeros_like(du), du, sig0, glv, 1.0, 1.0, 0.1)
           for _ in range(2)]
    assert (kernels.segment_sum.launches, kernels.node_force.launches) == (
        launches[0], launches[1] + 2)
    for a, b in zip(res[0], res[1]):
        assert torch.equal(a, b)
    sp = be.space
    op = tasm.make_multi_matvec(be.operator(esm).esm_t, sp.eldofs_m, sp.fixmask_m)
    v = torch.randn((be.ndof_pad, 8), generator=gen, device="cuda")
    assert torch.equal(op(v), op(v))
    again = be.assemble(coords)[1]
    assert torch.equal(pinv, again)


# the widths at which the paths launch K1m (chip_smoke.K0M_SHAPES): the
# beam-column's eigensolve block of 8 and its tails, its deflation k = 64;
# the plate's deflation k = 32; and off-path checks of the chunk edges
K1M_SHAPES = (*(("column", m) for m in (1, 2, 3, 4, 5, 6, 7, 8, 32, 64)), ("plate", 32),
              ("ragged", 3), ("ragged", 9), ("ragged", 37), ("box", 8))
K1M_FORMS = {"masked": (True, True, False), "projected_negated": (True, False, True),
             "raw": (False, False, False)}  # (with fixmask, identity_on_fixed, negate)


def _k1m_operator(size, dtype):
    """K1m's inputs at ``size``: the 3x3x3 box's operator, mask and incidence
    in its solve space, or ``_random_operator`` at a path's counts."""
    if size == "box":
        be = TorchSystem(_tension_box(3), FcvmConfig(device="cuda", dtype="float64"), dtype,
                         torch.device("cuda"))
        esm, *_ = be.assemble(be.tensor(be.mesh.coords))
        op = be.operator(esm)
        return op.esm_t, op.packed, be.space.incidence, be.space.fixmask_m
    esm_t, packed, inc, _, fm = _random_operator(*PATH_SIZES[size], dtype, seed=8)
    return esm_t, packed, inc, fm


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("form", list(K1M_FORMS))
@pytest.mark.parametrize("size,m", K1M_SHAPES, ids=[f"{s}-m{m}" for s, m in K1M_SHAPES])
def test_khat_matmat_kernel_matches_plain(cuda, dtype, form, size, m):
    """K1m against its plain version on the card at every width the paths
    give it, in each form (K_hat·V; -G_hat·V, projected and negated; the raw
    K·V): on random symmetric blocks and connectivity at the beam-column's
    and the plate's counts, at a ragged count (no whole tile, widths across
    the chunk of 8 columns) and on the 3x3x3 box's operator; the kernel
    reads only the packed blocks; max |kernel - plain| / max |plain| within
    TOL against the packed plain version and the full blocks'; the same bits
    on a second call; one launch counted each, by dtype and m."""
    esm_t, packed, inc, fm = _k1m_operator(size, dtype)
    masked, ident, neg = K1M_FORMS[form]
    fm = fm if masked else None
    gen = torch.Generator(device="cuda").manual_seed(m)
    u = torch.randn((3 * (inc.offsets.shape[0] - 1), m), generator=gen, device="cuda",
                    dtype=dtype)
    launches = kernels.khat_matmat.launches
    shape = kernels.khat_matmat.shapes[(str(dtype).removeprefix("torch."), m)]
    out = kernels.khat_matmat(packed, inc, u, fm, ident, neg)
    again = kernels.khat_matmat(packed, inc, u, fm, ident, neg)
    torch.cuda.synchronize()
    assert kernels.khat_matmat.launches == launches + 2
    assert kernels.khat_matmat.shapes[(str(dtype).removeprefix("torch."), m)] == shape + 2
    assert torch.equal(out, again)  # fixed-order sums: deterministic
    for ref in (kernels.khat_matmat_packed_ref(packed, inc, u, fm, ident, neg),
                kernels.khat_matmat_ref(esm_t, inc, u, fm, ident, neg)):
        assert float((out - ref).abs().max()) <= TOL[dtype] * float(ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("form", ["masked", "raw"])
def test_khat_matmat_on_one_column_is_khat_matvec(cuda, dtype, form):
    """K1m on an (ndof, 1) block gives K1's bits on that column: the same
    entries in the same order in each element, the same incidences in the
    same order at each node."""
    esm_t, packed, inc, _, fm = _random_operator(*PATH_SIZES["column"], dtype, seed=9)
    fm = fm if form == "masked" else None
    u = torch.randn((3 * (inc.offsets.shape[0] - 1), 1), device="cuda", dtype=dtype)
    assert torch.equal(kernels.khat_matmat(packed, inc, u, fm)[:, 0],
                       kernels.khat_matvec(packed, inc, u[:, 0].contiguous(), fm))


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("form", ["masked", "raw"])
@pytest.mark.parametrize("size,m", K1M_SHAPES, ids=[f"{s}-m{m}" for s, m in K1M_SHAPES])
def test_khat_matmat_is_khat_matvec_column_by_column(cuda, dtype, form, size, m):
    """K1m at every width of K1M_SHAPES gives, in each column, K1's bits on
    that column: each element's entries in packed order, each node's
    partial of its first sub-tile and then its later rows, the adds of K1's
    node sum in K1's order; through the operator's plan, as the paths call
    it, and without it."""
    esm_t, packed, inc, fm = _k1m_operator(size, dtype)
    fm = fm if form == "masked" else None
    gen = torch.Generator(device="cuda").manual_seed(100 + m)
    u = torch.randn((3 * (inc.offsets.shape[0] - 1), m), generator=gen, device="cuda",
                    dtype=dtype)
    plan = kernels.khat_matmat_plan(packed, inc, fm)
    out = kernels.khat_matmat(packed, inc, u, fm, plan=plan)
    assert torch.equal(_bits(kernels.khat_matmat(packed, inc, u, fm)), _bits(out))
    for c in range(m):
        col = kernels.khat_matvec(packed, inc, u[:, c].contiguous(), fm)
        assert torch.equal(_bits(out[:, c].contiguous()), _bits(col)), c


def test_khat_matmat_rejects_what_it_does_not_take(cuda):
    esm_t, packed, inc, u, fm = _random_operator(50, 120, torch.float32, seed=3)
    v = torch.stack([u, u, u], dim=1)
    with pytest.raises(ValueError):
        kernels.khat_matmat(esm_t, inc, v, fm)  # the full blocks, not the packed copy
    with pytest.raises(TypeError):
        kernels.khat_matmat(packed, inc, v.double(), fm)
    with pytest.raises(TypeError):
        kernels.khat_matmat(packed, inc._replace(offsets=inc.offsets.long()), v, fm)
    with pytest.raises(ValueError):
        kernels.khat_matmat(packed, inc, v.cpu(), fm)
    with pytest.raises(ValueError):
        kernels.khat_matmat(packed, inc, v[:-3], fm)
    with pytest.raises(ValueError):
        kernels.khat_matmat(packed, inc, u, fm)  # a vector, not a block
    with pytest.raises(ValueError):
        kernels.khat_matmat(packed, inc, v[:, 1:], fm)  # a column slice: strided
    with pytest.raises(ValueError):
        kernels.khat_matmat(packed[:, :, :128].contiguous(), inc, v, fm)
    # the operator of make_multi_matvec makes a column slice dense first
    op = tasm.make_multi_matvec(esm_t, tasm.element_dof_ids(inc.elnodes_t.T.long()), fm,
                                incidence=inc, packed=packed)
    assert torch.equal(op(v[:, 1:]), op(v[:, 1:].contiguous()))


def test_khat_matmat_plan_is_held_to_its_operator(cuda):
    """A plan serves only the blocks, tables and mask it was made for, and
    the op refuses tables of the wrong size and maps of another copy."""
    esm_t, packed, inc, u, fm = _random_operator(50, 120, torch.float32, seed=3)
    v = torch.stack([u, u, u], dim=1)
    plan = kernels.khat_matmat_plan(packed, inc, fm)
    with pytest.raises(ValueError):
        kernels.khat_matmat(packed, inc, v, None, plan=plan)  # made with the mask
    with pytest.raises(ValueError):
        kernels.khat_matmat(packed.clone(), inc, v, fm, plan=plan)
    with pytest.raises(ValueError):
        kernels.khat_matmat(packed, inc._replace(elnodes_t=inc.elnodes_t.clone()), v, fm,
                            plan=plan)
    want = kernels.khat_matmat(packed, inc, v, fm, plan=plan)
    tab = plan.tables
    args = (*inc[:3], *tab, v, fm, True, False)
    assert torch.equal(torch.ops.fcvm.khat_matmat(packed, plan.map, *args), want)
    with pytest.raises(RuntimeError):  # the map of another copy
        torch.ops.fcvm.khat_matmat(packed.clone(), plan.map, *args)
    with pytest.raises(RuntimeError):  # a table cut short
        torch.ops.fcvm.khat_matmat(packed, plan.map, *inc[:3], tab.ents[:-1], *tab[1:], v, fm,
                                   True, False)
    with pytest.raises(RuntimeError):  # a mask of the wrong size
        torch.ops.fcvm.khat_matmat(packed, plan.map, *inc[:3], *tab, v, fm[:-3], True, False)


def _random_coarse(n, dtype, gen):
    """A random symmetric (n, n) matrix of unit scale on the card and its
    packed upper tiles (K4c's input)."""
    a = torch.randn((n, n), generator=gen, device="cuda", dtype=dtype) / n**0.5
    a = 0.5 * (a + a.T)
    return a, kernels.pack_coarse(a)


def _random_precond(nn, cs, ncl, nm, dtype, seed):
    """Random block-Jacobi blocks, mode basis (zero past the nn nodes),
    packed symmetric coarse inverse, mask, vector and fine-level output on
    the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    qmat = randn(ncl * cs, 3, nm)
    qmat[nn:] = 0.0
    fm = (torch.rand(3 * nn, generator=gen, device="cuda") > 0.1).to(dtype)
    pinv = randn(nn, 3, 3)
    _, kinv = _random_coarse(nm * ncl, dtype, gen)
    return (pinv, qmat, kinv, fm, randn(3 * nn), randn(3 * nn))


# coarse dimensions: one partial tile, a few tiles with a ragged edge, the
# plate's 12 x 1,022
COARSE_SIZES = {"small": 300, "ragged": 1000, "plate": 12_264}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("m", [1, 2, 8, 32])
@pytest.mark.parametrize("size", list(COARSE_SIZES))
def test_coarse_product_kernel_matches_plain(cuda, dtype, m, size):
    """K4c, the symmetric coarse product on the packed upper tiles, against
    its plain version (the mirrored tiles' dense product) and the dense
    product of the matrix packed, on a vector (m = 1) and on blocks (one
    pass over the tiles at m <= 8, four at 32; at 8 columns in float64 the
    tensor-core pass); within TOL, the same bits on a second call, one
    launch counted each."""
    gen = torch.Generator(device="cuda").manual_seed(m)
    n = COARSE_SIZES[size]
    dense, packed = _random_coarse(n, dtype, gen)
    x = torch.randn((n,) if m == 1 else (n, m), generator=gen, device="cuda", dtype=dtype)
    launches = kernels.coarse_product.launches
    out, again = kernels.coarse_product(packed, x), kernels.coarse_product(packed, x)
    torch.cuda.synchronize()
    assert kernels.coarse_product.launches == launches + 2
    assert out.shape == x.shape and torch.equal(out, again)
    for ref in (kernels.coarse_product_ref(packed, x), dense @ x):
        assert float((out - ref).abs().max()) <= TOL[dtype] * float(ref.abs().max())


def test_coarse_product_rejects_what_it_does_not_take(cuda):
    gen = torch.Generator(device="cuda").manual_seed(3)
    dense, packed = _random_coarse(300, torch.float32, gen)
    x = torch.randn(300, generator=gen, device="cuda")
    with pytest.raises(TypeError):  # the dense matrix, not its packed copy
        kernels.coarse_product(dense, x)
    with pytest.raises(TypeError):
        kernels.coarse_product(packed, x.double())
    with pytest.raises(ValueError):
        kernels.coarse_product(packed, x[:-1])
    with pytest.raises(ValueError):
        kernels.coarse_product(packed, x.cpu())
    with pytest.raises(ValueError):
        kernels.coarse_product(packed, x.reshape(300, 1, 1))  # neither a vector nor a block
    with pytest.raises(ValueError):
        kernels.coarse_product(kernels.PackedCoarse(packed.tiles, 500), x)
    with pytest.raises(RuntimeError):  # tiles of another size
        kernels.coarse_product(kernels.PackedCoarse(packed.tiles[1:], 300), x)
    with pytest.raises(RuntimeError):
        torch.ops.fcvm.coarse_product(packed.tiles, x[:100])


# K4's error on the 3x3x3 box with the cluster smoother in float32, against
# the plain version in float64 on the same inputs, as a multiple of the
# float32 plain version's.  That output is a small difference of the fine
# level and the coarse correction (1e-5 of the terms it is summed from), so
# any two float32 summation orders of the coarse product differ by more than
# TOL of it: K4c's order and cuBLAS's (the plain version's) lie 2.59e-5 of
# the output apart, K4 2.53e-5 from float64 and the plain version 5.13e-5
# (PERF.md; fcvm_tpu_torch/tools/coarse_probe.py on an H100).
BOX_CLUSTER_F32_FACTOR = 1.0


def _assert_two_level_close(out, ref_fn, args, z_fine, ill_conditioned=False):
    """K4's or K4m's output against its plain version, within TOL.  Where
    ``ill_conditioned`` (K4 on the box with the cluster smoother in
    float32), instead no further from the plain version in float64 than
    BOX_CLUSTER_F32_FACTOR times the float32 plain version is."""
    ref = ref_fn(*args, z_fine)
    err = float((out - ref).abs().max())
    if not ill_conditioned:
        assert err <= TOL[out.dtype] * float(ref.abs().max())
        return
    up = [kernels.dense_coarse(a).double() for a in args]  # the coarse inverse made dense
    ref64 = ref_fn(*up, None if z_fine is None else z_fine.double())
    assert (float((out.double() - ref64).abs().max())
            <= BOX_CLUSTER_F32_FACTOR * float((ref.double() - ref64).abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("fine", ["jacobi3", "cluster"])
@pytest.mark.parametrize("size", ["box", "plate", "column"])
def test_two_level_apply_kernel_matches_plain(cuda, dtype, fine, size):
    """K4 against its plain version on the card, with block Jacobi and with
    the cluster smoother's output as the fine level: on the 3x3x3 box's
    preconditioner (16-node smoother clusters; its coarse inverse packed by
    the build), and on random state at the plate's and the beam-column's
    node counts with their coarse sizes (12 modes on 1,022 clusters of 164
    nodes; 1,021 of 148); within TOL (see _assert_two_level_close), the
    same bits on a second call, one launch counted each."""
    if size == "box":
        cfg = FcvmConfig(device="cuda", dtype="float64", smoother=fine,
                         smoother_cluster_nodes=16)
        be = TorchSystem(_tension_box(3), cfg, dtype, cuda)
        esm, pinv, *_ = be.assemble(be.tensor(be.mesh.coords))
        pc = be.make_pc(esm, pinv)
        r = torch.randn(be.ndof_pad, generator=torch.Generator(device="cuda").manual_seed(4),
                        device="cuda", dtype=dtype)
        args = (pc.pinv, pc.qmat, pc.coarse_inv, pc.fixmask, r)
        z_fine = pc.fine(r) if fine == "cluster" else None
        assert (pc.smooth_inv is None) == (fine == "jacobi3")
        assert isinstance(pc.coarse_inv, kernels.PackedCoarse)
    else:
        nn = PATH_SIZES[size][1] + (-PATH_SIZES[size][1] % 128)  # the padded node count
        cs, ncl = {"plate": (164, 1022), "column": (148, 1021)}[size]
        *args, z = _random_precond(nn, cs, ncl, 12, dtype, seed=5)
        z_fine = z if fine == "cluster" else None
    launches = kernels.two_level_apply.launches
    out = kernels.two_level_apply(*args, z_fine)
    again = kernels.two_level_apply(*args, z_fine)
    torch.cuda.synchronize()
    assert kernels.two_level_apply.launches == launches + 2
    assert torch.equal(out, again)
    _assert_two_level_close(out, kernels.two_level_apply_ref, args, z_fine,
                            size == "box" and fine == "cluster" and dtype == torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("fine", ["jacobi3", "cluster"])
@pytest.mark.parametrize("size,m", [("box", 5), ("column", 1), ("column", 3), ("column", 8),
                                    ("column", 37), ("plate", 8)])
def test_two_level_apply_block_kernel_matches_plain(cuda, dtype, fine, size, m):
    """K4m against its plain version on the card, with block Jacobi and with
    a fine level given (the cluster smoother's output): on the 3x3x3 box's
    preconditioner (6 modes, 16-node smoother clusters) and on random state
    at the beam-column's and the plate's node counts with their coarse sizes,
    at the eigensolve's block widths and one past a warp of columns; within
    TOL, the same bits on a second call, one launch counted each."""
    gen = torch.Generator(device="cuda").manual_seed(m)
    if size == "box":
        cfg = FcvmConfig(device="cuda", dtype="float64", smoother=fine,
                         smoother_cluster_nodes=16, coarse_modes=6)
        be = TorchSystem(_tension_box(3), cfg, dtype, cuda)
        esm, pinv, *_ = be.assemble(be.tensor(be.mesh.coords))
        pc = be.make_pc(esm, pinv)
        assert pc.qmat.shape[2] == 6 and (pc.smooth_inv is None) == (fine == "jacobi3")
        r = torch.randn((be.ndof_pad, m), generator=gen, device="cuda", dtype=dtype)
        args = (pc.pinv, pc.qmat, pc.coarse_inv, pc.fixmask, r)
        z_fine = pc.fine(r) if fine == "cluster" else None
    else:
        nn = PATH_SIZES[size][1] + (-PATH_SIZES[size][1] % 128)
        cs, ncl = {"plate": (164, 1022), "column": (148, 1021)}[size]
        pinv, qmat, kinv, fm, *_ = _random_precond(nn, cs, ncl, 12, dtype, seed=5)
        r = torch.randn((3 * nn, m), generator=gen, device="cuda", dtype=dtype)
        args = (pinv, qmat, kinv, fm, r)
        z_fine = torch.randn_like(r) if fine == "cluster" else None
    launches = kernels.two_level_apply_block.launches
    out = kernels.two_level_apply_block(*args, z_fine)
    again = kernels.two_level_apply_block(*args, z_fine)
    torch.cuda.synchronize()
    assert kernels.two_level_apply_block.launches == launches + 2
    assert torch.equal(out, again)
    _assert_two_level_close(out, kernels.two_level_apply_block_ref, args, z_fine)


def test_two_level_apply_block_rejects_what_it_does_not_take(cuda):
    pinv, qmat, kinv, fm, r, _ = _random_precond(200, 16, 13, 12, torch.float32, seed=6)
    block = torch.stack([r, r, r], dim=1)
    with pytest.raises(TypeError):
        kernels.two_level_apply_block(pinv, qmat, kernels.PackedCoarse(kinv.tiles.double(),
                                                                       kinv.n), fm, block)
    with pytest.raises(TypeError):  # the dense inverse: on the card K4c reads the packed tiles
        kernels.two_level_apply_block(pinv, qmat, kernels.unpack_coarse(kinv), fm, block)
    with pytest.raises(ValueError):
        kernels.two_level_apply_block(pinv, qmat, kinv, fm, block.cpu())
    with pytest.raises(ValueError):
        kernels.two_level_apply_block(pinv, qmat, kinv, fm, r)  # a vector, not a block
    with pytest.raises(ValueError):
        kernels.two_level_apply_block(pinv, qmat, kinv, fm, block[:, 1:])  # strided
    with pytest.raises(ValueError):
        kernels.two_level_apply_block(pinv, qmat, kinv, fm, block, block[:, :2])
    with pytest.raises(RuntimeError):  # tiles of another coarse size
        torch.ops.fcvm.two_level_apply_block(pinv, qmat, kinv.tiles[1:], kinv.n, fm, block, None)
    # TwoLevelPrecond.apply makes a column slice dense first
    from fcvm_tpu_torch.ops.precond import TwoLevelPrecond

    pc = TwoLevelPrecond(pinv, qmat, kinv, fm)
    assert torch.equal(pc.apply(block[:, 1:]), pc.apply(block[:, 1:].contiguous()))


def test_two_level_apply_rejects_what_it_does_not_take(cuda):
    pinv, qmat, kinv, fm, r, _ = _random_precond(200, 16, 13, 12, torch.float32, seed=6)
    with pytest.raises(TypeError):
        kernels.two_level_apply(pinv, qmat, kernels.PackedCoarse(kinv.tiles.double(), kinv.n),
                                fm, r)
    with pytest.raises(TypeError):  # the dense inverse: on the card K4c reads the packed tiles
        kernels.two_level_apply(pinv, qmat, kernels.unpack_coarse(kinv), fm, r)
    with pytest.raises(ValueError):
        kernels.two_level_apply(pinv, qmat, kinv, fm, r.cpu())
    with pytest.raises(ValueError):
        kernels.two_level_apply(pinv, qmat[:, :, :7], kinv, fm, r)
    with pytest.raises(ValueError):
        kernels.two_level_apply(pinv, qmat.transpose(1, 2).contiguous().transpose(1, 2), kinv,
                                fm, r)
    with pytest.raises(RuntimeError):  # tiles of another coarse size
        torch.ops.fcvm.two_level_apply(pinv, qmat, kinv.tiles[1:], kinv.n, fm, r, None)


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


def _tension_box(n):
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


def _deflated_solve(device):
    """A deflated float64 solve of a 3x3x3 tension box on ``device``: harvest,
    Ritz space, then the deflated solve, all at cg_rtol 1e-12."""
    model = _tension_box(3)
    mesh = model.mesh
    cfg = FcvmConfig(device=device, dtype="float64", cg_rtol=1e-12)
    be = TorchSystem(model, cfg, torch.float64, torch.device(device))
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


def test_gnl_collapse_cuda_matches_cpu(cuda):
    """The geometrically nonlinear plastic collapse of the 2x2x2 tension box
    (tangent refreshes, predictor solves through K1 and K4) in float64 on
    the card against the CPU: the same steps and load factors to 1e-9."""
    params = ControlParams(sig_yield=60.0, nstep=3, error_max=1e-8, et_e=0.1, target_lf=99.0,
                           gnl="GNLY", max_imp=0.0)
    runs = {}
    for device in ("cpu", "cuda"):
        launches = _cg_launches()
        res = solve_collapse(_tension_box(2), params,
                             config=FcvmConfig(device=device, dtype="float64", cg_rtol=1e-10))
        runs[device] = (np.asarray(res.history.lbd), res.cg_stats,
                        min(np.subtract(_cg_launches(), launches)))
    (lbd_cpu, _, cg_cpu), (lbd_gpu, stats, cg_gpu) = runs["cpu"], runs["cuda"]
    assert len(lbd_gpu) == len(lbd_cpu) == 4
    np.testing.assert_allclose(lbd_gpu, lbd_cpu, rtol=1e-9, atol=0)
    assert stats["predictor_solves"] > 0 and cg_cpu == 0 and cg_gpu > 0


def _smoothed_precond(device, dtype):
    """The two-level preconditioner with the cluster smoother (16-node
    clusters) of a 3x3x3 tension box on ``device``, and its apply on a
    seeded vector and on a seeded block of 8 columns."""
    model = _tension_box(3)
    cfg = FcvmConfig(device=device, dtype=dtype, smoother="cluster", smoother_cluster_nodes=16)
    be = TorchSystem(model, cfg, dtype, torch.device(device))
    esm, pinv, *_ = be.assemble(be.tensor(model.mesh.coords))
    pc = be.make_pc(esm, pinv)
    r = np.random.default_rng(5).normal(size=(be.ndof_pad, 9))
    rr = torch.as_tensor(r, device=device).to(dtype)
    return [t.cpu().double().numpy() for t in (pc.smooth_inv, pc.apply(rr[:, 0]),
                                               pc.apply(rr[:, 1:]))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_cluster_smoother_cuda_matches_cpu(cuda, dtype):
    """The cluster smoother built (accumulate, batched Cholesky, inverse)
    and applied on the card, to a vector and to a block, against the same
    on the CPU: to 1e-10 of the largest value in float64, and in float32 to
    1e-3 (the inverse of a block with condition ~1e3 in float32)."""
    tol = {torch.float32: 1e-3, torch.float64: 1e-10}[dtype]
    for got, want in zip(_smoothed_precond("cuda", dtype), _smoothed_precond("cpu", dtype)):
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_cluster_smoother_collapse_cuda_matches_cpu(cuda):
    """The GNL collapse of the 2x2x2 box with ``smoother="cluster"`` in
    float64 on the card against the CPU: the same steps and load factors to
    1e-9, one smoother build per run (the refreshes keep it)."""
    from fcvm_tpu_torch.ops.precond import COARSE_BUILD_STATS

    params = ControlParams(sig_yield=60.0, nstep=3, error_max=1e-8, et_e=0.1, target_lf=99.0,
                           gnl="GNLY", max_imp=0.0)
    lbd = {}
    for device in ("cpu", "cuda"):
        builds = COARSE_BUILD_STATS["smoother_builds"]
        res = solve_collapse(_tension_box(2), params, config=FcvmConfig(
            device=device, dtype="float64", cg_rtol=1e-10, smoother="cluster",
            smoother_cluster_nodes=16))
        lbd[device] = np.asarray(res.history.lbd)
        assert COARSE_BUILD_STATS["smoother_builds"] == builds + 1
        assert res.cg_stats["predictor_solves"] > 0
    assert len(lbd["cuda"]) == len(lbd["cpu"]) == 4
    np.testing.assert_allclose(lbd["cuda"], lbd["cpu"], rtol=1e-9, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8, 9, 31, 32, 33, 37, 64])
@pytest.mark.parametrize("ne", [1, 1003, 103_680])
def test_block_matmat_kernel_matches_plain(cuda, dtype, m, ne):
    """K0m at every column count of its narrow ring (m = 1 to 8, float64 m
    = 8 included) and across the boundaries of its wide ring (9, and 31 to
    33 around one warp of columns), on one element (below a tile), a count
    that is not a multiple of 4 (its one-value block copies) and 103,680
    (many tiles a persistent block); two launches in a row on different
    inputs, so stale ring contents would show; counted once each, and the
    first and last columns against K0 on that column as well."""
    rng = np.random.default_rng(m)
    launches = kernels.block_matmat.launches
    for _ in range(2):
        esm_t = torch.as_tensor(rng.normal(size=(30, 30, ne)), device=cuda).to(dtype)
        ue = torch.as_tensor(rng.normal(size=(ne, 30, m)), device=cuda).to(dtype)
        out = kernels.block_matmat(esm_t, ue)
        torch.cuda.synchronize()
        ref = kernels.block_matmat_ref(esm_t, ue)
        assert float((out - ref).abs().max()) <= TOL[dtype] * float(ref.abs().max())
    assert kernels.block_matmat.launches == launches + 2
    for c in (0, m - 1):
        k0 = kernels.block_matvec(esm_t, ue[:, :, c].T.contiguous())
        assert float((out[:, :, c].T - k0).abs().max()) <= TOL[dtype] * float(k0.abs().max())


def test_block_matmat_rejects_what_it_does_not_take(cuda):
    esm_t = torch.zeros((30, 30, 8), device=cuda)
    with pytest.raises(TypeError):
        kernels.block_matmat(esm_t, torch.zeros((8, 30, 2), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        kernels.block_matmat(esm_t, torch.zeros((8, 29, 2), device=cuda))
    with pytest.raises(ValueError):
        kernels.block_matmat(esm_t, torch.zeros((8, 30, 2)))
    with pytest.raises(ValueError):
        kernels.block_matmat(esm_t, torch.zeros((8, 2, 30), device=cuda).transpose(1, 2))


def _column_model(nx=8, ny=1, lc=20.0, p=1000.0):
    """A clamped-free column of section ny x 1 under an end traction."""
    mesh = meshgen.box_tet10(nx, ny, 1, lc, float(ny), 1.0)
    bcs = BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, 0.0, 0.0))])
    faces = mesh.faces_on(lambda x, y, z: x > lc - 1e-9)
    loads = Loads(traction_faces=faces, tractions=np.tile([-p / ny, 0, 0], (len(faces), 1)))
    return Model(mesh, Material(210000.0, 0.3), bcs, loads)


def _pcg_block(device):
    """pcg_block on four columns of a 3x3x3 tension box's K_hat, float64,
    block-Jacobi preconditioner, half of them warm-started."""
    model = _tension_box(3)
    cfg = FcvmConfig(device=device, dtype="float64")
    be = TorchSystem(model, cfg, torch.float64, torch.device(device))
    esm, pinv, *_ = be.assemble(be.tensor(model.mesh.coords))
    khat = be.operator(esm)
    sp = be.space
    kmv = tasm.make_multi_matvec(khat.esm_t, sp.eldofs_m, sp.fixmask_m)
    b = torch.as_tensor(np.random.default_rng(5).normal(size=(be.ndof_pad, 4)), device=device)
    b = sp.fixmask_m[:, None] * b
    x0 = torch.zeros_like(b)
    x0[:, 2:] = 0.5 * b[:, 2:]
    return tslv.pcg_block(kmv, b, precond=lambda r: tasm.apply_block_precond(pinv[sp.nperm], r),
                          x0=x0, rtol=1e-10, maxiter=500)


def test_pcg_block_cuda_matches_cpu(cuda):
    """The block PCG through K1m on the card against the CPU, float64:
    every column's CG count within one (sums in another order), the same
    solutions."""
    ref, res = _pcg_block("cpu"), _pcg_block("cuda")
    assert all(abs(a - b) <= 1 for a, b in zip(res.iters, ref.iters))
    np.testing.assert_allclose(res.x.cpu().numpy(), ref.x.numpy(), rtol=0,
                               atol=1e-9 * float(ref.x.abs().max()))


def test_linear_buckling_cuda_matches_cpu(cuda):
    """linear_buckling of the 8x1x1 clamped-free column in float64 on the
    card (K1m in every K_hat·V and -G_hat·V, K4m in every block
    preconditioner apply, K0m in none) against the CPU: the factors to
    1e-10, the (near-degenerate) mode pair spanning the same plane.  The
    solves run to 1e-12: at the default 1e-6 the two devices' pre-stress
    solves, whose sums round in another order, differ by ~1e-8, and so do
    the factors."""
    params = ControlParams(gnl="GNLY", nstep=1)
    block_kernels = (kernels.khat_matmat, kernels.two_level_apply_block, kernels.block_matmat)
    out = {}
    for device in ("cpu", "cuda"):
        launches = [k.launches for k in block_kernels]
        out[device] = linear_buckling(
            _column_model(), params,
            config=FcvmConfig(device=device, dtype="float64", cg_rtol=1e-12))
        out[device] += ([k.launches - n for k, n in zip(block_kernels, launches)],)
    (lam_c, v_c, blk_c), (lam_g, v_g, blk_g) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(lam_g, lam_c, rtol=1e-10, atol=0)
    coef, *_ = np.linalg.lstsq(v_c, v_g, rcond=None)
    assert np.linalg.norm(v_g - v_c @ coef) < 1e-6 * np.linalg.norm(v_g)
    assert blk_c == [0, 0, 0] and blk_g[0] > 0 and blk_g[1] > 0 and blk_g[2] == 0


@pytest.mark.parametrize("case", ["buckling_only", "seeded", "scipy"])
def test_driver_branches_cuda_match_cpu(cuda, case):
    """``solve_collapse`` through the branches the buckling slice opened, in
    float64 on the card against the CPU: GNL with ``nstep == 1`` (the
    factors to 1e-10), GNL seeded with a blend of both modes of a 2 x 1
    column (the perturbed coordinates to 1e-9 of ``max_imp``, the same
    steps, ``lbd`` to 1e-8), and the scipy direct tier in small strain
    (``lbd`` to 1e-10, no CG iteration)."""
    if case == "scipy":
        model = _tension_box(2)
        params = ControlParams(sig_yield=60.0, nstep=3, error_max=1e-8, et_e=0.1, target_lf=99.0)
        cfg_kw = dict(solver="scipy")
    else:
        model = _column_model(nx=6, ny=2, p=100.0)
        params = ControlParams(gnl="GNLY", nstep=1) if case == "buckling_only" else ControlParams(
            gnl="GNLY", nstep=3, max_imp=0.05, ev1=1.0, ev2=0.3, sig_yield=60.0, et_e=0.1,
            error_max=1e-8, target_lf=99.0)
        cfg_kw = {}
    res = {device: solve_collapse(model, params, config=FcvmConfig(
        device=device, dtype="float64", cg_rtol=1e-12, **cfg_kw)) for device in ("cpu", "cuda")}
    cpu, gpu = res["cpu"], res["cuda"]
    assert len(gpu.history.lbd) == len(cpu.history.lbd) == params.nstep + 1
    if case == "scipy":
        np.testing.assert_allclose(gpu.history.lbd, cpu.history.lbd, rtol=1e-10, atol=0)
        assert gpu.cg_stats["iters"] == cpu.cg_stats["iters"] == 0
        return
    np.testing.assert_allclose(gpu.eigenvalues, cpu.eigenvalues, rtol=1e-10, atol=0)
    if case == "seeded":
        np.testing.assert_allclose(gpu.coords, cpu.coords, rtol=0, atol=1e-9 * 0.05)
        np.testing.assert_allclose(gpu.history.lbd, cpu.history.lbd, rtol=1e-8, atol=0)


PLATE_CASE = """
name = "plate"
[mesh.generator]
kind = "plate_with_hole"
n_circ = 10
n_rad = 8
[material]
e = 210000.0
nu = 0.3
[[material.region]]
where = "y > 75.0"
e = 420000.0
[control]
sig_yield = 100.0
nstep = 6
iterat_max = 20
error_max = 5e-4
target_lf = 1.62
ultimate_strain = 0.25
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
traction = [0.0, 50.0, 0.0]
[[sum.face]]
where = "y > 100.0 - 1e-6"
"""


def test_run_analysis_cuda_matches_cpu(cuda, tmp_path):
    """The case-file path on the card: the small plate with a stiffer region,
    ``load_case`` -> ``run_analysis`` -> ``run_sum`` in float64 on the GPU
    against the CPU: the same steps, load factors to 1e-9, the exported
    nodal fields and the face averages to 1e-9; K1 and K4 launched on the
    card only."""
    from fcvm_tpu_torch import run_analysis, run_sum
    from fcvm_tpu_torch.models.casefile import load_case, parse_sum_groups
    from fcvm_tpu_torch.runtime.vtk import read_point_fields

    case = tmp_path / "plate.toml"
    case.write_text(PLATE_CASE)
    out = {}
    for device in ("cpu", "cuda"):
        model, params = load_case(case)
        launches = _cg_launches()
        res = run_analysis(model, params, outdir=str(tmp_path / device), save_plots=False,
                           config=FcvmConfig(device=device, dtype="float64", cg_rtol=1e-10))
        sums = run_sum(model, res, params, *parse_sum_groups(case, model.mesh))
        out[device] = (res, read_point_fields(tmp_path / device / "plate.vtk"), sums,
                       min(np.subtract(_cg_launches(), launches)))
    (cpu, f_cpu, s_cpu, cg_cpu), (gpu, f_gpu, s_gpu, cg_gpu) = out["cpu"], out["cuda"]
    assert len(gpu.history.lbd) == len(cpu.history.lbd) == 7
    np.testing.assert_allclose(gpu.history.lbd, cpu.history.lbd, rtol=1e-9, atol=0)
    assert list(f_gpu) == list(f_cpu) and len(f_cpu) == 12
    for k, want in f_cpu.items():
        np.testing.assert_allclose(f_gpu[k], want, rtol=0, atol=1e-9 * max(np.abs(want).max(), 1))
    np.testing.assert_allclose(s_gpu["faces"]["Face1"]["area"], 250.0, rtol=1e-12)
    np.testing.assert_allclose(s_gpu["faces"]["Face1"]["svm"], s_cpu["faces"]["Face1"]["svm"],
                               rtol=1e-9)
    assert cg_cpu == 0 and cg_gpu > 0


GNL_BOX = dict(sig_yield=60.0, nstep=3, error_max=1e-8, et_e=0.1, target_lf=99.0, gnl="GNLY",
               max_imp=0.0)
COLUMN = dict(gnl="GNLY", nstep=1)


def _sharded_rank(case, device):
    """One rank of a sharded run of ``case`` in float64 at ``cg_rtol``
    1e-10 on ``device``: its load factors, buckling factors, the CG
    iterations of every solve, the fewer of its K1 and K4 launches and its
    K1m launches."""
    from fcvm_tpu_torch.parallel import dist as pdist

    model, params = ((_tension_box(2), GNL_BOX) if case == "gnl" else
                     (_column_model(), COLUMN))
    cg, k1m = _cg_launches(), kernels.khat_matmat.launches
    res = solve_collapse(model, ControlParams(**params), config=FcvmConfig(
        device=device, dtype="float64", cg_rtol=1e-10, force_sharded=True,
        n_devices=pdist.world_size()))
    return dict(lbd=np.asarray(res.history.lbd), eig=res.eigenvalues,
                cg=[s["cg"] for s in res.cg_stats["steps"]], iters=res.cg_stats["iters"],
                k1k4=min(np.subtract(_cg_launches(), cg)),
                k1m=kernels.khat_matmat.launches - k1m)


@pytest.mark.parametrize("case", ["gnl", "column"])
def test_sharded_world_of_one_over_nccl_matches_torchsystem(cuda, case):
    """The sharded backend on a world of one over NCCL against the
    single-device backend on the same card, float64: the same load and
    buckling factors to 1e-9, K1 and K4 (and K1m for the eigensolve)
    launched."""
    from fcvm_tpu_torch.parallel import dist as pdist

    (out,) = pdist.spawn(_sharded_rank, 1, args=(case, "cuda"), device="cuda", timeout=900)
    model, params = ((_tension_box(2), GNL_BOX) if case == "gnl" else
                     (_column_model(), COLUMN))
    ref = solve_collapse(model, ControlParams(**params),
                         config=FcvmConfig(device="cuda", dtype="float64", cg_rtol=1e-10))
    np.testing.assert_allclose(out["lbd"], ref.history.lbd, rtol=1e-9, atol=0)
    if case == "column":
        np.testing.assert_allclose(out["eig"], ref.eigenvalues, rtol=1e-9)
        assert out["k1m"] > 0
    assert out["k1k4"] > 0


def _node_partition_rank(device):
    """One rank of the GNL box on the node-partitioned sharded PCG
    (``node_partition``), float64: its load factors and its launches of
    K4c alone (the sharded coarse product) and of K4."""
    from fcvm_tpu_torch.parallel import dist as pdist

    k4c, k4 = kernels.coarse_product.launches, kernels.two_level_apply.launches
    res = solve_collapse(_tension_box(2), ControlParams(**GNL_BOX), config=FcvmConfig(
        device=device, dtype="float64", cg_rtol=1e-10, force_sharded=True, node_partition=True,
        n_devices=pdist.world_size()))
    return dict(lbd=np.asarray(res.history.lbd), k4c=kernels.coarse_product.launches - k4c,
                k4=kernels.two_level_apply.launches - k4)


def test_sharded_coarse_product_world_of_one_matches_local(cuda):
    """The node-partitioned sharded PCG on a world of one over NCCL, whose
    preconditioner calls K4c alone on the all-reduced coarse vector,
    against the single-device backend (K4, whose coarse product is the same
    kernel) on the same card, float64: the same load factors to 1e-9, K4c
    launched by the sharded run."""
    from fcvm_tpu_torch.parallel import dist as pdist

    (out,) = pdist.spawn(_node_partition_rank, 1, args=("cuda",), device="cuda", timeout=900)
    ref = solve_collapse(_tension_box(2), ControlParams(**GNL_BOX),
                         config=FcvmConfig(device="cuda", dtype="float64", cg_rtol=1e-10))
    np.testing.assert_allclose(out["lbd"], ref.history.lbd, rtol=1e-9, atol=0)
    assert out["k4c"] > 0


def test_sharded_two_gloo_ranks_on_one_card_match_cpu(cuda):
    """Two ranks on one card over gloo (NCCL refuses two ranks on one
    device; gloo stages each collective through the host): the GNL box's
    load factors against the single-device CPU run to 1e-9, both ranks the
    same bits."""
    from fcvm_tpu_torch.parallel import dist as pdist

    outs = pdist.spawn(_sharded_rank, 2, args=("gnl", "cuda:0"), device="cuda:0",
                       backend="gloo", timeout=900)
    np.testing.assert_array_equal(outs[0]["lbd"], outs[1]["lbd"])
    assert outs[0]["cg"] == outs[1]["cg"]
    ref = solve_collapse(_tension_box(2), ControlParams(**GNL_BOX),
                         config=FcvmConfig(device="cpu", dtype="float64", cg_rtol=1e-10))
    np.testing.assert_allclose(outs[0]["lbd"], ref.history.lbd, rtol=1e-9, atol=0)
    assert outs[0]["k1k4"] > 0


# -- K6: the CG iteration's passes ---------------------------------------------

K6_NSTORE = 8
# "big": past CG_HELD sweeps of the resident grid (a thread reads its later
# items again after the barrier) and 3 rows past a multiple of 4 (a vector
# ends in a ragged item)
K6_SIZES = [1, 1000, 77_777, "big"]
K6_FORMS = ["vector", "deflated", "deflated6", "harvest", "m1", "m5", "m8"]


def _k6_n(cuda, dtype, n, m):
    if n != "big":
        return n
    per = 16 // torch.empty(0, dtype=dtype).element_size()  # values an item
    sweep = kernels.cg_grid(dtype, 1 << 40, max(m, 1), cuda) * 256 * per
    return kernels.CG_HELD * sweep // max(m, 1) + 3


def _k6_inputs(cuda, dtype, n, m, kd, harvest, seed=3):
    """A K6 plan of n rows (a vector for m = 0, else m columns) on a running
    state (on a block every third column frozen), and seeded x, r, p and v:
    what a pass sees mid-solve; with a deflation space of kd vectors."""
    rng = np.random.default_rng(seed)
    shape = (n,) if m == 0 else (n, m)

    def vec(*s):
        return torch.as_tensor(rng.normal(size=s or shape), device=cuda).to(dtype)

    b = vec()
    dfl, hv = None, None
    if kd:
        a = rng.normal(size=(kd, kd))
        dfl = (vec(n, kd), torch.as_tensor(a @ a.T / kd, device=cuda).to(dtype))
    if harvest:
        hv = (torch.zeros((K6_NSTORE, n), dtype=dtype, device=cuda),
              torch.zeros((3, K6_NSTORE), dtype=dtype, device=cuda))
    plan = kernels.cg_plan(b, 1e-3, 0.0, 500, 6, dfl, hv)
    cols = plan.state.shape[0]
    st = plan.state
    st[:, kernels.SLOT_RZ] = torch.as_tensor(rng.uniform(0.5, 2.0, cols), device=cuda)
    st[:, kernels.SLOT_ALPHA] = torch.as_tensor(rng.uniform(0.1, 0.5, cols), device=cuda)
    st[:, kernels.SLOT_BETA] = torch.as_tensor(rng.uniform(0.1, 0.9, cols), device=cuda)
    st[:, kernels.SLOT_K] = 11.0  # past the harvest's 8 slots: the clamped slot
    st[:, kernels.SLOT_SINCE] = 5.0
    st[:, kernels.SLOT_BEST] = 1e9
    st[:, kernels.SLOT_TOL] = 1e-6
    st[:, kernels.SLOT_GATE] = 1e9  # armed: a stall ends the column
    running = torch.ones(cols, dtype=torch.float64, device=cuda)
    running[::3] = 0.0 if cols > 1 else 1.0
    st[:, kernels.SLOT_RUN] = running
    st[:, kernels.SLOT_NEXT] = running
    # the floats a pass casts to the working dtype are exact in it
    st[:, :3] = st[:, :3].to(dtype).to(torch.float64)
    # x, r, p and v near one vector, so no inner product cancels: each sum
    # is then held to TOL of its own size
    base = vec()
    return plan, [base + 0.1 * vec() for _ in range(4)]


def _k6_compare(dtype, step, start, plan_k, vk, plan_r, vr, vin):
    """The kernel's pass against the plain version's: the counters and flags
    exactly, the sums and what follows from them to TOL; x, r and p bit for
    bit what the plain version's updates make of the inputs with the
    kernel's own step lengths (a deflated direction to TOL of the plain
    version's: z + W c is a sum), z never written; a harvest's residuals bit
    for bit."""
    tol = TOL[dtype]

    def near(a, b):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max()), (step, start)

    sk, sr = plan_k.state, plan_r.state
    exact = [kernels.SLOT_K, kernels.SLOT_SINCE, kernels.SLOT_RUN, kernels.SLOT_NEXT,
             kernels.SLOT_STALL_LIM, kernels.SLOT_MAXITER, kernels.SLOT_BNORM,
             kernels.SLOT_RTOL, kernels.SLOT_ATOL]
    assert torch.equal(sk[:, exact], sr[:, exact]), (step, start)
    for slot in (kernels.SLOT_RZ, kernels.SLOT_ALPHA, kernels.SLOT_BETA, kernels.SLOT_RNORM,
                 kernels.SLOT_BEST, kernels.SLOT_TOL, kernels.SLOT_GATE):
        near(sk[:, slot], sr[:, slot])  # each scalar against its own size
    rows = sk.tolist()
    run = [bool(row[kernels.SLOT_RUN]) for row in rows]
    alpha = [row[kernels.SLOT_ALPHA] for row in rows]
    x, r, p, z = (t.clone() for t in vin)
    if step == 0 and not start and any(run):
        kernels.cg_update_r(r, z, alpha, run)
    elif step == 1 and start:
        p.copy_(z)
    elif step == 1 and any(run):
        kernels.cg_update_direction(x, p, z, alpha, [row[kernels.SLOT_BETA] for row in rows],
                                    run)
    deflated = plan_k.w is not None and step == 1
    for i, (a, want) in enumerate(zip(vk, (x, r, p, vin[3]))):
        if deflated and i == 2:
            near(a, vr[2])
        else:
            assert torch.equal(a, want), (step, start, i)
    if deflated:
        near(plan_k.c, plan_r.c)
    if plan_k.zs is not None:
        assert torch.equal(plan_k.zs, plan_r.zs)
        near(plan_k.coef, plan_r.coef)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("form", K6_FORMS)
@pytest.mark.parametrize("n", K6_SIZES)
def test_cg_iteration_kernel_matches_plain(cuda, dtype, form, n):
    """Each of K6's two passes, and their start forms, against the plain
    version on the same inputs (a vector, with a deflation space of 32
    vectors or of 6, which the plan pads to 8, or a harvest of 8 slots, or a
    block of 1, 5 and 8 columns with frozen ones); the direction pass on the
    partials an update pass's start form leaves of r; a second launch on the
    same inputs gives the same bits; one launch each counted."""
    m = int(form[1:]) if form.startswith("m") else 0
    kd = {"deflated": 32, "deflated6": 6}.get(form, 0)
    n = _k6_n(cuda, dtype, n, m)
    for start in (False, True):
        for step in (0, 1):
            plan, vin = _k6_inputs(cuda, dtype, n, m, kd, form == "harvest")
            if step == 1:  # the partials of r, as the update pass leaves them
                kernels.cg_iteration(0, plan, *vin, start=True)
            (pk, vk), (pk2, vk2), (pr, vr) = ((plan.copy(), [v.clone() for v in vin])
                                             for _ in range(3))
            launches = kernels.cg_iteration.launches
            for p_, v_ in ((pk, vk), (pk2, vk2)):
                kernels.cg_iteration(step, p_, *v_, start=start)
            torch.cuda.synchronize()
            assert kernels.cg_iteration.launches == launches + 2
            kernels.cg_iteration_ref(step, start, pr, *vr)
            _k6_compare(dtype, step, start, pk, vk, pr, vr, vin)
            assert torch.equal(pk.state, pk2.state) and all(
                torch.equal(a, b) for a, b in zip(vk, vk2))
            del plan, vin, pk, vk, pk2, vk2, pr, vr


def test_cg_iteration_idle_pass_writes_nothing(cuda):
    """A plan whose every column is done: no pass writes a value (the update
    pass sets run to 0 and nothing else)."""
    plan, vecs = _k6_inputs(cuda, torch.float32, 5000, 8, 0, False)
    plan.state[:, kernels.SLOT_NEXT] = 0.0
    state, before = plan.state.clone(), [v.clone() for v in vecs]
    for step in range(len(kernels.CG_PASSES)):
        kernels.cg_iteration(step, plan, *vecs)
    torch.cuda.synchronize()
    state[:, kernels.SLOT_RUN] = 0.0
    assert torch.equal(plan.state, state)
    assert all(torch.equal(a, b) for a, b in zip(vecs, before))


def test_cg_iteration_refused_launch_raises(cuda):
    """A grid larger than what stays resident: the cooperative launch is
    refused and the wrapper raises, with no fallback and nothing written."""
    plan, vecs = _k6_inputs(cuda, torch.float32, 1 << 20, 0, 0, False)
    grid = 8 * kernels.cg_grid(torch.float32, 1 << 40, 1, cuda)
    big = kernels.CGPlan(plan.state, None, None, None, None,
                         torch.empty(kernels.cg_layout(grid, 1, 0)[3], device=cuda),
                         plan.barrier, None, grid)
    state, before = plan.state.clone(), [v.clone() for v in vecs]
    launches = kernels.cg_iteration.launches
    for step in range(len(kernels.CG_PASSES)):
        with pytest.raises(RuntimeError, match="cooperative launch"):
            kernels.cg_iteration(step, big, *vecs)
    torch.cuda.synchronize()
    assert kernels.cg_iteration.launches == launches
    assert torch.equal(plan.state, state)
    assert all(torch.equal(a, b) for a, b in zip(vecs, before))


def _box_solve(device, harvest):
    model = _tension_box(3)
    be = TorchSystem(model, FcvmConfig(device=device, dtype="float64", precond="two_level",
                                       cg_rtol=1e-8), torch.float64, torch.device(device))
    esm, pinv, _, rhs, *_ = be.assemble(be.tensor(model.mesh.coords))
    khat, pc = be.operator(esm), be.make_pc(esm, pinv)
    tslv.CG_STATS.clear()
    if harvest:
        res, h = be.solve_harvest(khat, pc, rhs, nstore=16)
        return res, dict(tslv.CG_STATS), torch.cat([h.zs.reshape(-1), h.rzs, h.alphas, h.betas])
    return be.solve(khat, pc, rhs), dict(tslv.CG_STATS), None


@pytest.mark.parametrize("harvest", [False, True], ids=["pcg", "pcg_harvest"])
def test_device_cg_cuda_matches_cpu(cuda, harvest):
    """A whole pcg and pcg_harvest through K1, K4 and K6 on the card against
    the CPU, float64, two-level, rtol 1e-8: equal counts, the same solution
    to 1e-10 and harvest to 1e-9; on the card K6 launched twice an
    iteration queued and twice a solve's start, and the state read at most
    ceil(iters / CG_BATCH) + 2 times."""
    launches = kernels.cg_iteration.launches
    res, stats, hv = _box_solve("cuda", harvest)
    torch.cuda.synchronize()
    ref, ref_stats, ref_hv = _box_solve("cpu", harvest)
    assert res.iters == ref.iters > 5
    x_ref = ref.x.numpy()
    np.testing.assert_allclose(res.x.cpu().numpy(), x_ref, rtol=0,
                               atol=1e-10 * np.abs(x_ref).max())
    if harvest:
        assert float((hv.cpu() - ref_hv).abs().max()) <= 1e-9 * float(ref_hv.abs().max())
    assert stats == ref_stats
    assert stats["reads"] <= -(-res.iters // tslv.CG_BATCH) + 2
    assert kernels.cg_iteration.launches - launches == 2 * (stats["queued"] + stats["solves"])


# -- K2, the stress update and internal force ---------------------------------------


def _k2_inputs(dtype, large, per_element, seed=18):
    """K2's inputs on the card: a 6 x 6 x 6 box (1,296 elements) with its
    nodes moved by up to 5% of an element, a step-start displacement and
    increment, seeded old stresses, one D or a D and moduli per element, and
    yield stresses that make about half the Gauss points plastic, each at
    least 10% from the surface in the plain version's float64 update."""
    mesh = meshgen.box_tet10(6, 6, 6, 10.0, 10.0, 10.0)
    rng = np.random.default_rng(seed)
    nn, ne = mesh.coords.shape[0], mesh.elnodes.shape[0]
    f64 = torch.float64
    cuda = torch.device("cuda")

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=cuda).to(dt)

    coords = mesh.coords + 0.05 * (10.0 / 6) * rng.uniform(-1, 1, size=mesh.coords.shape)
    disp = rng.normal(scale=0.01, size=3 * nn + 3)
    du = rng.normal(scale=1e-3, size=3 * nn + 3)
    sig = rng.normal(scale=60.0, size=(ne, 4, 6))
    e = 210000.0 * rng.uniform(0.5, 2.0, size=ne) if per_element else 210000.0
    nu = 0.3 + 0.05 * rng.uniform(-1, 1, size=ne) if per_element else 0.3
    e_t, nu_t = (dev(e), dev(nu)) if per_element else (e, nu)
    g = tmat.shear_modulus(tmat.per_gauss(e_t), tmat.per_gauss(nu_t))
    h = tmat.hardening_modulus(tmat.per_gauss(e_t), 0.1)
    dmat = tmat.hooke_dmat(e_t, nu_t, dtype, cuda)
    eln = torch.as_tensor(mesh.elnodes.astype(np.int64), device=cuda)
    kw = dict(du=dev(du), dmat=dmat, g=g, h=h)
    trial = kernels.stress_update_ref(dev(coords, f64), eln, dev(disp, f64), dev(sig, f64), large,
                                      du=dev(du, f64), dmat=dmat.to(f64), sig_yield=dev(
                                          np.full((ne, 4), 1e30), f64),
                                      g=g.to(f64) if torch.is_tensor(g) else g,
                                      h=h.to(f64) if torch.is_tensor(h) else h)[1]
    svm = tmat.von_mises(trial)[2].cpu().numpy()
    plastic = rng.uniform(size=(ne, 4)) < 0.5
    sy = np.where(plastic, rng.uniform(0.5, 0.9, size=(ne, 4)),
                  rng.uniform(1.1, 1.5, size=(ne, 4))) * svm
    kw["sig_yield"] = dev(sy)
    weights = dev((rng.uniform(size=ne) > 0.3) * rng.uniform(0.5, 2.0, size=ne))
    return (dev(coords), eln, dev(disp), dev(sig)), kw, weights


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("large", [False, True], ids=["small_strain", "gnl"])
@pytest.mark.parametrize("per_element", [False, True], ids=["one_d", "per_element_d"])
@pytest.mark.parametrize("form", ["update", "given"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_stress_update_kernel_matches_plain(cuda, dtype, large, per_element, form, weighted):
    """K2 against its plain version on the same tensors, each output to TOL
    of its largest entry, the plastic flags equal (no point lies within 10%
    of the surface), one launch counted; in float32 the kernel no farther
    from the float64 plain version than twice the float32 plain version."""
    args, kw, weights = _k2_inputs(dtype, large, per_element)
    if form == "given":
        kw = {}
    if weighted:
        kw["weights"] = weights
    launches = kernels.stress_update.launches
    got = kernels.stress_update(*args, large, **kw)
    torch.cuda.synchronize()
    assert kernels.stress_update.launches == launches + 1
    want = kernels.stress_update_ref(*args, large, **kw)
    got, want = ((got,), (want,)) if form == "given" else (got, want)
    if form == "update":
        assert torch.equal(got[2], want[2]) and 0.3 < float(got[2].float().mean()) < 0.7
    floats = [(a, b) for a, b in zip(got, want) if a.dtype != torch.bool]
    for a, b in floats:
        assert _rel(a, b) <= TOL[dtype]
    if dtype == torch.float32:
        f64 = [a.double() if a.is_floating_point() else a for a in args]
        kw64 = {k: v.double() if torch.is_tensor(v) else v for k, v in kw.items()}
        exact = kernels.stress_update_ref(*f64, large, **kw64)
        exact = (exact,) if form == "given" else exact
        for (a, b), c in zip(floats, [x for x in exact if x.dtype != torch.bool]):
            assert _rel(a.double(), c) <= 2 * max(_rel(b.double(), c), 1e-7)


def test_stress_update_repeats_its_bits(cuda):
    """Two launches on one input give the same bits (float32, GNL, per
    element, weighted; and the given-stress form)."""
    args, kw, weights = _k2_inputs(torch.float32, True, True)
    a = kernels.stress_update(*args, True, weights=weights, **kw)
    b = kernels.stress_update(*args, True, weights=weights, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(kernels.stress_update(*args, True), kernels.stress_update(*args, True))


def test_stress_update_rejects_what_it_does_not_take(cuda):
    (coords, eln, disp, sig), kw, _ = _k2_inputs(torch.float32, False, False)
    bad = (TypeError, ValueError, RuntimeError)
    with pytest.raises(TypeError):
        kernels.stress_update(coords, eln, disp, sig.double(), **kw)
    with pytest.raises(TypeError):
        kernels.stress_update(coords, eln.int(), disp, sig, **kw)
    with pytest.raises(ValueError):
        kernels.stress_update(coords, eln, disp, sig.cpu(), **kw)
    with pytest.raises(bad):
        kernels.stress_update(coords, eln, disp, sig[:, :3].contiguous(), **kw)
    with pytest.raises(bad):
        kernels.stress_update(coords, eln, disp, sig.transpose(1, 2).contiguous()
                              .transpose(1, 2), **kw)
    with pytest.raises(bad):
        kernels.stress_update(coords, eln, disp, sig, **{**kw, "dmat": kw["dmat"][:5]})
    with pytest.raises(ValueError):
        kernels.stress_update(coords, eln, None, sig, True)


@pytest.mark.parametrize("large", [False, True], ids=["small_strain", "gnl"])
def test_stress_update_forms_take_a_float64_disp(cuda, large, monkeypatch):
    """A float32 run's disp is float64 once the refinement tier has committed
    a step.  The reaction (``internal_force_from_stress``) takes it in both
    modes, casting it where K2 reads it (GNL), and the small-strain update
    takes it unread; each through K2 against the plain version on the same
    tensors, and the small-strain results the bits of a float32 disp."""
    from fcvm_tpu_torch.ops.stress_update import internal_force_from_stress, update_stress_load
    (coords, eln, disp, sig), kw, _ = _k2_inputs(torch.float32, large, False)
    disp64 = disp.double() + 1e-9

    def forms(d):
        out = [internal_force_from_stress(coords, eln, sig, d, large)]
        if not large:
            out += update_stress_load(coords, eln, kw["dmat"], kw["sig_yield"], d, kw["du"], sig,
                                      210000.0, 0.3, 0.1, False)
        return out

    launches = kernels.stress_update.launches
    got = forms(disp64)
    assert kernels.stress_update.launches == launches + (1 if large else 2)
    if not large:
        assert all(torch.equal(a, b) for a, b in zip(got, forms(disp)))
    monkeypatch.setattr(kernels, "stress_update", kernels.stress_update_ref)
    for a, b in zip(got, forms(disp64)):
        if a.dtype == torch.bool:
            assert torch.equal(a, b)
        else:
            assert a.dtype == torch.float32 and _rel(a, b) <= TOL[torch.float32]


def test_driver_launches_stress_update_once_a_residual(cuda, monkeypatch):
    """A GNL plastic run of the 3x3x3 box on the card launches K2's element
    pass and its node pass once each for each stress update and internal
    force the driver asks of its backend, every residual among them, and
    for nothing else."""
    calls = {"n": 0}
    for name in ("residual", "residual_refined", "stress_update", "internal_force"):
        method = getattr(TorchSystem, name)

        def counted(self, *a, _m=method, **k):
            calls["n"] += 1
            return _m(self, *a, **k)

        monkeypatch.setattr(TorchSystem, name, counted)
    params = ControlParams(sig_yield=60.0, nstep=3, error_max=1e-8, et_e=0.1, target_lf=99.0,
                           gnl="GNLY", max_imp=0.0)
    launches = kernels.stress_update.launches, kernels.node_force.launches
    res = solve_collapse(_tension_box(3), params, config=FcvmConfig(device="cuda",
                                                                     dtype="float64"))
    assert len(res.history.lbd) == 4 and max(res.history.peeqmax) > 0
    assert kernels.stress_update.launches - launches[0] == calls["n"] > 3
    assert kernels.node_force.launches - launches[1] == calls["n"]


def _k2_residual_inputs(dtype, seed=20):
    """A load vector, a mask with 20% fixed dofs and the write-form node plan
    over the dof vectors of :func:`_k2_inputs` (one node past the mesh)."""
    (coords, eln, disp, sig), kw, weights = _k2_inputs(dtype, True, True)
    rng = np.random.default_rng(seed)
    nd = disp.shape[0]
    glv = torch.as_tensor(rng.normal(scale=50.0, size=nd), device=coords.device).to(dtype)
    fixmask = torch.as_tensor(rng.uniform(size=nd) > 0.2, device=coords.device).to(dtype)
    plan = kernels.segment_plan(eln, rows=nd // 3)
    return (coords, eln, disp, sig), kw, weights, glv, fixmask, plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_node_force_kernel_matches_plain(cuda, dtype):
    """K2's node pass, the internal force: bit for bit K8's write form on the
    same rows and plan, to TOL of its plain version (``index_add_``), zero in
    the holes, one launch counted."""
    (coords, eln, disp, sig), kw, weights, glv, fixmask, plan = _k2_residual_inputs(dtype)
    elv = kernels.stress_update(coords, eln, disp, sig, True, weights=weights)
    rows = disp.shape[0] // 3
    launches = kernels.node_force.launches
    qin = kernels.node_force(elv, plan, rows=rows)
    torch.cuda.synchronize()
    assert kernels.node_force.launches == launches + 1
    k8 = kernels.segment_sum(elv.reshape(-1, 3).contiguous(), plan, rows=rows).reshape(-1)
    assert torch.equal(qin, k8)
    want = kernels.node_force_ref(elv, plan, rows)
    assert _rel(qin, want) <= TOL[dtype]
    assert torch.equal(qin.reshape(-1, 3)[plan.holes.long()],
                       torch.zeros((plan.holes.shape[0], 3), dtype=dtype, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("large", [False, True], ids=["small_strain", "gnl"])
@pytest.mark.parametrize("per_element", [False, True], ids=["one_d", "per_element_d"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_residual_matches_the_unfused_composition(cuda, dtype, large, per_element, weighted):
    """K2's two passes as one residual (``kernels.stress_residual_bound``,
    relax 0.7) against the unfused composition on the card (the element pass, K8's
    write form, the torch tail): sig_new, sig_test, pgp, qin and r bit for
    bit, error within 4 ulps; against the plain version to TOL; two calls the
    same bits; one launch of each pass a call."""
    (coords, eln, disp, sig), kw, weights, glv, fixmask, plan = _k2_residual_inputs(dtype)
    if not per_element:
        args, kw, _ = _k2_inputs(dtype, large, False)
        coords, eln, disp, sig = args
    w = weights if weighted else None
    lbd1, qnorm, relax = 1.3, 7.0, 0.7
    mats = dict(dmat=kw["dmat"], g=kw["g"], h=kw["h"])
    launches = kernels.stress_update.launches, kernels.node_force.launches
    k2 = kernels.stress_residual_bound(eln, plan, fixmask, weights=w, **mats)
    got = [k2(coords, disp, kw["du"], sig, kw["sig_yield"], glv, lbd1, qnorm, large, relax)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert (kernels.stress_update.launches, kernels.node_force.launches) == (
        launches[0] + 2, launches[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(*got))
    got = got[0]
    sig_new, sig_test, pgp, elv = kernels.stress_update(coords, eln, disp, sig, large,
                                                        weights=w, **kw)
    qin = kernels.segment_sum(elv.reshape(-1, 3).contiguous(), plan,
                              rows=disp.shape[0] // 3).reshape(-1)
    lbd = torch.as_tensor(lbd1, dtype=torch.float64, device=cuda).to(dtype)
    raw = fixmask * (lbd * glv - qin)
    error = torch.linalg.vector_norm(raw) / qnorm
    for a, b in zip(got[:5], (sig_new, sig_test, pgp, qin, relax * raw)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[5].dim() == 0 and got[5].dtype == dtype
    ulp = torch.finfo(dtype).eps * abs(float(error))
    assert abs(float(got[5]) - float(error)) <= 4 * ulp
    plain = kernels.stress_residual_ref(coords, eln, disp, kw["du"], sig, kw["sig_yield"], glv,
                                        fixmask, lbd1, qnorm, large, relax, plan=plan,
                                        weights=w, **mats)
    for a, b in zip(got, plain):
        if a.dtype == torch.bool:
            assert torch.equal(a, b)
        else:
            assert _rel(a, b) <= TOL[dtype]


def test_residual_rejects_what_it_does_not_take(cuda):
    (coords, eln, disp, sig), kw, weights, glv, fixmask, plan = _k2_residual_inputs(
        torch.float32)
    mats = dict(dmat=kw["dmat"], g=kw["g"], h=kw["h"])
    bad = (TypeError, ValueError, RuntimeError)
    with pytest.raises(ValueError):  # a plan of other rows
        kernels.stress_residual_bound(eln, kernels.segment_plan(eln), fixmask, **mats)
    with pytest.raises(bad):
        kernels.stress_residual_bound(eln, plan, fixmask.double(), **mats)
    with pytest.raises(ValueError):
        kernels.stress_residual_bound(eln, plan, fixmask.cpu(), **mats)
    k2 = kernels.stress_residual_bound(eln, plan, fixmask, **mats)
    with pytest.raises(bad):  # glv of another length
        k2(coords, disp, kw["du"], sig, kw["sig_yield"], glv[:-3], 1.0, 1.0)
    with pytest.raises(bad):
        k2(coords, disp, kw["du"], sig, kw["sig_yield"], glv.double(), 1.0, 1.0)


# -- the bench's sharded row and the float32 Newton floor under it -----------------


class _Restarted(Exception):
    pass


def test_sharded_rows_float32_newton_floor(cuda):
    """The first attempt of the sharded row's first step (its physics in
    float32, ``error_max`` 1e-12, no precision tiers, stopped at its first
    restart after 7 iterations) on the box at ``SHARDED_NX``, 16 and
    ``NX_BOX``: where its Newton error stalls.  The floor grows with the box,
    and at ``SHARDED_NX`` it lies ``FIRST_STEP_MARGIN`` times below the row's
    ``error_max``.  Each size's errors are printed as one JSON line."""
    import json

    from fcvm_tpu_torch.tools import bench as tb

    floors = []
    for nx in (tb.SHARDED_NX, 16, tb.NX_BOX):
        _, model = tb.build(nx)
        errors = []

        def progress(line, errors=errors):
            if line.startswith("Iteration: "):
                errors.append(float(line.rsplit(" ", 1)[1]))
            elif line.startswith("RESTART"):
                raise _Restarted

        with pytest.raises(_Restarted):
            solve_collapse(model, ControlParams(**{**tb.SHARDED_PARAMS, "error_max": 1e-12,
                                                   "iterat_max": 7}),
                           progress=progress, config=FcvmConfig(
                               device="cuda", dtype="float32", residual_refinement=False,
                               precision_failover=False))
        print(json.dumps({"nx": nx, "ndof": 3 * len(model.mesh.coords), "errors": errors}))
        floors.append(min(errors))
    assert floors == sorted(floors)
    assert floors[0] * tb.FIRST_STEP_MARGIN <= tb.SHARDED_PARAMS["error_max"]


def _plain_residual_bound(elnodes, plan, fixmask, dmat, g, h, *, weights=None, table=None):
    """``kernels.stress_residual_bound`` with its plain version on the card."""
    def k2(coords, disp, du, sig_old, sig_yield, glv, lbd1, qnorm, large_disp=False, relax=1.0):
        return kernels.stress_residual_ref(coords, elnodes, disp, du, sig_old, sig_yield, glv,
                                           fixmask, lbd1, qnorm, large_disp, relax, dmat=dmat,
                                           g=g, h=h, plan=plan, weights=weights)
    return k2


def test_sharded_row_passes_with_the_plain_stress_update_on_the_local_path(cuda, monkeypatch):
    """The bench's sharded row with the local run's stress update and
    residual from K2's plain versions (the sum order of the chain the path
    ran before K2) and the sharded run's from K2: a row that judges parity,
    not rounding, passes under both orders.  Its record is printed as one
    JSON line."""
    import json

    from fcvm_tpu_torch.tools import bench as tb

    run = tb.solve_collapse
    local_launches = []

    def plain_local(model, params, **kw):
        if kw["config"].force_sharded:
            return run(model, params, **kw)
        launches = kernels.stress_update.launches + kernels.node_force.launches
        with monkeypatch.context() as m:
            m.setattr(kernels, "stress_update", kernels.stress_update_ref)
            m.setattr(kernels, "node_force",
                      lambda elv, plan, rows: kernels.node_force_ref(elv, plan, rows))
            m.setattr(kernels, "stress_residual_bound", _plain_residual_bound)
            out = run(model, params, **kw)
        local_launches.append(kernels.stress_update.launches + kernels.node_force.launches
                              - launches)
        return out

    monkeypatch.setattr(tb, "solve_collapse", plain_local)
    launches = kernels.stress_update.launches
    row = tb.sharded_record(tb.SHARDED_NX, "cuda")
    faults = tb.sharded_faults(row)
    print(json.dumps({"faults": faults, "stress_update_launches":
                      kernels.stress_update.launches - launches, **row}))
    assert local_launches == [0] and kernels.stress_update.launches > launches
    assert faults == []
