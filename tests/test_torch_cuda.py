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
# 451,875-dof beam-column
PATH_SIZES = {"plate": (117_936, 167_533), "column": (103_680, 150_625)}


def _random_operator(ne, nn, dtype, seed):
    """Random element blocks (30, 30, ne), a random connectivity of ne
    elements over nn nodes (ten distinct nodes an element, spread as a
    mesh's are: element e's nodes near node e nn / ne) with its
    node-incidence table, a dof vector and a mask with a tenth of the dofs
    fixed, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    esm_t = torch.randn((30, 30, ne), generator=gen, device="cuda", dtype=dtype)
    base = torch.arange(ne, device="cuda")[:, None] * nn // ne
    off = torch.argsort(torch.rand((ne, 40), generator=gen, device="cuda"), dim=1)[:, :10]
    elnodes = (base + off) % nn
    inc = tasm.node_incidence(elnodes, nn)
    u = torch.randn(3 * nn, generator=gen, device="cuda", dtype=dtype)
    fm = (torch.rand(3 * nn, generator=gen, device="cuda") > 0.1).to(dtype)
    return esm_t, inc, u, fm


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("form", ["masked", "raw"])
@pytest.mark.parametrize("size", ["box", "plate", "column"])
def test_khat_matvec_kernel_matches_plain(cuda, dtype, form, size):
    """K1 against its plain version on the card, masked and raw: on the
    3x3x3 box's operator and mask in its solve space, and on random blocks
    and connectivity at the plate's and the beam-column's element and node
    counts; max |kernel - plain| / max |plain| within TOL; the same bits on
    a second call; one launch counted each."""
    if size == "box":
        be = TorchSystem(_tension_box(3), FcvmConfig(device="cuda", dtype="float64"), dtype,
                         cuda)
        esm, *_ = be.assemble(be.tensor(be.mesh.coords))
        esm_t, inc, fm = be.operator(esm).esm_t, be.space.incidence, be.space.fixmask_m
        u = torch.randn(be.ndof_pad, generator=torch.Generator(device="cuda").manual_seed(1),
                        device="cuda", dtype=dtype)
    else:
        esm_t, inc, u, fm = _random_operator(*PATH_SIZES[size], dtype, seed=2)
    fm = fm if form == "masked" else None
    launches = kernels.khat_matvec.launches
    out = kernels.khat_matvec(esm_t, inc, u, fm)
    again = kernels.khat_matvec(esm_t, inc, u, fm)
    torch.cuda.synchronize()
    assert kernels.khat_matvec.launches == launches + 2
    assert torch.equal(out, again)  # fixed-order sums: deterministic
    ref = kernels.khat_matvec_ref(esm_t, inc, u, fm)
    assert float((out - ref).abs().max()) <= TOL[dtype] * float(ref.abs().max())


def test_khat_matvec_rejects_what_it_does_not_take(cuda):
    esm_t, inc, u, fm = _random_operator(50, 120, torch.float32, seed=3)
    with pytest.raises(TypeError):
        kernels.khat_matvec(esm_t, inc, u.double(), fm)
    with pytest.raises(TypeError):
        kernels.khat_matvec(esm_t, inc._replace(pos=inc.pos.long()), u, fm)
    with pytest.raises(ValueError):
        kernels.khat_matvec(esm_t, inc, u.cpu(), fm)
    with pytest.raises(ValueError):
        kernels.khat_matvec(esm_t, inc, u[:-3], fm)


def _random_precond(nn, cs, ncl, nm, dtype, seed):
    """Random block-Jacobi blocks, mode basis (zero past the nn nodes),
    coarse inverse, mask, vector and fine-level output on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    qmat = randn(ncl * cs, 3, nm)
    qmat[nn:] = 0.0
    fm = (torch.rand(3 * nn, generator=gen, device="cuda") > 0.1).to(dtype)
    return (randn(nn, 3, 3), qmat, randn(nm * ncl, nm * ncl) / (nm * ncl) ** 0.5, fm,
            randn(3 * nn), randn(3 * nn))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("fine", ["jacobi3", "cluster"])
@pytest.mark.parametrize("size", ["box", "plate", "column"])
def test_two_level_apply_kernel_matches_plain(cuda, dtype, fine, size):
    """K4 against its plain version on the card, with block Jacobi and with
    the cluster smoother's output as the fine level: on the 3x3x3 box's
    preconditioner (16-node smoother clusters), and on random state at the
    plate's and the beam-column's node counts with their coarse sizes (12
    modes on 1,022 clusters of 164 nodes; 1,021 of 148); within TOL, the
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
    ref = kernels.two_level_apply_ref(*args, z_fine)
    assert float((out - ref).abs().max()) <= TOL[dtype] * float(ref.abs().max())


def test_two_level_apply_rejects_what_it_does_not_take(cuda):
    pinv, qmat, kinv, fm, r, _ = _random_precond(200, 16, 13, 12, torch.float32, seed=6)
    with pytest.raises(TypeError):
        kernels.two_level_apply(pinv, qmat, kinv.double(), fm, r)
    with pytest.raises(ValueError):
        kernels.two_level_apply(pinv, qmat, kinv, fm, r.cpu())
    with pytest.raises(ValueError):
        kernels.two_level_apply(pinv, qmat[:, :, :7], kinv, fm, r)
    with pytest.raises(ValueError):
        kernels.two_level_apply(pinv, qmat.transpose(1, 2).contiguous().transpose(1, 2), kinv,
                                fm, r)


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
    """The block PCG through K0m on the card against the CPU, float64:
    every column's CG count within one (atomic sums in another order), the
    same solutions."""
    ref, res = _pcg_block("cpu"), _pcg_block("cuda")
    assert all(abs(a - b) <= 1 for a, b in zip(res.iters, ref.iters))
    np.testing.assert_allclose(res.x.cpu().numpy(), ref.x.numpy(), rtol=0,
                               atol=1e-9 * float(ref.x.abs().max()))


def test_linear_buckling_cuda_matches_cpu(cuda):
    """linear_buckling of the 8x1x1 clamped-free column in float64 on the
    card (K0m in every K_hat·V and -G_hat·V) against the CPU: the factors
    to 1e-10, the (near-degenerate) mode pair spanning the same plane.  The
    solves run to 1e-12: at the default 1e-6 the two devices' pre-stress
    solves, whose sums round in another order, differ by ~1e-8, and so do
    the factors."""
    params = ControlParams(gnl="GNLY", nstep=1)
    out = {}
    for device in ("cpu", "cuda"):
        launches = kernels.block_matmat.launches
        out[device] = linear_buckling(
            _column_model(), params,
            config=FcvmConfig(device=device, dtype="float64", cg_rtol=1e-12))
        out[device] += (kernels.block_matmat.launches - launches,)
    (lam_c, v_c, k0m_c), (lam_g, v_g, k0m_g) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(lam_g, lam_c, rtol=1e-10, atol=0)
    coef, *_ = np.linalg.lstsq(v_c, v_g, rcond=None)
    assert np.linalg.norm(v_g - v_c @ coef) < 1e-6 * np.linalg.norm(v_g)
    assert k0m_c == 0 and k0m_g > 0


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
    K0m launches."""
    from fcvm_tpu_torch.parallel import dist as pdist

    model, params = ((_tension_box(2), GNL_BOX) if case == "gnl" else
                     (_column_model(), COLUMN))
    cg, k0m = _cg_launches(), kernels.block_matmat.launches
    res = solve_collapse(model, ControlParams(**params), config=FcvmConfig(
        device=device, dtype="float64", cg_rtol=1e-10, force_sharded=True,
        n_devices=pdist.world_size()))
    return dict(lbd=np.asarray(res.history.lbd), eig=res.eigenvalues,
                cg=[s["cg"] for s in res.cg_stats["steps"]], iters=res.cg_stats["iters"],
                k1k4=min(np.subtract(_cg_launches(), cg)),
                k0m=kernels.block_matmat.launches - k0m)


@pytest.mark.parametrize("case", ["gnl", "column"])
def test_sharded_world_of_one_over_nccl_matches_torchsystem(cuda, case):
    """The sharded backend on a world of one over NCCL against the
    single-device backend on the same card, float64: the same load and
    buckling factors to 1e-9, K1 and K4 (and K0m for the eigensolve)
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
        assert out["k0m"] > 0
    assert out["k1k4"] > 0


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
