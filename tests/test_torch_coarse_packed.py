"""K4c's packed coarse inverse on the CPU: the packing, an emulation of the
kernel's schedule, and K4's and K4m's plain versions fed the packed copy
against the JAX package, float64.

* ``kernels.pack_coarse``/``unpack_coarse``: the upper 128 x 128 tiles of
  the symmetric coarse inverse, each contiguous, in row-major tile order,
  the last tile row and column zero-padded; unpacking mirrors them.
* The schedule of ``csrc/two_level.cu``'s K4c, emulated here: equal runs of
  the tile list, a run's row products kept per tile row it touches, each
  off-diagonal tile's transposed product a partial of its own, the sum pass
  in its order; it gives the dense product of the mirrored triangle.
* ``coarse_product_ref`` on a vector and on blocks against that dense
  product.
* K4 and K4m (``kernels.two_level_apply``/``two_level_apply_block``) on
  CPU tensors fed the packed copy against the JAX package's
  ``TwoLevelPrecond.apply`` (under ``jax.vmap`` for the block) with the
  same symmetric coarse inverse, on a small box.

CPU tensors take the plain versions, so no launch is counted.  The kernel
on the card is tested in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import E, F64, NU, t64

import fcvm_tpu
from fcvm_tpu.config import get_config
from fcvm_tpu.models import meshgen
from fcvm_tpu.ops import assembly as asm
from fcvm_tpu.ops import material as mat
from fcvm_tpu.runtime import system as sysm
from fcvm_tpu.utils.indexing import pad_ndof, pad_vector
from fcvm_tpu_torch.models.spec import to_torch
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import precond as tpre

RTOL = 1e-12  # max |port - JAX| / max |JAX|: float64 sums in another order


def _close(got, want, rel):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _spd(n, seed):
    """A seeded symmetric positive definite (n, n) float64 matrix."""
    a = np.random.default_rng(seed).normal(size=(n, n))
    return torch.as_tensor(a @ a.T / n + np.eye(n))


def _mirrored(a):
    """The symmetric matrix of a's upper triangle i <= j."""
    upper = torch.triu(a)
    return upper + torch.triu(a, 1).T


@pytest.mark.parametrize("n,tile", [(1, 4), (7, 4), (13, 4), (129, 128), (301, 128),
                                    (255, 16)])
def test_pack_round_trip(n, tile):
    """Unpacking gives the mirrored upper triangle bit for bit, also of a
    matrix that is not symmetric, at sizes that leave a padded edge tile;
    the padding is zero and each diagonal tile is symmetric."""
    a = torch.as_tensor(np.random.default_rng(n).normal(size=(n, n)))
    packed = kernels.pack_coarse(a, tile)
    nb = -(-n // tile)
    assert packed.n == n and packed.tiles.shape == (nb * (nb + 1) // 2, tile, tile)
    assert packed.tiles.is_contiguous()
    assert torch.equal(kernels.unpack_coarse(packed), _mirrored(a))
    assert torch.equal(kernels.unpack_coarse(kernels.pack_coarse(_mirrored(a), tile)),
                       _mirrored(a))
    last = packed.tiles[-1]  # the diagonal tile of the last tile row
    edge = n - (nb - 1) * tile
    assert not last[edge:].any() and not last[:, edge:].any()
    diag = packed.tiles[[b * nb - b * (b - 1) // 2 for b in range(nb)]]
    assert torch.equal(diag, diag.transpose(1, 2))


@pytest.mark.parametrize("n,tile", [(5, 4), (17, 4), (300, 128), (12_264 // 8, 64)])
def test_tile_list_covers_each_upper_tile_once(n, tile):
    """Each entry i <= j of the matrix sits in exactly one stored tile, at
    (bi, bj) = (i // T, j // T) in row-major order of the upper tiles, and
    nothing else but the diagonal tiles' mirrored halves and zeros."""
    ids = torch.arange(1, n * n + 1, dtype=F64).reshape(n, n)
    packed = kernels.pack_coarse(torch.triu(ids), tile)
    nb = -(-n // tile)
    bi, bj = torch.triu_indices(nb, nb)
    rows = (bi[:, None, None] * tile + torch.arange(tile)[:, None]).expand(-1, tile, tile)
    cols = (bj[:, None, None] * tile + torch.arange(tile)).expand(-1, tile, tile)
    upper = (rows <= cols) & (cols < n)
    got = packed.tiles[upper]
    want = torch.triu(ids)[rows[upper], cols[upper]]
    assert torch.equal(got, want)
    assert torch.equal(torch.sort(got).values, torch.triu(ids)[torch.triu(ids) > 0].sort().values)
    lower = (rows > cols) & (rows < n)
    assert bool((lower <= (bi == bj)[:, None, None]).all())  # only in diagonal tiles
    assert not packed.tiles[(rows >= n) | (cols >= n)].any()


def _row_start(b, nb):
    return b * nb - b * (b - 1) // 2


def _tile_row(t, nb):
    return max(b for b in range(nb) if _row_start(b, nb) <= t)


def _run_start(k, ntiles, nruns):
    return k * ntiles // nruns


def _run_of(t, ntiles, nruns):
    return ((t + 1) * nruns + ntiles - 1) // ntiles - 1


def emulate_coarse_product(packed, x, nruns):
    """K4c's schedule (``csrc/two_level.cu``) on x (n, m), in order: run k
    of ``nruns`` walks tiles [k P / nruns, (k + 1) P / nruns); per tile the
    row product A x[bj] adds into the run's running sum for tile row bi
    (out as one partial when the run leaves the row) and, off the diagonal,
    the transposed product A^T x[bi] is the tile's partial; then each output
    row adds the partials of the tiles above it in its tile column in
    ascending tile row, into 8 interleaved sums added in a fixed tree, and
    its row's run partials in run order to that."""
    tiles, n = packed
    ntiles, tile, _ = tiles.shape
    nb = -(-n // tile)
    xp = torch.nn.functional.pad(x, (0, 0, 0, nb * tile - n)).reshape(nb, tile, -1)
    sv, su = {}, {}
    for k in range(nruns):
        lo, hi = _run_start(k, ntiles, nruns), _run_start(k + 1, ntiles, nruns)
        b_first = _tile_row(lo, nb)
        bi, bj = b_first, b_first + lo - _row_start(b_first, nb)
        acc = torch.zeros_like(xp[0])
        for t in range(lo, hi):
            a = tiles[t]
            acc = acc + a @ xp[bj]
            if bi != bj:
                sv[t] = a.T @ xp[bi]
            if t + 1 == hi or bj + 1 == nb:
                su[(k, bi - b_first)] = acc
                acc = torch.zeros_like(acc)
            bj += 1
            if bj == nb:
                bi += 1
                bj = bi
    out = torch.empty_like(xp)
    for b in range(nb):
        t0 = _row_start(b, nb)
        s = torch.zeros_like(xp[0])
        for k in range(_run_of(t0, ntiles, nruns), _run_of(t0 + nb - b - 1, ntiles, nruns) + 1):
            s = s + su[(k, b - _tile_row(_run_start(k, ntiles, nruns), nb))]
        p = [torch.zeros_like(s) for _ in range(8)]
        for a in range(b):
            p[a % 8] = p[a % 8] + sv[_row_start(a, nb) + b - a]
        for off in (4, 2, 1):  # ((0 + 4) + (2 + 6)) + ((1 + 5) + (3 + 7))
            p = [p[j] + p[j ^ off] for j in range(8)]
        out[b] = s + p[0]
    return out.reshape(nb * tile, -1)[:n]


@pytest.mark.parametrize("nruns", [1, 3, 7, 45])
@pytest.mark.parametrize("n", [37, 130])
def test_emulated_schedule_gives_the_dense_product(n, nruns):
    """The kernel's runs, segments and partials, emulated, cover every tile
    once and give the dense product of the mirrored triangle to 1e-13; every
    run's partials land in the sum pass (runs shorter and longer than a
    tile row, more runs than tile rows)."""
    a = _spd(n, n)
    packed = kernels.pack_coarse(a, 8)
    x = torch.as_tensor(np.random.default_rng(nruns).normal(size=(n, 3)))
    ntiles = packed.tiles.shape[0]
    nruns = min(nruns, ntiles)
    assert [_run_of(t, ntiles, nruns) for t in range(ntiles)] == [
        k for k in range(nruns) for _ in range(_run_start(k, ntiles, nruns),
                                                _run_start(k + 1, ntiles, nruns))]
    _close(emulate_coarse_product(packed, x, nruns), a @ x, 1e-13)


@pytest.mark.parametrize("m", [1, 2, 8, 13])
def test_plain_versions_give_the_mirrored_product(m):
    """``coarse_product_ref`` on a vector (m = 1) and on (n, m) blocks of a
    seeded SPD matrix of 301 coarse dofs (three tiles a side, the last
    ragged): the dense product to 1e-13; the wrapper on CPU tensors takes it
    and counts no launch."""
    a = _spd(301, 5)
    packed = kernels.pack_coarse(a)
    x = torch.as_tensor(np.random.default_rng(m).normal(size=(301, m)))
    if m == 1:
        x = x[:, 0]
    before = kernels.coarse_product.launches
    got = kernels.coarse_product(packed, x)
    _close(kernels.coarse_product_ref(packed, x), a @ x, 1e-13)
    _close(got, a @ x, 1e-13)
    assert kernels.coarse_product.launches == before
    with pytest.raises(ValueError):
        kernels.coarse_product(packed, x[:-1])


def _jax_precond(smoother):
    """The JAX package's two-level preconditioner of a 3 x 2 x 2 box clamped
    on x = 0 (12 modes, 32-node clusters; the cluster smoother's 64-node
    clusters), its coarse inverse made exactly symmetric, and the port's
    TwoLevelPrecond of the same state with that inverse packed."""
    mesh = meshgen.box_tet10(3, 2, 2, 10.0, 6.0, 6.0)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, 0.0, 0.0))])
    nd = pad_ndof(mesh.ndof)
    fixmask = jnp.asarray(pad_vector(bcs.masks(mesh.ndof)[0], nd))
    esm = asm.elastic_stiffness_blocks(jnp.asarray(mesh.coords), jnp.asarray(mesh.elnodes),
                                       mat.hooke_dmat(jnp.float64(E), jnp.float64(NU)))
    space = sysm.build_solve_space(mesh.coords, mesh.elnodes, fixmask, nd)
    cfg = get_config()
    saved = cfg.smoother
    cfg.smoother = smoother
    try:
        pc = sysm.build_precond(esm, jnp.asarray(mesh.elnodes), jnp.asarray(mesh.coords),
                                fixmask, 32, space=space, n_modes=12)
    finally:
        cfg.smoother = saved
    assert (pc.smooth_inv is not None) == (smoother == "cluster")
    inv = np.asarray(pc.coarse_inv, dtype=np.float64)
    pc = pc._replace(coarse_inv=jnp.asarray(0.5 * (inv + inv.T)))
    pinv, qmat, coarse, fm, smooth = to_torch(
        (pc.pinv, pc.qmat, pc.coarse_inv, pc.fixmask, pc.smooth_inv), "cpu", F64)
    assert torch.equal(coarse, coarse.T)
    tpc = tpre.TwoLevelPrecond(pinv, qmat, kernels.pack_coarse(coarse), fm, smooth)
    return nd, pc, tpc


@pytest.fixture(scope="module", params=["jacobi3", "cluster"])
def box_pc(request):
    return _jax_precond(request.param)


def test_two_level_apply_on_the_packed_copy_matches_jax(box_pc):
    """K4's plain version fed the packed coarse inverse (and
    ``TwoLevelPrecond.apply``, which calls it) against the JAX package's
    ``TwoLevelPrecond.apply`` with the same inverse, to 1e-12; its coarse
    part alone (the apply less the fine level) to 1e-9 of that part's
    largest value, as ``test_torch_fused_cg.py`` holds the dense one."""
    nd, pc, tpc = box_pc
    r = np.random.default_rng(16).normal(size=nd)
    want = pc.apply(jnp.asarray(r))
    z_fine = None if tpc.smooth_inv is None else tpc.fine(t64(r))
    got = kernels.two_level_apply(tpc.pinv, tpc.qmat, tpc.coarse_inv, tpc.fixmask, t64(r),
                                  z_fine)
    assert torch.equal(tpc.apply(t64(r)), got)
    _close(got, want, RTOL)
    fine = tpc.fine(t64(r))
    coarse = np.asarray(want) - fine.numpy()
    assert np.abs(coarse).max() > 0.0
    _close(got - fine, coarse, 1e-9)


@pytest.mark.parametrize("m", [1, 3, 8])
def test_two_level_apply_block_on_the_packed_copy_matches_vmapped_apply(box_pc, m):
    """K4m's plain version fed the packed coarse inverse against the JAX
    package's ``TwoLevelPrecond.apply`` under ``jax.vmap`` over the columns
    with the same inverse, to 1e-12, column by column."""
    nd, pc, tpc = box_pc
    r = np.random.default_rng(40 + m).normal(size=(nd, m))
    want = np.asarray(jax.vmap(pc.apply, in_axes=1, out_axes=1)(jnp.asarray(r)))
    z_fine = None if tpc.smooth_inv is None else tpc.fine(t64(r))
    got = kernels.two_level_apply_block(tpc.pinv, tpc.qmat, tpc.coarse_inv, tpc.fixmask, t64(r),
                                        z_fine)
    assert torch.equal(tpc.apply(t64(r)), got)
    for c in range(m):
        _close(got[:, c], want[:, c], RTOL)


def test_the_card_keeps_the_packed_copy_and_the_cpu_the_dense():
    """``precond.stored_coarse``: a CPU inverse stays dense (the CPU runs
    are unchanged); the packed copy holds the upper triangle, and
    ``TwoLevelPrecond.coarse`` gives the same product from either."""
    a = _spd(140, 3)
    assert tpre.stored_coarse(a) is a
    x = torch.as_tensor(np.random.default_rng(2).normal(size=140))
    dense = tpre.TwoLevelPrecond(None, None, a, None)
    packed = tpre.TwoLevelPrecond(None, None, kernels.pack_coarse(a), None)
    _close(packed.coarse(x), dense.coarse(x), 1e-13)
