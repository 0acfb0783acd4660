"""The port's linear-buckling modules against the JAX package's, CPU
float64: the geometric blocks, the new mesh generators, the multi-column
operators (K0m's plain version on the CPU), the block PCG, the block
preconditioner apply, the pencil subspace iteration and the eigensolve's
retry ladder; and the port alone on the buckling cases of
``tests/test_buckling_gnl.py`` (lines 29, 59, 205, 231, 262, 467, 514, 566).

Where a test compares eigenpairs with the JAX package, both sides start the
subspace iteration from the JAX package's start block
(``jax.random.normal(PRNGKey(0), (ndof, m))``, handed to the port as ``v0``)
and run the block-Jacobi preconditioner (the JAX package's two-level
coarse inverse is float32, the port's float64); the sweeps are then equal
and the factors agree to 1e-8.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from torch_parity import E, NU, F64, port_config, t64, ti

import fcvm_tpu
import fcvm_tpu_torch as ft
from fcvm_tpu.config import get_config
from fcvm_tpu.models import meshgen
from fcvm_tpu.ops import assembly as jasm
from fcvm_tpu.runtime import buckling as jbk
from fcvm_tpu_torch.models import meshgen as tmeshgen
from fcvm_tpu_torch.ops import assembly as tasm
from fcvm_tpu_torch.ops import deflation as tdfl
from fcvm_tpu_torch.ops import precond as tpc
from fcvm_tpu_torch.ops import solver as tslv
from fcvm_tpu_torch.runtime import buckling as tbk
from fcvm_tpu_torch.utils.indexing import pad_ndof, pad_vector

BUCKLE = dict(gnl="GNLY", nstep=1)


def column_model(nx=8, ny=1, nz=1, lc=20.0, p=1000.0):
    """The clamped-free column of ``tests/test_buckling_gnl.py:16-26`` with
    an ny x nz section (unit cells), end traction ``p`` per unit force."""
    mesh = meshgen.box_tet10(nx, ny, nz, lc, float(ny), float(nz))
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, 0.0, 0.0))])
    faces = mesh.faces_on(lambda x, y, z: x > lc - 1e-9)
    loads = fcvm_tpu.Loads(traction_faces=faces,
                           tractions=np.tile([-p / (ny * nz), 0, 0], (len(faces), 1)))
    return fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), bcs, loads)


def _pencil_inputs(mesh, seed=0):
    """Element blocks, a random pre-stress, dofs and a clamped fixmask."""
    rng = np.random.default_rng(seed)
    coords, eln = mesh.coords, mesh.elnodes
    sig = rng.normal(scale=50.0, size=(mesh.n_elements, 4, 6))
    nd = pad_ndof(mesh.ndof)
    fixed = 3 * mesh.select_nodes(lambda x, y, z: x < 1e-9)
    fm = np.ones(mesh.ndof)
    fm[np.concatenate([fixed, fixed + 1, fixed + 2])] = 0.0
    return coords, eln, sig, pad_vector(fm, nd)


MESHES = {
    "box": lambda: meshgen.box_tet10(2, 2, 3, 1.0, 2.0, 3.0),
    "cruciform": lambda: meshgen.cruciform_tet10(4.0, 1.0, 10.0, n_flange=1, n_thick=1, n_z=2),
}


@pytest.mark.parametrize("name", list(MESHES))
def test_geometric_stiffness_blocks_match_jax(name):
    """G's element blocks on a random stress field to 1e-12 of their max."""
    mesh = MESHES[name]()
    coords, eln, sig, _ = _pencil_inputs(mesh)
    ref = np.asarray(jasm.geometric_stiffness_blocks(jnp.asarray(coords), jnp.asarray(eln),
                                                     jnp.asarray(sig)))
    got = tasm.geometric_stiffness_blocks(t64(coords), ti(eln), t64(sig)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    # (dN^T sigma dN) (x) I_3: symmetric, and no coupling between components
    np.testing.assert_allclose(got, got.transpose(0, 2, 1), rtol=0, atol=1e-12 * np.abs(ref).max())
    assert np.all(got.reshape(-1, 10, 3, 10, 3)[:, :, 0, :, 1] == 0.0)


@pytest.mark.parametrize("gen,args", [
    ("cruciform_tet10", (40.0, 4.0, 200.0, 3, 1, 4)),
    ("cruciform_tet10", (5.0, 2.0, 8.0)),
    ("bar_tet10", (20.0, 2.0, 1.0, 8, 2, 1)),
])
def test_meshgen_additions_match_jax(gen, args):
    ref, got = getattr(meshgen, gen)(*args), getattr(tmeshgen, gen)(*args)
    np.testing.assert_array_equal(got.coords, ref.coords)
    np.testing.assert_array_equal(got.elnodes, ref.elnodes)


OPERATORS = {  # fixmask kind, identity on fixed dofs, negate
    "khat": ("clamped", True, False),
    "minus_g": ("clamped", False, True),
    "khat_no_elimination": ("ones", True, False),
    "minus_g_no_elimination": ("ones", False, True),
}


@pytest.mark.parametrize("case", list(OPERATORS))
def test_multi_matvec_matches_jax(case):
    """K_hat·V and -G_hat·V on (ndof, 5) blocks against ``_multi_matvec``."""
    kind, ident, neg = OPERATORS[case]
    mesh = meshgen.box_tet10(3, 2, 2, 6.0, 2.0, 2.0)
    coords, eln, sig, fm = _pencil_inputs(mesh, seed=1)
    if kind == "ones":
        fm = np.ones_like(fm)
    blocks = jasm.geometric_stiffness_blocks(jnp.asarray(coords), jnp.asarray(eln),
                                             jnp.asarray(sig))
    u = np.random.default_rng(2).normal(size=(fm.shape[0], 5))
    eldofs = jasm.element_dof_ids(jnp.asarray(eln))
    ref = np.asarray(jbk._multi_matvec(eldofs, jnp.asarray(fm), ident, negate=neg)(
        blocks, jnp.asarray(u)))
    esm_t = t64(blocks).permute(1, 2, 0).contiguous()
    got = tasm.make_multi_matvec(esm_t, ti(eldofs), t64(fm), ident, neg)(t64(u)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


def test_penalty_operators_match_jax():
    """The penalty pencil's K·V + dvec V, -G·V and its CG ``K^{-1}`` (penalty
    block Jacobi) against the JAX package's ``_penalty_operators``."""
    mesh = meshgen.box_tet10(3, 1, 1, 6.0, 1.0, 1.0)
    coords, eln, sig, fm = _pencil_inputs(mesh, seed=3)
    jc, je = jnp.asarray(coords), jnp.asarray(eln)
    dmat = fcvm_tpu.ops.material.hooke_dmat(jnp.float64(E), jnp.float64(NU))
    esm = jasm.elastic_stiffness_blocks(jc, je, dmat)
    nsm = jasm.geometric_stiffness_blocks(jc, je, jnp.asarray(sig))
    nd = fm.shape[0]
    eldofs = jasm.element_dof_ids(je)
    jk, jg, jinv = jbk._penalty_operators(esm, nsm, eldofs, je, jnp.asarray(fm), nd,
                                          jnp.float64, get_config(), 1e-12, 2000, 100)
    tk, tg, tinv = tbk._penalty_operators(tasm.blocks_of(t64(esm)), tasm.blocks_of(t64(nsm)),
                                          ti(eldofs), ti(eln), t64(fm), nd, "cg", 1e-12, 2000)
    u = np.random.default_rng(4).normal(size=(nd, 3))
    for jop, top in ((jk, tk), (jg, tg), (jinv, tinv)):
        ref = np.asarray(jop(jnp.asarray(u)))
        np.testing.assert_allclose(top(t64(u)).numpy(), ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max())


def _small_khat():
    """K_hat of a clamped 3x3x3 cube in the solve space, its block-Jacobi
    and two-level preconditioners, and a seeded (ndof, 4) right-hand side."""
    model = ft.model_from_arrays(column_model(nx=3, ny=3, nz=3, lc=3.0))
    cfg = port_config(precond="two_level")
    be = ft.runtime.backend.TorchSystem(model, cfg, F64, torch.device("cpu"))
    khat, pinv, *_ = be.assemble_operator(be.tensor(model.mesh.coords))
    sp = be.space
    pc = be.operator_pc(khat, pinv)
    b = sp.fixmask_m[:, None] * torch.as_tensor(
        np.random.default_rng(6).normal(size=(be.ndof_pad, 4)))
    return khat, sp, pinv[sp.nperm], pc, b


@pytest.mark.parametrize("case", ["cold", "warm", "stall"])
def test_pcg_block_matches_pcg(case):
    """Each column of ``pcg_block`` follows ``pcg`` on that column: equal CG
    counts and solutions to 1e-11 of their max, cold, warm-started (from
    the cold block's solutions, columns reversed), and with the stagnation
    exit (rtol 1e-16, below the float64 floor, stall 5).  Two-level
    preconditioner, rtol 1e-8.  The block's column sums and products round
    in another order than the vector's; over ~65 iterations that grows to
    ~4e-12 of the solution, hence 1e-11 and not the rounding unit."""
    khat, sp, _, pc, b = _small_khat()
    kmv = tasm.make_multi_matvec(khat.esm_t, sp.eldofs_m, sp.fixmask_m)
    kw = dict(rtol=1e-16, stall=5, maxiter=2000) if case == "stall" else dict(rtol=1e-8)
    x0 = 0.5 * tslv.pcg_block(kmv, b, pc.apply, rtol=1e-8).x.flip(1) if case == "warm" else None
    res = tslv.pcg_block(kmv, b, precond=pc.apply, x0=x0, **kw)
    iters = []
    for c in range(b.shape[1]):
        ref = tslv.pcg(khat, b[:, c], precond=pc.apply,
                       x0=None if x0 is None else x0[:, c], **kw)
        iters.append(ref.iters)
        np.testing.assert_allclose(res.x[:, c].numpy(), ref.x.numpy(), rtol=0,
                                   atol=1e-11 * float(ref.x.abs().max()))
        if case == "stall":  # both at the float64 floor
            assert max(res.relres[c], ref.relres) < 1e-12
        else:
            assert max(res.relres[c], ref.relres) <= kw["rtol"]
    assert res.iters == iters
    assert len(set(iters)) > 1 or case == "stall"  # the columns finish apart
    if case == "stall":
        assert max(iters) < 2000  # the stagnation exit, not maxiter


@pytest.mark.parametrize("kind", ["two_level", "block_jacobi", "deflated"])
def test_block_precond_apply_matches_columns(kind):
    """The preconditioner applied to an (ndof, 4) block equals the vector
    apply on each column."""
    khat, sp, pinv, pc, b = _small_khat()
    if kind == "block_jacobi":
        apply = functools.partial(tpc.apply_precond, pinv)
    elif kind == "two_level":
        apply = pc.apply
    else:
        w = sp.fixmask_m[:, None] * torch.as_tensor(
            np.random.default_rng(7).normal(size=(b.shape[0], 6)))
        defl = tdfl.DeflationSpace(w, tdfl.pinv_psd(tdfl.galerkin(
            khat.esm_t, sp.eldofs_m, sp.fixmask_m, w)))
        apply = tdfl.deflated(pc.apply, defl)
    got = apply(b)
    for c in range(b.shape[1]):
        ref = apply(b[:, c].contiguous())
        np.testing.assert_allclose(got[:, c].numpy(), ref.numpy(), rtol=0,
                                   atol=1e-13 * float(ref.abs().max()))


def _dense_pencil():
    """The 24-dof dense pencil of ``tests/test_buckling_gnl.py:480-491``."""
    rng = np.random.default_rng(0)
    n = 24
    a = rng.normal(size=(n, n))
    return a @ a.T + n * np.eye(n), np.diag(rng.uniform(1.0, 5.0, size=n))


def test_pencil_subspace_matches_jax():
    """On the dense pencil with exact inner solves, from the JAX start
    block: the same sweeps, factors to 1e-10, vectors to 1e-8 of their max."""
    kmat, g = _dense_pencil()
    n, k, m = 24, 2, 4
    sweeps = {"jax": 0, "port": 0}

    def kinv(side, lib):
        def f(w, x0_basis=None, x0_scale=None):
            sweeps[side] += 1
            return lib.asarray(np.linalg.solve(kmat, np.asarray(w)))
        return f

    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n, m), dtype=jnp.float64))
    lam_j, vec_j = jbk.pencil_subspace(
        lambda w: jnp.asarray(kmat) @ w, lambda w: jnp.asarray(g) @ w, kinv("jax", jnp),
        n, jnp.float64, k, m)
    lam_t, vec_t = tbk.pencil_subspace(
        lambda w: t64(kmat) @ w, lambda w: t64(g) @ w, kinv("port", torch), n, F64, k, m,
        v0=v0)
    assert sweeps["port"] == sweeps["jax"] > 2
    np.testing.assert_allclose(lam_t, lam_j, rtol=1e-10)
    np.testing.assert_allclose(vec_t, vec_j, rtol=0, atol=1e-8 * np.abs(vec_j).max())


def test_pencil_residual_validation_catches_wrong_factors():
    """``tests/test_buckling_gnl.py:467-511``: exact inner solves give the
    pencil's eigenpairs; a ``K^{-1}`` that returns its rhs unsolved
    converges onto non-eigenpairs, which raise while a retry tier exists
    and warn on the last one."""
    kmat, g = _dense_pencil()
    n, k, m = 24, 2, 4

    def ops(dtype):
        kmv = lambda w: torch.as_tensor(kmat, dtype=dtype) @ w  # noqa: E731
        mg = lambda w: torch.as_tensor(g, dtype=dtype) @ w  # noqa: E731
        return kmv, mg

    exact = lambda w, x0_basis=None, x0_scale=None: torch.as_tensor(  # noqa: E731
        np.linalg.solve(kmat, w.double().numpy()), dtype=w.dtype)
    broken = lambda w, x0_basis=None, x0_scale=None: w  # noqa: E731
    lam, _ = tbk.pencil_subspace(*ops(torch.float32), exact, n, torch.float32, k, m)
    ref = np.sort(np.abs(np.linalg.eigvals(np.linalg.solve(g, kmat))))[:k]
    np.testing.assert_allclose(np.sort(lam), ref, rtol=1e-4)
    for dtype in (torch.float32, F64):
        with pytest.raises(tbk.EigensolveBreakdownError, match="pencil residual"):
            tbk.pencil_subspace(*ops(dtype), broken, n, dtype, k, m)
    with pytest.warns(UserWarning, match="pencil residual"):
        tbk.pencil_subspace(*ops(F64), broken, n, F64, k, m, last_tier=True)


@pytest.fixture
def jax_bj(monkeypatch):
    """The JAX package's config at float64 with the block-Jacobi
    preconditioner; returns a counter of its eigensolve sweeps."""
    cfg = get_config()
    monkeypatch.setattr(cfg, "precond", "block_jacobi")
    sweeps = []
    inner = jbk.pencil_subspace

    def counted(kmv, minus_g, k_inverse, *a, **kw):
        sweeps.append(0)

        def kinv(*b, **c):
            sweeps[-1] += 1
            return k_inverse(*b, **c)

        return inner(kmv, minus_g, kinv, *a, **kw)

    monkeypatch.setattr(jbk, "pencil_subspace", counted)
    return sweeps


def jax_start(ndof, m=8):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (ndof, m), dtype=jnp.float64))


def test_linear_buckling_matches_jax(jax_bj, monkeypatch):
    """A 2x1-section column (distinct bending modes), deflation on, both
    sides from the JAX start block: equal sweeps, factors to 1e-8, modes to
    1e-6 of their max; the port's own seeded start gives the factors to
    1e-6.  The pre-stress solves run to 1e-10 on both sides: at the default
    1e-6 the two CG paths' pre-stresses differ by ~1e-8."""
    monkeypatch.setattr(get_config(), "cg_rtol", 1e-10)
    model = column_model(nx=4, ny=2, nz=1, lc=20.0)
    lam_j, vec_j = fcvm_tpu.linear_buckling(model, fcvm_tpu.ControlParams(**BUCKLE))
    stats = []
    seeded = functools.partial(tbk.buckling_from_arrays, v0=jax_start(pad_ndof(model.mesh.ndof)),
                               stats=stats)
    monkeypatch.setattr(tbk, "buckling_from_arrays", seeded)
    cfg = ft.FcvmConfig(device="cpu", dtype="float64", precond="block_jacobi", cg_rtol=1e-10)
    tmodel = ft.model_from_arrays(model)
    lam_t, vec_t = ft.linear_buckling(tmodel, ft.ControlParams(**BUCKLE), config=cfg)
    assert [r["sweeps"] for r in stats] == jax_bj and stats[0]["harvest"]["kept"] > 0
    np.testing.assert_allclose(lam_t, lam_j, rtol=1e-8)
    np.testing.assert_allclose(vec_t, vec_j, rtol=0, atol=1e-6 * np.abs(vec_j).max())
    assert lam_j[1] > 1.5 * lam_j[0]  # two distinct modes
    monkeypatch.undo()
    lam_s, _ = ft.linear_buckling(tmodel, ft.ControlParams(**BUCKLE), config=cfg)
    np.testing.assert_allclose(lam_s, lam_j, rtol=1e-6)


@pytest.mark.parametrize("section", ["2x1", "2x2"])
def test_linear_buckling_with_the_cards_block_schedule_matches_jax(jax_bj, monkeypatch,
                                                                    section):
    """The eigensolve with ``pcg_block`` reading its states once per
    ``CG_BATCH`` iterations and dropping done columns only then, the
    schedule it runs on the card (on the CPU it drops a column the
    iteration it is done), against the JAX package as
    :func:`test_linear_buckling_matches_jax`: equal sweeps, factors to 1e-8;
    the 2x1 section's distinct modes to 1e-6 of their max; the square
    section's pair of equal factors spanning the JAX pair's plane (a
    block's width moves its columns' rounding, and so how the pair
    splits)."""
    monkeypatch.setattr(get_config(), "cg_rtol", 1e-10)
    model = column_model(nx=4, ny=2, nz=1 if section == "2x1" else 2, lc=20.0)
    lam_j, vec_j = fcvm_tpu.linear_buckling(model, fcvm_tpu.ControlParams(**BUCKLE))
    stats = []
    seeded = functools.partial(tbk.buckling_from_arrays, v0=jax_start(pad_ndof(model.mesh.ndof)),
                               stats=stats)
    monkeypatch.setattr(tbk, "buckling_from_arrays", seeded)

    def card_schedule(matvec, b, precond=None, x0=None, rtol=1e-6, atol=0.0, maxiter=1000,
                      stall=0, defl=None):
        return tslv._pcg_block(matvec, b, precond, x0, rtol, atol, maxiter, stall,
                               tslv.CG_BATCH, defl)

    monkeypatch.setattr(tslv, "pcg_block", card_schedule)
    tslv.CG_STATS.clear()
    cfg = ft.FcvmConfig(device="cpu", dtype="float64", precond="block_jacobi", cg_rtol=1e-10)
    lam_t, vec_t = ft.linear_buckling(ft.model_from_arrays(model), ft.ControlParams(**BUCKLE),
                                      config=cfg)
    assert tslv.CG_STATS["reads"] < tslv.CG_STATS["queued"] / 2  # a read a batch, not an iteration
    assert [r["sweeps"] for r in stats] == jax_bj
    np.testing.assert_allclose(lam_t, lam_j, rtol=1e-8)
    if section == "2x1":
        np.testing.assert_allclose(vec_t, vec_j, rtol=0, atol=1e-6 * np.abs(vec_j).max())
    else:
        coef, *_ = np.linalg.lstsq(vec_j, vec_t, rcond=None)
        assert np.linalg.norm(vec_t - vec_j @ coef) < 1e-6 * np.linalg.norm(vec_t)


def test_euler_column_buckling():
    """``tests/test_buckling_gnl.py:29-40`` on the port (default two-level
    configuration, float64), and against the JAX package: the
    near-degenerate pair of the square column spans the same plane
    (principal angles), its factors agree to 1e-6."""
    lc, w, p = 20.0, 1.0, 1000.0
    model = column_model()
    lam, vecs = ft.linear_buckling(ft.model_from_arrays(model), ft.ControlParams(**BUCKLE),
                                   config=ft.FcvmConfig(device="cpu", dtype="float64"))
    p_cr = np.pi**2 * E * (w**4 / 12) / (4 * lc**2)
    np.testing.assert_allclose(lam, p_cr / p, rtol=0.03)
    assert abs(lam[0] - lam[1]) / lam[0] < 0.02
    v = vecs.reshape(-1, 3, 2)
    assert np.abs(v[:, 0, :]).max() < 0.2 * np.abs(v).max()  # mostly lateral
    lam_j, vec_j = fcvm_tpu.linear_buckling(model, fcvm_tpu.ControlParams(**BUCKLE))
    np.testing.assert_allclose(lam, lam_j, rtol=1e-6)
    assert np.max(scipy.linalg.subspace_angles(vecs, np.asarray(vec_j))) < 1e-4


def _port_buckling(model, **cfg_kw):
    kw = {"device": "cpu", "dtype": "float64", **cfg_kw}
    return ft.linear_buckling(ft.model_from_arrays(model), ft.ControlParams(**BUCKLE),
                              config=ft.FcvmConfig(**kw))


def test_penalty_bc_cg_tier_matches_direct():
    """``tests/test_buckling_gnl.py:59-81``: the penalty pencil gives the
    same factors from the PCG tier as from the direct tier, and its modes
    nearly vanish on the clamped face."""
    model = column_model(nx=6)
    lam_direct, _ = _port_buckling(model, buckling_bc="penalty", solver="scipy")
    lam_cg, vecs_cg = _port_buckling(model, buckling_bc="penalty")
    np.testing.assert_allclose(lam_cg, lam_direct, rtol=1e-7)
    v = np.abs(vecs_cg).reshape(-1, 3, 2)
    clamped = model.mesh.select_nodes(lambda x, y, z: x < 1e-9)
    assert v[clamped].max() < 2e-2 * v.max()


def test_buckling_deflation_matches_undeflated():
    """``tests/test_buckling_gnl.py:205-228``: the eigensolve's Ritz
    recycling changes the CG path, not the eigenpairs."""
    model = column_model(nx=12)
    lam_off, v_off = _port_buckling(model, deflation=False)
    lam_on, v_on = _port_buckling(model, deflation=True)
    np.testing.assert_allclose(lam_on, lam_off, rtol=1e-8)
    np.testing.assert_allclose(v_on, v_off, atol=1e-6 * np.abs(v_off).max())


def test_eigensolve_hands_its_deflation_to_pcg_block(monkeypatch):
    """``linear_buckling``'s inner solves pass the eigensolve's Ritz space
    to ``pcg_block`` (``defl=``, folded into K6's passes) and wrap no
    preconditioner in ``deflation.deflated``; on the CPU the factors and
    modes are bit for bit those of the wrapped preconditioner, the way the
    solves ran before the fold."""
    model = column_model(nx=12)
    calls, wraps = [], []
    pcg_block, deflated = tslv.pcg_block, tdfl.deflated

    def recorded(*args, defl=None, **kw):
        calls.append(defl)
        return pcg_block(*args, defl=defl, **kw)

    def wrap(precond, defl):
        if defl is not None:
            wraps.append(defl)
        return deflated(precond, defl)

    monkeypatch.setattr(tslv, "pcg_block", recorded)
    monkeypatch.setattr(tdfl, "deflated", wrap)
    lam, vecs = _port_buckling(model, deflation=True)
    assert any(d is not None for d in calls)
    assert not wraps

    def wrapped(matvec, b, precond=None, defl=None, **kw):  # the preconditioner wrapped instead
        return pcg_block(matvec, b, precond=deflated(precond, defl), **kw)

    monkeypatch.setattr(tslv, "pcg_block", wrapped)
    lam_w, vecs_w = _port_buckling(model, deflation=True)
    assert np.array_equal(lam, lam_w) and np.array_equal(vecs, vecs_w)


def test_cg_eigensolve_matches_direct_tier():
    """``tests/test_buckling_gnl.py:231-259``: the PCG tier against the
    scipy direct tier, factors to 1e-6 and the same mode plane."""
    model = column_model(nx=10)
    lam_cg, v_cg = _port_buckling(model, solver="cg")
    lam_sp, v_sp = _port_buckling(model, solver="scipy")
    np.testing.assert_allclose(lam_cg, lam_sp, rtol=1e-6)
    coef, *_ = np.linalg.lstsq(v_sp, v_cg, rcond=None)
    assert np.linalg.norm(v_cg - v_sp @ coef) < 1e-4 * np.linalg.norm(v_cg)


def test_cruciform_torsional_buckling():
    """``tests/test_buckling_gnl.py:262-313``: torsional buckling of a
    cruciform column on the scipy tier, within 10% of St Venant's
    ``G J / I_p``, the second mode below flexure, the first a twist."""
    b, t, lc, p = 40.0, 4.0, 200.0, 100.0
    mesh = tmeshgen.cruciform_tet10(b, t, lc, n_flange=4, n_thick=1, n_z=12)
    g = E / (2.0 * (1.0 + NU))
    w = 2 * b + t
    area = 2 * w * t - t * t
    ip = 2 * (t * w**3 / 12 + w * t**3 / 12) - t**4 / 6
    jt = (2 * w * t**3 - t**4) / 3.0
    sig_tor = g * jt / ip
    sig_euler = np.pi**2 * E * (t * w**3 / 12 + (w - t) * t**3 / 12) / (4 * lc**2 * area)
    bcs = ft.BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: z < 1e-9), (0.0, 0.0, 0.0))])
    top = mesh.faces_on(lambda x, y, z: z > lc - 1e-9)
    model = ft.Model(mesh, ft.Material(E, NU), bcs,
                     ft.Loads(traction_faces=top, tractions=np.tile([0, 0, -p], (len(top), 1))))
    lam, vecs = ft.linear_buckling(model, ft.ControlParams(**BUCKLE),
                                   config=ft.FcvmConfig(device="cpu", dtype="float64",
                                                        solver="scipy"))
    np.testing.assert_allclose(lam[0], sig_tor / p, rtol=0.10)
    assert lam[0] < lam[1] < sig_euler / p
    v = vecs[:, 0].reshape(-1, 3)
    tang = np.stack([-mesh.coords[:, 1], mesh.coords[:, 0]], axis=1)
    cos = abs((v[:, :2] * tang).sum() / np.sqrt((v[:, :2] ** 2).sum() * (tang**2).sum()))
    assert cos > 0.6


def test_f32_eigensolve_breakdown_fails_over_to_f64(monkeypatch):
    """``tests/test_buckling_gnl.py:514-563``: ``linear_buckling`` reruns
    the pipeline in float64 on an f32 breakdown, on the direct tier for a
    host-factorisable mesh, and leaves the caller's config as it was."""
    seen = []

    def fake_impl(model, params, k, cfg):
        seen.append((str(cfg.resolve_dtype()), cfg.solver))
        if len(seen) == 1:
            raise tbk.EigensolveBreakdownError("forced breakdown")
        return np.array([1.5, 2.5]), np.zeros((12, 2))

    monkeypatch.setattr(tbk, "_linear_buckling_impl", fake_impl)

    class _Model:
        class mesh:
            ndof = 12

    cfg = ft.FcvmConfig(device="cpu", dtype="float32")
    with pytest.warns(UserWarning, match="retrying the pipeline in float64"):
        lam, _ = tbk.linear_buckling(_Model(), object(), config=cfg)
    np.testing.assert_allclose(lam, [1.5, 2.5])
    assert seen == [("torch.float32", "cg"), ("torch.float64", "scipy")]
    assert cfg.dtype == "float32" and cfg.solver == "cg"
    # above the direct-tier bound the float64 rerun keeps the PCG tier
    seen.clear()
    monkeypatch.setattr(_Model.mesh, "ndof", tbk._DIRECT_FAILOVER_MAX_DOF + 1)
    with pytest.warns(UserWarning, match="in float64$"):
        tbk.linear_buckling(_Model(), object(), config=cfg)
    assert seen == [("torch.float32", "cg"), ("torch.float64", "cg")]


def test_reassembly_ladder_reaches_direct_tier(monkeypatch):
    """``tests/test_buckling_gnl.py:566-630``: ``buckling_from_arrays``
    walks float32 -> float64 iteration -> the float64 direct tier, the two
    float64 tiers on operands assembled in float64; with
    ``allow_reassembly=False`` the float64-iteration failure propagates.
    ``stats`` records each tier tried."""
    mesh = meshgen.box_tet10(2, 1, 1, 20.0, 1.0, 1.0)
    f32 = torch.float32
    coords = torch.as_tensor(mesh.coords, dtype=f32)
    elnodes = ti(mesh.elnodes)
    dmat = ft.ops.material.hooke_dmat(E, NU, f32, "cpu")
    sig = torch.zeros((mesh.n_elements, 4, 6), dtype=f32)
    fixmask = torch.ones(mesh.ndof, dtype=f32)
    calls = []

    def fake_pencil(kmv, minus_g, k_inverse, ndof, dtype, k, m, outer_tol=1.0e-9,
                    max_outer=60, fixmask=None, last_tier=False, v0=None, device=None,
                    record=None):
        calls.append((str(dtype), last_tier))
        if not last_tier:
            raise tbk.EigensolveBreakdownError("forced: non-eigenpair")
        return np.array([0.43, 0.44])[:k], np.zeros((ndof, k))

    monkeypatch.setattr(tbk, "pencil_subspace", fake_pencil)
    built = []  # the dtype each tier assembles E and G in (K3's entry, one call a form)

    def record(form, coords, *a, _inner=tasm.operator_blocks, **kw):
        built.append(str(coords.dtype))
        return _inner(form, coords, *a, **kw)

    monkeypatch.setattr(tasm, "operator_blocks", record)
    stats = []
    with pytest.warns(UserWarning, match="re-assembling the pencil"):
        lam, _ = tbk.buckling_from_arrays(coords, elnodes, dmat, sig, fixmask, k=2,
                                          stats=stats)
    np.testing.assert_allclose(lam, [0.43, 0.44])
    assert calls == [("torch.float32", False), ("torch.float64", False),
                     ("torch.float64", True)]
    # the float64 tiers assemble the pencil in float64 from the float32
    # inputs (the JAX package's tier 2 iterates on the upcast float32 blocks)
    assert built == ["torch.float32"] * 2 + ["torch.float64"] * 4
    assert [(r["dtype"], r["solver"], r["error"] is not None) for r in stats] == [
        ("float32", "cg", True), ("float64", "cg", True), ("float64", "scipy", False)]
    calls.clear()
    with pytest.raises(tbk.EigensolveBreakdownError):
        with pytest.warns(UserWarning, match="retrying the iteration"):
            tbk.buckling_from_arrays(coords, elnodes, dmat, sig, fixmask, k=2,
                                     allow_reassembly=False)
    assert calls == [("torch.float32", False), ("torch.float64", False)]


def test_float64_tier_is_an_all_float64_run(monkeypatch):
    """The port's second tier departs from the JAX package's on purpose: it
    re-assembles the pencil in float64 from the float32 inputs, where the
    JAX package iterates on the upcast float32 blocks.  Forced past a
    float32 breakdown, it gives what ``buckling_from_arrays`` gives on the
    same inputs upcast to float64 from the start (the all-float64 path held
    against the JAX package above): equal sweeps, the factors to 1e-12 and
    the modes to 1e-10 of their max."""
    mesh = meshgen.box_tet10(4, 2, 1, 20.0, 2.0, 1.0)
    coords, eln, _, fm = _pencil_inputs(mesh)
    sig = np.zeros((mesh.n_elements, 4, 6))
    sig[..., 0] = -500.0  # uniform axial compression
    f32 = torch.float32
    inputs = (torch.as_tensor(coords, dtype=f32), ti(eln),
              ft.ops.material.hooke_dmat(E, NU, f32, "cpu"), torch.as_tensor(sig, dtype=f32),
              torch.as_tensor(fm, dtype=f32))
    real = tbk.pencil_subspace

    def float32_breaks_down(*a, **kw):
        if a[4] == f32:  # the working dtype
            raise tbk.EigensolveBreakdownError("forced")
        return real(*a, **kw)

    monkeypatch.setattr(tbk, "pencil_subspace", float32_breaks_down)
    tiers, direct = [], []
    with pytest.warns(UserWarning, match="retrying the iteration in float64"):
        lam, vecs = tbk.buckling_from_arrays(*inputs, k=2, stats=tiers)
    lam64, vecs64 = tbk.buckling_from_arrays(*(t if t.dtype == ti(eln).dtype else t.to(F64)
                                               for t in inputs), k=2, stats=direct)
    assert [(r["dtype"], r["error"] is None) for r in tiers] == [("float32", False),
                                                                ("float64", True)]
    assert tiers[1]["sweeps"] == direct[0]["sweeps"] > 2
    np.testing.assert_allclose(lam, lam64, rtol=1e-12)
    np.testing.assert_allclose(vecs, vecs64, rtol=0, atol=1e-10 * np.abs(vecs64).max())
