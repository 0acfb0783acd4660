"""Parity of the port's geometric-nonlinearity modules (``gnl="GNLY"``) with
the JAX package's, CPU float64: the convected stress update, the deformed
internal force, the tangent blocks, the follower loads, the block-Jacobi
refresh, the tangent refresh with its predictor solve, and the Crisfield
arc-length update.  Each holds to ``RTOL`` of the largest entry unless a
test says otherwise.

Where a test demands equal CG iteration counts, the port is fed the JAX
package's preconditioner state (``to_torch``): the JAX package inverts its
coarse matrix in float32, the port in the working dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import E, F64, L, NU, port_config, symmetry_bcs, t64, ti, tension_model

import fcvm_tpu
from fcvm_tpu.config import get_config
from fcvm_tpu.models import meshgen
from fcvm_tpu.ops import assembly as asm
from fcvm_tpu.ops import deflation as jdfl
from fcvm_tpu.ops import material as mat
from fcvm_tpu.ops import precond as pre
from fcvm_tpu.ops.stress_update import internal_force_from_stress
from fcvm_tpu.runtime import system as sysm
from fcvm_tpu.runtime.backend import LocalSystem
from fcvm_tpu_torch.models.spec import model_from_arrays, to_torch
from fcvm_tpu_torch.ops import assembly as tasm
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import material as tmat
from fcvm_tpu_torch.ops import precond as tpre
from fcvm_tpu_torch.ops import stress_update as tsu
from fcvm_tpu_torch.runtime import system as tsys
from fcvm_tpu_torch.runtime.backend import TorchSystem
from fcvm_tpu_torch.utils.indexing import pad_ndof

RTOL = 1e-10


def _close(a, b, rtol=RTOL):
    """``a`` (tensor) equals ``b`` (array) to ``rtol`` of ``b``'s largest entry."""
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


def _close_blocks(a, b, rtol=RTOL):
    """Nodal 3x3 blocks, each to ``rtol`` of its own largest entry (the
    identity blocks of fixed nodes dwarf the stiffness inverses)."""
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(b).max(axis=(-2, -1), keepdims=True)
    assert (np.abs(a - b) <= rtol * scale).all(), np.max(np.abs(a - b) / scale)


def _gauss_state(ne, seed):
    """Seeded start-of-step stresses (ne, 4, 6) and plastic flags, some set."""
    rng = np.random.default_rng(seed)
    sig = rng.normal(scale=60.0, size=(ne, 4, 6))
    sig[0, 0] = 0.0  # a zero deviator on a plastic point: svm == 0 is guarded
    pgp = rng.random((ne, 4)) < 0.4
    pgp[0, 0] = True
    return sig, pgp


def _pressure_gravity_model(n=2):
    """The tension box with a pressure on the x = L face and gravity."""
    mesh = meshgen.box_tet10(n, n, n, L, L, L)
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    top = mesh.faces_on(lambda x, y, z: z > L - 1e-9)
    loads = fcvm_tpu.Loads(pressure_faces=faces, pressures=np.full(len(faces), -80.0),
                           traction_faces=top, tractions=np.tile([0.0, 5.0, 0.0], (len(top), 1)),
                           gravity=np.array([0.0, -9810.0, 2000.0]))
    return fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU, 7.85e-6), symmetry_bcs(mesh), loads)


@pytest.fixture(scope="module")
def deformed():
    """A 2x2x2 tension box with a seeded total displacement and increment
    large enough that geometry matters, on both sides."""
    model = tension_model()
    mesh = model.mesh
    nd = pad_ndof(mesh.ndof)
    rng = np.random.default_rng(11)
    disp = np.zeros(nd)
    disp[: mesh.ndof] = rng.normal(scale=0.05, size=mesh.ndof)
    du = np.zeros(nd)
    du[: mesh.ndof] = rng.normal(scale=4e-3, size=mesh.ndof)
    return dict(model=model, coords=mesh.coords, eln=mesh.elnodes, nd=nd, disp=disp, du=du,
                dmat=mat.hooke_dmat(jnp.float64(E), jnp.float64(NU)))


def test_gnl_internal_force_matches_jax(deformed):
    """The reaction of a given stress on the deformed geometry; a float64
    displacement over float32 coordinates is cast to float32 first."""
    d = deformed
    sig, _ = _gauss_state(len(d["eln"]), 1)
    ref = internal_force_from_stress(jnp.asarray(d["coords"]), jnp.asarray(d["eln"]),
                                     jnp.asarray(sig), jnp.asarray(d["disp"]), True)
    out = tsu.internal_force_from_stress(t64(d["coords"]), ti(d["eln"]), t64(sig),
                                         t64(d["disp"]), large_disp=True)
    _close(out, ref)
    small = tsu.internal_force_from_stress(t64(d["coords"]), ti(d["eln"]), t64(sig),
                                           t64(d["disp"]))
    assert float((small - out).abs().max()) > 1e-3 * float(out.abs().max())
    f32 = torch.float32
    mixed = tsu.internal_force_from_stress(t64(d["coords"]).to(f32), ti(d["eln"]),
                                           t64(sig).to(f32), t64(d["disp"]), large_disp=True)
    assert mixed.dtype == f32
    same = tsu.internal_force_from_stress(t64(d["coords"]).to(f32), ti(d["eln"]),
                                          t64(sig).to(f32), t64(d["disp"]).to(f32),
                                          large_disp=True)
    assert torch.equal(mixed, same)


def test_gnl_stress_convection_rigid_rotation():
    """A rigid rotation increment convects the stress as R sigma R^T
    (``tests/test_buckling_gnl.py:96-129``), up to the O(E phi^2) spurious
    strain the reference's linearised ``deps`` carries."""
    mesh = meshgen.box_tet10(1, 1, 1, 1.0, 1.0, 1.0)
    ne = mesh.n_elements
    sig0 = np.tile([100.0, -40.0, 10.0, 5.0, -2.0, 7.0], (ne, 4, 1))
    phi = 1e-4
    c, s = np.cos(phi), np.sin(phi)
    r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    du = (mesh.coords @ r.T - mesh.coords).reshape(-1)
    sig_new, *_ = tsu.update_stress_load(
        t64(mesh.coords), ti(mesh.elnodes),
        t64(mat.hooke_dmat(jnp.float64(E), jnp.float64(NU))),
        torch.full((ne, 4), 1e30, dtype=F64), torch.zeros(mesh.ndof, dtype=F64), t64(du),
        t64(sig0), E, NU, 0.0, large_disp=True)
    t = tmat.voigt_to_tensor(t64(sig0[0, 0])).numpy()
    rt = r @ t @ r.T
    expect = np.array([rt[0, 0], rt[1, 1], rt[2, 2], rt[0, 1], rt[0, 2], rt[1, 2]])
    got = sig_new.numpy().reshape(-1, 6)
    np.testing.assert_allclose(got, np.tile(expect, (got.shape[0], 1)), atol=5e-3)
    assert np.abs(got - sig0.reshape(-1, 6)).max() > 1e-3  # the rotation shows


def test_tangent_blocks_match_jax(deformed):
    """Tangent blocks on deformed coordinates with some plastic points
    (``tests/test_assembly_solver.py:217-243``); with no point plastic they
    are the elastic blocks of the deformed geometry."""
    d = deformed
    ne = len(d["eln"])
    sig, pgp = _gauss_state(ne, 2)
    coords_def = d["coords"] + d["disp"][: d["model"].mesh.ndof].reshape(-1, 3)
    g, h = E / (2.0 * (1.0 + NU)), float(mat.hardening_modulus(E, 0.1))
    ref = asm.tangent_stiffness_blocks(jnp.asarray(coords_def), jnp.asarray(d["eln"]), d["dmat"],
                                       jnp.asarray(sig), jnp.asarray(pgp), jnp.asarray(g),
                                       jnp.asarray(h))
    out = tasm.tangent_stiffness_blocks(t64(coords_def), ti(d["eln"]), t64(d["dmat"]),
                                        t64(sig), torch.as_tensor(pgp), g, h)
    _close(out, ref)
    elastic = tasm.elastic_stiffness_blocks(t64(coords_def), ti(d["eln"]), t64(d["dmat"]))
    none = torch.zeros((ne, 4), dtype=torch.bool)
    assert torch.allclose(tasm.tangent_stiffness_blocks(
        t64(coords_def), ti(d["eln"]), t64(d["dmat"]), t64(sig), none, g, h), elastic,
        rtol=0, atol=1e-12 * float(elastic.abs().max()))
    assert float((out - elastic).abs().max()) > 1e-3 * float(elastic.abs().max())
    # any element order: the blocks of permuted rows are the permuted blocks
    perm = torch.as_tensor(np.random.default_rng(3).permutation(ne))
    permuted = tasm.tangent_stiffness_blocks(t64(coords_def), ti(d["eln"])[perm],
                                             t64(d["dmat"]), t64(sig)[perm],
                                             torch.as_tensor(pgp)[perm], g, h)
    assert torch.equal(permuted, out[perm])


@pytest.mark.parametrize("follower", [True, False])
def test_external_loads_match_jax(deformed, follower):
    """Pressure and gravity follow the deformed geometry, uniform face
    tractions stay on the original one."""
    d = deformed
    model = _pressure_gravity_model()
    tables = sysm.LoadTables.from_spec(model.loads, jnp.float64)
    ttables = tsys.LoadTables.from_spec(model_from_arrays(model).loads, F64, "cpu", d["nd"])
    ref = sysm.external_loads(jnp.asarray(d["coords"]), jnp.asarray(d["disp"]),
                              jnp.asarray(d["eln"]), tables, jnp.float64(7.85e-6), follower)
    plan = kernels.segment_plan(ti(d["eln"]))
    out = tsys.external_loads(t64(d["coords"]), t64(d["disp"]), ti(d["eln"]), ttables,
                              7.85e-6, follower, plan)
    for a, b in zip(out, ref):
        _close(a, b)
    original = tsys.external_loads(t64(d["coords"]), torch.zeros(d["nd"], dtype=F64),
                                   ti(d["eln"]), ttables, 7.85e-6, follower, plan)[0]
    moved = float((out[0] - original).abs().max()) > 1e-3 * float(original.abs().max())
    assert moved == follower


@pytest.fixture(scope="module")
def refresh_case():
    """A plastic mid-step state of the tension box with pressure and
    gravity: both backends, the JAX package's two-level preconditioner, and a
    load-space basis from a JAX harvest of the elastic solve."""
    model = _pressure_gravity_model()
    mesh = model.mesh
    be = LocalSystem(model, get_config(), jnp.float64)
    esm, pinv, _, rhs, *_ = be.assemble(mesh.coords)
    pc = be.make_pc(esm, pinv, jnp.asarray(mesh.coords, jnp.float64))
    res, h = be.solve_harvest(esm, pc, rhs, nstore=32)
    coef = jdfl.ritz_coefficients(h.alphas, h.betas, h.rzs, int(res.iters), 8)
    w = jdfl.build_w(h.zs, jnp.asarray(coef), be.space.fixmask_m)
    tbe = TorchSystem(model_from_arrays(model), port_config(), F64, torch.device("cpu"))
    sig, pgp = _gauss_state(mesh.n_elements, 4)
    rng = np.random.default_rng(5)
    disp = np.zeros(be.ndof_pad)
    disp[: mesh.ndof] = 0.02 * rng.normal(size=mesh.ndof) * np.asarray(be.fixmask)[: mesh.ndof]
    return dict(be=be, tbe=tbe, pc=pc, w=w, sig=sig, pgp=pgp, disp=disp, ue=np.asarray(res.x),
                coords=mesh.coords)


def _jax_refresh(c, **kw):
    return c["be"].tangent_refresh(jnp.asarray(c["coords"]), jnp.asarray(c["sig"]),
                                   jnp.asarray(c["pgp"]), jnp.asarray(c["disp"]),
                                   jnp.zeros_like(jnp.asarray(c["disp"])), c["pc"], 0.1, **kw)


def _port_refresh(c, **kw):
    tpc = tpre.TwoLevelPrecond(*to_torch((c["pc"].pinv, c["pc"].qmat, c["pc"].coarse_inv,
                                          c["pc"].fixmask), "cpu", F64))
    return c["tbe"].tangent_refresh(t64(c["coords"]), t64(c["sig"]), torch.as_tensor(c["pgp"]),
                                    t64(c["disp"]), tpc, 0.1, **kw)


def test_refresh_blocks_match_jax(refresh_case):
    """The refreshed nodal blocks, Morton-ordered tangent blocks in, for
    both preconditioner tiers; the coarse correction is kept."""
    c = refresh_case
    be, tbe = c["be"], c["tbe"]
    coords_def = jnp.asarray(c["coords"]) + jnp.asarray(c["disp"]).reshape(-1, 3)[: len(c["coords"])]
    esm = asm.tangent_stiffness_blocks(coords_def, be.elnodes, be.dmat, jnp.asarray(c["sig"]),
                                       jnp.asarray(c["pgp"]), be.g, 1000.0)
    esm_m = esm[be.space.eperm]
    sp, tsp = be.space, tbe.space
    ref = pre.refresh_blocks(c["pc"], esm_m, sp.elnodes_m, sp.fixmask_m)
    tpc = tpre.TwoLevelPrecond(*to_torch((c["pc"].pinv, c["pc"].qmat, c["pc"].coarse_inv,
                                          c["pc"].fixmask), "cpu", F64))
    out = tpre.refresh_blocks(tpc, t64(esm_m), tsp.elnodes_m, tsp.fixmask_m)
    _close_blocks(out.pinv, ref.pinv)
    assert out.coarse_inv is tpc.coarse_inv and out.qmat is tpc.qmat
    assert not torch.allclose(out.pinv, tpc.pinv, rtol=1e-3, atol=0.0)
    bj = tpre.refresh_blocks(tpc.pinv, t64(esm_m), tsp.elnodes_m, tsp.fixmask_m)
    assert torch.equal(bj, out.pinv)


@pytest.mark.parametrize("with_w", [False, True], ids=["plain", "load_space"])
def test_tangent_refresh_matches_jax(refresh_case, with_w):
    """Predictor solution, CG count, follower loads and refreshed blocks,
    warm-started from the elastic solution, with and without a load-space
    basis; and the right-hand side a harvest would solve."""
    c = refresh_case
    w = c["w"] if with_w else None
    _, pc_j, glv_j, ue_j, it_j = _jax_refresh(c, ue0=jnp.asarray(c["ue"]), w=w)
    khat, pc_t, glv_t, ue_t, it_t = _port_refresh(c, ue0=t64(c["ue"]),
                                                  w=None if w is None else t64(w))
    assert it_t == int(it_j) > 3
    _close(ue_t, ue_j, 1e-9)
    _close(glv_t, glv_j)
    _close_blocks(pc_t.pinv, pc_j.pinv)
    assert isinstance(khat, tsys.Operator)
    _, _, _, rhs_j, _ = _jax_refresh(c, solve_predictor=False)
    _, _, _, rhs_t, it0 = _port_refresh(c, solve_predictor=False)
    assert it0 == 0
    _close(rhs_t, rhs_j)
    # the predictor solves the operator's system
    sp = c["tbe"].space
    resid = khat(sp.to_m(ue_t)) - sp.to_m(rhs_t)
    assert float(resid.norm()) <= 1e-5 * float(rhs_t.norm())


def test_regalerkin_deflation_matches_jax(refresh_case):
    c = refresh_case
    be, tbe = c["be"], c["tbe"]
    esm_j, *_ = _jax_refresh(c, solve_predictor=False)
    khat, *_ = _port_refresh(c, solve_predictor=False)
    ref = be.make_deflation(esm_j, c["w"])
    out = tbe.make_deflation(khat, t64(c["w"]))
    _close(out.kw_inv, ref.kw_inv, 1e-9)


def test_riks_update_crisfield_matches_jax():
    """Reachable sphere: the increment lands on it (``|du| = |a|``, the
    property of ``tests/test_buckling_gnl.py:316-333``) and advances along
    ``a``; unreachable: the stationary point.  Both against the JAX
    package."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal(30)
    ue = rng.standard_normal(30)
    cases = {"sphere": (0.1 * rng.standard_normal(30), 0.9 * a),
             "stationary": (5.0 * rng.standard_normal(30), 0.9 * a)}
    for name, (due, du) in cases.items():
        ref = sysm.riks_update_crisfield(*map(jnp.asarray, (a, ue, due, du)), 0.0, 1.0)
        out = tsys.riks_update_crisfield(*map(t64, (a, ue, due, du)), 0.0, 1.0)
        for x, y in zip(out, ref):
            _close(x, y, 1e-12)
        du_new, lbd1, dl = out
        assert float(lbd1) == 1.0 + float(dl)
        if name == "sphere":
            np.testing.assert_allclose(float(du_new.norm()), np.linalg.norm(a), rtol=1e-12)
            assert float(du_new @ t64(a)) > 0.0
        else:
            assert float(du_new.norm()) > 1.01 * np.linalg.norm(a)


def test_scaled_control_vector():
    """``a = ue |du| / |ue|`` in the wider dtype; ``|ue| = 0`` guarded."""
    rng = np.random.default_rng(6)
    ue, du = rng.standard_normal(20), rng.standard_normal(20)
    _close(tsys.scaled_control_vector(t64(ue), t64(du)),
           sysm.scaled_control_vector(jnp.asarray(ue), jnp.asarray(du)), 1e-14)
    a = tsys.scaled_control_vector(t64(ue).float(), t64(du))
    assert a.dtype == F64
    assert torch.equal(tsys.scaled_control_vector(torch.zeros(4, dtype=F64), t64(du[:4])),
                       torch.zeros(4, dtype=F64))
