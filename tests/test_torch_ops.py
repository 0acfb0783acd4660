"""Parity of the port's ops (elements, material, assembly, stress update,
two-level preconditioner) with the JAX package's, CPU float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import E, F64, L, NU, t64, ti, tension_model

from fcvm_tpu.models import meshgen
from fcvm_tpu.ops import assembly as asm
from fcvm_tpu.ops import elements as el
from fcvm_tpu.ops import material as mat
from fcvm_tpu.ops import precond as pre
from fcvm_tpu.ops.stress_update import internal_force_from_stress, update_stress_load
from fcvm_tpu.runtime import system as sysm
from fcvm_tpu.utils.indexing import pad_ndof, pad_vector
from fcvm_tpu_torch.models.spec import to_torch
from fcvm_tpu_torch.ops import assembly as tasm
from fcvm_tpu_torch.ops import elements as tel
from fcvm_tpu_torch.ops import material as tmat
from fcvm_tpu_torch.ops import precond as tpre
from fcvm_tpu_torch.ops import stress_update as tsu
from fcvm_tpu_torch.runtime import system as tsys

RTOL = 1e-10


def close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _distorted_box(seed=0):
    """box_tet10(2, 2, 2) with interior-safe random node jitter."""
    mesh = meshgen.box_tet10(2, 2, 2, L, L, L)
    jitter = np.random.default_rng(seed).uniform(-0.4, 0.4, mesh.coords.shape)
    return mesh.coords + jitter, mesh.elnodes


@pytest.fixture(scope="module")
def box():
    """Elastic operator pieces of the symmetry-constrained tension box."""
    model = tension_model()
    mesh = model.mesh
    nd = pad_ndof(mesh.ndof)
    fixmask_np, u_fix_np, _ = model.bcs.masks(mesh.ndof)
    coords = jnp.asarray(mesh.coords)
    eln = jnp.asarray(mesh.elnodes)
    esm = asm.elastic_stiffness_blocks(coords, eln, mat.hooke_dmat(jnp.float64(E), jnp.float64(NU)))
    return dict(model=model, coords=coords, eln=eln, esm=esm, nd=nd,
                fixmask=jnp.asarray(pad_vector(fixmask_np, nd)),
                u_fix=jnp.asarray(pad_vector(u_fix_np, nd)))


# -- elements and material ---------------------------------------------------


def test_tet10_geometry_matches_jax():
    coords, eln = _distorted_box()
    det, dshpg, bmat = jax.vmap(el.tet10_element_geometry)(jnp.asarray(coords)[eln])
    tdet, tdshpg, tbmat = tel.tet10_element_geometry(t64(coords)[ti(eln)])
    close(tdet, det, rtol=1e-12)
    close(tdshpg, dshpg, rtol=1e-12, atol=1e-14)
    close(tbmat, bmat, rtol=1e-12, atol=1e-14)


def test_surface_frames_match_jax():
    coords, _ = _distorted_box(1)
    rng = np.random.default_rng(1)
    faces = rng.integers(0, len(coords), size=(7, 6))
    edges = rng.integers(0, len(coords), size=(5, 3))
    xsj, normal = jax.vmap(el.tri6_surface_frame)(jnp.asarray(coords)[faces])
    txsj, tnormal = tel.tri6_surface_frame(t64(coords)[ti(faces)])
    close(txsj, xsj, rtol=1e-12)
    close(tnormal, normal, rtol=1e-12, atol=1e-13)
    close(tel.line3_jacobian(t64(coords)[ti(edges)]),
          jax.vmap(el.line3_jacobian)(jnp.asarray(coords)[edges]), rtol=1e-12)


def test_material_matches_jax():
    rng = np.random.default_rng(3)
    sig = rng.normal(scale=150.0, size=(64, 4, 6))
    sy = rng.uniform(100.0, 300.0, size=(64, 4))
    close(tmat.hooke_dmat(E, NU, F64, "cpu"), mat.hooke_dmat(jnp.float64(E), jnp.float64(NU)),
          rtol=1e-15)
    g, h = E / (1 + NU) / 2, tmat.hardening_modulus(E, 0.1)
    assert h == pytest.approx(float(mat.hardening_modulus(E, 0.1)), rel=1e-15)
    sig_new, plastic = mat.radial_return(jnp.asarray(sig), jnp.asarray(sy), h, g)
    tsig_new, tplastic = tmat.radial_return(t64(sig), t64(sy), h, g)
    assert plastic.any() and not plastic.all()
    assert np.array_equal(tplastic.numpy(), np.asarray(plastic))
    close(tsig_new, sig_new, rtol=1e-12, atol=1e-10)
    ref = mat.update_peeq_csr(jnp.asarray(sig), sig_new, jnp.asarray(sy),
                              jnp.zeros((64, 4)), jnp.zeros((64, 4)), E, NU, 0.1, 0.25)
    out = tmat.update_peeq_csr(t64(sig), tsig_new, t64(sy), torch.zeros(64, 4, dtype=F64),
                               torch.zeros(64, 4, dtype=F64), E, NU, 0.1, 0.25)
    for a, b in zip(out, ref):
        close(a, b, rtol=1e-12, atol=1e-14)


# -- assembly ----------------------------------------------------------------


def test_elastic_blocks_match_jax():
    coords, eln = _distorted_box(2)
    dmat = mat.hooke_dmat(jnp.float64(E), jnp.float64(NU))
    esm = asm.elastic_stiffness_blocks(jnp.asarray(coords), jnp.asarray(eln), dmat)
    tesm = tasm.elastic_stiffness_blocks(t64(coords), ti(eln), t64(dmat))
    close(tesm, esm, atol=RTOL * float(jnp.abs(esm).max()))


@pytest.mark.parametrize("kind", ["gravity", "pressure", "traction", "edge", "vertex"])
def test_loads_match_jax(kind):
    mesh = meshgen.box_tet10(2, 2, 2, L, L, L)
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    coords, eln = _distorted_box(4)
    nd = pad_ndof(mesh.ndof)
    if kind == "gravity":
        args = (jnp.asarray(eln), jnp.float64(7.85e-6), jnp.asarray([0.0, -9810.0, 3.0]), nd)
        ref = asm.gravity_load_and_gp_coords(jnp.asarray(coords), *args)
        out = tasm.gravity_load_and_gp_coords(t64(coords), ti(eln), 7.85e-6,
                                              t64([0.0, -9810.0, 3.0]), nd)
        for a, b in zip(out, ref):
            close(a, b, atol=1e-12)
        return
    rng = np.random.default_rng(5)
    if kind == "pressure":
        p = rng.normal(size=len(faces))
        ref = asm.pressure_face_loads(jnp.asarray(coords), jnp.asarray(faces), jnp.asarray(p), nd)
        out = tasm.pressure_face_loads(t64(coords), ti(faces), t64(p), nd)
    elif kind == "traction":
        tr = rng.normal(size=(len(faces), 3))
        ref = asm.uniform_face_loads(jnp.asarray(coords), jnp.asarray(faces), jnp.asarray(tr), nd)
        out = tasm.uniform_face_loads(t64(coords), ti(faces), t64(tr), nd)
    elif kind == "edge":
        edges = mesh.boundary_edges()[:6]
        tr = rng.normal(size=(len(edges), 3))
        ref = asm.edge_loads(jnp.asarray(coords), jnp.asarray(edges), jnp.asarray(tr), nd)
        out = tasm.edge_loads(t64(coords), ti(edges), t64(tr), nd)
    else:
        verts = np.array([3, 17, 40])
        f = rng.normal(size=(3, 3))
        ref = asm.vertex_loads(jnp.asarray(verts), jnp.asarray(f), nd, jnp.float64)
        out = tasm.vertex_loads(ti(verts), t64(f), nd)
    assert float(np.abs(np.asarray(ref)).max()) > 0.0
    close(out, ref, atol=1e-13)


def test_distribute_total_force_matches_jax():
    """Total force -> per-unit tractions over faces (area), edges (length)
    and vertices, with the port's numpy face and edge integrals."""
    from fcvm_tpu.models import spec
    from fcvm_tpu_torch.models import spec as tspec

    coords, eln = _distorted_box(9)
    mesh = meshgen.box_tet10(2, 2, 2, L, L, L)
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    edges = mesh.boundary_edges()[:5]
    mesh.coords = coords
    kw = dict(faces=faces, edges=edges, vertices=np.array([1, 4, 9]))
    ref = spec.distribute_total_force(mesh, [3.0, -2.0, 7.0], **kw)
    out = tspec.distribute_total_force(tspec.Mesh(coords, eln), [3.0, -2.0, 7.0], **kw)
    assert sorted(out) == sorted(ref)
    for k in ref:
        close(out[k], ref[k], rtol=1e-12)


def test_dirichlet_rhs_and_block_jacobi_match_jax(box):
    eldofs = asm.element_dof_ids(box["eln"])
    glv = jnp.asarray(np.random.default_rng(6).normal(size=box["nd"]))
    u_fix = box["u_fix"] + 1e-3 * (1.0 - box["fixmask"])  # nonzero prescribed values
    rhs = asm.dirichlet_rhs(box["esm"], eldofs, box["fixmask"], u_fix, glv)
    trhs = tasm.dirichlet_rhs(t64(box["esm"]).permute(1, 2, 0).contiguous(), ti(eldofs),
                              t64(box["fixmask"]),
                              t64(u_fix), t64(glv))
    close(trhs, rhs, atol=RTOL * float(jnp.abs(rhs).max()))
    pinv = asm.block_jacobi_inverse_blocks(box["esm"], box["eln"], box["fixmask"])
    tpinv = tasm.block_jacobi_inverse_blocks(t64(box["esm"]), ti(box["eln"]), t64(box["fixmask"]))
    close(tpinv, pinv, atol=RTOL * float(jnp.abs(pinv).max()))


# -- stress update -----------------------------------------------------------


def test_stress_update_plastic_matches_jax(box):
    rng = np.random.default_rng(7)
    ne = box["eln"].shape[0]
    du = rng.normal(scale=2e-3, size=box["nd"])
    sig_old = rng.normal(scale=40.0, size=(ne, 4, 6))
    sy = rng.uniform(100.0, 400.0, size=(ne, 4))
    dmat = mat.hooke_dmat(jnp.float64(E), jnp.float64(NU))
    zero = jnp.zeros(box["nd"])
    ref = update_stress_load(box["coords"], box["eln"], dmat, jnp.asarray(sy), zero,
                             jnp.asarray(du), jnp.asarray(sig_old), E, NU, 0.1, False)
    out = tsu.update_stress_load(t64(box["coords"]), ti(box["eln"]), t64(dmat), t64(sy),
                                 torch.zeros(box["nd"], dtype=F64), t64(du), t64(sig_old),
                                 E, NU, 0.1)
    sig_new, sig_test, pgp, qin = ref
    assert np.asarray(pgp).any() and not np.asarray(pgp).all()
    assert np.array_equal(out[2].numpy(), np.asarray(pgp))
    close(out[0], sig_new, atol=RTOL * float(jnp.abs(sig_new).max()))
    close(out[1], sig_test, atol=RTOL * float(jnp.abs(sig_test).max()))
    close(out[3], qin, atol=RTOL * float(jnp.abs(qin).max()))
    # the reaction of a given stress field (target-LF interception state)
    qin2 = internal_force_from_stress(box["coords"], box["eln"], sig_new, zero, False)
    close(tsu.internal_force_from_stress(t64(box["coords"]), ti(box["eln"]), out[0],
                                         torch.zeros(box["nd"], dtype=F64)),
          qin2, atol=RTOL * float(jnp.abs(qin2).max()))


def test_gnl_stress_update_raises(box):
    """The geometrically nonlinear stress update (``large_disp=True``: B on
    ``coords + disp``, the old stress convected as ``F sigma F^T / det F``)
    with a non-zero total displacement and increment, some points plastic
    and some not: the same flags, stresses and internal force as the JAX
    package; and not those of small strain."""
    rng = np.random.default_rng(17)
    ne = box["eln"].shape[0]
    disp = np.asarray(box["fixmask"]) * rng.normal(scale=0.05, size=box["nd"])
    du = rng.normal(scale=2e-3, size=box["nd"])
    sig_old = rng.normal(scale=40.0, size=(ne, 4, 6))
    sy = rng.uniform(100.0, 400.0, size=(ne, 4))
    dmat = mat.hooke_dmat(jnp.float64(E), jnp.float64(NU))
    args = (jnp.asarray(sy), jnp.asarray(disp), jnp.asarray(du), jnp.asarray(sig_old), E, NU, 0.1)
    targs = (t64(sy), t64(disp), t64(du), t64(sig_old), E, NU, 0.1)
    sig_new, sig_test, pgp, qin = update_stress_load(box["coords"], box["eln"], dmat, *args, True)
    out = tsu.update_stress_load(t64(box["coords"]), ti(box["eln"]), t64(dmat), *targs,
                                 large_disp=True)
    assert np.asarray(pgp).any() and not np.asarray(pgp).all()
    assert np.array_equal(out[2].numpy(), np.asarray(pgp))
    close(out[0], sig_new, atol=RTOL * float(jnp.abs(sig_new).max()))
    close(out[1], sig_test, atol=RTOL * float(jnp.abs(sig_test).max()))
    close(out[3], qin, atol=RTOL * float(jnp.abs(qin).max()))
    small = tsu.update_stress_load(t64(box["coords"]), ti(box["eln"]), t64(dmat), *targs)
    assert float((small[1] - out[1]).abs().max()) > 1e-3 * float(out[1].abs().max())


# -- two-level preconditioner ------------------------------------------------


@pytest.fixture(scope="module")
def morton_box(box):
    """The JAX package's Morton solve space and two-level preconditioner
    (12 modes, 8-node clusters) on the tension box, and the port's."""
    mesh = box["model"].mesh
    space = sysm.build_solve_space(mesh.coords, mesh.elnodes, box["fixmask"], box["nd"])
    pc = sysm.build_precond(box["esm"], box["eln"], box["coords"], box["fixmask"], 8,
                            space=space, n_modes=12)
    tspace = tsys.build_solve_space(mesh.coords, mesh.elnodes, t64(box["fixmask"]), box["nd"])
    tpc = tpre.build_two_level(t64(box["esm"])[tspace.eperm], tspace.elnodes_m, tspace.coords_m,
                               tspace.fixmask_m, cluster_size=8, n_modes=12)
    return space, pc, tspace, tpc


def test_two_level_apply_matches_jax(morton_box):
    """The port's apply on the JAX package's exact preconditioner state."""
    _, pc, _, _ = morton_box
    tpc = tpre.TwoLevelPrecond(*to_torch((pc.pinv, pc.qmat, pc.coarse_inv, pc.fixmask),
                                         "cpu", F64))
    r = np.random.default_rng(8).normal(size=pc.fixmask.shape[0])
    z = pc.apply(jnp.asarray(r))
    close(tpc.apply(t64(r)), z, atol=RTOL * float(jnp.abs(z).max()))


def test_two_level_build_matches_jax(morton_box, box):
    """Block-Jacobi blocks, mode basis and Galerkin accumulate equal the JAX
    package's; the coarse inverse (float64 here, float32 there by the TPU's
    rule) equals the exact inverse of the JAX package's scaled, ridged
    coarse matrix."""
    space, pc, tspace, tpc = morton_box
    close(tpc.pinv, pc.pinv, atol=RTOL * float(jnp.abs(pc.pinv).max()))
    close(tpc.qmat, pc.qmat, atol=1e-13)
    kc = pre._coarse_accumulate(box["esm"][space.eperm], space.elnodes_m, pc.qmat, 8)
    tkc = tpre.coarse_accumulate(t64(box["esm"])[tspace.eperm], tspace.elnodes_m, tpc.qmat, 8)
    close(tkc, kc, atol=RTOL * float(jnp.abs(kc).max()))
    ks, dscale = pre._coarse_densify_scale(kc, jnp.float64(3e-5))
    exact = np.linalg.inv(np.asarray(ks)) * np.outer(dscale, dscale)
    close(tpc.coarse_inv, exact, atol=1e-8 * np.abs(exact).max())
    assert tpre.COARSE_BUILD_STATS["builds"] >= 1
    assert not tpre.COARSE_BUILD_STATS["last_fallback"]
