"""K1m and K4m, the block kernels of the port's buckling eigensolve, on the
CPU: their plain versions against the JAX package, float64.

* K1m (``kernels.khat_matmat``, through ``make_multi_matvec`` and the
  deflation's ``block_khat_matvec``/``galerkin``) against the JAX
  package's ``_multi_matvec`` in its three forms (K_hat·V; -G_hat·V,
  projected and negated; the raw K·V, ``fixmask`` all ones) and its
  ``block_khat_matvec``/``galerkin``, on a clamped box and the small plate
  with a hole, at the eigensolve's and the deflation's widths.
* K1m's plain version on the packed copy of the blocks (what the kernel
  reads on the card) against the full blocks'.
* K4m (``kernels.two_level_apply_block``, through ``TwoLevelPrecond.apply``
  on a block) against the JAX package's ``TwoLevelPrecond.apply`` under
  ``jax.vmap`` over the columns, on the JAX package's exact state, with
  block Jacobi and the cluster smoother, 6 and 12 modes.
* Both wrappers' checks of shapes, dtypes and devices.

The inputs are made from numpy seeds.  Every comparison is held to
``RTOL`` = 1e-12 of the largest value of the JAX package's output: float64
sums in another order.  CPU tensors take the plain versions, so no launch
is counted.  The kernels on the card are tested in ``test_torch_cuda.py``;
the eigensolve through them (``buckling_from_arrays``, ``pcg_block``) in
``test_torch_buckling.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import E, F64, NU, plate_model, t64, ti

import fcvm_tpu
from fcvm_tpu.config import get_config
from fcvm_tpu.models import meshgen
from fcvm_tpu.ops import assembly as asm
from fcvm_tpu.ops import deflation as jdfl
from fcvm_tpu.ops import material as mat
from fcvm_tpu.runtime import buckling as jbk
from fcvm_tpu.runtime import system as sysm
from fcvm_tpu.utils.indexing import pad_ndof, pad_vector
from fcvm_tpu_torch.models.spec import to_torch
from fcvm_tpu_torch.ops import assembly as tasm
from fcvm_tpu_torch.ops import deflation as tdfl
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import precond as tpre

RTOL = 1e-12  # max |port - JAX| / max |JAX|: float64 sums in another order
WIDTHS = (1, 3, 8, 32)  # a block solve's tails, its block of 8, the plate's deflation k


def _close(got, want, rel=RTOL):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _launches():
    return kernels.khat_matmat.launches, kernels.two_level_apply_block.launches


def _clamped_box():
    mesh = meshgen.box_tet10(3, 2, 2, 10.0, 6.0, 6.0)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, 0.0, 0.0))])
    return mesh, bcs


def _plate():
    model = plate_model()
    return model.mesh, model.bcs


@pytest.fixture(scope="module", params=["box", "plate"])
def pencil(request):
    """A mesh's elastic and geometric blocks (a seeded pre-stress), both in
    the JAX package's (ne, 30, 30) and the port's element-major (30, 30,
    ne), its padded fixmask (fixed and padded dofs included) and dofs."""
    mesh, bcs = _clamped_box() if request.param == "box" else _plate()
    nd = pad_ndof(mesh.ndof)
    assert nd > mesh.ndof
    fm = pad_vector(bcs.masks(mesh.ndof)[0], nd)
    coords, eln = jnp.asarray(mesh.coords), jnp.asarray(mesh.elnodes)
    sig = np.random.default_rng(1).normal(scale=50.0, size=(mesh.n_elements, 4, 6))
    blocks = {"elastic": asm.elastic_stiffness_blocks(
                  coords, eln, mat.hooke_dmat(jnp.float64(E), jnp.float64(NU))),
              "geometric": asm.geometric_stiffness_blocks(coords, eln, jnp.asarray(sig))}
    eldofs = asm.element_dof_ids(eln)
    return dict(name=request.param, mesh=mesh, nd=nd, fm=fm, blocks=blocks, eldofs=eldofs,
                blocks_t={k: t64(v).permute(1, 2, 0).contiguous() for k, v in blocks.items()},
                inc=tasm.node_incidence(ti(mesh.elnodes), nd // 3))


# form -> (blocks, mask: "clamped" or "ones", identity_on_fixed, negate)
FORMS = {"masked": ("elastic", "clamped", True, False),
         "projected_negated": ("geometric", "clamped", False, True),
         "raw": ("elastic", "ones", False, False)}


@pytest.mark.parametrize("m", WIDTHS)
@pytest.mark.parametrize("form", list(FORMS))
def test_khat_matmat_matches_multi_matvec(pencil, form, m):
    """``make_multi_matvec`` (K1m's plain version on the CPU) against the
    JAX package's ``_multi_matvec`` on an (ndof, m) block non-zero on every
    dof, to 1e-12 of the largest value: K_hat·V of the elastic blocks,
    -G_hat·V of the geometric ones, and the raw K·V with ``fixmask`` all
    ones, which K1m's raw form (no ``fixmask``) gives bit for bit."""
    kind, mask, ident, neg = FORMS[form]
    fm = pencil["fm"] if mask == "clamped" else np.ones(pencil["nd"])
    u = np.random.default_rng(m).normal(size=(pencil["nd"], m))
    want = jbk._multi_matvec(pencil["eldofs"], jnp.asarray(fm), ident, negate=neg)(
        pencil["blocks"][kind], jnp.asarray(u))
    before = _launches()
    esm_t, eldofs = pencil["blocks_t"][kind], ti(pencil["eldofs"])
    got = tasm.make_multi_matvec(esm_t, eldofs, t64(fm), ident, neg)(t64(u))
    _close(got, want)
    if mask == "ones":
        raw = tasm.make_multi_matvec(esm_t, eldofs, None, incidence=pencil["inc"])(t64(u))
        assert torch.equal(raw, got)
        assert torch.equal(kernels.khat_matmat(esm_t, pencil["inc"], t64(u)), got)
    assert _launches() == before


@pytest.mark.parametrize("m", WIDTHS)
def test_khat_matmat_matches_block_khat_matvec(pencil, m):
    """The deflation's ``block_khat_matvec`` and ``galerkin`` (K1m, masked)
    against the JAX package's, with its plain node sum, to 1e-12."""
    esm, fm, eldofs = pencil["blocks"]["elastic"], jnp.asarray(pencil["fm"]), pencil["eldofs"]
    w = np.random.default_rng(10 + m).normal(size=(pencil["nd"], m))
    before = _launches()
    args = (pencil["blocks_t"]["elastic"], ti(eldofs), t64(pencil["fm"]), t64(w))
    _close(tdfl.block_khat_matvec(*args, incidence=pencil["inc"]),
           jdfl.block_khat_matvec(esm, eldofs, fm, None, jnp.asarray(w)))
    _close(tdfl.galerkin(*args), jdfl.galerkin(esm, eldofs, fm, None, jnp.asarray(w)))
    assert _launches() == before


@pytest.mark.parametrize("form", list(FORMS))
def test_plain_khat_matmat_on_packed_blocks(pencil, form):
    """K1m's plain version on the packed copy of the blocks (the upper
    triangles, symmetrised: what the kernel reads on the card) against the
    full blocks', to 1e-12; the packed plain version is the unpacked
    blocks' bit for bit."""
    kind, mask, ident, neg = FORMS[form]
    esm_t, inc = pencil["blocks_t"][kind], pencil["inc"]
    fm = t64(pencil["fm"]) if mask == "clamped" else None
    u = t64(np.random.default_rng(20).normal(size=(pencil["nd"], 8)))
    packed = kernels.pack_blocks(esm_t)
    sym = kernels.unpack_blocks(packed, esm_t.shape[2])
    got = kernels.khat_matmat_ref(sym, inc, u, fm, ident, neg)
    assert torch.equal(kernels.khat_matmat_packed_ref(packed, inc, u, fm, ident, neg), got)
    _close(got, kernels.khat_matmat_ref(esm_t, inc, u, fm, ident, neg))


def _jax_precond(smoother, nm):
    """The small plate's two-level preconditioner (32-node coarse clusters,
    ``nm`` modes; with the cluster smoother of 64-node clusters) built by
    the JAX package in its Morton solve space, and the port's copy."""
    model = plate_model()
    mesh = model.mesh
    nd = pad_ndof(mesh.ndof)
    fixmask = jnp.asarray(pad_vector(model.bcs.masks(mesh.ndof)[0], nd))
    esm = asm.elastic_stiffness_blocks(jnp.asarray(mesh.coords), jnp.asarray(mesh.elnodes),
                                       mat.hooke_dmat(jnp.float64(E), jnp.float64(NU)))
    space = sysm.build_solve_space(mesh.coords, mesh.elnodes, fixmask, nd)
    cfg = get_config()
    saved = cfg.smoother
    cfg.smoother = smoother
    try:
        pc = sysm.build_precond(esm, jnp.asarray(mesh.elnodes), jnp.asarray(mesh.coords),
                                fixmask, 32, space=space, n_modes=nm)
    finally:
        cfg.smoother = saved
    assert (pc.smooth_inv is not None) == (smoother == "cluster")
    assert pc.qmat.shape[2] == nm
    fields = (pc.pinv, pc.qmat, pc.coarse_inv, pc.fixmask, pc.smooth_inv)
    return nd, pc, tpre.TwoLevelPrecond(*to_torch(fields, "cpu", F64))


@pytest.fixture(scope="module", params=[("jacobi3", 6), ("jacobi3", 12), ("cluster", 6),
                                        ("cluster", 12)], ids=lambda p: f"{p[0]}-nm{p[1]}")
def plate_pc(request):
    return _jax_precond(*request.param)


@pytest.mark.parametrize("m", [1, 5, 8])
def test_two_level_apply_block_matches_vmapped_apply(plate_pc, m):
    """``kernels.two_level_apply_block`` (and ``TwoLevelPrecond.apply`` on a
    block, which calls it) on the JAX package's exact state against its
    ``TwoLevelPrecond.apply`` under ``jax.vmap`` over the columns, to
    1e-12; its coarse part alone (less the fine level) to 1e-9 of that
    part's largest value, as the vector's test holds it."""
    nd, pc, tpc = plate_pc
    r = np.random.default_rng(30 + m).normal(size=(nd, m))
    want = jax.vmap(pc.apply, in_axes=1, out_axes=1)(jnp.asarray(r))
    before = _launches()
    z_fine = None if tpc.smooth_inv is None else tpc.fine(t64(r))
    got = kernels.two_level_apply_block(tpc.pinv, tpc.qmat, tpc.coarse_inv, tpc.fixmask, t64(r),
                                        z_fine)
    assert _launches() == before
    assert torch.equal(tpc.apply(t64(r)), got)
    _close(got, want)
    fine = tpc.fine(t64(r))
    coarse = np.asarray(want) - fine.numpy()
    assert np.abs(coarse).max() > 0.0
    _close(got - fine, coarse, 1e-9)


def test_block_wrappers_reject_what_they_do_not_take(pencil):
    """Wrong shapes, dtypes and devices raise in both wrappers (a tensor on
    the ``meta`` device stands for one off the CPU)."""
    esm_t, inc, nd = pencil["blocks_t"]["elastic"], pencil["inc"], pencil["nd"]
    fm, u = t64(pencil["fm"]), torch.zeros((nd, 3), dtype=F64)
    with pytest.raises(ValueError):
        kernels.khat_matmat(esm_t, inc, u[:, 0], fm)  # a vector, not a block
    with pytest.raises(ValueError):
        kernels.khat_matmat(esm_t, inc, u[:-3], fm)
    with pytest.raises(ValueError):
        kernels.khat_matmat(esm_t, inc, u, fm[:-3])
    with pytest.raises(ValueError):
        kernels.khat_matmat(esm_t[:, :, 1:], inc, u, fm)
    with pytest.raises(TypeError):
        kernels.khat_matmat(esm_t, inc, u.float(), fm)
    with pytest.raises(TypeError):
        kernels.khat_matmat(esm_t, inc._replace(pos=inc.pos.long()), u, fm)
    with pytest.raises(ValueError):
        kernels.khat_matmat(esm_t, inc, u.to("meta"), fm)
    with pytest.raises(ValueError):
        tasm.make_multi_matvec(esm_t, tasm.element_dof_ids(inc.elnodes_t.T.long()), None)
    _, _, tpc = _jax_precond("jacobi3", 6)
    args = (tpc.pinv, tpc.qmat, tpc.coarse_inv, tpc.fixmask)
    r = torch.zeros((tpc.fixmask.shape[0], 3), dtype=F64)
    with pytest.raises(ValueError):
        kernels.two_level_apply_block(*args, r[:, 0])  # a vector, not a block
    with pytest.raises(ValueError):
        kernels.two_level_apply_block(*args, r[:-3])
    with pytest.raises(ValueError):
        kernels.two_level_apply_block(*args, r, r[:, :2])
    with pytest.raises(ValueError):
        kernels.two_level_apply_block(tpc.pinv, tpc.qmat[:, :, :5], *args[2:], r)
    with pytest.raises(TypeError):
        kernels.two_level_apply_block(*args, r.float())
    with pytest.raises(ValueError):
        kernels.two_level_apply_block(*args, r.to("meta"))
