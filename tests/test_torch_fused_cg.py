"""K1 and K4, the fused kernels of the port's CG iteration, on the CPU:
their plain versions against the JAX package, float64.

* K1 (``kernels.khat_matvec``): the fused K_hat·v, masked and raw, against
  the JAX package's ``make_bc_matvec``/``make_matvec`` (its ``segment_sum``
  and its ``ScatterPlan`` node sums) on a small box in its Morton solve
  space, fixed and padded dofs included; its plain version is the chain it
  replaced, bit for bit.
* The node-incidence table K1's node pass reads: a segment sum through its
  CSR equals ``index_add_``, and every (slot, element) appears exactly once.
* K4 (``kernels.two_level_apply``): the two-level apply on a vector against
  the JAX package's ``TwoLevelPrecond.apply``, with block Jacobi and with
  the cluster smoother, on the JAX package's exact preconditioner state.
* The slice: the port's PCG solve through K1 and K4 against the JAX
  package's ``solve_displacement`` with the same preconditioner.

CPU tensors take the plain versions, so no launch is counted.  The kernels
on the card are tested in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import E, F64, NU, plate_model, t64, ti

import fcvm_tpu
from fcvm_tpu.config import get_config
from fcvm_tpu.models import meshgen
from fcvm_tpu.ops import assembly as asm
from fcvm_tpu.ops import material as mat
from fcvm_tpu.runtime import system as sysm
from fcvm_tpu.utils.indexing import pad_ndof, pad_vector
from fcvm_tpu_torch.models.spec import to_torch
from fcvm_tpu_torch.ops import assembly as tasm
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import precond as tpre
from fcvm_tpu_torch.runtime import system as tsys

RTOL = 1e-12  # max |port - JAX| / max |JAX|: float64 sums in another order


def _close(got, want, rel=RTOL):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _launches():
    return kernels.khat_matvec.launches, kernels.two_level_apply.launches


@pytest.fixture(scope="module")
def box():
    """A 3 x 2 x 2 box clamped on x = 0 (525 dof, padded to 768) in the JAX
    package's Morton solve space, its blocks in that element order, and the
    port's solve space of the same mesh."""
    mesh = meshgen.box_tet10(3, 2, 2, 10.0, 6.0, 6.0)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, 0.0, 0.0))])
    nd = pad_ndof(mesh.ndof)
    assert nd > mesh.ndof
    fixmask = jnp.asarray(pad_vector(bcs.masks(mesh.ndof)[0], nd))
    esm = asm.elastic_stiffness_blocks(jnp.asarray(mesh.coords), jnp.asarray(mesh.elnodes),
                                       mat.hooke_dmat(jnp.float64(E), jnp.float64(NU)))
    space = sysm.build_solve_space(mesh.coords, mesh.elnodes, fixmask, nd)
    tspace = tsys.build_solve_space(mesh.coords, mesh.elnodes, t64(fixmask), nd)
    np.testing.assert_array_equal(tspace.elnodes_m.numpy(), np.asarray(space.elnodes_m))
    esm_m = esm[space.eperm]
    return dict(mesh=mesh, nd=nd, space=space, tspace=tspace, esm_m=esm_m,
                esm_t=t64(esm_m).permute(1, 2, 0).contiguous(),
                eldofs_m=asm.element_dof_ids(space.elnodes_m))


@pytest.mark.parametrize("reference", ["segment_sum", "scatter_plan"])
@pytest.mark.parametrize("form", ["masked", "raw"])
def test_khat_matvec_matches_jax(box, form, reference):
    """``kernels.khat_matvec`` on a vector that is non-zero on every dof
    (fixed and padded ones too) against ``make_bc_matvec`` (masked) and
    ``make_matvec`` (raw) of the JAX package, with its plain node sum and
    with its ``ScatterPlan``, to 1e-12; the port's ``make_bc_matvec`` and
    ``make_matvec`` give the same bits as the wrapper."""
    sp, tsp, nd = box["space"], box["tspace"], box["nd"]
    plan = sp.plan_m if reference == "scatter_plan" else None
    u = np.random.default_rng(3).normal(size=nd)
    fm = sp.fixmask_m
    before = _launches()
    if form == "masked":
        want = asm.make_bc_matvec(box["esm_m"], box["eldofs_m"], fm, plan)(jnp.asarray(u))
        got = kernels.khat_matvec(box["esm_t"], tsp.incidence, t64(u), tsp.fixmask_m)
        via = tasm.make_bc_matvec(box["esm_t"], tsp.eldofs_m, tsp.fixmask_m,
                                  tsp.incidence)(t64(u))
        pad = slice(3 * box["mesh"].n_nodes, nd)  # padded dofs: the identity
        np.testing.assert_array_equal(got[pad].numpy(), u[pad])
    else:
        want = asm.make_matvec(box["esm_m"], box["eldofs_m"], nd, plan)(jnp.asarray(u))
        got = kernels.khat_matvec(box["esm_t"], tsp.incidence, t64(u))
        via = tasm.make_matvec(box["esm_t"], tsp.eldofs_m, nd)(t64(u))  # its own incidence
    assert _launches() == before  # CPU tensors: the plain version
    assert torch.equal(got, via)
    _close(got, want)


@pytest.mark.parametrize("form", ["masked", "raw"])
def test_khat_matvec_plain_is_the_chain_it_replaced(box, form):
    """K1's plain version is the chain the solver ran before it (per-dof
    gather, K0's plain version, ``index_add_``, the masks), bit for bit, so
    the CPU results of every path through it are unchanged."""
    tsp, esm_t = box["tspace"], box["esm_t"]
    u = t64(np.random.default_rng(4).normal(size=box["nd"]))
    fm = tsp.fixmask_m if form == "masked" else None
    eldofs_t = tsp.eldofs_m.T.contiguous()
    v = u if fm is None else fm * u
    fe_t = kernels.block_matvec_ref(esm_t, v[eldofs_t])
    kv = torch.zeros_like(u).index_add_(0, eldofs_t.reshape(-1), fe_t.reshape(-1))
    want = kv if fm is None else fm * kv + (1.0 - fm) * u
    assert torch.equal(kernels.khat_matvec_ref(esm_t, tsp.incidence, u, fm), want)


def test_node_incidence_is_a_fixed_order_csr(box):
    """The incidence table of the Morton elements: every (slot, element)
    exactly once, each under its own node, in ascending element order; a
    segment sum of an element output (30, ne) through the CSR equals
    ``index_add_`` into the dofs to 1e-14 of the largest value."""
    tsp = box["tspace"]
    inc = tsp.incidence
    eln = tsp.elnodes_m
    ne, nn = eln.shape[0], box["nd"] // 3
    assert inc.elnodes_t.dtype == inc.offsets.dtype == inc.pos.dtype == torch.int32
    assert torch.equal(inc.elnodes_t, eln.T.int())
    offsets, pos = inc.offsets.long(), inc.pos.long()
    assert offsets.shape == (nn + 1,) and int(offsets[0]) == 0 and int(offsets[-1]) == 10 * ne
    assert bool((offsets[1:] >= offsets[:-1]).all())
    slot, e = pos // (3 * ne), pos % (3 * ne)
    assert bool((e < ne).all()) and bool((slot < 10).all())
    np.testing.assert_array_equal(np.sort((10 * e + slot).numpy()), np.arange(10 * ne))
    node = torch.repeat_interleave(torch.arange(nn), offsets[1:] - offsets[:-1])
    assert torch.equal(eln[e, slot], node)
    same = node[1:] == node[:-1]
    assert bool((e[1:][same] > e[:-1][same]).all())  # a tet10 holds a node once
    fe = t64(np.random.default_rng(5).normal(size=(30, ne)))
    rows = fe.reshape(-1)[pos[:, None] + ne * torch.arange(3)]  # (10 ne, 3)
    seg = torch.segment_reduce(rows, "sum", lengths=offsets[1:] - offsets[:-1], axis=0,
                               unsafe=True)
    eldofs_t = tsp.eldofs_m.T.contiguous()
    want = torch.zeros(3 * nn, dtype=F64).index_add_(0, eldofs_t.reshape(-1), fe.reshape(-1))
    _close(seg.reshape(-1), want, 1e-14)


def test_khat_matvec_rejects_what_it_does_not_take(box):
    tsp, esm_t = box["tspace"], box["esm_t"]
    u = torch.zeros(box["nd"], dtype=F64)
    with pytest.raises(ValueError):
        kernels.khat_matvec(esm_t, tsp.incidence, u[:-3])
    with pytest.raises(ValueError):
        kernels.khat_matvec(esm_t[:, :, 1:], tsp.incidence, u)
    with pytest.raises(ValueError):
        kernels.khat_matvec(esm_t, tsp.incidence, u, tsp.fixmask_m[:-3])
    with pytest.raises(ValueError):
        tasm.node_incidence(tsp.elnodes_m, box["nd"] // 3 - 200)


def _jax_precond(model, smoother):
    """The small plate's two-level preconditioner (32-node coarse clusters,
    12 modes; with the cluster smoother of 64-node clusters) built by the
    JAX package in its Morton solve space."""
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
                                fixmask, 32, space=space, n_modes=12)
    finally:
        cfg.smoother = saved
    assert (pc.smooth_inv is not None) == (smoother == "cluster")
    return dict(nd=nd, esm=esm, fixmask=fixmask, space=space, pc=pc)


@pytest.fixture(scope="module", params=["jacobi3", "cluster"])
def plate_pc(request):
    model = plate_model()
    out = _jax_precond(model, request.param)
    pc = out["pc"]
    fields = (pc.pinv, pc.qmat, pc.coarse_inv, pc.fixmask, pc.smooth_inv)
    out.update(model=model, smoother=request.param,
               tpc=tpre.TwoLevelPrecond(*to_torch(fields, "cpu", F64)))
    return out


def test_two_level_apply_matches_jax(plate_pc):
    """``kernels.two_level_apply`` (and ``TwoLevelPrecond.apply``, which
    calls it) on the JAX package's exact state against the JAX package's
    ``TwoLevelPrecond.apply``, with block Jacobi and with the cluster
    smoother, to 1e-12; and its coarse part alone (the apply less its fine
    level, small on white noise) to 1e-9 of that part's largest value."""
    pc, tpc = plate_pc["pc"], plate_pc["tpc"]
    r = np.random.default_rng(6).normal(size=plate_pc["nd"])
    want = pc.apply(jnp.asarray(r))
    before = _launches()
    z_fine = None if tpc.smooth_inv is None else tpc.fine(t64(r))
    got = kernels.two_level_apply(tpc.pinv, tpc.qmat, tpc.coarse_inv, tpc.fixmask, t64(r),
                                  z_fine)
    assert _launches() == before
    assert torch.equal(tpc.apply(t64(r)), got)
    _close(got, want)
    fine = tpc.fine(t64(r))
    coarse = np.asarray(want) - fine.numpy()
    assert np.abs(coarse).max() > 0.0
    _close(got - fine, coarse, 1e-9)


def test_two_level_apply_rejects_what_it_does_not_take(plate_pc):
    tpc = plate_pc["tpc"]
    r = torch.zeros(plate_pc["nd"], dtype=F64)
    with pytest.raises(ValueError):
        kernels.two_level_apply(tpc.pinv, tpc.qmat, tpc.coarse_inv, tpc.fixmask, r[:-3])
    with pytest.raises(ValueError):
        kernels.two_level_apply(tpc.pinv, tpc.qmat[:, :, :5], tpc.coarse_inv, tpc.fixmask, r)
    with pytest.raises(ValueError):
        kernels.two_level_apply(tpc.pinv, tpc.qmat, tpc.coarse_inv[1:], tpc.fixmask, r)


def test_pcg_through_k1_and_k4_matches_jax(plate_pc):
    """The slice: the port's ``solve_displacement`` (its operator through K1,
    its preconditioner through K4, the JAX package's exact preconditioner
    state) against the JAX package's on the elastic right-hand side of the
    small plate at ``cg_rtol`` 1e-10: the same CG count, the solutions to
    1e-10 of their largest value, and no launch counted on the CPU."""
    model, nd, sp = plate_pc["model"], plate_pc["nd"], plate_pc["space"]
    mesh = model.mesh
    b = np.random.default_rng(7).normal(size=nd) * np.asarray(plate_pc["fixmask"])
    ref = sysm.solve_displacement(plate_pc["esm"], jnp.asarray(mesh.elnodes),
                                  plate_pc["fixmask"], plate_pc["pc"], jnp.asarray(b), 1e-10,
                                  1000, space=sp)
    tsp = tsys.build_solve_space(mesh.coords, mesh.elnodes, t64(plate_pc["fixmask"]), nd)
    khat = tsys.make_operator(t64(plate_pc["esm"])[ti(sp.eperm)], tsp)
    before = _launches()
    res = tsys.solve_displacement(khat, plate_pc["tpc"], t64(b), 1e-10, 1000, tsp)
    assert _launches() == before
    assert res.iters == int(ref.iters)
    _close(res.x, ref.x, 1e-10)
