"""The port's elastic PCG solve against the JAX package's, CPU float64: the
Morton solve space, the operator, and the two-level-preconditioned CG."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import E, F64, NU, t64, tension_model

from fcvm_tpu.ops import material as mat
from fcvm_tpu.runtime import system as sysm
from fcvm_tpu.utils.indexing import pad_ndof, pad_vector
from fcvm_tpu_torch.models.spec import model_from_arrays, to_torch
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import precond as tpre
from fcvm_tpu_torch.ops import solver as tslv
from fcvm_tpu_torch.runtime import system as tsys

RTOL_CG = 1e-8
CLUSTER = 8


@pytest.fixture(scope="module")
def elastic():
    """The elastic system of a 3x3x3 tension box, assembled and solved by
    the JAX package (two-level PCG in its Morton space) and assembled by the
    port."""
    model = tension_model(n=3)
    mesh = model.mesh
    nd = pad_ndof(mesh.ndof)
    fixmask_np, u_fix_np, _ = model.bcs.masks(mesh.ndof)
    fixmask = jnp.asarray(pad_vector(fixmask_np, nd))
    u_fix = jnp.asarray(pad_vector(u_fix_np, nd))
    coords, eln = jnp.asarray(mesh.coords), jnp.asarray(mesh.elnodes)
    dmat = mat.hooke_dmat(jnp.float64(E), jnp.float64(NU))
    loads = sysm.LoadTables.from_spec(model.loads, jnp.float64)
    esm, _, _, rhs, _, _, _ = sysm.assemble_elastic(coords, eln, dmat, loads, jnp.float64(0.0),
                                                    fixmask, u_fix)
    space = sysm.build_solve_space(mesh.coords, mesh.elnodes, fixmask, nd)
    pc = sysm.build_precond(esm, eln, coords, fixmask, CLUSTER, space=space, n_modes=12)
    res = sysm.solve_displacement(esm, eln, fixmask, pc, rhs, RTOL_CG, 2000, x0=u_fix,
                                  space=space)

    tmodel = model_from_arrays(model)
    tloads = tsys.LoadTables.from_spec(tmodel.loads, F64, "cpu", nd)
    teln = torch.as_tensor(mesh.elnodes.astype(np.int64))
    tspace = tsys.build_solve_space(mesh.coords, mesh.elnodes, t64(fixmask), nd)
    tkhat, tpinv, _, trhs, _, _, _ = tsys.assemble_operator(
        t64(mesh.coords), teln, t64(dmat), tloads, 0.0, t64(fixmask), t64(u_fix),
        kernels.segment_plan(teln), tspace)
    return dict(space=space, pc=pc, res=res, rhs=rhs, u_fix=u_fix, tspace=tspace,
                tkhat=tkhat, tpinv=tpinv, trhs=trhs)


def test_solve_space_matches_jax(elastic):
    space, tspace = elastic["space"], elastic["tspace"]
    for name in ("nperm", "npos", "eperm", "elnodes_m"):
        assert np.array_equal(getattr(tspace, name).numpy(), np.asarray(getattr(space, name)))
    np.testing.assert_array_equal(tspace.fixmask_m.numpy(), np.asarray(space.fixmask_m))
    np.testing.assert_array_equal(tspace.coords_m.numpy(), np.asarray(space.coords_m))
    np.testing.assert_allclose(elastic["trhs"].numpy(), np.asarray(elastic["rhs"]),
                               rtol=0, atol=1e-10 * float(jnp.abs(elastic["rhs"]).max()))


def test_elastic_pcg_matches_jax(elastic):
    """The port's PCG on its own operator, preconditioned with the JAX
    package's exact two-level state: equal iteration count, equal x."""
    pc = elastic["pc"]
    tpc = tpre.TwoLevelPrecond(*to_torch((pc.pinv, pc.qmat, pc.coarse_inv, pc.fixmask),
                                         "cpu", F64))
    res = tsys.solve_displacement(elastic["tkhat"], tpc, elastic["trhs"], RTOL_CG, 2000,
                                  elastic["tspace"], x0=t64(elastic["u_fix"]))
    ref = elastic["res"]
    assert res.iters == int(ref.iters) > 5
    x_ref = np.asarray(ref.x)
    np.testing.assert_allclose(res.x.numpy(), x_ref, rtol=0,
                               atol=1e-9 * np.abs(x_ref).max())


@pytest.mark.parametrize("precond", ["two_level", "block_jacobi"])
def test_elastic_pcg_own_precond_converges(elastic, precond):
    """With the port's own preconditioner (two-level in float64, or the
    nodal blocks alone) the solve reaches the JAX package's solution."""
    tspace = elastic["tspace"]
    if precond == "two_level":
        pc = tsys.operator_precond(elastic["tkhat"], CLUSTER, tspace, 12)
    else:
        pc = elastic["tpinv"][tspace.nperm]
    res = tsys.solve_displacement(elastic["tkhat"], pc, elastic["trhs"], 1e-12, 2000, tspace,
                                  x0=t64(elastic["u_fix"]))
    assert res.relres <= 1e-12
    x_ref = np.asarray(elastic["res"].x)
    np.testing.assert_allclose(res.x.numpy(), x_ref, rtol=0,
                               atol=1e-7 * np.abs(x_ref).max())


def test_pcg_stall_exit_and_custom_dot():
    """``stall`` stops a solve whose residual stopped improving; a custom
    ``dot`` gives the default result."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(40, 40))
    spd = torch.as_tensor(a @ a.T + 40.0 * np.eye(40))
    b = torch.as_tensor(rng.normal(size=40))
    base = tslv.pcg(lambda v: spd @ v, b, rtol=1e-10, maxiter=200)
    alt = tslv.pcg(lambda v: spd @ v, b, rtol=1e-10, maxiter=200,
                   dot=lambda u, v: (u * v).sum())
    assert base.iters == alt.iters and base.relres <= 1e-10
    np.testing.assert_allclose(alt.x.numpy(), base.x.numpy(), rtol=1e-12)
    # b has a component in the null space of a singular operator, so ||r||
    # cannot reach the tolerance: without stall the solve runs to maxiter,
    # with stall it stops once ||r|| no longer improves
    sing = torch.diag(torch.as_tensor(np.r_[np.linspace(1.0, 10.0, 39), 0.0]))
    b_floor = b.clone()
    b_floor[-1] = 1e-5 * float(b.norm())
    floor = tslv.pcg(lambda v: sing @ v, b_floor, rtol=1e-12, maxiter=100)
    stalled = tslv.pcg(lambda v: sing @ v, b_floor, rtol=1e-12, maxiter=100, stall=5)
    assert floor.iters == 100 and stalled.iters < 100
