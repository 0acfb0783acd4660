"""Whole-system composites of the small-strain collapse analysis.

The port of the :mod:`fcvm_tpu.runtime.system` functions on the slice's
call chain: elastic assembly, the Morton solve space, the preconditioner
build, the PCG solve (plain, deflated or harvesting), the deflation-space
build, the residual (and its float64 refinement over float32 state), the
Riks update and the converged-step records.  JAX compiles each of these
into one device program, and fuses a Newton iteration's solve, Riks update
and residual into another; here they are plain functions on tensors, which
the driver calls one after the other, and the operator's element blocks are
permuted into the solve space and stored element-major once per operator
(:func:`make_operator`), not on every solve.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from fcvm_tpu_torch.ops import assembly as asm
from fcvm_tpu_torch.ops import deflation as dfl
from fcvm_tpu_torch.ops import solver as slv
from fcvm_tpu_torch.ops.precond import apply_precond, build_two_level
from fcvm_tpu_torch.ops.stress_update import update_stress_load
from fcvm_tpu_torch.utils.ordering import morton_perm


class LoadTables(NamedTuple):
    """Device-side load tables (see :class:`fcvm_tpu_torch.models.spec.Loads`)."""

    pressure_faces: torch.Tensor
    pressures: torch.Tensor
    traction_faces: torch.Tensor
    tractions: torch.Tensor
    edges: torch.Tensor
    edge_tractions: torch.Tensor
    vertices: torch.Tensor
    vertex_forces: torch.Tensor
    gravity: torch.Tensor

    @staticmethod
    def from_spec(loads, dtype, device) -> "LoadTables":
        def i(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

        def f(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device).to(dtype)

        return LoadTables(
            i(loads.pressure_faces), f(loads.pressures),
            i(loads.traction_faces), f(loads.tractions),
            i(loads.edges), f(loads.edge_tractions),
            i(loads.vertices), f(loads.vertex_forces),
            f(loads.gravity),
        )


def external_loads(coords, ndof, elnodes, loads: LoadTables, density):
    """Global load vector (length ``ndof``, padding included), Gauss-point
    coordinates, volume and load sums, all on the original geometry
    (elastic assembly, ``fcVM.py:647-767``).  The follower loads of the GNL
    tangent come with the GNL port."""
    glv, gp_coords, volume = asm.gravity_load_and_gp_coords(
        coords, elnodes, density, loads.gravity, ndof)
    glv = glv + asm.pressure_face_loads(coords, loads.pressure_faces, loads.pressures, ndof)
    glv = glv + asm.uniform_face_loads(coords, loads.traction_faces, loads.tractions, ndof)
    glv = glv + asm.edge_loads(coords, loads.edges, loads.edge_tractions, ndof)
    glv = glv + asm.vertex_loads(loads.vertices, loads.vertex_forces, ndof)
    loadsums = glv.reshape(-1, 3).sum(dim=0)
    return glv, gp_coords, volume, loadsums


def assemble_elastic(coords, elnodes, dmat, loads: LoadTables, density, fixmask, u_fix):
    """Elastic blocks (ne, 30, 30) in user element order, nodal block-Jacobi
    inverses, loads and the elastic RHS (``calcGSM``, ``fcVM.py:620-816``).

    Returns (esm, pinv, glv, rhs, gp_coords, volume, loadsums)."""
    esm = asm.elastic_stiffness_blocks(coords, elnodes, dmat)
    pinv = asm.block_jacobi_inverse_blocks(esm, elnodes, fixmask)
    glv, gp_coords, volume, loadsums = external_loads(
        coords, fixmask.shape[0], elnodes, loads, density)
    rhs = asm.dirichlet_rhs(esm, asm.element_dof_ids(elnodes), fixmask, u_fix, glv)
    return esm, pinv, glv, rhs, gp_coords, volume, loadsums


class SolveSpace(NamedTuple):
    """Morton-ordered solve space: the node/element numbering CG runs in.

    The two-level preconditioner aggregates index-contiguous node ranges,
    which must be spatially compact; rather than renumbering the user's
    mesh (Gauss-point order is part of the results), the linear solves
    permute into a Morton node numbering with elements sorted to match.

    Fields:
      nperm: (nn_pad,) original padded-node id at each Morton slot.
      npos: (nn_pad,) Morton slot of each original padded node.
      eperm: (ne,) solver element order (ascending min Morton slot).
      elnodes_m: (ne, 10) Morton node ids, ``eperm``-sorted.
      eldofs_m: (ne, 30) the matching dof ids.
      fixmask_m: (ndof_pad,) fixmask in Morton numbering.
      coords_m: (nn, 3) coordinates in Morton numbering.
    """

    nperm: torch.Tensor
    npos: torch.Tensor
    eperm: torch.Tensor
    elnodes_m: torch.Tensor
    eldofs_m: torch.Tensor
    fixmask_m: torch.Tensor
    coords_m: torch.Tensor

    def to_m(self, v):
        return v.reshape(-1, 3)[self.nperm].reshape(-1)

    def from_m(self, v):
        return v.reshape(-1, 3)[self.npos].reshape(-1)


def build_solve_space(coords_np, elnodes_np, fixmask, ndof_pad: int) -> SolveSpace:
    """Build the Morton solve space (one host argsort per analysis)."""
    dev, dtype = fixmask.device, fixmask.dtype
    nn = len(coords_np)
    nn_pad = ndof_pad // 3
    perm = np.concatenate([morton_perm(np.asarray(coords_np)), np.arange(nn, nn_pad)])
    npos = np.empty(nn_pad, dtype=np.int64)
    npos[perm] = np.arange(nn_pad)
    elnodes_m = npos[np.asarray(elnodes_np)]
    eperm = np.argsort(elnodes_m.min(axis=1), kind="stable")
    elnodes_m = torch.as_tensor(elnodes_m[eperm], device=dev)
    perm_t = torch.as_tensor(perm, device=dev)
    return SolveSpace(
        perm_t,
        torch.as_tensor(npos, device=dev),
        torch.as_tensor(eperm, device=dev),
        elnodes_m,
        asm.element_dof_ids(elnodes_m),
        fixmask.reshape(nn_pad, 3)[perm_t].reshape(-1),
        torch.as_tensor(np.asarray(coords_np)[perm[:nn]], device=dev).to(dtype),
    )


class Operator(NamedTuple):
    """``K_hat`` in the solve space: its blocks, Morton-ordered and
    element-major (30, 30, ne), and the matvec over them.  Calling it
    applies the matvec."""

    esm_t: torch.Tensor
    matvec: Callable

    def __call__(self, v):
        return self.matvec(v)


def make_operator(esm, space: SolveSpace) -> Operator:
    """``K_hat @ v`` in the solve space over the user-order blocks ``esm``
    (ne, 30, 30): the blocks are permuted to the Morton element order and
    stored element-major (30, 30, ne) here, once."""
    esm_t = esm[space.eperm].permute(1, 2, 0).contiguous()
    return Operator(esm_t, asm.make_bc_matvec(esm_t, space.eldofs_m, space.fixmask_m))


def build_precond(esm, cluster_size: int, space: SolveSpace, n_modes: int):
    """Two-level preconditioner on the Morton-permuted operator."""
    return build_two_level(esm[space.eperm], space.elnodes_m, space.coords_m,
                           space.fixmask_m, cluster_size=cluster_size,
                           n_modes=n_modes)


def solve_displacement(khat, pc, b, rtol, maxiter: int, space: SolveSpace,
                       x0=None, defl=None) -> slv.CGResult:
    """PCG solve of ``K_hat x = b`` in the solve space (replaces the
    reference's ``factor(f)``); ``b``, ``x0`` and the returned ``x`` are in
    user dof order.  Seeding ``x0`` with the prescribed displacements makes
    the fixed dofs exact from iteration zero.  ``defl`` (a
    :class:`fcvm_tpu_torch.ops.deflation.DeflationSpace` in the solve space)
    adds the Ritz correction to the preconditioner."""
    res = slv.pcg(khat, space.to_m(b),
                  precond=dfl.deflated(lambda r: apply_precond(pc, r), defl),
                  x0=None if x0 is None else space.to_m(x0), rtol=rtol,
                  maxiter=maxiter)
    return res._replace(x=space.from_m(res.x))


def solve_displacement_harvest(khat, pc, b, rtol, maxiter: int, space: SolveSpace,
                               x0=None, nstore: int = dfl.NSTORE):
    """Undeflated :func:`solve_displacement` that records its Lanczos
    byproducts (a harvest runs only when no deflation space is held).

    Returns ``(CGResult, HarvestData)``; the harvested ``zs`` live in the
    solve space, as the deflation space built from them does."""
    res, h = slv.pcg_harvest(
        khat, space.to_m(b), precond=lambda r: apply_precond(pc, r),
        x0=None if x0 is None else space.to_m(x0), rtol=rtol, maxiter=maxiter,
        nstore=nstore)
    return res._replace(x=space.from_m(res.x)), h


def build_deflation(khat: Operator, space: SolveSpace, zs, coef) -> dfl.DeflationSpace:
    """Deflation space from harvested residuals ``zs`` and Ritz
    coefficients ``coef``, on the operator ``khat``, in the solve space."""
    return dfl.build_space(khat.esm_t, space.eldofs_m, space.fixmask_m, zs, coef)


def residual(coords, elnodes, dmat, sig_yield, disp_new, du, sig_old, e, nu,
             et_e, glv, fixmask, lbd1, qnorm, relax=1.0):
    """Stress update + out-of-balance residual (``fcVM.py:1323-1342``).

    The returned ``r`` is pre-scaled by the relaxation factor (applied at
    the solve RHS, ``fcVM.py:1398-1400``); ``error`` (a 0-dim tensor) is
    computed from the raw residual as the reference does."""
    sig_new, sig_test, pgp, qin = update_stress_load(
        coords, elnodes, dmat, sig_yield, disp_new, du, sig_old, e, nu, et_e)
    r = fixmask * (lbd1 * glv - qin)
    error = torch.linalg.vector_norm(r) / qnorm
    return sig_new, sig_test, pgp, qin, relax * r, error


def residual_refined(coords, elnodes, dmat, sig_yield, disp_new, du, sig_old, e,
                     nu, et_e, glv, fixmask, lbd1, qnorm, relax=1.0):
    """:func:`residual` evaluated in float64 over float32-stored state.

    The mixed-precision refinement tier (``config.residual_refinement``):
    every input is upcast and the stress update and out-of-balance force
    are computed in float64, which removes the float32 evaluation floor of
    ``B^T sigma``.  Returns the Gauss state, the internal force and the CG
    right-hand side in the storage dtype of ``glv`` (the operator and the
    correction solve stay float32) and the error as a float64 scalar."""
    f64 = torch.float64
    out_dt = glv.dtype

    def c(x):
        return x.to(f64)

    sig_new, sig_test, pgp, qin = update_stress_load(
        c(coords), elnodes, c(dmat), c(sig_yield), c(disp_new), c(du), c(sig_old),
        e, nu, et_e)
    r = c(fixmask) * (c(lbd1) * c(glv) - qin)
    error = torch.linalg.vector_norm(r) / qnorm
    return (sig_new.to(out_dt), sig_test.to(out_dt), pgp, qin.to(out_dt),
            (relax * r).to(out_dt), error)


def _nonzero(x):
    return torch.where(x == 0.0, torch.ones_like(x), x)


def _dot(x, y):
    """``x . y`` in the wider of the two dtypes (a refined float64 increment
    meets float32 solve vectors, as JAX promotes)."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.dot(x.to(dt), y.to(dt))


def riks_update(a, ue, due, du, lbd0, lbd1):
    """Arc-length load correction + increment scale-back
    (``fcVM.py:1414-1434``).

    ``lbd0``/``lbd1`` (numbers or 0-dim tensors) take the dtype of the load
    correction, as the JAX package's weakly typed Python floats do: float32
    in a float32 run, float64 once the Riks control vector is a refined
    float64 increment.  Returns (du, lbd1, dl).  A zero increment
    (``|du| = 0``) skips the scale-back instead of dividing by zero as the
    reference does."""
    dl = -_dot(a, due) / _nonzero(_dot(a, ue))
    lbd0 = torch.as_tensor(lbd0, dtype=dl.dtype, device=dl.device)
    lbd1 = torch.as_tensor(lbd1, dtype=dl.dtype, device=dl.device) + dl
    aa = torch.linalg.vector_norm(a)
    du = du + due + dl * ue.to(dl.dtype)
    uu = torch.linalg.vector_norm(du)
    sf = torch.where(uu > 0.0, torch.clamp(aa / _nonzero(uu), max=1.0),
                     torch.ones_like(uu))
    lbd1 = lbd0 + sf * (lbd1 - lbd0)
    return du * sf, lbd1, dl


def record_step_stats(disp_new, csr, peeq, pressure, svm, triax, ecr):
    """Converged-step history scalars (``fcVM.py:1539-1557``), all inputs in
    user Gauss order so argmax ties break like ``np.argmax`` (first max).

    Returns a tuple of 0-dim tensors: (un_max, maxloc, csr@loc,
    pressure@loc, svm@loc, triax@loc, ecr@loc, peeq@loc, peeq_max)."""
    un = torch.sqrt((disp_new.reshape(-1, 3) ** 2).sum(dim=1).max())
    csr_f = csr.reshape(-1)
    loc = torch.argmax(csr_f)
    return (un, loc, csr_f[loc], pressure.reshape(-1)[loc], svm.reshape(-1)[loc],
            triax.reshape(-1)[loc], ecr.reshape(-1)[loc], peeq.reshape(-1)[loc],
            peeq.max())


def commit_step(disp_new, du, factor):
    """Converged-step commit: total displacement update + the adaptively
    scaled next increment (``fcVM.py:1515-1537``)."""
    return disp_new + du, du * factor
