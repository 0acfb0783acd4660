"""Whole-system composites of the collapse analysis.

The port of the :mod:`fcvm_tpu.runtime.system` functions on the driver's
call chain: elastic assembly, the Morton solve space, the preconditioner
build, the PCG solve (plain, deflated or harvesting), the deflation-space
build and its re-Galerkin on a new operator, the residual (and its float64
refinement over float32 state), the geometrically nonlinear tangent refresh
(tangent blocks, follower loads, block-Jacobi rebuild, tangent predictor
solve), the Riks and Crisfield arc-length updates and the converged-step
records.  JAX compiles each of these into one device program, and fuses a
Newton iteration's solve, Riks update and residual into another; here they
are plain functions on tensors, which the driver calls one after the other,
and the operator's element blocks are formed by K3 in the solve space's
element order (:func:`assemble_operator`, :func:`tangent_refresh`), stored
element-major and, on the card, as K1's packed tiles from the same launch,
once per operator (:func:`make_operator`), not on every solve; the
block-Jacobi rebuild is K5, one launch on the compact diagonal K3 writes
beside them.  Every fixed set of keys
of a node sum (the elements', the load tables', the block-Jacobi rebuild's)
gets its K8 segment plan once, here or on the backend.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from fcvm_tpu_torch.ops import assembly as asm
from fcvm_tpu_torch.ops import deflation as dfl
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import material as mat
from fcvm_tpu_torch.ops import solver as slv
from fcvm_tpu_torch.ops.kernels import NodeIncidence, SegmentPlan
from fcvm_tpu_torch.ops.precond import (bound_precond, build_two_level, rebuilds_jacobi,
                                         refresh_blocks)
from fcvm_tpu_torch.ops.stress_update import update_stress_load
from fcvm_tpu_torch.utils.ordering import morton_perm


class LoadTables(NamedTuple):
    """Device-side load tables (see :class:`fcvm_tpu_torch.models.spec.Loads`),
    each node table with its K8 segment plan (of the write form, into the
    ``ndof`` of :meth:`from_spec`)."""

    pressure_faces: torch.Tensor
    pressures: torch.Tensor
    traction_faces: torch.Tensor
    tractions: torch.Tensor
    edges: torch.Tensor
    edge_tractions: torch.Tensor
    vertices: torch.Tensor
    vertex_forces: torch.Tensor
    gravity: torch.Tensor
    pressure_plan: SegmentPlan
    traction_plan: SegmentPlan
    edge_plan: SegmentPlan
    vertex_plan: SegmentPlan

    @staticmethod
    def from_spec(loads, dtype, device, ndof: int) -> "LoadTables":
        def i(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

        def f(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device).to(dtype)

        tables = (i(loads.pressure_faces), i(loads.traction_faces), i(loads.edges),
                  i(loads.vertices))
        return LoadTables(
            tables[0], f(loads.pressures),
            tables[1], f(loads.tractions),
            tables[2], f(loads.edge_tractions),
            tables[3], f(loads.vertex_forces),
            f(loads.gravity),
            *(kernels.segment_plan(t, rows=ndof // 3) for t in tables),
        )


def external_loads(coords, disp, elnodes, loads: LoadTables, density, follower: bool,
                   plan: SegmentPlan):
    """Global load vector (the length of ``disp``, padding included),
    Gauss-point coordinates, volume and load sums; ``plan`` is the segment
    plan of ``elnodes`` (gravity's node sum), built once by the caller.

    ``follower=False``: everything on the original geometry (elastic
    assembly, ``fcVM.py:647-767``).  ``follower=True``: pressure follows the
    deformed surface and gravity integrates on the deformed coordinates
    ``coords + disp``, while uniform face and edge loads stay on the
    original geometry, as the reference's GNL tangent does
    (``fcVM.py:858-938, 962-1009``)."""
    ndof = disp.shape[0]
    coords_def = coords + disp.reshape(-1, 3)[: coords.shape[0]] if follower else coords
    glv, gp_coords, volume = asm.gravity_load_and_gp_coords(
        coords_def, elnodes, density, loads.gravity, ndof, plan=plan)
    glv = glv + asm.pressure_face_loads(coords_def, loads.pressure_faces, loads.pressures, ndof,
                                        loads.pressure_plan)
    glv = glv + asm.uniform_face_loads(coords, loads.traction_faces, loads.tractions, ndof,
                                       loads.traction_plan)
    glv = glv + asm.edge_loads(coords, loads.edges, loads.edge_tractions, ndof, loads.edge_plan)
    glv = glv + asm.vertex_loads(loads.vertices, loads.vertex_forces, ndof, loads.vertex_plan)
    loadsums = glv.reshape(-1, 3).sum(dim=0)
    return glv, gp_coords, volume, loadsums


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
      epos: (ne,) the solver position of each user element (``eperm``'s
        inverse).
      elnodes_m: (ne, 10) Morton node ids, ``eperm``-sorted.
      eldofs_m: (ne, 30) the matching dof ids.
      fixmask_m: (ndof_pad,) fixmask in Morton numbering.
      coords_m: (nn, 3) coordinates in Morton numbering.
      incidence: K1's node table and node-incidence CSR of ``elnodes_m``
        over the ``nn_pad`` Morton nodes
        (:func:`fcvm_tpu_torch.ops.assembly.node_incidence`), built once
        here and shared by every operator of the analysis.
      jacobi_plan: the block-Jacobi rebuild's K8 plan over ``elnodes_m``
        (:func:`fcvm_tpu_torch.ops.assembly.jacobi_plan`), built once here.
    """

    nperm: torch.Tensor
    npos: torch.Tensor
    eperm: torch.Tensor
    epos: torch.Tensor
    elnodes_m: torch.Tensor
    eldofs_m: torch.Tensor
    fixmask_m: torch.Tensor
    coords_m: torch.Tensor
    incidence: NodeIncidence
    jacobi_plan: SegmentPlan

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
        torch.as_tensor(np.argsort(eperm), device=dev),
        elnodes_m,
        asm.element_dof_ids(elnodes_m),
        fixmask.reshape(nn_pad, 3)[perm_t].reshape(-1),
        torch.as_tensor(np.asarray(coords_np)[perm[:nn]], device=dev).to(dtype),
        asm.node_incidence(elnodes_m, nn_pad),
        asm.jacobi_plan(elnodes_m, nn_pad),
    )


class Operator(NamedTuple):
    """``K_hat`` in the solve space: its blocks, Morton-ordered and
    element-major (30, 30, ne) (on the card None where no caller reads them:
    a tangent refresh's, but for the scipy tier), their packed tiles that K1
    reads on the card (K3's, :func:`fcvm_tpu_torch.ops.kernels.pack_blocks`'s
    layout; None on the CPU), the matvec over them, and the elastic
    operator's compact diagonal on the card (K3's, which the two-level
    build's K5 reads; None elsewhere).  Calling it applies the matvec."""

    esm_t: torch.Tensor
    matvec: Callable
    packed: torch.Tensor = None
    diag: torch.Tensor = None

    def __call__(self, v):
        return self.matvec(v)


def make_operator(blocks: asm.Blocks, space: SolveSpace) -> Operator:
    """``K_hat @ v`` in the solve space over ``blocks``
    (:class:`~fcvm_tpu_torch.ops.assembly.Blocks`) in the solve space's
    element order: K3's (its packed tiles, and its element-major blocks
    where formed), or :func:`~fcvm_tpu_torch.ops.assembly.blocks_of` a
    tensor; the compact diagonal is not kept."""
    esm_t, packed = blocks.esm_t, blocks.packed
    return Operator(esm_t, asm.make_bc_matvec(esm_t, space.eldofs_m, space.fixmask_m,
                                              space.incidence, packed), packed)


def assemble_operator(coords, elnodes, dmat, loads: LoadTables, density, fixmask, u_fix,
                      plan: SegmentPlan, space: SolveSpace, table=None):
    """The elastic system (``calcGSM``, ``fcVM.py:620-816``): the operator
    formed by K3 in the solve space's element order (one launch: its
    element-major blocks, which the two-level build reads, and on the card
    K1's packed tiles and the compact diagonal, which the operator keeps
    for the two-level build), K5's nodal block-Jacobi inverses over them
    (user node order), the loads and the elastic right-hand side (user dof
    order); ``plan`` as in :func:`external_loads`, ``table`` the
    user-order element table K3 reads (made on the card when not given).
    The inverses sum each node's blocks in user element order
    (``space.epos`` maps each to its block).

    Returns (khat, pinv, glv, rhs, gp_coords, volume, loadsums): the
    :class:`Operator`, the inverses (nn, 3, 3), the load vector, the
    right-hand side, the Gauss-point coordinates, the volume and the load
    sums."""
    blocks = asm.operator_blocks("elastic", coords, elnodes, dmat=dmat, perm=space.eperm,
                                 table=table, full=True, diag=True)
    khat = make_operator(blocks, space)._replace(diag=blocks.diag)
    pinv = asm.block_jacobi_inverse_blocks(blocks.esm, elnodes, fixmask, cols=space.epos,
                                           diag=blocks.diag)
    glv, gp_coords, volume, loadsums = external_loads(
        coords, torch.zeros_like(u_fix), elnodes, loads, density, follower=False, plan=plan)
    rhs = asm.dirichlet_rhs(khat.esm_t, space.eldofs_m, space.fixmask_m, space.to_m(u_fix),
                            space.to_m(glv), space.incidence, khat.packed)
    return khat, pinv, glv, space.from_m(rhs), gp_coords, volume, loadsums


def operator_precond(khat: Operator, cluster_size: int, space: SolveSpace, n_modes: int,
                     smoother: str = "jacobi3", smoother_cluster_nodes: int = 64):
    """Two-level preconditioner on the blocks ``khat`` holds (formed in the
    solve space's order by :func:`assemble_operator`; on the card its block
    Jacobi from the compact diagonal ``khat`` keeps), with the fine level
    ``smoother`` (see :func:`build_two_level`)."""
    return build_two_level(khat.esm_t.permute(2, 0, 1).contiguous(), space.elnodes_m,
                           space.coords_m, space.fixmask_m, cluster_size=cluster_size,
                           n_modes=n_modes, smoother=smoother,
                           smoother_cluster_nodes=smoother_cluster_nodes, diag=khat.diag)


def solve_displacement(khat, pc, b, rtol, maxiter: int, space: SolveSpace,
                       x0=None, defl=None) -> slv.CGResult:
    """PCG solve of ``K_hat x = b`` in the solve space (replaces the
    reference's ``factor(f)``); ``b``, ``x0`` and the returned ``x`` are in
    user dof order.  Seeding ``x0`` with the prescribed displacements makes
    the fixed dofs exact from iteration zero.  ``defl`` (a
    :class:`fcvm_tpu_torch.ops.deflation.DeflationSpace` in the solve space)
    adds the Ritz correction to the preconditioner."""
    res = slv.pcg(khat, space.to_m(b), precond=bound_precond(pc),
                  x0=None if x0 is None else space.to_m(x0), rtol=rtol,
                  maxiter=maxiter, defl=defl)
    return res._replace(x=space.from_m(res.x))


def solve_displacement_harvest(khat, pc, b, rtol, maxiter: int, space: SolveSpace,
                               x0=None, nstore: int = dfl.NSTORE):
    """Undeflated :func:`solve_displacement` that records its Lanczos
    byproducts (a harvest runs only when no deflation space is held).

    Returns ``(CGResult, HarvestData)``; the harvested ``zs`` live in the
    solve space, as the deflation space built from them does."""
    res, h = slv.pcg_harvest(
        khat, space.to_m(b), precond=bound_precond(pc),
        x0=None if x0 is None else space.to_m(x0), rtol=rtol, maxiter=maxiter,
        nstore=nstore)
    return res._replace(x=space.from_m(res.x)), h


def regalerkin_deflation(khat: Operator, space: SolveSpace, w) -> dfl.DeflationSpace:
    """The basis ``w`` (ndof, k) with ``(W^T K_hat W)^+`` on the operator
    ``khat``: one block matvec and the PSD pseudo-inverse.  A tangent
    refresh re-Galerkins a held basis on the new operator this way (a stale
    Galerkin stays SPD but deflates the wrong scales)."""
    return dfl.DeflationSpace(w, dfl.pinv_psd(dfl.galerkin(
        khat.esm_t, space.eldofs_m, space.fixmask_m, w, space.incidence, khat.packed)))


def build_deflation(khat: Operator, space: SolveSpace, zs, coef) -> dfl.DeflationSpace:
    """Deflation space from harvested residuals ``zs`` and Ritz
    coefficients ``coef``, on the operator ``khat``, in the solve space."""
    return dfl.build_space(khat.esm_t, space.eldofs_m, space.fixmask_m, zs, coef,
                           space.incidence, khat.packed)


def residual_kernel(elnodes, dmat, e, nu, et_e, fixmask, weights=None, *, plan: SegmentPlan,
                    table=None):
    """The residual of one mesh, material (``e``, ``nu``: numbers or
    per-element tensors), hardening ratio ``et_e`` and mask, bound once:
    :func:`fcvm_tpu_torch.ops.kernels.stress_residual_bound` with the
    moduli ``update_stress_load`` forms, ``k2(coords, disp, du, sig_old,
    sig_yield, glv, lbd1, qnorm, large_disp, relax)``.  A backend keeps one
    for each ``et_e`` (and the refinement tier's float64), so on the card a
    residual is two launches and nothing else."""
    e, nu = mat.per_gauss(e), mat.per_gauss(nu)
    return kernels.stress_residual_bound(
        elnodes, plan, fixmask, dmat, mat.shear_modulus(e, nu), mat.hardening_modulus(e, et_e),
        weights=weights, table=table)


def residual(coords, elnodes, dmat, sig_yield, disp_new, du, sig_old, e, nu,
             et_e, glv, fixmask, lbd1, qnorm, large_disp=False, relax=1.0,
             weights=None, reduce=None, *, plan: SegmentPlan, table=None, k2=None):
    """Stress update + out-of-balance residual (``fcVM.py:1323-1342``).

    The returned ``r`` is pre-scaled by the relaxation factor (applied at
    the solve RHS, ``fcVM.py:1398-1400``); ``error`` (a 0-dim tensor) is
    computed from the raw residual as the reference does.  ``weights``,
    ``reduce``, ``plan`` and ``table`` go to the internal force (the sharded
    backend's padding elements and ``all_reduce``, the node sum's segment
    plan, the element pass's node table, :func:`update_stress_load`).
    Without ``reduce`` all of it is K2's two passes (``k2``, the
    :func:`residual_kernel` of these arguments, made here when not given;
    ``lbd1`` a number); with it, the stress update and internal force of
    :func:`update_stress_load`, the sum and the residual's torch steps."""
    if reduce is None:
        k2 = k2 or residual_kernel(elnodes, dmat, e, nu, et_e, fixmask, weights, plan=plan,
                                   table=table)
        return k2(coords, disp_new, du, sig_old, sig_yield, glv, lbd1, qnorm, large_disp, relax)
    sig_new, sig_test, pgp, qin = update_stress_load(
        coords, elnodes, dmat, sig_yield, disp_new, du, sig_old, e, nu, et_e, large_disp,
        weights=weights, reduce=reduce, plan=plan, table=table)
    r = fixmask * (lbd1 * glv - qin)
    error = torch.linalg.vector_norm(r) / qnorm
    return sig_new, sig_test, pgp, qin, relax * r, error


def residual_refined(coords, elnodes, dmat, sig_yield, disp_new, du, sig_old, e,
                     nu, et_e, glv, fixmask, lbd1, qnorm, large_disp=False, relax=1.0,
                     weights=None, reduce=None, *, plan: SegmentPlan, table=None, k2=None):
    """:func:`residual` evaluated in float64 over float32-stored state.

    The mixed-precision refinement tier (``config.residual_refinement``):
    every input is upcast and the stress update and out-of-balance force
    are computed in float64, which removes the float32 evaluation floor of
    ``B^T sigma``.  Returns the Gauss state, the internal force and the CG
    right-hand side in the storage dtype of ``glv`` (the operator and the
    correction solve stay float32) and the error as a float64 scalar.
    ``k2``: the float64 :func:`residual_kernel` (of the upcast material and
    mask), made here when not given."""
    f64 = torch.float64
    out_dt = glv.dtype

    def c(x):  # numbers (one material's E and nu) stay as they are
        return x.to(f64) if torch.is_tensor(x) else x

    if reduce is None:
        k2 = k2 or residual_kernel(elnodes, c(dmat), c(e), c(nu), et_e, c(fixmask), c(weights),
                                   plan=plan, table=table)
        sig_new, sig_test, pgp, qin, r, error = k2(
            c(coords), c(disp_new), c(du), c(sig_old), c(sig_yield), c(glv), lbd1, qnorm,
            large_disp, relax)
    else:
        sig_new, sig_test, pgp, qin = update_stress_load(
            c(coords), elnodes, c(dmat), c(sig_yield), c(disp_new), c(du), c(sig_old),
            c(e), c(nu), et_e, large_disp, weights=c(weights), reduce=reduce, plan=plan,
            table=table)
        r = c(fixmask) * (c(lbd1) * c(glv) - qin)
        error = torch.linalg.vector_norm(r) / qnorm
        r = relax * r
    return (sig_new.to(out_dt), sig_test.to(out_dt), pgp, qin.to(out_dt), r.to(out_dt), error)


def tangent_refresh(coords, elnodes, dmat, sig_old, pgp, disp_new, loads: LoadTables,
                    density, u_fix, g, h, rtol, maxiter: int, pc, space: SolveSpace,
                    ue0=None, w=None, solve_predictor: bool = True, *,
                    plan: SegmentPlan, table=None, full: bool = False):
    """GNL tangent refresh: tangent blocks on the deformed geometry,
    follower loads, block-Jacobi rebuild and the tangent predictor solve
    (``calcTSM``, re-factorisation and ``ue = K_t^-1 f``,
    ``fcVM.py:1351-1396``).

    The blocks are formed by K3 directly in the solve space's element order
    on ``coords`` moved by ``disp_new`` (the Gauss state ``sig_old``/``pgp``,
    and per-element ``dmat`` (ne, 6, 6), ``g`` and ``h`` (ne,), come in user
    order, and K3 reads them, and the user-order element ``table``, at each
    block's element); on the card as K1's packed tiles and the compact
    diagonal, unless ``full`` asks for the element-major blocks too (the
    scipy tier reads them); the two-level coarse correction of ``pc`` is
    kept and only the nodal blocks are rebuilt, by K5 from that diagonal
    (:func:`refresh_blocks`; a cluster smoother is kept as well, nothing is
    rebuilt and no diagonal is formed).  A float64 ``disp_new`` (the
    refinement tier's) is cast to the storage dtype of ``coords``: the
    tangent operator stays in it.

    The predictor is warm-started from the previous predictor ``ue0`` (two
    successive tangents differ by one Newton update).  ``w``, a load-rhs
    harvested Ritz basis in the solve space, is re-Galerkined on the new
    operator and deflates the predictor solve.  With
    ``solve_predictor=False`` no solve runs and ``out`` is the predictor's
    right-hand side in user dof order, for the caller's harvesting solve.
    ``plan`` is the segment plan of ``elnodes`` (the follower gravity).

    Returns ``(khat, pc_t, glv_t, out, iters)``: the tangent
    :class:`Operator`, the refreshed preconditioner, the follower load
    vector, the predictor (user dof order) and its CG count."""
    disp_new = disp_new.to(coords.dtype)
    blocks = asm.operator_blocks("tangent", coords, elnodes, disp=disp_new, dmat=dmat,
                                 sig=sig_old, pgp=pgp, g=g, h=h, perm=space.eperm, table=table,
                                 full=full, diag=rebuilds_jacobi(pc))
    pc_t = refresh_blocks(pc, blocks.esm, space.elnodes_m, space.fixmask_m, space.jacobi_plan,
                          diag=blocks.diag)
    khat = make_operator(blocks, space)
    del blocks
    glv_t, *_ = external_loads(coords, disp_new, elnodes, loads, density, follower=True,
                               plan=plan)
    rhs = asm.dirichlet_rhs(khat.esm_t, space.eldofs_m, space.fixmask_m,
                            space.to_m(u_fix), space.to_m(glv_t), space.incidence, khat.packed)
    if not solve_predictor:
        return khat, pc_t, glv_t, space.from_m(rhs), 0
    defl = None if w is None else regalerkin_deflation(khat, space, w)
    res = slv.pcg(khat, rhs, precond=bound_precond(pc_t),
                  x0=None if ue0 is None else space.to_m(ue0), rtol=rtol, maxiter=maxiter,
                  defl=defl)
    return khat, pc_t, glv_t, space.from_m(res.x), res.iters


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


def riks_update_crisfield(a, ue, due, du, lbd0, lbd1):
    """Spherical (Crisfield) arc-length update, beyond the reference.

    Solves ``|du + due + dl ue|^2 = |a|^2`` for the load correction ``dl``
    and keeps the root whose increment advances along the control vector
    ``a`` (Crisfield 1981); where the sphere is out of reach, the stationary
    point.  Unlike :func:`riks_update` it can follow a snapback fold.
    ``lbd0`` is unused (the signature of :func:`riks_update`).  Every
    product runs in the widest dtype of the vectors, as JAX promotes.
    Returns (du, lbd1, dl)."""
    dt = torch.promote_types(torch.promote_types(du.dtype, due.dtype),
                             torch.promote_types(a.dtype, ue.dtype))
    a, ue = a.to(dt), ue.to(dt)
    p = du.to(dt) + due.to(dt)
    a2 = torch.dot(ue, ue)
    safe_a2 = _nonzero(a2)
    b = 2.0 * torch.dot(p, ue)
    c = torch.dot(p, p) - torch.dot(a, a)
    disc = b * b - 4.0 * a2 * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    dl_hi = (-b + sq) / (2.0 * safe_a2)
    dl_lo = (-b - sq) / (2.0 * safe_a2)
    keep_hi = torch.dot(a, p + dl_hi * ue) >= torch.dot(a, p + dl_lo * ue)
    dl = torch.where(keep_hi, dl_hi, dl_lo)
    dl = torch.where(disc >= 0.0, dl, -b / (2.0 * safe_a2))
    return p + dl * ue, torch.as_tensor(lbd1, dtype=dt, device=dl.device) + dl, dl


def scaled_control_vector(ue, du):
    """The GNL control vector after a tangent refresh,
    ``a = ue |du| / |ue|`` (``fcVM.py:1392-1394``), in the wider dtype of
    the two; ``|ue| = 0`` is guarded as in :func:`riks_update`."""
    dt = torch.promote_types(ue.dtype, du.dtype)
    scale = (torch.linalg.vector_norm(du).to(dt)
             / _nonzero(torch.linalg.vector_norm(ue)).to(dt))
    return ue.to(dt) * scale


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
