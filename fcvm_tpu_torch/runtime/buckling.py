"""Linear (elastic) buckling: ``K v = lambda (-G) v``, matrix-free.

The port of :mod:`fcvm_tpu.runtime.buckling`, with the same names.  The
reference assembles the elastic and geometric matrices and calls ARPACK in
shift-invert mode (``source code/fcVM.py:1199-1214``).  Here the buckling
factors are ``lambda_i = 1 / theta_i`` for the largest eigenvalues
``theta`` of ``K_hat^{-1} (-G_hat)``, found by block subspace iteration
with Rayleigh-Ritz on the (K, -G) pencil (:func:`pencil_subspace`).  Every
operator application is K1m over ``(ndof, m)`` blocks (the node-row
gather, block product and fixed-order node sum of one CUDA kernel pair on
the card, over one packed copy of each operator's blocks and one
incidence table); the inner ``K_hat^{-1}`` solves the ``m`` columns
together with :func:`fcvm_tpu_torch.ops.solver.pcg_block`, each
preconditioner apply on the block one K4m, every solve deflated by one deep
Ritz harvest of the first column (:func:`make_recycled_k_inverse`) inside
K6's passes (``pcg_block(defl=)``).

Boundary conditions: fixed dofs are eliminated exactly by default
(identity rows in K_hat, zero rows in G_hat), the limit the reference's x100
fixed-diagonal penalty approximates (``fcVM.py:1051-1062``);
``FcvmConfig(buckling_bc="penalty")`` reproduces that penalised full pencil.
Eigenvectors are normalised in the (-G) metric, as ARPACK's
M-normalisation, with the largest-magnitude entry made positive.

Float32 robustness is a retry ladder (:func:`buckling_from_arrays`): float32
iteration, float64 iteration on operands re-assembled in float64 (the JAX
package upcasts its float32 blocks instead, whose rounding the slender
bending modes amplify), then the scipy direct tier (at most
``_DIRECT_FAILOVER_MAX_DOF``);
:func:`linear_buckling` instead reruns its whole pipeline in float64.  The
configuration is passed explicitly and never changed: each retry runs on a
``dataclasses.replace`` copy.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from fcvm_tpu_torch.config import FcvmConfig, pin_full_fp32
from fcvm_tpu_torch.ops import assembly as asm
from fcvm_tpu_torch.ops import deflation as dfl
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import solver as slv
from fcvm_tpu_torch.ops.precond import apply_precond, bound_precond, build_two_level
from fcvm_tpu_torch.utils.linalg3 import inv3_spd

# Pencil-residual acceptance bound of pencil_subspace's a-posteriori check:
# a healthy float32 eigenpair sits at ~1e-3 relative or below, the silent
# wrong-factor failure (inner solves at their arithmetic floor) at O(1).
_PENCIL_RESIDUAL_TOL = 0.03

# The last tier of buckling_from_arrays (float64 re-assembly on the host LU)
# and linear_buckling's direct-tier retry run only up to this size.
_DIRECT_FAILOVER_MAX_DOF = 200_000

# The eigensolve's Ritz recycling sizes, the JAX package's defaults
# (``fcvm_tpu.config``: buckling_deflation_nstore, buckling_deflation_k).
# The harvest goes much deeper than the driver's (ops/deflation.py): the
# eigensolve re-solves one operator for m columns over up to 60 sweeps.
NSTORE = 512
RITZ_K = 64

# Inner-solve stagnation exit: each column solve runs to its own arithmetic
# floor and stops STALL iterations later (rtol 1e-10 is below the float32
# floor).
STALL = 100


class EigensolveBreakdownError(RuntimeError):
    """The subspace iteration lost the pencil to arithmetic breakdown.

    Raised when the Rayleigh-Ritz projections come back non-finite, the
    projected ``B = Q^T K Q`` stays indefinite through the ridge ladder, or
    the converged pairs fail the pencil-residual check while a further
    retry tier exists."""


def _recycling_params(ndof: int, itemsize: int):
    """(nstore, k) of the eigensolve's harvest: the (nstore, ndof) buffer
    is capped near 1 GiB on large meshes."""
    nstore = max(dfl.NSTORE, min(NSTORE, int(2**30 // (ndof * itemsize))))
    return nstore, min(RITZ_K, max(nstore // 4, 8))


def make_recycled_k_inverse(kinv, harvest, build_space, k_defl, min_iters, enabled,
                            record=None):
    """The eigensolve's recycled ``K_hat^{-1}``.

    ``kinv(w, defl, x0_basis, x0_scale)`` solves the columns of ``w`` with
    the Ritz warm start ``x0 = x0_basis * x0_scale`` and returns a
    :class:`fcvm_tpu_torch.ops.solver.BlockCGResult`; ``harvest(b)`` is a
    ``pcg_harvest`` of one column; ``build_space(zs, coef)`` builds the
    deflation space.  One harvest (first column, first call) deflates every
    later solve: the operator never changes, so no re-Galerkin is needed.
    ``record`` (a dict), when given, collects the CG iterations of every
    column per call (``inner_iters``) and the harvest (``harvest``)."""
    state = {"defl": None, "tried": not enabled}

    def solve(w, x0_basis, x0_scale):
        res = kinv(w, state["defl"], x0_basis, x0_scale)
        return res.x, res.iters

    def k_inverse(w, x0_basis=None, x0_scale=None):
        if not state["tried"]:
            state["tried"] = True
            res0, h = harvest(w[:, 0])
            kept = 0
            if res0.iters >= min_iters:
                alphas, betas, rzs = torch.stack([h.alphas, h.betas, h.rzs]).cpu().numpy()
                coef = dfl.ritz_coefficients(alphas, betas, rzs, res0.iters, k_defl)
                if coef is not None:
                    state["defl"] = build_space(h.zs, coef)
                    kept = int((np.abs(coef).sum(axis=0) > 0).sum())
            if record is not None:
                record["harvest"] = {"iters": res0.iters, "nstore": h.zs.shape[0], "kept": kept}
            del h
            x, iters = res0.x[:, None], [res0.iters]
            if w.shape[1] > 1:
                rest, it_rest = solve(
                    w[:, 1:], None if x0_basis is None else x0_basis[:, 1:],
                    None if x0_scale is None else x0_scale[1:])
                x, iters = torch.cat([x, rest], dim=1), iters + it_rest
        else:
            x, iters = solve(w, x0_basis, x0_scale)
        if record is not None:
            record["inner_iters"].append(iters)
        return x

    return k_inverse


def _assembled_diagonal(esm, eldofs, ndof: int):
    """(ndof,) assembled diagonal of the element blocks (no BC handling)."""
    d = torch.diagonal(esm, dim1=1, dim2=2).contiguous()
    return kernels.segment_sum(d.reshape(-1), kernels.segment_plan(eldofs, rows=ndof), rows=ndof)


def _penalty_block_jacobi(esm, elnodes, dvec):
    """Inverse 3x3 nodal blocks of the penalised full stiffness (no
    elimination): the assembled nodal diagonal blocks plus ``dvec`` on the
    diagonal.  The preconditioner of the penalty mode's inner CG."""
    ne = esm.shape[0]
    nn = dvec.shape[0] // 3
    idx = torch.arange(10, device=esm.device)
    diag = esm.reshape(ne, 10, 3, 10, 3)[:, idx, :, idx, :]  # (10, ne, 3, 3)
    nodal = kernels.segment_sum(diag.reshape(-1, 3, 3).contiguous(), asm.jacobi_plan(elnodes, nn),
                                rows=nn)
    eye = torch.eye(3, dtype=esm.dtype, device=esm.device)
    return inv3_spd(nodal + eye[None] * dvec.reshape(nn, 3)[:, :, None])


def _assemble_penalty_csc(esm, eldofs, dvec, ndof: int):
    """Full (uneliminated) scipy CSC of the penalised stiffness: every
    element entry plus ``dvec`` on the diagonal (``fcVM.py:1207-1211``)."""
    import scipy.sparse as sp

    esm = esm.detach().cpu().numpy()
    eldofs = eldofs.cpu().numpy()
    rows = np.repeat(eldofs, 30, axis=1).reshape(-1)
    cols = np.tile(eldofs, (1, 30)).reshape(-1)
    k = sp.coo_matrix((esm.reshape(-1), (rows, cols)), shape=(ndof, ndof))
    idx = np.arange(ndof)
    return (k + sp.coo_matrix((dvec.cpu().numpy(), (idx, idx)), shape=(ndof, ndof))).tocsc()


def _penalty_operators(kb, gb, eldofs, elnodes, fixmask, ndof, solver, rtol, maxiter):
    """(kmv, minus_g, k_inverse) of the reference-parity penalty pencil
    (``fcVM.py:1051-1062``) on the stiffness and geometric blocks ``kb`` and
    ``gb``, :class:`~fcvm_tpu_torch.ops.assembly.Blocks` with their
    element-major blocks.  The full stiffness and geometric matrices (no
    Dirichlet elimination) with the fixed K diagonals multiplied by 100 and
    G unpenalised.  No recycling: the mode targets small parity meshes."""
    inc = asm.node_incidence(elnodes, ndof // 3)  # one incidence for both operators
    kfull = asm.make_multi_matvec(kb.esm_t, eldofs, None, incidence=inc, packed=kb.packed)
    minus_g = asm.make_multi_matvec(gb.esm_t, eldofs, None, negate=True, incidence=inc,
                                    packed=gb.packed)
    esm = kb.esm
    diag = _assembled_diagonal(esm, eldofs, ndof)
    empty = (diag == 0).to(diag.dtype)  # dof-alignment padding rows
    dvec_k = 99.0 * diag * (1.0 - fixmask) + empty

    def kmv(u):
        return kfull(u) + dvec_k[:, None] * u

    if solver == "scipy":
        from scipy.sparse.linalg import splu

        lu = splu(_assemble_penalty_csc(esm, eldofs, dvec_k, ndof))

        def k_inverse(w, x0_basis=None, x0_scale=None):
            x = lu.solve(w.detach().cpu().double().numpy())
            return torch.as_tensor(x, device=w.device).to(w.dtype)
    else:
        pinv = _penalty_block_jacobi(esm, elnodes, dvec_k)

        def k_inverse(w, x0_basis=None, x0_scale=None):
            x0 = None if x0_basis is None else x0_basis * x0_scale[None, :]
            return slv.pcg_block(kmv, w, precond=lambda r: asm.apply_block_precond(pinv, r),
                                 x0=x0, rtol=rtol, maxiter=maxiter, stall=STALL).x

    return kmv, minus_g, k_inverse


def buckling_from_arrays(
    coords,
    elnodes,
    dmat,
    sig_gp,
    fixmask,
    k: int = 2,
    rtol: float = 1.0e-8,
    maxiter: int = 2000,
    n_sub: int = 0,
    outer_tol: float = 1.0e-9,
    max_outer: int = 60,
    space=None,
    allow_reassembly: bool = True,
    *,
    config: Optional[FcvmConfig] = None,
    stats: Optional[list] = None,
    v0=None,
    _dtype_override=None,
    _solver_override=None,
):
    """Lowest ``k`` buckling factors and mode shapes.

    Args:
      coords: (nn, 3) nodal coordinates; their dtype is the operands'.
      elnodes: (ne, 10) connectivity; ``dmat`` (6, 6), or (ne, 6, 6) per
        element in the order of ``elnodes``; ``fixmask`` (ndof,) padded, 1
        on free dofs.
      sig_gp: (ne, 4, 6) pre-stress field (elastic stresses under the full
        reference load, ``fcVM.py:1195-1207``).
      space: optional :class:`fcvm_tpu_torch.runtime.system.SolveSpace`: the
        eigensolve then runs in its Morton numbering, mode shapes mapped
        back on return.
      allow_reassembly: whether the last tier (float64 re-assembly on the
        scipy direct tier) may run here; :func:`linear_buckling` passes
        False and reruns its whole pipeline in float64 instead.
      config: the solver configuration (``None`` = ``FcvmConfig()``).
      stats: a list that receives one dict per tier tried (its dtype,
        solver, sweeps, inner CG iterations per sweep, harvest, pencil
        residuals and the error that ended it, if any).
      v0: the (ndof, m) start block in the solve space's numbering, for
        tests; default a seeded normal block (:func:`pencil_subspace`).

    The retry ladder, each step taken on :class:`EigensolveBreakdownError`
    (non-finite projections, an indefinite Rayleigh-Ritz block, or the
    pencil-residual check), each announced by a warning:

    1. float32 iteration on float32-built operands;
    2. float64 iteration on operands re-assembled in float64 from the same
       (upcast) inputs, where the JAX package iterates on the upcast
       float32 blocks;
    3. the same float64 operands with the exact host LU ``K^{-1}`` (scipy),
       only with ``allow_reassembly`` and at most ``_DIRECT_FAILOVER_MAX_DOF``
       dofs; the pre-stress ``sig_gp`` is not recomputed.

    Returns:
      (eigenvalues (k,), eigenvectors (ndof, k)) as numpy arrays, ascending
      buckling factor, eigenvectors in user dof order.
    """
    cfg = config if config is not None else FcvmConfig()
    m = n_sub if n_sub > 0 else max(cfg.n_eig_vectors, 2 * k, k + 4)
    ndof = fixmask.shape[0]
    dtype = _dtype_override if _dtype_override is not None else coords.dtype
    solver = _solver_override or cfg.solver
    f32_built = coords.dtype == torch.float32
    can_reassemble = allow_reassembly and f32_built and ndof <= _DIRECT_FAILOVER_MAX_DOF
    # allow_reassembly=False promises that the caller catches the breakdown
    # and reruns its whole pipeline in float64
    caller_escalates = (not allow_reassembly) and f32_built
    retry = dict(k=k, rtol=rtol, maxiter=maxiter, n_sub=n_sub, outer_tol=outer_tol,
                 max_outer=max_outer, config=cfg, stats=stats, v0=v0)
    elnodes_in, fixmask_in = elnodes, fixmask
    penalty = cfg.buckling_bc == "penalty"
    if penalty:
        space = None  # the penalty pencil runs in the natural dof order
    record = {"dtype": str(dtype).replace("torch.", ""), "solver": solver, "sweeps": 0,
              "inner_iters": [], "harvest": None, "pencil_residuals": None, "error": None}
    if stats is not None:
        stats.append(record)

    # the float64 tiers assemble the pencil in float64 from the (upcast)
    # float32 inputs: float32-built blocks carry ~1e-7 relative rounding,
    # which the softest bending modes of a slender member amplify (on the
    # 451,875-dof beam-column of chip_smoke.py the factors of the upcast
    # float32 blocks came out 4.7% and 6.3% low, with a pencil residual of 7e-4)
    # K3 forms both pencils in the solve space's element order, each in one
    # launch: K_hat's element-major blocks (the two-level build, the scipy
    # and penalty tiers read them) and, on the card, both operators' packed
    # tiles, which K_hat·V, -G_hat·V, the harvest's K_hat·v and the
    # deflation build share; G_hat's element-major blocks only for the
    # penalty pencil (and on the CPU, whose plain versions read them); K_hat's
    # compact diagonal where the CG tier's block Jacobi (K5) reads it
    perm = None if space is None else space.eperm
    kb = asm.operator_blocks("elastic", coords.to(dtype), elnodes, dmat=dmat.to(dtype),
                             perm=perm, full=True, diag=not penalty and solver != "scipy")
    gb = asm.operator_blocks("geometric", coords.to(dtype), elnodes, sig=sig_gp.to(dtype),
                             perm=perm, full=penalty)
    esm = kb.esm  # (ne, 30, 30), a view
    coords_work = coords
    if space is not None:
        elnodes, fixmask, coords_work = space.elnodes_m, space.fixmask_m, space.coords_m
    fixmask, coords_work = fixmask.to(dtype), coords_work.to(dtype)
    eldofs = asm.element_dof_ids(elnodes)
    ladder_top = dtype == torch.float32

    if penalty:
        kmv, minus_g, k_inverse = _penalty_operators(kb, gb, eldofs, elnodes, fixmask,
                                                     ndof, solver, rtol, maxiter)
        del esm, kb, gb
        try:
            return pencil_subspace(
                kmv, minus_g, k_inverse, ndof, dtype, k, m, outer_tol, max_outer,
                fixmask=None, last_tier=not (ladder_top or caller_escalates), v0=v0,
                device=fixmask.device, record=record)
        except EigensolveBreakdownError as err:
            record["error"] = str(err)
            if not ladder_top:
                raise
            warnings.warn("f32 penalty-BC buckling eigensolve broke down; retrying "
                          "the iteration in float64 on operands re-assembled in float64")
            return buckling_from_arrays(
                coords, elnodes_in, dmat, sig_gp, fixmask_in, space=None,
                allow_reassembly=allow_reassembly, _dtype_override=torch.float64, **retry)

    esm_t, packed, diag = kb
    # one incidence table, shared by K_hat·V, -G_hat·V, the harvest's
    # K_hat·v and the deflation build
    inc = space.incidence if space is not None else asm.node_incidence(elnodes, ndof // 3)
    kmv = asm.make_multi_matvec(esm_t, eldofs, fixmask, incidence=inc, packed=packed)
    minus_g = asm.make_multi_matvec(gb.esm_t, eldofs, fixmask, identity_on_fixed=False,
                                    negate=True, incidence=inc, packed=gb.packed)
    del gb

    if solver == "scipy":
        # the reference's direct tier (fcVM.py:1263-1278): an exact K^-1
        direct = slv.ScipyDirectSolver(esm, eldofs, fixmask, ndof)

        def k_inverse(w, x0_basis=None, x0_scale=None):
            return direct.solve(w)  # exact: the Ritz warm start has nothing to seed
    else:
        if cfg.precond == "two_level":
            pc = build_two_level(esm.contiguous(), elnodes, coords_work, fixmask,
                                 cluster_size=cfg.resolve_cluster_size(coords.shape[0]),
                                 n_modes=cfg.coarse_modes, smoother=cfg.smoother,
                                 smoother_cluster_nodes=cfg.smoother_cluster_nodes, diag=diag)
        else:
            pc = asm.block_jacobi_inverse_blocks(esm, elnodes, fixmask, diag=diag)
        nstore, k_defl = _recycling_params(ndof, esm.element_size())
        kv = asm.make_bc_matvec(esm_t, eldofs, fixmask, incidence=inc, packed=packed)

        def prec(r):
            return apply_precond(pc, r)

        def kinv(w, defl, x0_basis, x0_scale):
            x0 = None if x0_basis is None else x0_basis * x0_scale[None, :]
            return slv.pcg_block(kmv, w, precond=prec, x0=x0, rtol=rtol, maxiter=maxiter,
                                 stall=STALL, defl=defl)

        def harvest(b):
            return slv.pcg_harvest(kv, b, precond=bound_precond(pc), rtol=rtol, maxiter=maxiter,
                                   nstore=nstore, stall=STALL)

        k_inverse = make_recycled_k_inverse(
            kinv, harvest,
            lambda zs, coef: dfl.build_space(esm_t, eldofs, fixmask, zs, coef, inc, packed),
            k_defl, cfg.deflation_min_iters, cfg.deflation, record=record)
    del esm, kb, diag

    try:
        lam, vecs = pencil_subspace(
            kmv, minus_g, k_inverse, ndof, dtype, k, m, outer_tol, max_outer,
            fixmask=fixmask, last_tier=not (ladder_top or can_reassemble or caller_escalates),
            v0=v0, record=record)
    except EigensolveBreakdownError as err:
        record["error"] = str(err)
        if ladder_top:
            warnings.warn(f"f32 buckling eigensolve broke down ({err}); retrying the "
                          "iteration in float64 on operands re-assembled in float64")
            return buckling_from_arrays(
                coords, elnodes_in, dmat, sig_gp, fixmask_in, space=space,
                allow_reassembly=allow_reassembly, _dtype_override=torch.float64,
                _solver_override=_solver_override, **retry)
        if not can_reassemble:
            raise
        # the float64 iteration still fails: solve with the exact host LU,
        # the reference's own pipeline
        warnings.warn(f"f64 iterative buckling eigensolve still invalid ({err}); "
                      "re-assembling the pencil in float64 on the host-direct tier "
                      "(exact splu K^-1)")
        f64 = torch.float64
        return buckling_from_arrays(
            coords.to(f64), elnodes_in, dmat.to(f64), sig_gp.to(f64), fixmask_in,
            space=space, allow_reassembly=True, _dtype_override=f64,
            _solver_override="scipy", **retry)
    if space is not None:
        vecs = vecs.reshape(-1, 3, k)[space.npos.cpu().numpy()].reshape(-1, k)
    return lam, vecs


def pencil_subspace(kmv, minus_g, k_inverse, ndof, dtype, k, m, outer_tol=1.0e-9,
                    max_outer=60, fixmask=None, last_tier=False, v0=None, device=None,
                    record=None):
    """Block subspace iteration with Rayleigh-Ritz on the (K, -G) pencil.

    Operator-parametrised: ``kmv`` and ``minus_g`` apply ``K_hat`` and
    ``-G_hat`` to (ndof, m) blocks, ``k_inverse(w, x0_basis, x0_scale)``
    solves ``K_hat X = W``.  The QR and the (m, m) projections run on the
    device in ``dtype``; the small generalized ``eigh`` on the host (scipy).

    The start block is ``v0`` or a standard normal (ndof, m) block from a
    CPU ``torch.Generator`` seeded 0 (the same numbers on every device).
    ``outer_tol`` is a Cauchy test on theta, not floored by dtype: in
    float32 the loop may run all ``max_outer`` sweeps, cheaply, because the
    Ritz warm start makes converged columns re-solve in a few iterations.
    ``record`` (a dict), when given, receives ``sweeps`` and
    ``pencil_residuals``.
    """
    import scipy.linalg

    if device is None:
        device = fixmask.device if fixmask is not None else torch.device("cpu")
    if v0 is None:
        v = torch.randn((ndof, m), generator=torch.Generator().manual_seed(0), dtype=dtype)
    else:
        v = torch.as_tensor(v0)
    v = v.to(device=device, dtype=dtype)
    if fixmask is not None:
        v = fixmask[:, None] * v

    theta_old = None
    theta_full = None
    for sweep in range(max_outer):
        # Ritz warm start: K^-1 (-G) v_i ~ theta_i v_i after Rayleigh-Ritz
        if theta_full is None:
            z = k_inverse(minus_g(v))
        else:
            z = k_inverse(minus_g(v), x0_basis=v,
                          x0_scale=torch.as_tensor(theta_full, dtype=dtype, device=device))
        # Euclidean orthonormalisation keeps the projection well conditioned
        q = torch.linalg.qr(z).Q
        ab = torch.stack([q.T @ minus_g(q), q.T @ kmv(q)]).cpu().numpy()
        a_small, b_small = ab[0], ab[1]
        if record is not None:
            record["sweeps"] = sweep + 1
        if not (np.isfinite(a_small).all() and np.isfinite(b_small).all()):
            raise EigensolveBreakdownError(
                "non-finite Rayleigh-Ritz projection (a diverged inner "
                f"solve poisoned the subspace block) at dtype {dtype}")
        b_small = 0.5 * (b_small + b_small.T)
        a_small = 0.5 * (a_small + a_small.T)
        # rounding can leave B = Q^T K Q marginally indefinite: escalate a
        # relative ridge (it biases the Ritz values by O(ridge / diag))
        scale = max(float(np.mean(np.abs(np.diag(b_small)))), 1e-300)
        for ridge in (0.0, 1e-6, 1e-4, 1e-2):
            try:
                theta, c = scipy.linalg.eigh(
                    a_small, b_small + (ridge * scale) * np.eye(len(b_small)))
                break
            except np.linalg.LinAlgError as err:
                if ridge == 1e-2:
                    raise EigensolveBreakdownError(
                        "projected Q^T K Q stayed indefinite through the "
                        f"ridge ladder at dtype {dtype}: {err}") from err
        order = np.argsort(theta)[::-1]
        theta = theta[order]
        c = c[:, order]
        v = q @ torch.as_tensor(c, dtype=dtype, device=device)
        theta_full = theta
        if theta_old is not None:
            denom = np.maximum(np.abs(theta[:k]), 1e-300)
            if np.max(np.abs(theta[:k] - theta_old[:k]) / denom) < outer_tol:
                break
        theta_old = theta

    lam = 1.0 / theta[:k]
    vk = v[:, :k].contiguous()
    vecs = vk.cpu().numpy().copy()
    # A-posteriori pencil-residual check, ||K v - lam (-G) v|| / ||K v|| per
    # pair: the Cauchy test only shows that the subspace stopped moving;
    # float32 inner solves at their floor can settle on a non-eigenpair.
    kv_chk = kmv(vk).cpu().numpy()
    gv_chk = minus_g(vk).cpu().numpy()
    num = np.linalg.norm(kv_chk - gv_chk * lam[None, :], axis=0)
    den = np.maximum(np.linalg.norm(kv_chk, axis=0), 1e-300)
    rel_res = num / den
    if record is not None:
        record["pencil_residuals"] = rel_res.tolist()
    if np.max(rel_res) > _PENCIL_RESIDUAL_TOL:
        msg = (f"pencil residual validation failed at dtype {dtype}: "
               f"max ||Kv - lam(-G)v||/||Kv|| = {np.max(rel_res):.2e} "
               f"(factors {lam}) — the subspace converged onto a "
               "non-eigenpair (inner solves at their arithmetic floor)")
        if not last_tier:
            raise EigensolveBreakdownError(msg)
        warnings.warn(msg)  # no further tier to retry in
    # (-G)-metric normalisation (ARPACK's M-normalisation), sign rule
    for i in range(k):
        s = float(vecs[:, i] @ gv_chk[:, i])
        if s > 0:
            vecs[:, i] /= np.sqrt(s)
        imax = int(np.argmax(np.abs(vecs[:, i])))
        if vecs[imax, i] < 0:
            vecs[:, i] = -vecs[:, i]
    return np.asarray(lam), vecs


def linear_buckling(model, params, k: int = 2, config: Optional[FcvmConfig] = None):
    """Buckling factors and modes of a :class:`fcvm_tpu_torch.models.spec.Model`.

    The reference's pre-stress pipeline: elastic solve under the full load,
    elastic stress recovery, then the pencil eigensolve.  When the float32
    eigensolve breaks down (its float64-iteration retry included), the
    whole pipeline reruns in float64, the elastic pre-stress solve too, on
    the scipy direct tier where the mesh has at most
    ``_DIRECT_FAILOVER_MAX_DOF`` dofs.  ``config`` is not changed.

    Returns (factors (k,), modes (ndof, k)) as numpy arrays.
    """
    cfg = config if config is not None else FcvmConfig()
    try:
        return _linear_buckling_impl(model, params, k, cfg)
    except EigensolveBreakdownError as err:
        if cfg.resolve_dtype() != torch.float32:
            raise
        direct = cfg.solver != "scipy" and model.mesh.ndof <= _DIRECT_FAILOVER_MAX_DOF
        warnings.warn(f"f32 buckling eigensolve broke down ({err}); retrying the "
                      "pipeline in float64"
                      + (" on the host-direct solver tier" if direct else ""))
        cfg64 = dataclasses.replace(cfg, dtype="float64",
                                    solver="scipy" if direct else cfg.solver)
        return _linear_buckling_impl(model, params, k, cfg64)


def _linear_buckling_impl(model, params, k: int, cfg: FcvmConfig):
    from fcvm_tpu_torch.runtime.backend import TorchSystem

    cfg.check_supported()
    device = cfg.resolve_device()
    dtype = cfg.resolve_dtype()
    pin_full_fp32()
    model.mesh.validate()
    backend = TorchSystem(model, cfg, dtype, device)
    coords = backend.tensor(model.mesh.coords)
    khat, pinv, _, rhs, *_ = backend.assemble_operator(coords)
    if cfg.solver == "scipy":
        ue = backend.scipy_direct(khat)(rhs)
    else:
        ue = backend.solve(khat, backend.operator_pc(khat, pinv), rhs).x
    del pinv, khat
    sig_el, *_ = backend.stress_update(
        coords, backend.gauss_full(1.0e30), torch.zeros_like(ue), ue,
        backend.gauss_zeros((6,)), 0.0)
    lam, vecs = buckling_from_arrays(
        coords, backend.elnodes, backend.dmat, sig_el, backend.fixmask, k=k,
        rtol=min(cfg.cg_rtol, 1.0e-10), maxiter=backend.maxiter, space=backend.space,
        # the float64 re-assembly tier would keep this float32 pre-stress;
        # linear_buckling's own retry reruns the whole pipeline instead
        allow_reassembly=False, config=cfg)
    return lam, vecs[: model.mesh.ndof]
