"""ShardedSystem: the collapse solver's backend over an element partition.

The port of :class:`fcvm_tpu.parallel.system.ShardedSystem`, on
``torch.distributed`` (:mod:`fcvm_tpu_torch.parallel.dist`): one process
per device instead of one process driving a mesh.

* **Elements are partitioned**, in the Morton solve-space order
  (:class:`fcvm_tpu_torch.runtime.system.SolveSpace`), so each rank owns a
  spatially compact slice.  The element tables are padded to a multiple of
  the world size with zero-weight ghost elements that copy Morton element
  0's connectivity; each rank holds only its slice of connectivity,
  materials, element blocks and Gauss state, so element memory divides by
  the world size.
* **Node vectors are replicated.**  Every operator application runs K1's
  raw form (:func:`fcvm_tpu_torch.ops.kernels.khat_matvec`, over the rank's
  own node-incidence table and packed blocks) or K1m's (``khat_matmat``,
  over the same) on the rank's blocks and ends in exactly one
  ``all_reduce`` of the
  ``(ndof_pad,)`` or ``(ndof_pad, k)`` result, then applies the Dirichlet
  mask: the counterpart of the one ``psum``.  The same holds for the
  internal force, the gravity load, the volume, the block-Jacobi blocks
  and the coarse Galerkin table.  (The JAX package's per-shard
  ``ScatterPlan``s, a TPU workaround, are not ported.)
* **The preconditioner** applies replicated; its coarse Galerkin table is
  accumulated per rank and all-reduced.  The cluster smoother is not built:
  the reference's sharded ``make_pc`` builds none either and ignores
  ``smoother="cluster"``; so does this one.
* ``config.node_partition`` runs the whole PCG on each rank's slice of
  Morton node rows: per iteration one ``all_gather`` of the search
  direction and one ``reduce_scatter`` of the element output, with the
  dots, the coarse restriction and the deflation projection all-reduced.

**Ranks agree by determinism.**  Every rank runs the driver's host control
flow (Newton, CG convergence, restarts, harvests), so two ranks that read
different bits would take different branches and hang.  Every value that
decides a branch is computed from all-reduced or broadcast tensors by
operations that are deterministic on a given device (elementwise work,
gathers, reductions, the fixed-order node sums of K1 and K8, cuBLAS and
cuSOLVER products and factorisations, host numpy); no operation uses an
atomic scatter.  The local eigensolve ladder's result is rank 0's,
broadcast (:func:`~fcvm_tpu_torch.parallel.dist.broadcast`).  The tests
assert that all ranks' histories and CG counts are identical.
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from fcvm_tpu_torch.ops import assembly as asm
from fcvm_tpu_torch.ops import deflation as dfl
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import material as mat
from fcvm_tpu_torch.ops import solver as slv
from fcvm_tpu_torch.ops.precond import (
    TwoLevelPrecond,
    apply_precond,
    bound_precond,
    coarse_accumulate,
    invert_coarse_with_ladder,
    qmat_bc,
    stored_coarse,
)
from fcvm_tpu_torch.ops.stress_update import internal_force_from_stress, update_stress_load
from fcvm_tpu_torch.parallel import dist as pdist
from fcvm_tpu_torch.runtime import buckling as bk
from fcvm_tpu_torch.runtime import system as sysm
from fcvm_tpu_torch.runtime.backend import TorchSystem


class ShardedOperator(NamedTuple):
    """``K_hat`` over this rank's blocks (30, 30, ne_l), Morton element
    order, element-major (on the card None after a tangent refresh, which
    forms the packed tiles alone), and on the card their packed tiles
    (None on the CPU).  Calling it applies ``K_hat @ v`` (one ``all_reduce``);
    ``local(v)`` is this rank's unreduced raw ``K @ v``."""

    esm_t: torch.Tensor
    matvec: Callable
    local: Callable
    packed: torch.Tensor = None

    def __call__(self, v):
        return self.matvec(v)


class ShardedSystem(TorchSystem):
    """Element-partition backend with the :class:`TorchSystem` interface.

    Gauss state is (ne_l, 4, ...) on each rank: the rank's slice of the
    padded Morton element order.  Element blocks passed between the
    methods (``assemble_operator`` → ``operator_pc``) are the rank's, in
    that order."""

    supports_scipy = False

    def __init__(self, model, cfg, dtype: torch.dtype, device: torch.device):
        g = pdist.require(max(1, cfg.n_devices), device)
        super().__init__(model, cfg, dtype, g.device)
        self.group = g
        self.writes_files = g.rank == 0
        n, r = g.world_size, g.rank
        ne = self.ne
        self.ne_pad = -(-ne // n) * n
        self.ne_l = self.ne_pad // n
        self.nn_pad = self.ndof_pad // 3
        eperm = self.space.eperm.cpu().numpy()
        self._epos = torch.as_tensor(np.argsort(eperm), device=self.device)
        # padded Morton slot -> Morton slot (ghosts: slot 0) of this rank
        slot = np.arange(r * self.ne_l, (r + 1) * self.ne_l)
        real = slot < ne
        morton = np.where(real, slot, 0)
        self._user = torch.as_tensor(eperm[morton], device=self.device)  # user ids
        self.w_l = torch.as_tensor(real, device=self.device).to(dtype)
        self.eln_l = self.elnodes[self._user]
        self.eln_m_l = self.space.elnodes_m[torch.as_tensor(morton, device=self.device)]
        self.eldofs_m_l = asm.element_dof_ids(self.eln_m_l)
        self.incidence_l = asm.node_incidence(self.eln_m_l, self.nn_pad)
        # the K8 plans of the rank's node sums: the internal force's and
        # gravity's (user node ids), the block-Jacobi blocks' (Morton)
        self.node_plan_l = kernels.segment_plan(self.eln_l, rows=self.nn_pad)
        self.jacobi_plan_l = asm.jacobi_plan(self.eln_m_l, self.nn_pad)

        def local(x):  # per-element (ne,) material tables follow their elements
            return x[self._user] if torch.is_tensor(x) and x.dim() == 1 else x

        self.e_l, self.nu_l, self.density_l, self.g_l = (
            local(x) for x in (self.e, self.nu, self.density, self.g))
        self.dmat_l = self.dmat[self._user] if self.dmat.dim() == 3 else self.dmat

    @property
    def element_table(self):
        """K2's node tables of this rank's elements, made at first use and kept."""
        if self._element_table is None:
            self._element_table = kernels.element_table(self.eln_l)
        return self._element_table

    # -- Gauss state (this rank's slice of the padded Morton order) ----------

    def gauss_zeros(self, trailing=()):
        return torch.zeros((self.ne_l, 4) + tuple(trailing), dtype=self.dtype,
                           device=self.device)

    def gauss_full(self, value):
        return torch.full((self.ne_l, 4), value, dtype=self.dtype, device=self.device)

    def gauss_false(self):
        return torch.zeros((self.ne_l, 4), dtype=torch.bool, device=self.device)

    def _gauss_to_user_t(self, a):
        """Gather a Gauss field to every rank, in user element order (the
        counterpart of the JAX package's ``process_allgather``)."""
        if a.dtype == torch.bool:
            return self._gauss_to_user_t(a.to(torch.uint8)).to(torch.bool)
        return pdist.all_gather(a)[self._epos]

    def gauss_to_user(self, a) -> np.ndarray:
        return self._gauss_to_user_t(a).cpu().numpy()

    def user_to_gauss(self, a):
        return super().user_to_gauss(np.asarray(a)[self._user.cpu().numpy()])

    def any(self, flags) -> bool:
        return bool(pdist.all_reduce(flags.any().to(torch.int32).reshape(1)) > 0)

    def record_stats(self, disp_new, *fields):
        """Converged-step history scalars: the Gauss fields (csr, peeq,
        pressure, svm, triax, ecr) gathered in user element order first, so
        the argmax ties break like ``np.argmax``."""
        return super().record_stats(
            disp_new, *self._gauss_to_user_t(torch.stack(fields, dim=-1)).unbind(-1))

    # -- operators ------------------------------------------------------------

    def operator(self, blocks: asm.Blocks):
        """``K_hat @ v`` in the solve space over this rank's ``blocks``
        (K3's :class:`~fcvm_tpu_torch.ops.assembly.Blocks`)."""
        esm_t, packed = blocks.esm_t, blocks.packed
        local = asm.make_matvec(esm_t, self.eldofs_m_l, self.ndof_pad, self.incidence_l, packed)
        fm = self.space.fixmask_m
        free = 1.0 - fm

        def khat(u):
            return fm * pdist.all_reduce(local(fm * u)) + free * u

        return ShardedOperator(esm_t, khat, local, packed)

    def _block_op(self, esm_t, identity_on_fixed=True, negate=False, packed=None):
        """``(ndof, m) -> (ndof, m)``: ``K_hat @ U`` (or ``-G_hat @ U`` with
        ``identity_on_fixed=False, negate=True``) through K1m's raw form on
        this rank's blocks (``packed``, their packed copy, made here on the
        card when not given) and one ``all_reduce``."""
        raw = asm.make_multi_matvec(esm_t, self.eldofs_m_l, None, incidence=self.incidence_l,
                                    packed=packed)
        fm = self.space.fixmask_m[:, None]

        def mv(u):
            y = fm * pdist.all_reduce(raw(fm * u))
            if identity_on_fixed:
                y = y + (1.0 - fm) * u
            return -y if negate else y

        return mv

    def _pinv_m(self, blocks: asm.Blocks):
        """Replicated (nn_pad, 3, 3) block-Jacobi inverses, Morton order, of
        this rank's ``blocks`` (on the card their compact diagonal): K5's
        sum, the ``all_reduce``, K5's tail."""
        return asm.block_jacobi_inverse_blocks(blocks.esm, self.eln_m_l, self.space.fixmask_m,
                                               reduce=pdist.all_reduce, plan=self.jacobi_plan_l,
                                               diag=blocks.diag)

    def _external_loads(self, coords, disp, follower: bool):
        """:func:`fcvm_tpu_torch.runtime.system.external_loads` over this
        rank's elements: gravity and volume all-reduced, the small load
        tables (faces, edges, vertices) replicated (their fixed-order node
        sums give every rank the same bits)."""
        ndof = self.ndof_pad
        coords_def = coords + disp.reshape(-1, 3)[: coords.shape[0]] if follower else coords
        ld = self.loads
        glv, gp_coords, volume = asm.gravity_load_and_gp_coords(
            coords_def, self.eln_l, self.density_l, ld.gravity, ndof, weights=self.w_l,
            plan=self.node_plan_l)
        glv = pdist.all_reduce(glv)
        volume = pdist.all_reduce(volume.reshape(1))[0]
        glv = glv + asm.pressure_face_loads(coords_def, ld.pressure_faces, ld.pressures, ndof,
                                            ld.pressure_plan)
        glv = glv + asm.uniform_face_loads(coords, ld.traction_faces, ld.tractions, ndof,
                                           ld.traction_plan)
        glv = glv + asm.edge_loads(coords, ld.edges, ld.edge_tractions, ndof, ld.edge_plan)
        glv = glv + asm.vertex_loads(ld.vertices, ld.vertex_forces, ndof, ld.vertex_plan)
        return glv, gp_coords, volume, glv.reshape(-1, 3).sum(dim=0)

    def _rhs_m(self, khat: ShardedOperator, glv):
        """Dirichlet right-hand side in the solve space,
        ``P glv - P K u_fix + u_fix`` (``fcVM.py:1128``)."""
        sp = self.space
        u_fix_m, fm = sp.to_m(self.u_fix), sp.fixmask_m
        return fm * sp.to_m(glv) - fm * pdist.all_reduce(khat.local(u_fix_m)) + u_fix_m

    # -- composites -------------------------------------------------------------

    def assemble_operator(self, coords):
        """The operator over this rank's elastic blocks (K3, the padding
        elements' weights folded in, element-major and on the card packed),
        the replicated block-Jacobi inverses (Morton order), loads, the
        elastic RHS (user order), this rank's Gauss-point coordinates,
        volume and load sums."""
        blocks = asm.operator_blocks("elastic", coords, self.eln_l, dmat=self.dmat_l,
                                     weights=self.w_l, table=self.element_table, full=True,
                                     diag=True)
        khat = self.operator(blocks)
        pinv = self._pinv_m(blocks)
        del blocks
        glv, gp_coords, volume, loadsums = self._external_loads(
            coords, torch.zeros_like(self.u_fix), follower=False)
        rhs = self.space.from_m(self._rhs_m(khat, glv))
        return khat, pinv, glv, rhs, gp_coords, volume, loadsums

    def assemble(self, coords):
        """:meth:`assemble_operator` with this rank's elastic blocks (ne_l,
        30, 30) (Morton order) in place of the operator."""
        khat, *rest = self.assemble_operator(coords)
        return (khat.esm_t.permute(2, 0, 1), *rest)

    def operator_pc(self, khat, pinv):
        """Two-level preconditioner on the blocks of the operator ``khat``
        (the coarse table all-reduced) or the block-Jacobi blocks ``pinv``,
        Morton order; no cluster smoother."""
        cfg = self.cfg
        if cfg.precond != "two_level":
            return pinv
        sp = self.space
        cs = cfg.resolve_cluster_size(self.mesh.n_nodes)
        qmat = qmat_bc(sp.coords_m, sp.fixmask_m, cs, cfg.coarse_modes)
        kc = pdist.all_reduce(coarse_accumulate(khat.esm_t.permute(2, 0, 1).contiguous(),
                                                self.eln_m_l, qmat, cs))
        return TwoLevelPrecond(pinv, qmat,
                               stored_coarse(invert_coarse_with_ladder(kc, label="sharded ")),
                               sp.fixmask_m, None)

    def _np_solve_ok(self, pc):
        return self.cfg.node_partition and self.nn_pad % self.group.world_size == 0

    def solve(self, khat, pc, b, x0=None, defl=None):
        if self._np_solve_ok(pc):
            return self._solve_np(khat, pc, b, x0, defl)
        return super().solve(khat, pc, b, x0=x0, defl=defl)

    def _solve_np(self, khat: ShardedOperator, pc, b, x0, defl) -> slv.CGResult:
        """Node-partitioned PCG (``config.node_partition``): the vectors are
        this rank's slice of Morton node rows; the matvec all-gathers the
        search direction and reduce-scatters the element output, the dots,
        the coarse restriction and the deflation projection are
        all-reduced, the block Jacobi, prolongation and vector algebra run
        on the slice.  The result is gathered to every rank."""
        sp, g = self.space, self.group
        rows = self.nn_pad // g.world_size
        lo, hi = g.rank * rows, (g.rank + 1) * rows
        own = slice(3 * lo, 3 * hi)
        fm = sp.fixmask_m[own]
        fm3 = fm.reshape(-1, 3)
        two_level = isinstance(pc, TwoLevelPrecond)
        pinv = (pc.pinv if two_level else pc)[lo:hi]
        if two_level:
            nm = pc.qmat.shape[2]
            ncl = pc.coarse_inv.shape[0] // nm
            q = pc.qmat[lo:hi]
            cid = torch.arange(lo, hi, device=self.device) // (pc.qmat.shape[0] // ncl)
            cid_plan = kernels.segment_plan(cid, rows=ncl)
        w = None if defl is None else defl.w[own]

        def mv(u):
            y = pdist.reduce_scatter(khat.local(pdist.all_gather(fm * u)))
            return fm * y + (1.0 - fm) * u

        def prec(r):
            r3 = r.reshape(-1, 3)
            z3 = torch.einsum("nab,nb->na", pinv, r3)
            if two_level:
                rc = kernels.segment_sum(torch.einsum("nak,na->nk", q, fm3 * r3).contiguous(),
                                         cid_plan, rows=ncl)
                zc = pc.coarse(pdist.all_reduce(rc).T.reshape(-1))  # mode-major
                z3 = z3 + torch.einsum("nak,nk->na", q, zc.reshape(nm, ncl).T[cid]) * fm3
            z = z3.reshape(-1)
            if w is not None:
                z = z + w @ (defl.kw_inv @ pdist.all_reduce(w.T @ r))
            return z

        def pdot(u, v):
            return pdist.all_reduce(torch.dot(u, v).reshape(1))[0]

        res = slv.pcg(mv, sp.to_m(b)[own], precond=prec,
                      x0=None if x0 is None else sp.to_m(x0)[own],
                      rtol=self.rtol, maxiter=self.maxiter, dot=pdot)
        return res._replace(x=sp.from_m(pdist.all_gather(res.x)))

    # -- Ritz-deflation recycling ------------------------------------------------

    def make_deflation(self, khat, w):
        return dfl.DeflationSpace(
            w, dfl.pinv_psd(w.T @ self._block_op(khat.esm_t, packed=khat.packed)(w)))

    def build_deflation(self, khat, zs, coef):
        return self.make_deflation(khat, dfl.build_w(zs, coef, self.space.fixmask_m))

    # -- Newton pieces -------------------------------------------------------------

    def tangent_refresh(self, coords, sig_old, pgp, disp_new, pc, et_e, ue0=None,
                        w=None, solve_predictor=True):
        """See :func:`fcvm_tpu_torch.runtime.system.tangent_refresh`: this
        rank's tangent blocks, the block-Jacobi rebuild and the follower
        loads all-reduced, the predictor solve replicated."""
        disp_new = disp_new.to(coords.dtype)
        blocks = asm.operator_blocks(
            "tangent", coords, self.eln_l, disp=disp_new, dmat=self.dmat_l, sig=sig_old,
            pgp=pgp, g=self.g_l, h=mat.hardening_modulus(self.e_l, et_e), weights=self.w_l,
            table=self.element_table, diag=True)
        pinv = self._pinv_m(blocks)
        pc_t = pc._replace(pinv=pinv) if isinstance(pc, TwoLevelPrecond) else pinv
        khat = self.operator(blocks)
        del blocks
        glv_t = self._external_loads(coords, disp_new, follower=True)[0]
        rhs = self._rhs_m(khat, glv_t)
        sp = self.space
        if not solve_predictor:
            return khat, pc_t, glv_t, sp.from_m(rhs), 0
        defl = None if w is None else self.make_deflation(khat, w)
        # the replicated solve folds the deflation into K6 as the local
        # backend's predictor does, so a world of one repeats its bits
        res = slv.pcg(khat, rhs, precond=bound_precond(pc_t),
                      x0=None if ue0 is None else sp.to_m(ue0), rtol=self.rtol,
                      maxiter=self.maxiter, defl=defl)
        return khat, pc_t, glv_t, sp.from_m(res.x), res.iters

    def residual(self, coords, sig_yield, disp_new, du, sig_old, glv, lbd1,
                 qnorm, et_e, large_disp=False, relax=1.0):
        return sysm.residual(
            coords, self.eln_l, self.dmat_l, sig_yield, disp_new, du, sig_old, self.e_l,
            self.nu_l, et_e, glv, self.fixmask, self.tensor(lbd1), qnorm, large_disp,
            relax=relax, weights=self.w_l, reduce=pdist.all_reduce, plan=self.node_plan_l,
            table=self.element_table)

    def residual_refined(self, coords, sig_yield, disp_new, du, sig_old, glv,
                         lbd1, qnorm, et_e, large_disp=False, relax=1.0):
        return sysm.residual_refined(
            coords, self.eln_l, self.dmat_l, sig_yield, disp_new, du, sig_old, self.e_l,
            self.nu_l, et_e, glv, self.fixmask,
            torch.tensor(float(lbd1), dtype=torch.float64, device=self.device),
            qnorm, large_disp, relax=relax, weights=self.w_l, reduce=pdist.all_reduce,
            plan=self.node_plan_l, table=self.element_table)

    def stress_update(self, coords, sig_yield, disp, du, sig_old, et_e, large_disp=False):
        return update_stress_load(coords, self.eln_l, self.dmat_l, sig_yield, disp, du,
                                  sig_old, self.e_l, self.nu_l, et_e, large_disp,
                                  weights=self.w_l, reduce=pdist.all_reduce,
                                  plan=self.node_plan_l, table=self.element_table)

    def internal_force(self, coords, sig_gp, disp, large_disp=False):
        return internal_force_from_stress(coords, self.eln_l, sig_gp, disp, large_disp,
                                          weights=self.w_l, reduce=pdist.all_reduce,
                                          plan=self.node_plan_l, table=self.element_table)

    def update_peeq_csr(self, sig_test, sig_new, sig_yield, peeq, csr, et_e,
                        ultimate_strain):
        return mat.update_peeq_csr(sig_test, sig_new, sig_yield, peeq, csr,
                                   mat.per_gauss(self.e_l), mat.per_gauss(self.nu_l),
                                   et_e, ultimate_strain)

    # -- linear buckling -------------------------------------------------------------

    def _local_buckling(self, coords, sig_el_gp, k, stats):
        """The single-device eigensolve and its retry ladder on the gathered
        user-order arrays, rank 0's result on every rank."""
        lam, vecs = bk.buckling_from_arrays(
            coords, self.elnodes, self.dmat, self._gauss_to_user_t(sig_el_gp), self.fixmask,
            k=k, rtol=min(self.rtol, 1.0e-10), maxiter=self.maxiter, space=self.space,
            config=self.cfg, stats=stats)
        both = torch.as_tensor(np.vstack([lam[None, :], vecs]), device=self.device)
        both = pdist.broadcast(both).cpu().numpy()
        return both[0], both[1:].astype(vecs.dtype)

    def buckling(self, coords, sig_el_gp, k=2, stats=None):
        """Lowest-``k`` buckling factors and modes (user dof order) under the
        pre-stress ``sig_el_gp`` (this rank's Gauss slice).

        The (K, -G) pencil's blocks are this rank's; ``K_hat @ V`` and
        ``-G_hat @ V`` go through K1m and one ``all_reduce``, the inner
        block solves and the deep Ritz harvest through the sharded
        operator, the Rayleigh-Ritz algebra replicated.  The penalty BC
        runs the single-device tier, as does the retry after a float32
        breakdown (:meth:`_local_buckling`), as in the reference."""
        cfg = self.cfg
        if cfg.buckling_bc == "penalty":
            return self._local_buckling(coords, sig_el_gp, k, stats)
        dtype, fm = self.dtype, self.space.fixmask_m
        rtol = min(self.rtol, 1.0e-10)
        kb = asm.operator_blocks("elastic", coords, self.eln_l, dmat=self.dmat_l,
                                 weights=self.w_l, table=self.element_table, full=True,
                                 diag=True)
        gb = asm.operator_blocks("geometric", coords, self.eln_l, sig=sig_el_gp,
                                 weights=self.w_l, table=self.element_table)
        khat = self.operator(kb)
        pc = self.operator_pc(khat, self._pinv_m(kb))
        nstore, k_defl = bk._recycling_params(self.ndof_pad, kb.esm_t.element_size())
        del kb
        kmv = self._block_op(khat.esm_t, packed=khat.packed)
        minus_g = self._block_op(gb.esm_t, identity_on_fixed=False, negate=True,
                                 packed=gb.packed)
        record = {"dtype": str(dtype).replace("torch.", ""), "solver": "cg", "sweeps": 0,
                  "inner_iters": [], "harvest": None, "pencil_residuals": None,
                  "error": None, "sharded": True}
        if stats is not None:
            stats.append(record)

        def prec(r):
            return apply_precond(pc, r)

        def kinv(w, defl, x0_basis, x0_scale):
            x0 = None if x0_basis is None else x0_basis * x0_scale[None, :]
            return slv.pcg_block(kmv, w, precond=prec, x0=x0, rtol=rtol, maxiter=self.maxiter,
                                 stall=bk.STALL, defl=defl)

        def harvest(b):
            return slv.pcg_harvest(khat, b, precond=prec, rtol=rtol, maxiter=self.maxiter,
                                   nstore=nstore, stall=bk.STALL)

        k_inverse = bk.make_recycled_k_inverse(
            kinv, harvest, lambda zs, coef: self.build_deflation(khat, zs, coef), k_defl,
            cfg.deflation_min_iters, cfg.deflation, record=record)
        m = max(cfg.n_eig_vectors, 2 * k, k + 4)
        try:
            # warn-only in float64; raise in float32 so the ladder escalates
            lam, vecs = bk.pencil_subspace(kmv, minus_g, k_inverse, self.ndof_pad, dtype, k, m,
                                           fixmask=fm, last_tier=dtype != torch.float32,
                                           record=record)
        except bk.EigensolveBreakdownError as err:
            record["error"] = str(err)
            warnings.warn("sharded f32 buckling eigensolve broke down; escalating through "
                          "the local retry ladder (f64 iteration / re-assembly), the collapse "
                          "analysis itself stays sharded")
            del kmv, minus_g, k_inverse, khat, gb
            return self._local_buckling(coords, sig_el_gp, k, stats)
        return lam, vecs.reshape(-1, 3, k)[self.space.npos.cpu().numpy()].reshape(-1, k)
