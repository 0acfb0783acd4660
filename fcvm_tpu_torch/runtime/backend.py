"""The compute engines behind the collapse driver and their factory.

:class:`TorchSystem` is the port of :class:`fcvm_tpu.runtime.backend.LocalSystem`
(one device); :func:`make_backend` picks it or the element-partition
:class:`fcvm_tpu_torch.parallel.system.ShardedSystem` (several devices).
The driver keeps the host control flow; every tensor operation goes
through the backend.

Data contract (the same as ``LocalSystem``'s):

* node vectors (disp, du, loads, residuals) are in user dof order, padded
  to the 384-dof alignment (:mod:`fcvm_tpu_torch.utils.indexing`);
* Gauss-state tensors (stress, PEEQ, CSR, yield) are (ne, 4, ...) in the
  backend's element order: user order here, each rank's padded Morton
  slice in the sharded backend; ``gauss_to_user`` / ``user_to_gauss``
  convert, and the driver converts exactly at results and checkpoints;
* the linear solves run in the Morton solve space
  (:class:`fcvm_tpu_torch.runtime.system.SolveSpace`), and so do the
  harvested residuals and the deflation spaces built from them, and the
  tangent refresh's operator, preconditioner and load-space basis.
"""

from __future__ import annotations

import numpy as np
import torch

from fcvm_tpu_torch.ops import deflation as dfl
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import material as mat
from fcvm_tpu_torch.ops import solver as slv
from fcvm_tpu_torch.ops.stress_update import internal_force_from_stress, update_stress_load
from fcvm_tpu_torch.runtime import system as sysm
from fcvm_tpu_torch.runtime.buckling import buckling_from_arrays
from fcvm_tpu_torch.utils.indexing import pad_ndof, pad_vector


class TorchSystem:
    """Single-device backend over :mod:`fcvm_tpu_torch.runtime.system`."""

    supports_scipy = True
    writes_files = True  # the process that writes outputs and checkpoints

    def __init__(self, model, cfg, dtype: torch.dtype, device: torch.device):
        self.cfg = cfg
        self.dtype = dtype
        self.device = device
        mesh = model.mesh
        self.mesh = mesh
        self.ne = mesh.n_elements
        self.ndof_pad = pad_ndof(mesh.ndof)
        if model.materials_by_element is not None:
            # per-element (E, nu, rho): (ne,) tensors, dmat (ne, 6, 6); they
            # reach elastic and tangent formation, the stress update, the
            # damage update, gravity and the buckling pencil
            mbe = model.materials_by_element
            self.e, self.nu, self.density = (self.tensor(mbe[:, k]) for k in range(3))
        else:
            self.e = float(model.material.e)
            self.nu = float(model.material.nu)
            self.density = float(model.material.density)
        self.dmat = mat.hooke_dmat(self.e, self.nu, dtype, device)
        self.g = mat.shear_modulus(self.e, self.nu)
        self.elnodes = torch.as_tensor(mesh.elnodes.astype(np.int64), device=device)
        # the K8 plan of the internal force's and gravity's node sums, over
        # the user element order the Gauss state keeps
        self.node_plan = kernels.segment_plan(self.elnodes, rows=self.ndof_pad // 3)
        self._element_table = None
        self._residuals = {}  # K2's bound residuals by (et_e, refined)

        def vec(a):
            return torch.as_tensor(pad_vector(a, self.ndof_pad), device=device).to(dtype)

        fixmask_np, u_fix_np, movdof_np = model.bcs.masks(mesh.ndof)
        self.fixmask = vec(fixmask_np)
        self.u_fix = vec(u_fix_np)
        self.movdof = vec(movdof_np)
        self.has_movdof = bool(movdof_np.max() > 0.5)
        self.loads = sysm.LoadTables.from_spec(model.loads, dtype, device, self.ndof_pad)
        self.space = sysm.build_solve_space(mesh.coords, mesh.elnodes,
                                            self.fixmask, self.ndof_pad)
        self.rtol = cfg.cg_rtol
        self.maxiter = cfg.resolve_cg_maxiter(mesh.ndof)

    @property
    def element_table(self):
        """K2's node tables of ``elnodes`` (:func:`~fcvm_tpu_torch.ops.kernels.element_table`),
        made at the first stress update (after the preconditioner's first
        build, whose peak they stay out of) and kept."""
        if self._element_table is None:
            self._element_table = kernels.element_table(self.elnodes)
        return self._element_table

    # -- Gauss-state helpers -------------------------------------------------

    def gauss_zeros(self, trailing=()):
        return torch.zeros((self.ne, 4) + tuple(trailing), dtype=self.dtype,
                           device=self.device)

    def gauss_full(self, value):
        return torch.full((self.ne, 4), value, dtype=self.dtype, device=self.device)

    def gauss_false(self):
        return torch.zeros((self.ne, 4), dtype=torch.bool, device=self.device)

    def gauss_to_user(self, a) -> np.ndarray:
        """A Gauss-state tensor as a host array in user element order."""
        return a.detach().cpu().numpy()

    def user_to_gauss(self, a):
        """A user-order host array (a checkpoint's) as Gauss state: floats in
        the working dtype, booleans as they are."""
        t = torch.as_tensor(np.asarray(a), device=self.device)
        return t if t.dtype == torch.bool else t.to(self.dtype)

    def any(self, flags) -> bool:
        """Whether any Gauss point is flagged (``pgp``), over the whole mesh."""
        return bool(flags.any())

    def tensor(self, a):
        """A host array or scalar as a tensor of the working dtype."""
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=self.device).to(self.dtype)

    # -- composites ----------------------------------------------------------

    def assemble(self, coords):
        return sysm.assemble_elastic(
            coords, self.elnodes, self.dmat, self.loads, self.density,
            self.fixmask, self.u_fix, self.node_plan)

    def operator(self, esm):
        """K_hat·v in the solve space over blocks ``esm`` (user order)."""
        return sysm.make_operator(esm[self.space.eperm], self.space)

    def make_pc(self, esm, pinv):
        if self.cfg.precond == "two_level":
            return sysm.build_precond(
                esm, self.cfg.resolve_cluster_size(self.mesh.n_nodes),
                self.space, self.cfg.coarse_modes, self.cfg.smoother,
                self.cfg.smoother_cluster_nodes)
        return pinv[self.space.nperm]  # block-Jacobi tier, in solve space

    def solve(self, khat, pc, b, x0=None, defl=None):
        return sysm.solve_displacement(khat, pc, b, self.rtol, self.maxiter,
                                       self.space, x0=x0, defl=defl)

    def scipy_direct(self, khat):
        """The scipy direct tier on the operator ``khat``: a host LU of its
        blocks, returned as a solve ``b -> x`` in user dof order."""
        sp = self.space
        direct = slv.ScipyDirectSolver(khat.esm_t.permute(2, 0, 1), sp.eldofs_m,
                                       sp.fixmask_m, self.ndof_pad)
        return lambda b: sp.from_m(direct.solve(sp.to_m(b)))

    def buckling(self, coords, sig_el_gp, k=2, stats=None):
        """Lowest-``k`` buckling factors and mode shapes (user dof order)
        under the elastic pre-stress ``sig_el_gp`` (user Gauss order); see
        :func:`fcvm_tpu_torch.runtime.buckling.buckling_from_arrays`."""
        return buckling_from_arrays(
            coords, self.elnodes, self.dmat, sig_el_gp, self.fixmask, k=k,
            rtol=min(self.rtol, 1.0e-10), maxiter=self.maxiter, space=self.space,
            config=self.cfg, stats=stats)

    # -- Ritz-deflation recycling (fcvm_tpu_torch.ops.deflation) -------------

    def solve_harvest(self, khat, pc, b, x0=None, nstore=dfl.NSTORE):
        return sysm.solve_displacement_harvest(
            khat, pc, b, self.rtol, self.maxiter, self.space, x0=x0, nstore=nstore)

    def build_deflation(self, khat, zs, coef):
        """Harvested ``zs`` + Ritz ``coef`` -> DeflationSpace on ``khat``."""
        return sysm.build_deflation(khat, self.space, zs, coef)

    def make_deflation(self, khat, w):
        """Re-Galerkin a held basis ``w`` on a (refreshed) operator."""
        return sysm.regalerkin_deflation(khat, self.space, w)

    def deflation_basis(self, zs, coef):
        """Harvest data -> solve-space (ndof, k) Ritz basis, without a
        Galerkin: the tangent predictor's load space, re-Galerkined on
        each new tangent inside :meth:`tangent_refresh`."""
        return dfl.build_w(zs, coef, self.space.fixmask_m)

    # -- geometric nonlinearity ----------------------------------------------

    def tangent_refresh(self, coords, sig_old, pgp, disp_new, pc, et_e, ue0=None,
                        w=None, solve_predictor=True):
        """See :func:`fcvm_tpu_torch.runtime.system.tangent_refresh`."""
        return sysm.tangent_refresh(
            coords, self.elnodes, self.dmat, sig_old, pgp, disp_new, self.loads,
            self.density, self.u_fix, self.g, mat.hardening_modulus(self.e, et_e),
            self.rtol, self.maxiter, pc, self.space, ue0=ue0, w=w,
            solve_predictor=solve_predictor, plan=self.node_plan)

    def _residual_kernel(self, et_e, refined: bool):
        """The residual's :func:`~fcvm_tpu_torch.runtime.system.residual_kernel`
        for ``et_e``, in the working dtype or (``refined``) in float64 over
        the upcast material and mask: made once and kept."""
        key = (float(et_e), refined)
        if key not in self._residuals:
            def c(x):
                return x.to(torch.float64) if refined and torch.is_tensor(x) else x

            self._residuals[key] = sysm.residual_kernel(
                self.elnodes, c(self.dmat), c(self.e), c(self.nu), et_e, c(self.fixmask),
                plan=self.node_plan, table=self.element_table)
        return self._residuals[key]

    def residual(self, coords, sig_yield, disp_new, du, sig_old, glv, lbd1,
                 qnorm, et_e, large_disp=False, relax=1.0):
        return sysm.residual(
            coords, self.elnodes, self.dmat, sig_yield, disp_new, du, sig_old,
            self.e, self.nu, et_e, glv, self.fixmask, float(lbd1),
            qnorm, large_disp, relax=relax, plan=self.node_plan, table=self.element_table,
            k2=self._residual_kernel(et_e, False))

    def residual_refined(self, coords, sig_yield, disp_new, du, sig_old, glv,
                         lbd1, qnorm, et_e, large_disp=False, relax=1.0):
        """The residual in float64 over float32 state (the refinement tier,
        :func:`fcvm_tpu_torch.runtime.system.residual_refined`)."""
        return sysm.residual_refined(
            coords, self.elnodes, self.dmat, sig_yield, disp_new, du, sig_old,
            self.e, self.nu, et_e, glv, self.fixmask, float(lbd1),
            qnorm, large_disp, relax=relax, plan=self.node_plan, table=self.element_table,
            k2=self._residual_kernel(et_e, True))

    def stress_update(self, coords, sig_yield, disp, du, sig_old, et_e, large_disp=False):
        return update_stress_load(coords, self.elnodes, self.dmat, sig_yield,
                                  disp, du, sig_old, self.e, self.nu, et_e, large_disp,
                                  plan=self.node_plan, table=self.element_table)

    def internal_force(self, coords, sig_gp, disp, large_disp=False):
        return internal_force_from_stress(coords, self.elnodes, sig_gp, disp, large_disp,
                                          plan=self.node_plan, table=self.element_table)

    def update_peeq_csr(self, sig_test, sig_new, sig_yield, peeq, csr, et_e,
                        ultimate_strain):
        return mat.update_peeq_csr(sig_test, sig_new, sig_yield, peeq, csr,
                                   mat.per_gauss(self.e), mat.per_gauss(self.nu),
                                   et_e, ultimate_strain)

    def record_stats(self, disp_new, csr, peeq, pressure, svm, triax, ecr):
        """Converged-step history scalars as host numbers."""
        vals = sysm.record_step_stats(disp_new, csr, peeq, pressure, svm, triax, ecr)
        return [v.item() for v in torch.stack([v.to(torch.float64) for v in vals]).cpu()]


def make_backend(model, cfg, dtype: torch.dtype, device: torch.device):
    """The backend of an analysis: the sharded one when ``cfg.n_devices >
    1`` or ``cfg.force_sharded`` (a world of one, which runs the sharded
    code on one device), :class:`TorchSystem` otherwise, as
    :func:`fcvm_tpu.runtime.backend.make_backend` chooses."""
    if cfg.n_devices > 1 or cfg.force_sharded:
        from fcvm_tpu_torch.parallel.system import ShardedSystem

        return ShardedSystem(model, cfg, dtype, device)
    return TorchSystem(model, cfg, dtype, device)
