"""The compute engine behind the collapse driver: :class:`TorchSystem`.

The port of :class:`fcvm_tpu.runtime.backend.LocalSystem` (one device) for
the small-strain slice.  The driver keeps the host control flow; every
tensor operation goes through this object.

Data contract (the same as ``LocalSystem``'s):

* node vectors (disp, du, loads, residuals) are in user dof order, padded
  to the 384-dof alignment (:mod:`fcvm_tpu_torch.utils.indexing`);
* Gauss-state tensors (stress, PEEQ, CSR, yield) are (ne, 4, ...) in user
  element order;
* the linear solves run in the Morton solve space
  (:class:`fcvm_tpu_torch.runtime.system.SolveSpace`), and so do the
  harvested residuals and the deflation spaces built from them.
"""

from __future__ import annotations

import numpy as np
import torch

from fcvm_tpu_torch.ops import deflation as dfl
from fcvm_tpu_torch.ops import material as mat
from fcvm_tpu_torch.ops.stress_update import internal_force_from_stress, update_stress_load
from fcvm_tpu_torch.runtime import system as sysm
from fcvm_tpu_torch.utils.indexing import pad_ndof, pad_vector


class TorchSystem:
    """Single-device backend over :mod:`fcvm_tpu_torch.runtime.system`."""

    def __init__(self, model, cfg, dtype: torch.dtype, device: torch.device):
        if model.materials_by_element is not None:
            raise NotImplementedError(
                "materials_by_element: per-element materials are not ported "
                "yet (ROADMAP Queue 1 item 3)"
            )
        self.cfg = cfg
        self.dtype = dtype
        self.device = device
        mesh = model.mesh
        self.mesh = mesh
        self.ne = mesh.n_elements
        self.ndof_pad = pad_ndof(mesh.ndof)
        self.e = float(model.material.e)
        self.nu = float(model.material.nu)
        self.density = float(model.material.density)
        self.dmat = mat.hooke_dmat(self.e, self.nu, dtype, device)
        self.elnodes = torch.as_tensor(mesh.elnodes.astype(np.int64), device=device)

        def vec(a):
            return torch.as_tensor(pad_vector(a, self.ndof_pad), device=device).to(dtype)

        fixmask_np, u_fix_np, movdof_np = model.bcs.masks(mesh.ndof)
        self.fixmask = vec(fixmask_np)
        self.u_fix = vec(u_fix_np)
        self.movdof = vec(movdof_np)
        self.has_movdof = bool(movdof_np.max() > 0.5)
        self.loads = sysm.LoadTables.from_spec(model.loads, dtype, device)
        self.space = sysm.build_solve_space(mesh.coords, mesh.elnodes,
                                            self.fixmask, self.ndof_pad)
        self.rtol = cfg.cg_rtol
        self.maxiter = cfg.resolve_cg_maxiter(mesh.ndof)

    # -- Gauss-state helpers -------------------------------------------------

    def gauss_zeros(self, trailing=()):
        return torch.zeros((self.ne, 4) + tuple(trailing), dtype=self.dtype,
                           device=self.device)

    def gauss_full(self, value):
        return torch.full((self.ne, 4), value, dtype=self.dtype, device=self.device)

    def tensor(self, a):
        """A host array or scalar as a tensor of the working dtype."""
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=self.device).to(self.dtype)

    # -- composites ----------------------------------------------------------

    def assemble(self, coords):
        return sysm.assemble_elastic(
            coords, self.elnodes, self.dmat, self.loads, self.density,
            self.fixmask, self.u_fix)

    def operator(self, esm):
        """K_hat·v in the solve space over blocks ``esm`` (user order)."""
        return sysm.make_operator(esm, self.space)

    def make_pc(self, esm, pinv):
        if self.cfg.precond == "two_level":
            return sysm.build_precond(
                esm, self.cfg.resolve_cluster_size(self.mesh.n_nodes),
                self.space, self.cfg.coarse_modes)
        return pinv[self.space.nperm]  # block-Jacobi tier, in solve space

    def solve(self, khat, pc, b, x0=None, defl=None):
        return sysm.solve_displacement(khat, pc, b, self.rtol, self.maxiter,
                                       self.space, x0=x0, defl=defl)

    # -- Ritz-deflation recycling (fcvm_tpu_torch.ops.deflation) -------------

    def solve_harvest(self, khat, pc, b, x0=None, nstore=dfl.NSTORE):
        return sysm.solve_displacement_harvest(
            khat, pc, b, self.rtol, self.maxiter, self.space, x0=x0, nstore=nstore)

    def build_deflation(self, khat, zs, coef):
        """Harvested ``zs`` + Ritz ``coef`` -> DeflationSpace on ``khat``."""
        return sysm.build_deflation(khat, self.space, zs, coef)

    def residual(self, coords, sig_yield, disp_new, du, sig_old, glv, lbd1,
                 qnorm, et_e, relax=1.0):
        return sysm.residual(
            coords, self.elnodes, self.dmat, sig_yield, disp_new, du, sig_old,
            self.e, self.nu, et_e, glv, self.fixmask, self.tensor(lbd1),
            qnorm, relax=relax)

    def residual_refined(self, coords, sig_yield, disp_new, du, sig_old, glv,
                         lbd1, qnorm, et_e, relax=1.0):
        """The residual in float64 over float32 state (the refinement tier,
        :func:`fcvm_tpu_torch.runtime.system.residual_refined`)."""
        return sysm.residual_refined(
            coords, self.elnodes, self.dmat, sig_yield, disp_new, du, sig_old,
            self.e, self.nu, et_e, glv, self.fixmask,
            torch.tensor(float(lbd1), dtype=torch.float64, device=self.device),
            qnorm, relax=relax)

    def stress_update(self, coords, sig_yield, disp, du, sig_old, et_e):
        return update_stress_load(coords, self.elnodes, self.dmat, sig_yield,
                                  disp, du, sig_old, self.e, self.nu, et_e)

    def internal_force(self, coords, sig_gp, disp):
        return internal_force_from_stress(coords, self.elnodes, sig_gp, disp)

    def update_peeq_csr(self, sig_test, sig_new, sig_yield, peeq, csr, et_e,
                        ultimate_strain):
        return mat.update_peeq_csr(sig_test, sig_new, sig_yield, peeq, csr,
                                   self.e, self.nu, et_e, ultimate_strain)

    def record_stats(self, disp_new, csr, peeq, pressure, svm, triax, ecr):
        """Converged-step history scalars as host numbers."""
        vals = sysm.record_step_stats(disp_new, csr, peeq, pressure, svm, triax, ecr)
        return [v.item() for v in torch.stack([v.to(torch.float64) for v in vals]).cpu()]
