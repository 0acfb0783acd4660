"""Stress update and internal force: the port of :mod:`fcvm_tpu.ops.stress_update`.

Per Gauss point: B on the original coordinates (small strain) or on the
start-of-step deformed ones (``large_disp``), strain increment
``deps = B du``, the old stress convected through the incremental
deformation gradient ``F = I + d(du)/dx`` as ``F sigma F^T / det F``
(``large_disp`` only, ``fcVM.py:2383-2429``), elastic trial stress
``sig_c + D deps``, radial return to the von Mises surface, and the
internal force ``qin = sum_e sum_g B^T sigma w |J|`` (``fcVM.py:2196-2464``).
Float32 products run in full float32 (no TF32): a lower-precision internal
force floors the Newton residual.  The element rows are summed into nodes by
K8 (:func:`fcvm_tpu_torch.ops.kernels.segment_sum`) in a fixed order, so two
residuals at the same state give the same bits on the card too.
"""

from __future__ import annotations

import torch

from fcvm_tpu_torch.ops import elements as el
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import material as mat
from fcvm_tpu_torch.utils.linalg3 import det3


def voigt_to_tensor(sig: torch.Tensor) -> torch.Tensor:
    """(..., 6) Voigt [xx,yy,zz,xy,zx,yz] -> (..., 3, 3) symmetric tensor."""
    sxx, syy, szz = sig[..., 0], sig[..., 1], sig[..., 2]
    sxy, szx, syz = sig[..., 3], sig[..., 4], sig[..., 5]
    return torch.stack([
        torch.stack([sxx, sxy, szx], dim=-1),
        torch.stack([sxy, syy, syz], dim=-1),
        torch.stack([szx, syz, szz], dim=-1),
    ], dim=-2)


def _tensor_to_voigt(s: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric tensor -> (..., 6) Voigt [xx,yy,zz,xy,zx,yz]."""
    return torch.stack([s[..., 0, 0], s[..., 1, 1], s[..., 2, 2],
                        s[..., 0, 1], s[..., 0, 2], s[..., 1, 2]], dim=-1)


def _geometry(coords_el):
    """det J (ne, 4), dshpg (ne, 4, 3, 10), B (ne, 4, 6, 30) and the
    quadrature scale w |J| (ne, 4) of elements with nodes ``coords_el``."""
    det, dshpg, bmat = el.tet10_element_geometry(coords_el)
    w = torch.as_tensor(el.W10, dtype=coords_el.dtype, device=coords_el.device)
    return dshpg, bmat, w * det.abs()


def _internal_force(bmat, scale, sig, elnodes, ndof, weights=None, reduce=None, plan=None):
    """``sum_e sum_g B_g^T sig_g w_g |J_g|`` (``fcVM.py:2448-2462``); each
    element's share scaled by ``weights`` (ne,) when given, the node vector
    passed through ``reduce`` when given (see :func:`update_stress_load`);
    the node sum is K8's write form over ``plan``, the segment plan of
    ``elnodes`` with ``rows = ndof // 3`` (built here when not given)."""
    elv = torch.einsum("egkn,egk,eg->en", bmat, sig, scale)
    if weights is not None:
        elv = elv * weights[:, None]
    if plan is None:
        plan = kernels.segment_plan(elnodes, rows=ndof // 3)
    qin = kernels.segment_sum(elv.reshape(-1, 3).contiguous(), plan, rows=ndof // 3).reshape(-1)
    return qin if reduce is None else reduce(qin)


def update_stress_load(coords, elnodes, dmat, sig_yield, disp, du, sig_old,
                       e, nu, et_e, large_disp: bool = False, weights=None, reduce=None,
                       plan=None):
    """Full-mesh stress update + internal force.

    Args:
      coords: (nn, 3) original nodal coordinates.
      elnodes: (ne, 10) 0-based connectivity.
      dmat: (6, 6) elastic matrix, or (ne, 6, 6) per element.
      sig_yield: (ne, 4) current yield stresses.
      disp: (ndof,) total displacement at the start of the step (read only
        with ``large_disp``).
      du: (ndof,) displacement increment of the current step.
      sig_old: (ne, 4, 6) stresses at the start of the step.
      large_disp: geometric nonlinearity (``gnl="GNLY"``).
      weights: optional (ne,) scale of each element's internal force (0 for
        the sharded backend's padding elements).
      reduce: optional sum of the internal force over the parts of a
        partitioned mesh (the sharded backend's ``all_reduce``).
      plan: the :func:`~fcvm_tpu_torch.ops.kernels.segment_plan` of
        ``elnodes``, the internal force's node sum (built here when not
        given; a backend builds it once).

    Returns:
      (sig_new, sig_test, pgp, qin): stresses (ne, 4, 6), trial stresses
      (ne, 4, 6), plastic flags (ne, 4), internal force (ndof,).
    """
    e, nu = mat.per_gauss(e), mat.per_gauss(nu)
    g = mat.shear_modulus(e, nu)
    h = mat.hardening_modulus(e, et_e)
    coords_el = coords[elnodes]
    du_el = du.reshape(-1, 3)[elnodes]  # (ne, 10, 3)
    if large_disp:
        coords_el = coords_el + disp.reshape(-1, 3)[elnodes]
    dshpg, bmat, scale = _geometry(coords_el)
    deps = torch.einsum("egkn,en->egk", bmat, du_el.reshape(-1, 30))  # (ne, 4, 6)
    sig_c = sig_old
    if large_disp:
        # incremental deformation gradient on the start-of-step deformed
        # configuration (fcVM.py:2396-2414): F[a, b] = d_ab + sum_i du_ia dN_i/dx_b
        f = torch.eye(3, dtype=du.dtype, device=du.device) + torch.einsum(
            "eia,egbi->egab", du_el, dshpg)
        s_conv = torch.einsum("egij,egjl,egkl->egik", f, voigt_to_tensor(sig_old), f)
        sig_c = _tensor_to_voigt(s_conv / det3(f)[..., None, None])
    sig_test = sig_c + mat.apply_dmat(dmat, deps)
    sig_new, pgp = mat.radial_return(sig_test, sig_yield, h, g)
    qin = _internal_force(bmat, scale, sig_new, elnodes, disp.shape[0], weights, reduce, plan)
    return sig_new, sig_test, pgp, qin


def internal_force_from_stress(coords, elnodes, sig_gp, disp, large_disp: bool = False,
                               weights=None, reduce=None, plan=None):
    """``qin = sum_e B^T sigma w |J|`` for a given stress field (the
    reaction of the target-LF interception state, whose stress is a linear
    interpolation, ``fcVM.py:1486-1510``); with ``large_disp`` on the
    deformed coordinates.  A float64 ``disp`` (the refinement tier's) is
    cast to the storage dtype of ``coords`` first: the record stays in it.
    ``weights``, ``reduce`` and ``plan`` as in :func:`update_stress_load`."""
    coords_el = coords[elnodes]
    if large_disp:
        coords_el = coords_el + disp.to(coords.dtype).reshape(-1, 3)[elnodes]
    _, bmat, scale = _geometry(coords_el)
    return _internal_force(bmat, scale, sig_gp, elnodes, disp.shape[0], weights, reduce, plan)
