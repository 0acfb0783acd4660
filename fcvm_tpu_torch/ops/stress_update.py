"""Stress update and internal force, small strain: the port of
:mod:`fcvm_tpu.ops.stress_update` with ``large_disp=False``.

Per Gauss point: B on the original coordinates, strain increment
``deps = B du``, elastic trial stress ``sig_old + D deps``, radial return
to the von Mises surface, and the internal force
``qin = sum_e sum_g B^T sigma w |J|`` (``fcVM.py:2196-2464``).  Float32
products run in full float32 (no TF32): a lower-precision internal force
floors the Newton residual.  The geometrically nonlinear branch (the
convected stress ``F sigma F^T / det F``) comes with the GNL port.
"""

from __future__ import annotations

import torch

from fcvm_tpu_torch.ops import elements as el
from fcvm_tpu_torch.ops import material as mat


def _require_small_strain(large_disp: bool):
    if large_disp:
        raise NotImplementedError(
            "large_disp=True: the geometrically nonlinear stress update "
            "(gnl='GNLY') is not ported yet (ROADMAP Queue 1 item 7)"
        )


def _geometry(coords, elnodes):
    """B (ne, 4, 6, 30), the quadrature scale w |J| (ne, 4) and the element
    dof ids (ne, 30)."""
    det, _, bmat = el.tet10_element_geometry(coords[elnodes])
    w = torch.as_tensor(el.W10, dtype=coords.dtype, device=coords.device)
    dofs = 3 * elnodes[:, :, None] + torch.arange(3, device=elnodes.device)
    return bmat, w * det.abs(), dofs.reshape(-1, 30)


def _internal_force(bmat, scale, sig, dofs, ndof):
    """``sum_e sum_g B_g^T sig_g w_g |J_g|`` (``fcVM.py:2448-2462``)."""
    elv = torch.einsum("egkn,egk,eg->en", bmat, sig, scale)
    qin = torch.zeros(ndof, dtype=elv.dtype, device=elv.device)
    return qin.index_add_(0, dofs.reshape(-1), elv.reshape(-1))


def update_stress_load(coords, elnodes, dmat, sig_yield, disp, du, sig_old,
                       e, nu, et_e, large_disp: bool = False):
    """Full-mesh stress update + internal force.

    Args:
      coords: (nn, 3) original nodal coordinates.
      elnodes: (ne, 10) 0-based connectivity.
      dmat: (6, 6) elastic matrix.
      sig_yield: (ne, 4) current yield stresses.
      disp: (ndof,) total displacement at the start of the step (unused in
        small strain; kept for the JAX signature).
      du: (ndof,) displacement increment of the current step.
      sig_old: (ne, 4, 6) stresses at the start of the step.

    Returns:
      (sig_new, sig_test, pgp, qin): stresses (ne, 4, 6), trial stresses
      (ne, 4, 6), plastic flags (ne, 4), internal force (ndof,).
    """
    _require_small_strain(large_disp)
    g = mat.shear_modulus(e, nu)
    h = mat.hardening_modulus(e, et_e)
    bmat, scale, dofs = _geometry(coords, elnodes)
    deps = torch.einsum("egkn,en->egk", bmat, du[dofs])  # (ne, 4, 6)
    sig_test = sig_old + torch.einsum("kl,egl->egk", dmat, deps)
    sig_new, pgp = mat.radial_return(sig_test, sig_yield, h, g)
    qin = _internal_force(bmat, scale, sig_new, dofs, disp.shape[0])
    return sig_new, sig_test, pgp, qin


def internal_force_from_stress(coords, elnodes, sig_gp, disp, large_disp: bool = False):
    """``qin = sum_e B^T sigma w |J|`` for a given stress field (the
    reaction of the target-LF interception state, whose stress is a linear
    interpolation, ``fcVM.py:1486-1510``)."""
    _require_small_strain(large_disp)
    bmat, scale, dofs = _geometry(coords, elnodes)
    return _internal_force(bmat, scale, sig_gp, dofs, disp.shape[0])
