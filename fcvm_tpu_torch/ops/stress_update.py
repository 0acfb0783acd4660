"""Stress update and internal force: the port of :mod:`fcvm_tpu.ops.stress_update`.

Per Gauss point: B on the original coordinates (small strain) or on the
start-of-step deformed ones (``large_disp``), strain increment
``deps = B du``, the old stress convected through the incremental
deformation gradient ``F = I + d(du)/dx`` as ``F sigma F^T / det F``
(``large_disp`` only, ``fcVM.py:2383-2429``), elastic trial stress
``sig_c + D deps``, radial return to the von Mises surface, and the
internal force ``qin = sum_e sum_g B^T sigma w |J|`` (``fcVM.py:2196-2464``).
All of that per element is K2's element pass
(:func:`fcvm_tpu_torch.ops.kernels.stress_update`, ``csrc/stress_update.cu``
on the card; its plain version, the torch chain with B formed, on the CPU),
in full float32 (no TF32): a lower-precision internal force floors the
Newton residual.  The element rows are summed into nodes by K2's node pass
(:func:`fcvm_tpu_torch.ops.kernels.node_force`, K8's order and bits) in a
fixed order, so two residuals at the same state give the same bits on the
card too.  The residual of a backend without ``reduce`` runs both passes
through :func:`fcvm_tpu_torch.ops.kernels.stress_residual_bound`
(:mod:`fcvm_tpu_torch.runtime.system`).
"""

from __future__ import annotations

from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import material as mat


def _node_sum(elv, elnodes, ndof, reduce=None, plan=None):
    """``qin``, the element rows ``elv`` (ne, 30) summed into nodes
    (``fcVM.py:2448-2462``) by K2's node pass over ``plan``, the segment
    plan of ``elnodes`` with ``rows = ndof // 3`` (built here when not
    given), passed through ``reduce`` when given (see
    :func:`update_stress_load`)."""
    if plan is None:
        plan = kernels.segment_plan(elnodes, rows=ndof // 3)
    qin = kernels.node_force(elv, plan, rows=ndof // 3)
    return qin if reduce is None else reduce(qin)


def update_stress_load(coords, elnodes, dmat, sig_yield, disp, du, sig_old,
                       e, nu, et_e, large_disp: bool = False, weights=None, reduce=None,
                       plan=None, table=None):
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
      table: :func:`~fcvm_tpu_torch.ops.kernels.element_table` of
        ``elnodes``, the element pass's node table on the card (made there
        when not given; a backend makes it once).

    Returns:
      (sig_new, sig_test, pgp, qin): stresses (ne, 4, 6), trial stresses
      (ne, 4, 6), plastic flags (ne, 4), internal force (ndof,).
    """
    e, nu = mat.per_gauss(e), mat.per_gauss(nu)
    sig_new, sig_test, pgp, elv = kernels.stress_update(
        coords, elnodes, disp, sig_old, large_disp, du=du, dmat=dmat, sig_yield=sig_yield,
        g=mat.shear_modulus(e, nu), h=mat.hardening_modulus(e, et_e), weights=weights,
        table=table)
    qin = _node_sum(elv, elnodes, disp.shape[0], reduce, plan)
    return sig_new, sig_test, pgp, qin


def internal_force_from_stress(coords, elnodes, sig_gp, disp, large_disp: bool = False,
                               weights=None, reduce=None, plan=None, table=None):
    """``qin = sum_e B^T sigma w |J|`` for a given stress field (the
    reaction of the target-LF interception state, whose stress is a linear
    interpolation, ``fcVM.py:1486-1510``); with ``large_disp`` on the
    deformed coordinates.  A float64 ``disp`` (the refinement tier's) is
    cast to the storage dtype of ``coords`` first where it is read (with
    ``large_disp``): the record stays in that dtype.  ``weights``,
    ``reduce``, ``plan`` and ``table`` as in :func:`update_stress_load`."""
    if large_disp:
        disp = disp.to(coords.dtype)
    elv = kernels.stress_update(coords, elnodes, disp, sig_gp, large_disp, weights=weights,
                                table=table)
    return _node_sum(elv, elnodes, disp.shape[0], reduce, plan)
