"""Ritz-deflation recycling for the PCG solve path: the port of
:mod:`fcvm_tpu.ops.deflation`.

Every PCG solve runs a preconditioned Lanczos process whose vectors it has
already computed.  A harvesting solve (:func:`fcvm_tpu_torch.ops.solver.pcg_harvest`)
keeps the first ``nstore`` preconditioned residuals and the CG coefficients;
the lowest Ritz vectors of ``M^-1 K`` they span form a basis ``W`` of the
slow subspace, and every later solve adds the correction

    z = M^-1 r + W (W^T K W)^+ W^T r

to its preconditioner.  The correction stays SPD for any PSD
``(W^T K W)^+``, so a stale space can slow CG but never break it.  The
driver's policy (harvest one correction solve, keep the space across load
steps, drop it when a deflated solve regresses) lives in
:mod:`fcvm_tpu_torch.runtime.driver`.

``K_hat @ W`` runs through K1m (:func:`fcvm_tpu_torch.ops.assembly.make_multi_matvec`).
The other ``(ndof, k)`` products here are plain PyTorch in the working dtype;
float32 runs in full float32 (no TF32, :func:`fcvm_tpu_torch.config.pin_full_fp32`),
the counterpart of the JAX package's HIGHEST matmul precision: the
correction must cancel the slow modes below the CG tolerance.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from fcvm_tpu_torch.ops import assembly as asm

# the driver's recycling sizes, the JAX package's defaults
# (``fcvm_tpu.config``: deflation_k, deflation_nstore, deflation_refresh_iters)
RITZ_K = 32  # Ritz vectors kept per space
NSTORE = 64  # preconditioned residuals stored per harvest
REFRESH_ITERS = 48  # a deflated solve this long marks the space stale


class DeflationSpace(NamedTuple):
    """Deflation basis + Galerkin inverse, in the space CG runs in."""

    w: torch.Tensor  # (ndof, k) basis (zero on fixed dofs)
    kw_inv: torch.Tensor  # (k, k) pseudo-inverse of W^T K_hat W


def deflated(precond, defl: Optional[DeflationSpace]):
    """Wrap a preconditioner apply with the deflation correction; the
    wrapped apply takes a vector (ndof,) or a block (ndof, m) and corrects
    each column as it does a vector."""
    if defl is None:
        return precond

    def apply(r):
        return precond(r) + defl.w @ (defl.kw_inv @ (defl.w.T @ r))

    return apply


def ritz_coefficients(alphas, betas, rzs, iters: int, k: int, ghost_rtol: float = 1.0e-4):
    """Host-side Ritz extraction from stored PCG coefficients.

    Builds the Lanczos tridiagonal ``T`` of the preconditioned operator from
    the CG alpha/beta recurrence (Saad, Iterative Methods, sec. 6.7), drops
    ghost duplicates (re-converged copies of an eigenpair, an artifact of
    finite-precision Lanczos), and returns the combination coefficients of
    the ``k`` lowest Ritz vectors in the stored preconditioned residuals:
    ``W = Z.T @ coef`` with ``v_j = (-1)^j z_j / sqrt(r_j^T z_j)``.

    The result is a float32 ``(nstore, k)`` array, zero-padded: zero columns
    make zero ``W`` columns, which the pseudo-inverse of the Galerkin matrix
    ignores.  The float32 rounding is the JAX package's; float64 runs keep
    it so both packages build the same basis.  Takes host arrays; returns
    ``None`` when fewer than 3 valid iterations are available or the
    coefficients are not those of an SPD solve.
    """
    nstore = int(np.asarray(alphas).shape[0])
    m = min(int(iters), nstore - 2)
    if m < 3:
        return None
    a = np.asarray(alphas)[:m].astype(np.float64)
    bt = np.asarray(betas)[:m].astype(np.float64)
    rz = np.asarray(rzs)[:m].astype(np.float64)
    if not (np.all(np.isfinite(a)) and np.all(a > 0.0)
            and np.all(np.isfinite(bt)) and np.all(bt >= 0.0)
            and np.all(rz > 0.0)):
        return None
    diag = np.empty(m)
    off = np.empty(m - 1)
    diag[0] = 1.0 / a[0]
    for j in range(1, m):
        diag[j] = 1.0 / a[j] + bt[j - 1] / a[j - 1]
        off[j - 1] = np.sqrt(bt[j - 1]) / a[j - 1]
    t = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
    evals, evecs = np.linalg.eigh(t)
    keep = []
    for j in range(m):
        if all(abs(evals[j] - evals[i]) > ghost_rtol * max(abs(evals[j]), 1e-30)
               for i in keep):
            keep.append(j)
        if len(keep) >= k:
            break
    sgn = (-1.0) ** np.arange(m)
    scale = sgn / np.sqrt(rz)
    coef = np.zeros((nstore, k), dtype=np.float32)
    coef[:m, : len(keep)] = scale[:, None] * evecs[:, np.asarray(keep)]
    return coef


def build_w(zs, coef, fixmask):
    """(ndof, k) deflation basis from stored residuals ``zs`` (nstore, ndof)
    and Ritz coefficients ``coef`` (nstore, k), zero on fixed dofs."""
    coef = torch.as_tensor(coef, device=zs.device).to(zs.dtype)
    return fixmask[:, None] * (zs[: coef.shape[0]].T @ coef)


def block_khat_matvec(esm_t, eldofs, fixmask, w, incidence=None, packed=None):
    """``K_hat @ W`` for a (ndof, k) block of vectors in one pass (K1m).

    ``esm_t`` holds the element blocks element-major, (30, 30, ne), as the
    operator stores them; ``eldofs`` (ne, 30); ``incidence`` and on the
    card ``packed``, the operator's node-incidence table and packed blocks,
    are made here when not given
    (:func:`fcvm_tpu_torch.ops.assembly.make_multi_matvec`)."""
    return asm.make_multi_matvec(esm_t, eldofs, fixmask, incidence=incidence, packed=packed)(w)


def galerkin(esm_t, eldofs, fixmask, w, incidence=None, packed=None):
    """(k, k) Galerkin matrix ``W^T K_hat W`` on the current operator."""
    return w.T @ block_khat_matvec(esm_t, eldofs, fixmask, w, incidence, packed)


def build_space(esm_t, eldofs, fixmask, zs, coef, incidence=None, packed=None) -> DeflationSpace:
    """Deflation space from harvested residuals ``zs`` and Ritz
    coefficients ``coef`` on the operator of blocks ``esm_t`` (its
    ``incidence`` and ``packed`` as in :func:`block_khat_matvec`)."""
    w = build_w(zs, coef, fixmask)
    return DeflationSpace(w, pinv_psd(galerkin(esm_t, eldofs, fixmask, w, incidence, packed)))


def pinv_psd(kw):
    """PSD pseudo-inverse of the (k, k) Galerkin matrix.

    A pseudo-inverse, not an inverse: Ritz pairs can be nearly dependent and
    zero-padded coefficient columns make exactly singular blocks.  It
    computes in the working dtype on every device (the JAX package drops to
    float32 only on a TPU, which has no float64 factorisation)."""
    rcond = 1.0e-10 if kw.dtype == torch.float64 else 1.0e-5
    evals, evecs = torch.linalg.eigh(0.5 * (kw + kw.T))
    cutoff = rcond * evals.abs().max()
    good = evals > cutoff
    inv = torch.where(good, 1.0 / torch.where(good, evals, torch.ones_like(evals)),
                      torch.zeros_like(evals))
    return (evecs * inv[None, :]) @ evecs.T
