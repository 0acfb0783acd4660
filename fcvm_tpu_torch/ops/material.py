"""Constitutive model: linear elasticity + von Mises radial return + damage.

The port of :mod:`fcvm_tpu.ops.material`, batched over leading dimensions:

* ``hooke``      -> :func:`hooke_dmat`            (``fcVM.py:570-582``)
* ``vmises_original_optimised`` -> :func:`radial_return`  (``fcVM.py:2468-2492``)
* ``update_PEEQ_CSR`` -> :func:`update_peeq_csr`  (``fcVM.py:2084-2137``)

The reference's inter-step hardening ``sig_yield += Et * DL`` (not the
textbook ``H * DL``) is kept on purpose: results follow the reference.

Material constants are numbers (one material) or (ne,) tensors (a model's
``materials_by_element``): :func:`per_gauss` and :func:`apply_dmat` make
either broadcast over the 4 Gauss points of every element.
"""

from __future__ import annotations

import math

import torch


def hooke_dmat(e, nu, dtype, device) -> torch.Tensor:
    """Isotropic 6x6 elasticity matrix in Voigt order [xx,yy,zz,xy,zx,yz].

    Engineering shear strains (factor ``sd`` on the shear diagonal),
    matching the reference (``fcVM.py:570-582``).
    """
    e = torch.as_tensor(e, dtype=dtype, device=device)
    nu = torch.as_tensor(nu, dtype=dtype, device=device)
    dm = e * (1.0 - nu) / (1.0 + nu) / (1.0 - 2.0 * nu)
    od = nu / (1.0 - nu)
    sd = 0.5 * (1.0 - 2.0 * nu) / (1.0 - nu)
    dmat = torch.zeros(e.shape + (6, 6), dtype=dtype, device=device)
    for i in range(3):
        dmat[..., i, i] = 1.0
        dmat[..., 3 + i, 3 + i] = sd
    for i, j in ((0, 1), (0, 2), (1, 2), (1, 0), (2, 0), (2, 1)):
        dmat[..., i, j] = od
    return dmat * dm[..., None, None]


def per_gauss(x):
    """A per-element (ne,) tensor as (ne, 1), to broadcast over the Gauss
    points of (ne, 4) state; a number stays a number."""
    return x[:, None] if torch.is_tensor(x) and x.dim() == 1 else x


def apply_dmat(dmat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``D x`` over the last axis of ``x`` (ne, 4, 6, ...) for one (6, 6)
    matrix or per-element (ne, 6, 6) matrices."""
    if dmat.dim() == 2:
        return torch.einsum("kl,egl...->egk...", dmat, x)
    return torch.einsum("ekl,egl...->egk...", dmat, x)


def voigt_to_tensor(sig: torch.Tensor) -> torch.Tensor:
    """(..., 6) Voigt [xx,yy,zz,xy,zx,yz] -> (..., 3, 3) symmetric tensor."""
    sxx, syy, szz = sig[..., 0], sig[..., 1], sig[..., 2]
    sxy, szx, syz = sig[..., 3], sig[..., 4], sig[..., 5]
    return torch.stack([
        torch.stack([sxx, sxy, szx], dim=-1),
        torch.stack([sxy, syy, syz], dim=-1),
        torch.stack([szx, syz, szz], dim=-1),
    ], dim=-2)


def tensor_to_voigt(s: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric tensor -> (..., 6) Voigt [xx,yy,zz,xy,zx,yz]."""
    return torch.stack([s[..., 0, 0], s[..., 1, 1], s[..., 2, 2],
                        s[..., 0, 1], s[..., 0, 2], s[..., 1, 2]], dim=-1)


def shear_modulus(e, nu):
    return e / (1.0 + nu) / 2.0


def hardening_modulus(e, et_e):
    """Plastic hardening modulus H from the tangent/elastic ratio Et/E.

    The reference caps Et/E at 0.95 (``fcVM.py:952-954``)."""
    et_e = min(et_e, 0.95)
    return et_e * e / (1.0 - et_e)


def von_mises(sig: torch.Tensor):
    """Deviator, pressure and von Mises stress of Voigt stresses (..., 6)."""
    p = (sig[..., 0] + sig[..., 1] + sig[..., 2]) / 3.0
    dev = sig.clone()
    dev[..., :3] -= p[..., None]
    svm = torch.sqrt(
        1.5 * (dev[..., 0] ** 2 + dev[..., 1] ** 2 + dev[..., 2] ** 2)
        + 3.0 * (dev[..., 3] ** 2 + dev[..., 4] ** 2 + dev[..., 5] ** 2)
    )
    return dev, p, svm


def radial_return(sig_test: torch.Tensor, sig_yield: torch.Tensor, h, g):
    """Return trial stresses to the von Mises surface with isotropic hardening.

    Masked form of the reference's scalar routine (``fcVM.py:2468-2492``):
    scale the deviator by ``1 - (1 - sy/svm) * 3G / (H + 3G)`` where the
    point is plastic.

    Returns:
      (sig_new, plastic) where ``plastic`` is a (...,) bool mask of plastic
      Gauss points (the reference's ``pgp``).
    """
    dev, p, svm = von_mises(sig_test)
    plastic = svm >= sig_yield
    svm_safe = torch.where(svm == 0.0, torch.ones_like(svm), svm)
    fac_plastic = 1.0 - (1.0 - sig_yield / svm_safe) * 3.0 * g / (h + 3.0 * g)
    fac = torch.where(plastic, fac_plastic, torch.ones_like(fac_plastic))
    sig_new = dev * fac[..., None]
    sig_new[..., :3] += p[..., None]
    return sig_new, plastic


def update_peeq_csr(sig_test, sig_new, sig_yield, peeq, csr, e, nu, et_e,
                    ultimate_strain):
    """End-of-step damage/ductility state update (``fcVM.py:2084-2137``).

    Per Gauss point: plastic increment ``DL = (svm_test - sy) / (3G + H)``,
    PEEQ accumulation, isotropic hardening ``sy += Et * DL`` (the
    reference's quirk), triaxiality ``T = p / sy``, critical strain
    ``eps_cr = sqrt(e) * eps_u * exp(-1.5 T)`` (floored at 1e-6), and
    Miner-rule damage ``CSR += DL / eps_cr``.

    Returns:
      (sig_yield, peeq, csr, triax, pressure, sigmises, ecr), all (...,).
    """
    g = shear_modulus(e, nu)
    et_e_c = min(et_e, 0.95)
    et = et_e_c * e
    h = et / (1.0 - et_e_c)
    ultimate = 1.0e12 if ultimate_strain == 0.0 else ultimate_strain
    alpha = math.sqrt(math.e) * ultimate  # triaxiality T = 1/3 in uniaxial test
    beta = 1.5

    _, _, svm_test = von_mises(sig_test)
    _, p_n, svm_new = von_mises(sig_new)

    dl = torch.where(svm_test > sig_yield, (svm_test - sig_yield) / (3.0 * g + h),
                     torch.zeros_like(svm_test))
    peeq = peeq + dl
    sig_yield = sig_yield + et * dl

    triax = p_n / sig_yield
    ecr = torch.clamp(alpha * torch.exp(-beta * triax), min=1.0e-6)
    csr = csr + dl / ecr
    return sig_yield, peeq, csr, triax, p_n, svm_new, ecr
