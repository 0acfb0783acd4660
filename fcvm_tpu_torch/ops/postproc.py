"""Result post-processing: Gauss->node mapping, principal stresses,
surface/edge averaging, reinforcement design.

Vectorized numpy rebuilds of the reference's numba post-processing kernels:

* ``mapStresses``                 -> :func:`map_stresses`       (``fcVM.py:2496-2554``)
* ``calculate_principal_stress``  -> :func:`principal_stresses` (``fcVM.py:2953-2994``)
* ``calcSum``                     -> :func:`integrate_edges` / :func:`integrate_faces` (``fcVM.py:2830-2900``)
* ``calculate_rho``               -> :func:`reinforcement_rho`  (``fcVM.py:2997-3150``)
* ``calculate_mohr_coulomb``      -> :func:`mohr_coulomb`       (``fcVM.py:3153-3168``)

The port's copy of :mod:`fcvm_tpu.ops.postproc`.  These run on the host
after the solve (they are output-bound, not compute-bound), in numpy as in
the JAX package, on the numpy arrays of the results; the face integrals
take the surface Jacobians from :func:`fcvm_tpu_torch.ops.elements.tri6_surface_frame`
on float64 CPU tensors, batched over a group's faces.
"""

from __future__ import annotations

import numpy as np
import torch

from fcvm_tpu_torch.models.spec import TET10_EDGES
from fcvm_tpu_torch.ops import elements as el


def map_stresses(
    averaged: bool,
    elnodes: np.ndarray,
    n_nodes: int,
    sig_gp: np.ndarray,
    peeq_gp: np.ndarray,
    csr_gp: np.ndarray,
    svm_gp: np.ndarray,
    noce: np.ndarray,
    sig_yield: float,
):
    """Gauss-point (4/element) -> nodal fields.

    Stresses are always averaged over adjacent elements (divided by ``noce``);
    scalars are averaged or element-maxed depending on ``averaged``
    (``fcVM.py:2519-2539``).  Midside nodes are interpolated from their two
    edge corners (the fixed 0.5 stencil ``map_inter``, ``fcVM.py:2500-2552``).

    Returns (stress (nn, 6), peeq, csr, svm, triax) nodal arrays.
    """
    ne = len(elnodes)
    corners = elnodes[:, :4]  # (ne, 4)
    triax_gp = (sig_gp[..., 0] + sig_gp[..., 1] + sig_gp[..., 2]) / 3.0 / sig_yield

    stress = np.zeros((n_nodes, 6))
    w = 1.0 / noce[corners]  # (ne, 4)
    np.add.at(stress, corners.reshape(-1), (sig_gp * w[..., None]).reshape(-1, 6))

    def nodal_scalar(gp_field):
        out = np.zeros(n_nodes)
        if averaged:
            np.add.at(out, corners.reshape(-1), (gp_field * w).reshape(-1))
        else:
            np.maximum.at(out, corners.reshape(-1), gp_field.reshape(-1))
        return out

    peeq = nodal_scalar(peeq_gp)
    csr = nodal_scalar(csr_gp)
    svm = nodal_scalar(svm_gp)
    triax = nodal_scalar(triax_gp)

    # midside nodes: mean of the two edge-corner values
    mids = elnodes[:, 4:].reshape(-1)
    pa = np.empty((ne, 6), dtype=np.int64)
    pb = np.empty((ne, 6), dtype=np.int64)
    for k, (a, b) in enumerate(TET10_EDGES):
        pa[:, k] = elnodes[:, a]
        pb[:, k] = elnodes[:, b]
    pa = pa.reshape(-1)
    pb = pb.reshape(-1)
    stress[mids] = 0.5 * (stress[pa] + stress[pb])
    for arr in (peeq, csr, svm, triax):
        arr[mids] = 0.5 * (arr[pa] + arr[pb])
    return stress, peeq, csr, svm, triax


def principal_stresses(stress: np.ndarray):
    """Sorted principal stresses + scaled principal direction vectors.

    Args:
      stress: (nn, 6) Voigt [xx,yy,zz,xy,zx,yz].

    Returns:
      (s1, s2, s3, v1, v2, v3): scalars (nn,), vectors (nn, 3) scaled by
      their eigenvalue (``fcVM.py:2986-2992``).
    """
    t = np.zeros((len(stress), 3, 3))
    t[:, 0, 0] = stress[:, 0]
    t[:, 1, 1] = stress[:, 1]
    t[:, 2, 2] = stress[:, 2]
    t[:, 0, 1] = t[:, 1, 0] = stress[:, 3]
    t[:, 0, 2] = t[:, 2, 0] = stress[:, 4]
    t[:, 1, 2] = t[:, 2, 1] = stress[:, 5]
    vals, vecs = np.linalg.eigh(t)  # ascending
    vals = vals[:, ::-1]
    vecs = vecs[:, :, ::-1]
    v1 = vals[:, 0, None] * vecs[:, :, 0]
    v2 = vals[:, 1, None] * vecs[:, :, 1]
    v3 = vals[:, 2, None] * vecs[:, :, 2]
    return vals[:, 0], vals[:, 1], vals[:, 2], v1, v2, v3


def integrate_edges(edge_groups, coords, *fields):
    """Length-averaged field values over groups of line3 edge elements.

    Args:
      edge_groups: list of (n_i, 3) node-id arrays (one group per named edge).
      fields: nodal arrays to average.

    Returns:
      (lengths, [averages per field]) — the reference's per-edge rows
      (``fcVM.py:2840-2865``).
    """
    lengths = []
    avgs = [[] for _ in fields]
    coords = np.asarray(coords, dtype=np.float64)
    for group in edge_groups:
        group = np.asarray(group, dtype=np.int64).reshape(-1, 3)
        dx = np.einsum("gk,eki->egi", el.DSHP2_AT_GP, coords[group])  # (n, 2, 3)
        xsj = np.linalg.norm(dx, axis=-1)  # (n, 2)
        dl = el.SHP2_AT_GP[None] * (xsj * el.W2)[:, :, None]  # (n, 2 gp, 3 nodes)
        _append_averages(lengths, avgs, dl, group, fields)
    return lengths, avgs


def integrate_faces(face_groups, coords, *fields):
    """Area-averaged field values over groups of tri6 face elements
    (``fcVM.py:2872-2898``)."""
    areas = []
    avgs = [[] for _ in fields]
    coords = np.asarray(coords, dtype=np.float64)
    for group in face_groups:
        group = np.asarray(group, dtype=np.int64).reshape(-1, 6)
        xsj, _ = el.tri6_surface_frame(torch.from_numpy(coords[group]))
        xsj = np.abs(xsj.numpy())  # (n, 6 gp)
        da = el.SHP6_AT_GP[None] * (xsj * el.W6)[:, :, None]  # (n, 6 gp, 6 nodes)
        _append_averages(areas, avgs, da, group, fields)
    return areas, avgs


def _append_averages(measures, avgs, dm, group, fields):
    """Append a group's total measure (``dm`` summed) and the
    measure-weighted mean of each nodal field over it."""
    total = float(dm.sum())
    measures.append(total)
    for i, f in enumerate(fields):
        weighted = float((dm * np.asarray(f)[group][:, None, :]).sum())
        avgs[i].append(weighted / total if total > 0 else 0.0)


def _where_div(num, den):
    """num/den where den != 0, else 0 — the published forms leave a
    candidate component at zero when its divisor vanishes."""
    ok = den != 0.0
    return np.where(ok, num / np.where(ok, den, 1.0), 0.0)


def reinforcement_rho(stress: np.ndarray, fy: float) -> np.ndarray:
    """Orthogonal reinforcement ratios per node (HERON 53-4 closed forms).

    Batched over all nodes and all 15 candidate solutions at once: build an
    (n, 15, 3) tensor of candidate reinforcement stresses (rho*fy), mask the
    candidates whose ratios are negative or whose residual concrete stress
    state is not admissible (all-compressive invariants), and pick the
    minimum-total-reinforcement candidate per node with a masked argmin.
    Functional equivalent of the reference's per-node numba scan
    (``fcVM.py:2997-3150``); same published closed forms, array-shaped.
    """
    s = np.asarray(stress, dtype=np.float64).reshape(-1, 6)
    n = len(s)
    sxx, syy, szz, sxy, sxz, syz = (s[:, i] for i in range(6))
    i3 = (
        sxx * syy * szz + 2 * sxy * sxz * syz
        - sxx * syz**2 - syy * sxz**2 - szz * sxy**2
    )

    # Candidate reinforcement stresses (rho * fy), one (n, 3) slab each.
    z = np.zeros(n)
    fc_x = _where_div(sxz * sxy, sxx) - np.where(sxx != 0.0, syz, 0.0)
    fc_y = _where_div(syz * sxy, syy) - np.where(syy != 0.0, sxz, 0.0)
    fc_z = _where_div(sxz * syz, szz) - np.where(szz != 0.0, sxy, 0.0)
    gx, gy, gz = sxx != 0.0, syy != 0.0, szz != 0.0
    cands = np.stack(
        [
            np.stack([z, z, _where_div(i3, sxx * syy - sxy**2)], axis=1),
            np.stack([z, _where_div(i3, sxx * szz - sxz**2), z], axis=1),
            np.stack([_where_div(i3, syy * szz - syz**2), z, z], axis=1),
            np.stack(
                [z,
                 np.where(gx, syy - _where_div(sxy**2, sxx) + fc_x, 0.0),
                 np.where(gx, szz - _where_div(sxz**2, sxx) + fc_x, 0.0)],
                axis=1,
            ),
            np.stack(
                [z,
                 np.where(gx, syy - _where_div(sxy**2, sxx) - fc_x, 0.0),
                 np.where(gx, szz - _where_div(sxz**2, sxx) - fc_x, 0.0)],
                axis=1,
            ),
            np.stack(
                [np.where(gy, sxx - _where_div(sxy**2, syy) + fc_y, 0.0),
                 z,
                 np.where(gy, szz - _where_div(syz**2, syy) + fc_y, 0.0)],
                axis=1,
            ),
            np.stack(
                [np.where(gy, sxx - _where_div(sxy**2, syy) - fc_y, 0.0),
                 z,
                 np.where(gy, szz - _where_div(syz**2, syy) - fc_y, 0.0)],
                axis=1,
            ),
            np.stack(
                [np.where(gz, sxx - _where_div(sxz**2, szz) + fc_z, 0.0),
                 np.where(gz, syy - _where_div(syz**2, szz) + fc_z, 0.0),
                 z],
                axis=1,
            ),
            np.stack(
                [np.where(gz, sxx - _where_div(sxz**2, szz) - fc_z, 0.0),
                 np.where(gz, syy - _where_div(syz**2, szz) - fc_z, 0.0),
                 z],
                axis=1,
            ),
            np.stack([sxx + sxy + sxz, syy + sxy + syz, szz + sxz + syz], axis=1),
            np.stack([sxx + sxy - sxz, syy + sxy - syz, szz - sxz - syz], axis=1),
            np.stack([sxx - sxy - sxz, syy - sxy + syz, szz - sxz + syz], axis=1),
            np.stack([sxx - sxy + sxz, syy - sxy - syz, szz + sxz - syz], axis=1),
            np.stack(
                [sxx - _where_div(sxy * sxz, syz),
                 syy - _where_div(sxy * syz, sxz),
                 szz - _where_div(sxz * syz, sxy)],
                axis=1,
            ),
            np.stack([z, z, z], axis=1),  # fallback: no reinforcement
        ],
        axis=1,
    )  # (n, 15, 3) in stress units

    # Feasibility: non-negative ratios (tolerance in rho units) ...
    tol = 1.0e-10 * fy
    feas = (
        (cands[:, :, 0] >= -tol)
        & (cands[:, :, 1] >= -tol)
        & (cands[:, :, 2] > -tol)
    )
    # ... and an admissible residual concrete state: subtracting the
    # reinforcement stresses must leave all-compressive principal stresses
    # (invariant sign tests, tolerances in stress units as in the reference).
    scx = sxx[:, None] - cands[:, :, 0]
    scy = syy[:, None] - cands[:, :, 1]
    scz = szz[:, None] - cands[:, :, 2]
    shear2 = (sxy**2 + sxz**2 + syz**2)[:, None]
    ic1 = scx + scy + scz
    ic2 = scx * scy + scy * scz + scz * scx - shear2
    ic3 = (
        scx * scy * scz + (2 * sxy * sxz * syz)[:, None]
        - scx * (syz**2)[:, None] - scy * (sxz**2)[:, None]
        - scz * (sxy**2)[:, None]
    )
    feas &= (ic1 <= 1e-6) & (ic2 >= -1e-6) & (ic3 <= 1e-6)
    rsum = cands.sum(axis=2)
    feas &= rsum > 0.0

    # Minimum-total-reinforcement admissible candidate; rows with none fall
    # back to candidate 14 (zero reinforcement).
    rsum_m = np.where(feas, rsum, np.inf)
    eq = np.argmin(rsum_m, axis=1)
    eq = np.where(np.isfinite(rsum_m[np.arange(n), eq]), eq, 14)
    return cands[np.arange(n), eq] / fy


def mohr_coulomb(prin1, prin3, phi: float, fck: float):
    """Mohr-Coulomb crushing/shear check (``fcVM.py:3153-3168``)."""
    coh = fck * (1 - np.sin(phi)) / 2 / np.cos(phi)
    mc = (prin1 - prin3) + (prin1 + prin3) * np.sin(phi) - 2.0 * coh * np.cos(phi)
    return np.maximum(mc, 0.0)
