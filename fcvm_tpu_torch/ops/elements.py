"""Tet10 / tri6 / line3 element kernels, batched over leading dimensions.

The port of :mod:`fcvm_tpu.ops.elements`: the numpy shape-function tables
are the same, and each JAX per-element function (``vmap``-ed there) is
written here once for a whole batch.  Voigt ordering follows the reference:
``[xx, yy, zz, xy, zx, yz]`` (``fcVM.py:464-478``).  Float32 products run
in full float32 (no TF32, :func:`fcvm_tpu_torch.config.pin_full_fp32`): the
geometry must be bit-consistent between element formation and the stress
update, or the operator disagrees with the internal force.
"""

from __future__ import annotations

import numpy as np
import torch

from fcvm_tpu_torch.ops.quadrature import GP10, GP6, GP2
from fcvm_tpu_torch.utils.linalg3 import inv3


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def tet10_shape_np(xi: float, et: float, ze: float) -> np.ndarray:
    """Shape functions of the 10-node tet (reference ``fcVM.py:364-380``)."""
    a = 1.0 - xi - et - ze
    return np.array(
        [
            (2.0 * a - 1.0) * a,
            xi * (2.0 * xi - 1.0),
            et * (2.0 * et - 1.0),
            ze * (2.0 * ze - 1.0),
            4.0 * xi * a,
            4.0 * xi * et,
            4.0 * et * a,
            4.0 * ze * a,
            4.0 * xi * ze,
            4.0 * et * ze,
        ]
    )


def tet10_dshape_local_np(xi: float, et: float, ze: float) -> np.ndarray:
    """Local derivatives (3, 10) of the tet10 shape functions.

    Matches the hand-written tables in the reference
    (``fcVM.py:390-424``; source: CalculiX, G. Dhondt).
    """
    d = np.zeros((3, 10))
    a = 1.0 - 4.0 * (1.0 - xi - et - ze)
    d[0, 0] = a
    d[0, 1] = 4.0 * xi - 1.0
    d[0, 4] = 4.0 * (1.0 - 2.0 * xi - et - ze)
    d[0, 5] = 4.0 * et
    d[0, 6] = -4.0 * et
    d[0, 7] = -4.0 * ze
    d[0, 8] = 4.0 * ze

    d[1, 0] = a
    d[1, 2] = 4.0 * et - 1.0
    d[1, 4] = -4.0 * xi
    d[1, 5] = 4.0 * xi
    d[1, 6] = 4.0 * (1.0 - xi - 2.0 * et - ze)
    d[1, 7] = -4.0 * ze
    d[1, 9] = 4.0 * ze

    d[2, 0] = a
    d[2, 3] = 4.0 * ze - 1.0
    d[2, 4] = -4.0 * xi
    d[2, 6] = -4.0 * et
    d[2, 7] = 4.0 * (1.0 - xi - et - 2.0 * ze)
    d[2, 8] = 4.0 * xi
    d[2, 9] = 4.0 * et
    return d


# Compile-time constant tables at the 4 tet10 Gauss points.
SHP10_AT_GP = np.stack([tet10_shape_np(*gp[:3]) for gp in GP10])  # (4, 10)
DSHP10_AT_GP = np.stack([tet10_dshape_local_np(*gp[:3]) for gp in GP10])  # (4, 3, 10)
W10 = GP10[:, 3].copy()  # (4,)


def tet10_element_geometry(coords_el: torch.Tensor):
    """detJ, dshpg and B at the 4 Gauss points of a batch of elements.

    Args:
      coords_el: (..., 10, 3) nodal coordinates.

    Returns:
      det: (..., 4), dshpg: (..., 4, 3, 10) with ``dshpg[g, i, j] =
      dN_j/dx_i`` (``fcVM.py:426-460``), bmat: (..., 4, 6, 30) in Voigt row
      order with engineering shear strains (``fcVM.py:464-478``).
    """
    dshp = _const(DSHP10_AT_GP, coords_el)  # (4, 3, 10)
    xs = torch.einsum("...ki,gjk->...gij", coords_el, dshp)
    xsi, det = inv3(xs)
    dshpg = torch.einsum("...gki,gkj->...gij", xsi, dshp)
    d0, d1, d2 = dshpg[..., 0, :], dshpg[..., 1, :], dshpg[..., 2, :]
    z = torch.zeros_like(d0)
    rows = torch.stack(
        [
            torch.stack([d0, z, z], dim=-1),  # eps_xx
            torch.stack([z, d1, z], dim=-1),  # eps_yy
            torch.stack([z, z, d2], dim=-1),  # eps_zz
            torch.stack([d1, d0, z], dim=-1),  # gam_xy
            torch.stack([d2, z, d0], dim=-1),  # gam_zx
            torch.stack([z, d2, d1], dim=-1),  # gam_yz
        ],
        dim=-3,
    )  # (..., 4, 6, 10, 3)
    bmat = rows.reshape(rows.shape[:-2] + (30,))
    return det, dshpg, bmat


def tri6_shape_np(xi: float, et: float) -> np.ndarray:
    """6-node triangle shape functions (reference ``fcVM.py:491-496``)."""
    return np.array(
        [
            (1.0 - xi - et) * (1.0 - 2.0 * xi - 2.0 * et),
            xi * (2.0 * xi - 1.0),
            et * (2.0 * et - 1.0),
            4.0 * xi * (1.0 - xi - et),
            4.0 * xi * et,
            4.0 * et * (1.0 - xi - et),
        ]
    )


def tri6_dshape_np(xi: float, et: float) -> np.ndarray:
    """(2, 6) local derivatives of the tri6 shape functions
    (reference ``fcVM.py:498-512``)."""
    return np.array(
        [
            [
                -3.0 + 4.0 * et + 4.0 * xi,
                -1.0 + 4.0 * xi,
                0.0,
                -4.0 * (-1.0 + et + 2.0 * xi),
                4.0 * et,
                -4.0 * et,
            ],
            [
                -3.0 + 4.0 * et + 4.0 * xi,
                0.0,
                -1.0 + 4.0 * et,
                -4.0 * xi,
                4.0 * xi,
                -4.0 * (-1.0 + 2.0 * et + xi),
            ],
        ]
    )


SHP6_AT_GP = np.stack([tri6_shape_np(*gp[:2]) for gp in GP6])  # (6, 6)
DSHP6_AT_GP = np.stack([tri6_dshape_np(*gp[:2]) for gp in GP6])  # (6, 2, 6)
W6 = GP6[:, 2].copy()


def tri6_surface_frame(coords_face: torch.Tensor):
    """Area Jacobians and unit normals of tri6 faces at the 6 Gauss points.

    Args:
      coords_face: (..., 6, 3) face node coordinates.

    Returns:
      xsj: (..., 6) area Jacobian magnitude; normal: (..., 6, 3) unit
      normals (the reference's ``xp``, ``fcVM.py:514-527``).
    """
    dshp = _const(DSHP6_AT_GP, coords_face)  # (6, 2, 6)
    xs = torch.einsum("gak,...ki->...gai", dshp, coords_face)  # (..., 6, 2, 3)
    xp = torch.linalg.cross(xs[..., 0, :], xs[..., 1, :])  # normal * |J|
    xsj = torch.linalg.vector_norm(xp, dim=-1)
    normal = xp / xsj[..., None]
    return xsj, normal


def line3_shape_np(xi: float) -> np.ndarray:
    """3-node line shape functions (reference ``fcVM.py:544-552``)."""
    return np.array(
        [-0.5 * (1.0 - xi) * xi, 0.5 * (1.0 + xi) * xi, (1.0 + xi) * (1.0 - xi)]
    )


def line3_dshape_np(xi: float) -> np.ndarray:
    return np.array([xi - 0.5, xi + 0.5, -2.0 * xi])


SHP2_AT_GP = np.stack([line3_shape_np(gp[0]) for gp in GP2])  # (2, 3)
DSHP2_AT_GP = np.stack([line3_dshape_np(gp[0]) for gp in GP2])  # (2, 3)
W2 = GP2[:, 1].copy()


def line3_jacobian(coords_edge: torch.Tensor) -> torch.Tensor:
    """Arc-length Jacobian of 3-node edges at both Gauss points.

    Args:
      coords_edge: (..., 3, 3) edge node coordinates (3 nodes x xyz).

    Returns:
      xsj: (..., 2) (reference ``fcVM.py:554-563``).
    """
    dshp = _const(DSHP2_AT_GP, coords_edge)  # (2, 3)
    dx = torch.einsum("gk,...ki->...gi", dshp, coords_edge)
    return torch.linalg.vector_norm(dx, dim=-1)
