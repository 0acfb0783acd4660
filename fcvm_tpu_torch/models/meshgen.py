"""Built-in tet10 mesh generators (CAD-free model building).

The reference relies on FreeCAD/Gmsh/Netgen for meshing; the bundled
``.FCStd`` documents do not ship their meshes, so the validation corpus here
is regenerated from parametric generators: structured boxes (Kuhn 6-tet
subdivision of a hex grid) and a quarter plate-with-hole.  All generators
emit the tet10 node convention of :mod:`fcvm_tpu_torch.models.spec`, and
number nodes exactly as :mod:`fcvm_tpu.models.meshgen` does.
"""

from __future__ import annotations

import numpy as np

from fcvm_tpu_torch.models.spec import Mesh, TET10_EDGES

# The 6 Kuhn simplices of the unit cube: each tet follows one permutation of
# axis increments from vertex (0,0,0) to (1,1,1).  Shared faces of adjacent
# cubes triangulate identically, so the grid is conforming.
_PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


def _cube_tets():
    """Corner-index quadruples (by binary xyz corner id) of the 6 Kuhn tets."""
    tets = []
    for p in _PERMS:
        v = [0, 0, 0, 0]
        acc = np.zeros(3, dtype=int)
        v[0] = 0
        for k, axis in enumerate(p):
            acc[axis] = 1
            v[k + 1] = acc[0] * 1 + acc[1] * 2 + acc[2] * 4
        tets.append(tuple(v))
    return tets


_CUBE_TETS = _cube_tets()


def _tet4_to_tet10(coords4: np.ndarray, tets4: np.ndarray):
    """Insert midside nodes on every unique edge of a tet4 mesh."""
    coords4 = np.asarray(coords4, dtype=np.float64)
    tets4 = np.asarray(tets4, dtype=np.int64)
    ne = len(tets4)

    edges = np.empty((ne, 6, 2), dtype=np.int64)
    for k, (a, b) in enumerate(TET10_EDGES):
        edges[:, k, 0] = tets4[:, a]
        edges[:, k, 1] = tets4[:, b]
    ekey = np.sort(edges.reshape(-1, 2), axis=1)
    uniq, inv = np.unique(ekey, axis=0, return_inverse=True)

    mid_coords = 0.5 * (coords4[uniq[:, 0]] + coords4[uniq[:, 1]])
    coords = np.concatenate([coords4, mid_coords], axis=0)

    elnodes = np.empty((ne, 10), dtype=np.int64)
    elnodes[:, :4] = tets4
    elnodes[:, 4:] = len(coords4) + inv.reshape(ne, 6)
    return Mesh(coords, elnodes)


def _fix_orientation(coords4, tets4):
    """Swap nodes 1<->2 of negative-volume tets so volumes are positive."""
    v = coords4[tets4]
    det = np.linalg.det(v[:, 1:4] - v[:, :1])
    flip = det < 0.0
    tets4[flip, 1], tets4[flip, 2] = tets4[flip, 2].copy(), tets4[flip, 1].copy()
    return tets4


def grid_tet10(xs, ys, zs, keep=None) -> Mesh:
    """Tet10 mesh on an explicit (possibly non-uniform) structured grid.

    ``xs/ys/zs`` are strictly-increasing breakpoint arrays.  ``keep(cx, cy,
    cz) -> bool`` (vectorized over cell-centroid arrays) optionally masks
    grid cells, so voxelized solids (L-shapes, cruciforms, ...) come out of
    the same conforming Kuhn subdivision; unused nodes are compacted away.
    """
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    zs = np.asarray(zs, dtype=np.float64)
    nx, ny, nz = len(xs) - 1, len(ys) - 1, len(zs) - 1
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    coords4 = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    if keep is not None:
        ci, cj, ck = np.meshgrid(
            np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
        )
        cx = 0.5 * (xs[ci] + xs[ci + 1])
        cy = 0.5 * (ys[cj] + ys[cj + 1])
        cz = 0.5 * (zs[ck] + zs[ck + 1])
        mask = np.asarray(keep(cx, cy, cz), dtype=bool)
    else:
        mask = None

    tets = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                if mask is not None and not mask[i, j, k]:
                    continue
                corner = np.array(
                    [vid(i + (c & 1), j + ((c >> 1) & 1), k + ((c >> 2) & 1)) for c in range(8)]
                )
                for tet in _CUBE_TETS:
                    tets.append(corner[list(tet)])
    tets4 = np.asarray(tets, dtype=np.int64)
    if mask is not None:
        used, inv = np.unique(tets4, return_inverse=True)
        coords4 = coords4[used]
        tets4 = inv.reshape(tets4.shape)
    tets4 = _fix_orientation(coords4, tets4)
    return _tet4_to_tet10(coords4, tets4)


def box_tet10(
    nx: int,
    ny: int,
    nz: int,
    lx: float = 1.0,
    ly: float = 1.0,
    lz: float = 1.0,
) -> Mesh:
    """Structured tet10 box mesh: ``6 * nx * ny * nz`` elements on [0,L]^3."""
    return grid_tet10(
        np.linspace(0.0, lx, nx + 1),
        np.linspace(0.0, ly, ny + 1),
        np.linspace(0.0, lz, nz + 1),
    )


def plate_with_hole_tet10(
    radius: float = 10.0,
    width: float = 50.0,
    height: float = 100.0,
    thickness: float = 5.0,
    n_circ: int = 8,
    n_rad: int = 6,
    n_thick: int = 1,
) -> Mesh:
    """Quarter plate with a central circular hole, extruded through thickness.

    A polar->rectangular blended quad grid in-plane (hole boundary exactly on
    the circle), each prism split into Kuhn tets.  Used to reproduce the
    reference's headline Plate_with_hole collapse example (net-section plastic
    limit ~ applied * (width - radius) / width with local stress concentration
    factor 3 at the hole).
    """
    # In-plane quad grid by transfinite blending between the quarter circle
    # and the outer rectangle boundary (two patches: lower-right, upper).
    # Outer boundary: walk the rectangle perimeter (width,0) -> corner
    # (width,height) -> (0,height) with a node snapped exactly onto the
    # corner, so the loaded edges are exact regardless of resolution.
    perim = height + width
    n1 = max(1, min(n_circ - 1, round(n_circ * height / perim)))
    outer_pts = np.zeros((n_circ + 1, 2))
    for ia in range(n_circ + 1):
        if ia <= n1:
            outer_pts[ia] = (width, height * ia / n1)
        else:
            outer_pts[ia] = (width - width * (ia - n1) / (n_circ - n1), height)

    angles = np.linspace(0.0, 0.5 * np.pi, n_circ + 1)
    pts = np.zeros((n_circ + 1, n_rad + 1, 2))
    for ia, a in enumerate(angles):
        inner = np.array([radius * np.cos(a), radius * np.sin(a)])
        outer = outer_pts[ia]
        for ir in range(n_rad + 1):
            s = ir / n_rad
            # grade toward the hole (stress concentration)
            s = s**1.2
            pts[ia, ir] = (1 - s) * inner + s * outer

    nz = n_thick
    zs = np.linspace(0.0, thickness, nz + 1)
    n_inplane = (n_circ + 1) * (n_rad + 1)
    coords4 = np.zeros((n_inplane * (nz + 1), 3))
    for kz, z in enumerate(zs):
        base = kz * n_inplane
        coords4[base : base + n_inplane, :2] = pts.reshape(-1, 2)
        coords4[base : base + n_inplane, 2] = z

    def pid(ia, ir, kz):
        return kz * n_inplane + ia * (n_rad + 1) + ir

    tets = []
    for ia in range(n_circ):
        for ir in range(n_rad):
            for kz in range(nz):
                corner = np.array(
                    [
                        pid(ia, ir, kz),
                        pid(ia, ir + 1, kz),
                        pid(ia + 1, ir, kz),
                        pid(ia + 1, ir + 1, kz),
                        pid(ia, ir, kz + 1),
                        pid(ia, ir + 1, kz + 1),
                        pid(ia + 1, ir, kz + 1),
                        pid(ia + 1, ir + 1, kz + 1),
                    ]
                )
                # map to the binary corner convention of _CUBE_TETS:
                # bit0 = radial, bit1 = angular, bit2 = thickness
                for tet in _CUBE_TETS:
                    tets.append(corner[list(tet)])
    tets4 = _fix_orientation(coords4, np.asarray(tets, dtype=np.int64))
    return _tet4_to_tet10(coords4, tets4)
