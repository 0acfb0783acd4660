"""FreeCAD ``.FCStd`` document ingest — CAD-kernel-free replay of the
reference's golden corpus.

The port's copy of :mod:`fcvm_tpu.models.fcstd` on the port's own model
modules: host numpy and ``scipy.spatial``, with no device work.  The
:class:`Model` it builds is handed to the driver, which converts its arrays
to tensors as it does for a TOML case.

The reference extracts mesh, materials, Dirichlet constraints and loads from
a *live* FreeCAD document through the CAD API (``fcVM.py:122-347``).  An
``.FCStd`` file on disk is just a zip archive holding everything those API
calls would return:

* ``Document.xml`` — every object's properties: constraint types and values
  (``Fem::ConstraintFixed/Displacement/Force/Pressure``), material cards,
  and the mesh object's placement;
* ``FemMesh.unv`` — the Gmsh-generated tet10 volume mesh (I-DEAS UNV);
* per-constraint ``Points``/``Normals`` vector-list blobs — the sample
  clouds FreeCAD computed **on the referenced CAD faces** to draw the
  constraint markers.  They are dense enough to resolve which mesh boundary
  entities a constraint applies to, geometrically, with no OCCT kernel.

Constraint semantics reproduced from the reference:

* ``ConstraintFixed``: every node on the referenced boundary gets all three
  dofs pinned to zero (``fcVM.py:196-258``).
* ``ConstraintDisplacement``: per-axis ``xFree/yFree/zFree`` +
  ``x/y/zDisplacement`` values (``fcVM.py:201-203``).
* ``ConstraintForce``: total force ``F`` along ``DirectionVector``,
  distributed per reference kind by vertex count / edge length / face area
  (``fcVM.py:289-326``).  The reference uses CAD areas; we integrate the
  resolved tri6/line3 mesh entities — identical load sums up to mesh
  faceting error.
* ``ConstraintPressure``: follower pressure ``sign*p`` on tri6 faces with
  ``sign=+1`` if ``Reversed`` else ``-1`` (``fcVM.py:270-285``).

Unit handling: old-style ``App::PropertyFloat`` stores N / MPa directly
(the reference's pre-0.22 branch uses the raw value, ``fcVM.py:287,294``);
quantity properties (``App::PropertyForce/Pressure``) store FreeCAD internal
mm-kg-s units (milli-newton, kPa) and are converted, mirroring the
``getValueAs`` branch (``fcVM.py:292-296``).
"""

from __future__ import annotations

import dataclasses
import re
import struct
import tempfile
import warnings
import zipfile
from pathlib import Path
from typing import Optional
from xml.etree import ElementTree as ET

import numpy as np

from fcvm_tpu_torch.models.inp import ControlParams
from fcvm_tpu_torch.models.spec import (
    BoundaryConditions,
    Loads,
    Material,
    Mesh,
    Model,
    distribute_total_force,
)

# ---------------------------------------------------------------------------
# Low-level decoding
# ---------------------------------------------------------------------------


def _read_vectorlist(data: bytes) -> np.ndarray:
    """Decode an ``App::PropertyVectorList`` blob: uint32 count + count*3 f64."""
    if len(data) < 4:
        return np.zeros((0, 3))
    n = struct.unpack("<I", data[:4])[0]
    need = 4 + 24 * n
    if len(data) < need:
        return np.zeros((0, 3))
    return np.frombuffer(data[4:need], dtype="<f8").reshape(n, 3).copy()


_PRESSURE_UNITS = {  # -> MPa
    "MPa": 1.0, "N/mm^2": 1.0, "GPa": 1e3, "kPa": 1e-3, "Pa": 1e-6,
    "kN/m^2": 1e-3, "N/m^2": 1e-6, "MN/m^2": 1.0, "psi": 6.894757e-3,
    "ksi": 6.894757,
    # FreeCAD internal mm-kg-s pressure unit (kg/(mm*s^2) = kPa)
    "kg/(mm*s^2)": 1e-3, "kg/(m*s^2)": 1e-6,
}
_DENSITY_UNITS = {  # -> kg/mm^3 (pairs with mm/s^2 gravity, fcVM.py:174)
    "kg/m^3": 1e-9, "kg/mm^3": 1.0, "g/cm^3": 1e-6, "t/m^3": 1e-6,
    "kg/cm^3": 1e-3, "g/mm^3": 1e-3,
}


def _quantity(s: str, table: dict, default_unit: Optional[str] = None) -> float:
    """Parse FreeCAD material-card quantities like ``"210000 MPa"``."""
    s = s.strip()
    m = re.match(r"^([-+0-9.eE]+)\s*(.*)$", s)
    if not m:
        raise ValueError(f"unparseable quantity {s!r}")
    val = float(m.group(1))
    unit = m.group(2).strip() or default_unit
    if unit is None:
        return val
    if unit not in table:
        raise ValueError(f"unknown unit {unit!r} in {s!r}")
    return val * table[unit]


# ---------------------------------------------------------------------------
# Document.xml object model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FcstdConstraint:
    name: str
    kind: str  # Fixed | Displacement | Force | Pressure
    subs: list  # [(object_name, sub_element_name), ...]
    points: np.ndarray  # (n, 3) sample cloud on the referenced geometry
    normals: np.ndarray  # (n, 3) geometric normals at the samples (faces)
    props: dict


@dataclasses.dataclass
class FcstdMaterial:
    e: float  # MPa
    nu: float
    density: float  # kg/mm^3
    subs: list  # solid references for multi-material documents
    card: dict


@dataclasses.dataclass
class FcstdDoc:
    label: str
    mesh: Mesh
    materials: list  # [FcstdMaterial]
    constraints: list  # [FcstdConstraint]


def _prop_elems(obj_elem):
    props = {}
    for p in obj_elem.iter("Property"):
        props[p.get("name")] = p
    return props


def _float_prop(props, name, default=None):
    p = props.get(name)
    if p is None:
        return default
    f = p.find("Float")
    return float(f.get("value")) if f is not None else default


def _bool_prop(props, name, default=False):
    p = props.get(name)
    if p is None:
        return default
    b = p.find("Bool")
    return (b is not None) and b.get("value") == "true"


def _vector_prop(props, name):
    p = props.get(name)
    if p is None:
        return None
    v = p.find("PropertyVector")
    if v is None:
        return None
    return np.array(
        [float(v.get("valueX")), float(v.get("valueY")), float(v.get("valueZ"))]
    )


def _linksub_prop(props, name="References"):
    p = props.get(name)
    if p is None:
        return []
    out = []
    for link in p.iter("Link"):
        out.append((link.get("obj"), link.get("sub") or ""))
    return out


def _vectorlist_file(props, name):
    p = props.get(name)
    if p is None:
        return None
    v = p.find("VectorList")
    return v.get("file") if v is not None else None


def _read_materials_constraints(obj_data, obj_types, zf):
    # --- materials
    materials = []
    for name, elem in obj_data.items():
        props = _prop_elems(elem)
        matp = props.get("Material")
        if matp is None or matp.find("Map") is None:
            continue
        card = {
            item.get("key"): item.get("value")
            for item in matp.find("Map").iter("Item")
        }
        if "YoungsModulus" not in card:
            continue
        e = _quantity(card["YoungsModulus"], _PRESSURE_UNITS, "MPa")
        nu = float(card.get("PoissonRatio", "0.0"))
        rho = (
            _quantity(card["Density"], _DENSITY_UNITS, "kg/m^3")
            if "Density" in card
            else 0.0
        )
        subs = _linksub_prop(props)
        materials.append(FcstdMaterial(e, nu, rho, subs, card))

    # --- constraints (document order matters: the reference's fix-dict
    # applies them in App.ActiveDocument.Objects order, later wins).
    constraints = []
    for name, elem in obj_data.items():
        typ = obj_types.get(name, "")
        kind = None
        for k in ("Fixed", "Displacement", "Force", "Pressure"):
            if typ == f"Fem::Constraint{k}":
                kind = k
        if kind is None:
            # older saves sometimes lack the Objects section type attr
            props0 = _prop_elems(elem)
            if "Force" in props0 and "DirectionVector" in props0:
                kind = "Force"
            elif "Pressure" in props0 and "Reversed" in props0:
                kind = "Pressure"
            elif "xFree" in props0:
                kind = "Displacement"
            elif re.match(r".*Fixed\d*$", name) and "Points" in props0:
                kind = "Fixed"
        if kind is None:
            continue
        props = _prop_elems(elem)
        pts_file = _vectorlist_file(props, "Points")
        nrm_file = _vectorlist_file(props, "Normals")
        points = (
            _read_vectorlist(zf.read(pts_file))
            if pts_file and pts_file in zf.namelist()
            else np.zeros((0, 3))
        )
        normals = (
            _read_vectorlist(zf.read(nrm_file))
            if nrm_file and nrm_file in zf.namelist()
            else np.zeros((0, 3))
        )
        scalar = {}
        if kind == "Force":
            p = props.get("Force")
            ptype = p.get("type") if p is not None else ""
            val = _float_prop(props, "Force", 0.0)
            # App::PropertyForce stores FreeCAD internal mm-kg-s units (mN).
            scalar["force"] = val / 1e3 if ptype == "App::PropertyForce" else val
            direction = _vector_prop(props, "DirectionVector")
            if direction is None:
                raise ValueError(
                    f"constraint {name}: ConstraintForce without a stored "
                    "DirectionVector cannot be resolved"
                )
            scalar["direction"] = direction
        elif kind == "Pressure":
            p = props.get("Pressure")
            ptype = p.get("type") if p is not None else ""
            val = _float_prop(props, "Pressure", 0.0)
            # App::PropertyPressure internal unit is kPa.
            scalar["pressure"] = (
                val / 1e3 if ptype == "App::PropertyPressure" else val
            )
            scalar["reversed"] = _bool_prop(props, "Reversed")
        elif kind == "Displacement":
            for ax in "xyz":
                scalar[f"{ax}free"] = _bool_prop(props, f"{ax}Free", True)
                scalar[f"{ax}disp"] = _float_prop(props, f"{ax}Displacement", 0.0)
        constraints.append(
            FcstdConstraint(name, kind, _linksub_prop(props), points, normals, scalar)
        )

    return materials, constraints


def read_fcstd(path, mesh_path=None) -> FcstdDoc:
    """Parse an ``.FCStd`` archive into mesh + materials + constraints.

    ``mesh_path`` substitutes an external mesh file (UNV/Gmsh/VTK) for the
    embedded one.  Constraint resolution is purely geometric (sample
    clouds), so any mesh of the same geometry works — in particular the
    committed ``output files/*.vtk`` meshes, which replay documents that
    were saved with their Gmsh mesh purged.
    """
    path = Path(path)
    with zipfile.ZipFile(path) as zf:
        return _read_fcstd_open(path, mesh_path, zf)


def _read_fcstd_open(path, mesh_path, zf) -> FcstdDoc:
    xml = zf.read("Document.xml")
    root = ET.fromstring(xml)

    # Document label (fcVM keys the control file on it, fcVM.py:74-76).
    label = path.stem
    for p in root.iter("Property"):
        if p.get("name") == "Label":
            s = p.find("String")
            if s is not None and s.get("value"):
                label = s.get("value")
            break

    # Object type declarations (<Objects> section).
    obj_types = {}
    objects_sec = root.find("Objects")
    if objects_sec is not None:
        for o in objects_sec.iter("Object"):
            obj_types[o.get("name")] = o.get("type") or ""

    # Object data sections.
    obj_data = {}
    data_sec = root.find("ObjectData")
    if data_sec is not None:
        for o in data_sec.iter("Object"):
            obj_data[o.get("name")] = o

    if mesh_path is not None:
        from fcvm_tpu_torch.models import meshio_io

        mesh = meshio_io.read_mesh(mesh_path)
        return FcstdDoc(
            label,
            mesh,
            *_read_materials_constraints(obj_data, obj_types, zf),
        )

    # --- mesh: the analysis mesh object (class MeshGmsh / MeshNetgen),
    # not the MeshResult objects results were pasted into.
    mesh_file, mesh_props = None, None
    candidates = []
    for name, elem in obj_data.items():
        props = _prop_elems(elem)
        fm = props.get("FemMesh")
        if fm is None:
            continue
        node = fm.find("FemMesh")
        if node is None or not node.get("file"):
            continue
        cls = ""
        proxy = props.get("Proxy")
        if proxy is not None:
            py = proxy.find("Python")
            if py is not None:
                cls = py.get("class") or ""
        candidates.append((name, cls, node, props))
    for name, cls, node, props in candidates:
        if "Result" not in cls and "Result" not in name:
            mesh_file, mesh_props = node, props
            break
    if mesh_file is None and candidates:
        mesh_file, mesh_props = candidates[0][2], candidates[0][3]
    if mesh_file is None:
        raise FileNotFoundError(f"{path}: no FEM mesh object in Document.xml")

    from fcvm_tpu_torch.models import meshio_io

    with tempfile.NamedTemporaryFile(suffix=".unv", delete=False) as tmp:
        tmp.write(zf.read(mesh_file.get("file")))
        tmp_path = tmp.name
    mesh = meshio_io.read_unv(tmp_path)
    Path(tmp_path).unlink()
    if mesh is None or mesh.n_nodes == 0 or mesh.n_elements == 0:
        raise ValueError(
            f"{path}: the embedded FEM mesh ({mesh_file.get('file')}) is "
            "empty — the document was saved without (or after purging) the "
            "Gmsh mesh; re-mesh in FreeCAD and save, or supply a mesh file"
        )

    # Mesh placement (a11..a34 affine transform stored on the property).
    a = np.eye(4)
    for i in range(1, 4):
        for j in range(1, 5):
            v = mesh_file.get(f"a{i}{j}")
            if v is not None:
                a[i - 1, j - 1] = float(v)
    if not np.allclose(a, np.eye(4)):
        mesh = Mesh(mesh.coords @ a[:3, :3].T + a[:3, 3], mesh.elnodes)

    materials, constraints = _read_materials_constraints(
        obj_data, obj_types, zf
    )
    return FcstdDoc(label, mesh, materials, constraints)


# ---------------------------------------------------------------------------
# Geometric resolution: sample cloud -> mesh boundary entities
# ---------------------------------------------------------------------------


class CloudResolver:
    """Resolve constraint sample clouds to mesh boundary faces/edges/nodes.

    Replaces FreeCAD's ``getNodesByFace``/``getFacesByFace``/
    ``getEdgesByEdge``/``getNodesByVertex`` queries (``fcVM.py:204-216,
    277-326``).  A boundary face belongs to the referenced CAD face when
    every node lies on the sampled surface (within a curvature-aware
    tolerance derived from the cloud itself) and its centroid is covered by
    the sample grid.  FreeCAD's marker grids span the full face extent, so
    coverage radii equal to the local sample spacing are sufficient.
    """

    def __init__(self, mesh: Mesh, patch_angle_deg: float = 30.0):
        self.mesh = mesh
        self.coords = mesh.coords
        self.diag = float(np.linalg.norm(self.coords.max(0) - self.coords.min(0)))
        self.bfaces = mesh.boundary_faces()
        tri = self.coords[self.bfaces[:, :3]]
        self.fcent = self.coords[self.bfaces].mean(axis=1)
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        self.fnormal = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-300)
        self.bedges = mesh.boundary_edges()
        self.patch_id = self._segment_patches(np.cos(np.radians(patch_angle_deg)))

    def _segment_patches(self, cos_thresh: float) -> np.ndarray:
        """Group boundary faces into smooth patches: region growing across
        shared corner edges, stopping at sharp creases.  Each patch
        approximates one CAD face (or a tangent-continuous run of them) —
        the selection unit FreeCAD's ``getFacesByFace`` operates on."""
        nf = len(self.bfaces)
        # shared corner edge -> the two faces meeting there
        pairs = {}
        adj = [[] for _ in range(nf)]
        for fi in range(nf):
            c = self.bfaces[fi, :3]
            for a, b in ((0, 1), (1, 2), (2, 0)):
                key = (min(c[a], c[b]), max(c[a], c[b]))
                other = pairs.pop(key, None)
                if other is None:
                    pairs[key] = fi
                else:
                    adj[fi].append(other)
                    adj[other].append(fi)
        parent = np.arange(nf)

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        for fi in range(nf):
            for fj in adj[fi]:
                if self.fnormal[fi] @ self.fnormal[fj] >= cos_thresh:
                    ri, rj = find(fi), find(fj)
                    if ri != rj:
                        parent[ri] = rj
        return np.array([find(i) for i in range(nf)])

    # -- cloud statistics ---------------------------------------------------

    @staticmethod
    def _pairwise(a, b):
        return np.linalg.norm(a[:, None, :] - b[None, :, :], axis=2)

    def _cloud_stats(self, pts, nrm=None):
        """Per-point nearest-neighbour sample spacing."""
        npts = len(pts)
        if npts == 1:
            spacing = np.array([0.05 * self.diag])
        else:
            d = self._pairwise(pts, pts)
            np.fill_diagonal(d, np.inf)
            spacing = np.maximum(d.min(axis=1), 1e-12 * self.diag)
        return spacing, None

    # -- faces ---------------------------------------------------------------

    def resolve_faces(
        self, pts: np.ndarray, nrm: np.ndarray, what: str = "constraint"
    ) -> np.ndarray:
        """``faces_for`` with a relaxed-tolerance retry ladder.

        Meshes do not always sit exactly on the CAD surfaces (e.g. the
        committed reference VTK exports carry imperfection-seeded
        coordinates, and real meshers leave projection slack); when the
        strict pass resolves nothing, retry with the surface-membership
        tolerance widened 30x / 1000x and warn.
        """
        for tf in (1.0, 30.0, 1000.0):
            unresolved: list = []
            faces = self.faces_for(pts, nrm, tol_factor=tf, unresolved=unresolved)
            if len(faces) and not unresolved:
                if tf > 1.0:
                    warnings.warn(
                        f"fcstd: {what} resolved only with a {tf:g}x relaxed "
                        "surface tolerance — mesh nodes sit off the CAD "
                        "geometry (imperfect/deformed mesh?)"
                    )
                return faces
        if unresolved:
            # Even the widest rung left some sample clusters with zero
            # selected faces (plane test passed but no on-plane mesh nodes).
            # Those samples must not be silently dropped — the constraint
            # would then act on a subset of its faces; fall through to
            # nearest-patch selection for them and union the results.
            warnings.warn(
                f"fcstd: {what}: {len(unresolved)} samples matched no exact "
                "surface at any tolerance; using nearest-patch selection"
            )
            mask = np.zeros(len(self.bfaces), dtype=bool)
            nrm_u = None
            if len(nrm) == len(pts):
                nlen = np.linalg.norm(nrm, axis=1, keepdims=True)
                nrm_u = nrm / np.maximum(nlen, 1e-12)
            self._select_patches(pts, nrm_u, np.asarray(unresolved), mask)
            patch_faces = self.bfaces[mask]
            if len(faces):
                faces = np.unique(
                    np.concatenate([faces, patch_faces], axis=0), axis=0
                )
            else:
                faces = patch_faces
        return faces

    def faces_for(
        self,
        pts: np.ndarray,
        nrm: np.ndarray,
        tol_factor: float = 1.0,
        unresolved: list | None = None,
    ) -> np.ndarray:
        """Boundary tri6 faces lying on the sampled CAD surface.

        Three-stage resolution, mirroring what FreeCAD's
        ``getFacesByFace`` computes with the OCCT kernel:

        1. Samples are clustered by (signed) normal direction; each
           *coplanar* cluster is one planar CAD face — membership is an
           exact plane + coverage test.
        2. Leftover samples (varying normals = curved face) get a cylinder
           fit (axis from the normals' null space, Kasa circle fit);
           membership is a radial + unrolled-surface-coverage test.  This
           keeps partially-loaded holes (e.g. a lug's 90-degree bearing
           arc) exact.
        3. Anything else falls back to smooth-patch selection (nearest
           boundary face's patch, normal-filtered).
        """
        if len(pts) == 0:
            return np.zeros((0, 6), dtype=np.int32)
        nn = np.linalg.norm(nrm, axis=1) if len(nrm) == len(pts) else None
        have_normals = nn is not None and bool(np.all(nn > 0.5))
        signed = have_normals
        if have_normals:
            nrm = nrm / nn[:, None]
        elif len(pts) >= 4:
            # Force constraints store no Normals blob; estimate them from
            # local plane fits so samples landing exactly on a crease still
            # vote for the referenced face, not a neighbour.  SVD normals
            # have arbitrary per-point sign, so clustering must be unsigned
            # (members are sign-canonicalized to their cluster).
            nrm = self._estimate_normals(pts)
            have_normals = True

        mask = np.zeros(len(self.bfaces), dtype=bool)
        if not have_normals:
            self._select_patches(pts, None, np.arange(len(pts)), mask)
            return self.bfaces[mask]

        remaining = []
        for cluster in self._cluster_by_normal(pts, nrm, signed=signed):
            if len(cluster) >= 3:
                handled, n_sel = self._select_plane(
                    pts, nrm, cluster, mask, tol_factor
                )
                if handled:
                    if unresolved is not None and n_sel == 0:
                        # plane test accepted the cluster but found no
                        # on-plane mesh faces — report it so the caller can
                        # retry wider or patch-select rather than silently
                        # dropping it
                        unresolved.extend(int(i) for i in cluster)
                    continue
            remaining.extend(cluster)
        if remaining:
            remaining = np.array(remaining)
            handled, n_sel = self._select_cylinder(
                pts, nrm, remaining, mask, tol_factor
            )
            if not handled:
                self._select_patches(pts, nrm, remaining, mask)
            elif unresolved is not None and n_sel == 0:
                # cylinder fit accepted the samples but selected no mesh
                # faces (nodes sit off the fitted surface) — same
                # must-not-drop-silently contract as the plane path
                unresolved.extend(int(i) for i in remaining)
        return self.bfaces[mask]

    def _cluster_by_normal(self, pts, nrm, cos_same=0.9962, signed=True):
        """Group samples by normal direction (5-degree cone).

        ``signed=False`` clusters by |cos| and flips members in place to the
        cluster representative's orientation (for sign-ambiguous estimated
        normals).
        """
        reps, clusters = [], []
        for i in range(len(pts)):
            for r, cl in zip(reps, clusters):
                d = float(nrm[i] @ r)
                if (d if signed else abs(d)) > cos_same:
                    if not signed and d < 0:
                        nrm[i] = -nrm[i]
                    cl.append(i)
                    break
            else:
                reps.append(nrm[i].copy())
                clusters.append([i])
        return clusters

    def _select_plane(self, pts, nrm, cluster, mask, tol_factor=1.0):
        """Exact planar-face membership for one coplanar sample cluster.

        Returns ``(handled, n_selected)``: ``handled`` means the cluster is
        a planar face grid (do not pass it to the curved-face fallbacks);
        ``n_selected`` is how many boundary faces this cluster selected —
        zero with ``handled`` means the plane matched no mesh faces at this
        tolerance."""
        cl = np.asarray(cluster)
        n = nrm[cl].mean(axis=0)
        n = n / np.linalg.norm(n)
        p0 = pts[cl].mean(axis=0)
        cloud_tol = max(1e-6 * self.diag, 1e-9)
        tol = cloud_tol * tol_factor
        if np.max(np.abs((pts[cl] - p0) @ n)) > cloud_tol:
            return False, 0  # normals agree but points not coplanar
        s = np.linalg.svd(pts[cl] - p0, compute_uv=False)
        if s[1] < 1e-3 * max(s[0], 1e-12):
            # collinear samples: a generatrix of a curved face (e.g. one
            # angular station of a cylinder grid), not a 2D face grid
            return False, 0
        on_plane_node = np.abs((self.coords - p0) @ n) <= tol
        cand = np.where(
            on_plane_node[self.bfaces].all(axis=1)
            & (np.abs(self.fnormal @ n) >= 0.9)
        )[0]
        if len(cand) == 0:
            return True, 0
        # coverage: the marker grid spans the face (corners included), so
        # the face's extent is the convex hull of the samples in-plane
        e1 = np.linalg.qr(
            np.column_stack([n, np.eye(3)[np.argmin(np.abs(n))]])
        )[0][:, 1]
        e2 = np.cross(n, e1)
        s2d = np.column_stack([(pts[cl] - p0) @ e1, (pts[cl] - p0) @ e2])
        q2d = np.column_stack(
            [(self.fcent[cand] - p0) @ e1, (self.fcent[cand] - p0) @ e2]
        )
        margin = 0.02 * float(
            np.linalg.norm(s2d.max(0) - s2d.min(0))
        )  # covers curved rims the sample polygon inscribes
        sel = cand[_hull_contains(s2d, q2d, margin)]
        mask[sel] = True
        return True, len(sel)

    def _select_cylinder(self, pts, nrm, idx, mask, tol_factor=1.0):
        """Cylindrical-face membership for samples with rotating normals.

        Returns ``(handled, n_selected)``: ``handled=False`` means the
        samples do not look like a cylinder (caller falls back to patch
        selection); ``handled=True, n_selected=0`` means the fit succeeded
        but no mesh faces lie on the surface — the caller reports those
        samples as unresolved instead of silently dropping the constraint
        subset."""
        if len(idx) < 6:
            return False, 0
        sub, snrm = pts[idx], nrm[idx]
        # axis: cylinder normals are perpendicular to it
        w, v = np.linalg.eigh(snrm.T @ snrm)
        axis = v[:, 0]
        if w[0] > 1e-4 * w[2]:
            return False, 0  # normals not coplanar in the axis-normal plane
        # project to the plane perpendicular to the axis; Kasa circle fit
        e1 = np.linalg.qr(
            np.column_stack([axis, np.eye(3)[np.argmin(np.abs(axis))]])
        )[0][:, 1]
        e2 = np.cross(axis, e1)
        u, vv = sub @ e1, sub @ e2
        A = np.column_stack([2 * u, 2 * vv, np.ones(len(u))])
        sol, *_ = np.linalg.lstsq(A, u**2 + vv**2, rcond=None)
        cu, cv, c0 = sol
        r = np.sqrt(max(c0 + cu**2 + cv**2, 0.0))
        if r <= 0:
            return False, 0
        resid = np.abs(np.hypot(u - cu, vv - cv) - r)
        if resid.max() > 0.02 * r:
            return False, 0
        # unrolled coordinates (theta*r, z) of samples and mesh nodes
        z0 = sub @ axis
        th0 = np.arctan2(vv - cv, u - cu)

        def unroll(x):
            uu, vvv, zz = x @ e1, x @ e2, x @ axis
            rad = np.hypot(uu - cu, vvv - cv)
            return np.arctan2(vvv - cv, uu - cu), zz, rad

        tol_r = max(0.05 * r, 1e-6 * self.diag * tol_factor)
        nd_th, nd_z, nd_rad = unroll(self.coords)
        node_on = np.abs(nd_rad - r) <= tol_r
        cand = np.where(node_on[self.bfaces].all(axis=1))[0]
        if len(cand) == 0:
            return True, 0
        ct, cz, _ = unroll(self.fcent[cand])
        # Angular extent: rotate so the largest gap between sample angles
        # sits at the seam; a closed cylinder (regular gaps) has no angular
        # bound, an arc (one dominant gap) is bounded by its end samples.
        order = np.sort(np.unique(np.round(th0, 9)))
        gaps = np.diff(np.concatenate([order, [order[0] + 2 * np.pi]]))
        gi = int(np.argmax(gaps))
        seam = order[gi] + gaps[gi] / 2.0
        rot = lambda t: np.mod(t - seam, 2 * np.pi)
        closed = gaps[gi] <= 1.5 * np.median(gaps)
        s2d = np.column_stack([rot(th0) * r, z0])
        q2d = np.column_stack([rot(ct) * r, cz])
        margin = 0.02 * float(np.linalg.norm(s2d.max(0) - s2d.min(0)))
        if closed:
            keep = (q2d[:, 1] >= s2d[:, 1].min() - margin) & (
                q2d[:, 1] <= s2d[:, 1].max() + margin
            )
        else:
            keep = _hull_contains(s2d, q2d, margin)
        mask[cand[keep]] = True
        return True, int(np.count_nonzero(keep))

    def _select_patches(self, pts, nrm, idx, mask) -> None:
        """Fallback: nearest boundary face's smooth patch, normal-filtered."""
        selected = set()
        for i in idx:
            dist = self._point_face_dist(pts[i])
            if nrm is not None:
                aligned = np.abs(self.fnormal @ nrm[i]) >= 0.7
                if aligned.any():
                    dist = np.where(aligned, dist, np.inf)
            j = int(dist.argmin())
            if dist[j] <= 0.05 * self.diag:
                selected.add(int(self.patch_id[j]))
        if selected:
            mask |= np.isin(self.patch_id, sorted(selected))

    def _estimate_normals(self, pts: np.ndarray) -> np.ndarray:
        """Per-sample surface normal from an SVD plane fit of the k nearest
        neighbours (sign-ambiguous; membership tests use |cos|)."""
        d = self._pairwise(pts, pts)
        np.fill_diagonal(d, np.inf)
        k = min(6, len(pts) - 1)
        nbr = np.argpartition(d, k - 1, axis=1)[:, :k]
        out = np.zeros((len(pts), 3))
        for i in range(len(pts)):
            q = pts[nbr[i]] - pts[i]
            _, s, vt = np.linalg.svd(q, full_matrices=False)
            out[i] = vt[-1]
        return out

    def _point_face_dist(self, p: np.ndarray) -> np.ndarray:
        """True distance from ``p`` to every boundary corner triangle."""
        a = self.coords[self.bfaces[:, 0]]
        b = self.coords[self.bfaces[:, 1]]
        c = self.coords[self.bfaces[:, 2]]
        # projection onto each triangle plane, barycentric inside-test
        n = self.fnormal
        d_plane = np.einsum("ij,ij->i", p[None] - a, n)
        proj = p[None] - d_plane[:, None] * n
        v0, v1, v2 = c - a, b - a, proj - a
        d00 = np.einsum("ij,ij->i", v0, v0)
        d01 = np.einsum("ij,ij->i", v0, v1)
        d11 = np.einsum("ij,ij->i", v1, v1)
        d02 = np.einsum("ij,ij->i", v0, v2)
        d12 = np.einsum("ij,ij->i", v1, v2)
        den = np.maximum(d00 * d11 - d01 * d01, 1e-300)
        u = (d11 * d02 - d01 * d12) / den
        v = (d00 * d12 - d01 * d02) / den
        inside = (u >= -1e-12) & (v >= -1e-12) & (u + v <= 1 + 1e-12)
        d_edges = np.minimum.reduce(
            [
                _point_segment_dist(p[None], a, b),
                _point_segment_dist(p[None], b, c),
                _point_segment_dist(p[None], c, a),
            ]
        )
        return np.where(inside, np.abs(d_plane), d_edges)

    # -- edges ---------------------------------------------------------------

    def edges_for(self, pts: np.ndarray) -> np.ndarray:
        """Boundary line3 edges lying on the sampled curve."""
        if len(pts) == 0:
            return np.zeros((0, 3), dtype=np.int32)
        spacing, _ = self._cloud_stats(pts, None)
        # local chord sagitta: distance of each sample to the segment
        # between its two nearest neighbours (0 for straight edges)
        sag = 0.0
        if len(pts) >= 3:
            d = self._pairwise(pts, pts)
            np.fill_diagonal(d, np.inf)
            nbr = np.argpartition(d, 1, axis=1)[:, :2]
            a, b = pts[nbr[:, 0]], pts[nbr[:, 1]]
            # distance to the *infinite line* through the two neighbours:
            # endpoint samples sit outside their neighbour segment, and the
            # clamped segment distance would report the full sample spacing
            # as curvature (tolerance blow-up on straight edges)
            sag = float(np.max(_point_line_dist(pts, a, b)))
        tol = max(2.5 * sag, 1e-6 * self.diag + 1e-9)

        emid = self.coords[self.bedges].mean(axis=1)
        # vectorized midpoint prefilter: one (nedges, npts) distance table
        # instead of a Python-level pass over every boundary edge (there
        # are O(1.5x boundary faces) of them — minutes of host time per
        # edge-referenced constraint on large meshes); the exact per-node
        # polyline test below then runs only on the few nearby candidates
        dmid = self._pairwise(emid, pts)
        jmin = dmid.argmin(axis=1)
        rows = np.arange(len(emid))
        cand = np.where(dmid[rows, jmin] <= 1.1 * spacing[jmin])[0]
        keep = []
        for idx in cand:
            nodes = self.coords[self.bedges[idx]]
            ok = True
            for x in nodes:
                dd = np.linalg.norm(x - pts, axis=1)
                j = dd.argmin()
                # distance to the polyline segment through the two samples
                # nearest to this node
                order = np.argsort(dd)[:2]
                if len(order) == 2:
                    dist = _point_segment_dist(
                        x[None], pts[order[0]][None], pts[order[1]][None]
                    )[0]
                else:
                    dist = dd[j]
                if dist > tol:
                    ok = False
                    break
            if ok:
                keep.append(idx)
        return self.bedges[np.array(keep, dtype=int)] if keep else np.zeros(
            (0, 3), dtype=np.int32
        )

    # -- vertices --------------------------------------------------------------

    def vertices_for(self, pts: np.ndarray, count: int | None = None) -> np.ndarray:
        """Mesh node nearest to each sample point (one per CAD vertex).

        ``count`` handles constraints mixing Vertex with Face/Edge
        references: their sample cloud holds face/edge samples too, but CAD
        vertices coincide exactly with mesh nodes (meshers pin nodes to
        geometry vertices) while triangulation samples generally do not, so
        the ``count`` samples with the smallest node distance are the vertex
        references.

        Known ambiguity (accepted): face marker grids include the face's
        own corner vertices, which also coincide exactly with mesh nodes,
        so a mixed Face+Vertex cloud can tie at distance 0 and pick a face
        corner instead of the referenced vertex.  There is no geometric
        signal to break the tie without the CAD kernel; the mixed-kind
        warning at the call sites tells the user to check load sums.
        """
        hits = []
        for p in pts:
            d = np.linalg.norm(self.coords - p, axis=1)
            j = int(d.argmin())
            hits.append((float(d[j]), j))
        if count is not None:
            hits = sorted(hits)[: int(count)]
        out = []
        for dist, j in hits:
            if dist > 1e-3 * self.diag:
                warnings.warn(
                    f"fcstd: vertex sample is {dist:.3g} away from the "
                    "nearest mesh node"
                )
            out.append(j)
        return np.unique(np.array(out, dtype=np.int32))


def _hull_contains(samples2d, queries2d, margin):
    """Half-plane test: queries inside the samples' 2D convex hull + margin."""
    from scipy.spatial import ConvexHull, QhullError

    try:
        hull = ConvexHull(samples2d)
    except QhullError:
        # degenerate (collinear) sample set: fall back to bbox test
        lo, hi = samples2d.min(0) - margin, samples2d.max(0) + margin
        return ((queries2d >= lo) & (queries2d <= hi)).all(axis=1)
    eq = hull.equations
    return (queries2d @ eq[:, :2].T + eq[:, 2][None, :] <= margin).all(axis=1)


def _point_line_dist(x, a, b):
    ab = b - a
    denom = np.maximum((ab * ab).sum(axis=1), 1e-300)
    t = ((x - a) * ab).sum(axis=1) / denom
    proj = a + t[:, None] * ab
    return np.linalg.norm(x - proj, axis=1)


def _point_segment_dist(x, a, b):
    ab = b - a
    denom = np.maximum((ab * ab).sum(axis=1), 1e-300)
    t = np.clip(((x - a) * ab).sum(axis=1) / denom, 0.0, 1.0)
    proj = a + t[:, None] * ab
    return np.linalg.norm(x - proj, axis=1)


# ---------------------------------------------------------------------------
# Model assembly
# ---------------------------------------------------------------------------


def _sub_kinds(subs):
    kinds = set()
    for _, sub in subs:
        m = re.match(r"([A-Za-z]+)", sub or "")
        if m:
            kinds.add(m.group(1))
    return kinds


def build_model(
    doc: FcstdDoc,
    params: Optional[ControlParams] = None,
    name: Optional[str] = None,
) -> Model:
    """Assemble an analysis :class:`Model` from a parsed document.

    ``params`` supplies gravity (the reference reads it from the ``.inp``
    control file, not the document, ``fcVM.FCMacro:75-78``).
    """
    mesh = doc.mesh
    res = CloudResolver(mesh)

    bc_entries = []
    loads_kw: dict = {}
    press_faces, press_vals = [], []

    for con in doc.constraints:
        kinds = _sub_kinds(con.subs)
        if con.kind in ("Fixed", "Displacement"):
            if con.kind == "Fixed":
                comps = (0.0, 0.0, 0.0)
            else:
                comps = tuple(
                    None if con.props[f"{ax}free"] else con.props[f"{ax}disp"]
                    for ax in "xyz"
                )
            nodes = []
            if "Face" in kinds or not kinds:
                faces = res.resolve_faces(con.points, con.normals, con.name)
                nodes.append(np.unique(faces))
            if "Edge" in kinds:
                edges = res.edges_for(con.points)
                nodes.append(np.unique(edges))
            if "Vertex" in kinds:
                # the reference pins vertex nodes unconditionally, in the
                # same References loop as faces/edges (fcVM.py:204-216);
                # with mixed kinds only the vertex-reference samples (one
                # per Vertex sub) are node candidates — the same
                # count-based selection as the Force path below
                n_vsubs = sum(
                    1 for _, sub in con.subs
                    if re.match(r"Vertex\d*$", sub or "")
                ) or None
                nodes.append(res.vertices_for(
                    con.points,
                    count=None if kinds == {"Vertex"} else n_vsubs,
                ))
            nodes = [n for n in nodes if len(n)]
            nodes = np.unique(np.concatenate(nodes)) if nodes else np.zeros(0, np.int32)
            if len(nodes) == 0:
                warnings.warn(f"fcstd: constraint {con.name} resolved no nodes")
                continue
            bc_entries.append((nodes, comps))

        elif con.kind == "Pressure":
            faces = res.resolve_faces(con.points, con.normals, con.name)
            if len(faces) == 0:
                warnings.warn(f"fcstd: pressure {con.name} resolved no faces")
                continue
            sign = 1.0 if con.props["reversed"] else -1.0
            press_faces.append(faces)
            press_vals.append(np.full(len(faces), sign * con.props["pressure"]))

        elif con.kind == "Force":
            f_total = con.props["force"] * np.asarray(con.props["direction"])
            faces = (
                res.resolve_faces(con.points, con.normals, con.name)
                if "Face" in kinds
                else None
            )
            edges = res.edges_for(con.points) if "Edge" in kinds else None
            # Each referenced kind applies the FULL force independently
            # (vertices get F/N each even when mixed with faces/edges,
            # fcVM.py:298-313), so vertices are included whenever present.
            # With mixed kinds only the vertex-reference samples (one per
            # "Vertex" sub) are node candidates.
            n_vsubs = sum(
                1 for _, sub in con.subs if re.match(r"Vertex\d*$", sub or "")
            ) or None
            verts = (
                res.vertices_for(
                    con.points, count=None if kinds == {"Vertex"} else n_vsubs
                )
                if "Vertex" in kinds
                else None
            )
            if len(kinds) > 1:
                warnings.warn(
                    f"fcstd: force {con.name} references mixed kinds {kinds}; "
                    "each kind carries the full force (reference semantics) — "
                    "sample-cloud resolution is best-effort, check load sums"
                )
            if (
                (faces is None or len(faces) == 0)
                and (edges is None or len(edges) == 0)
                and (verts is None or len(verts) == 0)
            ):
                warnings.warn(f"fcstd: force {con.name} resolved no entities")
                continue
            kw = distribute_total_force(
                mesh, f_total, faces=faces, edges=edges, vertices=verts
            )
            for k, v in kw.items():
                if k in loads_kw:
                    loads_kw[k] = np.concatenate([loads_kw[k], v])
                else:
                    loads_kw[k] = v

    if press_faces:
        loads_kw["pressure_faces"] = np.concatenate(press_faces)
        loads_kw["pressures"] = np.concatenate(press_vals)
    if params is not None:
        loads_kw["gravity"] = np.asarray(params.gravity, dtype=np.float64)

    if not doc.materials:
        material = Material(210000.0, 0.3, 7.9e-9)
    else:
        m0 = doc.materials[0]
        material = Material(m0.e, m0.nu, m0.density)
        if len(doc.materials) > 1:
            warnings.warn(
                "fcstd: document has multiple materials; per-element "
                "assignment needs explicit regions (materials_by_element) — "
                "using the first material only, like the reference kernels "
                "(fcVM.py:736-737)"
            )

    bcs = BoundaryConditions.from_node_sets(bc_entries) if bc_entries else (
        BoundaryConditions(np.zeros(0, dtype=np.int32), np.zeros(0))
    )
    return Model(
        mesh, material, bcs, Loads(**loads_kw), name=name or doc.label
    )


def load_reference_case(
    fcstd_path, inp_path=None, name: Optional[str] = None, mesh_path=None
) -> tuple[Model, ControlParams]:
    """Load an ``.FCStd`` + its paired ``.inp`` control file.

    When ``inp_path`` is omitted, looks for ``control files/<label>.inp``
    next to the document — the reference's own pairing convention
    (``fcVM.py:74-76``).  ``mesh_path`` substitutes an external UNV/Gmsh/VTK
    mesh for the embedded one (e.g. a committed ``output files/*.vtk``).
    """
    from fcvm_tpu_torch.models.inp import read_inp

    doc = read_fcstd(fcstd_path, mesh_path=mesh_path)
    if inp_path is None:
        base = Path(fcstd_path).parent
        for cand in (
            base / "control files" / f"{doc.label}.inp",
            base.parent / "control files" / f"{doc.label}.inp",
            base / f"{doc.label}.inp",
        ):
            if cand.exists():
                inp_path = cand
                break
    params = read_inp(inp_path) if inp_path else ControlParams()
    model = build_model(doc, params, name=name)
    return model, params
