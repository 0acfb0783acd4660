"""Declarative analysis model, host side (numpy only; no JAX).

The port's copy of :mod:`fcvm_tpu.models.spec`, plus the two bridges the
parity tests use: :func:`model_from_arrays` takes a model of the JAX package
(duck-typed, through numpy) and :func:`to_torch` turns state taken from the
JAX package (as numpy arrays) into the port's tensors.

The reference extracts the mesh, materials, Dirichlet constraints and loads
from live FreeCAD document objects (``source code/fcVM.py:122-347``).  This
framework decouples the solver from any CAD kernel: a :class:`Model` is plain
arrays — connectivity, coordinates, dof constraint tables and load tables —
built from the included mesh generators and node-set predicates.

Conventions (identical to the reference after its node reordering at
``fcVM.py:337-341``):

* tet10 node order: corners (0,1,2,3) then midsides
  (0-1), (1-2), (0-2), (0-3), (1-3), (2-3) — the CalculiX convention the
  reference's shape functions assume.
* Voigt stress/strain order ``[xx, yy, zz, xy, zx, yz]``.
* dof numbering ``dof = 3 * node + component``; all indices 0-based.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

# Midside node -> (corner, corner) for the tet10 convention above.
TET10_EDGES = ((0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3))


@dataclasses.dataclass
class Mesh:
    """Tet10 volume mesh.

    Attributes:
      coords: (nn, 3) float64 nodal coordinates.
      elnodes: (ne, 10) int32 0-based connectivity.
    """

    coords: np.ndarray
    elnodes: np.ndarray

    def __post_init__(self):
        self.coords = np.ascontiguousarray(self.coords, dtype=np.float64)
        self.elnodes = np.ascontiguousarray(self.elnodes, dtype=np.int32)

    @property
    def n_nodes(self) -> int:
        return len(self.coords)

    @property
    def n_elements(self) -> int:
        return len(self.elnodes)

    @property
    def ndof(self) -> int:
        return 3 * self.n_nodes

    def elements_per_node(self) -> np.ndarray:
        """The reference's ``noce`` (``fcVM.py:183-185``): number of volume
        elements adjacent to each node."""
        return np.bincount(self.elnodes.reshape(-1),
                           minlength=self.n_nodes).astype(np.int32)

    def select_nodes(self, predicate) -> np.ndarray:
        """Node ids where ``predicate(x, y, z)`` (vectorized) is true."""
        m = predicate(self.coords[:, 0], self.coords[:, 1], self.coords[:, 2])
        return np.where(m)[0].astype(np.int32)

    def validate(self):
        """Fail fast on meshes the solver cannot produce physics for.

        The reference inherits mesh sanity from FreeCAD/SMESH and crashes
        deep inside numba on a bad one; here a broken import (wrong node
        order, duplicated nodes, inside-out connectivity) is reported at
        ingest with the offending element ids.  Checks: connectivity in
        range, non-degenerate corner-tet volume
        ``det[x1-x0, x2-x0, x3-x0]`` relative to the element's own edge
        scale, and *consistent* orientation.  A uniformly mirrored mesh
        (every volume negative) is repaired in place with a warning: the
        volume kernels integrate ``|det J|`` exactly like the reference's
        ``abs(xsj)`` (``fcVM.py:756``), but :meth:`boundary_faces` windings
        (and so pressure/follower-load normals) assume positive orientation,
        so the corner 1↔2 swap (with the matching midside permutation) is
        applied rather than merely warning.  Only a sign mix within one
        mesh indicates a real connectivity error and still raises.
        """
        if self.elnodes.size == 0:
            raise ValueError("mesh has no elements")
        if self.elnodes.min() < 0 or self.elnodes.max() >= self.n_nodes:
            raise ValueError(
                "mesh connectivity references node "
                f"{int(self.elnodes.max())} but only {self.n_nodes} nodes "
                "exist (or a negative id)"
            )
        x = self.coords[self.elnodes[:, :4]]  # (ne, 4, 3) corner nodes
        e = x[:, 1:] - x[:, :1]  # (ne, 3, 3) edge vectors
        vol6 = np.linalg.det(e)
        # degeneracy is judged against each element's own edge scale, not a
        # global tolerance (meshes come in arbitrary units)
        h = np.abs(e).max(axis=(1, 2))
        degenerate = np.where(np.abs(vol6) <= 1e-12 * h**3)[0]
        if len(degenerate):
            raise ValueError(
                f"{len(degenerate)} degenerate tet element(s), e.g. ids "
                f"{degenerate[:8].tolist()} (corner volume ~ 0) — check for "
                "duplicated nodes or collapsed elements"
            )
        neg = int((vol6 < 0.0).sum())
        if 0 < neg < len(vol6):
            bad = np.where(vol6 < 0.0)[0]
            raise ValueError(
                f"{neg} of {len(vol6)} tet element(s) have inverted "
                f"orientation, e.g. ids {bad[:8].tolist()} (corner volume "
                "< 0 while others are > 0) — check node ordering (Gmsh vs "
                "CalculiX midside conventions)"
            )
        if neg == len(vol6):
            import warnings

            warnings.warn(
                "mesh is uniformly mirror-oriented (every corner volume "
                "negative); flipping element orientation in place so "
                "boundary-face/pressure normals point outward (volume "
                "kernels are orientation-free, reference parity fcVM.py:756)"
            )
            # corners (0,2,1,3); midsides follow the edge relabeling
            # (0-1),(1-2),(0-2),(0-3),(1-3),(2-3) -> old ids 6,5,4,7,9,8
            self.elnodes = self.elnodes[:, [0, 2, 1, 3, 6, 5, 4, 7, 9, 8]]

    def boundary_faces(self) -> np.ndarray:
        """All exterior tri6 faces, outward-ordered, as (nf, 6) node ids.

        A face appears in exactly one element iff it is on the boundary.
        Replaces the FreeCAD ``getFacesByFace`` queries.
        """
        # Local faces of a tet (corner triple, midside triple), oriented
        # outward for a positively-oriented tet.
        local_faces = (
            ((0, 2, 1), (2, 1, 0)),  # corners 0-2-1, midsides (0-2),(1-2),(0-1)
            ((0, 1, 3), (0, 4, 3)),  # midsides (0-1),(1-3),(0-3)
            ((1, 2, 3), (1, 5, 4)),  # midsides (1-2),(2-3),(1-3)
            ((2, 0, 3), (2, 3, 5)),  # midsides (0-2),(0-3),(2-3)
        )
        faces = []
        for corners, mids in local_faces:
            c = self.elnodes[:, list(corners)]
            m = self.elnodes[:, [4 + i for i in mids]]
            faces.append(np.concatenate([c, m], axis=1))
        all_faces = np.concatenate(faces, axis=0)  # (4*ne, 6)
        key = np.sort(all_faces[:, :3], axis=1)
        _, inv, counts = np.unique(
            key, axis=0, return_inverse=True, return_counts=True
        )
        return all_faces[counts[inv] == 1].astype(np.int32)

    def faces_on(self, predicate) -> np.ndarray:
        """Boundary faces whose 6 nodes all satisfy the predicate."""
        bf = self.boundary_faces()
        node_ok = np.zeros(self.n_nodes, dtype=bool)
        sel = self.select_nodes(predicate)
        node_ok[sel] = True
        return bf[node_ok[bf].all(axis=1)]

    def boundary_edges(self) -> np.ndarray:
        """All unique line3 edges (corner, corner, midside) of the exterior
        surface — the mesh entities behind the reference's edge queries
        (``getEdgesByEdge``), in order of first appearance."""
        bf = self.boundary_faces()
        edges = np.concatenate([bf[:, [0, 1, 3]], bf[:, [1, 2, 4]], bf[:, [2, 0, 5]]], axis=0)
        key = np.sort(edges[:, :2], axis=1)
        _, first = np.unique(key, axis=0, return_index=True)
        return edges[np.sort(first)].astype(np.int32)

    def edges_on(self, predicate) -> np.ndarray:
        """Boundary edges whose 3 nodes all satisfy the predicate."""
        be = self.boundary_edges()
        node_ok = np.zeros(self.n_nodes, dtype=bool)
        node_ok[self.select_nodes(predicate)] = True
        return be[node_ok[be].all(axis=1)]


@dataclasses.dataclass
class Material:
    """Isotropic elastoplastic material.

    The reference extracts one (E, nu, rho) row per element but its kernels
    use element 0 for the constitutive law everywhere
    (``fcVM.py:736-737, 947-950, 2227-2234``), i.e. the solve is effectively
    single-material; we mirror that contract.
    """

    e: float  # Young's modulus [MPa]
    nu: float  # Poisson ratio
    density: float = 0.0  # [kg/mm^3] paired with gravity in [mm/s^2]


@dataclasses.dataclass
class BoundaryConditions:
    """Prescribed-displacement constraints (fixed and driven dofs).

    Built from per-node component locks, the analogue of the reference's
    ``fix``/``fixdof``/``movdof`` triple (``fcVM.py:222-258``).
    """

    fixed_dofs: np.ndarray  # (k,) int32 dof ids
    fixed_values: np.ndarray  # (k,) float64 prescribed displacement

    @staticmethod
    def from_node_sets(
        entries: Sequence[tuple[np.ndarray, Sequence[Optional[float]]]],
    ) -> "BoundaryConditions":
        """``entries = [(node_ids, (ux, uy, uz)), ...]`` with ``None`` = free.

        Later entries win on conflicts, matching the reference dict update.
        """
        table: dict[int, float] = {}
        for nodes, comps in entries:
            for axis, val in enumerate(comps):
                if val is None:
                    continue
                for n in np.asarray(nodes).ravel():
                    table[3 * int(n) + axis] = float(val)
        dofs = np.array(sorted(table), dtype=np.int32)
        vals = np.array([table[d] for d in dofs], dtype=np.float64)
        return BoundaryConditions(dofs, vals)

    def masks(self, ndof: int):
        """Returns (fixmask, u_fix, movdof) as float64/ndof arrays.

        fixmask: 1.0 free / 0.0 fixed (reference ``fixdof``);
        u_fix: prescribed values at fixed dofs, 0 elsewhere;
        movdof: 1.0 where the prescribed value is nonzero (displacement
        control detection, ``fcVM.py:256-258``).
        """
        fixmask = np.ones(ndof)
        u_fix = np.zeros(ndof)
        fixmask[self.fixed_dofs] = 0.0
        u_fix[self.fixed_dofs] = self.fixed_values
        movdof = np.zeros(ndof)
        movdof[self.fixed_dofs[self.fixed_values != 0.0]] = 1.0
        return fixmask, u_fix, movdof


def _empty_i(shape):
    return np.zeros(shape, dtype=np.int32)


def _empty_f(shape):
    return np.zeros(shape, dtype=np.float64)


@dataclasses.dataclass
class Loads:
    """External load tables (reference ``fcVM.py:260-335``).

    Attributes:
      pressure_faces: (nf, 6) tri6 node ids; pressures: (nf,) [MPa], negative
        = pushing onto the surface with the reference's sign convention
        (reference applies ``sign * p`` along the outward normal with
        ``sign=-1`` unless reversed, ``fcVM.py:270-285``). Store the signed
        value directly.
      traction_faces: (nt, 6); tractions: (nt, 3) force/area, direction fixed.
      edges: (nl, 3) line3 node ids; edge_tractions: (nl, 3) force/length.
      vertices: (nv,) node ids; vertex_forces: (nv, 3) point forces.
      gravity: (3,) acceleration vector.
    """

    pressure_faces: np.ndarray = dataclasses.field(default_factory=lambda: _empty_i((0, 6)))
    pressures: np.ndarray = dataclasses.field(default_factory=lambda: _empty_f((0,)))
    traction_faces: np.ndarray = dataclasses.field(default_factory=lambda: _empty_i((0, 6)))
    tractions: np.ndarray = dataclasses.field(default_factory=lambda: _empty_f((0, 3)))
    edges: np.ndarray = dataclasses.field(default_factory=lambda: _empty_i((0, 3)))
    edge_tractions: np.ndarray = dataclasses.field(default_factory=lambda: _empty_f((0, 3)))
    vertices: np.ndarray = dataclasses.field(default_factory=lambda: _empty_i((0,)))
    vertex_forces: np.ndarray = dataclasses.field(default_factory=lambda: _empty_f((0, 3)))
    gravity: np.ndarray = dataclasses.field(default_factory=lambda: _empty_f((3,)))

    def __post_init__(self):
        self.pressure_faces = np.asarray(self.pressure_faces, dtype=np.int32).reshape(-1, 6)
        self.pressures = np.asarray(self.pressures, dtype=np.float64).reshape(-1)
        self.traction_faces = np.asarray(self.traction_faces, dtype=np.int32).reshape(-1, 6)
        self.tractions = np.asarray(self.tractions, dtype=np.float64).reshape(-1, 3)
        self.edges = np.asarray(self.edges, dtype=np.int32).reshape(-1, 3)
        self.edge_tractions = np.asarray(self.edge_tractions, dtype=np.float64).reshape(-1, 3)
        self.vertices = np.asarray(self.vertices, dtype=np.int32).reshape(-1)
        self.vertex_forces = np.asarray(self.vertex_forces, dtype=np.float64).reshape(-1, 3)
        self.gravity = np.asarray(self.gravity, dtype=np.float64).reshape(3)


def distribute_total_force(mesh: Mesh, force, faces=None, edges=None, vertices=None):
    """Convert a total force vector into per-unit load-table entries.

    The reference's ``Fem::ConstraintForce`` distributes a total force over
    the selected boundary by face area / edge length / vertex count
    (``fcVM.py:289-326``).  Returns a :class:`Loads`-kwargs dict with the
    matching per-unit tractions.
    """
    force = np.asarray(force, dtype=np.float64).reshape(3)
    out = {}
    if faces is not None and len(faces):
        faces = np.asarray(faces, dtype=np.int32).reshape(-1, 6)
        area = _face_area(mesh.coords, faces)
        out["traction_faces"] = faces
        out["tractions"] = np.tile(force / area, (len(faces), 1))
    if edges is not None and len(edges):
        edges = np.asarray(edges, dtype=np.int32).reshape(-1, 3)
        length = _edge_length(mesh.coords, edges)
        out["edges"] = edges
        out["edge_tractions"] = np.tile(force / length, (len(edges), 1))
    if vertices is not None and len(vertices):
        vertices = np.asarray(vertices, dtype=np.int32).reshape(-1)
        out["vertices"] = vertices
        out["vertex_forces"] = np.tile(force / len(vertices), (len(vertices), 1))
    return out


def _face_area(coords, faces):
    """Total area of tri6 faces by 6-point Gauss integration."""
    from fcvm_tpu_torch.ops import elements as el

    # xs[f, g, a, :] = d(x, y, z)/d(xi_a) at Gauss point g of face f
    xs = np.einsum("gak,fki->fgai", el.DSHP6_AT_GP, np.asarray(coords)[faces])
    xsj = np.linalg.norm(np.cross(xs[:, :, 0], xs[:, :, 1]), axis=-1)
    return float(np.sum(xsj * el.W6[None, :]))


def _edge_length(coords, edges):
    """Total length of line3 edges by 2-point Gauss integration."""
    from fcvm_tpu_torch.ops import elements as el

    dx = np.einsum("gk,eki->egi", el.DSHP2_AT_GP, np.asarray(coords)[edges])
    return float(np.sum(np.linalg.norm(dx, axis=-1) * el.W2[None, :]))


@dataclasses.dataclass
class Model:
    """A complete analysis model: mesh + material + constraints + loads.

    ``materials_by_element`` is the per-element (E, nu, rho) table — the
    reference extracts exactly this (``materialbyElement``,
    ``fcVM.py:170-181``) but its kernels then use row 0 only; here it is
    honored throughout assembly, stress update and gravity when given.
    """

    mesh: Mesh
    material: Material
    bcs: BoundaryConditions
    loads: Loads
    name: str = "model"
    materials_by_element: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.materials_by_element is not None:
            self.materials_by_element = np.asarray(
                self.materials_by_element, dtype=np.float64
            ).reshape(self.mesh.n_elements, 3)

    @property
    def ndof(self) -> int:
        return self.mesh.ndof


def model_from_arrays(ref_model) -> Model:
    """The port's :class:`Model` from any object shaped like one.

    Reads ``mesh.coords``/``mesh.elnodes``, ``material`` (``e``, ``nu``,
    ``density``), ``bcs`` (``fixed_dofs``/``fixed_values``), every
    :class:`Loads` table, ``name`` and ``materials_by_element`` through
    numpy, so a :class:`fcvm_tpu.models.spec.Model` converts without this
    package importing the JAX one.
    """
    m = ref_model.mesh
    mat = ref_model.material
    ld = ref_model.loads
    loads = Loads(**{
        f.name: np.array(getattr(ld, f.name)) for f in dataclasses.fields(Loads)
    })
    mbe = getattr(ref_model, "materials_by_element", None)
    return Model(
        Mesh(np.array(m.coords), np.array(m.elnodes)),
        Material(float(mat.e), float(mat.nu), float(mat.density)),
        BoundaryConditions(
            np.array(ref_model.bcs.fixed_dofs, dtype=np.int32),
            np.array(ref_model.bcs.fixed_values, dtype=np.float64),
        ),
        loads,
        name=getattr(ref_model, "name", "model"),
        materials_by_element=None if mbe is None else np.array(mbe),
    )


def to_torch(tree, device, dtype):
    """Numpy-convertible leaves of ``tree`` as tensors on ``device``.

    Floating leaves take ``dtype``, integer leaves ``int64``, boolean
    leaves stay boolean; tuples (NamedTuples keep their type), lists and
    dicts are walked; ``None`` stays ``None``.  Feeds one module of the port
    the exact state a JAX function produced (e.g. a two-level
    preconditioner or Gauss-point stresses).
    """
    import torch

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_torch(v, device, dtype) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v, device, dtype) for v in tree)
    a = np.asarray(tree)
    if a.dtype == np.bool_:
        return torch.as_tensor(a.copy(), device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a.astype(np.float64), device=device).to(dtype)
