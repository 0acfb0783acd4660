"""Declarative TOML case files: the GUI/document tier, batch-friendly.

The port's copy of :mod:`fcvm_tpu.models.casefile`: the same files give
the same models.

The reference's front end is a Qt dock panel bound to a FreeCAD document
(``InitGui.py:61-483``); constraints and loads are picked on CAD faces.  The
batch equivalent is a TOML case file: mesh source (file or generator),
material, the 21 control parameters (inline or via a reference ``.inp``),
and boundary conditions/loads selected by coordinate predicates.

Example::

    name = "plate"
    [mesh.generator]           # or: [mesh] file = "plate.msh"
    kind = "box"
    nx = 4
    lx = 10.0
    [material]
    e = 210000.0
    nu = 0.3
    [control]                  # or: inp = "plate.inp"
    sig_yield = 240.0
    nstep = 10
    [[bc]]
    where = "x < 1e-9"
    ux = 0.0
    uy = 0.0
    uz = 0.0
    [[load.face]]
    where = "x > 10.0 - 1e-9"
    traction = [100.0, 0.0, 0.0]
    [loads]
    gravity = [0.0, 0.0, 0.0]

Predicates are numpy expressions over the node coordinate arrays
``x, y, z`` (evaluated with numpy available as ``np``); case files are
trusted input, like any solver input deck.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fcvm_tpu_torch.models.inp import ControlParams, read_inp
from fcvm_tpu_torch.models.spec import (
    BoundaryConditions,
    Loads,
    Material,
    Mesh,
    Model,
    distribute_total_force,
)


def _predicate(expr: str):
    def pred(x, y, z):
        return eval(expr, {"np": np, "x": x, "y": y, "z": z})  # noqa: S307

    return pred


def load_case(path) -> tuple[Model, ControlParams]:
    """Parse a TOML case file into (Model, ControlParams)."""
    import tomllib

    path = Path(path)
    with open(path, "rb") as f:
        case = tomllib.load(f)
    base = path.parent

    mesh = _build_mesh(case.get("mesh", {}), base)
    matspec = case.get("material", {})
    material = Material(
        e=float(matspec.get("e", 210000.0)),
        nu=float(matspec.get("nu", 0.3)),
        density=float(matspec.get("density", 0.0)),
    )
    # optional per-element material regions selected by centroid predicates
    materials_by_element = None
    if matspec.get("region"):
        centroids = mesh.coords[mesh.elnodes[:, :4]].mean(axis=1)
        mbe = np.tile(
            [material.e, material.nu, material.density], (mesh.n_elements, 1)
        )
        for reg in matspec["region"]:
            m = _predicate(reg["where"])(
                centroids[:, 0], centroids[:, 1], centroids[:, 2]
            )
            if "e" in reg:
                mbe[m, 0] = float(reg["e"])
            if "nu" in reg:
                mbe[m, 1] = float(reg["nu"])
            if "density" in reg:
                mbe[m, 2] = float(reg["density"])
        materials_by_element = mbe

    ctrl = case.get("control", {})
    if "inp" in ctrl:
        params = read_inp(base / ctrl["inp"])
    else:
        params = ControlParams()
        for k, v in ctrl.items():
            if not hasattr(params, k):
                raise ValueError(f"unknown control parameter: {k}")
            setattr(params, k, type(getattr(params, k))(v))

    entries = []
    for bc in case.get("bc", []):
        nodes = mesh.select_nodes(_predicate(bc["where"]))
        comps = (bc.get("ux"), bc.get("uy"), bc.get("uz"))
        entries.append((nodes, comps))
    bcs = BoundaryConditions.from_node_sets(entries) if entries else (
        BoundaryConditions(np.zeros(0, np.int32), np.zeros(0))
    )

    loadspec = case.get("load", {})
    p_faces, p_vals = [], []
    t_faces, t_vals = [], []
    for entry in loadspec.get("face_pressure", []):
        faces = mesh.faces_on(_predicate(entry["where"]))
        p_faces.append(faces)
        p_vals.append(np.full(len(faces), float(entry["pressure"])))
    for entry in loadspec.get("face", []):
        faces = mesh.faces_on(_predicate(entry["where"]))
        t_faces.append(faces)
        t_vals.append(np.tile(np.asarray(entry["traction"], float), (len(faces), 1)))
    e_edges, e_vals = [], []
    vert_ids, vert_forces = [], []
    for entry in loadspec.get("vertex", []):
        nodes = mesh.select_nodes(_predicate(entry["where"]))
        force = np.asarray(entry["force"], float)
        for nd in nodes:
            vert_ids.append(nd)
            vert_forces.append(force / len(nodes))
    for entry in loadspec.get("force", []):
        # total force distributed by area/length/count, the reference's
        # Fem::ConstraintForce semantics (fcVM.py:289-326)
        pred = _predicate(entry["where"])
        on = entry.get("on", "face")
        if on == "face":
            kw = distribute_total_force(mesh, entry["total"], faces=mesh.faces_on(pred))
            if kw:
                t_faces.append(kw["traction_faces"])
                t_vals.append(kw["tractions"])
        elif on == "edge":
            kw = distribute_total_force(mesh, entry["total"], edges=mesh.edges_on(pred))
            if kw:
                e_edges.append(kw["edges"])
                e_vals.append(kw["edge_tractions"])
        elif on == "vertex":
            kw = distribute_total_force(
                mesh, entry["total"], vertices=mesh.select_nodes(pred)
            )
            if kw:
                vert_ids.extend(kw["vertices"].tolist())
                vert_forces.extend(kw["vertex_forces"].tolist())
        else:
            raise ValueError(f"unknown force target: {on}")

    gravity = np.asarray(
        case.get("loads", {}).get("gravity", loadspec.get("gravity", [0.0, 0.0, 0.0])),
        float,
    )
    # the .inp gravity fields win if a reference control file was given
    if "inp" in ctrl and (params.grav_x or params.grav_y or params.grav_z):
        gravity = np.asarray(params.gravity, float)

    loads = Loads(
        pressure_faces=np.concatenate(p_faces) if p_faces else np.zeros((0, 6), np.int32),
        pressures=np.concatenate(p_vals) if p_vals else np.zeros(0),
        traction_faces=np.concatenate(t_faces) if t_faces else np.zeros((0, 6), np.int32),
        tractions=np.concatenate(t_vals) if t_vals else np.zeros((0, 3)),
        edges=np.concatenate(e_edges) if e_edges else np.zeros((0, 3), np.int32),
        edge_tractions=np.concatenate(e_vals) if e_vals else np.zeros((0, 3)),
        vertices=np.asarray(vert_ids, np.int32),
        vertex_forces=np.asarray(vert_forces, float).reshape(-1, 3),
        gravity=gravity,
    )
    name = case.get("name", path.stem)
    model = Model(
        mesh, material, bcs, loads, name=name,
        materials_by_element=materials_by_element,
    )
    return model, params


def parse_sum_groups(path, mesh: Mesh):
    """``[[sum.edge]] / [[sum.face]]`` selectors -> named element groups for
    the Sum-button equivalent (:func:`fcvm_tpu_torch.api.run_sum`)."""
    import tomllib

    with open(path, "rb") as f:
        case = tomllib.load(f)
    spec = case.get("sum", {})
    edge_groups = {}
    face_groups = {}
    for i, entry in enumerate(spec.get("edge", [])):
        name = entry.get("name", f"Edge{i + 1}")
        edge_groups[name] = mesh.edges_on(_predicate(entry["where"]))
    for i, entry in enumerate(spec.get("face", [])):
        name = entry.get("name", f"Face{i + 1}")
        face_groups[name] = mesh.faces_on(_predicate(entry["where"]))
    return edge_groups, face_groups


def _build_mesh(spec: dict, base: Path) -> Mesh:
    from fcvm_tpu_torch.models import meshgen, meshio_io

    if "file" in spec:
        mesh = meshio_io.read_mesh(base / spec["file"])
    elif "generator" in spec:
        g = dict(spec["generator"])
        kind = g.pop("kind")
        if kind == "box":
            mesh = meshgen.box_tet10(
                int(g.get("nx", 4)), int(g.get("ny", g.get("nx", 4))),
                int(g.get("nz", g.get("nx", 4))),
                float(g.get("lx", 1.0)), float(g.get("ly", g.get("lx", 1.0))),
                float(g.get("lz", g.get("lx", 1.0))),
            )
        elif kind == "plate_with_hole":
            mesh = meshgen.plate_with_hole_tet10(
                radius=float(g.get("radius", 10.0)),
                width=float(g.get("width", 50.0)),
                height=float(g.get("height", 100.0)),
                thickness=float(g.get("thickness", 5.0)),
                n_circ=int(g.get("n_circ", 8)),
                n_rad=int(g.get("n_rad", 6)),
                n_thick=int(g.get("n_thick", 1)),
            )
        elif kind == "cruciform":
            mesh = meshgen.cruciform_tet10(
                b=float(g.get("b", 40.0)),
                t=float(g.get("t", 4.0)),
                length=float(g.get("length", 200.0)),
                n_flange=int(g.get("n_flange", 5)),
                n_thick=int(g.get("n_thick", 1)),
                n_z=int(g.get("n_z", 16)),
            )
        else:
            raise ValueError(f"unknown mesh generator: {kind}")
    else:
        raise ValueError("case file needs [mesh] file=... or [mesh.generator]")

    if spec.get("rcm", False):
        from fcvm_tpu_torch import native

        perm = native.rcm_order(mesh.elnodes.astype(np.int64), mesh.n_nodes)
        coords, eln = native.apply_node_permutation(mesh.coords, mesh.elnodes, perm)
        mesh = Mesh(coords, eln)
    return mesh
