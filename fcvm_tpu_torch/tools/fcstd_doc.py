"""Write synthetic FreeCAD ``.FCStd`` documents for the reader
(:mod:`fcvm_tpu_torch.models.fcstd`).

An ``.FCStd`` file is a zip archive: ``Document.xml`` (the objects and their
properties), the mesh (``FemMesh.unv``) and, per constraint, the
``Points``/``Normals`` vector-list blobs of the sample clouds FreeCAD draws
its markers from.  :func:`write_fcstd` writes one from a mesh, a material
card and :class:`DocConstraint` entries; the cloud helpers sample a plane
patch, a cylinder patch, a segment or a set of vertices.
:func:`plate_document` writes the quarter plate with a hole (the symmetry
planes as Displacement constraints, a Fixed outer corner, a Force pulling
the top face) with its ``.inp`` control file, and the equivalent TOML case.

    python -m fcvm_tpu_torch.tools.fcstd_doc OUTDIR [--size 10 8 1] [--nstep 6]

writes ``OUTDIR/plate.FCStd``, ``plate.inp`` and ``plate.toml``; then
``python -m fcvm_tpu_torch run OUTDIR/plate.FCStd --inp OUTDIR/plate.inp``.
"""

from __future__ import annotations

import argparse
import dataclasses
import struct
import tempfile
import zipfile
from pathlib import Path
from typing import Optional
from xml.sax.saxutils import quoteattr

import numpy as np

from fcvm_tpu_torch.models import meshgen
from fcvm_tpu_torch.models.inp import ControlParams, write_inp
from fcvm_tpu_torch.models.meshio_io import write_unv
from fcvm_tpu_torch.models.spec import Mesh


@dataclasses.dataclass
class DocConstraint:
    """One ``Fem::Constraint<kind>`` object.

    ``props`` holds the kind's properties, each ``(type, value)``:
    ``("App::PropertyBool", True)``, ``("App::PropertyFloat", 0.5)``,
    ``("App::PropertyForce", 5e5)`` (a quantity, in FreeCAD's internal mN),
    ``("App::PropertyPressure", 5e4)`` (kPa), ``("App::PropertyVector",
    (x, y, z))``.  ``normals`` None writes no ``Normals`` blob (as FreeCAD
    does for a Force)."""

    name: str
    kind: str  # Fixed | Displacement | Force | Pressure
    subs: list  # [(object name, sub-element name), ...]
    points: np.ndarray
    normals: Optional[np.ndarray] = None
    props: dict = dataclasses.field(default_factory=dict)


def fixed(name, subs, points, normals=None):
    return DocConstraint(name, "Fixed", subs, points, normals)


def displacement(name, subs, points, normals, values):
    """``values`` (x, y, z): a number prescribes the axis, None leaves it free."""
    props = {}
    for ax, v in zip("xyz", values):
        props[f"{ax}Free"] = ("App::PropertyBool", v is None)
        props[f"{ax}Displacement"] = ("App::PropertyFloat", 0.0 if v is None else float(v))
    return DocConstraint(name, "Displacement", subs, points, normals, props)


def force(name, subs, points, newton, direction, quantity=True):
    """A total force of ``newton`` along ``direction``: stored as a quantity
    (mN) or, ``quantity=False``, as an old-style float in N."""
    value = ("App::PropertyForce", 1e3 * newton) if quantity else ("App::PropertyFloat", newton)
    return DocConstraint(name, "Force", subs, points, None,
                         {"Force": value, "DirectionVector": ("App::PropertyVector", direction)})


def pressure(name, subs, points, normals, mpa, reversed_=False, quantity=True):
    """A pressure of ``mpa``, pushing (``reversed_`` pulling): stored as a
    quantity (kPa) or, ``quantity=False``, as an old-style float in MPa."""
    value = ("App::PropertyPressure", 1e3 * mpa) if quantity else ("App::PropertyFloat", mpa)
    return DocConstraint(name, "Pressure", subs, points, normals,
                         {"Pressure": value, "Reversed": ("App::PropertyBool", reversed_)})


# -- sample clouds --------------------------------------------------------------


def plane_cloud(origin, u, v, n=(6, 6)):
    """An n[0] x n[1] grid over the parallelogram ``origin + s u + t v``
    (s, t in [0, 1]), with the unit normal ``u x v``: (points, normals)."""
    origin, u, v = (np.asarray(a, dtype=np.float64) for a in (origin, u, v))
    s, t = np.meshgrid(np.linspace(0.0, 1.0, n[0]), np.linspace(0.0, 1.0, n[1]), indexing="ij")
    pts = origin + s.reshape(-1, 1) * u + t.reshape(-1, 1) * v
    nrm = np.cross(u, v)
    return pts, np.tile(nrm / np.linalg.norm(nrm), (len(pts), 1))


def cylinder_cloud(center, radius, theta, z, n=(7, 4), outward=True):
    """A grid on the cylinder about the z axis through ``center``: angles
    ``theta`` (from, to) in radians, heights ``z`` (from, to); normals
    radial, pointing away from the axis when ``outward``."""
    th, zz = np.meshgrid(np.linspace(*theta, n[0]), np.linspace(*z, n[1]), indexing="ij")
    th, zz = th.reshape(-1), zz.reshape(-1)
    radial = np.column_stack([np.cos(th), np.sin(th), np.zeros_like(th)])
    pts = np.asarray(center, dtype=np.float64) + radius * radial
    pts[:, 2] = zz
    return pts, radial if outward else -radial


def segment_cloud(a, b, n=5):
    """``n`` points from ``a`` to ``b``."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return a + np.linspace(0.0, 1.0, n)[:, None] * (b - a)


# -- the document -----------------------------------------------------------------


def _vectorlist(a) -> bytes:
    a = np.asarray(a, dtype="<f8").reshape(-1, 3)
    return struct.pack("<I", len(a)) + a.tobytes()


def _prop(name, typ, value) -> str:
    if typ == "App::PropertyBool":
        body = f'<Bool value="{"true" if value else "false"}"/>'
    elif typ == "App::PropertyVector":
        x, y, z = (float(c) for c in value)
        body = f'<PropertyVector valueX="{x!r}" valueY="{y!r}" valueZ="{z!r}"/>'
    else:
        body = f'<Float value="{float(value)!r}"/>'
    return f'<Property name="{name}" type="{typ}">{body}</Property>'


def _links(subs) -> str:
    links = "".join(f"<Link obj={quoteattr(o)} sub={quoteattr(s)}/>" for o, s in subs)
    return (f'<Property name="References" type="App::PropertyLinkSubList">'
            f'<LinkSubList count="{len(subs)}">{links}</LinkSubList></Property>')


def write_fcstd(path, mesh: Mesh, constraints, card=None, label="synthetic",
                placement=None) -> None:
    """Write ``mesh``, the material ``card`` (FreeCAD's keys and quantity
    strings; default steel in MPa) and ``constraints`` (document order) as
    an ``.FCStd`` archive at ``path``.

    ``placement`` (a 3x4 affine ``[R | t]``) is stored on the mesh
    property, and the mesh is written in its local frame, so the reader's
    placed coordinates are ``mesh.coords`` again (to rounding)."""
    card = card or {"YoungsModulus": "210000 MPa", "PoissonRatio": "0.3",
                    "Density": "7900 kg/m^3"}
    coords = mesh.coords
    attrs = ""
    if placement is not None:
        a = np.asarray(placement, dtype=np.float64)
        coords = (coords - a[:, 3]) @ a[:, :3]  # R^T (x - t), row-wise
        attrs = "".join(f' a{i + 1}{j + 1}="{float(a[i, j])!r}"' for i in range(3) for j in range(4))
    blobs = {}
    types = [("FEMMeshGmsh", "Fem::FemMeshObjectPython"),
             ("MaterialSolid", "App::MaterialObjectPython")]
    data = [
        ("FEMMeshGmsh",
         f'<Property name="FemMesh" type="Fem::PropertyFemMesh"><FemMesh file="FemMesh.unv"'
         f'{attrs}/></Property><Property name="Proxy" type="App::PropertyPythonObject">'
         '<Python value="" encoded="yes" module="femobjects.mesh_gmsh" class="MeshGmsh"/>'
         "</Property>"),
        ("MaterialSolid",
         '<Property name="Material" type="App::PropertyMap"><Map count="%d">%s</Map>'
         "</Property>%s" % (len(card), "".join(
             f"<Item key={quoteattr(k)} value={quoteattr(v)}/>" for k, v in card.items()),
             _links([]))),
    ]
    for c in constraints:
        types.append((c.name, f"Fem::Constraint{c.kind}"))
        props = [_links(c.subs)]
        for blob, arr in (("Points", c.points), ("Normals", c.normals)):
            if arr is not None:
                blobs[f"{c.name}{blob}"] = _vectorlist(arr)
                props.append(f'<Property name="{blob}" type="App::PropertyVectorList">'
                             f'<VectorList file="{c.name}{blob}"/></Property>')
        props += [_prop(k, t, v) for k, (t, v) in c.props.items()]
        data.append((c.name, "".join(props)))
    xml = ['<?xml version="1.0" encoding="utf-8"?>',
           '<Document SchemaVersion="4" ProgramVersion="0.21.2" FileVersion="1">',
           '<Properties Count="1"><Property name="Label" type="App::PropertyString">'
           f"<String value={quoteattr(label)}/></Property></Properties>",
           f'<Objects Count="{len(types)}">']
    xml += [f"<Object type={quoteattr(t)} name={quoteattr(n)}/>" for n, t in types]
    xml += ["</Objects>", f'<ObjectData Count="{len(data)}">']
    xml += [f"<Object name={quoteattr(n)}><Properties>{p}</Properties></Object>" for n, p in data]
    xml += ["</ObjectData>", "</Document>"]
    with tempfile.TemporaryDirectory() as tmp:
        unv = Path(tmp) / "FemMesh.unv"
        write_unv(unv, Mesh(coords, mesh.elnodes))
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("Document.xml", "\n".join(xml))
            zf.write(unv, "FemMesh.unv")
            for name, blob in blobs.items():
                zf.writestr(name, blob)


# -- the plate with a hole --------------------------------------------------------

PLATE = dict(radius=10.0, width=50.0, height=100.0, thickness=5.0)


def plate_document(outdir, size, params: ControlParams, sigma=50.0, e=210000.0, nu=0.3):
    """Write the quarter plate with a hole (``meshgen.plate_with_hole_tet10``
    at ``size`` = (n_circ, n_rad, n_thick)) as ``OUTDIR/plate.FCStd`` with
    ``plate.inp`` (``params``) and the same model as a TOML case,
    ``plate.toml``: the symmetry planes x = 0, y = 0, z = 0 as Displacement
    constraints on faces, a Fixed vertex at the outer corner (50, 0, 0), and
    a Force of ``sigma`` times the top face's area pulling it along +y (the
    case's traction ``[0, sigma, 0]``: a fixed direction, so the load sums
    across it are exactly 0 in both, where a pressure's follow the face
    normals' rounding).  Returns (the mesh, the three paths)."""
    r, w, h, t = (PLATE[k] for k in ("radius", "width", "height", "thickness"))
    nc, nr, nt = size
    mesh = meshgen.plate_with_hole_tet10(**PLATE, n_circ=nc, n_rad=nr, n_thick=nt)
    sym_x = plane_cloud((0.0, r, 0.0), (0.0, 0.0, t), (0.0, h - r, 0.0))  # normal -x
    sym_y = plane_cloud((r, 0.0, 0.0), (w - r, 0.0, 0.0), (0.0, 0.0, t))  # normal -y
    sym_z = plane_cloud((0.0, 0.0, 0.0), (0.0, h, 0.0), (w, 0.0, 0.0), n=(11, 6))  # -z
    top = plane_cloud((0.0, h, 0.0), (0.0, 0.0, t), (w, 0.0, 0.0))  # normal +y
    corner = np.array([[w, 0.0, 0.0]])
    constraints = [
        displacement("SymmetryX", [("Plate", "Face1")], *sym_x, (0.0, None, None)),
        displacement("SymmetryY", [("Plate", "Face2")], *sym_y, (None, 0.0, None)),
        displacement("SymmetryZ", [("Plate", "Face3")], *sym_z, (None, None, 0.0)),
        fixed("FixedCorner", [("Plate", "Vertex1")], corner),
        force("TopPull", [("Plate", "Face4")], top[0], sigma * w * t, (0.0, 1.0, 0.0)),
    ]
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    doc, inp, toml = outdir / "plate.FCStd", outdir / "plate.inp", outdir / "plate.toml"
    write_fcstd(doc, mesh, constraints, label="plate",
                card={"YoungsModulus": f"{e / 1e3!r} GPa", "PoissonRatio": repr(nu),
                      "Density": "7900 kg/m^3"})
    write_inp(params, inp)
    toml.write_text(f"""name = "plate"
[mesh.generator]
kind = "plate_with_hole"
radius = {r}
width = {w}
height = {h}
thickness = {t}
n_circ = {nc}
n_rad = {nr}
n_thick = {nt}
[material]
e = {e}
nu = {nu}
density = 7.9e-06
[control]
inp = "{inp.name}"
[[bc]]
where = "x < 1e-9"
ux = 0.0
[[bc]]
where = "y < 1e-9"
uy = 0.0
[[bc]]
where = "z < 1e-9"
uz = 0.0
[[bc]]
where = "(x > {w} - 1e-9) & (y < 1e-9) & (z < 1e-9)"
ux = 0.0
uy = 0.0
uz = 0.0
[[load.face]]
where = "y > {h} - 1e-6"
traction = [0.0, {sigma}, 0.0]
""")
    return mesh, (doc, inp, toml)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m fcvm_tpu_torch.tools.fcstd_doc")
    ap.add_argument("outdir")
    ap.add_argument("--size", type=int, nargs=3, default=(10, 8, 1),
                    metavar=("N_CIRC", "N_RAD", "N_THICK"))
    ap.add_argument("--nstep", type=int, default=6)
    args = ap.parse_args(argv)
    params = ControlParams(sig_yield=100.0, nstep=args.nstep, iterat_max=20, error_max=5e-4,
                           et_e=0.0, target_lf=1.62, ultimate_strain=0.25)
    mesh, paths = plate_document(args.outdir, args.size, params)
    print(f"{mesh.n_nodes} nodes, {mesh.n_elements} elements: " + ", ".join(map(str, paths)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
