"""The port's FreeCAD ``.FCStd`` reader and its CLI branch against the JAX
package's (``fcvm_tpu.models.fcstd``, ``fcvm_tpu.__main__``), CPU float64.

The reference corpus is not in the repository, so the documents are
synthetic, written by ``fcvm_tpu_torch.tools.fcstd_doc``: a box under every
constraint kind the reader resolves (Fixed on a face and a vertex,
Displacement with free axes and a prescribed value, Force over a face, an
edge and vertices, Pressure pushing and ``Reversed``), with quantity units,
old-style floats and a mesh placement; and the quarter plate with a hole
with its ``.inp`` control file and the equivalent TOML case.  Both readers
are host numpy, so their arrays are equal (float arrays to 1e-14 of their
largest entry: see ``_assert_fields_equal``).
"""

import dataclasses
import zipfile

import numpy as np
import pytest

import fcvm_tpu.__main__ as jax_cli
from fcvm_tpu.models import fcstd as jfc
from fcvm_tpu_torch.__main__ import main
from fcvm_tpu_torch.models import fcstd, meshgen
from fcvm_tpu_torch.models.inp import ControlParams, write_inp
from fcvm_tpu_torch.models.meshio_io import write_unv
from fcvm_tpu_torch.models.spec import Mesh
from fcvm_tpu_torch.tools import fcstd_doc as fd

LX, LY, LZ = 30.0, 20.0, 20.0
ANGLE = np.radians(30.0)
ROT = np.array([[np.cos(ANGLE), -np.sin(ANGLE), 0.0], [np.sin(ANGLE), np.cos(ANGLE), 0.0],
                [0.0, 0.0, 1.0]])
SHIFT = np.array([5.0, -3.0, 2.0])
PLATE_SIZE = (6, 4, 1)


def _placed(pts, nrm=None):
    """A cloud of the box's local frame in the placed (document) frame."""
    pts = np.asarray(pts) @ ROT.T + SHIFT
    return pts if nrm is None else (pts, np.asarray(nrm) @ ROT.T)


@pytest.fixture(scope="module")
def box_doc(tmp_path_factory):
    """The box (30 x 20 x 20, 3 x 2 x 2 cells) placed by a rotation about z
    and a shift, under one constraint of every kind, with its ``.inp``
    (gravity on)."""
    tmp = tmp_path_factory.mktemp("box")
    box = meshgen.box_tet10(3, 2, 2, LX, LY, LZ)
    mesh = Mesh(_placed(box.coords), box.elnodes)
    x0_pts, x0_nrm = fd.plane_cloud((0, 0, 0), (0, 0, LZ), (0, LY, 0))  # normal -x
    corner = np.array([[LX, LY, LZ]])
    y0 = fd.plane_cloud((0, 0, 0), (LX, 0, 0), (0, 0, LZ))  # normal -y
    z0 = fd.plane_cloud((0, 0, 0), (0, LY, 0), (LX, 0, 0))  # normal -z
    xl_pts, _ = fd.plane_cloud((LX, 0, 0), (0, LY, 0), (0, 0, LZ))
    top = fd.plane_cloud((0, 0, LZ), (LX, 0, 0), (0, LY, 0))  # normal +z
    back = fd.plane_cloud((0, LY, 0), (0, 0, LZ), (LX, 0, 0))  # normal +y
    edge = fd.segment_cloud((0, 0, LZ), (LX, 0, LZ))
    verts = np.array([[LX, 0.0, 0.0], [LX, LY, 0.0]])
    rot = lambda v: tuple(np.asarray(v, dtype=float) @ ROT.T)  # noqa: E731
    constraints = [
        fd.fixed("FixedFaceVertex", [("Box", "Face1"), ("Box", "Vertex8")],
                 *_placed(np.vstack([x0_pts, corner]),
                          np.vstack([x0_nrm, [[-1.0, 0.0, 0.0]]]))),
        fd.displacement("SlideY", [("Box", "Face3")], *_placed(*y0), (None, 0.0, None)),
        fd.displacement("SinkZ", [("Box", "Face5")], *_placed(*z0), (None, None, -0.01)),
        fd.force("PushFace", [("Box", "Face2")], _placed(xl_pts), 1000.0, rot((1, 0, 0))),
        fd.force("PullEdge", [("Box", "Edge3")], _placed(edge), 200.0, rot((0, 0, -1)),
                 quantity=False),
        fd.force("PointLoads", [("Box", "Vertex1"), ("Box", "Vertex2")], _placed(verts), 50.0,
                 rot((0, 1, 0))),
        fd.pressure("Suction", [("Box", "Face6")], *_placed(*top), 2.0, reversed_=True),
        fd.pressure("Push", [("Box", "Face4")], *_placed(*back), 1.5, quantity=False),
    ]
    placement = np.column_stack([ROT, SHIFT])
    doc = tmp / "box.FCStd"
    fd.write_fcstd(doc, mesh, constraints, label="box", placement=placement,
                   card={"YoungsModulus": "200 GPa", "PoissonRatio": "0.29",
                         "Density": "7.85 g/cm^3"})
    inp = tmp / "box.inp"
    write_inp(ControlParams(sig_yield=235.0, grav_z=-9810.0, nstep=4, target_lf=2.0), inp)
    return dict(doc=doc, inp=inp, mesh=mesh)


def _assert_fields_equal(a, b, what):
    """Every field of two dataclass instances equal: integer arrays and
    scalars exactly, float arrays to 1e-14 of their largest entry (a total
    force spread over a face divides by the face's area, whose quadrature
    sum the two packages round differently in the last bit)."""
    assert type(a).__name__ == type(b).__name__, what
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) and va.dtype.kind == "f":
            assert va.shape == vb.shape, f"{what}.{f.name}"
            np.testing.assert_allclose(va, vb, rtol=0, atol=1e-14 * max(np.abs(vb).max(initial=0), 1),
                                       err_msg=f"{what}.{f.name}")
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f"{what}.{f.name}")
        elif dataclasses.is_dataclass(va):
            _assert_fields_equal(va, vb, f"{what}.{f.name}")
        else:
            assert va == vb, f"{what}.{f.name}: {va!r} != {vb!r}"


def test_read_fcstd_matches_jax(box_doc):
    """The document read by both packages: the label, the placed mesh (the
    writer's coordinates to rounding), the material card in MPa and
    kg/mm^3, and every constraint's references, clouds and scalars in N and
    MPa, in document order."""
    got, want = fcstd.read_fcstd(box_doc["doc"]), jfc.read_fcstd(box_doc["doc"])
    assert got.label == want.label == "box"
    np.testing.assert_array_equal(got.mesh.coords, want.mesh.coords)
    np.testing.assert_array_equal(got.mesh.elnodes, want.mesh.elnodes)
    np.testing.assert_allclose(got.mesh.coords, box_doc["mesh"].coords, rtol=0, atol=1e-12)
    assert len(got.materials) == len(want.materials) == 1
    _assert_fields_equal(got.materials[0], want.materials[0], "material")
    m = got.materials[0]
    assert (m.e, m.nu) == (200000.0, 0.29) and abs(m.density - 7.85e-6) < 1e-18
    assert [c.name for c in got.constraints] == [c.name for c in want.constraints]
    for c, w in zip(got.constraints, want.constraints):
        assert (c.kind, c.subs) == (w.kind, w.subs), c.name
        np.testing.assert_array_equal(c.points, w.points, err_msg=c.name)
        np.testing.assert_array_equal(c.normals, w.normals, err_msg=c.name)
        assert c.props.keys() == w.props.keys(), c.name
        for k, v in c.props.items():
            np.testing.assert_array_equal(v, w.props[k], err_msg=f"{c.name}.{k}")
    props = {c.name: c.props for c in got.constraints}
    assert props["PushFace"]["force"] == 1000.0 and props["PullEdge"]["force"] == 200.0
    assert props["Suction"] == {"pressure": 2.0, "reversed": True}
    assert props["Push"] == {"pressure": 1.5, "reversed": False}
    assert props["SlideY"]["xfree"] and not props["SlideY"]["yfree"]


def test_build_model_matches_jax(box_doc):
    """``load_reference_case`` of both packages on the document and its
    ``.inp``: the same ``ControlParams``, material, masks, prescribed
    values and load tables; and every constraint resolved to what it
    references."""
    model, params = fcstd.load_reference_case(box_doc["doc"], inp_path=box_doc["inp"])
    jmodel, jparams = jfc.load_reference_case(box_doc["doc"], inp_path=box_doc["inp"])
    assert dataclasses.asdict(params) == dataclasses.asdict(jparams)
    assert params.grav_z == -9810.0 and params.nstep == 4
    assert model.name == jmodel.name == "box"
    assert dataclasses.astuple(model.material) == dataclasses.astuple(jmodel.material)
    ndof = model.mesh.ndof
    for got, want in zip(model.bcs.masks(ndof), jmodel.bcs.masks(ndof)):
        np.testing.assert_array_equal(got, want)
    _assert_fields_equal(model.loads, jmodel.loads, "loads")
    fixmask, u_fix, movdof = model.bcs.masks(ndof)
    local = (model.mesh.coords - SHIFT) @ ROT  # back in the box's frame
    x0 = np.where(local[:, 0] < 1e-9)[0]
    assert (fixmask.reshape(-1, 3)[x0] < 0.5).all()  # the Fixed face
    corner = np.where((np.abs(local - [LX, LY, LZ]) < 1e-9).all(axis=1))[0]
    assert len(corner) == 1 and (fixmask.reshape(-1, 3)[corner] < 0.5).all()  # its vertex
    assert movdof.sum() > 0 and np.isclose(u_fix[movdof > 0.5], -0.01).all()
    loads = model.loads
    assert len(loads.pressure_faces) == 2 * (3 * 2) + 2 * (3 * 2)  # the top and the back
    assert sorted(set(loads.pressures.tolist())) == [-1.5, 2.0]
    assert len(loads.traction_faces) == 2 * 2 * 2 and len(loads.edges) == 3
    assert len(loads.vertices) == 2
    np.testing.assert_allclose(loads.vertex_forces, np.tile([0.0, 25.0, 0.0] @ ROT.T, (2, 1)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(loads.gravity, [0.0, 0.0, -9810.0])


@pytest.mark.parametrize("arc", [0.5 * np.pi, 0.25 * np.pi], ids=["quarter", "eighth"])
def test_cloud_resolver_cylinder_matches_jax(arc):
    """``CloudResolver.resolve_faces`` on the plate's hole, a cylinder of
    radius 10 about z: a cloud over the whole quarter arc and over half of
    it (a partly loaded hole) selects the same faces in both packages, all
    on the hole and, for the half arc, only those within it."""
    mesh = meshgen.plate_with_hole_tet10(**fd.PLATE, n_circ=8, n_rad=4, n_thick=2)
    pts, nrm = fd.cylinder_cloud((0.0, 0.0, 0.0), 10.0, (0.0, arc), (0.0, 5.0), outward=False)
    got = fcstd.CloudResolver(mesh).resolve_faces(pts, nrm, "hole")
    want = jfc.CloudResolver(mesh).resolve_faces(pts, nrm, "hole")
    np.testing.assert_array_equal(got, want)
    xyz = mesh.coords[got]
    radius = np.hypot(xyz[..., 0], xyz[..., 1])  # mid-side nodes sit on the chords
    assert len(got) > 0 and np.allclose(radius[:, :3], 10.0) and (radius >= 9.9).all()
    theta = np.arctan2(xyz[..., 1].mean(axis=1), xyz[..., 0].mean(axis=1))
    assert theta.max() <= arc + 1e-9
    # faces per thickness layer and element column: 2 * 2 per cell of the arc
    assert len(got) == 2 * 2 * round(8 * arc / (0.5 * np.pi))


def test_empty_mesh_raises(box_doc, tmp_path):
    """A document saved with its mesh purged: both readers raise the
    empty-mesh ``ValueError``."""
    doc = tmp_path / "purged.FCStd"
    with zipfile.ZipFile(box_doc["doc"]) as src, zipfile.ZipFile(doc, "w") as dst:
        for name in src.namelist():
            dst.writestr(name, b"" if name == "FemMesh.unv" else src.read(name))
    for read in (fcstd.read_fcstd, jfc.read_fcstd):
        with pytest.raises(ValueError, match="empty"):
            read(doc)


@pytest.fixture(scope="module")
def plate_doc(tmp_path_factory):
    """The quarter plate with a hole as a document, its ``.inp`` (3 steps)
    and the same model as a TOML case."""
    tmp = tmp_path_factory.mktemp("plate")
    params = ControlParams(sig_yield=100.0, nstep=3, iterat_max=20, error_max=5e-4, et_e=0.0,
                           target_lf=1.62, ultimate_strain=0.25)
    mesh, (doc, inp, toml) = fd.plate_document(tmp, PLATE_SIZE, params)
    return dict(tmp=tmp, mesh=mesh, doc=doc, inp=inp, toml=toml)


def test_cli_run_fcstd_matches_jax(plate_doc, tmp_path):
    """``run doc.FCStd --inp doc.inp --cpu --x64`` in both CLIs writes the
    same ``.out`` bytes and no ``.avr``; ``--mesh`` with the same mesh in a
    ``.unv`` file writes them too; ``sum`` on a document returns 2."""
    args = ["run", str(plate_doc["doc"]), "--inp", str(plate_doc["inp"]), "--cpu", "--x64"]
    assert jax_cli.main(args + ["--outdir", str(tmp_path / "jax")]) == 0
    assert main(args + ["--outdir", str(tmp_path / "port"), "--no-plots"]) == 0
    unv = tmp_path / "plate.unv"
    write_unv(unv, plate_doc["mesh"])
    assert main(args + ["--outdir", str(tmp_path / "mesh"), "--no-plots", "--mesh",
                        str(unv)]) == 0
    want = (tmp_path / "jax" / "plate.out").read_bytes()
    assert (tmp_path / "port" / "plate.out").read_bytes() == want
    assert (tmp_path / "mesh" / "plate.out").read_bytes() == want
    for tag in ("jax", "port", "mesh"):
        assert not (tmp_path / tag / "plate.avr").exists()
        assert (tmp_path / tag / "plate.vtk").exists()
    rows = [ln for ln in want.decode().splitlines() if ln.strip()[:1].isdigit()]
    assert len(rows) == 4
    assert main(["sum", str(plate_doc["doc"]), "--outdir", str(tmp_path / "port")]) == 2
    assert jax_cli.main(["sum", str(plate_doc["doc"]), "--outdir", str(tmp_path / "jax")]) == 2


def test_plate_document_matches_its_toml_case(plate_doc, tmp_path):
    """The plate document and its TOML case are one model: the same fixed
    dofs, the same assembled load vector, and the port's CLI writes the
    same history from both to the solver's tolerance."""
    import torch

    from fcvm_tpu_torch.models.casefile import load_case
    from fcvm_tpu_torch.ops import kernels
    from fcvm_tpu_torch.runtime import system as sysm

    doc_model, doc_params = fcstd.load_reference_case(plate_doc["doc"],
                                                      inp_path=plate_doc["inp"])
    toml_model, toml_params = load_case(plate_doc["toml"])
    assert dataclasses.asdict(doc_params) == dataclasses.asdict(toml_params)
    ndof = doc_model.mesh.ndof
    np.testing.assert_array_equal(doc_model.bcs.masks(ndof)[0], toml_model.bcs.masks(ndof)[0])
    glv = []
    for model in (doc_model, toml_model):
        lt = sysm.LoadTables.from_spec(model.loads, torch.float64, "cpu", ndof)
        coords = torch.as_tensor(model.mesh.coords)
        elnodes = torch.as_tensor(model.mesh.elnodes, dtype=torch.int64)
        glv.append(sysm.external_loads(coords, torch.zeros(ndof, dtype=torch.float64), elnodes,
                                       lt, model.material.density, False,
                                       kernels.segment_plan(elnodes))[0].numpy())
    assert np.abs(glv[1]).max() > 0
    np.testing.assert_allclose(glv[0], glv[1], rtol=0, atol=1e-12 * np.abs(glv[1]).max())
    rows = {}
    for tag, case in (("doc", [str(plate_doc["doc"]), "--inp", str(plate_doc["inp"])]),
                      ("toml", [str(plate_doc["toml"])])):
        assert main(["run", *case, "--cpu", "--x64", "--no-plots", "--outdir",
                     str(tmp_path / tag)]) == 0
        text = (tmp_path / tag / "plate.out").read_text().splitlines()
        rows[tag] = np.array([[float(v) for v in ln.split()] for ln in text
                              if ln.strip()[:1].isdigit()])
    np.testing.assert_allclose(rows["doc"], rows["toml"], rtol=1e-6, atol=1e-12)
