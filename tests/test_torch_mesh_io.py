"""The port's mesh files, native library and RCM against the JAX package's
(``tests/test_mesh_io.py``): Gmsh and UNV round trips on the native and the
Python paths, each package reading the other's files, the RCM permutation,
and the native formatters against their Python versions, byte for byte.
"""

import numpy as np
import pytest

from fcvm_tpu import native as jax_native
from fcvm_tpu.models import meshgen
from fcvm_tpu.models import meshio_io as jio
from fcvm_tpu_torch import native
from fcvm_tpu_torch.models import meshio_io as tio
from fcvm_tpu_torch.models.spec import Mesh


@pytest.fixture(scope="module")
def mesh():
    m = meshgen.box_tet10(2, 2, 2, 3.0, 2.0, 1.0)
    return Mesh(m.coords, m.elnodes)


def _assert_same(a, b):
    np.testing.assert_allclose(a.coords, b.coords, atol=1e-12)
    np.testing.assert_array_equal(a.elnodes, b.elnodes)


def test_native_builds():
    """The port's copy of the C++ library compiles into ``_build/``."""
    assert native.build(), "g++ present but the native build failed"
    assert native.available()
    assert native._LIB_PATH.parent.name == "_build"


@pytest.mark.parametrize("fmt", ["msh", "unv"])
@pytest.mark.parametrize("path", ["native", "python"])
def test_round_trip(tmp_path, mesh, fmt, path):
    """The port writes, then reads back on the native and the Python path."""
    p = tmp_path / f"m.{fmt}"
    (tio.write_gmsh if fmt == "msh" else tio.write_unv)(p, mesh)
    if path == "native":
        out = (native.read_gmsh_native if fmt == "msh" else native.read_unv_native)(str(p))
        assert out is not None
        back = Mesh(*out)
    else:
        back = (tio._read_gmsh_py if fmt == "msh" else tio._read_unv_py)(p)
    _assert_same(mesh, back)


@pytest.mark.parametrize("fmt", ["msh", "unv"])
def test_each_package_reads_the_others_files(tmp_path, mesh, fmt):
    for writer, reader in ((jio, tio), (tio, jio)):
        p = tmp_path / f"{writer.__name__.split('.')[0]}.{fmt}"
        (writer.write_gmsh if fmt == "msh" else writer.write_unv)(p, mesh)
        _assert_same(mesh, reader.read_mesh(p))
    assert (tmp_path / f"fcvm_tpu.{fmt}").read_bytes() == (
        tmp_path / f"fcvm_tpu_torch.{fmt}").read_bytes()


def test_rcm_matches_jax(mesh):
    """The RCM order of a scrambled numbering equals the JAX package's, on
    the native and the Python paths, and restores locality."""
    perm = np.random.default_rng(0).permutation(mesh.n_nodes)
    c, e = native.apply_node_permutation(mesh.coords, mesh.elnodes, perm)
    order = native.rcm_order(e, mesh.n_nodes)
    np.testing.assert_array_equal(order, jax_native.rcm_order(e, mesh.n_nodes))
    np.testing.assert_array_equal(native._rcm_python(e.astype(np.int64), mesh.n_nodes),
                                  jax_native._rcm_python(e.astype(np.int64), mesh.n_nodes))
    assert sorted(order.tolist()) == list(range(mesh.n_nodes))
    _, e2 = native.apply_node_permutation(c, e, order)
    assert native.bandwidth(e2, mesh.n_nodes) <= native.bandwidth(e, mesh.n_nodes)
    assert native.bandwidth(e2, mesh.n_nodes) == jax_native.bandwidth(e2, mesh.n_nodes)


def test_native_formatters_match_python(mesh):
    """``%.10g`` values and tet10 cell lines: the native bytes equal the
    Python versions' on seeded data with awkward values."""
    rng = np.random.default_rng(3)
    vals = np.concatenate([rng.normal(scale=1e3, size=997), rng.normal(scale=1e-7, size=50),
                           [0.0, -0.0, 1e-5, 1.0, 123456789012.0, -2.5e-300, 1e300, 0.1]])
    for per_line in (9, 3, 1):
        assert native.format_doubles(vals, per_line) == native.format_doubles_py(vals, per_line)
    assert native.format_tet10_cells(mesh.elnodes) == native.format_tet10_cells_py(mesh.elnodes)
    assert native.format_doubles(vals) == jax_native.format_doubles(vals)


def test_vtk_reader_on_own_export(tmp_path, mesh):
    """The port's legacy-VTK reader ingests the port's export (and the JAX
    package's, which is the same bytes): the mesh comes back."""
    from types import SimpleNamespace

    from fcvm_tpu_torch.models.inp import ControlParams
    from fcvm_tpu_torch.runtime import vtk

    nn, ne = mesh.n_nodes, mesh.n_elements
    res = SimpleNamespace(coords=mesh.coords, disp=np.zeros(3 * nn),
                          sig_gp=np.ones((ne, 4, 6)), peeq_gp=np.zeros((ne, 4)),
                          csr_gp=np.zeros((ne, 4)), svm_gp=np.ones((ne, 4)))
    path = tmp_path / "m.vtk"
    vtk.export_results(path, res, mesh.elnodes, ControlParams(), 240.0)
    for reader in (tio, jio):
        _assert_same(mesh, reader.read_vtk(path))


def _gmsh_text(mesh, version, missing_tag=False):
    """A Gmsh file of ``mesh`` with sparse node tags (2 i + 5), extra
    element tags and elements of other types beside the tet10s: v2.2 in one
    section each, v4.1 with two node blocks and three element blocks."""
    ntag = 2 * np.arange(mesh.n_nodes) + 5
    g2f = np.asarray(tio.GMSH_TO_FCVM)
    gmsh_rows = np.empty_like(mesh.elnodes)
    gmsh_rows[:, np.arange(10)] = ntag[mesh.elnodes[:, g2f]]
    if missing_tag:
        gmsh_rows[-1, 4] = 2 * mesh.n_nodes + 7  # no such node
    xyz = [" ".join(f"{v:.17g}" for v in c) for c in mesh.coords]
    ne = len(gmsh_rows)
    if version == "2.2":
        lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(mesh.n_nodes)]
        lines += [f"{t} {c}" for t, c in zip(ntag, xyz)]
        lines += ["$EndNodes", "$Elements", str(ne + 2), f"1 15 2 0 1 {ntag[0]}"]
        lines += [f"{e + 2} 11 3 0 1 7 " + " ".join(map(str, r)) for e, r in enumerate(gmsh_rows)]
        lines += [f"{ne + 2} 4 2 0 1 " + " ".join(map(str, ntag[:4])), "$EndElements"]
    else:
        half = mesh.n_nodes // 2
        lines = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat", "$Nodes",
                 f"2 {mesh.n_nodes} {ntag.min()} {ntag.max()}"]
        for lo, hi in ((0, half), (half, mesh.n_nodes)):
            lines += [f"3 1 0 {hi - lo}"] + [str(t) for t in ntag[lo:hi]] + xyz[lo:hi]
        lines += ["$EndNodes", "$Elements", f"3 {ne + 1} 1 {ne + 1}",
                  "3 1 4 1", "1 " + " ".join(map(str, ntag[:4])), f"3 1 11 {ne - 1}"]
        lines += [f"{e + 2} " + " ".join(map(str, r)) for e, r in enumerate(gmsh_rows[:-1])]
        lines += ["3 2 11 1", f"{ne + 1} " + " ".join(map(str, gmsh_rows[-1])), "$EndElements"]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("version", ["2.2", "4.1"])
def test_native_gmsh_reader_matches_python(tmp_path, mesh, version):
    """The native Gmsh reader (C stdio, bounds-checked tags) against the
    Python reader on v2.2 and v4.1 files with sparse node tags, several
    blocks and elements of other types; a tag with no node is refused."""
    p = tmp_path / "m.msh"
    p.write_text(_gmsh_text(mesh, version))
    out = native.read_gmsh_native(str(p))
    assert out is not None
    py = tio._read_gmsh_py(p)
    np.testing.assert_array_equal(out[0], py.coords)
    np.testing.assert_array_equal(out[1], py.elnodes)
    _assert_same(mesh, py)
    p.write_text(_gmsh_text(mesh, version, missing_tag=True))
    assert native.read_gmsh_native(str(p)) is None
    with pytest.raises(KeyError):
        tio._read_gmsh_py(p)
