"""Tet10 mesh file IO: Gmsh ASCII (.msh v2.2/v4.1) and UNV (2411/2412).

The port's copy of :mod:`fcvm_tpu.models.meshio_io`, which replaces the
reference's FreeCAD/SMESH mesh extraction (``source code/fcVM.py:136-164``)
with file-based ingest.  Readers prefer the native C++ parser
(:mod:`fcvm_tpu_torch.native`) and fall back to pure Python.
Node-order conventions are normalized to the fcvm tet10 order at read time,
the same role as the reference's SMESH->CalculiX swap (``fcVM.py:337-341``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fcvm_tpu_torch import native
from fcvm_tpu_torch.models.spec import Mesh

# Gmsh tet10 midside order (0-1),(1-2),(0-2),(0-3),(2-3),(1-3) -> fcvm order
GMSH_TO_FCVM = [0, 1, 2, 3, 4, 5, 6, 7, 9, 8]
# UNV FE 118: c1, m12, c2, m23, c3, m31, m14, m24, m34, c4
UNV_TO_FCVM = [0, 4, 1, 5, 2, 6, 7, 8, 9, 3]  # fcvm slot receiving unv slot i


def read_mesh(path) -> Mesh:
    path = Path(path)
    if path.suffix == ".msh":
        return read_gmsh(path)
    if path.suffix == ".unv":
        return read_unv(path)
    if path.suffix == ".vtk":
        return read_vtk(path)
    raise ValueError(f"unsupported mesh format: {path.suffix}")


def read_vtk(path) -> Mesh:
    """Legacy VTK unstructured grid (ASCII or binary, 4.x and 5.1 layouts),
    extracting the QUADRATIC_TETRA (type 24) cells.

    The reference exports results this way (``fcVM.py:2903-2950``, via
    pyvista/meshio); the committed ``output files/*.vtk`` therefore carry
    the exact meshes of the committed runs, which makes them replayable even
    when the ``.FCStd`` was saved with its Gmsh mesh purged.  VTK quadratic-
    tetra node order equals the fcvm/CalculiX order, so connectivity is
    taken verbatim.
    """
    data = Path(path).read_bytes()

    def find_line(token, start=0):
        i = data.find(token, start)
        if i < 0:
            raise ValueError(f"{path}: missing {token!r}")
        j = data.index(b"\n", i)
        return data[i:j].split(), j + 1

    header = data[:256].split(b"\n")
    binary = any(ln.strip() == b"BINARY" for ln in header[:4])

    def read_array(offset, count, dtype):
        if binary:
            # legacy binary VTK is big-endian
            item = np.dtype(dtype).newbyteorder(">")
            arr = np.frombuffer(data, dtype=item, count=count, offset=offset)
            return arr.astype(dtype), offset + count * item.itemsize
        toks = []
        pos = offset
        while len(toks) < count:
            j = data.index(b"\n", pos)
            toks.extend(data[pos:j].split())
            pos = j + 1
        return np.array(toks[:count], dtype=dtype), pos

    ln, pos = find_line(b"POINTS")
    npts = int(ln[1])
    pdtype = np.float64 if ln[2] == b"double" else np.float32
    flat, pos = read_array(pos, 3 * npts, pdtype)
    coords = flat.reshape(npts, 3).astype(np.float64)

    ln, pos = find_line(b"CELLS", pos)
    ncell_hdr, total = int(ln[1]), int(ln[2])
    nxt = data.find(b"OFFSETS", pos)
    if 0 <= nxt < pos + 80:  # VTK 5.1 layout: OFFSETS + CONNECTIVITY
        ln, pos = find_line(b"OFFSETS", pos)
        itype = np.int64 if b"64" in ln[1] else np.int32
        offsets, pos = read_array(pos, ncell_hdr, itype)
        ln, pos = find_line(b"CONNECTIVITY", pos)
        conn, pos = read_array(pos, total, itype)
        ncells = ncell_hdr - 1
        starts, ends = offsets[:-1], offsets[1:]
    else:  # classic layout: per-cell [n, id0, ..., idn-1]
        # legacy (pre-5.1) binary VTK stores cell data as 32-bit ints
        flat, pos = read_array(pos, total, np.int32 if binary else np.int64)
        ncells = ncell_hdr
        starts, ends, k = [], [], 0
        for _ in range(ncells):
            n = int(flat[k])
            starts.append(k + 1)
            ends.append(k + 1 + n)
            k += 1 + n
        conn = flat
        starts, ends = np.array(starts), np.array(ends)

    ln, pos = find_line(b"CELL_TYPES", pos)
    ntypes = int(ln[1])
    ctypes, pos = read_array(pos, ntypes, np.int32)

    elems = [
        conn[starts[c] : ends[c]]
        for c in range(ncells)
        if ctypes[c] == 24 and ends[c] - starts[c] == 10
    ]
    if not elems:
        raise ValueError(f"{path}: no QUADRATIC_TETRA cells")
    return Mesh(coords, np.asarray(elems, dtype=np.int64))


def read_gmsh(path) -> Mesh:
    out = native.read_gmsh_native(str(path))
    if out is not None:
        return Mesh(out[0], out[1])
    return _read_gmsh_py(path)


def read_unv(path) -> Mesh:
    out = native.read_unv_native(str(path))
    if out is not None:
        return Mesh(out[0], out[1])
    return _read_unv_py(path)


# ---------------------------------------------------------------------------
# Pure-python fallbacks
# ---------------------------------------------------------------------------


def _read_gmsh_py(path) -> Mesh:
    lines = Path(path).read_text().splitlines()
    i = 0
    version = 2.2
    tags, xyz, elems = [], [], []
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("$MeshFormat"):
            version = float(lines[i + 1].split()[0])
            i += 2
        elif ln.startswith("$Nodes"):
            if version < 4.0:
                n = int(lines[i + 1])
                for k in range(n):
                    parts = lines[i + 2 + k].split()
                    tags.append(int(parts[0]))
                    xyz.append([float(v) for v in parts[1:4]])
                i += 2 + n
            else:
                nblocks = int(lines[i + 1].split()[0])
                j = i + 2
                for _ in range(nblocks):
                    nb = int(lines[j].split()[3])
                    btags = [int(lines[j + 1 + k]) for k in range(nb)]
                    for k in range(nb):
                        parts = lines[j + 1 + nb + k].split()
                        tags.append(btags[k])
                        xyz.append([float(v) for v in parts[:3]])
                    j += 1 + 2 * nb
                i = j
        elif ln.startswith("$Elements"):
            tag2idx = {t: k for k, t in enumerate(tags)}
            if version < 4.0:
                n = int(lines[i + 1])
                for k in range(n):
                    parts = lines[i + 2 + k].split()
                    etype = int(parts[1])
                    if etype == 11:
                        ntags = int(parts[2])
                        nd = [tag2idx[int(v)] for v in parts[3 + ntags : 13 + ntags]]
                        row = [0] * 10
                        for s, v in enumerate(nd):
                            row[GMSH_TO_FCVM[s]] = v
                        elems.append(row)
                i += 2 + n
            else:
                nblocks = int(lines[i + 1].split()[0])
                j = i + 2
                for _ in range(nblocks):
                    hdr = lines[j].split()
                    etype, nb = int(hdr[2]), int(hdr[3])
                    for k in range(nb):
                        if etype == 11:
                            parts = lines[j + 1 + k].split()
                            nd = [tag2idx[int(v)] for v in parts[1:11]]
                            row = [0] * 10
                            for s, v in enumerate(nd):
                                row[GMSH_TO_FCVM[s]] = v
                            elems.append(row)
                    j += 1 + nb
                i = j
        else:
            i += 1
    return Mesh(np.asarray(xyz), np.asarray(elems))


def _read_unv_py(path) -> Mesh:
    lines = Path(path).read_text().splitlines()
    i = 0
    tags, xyz, elems = [], [], []
    while i < len(lines):
        if lines[i].strip() == "-1" and i + 1 < len(lines):
            ds = lines[i + 1].strip()
            i += 2
            if ds == "2411":
                while i < len(lines) and lines[i].strip() != "-1":
                    tags.append(int(lines[i].split()[0]))
                    xyz.append(
                        [float(v.replace("D", "E").replace("d", "e")) for v in lines[i + 1].split()[:3]]
                    )
                    i += 2
                i += 1  # consume the dataset end marker
            elif ds == "2412":
                tag2idx = {t: k for k, t in enumerate(tags)}
                while i < len(lines) and lines[i].strip() != "-1":
                    hdr = lines[i].split()
                    if len(hdr) < 6:
                        i += 1
                        continue
                    fe, nnodes = int(hdr[1]), int(hdr[5])
                    i += 1
                    # beam-family FE types carry an extra orientation record
                    if fe in (11, 21, 22, 23, 24):
                        i += 1
                    nd = []
                    while len(nd) < nnodes:
                        nd.extend(int(v) for v in lines[i].split())
                        i += 1
                    if fe == 118 and nnodes == 10:
                        row = [0] * 10
                        for s, v in enumerate(nd):
                            row[UNV_TO_FCVM[s]] = tag2idx[v]
                        elems.append(row)
                i += 1  # consume the dataset end marker
            else:
                while i < len(lines) and lines[i].strip() != "-1":
                    i += 1
                i += 1
        else:
            i += 1
    return Mesh(np.asarray(xyz), np.asarray(elems))


# ---------------------------------------------------------------------------
# Writers (for interchange and roundtrip tests)
# ---------------------------------------------------------------------------


def write_gmsh(path, mesh: Mesh) -> None:
    """Gmsh ASCII v2.2 with tet10 elements (type 11)."""
    inv = np.argsort(np.asarray(GMSH_TO_FCVM))  # fcvm slot -> gmsh slot
    fcvm_to_gmsh = np.empty(10, dtype=int)
    for g, f in enumerate(GMSH_TO_FCVM):
        fcvm_to_gmsh[f] = g
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(mesh.n_nodes)]
    for i, (x, y, z) in enumerate(mesh.coords):
        lines.append(f"{i + 1} {x:.16g} {y:.16g} {z:.16g}")
    lines += ["$EndNodes", "$Elements", str(mesh.n_elements)]
    for e, row in enumerate(mesh.elnodes):
        gmsh_row = np.empty(10, dtype=int)
        for f in range(10):
            gmsh_row[fcvm_to_gmsh[f]] = row[f] + 1
        lines.append(f"{e + 1} 11 2 0 1 " + " ".join(str(v) for v in gmsh_row))
    lines.append("$EndElements")
    Path(path).write_text("\n".join(lines) + "\n")


def write_unv(path, mesh: Mesh) -> None:
    """UNV datasets 2411/2412 with FE descriptor 118."""
    lines = ["    -1", "  2411"]
    for i, (x, y, z) in enumerate(mesh.coords):
        lines.append(f"{i + 1:10d}{1:10d}{1:10d}{11:10d}")
        lines.append(f"{x:25.16E}{y:25.16E}{z:25.16E}")
    lines += ["    -1", "    -1", "  2412"]
    for e, row in enumerate(mesh.elnodes):
        unv_row = np.empty(10, dtype=int)
        for u, f in enumerate(UNV_TO_FCVM):
            unv_row[u] = row[f] + 1
        lines.append(f"{e + 1:10d}{118:10d}{2:10d}{1:10d}{7:10d}{10:10d}")
        lines.append("".join(f"{v:10d}" for v in unv_row[:8]))
        lines.append("".join(f"{v:10d}" for v in unv_row[8:]))
    lines += ["    -1"]
    Path(path).write_text("\n".join(lines) + "\n")
