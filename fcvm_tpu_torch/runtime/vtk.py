"""Legacy-ASCII VTK export of quadratic-tetra results (no pyvista needed).

Rebuild of ``exportVTK`` (``source code/fcVM.py:2903-2950``): an
UnstructuredGrid of VTK_QUADRATIC_TETRA (cell type 24) with the same point
data fields.  Field-name divergence (documented): the reference embeds
trailing ``\\n`` in several field names, which legacy VTK cannot represent;
names here are the same text without the newline, with spaces preserved
via the VTK FIELD encoding.

The port's copy of :mod:`fcvm_tpu.runtime.vtk`: the same results give the
same bytes, from the native formatters of :mod:`fcvm_tpu_torch.native` or
their Python versions.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fcvm_tpu_torch import native
from fcvm_tpu_torch.ops import postproc

VTK_QUADRATIC_TETRA = 24

# Our tet10 midside order is (0-1),(1-2),(0-2),(0-3),(1-3),(2-3); VTK's
# quadratic tetra expects (0-1),(1-2),(2-0),(0-3),(1-3),(2-3) -> identical
# node sets, so the connectivity maps 1:1.
_VTK_ORDER = list(range(10))


def _fmt_array(a: np.ndarray) -> bytes:
    # the native %.10g formatter, else its (much slower) Python version
    flat = np.asarray(a, dtype=np.float64).reshape(-1)
    txt = native.format_doubles(flat, 9)
    return txt if txt is not None else native.format_doubles_py(flat, 9)


def write_vtk(
    path,
    coords: np.ndarray,
    elnodes: np.ndarray,
    point_data: dict,
) -> None:
    """Write a legacy VTK file with the given nodal fields.

    Args:
      point_data: ``name -> (nn,) | (nn, 3) | (nn, 6)`` arrays; 6-wide arrays
        are written as symmetric tensors (xx, yy, zz, xy, zx, yz order kept
        as a 6-component field, matching the reference's flat export).
    """
    coords = np.asarray(coords, dtype=np.float64)
    elnodes = np.asarray(elnodes)
    nn = len(coords)
    ne = len(elnodes)
    # assembled as bytes end to end, with no text encode of the whole file
    lines = [
        b"# vtk DataFile Version 4.2",
        b"fcvm_tpu results",
        b"ASCII",
        b"DATASET UNSTRUCTURED_GRID",
        f"POINTS {nn} double".encode(),
        _fmt_array(coords),
        f"CELLS {ne} {ne * 11}".encode(),
    ]
    cell_txt = native.format_tet10_cells(elnodes[:, _VTK_ORDER])
    if cell_txt is None:
        cell_txt = native.format_tet10_cells_py(elnodes[:, _VTK_ORDER])
    lines.append(cell_txt)
    lines.append(f"CELL_TYPES {ne}".encode())
    lines.append(b"\n".join([str(VTK_QUADRATIC_TETRA).encode()] * ne))
    lines.append(f"POINT_DATA {nn}".encode())

    scalars = {k: v for k, v in point_data.items() if np.ndim(v) == 1}
    vectors = {k: v for k, v in point_data.items() if np.ndim(v) == 2 and v.shape[1] == 3}
    wide = {k: v for k, v in point_data.items() if np.ndim(v) == 2 and v.shape[1] not in (3,)}

    nfields = len(scalars) + len(wide)
    if nfields:
        lines.append(f"FIELD FieldData {nfields}".encode())
        for name, v in scalars.items():
            lines.append(f"{name.replace(' ', '_')} 1 {nn} double".encode())
            lines.append(_fmt_array(v))
        for name, v in wide.items():
            lines.append(
                f"{name.replace(' ', '_')} {v.shape[1]} {nn} double".encode()
            )
            lines.append(_fmt_array(v))
    for name, v in vectors.items():
        lines.append(f"VECTORS {name.replace(' ', '_')} double".encode())
        lines.append(_fmt_array(v))
    Path(path).write_bytes(b"\n".join(lines) + b"\n")


def read_point_fields(path) -> dict:
    """Read the nodal fields back from a :func:`write_vtk` export.

    Inverse of this module's own ASCII layout (FIELD FieldData entries +
    VECTORS blocks).  Enables the post-hoc "Sum" workflow: the reference's
    Sum button reads CSR/PEEQ/von Mises from the stored result object
    (``fcVM_sum.FCMacro:80-101``); ours reads them from the exported
    ``.vtk`` so surface averages can be computed any time after a run.
    Field names come back with the underscores the writer substituted for
    spaces.
    """
    lines = Path(path).read_bytes().split(b"\n")
    try:
        i = next(k for k, ln in enumerate(lines) if ln.startswith(b"POINT_DATA"))
    except StopIteration:
        raise ValueError(f"{path}: no POINT_DATA section") from None
    nn = int(lines[i].split()[1])

    def take(count, k):
        vals: list = []
        while len(vals) < count:
            vals.extend(lines[k].split())
            k += 1
        return np.array(vals[:count], dtype=np.float64), k

    fields: dict = {}
    k = i + 1
    while k < len(lines):
        ln = lines[k].split()
        if not ln:
            k += 1
            continue
        if ln[0] == b"FIELD":
            nf = int(ln[2])
            k += 1
            for _ in range(nf):
                name, ncomp, n, _ = lines[k].split()
                k += 1
                arr, k = take(int(ncomp) * int(n), k)
                if int(ncomp) > 1:
                    arr = arr.reshape(int(n), int(ncomp))
                fields[name.decode()] = arr
        elif ln[0] == b"VECTORS":
            name = ln[1].decode()
            k += 1
            arr, k = take(3 * nn, k)
            fields[name] = arr.reshape(nn, 3)
        else:
            k += 1
    return fields


def export_results(
    path,
    results,
    elnodes: np.ndarray,
    params,
    fy: float,
    include_rho: bool = False,
) -> dict:
    """Full result export mirroring ``exportVTK``'s field set.

    Returns the point-data dict that was written (for testing).
    """
    mesh_coords = results.coords
    nn = len(mesh_coords)
    noce = _elements_per_node(elnodes, nn)
    stress, peeq, csr, svm, triax = postproc.map_stresses(
        params.averaged_option == "averaged",
        elnodes,
        nn,
        results.sig_gp,
        results.peeq_gp,
        results.csr_gp,
        results.svm_gp,
        noce,
        params.sig_yield,
    )
    s1, s2, s3, v1, v2, v3 = postproc.principal_stresses(stress)
    data = {
        "Critical Strain Ratio": csr,
        "Equivalent Plastic Strain": peeq,
        "von Mises Stress": svm,
        "Triaxiality": triax,
        "Displacement": results.disp.reshape(nn, 3),
        "Stress Tensor": stress,
        "Major Principal Stress": s1,
        "Intermediate Principal Stress": s2,
        "Minor Principal Stress": s3,
        "Major Principal Stress Vector": v1,
        "Intermediate Principal Stress Vector": v2,
        "Minor Principal Stress Vector": v3,
    }
    if params.gnl == "GNLY" and results.eigenvectors is not None and not (
        params.nstep > 1 and params.max_imp == 0.0
    ):
        ev = results.eigenvalues
        vecs = results.eigenvectors
        data["Elastic Displacement"] = results.disp_el.reshape(nn, 3)
        for i in (0, 1):
            v = vecs[:, i] / np.max(np.abs(vecs[:, i]))
            data[f"Buckling shape for lambda{i + 1} = {round(float(ev[i]), 3)}"] = (
                v.reshape(nn, 3)
            )
    if include_rho:
        rho = postproc.reinforcement_rho(stress, fy)
        data["Reinforcement Ratio x"] = rho[:, 0]
        data["Reinforcement Ratio y"] = rho[:, 1]
        data["Reinforcement Ratio z"] = rho[:, 2]
    write_vtk(path, mesh_coords, elnodes, data)
    return data


def _elements_per_node(elnodes: np.ndarray, nn: int) -> np.ndarray:
    counts = np.zeros(nn, dtype=np.int64)
    np.add.at(counts, np.asarray(elnodes).reshape(-1), 1)
    return counts
