"""Report writers: the reference's ``.out`` and ``.avr`` file formats.

Byte-compatible in structure with ``fcVM.FCMacro:212-253`` (analysis report)
and ``fcVM_sum.FCMacro:111-161`` (surface/edge averages).
The port's copy of :mod:`fcvm_tpu.runtime.report`: the same results give
the same bytes.
"""

from __future__ import annotations

from pathlib import Path

SEPARATOR = (
    "\n======================================================================="
    "==================================================\n\n"
)


def write_out(
    path,
    name: str,
    results,
    params,
    ne: int,
    nn: int,
) -> None:
    """Write the ``.out`` analysis report (``fcVM.FCMacro:214-253``)."""
    h = results.history
    gp_coords = results.gp_coords.reshape(-1, 3)
    lines = []
    lines.append("model name:{0: >50}\n".format(name))
    lines.append("No. of elements:{0: >45}\n".format(ne))
    lines.append("No. of Degrees of freedom:{0: >35}\n".format(nn))
    if params.gnl == "GNLY":
        ev = results.eigenvalues
        if params.nstep == 1:
            lines.append("analysis type:{0: >47}\n".format("elastic buckling analysis"))
            lines.append("elastic buckling factors:{0: >36}\n".format(str(ev)))
        else:
            lines.append(
                "analysis type:{0: >47}\n".format("elastic-plastic, geometric non-linear")
            )
            lines.append("elastic buckling factors:{0: >36}\n".format(str(ev)))
    else:
        if params.nstep == 1:
            lines.append("analysis type: elastic\n")
        else:
            lines.append("analysis type: elastic-plastic, geometric linear\n")
    lines.append(SEPARATOR)
    lines.append("Sum of loads x-direction: {0: >15.2e}\n".format(results.loadsums[0]))
    lines.append("Sum of loads y-direction: {0: >15.2e}\n".format(results.loadsums[1]))
    lines.append("Sum of loads z-direction: {0: >15.2e}\n".format(results.loadsums[2]))
    lines.append(SEPARATOR)
    lines.append(
        "{0: >8}{1: >10}{2: >10}{3: >10}{4: >10}{5: >10}{6: >10}{7: >10}"
        "{8: >10}{9: >10}{10: >10}{11: >10}\n".format(
            "Gauss point", "x", "y", "z", "load", "disp", "peeq", "pressure",
            "svmises", "triax", "eps_cr", "csr_max",
        )
    )
    for i in range(len(h.crip)):
        gp = h.crip[i]
        lines.append(
            "{0: 11d}{1: >10.2e}{2: >10.2e}{3: >10.2e}{4: >10.2e}{5: >10.2e}"
            "{6: >10.2e}{7: >10.2e}{8: >10.2e}{9: >10.2e}{10: >10.2e}{11: >10.2e}\n".format(
                gp, gp_coords[gp][0], gp_coords[gp][1], gp_coords[gp][2],
                h.load[i], h.un[i], h.peeq[i], h.pressure[i], h.svm[i],
                h.triax[i], h.ecr[i], h.csr[i],
            )
        )
    lines.append(SEPARATOR)
    Path(path).write_text("".join(lines), encoding="utf8")


def write_avr(
    path,
    name: str,
    edge_names,
    edge_lengths,
    edge_peeq,
    edge_csr,
    edge_svm,
    face_names,
    face_areas,
    face_peeq,
    face_csr,
    face_svm,
) -> None:
    """Write the ``.avr`` surface/edge averages report
    (``fcVM_sum.FCMacro:111-161``)."""
    lines = []
    lines.append("model name:{0: >30}\n\n".format(name))
    lines.append("average values")
    lines.append(SEPARATOR)
    lines.append(
        "{0: >10}{1: >10}{2: >10}{3: >10}    {4}\n".format(
            "Length", "peeq", "CSR", "svmises", "edge"
        )
    )
    for i, edge in enumerate(edge_names):
        lines.append(
            "{0: >10.2e}{1: >10.2e}{2: >10.2e}{3: >10.2e}    {4}\n".format(
                edge_lengths[i], edge_peeq[i], edge_csr[i], edge_svm[i], edge
            )
        )
    lines.append(SEPARATOR)
    lines.append(
        "{0: >10}{1: >10}{2: >10}{3: >10}    {4}\n".format(
            "Area", "peeq", "CSR", "svmises", "face"
        )
    )
    for i, face in enumerate(face_names):
        lines.append(
            "{0: >10.2e}{1: >10.2e}{2: >10.2e}{3: >10.2e}    {4}\n".format(
                face_areas[i], face_peeq[i], face_csr[i], face_svm[i], face
            )
        )
    lines.append(SEPARATOR)
    Path(path).write_text("".join(lines), encoding="utf8")
