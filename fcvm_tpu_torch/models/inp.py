"""The reference's 21-line positional ``.inp`` control-file format.

Schema (write: ``InitGui.py:253-276``; read: ``fcVM.FCMacro:73-96``):

  1 sig_yield [MPa]      8 relax               15 target_LF
  2 grav_x [m/s^2]       9 scale_re            16 csr_option (PEEQ|CSR)
  3 grav_y              10 scale_up            17 averaged_option
  4 grav_z              11 scale_dn            18 gnl (GNLY|GNLN)
  5 nstep               12 disp_output         19 maxImp
  6 iterat_max          13 ultimate_strain     20 ev1
  7 error_max           14 Et_E                21 ev2

The port's copy of :mod:`fcvm_tpu.models.inp`: the reader and writer
give and take the same files as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path


@dataclasses.dataclass
class ControlParams:
    """All 21 analysis-control parameters with the reference defaults
    (``InitGui.py:181-201``)."""

    sig_yield: float = 240.0
    grav_x: float = 0.0
    grav_y: float = 0.0
    grav_z: float = 0.0
    nstep: int = 10
    iterat_max: int = 20
    error_max: float = 1.0e-3
    relax: float = 1.2
    scale_re: float = 2.0
    scale_up: float = 1.2
    scale_dn: float = 1.2
    disp_output: str = "total"  # or "incremental"
    ultimate_strain: float = 0.0
    et_e: float = 0.0
    target_lf: float = 0.0
    csr_option: str = "PEEQ"  # ultimate-limit criterion: PEEQ or CSR
    averaged_option: str = "unaveraged"
    gnl: str = "GNLN"  # GNLY = geometric nonlinear
    max_imp: float = 0.0
    ev1: float = 1.0
    ev2: float = 0.0

    @property
    def large_disp(self) -> bool:
        return self.gnl == "GNLY"

    @property
    def gravity(self):
        return (self.grav_x, self.grav_y, self.grav_z)


def read_inp(path) -> ControlParams:
    """Parse a control file.

    The bundled corpus contains files from earlier format revisions with
    13-20 lines (the current reference driver cannot read those either — its
    bare ``except`` at ``fcVM.FCMacro:97`` silently aborts); missing trailing
    fields take the GUI defaults.
    """
    lines = Path(path).read_text(encoding="utf8").splitlines()
    vals = [ln.strip() for ln in lines]
    p = ControlParams()
    fields = [
        ("sig_yield", float), ("grav_x", float), ("grav_y", float),
        ("grav_z", float), ("nstep", lambda s: int(float(s))),
        ("iterat_max", lambda s: int(float(s))),
        ("error_max", float), ("relax", float), ("scale_re", float),
        ("scale_up", float), ("scale_dn", float), ("disp_output", str),
        ("ultimate_strain", float), ("et_e", float), ("target_lf", float),
        ("csr_option", str), ("averaged_option", str), ("gnl", str),
        ("max_imp", float), ("ev1", float), ("ev2", float),
    ]
    for (name, conv), raw in zip(fields, vals):
        setattr(p, name, conv(raw))
    return p


def write_inp(params: ControlParams, path) -> None:
    lines = [
        str(params.sig_yield),
        str(params.grav_x),
        str(params.grav_y),
        str(params.grav_z),
        str(params.nstep),
        str(params.iterat_max),
        str(params.error_max),
        str(params.relax),
        str(params.scale_re),
        str(params.scale_up),
        str(params.scale_dn),
        params.disp_output,
        str(params.ultimate_strain),
        str(params.et_e),
        str(params.target_lf),
        params.csr_option,
        params.averaged_option,
        params.gnl,
        str(params.max_imp),
        str(params.ev1),
        str(params.ev2),
    ]
    Path(path).write_text("\n".join(lines) + "\n", encoding="utf8")
