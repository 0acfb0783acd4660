"""Analysis-control parameters: the reference's 21-line ``.inp`` schema.

Schema (write: ``InitGui.py:253-276``; read: ``fcVM.FCMacro:73-96``):

  1 sig_yield [MPa]      8 relax               15 target_LF
  2 grav_x [m/s^2]       9 scale_re            16 csr_option (PEEQ|CSR)
  3 grav_y              10 scale_up            17 averaged_option
  4 grav_z              11 scale_dn            18 gnl (GNLY|GNLN)
  5 nstep               12 disp_output         19 maxImp
  6 iterat_max          13 ultimate_strain     20 ev1
  7 error_max           14 Et_E                21 ev2

The file reader and writer (:func:`fcvm_tpu.models.inp.read_inp`) are not
ported yet (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import dataclasses


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
