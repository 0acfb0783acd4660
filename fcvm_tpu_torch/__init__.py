"""fcVM on PyTorch and CUDA: the port of :mod:`fcvm_tpu` to NVIDIA GPUs.

The JAX package stays the reference; this package mirrors its module layout
and names, imports neither it nor JAX, and is checked against it by the
``tests/test_torch_*.py`` parity tests.  It runs the plastic Riks collapse
analysis, small strain (``gnl="GNLN"``) and geometrically nonlinear
(``gnl="GNLY"``, with the linear-buckling pre-analysis and imperfection
seeding), through :func:`solve_collapse`, and linear buckling alone through
:func:`linear_buckling`, with the two-level-preconditioned CG solver (or the
scipy direct tier) whose K_hat·v, preconditioner apply, node sums and block
products are the hand-written CUDA kernels K1, K4, K8, K1m and K4m
(:mod:`fcvm_tpu_torch.ops.kernels`, sources under ``csrc/``).
:func:`run_analysis` and :func:`run_sum` (:mod:`fcvm_tpu_torch.api`) add
the reference's output files (``.out``, ``.vtk``, ``.avr``, curves), and
``python -m fcvm_tpu_torch run case.toml`` runs a TOML case file
(:mod:`fcvm_tpu_torch.models.casefile`) through them.  On several
devices the analysis runs over an element partition, one process per
device (:mod:`fcvm_tpu_torch.parallel`, ``FcvmConfig(n_devices=N)``, the
CLI's ``--devices N`` and ``--distributed``).
"""

from fcvm_tpu_torch.config import FcvmConfig
from fcvm_tpu_torch.models.inp import ControlParams, read_inp, write_inp
from fcvm_tpu_torch.models.spec import (
    BoundaryConditions,
    Loads,
    Material,
    Mesh,
    Model,
    model_from_arrays,
)
from fcvm_tpu_torch.runtime.buckling import EigensolveBreakdownError, linear_buckling
from fcvm_tpu_torch.runtime.driver import AnalysisResults, solve_collapse
from fcvm_tpu_torch.api import run_analysis, run_sum
from fcvm_tpu_torch.version import __version__

__all__ = [
    "__version__",
    "FcvmConfig",
    "ControlParams",
    "read_inp",
    "write_inp",
    "Mesh",
    "Material",
    "BoundaryConditions",
    "Loads",
    "Model",
    "model_from_arrays",
    "solve_collapse",
    "AnalysisResults",
    "linear_buckling",
    "EigensolveBreakdownError",
    "run_analysis",
    "run_sum",
]
