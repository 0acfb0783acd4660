"""fcVM on PyTorch and CUDA: the port of :mod:`fcvm_tpu` to one NVIDIA GPU.

The JAX package stays the reference; this package mirrors its module layout
and names, imports neither it nor JAX, and is checked against it by the
``tests/test_torch_*.py`` parity tests.  This slice runs the small-strain
plastic Riks collapse analysis (``gnl="GNLN"``) through
:func:`solve_collapse`, with the two-level-preconditioned CG solver whose
K_hat·v block stage is the hand-written CUDA kernel K0
(:mod:`fcvm_tpu_torch.ops.kernels`, source ``csrc/block_matvec.cu``).

Options that are not ported yet raise :class:`NotImplementedError` naming
the ROADMAP item that ports them.
"""

from fcvm_tpu_torch.config import FcvmConfig
from fcvm_tpu_torch.models.inp import ControlParams
from fcvm_tpu_torch.models.spec import (
    BoundaryConditions,
    Loads,
    Material,
    Mesh,
    Model,
    model_from_arrays,
)
from fcvm_tpu_torch.runtime.driver import AnalysisResults, solve_collapse

__all__ = [
    "FcvmConfig",
    "ControlParams",
    "Mesh",
    "Material",
    "BoundaryConditions",
    "Loads",
    "Model",
    "model_from_arrays",
    "solve_collapse",
    "AnalysisResults",
]
