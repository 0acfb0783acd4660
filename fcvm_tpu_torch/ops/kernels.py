"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

K0 :func:`block_matvec` replaces the repository's Pallas TPU kernel
``fcvm_tpu/ops/pallas_kernels.py::block_matvec`` (the batched 30x30
element-block matvec in element-major layout).  Its source is
``fcvm_tpu_torch/csrc/block_matvec.cu``; what bounds it on the card and how
its design answers that is written at the top of that file.

Dispatch is by the tensors' device: on CPU tensors the wrapper runs the plain
version (:func:`block_matvec_ref`), on CUDA tensors it launches the kernel or
raises.  There is no fallback from a failed build or launch.

The kernels are compiled at first use by ``torch.utils.cpp_extension.load``
(``nvcc`` for ``sm_90a``, the host compiler for the bindings) into
``fcvm_tpu_torch/_build/`` and registered with PyTorch's dispatcher as
``torch.ops.fcvm.*`` (``csrc/ops.cpp``).  The ``.cu`` sources keep a plain C
interface and include no PyTorch header, so only the binding file compiles
against PyTorch's headers.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("ops.cpp", "block_matvec.cu")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3")


class BuildInfo(NamedTuple):
    path: str  # the loaded shared library
    seconds: float  # compile (or, when up to date, up-to-date check) and load


_build_info = None


def build() -> BuildInfo:
    """Compile the kernel library from ``csrc/`` and load its operators.

    Once per process; ninja rebuilds only what changed since the last build
    in ``_build/``.  A failed build raises."""
    global _build_info
    if _build_info is None:
        from torch.utils.cpp_extension import load

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        path = load(
            name="fcvm_kernels",
            sources=[str(CSRC / s) for s in SOURCES],
            extra_cflags=["-O3"],
            extra_cuda_cflags=list(NVCC_FLAGS),
            build_directory=str(BUILD_DIR),
            is_python_module=False,
        )
        _build_info = BuildInfo(path, time.perf_counter() - t0)
    return _build_info


def block_matvec_ref(esm_t: torch.Tensor, ue_t: torch.Tensor) -> torch.Tensor:
    """Plain version of K0: ``out[i, e] = sum_j esm_t[i, j, e] ue_t[j, e]``."""
    return torch.einsum("ije,je->ie", esm_t, ue_t)


def block_matvec(esm_t: torch.Tensor, ue_t: torch.Tensor) -> torch.Tensor:
    """K0: batched 30x30 element-block matvec in element-major layout.

    Args:
      esm_t: (30, 30, ne) element blocks, float32 or float64.
      ue_t: (30, ne) gathered element dof values, same dtype and device.

    Returns:
      (30, ne) element force contributions.  CPU tensors take the plain
      version; CUDA tensors launch the kernel (``block_matvec.launches``
      counts those launches).
    """
    if esm_t.device.type == "cpu" and ue_t.device.type == "cpu":
        return block_matvec_ref(esm_t, ue_t)
    if esm_t.device.type != "cuda" or ue_t.device != esm_t.device:
        raise ValueError(
            f"block_matvec: tensors on {esm_t.device} and {ue_t.device}; "
            "expected both on the CPU or both on one CUDA device"
        )
    if esm_t.dtype not in (torch.float32, torch.float64) or ue_t.dtype != esm_t.dtype:
        raise TypeError(
            f"block_matvec: dtypes {esm_t.dtype}/{ue_t.dtype}; expected both "
            "float32 or both float64"
        )
    ne = esm_t.shape[-1]
    if esm_t.shape != (30, 30, ne) or ue_t.shape != (30, ne):
        raise ValueError(
            f"block_matvec: shapes {tuple(esm_t.shape)} and {tuple(ue_t.shape)};"
            " expected (30, 30, ne) and (30, ne)"
        )
    if not (esm_t.is_contiguous() and ue_t.is_contiguous()):
        raise ValueError("block_matvec: inputs must be contiguous")
    if ne == 0:
        return torch.empty_like(ue_t)
    build()
    out = torch.ops.fcvm.block_matvec(esm_t, ue_t)
    block_matvec.launches += 1
    return out


block_matvec.launches = 0
