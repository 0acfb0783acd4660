"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

* K0 :func:`block_matvec` replaces the Pallas TPU kernel
  ``fcvm_tpu/ops/pallas_kernels.py::block_matvec``; source
  ``csrc/block_matvec.cu``.
* K0p :func:`soa_matvec` replaces ``tools/bw_probe.py::soa_matvec``;
  source ``csrc/bw_probe.cu``.
* Kbw :func:`bw_read` replaces ``tools/bw_probe.py::make_bw_kernel``;
  source ``csrc/bw_probe.cu``.

K0 is the block stage of the solver's K_hat·v; K0p and Kbw serve the
bandwidth probe (:mod:`fcvm_tpu_torch.tools.bw_probe`).  What bounds each
on the card and how its design answers that is written at the top of its
source.

Dispatch is by the tensors' device: on CPU tensors a wrapper runs the plain
version (``*_ref``), on CUDA tensors it launches the kernel or raises.  There
is no fallback from a failed build or launch.  Each wrapper counts its
kernel launches in its ``launches`` attribute.

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
SOURCES = ("ops.cpp", "block_matvec.cu", "bw_probe.cu")
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


def soa_matvec_ref(esm_t: torch.Tensor, ue_t: torch.Tensor) -> torch.Tensor:
    """Plain version of K0p: ``out[i, e] = sum_j esm_t[i, j, e] ue_t[j, e]``."""
    return torch.einsum("ije,je->ie", esm_t, ue_t)


def soa_matvec(esm_t: torch.Tensor, ue_t: torch.Tensor, tile: int = 1024) -> torch.Tensor:
    """K0p: K0's contraction in the bandwidth probe's tiling, one thread
    block per ``tile`` elements.

    Args:
      esm_t: (30, 30, ne) float32 blocks, ``ne`` a multiple of ``tile``.
      ue_t: (30, ne) float32, same device.

    Returns:
      (30, ne).  CPU tensors take the plain version; CUDA tensors launch the
      kernel (``soa_matvec.launches`` counts those launches).
    """
    ne = esm_t.shape[-1]
    if esm_t.shape != (30, 30, ne) or ue_t.shape != (30, ne):
        raise ValueError(
            f"soa_matvec: shapes {tuple(esm_t.shape)} and {tuple(ue_t.shape)}; "
            "expected (30, 30, ne) and (30, ne)"
        )
    if tile < 1 or ne % tile != 0:
        raise ValueError(f"soa_matvec: ne = {ne} is not a multiple of tile = {tile}")
    if esm_t.dtype != torch.float32 or ue_t.dtype != torch.float32:
        raise TypeError(f"soa_matvec: dtypes {esm_t.dtype}/{ue_t.dtype}; expected float32")
    if esm_t.device.type == "cpu" and ue_t.device.type == "cpu":
        return soa_matvec_ref(esm_t, ue_t)
    if esm_t.device.type != "cuda" or ue_t.device != esm_t.device:
        raise ValueError(
            f"soa_matvec: tensors on {esm_t.device} and {ue_t.device}; expected "
            "both on the CPU or both on one CUDA device"
        )
    if not (esm_t.is_contiguous() and ue_t.is_contiguous()):
        raise ValueError("soa_matvec: inputs must be contiguous")
    if ne == 0:
        return torch.empty_like(ue_t)
    build()
    out = torch.ops.fcvm.soa_matvec(esm_t, ue_t, tile)
    soa_matvec.launches += 1
    return out


soa_matvec.launches = 0

BW_READ_MAX_K = 8  # slots of the kernel's shared-memory ring


def bw_read_ref(x: torch.Tensor, chunk_rows: int = 2048) -> torch.Tensor:
    """Plain version of Kbw: (8, 128) filled with ``sum_c x[c chunk_rows, 0]``."""
    return torch.full((8, 128), float(x[::chunk_rows, 0].sum()), dtype=x.dtype,
                      device=x.device)


def bw_read(x: torch.Tensor, k: int, chunk_rows: int = 2048) -> torch.Tensor:
    """Kbw: read every byte of ``x`` into shared memory in chunks of
    ``chunk_rows`` rows with ``k`` bulk copies in flight per block, and
    return the sum of each chunk's first value, broadcast to (8, 128).

    Args:
      x: (rows, 128) float32, ``rows`` a multiple of ``chunk_rows``.
      k: copies in flight per block, 1 to ``BW_READ_MAX_K``.

    Returns:
      (8, 128).  A CPU tensor takes the plain version; a CUDA tensor
      launches the kernel (``bw_read.launches`` counts those launches).
    """
    if x.dim() != 2 or x.shape[1] != 128 or x.shape[0] == 0:
        raise ValueError(f"bw_read: shape {tuple(x.shape)}; expected (rows, 128)")
    if chunk_rows < 1 or x.shape[0] % chunk_rows != 0:
        raise ValueError(
            f"bw_read: rows = {x.shape[0]} is not a multiple of chunk_rows = {chunk_rows}")
    if not 1 <= k <= BW_READ_MAX_K:
        raise ValueError(f"bw_read: k = {k}; expected 1 to {BW_READ_MAX_K}")
    if x.dtype != torch.float32:
        raise TypeError(f"bw_read: dtype {x.dtype}; expected float32")
    if x.device.type == "cpu":
        return bw_read_ref(x, chunk_rows)
    if x.device.type != "cuda":
        raise ValueError(f"bw_read: x on {x.device}; expected the CPU or a CUDA device")
    if not x.is_contiguous() or x.data_ptr() % 16 != 0:
        raise ValueError("bw_read: x must be contiguous and 16-byte aligned")
    build()
    out = torch.ops.fcvm.bw_read(x, k, chunk_rows)
    bw_read.launches += 1
    return out


bw_read.launches = 0
