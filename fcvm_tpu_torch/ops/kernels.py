"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

* K0 :func:`block_matvec` replaces the Pallas TPU kernel
  ``fcvm_tpu/ops/pallas_kernels.py::block_matvec``; source
  ``csrc/block_matvec.cu``.
* K0m :func:`block_matmat`, K0's multi-column form, replaces K0 under
  ``vmap`` and the block ``einsum`` of ``fcvm_tpu/runtime/buckling.py:318``;
  source ``csrc/block_matmat.cu``.
* K1 :func:`khat_matvec`, the fused K_hat·v (gather -> element pass ->
  fixed-order node sum -> Dirichlet mask), replaces the XLA-lowered
  ``fcvm_tpu/ops/assembly.py::make_matvec``/``make_bc_matvec`` with its
  ``ScatterPlan`` node sum; source ``csrc/khat_matvec.cu`` (its element
  pass is K0's, ``csrc/element_pass.cuh``).
* K4 :func:`two_level_apply`, the fused two-level preconditioner apply on
  a vector, replaces the XLA-lowered
  ``fcvm_tpu/ops/precond.py::TwoLevelPrecond.apply``; source
  ``csrc/two_level.cu``.
* K0p :func:`soa_matvec` replaces ``tools/bw_probe.py::soa_matvec``;
  source ``csrc/bw_probe.cu``.
* Kbw :func:`bw_read` replaces ``tools/bw_probe.py::make_bw_kernel``;
  source ``csrc/bw_probe.cu``.

K1 and K4 carry the solver's CG iteration (every ``K_hat @ v`` and raw
``K @ v``, every preconditioner apply on a vector); K0m is the block stage
of the multi-column K_hat·V and -G_hat·V (the buckling eigensolve, the
deflation Galerkin and correction builds); K0, K0p and Kbw serve the
bandwidth probe (:mod:`fcvm_tpu_torch.tools.bw_probe`).  What bounds each
on the card and how its design answers that is written at the top of its
source.

Dispatch is by the tensors' device: on CPU tensors a wrapper runs the plain
version (``*_ref``), on CUDA tensors it launches the kernel or raises.  There
is no fallback from a failed build or launch.  Each wrapper counts its
kernel launches in its ``launches`` attribute; K0, K1 and K4 also count them
by dtype in their ``dtypes``, K0m by dtype and column count in
``block_matmat.shapes``.

The kernels are compiled at first use by ``torch.utils.cpp_extension.load``
(``nvcc`` for ``sm_90a``, the host compiler for the bindings) into
``fcvm_tpu_torch/_build/`` and registered with PyTorch's dispatcher as
``torch.ops.fcvm.*`` (``csrc/ops.cpp``).  The ``.cu`` sources keep a plain C
interface and include no PyTorch header, so only the binding file compiles
against PyTorch's headers.
"""

from __future__ import annotations

import time
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("ops.cpp", "block_matvec.cu", "block_matmat.cu", "khat_matvec.cu", "two_level.cu",
           "bw_probe.cu")
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


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


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
    block_matvec.dtypes[_dtype_name(ue_t)] += 1
    return out


block_matvec.launches = 0
block_matvec.dtypes = Counter()  # launches by dtype name


def block_matmat_ref(esm_t: torch.Tensor, ue: torch.Tensor) -> torch.Tensor:
    """Plain version of K0m: ``out[e, i, c] = sum_j esm_t[i, j, e] ue[e, j, c]``."""
    return torch.einsum("ije,ejc->eic", esm_t, ue)


def block_matmat(esm_t: torch.Tensor, ue: torch.Tensor) -> torch.Tensor:
    """K0m: K0 on ``m`` columns at once (design and bound at the top of
    ``csrc/block_matmat.cu``).

    Args:
      esm_t: (30, 30, ne) element blocks, element-major, float32 or float64.
      ue: (ne, 30, m) gathered element dof values (the node-row gather of
        an (ndof, m) block), same dtype and device.

    Returns:
      (ne, 30, m) element force contributions.  CPU tensors take the plain
      version; CUDA tensors launch the kernel (``block_matmat.launches``
      counts those launches).
    """
    if esm_t.device.type == "cpu" and ue.device.type == "cpu":
        return block_matmat_ref(esm_t, ue)
    if esm_t.device.type != "cuda" or ue.device != esm_t.device:
        raise ValueError(
            f"block_matmat: tensors on {esm_t.device} and {ue.device}; "
            "expected both on the CPU or both on one CUDA device"
        )
    if esm_t.dtype not in (torch.float32, torch.float64) or ue.dtype != esm_t.dtype:
        raise TypeError(
            f"block_matmat: dtypes {esm_t.dtype}/{ue.dtype}; expected both "
            "float32 or both float64"
        )
    ne = esm_t.shape[-1]
    if esm_t.shape != (30, 30, ne) or ue.dim() != 3 or ue.shape[:2] != (ne, 30):
        raise ValueError(
            f"block_matmat: shapes {tuple(esm_t.shape)} and {tuple(ue.shape)}; "
            "expected (30, 30, ne) and (ne, 30, m)"
        )
    if not (esm_t.is_contiguous() and ue.is_contiguous()):
        raise ValueError("block_matmat: inputs must be contiguous")
    if ne == 0 or ue.shape[2] == 0:
        return torch.empty_like(ue)
    build()
    out = torch.ops.fcvm.block_matmat(esm_t, ue)
    block_matmat.launches += 1
    block_matmat.shapes[(_dtype_name(ue), ue.shape[2])] += 1
    return out


block_matmat.launches = 0
block_matmat.shapes = Counter()  # launches by (dtype name, m)


class NodeIncidence(NamedTuple):
    """K1's int32 tables of one element numbering (built by
    :func:`fcvm_tpu_torch.ops.assembly.node_incidence`).

    Fields:
      elnodes_t: (10, ne) element node ids, element-major.
      offsets: (nn + 1,) CSR row starts over the nodes.
      pos: (10 ne,) each incidence's offset ``3 slot ne + e`` into K1's
        element output (30, ne), the node's incidences in ascending
        element order.
    """

    elnodes_t: torch.Tensor
    offsets: torch.Tensor
    pos: torch.Tensor


def khat_matvec_ref(esm_t: torch.Tensor, inc: NodeIncidence, u: torch.Tensor,
                    fixmask=None) -> torch.Tensor:
    """Plain version of K1: the gather of ``P u`` (``u`` without
    ``fixmask``) at the element dofs, K0's plain version, ``index_add_``
    into the dofs and, with ``fixmask``, ``P (.) + (I - P) u``."""
    ne = esm_t.shape[-1]
    a3 = torch.arange(3, device=u.device)
    eldofs_t = (3 * inc.elnodes_t.long()[:, None, :] + a3[None, :, None]).reshape(30, ne)
    v = u if fixmask is None else fixmask * u
    fe_t = block_matvec_ref(esm_t, v[eldofs_t])
    out = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
    out.index_add_(0, eldofs_t.reshape(-1), fe_t.reshape(-1))
    if fixmask is None:
        return out
    return fixmask * out + (1.0 - fixmask) * u


def khat_matvec(esm_t: torch.Tensor, inc: NodeIncidence, u: torch.Tensor,
                fixmask=None) -> torch.Tensor:
    """K1: ``K_hat u = P K (P u) + (I - P) u`` with ``P = diag(fixmask)``,
    or the raw ``K u`` without ``fixmask`` (design and bound at the top of
    ``csrc/khat_matvec.cu``).

    Args:
      esm_t: (30, 30, ne) element blocks, element-major, float32 or float64.
      inc: the element numbering's :class:`NodeIncidence` over ``nn`` nodes.
      u: (3 nn,) dof vector, same dtype and device.
      fixmask: (3 nn,) 1 on free dofs, 0 on fixed ones, or None.

    Returns:
      (3 nn,).  CPU tensors take the plain version; CUDA tensors launch the
      kernel (``khat_matvec.launches`` counts those launches), whose sums
      run in a fixed order: two calls on the same inputs give the same bits.
    """
    ne = esm_t.shape[-1]
    nn = inc.offsets.shape[0] - 1
    if (esm_t.shape != (30, 30, ne) or inc.elnodes_t.shape != (10, ne)
            or inc.pos.shape != (10 * ne,) or u.shape != (3 * nn,)
            or (fixmask is not None and fixmask.shape != u.shape)):
        raise ValueError(
            f"khat_matvec: shapes {tuple(esm_t.shape)}, elnodes_t "
            f"{tuple(inc.elnodes_t.shape)}, {nn} nodes, pos {tuple(inc.pos.shape)}, u "
            f"{tuple(u.shape)}; expected (30, 30, ne), (10, ne), (10 ne,), (3 nn,)")
    tensors = (esm_t, u, *inc) + (() if fixmask is None else (fixmask,))
    if all(t.device.type == "cpu" for t in tensors):
        return khat_matvec_ref(esm_t, inc, u, fixmask)
    if esm_t.device.type != "cuda" or any(t.device != esm_t.device for t in tensors):
        raise ValueError("khat_matvec: tensors on several devices; expected all on the CPU "
                         "or all on one CUDA device")
    if (esm_t.dtype not in (torch.float32, torch.float64) or u.dtype != esm_t.dtype
            or (fixmask is not None and fixmask.dtype != esm_t.dtype)):
        raise TypeError(f"khat_matvec: dtypes {esm_t.dtype}/{u.dtype}; expected float32 or "
                        "float64 throughout")
    if any(t.dtype != torch.int32 for t in inc):
        raise TypeError("khat_matvec: the incidence tables must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("khat_matvec: inputs must be contiguous")
    build()
    out = torch.ops.fcvm.khat_matvec(esm_t, inc.elnodes_t, inc.offsets, inc.pos, u, fixmask)
    khat_matvec.launches += 1
    khat_matvec.dtypes[_dtype_name(u)] += 1
    return out


khat_matvec.launches = 0
khat_matvec.dtypes = Counter()  # launches by dtype name


def two_level_apply_ref(pinv, qmat, coarse_inv, fixmask, r, z_fine=None):
    """Plain version of K4: the fine level (block Jacobi ``pinv r`` per
    node, or ``z_fine``), the projection of ``P r`` onto the cluster modes,
    the cluster sum, the coarse product in mode-major order, the
    prolongation and the mask."""
    z = z_fine
    if z is None:
        z = torch.einsum("nab,nb->na", pinv, r.reshape(-1, 3)).reshape(-1)
    nn_cl, _, nm = qmat.shape
    ncl = coarse_inv.shape[0] // nm
    cs = nn_cl // ncl
    r3 = (fixmask * r).reshape(-1, 3)
    nn = r3.shape[0]
    r3p = torch.nn.functional.pad(r3, (0, 0, 0, nn_cl - nn))
    # Q^T r: project onto cluster modes, sum within clusters; the coarse
    # vector is mode-major (k * ncl + i), the layout of coarse_inv
    rc = torch.einsum("nak,na->nk", qmat, r3p)
    rc = rc.reshape(ncl, cs, nm).sum(dim=1)  # (ncl, nm)
    zc = coarse_inv @ rc.T.reshape(-1)
    zc_n = zc.reshape(nm, ncl).T.repeat_interleave(cs, dim=0)  # (nn_cl, nm)
    z2 = torch.einsum("nak,nk->na", qmat, zc_n)
    return z + z2[:nn].reshape(-1) * fixmask


def two_level_apply(pinv, qmat, coarse_inv, fixmask, r, z_fine=None):
    """K4: the two-level preconditioner on a vector, ``z_fine + P Q Kc^-1
    Q^T (P r)`` with ``z_fine = pinv r`` per node unless given (design and
    bound at the top of ``csrc/two_level.cu``).

    Args:
      pinv: (nn, 3, 3) block-Jacobi inverses.
      qmat: (ncl cs, 3, nm) cluster mode basis, nm 6 or 12, ncl cs >= nn.
      coarse_inv: (nm ncl, nm ncl) coarse inverse, mode-major, in any
        layout (``cholesky_inverse`` gives column-major): it reaches only
        the GEMV, cuBLAS's, as in the plain version.
      fixmask, r: (3 nn,).
      z_fine: (3 nn,) the fine level's output (the cluster smoother's), or
        None for block Jacobi.

    Returns:
      (3 nn,).  CPU tensors take the plain version; CUDA tensors launch the
      kernels (``two_level_apply.launches`` counts those calls).
    """
    nn = r.shape[0] // 3
    if (r.dim() != 1 or r.shape != (3 * nn,) or fixmask.shape != r.shape
            or pinv.shape != (nn, 3, 3) or qmat.dim() != 3 or qmat.shape[1] != 3
            or (z_fine is not None and z_fine.shape != r.shape)):
        raise ValueError(
            f"two_level_apply: shapes pinv {tuple(pinv.shape)}, qmat {tuple(qmat.shape)}, "
            f"r {tuple(r.shape)}; expected (nn, 3, 3), (ncl cs, 3, nm), (3 nn,)")
    nm = qmat.shape[2]
    ncl = coarse_inv.shape[0] // nm if nm else 0
    if (nm not in (6, 12) or ncl == 0 or coarse_inv.shape != (nm * ncl, nm * ncl)
            or qmat.shape[0] % ncl or qmat.shape[0] < nn):
        raise ValueError(
            f"two_level_apply: qmat {tuple(qmat.shape)} and coarse_inv "
            f"{tuple(coarse_inv.shape)}; expected nm 6 or 12 modes on ncl clusters that "
            "cover the nodes")
    tensors = (pinv, qmat, coarse_inv, fixmask, r) + (() if z_fine is None else (z_fine,))
    if all(t.device.type == "cpu" for t in tensors):
        return two_level_apply_ref(pinv, qmat, coarse_inv, fixmask, r, z_fine)
    if r.device.type != "cuda" or any(t.device != r.device for t in tensors):
        raise ValueError("two_level_apply: tensors on several devices; expected all on the "
                         "CPU or all on one CUDA device")
    if r.dtype not in (torch.float32, torch.float64) or any(t.dtype != r.dtype
                                                             for t in tensors):
        raise TypeError("two_level_apply: expected float32 or float64 throughout")
    if not all(t.is_contiguous() for t in tensors if t is not coarse_inv):
        raise ValueError("two_level_apply: inputs other than coarse_inv must be contiguous")
    build()
    out = torch.ops.fcvm.two_level_apply(pinv, qmat, coarse_inv, fixmask, r, z_fine)
    two_level_apply.launches += 1
    two_level_apply.dtypes[_dtype_name(r)] += 1
    return out


two_level_apply.launches = 0
two_level_apply.dtypes = Counter()  # launches by dtype name


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
