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
  ``ScatterPlan`` node sum; source ``csrc/khat_matvec.cu``.  On the card it
  reads the blocks' upper triangles, packed tile by tile
  (:func:`pack_blocks`), streamed by bulk asynchronous copies.
* K1m :func:`khat_matmat`, K1 on an ``(ndof, m)`` block (K_hat·V, -G_hat·V,
  the raw K·V), replaces the XLA-lowered
  ``fcvm_tpu/runtime/buckling.py::_multi_matvec`` and
  ``fcvm_tpu/ops/deflation.py::block_khat_matvec``; source
  ``csrc/khat_matmat.cu``, on K1's packed blocks and incidence table and
  its own compacted tables (:func:`k1m_tables`, read where its element
  pass takes the collapse layout), its tensor maps made once per operator
  (:func:`khat_matmat_plan`).
* K8 :func:`segment_sum`, the fixed-order segment sum of a
  :class:`SegmentPlan`, replaces the node reductions of the JAX package
  (``fcvm_tpu/ops/assembly.py::scatter_node_rows`` with its
  ``ScatterPlan``, and ``jax.ops.segment_sum``); source
  ``csrc/segment_sum.cu``: long groups of wide rows stream through a
  bulk-copy ring, the rest are summed in registers, longest first, in
  place or into a new output it writes whole.  Every node reduction of the
  port but K1's, K1m's and K2's (each in K8's fixed order) runs through it,
  so none is an atomic scatter-add on the card.
* K4 :func:`two_level_apply`, the fused two-level preconditioner apply on
  a vector, replaces the XLA-lowered
  ``fcvm_tpu/ops/precond.py::TwoLevelPrecond.apply``; source
  ``csrc/two_level.cu``.  K4m :func:`two_level_apply_block`, its block
  form, replaces that apply under the eigensolve's ``vmap``; the same
  source.  Their coarse product is K4c, the symmetric product on the
  coarse inverse's packed upper tiles (:func:`pack_coarse`, made once per
  preconditioner build), which :func:`coarse_product` launches alone (the
  sharded backend's coarse product).
* K6 :func:`cg_iteration`, one of the two vector passes of a CG iteration
  on the solve's device state (:class:`CGPlan`), with the loop's
  convergence test and the Ritz deflation correction folded in, replaces
  the XLA-lowered body and cond of the ``lax.while_loop`` of
  ``fcvm_tpu/ops/solver.py::pcg``/``pcg_harvest`` (the chain at
  ``solver.py:107-122``), the products of
  ``fcvm_tpu/ops/deflation.py::deflated`` and, on a block, the same body
  with those products under the ``vmap`` of
  ``fcvm_tpu/runtime/buckling.py::_kinv``; source ``csrc/cg_iteration.cu``.
* K2, the stress update and internal force in two passes, replaces the
  XLA-lowered per-element update of ``fcvm_tpu/ops/stress_update.py``
  (``_element_stress_update_hp``, ``update_stress_load``,
  ``internal_force_from_stress``) with
  ``fcvm_tpu/ops/material.py::radial_return``, and its node sum; source
  ``csrc/stress_update.cu``.  Its element pass :func:`stress_update`, the
  stress update of every Gauss point and each element's rows of the
  internal force (the given-stress form: the rows alone), on its int32 node
  table (:func:`element_table`, made once per mesh); its node pass
  :func:`node_force`, the rows summed into nodes in K8's order; both as a
  residual, with its tail and norm in the node pass,
  :func:`stress_residual_bound`.
* K3 :func:`form_blocks`, every element block the paths form (elastic,
  tangent, geometric) in one launch, replaces the XLA-lowered
  ``fcvm_tpu/ops/assembly.py::elastic_stiffness_blocks``,
  ``tangent_stiffness_blocks`` and ``geometric_stiffness_blocks``; source
  ``csrc/form_blocks.cu``, on the Gauss-point geometry of ``csrc/tet10.cuh``
  (K2's); it writes K1's packed tiles (:func:`pack_blocks`'s layout) and,
  when asked, the element-major blocks and the compact diagonal
  (:func:`diag_sectors`'s layout) K5 reads.
* K5 :func:`jacobi_inverse`, the block-Jacobi rebuild as one node pass
  (each node's diagonal blocks read from K3's compact diagonal, one
  sector an incidence, summed in K8's order, masked and inverted),
  replaces the XLA-lowered
  ``fcvm_tpu/ops/assembly.py::block_jacobi_inverse_blocks``; source
  ``csrc/jacobi_inverse.cu``.
* K0p :func:`soa_matvec` replaces ``tools/bw_probe.py::soa_matvec``;
  source ``csrc/bw_probe.cu``.
* Kbw :func:`bw_read` replaces ``tools/bw_probe.py::make_bw_kernel``;
  source ``csrc/bw_probe.cu``.

K1 and K4 carry the solver's CG iteration (every ``K_hat @ v`` and raw
``K @ v``, every preconditioner apply on a vector); K1m and K4m the block
solves of the buckling eigensolve (every K_hat·V, -G_hat·V and block
preconditioner apply) and the deflation builds' K_hat·W; K8 every sum of
element rows into nodes outside K1, K1m and K2 (the loads, the
preconditioner builds); K2 every residual's stress update, internal force
and residual; K3 every element block an assembly, a tangent refresh or the
eigensolve's pencil forms, and K5 every block-Jacobi rebuild.  K0m runs on
no path
since K1m; it, K0, K0p and Kbw serve phase 3 of ``chip_smoke.py`` and the
bandwidth probe (:mod:`fcvm_tpu_torch.tools.bw_probe`).  What bounds each
on the card and how its design answers that is written at the top of its
source.

Dispatch is by the tensors' device: on CPU tensors a wrapper runs the plain
version (``*_ref``), on CUDA tensors it launches the kernel or raises.  There
is no fallback from a failed build or launch.  Each wrapper counts its
kernel launches in its ``launches`` attribute (K8 its calls, each launching
one or two kernels); K0, K1, K2, K4, K6 and K8 also count them by dtype in
their ``dtypes`` (K6 by pass in ``cg_iteration.passes``, K2's passes by form
in ``stress_update.forms`` and ``node_force.forms``, K3 and K5 by form in
``form_blocks.forms`` and ``jacobi_inverse.forms``, K3 by output in
``form_blocks.outputs``), K0m, K1m and K4m by
dtype and column count in their ``shapes`` (K4c alone too:
``coarse_product.shapes``),
and K8 its kernels by form and path in ``segment_sum.paths``.

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

from fcvm_tpu_torch.ops import elements as el
from fcvm_tpu_torch.ops import material as mat
from fcvm_tpu_torch.utils.linalg3 import det3, inv3_spd

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("ops.cpp", "block_matvec.cu", "block_matmat.cu", "khat_matvec.cu",
           "khat_matmat.cu", "two_level.cu", "segment_sum.cu", "cg_iteration.cu",
           "stress_update.cu", "form_blocks.cu", "jacobi_inverse.cu", "bw_probe.cu")
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


class K1mTables(NamedTuple):
    """K1m's int32 tables of one element numbering (built by
    :func:`k1m_tables`): the element pass in its collapse layout (float32
    from 5 columns) writes compacted rows, and its node pass sums them.

    An incidence is an (element, slot) of K1's table, each node's in
    ascending element order.  The elements fall in sub-tiles of
    ``K1M_SUB``.  A node's incidences in the sub-tile of its first one make
    one row, its partial: their sum from 0 in table order, which is K1's
    running sum after them, bit for bit.  Every later incidence is a row of
    its own.  Rows are numbered sub-tile by sub-tile, in each by their first
    incidence, so sub-tile ``b``'s incidences are entries ``10 K1M_SUB b``
    onwards.

    Fields:
      ents: (10 ne,) the incidences row by row, each row's in table order,
        as ``10 (e mod K1M_SUB) + slot`` in their sub-tile.
      ent_rows: (10 ne,) each entry's row, ascending.
      node_offsets: (nn + 1,) each node's first entry of ``node_rows``.
      node_rows: (R,) each node's rows, its partial first, then its later
        incidences in table order.
    """

    ents: torch.Tensor
    ent_rows: torch.Tensor
    node_offsets: torch.Tensor
    node_rows: torch.Tensor


class NodeIncidence(NamedTuple):
    """K1's int32 tables of one element numbering (built by
    :func:`fcvm_tpu_torch.ops.assembly.node_incidence`), and K1m's.

    Fields:
      elnodes_t: (10, ne) element node ids, element-major.
      offsets: (nn + 1,) CSR row starts over the nodes.
      pos: (10 ne,) each incidence's offset ``3 slot ne + e`` into K1's
        element output (30, ne), the node's incidences in ascending
        element order.
      k1m: K1m's :class:`K1mTables` of the same numbering, made with the
        others on the card (None on the CPU, whose plain version needs
        none).
    """

    elnodes_t: torch.Tensor
    offsets: torch.Tensor
    pos: torch.Tensor
    k1m: K1mTables | None = None


K1M_SUB = 32  # elements a sub-tile of K1m's element pass: kSub of csrc/khat_matmat.cu


def k1m_tables(inc: NodeIncidence, sub: int = K1M_SUB) -> K1mTables:
    """K1m's :class:`K1mTables` of ``inc``'s numbering at sub-tiles of
    ``sub`` elements (the kernel's ``K1M_SUB``; another size is a probe's),
    on ``inc``'s device: a few sorts, once per element numbering."""
    ne, nn, dev = inc.elnodes_t.shape[1], inc.offsets.shape[0] - 1, inc.pos.device
    offsets, pos = inc.offsets.long(), inc.pos.long()
    e, slot = pos % max(ne, 1), pos // max(3 * ne, 1)
    k = 10 * e + slot  # the incidence's element-major id: a node's table order is k's
    node = torch.repeat_interleave(torch.arange(nn, device=dev), offsets[1:] - offsets[:-1])
    first = offsets[:-1][node]  # the table position of the node's first incidence
    s = e // sub
    # the row of each incidence, named by its first incidence's k
    key = torch.where(s == s[first], k[first], k)
    keys, row = torch.unique(key, sorted=True, return_inverse=True)
    nrows = keys.shape[0]
    order = torch.argsort(row * (10 * ne) + k)
    row_node = torch.zeros(nrows, dtype=torch.int64, device=dev).scatter_(0, row, node)
    node_offsets = torch.zeros(nn + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(row_node, minlength=nn), 0, out=node_offsets[1:])
    # a node's rows by their first incidence: the partial's is the node's first
    node_rows = torch.argsort(row_node * (10 * ne) + keys)
    return K1mTables(*(t.to(torch.int32) for t in ((10 * (e % sub) + slot)[order], row[order],
                                                    node_offsets, node_rows)))


# K1's packed blocks: the upper triangle i <= j of each 30x30 block, row by
# row, PACK_TILE[dtype] elements a tile (1 KB a packed row), the tiles one
# after the other; the kernel streams PACK_ROWS packed rows a copy
NPACK = 465  # 30 * 31 / 2
PACK_ROWS = 31  # 465 = 15 x 31
PACK_TILE = {torch.float32: 256, torch.float64: 128}


def _triu(device):
    return torch.triu_indices(30, 30, device=device)  # row-major, i <= j


def pack_blocks(esm_t: torch.Tensor) -> torch.Tensor:
    """K1's packed copy of element-major blocks ``esm_t`` (30, 30, ne):
    ``(ntiles, 465, E)`` with ``packed[t, q, k]`` the upper-triangle entry
    ``q`` (row-major, ``i <= j``) of element ``t E + k``, ``E`` =
    ``PACK_TILE[dtype]``, the last tile zero-padded.  Plain indexing, once
    per operator; the blocks must be symmetric (``B^T D B``), which the
    tests check."""
    if esm_t.dim() != 3 or esm_t.shape[:2] != (30, 30):
        raise ValueError(f"pack_blocks: shape {tuple(esm_t.shape)}; expected (30, 30, ne)")
    if esm_t.dtype not in PACK_TILE:
        raise TypeError(f"pack_blocks: dtype {esm_t.dtype}; expected float32 or float64")
    tile, ne = PACK_TILE[esm_t.dtype], esm_t.shape[2]
    ntiles = -(-ne // tile)
    iu = _triu(esm_t.device)
    upper = torch.nn.functional.pad(esm_t[iu[0], iu[1]], (0, ntiles * tile - ne))
    return upper.reshape(NPACK, ntiles, tile).transpose(0, 1).contiguous()


def unpack_blocks(packed: torch.Tensor, ne: int) -> torch.Tensor:
    """The symmetric element-major blocks (30, 30, ne) of a
    :func:`pack_blocks` copy: each packed entry at ``(i, j)`` and ``(j, i)``."""
    ntiles, npack, tile = packed.shape
    if npack != NPACK or not (ntiles - 1) * tile < ne <= ntiles * tile:
        raise ValueError(f"unpack_blocks: packed {tuple(packed.shape)} for {ne} elements")
    upper = packed.transpose(0, 1).reshape(NPACK, ntiles * tile)[:, :ne]
    iu = _triu(packed.device)
    out = torch.empty((30, 30, ne), dtype=packed.dtype, device=packed.device)
    out[iu[1], iu[0]] = upper
    out[iu[0], iu[1]] = upper
    return out


def khat_matvec_ref(esm_t: torch.Tensor, inc: NodeIncidence, u: torch.Tensor,
                    fixmask=None) -> torch.Tensor:
    """Plain version of K1 on full blocks (the CPU's path): the gather of
    ``P u`` (``u`` without ``fixmask``) at the element dofs, K0's plain
    version, ``index_add_`` into the dofs and, with ``fixmask``,
    ``P (.) + (I - P) u``.  On an ``(ndof, m)`` block ``u`` (K1m's plain
    version) the node-row gather, K0m's plain version and ``index_add_``
    into the nodes, element by element, as K1m's node pass orders them."""
    ne = inc.elnodes_t.shape[1]
    pm = fixmask if fixmask is None or u.dim() == 1 else fixmask[:, None]
    v = u if pm is None else pm * u
    if u.dim() == 2:
        nn, m = u.shape[0] // 3, u.shape[1]
        eln = inc.elnodes_t.T.long()  # (ne, 10)
        fe = block_matmat_ref(esm_t, v.reshape(nn, 3, m)[eln].reshape(ne, 30, m))
        out = torch.zeros((nn, 3, m), dtype=u.dtype, device=u.device)
        out = out.index_add_(0, eln.reshape(-1), fe.reshape(ne * 10, 3, m)).reshape(3 * nn, m)
    else:
        a3 = torch.arange(3, device=u.device)
        eldofs_t = (3 * inc.elnodes_t.long()[:, None, :] + a3[None, :, None]).reshape(30, ne)
        fe_t = block_matvec_ref(esm_t, v[eldofs_t])
        out = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
        out.index_add_(0, eldofs_t.reshape(-1), fe_t.reshape(-1))
    if pm is None:
        return out
    return pm * out + (1.0 - pm) * u


def khat_matvec_packed_ref(packed: torch.Tensor, inc: NodeIncidence, u: torch.Tensor,
                           fixmask=None) -> torch.Tensor:
    """Plain version of K1 on the card: the packed blocks unpacked to
    symmetric blocks, then :func:`khat_matvec_ref`."""
    return khat_matvec_ref(unpack_blocks(packed, inc.elnodes_t.shape[1]), inc, u, fixmask)


def khat_matvec(blocks: torch.Tensor, inc: NodeIncidence, u: torch.Tensor,
                fixmask=None) -> torch.Tensor:
    """K1: ``K_hat u = P K (P u) + (I - P) u`` with ``P = diag(fixmask)``,
    or the raw ``K u`` without ``fixmask`` (design and bound at the top of
    ``csrc/khat_matvec.cu``).

    Args:
      blocks: the element blocks, float32 or float64: on the CPU the full
        element-major blocks (30, 30, ne), which the plain version reads;
        on the card their :func:`pack_blocks` copy, which the kernel reads.
      inc: the element numbering's :class:`NodeIncidence` over ``nn`` nodes.
      u: (3 nn,) dof vector, same dtype and device.
      fixmask: (3 nn,) 1 on free dofs, 0 on fixed ones, or None.

    Returns:
      (3 nn,).  CPU tensors take the plain version; CUDA tensors launch the
      kernel (``khat_matvec.launches`` counts those launches), whose sums
      run in a fixed order: two calls on the same inputs give the same bits.
    """
    _k1_shapes(inc, u.shape, fixmask)
    _k1_on_cpu("khat_matvec", blocks, inc, u, fixmask)
    return khat_matvec_bound(blocks, inc, fixmask)(u)


khat_matvec.launches = 0
khat_matvec.dtypes = Counter()  # launches by dtype name


def _k1_shapes(inc, u_shape, fixmask):
    ne = inc.elnodes_t.shape[1] if inc.elnodes_t.dim() == 2 else -1
    nn = inc.offsets.shape[0] - 1
    if (inc.elnodes_t.shape != (10, ne) or inc.pos.shape != (10 * ne,)
            or u_shape != (3 * nn,) or (fixmask is not None and fixmask.shape != u_shape)):
        raise ValueError(
            f"khat_matvec: elnodes_t {tuple(inc.elnodes_t.shape)}, {nn} nodes, pos "
            f"{tuple(inc.pos.shape)}, u {tuple(u_shape)}; expected (10, ne), (10 ne,), (3 nn,)")


def khat_matvec_bound(blocks: torch.Tensor, inc: NodeIncidence, fixmask=None):
    """K1 of one operator, the checks of ``blocks``, ``inc`` and
    ``fixmask`` made once: returns ``u -> khat_matvec(blocks, inc, u,
    fixmask)``, which on the CPU takes the plain version and on the card
    launches K1 at once (the binding checks ``u``) and counts it in
    ``khat_matvec.launches``: the one place that launches K1."""
    nn = inc.offsets.shape[0] - 1
    _k1_shapes(inc, (3 * nn,), fixmask)
    if _k1_on_cpu("khat_matvec", blocks, inc, None, fixmask):
        return lambda u: khat_matvec_ref(blocks, inc, u, fixmask)
    build()
    op, tables, name = torch.ops.fcvm.khat_matvec, tuple(inc[:3]), _dtype_name(blocks)

    def k1(u):
        out = op(blocks, *tables, u, fixmask)
        khat_matvec.launches += 1
        khat_matvec.dtypes[name] += 1
        return out

    return k1


def _k1_on_cpu(name, blocks, inc, u, fixmask) -> bool:
    """Check the devices, dtypes and blocks of K1's or K1m's inputs (their
    shapes checked by the caller; ``u`` None for an operator's): True for
    CPU tensors, which take the full blocks; False for one CUDA device,
    whose kernel takes the packed copy, every input dense."""
    ne = inc.elnodes_t.shape[1]
    tensors = (blocks, *inc[:3]) + (() if u is None else (u,)) + (
        () if fixmask is None else (fixmask,))
    cpu = all(t.device.type == "cpu" for t in tensors)
    if not cpu and (blocks.device.type != "cuda"
                    or any(t.device != blocks.device for t in tensors)):
        raise ValueError(f"{name}: tensors on several devices; expected all on the CPU or all "
                         "on one CUDA device")
    if (blocks.dtype not in PACK_TILE or (u is not None and u.dtype != blocks.dtype)
            or (fixmask is not None and fixmask.dtype != blocks.dtype)):
        raise TypeError(f"{name}: dtypes {blocks.dtype}/{None if u is None else u.dtype}; "
                        "expected float32 or float64 throughout")
    if any(t.dtype != torch.int32 for t in inc[:3]):
        raise TypeError(f"{name}: the incidence tables must be int32")
    if cpu:
        if blocks.shape != (30, 30, ne):
            raise ValueError(f"{name}: CPU blocks {tuple(blocks.shape)}; expected the full "
                             f"blocks (30, 30, {ne})")
        return True
    tile = PACK_TILE[blocks.dtype]
    if (blocks.dim() != 3 or blocks.shape[1:] != (NPACK, tile)
            or not (blocks.shape[0] - 1) * tile < ne <= blocks.shape[0] * tile):
        raise ValueError(f"{name}: CUDA blocks {tuple(blocks.shape)} for {ne} elements; "
                         f"expected (ntiles, {NPACK}, {tile}) from pack_blocks")
    if not all(t.is_contiguous() for t in tensors) or blocks.data_ptr() % 16:
        raise ValueError(f"{name}: inputs must be contiguous (a column slice of a block is "
                         "not), the packed blocks 16-byte aligned")
    return False


def khat_matmat_ref(esm_t: torch.Tensor, inc: NodeIncidence, u: torch.Tensor, fixmask=None,
                    identity_on_fixed: bool = True, negate: bool = False) -> torch.Tensor:
    """Plain version of K1m on full blocks (the CPU's path): the raw ``K U``
    of :func:`khat_matvec_ref` on ``P U``, then ``P (.)``, ``+ (I - P) U``
    with ``identity_on_fixed``, and the sign (the chain the port ran before
    K1m, bit for bit)."""
    if fixmask is None:
        y = khat_matvec_ref(esm_t, inc, u)
    else:
        pm = fixmask[:, None]
        y = pm * khat_matvec_ref(esm_t, inc, pm * u)
        if identity_on_fixed:
            y = y + (1.0 - pm) * u
    return -y if negate else y


def khat_matmat_packed_ref(packed: torch.Tensor, inc: NodeIncidence, u: torch.Tensor,
                           fixmask=None, identity_on_fixed: bool = True,
                           negate: bool = False) -> torch.Tensor:
    """Plain version of K1m on the card: the packed blocks unpacked to
    symmetric blocks, then :func:`khat_matmat_ref`."""
    return khat_matmat_ref(unpack_blocks(packed, inc.elnodes_t.shape[1]), inc, u, fixmask,
                           identity_on_fixed, negate)


class K1mPlan(NamedTuple):
    """What K1m reads on the card for one operator, checked and made once
    (:func:`khat_matmat_plan`): the packed blocks and their TMA tensor maps
    (bytes on the CPU), K1's tables, K1m's tables, the mask, and the
    operator's dof count."""

    packed: torch.Tensor
    map: torch.Tensor
    inc: NodeIncidence
    tables: K1mTables
    fixmask: torch.Tensor | None
    ndof: int


def _check_shapes(name, inc, u, fixmask):
    ne = inc.elnodes_t.shape[1] if inc.elnodes_t.dim() == 2 else -1
    nn = inc.offsets.shape[0] - 1
    if (inc.elnodes_t.shape != (10, ne) or inc.pos.shape != (10 * ne,)
            or (u is not None and (u.dim() != 2 or u.shape[0] != 3 * nn))
            or (fixmask is not None and fixmask.shape != (3 * nn,))):
        raise ValueError(
            f"{name}: elnodes_t {tuple(inc.elnodes_t.shape)}, {nn} nodes, pos "
            f"{tuple(inc.pos.shape)}, u {None if u is None else tuple(u.shape)}; expected "
            "(10, ne), (10 ne,), (3 nn, m) and a (3 nn,) fixmask")


def khat_matmat_plan(blocks: torch.Tensor, inc: NodeIncidence, fixmask=None):
    """K1m's :class:`K1mPlan` of one operator (the arguments as in
    :func:`khat_matmat`), checked once: ``inc.k1m`` (made here when None)
    and the tensor maps of the packed blocks, which a call would otherwise
    encode again.  None for CPU tensors, whose plain version needs none.
    The plan keeps the blocks alive; it serves every width."""
    _check_shapes("khat_matmat", inc, None, fixmask)
    if _k1_on_cpu("khat_matmat", blocks, inc, None, fixmask):
        return None
    tables = inc.k1m if inc.k1m is not None else k1m_tables(inc)
    ne, nn, rows = inc.elnodes_t.shape[1], inc.offsets.shape[0] - 1, tables.node_rows.shape[0]
    want = {"ents": 10 * ne, "ent_rows": 10 * ne, "node_offsets": nn + 1, "node_rows": rows}
    for field, t in zip(K1mTables._fields, tables):
        if (t.shape != (want[field],) or t.dtype != torch.int32 or t.device != blocks.device
                or not t.is_contiguous()):
            raise ValueError(f"khat_matmat: K1m table {field} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}; expected ({want[field]},) int32 on {blocks.device}")
    build()
    return K1mPlan(blocks, torch.ops.fcvm.khat_matmat_map(blocks), inc, tables, fixmask, 3 * nn)


def khat_matmat(blocks: torch.Tensor, inc: NodeIncidence, u: torch.Tensor, fixmask=None,
                identity_on_fixed: bool = True, negate: bool = False,
                plan: K1mPlan | None = None) -> torch.Tensor:
    """K1m: K1 on the m columns of a block (design and bound at the top of
    ``csrc/khat_matmat.cu``):

    * with ``fixmask`` and ``identity_on_fixed``: ``K_hat U = P K (P U) +
      (I - P) U``, ``P = diag(fixmask)``;
    * with ``fixmask`` alone: ``P K (P U)`` (``-G_hat U`` once negated);
    * without ``fixmask``: the raw ``K U`` (``identity_on_fixed`` unread);

    each negated with ``negate``.

    Args:
      blocks: as in :func:`khat_matvec`: the full element-major blocks on
        the CPU, their :func:`pack_blocks` copy on the card.
      inc: the element numbering's :class:`NodeIncidence` over ``nn`` nodes.
      u: (3 nn, m) block, row-major (a column slice is not: make it dense).
      fixmask: (3 nn,) 1 on free dofs, 0 on fixed ones, or None.
      plan: on the card, :func:`khat_matmat_plan` of the same ``blocks``,
        ``inc`` and ``fixmask`` (the same tensors: a plan of others
        raises), made once per operator: a call then checks only ``u``.
        Without it each call makes one.

    Returns:
      (3 nn, m).  CPU tensors take the plain version; CUDA tensors launch
      the kernels (``khat_matmat.launches`` counts those calls, by dtype and
      m in ``khat_matmat.shapes``), whose sums run in a fixed order: each
      column has K1's bits, and two calls on the same inputs give the same
      bits.
    """
    if plan is None:
        _check_shapes("khat_matmat", inc, u, fixmask)
        if _k1_on_cpu("khat_matmat", blocks, inc, u, fixmask):
            return khat_matmat_ref(blocks, inc, u, fixmask, identity_on_fixed, negate)
        plan = khat_matmat_plan(blocks, inc, fixmask)
    elif (plan.packed is not blocks or plan.inc.elnodes_t is not inc.elnodes_t
          or plan.fixmask is not fixmask):
        raise ValueError("khat_matmat: the plan was made for other blocks, incidence tables or "
                         "fixmask than the ones given")
    elif (u.dim() != 2 or u.shape[0] != plan.ndof or u.dtype != plan.packed.dtype
          or u.device != plan.packed.device or not u.is_contiguous()):
        raise ValueError(f"khat_matmat: u {tuple(u.shape)} {u.dtype} on {u.device}; expected a "
                         f"dense ({plan.ndof}, m) {plan.packed.dtype} on {plan.packed.device}")
    if u.shape[1] == 0:
        return torch.empty_like(u)
    out = torch.ops.fcvm.khat_matmat(plan.packed, plan.map, *plan.inc[:3], *plan.tables, u,
                                     plan.fixmask, identity_on_fixed, negate)
    khat_matmat.launches += 1
    khat_matmat.shapes[(_dtype_name(u), u.shape[1])] += 1
    return out


khat_matmat.launches = 0
khat_matmat.shapes = Counter()  # launches by (dtype name, m)


class SegmentPlan(NamedTuple):
    """K8's plan of one fixed set of keys: value row ``p`` adds into row
    ``keys[p]`` of the output (built by :func:`segment_plan`).

    Fields:
      keys: (n,) int64, the plain version's ``index_add_`` index.
      order: (nsum,) int32, the value rows grouped by key in ascending key
        order, each group in ascending row order (a stable sort).
      offsets: (nu + 1,) int32, each group's range in ``order``.
      segs: (nu,) int32, each group's key: the output rows the kernel
        writes; every other row keeps its value (accumulating) or is
        written 0 (the write form).
      top: the largest key in ``segs`` plus one (0 when empty): the least
        number of output rows.
      walk: (3, nu) int32, the groups longest first (ties in ascending key
        order): each one's begin and end in ``order`` and its key, the
        order in which the kernel takes them.
      long_counts: 32 ints, ``long_counts[k]`` the number of groups of at
        least ``2**k`` rows: the first ones of ``walk``.
      rows: the output rows of the write form, or None (a plan for the
        accumulating form only; the write form's plain version takes any).
      holes: (rows - nu,) int32, the output rows below ``rows`` that no key
        names, which the write form zeroes; None without ``rows``.
    """

    keys: torch.Tensor
    order: torch.Tensor
    offsets: torch.Tensor
    segs: torch.Tensor
    top: int
    walk: torch.Tensor
    long_counts: tuple
    rows: int | None = None
    holes: torch.Tensor | None = None


def segment_plan(keys: torch.Tensor, drop=None, rows=None) -> SegmentPlan:
    """The :class:`SegmentPlan` of ``keys`` (any shape, flattened): one
    stable sort on their device, the JAX package's ``ScatterPlan`` order.
    Besides the count of groups (``torch.unique_consecutive``) the host
    reads once: the keys' range and the long-group counts together.  Rows
    whose key is ``drop`` are left out of the kernel's sums (a dump row
    nobody reads); the plain version still adds them.  ``rows``, for a plan
    of the write form (not with ``drop``): the output's rows, every key
    below it."""
    keys = keys.reshape(-1).long()
    n, dev = keys.shape[0], keys.device
    if n >= 2**31:
        raise ValueError("segment_plan: K8's int32 tables need fewer than 2^31 rows")
    if drop is not None and rows is not None:
        raise ValueError("segment_plan: a plan of the write form has no dump row")
    # a dropped row sorts last, in a group of its own that sums nothing
    sort_keys = keys if drop is None else keys.masked_fill(keys == drop, _DROPPED)
    sorted_keys, order = torch.sort(sort_keys, stable=True)
    segs, counts = torch.unique_consecutive(sorted_keys, return_counts=True)
    offsets = torch.zeros(segs.shape[0] + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=offsets[1:])
    nall = segs.shape[0]
    last = min(nall, 2)  # the last two groups' keys, and the last one's rows
    ends = [sorted_keys[:1], segs[nall - last:], counts[nall - last:]]
    if drop is not None:
        counts = counts.masked_fill(segs == _DROPPED, 0)
    lengths, by_length = torch.sort(counts, descending=True, stable=True)
    walk = torch.stack([offsets[:-1][by_length], offsets[1:][by_length], segs[by_length]])
    longer = torch.searchsorted(-lengths, -(2 ** torch.arange(32, device=dev)), right=True)
    lo, tail, tail_rows, long_counts = 0, [], [], [0] * 32
    if n:
        lo, *read = torch.cat([*ends, longer]).tolist()
        tail, tail_rows, long_counts = read[:last], read[last:2 * last], read[2 * last:]
    nu = long_counts[0]  # the groups summed: every one but the dropped rows'
    ndrop = tail_rows[-1] if nu < nall else 0
    hi = tail[nall - nu - 1] if nu else 0  # the largest key summed
    if lo < 0 or hi >= 2**31:
        raise ValueError("segment_plan: K8's int32 tables need keys in [0, 2^31)")
    segs, offsets, order, walk = segs[:nu], offsets[:nu + 1], order[:n - ndrop], walk[:, :nu]
    top = hi + 1 if nu else 0
    holes = None
    if rows is not None:
        if top > rows:
            raise ValueError(f"segment_plan: a key {top - 1} is not below rows = {rows}")
        named = torch.zeros(rows, dtype=torch.bool, device=dev)
        named[segs] = True
        holes = torch.nonzero(~named).reshape(-1).to(torch.int32)
    return SegmentPlan(keys, order.to(torch.int32), offsets.to(torch.int32),
                       segs.to(torch.int32), top, walk.to(torch.int32), tuple(long_counts),
                       rows, holes)


_DROPPED = 2**62  # a dropped row's sort key, past every key K8 takes


# K8's schedule (csrc/segment_sum.cu, which owns the ring's shape): a group
# of at least RING_MIN_VALUES values (rows x width, its rows rounded up to a
# power of two) takes the ring path where its rows allow: a multiple of 16
# bytes at a 16-byte aligned address, and at most RING_MAX_WIDTH values (31
# consumer warps of the kernel's 1024 threads).  Every other group takes the
# register path.
RING_MIN_VALUES = 4096
RING_MAX_WIDTH = 992


def ring_groups(plan: SegmentPlan, width: int, itemsize: int, aligned: bool = True) -> int:
    """How many of ``plan``'s groups K8 sums on its ring path, the first of
    its ``walk``, for rows of ``width`` values of ``itemsize`` bytes;
    ``aligned``: the values start at a 16-byte aligned address."""
    if not (aligned and (width * itemsize) % 16 == 0 and 0 < width <= RING_MAX_WIDTH):
        return 0
    k = (-(-RING_MIN_VALUES // width) - 1).bit_length()  # log2 of the rows, rounded up
    return plan.long_counts[k] if k < len(plan.long_counts) else 0


def segment_sum_ref(vals: torch.Tensor, plan: SegmentPlan, out=None, *, rows=None):
    """Plain version of K8: ``out.index_add_(0, plan.keys, vals)``, or
    with ``rows`` instead of ``out`` the same into ``torch.zeros``."""
    if out is None:
        out = torch.zeros((rows, *vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, plan.keys, vals)


def segment_sum(vals: torch.Tensor, plan: SegmentPlan, out=None, *, rows=None):
    """K8: ``out[keys[p]] += vals[p]`` for every row ``p`` of ``vals``, each
    output row summed in the plan's fixed order (design and bound at the
    top of ``csrc/segment_sum.cu``).  Two forms:

    * accumulate, given ``out``: in place onto its rows;
    * write, given ``rows`` instead: a new output of ``rows`` rows, each
      sum from zero and every row that no key names 0, as ``index_add_``
      into ``torch.zeros`` (on the card one launch writes all of it: no
      zero fill; the plan must be built with the same ``rows``).

    Args:
      vals: (n, ...) values, float32 or float64, contiguous.
      plan: the :class:`SegmentPlan` of the n rows' keys.
      out: (nout, ...) accumulator, the trailing shape of ``vals``, same
        dtype and device, contiguous; or None with ``rows``.

    Returns:
      The output.  CPU tensors take the plain version; CUDA tensors launch
      the kernel: no atomics, so two calls on the same inputs give the same
      bits.  ``segment_sum.launches`` counts the calls that launch, one each
      whatever its paths; ``segment_sum.paths`` counts the kernels launched,
      by form and path (a call with long and short groups launches two).
    """
    write = out is None
    if write == (rows is None):
        raise ValueError("segment_sum: give out (the accumulating form) or rows (the write "
                         "form)")
    nout = rows if write else out.shape[0]
    if (vals.dim() < 1 or plan.keys.shape[0] != vals.shape[0] or not plan.top <= nout < 2**31
            or (write and plan.rows not in (None, rows))):
        raise ValueError(
            f"segment_sum: vals {tuple(vals.shape)}, {nout} output rows, a plan of "
            f"{plan.keys.shape[0]} keys needing {plan.top} rows (built for {plan.rows}); "
            "expected n keys for the n rows of vals, every key below the output's rows, "
            "fewer than 2^31 of them, and the plan's rows")
    if not vals.is_cuda:
        tensors = (vals, plan.keys, plan.order, plan.walk) + (() if write else (out,))
        if any(t.device.type != "cpu" for t in tensors):
            raise ValueError("segment_sum: tensors on several devices; expected all on the CPU "
                             "or all on one CUDA device")
        if (plan.order.shape[0] > vals.shape[0] or plan.walk.shape != (3, plan.segs.shape[0])
                or (not write and (out.dim() != vals.dim() or out.shape[1:] != vals.shape[1:]))):
            raise ValueError(f"segment_sum: vals {tuple(vals.shape)}, out "
                             f"{None if write else tuple(out.shape)}; expected (n, ...) and "
                             "(nout, ...) of the same trailing shape")
        if not (vals.is_contiguous() and (write or out.is_contiguous())):
            raise ValueError("segment_sum: vals and out must be contiguous")
        return segment_sum_ref(vals, plan, out, rows=rows)
    # on the card the binding checks the devices, dtypes, shapes and layouts
    if write:
        if plan.rows != rows:
            raise ValueError("segment_sum: the write form on the card needs a plan built with "
                             f"rows = {rows}")
        out = vals.new_empty((rows, *vals.shape[1:]))
    nu, nholes = plan.segs.shape[0], (plan.holes.shape[0] if write else 0)
    if out.numel() == 0 or nu + nholes == 0:
        return out
    nlong = ring_groups(plan, out.numel() // nout, vals.element_size(), vals.data_ptr() % 16 == 0)
    build()
    torch.ops.fcvm.segment_sum(vals, plan.order, plan.walk, plan.holes if write else None, out,
                               nlong, write)
    segment_sum.launches += 1
    segment_sum.dtypes[_dtype_name(out)] += 1
    form = "write" if write else "accumulate"
    if nlong:
        segment_sum.paths[f"{form} ring"] += 1
    if nu > nlong or nholes:
        segment_sum.paths[f"{form} register"] += 1
    return out


segment_sum.launches = 0  # calls that launch (one or two kernels each)
segment_sum.dtypes = Counter()  # those calls by dtype name
segment_sum.paths = Counter()  # kernels launched, by form and path ("write register", ...)


# K4c's packed coarse inverse: the (n, n) symmetric matrix cut into
# COARSE_TILE x COARSE_TILE tiles, the upper ones (bi <= bj) in row-major
# tile order, each contiguous and row-major, the last tile row and column
# zero-padded; a diagonal tile whole, its lower half the mirror of its upper
COARSE_TILE = 128


class PackedCoarse(NamedTuple):
    """The upper tiles (nb (nb + 1) / 2, T, T) of an (n, n) symmetric
    coarse inverse, nb = ceil(n / T) (:func:`pack_coarse`)."""
    tiles: torch.Tensor
    n: int

    @property
    def shape(self):  # the matrix's
        return (self.n, self.n)


def pack_coarse(coarse_inv: torch.Tensor, tile: int = COARSE_TILE) -> PackedCoarse:
    """K4c's packed copy of a coarse inverse (n, n): the values ``i <= j``
    of its upper triangle, tile by tile (see ``COARSE_TILE``).  One tile row
    at a time, so it needs a tile row of scratch beside the result; once
    per preconditioner build."""
    if coarse_inv.dim() != 2 or coarse_inv.shape[0] != coarse_inv.shape[1]:
        raise ValueError(f"pack_coarse: shape {tuple(coarse_inv.shape)}; expected (n, n)")
    if coarse_inv.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pack_coarse: dtype {coarse_inv.dtype}; expected float32 or float64")
    n = coarse_inv.shape[0]
    nb = -(-n // tile)
    tiles = torch.empty((nb * (nb + 1) // 2, tile, tile), dtype=coarse_inv.dtype,
                        device=coarse_inv.device)
    t = 0
    for b in range(nb):
        rows = coarse_inv[b * tile:(b + 1) * tile, b * tile:]
        rows = torch.nn.functional.pad(rows, (0, (nb - b) * tile - rows.shape[1],
                                              0, tile - rows.shape[0]))
        tiles[t:t + nb - b] = rows.reshape(tile, nb - b, tile).transpose(0, 1)
        diag = tiles[t].triu()
        tiles[t] = diag + diag.triu(1).T
        t += nb - b
    return PackedCoarse(tiles, n)


def unpack_coarse(packed: PackedCoarse) -> torch.Tensor:
    """The symmetric (n, n) matrix of a :func:`pack_coarse` copy: each
    stored upper tile at (bi, bj) and its transpose at (bj, bi)."""
    tiles, n = packed
    ntiles, tile, _ = tiles.shape
    nb = -(-n // tile)
    if tiles.shape[2] != tile or ntiles != nb * (nb + 1) // 2:
        raise ValueError(f"unpack_coarse: tiles {tuple(tiles.shape)} for n = {n}")
    bi, bj = torch.triu_indices(nb, nb, device=tiles.device)  # row-major tile order
    grid = torch.empty((nb, nb, tile, tile), dtype=tiles.dtype, device=tiles.device)
    grid[bj, bi] = tiles.transpose(1, 2)
    grid[bi, bj] = tiles
    return grid.transpose(1, 2).reshape(nb * tile, nb * tile)[:n, :n]


def dense_coarse(coarse) -> torch.Tensor:
    """The dense matrix of a coarse inverse as a two-level preconditioner
    keeps it (dense on the CPU, :func:`pack_coarse`'s copy on the card): the
    one the plain versions and the library calls read, a packed copy's
    mirrored tiles."""
    return unpack_coarse(coarse) if isinstance(coarse, PackedCoarse) else coarse


def coarse_product_ref(coarse, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K4c: the dense product (:func:`dense_coarse`)."""
    return dense_coarse(coarse) @ x


def coarse_product(coarse, x: torch.Tensor) -> torch.Tensor:
    """K4c: ``Kc^-1 x`` for x (n,) or (n, m), m >= 1 (up to 8 columns a pass
    over the tiles; design and bound at the top of ``csrc/two_level.cu``).
    CPU tensors take the plain version, on the dense inverse or a packed
    copy; CUDA tensors launch the kernels on the packed copy
    (``coarse_product.launches``, by dtype and m, 1 for a vector, in
    ``coarse_product.shapes``)."""
    name = "coarse_product"
    if x.dim() not in (1, 2) or x.shape[0] != coarse.shape[0] or x.dim() == 2 and x.shape[1] < 1:
        raise ValueError(f"{name}: x {tuple(x.shape)}; expected (n,) or (n, m), m >= 1, with "
                         f"n = {coarse.shape[0]}")
    packed = isinstance(coarse, PackedCoarse)
    values = coarse.tiles if packed else coarse
    if values.device != x.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {values.device} and {x.device}; expected both on "
                         "the CPU or both on one CUDA device")
    if x.dtype not in (torch.float32, torch.float64) or values.dtype != x.dtype:
        raise TypeError(f"{name}: dtypes {values.dtype}/{x.dtype}; expected one of float32 or "
                        "float64")
    if x.device.type == "cpu":
        return coarse_product_ref(coarse, x)
    if not packed:
        raise TypeError(f"{name}: on CUDA the coarse inverse must be packed (kernels.pack_coarse)")
    build()
    out = torch.ops.fcvm.coarse_product(coarse.tiles, x.contiguous())
    coarse_product.launches += 1
    coarse_product.shapes[(_dtype_name(x), 1 if x.dim() == 1 else x.shape[1])] += 1
    return out


coarse_product.launches = 0
coarse_product.shapes = Counter()  # launches by (dtype name, m)


def two_level_apply_ref(pinv, qmat, coarse_inv, fixmask, r, z_fine=None):
    """Plain version of K4: the fine level (block Jacobi ``pinv r`` per
    node, or ``z_fine``), the projection of ``P r`` onto the cluster modes,
    the cluster sum, the coarse product in mode-major order (the dense
    inverse, or a packed copy's mirrored tiles), the prolongation and the
    mask."""
    coarse_inv = dense_coarse(coarse_inv)
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
      coarse_inv: the (nm ncl, nm ncl) symmetric coarse inverse,
        mode-major: on CUDA its packed copy (:func:`pack_coarse`), which K4c
        reads; on the CPU the dense matrix (any layout) or a packed copy.
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
    _two_level_on_cpu("two_level_apply", pinv, qmat, coarse_inv, fixmask, r, z_fine, nn)
    return two_level_apply_bound(pinv, qmat, coarse_inv, fixmask)(r, z_fine)


two_level_apply.launches = 0
two_level_apply.dtypes = Counter()  # launches by dtype name


def two_level_apply_bound(pinv, qmat, coarse_inv, fixmask):
    """K4 of one preconditioner, the checks of its operands made once:
    returns ``(r, z_fine=None) -> two_level_apply(pinv, qmat, coarse_inv,
    fixmask, r, z_fine)`` on vectors, which on the CPU takes the plain
    version and on the card launches K4 at once (the binding checks ``r``
    and ``z_fine``) and counts it in ``two_level_apply.launches``: the one
    place that launches K4."""
    nn = pinv.shape[0] if pinv.dim() == 3 else -1
    if (fixmask.shape != (3 * nn,) or pinv.shape != (nn, 3, 3) or qmat.dim() != 3
            or qmat.shape[1] != 3):
        raise ValueError(
            f"two_level_apply: shapes pinv {tuple(pinv.shape)}, qmat {tuple(qmat.shape)}, "
            f"fixmask {tuple(fixmask.shape)}; expected (nn, 3, 3), (ncl cs, 3, nm), (3 nn,)")
    if _two_level_on_cpu("two_level_apply", pinv, qmat, coarse_inv, fixmask, fixmask, None, nn):
        return lambda r, z_fine=None: two_level_apply_ref(pinv, qmat, coarse_inv, fixmask, r,
                                                          z_fine)
    build()
    op, tiles, ncf, name = (torch.ops.fcvm.two_level_apply, coarse_inv.tiles, coarse_inv.n,
                            _dtype_name(fixmask))

    def k4(r, z_fine=None):
        out = op(pinv, qmat, tiles, ncf, fixmask, r, z_fine)
        two_level_apply.launches += 1
        two_level_apply.dtypes[name] += 1
        return out

    return k4


def _two_level_on_cpu(name, pinv, qmat, coarse_inv, fixmask, r, z_fine, nn) -> bool:
    """Check the coarse space, devices, dtypes and layouts of K4's or K4m's
    inputs (their vector or block shapes checked by the caller): True for
    CPU tensors, False for one CUDA device, every input dense and the
    coarse inverse packed (:func:`pack_coarse`: K4c reads its tiles)."""
    nm = qmat.shape[2]
    ncl = coarse_inv.shape[0] // nm if nm else 0
    if (nm not in (6, 12) or ncl == 0 or tuple(coarse_inv.shape) != (nm * ncl, nm * ncl)
            or qmat.shape[0] % ncl or qmat.shape[0] < nn):
        raise ValueError(f"{name}: qmat {tuple(qmat.shape)} and coarse_inv "
                         f"{tuple(coarse_inv.shape)}; expected nm 6 or 12 modes on ncl clusters "
                         "that cover the nodes")
    packed = isinstance(coarse_inv, PackedCoarse)
    tensors = ((pinv, qmat, coarse_inv.tiles if packed else coarse_inv, fixmask, r)
               + (() if z_fine is None else (z_fine,)))
    cpu = all(t.device.type == "cpu" for t in tensors)
    if not cpu and (r.device.type != "cuda" or any(t.device != r.device for t in tensors)):
        raise ValueError(f"{name}: tensors on several devices; expected all on the CPU or all "
                         "on one CUDA device")
    if r.dtype not in (torch.float32, torch.float64) or any(t.dtype != r.dtype
                                                             for t in tensors):
        raise TypeError(f"{name}: expected float32 or float64 throughout")
    if not cpu and not packed:
        raise TypeError(f"{name}: on CUDA the coarse inverse must be packed "
                        "(kernels.pack_coarse)")
    if not cpu and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous (a column slice of a block is not)")
    return cpu


def two_level_apply_block_ref(pinv, qmat, coarse_inv, fixmask, r, z_fine=None):
    """Plain version of K4m: :func:`two_level_apply_ref`'s steps on the m
    columns of ``r`` (3 nn, m) at once, with a trailing column axis and the
    coarse product a GEMM."""
    coarse_inv = dense_coarse(coarse_inv)
    m = r.shape[1]
    z = z_fine
    if z is None:
        z = torch.einsum("nab,nbm->nam", pinv, r.reshape(-1, 3, m)).reshape(r.shape)
    nn_cl, _, nm = qmat.shape
    ncl = coarse_inv.shape[0] // nm
    cs = nn_cl // ncl
    r3 = (fixmask[:, None] * r).reshape(-1, 3, m)
    nn = r3.shape[0]
    r3p = torch.nn.functional.pad(r3, (0, 0, 0, 0, 0, nn_cl - nn))
    rc = torch.einsum("nak,nam->nkm", qmat, r3p).reshape(ncl, cs, nm, m).sum(dim=1)
    zc = coarse_inv @ rc.permute(1, 0, 2).reshape(nm * ncl, m)  # mode-major rows
    zc_n = zc.reshape(nm, ncl, m).permute(1, 0, 2).repeat_interleave(cs, dim=0)
    z2 = torch.einsum("nak,nkm->nam", qmat, zc_n)
    return z + z2[:nn].reshape(-1, m) * fixmask[:, None]


def two_level_apply_block(pinv, qmat, coarse_inv, fixmask, r, z_fine=None):
    """K4m: :func:`two_level_apply` on the m columns of a block at once
    (design and bound at the top of ``csrc/two_level.cu``).

    Args:
      pinv, qmat, coarse_inv, fixmask: as in :func:`two_level_apply`.
      r: (3 nn, m) block, row-major (a column slice is not: make it dense).
      z_fine: (3 nn, m) the fine level's output, or None for block Jacobi.

    Returns:
      (3 nn, m).  CPU tensors take the plain version; CUDA tensors launch
      the kernels (``two_level_apply_block.launches`` counts those calls,
      by dtype and m in ``two_level_apply_block.shapes``).
    """
    nn = r.shape[0] // 3 if r.dim() == 2 else -1
    if (r.dim() != 2 or r.shape[0] != 3 * nn or fixmask.shape != (3 * nn,)
            or pinv.shape != (nn, 3, 3) or qmat.dim() != 3 or qmat.shape[1] != 3
            or (z_fine is not None and z_fine.shape != r.shape)):
        raise ValueError(
            f"two_level_apply_block: shapes pinv {tuple(pinv.shape)}, qmat "
            f"{tuple(qmat.shape)}, r {tuple(r.shape)}; expected (nn, 3, 3), (ncl cs, 3, nm), "
            "(3 nn, m)")
    if _two_level_on_cpu("two_level_apply_block", pinv, qmat, coarse_inv, fixmask, r, z_fine,
                         nn):
        return two_level_apply_block_ref(pinv, qmat, coarse_inv, fixmask, r, z_fine)
    if r.shape[1] == 0:
        return torch.empty_like(r)
    build()
    out = torch.ops.fcvm.two_level_apply_block(pinv, qmat, coarse_inv.tiles, coarse_inv.n,
                                               fixmask, r, z_fine)
    two_level_apply_block.launches += 1
    two_level_apply_block.shapes[(_dtype_name(r), r.shape[1])] += 1
    return out


two_level_apply_block.launches = 0
two_level_apply_block.shapes = Counter()  # launches by (dtype name, m)


# K6's state: one float64 row of these slots a column of the solve, read and
# written by its passes alone (the order of csrc/cg_iteration.cu)
CG_SLOTS = ("rz", "alpha", "beta", "k", "rnorm", "best", "since", "run", "next", "tol", "gate",
            "stall_lim", "maxiter", "bnorm", "rtol", "atol")
(SLOT_RZ, SLOT_ALPHA, SLOT_BETA, SLOT_K, SLOT_RNORM, SLOT_BEST, SLOT_SINCE, SLOT_RUN, SLOT_NEXT,
 SLOT_TOL, SLOT_GATE, SLOT_STALL_LIM, SLOT_MAXITER, SLOT_BNORM, SLOT_RTOL,
 SLOT_ATOL) = range(len(CG_SLOTS))
CG_PASSES = ("update", "direction")  # K6's steps 0 and 1
CG_MAX_COLS = 64  # columns of a block solve (kMaxCols)
CG_MAX_DEFL = 32  # deflation vectors of a vector solve on the card (kMaxDefl)
CG_MAX_DEFL_BLOCK = 64  # deflation vectors of a block solve, on every device (kMaxDeflBlock)
CG_HELD = 8  # most items a thread keeps in registers across a pass's grid barrier (Many::held)


def cg_layout(grid: int, m: int, kd: int, n: int = 0, block: bool = False):
    """Offsets, in values, of K6's scratch regions for a grid of ``grid``
    blocks on ``m`` columns with ``kd`` deflation vectors (``block``: an (n,
    m) block, whose deflation keeps n m values of z), as the kernel lays
    them out (``layout_of`` in ``csrc/cg_iteration.cu``, through the op): the
    ``||r||^2`` partials, the ``W^T r`` partials, ``c``, the size (the r.z
    and p.ap partials at 0) and a deflated block's ``z``."""
    build()
    return tuple(torch.ops.fcvm.cg_layout(grid, m, kd, n, block))


def cg_grid(dtype: torch.dtype, n: int, m: int = 1, device=None, kd: int = 0,
            block: bool = False) -> int:
    """The blocks of K6's grid for an (n, m) solve of ``dtype`` on the CUDA
    ``device`` (default: the current one; ``block``: an (n, m) block,
    deflated by ``kd`` vectors): as many as stay resident on every SM for
    both passes (at most 4 an SM), and no more than one sweep of the items
    needs."""
    build()
    with torch.cuda.device(device):
        grid = torch.ops.fcvm.cg_grid(torch.empty(0, dtype=dtype).element_size(), n, m, kd,
                                      block)
    if grid < 1:
        raise RuntimeError(f"cg_grid: no resident grid for {dtype} n={n} m={m} kd={kd}")
    return grid


class CGPlan:
    """What K6 reads and writes of one CG solve beside its vectors, checked
    once (:func:`cg_plan`).

    Fields:
      state: (m, 16) float64, a row of ``CG_SLOTS`` a column (m = 1 for a
        vector solve) on the solve's device.
      w, kw_inv: the deflation basis (n, kd) and Galerkin pseudo-inverse
        (kd, kd), or None; on the card kd is a multiple of 4 (the basis and
        its inverse padded with zeros, :func:`cg_plan`).
      c: (kd,) ``kw_inv W^T r`` of the last direction pass, on a block (kd,
        m) ``kw_inv W^T R`` (on the card the update pass's; a view of the
        scratch, kd the padded one), or None.
      n, block: the solve's rows; whether its vectors are an (n, m) block.
      form: ``"vector"`` or ``"block"``, with ``" deflated"`` and ``"
        harvest"`` as the plan has them (:func:`cg_iteration` counts its
        launches by it).
      zs, coef: the harvest, (nstore, n) residuals and (3, nstore) rows
        r.z, alpha and beta, or None.
      scratch, barrier, grid: on the card the partial sums' scratch, the
        grid barrier's word and the passes' blocks (None on the CPU).
    """

    def __init__(self, state, w, kw_inv, zs, coef, scratch, barrier, c, grid=None, n=0,
                 block=False):
        self.state, self.w, self.kw_inv, self.zs, self.coef = state, w, kw_inv, zs, coef
        self.scratch, self.barrier, self.c, self.grid = scratch, barrier, c, grid
        self.n, self.block = n, block
        self.cpu = state.device.type == "cpu"
        self.dtype_name = None if scratch is None else _dtype_name(scratch)
        self.form = ("block" if block else "vector") + (" deflated" if w is not None else "") + (
            " harvest" if zs is not None else "")

    def read(self) -> list:
        """The state's rows on the host: the one read of the device a batch."""
        return self.state.tolist()

    def _c(self, scratch, m):
        """``c`` of this plan's deflation on ``m`` columns: on the card the
        view of ``scratch`` the kernel writes, on the CPU a new tensor."""
        if self.w is None:
            return None
        kd = self.w.shape[1]
        shape = (kd, m) if self.block else (kd,)
        if scratch is None:
            return torch.empty(shape, dtype=self.w.dtype)
        off = cg_layout(self.grid, m, kd, self.n, self.block)[2]
        return scratch[off:off + kd * m].view(shape)

    def select(self, cols) -> "CGPlan":
        """The plan of the columns ``cols`` (host ints) of a block solve: a
        copy of their state rows, the same deflation space, scratch,
        barrier and grid."""
        idx = torch.as_tensor(cols, dtype=torch.long, device=self.state.device)
        return CGPlan(self.state.index_select(0, idx), self.w, self.kw_inv, None, None,
                      self.scratch, self.barrier, self._c(self.scratch, len(cols)), self.grid,
                      self.n, self.block)

    def copy(self) -> "CGPlan":
        """A plan with copies of everything a pass writes (the state, the
        harvest, the scratch and ``c`` in it, the barrier), sharing the
        deflation space."""
        def clone(t):
            return None if t is None else t.clone()

        scratch = clone(self.scratch)
        if self.c is None:
            c = None
        elif scratch is None:
            c = self.c.clone()
        else:
            c = self._c(scratch, self.state.shape[0])
        return CGPlan(self.state.clone(), self.w, self.kw_inv, clone(self.zs), clone(self.coef),
                      scratch, clone(self.barrier), c, self.grid, self.n, self.block)


def cg_plan(b: torch.Tensor, rtol: float, atol: float, maxiter: int, stall_lim: int,
            defl=None, harvest=None) -> CGPlan:
    """K6's :class:`CGPlan` of a solve of ``b`` ((n,), or (n, m) with m <=
    ``CG_MAX_COLS`` for a block of independent solves): the state with the
    tolerances and ``||b||`` per column (no read of the device), and on the
    card the grid, sized once here to what stays resident, and its scratch.
    ``defl``: ``(w, kw_inv)`` of a deflation space ((n, kd); kd <=
    ``CG_MAX_DEFL`` for a vector on the card, <= ``CG_MAX_DEFL_BLOCK`` for a
    block on every device; on the card a kd that is not a multiple of 4 or a
    basis off 16-byte alignment is copied, padded with zero columns);
    ``harvest``: ``(zs, coef)``, (nstore, n) and (3, nstore), for a vector
    only."""
    if b.dim() not in (1, 2) or (b.dim() == 2 and not 1 <= b.shape[1] <= CG_MAX_COLS):
        raise ValueError(f"cg_plan: b {tuple(b.shape)}; expected (n,) or (n, m), 1 <= m <= "
                         f"{CG_MAX_COLS}")
    if b.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cg_plan: dtype {b.dtype}; expected float32 or float64")
    if b.device.type not in ("cpu", "cuda") or not b.is_contiguous():
        raise ValueError(f"cg_plan: b on {b.device}, contiguous {b.is_contiguous()}; expected "
                         "a dense b on the CPU or a CUDA device")
    n, m, cuda = b.shape[0], 1 if b.dim() == 1 else b.shape[1], b.is_cuda
    extra = ()
    block = b.dim() == 2
    if defl is not None:
        w, kw_inv = defl
        kd = w.shape[-1] if w.dim() == 2 else -1
        if (w.shape != (n, kd) or kw_inv.shape != (kd, kd) or kd < 1
                or (block and kd > CG_MAX_DEFL_BLOCK)
                or (cuda and not block and kd > CG_MAX_DEFL)):
            raise ValueError(f"cg_plan: deflation w {tuple(w.shape)}, kw_inv "
                             f"{tuple(kw_inv.shape)} for b {tuple(b.shape)}; expected w (n, kd) "
                             f"and kw_inv (kd, kd), kd <= {CG_MAX_DEFL} for a vector on the "
                             f"card, <= {CG_MAX_DEFL_BLOCK} for a block")
        extra += (w, kw_inv)
    if harvest is not None:
        zs, coef = harvest
        if (b.dim() != 1 or zs.dim() != 2 or zs.shape[1] != n or zs.shape[0] < 1
                or coef.shape != (3, zs.shape[0])):
            raise ValueError(f"cg_plan: harvest zs {tuple(zs.shape)}, coef {tuple(coef.shape)} "
                             f"for b {tuple(b.shape)}; expected a vector b (n,), zs (nstore, n) "
                             "and coef (3, nstore)")
        extra += (zs, coef)
    for t in extra:
        if t.device != b.device or t.dtype != b.dtype or not t.is_contiguous():
            raise ValueError("cg_plan: the deflation space and the harvest must be dense, on "
                             "b's device and of its dtype")
    state = torch.zeros((m, len(CG_SLOTS)), dtype=torch.float64, device=b.device)
    for slot, value in ((SLOT_RTOL, rtol), (SLOT_ATOL, atol), (SLOT_STALL_LIM, stall_lim),
                        (SLOT_MAXITER, maxiter)):
        state[:, slot] = float(value)  # fills on the device: no copy from the host
    state[:, SLOT_BNORM] = _col_norms(b).to(torch.float64)
    w, kw_inv = defl if defl is not None else (None, None)
    zs, coef = harvest if harvest is not None else (None, None)
    if not cuda:
        plan = CGPlan(state, w, kw_inv, zs, coef, None, None, None, n=n, block=block)
        plan.c = plan._c(None, m)
        return plan
    kd = 0 if w is None else w.shape[1]
    if kd % 4 or (w is not None and w.data_ptr() % 16):  # the kernel's layout
        kdp = -(-kd // 4) * 4
        w = torch.nn.functional.pad(w, (0, kdp - kd))
        kw_inv = torch.nn.functional.pad(kw_inv, (0, kdp - kd, 0, kdp - kd))
        kd = kdp
    grid = cg_grid(b.dtype, n, m, b.device, kd, block)
    scratch = torch.empty(cg_layout(grid, m, kd, n, block)[3], dtype=b.dtype, device=b.device)
    barrier = torch.zeros(1, dtype=torch.int32, device=b.device)
    plan = CGPlan(state, w, kw_inv, zs, coef, scratch, barrier, None, grid, n, block)
    plan.c = plan._c(scratch, m)
    return plan


def _col_dots(u, v):
    """(m,) the solver's inner products: ``torch.dot`` of vectors, column
    sums of the products of blocks."""
    return torch.dot(u, v).reshape(1) if u.dim() == 1 else (u * v).sum(dim=0)


def _col_norms(v):
    """(m,) ``torch.linalg.vector_norm`` of a vector or of each column."""
    if v.dim() == 1:
        return torch.linalg.vector_norm(v).reshape(1)
    return torch.linalg.vector_norm(v, dim=0)


def _per_col(values, like):
    """Host floats of each column as a tensor of ``like``'s dtype that
    scales ``like``: 0-d for a vector, (m,) for a block's rows."""
    t = torch.tensor(values, dtype=like.dtype, device=like.device)
    return t[0] if like.dim() == 1 else t


def _masked(run, like):
    """``run`` (host bools a column) as a mask over ``like``'s columns."""
    mask = torch.tensor(run, device=like.device)
    return mask[0] if like.dim() == 1 else mask


def _cond(row) -> float:
    """The JAX ``while_loop``'s cond on a state row after its update, in
    float64 (the kernel's ``cond_of``)."""
    rn = row[SLOT_RNORM]
    stalled = row[SLOT_SINCE] >= row[SLOT_STALL_LIM] and rn < row[SLOT_GATE]
    return 1.0 if rn > row[SLOT_TOL] and row[SLOT_K] < row[SLOT_MAXITER] and not stalled else 0.0


def cg_update_r(r, ap, alpha, run) -> None:
    """``r -= alpha ap`` in place on the columns whose ``run`` is true
    (``alpha``, ``run``: host values a column): the plain version's update,
    which the kernel's rounds as (a product, then a difference)."""
    alpha = _per_col(alpha, r)
    if all(run):
        r.sub_(alpha * ap)
    else:
        r.copy_(torch.where(_masked(run, r), r - alpha * ap, r))


def cg_update_direction(x, p, z, alpha, beta, run) -> None:
    """``x += alpha p`` and ``p = z + beta p`` in place on the columns whose
    ``run`` is true (host values a column): the plain version's updates,
    each rounded as a product, then a sum, as the kernel's."""
    alpha, beta = _per_col(alpha, x), _per_col(beta, p)
    if all(run):
        x.add_(alpha * p)
        p.copy_(z + beta * p)
    else:
        mask = _masked(run, p)
        x.copy_(torch.where(mask, x + alpha * p, x))
        p.copy_(torch.where(mask, z + beta * p, p))


def cg_iteration_ref(step: int, start: bool, plan: CGPlan, x, r, p, v) -> None:
    """Plain version of K6's pass ``step`` on ``plan``, in place: the
    parent's torch chain (``torch.dot`` or column sums, the step length and
    direction update with their zero guards, the updates, ``vector_norm``,
    ``W (K_w^+ (W^T r))``, on a block ``W (K_w^+ (W^T R))``: the products
    and the sum of ``deflation.deflated`` in its order, so a deflated block
    solve has the bits of one with that wrapped preconditioner), the scalar
    tail on the host in float64 (a read of the state on the card), each
    column frozen once its ``run`` is 0.  ``v`` is ``ap`` in step 0, ``z``
    in step 1 (not written)."""
    state = plan.state
    rows = state.tolist()
    if step == 0:  # p.ap; run = next; alpha; r -= alpha ap (start: nothing)
        if start:
            return
        nxt = [row[SLOT_NEXT] for row in rows]
        if any(nxt):
            pap = _col_dots(p, v)
            rz = torch.tensor([row[SLOT_RZ] for row in rows], dtype=p.dtype, device=p.device)
            alpha = (rz / torch.where(pap == 0.0, torch.ones_like(pap), pap)).tolist()
            for row, go, a in zip(rows, nxt, alpha):
                if go:
                    row[SLOT_ALPHA] = a
        for row, go in zip(rows, nxt):
            row[SLOT_RUN] = go
        run = [bool(go) for go in nxt]
        if any(run):
            cg_update_r(r, v, [row[SLOT_ALPHA] for row in rows], run)
    else:  # ||r||, the test, c; z + W c; r.z; beta; x, p; the harvest's slots
        run = [True] * len(rows) if start else [bool(row[SLOT_RUN]) for row in rows]
        if not any(run):
            return
        rnorm = _col_norms(r).tolist()
        for row, go, rn in zip(rows, run, rnorm):
            if start:
                bn = row[SLOT_BNORM]
                row[SLOT_K] = row[SLOT_SINCE] = 0.0
                row[SLOT_BEST] = rn
                row[SLOT_TOL] = max(row[SLOT_RTOL] * bn, row[SLOT_ATOL])
                row[SLOT_GATE] = 1.0e-3 * bn
                row[SLOT_RUN] = 1.0
            elif go:
                row[SLOT_K] += 1.0
                row[SLOT_SINCE] = 0.0 if rn < 0.999 * row[SLOT_BEST] else row[SLOT_SINCE] + 1.0
                row[SLOT_BEST] = min(row[SLOT_BEST], rn)
            else:
                continue
            row[SLOT_RNORM] = rn
            row[SLOT_NEXT] = _cond(row)
        z = v
        if plan.w is not None:
            plan.c.copy_(plan.kw_inv @ (plan.w.T @ r))
            z = v + plan.w @ plan.c
        rz_new = _col_dots(r, z)
        if start:
            for row, rz in zip(rows, rz_new.tolist()):
                row[SLOT_RZ] = rz
            p.copy_(z)
        else:
            rz = torch.tensor([row[SLOT_RZ] for row in rows], dtype=r.dtype, device=r.device)
            beta = (rz_new / torch.where(rz == 0.0, torch.ones_like(rz), rz)).tolist()
            for row, go, bt, rzn in zip(rows, run, beta, rz_new.tolist()):
                if go:
                    row[SLOT_BETA], row[SLOT_RZ] = bt, rzn
            cg_update_direction(x, p, z, [row[SLOT_ALPHA] for row in rows],
                                [row[SLOT_BETA] for row in rows], run)
        if plan.zs is not None:
            cap = plan.zs.shape[0] - 1
            row = rows[0]
            k = int(row[SLOT_K])
            plan.zs[min(k, cap)] = z
            plan.coef[0, min(k, cap)] = row[SLOT_RZ]
            if not start:
                plan.coef[1:, min(k - 1, cap)] = torch.tensor(
                    [row[SLOT_ALPHA], row[SLOT_BETA]], dtype=plan.coef.dtype)
    state.copy_(torch.tensor(rows, dtype=torch.float64))


def cg_iteration(step: int, plan: CGPlan, x, r, p, v, start: bool = False) -> None:
    """K6: pass ``step`` (0 or 1, ``CG_PASSES``) of a CG iteration on the
    vectors of ``plan``'s solve, in place (design and bound at the top of
    ``csrc/cg_iteration.cu``):

    0. the update, between ``ap = K p`` and ``z = M r``: ``p.ap``; ``run =
       next``; ``alpha = rz / (pap == 0 ? 1 : pap)``; ``r -= alpha ap``
       (``start``: nothing but, on the card, the partial sums of ``r0``);
       on the card a deflated block's ``c = K_w^+ W^T R`` too;
    1. the direction: ``||r||``, ``k``, ``best``, ``since`` and ``next``,
       the loop's test on this ``r``; with a deflation space ``c = K_w^+
       W^T r`` (a block's from the update pass) and ``z + W c`` in place of
       ``z`` (``z`` itself is not written); ``r.z``; ``beta``; ``x += alpha
       p``, ``p = z + beta p``; a harvest's slot ``min(k, nstore - 1)``
       (``start``: the tolerance and gate from ``||b||``, ``rz``, ``p = z``
       and slot 0).

    A column whose ``run`` is 0 is left as it is.  Args: x, r, p, v of one
    shape, (n,) or (n, m), dense, of ``plan``'s dtype and device; ``v`` is
    ``ap`` in step 0, ``z`` in step 1; a tensor a step does not read may be
    any of them.  CPU tensors take the plain version
    (:func:`cg_iteration_ref`); CUDA tensors launch the kernel, a
    cooperative launch of the plan's resident grid (``cg_iteration.launches``,
    by dtype in ``dtypes``, by pass in ``passes`` and by the plan's form in
    ``forms``), whose sums run in a fixed order; a launch the card refuses
    raises.  A deflated block runs its folded form at every width: no
    torch product."""
    if plan.cpu:
        cg_iteration_ref(step, start, plan, x, r, p, v)
        return
    err = torch.ops.fcvm.cg_pass(step, start, plan.state, plan.scratch, plan.barrier, x, r, p,
                                 v, plan.w, plan.kw_inv, plan.zs, plan.coef, plan.grid)
    if err:
        raise RuntimeError(f"cg_iteration: the cooperative launch of {plan.grid} blocks of pass "
                           f"{CG_PASSES[step]!r} failed: {torch.ops.fcvm.cuda_error(err)}")
    cg_iteration.launches += 1
    cg_iteration.dtypes[plan.dtype_name] += 1
    cg_iteration.passes[CG_PASSES[step]] += 1
    cg_iteration.forms[plan.form] += 1


cg_iteration.launches = 0
cg_iteration.dtypes = Counter()  # launches by dtype name
cg_iteration.passes = Counter()  # launches by pass name (CG_PASSES)
cg_iteration.forms = Counter()  # launches by the plan's form (CGPlan.form)


# -- K2: the stress update and internal force ------------------------------------

def element_table(elnodes: torch.Tensor) -> torch.Tensor:
    """K2's node table of the connectivity ``elnodes`` (ne, 10): (10, ne)
    int32, element-major (the layout of K1's ``NodeIncidence.elnodes_t``),
    so neighbouring lanes read neighbouring elements' ids.  A backend makes
    it once."""
    if elnodes.dim() != 2 or elnodes.shape[1] != 10:
        raise ValueError(f"element_table: elnodes {tuple(elnodes.shape)}; expected (ne, 10)")
    return elnodes.t().to(torch.int32).contiguous()


def stress_update_ref(coords, elnodes, disp, sig, large_disp=False, *, du=None, dmat=None,
                      sig_yield=None, g=None, h=None, weights=None, table=None):
    """Plain version of K2's element pass, the torch chain it replaced: B
    (ne, 4, 6, 30) at every Gauss point, ``deps = B du``, under
    ``large_disp`` the convected ``F sig F^T / det F``, the trial stress and
    the radial return, and ``elv = sum_g B^T sig w |J|`` (times
    ``weights``).  Arguments and results as :func:`stress_update` (the
    kernel's node ``table`` is not read)."""
    coords_el = coords[elnodes]
    if large_disp:
        coords_el = coords_el + disp.reshape(-1, 3)[elnodes]
    det, dshpg, bmat = el.tet10_element_geometry(coords_el)
    w = torch.as_tensor(el.W10, dtype=coords_el.dtype, device=coords_el.device)
    scale = w * det.abs()
    if du is not None:
        du_el = du.reshape(-1, 3)[elnodes]  # (ne, 10, 3)
        deps = torch.einsum("egkn,en->egk", bmat, du_el.reshape(-1, 30))  # (ne, 4, 6)
        sig_c = sig
        if large_disp:
            # incremental deformation gradient on the start-of-step deformed
            # configuration (fcVM.py:2396-2414): F[a, b] = d_ab + sum_i du_ia dN_i/dx_b
            f = torch.eye(3, dtype=du.dtype, device=du.device) + torch.einsum(
                "eia,egbi->egab", du_el, dshpg)
            s_conv = torch.einsum("egij,egjl,egkl->egik", f, mat.voigt_to_tensor(sig), f)
            sig_c = mat.tensor_to_voigt(s_conv / det3(f)[..., None, None])
        sig_test = sig_c + mat.apply_dmat(dmat, deps)
        sig, pgp = mat.radial_return(sig_test, sig_yield, h, g)
    elv = torch.einsum("egkn,egk,eg->en", bmat, sig, scale)
    if weights is not None:
        elv = elv * weights[:, None]
    return elv if du is None else (sig, sig_test, pgp, elv)


def _per_element(x, ne: int, like: torch.Tensor, name="stress_update") -> torch.Tensor:
    """A material constant (a number, or a (ne,) or (ne, 1) tensor of
    ``like``'s dtype) as a contiguous (ne,) tensor."""
    if torch.is_tensor(x) and x.dtype != like.dtype:
        raise TypeError(f"{name}: a material tensor of {x.dtype}; expected {like.dtype}")
    t = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    if t.numel() not in (1, ne):
        raise ValueError(f"{name}: a material tensor of shape {tuple(t.shape)}; "
                         f"expected one value or {ne}")
    return t.reshape(-1).expand(ne).contiguous()


def _k2_materials(g, h, ne: int, like: torch.Tensor):
    """The element pass's moduli: ``(g, h3g, g_s, h3g_s)``, H + 3 G as
    radial_return forms it, (ne,) tensors where either is a tensor, else
    numbers (and None)."""
    if torch.is_tensor(g) or torch.is_tensor(h):
        return _per_element(g, ne, like), _per_element(h + 3.0 * g, ne, like), 0.0, 0.0
    return None, None, float(g), float(h + 3.0 * g)


def _k2_table(elnodes, table, like, name="stress_update"):
    """K2's (and K3's) node table on the card: ``table`` checked against
    ``elnodes``'s shape and ``like``'s device, or made from ``elnodes``."""
    if table is None:
        return element_table(elnodes)
    if (table.dtype != torch.int32 or table.device != like.device
            or table.shape != (10, elnodes.shape[0]) or not table.is_contiguous()):
        raise ValueError(f"{name}: a node table {tuple(table.shape)} {table.dtype} on "
                         f"{table.device}; expected element_table(elnodes) on {like.device}")
    return table


def _element_pass(coords, table, disp, du, sig, sig_yield, dmat, mats, weights, large_disp):
    """Launch K2's element pass (the binding checks the tensors) and count it."""
    out = torch.ops.fcvm.stress_update(coords, table, disp, du, sig, sig_yield, dmat, *mats,
                                       weights, bool(large_disp))
    stress_update.launches += 1
    stress_update.dtypes[_dtype_name(coords)] += 1
    stress_update.forms[("given" if du is None else "update") + (" gnl" if large_disp else "")] += 1
    return out


def stress_update(coords, elnodes, disp, sig, large_disp=False, *, du=None, dmat=None,
                  sig_yield=None, g=None, h=None, weights=None, table=None):
    """K2's element pass: the stress update of every Gauss point and each
    element's rows of the internal force, on the element's 10 nodes (design
    and bound at the top of ``csrc/stress_update.cu``); the node sum is the
    caller's (:func:`node_force`).

    Args:
      coords: (nn, 3) nodal coordinates, float32 or float64.
      elnodes: (ne, 10) int64 connectivity.
      disp: (3 n,) step-start displacement, read only with ``large_disp``
        (the deformed configuration; without it neither its dtype nor its
        device is checked); n at least nn.
      sig: (ne, 4, 6) the step-start stress ``sig_old``, or, without
        ``du``, the given stress whose internal force is wanted.
      du: (3 n,) the step's displacement increment; None for the
        given-stress form.
      dmat: (6, 6) or per-element (ne, 6, 6) elasticity; sig_yield (ne, 4);
        g, h: the shear and hardening moduli, numbers or per-element
        tensors (ne,) or (ne, 1) (read with ``du`` only).
      weights: optional (ne,) scale of each element's rows.
      table: the :func:`element_table` of ``elnodes`` (made here on the
        card when not given; a backend makes it once).

    Returns:
      With ``du``: (sig_new, sig_test, pgp, elv): (ne, 4, 6) twice, (ne, 4)
      bool, (ne, 30); without: elv.  CPU tensors take the plain version;
      CUDA tensors launch the kernel or raise (``stress_update.launches``
      counts the launches, ``.dtypes`` and ``.forms`` them by dtype and by
      form).
    """
    given = du is None
    if not large_disp:
        disp = None  # unread: a float64 disp of the refinement tier may come with it
    tensors = [t for t in (coords, elnodes, sig, disp, du, dmat, sig_yield, g, h, weights)
               if torch.is_tensor(t)]
    if all(t.device.type == "cpu" for t in tensors):
        return stress_update_ref(coords, elnodes, disp, sig, large_disp, du=du, dmat=dmat,
                                 sig_yield=sig_yield, g=g, h=h, weights=weights)
    if coords.device.type != "cuda" or any(t.device != coords.device for t in tensors):
        raise ValueError("stress_update: tensors on several devices; expected all on the CPU "
                         "or all on one CUDA device")
    floats = [t for t in (coords, sig, disp, du, dmat, sig_yield, g, h, weights)
              if torch.is_tensor(t)]
    if (coords.dtype not in (torch.float32, torch.float64)
            or any(t.dtype != coords.dtype for t in floats) or elnodes.dtype != torch.int64):
        raise TypeError(f"stress_update: dtypes {[str(t.dtype) for t in floats]}, elnodes "
                        f"{elnodes.dtype}; expected one of float32 or float64, elnodes int64")
    if large_disp and disp is None:
        raise ValueError("stress_update: large_disp reads disp")
    if not given and any(v is None for v in (dmat, sig_yield, g, h)):
        raise ValueError("stress_update: the update reads dmat, sig_yield, g and h")
    if elnodes.dim() != 2 or elnodes.shape[1] != 10:
        raise ValueError(f"stress_update: elnodes {tuple(elnodes.shape)}; expected (ne, 10)")
    ne = elnodes.shape[0]
    mats = (None, None, 0.0, 0.0) if given else _k2_materials(g, h, ne, coords)
    build()
    out = _element_pass(coords, _k2_table(elnodes, table, coords), disp, du, sig, sig_yield,
                        dmat, mats, weights, large_disp)
    return out[0] if given else tuple(out)


stress_update.launches = 0
stress_update.dtypes = Counter()  # launches by dtype name
stress_update.forms = Counter()  # launches by form ("update", "given", each " gnl")


def node_force_ref(elv: torch.Tensor, plan: SegmentPlan, rows: int) -> torch.Tensor:
    """Plain version of K2's node pass, the internal force: K8's plain
    version of the write form on ``elv``'s 3-wide rows, flattened."""
    return segment_sum_ref(elv.reshape(-1, 3).contiguous(), plan, rows=rows).reshape(-1)


def _node_plan_checks(name, plan, rows, nrows, device):
    if plan.keys.shape[0] != nrows or not plan.top <= rows < 2**31:
        raise ValueError(f"{name}: {nrows} element rows, {rows} output rows, a plan of "
                         f"{plan.keys.shape[0]} keys needing {plan.top} rows; expected a key for "
                         "each row, every key below the output's rows")
    if device.type == "cuda" and (plan.rows != rows or plan.holes is None):
        raise ValueError(f"{name}: the node pass on the card needs a write-form plan built with "
                         f"rows = {rows}")


def node_force(elv: torch.Tensor, plan: SegmentPlan, *, rows: int) -> torch.Tensor:
    """K2's node pass, the internal force: ``qin`` (3 rows,), element
    ``elv``'s 3-wide rows (ne, 30) summed into the node rows ``plan`` names,
    each in the plan's fixed order from zero, and 0 in the rows it does not
    name: K8's write form's bits (design at the top of
    ``csrc/stress_update.cu``).

    ``plan``: the :class:`SegmentPlan` of the rows' node keys, built with
    ``rows`` on the card.  CPU tensors take the plain version
    (:func:`node_force_ref`); CUDA tensors launch the kernel or raise
    (``node_force.launches`` counts the launches, ``.dtypes`` and
    ``.forms`` them by dtype and form: "force" here, "residual" by
    :func:`stress_residual_bound`)."""
    _node_plan_checks("node_force", plan, rows, elv.numel() // 3, elv.device)
    if elv.device.type == "cpu":
        if any(t.device.type != "cpu" for t in (plan.keys, plan.order)):
            raise ValueError("node_force: tensors on several devices; expected all on the CPU "
                             "or all on one CUDA device")
        return node_force_ref(elv, plan, rows)
    if elv.device.type != "cuda":
        raise ValueError(f"node_force: elv on {elv.device}; expected the CPU or a CUDA device")
    build()
    (qin,) = torch.ops.fcvm.node_force(elv, plan.order, plan.offsets, plan.segs, plan.holes,
                                       rows, None, None, None, 0.0, 1.0, 1.0)
    node_force.launches += 1
    node_force.dtypes[_dtype_name(elv)] += 1
    node_force.forms["force"] += 1
    return qin


node_force.launches = 0
node_force.dtypes = Counter()  # launches by dtype name
node_force.forms = Counter()  # launches by form ("force", "residual")


def stress_residual_ref(coords, elnodes, disp, du, sig_old, sig_yield, glv, fixmask, lbd1,
                        qnorm, large_disp=False, relax=1.0, *, dmat, g, h, plan, weights=None):
    """Plain version of :func:`stress_residual_bound`, the chain the residual ran
    before its node pass: the element pass's plain version, K8's (the write
    form into ``disp``'s node rows), then ``r = fixmask (lbd1 glv - qin)``
    and its norm as torch steps; ``lbd1`` a number or a tensor, taken in
    ``glv``'s dtype."""
    sig_new, sig_test, pgp, elv = stress_update_ref(
        coords, elnodes, disp if large_disp else None, sig_old, large_disp, du=du, dmat=dmat,
        sig_yield=sig_yield, g=g, h=h, weights=weights)
    qin = segment_sum_ref(elv.reshape(-1, 3).contiguous(), plan,
                          rows=disp.shape[0] // 3).reshape(-1)
    lbd1 = torch.as_tensor(lbd1, dtype=torch.float64, device=glv.device).to(glv.dtype)
    r = fixmask * (lbd1 * glv - qin)
    error = torch.linalg.vector_norm(r) / qnorm
    return sig_new, sig_test, pgp, qin, relax * r, error


def stress_residual_bound(elnodes, plan: SegmentPlan, fixmask, dmat, g, h, *, weights=None,
                          table=None):
    """K2's two passes for one mesh, material and Dirichlet mask, their
    checks made once: returns ``k2(coords, disp, du, sig_old, sig_yield,
    glv, lbd1, qnorm, large_disp=False, relax=1.0)``, which computes the
    stress update and the out-of-balance residual

        (sig_new, sig_test, pgp, qin, relax r, error),
        r = fixmask (lbd1 glv - qin),  error = ||r|| / qnorm (0-dim),

    on the CPU by the plain version (:func:`stress_residual_ref`), on the
    card in two launches: the element pass and the node pass's residual form,
    ``lbd1``, ``relax`` and ``qnorm`` passed as kernel scalars (no copy to
    the card).  ``plan`` is the write-form :class:`SegmentPlan` of the
    element rows' node keys over ``fixmask``'s node rows; ``dmat``, ``g``,
    ``h``, ``weights`` as for :func:`stress_update`; ``table`` its
    :func:`element_table` (made here on the card when not given).  Each
    launch is counted by its pass's wrapper (``stress_update`` and
    ``node_force``, form "residual")."""
    static = [t for t in (elnodes, fixmask, dmat, g, h, weights, table, plan.keys, plan.order)
              if torch.is_tensor(t)]
    if all(t.device.type == "cpu" for t in static):
        def plain(coords, disp, du, sig_old, sig_yield, glv, lbd1, qnorm, large_disp=False,
                  relax=1.0):
            return stress_residual_ref(coords, elnodes, disp, du, sig_old, sig_yield, glv,
                                       fixmask, lbd1, qnorm, large_disp, relax, dmat=dmat, g=g,
                                       h=h, plan=plan, weights=weights)

        return plain
    dev = fixmask.device
    if dev.type != "cuda" or any(t.device != dev for t in static):
        raise ValueError("stress_residual_bound: tensors on several devices; expected all on "
                         "the CPU or all on one CUDA device")
    dtype = fixmask.dtype
    floats = [t for t in (dmat, g, h, weights) if torch.is_tensor(t)]
    if dtype not in (torch.float32, torch.float64) or any(t.dtype != dtype for t in floats):
        names = [str(t.dtype) for t in [fixmask, *floats]]
        raise TypeError(f"stress_residual_bound: dtypes {names}; expected one of float32 or "
                        "float64")
    if elnodes.dim() != 2 or elnodes.shape[1] != 10 or elnodes.dtype != torch.int64:
        raise ValueError(f"stress_residual_bound: elnodes {tuple(elnodes.shape)} {elnodes.dtype}; "
                         "expected (ne, 10) int64")
    rows = fixmask.shape[0] // 3
    if fixmask.dim() != 1 or fixmask.shape[0] != 3 * rows or not fixmask.is_contiguous():
        raise ValueError(f"stress_residual_bound: fixmask {tuple(fixmask.shape)}; expected a "
                         "contiguous (3 rows,)")
    ne = elnodes.shape[0]
    _node_plan_checks("stress_residual_bound", plan, rows, 10 * ne, dev)
    table = _k2_table(elnodes, table, fixmask)
    mats = _k2_materials(g, h, ne, fixmask)
    tables = (plan.order, plan.offsets, plan.segs, plan.holes)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)  # the node pass's, 0 between launches
    name = _dtype_name(fixmask)
    build()
    node_op = torch.ops.fcvm.node_force

    def k2(coords, disp, du, sig_old, sig_yield, glv, lbd1, qnorm, large_disp=False,
           relax=1.0):
        sig_new, sig_test, pgp, elv = _element_pass(
            coords, table, disp if large_disp else None, du, sig_old, sig_yield, dmat, mats,
            weights, large_disp)
        qin, r, error = node_op(elv, *tables, rows, glv, fixmask, ticket, float(lbd1),
                                float(relax), float(qnorm))
        node_force.launches += 1
        node_force.dtypes[name] += 1
        node_force.forms["residual"] += 1
        return sig_new, sig_test, pgp, qin, r, error

    return k2


# -- K3: the element stiffness blocks ---------------------------------------------

FORMS = ("elastic", "tangent", "geometric")  # K3's forms: its kernel's form 0, 1, 2
DIAG = 8  # values of the compact diagonal an incidence: the 6 upper ones and 2 zeros
_UPPER3 = ((0, 0, 0, 1, 1, 2), (0, 1, 2, 1, 2, 2))  # a 3x3 block's upper values, row-major
_FORM_READS = {"elastic": ("dmat",), "tangent": ("dmat", "sig", "pgp", "g", "h"),
               "geometric": ("sig",)}


def _element_blocks(form, coords, elnodes, dmat, sig, pgp, g, h):
    """The torch chain of the element blocks (ne, 30, 30) of the elements
    ``elnodes`` on ``coords``: B (ne, 4, 6, 30) at every Gauss point, then
    ``sum_g B^T D_g B w |J|`` by einsum (elastic, tangent) or ``sum_g w |J|
    (dN^T sigma dN) (x) I_3`` (geometric)."""
    det, dshpg, bmat = el.tet10_element_geometry(coords[elnodes])
    scale = torch.as_tensor(el.W10, dtype=coords.dtype, device=coords.device) * det.abs()
    if form == "geometric":
        m = torch.einsum("egij,egik,egkl,eg->ejl", dshpg, mat.voigt_to_tensor(sig), dshpg, scale)
        eye3 = torch.eye(3, dtype=coords.dtype, device=coords.device)
        return torch.einsum("ejl,bc->ejblc", m, eye3).reshape(-1, 30, 30)
    if form == "elastic":
        db = mat.apply_dmat(dmat, bmat)
    else:
        dev, _, svm = mat.von_mises(sig)
        svm = torch.where(svm == 0.0, torch.ones_like(svm), svm)
        g, h = mat.per_gauss(g), mat.per_gauss(h)
        g3fac = 3.0 * g / (1.0 + h / (3.0 * g))
        fac = torch.where(pgp, g3fac / svm**2, torch.zeros_like(svm))
        dmat_e = dmat if dmat.dim() == 2 else dmat[:, None]
        dmat_g = dmat_e - fac[..., None, None] * dev[..., :, None] * dev[..., None, :]
        db = torch.einsum("egkl,egln->egkn", dmat_g, bmat)
    return torch.einsum("egkm,egkn,eg->emn", bmat, db, scale)


def diag_sectors(esm_t: torch.Tensor) -> torch.Tensor:
    """K3's compact diagonal of element-major blocks ``esm_t`` (30, 30, ne):
    (10, ne, ``DIAG``), row ``[slot, e]`` (incidence ``slot ne + e``) the 6
    upper values of element ``e``'s diagonal block (slot, slot), row-major,
    then 2 zeros (one 32-byte sector in float32).  Plain indexing."""
    ne = esm_t.shape[2]
    idx = torch.arange(10, device=esm_t.device)
    blocks = esm_t.reshape(10, 3, 10, 3, ne)[idx, :, idx]  # (10, 3, 3, ne)
    out = esm_t.new_zeros((10, ne, DIAG))
    out[:, :, :6] = blocks[:, _UPPER3[0], _UPPER3[1]].transpose(1, 2)
    return out


def form_blocks_ref(form, coords, elnodes, *, disp=None, dmat=None, sig=None, pgp=None, g=None,
                    h=None, weights=None, perm=None, table=None, full=True, packed=False,
                    diag=False):
    """Plain version of K3, the torch chain it replaced (the einsums of
    :func:`_element_blocks` on the elements ``elnodes[perm]``, each
    per-element input gathered with them; the blocks times ``weights``;
    :func:`pack_blocks`; :func:`diag_sectors`).  Arguments and results as
    :func:`form_blocks` (``table`` is not read); the element-major blocks
    are a (30, 30, ne) view of the chain's (ne, 30, 30) output."""
    if form not in FORMS:
        raise ValueError(f"form_blocks: form {form!r}; expected one of {FORMS}")

    def rows(x, dims):  # a per-element input in the output's element order
        return x[perm] if perm is not None and torch.is_tensor(x) and x.dim() == dims else x

    if disp is not None:
        coords = coords + disp.reshape(-1, 3)[: coords.shape[0]]
    esm = _element_blocks(form, coords, rows(elnodes, 2), rows(dmat, 3), rows(sig, 3),
                          rows(pgp, 2), rows(g, 1), rows(h, 1))
    if weights is not None:
        esm = esm * rows(weights, 1)[:, None, None]
    esm_t = esm.permute(1, 2, 0)
    return ((esm_t if full else None), (pack_blocks(esm_t) if packed else None),
            (diag_sectors(esm_t) if diag else None))


def form_blocks(form, coords, elnodes, *, disp=None, dmat=None, sig=None, pgp=None, g=None,
                h=None, weights=None, perm=None, table=None, full=True, packed=False,
                diag=False):
    """K3: the element stiffness blocks of one ``form`` (design and bound at
    the top of ``csrc/form_blocks.cu``).

    Args:
      form: "elastic" (``sum_g B^T D B w |J|``), "tangent" (``D_g = D - fac
        s s^T`` at the plastic points, ``fac = 3G / (1 + H/3G) / svm^2``,
        ``svm = 0`` read as 1) or "geometric" (``sum_g w |J| (dN^T sigma
        dN) (x) I_3``).
      coords: (nn, 3) nodal coordinates, float32 or float64; ``disp`` (3 n,),
        when given, moves them (the tangent's deformed geometry, never
        materialised on the card).
      elnodes: (nt, 10) int64 connectivity of the input elements; ``table``
        its :func:`element_table` (made here on the card when not given).
      dmat: (6, 6) or per input element (nt, 6, 6) (elastic, tangent);
        sig (nt, 4, 6) (the step-start stress of the tangent, the
        pre-stress of the geometric form); pgp (nt, 4) bool and g, h the
        shear and hardening moduli, numbers or (nt,) tensors (tangent);
        weights (nt,) scales each element's block.
      perm: (ne,) int64, the input element of each output element (the
        solve space's ``eperm``); None: the input order.
      full: return the element-major blocks (30, 30, ne); packed: return
        K1's packed tiles (:func:`pack_blocks`'s layout); diag: return the
        compact diagonal (10, ne, ``DIAG``) that K5 reads
        (:func:`diag_sectors`'s layout); at least one.

    Returns:
      (esm_t, packed, diag), each None where not asked.  CPU tensors take the
      plain version (:func:`form_blocks_ref`); CUDA tensors launch the kernel
      or raise (``form_blocks.launches`` counts the launches, ``.dtypes``
      and ``.forms`` them by dtype and form, ``.outputs`` the launches that
      wrote each output).  The card writes only the upper triangles, so its
      blocks are exactly symmetric.
    """
    if form not in FORMS:
        raise ValueError(f"form_blocks: form {form!r}; expected one of {FORMS}")
    if not (full or packed or diag):
        raise ValueError("form_blocks: no output asked for: full, packed or diag")
    given = dict(dmat=dmat, sig=sig, pgp=pgp, g=g, h=h)
    missing = [k for k in _FORM_READS[form] if given[k] is None]
    if missing:
        raise ValueError(f"form_blocks: the {form} form reads {missing}")
    tensors = [t for t in (coords, elnodes, disp, dmat, sig, pgp, g, h, weights, perm, table)
               if torch.is_tensor(t)]
    if all(t.device.type == "cpu" for t in tensors):
        return form_blocks_ref(form, coords, elnodes, disp=disp, dmat=dmat, sig=sig, pgp=pgp,
                               g=g, h=h, weights=weights, perm=perm, full=full, packed=packed,
                               diag=diag)
    if coords.device.type != "cuda" or any(t.device != coords.device for t in tensors):
        raise ValueError("form_blocks: tensors on several devices; expected all on the CPU or "
                         "all on one CUDA device")
    floats = [t for t in (coords, disp, dmat, sig, g, h, weights) if torch.is_tensor(t)]
    if coords.dtype not in PACK_TILE or any(t.dtype != coords.dtype for t in floats):
        raise TypeError(f"form_blocks: dtypes {[str(t.dtype) for t in floats]}; expected one "
                        "of float32 or float64")
    if (elnodes.dtype != torch.int64 or (perm is not None and perm.dtype != torch.int64)
            or (form == "tangent" and pgp.dtype != torch.bool)):
        raise TypeError("form_blocks: elnodes and perm must be int64, pgp bool")
    if elnodes.dim() != 2 or elnodes.shape[1] != 10 or (perm is not None and perm.dim() != 1):
        raise ValueError(f"form_blocks: elnodes {tuple(elnodes.shape)}, perm "
                         f"{None if perm is None else tuple(perm.shape)}; expected (nt, 10) "
                         "and (ne,)")
    nt = elnodes.shape[0]
    gt = ht = None
    g3fac = 0.0
    if form == "tangent":
        if torch.is_tensor(g) or torch.is_tensor(h):
            gt, ht = (_per_element(x, nt, coords, "form_blocks") for x in (g, h))
        else:
            g3fac = 3.0 * float(g) / (1.0 + float(h) / (3.0 * float(g)))
    reads = _FORM_READS[form]
    build()
    out = torch.ops.fcvm.form_blocks(
        FORMS.index(form), coords, None if disp is None else disp.contiguous(),
        _k2_table(elnodes, table, coords, "form_blocks"), perm,
        dmat if "dmat" in reads else None, sig.contiguous() if "sig" in reads else None,
        pgp.contiguous() if "pgp" in reads else None, gt, ht, g3fac, weights, bool(full),
        PACK_TILE[coords.dtype] if packed else 0, bool(diag))
    form_blocks.launches += 1
    form_blocks.dtypes[_dtype_name(coords)] += 1
    form_blocks.forms[form] += 1
    asked = [k for k, v in (("full", full), ("packed", packed), ("diag", diag)) if v]
    form_blocks.outputs.update(asked)
    got = dict(zip(asked, out))
    return got.get("full"), got.get("packed"), got.get("diag")


form_blocks.launches = 0
form_blocks.dtypes = Counter()  # launches by dtype name
form_blocks.forms = Counter()  # launches by form (FORMS)
form_blocks.outputs = Counter()  # launches that wrote each output: full, packed, diag


# -- K5: the block-Jacobi rebuild --------------------------------------------------

JACOBI_FORMS = ("fused", "sum", "tail")  # K5's forms: its kernel's form 0, 1, 2


def _jacobi_tail_ref(nodal: torch.Tensor, fixmask: torch.Tensor) -> torch.Tensor:
    """The torch tail of the rebuild: the nodal blocks (nn, 3, 3) masked to
    the identity on fixed dofs and inverted by the adjugate."""
    m3 = fixmask.reshape(nodal.shape[0], 3)
    eye = torch.eye(3, dtype=nodal.dtype, device=nodal.device)
    return inv3_spd(nodal * (m3[:, :, None] * m3[:, None, :]) + (1.0 - m3)[:, :, None] * eye)


def jacobi_inverse_ref(blocks: torch.Tensor, plan: SegmentPlan, fixmask: torch.Tensor, *,
                       reduce=None, cols=None) -> torch.Tensor:
    """Plain version of K5, the chain it replaced: the 10 diagonal 3x3
    blocks of every element sliced out of the element-major blocks (or
    made of K3's compact diagonal, each lower value its upper mirror; with
    ``cols`` the plan's elements gathered from their columns), their sum
    into nodes by :func:`segment_sum` (K8's write form on the card,
    ``index_add_`` on the CPU), ``reduce``, then :func:`_jacobi_tail_ref`.
    Arguments as :func:`jacobi_inverse`."""
    ne = plan.keys.shape[0] // 10
    if blocks.shape[:2] == (30, 30):
        esm_t = blocks if cols is None else blocks[:, :, cols]
        idx = torch.arange(10, device=esm_t.device)
        # diag[n, e] = esm[e, 3n:3n+3, 3n:3n+3] -> (10, ne, 3, 3)
        diag = esm_t.permute(2, 0, 1).reshape(ne, 10, 3, 10, 3)[:, idx, :, idx, :]
    else:
        upper = blocks if cols is None else blocks[:, cols]
        diag = upper[:, :, [0, 1, 2, 1, 3, 4, 2, 4, 5]].reshape(10, ne, 3, 3)
    nodal = segment_sum(diag.reshape(-1, 3, 3).contiguous(), plan, rows=fixmask.shape[0] // 3)
    if reduce is not None:
        nodal = reduce(nodal)
    return _jacobi_tail_ref(nodal, fixmask)


def _jacobi_launch(form, *args):
    out = torch.ops.fcvm.jacobi_inverse(JACOBI_FORMS.index(form), *args)
    jacobi_inverse.launches += 1
    jacobi_inverse.dtypes[_dtype_name(out)] += 1
    jacobi_inverse.forms[form] += 1
    return out


def jacobi_inverse(blocks: torch.Tensor, plan: SegmentPlan, fixmask: torch.Tensor, *,
                   reduce=None, cols=None) -> torch.Tensor:
    """K5: the inverse 3x3 nodal diagonal blocks of ``K_hat`` (nn, 3, 3),
    fixed dofs masked to the identity, in one node pass (design and bound at
    the top of ``csrc/jacobi_inverse.cu``).

    Args:
      blocks: K3's compact diagonal (10, ne, ``DIAG``) of ne elements
        (:func:`form_blocks` with ``diag``, :func:`diag_sectors`'s layout),
        the only input the card takes; on the CPU also the element-major
        blocks (30, 30, ne) with any strides.
      plan: the write-form :class:`SegmentPlan` of their slot-major keys
        into fixmask's nodes (``ops/assembly.py::jacobi_plan``); its order
        is the sum's.
      fixmask: (3 nn,) the free-dof mask.
      cols: (ne,) int64, the column of the blocks that holds each of the
        plan's elements, where the two orders differ (the solve space's
        blocks summed in user element order); None: the same order.
      reduce: sums the nodal blocks of a part of the mesh over the parts
        (the sharded backend's ``all_reduce``) before they are inverted: on
        the card the kernel's sum form, ``reduce``, then its tail form.

    CPU tensors take the plain version (:func:`jacobi_inverse_ref`); CUDA
    tensors launch the kernel or raise (``jacobi_inverse.launches`` counts
    the launches, ``.dtypes`` and ``.forms`` them by dtype and form: one
    "fused", or with ``reduce`` a "sum" and a "tail").  The sum is K8's
    write form's bits on the same (exactly symmetric) blocks, the tail the
    torch tail's."""
    rows = fixmask.shape[0] // 3
    ne = plan.keys.shape[0] // 10
    sectors = tuple(blocks.shape) == (10, ne, DIAG)
    if not sectors and tuple(blocks.shape) != (30, 30, ne):
        raise ValueError(f"jacobi_inverse: blocks {tuple(blocks.shape)}; expected the compact "
                         f"diagonal (10, {ne}, {DIAG}) or element-major (30, 30, {ne})")
    static = (blocks, fixmask, plan.keys, plan.order) + (() if cols is None else (cols,))
    if all(t.device.type == "cpu" for t in static):
        return jacobi_inverse_ref(blocks, plan, fixmask, reduce=reduce, cols=cols)
    if blocks.device.type != "cuda" or any(t.device != blocks.device for t in static):
        raise ValueError("jacobi_inverse: tensors on several devices; expected all on the CPU "
                         "or all on one CUDA device")
    if not sectors:
        raise ValueError("jacobi_inverse: on the card K5 reads K3's compact diagonal "
                         "(form_blocks(..., diag=True)), not the element-major blocks")
    if blocks.dtype not in PACK_TILE or fixmask.dtype != blocks.dtype:
        raise TypeError(f"jacobi_inverse: dtypes {blocks.dtype}/{fixmask.dtype}; expected "
                        "float32 or float64 throughout")
    if cols is not None and (cols.dtype != torch.int64 or cols.shape != (ne,)):
        raise ValueError(f"jacobi_inverse: cols {cols.dtype} {tuple(cols.shape)}; expected "
                         f"int64 ({ne},)")
    _node_plan_checks("jacobi_inverse", plan, rows, 10 * ne, blocks.device)
    build()
    tables = (plan.order, plan.offsets, plan.segs, plan.holes)
    if reduce is None:
        return _jacobi_launch("fused", blocks, *tables, rows, cols, fixmask, None)
    nodal = reduce(_jacobi_launch("sum", blocks, *tables, rows, cols, None, None))
    return _jacobi_launch("tail", None, None, None, None, None, rows, None, fixmask,
                          nodal.contiguous())


jacobi_inverse.launches = 0
jacobi_inverse.dtypes = Counter()  # launches by dtype name
jacobi_inverse.forms = Counter()  # launches by form (JACOBI_FORMS)


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
