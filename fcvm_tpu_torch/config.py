"""Solver configuration of the port (the fields of :mod:`fcvm_tpu.config`
that the port uses, with the same defaults, plus ``device``).

A :class:`FcvmConfig` is created by the caller and passed to
:func:`fcvm_tpu_torch.solve_collapse`; there is no process-wide config and
no environment override.  :meth:`FcvmConfig.check_supported` raises for
values outside each option's range.  The defaults run as they do in the
JAX package: Ritz deflation, residual refinement and the float64 failover
on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class FcvmConfig:
    """Framework-level solver configuration.

    Attributes:
      device: where every tensor of the analysis lives.  ``"cuda"`` raises
        when no CUDA device is available; nothing falls back to the CPU.
      solver: ``"cg"`` = matrix-free preconditioned conjugate gradients;
        ``"scipy"`` = the host direct tier, a scipy sparse LU of the
        assembled operator (small meshes, debugging; no deflation).
      dtype: compute dtype (``torch.float32``/``torch.float64`` or their
        names); ``None`` = float32.
      cg_rtol: relative residual tolerance of the PCG solves.
      cg_maxiter: CG iteration cap; ``0`` = ``min(max(1000, 2 ndof),
        200000)``.
      precond: ``"two_level"`` (3x3 nodal blocks + cluster coarse
        correction, :mod:`fcvm_tpu_torch.ops.precond`) or ``"block_jacobi"``.
      smoother: fine level of the two-level preconditioner: ``"jacobi3"``,
        3x3 nodal block Jacobi; ``"cluster"``, the block-Cholesky inverse of
        ``K_hat``'s diagonal blocks over index-contiguous clusters of
        ``smoother_cluster_nodes`` nodes, built once from the elastic
        operator and kept through tangent refreshes (fewer CG iterations for
        a larger apply; block Jacobi stays where the node count is not a
        multiple of the cluster size or the factorization fails).
      smoother_cluster_nodes: nodes per cluster of the ``"cluster"`` smoother.
      coarse_max_clusters, coarse_cluster_nodes, coarse_modes,
      coarse_max_dim: size the coarse space (see
        :meth:`resolve_cluster_size`); ``coarse_modes`` is 12 (affine) or
        6 (rigid-body).
      n_eig_vectors: subspace size of the buckling eigensolve (at least
        the requested modes; larger improves its convergence).
      buckling_bc: Dirichlet handling of the buckling pencil:
        ``"eliminate"`` removes fixed dofs exactly (identity rows in K_hat,
        zero rows in G_hat); ``"penalty"`` reproduces the reference's x100
        fixed-diagonal penalty on the full pencil (``fcVM.py:1051-1062``).
      n_devices: 0 or 1 = one device; N > 1 runs the element-partition
        backend (:mod:`fcvm_tpu_torch.parallel.system`) over a process
        group of exactly N ranks, one per device, which the caller starts
        (the CLI's ``--devices N`` or ``--distributed``,
        :func:`fcvm_tpu_torch.parallel.dist.spawn`); another group size
        raises.
      force_sharded: run the sharded backend even at ``n_devices <= 1``, on
        a world of one (which it starts when none is running): the sharded
        code on one device, as the JAX package validates its ``shard_map``
        kernels on one chip.
      node_partition: in the sharded backend, run each PCG on the ranks'
        slices of Morton node rows (one ``all_gather`` and one
        ``reduce_scatter`` per matvec, all-reduced dots and coarse
        restriction) instead of on replicated vectors.
      deflation: Ritz-deflation recycling of the Newton correction solves
        (:mod:`fcvm_tpu_torch.ops.deflation`, whose constants size it): one
        solve harvests its Lanczos byproducts, the lowest Ritz vectors
        deflate the following solves, across load steps, until a deflated
        solve regresses.  A harvest shorter than ``deflation_min_iters``
        builds nothing.
      load_deflation: with ``deflation``, the GNL tangent predictor's own
        recycling: one predictor solve harvests a Ritz basis of its load
        right-hand side, which each later tangent refresh re-Galerkins and
        deflates its predictor with, until a predictor solve regresses.
      precision_failover: in float32, watch the Newton error for an
        arithmetic floor above ``error_max``: clamp the tolerance near the
        floor, or escalate (refinement, then a float64 rerun).
      residual_refinement: the first escalation tier, float64 residuals
        over float32 state with the float32 operator and CG.
      arc_length: ``"riks"`` (the reference's linearised update) or
        ``"crisfield"`` (the spherical constraint, which follows snapback).
    """

    device: str = "cuda"
    solver: str = "cg"
    dtype: Optional[object] = None
    cg_rtol: float = 1.0e-6
    cg_maxiter: int = 0
    precond: str = "two_level"
    smoother: str = "jacobi3"
    smoother_cluster_nodes: int = 64
    coarse_max_clusters: int = 1500
    coarse_cluster_nodes: int = 32
    coarse_modes: int = 12
    coarse_max_dim: int = 12288
    n_eig_vectors: int = 8
    buckling_bc: str = "eliminate"
    n_devices: int = 0
    force_sharded: bool = False
    node_partition: bool = False
    deflation: bool = True
    deflation_min_iters: int = 48
    load_deflation: bool = True
    precision_failover: bool = True
    residual_refinement: bool = True
    arc_length: str = "riks"

    def resolve_cluster_size(self, nn: int) -> int:
        """Nodes per cluster for the two-level coarse space.

        Sized so the dense coarse dimension (coarse_modes * clusters) stays
        within ``coarse_max_dim``.
        """
        ncl_cap = max(1, min(self.coarse_max_clusters,
                             self.coarse_max_dim // max(self.coarse_modes, 1)))
        cs = max(self.coarse_cluster_nodes, -(-nn // ncl_cap))
        return min(cs, max(nn // 2, 1))

    def resolve_dtype(self) -> torch.dtype:
        if self.dtype is None:
            return torch.float32
        if isinstance(self.dtype, torch.dtype):
            dt = self.dtype
        else:
            dt = {"float32": torch.float32, "f32": torch.float32,
                  "float64": torch.float64, "f64": torch.float64}.get(
                      str(self.dtype).lower())
        if dt not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {self.dtype!r}")
        return dt

    def resolve_device(self) -> torch.device:
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device={self.device!r} but torch.cuda.is_available() is "
                "false; pass device='cpu' to run on the CPU"
            )
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {self.device!r}")
        return dev

    def resolve_cg_maxiter(self, ndof: int) -> int:
        """Safety cap only — the rtol criterion does the stopping."""
        if self.cg_maxiter > 0:
            return self.cg_maxiter
        return min(max(1000, 2 * ndof), 200_000)

    def check_supported(self) -> None:
        """Raise for every option value outside its range."""
        if self.n_devices < 0:
            raise ValueError(f"n_devices must be >= 0, got {self.n_devices}")
        if self.solver not in ("cg", "scipy"):
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.smoother not in ("jacobi3", "cluster"):
            raise ValueError(f"unknown smoother {self.smoother!r}")
        if self.smoother_cluster_nodes < 1:
            raise ValueError(f"smoother_cluster_nodes must be >= 1, got "
                             f"{self.smoother_cluster_nodes}")
        if self.arc_length not in ("riks", "crisfield"):
            raise ValueError(f"unknown arc_length {self.arc_length!r}")
        if self.precond not in ("two_level", "block_jacobi"):
            raise ValueError(f"unknown precond {self.precond!r}")
        if self.buckling_bc not in ("eliminate", "penalty"):
            raise ValueError(f"unknown buckling_bc {self.buckling_bc!r}")


def pin_full_fp32() -> None:
    """No TF32 anywhere: element formation, the stress update, the coarse
    solve and every other float32 product run in full float32 (the JAX
    package pins the same places to HIGHEST against the TPU's bf16 passes).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "torch.get_float32_matmul_precision() is "
            f"{torch.get_float32_matmul_precision()!r}; the port needs "
            "'highest' (no TF32)"
        )
