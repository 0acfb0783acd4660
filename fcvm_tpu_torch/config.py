"""Solver configuration of the port (the fields of :mod:`fcvm_tpu.config`
that the small-strain slice uses, with the same defaults, plus ``device``).

A :class:`FcvmConfig` is created by the caller and passed to
:func:`fcvm_tpu_torch.solve_collapse`; there is no process-wide config and
no environment override.  Options the slice has not ported are kept with
their JAX defaults so a config reads like the reference's, and
:meth:`FcvmConfig.check_supported` raises :class:`NotImplementedError` for
them naming the ROADMAP item that ports them.  The defaults run as they
do in the JAX package: Ritz deflation, residual refinement and the float64
failover on.
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
      solver: ``"cg"`` = matrix-free preconditioned conjugate gradients.
      dtype: compute dtype (``torch.float32``/``torch.float64`` or their
        names); ``None`` = float32.
      cg_rtol: relative residual tolerance of the PCG solves.
      cg_maxiter: CG iteration cap; ``0`` = ``min(max(1000, 2 ndof),
        200000)``.
      precond: ``"two_level"`` (3x3 nodal blocks + cluster coarse
        correction, :mod:`fcvm_tpu_torch.ops.precond`) or ``"block_jacobi"``.
      smoother: fine level of the two-level preconditioner; ``"jacobi3"``.
      coarse_max_clusters, coarse_cluster_nodes, coarse_modes,
      coarse_max_dim: size the coarse space (see
        :meth:`resolve_cluster_size`); ``coarse_modes`` is 12 (affine) or
        6 (rigid-body).
      n_devices: 0 or 1 (one device).
      deflation: Ritz-deflation recycling of the Newton correction solves
        (:mod:`fcvm_tpu_torch.ops.deflation`, whose constants size it): one
        solve harvests its Lanczos byproducts, the lowest Ritz vectors
        deflate the following solves, across load steps, until a deflated
        solve regresses.  A harvest shorter than ``deflation_min_iters``
        builds nothing.  (The JAX package's ``load_deflation``, the GNL
        tangent predictor's load-space recycling, comes with the GNL port.)
      precision_failover: in float32, watch the Newton error for an
        arithmetic floor above ``error_max``: clamp the tolerance near the
        floor, or escalate (refinement, then a float64 rerun).
      residual_refinement: the first escalation tier, float64 residuals
        over float32 state with the float32 operator and CG.
      arc_length: ``"riks"``.
    """

    device: str = "cuda"
    solver: str = "cg"
    dtype: Optional[object] = None
    cg_rtol: float = 1.0e-6
    cg_maxiter: int = 0
    precond: str = "two_level"
    smoother: str = "jacobi3"
    coarse_max_clusters: int = 1500
    coarse_cluster_nodes: int = 32
    coarse_modes: int = 12
    coarse_max_dim: int = 12288
    n_devices: int = 0
    deflation: bool = True
    deflation_min_iters: int = 48
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
        """Raise for every option this slice of the port does not run."""
        todo = [
            (self.solver == "scipy", "solver='scipy'",
             "the scipy direct tier (ROADMAP Queue 1 item 5)"),
            (self.smoother == "cluster", "smoother='cluster'",
             "the cluster block-Cholesky smoother (ROADMAP Queue 1 item 6)"),
            (self.arc_length == "crisfield", "arc_length='crisfield'",
             "the Crisfield arc-length update (ROADMAP Queue 1 item 8)"),
            (self.n_devices > 1, f"n_devices={self.n_devices}",
             "the multi-device backend (ROADMAP Queue 1 item 16)"),
        ]
        for unsupported, what, item in todo:
            if unsupported:
                raise NotImplementedError(f"{what}: {item} is not ported yet")
        if self.solver != "cg":
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.smoother != "jacobi3":
            raise ValueError(f"unknown smoother {self.smoother!r}")
        if self.arc_length != "riks":
            raise ValueError(f"unknown arc_length {self.arc_length!r}")
        if self.precond not in ("two_level", "block_jacobi"):
            raise ValueError(f"unknown precond {self.precond!r}")


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
