"""Two-level preconditioner for the matrix-free CG solver, the port of
:mod:`fcvm_tpu.ops.precond`.

* **Fine level** (``smoother``): ``"jacobi3"``, inverse 3x3 nodal diagonal
  blocks (:func:`fcvm_tpu_torch.ops.assembly.block_jacobi_inverse_blocks`),
  rebuilt with every tangent refresh; or ``"cluster"``, the inverse
  (3 cs, 3 cs) diagonal blocks of ``K_hat`` over index-contiguous clusters
  of ``cs`` nodes (:func:`cluster_diag_inverse`), built once from the
  elastic operator and applied as one batched product.
* **Coarse level**: nodes are aggregated into index-contiguous clusters;
  each cluster carries 12 affine (or 6 rigid-body) modes about its
  centroid.  The coarse operator ``K_c = Q^T K_hat Q`` is accumulated from
  the element blocks and inverted densely once; each application adds
  ``Q K_c^{-1} Q^T r``.  Clusters are contiguous index ranges, so ``Q`` and
  ``Q^T`` are reshapes and small products with no gather.

The driver builds it in the Morton solve space
(:class:`fcvm_tpu_torch.runtime.system.SolveSpace`), where contiguous
ranges are spatially compact.

The coarse inverse is a Cholesky factor and ``cholesky_inverse`` in the
working dtype (the JAX package forces float32 and a blocked Schur scheme
because of TPU limits).  The coarse product, projection and prolongation run
in full float32 at least (no TF32): the coarse correction exists to cancel
smooth error below CG's tolerance.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import torch

from fcvm_tpu_torch.ops import assembly as asm
from fcvm_tpu_torch.ops import kernels

# Observability for the coarse-build degradation paths (ridge escalation,
# zero-coarse fallback).  Both keep the solver correct, but the fallback
# costs several times more CG iterations, so the collapse driver surfaces
# these counters in cg_stats and its log.  ``smoother_builds`` counts the
# cluster smoother's factorizations (one per analysis: tangent refreshes
# keep it), ``smoother_fallbacks`` the builds whose inverse had a NaN and
# fell back to block Jacobi.
COARSE_BUILD_STATS = {
    "builds": 0,
    "ridge_escalations": 0,  # builds that needed a ridge above the first
    "zero_coarse_fallbacks": 0,  # builds that gave up (fine smoother only)
    "last_escalations": 0,  # ladder steps the most recent build climbed
    "last_fallback": False,
    "smoother_builds": 0,
    "smoother_fallbacks": 0,
}

_RIDGE_LADDER = (3.0e-5, 3.0e-4, 3.0e-3, 3.0e-2, 3.0e-1)


class TwoLevelPrecond(NamedTuple):
    pinv: torch.Tensor  # (nn, 3, 3) block-Jacobi inverses
    qmat: torch.Tensor  # (nn_cl, 3, nm) cluster mode basis per node
    coarse_inv: torch.Tensor  # (nm ncl, nm ncl), mode-major order
    fixmask: torch.Tensor  # (ndof,)
    # the cluster block-Cholesky smoother (ncl_s, 3 cs, 3 cs); when present
    # it replaces the block-Jacobi fine level
    smooth_inv: Optional[torch.Tensor] = None

    def fine(self, r: torch.Tensor) -> torch.Tensor:
        """The fine level on a vector (ndof,) or a block (ndof, m): block
        Jacobi, or one batched product with the cluster inverses (full
        float32 at least, no TF32, as the rest of the preconditioner)."""
        if self.smooth_inv is None:
            return asm.apply_block_precond(self.pinv, r)
        ncl, m, _ = self.smooth_inv.shape
        mask = self.fixmask if r.dim() == 1 else self.fixmask[:, None]
        z = torch.bmm(self.smooth_inv, (mask * r).reshape(ncl, m, -1))
        return z.reshape(r.shape) * mask

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """Apply to a vector (ndof,) through K4
        (:func:`fcvm_tpu_torch.ops.kernels.two_level_apply`, block Jacobi
        fused into it; the cluster smoother's ``bmm`` runs before it), or
        to each column of a block (ndof, m)."""
        if r.dim() == 2:
            return self._apply_block(r)
        r = r.contiguous()  # K4 reads a dense vector; a column of a block is strided
        z_fine = None if self.smooth_inv is None else self.fine(r)
        return kernels.two_level_apply(self.pinv, self.qmat, self.coarse_inv, self.fixmask, r,
                                       z_fine)

    def _apply_block(self, r: torch.Tensor) -> torch.Tensor:
        """:meth:`apply` on the m columns of ``r`` at once: the same steps
        with a trailing column axis, and the coarse product a GEMM.  The
        vector form stays separate: run as a block of one column, it made
        the default plate run's stepping ~3% slower on the H100 (PERF.md)."""
        m = r.shape[1]
        z = self.fine(r)
        nn_cl, _, nm = self.qmat.shape
        ncl = self.coarse_inv.shape[0] // nm
        cs = nn_cl // ncl
        r3 = (self.fixmask[:, None] * r).reshape(-1, 3, m)
        nn = r3.shape[0]
        r3p = torch.nn.functional.pad(r3, (0, 0, 0, 0, 0, nn_cl - nn))
        rc = torch.einsum("nak,nam->nkm", self.qmat, r3p).reshape(ncl, cs, nm, m).sum(dim=1)
        zc = self.coarse_inv @ rc.permute(1, 0, 2).reshape(nm * ncl, m)  # mode-major rows
        zc_n = zc.reshape(nm, ncl, m).permute(1, 0, 2).repeat_interleave(cs, dim=0)
        z2 = torch.einsum("nak,nkm->nam", self.qmat, zc_n)
        return z + z2[:nn].reshape(-1, m) * self.fixmask[:, None]


def apply_precond(pc, r):
    """Apply a :class:`TwoLevelPrecond` or nodal block-Jacobi blocks."""
    if isinstance(pc, TwoLevelPrecond):
        return pc.apply(r)
    return asm.apply_block_precond(pc, r)


def refresh_blocks(pc, esm, elnodes, fixmask):
    """Rebuild the block-Jacobi part after a tangent refresh from the
    blocks ``esm`` (ne, 30, 30), keeping the two-level coarse correction of
    the elastic operator (a preconditioner only needs to stay SPD and
    spectrally close, as the reference keeps its elastic factor,
    ``fcVM.py:1400-1406``).  Returns the new preconditioner: a
    :class:`TwoLevelPrecond`, or the nodal blocks of the block-Jacobi tier.
    A preconditioner with the cluster smoother is returned unchanged: its
    elastic cluster inverses stay, and nothing is rebuilt."""
    if isinstance(pc, TwoLevelPrecond) and pc.smooth_inv is not None:
        return pc
    pinv = asm.block_jacobi_inverse_blocks(esm, elnodes, fixmask)
    if isinstance(pc, TwoLevelPrecond):
        return pc._replace(pinv=pinv)
    return pinv


def rigid_modes(coords, cluster_size: int, n_modes: int = 6):
    """(nn_cl, 3, n_modes) cluster mode basis per node, centroid-centered.

    ``n_modes=6``: rigid-body modes (translations + rotations);
    ``n_modes=12``: the full affine basis, rigid plus the six uniform strain
    fields.  Rotation and strain modes are normalised by the cluster's rms
    offset so all modes have comparable magnitude."""
    if n_modes not in (6, 12):
        raise ValueError(f"n_modes must be 6 or 12, got {n_modes}")
    nn = coords.shape[0]
    ncl = -(-nn // cluster_size)
    nn_cl = ncl * cluster_size
    cpad = torch.nn.functional.pad(coords, (0, 0, 0, nn_cl - nn))
    centroids = cpad.reshape(ncl, cluster_size, 3).mean(dim=1)
    d = cpad - centroids.repeat_interleave(cluster_size, dim=0)  # (nn_cl, 3)
    d_rms = torch.sqrt((d.reshape(ncl, cluster_size, 3) ** 2).mean(dim=(1, 2)))
    scale = 1.0 / torch.clamp(d_rms.repeat_interleave(cluster_size), min=1e-30)
    dx, dy, dz = d[:, 0] * scale, d[:, 1] * scale, d[:, 2] * scale
    z = torch.zeros_like(dx)
    eye = torch.eye(3, dtype=coords.dtype, device=coords.device)
    trans = eye.expand(nn_cl, 3, 3)
    rot = torch.stack(
        [
            torch.stack([z, dz, -dy], dim=-1),
            torch.stack([-dz, z, dx], dim=-1),
            torch.stack([dy, -dx, z], dim=-1),
        ],
        dim=1,
    )  # column b = rotation about axis b
    parts = [trans, rot]
    if n_modes == 12:
        h = 0.5
        parts.append(torch.stack(
            [
                torch.stack([dx, z, z, h * dy, h * dz, z], dim=-1),
                torch.stack([z, dy, z, h * dx, z, h * dz], dim=-1),
                torch.stack([z, z, dz, z, h * dx, h * dy], dim=-1),
            ],
            dim=1,
        ))  # exx, eyy, ezz and the engineering shears exy, exz, eyz
    q = torch.cat(parts, dim=2)
    mask = (torch.arange(nn_cl, device=coords.device) < nn).to(coords.dtype)
    return q * mask[:, None, None]


def qmat_bc(coords, fixmask, cluster_size: int, n_modes: int = 6):
    """(nn_cl, 3, nm) Dirichlet-masked cluster-mode basis.  ``coords`` are
    padded to the ``fixmask`` node count first (padding nodes sit at the
    origin), as the JAX package does."""
    nn_pad = fixmask.shape[0] // 3
    coords_p = torch.nn.functional.pad(coords, (0, 0, 0, nn_pad - coords.shape[0]))
    q = rigid_modes(coords_p, cluster_size, n_modes)
    m3 = torch.nn.functional.pad(fixmask.reshape(nn_pad, 3), (0, 0, 0, q.shape[0] - nn_pad))
    return q * m3[:, :, None]


def coarse_accumulate(esm, elnodes, qmat, cluster_size: int, chunk: int = 8192):
    """Galerkin pair-block accumulation into the (ncl*ncl, nm*nm) layout.

    Per element ``S_e = Q~ B_e Q~^T`` with the block-diagonal element mode
    matrix ``Q~`` (10 nm, 30); its (nm, nm) pair blocks are added at key
    ``cluster(i) * ncl + cluster(j)``.  Chunked over elements to bound the
    (chunk, 10 nm, 10 nm) intermediate."""
    ne = esm.shape[0]
    nm = qmat.shape[2]
    ncl = qmat.shape[0] // cluster_size
    kc = torch.zeros((ncl * ncl, nm * nm), dtype=esm.dtype, device=esm.device)
    eye10 = torch.eye(10, dtype=esm.dtype, device=esm.device)
    for s in range(0, ne, chunk):
        esm_c = esm[s:s + chunk]
        eln_c = elnodes[s:s + chunk]
        c = esm_c.shape[0]
        qe = qmat[eln_c]  # (c, 10, 3, nm)
        qt = torch.einsum("ciax,ij->cixja", qe, eye10).reshape(c, 10 * nm, 30)
        s_blk = qt @ esm_c @ qt.transpose(1, 2)  # (c, 10 nm, 10 nm)
        pair = (s_blk.reshape(c, 10, nm, 10, nm).permute(0, 1, 3, 2, 4)
                .reshape(c * 100, nm * nm))
        ci = eln_c // cluster_size
        keys = (ci[:, :, None] * ncl + ci[:, None, :]).reshape(-1)
        kc.index_add_(0, keys, pair)
    return kc


def _coarse_densify_scale(kc, ridge: float):
    """Mode-major dense layout + symmetric Jacobi scaling + symmetrisation +
    ridge of the pair-block accumulator; returns ``(kc_scaled, dscale)``."""
    ncl = round(kc.shape[0] ** 0.5)
    nm = round(kc.shape[1] ** 0.5)
    n = nm * ncl
    # D[(a ncl + i), (b ncl + j)] = kc[i ncl + j, nm a + b]
    dense = kc.T.reshape(nm, nm, ncl, ncl).permute(0, 2, 1, 3).reshape(n, n)
    diag = dense.diagonal().abs()
    top = diag.max()
    diag = torch.where(diag <= 1e-12 * top, top, diag)
    dscale = 1.0 / torch.sqrt(diag)
    ks = dense * dscale[:, None] * dscale[None, :]
    ks.diagonal().clamp_(min=1.0)
    ks = 0.5 * (ks + ks.T)
    ks.diagonal().add_(ridge)
    return ks, dscale


def coarse_invert(kc, ridge: float):
    """Dense inverse of the scaled, ridged coarse matrix (Cholesky), in the
    original scaling.  A failed factorization gives a non-finite result."""
    ks, dscale = _coarse_densify_scale(kc, ridge)
    chol, info = torch.linalg.cholesky_ex(ks)
    if int(info) != 0:
        return torch.full_like(ks, float("nan"))
    inv = torch.cholesky_inverse(chol)
    return inv * dscale[:, None] * dscale[None, :]


def invert_coarse_with_ladder(kc, label: str = ""):
    """Dense coarse inverse with the escalating ridge ladder.

    The Galerkin accumulation cancels heavily (the modes nearly annihilate
    the rows of K), so the scaled coarse matrix can come out slightly
    indefinite.  Escalate the ridge until the inverse is finite; if every
    ridge fails, fall back to a zero coarse correction (fine smoother only),
    warn, and record it in :data:`COARSE_BUILD_STATS`.
    """
    stats = COARSE_BUILD_STATS
    stats["builds"] += 1
    inv = None
    for i, ridge in enumerate(_RIDGE_LADDER):
        inv = coarse_invert(kc, ridge)
        if bool(torch.isfinite(inv).all()):
            stats["last_escalations"] = i
            stats["last_fallback"] = False
            if i:
                stats["ridge_escalations"] += 1
            return inv
    stats["last_escalations"] = len(_RIDGE_LADDER)
    stats["last_fallback"] = True
    stats["zero_coarse_fallbacks"] += 1
    warnings.warn(
        f"{label}two-level coarse inverse non-finite at every ridge; "
        "continuing with the fine-level smoother only"
    )
    return torch.zeros_like(inv)


def build_two_level(esm, elnodes, coords, fixmask, cluster_size: int = 64,
                    n_modes: int = 6, smoother: str = "jacobi3",
                    smoother_cluster_nodes: int = 64) -> TwoLevelPrecond:
    """Assemble the two-level preconditioner from element blocks.

    All inputs share one node/element numbering (the driver passes the
    Morton solve-space views).  ``esm`` is (ne, 30, 30).  With
    ``smoother="cluster"`` the cluster smoother of ``smoother_cluster_nodes``
    nodes is built when that count divides the padded node count; an
    inverse with a NaN keeps block Jacobi, as in the JAX package."""
    pinv = asm.block_jacobi_inverse_blocks(esm, elnodes, fixmask)
    qmat = qmat_bc(coords, fixmask, cluster_size, n_modes)
    kc = coarse_accumulate(esm, elnodes, qmat, cluster_size)
    coarse_inv = invert_coarse_with_ladder(kc)
    del kc
    smooth_inv = None
    cs = smoother_cluster_nodes
    if smoother == "cluster" and (fixmask.shape[0] // 3) % cs == 0:
        smooth_inv = cluster_diag_inverse(esm, elnodes, fixmask, cs)
        COARSE_BUILD_STATS["smoother_builds"] += 1
        if bool(torch.isnan(smooth_inv).any()):
            COARSE_BUILD_STATS["smoother_fallbacks"] += 1
            smooth_inv = None
    return TwoLevelPrecond(pinv, qmat, coarse_inv, fixmask, smooth_inv)


def cluster_diag_inverse(esm, elnodes, fixmask, cs: int):
    """Inverse cluster-diagonal blocks of ``K_hat``: (ncl, 3 cs, 3 cs).

    Clusters are index-contiguous ranges of ``cs`` nodes (compact in the
    Morton solve space), so the apply is a reshape and one batched product.
    The blocks (:func:`cluster_diag_blocks`) are principal submatrices of
    the SPD ``K_hat``, so a batched Cholesky inverts them.

    The factorization runs in the working dtype: the JAX package factors in
    float32 because the TPU has no float64 Cholesky.  A block whose
    factorization fails comes back NaN (as the JAX package's does), which
    the caller reads as "keep block Jacobi"."""
    chol, info = torch.linalg.cholesky_ex(cluster_diag_blocks(esm, elnodes, fixmask, cs))
    inv = torch.cholesky_inverse(chol)
    return inv.masked_fill_((info != 0)[:, None, None], float("nan"))


def cluster_diag_blocks(esm, elnodes, fixmask, cs: int, chunk: int = 4096):
    """The (ncl, 3 cs, 3 cs) diagonal blocks of ``K_hat`` over clusters of
    ``cs`` nodes, fixed dofs masked to the identity.  Each element's
    same-cluster 3x3 node pairs are added into a flat (ncl 3cs cs + 1, 3)
    accumulator (row = cluster, block row, column node; pairs across
    clusters go to the last, dump row), chunked over elements."""
    nn_pad = fixmask.shape[0] // 3
    if nn_pad % cs:
        raise ValueError(f"{nn_pad} padded nodes are not a multiple of {cs}")
    ncl, m = nn_pad // cs, 3 * cs
    nrow = ncl * m * cs  # flat (cluster, block row, column node) 3-wide rows
    acc = torch.zeros((nrow + 1, 3), dtype=esm.dtype, device=esm.device)
    a3 = torch.arange(3, device=esm.device)
    for s in range(0, esm.shape[0], chunk):
        esm_c, eln_c = esm[s:s + chunk], elnodes[s:s + chunk]
        cid, loc = eln_c // cs, eln_c % cs  # (c, 10)
        # [e, i, j, a, b] = esm[e, 3i + a, 3j + b]
        pair = esm_c.reshape(-1, 10, 3, 10, 3).permute(0, 1, 3, 2, 4)
        row = 3 * loc[:, :, None, None] + a3  # (c, 10, 1, 3)
        key = (cid[:, :, None, None] * m + row) * cs + loc[:, None, :, None]
        key = torch.where((cid[:, :, None] == cid[:, None, :])[..., None], key, nrow)
        acc.index_add_(0, key.reshape(-1), pair.reshape(-1, 3))
    mask = fixmask.reshape(ncl, m)
    blocks = acc[:-1].reshape(ncl, m, m).mul_(mask[:, :, None]).mul_(mask[:, None, :])
    blocks.diagonal(dim1=1, dim2=2).add_(1.0 - mask)
    return blocks
