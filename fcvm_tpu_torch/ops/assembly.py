"""Element stiffness blocks, load integration, Dirichlet handling, K_hat·v.

The port of :mod:`fcvm_tpu.ops.assembly`, with the buckling pencil's
geometric stiffness.  The global
stiffness matrix is never formed: the per-element 30x30 blocks stay on the
device and ``K @ v`` is gather -> block matvec -> node sum -> mask, one
hand-written CUDA kernel K1 (:func:`fcvm_tpu_torch.ops.kernels.khat_matvec`)
over the element node table and its node-incidence CSR
(:func:`node_incidence`), whose node sums run in a fixed order, so its
results are deterministic; on the card K1 reads the blocks' packed upper
triangles, which K3 (:func:`fcvm_tpu_torch.ops.kernels.form_blocks`)
writes as it forms them (:func:`operator_blocks`; blocks given as a tensor
are packed by :func:`fcvm_tpu_torch.ops.kernels.pack_blocks`).  An
``(ndof, m)`` block of vectors goes through K1m
(:func:`fcvm_tpu_torch.ops.kernels.khat_matmat`), K1 on m columns at once,
over the same packed blocks and incidence table.  Every other
sum of element rows into nodes (the loads, the block-Jacobi blocks) is K8
(:func:`fcvm_tpu_torch.ops.kernels.segment_sum`) over a
:class:`~fcvm_tpu_torch.ops.kernels.SegmentPlan` of its keys, a fixed
order as well; CPU tensors take ``index_add_``, the plain version.  The
block-Jacobi rebuild is K5 (:func:`fcvm_tpu_torch.ops.kernels.jacobi_inverse`),
one node pass over the compact diagonal K3 writes beside its tiles.  The
operator stores the blocks element-major, ``(30, 30, ne)``, the layout the
plain versions read.

Dirichlet boundary conditions reproduce the reference's elimination scheme
(``fcVM.py:771-796``): the operator is the identity on fixed dofs and the
right-hand side carries ``-(K u_fix)_free + u_fix``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fcvm_tpu_torch.ops import elements as el
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.utils.linalg3 import det3


def element_dof_ids(elnodes: torch.Tensor) -> torch.Tensor:
    """(ne, 30) global dof indices from 0-based connectivity (ne, 10)."""
    a3 = torch.arange(3, device=elnodes.device)
    return (3 * elnodes[:, :, None] + a3).reshape(elnodes.shape[0], 30)


def node_sum(rows: torch.Tensor, nodes: torch.Tensor, ndof: int, plan=None) -> torch.Tensor:
    """(ndof,) node vector of the 3-wide ``rows`` (n k, 3) of ``n`` items
    of ``k`` nodes each (``nodes`` (n, k)), each node's rows summed in
    ascending row order by K8's write form over ``plan``, the
    :func:`~fcvm_tpu_torch.ops.kernels.segment_plan` of ``nodes`` with
    ``rows = ndof // 3`` (built here when not given)."""
    if plan is None:
        plan = kernels.segment_plan(nodes, rows=ndof // 3)
    return kernels.segment_sum(rows.reshape(-1, 3).contiguous(), plan,
                               rows=ndof // 3).reshape(-1)


# ---------------------------------------------------------------------------
# Element stiffness blocks
# ---------------------------------------------------------------------------


class Blocks(NamedTuple):
    """Element blocks as the operators take them: element-major ``esm_t``
    (30, 30, ne) (None on the card unless asked for), K1's packed tiles
    ``packed`` and the compact diagonal ``diag`` (10, ne, 8) that K5 reads
    (:func:`~fcvm_tpu_torch.ops.kernels.diag_sectors`'s layout; on the card
    only where asked for).  On the CPU ``packed`` and ``diag`` are None: its
    plain versions read ``esm_t``."""

    esm_t: torch.Tensor | None
    packed: torch.Tensor | None
    diag: torch.Tensor | None = None

    @property
    def esm(self) -> torch.Tensor | None:
        """The element-major blocks as (ne, 30, 30), a view (None where
        ``esm_t`` is)."""
        return None if self.esm_t is None else self.esm_t.permute(2, 0, 1)


def operator_blocks(form, coords, elnodes, *, full=False, diag=False, **inputs) -> Blocks:
    """K3's blocks of one ``form`` (see
    :func:`fcvm_tpu_torch.ops.kernels.form_blocks`, whose keyword
    ``inputs`` these are: ``disp``, ``dmat``, ``sig``, ``pgp``, ``g``, ``h``,
    ``weights``, ``perm``, ``table``) as an operator takes them: on the CPU
    the element-major blocks, contiguous; on the card K1's packed tiles,
    from the same launch the element-major blocks when ``full`` (the
    two-level build, the scipy tier, the penalty pencil read them) and the
    compact diagonal when ``diag`` (for callers that run K5 next)."""
    if coords.device.type == "cpu":
        esm_t, *_ = kernels.form_blocks(form, coords, elnodes, **inputs)
        return Blocks(esm_t.contiguous(), None)
    return Blocks(*kernels.form_blocks(form, coords, elnodes, full=full, packed=True, diag=diag,
                                       **inputs))


def blocks_of(esm: torch.Tensor) -> Blocks:
    """(ne, 30, 30) blocks given as a tensor, as an operator takes them:
    element-major, and on the card packed by
    :func:`~fcvm_tpu_torch.ops.kernels.pack_blocks` with their
    :func:`~fcvm_tpu_torch.ops.kernels.diag_sectors`."""
    esm_t = esm.permute(1, 2, 0).contiguous()
    if esm_t.device.type == "cpu":
        return Blocks(esm_t, None)
    return Blocks(esm_t, kernels.pack_blocks(esm_t), kernels.diag_sectors(esm_t))


def elastic_stiffness_blocks(coords, elnodes, dmat) -> torch.Tensor:
    """(ne, 30, 30) elastic element stiffness blocks (``fcVM.py:739-756``):
    ``sum_g B_g^T D B_g w_g |J_g|``; ``dmat`` (6, 6) or (ne, 6, 6) per
    element.  K3 (on the card a view of its element-major output)."""
    return kernels.form_blocks("elastic", coords, elnodes, dmat=dmat)[0].permute(2, 0, 1)


def tangent_stiffness_blocks(coords_def, elnodes, dmat, sig_gp, pgp, g, h) -> torch.Tensor:
    """(ne, 30, 30) tangent blocks on the deformed coordinates
    ``coords_def`` (``fcVM.py:971-1000``): ``sum_g B_g^T D_g B_g w_g |J_g|``
    with ``D_g = D - fac s s^T`` at plastic Gauss points, ``s`` the
    deviator of ``sig_gp`` (the stress at the start of the step, (ne, 4, 6))
    and ``fac = 3G / (1 + H/3G) / svm^2``; ``pgp`` (ne, 4) flags the
    plastic points.  Each element's block depends on its own rows only, so
    the rows of ``elnodes``, ``sig_gp`` and ``pgp`` (and of ``dmat`` (ne,
    6, 6), ``g`` and ``h`` (ne,) when they are per element) may come in any
    element order, the same for all.  K3."""
    return kernels.form_blocks("tangent", coords_def, elnodes, dmat=dmat, sig=sig_gp, pgp=pgp,
                               g=g, h=h)[0].permute(2, 0, 1)


def geometric_stiffness_blocks(coords, elnodes, sig_gp) -> torch.Tensor:
    """(ne, 30, 30) initial-stress (geometric) blocks (``fcVM.py:1002-1006``):
    ``sum_g w_g |J_g| (dN_g^T sigma_g dN_g) (x) I_3``, ``sig_gp`` (ne, 4, 6)
    the pre-stress field.  K3."""
    return kernels.form_blocks("geometric", coords, elnodes, sig=sig_gp)[0].permute(2, 0, 1)


# ---------------------------------------------------------------------------
# Load vector
# ---------------------------------------------------------------------------


def gravity_load_and_gp_coords(coords, elnodes, density, grav, ndof, weights=None, plan=None):
    """Gravity nodal loads + Gauss point coordinates + mesh volume.

    Integrates ``grav * rho * N_i w |J|`` per element (``fcVM.py:757-767``);
    ``density`` is a number or (ne,) per element.  ``weights`` (ne,), when
    given, scales each element's load and volume (0 for the sharded
    backend's padding elements).  ``plan``: the segment plan of
    ``elnodes`` (see :func:`node_sum`).
    """
    coords_el = coords[elnodes]  # (ne, 10, 3)
    dt, dev = coords.dtype, coords.device
    dshp = torch.as_tensor(el.DSHP10_AT_GP, dtype=dt, device=dev)
    shp = torch.as_tensor(el.SHP10_AT_GP, dtype=dt, device=dev)  # (4, 10)
    w = torch.as_tensor(el.W10, dtype=dt, device=dev)
    xs = torch.einsum("eki,gjk->egij", coords_el, dshp)
    det = det3(xs)  # (ne, 4)
    if weights is not None:
        det = det * weights[:, None]
    scale = w[None, :] * det.abs()
    rho = density[:, None, None] if torch.is_tensor(density) and density.dim() == 1 else density
    gamma = torch.einsum("eg,gj,c->ejc", scale, shp, grav) * rho
    glv = node_sum(gamma, elnodes, ndof, plan)
    gp_coords = torch.einsum("gj,eji->egi", shp, coords_el)  # (ne, 4, 3)
    volume = torch.sum(det * w[None, :])
    return glv, gp_coords, volume


def pressure_face_loads(coords, faces, pressures, ndof, plan=None):
    """Nodal loads from pressure along the outward normal of tri6 faces
    (``fcVM.py:649-672``); ``faces`` (nf, 6), ``pressures`` (nf,); ``plan``
    the segment plan of ``faces`` (see :func:`node_sum`)."""
    if faces.shape[0] == 0:
        return torch.zeros(ndof, dtype=coords.dtype, device=coords.device)
    xsj, normal = el.tri6_surface_frame(coords[faces])  # (nf, 6g), (nf, 6g, 3)
    shp = torch.as_tensor(el.SHP6_AT_GP, dtype=coords.dtype, device=coords.device)
    w = torch.as_tensor(el.W6, dtype=coords.dtype, device=coords.device)
    load = torch.einsum("gn,f,fgc,fg,g->fnc", shp, pressures, normal, xsj.abs(), w)
    return node_sum(load, faces, ndof, plan)


def uniform_face_loads(coords, faces, tractions, ndof, plan=None):
    """Nodal loads from uniform tractions on tri6 faces (``fcVM.py:683-705``);
    ``faces`` (nf, 6), ``tractions`` (nf, 3) force per unit area; ``plan``
    as in :func:`pressure_face_loads`."""
    if faces.shape[0] == 0:
        return torch.zeros(ndof, dtype=coords.dtype, device=coords.device)
    xsj, _ = el.tri6_surface_frame(coords[faces])
    shp = torch.as_tensor(el.SHP6_AT_GP, dtype=coords.dtype, device=coords.device)
    w = torch.as_tensor(el.W6, dtype=coords.dtype, device=coords.device)
    load = torch.einsum("gn,fc,fg,g->fnc", shp, tractions, xsj.abs(), w)
    return node_sum(load, faces, ndof, plan)


def edge_loads(coords, edges, tractions, ndof, plan=None):
    """Nodal loads from line tractions on 3-node edges (``fcVM.py:707-727``);
    ``edges`` (nedg, 3), ``tractions`` (nedg, 3) force per unit length;
    ``plan`` the segment plan of ``edges`` (see :func:`node_sum`)."""
    if edges.shape[0] == 0:
        return torch.zeros(ndof, dtype=coords.dtype, device=coords.device)
    xsj = el.line3_jacobian(coords[edges])  # (nedg, 2)
    shp = torch.as_tensor(el.SHP2_AT_GP, dtype=coords.dtype, device=coords.device)
    w = torch.as_tensor(el.W2, dtype=coords.dtype, device=coords.device)
    load = torch.einsum("gn,ec,eg,g->enc", shp, tractions, xsj.abs(), w)
    return node_sum(load, edges, ndof, plan)


def vertex_loads(vertices, forces, ndof, plan=None):
    """Point loads at nodes (``fcVM.py:674-681``); ``vertices`` (nv,),
    ``forces`` (nv, 3); ``plan`` the segment plan of ``vertices``."""
    if vertices.shape[0] == 0:
        return torch.zeros(ndof, dtype=forces.dtype, device=forces.device)
    return node_sum(forces, vertices, ndof, plan)


# ---------------------------------------------------------------------------
# Dirichlet elimination + matrix-free operator
# ---------------------------------------------------------------------------


def node_incidence(elnodes: torch.Tensor, nn: int) -> kernels.NodeIncidence:
    """K1's tables for the elements ``elnodes`` (ne, 10) over ``nn`` nodes:
    the element-major int32 node table and the node-incidence CSR, each
    node's incidences in ascending element order: K8's
    :func:`~fcvm_tpu_torch.ops.kernels.segment_plan` of ``elnodes`` (the
    JAX package's ``ScatterPlan`` semantics) with a row for every node and
    ``pos`` each incidence's offset ``3 slot ne + e`` into K1's element
    output (30, ne); on the card also K1m's compacted tables
    (:func:`~fcvm_tpu_torch.ops.kernels.k1m_tables`).  Built once per
    element numbering."""
    ne = elnodes.shape[0]
    if 30 * ne >= 2**31:
        raise ValueError(f"node_incidence: {ne} elements; K1's int32 offsets need 30 ne < 2^31")
    plan = kernels.segment_plan(elnodes)  # element-major: incidence k = 10 e + slot
    if plan.top > nn:
        raise ValueError(f"node_incidence: a node id {plan.top - 1} is not below {nn}")
    counts = torch.zeros(nn + 1, dtype=torch.int32, device=elnodes.device)
    counts[plan.segs.long() + 1] = plan.offsets[1:] - plan.offsets[:-1]
    order = plan.order.long()
    inc = kernels.NodeIncidence(
        elnodes.T.contiguous().to(torch.int32),
        torch.cumsum(counts, 0, dtype=torch.int32),
        (3 * (order % 10) * ne + order // 10).to(torch.int32))
    if elnodes.device.type == "cpu":
        return inc
    return inc._replace(k1m=kernels.k1m_tables(inc))


def _incidence(eldofs, ndof, incidence):
    return incidence if incidence is not None else node_incidence(eldofs[:, ::3] // 3, ndof // 3)


def _blocks(esm_t, packed):
    """What K1 and K1m read: on the CPU the full blocks, on the card their
    packed copy (K3's; made here when not given, and then ``esm_t`` may be
    None)."""
    if packed is not None and packed.device.type != "cpu":
        return packed
    if esm_t.device.type == "cpu":
        return esm_t
    return kernels.pack_blocks(esm_t)


def make_matvec(esm_t: torch.Tensor, eldofs: torch.Tensor, ndof: int, incidence=None,
                packed=None):
    """Raw ``K @ v`` from element-major blocks ``esm_t`` (30, 30, ne)
    through K1.  ``incidence``, the :func:`node_incidence` of the elements
    of ``eldofs`` (ne, 30) over ``ndof // 3`` nodes, and on the card
    ``packed``, the blocks' :func:`~fcvm_tpu_torch.ops.kernels.pack_blocks`
    copy, are made here when not given."""
    k1 = kernels.khat_matvec_bound(_blocks(esm_t, packed), _incidence(eldofs, ndof, incidence))

    def kv(u):
        return k1(u.contiguous())  # a dense vector

    return kv


def make_bc_matvec(esm_t: torch.Tensor, eldofs: torch.Tensor, fixmask: torch.Tensor,
                   incidence=None, packed=None):
    """``K_hat @ v`` with eliminated Dirichlet dofs through K1:
    ``K_hat u = P K P u + (I - P) u`` with ``P = diag(fixmask)`` — the same
    solution space as the reference's row/column elimination
    (``fcVM.py:771-796``).  ``esm_t`` is element-major (30, 30, ne);
    ``incidence`` and ``packed`` as in :func:`make_matvec`.  K1's checks run
    here, once per operator."""
    k1 = kernels.khat_matvec_bound(_blocks(esm_t, packed),
                                   _incidence(eldofs, fixmask.shape[0], incidence), fixmask)

    def khat(u):
        return k1(u.contiguous())

    return khat


def make_multi_matvec(esm_t: torch.Tensor, eldofs: torch.Tensor, fixmask,
                      identity_on_fixed: bool = True, negate: bool = False, incidence=None,
                      packed=None):
    """``(ndof, m) -> (ndof, m)`` block operator with Dirichlet projection
    through K1m (:func:`fcvm_tpu_torch.ops.kernels.khat_matmat`): ``P K P
    U`` (plus ``(I - P) U`` with ``identity_on_fixed``; negated with
    ``negate``), over element-major blocks ``esm_t`` (30, 30, ne).

    ``identity_on_fixed`` gives ``K_hat @ U``; without it and with
    ``negate``, ``-G_hat @ U`` of the buckling pencil (zero on fixed dofs);
    ``fixmask`` None gives the raw ``K @ U`` (all ones, the same values
    through the masks), and then ``incidence`` must be given.
    ``incidence`` and on the card ``packed`` as in :func:`make_matvec`,
    made here when not given.  A block that is not dense (a column slice)
    is copied first.  On the card K1m's plan (its tables and the blocks'
    tensor map, :func:`~fcvm_tpu_torch.ops.kernels.khat_matmat_plan`) is
    made here, once."""
    if fixmask is None and incidence is None:
        raise ValueError("make_multi_matvec: the raw form needs the incidence table (its "
                         "node count)")
    inc = _incidence(eldofs, None if fixmask is None else fixmask.shape[0], incidence)
    blocks = _blocks(esm_t, packed)
    plan = kernels.khat_matmat_plan(blocks, inc, fixmask)

    def mv(u):
        return kernels.khat_matmat(blocks, inc, u.contiguous(), fixmask, identity_on_fixed,
                                   negate, plan)

    return mv


def dirichlet_rhs(esm_t, eldofs, fixmask, u_fix, glv, incidence=None, packed=None):
    """Full RHS ``f = P glv - (P K u_fix) + u_fix`` (``fcVM.py:1128``) over
    element-major blocks ``esm_t`` (30, 30, ne); ``incidence`` and
    ``packed`` as in :func:`make_matvec`."""
    kv = make_matvec(esm_t, eldofs, fixmask.shape[0], incidence, packed)
    return fixmask * glv - fixmask * kv(u_fix) + u_fix


def jacobi_plan(elnodes: torch.Tensor, nn: int) -> kernels.SegmentPlan:
    """The segment plan of :func:`block_jacobi_inverse_blocks`'s node sum
    over the elements ``elnodes`` (ne, 10) into ``nn`` nodes: slot-major
    keys, K8's write form."""
    return kernels.segment_plan(elnodes.T, rows=nn)


def block_jacobi_inverse_blocks(esm, elnodes, fixmask, reduce=None, plan=None, cols=None,
                                diag=None):
    """Inverse 3x3 nodal diagonal blocks of ``K_hat`` (nn, 3, 3): K5
    (:func:`fcvm_tpu_torch.ops.kernels.jacobi_inverse`) over the (ne, 30,
    30) blocks ``esm`` (the CPU's), or over ``diag``, their compact
    diagonal (K3's, which the card reads), where given (``esm`` may then be
    None).

    Fixed dofs get identity rows/columns so the preconditioner is
    consistent with :func:`make_bc_matvec`.  ``reduce``, when given, sums
    the nodal blocks of a part of the mesh over the parts before they are
    inverted (the sharded backend's ``all_reduce``).  ``plan``, the
    :func:`jacobi_plan` of ``elnodes`` (K8's write form), is built here
    when not given.  ``cols``: the blocks' element of each of ``elnodes``'
    where the two orders differ (the sums then run in ``elnodes``' order).
    """
    if plan is None:
        plan = jacobi_plan(elnodes, fixmask.shape[0] // 3)
    blocks = diag if diag is not None else esm.permute(1, 2, 0)
    return kernels.jacobi_inverse(blocks, plan, fixmask, reduce=reduce, cols=cols)


def apply_block_precond(pinv, r):
    """Apply nodal block-Jacobi inverse blocks (nn, 3, 3) to r (ndof,) or to
    each column of r (ndof, m)."""
    if r.dim() == 2:
        return torch.einsum("nab,nbm->nam", pinv, r.reshape(-1, 3, r.shape[1])).reshape(r.shape)
    return torch.einsum("nab,nb->na", pinv, r.reshape(-1, 3)).reshape(-1)
