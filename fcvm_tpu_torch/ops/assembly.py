"""Element stiffness blocks, load integration, Dirichlet handling, K_hat·v.

The port of :mod:`fcvm_tpu.ops.assembly`, with the buckling pencil's
geometric stiffness.  The global
stiffness matrix is never formed: the per-element 30x30 blocks stay on the
device and ``K @ v`` is gather -> block matvec -> scatter-add, with the
block stage the hand-written CUDA kernel K0
(:func:`fcvm_tpu_torch.ops.kernels.block_matvec`); an ``(ndof, m)`` block
of vectors goes through K0m (:func:`fcvm_tpu_torch.ops.kernels.block_matmat`)
in one pass.  The operator stores the
blocks element-major, ``(30, 30, ne)``, the layout K0 and K0m read coalesced.
The node reduction is ``index_add_`` (on CUDA an atomic scatter-add whose
float32 summation order varies from run to run).

Dirichlet boundary conditions reproduce the reference's elimination scheme
(``fcVM.py:771-796``): the operator is the identity on fixed dofs and the
right-hand side carries ``-(K u_fix)_free + u_fix``.
"""

from __future__ import annotations

import torch

from fcvm_tpu_torch.ops import elements as el
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import material as mat
from fcvm_tpu_torch.ops.stress_update import voigt_to_tensor
from fcvm_tpu_torch.utils.linalg3 import det3, inv3_spd


def element_dof_ids(elnodes: torch.Tensor) -> torch.Tensor:
    """(ne, 30) global dof indices from 0-based connectivity (ne, 10)."""
    a3 = torch.arange(3, device=elnodes.device)
    return (3 * elnodes[:, :, None] + a3).reshape(elnodes.shape[0], 30)


def _scatter(values: torch.Tensor, dofs: torch.Tensor, ndof: int) -> torch.Tensor:
    out = torch.zeros(ndof, dtype=values.dtype, device=values.device)
    return out.index_add_(0, dofs.reshape(-1), values.reshape(-1))


# ---------------------------------------------------------------------------
# Element stiffness blocks
# ---------------------------------------------------------------------------


def elastic_stiffness_blocks(coords, elnodes, dmat) -> torch.Tensor:
    """(ne, 30, 30) elastic element stiffness blocks (``fcVM.py:739-756``):
    ``sum_g B_g^T D B_g w_g |J_g|``; ``dmat`` (6, 6) or (ne, 6, 6) per
    element."""
    det, _, bmat = el.tet10_element_geometry(coords[elnodes])
    scale = torch.as_tensor(el.W10, dtype=coords.dtype, device=coords.device) * det.abs()
    db = mat.apply_dmat(dmat, bmat)
    return torch.einsum("egkm,egkn,eg->emn", bmat, db, scale)


def tangent_stiffness_blocks(coords_def, elnodes, dmat, sig_gp, pgp, g, h) -> torch.Tensor:
    """(ne, 30, 30) tangent blocks on the deformed coordinates
    ``coords_def`` (``fcVM.py:971-1000``): ``sum_g B_g^T D_g B_g w_g |J_g|``
    with ``D_g = D - fac s s^T`` at plastic Gauss points, ``s`` the
    deviator of ``sig_gp`` (the stress at the start of the step, (ne, 4, 6))
    and ``fac = 3G / (1 + H/3G) / svm^2``; ``pgp`` (ne, 4) flags the
    plastic points.  Each element's block depends on its own rows only, so
    the rows of ``elnodes``, ``sig_gp`` and ``pgp`` (and of ``dmat`` (ne,
    6, 6), ``g`` and ``h`` (ne,) when they are per element) may come in any
    element order, the same for all."""
    det, _, bmat = el.tet10_element_geometry(coords_def[elnodes])
    scale = torch.as_tensor(el.W10, dtype=coords_def.dtype,
                            device=coords_def.device) * det.abs()
    dev, _, svm = mat.von_mises(sig_gp)
    svm = torch.where(svm == 0.0, torch.ones_like(svm), svm)
    g, h = mat.per_gauss(g), mat.per_gauss(h)
    g3fac = 3.0 * g / (1.0 + h / (3.0 * g))
    fac = torch.where(pgp, g3fac / svm**2, torch.zeros_like(svm))
    dmat_e = dmat if dmat.dim() == 2 else dmat[:, None]
    dmat_g = dmat_e - fac[..., None, None] * dev[..., :, None] * dev[..., None, :]
    db = torch.einsum("egkl,egln->egkn", dmat_g, bmat)
    return torch.einsum("egkm,egkn,eg->emn", bmat, db, scale)


def geometric_stiffness_blocks(coords, elnodes, sig_gp) -> torch.Tensor:
    """(ne, 30, 30) initial-stress (geometric) blocks (``fcVM.py:1002-1006``):
    ``sum_g w_g |J_g| (dN_g^T sigma_g dN_g) (x) I_3``, ``sig_gp`` (ne, 4, 6)
    the pre-stress field."""
    det, dshpg, _ = el.tet10_element_geometry(coords[elnodes])
    scale = torch.as_tensor(el.W10, dtype=coords.dtype, device=coords.device) * det.abs()
    m = torch.einsum("egij,egik,egkl,eg->ejl", dshpg, voigt_to_tensor(sig_gp), dshpg, scale)
    eye3 = torch.eye(3, dtype=coords.dtype, device=coords.device)
    return torch.einsum("ejl,bc->ejblc", m, eye3).reshape(-1, 30, 30)


# ---------------------------------------------------------------------------
# Load vector
# ---------------------------------------------------------------------------


def gravity_load_and_gp_coords(coords, elnodes, density, grav, ndof, weights=None):
    """Gravity nodal loads + Gauss point coordinates + mesh volume.

    Integrates ``grav * rho * N_i w |J|`` per element (``fcVM.py:757-767``);
    ``density`` is a number or (ne,) per element.  ``weights`` (ne,), when
    given, scales each element's load and volume (0 for the sharded
    backend's padding elements).
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
    nodes3 = 3 * elnodes[:, :, None] + torch.arange(3, device=dev)
    glv = _scatter(gamma, nodes3, ndof)
    gp_coords = torch.einsum("gj,eji->egi", shp, coords_el)  # (ne, 4, 3)
    volume = torch.sum(det * w[None, :])
    return glv, gp_coords, volume


def _node_dofs(nodes: torch.Tensor) -> torch.Tensor:
    return 3 * nodes[..., None] + torch.arange(3, device=nodes.device)


def pressure_face_loads(coords, faces, pressures, ndof):
    """Nodal loads from pressure along the outward normal of tri6 faces
    (``fcVM.py:649-672``); ``faces`` (nf, 6), ``pressures`` (nf,)."""
    if faces.shape[0] == 0:
        return torch.zeros(ndof, dtype=coords.dtype, device=coords.device)
    xsj, normal = el.tri6_surface_frame(coords[faces])  # (nf, 6g), (nf, 6g, 3)
    shp = torch.as_tensor(el.SHP6_AT_GP, dtype=coords.dtype, device=coords.device)
    w = torch.as_tensor(el.W6, dtype=coords.dtype, device=coords.device)
    load = torch.einsum("gn,f,fgc,fg,g->fnc", shp, pressures, normal, xsj.abs(), w)
    return _scatter(load, _node_dofs(faces), ndof)


def uniform_face_loads(coords, faces, tractions, ndof):
    """Nodal loads from uniform tractions on tri6 faces (``fcVM.py:683-705``);
    ``faces`` (nf, 6), ``tractions`` (nf, 3) force per unit area."""
    if faces.shape[0] == 0:
        return torch.zeros(ndof, dtype=coords.dtype, device=coords.device)
    xsj, _ = el.tri6_surface_frame(coords[faces])
    shp = torch.as_tensor(el.SHP6_AT_GP, dtype=coords.dtype, device=coords.device)
    w = torch.as_tensor(el.W6, dtype=coords.dtype, device=coords.device)
    load = torch.einsum("gn,fc,fg,g->fnc", shp, tractions, xsj.abs(), w)
    return _scatter(load, _node_dofs(faces), ndof)


def edge_loads(coords, edges, tractions, ndof):
    """Nodal loads from line tractions on 3-node edges (``fcVM.py:707-727``);
    ``edges`` (nedg, 3), ``tractions`` (nedg, 3) force per unit length."""
    if edges.shape[0] == 0:
        return torch.zeros(ndof, dtype=coords.dtype, device=coords.device)
    xsj = el.line3_jacobian(coords[edges])  # (nedg, 2)
    shp = torch.as_tensor(el.SHP2_AT_GP, dtype=coords.dtype, device=coords.device)
    w = torch.as_tensor(el.W2, dtype=coords.dtype, device=coords.device)
    load = torch.einsum("gn,ec,eg,g->enc", shp, tractions, xsj.abs(), w)
    return _scatter(load, _node_dofs(edges), ndof)


def vertex_loads(vertices, forces, ndof):
    """Point loads at nodes (``fcVM.py:674-681``); ``vertices`` (nv,),
    ``forces`` (nv, 3)."""
    if vertices.shape[0] == 0:
        return torch.zeros(ndof, dtype=forces.dtype, device=forces.device)
    return _scatter(forces, _node_dofs(vertices), ndof)


# ---------------------------------------------------------------------------
# Dirichlet elimination + matrix-free operator
# ---------------------------------------------------------------------------


def make_matvec(esm_t: torch.Tensor, eldofs: torch.Tensor, ndof: int):
    """Raw ``K @ v`` from element-major blocks ``esm_t`` (30, 30, ne):
    per-dof gather into (30, ne) -> K0 -> ``index_add_`` into dofs."""
    eldofs_t = eldofs.T.contiguous()  # (30, ne), the layout K0 reads
    flat = eldofs_t.reshape(-1)

    def kv(u):
        fe_t = kernels.block_matvec(esm_t, u[eldofs_t])
        out = torch.zeros(ndof, dtype=u.dtype, device=u.device)
        return out.index_add_(0, flat, fe_t.reshape(-1))

    return kv


def make_bc_matvec(esm_t: torch.Tensor, eldofs: torch.Tensor, fixmask: torch.Tensor):
    """``K_hat @ v`` with eliminated Dirichlet dofs:
    ``K_hat u = P K P u + (I - P) u`` with ``P = diag(fixmask)`` — the same
    solution space as the reference's row/column elimination
    (``fcVM.py:771-796``).  ``esm_t`` is element-major (30, 30, ne)."""
    kv = make_matvec(esm_t, eldofs, fixmask.shape[0])
    free = 1.0 - fixmask

    def khat(u):
        return fixmask * kv(fixmask * u) + free * u

    return khat


def make_multi_matvec(esm_t: torch.Tensor, eldofs: torch.Tensor, fixmask: torch.Tensor,
                      identity_on_fixed: bool = True, negate: bool = False):
    """``(ndof, m) -> (ndof, m)`` block operator with Dirichlet projection,
    ``P K P U`` (plus ``(I - P) U`` with ``identity_on_fixed``; negated
    with ``negate``), over element-major blocks ``esm_t`` (30, 30, ne).

    The node-row gather of ``U`` gives the (ne, 30, m) layout K0m reads,
    and K0m's output reshapes to node rows for ``index_add_``: no copy on
    either side.  ``identity_on_fixed`` gives ``K_hat @ U``; without it and
    with ``negate``, ``-G_hat @ U`` of the buckling pencil (zero on fixed
    dofs); ``fixmask`` all ones gives the raw ``K @ U``."""
    elnodes = eldofs[:, ::3] // 3
    flat = elnodes.reshape(-1)
    ne = elnodes.shape[0]
    nn = fixmask.shape[0] // 3
    pm = fixmask[:, None]

    def mv(u):
        m = u.shape[1]
        ue = (pm * u).reshape(nn, 3, m)[elnodes].reshape(ne, 30, m)  # node-row gather
        fe = kernels.block_matmat(esm_t, ue)
        out = torch.zeros((nn, 3, m), dtype=u.dtype, device=u.device)
        out.index_add_(0, flat, fe.reshape(ne * 10, 3, m))
        y = pm * out.reshape(nn * 3, m)
        if identity_on_fixed:
            y = y + (1.0 - pm) * u
        return -y if negate else y

    return mv


def dirichlet_rhs(esm_t, eldofs, fixmask, u_fix, glv):
    """Full RHS ``f = P glv - (P K u_fix) + u_fix`` (``fcVM.py:1128``) over
    element-major blocks ``esm_t`` (30, 30, ne)."""
    kv = make_matvec(esm_t, eldofs, fixmask.shape[0])
    return fixmask * glv - fixmask * kv(u_fix) + u_fix


def block_jacobi_inverse_blocks(esm, elnodes, fixmask, reduce=None):
    """Inverse 3x3 nodal diagonal blocks of ``K_hat`` (nn, 3, 3).

    Fixed dofs get identity rows/columns so the preconditioner is
    consistent with :func:`make_bc_matvec`.  ``esm`` (ne, 30, 30).
    ``reduce``, when given, sums the nodal blocks of a part of the mesh
    over the parts before they are inverted (the sharded backend's
    ``all_reduce``).
    """
    ne = esm.shape[0]
    nn = fixmask.shape[0] // 3
    idx = torch.arange(10, device=esm.device)
    # diag[n, e] = esm[e, 3n:3n+3, 3n:3n+3] -> (10, ne, 3, 3)
    diag = esm.reshape(ne, 10, 3, 10, 3)[:, idx, :, idx, :]
    nodal = torch.zeros((nn, 3, 3), dtype=esm.dtype, device=esm.device)
    nodal.index_add_(0, elnodes.T.reshape(-1), diag.reshape(-1, 3, 3))
    if reduce is not None:
        nodal = reduce(nodal)
    m3 = fixmask.reshape(nn, 3)
    eye = torch.eye(3, dtype=esm.dtype, device=esm.device)
    nodal = nodal * (m3[:, :, None] * m3[:, None, :]) + (1.0 - m3)[:, :, None] * eye
    return inv3_spd(nodal)


def apply_block_precond(pinv, r):
    """Apply nodal block-Jacobi inverse blocks (nn, 3, 3) to r (ndof,) or to
    each column of r (ndof, m)."""
    if r.dim() == 2:
        return torch.einsum("nab,nbm->nam", pinv, r.reshape(-1, 3, r.shape[1])).reshape(r.shape)
    return torch.einsum("nab,nb->na", pinv, r.reshape(-1, 3)).reshape(-1)
