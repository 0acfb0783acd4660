"""K3, the element stiffness blocks, and K5, the block-Jacobi rebuild, on
the CPU, float64.

* K3's plain version (``kernels.form_blocks_ref``, through
  ``kernels.form_blocks``) in its three forms against the JAX package's
  ``elastic_stiffness_blocks``, ``tangent_stiffness_blocks`` and
  ``geometric_stiffness_blocks`` to ``RTOL`` of ``max |block|``, on a box and
  the small plate: mixed plastic flags, a Gauss point with zero stress,
  one D or a D, G and H per element; its packed tiles bit for bit
  ``pack_blocks`` of its element-major blocks and its compact diagonal
  their diagonal slices (``diag_sectors``), with and without a permuted
  element order; a permuted element order the permuted blocks, bit for
  bit; element weights scale the blocks.
* A NumPy transcription of ``csrc/form_blocks.cu`` (each element's nodes
  gathered once; the geometry of ``csrc/tet10.cuh``, whose table is read
  from its source; s_g D_g's upper 21 values; each node pair a <= b in the
  kernel's row-major order, D B_b then B_a^T (D B_b); the packed index, the
  mirrored element-major store and the compact diagonal's sector) against
  JAX to ``RTOL``: the index check of the kernel that runs without a
  card.
* K5's plain version (``kernels.jacobi_inverse_ref``) against JAX's
  ``block_jacobi_inverse_blocks``, bit for bit the chain it replaced (the
  slice, K8's write form, the torch tail), on element-major blocks and on
  the compact diagonal of symmetric ones, with the blocks in another
  element order than the plan's (``cols``), and its sum-reduce-tail form
  against the fused one; a NumPy transcription of
  ``csrc/jacobi_inverse.cu`` (the units in row order, each incidence's
  sector, the upper sums mirrored, each rounding of the tail) bit for bit,
  and the same bits with the units sorted by count (the plan's walk, the
  probe's order).
* Both wrappers have no fallback: no ``try``, their plain versions only on
  CPU tensors, and they refuse what they do not take.
"""

import ast
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import F64, t64, ti

import fcvm_tpu
from fcvm_tpu.models import meshgen
from fcvm_tpu.ops import assembly as jasm
from fcvm_tpu_torch.ops import assembly as tasm
from fcvm_tpu_torch.ops import elements as tel
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.utils.linalg3 import inv3_spd

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "fcvm_tpu_torch" / "csrc"
RTOL = 1e-12  # max |port - JAX| / max |JAX block|: float64 sums in another order
E, NU, ET_E = 210000.0, 0.3, 0.1
MESHES = ("box", "plate")
MATERIALS = ("one", "per element")


def _mesh(name):
    if name == "box":
        return meshgen.box_tet10(2, 2, 2, 10.0, 10.0, 10.0)
    return meshgen.plate_with_hole_tet10(radius=10.0, width=50.0, height=100.0, thickness=5.0,
                                         n_circ=6, n_rad=4, n_thick=1)


def _case(name, material, seed=21):
    """Seeded inputs on mesh ``name``: a displacement (the tangent's deformed
    geometry), stresses of 50 MPa with one Gauss point at zero, about half
    the points plastic (the zero one among them), and one material or a
    Young's modulus per element (D, G and H per element)."""
    mesh = _mesh(name)
    rng = np.random.default_rng(seed)
    ne = mesh.n_elements
    disp = 1e-2 * rng.normal(size=3 * mesh.n_nodes)
    sig = rng.normal(scale=50.0, size=(ne, 4, 6))
    sig[1, 2] = 0.0
    pgp = rng.random((ne, 4)) < 0.5
    pgp[1, 2] = True
    e = rng.uniform(0.5, 2.0, size=ne) * E if material == "per element" else E
    dmat = fcvm_tpu.ops.material.hooke_dmat(jnp.asarray(e, jnp.float64), jnp.float64(NU))
    g = np.asarray(e) / (2.0 * (1.0 + NU))
    h = np.asarray(e) * ET_E / (1.0 - ET_E)
    if material == "one":
        g, h = float(g), float(h)
    return dict(coords=mesh.coords, eln=mesh.elnodes, disp=disp, sig=sig, pgp=pgp,
                dmat=np.asarray(dmat), g=g, h=h, ne=ne, nn=mesh.n_nodes)


def _jax_blocks(form, c):
    if form == "elastic":
        return np.asarray(jasm.elastic_stiffness_blocks(
            jnp.asarray(c["coords"]), jnp.asarray(c["eln"]), jnp.asarray(c["dmat"])))
    if form == "geometric":
        return np.asarray(jasm.geometric_stiffness_blocks(
            jnp.asarray(c["coords"]), jnp.asarray(c["eln"]), jnp.asarray(c["sig"])))
    coords_def = c["coords"] + c["disp"].reshape(-1, 3)
    return np.asarray(jasm.tangent_stiffness_blocks(
        jnp.asarray(coords_def), jnp.asarray(c["eln"]), jnp.asarray(c["dmat"]),
        jnp.asarray(c["sig"]), jnp.asarray(c["pgp"]), jnp.asarray(c["g"]), jnp.asarray(c["h"])))


def _inputs(form, c):
    """K3's keyword inputs of ``form`` on case ``c``, as tensors."""
    kw = {"elastic": dict(dmat=t64(c["dmat"])),
          "geometric": dict(sig=t64(c["sig"])),
          "tangent": dict(disp=t64(c["disp"]), dmat=t64(c["dmat"]), sig=t64(c["sig"]),
                          pgp=torch.as_tensor(c["pgp"]), g=c["g"], h=c["h"])}[form]
    return {k: (t64(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}


def form_launches():
    return kernels.form_blocks.launches + kernels.jacobi_inverse.launches


def _close(got, ref):
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max() / scale
    assert err <= RTOL, f"max rel err {err:.3e}"


@pytest.mark.parametrize("material", MATERIALS)
@pytest.mark.parametrize("form", kernels.FORMS)
@pytest.mark.parametrize("name", MESHES)
def test_plain_version_matches_jax(name, form, material):
    """The three forms, each mesh and material, against the JAX package;
    the packed tiles of the same call bit for bit ``pack_blocks`` of its
    element-major blocks, its compact diagonal their ``diag_sectors``."""
    c = _case(name, material)
    esm_t, packed, diag = kernels.form_blocks(form, t64(c["coords"]), ti(c["eln"]), full=True,
                                              packed=True, diag=True, **_inputs(form, c))
    _close(esm_t.permute(2, 0, 1).numpy(), _jax_blocks(form, c))
    assert torch.equal(packed, kernels.pack_blocks(esm_t))
    assert torch.equal(diag, kernels.diag_sectors(esm_t))
    assert form_launches() == 0


@pytest.mark.parametrize("form", kernels.FORMS)
def test_permuted_elements_give_permuted_blocks(form):
    """``perm``: each output element's block is its input element's, bit
    for bit the unpermuted call's column (the per-element inputs, D, G and
    H included, read at the input element)."""
    c = _case("plate", "per element")
    perm = torch.as_tensor(np.random.default_rng(3).permutation(c["ne"]))
    args = (t64(c["coords"]), ti(c["eln"]))
    base = kernels.form_blocks(form, *args, **_inputs(form, c))[0]
    moved = kernels.form_blocks(form, *args, perm=perm, **_inputs(form, c))[0]
    assert torch.equal(moved, base[:, :, perm])


@pytest.mark.parametrize("permuted", [False, True], ids=["input_order", "permuted"])
@pytest.mark.parametrize("form", kernels.FORMS)
def test_diag_is_the_blocks_diagonal_slices(form, permuted):
    """The compact diagonal, with and without ``perm``: for incidence
    ``slot ne + e`` the 6 upper values of output element e's diagonal block
    (slot, slot), row-major, bit for bit the element-major blocks' slices,
    then two zeros; in the permuted order the unpermuted call's columns."""
    c = _case("plate", "per element")
    perm = torch.as_tensor(np.random.default_rng(4).permutation(c["ne"])) if permuted else None
    args = (t64(c["coords"]), ti(c["eln"]))
    esm_t, _, diag = kernels.form_blocks(form, *args, perm=perm, diag=True, **_inputs(form, c))
    assert diag.shape == (10, c["ne"], kernels.DIAG)
    for slot in range(10):
        block = esm_t[3 * slot:3 * slot + 3, 3 * slot:3 * slot + 3]  # (3, 3, ne)
        upper = [block[r, q] for r in range(3) for q in range(r, 3)]
        assert torch.equal(diag[slot, :, :6], torch.stack(upper, dim=1))
    assert not diag[:, :, 6:].any()
    if permuted:
        base = kernels.form_blocks(form, *args, full=False, diag=True, **_inputs(form, c))[2]
        assert torch.equal(diag, base[:, perm])


@pytest.mark.parametrize("form", kernels.FORMS)
def test_weights_scale_the_blocks(form):
    """Element weights (the sharded backend's, zeros on padding elements)
    scale each element's block, bit for bit the blocks times the weight."""
    c = _case("box", "one")
    w = torch.as_tensor((np.random.default_rng(5).random(c["ne"]) > 0.2).astype(float)
                        * np.random.default_rng(6).uniform(0.5, 1.5, c["ne"]))
    args = (t64(c["coords"]), ti(c["eln"]))
    base = kernels.form_blocks(form, *args, **_inputs(form, c))[0]
    scaled = kernels.form_blocks(form, *args, weights=w, **_inputs(form, c))[0]
    assert torch.equal(scaled, base * w)
    assert not scaled[:, :, w == 0].any()


def test_operator_blocks_on_the_cpu():
    """``assembly.operator_blocks`` on CPU tensors: the element-major blocks,
    contiguous, no packed tiles and no compact diagonal, asked for or not;
    the (ne, 30, 30) functions the chain's output itself."""
    c = _case("box", "one")
    blocks = tasm.operator_blocks("elastic", t64(c["coords"]), ti(c["eln"]),
                                  dmat=t64(c["dmat"]), diag=True)
    assert blocks.packed is None and blocks.diag is None and blocks.esm_t.is_contiguous()
    esm = tasm.elastic_stiffness_blocks(t64(c["coords"]), ti(c["eln"]), t64(c["dmat"]))
    assert esm.is_contiguous() and torch.equal(esm.permute(1, 2, 0), blocks.esm_t)


# -- K3's kernel, transcribed --------------------------------------------------------


def _geometry_table():
    """The dN/dxi table [g][j][k] and Gauss weight of ``csrc/tet10.cuh``."""
    src = (CSRC / "tet10.cuh").read_text()
    body = re.search(r"kDshp\[kTable\] = \{(.*?)\};", src, re.S).group(1)
    vals = [float(v) for v in body.split(",") if v.strip()]
    weight = float(re.search(r"kWeight = ([-+0-9.eE]+);", src).group(1))
    return np.array(vals).reshape(4, 3, 10), weight


def _det3(m):
    return (m[0][0] * m[1][1] * m[2][2] - m[0][0] * m[1][2] * m[2][1]
            + m[0][2] * m[1][0] * m[2][1] - m[0][2] * m[1][1] * m[2][0]
            + m[0][1] * m[1][2] * m[2][0] - m[0][1] * m[1][0] * m[2][2])


def _upper6(k, l):
    return k * 6 - k * (k - 1) // 2 + (l - k)


def _packed_index(i, j):
    return i * 30 - i * (i - 1) // 2 + (j - i)


def _pairs():
    """The kernel's node pairs a <= b, row-major, decoded as it decodes p."""
    out = []
    for p in range(55):
        a, rem = 0, p
        while rem >= 10 - a:
            rem -= 10 - a
            a += 1
        out.append((a, a + rem))
    return out


def _k3_transcribed(form, c, tile):
    """``csrc/form_blocks.cu`` on every element at once: (full (30, 30, ne),
    packed (ntiles, 465, tile), diag (10, ne, 8))."""
    table, weight = _geometry_table()
    ne = c["ne"]
    nodes = kernels.element_table(ti(c["eln"])).numpy()  # (10, ne) int32
    coords = c["coords"] + (c["disp"].reshape(-1, 3) if form == "tangent" else 0.0)
    x = coords[nodes]  # (10, ne, 3)
    dmat = np.broadcast_to(c["dmat"], (ne, 6, 6))
    dx = np.empty((4, 30, ne))
    dq = np.empty((4, 21, ne))
    for g in range(4):
        dn = table[g]
        jac = [[np.zeros(ne) for _ in range(3)] for _ in range(3)]
        for k in range(10):
            for i in range(3):
                for j in range(3):
                    jac[i][j] = x[k, :, i] * dn[j, k] + jac[i][j]
        m = jac
        det = _det3(m)
        ji = [[(m[1][1] * m[2][2] - m[2][1] * m[1][2]) / det,
               (m[0][2] * m[2][1] - m[0][1] * m[2][2]) / det,
               (m[0][1] * m[1][2] - m[0][2] * m[1][1]) / det],
              [(m[1][2] * m[2][0] - m[1][0] * m[2][2]) / det,
               (m[0][0] * m[2][2] - m[0][2] * m[2][0]) / det,
               (m[1][0] * m[0][2] - m[0][0] * m[1][2]) / det],
              [(m[1][0] * m[2][1] - m[2][0] * m[1][1]) / det,
               (m[2][0] * m[0][1] - m[0][0] * m[2][1]) / det,
               (m[0][0] * m[1][1] - m[1][0] * m[0][1]) / det]]
        for k in range(10):
            for i in range(3):
                dx[g, 3 * k + i] = ji[0][i] * dn[0, k] + ji[1][i] * dn[1, k] + ji[2][i] * dn[2, k]
        scale = weight * np.abs(det)
        s = c["sig"][:, g]
        if form == "geometric":
            for v in range(6):
                dq[g, v] = scale * s[:, v]
            continue
        fac = np.zeros(ne)
        dev = np.zeros((ne, 6))
        if form == "tangent":
            p = (s[:, 0] + s[:, 1] + s[:, 2]) / 3.0
            dev = s.copy()
            dev[:, :3] -= p[:, None]
            svm = np.sqrt(1.5 * (dev[:, :3] ** 2).sum(1) + 3.0 * (dev[:, 3:] ** 2).sum(1))
            safe = np.where(svm == 0.0, 1.0, svm)
            gg, hh = np.broadcast_to(c["g"], ne), np.broadcast_to(c["h"], ne)
            g3fac = 3.0 * gg / (1.0 + hh / (3.0 * gg))
            fac = np.where(c["pgp"][:, g], g3fac / (safe * safe), 0.0)
        for k in range(6):
            for l in range(k, 6):
                dq[g, _upper6(k, l)] = scale * (dmat[:, k, l] - fac * dev[:, k] * dev[:, l])

    def d(g, k, l):
        return dq[g, _upper6(min(k, l), max(k, l))]

    full = np.empty((30, 30, ne))
    ntiles = -(-ne // tile)
    packed = np.zeros((ntiles, 465, tile))
    sectors = np.zeros((10, ne, 8))
    for a, b in _pairs():
        acc = np.zeros((3, 3, ne))
        for g in range(4):
            da, db = dx[g, 3 * a:3 * a + 3], dx[g, 3 * b:3 * b + 3]
            if form == "geometric":
                s = [dq[g, v] for v in range(6)]
                st = [[s[0], s[3], s[4]], [s[3], s[1], s[5]], [s[4], s[5], s[2]]]
                acc[0, 0] += sum(da[i] * (st[i][0] * db[0] + st[i][1] * db[1] + st[i][2] * db[2])
                                 for i in range(3))
                continue
            dbm = np.empty((6, 3, ne))
            for k in range(6):
                dbm[k, 0] = d(g, k, 0) * db[0] + d(g, k, 3) * db[1] + d(g, k, 4) * db[2]
                dbm[k, 1] = d(g, k, 1) * db[1] + d(g, k, 3) * db[0] + d(g, k, 5) * db[2]
                dbm[k, 2] = d(g, k, 2) * db[2] + d(g, k, 4) * db[0] + d(g, k, 5) * db[1]
            for col in range(3):
                acc[0, col] += da[0] * dbm[0, col] + da[1] * dbm[3, col] + da[2] * dbm[4, col]
                acc[1, col] += da[1] * dbm[1, col] + da[0] * dbm[3, col] + da[2] * dbm[5, col]
                acc[2, col] += da[2] * dbm[2, col] + da[0] * dbm[4, col] + da[1] * dbm[5, col]
        for ri in range(3):
            for ci in range(3):
                if a == b and ci < ri:
                    continue
                i, j = 3 * a + ri, 3 * b + ci
                v = (acc[0, 0] if ri == ci else 0.0) if form == "geometric" else acc[ri, ci]
                full[i, j] = full[j, i] = v
                flat = np.zeros(ntiles * tile)
                flat[:ne] = v
                packed[:, _packed_index(i, j)] = flat.reshape(ntiles, tile)
                if a == b:  # the diagonal's sector: the upper values, row-major
                    sectors[a, :, ri * 3 - ri * (ri - 1) // 2 + (ci - ri)] = v
    return full, packed, sectors


@pytest.mark.parametrize("material", MATERIALS)
@pytest.mark.parametrize("form", kernels.FORMS)
def test_kernel_transcription_matches_jax(form, material):
    """The kernel's steps against the JAX package's blocks; its packed tiles
    ``pack_blocks`` of its element-major blocks (the packed index, the
    padding zeros), which are symmetric by construction, and its compact
    diagonal their ``diag_sectors``."""
    c = _case("plate", material)
    tile = kernels.PACK_TILE[F64]
    full, packed, diag = _k3_transcribed(form, c, tile)
    _close(full.transpose(2, 0, 1), _jax_blocks(form, c))
    assert np.array_equal(packed, kernels.pack_blocks(torch.as_tensor(full)).numpy())
    assert np.array_equal(diag, kernels.diag_sectors(torch.as_tensor(full)).numpy())


def test_kernel_table_is_the_elements_table():
    table, weight = _geometry_table()
    assert np.array_equal(table, tel.DSHP10_AT_GP)
    assert np.all(tel.W10 == weight)


# -- K5 ----------------------------------------------------------------------------------


def _jacobi_case(name="plate", seed=8):
    """Elastic blocks of mesh ``name``, its fixmask (the x = 0 plane and a
    seeded tenth of the dofs fixed) and the rebuild's plan."""
    c = _case(name, "one")
    esm = tasm.elastic_stiffness_blocks(t64(c["coords"]), ti(c["eln"]), t64(c["dmat"]))
    fm = (np.random.default_rng(seed).random(3 * c["nn"]) > 0.1).astype(float)
    fm.reshape(-1, 3)[c["coords"][:, 0] < 1e-9, 0] = 0.0
    plan = tasm.jacobi_plan(ti(c["eln"]), c["nn"])
    return c, esm, t64(fm), plan


def _replaced_chain(esm, plan, fixmask):
    """The chain K5 replaced, as it stood: the diagonal slice of (ne, 30,
    30) blocks, K8's write form, the torch tail."""
    ne, nn = esm.shape[0], fixmask.shape[0] // 3
    idx = torch.arange(10)
    diag = esm.reshape(ne, 10, 3, 10, 3)[:, idx, :, idx, :]
    nodal = kernels.segment_sum(diag.reshape(-1, 3, 3).contiguous(), plan, rows=nn)
    m3 = fixmask.reshape(nn, 3)
    eye = torch.eye(3, dtype=F64)
    return inv3_spd(nodal * (m3[:, :, None] * m3[:, None, :]) + (1.0 - m3)[:, :, None] * eye)


def test_jacobi_matches_jax_and_the_chain():
    """Against the JAX package's block Jacobi to ``RTOL``; bit for bit the
    chain it replaced; on the compact diagonal of symmetric blocks bit for
    bit the element-major form; with ``cols`` (the blocks, and their
    diagonal, in a permuted order) bit for bit the unpermuted call."""
    c, esm, fm, plan = _jacobi_case()
    ref = np.asarray(jasm.block_jacobi_inverse_blocks(
        jnp.asarray(esm.numpy()), jnp.asarray(c["eln"]), jnp.asarray(fm.numpy())))
    got = kernels.jacobi_inverse(esm.permute(1, 2, 0), plan, fm)
    _close(got.numpy(), ref)
    assert torch.equal(got, _replaced_chain(esm, plan, fm))
    assert torch.equal(tasm.block_jacobi_inverse_blocks(esm, ti(c["eln"]), fm), got)
    sym = kernels.unpack_blocks(kernels.pack_blocks(esm.permute(1, 2, 0)), c["ne"])
    diag = kernels.diag_sectors(sym)
    assert torch.equal(kernels.jacobi_inverse(diag, plan, fm),
                       kernels.jacobi_inverse(sym, plan, fm))
    perm = torch.as_tensor(np.random.default_rng(2).permutation(c["ne"]))
    cols = torch.argsort(perm)
    assert torch.equal(kernels.jacobi_inverse(sym[:, :, perm], plan, fm, cols=cols),
                       kernels.jacobi_inverse(sym, plan, fm))
    assert torch.equal(kernels.jacobi_inverse(kernels.diag_sectors(sym[:, :, perm]), plan, fm,
                                              cols=cols),
                       kernels.jacobi_inverse(sym, plan, fm))


def test_jacobi_reduce_form():
    """The sum, the caller's reduce, the tail: with an identity reduce the
    fused form's bits; over two halves of the elements (zero weights, as
    the sharded backend pads) summed by the reduce, the whole mesh's to
    ``RTOL``."""
    c, esm, fm, plan = _jacobi_case()
    esm_t = esm.permute(1, 2, 0)
    whole = kernels.jacobi_inverse(esm_t, plan, fm)
    assert torch.equal(kernels.jacobi_inverse(esm_t, plan, fm, reduce=lambda x: x), whole)
    half = torch.arange(c["ne"]) < c["ne"] // 2
    parts = [esm_t * half, esm_t * ~half]

    def reduce(nodal):  # the other part's sum added, as an all_reduce of two ranks
        idx = torch.arange(10)
        diag = parts[1].permute(2, 0, 1).reshape(c["ne"], 10, 3, 10, 3)[:, idx, :, idx, :]
        return nodal + kernels.segment_sum(diag.reshape(-1, 3, 3).contiguous(), plan,
                                           rows=fm.shape[0] // 3)

    _close(kernels.jacobi_inverse(parts[0], plan, fm, reduce=reduce).numpy(), whole.numpy())


def _k5_transcribed(diag, plan, fixmask, units=None):
    """``csrc/jacobi_inverse.cu``'s fused form on K3's compact diagonal (10,
    ne, 8): a thread each unit of ``units`` (3, nu) (each unit's begin and
    end in the plan's order and its row; the kernel's: the plan's units in
    row order; its probe's: any table, the walk among them), its incidences
    in the plan's order, each one sector, the 6 upper values summed from
    zero and mirrored; then the holes; then the tail, each product, sum and
    quotient rounded on its own in the kernel's order."""
    if units is None:
        units = torch.stack([plan.offsets[:-1], plan.offsets[1:], plan.segs])
    units = units.numpy()
    flat = diag.numpy()
    order, holes = plan.order.numpy(), plan.holes.numpy()
    ne = flat.shape[1]
    fm = fixmask.numpy().reshape(-1, 3)
    out = np.empty((fm.shape[0], 3, 3))
    rows = [(row, (begin, end)) for begin, end, row in units.T] + [(h, (0, 0)) for h in holes]
    for row, (begin, end) in rows:
        u = np.zeros(6)
        for p in range(begin, end):
            slot, e = divmod(int(order[p]), ne)
            u = u + flat[slot, e, :6]
        s = u[[0, 1, 2, 1, 3, 4, 2, 4, 5]].reshape(3, 3)
        m = fm[row]
        a = s * (m[:, None] * m[None, :]) + (1.0 - m)[:, None] * np.eye(3)
        det = (a[0, 0] * a[1, 1] * a[2, 2] - a[0, 0] * a[1, 2] * a[2, 1]
               + a[0, 2] * a[1, 0] * a[2, 1] - a[0, 2] * a[1, 1] * a[2, 0]
               + a[0, 1] * a[1, 2] * a[2, 0] - a[0, 1] * a[1, 0] * a[2, 2])
        cof = np.array([
            [a[1, 1] * a[2, 2] - a[2, 1] * a[1, 2], a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2],
             a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]],
            [a[1, 2] * a[2, 0] - a[1, 0] * a[2, 2], a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0],
             a[1, 0] * a[0, 2] - a[0, 0] * a[1, 2]],
            [a[1, 0] * a[2, 1] - a[2, 0] * a[1, 1], a[2, 0] * a[0, 1] - a[0, 0] * a[2, 1],
             a[0, 0] * a[1, 1] - a[1, 0] * a[0, 1]]])
        out[row] = cof / det
    return out


def test_jacobi_transcription_bit_for_bit():
    """The kernel's steps on the compact diagonal, bit for bit the plain
    version on the same (symmetric) blocks: the sum is K8's write form's,
    the tail the torch tail's."""
    c, esm, fm, plan = _jacobi_case("box")
    sym = kernels.unpack_blocks(kernels.pack_blocks(esm.permute(1, 2, 0)), c["ne"])
    want = kernels.jacobi_inverse(sym, plan, fm)
    assert np.array_equal(_k5_transcribed(kernels.diag_sectors(sym), plan, fm), want.numpy())


def test_jacobi_units_by_count_keep_the_bits():
    """K5's threads take the plan's units in row order; its probe
    (``csrc/jacobi_inverse_probe.cu``) takes them in the plan's walk,
    sorted by incidence count, longest first (ties in ascending row), so a
    warp's lanes carry nodes of like counts.  Each node's adds keep the
    plan's order, so the transcription over the walk gives the bits of the
    one in row order; on the plate the walk is not the row order."""
    c, esm, fm, plan = _jacobi_case("plate")
    sym = kernels.unpack_blocks(kernels.pack_blocks(esm.permute(1, 2, 0)), c["ne"])
    diag = kernels.diag_sectors(sym)
    counts = (plan.walk[1] - plan.walk[0]).numpy()
    assert np.all(np.diff(counts) <= 0) and counts.sum() == plan.order.shape[0]
    rows = torch.stack([plan.offsets[:-1], plan.offsets[1:], plan.segs])
    assert not torch.equal(rows, plan.walk)
    by_count = _k5_transcribed(diag, plan, fm, units=plan.walk)
    assert np.array_equal(by_count, _k5_transcribed(diag, plan, fm, units=rows))
    assert np.array_equal(by_count, kernels.jacobi_inverse(sym, plan, fm).numpy())


# -- the wrappers ---------------------------------------------------------------------


@pytest.mark.parametrize("name,ref", [("form_blocks", "form_blocks_ref"),
                                      ("jacobi_inverse", "jacobi_inverse_ref")])
def test_wrapper_has_no_fallback(name, ref):
    """Each wrapper has no ``try`` and calls its plain version once, under a
    test of the tensors' device being the CPU."""
    tree = ast.parse((ROOT / "fcvm_tpu_torch" / "ops" / "kernels.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    ifs = [n for n in ast.walk(fn) if isinstance(n, ast.If)
           and any(isinstance(cl, ast.Call) and getattr(cl.func, "id", None) == ref
                   for b in n.body for cl in ast.walk(b))]
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == ref]
    assert len(calls) == 1 and len(ifs) == 1
    assert "'cpu'" in ast.unparse(ifs[0].test) or '"cpu"' in ast.unparse(ifs[0].test)


def test_wrappers_refuse_what_they_do_not_take():
    """An unknown form, a form's missing input, neither output, and blocks
    of neither layout raise before any launch; CPU tensors count none."""
    c, esm, fm, plan = _jacobi_case("box")
    args = (t64(c["coords"]), ti(c["eln"]))
    before = form_launches()
    with pytest.raises(ValueError):
        kernels.form_blocks("plastic", *args, dmat=t64(c["dmat"]))
    with pytest.raises(ValueError):
        kernels.form_blocks("tangent", *args, dmat=t64(c["dmat"]), sig=t64(c["sig"]))
    with pytest.raises(ValueError):
        kernels.form_blocks("elastic", *args, dmat=t64(c["dmat"]), full=False)
    with pytest.raises(ValueError):
        kernels.jacobi_inverse(esm, plan, fm)  # (ne, 30, 30): not element-major
    kernels.form_blocks("geometric", *args, sig=t64(c["sig"]), packed=True)
    kernels.jacobi_inverse(esm.permute(1, 2, 0), plan, fm)
    assert form_launches() == before
