"""K1m's compacted tables and its two-stage node sum, on the CPU.

K1m (``kernels.khat_matmat``, ``csrc/khat_matmat.cu``) sums, in its
element pass, each node's rows of the sub-tile of its first incidence into
one partial row, and writes every later incidence as its own row; its node
pass adds a node's partial and then its later rows (``kernels.K1mTables``,
built by ``kernels.k1m_tables``).  These tests hold, with no card:

* the tables on the 3x3x3 box and a beam in their solve spaces and on a
  ragged random connectivity, at the kernel's sub-tile and at another:
  every incidence in exactly one row, each row under one node with its
  incidences in table order, each node's rows its partial first and then
  its later incidences in table order, the partial exactly the node's
  incidences in its first sub-tile, and the offsets consistent;
* a plain emulation of the two-stage sum in float64 against K1m's plain
  version (``khat_matmat_ref``) and the JAX package's ``_multi_matvec``,
  in the three forms, to ``RTOL`` = 1e-12 of the largest value;
* the same emulation in float32 with plain adds equal, bit for bit, to
  K1's one-stage sum of the same element rows (each node's incidences from
  0 in table order): the prefix property that keeps K1's bits on the card;
* the sub-tile of the tables is the kernel's.

The inputs are made from numpy seeds.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import E, F64, NU, t64, ti

from fcvm_tpu.models import meshgen as jmeshgen
from fcvm_tpu.ops import assembly as jasm
from fcvm_tpu.ops import material as jmat
from fcvm_tpu.runtime import buckling as jbk
from fcvm_tpu_torch.models import meshgen
from fcvm_tpu_torch.ops import assembly as tasm
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.runtime.system import build_solve_space
from fcvm_tpu_torch.utils.indexing import pad_ndof

RTOL = 1e-12  # max |two-stage - reference| / max |reference|: float64 sums in another order
MESHES = ("box", "beam", "ragged")


def _incidence(name):
    """(elnodes (ne, 10), node count, NodeIncidence): the 3x3x3 box and a
    20 x 2 x 2 beam cut to 24 x 3 x 3 cells in their Morton solve spaces,
    or 1001 elements of ten distinct random nodes near node e nn / ne over
    1500 nodes (no whole sub-tile at the end)."""
    if name == "ragged":
        rng = np.random.default_rng(7)
        ne, nn = 1001, 1500
        base = np.arange(ne)[:, None] * nn // ne
        eln = torch.as_tensor((base + np.argsort(rng.random((ne, 40)), axis=1)[:, :10]) % nn)
    else:
        mesh = (meshgen.box_tet10(3, 3, 3, 10.0, 10.0, 10.0) if name == "box"
                else meshgen.box_tet10(24, 3, 3, 20.0, 2.0, 2.0))
        nd = pad_ndof(mesh.ndof)
        sp = build_solve_space(mesh.coords, mesh.elnodes, torch.ones(nd, dtype=F64), nd)
        eln, nn = sp.elnodes_m, nd // 3
    return eln, nn, tasm.node_incidence(eln, nn)


def _table_order(inc):
    """Each incidence of K1's table in its order: (node, element-major id
    10 e + slot)."""
    ne, nn = inc.elnodes_t.shape[1], inc.offsets.shape[0] - 1
    offsets, pos = inc.offsets.long(), inc.pos.long()
    node = torch.repeat_interleave(torch.arange(nn), offsets[1:] - offsets[:-1])
    return node, 10 * (pos % ne) + pos // (3 * ne)


def _row_ents(tab):
    """Each row's first entry of ``ents``, and the end: (R + 1,)."""
    return torch.searchsorted(tab.ent_rows.long(), torch.arange(tab.node_rows.shape[0] + 1))


def _row_ids(tab, sub):
    """Each entry of ``ents`` as its element-major incidence id: sub-tile
    ``b``'s entries start at ``10 sub b``."""
    return 10 * sub * (torch.arange(tab.ents.shape[0]) // (10 * sub)) + tab.ents.long()


def _ordered_sum(vals, starts, lengths):
    """Rows ``sum_j vals[starts + j]`` for j < lengths, each from 0 in
    that order with plain adds (the kernels' order)."""
    out = torch.zeros((starts.shape[0],) + vals.shape[1:], dtype=vals.dtype)
    for j in range(int(lengths.max()) if lengths.numel() else 0):
        live = lengths > j
        out[live] = out[live] + vals[starts[live] + j]
    return out


def two_stage(vals, inc, tab, sub=kernels.K1M_SUB):
    """K1m's node sums of element rows ``vals`` (10 ne, ...) indexed by
    ``10 e + slot``: the compacted rows from 0 in ``ents`` order, then each
    node's rows from 0 in ``node_rows`` order.  (nn, ...)."""
    row_ents = _row_ents(tab)
    rows = _ordered_sum(vals[_row_ids(tab, sub)], row_ents[:-1], row_ents[1:] - row_ents[:-1])
    return _ordered_sum(rows[tab.node_rows.long()], tab.node_offsets[:-1].long(),
                        (tab.node_offsets[1:] - tab.node_offsets[:-1]).long())


def one_stage(vals, inc):
    """K1's node sum: each node's incidences from 0 in table order."""
    _, k = _table_order(inc)
    return _ordered_sum(vals[k], inc.offsets[:-1].long(),
                        (inc.offsets[1:] - inc.offsets[:-1]).long())


@pytest.mark.parametrize("sub", [kernels.K1M_SUB, 8])
@pytest.mark.parametrize("name", MESHES)
def test_k1m_tables_cover_each_incidence_once_in_table_order(name, sub):
    eln, nn, inc = _incidence(name)
    ne = eln.shape[0]
    assert inc.k1m is None  # the CPU's plain version needs no tables
    tab = kernels.k1m_tables(inc, sub)
    assert all(t.dtype == torch.int32 and t.dim() == 1 for t in tab)
    nrows = tab.node_rows.shape[0]
    ent_rows, node_offsets = tab.ent_rows.long(), tab.node_offsets.long()
    # rows: every one non-empty, numbered in order, sub-tile by sub-tile
    assert tab.ents.shape == ent_rows.shape == (10 * ne,)
    assert int(ent_rows[0]) == 0 and int(ent_rows[-1]) == nrows - 1
    steps = ent_rows[1:] - ent_rows[:-1]
    assert bool(((steps == 0) | (steps == 1)).all())
    starts = 10 * sub * torch.arange(-(-ne // sub))
    assert bool((steps[starts[1:] - 1] == 1).all())  # no row crosses a sub-tile
    row_ents = _row_ents(tab)
    assert node_offsets.shape == (nn + 1,) and int(node_offsets[0]) == 0
    assert int(node_offsets[-1]) == nrows
    assert torch.equal(torch.sort(tab.node_rows.long()).values, torch.arange(nrows))
    # every incidence exactly once, in a row of its element's sub-tile
    ids = _row_ids(tab, sub)
    assert torch.equal(torch.sort(ids).values, torch.arange(10 * ne))
    assert bool((tab.ents.long() < 10 * sub).all())
    # each row one node's, its incidences ascending (table order)
    node_of = eln.reshape(-1)[ids]
    row = torch.repeat_interleave(torch.arange(nrows), row_ents[1:] - row_ents[:-1])
    same = row[1:] == row[:-1]
    assert bool((node_of[1:][same] == node_of[:-1][same]).all())
    assert bool((ids[1:][same] > ids[:-1][same]).all())
    # each node's rows: its table, the first sub-tile's incidences as the partial
    tnode, tk = _table_order(inc)
    firsts = ids[row_ents[:-1]]
    for n in np.random.default_rng(sub).choice(nn, size=min(nn, 300), replace=False):
        mine = tk[tnode == int(n)]
        rows = tab.node_rows[node_offsets[n]:node_offsets[n + 1]].long()
        if mine.numel() == 0:
            assert rows.numel() == 0
            continue
        in_first = mine // (10 * sub) == mine[0] // (10 * sub)
        partial = ids[row_ents[rows[0]]:row_ents[rows[0] + 1]]
        assert torch.equal(partial, mine[in_first])
        assert torch.equal(firsts[rows[1:]], mine[~in_first])
        assert all(int(row_ents[r + 1] - row_ents[r]) == 1 for r in rows[1:])


def test_k1m_sub_tile_is_the_kernels():
    src = (kernels.CSRC / "khat_matmat.cu").read_text()
    assert int(re.search(r"constexpr int kSub = (\d+);", src).group(1)) == kernels.K1M_SUB


def _jax_case(name, rng):
    """(blocks (ne, 30, 30), elnodes (ne, 10), fixmask, nn): the
    clamped 3 x 2 x 2 box's elastic blocks, or seeded symmetric blocks on
    the ragged connectivity with a tenth of the dofs fixed."""
    if name == "box":
        mesh = jmeshgen.box_tet10(3, 2, 2, 10.0, 6.0, 6.0)
        nd = pad_ndof(mesh.ndof)
        eln = np.asarray(mesh.elnodes)
        blocks = np.asarray(jasm.elastic_stiffness_blocks(
            jnp.asarray(mesh.coords), jnp.asarray(eln),
            jmat.hooke_dmat(jnp.float64(E), jnp.float64(NU))))
        fm = np.ones(nd)
        fixed = 3 * mesh.select_nodes(lambda x, y, z: x < 1e-9)
        fm[np.concatenate([fixed, fixed + 1, fixed + 2])] = 0.0
        return blocks, eln, fm, nd // 3
    eln, nn, _ = _incidence("ragged")
    a = rng.normal(size=(eln.shape[0], 30, 30))
    return a + a.transpose(0, 2, 1), eln.numpy(), (rng.random(3 * nn) > 0.1) * 1.0, nn


FORMS = {"masked": (True, True, False), "projected_negated": (True, False, True),
         "raw": (False, False, False)}  # (with fixmask, identity_on_fixed, negate)


@pytest.mark.parametrize("m", [3, 37])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("name", ["box", "ragged"])
def test_two_stage_sum_matches_plain_and_jax(name, form, m):
    """K1m's two-stage order in float64 (element rows of K0m's plain
    version, then :func:`two_stage`, the masks and the sign) against
    ``khat_matmat_ref`` and the JAX package's ``_multi_matvec``."""
    rng = np.random.default_rng(m)
    blocks, eln, fm, nn = _jax_case(name, rng)
    masked, ident, neg = FORMS[form]
    u = rng.normal(size=(3 * nn, m))
    inc = tasm.node_incidence(ti(eln), nn)
    esm_t = t64(blocks).permute(1, 2, 0).contiguous()
    pm = t64(fm)[:, None] if masked else None
    v = t64(u) if pm is None else pm * t64(u)
    ne = eln.shape[0]
    ue = v.reshape(nn, 3, m)[ti(eln)].reshape(ne, 30, m)
    vals = kernels.block_matmat_ref(esm_t, ue).reshape(10 * ne, 3, m)
    got = two_stage(vals, inc, kernels.k1m_tables(inc)).reshape(3 * nn, m)
    if masked:
        got = pm * got + ((1.0 - pm) * t64(u) if ident else 0.0)
    got = -got if neg else got
    want = kernels.khat_matmat_ref(esm_t, inc, t64(u), t64(fm) if masked else None, ident, neg)
    assert float((got - want).abs().max()) <= RTOL * float(want.abs().max())
    jfm = jnp.asarray(fm if masked else np.ones(3 * nn))
    jwant = np.asarray(jbk._multi_matvec(jasm.element_dof_ids(jnp.asarray(eln)), jfm, ident,
                                         negate=neg)(jnp.asarray(blocks), jnp.asarray(u)))
    assert float(np.abs(got.numpy() - jwant).max()) <= RTOL * np.abs(jwant).max()


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("name", MESHES)
def test_two_stage_sum_is_k1s_sum_bit_for_bit_in_float32(name, m):
    """The prefix property: in float32 with plain adds, the partial of a
    node's first-sub-tile rows and then its later rows give K1's running
    sum over its incidences, bit for bit, at the kernel's sub-tile and at
    another; element rows of mixed magnitudes, so rounding shows."""
    eln, nn, inc = _incidence(name)
    rng = np.random.default_rng(100 + m)
    vals = rng.normal(size=(10 * eln.shape[0], 3, m)) * 10.0 ** rng.integers(-4, 5, (1, 1, m))
    vals = torch.as_tensor(vals, dtype=torch.float32)
    want = one_stage(vals, inc)
    for sub in (kernels.K1M_SUB, 16):
        got = two_stage(vals, inc, kernels.k1m_tables(inc, sub), sub)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # and not by chance: each node's incidences in reverse order give other bits
    _, k = _table_order(inc)
    lengths = (inc.offsets[1:] - inc.offsets[:-1]).long().flip(0)
    starts = torch.cumsum(lengths, 0) - lengths
    backwards = _ordered_sum(vals[k.flip(0)], starts, lengths).flip(0)
    assert not torch.equal(backwards, want)
