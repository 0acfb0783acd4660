"""K8, the fixed-order segment sum, and the node sums routed through it, on
the CPU, float64.

* The plan (``kernels.segment_plan``): one stable sort of the keys, its
  groups listed longest first (``walk``, ``long_counts``) and, for the
  write form, the output rows no key names (``holes``); an emulation of
  the kernel's schedule over it (``kernels.ring_groups``: the long
  groups stage by stage through the ring, the rest in register batches,
  each output row from its value or from zero, its rows added in plan
  order) gives ``index_add_``'s bits, into zeros and into an accumulator,
  at the widths the paths give K8 and across both paths; the plain
  version and the plan against the JAX package's ``jax.ops.segment_sum``
  and its ``ScatterPlan`` (``scatter_node_rows``) to 1e-12, for items of 10
  (tet10 elements), 6 (tri6 faces), 3 (edges) and 1 (vertices) nodes.
* Every routed site on CPU tensors gives the parent's ``index_add_`` bits:
  the internal force, the loads, the block products' node pass, the
  block-Jacobi blocks, the coarse Galerkin table, the smoother's blocks,
  the buckling pencil's diagonal and penalty blocks, the sharded
  restriction's cluster sum; the backend's plans of the write-form sites
  know their output rows, as the card needs.
* No atomic scatter-add is left on a CUDA path: every ``index_add_``,
  ``scatter_add_`` or accumulating ``index_put_`` in ``fcvm_tpu_torch`` is
  a plain version that only CPU tensors take.

CPU tensors take the plain version, so no launch is counted.  K8 on the
card is tested in ``test_torch_cuda.py``.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import F64, t64

from fcvm_tpu.models import meshgen
from fcvm_tpu.ops import assembly as asm
from fcvm_tpu_torch.ops import assembly as tasm
from fcvm_tpu_torch.ops import elements as tel
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import precond as tpre
from fcvm_tpu_torch.ops import stress_update as tsu
from fcvm_tpu_torch.runtime import buckling as tbk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12  # max |port - JAX| / max |JAX|: float64 sums in another order


def _close(got, want, rel=RTOL):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def box():
    """A 3 x 2 x 2 box: its elements, the faces and edges on x = 10, the
    nodes on y = 0, and random element blocks (symmetric, as the solver's)."""
    mesh = meshgen.box_tet10(3, 2, 2, 10.0, 6.0, 6.0)
    rng = np.random.default_rng(11)
    a = rng.normal(size=(mesh.n_elements, 30, 30))
    return dict(mesh=mesh, nn=mesh.n_nodes, esm=t64(a + a.transpose(0, 2, 1)),
                items={10: mesh.elnodes,
                       6: mesh.faces_on(lambda x, y, z: x > 10.0 - 1e-9),
                       3: mesh.edges_on(lambda x, y, z: (x > 10.0 - 1e-9) & (y < 1e-9)),
                       1: mesh.select_nodes(lambda x, y, z: y < 1e-9)[:, None]})


def _emulate(vals, plan, out=None, rows=None, aligned=True, stage=32, depth=8):
    """K8's schedule on the CPU (``csrc/segment_sum.cu``), accumulating
    into ``out`` or writing ``rows`` rows: the first ``ring_groups`` groups
    of ``walk`` one after another, stage by stage as the ring delivers them
    (``stage`` rows, the kernel's at the coarse table's widths), each sum
    from its output row's value or from zero adding the stage's rows in
    order; then every other group at once, a register batch of ``depth``
    rows at a time (the kernel's 8: loaded first, a batch past the group's
    end reloading its first row, then added in order); the write form's
    holes zeroed.  Every written row starts as NaN, so a row left unwritten
    shows."""
    write = out is None
    if write:
        out = torch.full((rows, *vals.shape[1:]), float("nan"), dtype=vals.dtype)
    v, o = vals.reshape(vals.shape[0], -1), out.view(out.shape[0], -1)
    nlong = kernels.ring_groups(plan, v.shape[1], vals.element_size(), aligned)
    walk, order = plan.walk.long(), plan.order.long()
    for j in range(nlong):  # the ring path
        begin, end, seg = walk[:, j].tolist()
        acc = torch.zeros_like(o[seg]) if write else o[seg].clone()
        for p in range(begin, end, stage):
            for row in v[order[p:min(p + stage, end)]]:  # a slot
                acc = acc + row
        o[seg] = acc
    begin, end, seg = walk[:, nlong:]  # the register path
    acc = torch.zeros((seg.shape[0], v.shape[1]), dtype=v.dtype) if write else o[seg].clone()
    longest = int((end - begin).max()) if seg.numel() else 0
    for b in range(0, longest, depth):
        p = [begin + b + d for d in range(depth)]
        batch = [v[order[torch.where(q < end, q, begin)]] for q in p]
        for q, rows_d in zip(p, batch):
            live = q < end
            acc[live] = acc[live] + rows_d[live]
    o[seg] = acc
    if write:
        o[plan.holes.long()] = 0.0
    return out


@pytest.mark.parametrize("k", [10, 6, 3, 1])
def test_plan_is_a_stable_sort(box, k):
    """Every row once, grouped by ascending key, each group in ascending
    row order; ``segs`` the distinct keys, ``top`` past the largest."""
    items = t64(box["items"][k]).long()
    plan = kernels.segment_plan(items)
    keys = items.reshape(-1)
    assert plan.order.dtype == plan.offsets.dtype == plan.segs.dtype == torch.int32
    order, offsets = plan.order.long(), plan.offsets.long()
    np.testing.assert_array_equal(np.sort(order.numpy()), np.arange(keys.numel()))
    assert int(offsets[0]) == 0 and int(offsets[-1]) == keys.numel()
    assert torch.equal(plan.segs.long(), torch.unique(keys))
    assert plan.top == int(keys.max()) + 1
    seg_of = torch.repeat_interleave(plan.segs.long(), offsets[1:] - offsets[:-1])
    assert torch.equal(keys[order], seg_of)
    same = seg_of[1:] == seg_of[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())


@pytest.mark.parametrize("k", [10, 6, 3, 1])
def test_kernel_order_is_index_add(box, k):
    """The kernel's order (emulated) gives ``index_add_``'s bits, into
    zeros and into a non-zero accumulator; the wrapper on CPU tensors is
    ``index_add_`` itself and launches nothing."""
    items = t64(box["items"][k]).long()
    plan = kernels.segment_plan(items)
    rng = np.random.default_rng(k)
    vals = t64(rng.normal(size=(items.numel(), 3)))
    start = t64(rng.normal(size=(box["nn"], 3)))
    launches = kernels.segment_sum.launches
    for out0 in (torch.zeros_like(start), start):
        want = out0.clone().index_add_(0, items.reshape(-1), vals)
        assert torch.equal(_emulate(vals, plan, out0.clone()), want)
        assert torch.equal(kernels.segment_sum(vals, plan, out0.clone()), want)
    want = torch.zeros_like(start).index_add_(0, items.reshape(-1), vals)
    written = kernels.segment_plan(items, rows=box["nn"])
    assert torch.equal(_emulate(vals, written, rows=box["nn"]), want)
    assert torch.equal(kernels.segment_sum(vals, written, rows=box["nn"]), want)
    assert kernels.segment_sum.launches == launches


def test_node_incidence_is_the_element_plan(box):
    """K1's incidence CSR is K8's plan of the same elements with a row for
    every node: the plan's order as K1's offsets into its (30, ne) element
    output, and an empty row for each node no element names (the padding
    nodes past the mesh's)."""
    eln = t64(box["mesh"].elnodes).long()
    ne, nn = eln.shape[0], box["nn"] + 5
    inc, plan = tasm.node_incidence(eln, nn), kernels.segment_plan(eln)
    offsets, order = inc.offsets.long(), plan.order.long()
    assert offsets.shape == (nn + 1,) and int(offsets[0]) == 0 and int(offsets[-1]) == 10 * ne
    deg = offsets[1:] - offsets[:-1]
    assert torch.equal(deg[plan.segs.long()], (plan.offsets[1:] - plan.offsets[:-1]).long())
    assert int(deg[box["nn"]:].abs().sum()) == 0
    assert torch.equal(inc.pos.long(), 3 * (order % 10) * ne + order // 10)


@pytest.mark.parametrize("k", [10, 6, 3, 1])
@pytest.mark.parametrize("reference", ["segment_sum", "scatter_plan"])
def test_segment_sum_matches_jax(box, k, reference):
    """The plain version over the plan against the JAX package's node sums
    of the same rows: ``jax.ops.segment_sum`` and ``scatter_node_rows``
    over its ``ScatterPlan``, to 1e-12."""
    items, nn = box["items"][k], box["nn"]
    vals = np.random.default_rng(20 + k).normal(size=(items.size, 3))
    if reference == "segment_sum":
        want = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(items.reshape(-1)),
                                   num_segments=nn)
    else:
        want = asm.scatter_node_rows(jnp.asarray(vals), asm.build_scatter_plan(items, nn))
    plan = kernels.segment_plan(t64(items).long())
    got = kernels.segment_sum(t64(vals), plan, torch.zeros((nn, 3), dtype=F64))
    _close(got, want)
    _close(_emulate(t64(vals), plan, torch.zeros((nn, 3), dtype=F64)), want)


def test_drop_leaves_the_dump_row_to_the_plain_version():
    """A dropped key is out of the plan (the kernel leaves that row alone);
    the plain version still adds into it."""
    keys = torch.tensor([3, 0, 5, 3, 5, 5, 1])
    plan = kernels.segment_plan(keys, drop=5)
    assert plan.segs.tolist() == [0, 1, 3] and plan.top == 4
    assert plan.offsets.tolist() == [0, 1, 2, 4]
    vals = torch.arange(7, dtype=F64)
    out = _emulate(vals, plan, torch.zeros(6, dtype=F64))
    assert out.tolist() == [1.0, 6.0, 0.0, 3.0, 0.0, 0.0]
    assert kernels.segment_sum(vals, plan, torch.zeros(6, dtype=F64))[5] == 2.0 + 4.0 + 5.0
    with pytest.raises(ValueError):
        kernels.segment_plan(keys, drop=5, rows=6)


def test_walk_lists_the_groups_longest_first():
    """``walk`` holds every group once, longest first and ties in
    ascending key order, with its range in ``order`` and its key;
    ``long_counts[k]`` counts the groups of at least 2^k rows; ``holes``
    are the rows below ``rows`` that no key names."""
    rng = np.random.default_rng(5)
    keys = torch.as_tensor(rng.integers(0, 400, size=3000) ** 2 % 997)
    plan = kernels.segment_plan(keys, rows=1000)
    begin, end, seg = plan.walk.long()
    length = end - begin
    offsets = plan.offsets.long()
    order = sorted(range(plan.segs.shape[0]),
                   key=lambda u: (-int(offsets[u + 1] - offsets[u]), int(plan.segs[u])))
    assert seg.tolist() == [int(plan.segs[u]) for u in order]
    assert begin.tolist() == [int(offsets[u]) for u in order]
    assert bool((length[1:] <= length[:-1]).all())
    assert plan.long_counts == tuple(int((length >= 2**k).sum()) for k in range(32))
    named = set(plan.segs.tolist())
    assert plan.holes.tolist() == [r for r in range(1000) if r not in named]
    assert plan.rows == 1000 and plan.top == max(named) + 1


def _groups(rng, long_rows, n_long, nseg, n):
    """Keys of ``n`` rows in ``nseg`` groups, ``n_long`` of them of
    ``long_rows`` rows, the rows in random order."""
    keys = np.concatenate([np.full(long_rows, 3 * k + 1) for k in range(n_long)]
                          + [rng.integers(0, nseg, size=n)])
    return torch.as_tensor(rng.permutation(keys))


# name: (width, dtype, long groups' rows, how many, form, what the schedule must do)
SCHEDULES = {
    "144-wide groups of 10,000 rows, float64": (144, F64, 10_000, 3, "ring"),
    "144-wide groups of 10,000 rows, float32": (144, torch.float32, 10_000, 3, "ring"),
    "144-wide short groups": (144, F64, 0, 0, "register"),
    "width 3": (3, F64, 24, 2, "register"),
    "width 9": (9, F64, 24, 2, "register"),
    "width 24": (24, F64, 24, 2, "register"),
    "width 24, float32": (24, torch.float32, 24, 2, "register"),
    "width 5, float32 (20-byte rows)": (5, torch.float32, 10_000, 1, "register"),
    "144-wide groups, unaligned": (144, F64, 10_000, 1, "unaligned"),
}


@pytest.mark.parametrize("form", ["accumulate", "write"])
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_gives_index_add_bits(name, form):
    """The kernel's schedule (emulated) and the wrapper on CPU tensors give
    ``index_add_``'s bits, into a non-zero accumulator or written into
    zeros with rows that no key names, at the paths' widths: groups longer
    than the ring on the ring path (10,000 rows of 144), short groups and
    narrow rows (3, 9, 24) in register batches, a width whose rows are
    not a multiple of 16 bytes (5 in float32) and unaligned values on the
    register path whatever their length."""
    width, dtype, long_rows, n_long, path = SCHEDULES[name]
    rng = np.random.default_rng(width + long_rows)
    nseg = 700
    keys = _groups(rng, long_rows, n_long, nseg, 3000)
    vals = torch.as_tensor(rng.normal(size=(keys.shape[0], width))).to(dtype)
    rows = nseg + 40  # rows nseg .. nseg + 39 named by no key
    plan = kernels.segment_plan(keys, rows=rows)
    nlong = kernels.ring_groups(plan, width, vals.element_size(), path != "unaligned")
    lengths = (plan.walk[1] - plan.walk[0]).long()
    if path == "ring":
        assert nlong >= n_long and int(lengths[:n_long].min()) >= long_rows
        assert long_rows > 4 * 32  # longer than the kernel's ring of 4 stages of 32 rows
    else:
        assert nlong == 0
    assert len(plan.holes) >= 40
    if form == "write":
        want = torch.zeros((rows, width), dtype=dtype).index_add_(0, keys, vals)
        got = _emulate(vals, plan, rows=rows, aligned=path != "unaligned")
        assert torch.equal(kernels.segment_sum(vals, plan, rows=rows), want)
    else:
        start = torch.as_tensor(rng.normal(size=(rows, width))).to(dtype)
        want = start.clone().index_add_(0, keys, vals)
        got = _emulate(vals, plan, start.clone(), aligned=path != "unaligned")
        assert torch.equal(kernels.segment_sum(vals, plan, start.clone()), want)
    assert torch.equal(got, want)


def test_schedule_skips_the_dump_row():
    """A plan with a dump row on both paths: every other row
    ``index_add_``'s bits, the dump row untouched by the schedule."""
    rng = np.random.default_rng(8)
    keys = _groups(rng, 5000, 2, 300, 4000)
    keys[::3] = 300  # the dump row
    vals = torch.as_tensor(rng.normal(size=(keys.shape[0], 144)))
    start = torch.as_tensor(rng.normal(size=(301, 144)))
    plan = kernels.segment_plan(keys, drop=300)
    assert kernels.ring_groups(plan, 144, 8) >= 2
    want = start.clone().index_add_(0, keys, vals)
    got = _emulate(vals, plan, start.clone())
    assert torch.equal(got[:300], want[:300]) and torch.equal(got[300], start[300])


def test_segment_sum_rejects_what_it_does_not_take(box):
    plan = kernels.segment_plan(torch.tensor([0, 2, 2]))
    with pytest.raises(ValueError):
        kernels.segment_sum(torch.zeros((4, 3), dtype=F64), plan, torch.zeros((3, 3), dtype=F64))
    with pytest.raises(ValueError):
        kernels.segment_sum(torch.zeros((3, 3), dtype=F64), plan, torch.zeros((3, 2), dtype=F64))
    with pytest.raises(ValueError):
        kernels.segment_sum(torch.zeros((3, 3), dtype=F64).T, plan, torch.zeros((3, 3), dtype=F64))
    with pytest.raises(ValueError):
        kernels.segment_plan(torch.tensor([-1, 0]))
    vals, out = torch.zeros((3, 3), dtype=F64), torch.zeros((3, 3), dtype=F64)
    with pytest.raises(ValueError):  # neither form, or both
        kernels.segment_sum(vals, plan)
    with pytest.raises(ValueError):
        kernels.segment_sum(vals, plan, out, rows=3)
    with pytest.raises(ValueError):  # fewer rows than the keys need
        kernels.segment_sum(vals, plan, rows=2)
    with pytest.raises(ValueError):  # another output than the plan's
        kernels.segment_sum(vals, kernels.segment_plan(torch.tensor([0, 2, 2]), rows=4), rows=3)
    with pytest.raises(ValueError):
        kernels.segment_plan(torch.tensor([0, 2, 2]), rows=2)


# -- each routed site bit for bit its parent's index_add_ ----------------------


def test_write_form_plans_know_their_rows():
    """The backend's plans of the write-form sites (the internal force and
    gravity, the load tables, the block-Jacobi blocks) are built with
    their output's rows, as the kernel's write form needs on the card."""
    from fcvm_tpu_torch import FcvmConfig
    from fcvm_tpu_torch.models import meshgen as tmeshgen
    from fcvm_tpu_torch.models.spec import BoundaryConditions, Loads, Material, Model
    from fcvm_tpu_torch.runtime.backend import TorchSystem

    mesh = tmeshgen.box_tet10(2, 2, 2, 10.0, 10.0, 10.0)
    bcs = BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, 0.0, 0.0))])
    faces = mesh.faces_on(lambda x, y, z: x > 10.0 - 1e-9)
    model = Model(mesh, Material(210000.0, 0.3), bcs,
                  Loads(traction_faces=faces, tractions=np.tile([1.0, 0, 0], (len(faces), 1))))
    be = TorchSystem(model, FcvmConfig(device="cpu", dtype="float64"), F64, torch.device("cpu"))
    nn = be.ndof_pad // 3
    plans = (be.node_plan, be.space.jacobi_plan, be.loads.pressure_plan,
             be.loads.traction_plan, be.loads.edge_plan, be.loads.vertex_plan)
    assert [p.rows for p in plans] == [nn] * len(plans)
    assert be.loads.traction_plan.holes.shape[0] == nn - be.loads.traction_plan.segs.shape[0]


def _dofs(nodes):
    return 3 * nodes[..., None] + torch.arange(3)


@pytest.mark.parametrize("k", [10, 6, 3, 1])
def test_load_node_sum_is_the_parents_scatter(box, k):
    """``assembly.node_sum``, the loads' node sum (gravity over elements,
    pressure and traction over faces, edge and point loads), against the
    per-dof ``index_add_`` the loads ran before, bit for bit."""
    nodes = t64(box["items"][k]).long()
    if k == 1:
        nodes = nodes[:, 0]
    nd = 3 * box["nn"] + 9  # padded dofs stay 0
    load = t64(np.random.default_rng(30 + k).normal(size=tuple(nodes.shape) + (3,)))
    want = torch.zeros(nd, dtype=F64).index_add_(0, _dofs(nodes).reshape(-1), load.reshape(-1))
    assert torch.equal(tasm.node_sum(load, nodes, nd), want)
    assert torch.equal(tasm.node_sum(load, nodes, nd, kernels.segment_plan(nodes)), want)


def test_load_functions_route_through_node_sum(box):
    """The load functions end to end against their parent's formula."""
    mesh = box["mesh"]
    coords, faces = t64(mesh.coords), t64(box["items"][6]).long()
    edges = t64(box["items"][3]).long()
    nd = 3 * box["nn"]
    tr = t64(np.random.default_rng(40).normal(size=(faces.shape[0], 3)))
    xsj, _ = tel.tri6_surface_frame(coords[faces])
    shp, w = t64(tel.SHP6_AT_GP), t64(tel.W6)
    load = torch.einsum("gn,fc,fg,g->fnc", shp, tr, xsj.abs(), w)
    want = torch.zeros(nd, dtype=F64).index_add_(0, _dofs(faces).reshape(-1), load.reshape(-1))
    assert torch.equal(tasm.uniform_face_loads(coords, faces, tr, nd), want)
    et = t64(np.random.default_rng(41).normal(size=(edges.shape[0], 3)))
    xsj = tel.line3_jacobian(coords[edges])
    load = torch.einsum("gn,ec,eg,g->enc", t64(tel.SHP2_AT_GP), et, xsj.abs(), t64(tel.W2))
    want = torch.zeros(nd, dtype=F64).index_add_(0, _dofs(edges).reshape(-1), load.reshape(-1))
    assert torch.equal(tasm.edge_loads(coords, edges, et, nd), want)


def test_internal_force_is_the_parents_index_add(box):
    """The internal force's node sum against the per-dof ``index_add_`` of
    the parent, bit for bit, with and without element weights."""
    mesh = box["mesh"]
    eln = t64(mesh.elnodes).long()
    nd = 3 * box["nn"] + 6
    rng = np.random.default_rng(50)
    coords = t64(mesh.coords + 0.01 * rng.normal(size=mesh.coords.shape))
    sig = t64(rng.normal(size=(mesh.n_elements, 4, 6)))
    det, _, bmat = tel.tet10_element_geometry(coords[eln])
    scale = t64(tel.W10) * det.abs()
    weights = t64(rng.uniform(size=mesh.n_elements))
    for wt in (None, weights):
        elv = torch.einsum("egkn,egk,eg->en", bmat, sig, scale)
        if wt is not None:
            elv = elv * wt[:, None]
        want = torch.zeros(nd, dtype=F64).index_add_(0, _dofs(eln).reshape(-1), elv.reshape(-1))
        assert torch.equal(tsu._node_sum(elv, eln, nd), want)
        got = tsu.internal_force_from_stress(coords, eln, sig, torch.zeros(nd, dtype=F64),
                                             weights=wt, plan=kernels.segment_plan(eln))
        assert torch.equal(got, want)


def test_multi_matvec_is_the_parents_index_add(box):
    """The block products' node pass (K̂·V, −Ĝ·V) against the parent's
    ``index_add_`` of K0m's node rows, bit for bit."""
    mesh, esm = box["mesh"], box["esm"]
    eln = t64(mesh.elnodes).long()
    nn, ne = box["nn"], mesh.n_elements
    fm = t64((np.random.default_rng(60).uniform(size=3 * nn) > 0.2).astype(float))
    u = t64(np.random.default_rng(61).normal(size=(3 * nn, 4)))
    esm_t = esm.permute(1, 2, 0).contiguous()
    for ident, neg in ((True, False), (False, True)):
        ue = (fm[:, None] * u).reshape(nn, 3, 4)[eln].reshape(ne, 30, 4)
        out = torch.zeros((nn, 3, 4), dtype=F64)
        out.index_add_(0, eln.reshape(-1), kernels.block_matmat_ref(esm_t, ue).reshape(ne * 10, 3, 4))
        want = fm[:, None] * out.reshape(-1, 4)
        if ident:
            want = want + (1.0 - fm[:, None]) * u
        want = -want if neg else want
        got = tasm.make_multi_matvec(esm_t, tasm.element_dof_ids(eln), fm, ident, neg)(u)
        assert torch.equal(got, want)


def test_block_jacobi_is_the_parents_index_add(box):
    """The block-Jacobi blocks' node sum (slot-major, as before), bit for
    bit, with the plan built inside and given."""
    mesh, esm = box["mesh"], box["esm"]
    eln = t64(mesh.elnodes).long()
    nn, ne = box["nn"], mesh.n_elements
    fm = torch.ones(3 * nn, dtype=F64)
    idx = torch.arange(10)
    diag = esm.reshape(ne, 10, 3, 10, 3)[:, idx, :, idx, :]
    nodal = torch.zeros((nn, 3, 3), dtype=F64)
    nodal.index_add_(0, eln.T.reshape(-1), diag.reshape(-1, 3, 3))
    seen = []
    got = tasm.block_jacobi_inverse_blocks(esm, eln, fm, reduce=lambda x: seen.append(x) or x)
    assert torch.equal(seen[0], nodal)
    again = tasm.block_jacobi_inverse_blocks(esm, eln, fm, plan=tasm.jacobi_plan(eln, nn))
    assert torch.equal(got, again)
    # the buckling penalty mode's blocks: the same sum plus a diagonal
    dvec = t64(np.random.default_rng(70).uniform(1.0, 2.0, size=3 * nn))
    from fcvm_tpu_torch.utils.linalg3 import inv3_spd
    want = inv3_spd(nodal + torch.eye(3, dtype=F64)[None] * dvec.reshape(nn, 3)[:, :, None])
    assert torch.equal(tbk._penalty_block_jacobi(esm, eln, dvec), want)


def test_assembled_diagonal_is_the_parents_index_add(box):
    mesh, esm = box["mesh"], box["esm"]
    eldofs = tasm.element_dof_ids(t64(mesh.elnodes).long())
    nd = 3 * box["nn"] + 3
    want = torch.zeros(nd, dtype=F64).index_add_(
        0, eldofs.reshape(-1), torch.diagonal(esm, dim1=1, dim2=2).reshape(-1))
    assert torch.equal(tbk._assembled_diagonal(esm, eldofs, nd), want)


def _parent_coarse_accumulate(esm, elnodes, qmat, cluster_size, chunk):
    ne, nm = esm.shape[0], qmat.shape[2]
    ncl = qmat.shape[0] // cluster_size
    kc = torch.zeros((ncl * ncl, nm * nm), dtype=esm.dtype)
    eye10 = torch.eye(10, dtype=esm.dtype)
    for s in range(0, ne, chunk):
        esm_c, eln_c = esm[s:s + chunk], elnodes[s:s + chunk]
        c = esm_c.shape[0]
        qt = torch.einsum("ciax,ij->cixja", qmat[eln_c], eye10).reshape(c, 10 * nm, 30)
        s_blk = qt @ esm_c @ qt.transpose(1, 2)
        pair = s_blk.reshape(c, 10, nm, 10, nm).permute(0, 1, 3, 2, 4).reshape(c * 100, nm * nm)
        ci = eln_c // cluster_size
        kc.index_add_(0, (ci[:, :, None] * ncl + ci[:, None, :]).reshape(-1), pair)
    return kc


@pytest.mark.parametrize("chunk", [8192, 7])
def test_coarse_accumulate_is_the_parents_index_add(box, chunk):
    """The coarse Galerkin table, chunk by chunk, bit for bit."""
    mesh, esm = box["mesh"], box["esm"]
    eln = t64(mesh.elnodes).long()
    nd = 3 * (-(-box["nn"] // 16) * 16)
    fm = torch.ones(nd, dtype=F64)
    qmat = tpre.qmat_bc(t64(mesh.coords), fm, 16, 12)
    want = _parent_coarse_accumulate(esm, eln, qmat, 16, chunk)
    assert torch.equal(tpre.coarse_accumulate(esm, eln, qmat, 16, chunk=chunk), want)


@pytest.mark.parametrize("chunk", [4096, 9])
def test_smoother_blocks_are_the_parents_index_add(box, chunk):
    """The cluster smoother's blocks, summed over one plan of every
    element (the dump row skipped by the kernel, added by the plain
    version and cut away by both), bit for bit the parent's chunks of
    ``chunk`` elements summed one after another."""
    mesh, esm = box["mesh"], box["esm"]
    eln = t64(mesh.elnodes).long()
    cs = 16
    nn_pad = -(-box["nn"] // cs) * cs
    fm = t64((np.random.default_rng(80).uniform(size=3 * nn_pad) > 0.1).astype(float))
    ncl, m = nn_pad // cs, 3 * cs
    nrow = ncl * m * cs
    acc = torch.zeros((nrow + 1, 3), dtype=F64)
    a3 = torch.arange(3)
    for s in range(0, esm.shape[0], chunk):
        esm_c, eln_c = esm[s:s + chunk], eln[s:s + chunk]
        cid, loc = eln_c // cs, eln_c % cs
        pair = esm_c.reshape(-1, 10, 3, 10, 3).permute(0, 1, 3, 2, 4)
        key = (cid[:, :, None, None] * m + 3 * loc[:, :, None, None] + a3) * cs \
            + loc[:, None, :, None]
        key = torch.where((cid[:, :, None] == cid[:, None, :])[..., None], key, nrow)
        acc.index_add_(0, key.reshape(-1), pair.reshape(-1, 3))
    mask = fm.reshape(ncl, m)
    want = acc[:-1].reshape(ncl, m, m).mul_(mask[:, :, None]).mul_(mask[:, None, :])
    want.diagonal(dim1=1, dim2=2).add_(1.0 - mask)
    assert torch.equal(tpre.cluster_diag_blocks(esm, eln, fm, cs), want)


def test_cluster_restriction_is_the_parents_index_add():
    """The node-partitioned solve's restriction: a rank's node rows summed
    into clusters over the plan of their ascending cluster ids (a range not
    cut at cluster boundaries) equals ``index_add_``."""
    rows = t64(np.random.default_rng(90).normal(size=(100, 12)))
    cid = torch.arange(37, 137) // 24
    want = torch.zeros((6, 12), dtype=F64).index_add_(0, cid, rows)
    got = kernels.segment_sum(rows, kernels.segment_plan(cid), torch.zeros((6, 12), dtype=F64))
    assert torch.equal(got, want)


# -- nothing atomic on a CUDA path ----------------------------------------------

ATOMIC = {"index_add_", "index_add", "scatter_add_", "scatter_add", "scatter_reduce_",
          "scatter_reduce", "index_reduce_", "index_reduce"}
# the plain versions of K1 and K8: they run only for CPU tensors
ALLOWED = {("fcvm_tpu_torch/ops/kernels.py", "khat_matvec_ref"),
           ("fcvm_tpu_torch/ops/kernels.py", "segment_sum_ref")}


def _atomic_uses():
    uses = set()
    pkg = os.path.join(ROOT, "fcvm_tpu_torch")
    for base, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(base, name)
            rel = os.path.relpath(path, ROOT)
            with open(path) as f:
                tree = ast.parse(f.read())
            for fn in ast.walk(tree):
                if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
                    continue
                for node in ast.walk(fn):
                    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                        continue
                    attr = node.func.attr
                    accumulate = attr in ("index_put_", "index_put") and any(
                        kw.arg == "accumulate" and not (isinstance(kw.value, ast.Constant)
                                                        and kw.value.value is False)
                        for kw in node.keywords)
                    if attr in ATOMIC or accumulate:
                        owner = fn.name if not isinstance(fn, ast.Module) else "<module>"
                        uses.add((rel, owner, node.lineno))
    return uses


def test_no_atomic_scatter_on_a_cuda_path():
    """Every ``index_add_``, ``scatter_add_``, ``scatter_reduce_``,
    ``index_reduce_`` or accumulating ``index_put_`` in ``fcvm_tpu_torch``
    sits in a plain version that only CPU tensors take (K1's and K8's);
    a new one anywhere else fails here.  Innermost function of each use."""
    inner = {}
    for rel, owner, line in sorted(_atomic_uses()):
        if owner != "<module>":
            inner[(rel, line)] = owner
    sites = {(rel, owner) for (rel, _), owner in inner.items()}
    assert sites == ALLOWED, sorted(sites - ALLOWED)
