"""The port's sharded ``solve_collapse`` against the JAX package's, part 2.

The remaining driver cases of ``tests/test_sharded_driver.py``, run as in
``test_torch_sharded_driver.py`` (whose docstring states the comparison):
a world where ranks own only padding, per-element materials, the
Crisfield arc length, the node-partitioned CG, the recycling tiers, and
the ranks' agreement bit for bit with every tier on.
"""

import numpy as np
import torch_sharded_ranks as ranks
from test_sharded_driver import _box_model
from test_torch_sharded_driver import GNL, PLASTIC, sharded_case
from torch_parity import SHARD_CG_RTOL, assert_ranks_identical, jax_collapse

import fcvm_tpu
import fcvm_tpu_torch as ft
from fcvm_tpu.models import meshgen


def test_sharded_ranks_owning_only_padding_match_jax():
    """6 elements on 4 ranks: 8 slots, the last rank holds padding only."""
    mesh = meshgen.box_tet10(1, 1, 1, 10.0, 10.0, 10.0)
    assert mesh.n_elements == 6
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets([
        (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
        (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
        (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
    ])
    faces = mesh.faces_on(lambda x, y, z: x > 10.0 - 1e-9)
    loads = fcvm_tpu.Loads(traction_faces=faces,
                           tractions=np.tile([100.0, 0, 0], (len(faces), 1)))
    model = fcvm_tpu.Model(mesh, fcvm_tpu.Material(210000.0, 0.3), bcs, loads, name="tiny")
    sharded_case(model, dict(PLASTIC, nstep=3), 4)


def test_sharded_multi_material_matches_jax():
    """Per-element E follows the element partition: a two-material bar."""
    length = 10.0
    mesh = meshgen.box_tet10(2, 2, 6, 2.0, 2.0, length)
    cent_z = mesh.coords[mesh.elnodes[:, :4], 2].mean(axis=1)
    mbe = np.where((cent_z < length / 2)[:, None], np.array([[100000.0, 0.3, 0.0]]),
                   np.array([[200000.0, 0.3, 0.0]]))
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets([
        (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
        (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
        (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
    ])
    faces = mesh.faces_on(lambda x, y, z: z > length - 1e-9)
    loads = fcvm_tpu.Loads(traction_faces=faces,
                           tractions=np.tile([0, 0, 100.0], (len(faces), 1)))
    model = fcvm_tpu.Model(mesh, fcvm_tpu.Material(1.0, 0.3), bcs, loads, name="mm",
                           materials_by_element=mbe)
    port = sharded_case(model, dict(PLASTIC, nstep=4), 2)
    assert max(port["peeqmax"]) > 1e-6  # the soft half yields


def test_sharded_crisfield_arc_matches_jax():
    port = sharded_case(_box_model(), dict(GNL, nstep=5), 2, {"arc_length": "crisfield"},
                        {"arc_length": "crisfield"})
    assert max(port["peeqmax"]) > 1e-6


def test_node_partition_driver_matches_jax():
    """``node_partition``: every PCG on the ranks' row slices."""
    port = sharded_case(_box_model(), dict(GNL, nstep=5), 4, {"node_partition": True},
                        {"node_partition": True})
    assert max(port["peeqmax"]) > 1e-6


def _deflated(world):
    """The plastic GNL box with every recycling tier on (residual and load
    harvests forced by ``deflation_min_iters = 5``) on ``world`` ranks."""
    return ranks.world(world, ranks.solve, ft.model_from_arrays(_box_model()),
                       dict(GNL, nstep=6),
                       dict(cg_rtol=SHARD_CG_RTOL, deflation=True, load_deflation=True,
                            deflation_min_iters=5))


def test_sharded_driver_deflation_matches_jax():
    """Recycling on: harvests, retention, deflated correction and predictor
    solves all run sharded.  Deflated solves stop wherever the tolerance
    falls, so the histories agree to the solver's accuracy, the bars of
    ``tests/test_sharded_driver.py:389-391``."""
    outs = _deflated(2)
    assert_ranks_identical(outs)
    port = outs[0]
    assert any("deflation space: k=" in ln for ln in port["lines"])
    assert any("load-deflation space" in ln for ln in port["lines"])
    assert max(port["peeqmax"]) > 1e-6
    fields = dict(deflation=True, load_deflation=True, deflation_min_iters=5)
    for n in (0, 2):
        ref, _ = jax_collapse(_box_model(), dict(GNL, nstep=6), n, **fields)
        np.testing.assert_allclose(port["lbd"], ref.history.lbd, rtol=0, atol=5e-7)
        np.testing.assert_allclose(port["un"], ref.history.un, rtol=0, atol=1e-7)
        np.testing.assert_allclose(port["disp_total"], ref.disp_total, rtol=0, atol=1e-7)


def test_ranks_agree_bit_for_bit():
    """Four ranks with every tier on, restarts and GNL refreshes: every
    rank's history, CG count of every solve, harvest record, log and
    gathered field are the same bits (each host decision is taken from
    all-reduced values by deterministic operations,
    :mod:`fcvm_tpu_torch.parallel.system`)."""
    outs = _deflated(4)
    assert len(outs) == 4 and [o["rank"] for o in outs] == [0, 1, 2, 3]
    assert_ranks_identical(outs)
    assert outs[0]["harvests"] and outs[0]["predictor_solves"] > 0
