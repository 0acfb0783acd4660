"""The port's sharded ``solve_collapse`` against the JAX package's, part 1.

Each case of ``tests/test_sharded_driver.py`` runs the port's
:class:`~fcvm_tpu_torch.parallel.system.ShardedSystem` on a gloo world of 1,
2 or 4 CPU ranks (``torch.multiprocessing``, one process per rank, float64)
and the JAX package twice on the same model: its ``ShardedSystem`` over the
same number of devices (conftest's virtual CPU mesh) and its single-device
``LocalSystem``.  Every rank must return the same history bit for bit, and
that history must match both JAX runs to ``_assert_history_match``'s
tolerances (:func:`torch_parity.assert_history_match`, which also states
how ``crip`` is compared) and the port's own single-device run in its CG
counts, each solve within one iteration (:func:`torch_parity.assert_cg_match`).  Both packages solve to
``cg_rtol = 1e-12`` with the solver tiers off.

Part 2 (``test_torch_sharded_paths.py``) has the remaining driver paths,
``test_torch_sharded_ops.py`` the backend's pieces, the collectives, the
checkpoints and the CLI, ``test_torch_sharded_buckling.py`` the eigensolve.
"""

import torch_sharded_ranks as ranks
from test_sharded_driver import _box_model, _disp_model
from torch_parity import (
    SHARD_CG_RTOL,
    assert_cg_match,
    assert_history_match,
    assert_ranks_identical,
    jax_collapse,
)

import fcvm_tpu_torch as ft

PLASTIC = dict(sig_yield=60.0, error_max=1e-11, et_e=0.1, target_lf=99.0)
GNL = dict(PLASTIC, gnl="GNLY", max_imp=0.0)


def sharded_case(model, params_kw, world, port_kw=None, jax_fields=None):
    """Run ``model`` on a port world of ``world`` ranks and on the JAX
    package (sharded over ``world`` devices, and on one); assert the ranks
    agree and match both; return rank 0's summary."""
    jax_fields = jax_fields or {}
    port_kw = {"cg_rtol": SHARD_CG_RTOL, **(port_kw or {})}
    outs = ranks.world(world, ranks.solve, ft.model_from_arrays(model), params_kw, port_kw)
    assert_ranks_identical(outs)
    port = outs[0]
    assert port["backend"] == "ShardedSystem"
    local = ranks.solve(ft.model_from_arrays(model), params_kw,
                        {**port_kw, "force_sharded": False, "node_partition": False})
    assert local["backend"] == "TorchSystem"
    assert_cg_match(port, local)
    sharded = {"force_sharded": True} if world == 1 else {}
    ref, lines = jax_collapse(model, params_kw, 0, **jax_fields)
    sref, slines = jax_collapse(model, params_kw, world, **sharded, **jax_fields)
    assert_history_match(port, ref, lines)
    assert_history_match(port, sref, slines)
    return port


def test_sharded_plastic_gnl_collapse_matches_jax():
    port = sharded_case(_box_model(), dict(GNL, nstep=6), 4)
    assert max(port["peeqmax"]) > 1e-6  # plasticity happened
    assert port["predictor_solves"] > 0


def test_force_sharded_world_of_one_matches_jax():
    """``force_sharded`` runs the sharded code on a world of one, as the JAX
    package's ``force_sharded`` runs its ``shard_map`` kernels on one chip."""
    port = sharded_case(_box_model(), dict(GNL, nstep=5), 1, {"force_sharded": True})
    assert max(port["peeqmax"]) > 1e-6


def test_sharded_geometric_linear_plastic_matches_jax():
    port = sharded_case(_box_model(), dict(PLASTIC, nstep=5), 2)
    assert max(port["peeqmax"]) > 1e-6


def test_sharded_displacement_control_matches_jax():
    port = sharded_case(_disp_model(), dict(PLASTIC, sig_yield=500.0, nstep=4), 2)
    assert port["load"][-1] > 0  # the reaction level is recorded


def test_sharded_restart_path_matches_jax():
    """Divergence restarts forced by a tiny ``iterat_max``."""
    port = sharded_case(_box_model(), dict(PLASTIC, nstep=4, iterat_max=2), 4)
    assert any("RESTART" in ln for ln in port["lines"])


def test_sharded_uneven_element_count_matches_jax():
    """162 elements on 4 ranks: the last rank holds two padding elements."""
    model = _box_model(3)
    assert model.mesh.n_elements % 4 == 2
    sharded_case(model, dict(PLASTIC, sig_yield=240.0, nstep=3), 4)
