"""The port's sharded buckling eigensolve and float32 tiers against the JAX package.

The buckling cases of ``tests/test_sharded_driver.py`` on gloo worlds of
CPU ranks (float64 unless stated): the pencil eigensolve of the sharded
backend (K0m and one all_reduce per ``K_hat @ V`` and ``-G_hat @ V``, the
inner block solves and the deep harvest through the sharded operator) with
imperfection seeding and GNL steps; its float32 breakdown falling back to
the single-device ladder; the penalty boundary condition, which runs the
single-device tier; the recycled inverse leaving the factors where they
are; and the float64 residual refinement over a float32 sharded run.
Every rank must return the same result bit for bit.
"""

import re

import numpy as np
import torch_sharded_ranks as ranks
from test_sharded_driver import _box_model
from torch_parity import SHARD_CG_RTOL, assert_ranks_identical, jax_collapse

import fcvm_tpu
import fcvm_tpu_torch as ft
from fcvm_tpu.models import meshgen

IMPERFECT = dict(sig_yield=1e5, nstep=3, error_max=1e-10, et_e=0.0, target_lf=1e9,
                 gnl="GNLY", max_imp=0.05, ev1=1.0, ev2=0.0)


def _column():
    """The clamped 1 x 1 x 20 column under an end compression of
    ``tests/test_sharded_driver.py:195-215``."""
    length = 20.0
    mesh = meshgen.box_tet10(2, 2, 8, 1.0, 1.0, length)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: z < 1e-9), (0.0, 0.0, 0.0))])
    faces = mesh.faces_on(lambda x, y, z: z > length - 1e-9)
    loads = fcvm_tpu.Loads(traction_faces=faces, tractions=np.tile([0, 0, -1.0], (len(faces), 1)))
    return fcvm_tpu.Model(mesh, fcvm_tpu.Material(210000.0, 0.3), bcs, loads, name="col")


def _port(world, params_kw, **cfg):
    outs = ranks.world(world, ranks.solve, ft.model_from_arrays(_column()), params_kw,
                       {"cg_rtol": SHARD_CG_RTOL, **cfg})
    assert_ranks_identical(outs)
    return outs[0]


def _match(port, ref, vec_atol=1e-7):
    np.testing.assert_allclose(port["eigenvalues"], ref.eigenvalues, rtol=1e-8)
    np.testing.assert_allclose(np.abs(port["eigenvectors"]), np.abs(ref.eigenvectors),
                               atol=vec_atol)
    np.testing.assert_allclose(port["lbd"], ref.history.lbd, rtol=0, atol=1e-9)
    np.testing.assert_allclose(port["un"], ref.history.un, rtol=0, atol=1e-9)


def test_sharded_buckling_and_imperfection_matches_jax():
    """The sharded pencil eigensolve, seeding and three GNL steps on two
    ranks against the JAX package's sharded and single-device runs."""
    port = _port(2, IMPERFECT)
    rec = port["buckling"]
    assert len(rec) == 1 and rec[0]["sharded"] and rec[0]["error"] is None
    for n in (0, 2):
        ref, _ = jax_collapse(_column(), IMPERFECT, n)
        _match(port, ref)


def test_sharded_buckling_breakdown_falls_back_to_local_ladder():
    """A breakdown of the sharded eigensolve escalates through the
    single-device ladder on the gathered arrays (rank 0's result on every
    rank); the analysis stays sharded."""
    outs = ranks.world(2, ranks.breakdown_once, ft.model_from_arrays(_column()), IMPERFECT,
                       {"cg_rtol": SHARD_CG_RTOL})
    assert_ranks_identical(outs)
    port = outs[0]
    assert port["backend"] == "ShardedSystem"
    assert port["eigensolves"] >= 2
    assert any("escalating" in w for w in port["warnings"])
    assert port["buckling"][0]["error"] == "forced breakdown (test)"
    ref, _ = jax_collapse(_column(), IMPERFECT, 0)
    _match(port, ref)


def test_sharded_buckling_honors_penalty_bc():
    """``buckling_bc="penalty"`` runs the single-device penalty pencil."""
    port = _port(2, IMPERFECT, buckling_bc="penalty")
    assert not port["buckling"][0].get("sharded")
    for n in (0, 2):
        ref, _ = jax_collapse(_column(), IMPERFECT, n, buckling_bc="penalty")
        np.testing.assert_allclose(port["eigenvalues"], ref.eigenvalues, rtol=1e-10)
        np.testing.assert_allclose(port["lbd"], ref.history.lbd, rtol=0, atol=1e-9)


def test_sharded_buckling_deflation_keeps_the_factors():
    """The recycled ``K_hat^-1`` (one deep harvest) of the sharded eigensolve
    leaves the factors where the undeflated one puts them."""
    params = dict(gnl="GNLY", nstep=1)
    on = _port(2, params, deflation=True, deflation_min_iters=5)
    off = _port(2, params)
    assert on["buckling"][0]["harvest"]["kept"] > 0
    np.testing.assert_allclose(on["eigenvalues"], off["eigenvalues"], rtol=1e-8)


def test_sharded_refinement_tier_converges_below_f32_floor():
    """A float32 run on four ranks with the default tiers reaches an
    ``error_max`` below the float32 floor through float64 residual
    refinement (float64 internal force and all_reduce, float32 operator),
    without the float64 rerun."""
    model = ft.model_from_arrays(_box_model(n=2))
    params = dict(sig_yield=240.0, nstep=3, error_max=1e-9, et_e=0.1, target_lf=99.0,
                  iterat_max=25)
    outs = ranks.world(4, ranks.solve, model, params,
                       dict(dtype="float32", deflation=True, residual_refinement=True,
                            precision_failover=True))
    assert_ranks_identical(outs)
    port = outs[0]
    lines = port["lines"]
    assert any("f64 residual refinement" in ln for ln in lines)
    assert port["refinement_activations"] >= 1
    assert len(port["lbd"]) == 4
    assert not any(ln.startswith("PRECISION FAILOVER") for ln in lines)
    errs = [float(m.group(1)) for m in (re.search(r"Error: ([0-9.e+-]+)", ln) for ln in lines)
            if m]
    assert min(errs) <= params["error_max"]
