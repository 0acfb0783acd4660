"""Shared set-up of the ``test_torch_*`` parity tests.

Each parity test feeds the same inputs to a function of the JAX package
(``fcvm_tpu``, on the CPU in float64 as ``conftest.py`` configures it) and
to its counterpart in the PyTorch port (``fcvm_tpu_torch``, CPU tensors,
float64).  Models are built with the JAX package's mesh generators and
handed to the port through :func:`fcvm_tpu_torch.models.spec.model_from_arrays`.
"""

import re

import numpy as np
import pytest
import torch

import fcvm_tpu
from fcvm_tpu.config import get_config
from fcvm_tpu.models import meshgen
from fcvm_tpu_torch import FcvmConfig

# six xdist workers share the machine: one intra-op thread each
torch.set_num_threads(1)

E, NU, L = 210000.0, 0.3, 10.0
F64 = torch.float64
# the JAX package's default solver tiers (Ritz deflation and the float32
# precision governance), off on both sides where a test compares the plain
# solver; the JAX package's load_deflation, which acts only in GNL, goes off
# with them there
TIERS_OFF = dict(deflation=False, residual_refinement=False, precision_failover=False)


def port_config(**kw) -> FcvmConfig:
    return FcvmConfig(**{"device": "cpu", "dtype": "float64", **TIERS_OFF, **kw})


@pytest.fixture
def jax_cfg():
    """The JAX package's global config with the solver tiers off;
    every field a test sets is restored afterwards."""
    c = get_config()
    fields = ("deflation", "load_deflation", "residual_refinement",
              "precision_failover", "cg_rtol")
    saved = {f: getattr(c, f) for f in fields}
    for f, v in {**TIERS_OFF, "load_deflation": False}.items():
        setattr(c, f, v)
    yield c
    for f, v in saved.items():
        setattr(c, f, v)


def symmetry_bcs(mesh):
    return fcvm_tpu.BoundaryConditions.from_node_sets([
        (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
        (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
        (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
    ])


def tension_model(n=2, sigma=100.0):
    """Uniaxial tension of a symmetry-constrained box (``tests/test_driver_collapse.py``)."""
    mesh = meshgen.box_tet10(n, n, n, L, L, L)
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    loads = fcvm_tpu.Loads(traction_faces=faces,
                           tractions=np.tile([sigma, 0, 0], (len(faces), 1)))
    return fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), symmetry_bcs(mesh), loads)


def disp_control_model(u_end):
    """Prescribed end displacement (``tests/test_driver_collapse.py``)."""
    mesh = meshgen.box_tet10(2, 2, 2, L, L, L)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets([
        (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
        (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
        (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
        (mesh.select_nodes(lambda x, y, z: x > L - 1e-9), (u_end, None, None)),
    ])
    return fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), bcs, fcvm_tpu.Loads())


def plate_model(n_circ=10, n_rad=8, n_thick=1, applied=50.0):
    """Quarter plate with a hole in y-tension (``tests/test_physics_cases.py``)."""
    mesh = meshgen.plate_with_hole_tet10(
        radius=10.0, width=50.0, height=100.0, thickness=5.0,
        n_circ=n_circ, n_rad=n_rad, n_thick=n_thick,
    )
    top = mesh.faces_on(lambda x, y, z: y > 100 - 1e-6)
    loads = fcvm_tpu.Loads(traction_faces=top,
                           tractions=np.tile([0, applied, 0], (len(top), 1)))
    return fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), symmetry_bcs(mesh),
                          loads, name="plate")


def t64(a):
    """A JAX or numpy array as a float64 CPU tensor."""
    return torch.as_tensor(np.array(a, dtype=np.float64))


def ti(a):
    """A JAX or numpy integer array as an int64 CPU tensor."""
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def newton_per_step(lines):
    """Newton iterations (restarts included) of each step, from the
    ``Step: k`` / ``Iteration: n, Error: e`` progress lines both drivers log."""
    counts = []
    for ln in lines:
        if ln.startswith("Step: "):
            counts.append(0)
        elif counts and (m := re.match(r"Iteration: (\d+),", ln)) and int(m.group(1)) > 0:
            counts[-1] += 1
    return counts


# ---------------------------------------------------------------------------
# The sharded backend (tests/test_torch_sharded_*.py)
# ---------------------------------------------------------------------------

# both packages' CG runs to this relative residual in the sharded parity
# tests, so their solutions agree far below the history tolerances
SHARD_CG_RTOL = 1e-12


def jax_collapse(model, params_kw, n_devices=0, **fields):
    """The JAX package's ``solve_collapse`` with its solver tiers off,
    ``cg_rtol = SHARD_CG_RTOL``, ``n_devices`` (its ``ShardedSystem`` over
    that many of conftest's virtual CPU devices when > 1) and the config
    ``fields``, all restored afterwards.  Returns the result, its log lines
    and Newton iterations per step."""
    c = get_config()
    fields = {**TIERS_OFF, "load_deflation": False, "cg_rtol": SHARD_CG_RTOL,
              "n_devices": n_devices, **fields}
    saved = {f: getattr(c, f) for f in fields}
    for f, v in fields.items():
        setattr(c, f, v)
    lines = []
    try:
        res = fcvm_tpu.solve_collapse(model, fcvm_tpu.ControlParams(**params_kw),
                                      progress=lines.append)
    finally:
        for f, v in saved.items():
            setattr(c, f, v)
    return res, lines


def assert_ranks_identical(outs):
    """Every rank of a spawned world returned the same history, CG counts,
    log and fields, bit for bit."""
    def untimed(lines):  # the log's wall-time lines differ by nature
        return [ln for ln in lines if " time " not in ln]

    def same(a, b):
        if isinstance(a, np.ndarray):
            return isinstance(b, np.ndarray) and np.array_equal(a, b)
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return a == b

    first = outs[0]
    for o in outs[1:]:
        assert untimed(o.get("lines", [])) == untimed(first.get("lines", []))
        for k, v in first.items():
            if k not in ("rank", "lines"):
                assert same(o[k], v), (k, o["rank"])


def assert_history_match(port, ref, ref_lines, tol=1e-10):
    """``tests/test_sharded_driver.py::_assert_history_match`` between a
    port rank's summary and a JAX result: 1e-10 on lbd, un, load, csr, the
    displacements and PEEQ, 1e-8 on the stresses, equal Newton iterations
    per step and the same number of CG solves (their iteration counts are
    held against the port's own single-device run, :func:`assert_cg_match`:
    the JAX package inverts its coarse matrix in float32, so its counts
    drift from the port's with the two-level preconditioner).  The critical
    Gauss point: ``csr`` at it is compared as above at every step, and at
    the last step it must hold the maximum of the JAX package's final CSR
    field to 1e-12.  Its index is not compared by equality: the box models'
    CSR maxima are ties between symmetric Gauss points that rounding
    breaks, and the JAX package's own single-device and sharded runs pick
    different points of a tie (17 and 16 at the last step of the 6-step
    GNL box at ``cg_rtol = 1e-12``)."""
    h = ref.history
    for k in ("lbd", "un", "load", "csr"):
        np.testing.assert_allclose(port[k], np.asarray(getattr(h, k)), rtol=0, atol=tol,
                                   err_msg=k)
    np.testing.assert_allclose(port["disp_total"], ref.disp_total, rtol=0, atol=tol)
    np.testing.assert_allclose(port["peeq_gp"], ref.peeq_gp, rtol=0, atol=tol)
    np.testing.assert_allclose(port["sig_gp"], ref.sig_gp, rtol=0, atol=1e-8)
    np.testing.assert_allclose(port["volume"], ref.volume, rtol=1e-12)
    np.testing.assert_allclose(port["loadsums"], ref.loadsums, rtol=0, atol=1e-9)
    csr_ref = np.asarray(ref.csr_gp).reshape(-1)
    assert csr_ref[port["crip"][-1]] >= csr_ref.max() - 1e-12 * max(csr_ref.max(), 1.0)
    assert newton_per_step(port["lines"]) == newton_per_step(ref_lines)
    assert port["solves"] == ref.cg_stats["solves"]
    assert port["predictor_solves"] == ref.cg_stats["predictor_solves"]


def assert_cg_match(port, local):
    """The sharded port against its single-device run: the same steps and
    Newton iterations, and every correction and predictor solve within one
    CG iteration (the two reduce in different orders, so a solve at 1e-12
    may stop one iteration apart)."""
    assert len(port["steps"]) == len(local["steps"])
    for s, t in zip(port["steps"], local["steps"]):
        assert s["newton"] == t["newton"] and s["restarts"] == t["restarts"]
        for key in ("cg", "predictor"):
            assert len(s[key]) == len(t[key])
            assert all(abs(a - b) <= 1 for a, b in zip(s[key], t[key])), (key, s, t)
