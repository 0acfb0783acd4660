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
