"""The bandwidth probe's kernels K0p (``soa_matvec``) and Kbw (``bw_read``):
their plain versions in the port against the Pallas TPU kernels of
``tools/bw_probe.py``, run in interpret mode on the CPU at small sizes.

``tools/bw_probe.py`` allocates 2 GiB and runs when imported, so the
kernels are taken out of its source with ``ast`` and executed in a
namespace that binds small sizes and a ``pl`` whose ``pallas_call`` runs in
interpret mode.  The CUDA kernels themselves are tested on the card in
``test_torch_cuda.py``.
"""

import ast
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fcvm_tpu_torch.ops import kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(ROOT, "tools", "bw_probe.py")
NE, TILE = 256, 64  # K0p: four tiles
CHUNK, NCHUNK = 16, 8  # Kbw: (128, 128) float32 in 8 chunks
RTOL = 1e-5  # float32 sums of 30 (K0p) or 8 (Kbw) terms in another order


class _InterpretPl:
    """``pallas`` as the probe uses it, with ``pallas_call`` in interpret mode."""

    pallas_call = staticmethod(functools.partial(pl.pallas_call, interpret=True))

    def __getattr__(self, name):
        return getattr(pl, name)


def _probe_functions(names, **bindings):
    """The named function definitions of ``tools/bw_probe.py``, executed in
    a namespace with ``bindings``."""
    tree = ast.parse(open(PROBE).read())
    defs = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(d.name for d in defs) == sorted(names)
    ns = dict(jax=jax, jnp=jnp, pl=_InterpretPl(), pltpu=pltpu, **bindings)
    exec(compile(ast.Module(body=defs, type_ignores=[]), PROBE, "exec"), ns)
    return ns


def test_soa_matvec_plain_matches_pallas():
    rng = np.random.default_rng(6)
    esm_t = rng.standard_normal((30, 30, NE)).astype(np.float32)
    ue_t = rng.standard_normal((30, NE)).astype(np.float32)
    ns = _probe_functions(["_kern", "soa_matvec"], NE=NE, TILE=TILE, esm_t=jnp.asarray(esm_t))
    ref = np.asarray(ns["soa_matvec"](jnp.asarray(ue_t)))
    launches = kernels.soa_matvec.launches
    out = kernels.soa_matvec(torch.as_tensor(esm_t), torch.as_tensor(ue_t), TILE)
    assert kernels.soa_matvec.launches == launches  # the CPU takes the plain version
    assert out.dtype == torch.float32 and out.shape == (30, NE)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("k", [1, 4, 8])
def test_bw_read_plain_matches_pallas(k):
    x = np.random.default_rng(7).random((CHUNK * NCHUNK, 128)).astype(np.float32)
    ns = _probe_functions(["make_bw_kernel"], CHUNK=CHUNK, NCHUNK=NCHUNK)
    # 32-bit mode, as the probe runs: under the tests' x64 default the
    # kernel's ``lax.rem`` of an int32 slot by a Python int fails
    with jax.enable_x64(False):
        ref = np.asarray(ns["make_bw_kernel"](k)(jnp.asarray(x)))
    launches = kernels.bw_read.launches
    out = kernels.bw_read(torch.as_tensor(x), k, CHUNK)
    assert kernels.bw_read.launches == launches
    assert out.shape == (8, 128) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL)
    np.testing.assert_allclose(ref, np.full((8, 128), x[::CHUNK, 0].sum()), rtol=RTOL)


@pytest.mark.parametrize("bad", ["ne_not_multiple_of_tile", "dtype", "shape"])
def test_soa_matvec_rejects(bad):
    esm_t, ue_t, tile = torch.zeros((30, 30, NE)), torch.zeros((30, NE)), TILE
    if bad == "ne_not_multiple_of_tile":
        tile = 100
    elif bad == "dtype":
        esm_t, ue_t = esm_t.double(), ue_t.double()
    else:
        ue_t = torch.zeros((29, NE))
    with pytest.raises(TypeError if bad == "dtype" else ValueError):
        kernels.soa_matvec(esm_t, ue_t, tile)


@pytest.mark.parametrize("bad", ["k0", "k9", "rows_not_multiple_of_chunk", "width", "dtype"])
def test_bw_read_rejects(bad):
    x, k, chunk = torch.zeros((CHUNK * NCHUNK, 128)), 4, CHUNK
    if bad == "k0":
        k = 0
    elif bad == "k9":
        k = kernels.BW_READ_MAX_K + 1
    elif bad == "rows_not_multiple_of_chunk":
        chunk = 48
    elif bad == "width":
        x = torch.zeros((CHUNK * NCHUNK, 64))
    else:
        x = x.double()
    with pytest.raises(TypeError if bad == "dtype" else ValueError):
        kernels.bw_read(x, k, chunk)


def test_probe_needs_a_gpu():
    """Without a CUDA device the probe exits non-zero and measures nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the probe would run in full")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "fcvm_tpu_torch.tools.bw_probe"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "GB/s" not in proc.stdout
