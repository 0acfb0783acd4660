"""K2's two passes as a residual, on the CPU.

* The residual without ``reduce`` (``runtime/system.residual`` and
  ``residual_refined``, through ``kernels.stress_residual_bound``): its plain
  version is bit for bit the chain it was moved from (the stress update,
  K8's write form, the torch tail) in float32 and float64, small strain and
  GNL, one material and per element, ``relax`` != 1, weights with zeros.
* The same against the JAX package's ``residual`` to ``RTOL`` in float64 on
  every output.
* A NumPy transcription of the node pass (``csrc/stress_update.cu``: each
  node's rows in the plan's order from zero, the residual's products and
  differences rounded one by one, each block's float64 partial by its
  shuffle tree, the last block's fixed-order sum): qin and r the plain
  version's bits, error the plain version's to ``RTOL``, and JAX's.
* K2's int32 node table is the connectivity, element-major; it and the
  backend's bound residual are made once.
* The new wrappers have no fallback: no ``try``, their plain versions only
  on CPU tensors.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import F64, t64, tension_model, ti

from fcvm_tpu.models import meshgen
from fcvm_tpu.runtime import system as jsys
from fcvm_tpu_torch.config import FcvmConfig
from fcvm_tpu_torch.models.spec import model_from_arrays
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import material as tmat
from fcvm_tpu_torch.ops import stress_update as tsu
from fcvm_tpu_torch.runtime import system as tsys
from fcvm_tpu_torch.runtime.backend import TorchSystem

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-12  # max |port - reference| / max |reference|: float64 sums in another order
E, NU, ET_E = 210000.0, 0.3, 0.1
NODE_THREADS = 256  # the node pass's blocks (csrc/stress_update.cu: kNodeThreads)


def _mesh(name):
    if name == "box":
        return meshgen.box_tet10(2, 2, 2, 10.0, 10.0, 10.0)
    return meshgen.plate_with_hole_tet10(radius=10.0, width=50.0, height=100.0, thickness=5.0,
                                         n_circ=4, n_rad=2, n_thick=1)


def _case(name, per_element, seed=19):
    """Seeded inputs on mesh ``name``: perturbed coordinates, a step-start
    displacement and increment of about 1% of an element, old stresses
    that leave about half the Gauss points plastic, a load vector, a mask
    with about 20% fixed dofs, and the dof vectors padded by one node past
    the mesh (a hole of the node plan), as the backends pad them."""
    mesh = _mesh(name)
    rng = np.random.default_rng(seed)
    nn, ne = mesh.coords.shape[0], mesh.elnodes.shape[0]
    nd = 3 * nn + 3
    h = float(np.ptp(mesh.coords, axis=0).min()) / 8
    c = dict(coords=mesh.coords + 0.05 * h * rng.uniform(-1, 1, size=mesh.coords.shape),
             eln=mesh.elnodes, disp=0.01 * h * rng.normal(size=nd),
             du=1e-3 * h * rng.normal(size=nd), sig=rng.normal(scale=60.0, size=(ne, 4, 6)),
             glv=rng.normal(scale=50.0, size=nd), fixmask=(rng.uniform(size=nd) > 0.2) * 1.0,
             weights=(rng.uniform(size=ne) > 0.3) * rng.uniform(0.5, 2.0, size=ne))
    if per_element:
        c["e"], c["nu"] = E * rng.uniform(0.5, 2.0, size=ne), NU + 0.05 * rng.uniform(-1, 1, ne)
    else:
        c["e"], c["nu"] = E, NU
    c["dmat"] = tmat.hooke_dmat(c["e"], c["nu"], F64, torch.device("cpu")).numpy()
    # yield stresses of about half the points plastic: the trial von Mises
    # stress of a plain run (never reached: 1e30) times a factor in [0.5, 1.5]
    args = _args(c, torch.float64, large=False, sy=np.full((ne, 4), 1e30))
    svm = tmat.von_mises(tsu.update_stress_load(*args[:7], *args[7:10], False)[1])[2].numpy()
    c["sy"] = svm * rng.uniform(0.5, 1.5, size=(ne, 4))
    return c


def _material(x, dtype):
    return torch.as_tensor(x).to(dtype) if isinstance(x, np.ndarray) else x


def _args(c, dtype, large, sy=None):
    """update_stress_load's positional arguments in ``dtype``."""
    t = [torch.as_tensor(c[k]).to(dtype) for k in ("coords",)]
    return (t + [ti(c["eln"])]
            + [torch.as_tensor(c[k] if k != "sy" or sy is None else sy).to(dtype)
               for k in ("dmat", "sy", "disp", "du", "sig")]
            + [_material(c["e"], dtype), _material(c["nu"], dtype), ET_E])


def _parent_residual(c, dtype, large, relax, weights, plan, lbd1=1.3, qnorm=7.0):
    """``runtime/system.residual`` before K2's node pass, as it was: the
    stress update and internal force, then the torch steps, ``lbd1`` the
    backend's tensor of the working dtype."""
    args = _args(c, dtype, large)
    sig_new, sig_test, pgp, qin = tsu.update_stress_load(*args, large, weights=weights,
                                                         plan=plan)
    glv, fixmask = (torch.as_tensor(c[k]).to(dtype) for k in ("glv", "fixmask"))
    lbd = torch.as_tensor(np.asarray(lbd1, dtype=np.float64)).to(dtype)
    r = fixmask * (lbd * glv - qin)
    error = torch.linalg.vector_norm(r) / qnorm
    return sig_new, sig_test, pgp, qin, relax * r, error


def _parent_refined(c, large, relax, weights, plan, lbd1=1.3, qnorm=7.0):
    """``runtime/system.residual_refined`` before K2's node pass, on float32
    state: every input upcast, the float64 chain, the outputs cast back."""
    f64, f32 = torch.float64, torch.float32

    def cc(x):
        return x.to(f64) if torch.is_tensor(x) and x.is_floating_point() else x

    args = [cc(a) for a in _args(c, f32, large)]
    sig_new, sig_test, pgp, qin = tsu.update_stress_load(*args, large, weights=cc(weights),
                                                         plan=plan)
    glv, fixmask = (torch.as_tensor(c[k]).to(f32) for k in ("glv", "fixmask"))
    lbd = torch.tensor(float(lbd1), dtype=f64)
    r = cc(fixmask) * (lbd * cc(glv) - qin)
    error = torch.linalg.vector_norm(r) / qnorm
    return (sig_new.to(f32), sig_test.to(f32), pgp, qin.to(f32), (relax * r).to(f32), error)


def _port(c, dtype, large, relax, weights, plan, refined=False, lbd1=1.3, qnorm=7.0):
    """The port's residual without ``reduce`` (K2's bound passes), as a
    backend calls it: ``lbd1`` a number."""
    args = _args(c, torch.float32 if refined else dtype, large)
    coords, eln, dmat, sy, disp, du, sig, e, nu, et_e = args
    glv, fixmask = (torch.as_tensor(c[k]).to(args[0].dtype) for k in ("glv", "fixmask"))
    fn = tsys.residual_refined if refined else tsys.residual
    return fn(coords, eln, dmat, sy, disp, du, sig, e, nu, et_e, glv, fixmask, lbd1, qnorm,
              large, relax=relax, weights=weights, plan=plan)


def _plan(c):
    return kernels.segment_plan(ti(c["eln"]), rows=c["disp"].shape[0] // 3)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("per_element", [False, True], ids=["one_d", "per_element_d"])
@pytest.mark.parametrize("large", [False, True], ids=["small_strain", "gnl"])
@pytest.mark.parametrize("form", ["float64", "float32", "refined"])
def test_plain_residual_is_the_parents_chain_bit_for_bit(form, large, per_element, weighted):
    c = _case("plate", per_element)
    dtype = torch.float32 if form == "float32" else torch.float64
    plan = _plan(c)
    wdt = torch.float32 if form != "float64" else torch.float64
    weights = torch.as_tensor(c["weights"]).to(wdt) if weighted else None
    relax = 0.7
    if form == "refined":
        want = _parent_refined(c, large, relax, weights, plan)
    else:
        want = _parent_residual(c, dtype, large, relax, weights, plan)
    got = _port(c, dtype, large, relax, weights, plan, refined=form == "refined")
    assert 0.2 < float(got[2].float().mean()) < 0.8  # plastic and elastic points both
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("per_element", [False, True], ids=["one_d", "per_element_d"])
@pytest.mark.parametrize("large", [False, True], ids=["small_strain", "gnl"])
@pytest.mark.parametrize("name", ["box", "plate"])
def test_residual_matches_jax(name, large, per_element):
    """Every output against the JAX package's ``residual`` in float64."""
    c = _case(name, per_element)
    relax, lbd1, qnorm = 0.7, 1.3, 7.0
    got = [v.numpy() for v in _port(c, torch.float64, large, relax, None, _plan(c))]
    e = jnp.asarray(c["e"]) if per_element else c["e"]
    nu = jnp.asarray(c["nu"]) if per_element else c["nu"]
    want = [np.asarray(v) for v in jsys.residual(
        jnp.asarray(c["coords"]), jnp.asarray(c["eln"]), jnp.asarray(c["dmat"]),
        jnp.asarray(c["sy"]), jnp.asarray(c["disp"]), jnp.asarray(c["du"]),
        jnp.asarray(c["sig"]), e, nu, ET_E, jnp.asarray(c["glv"]), jnp.asarray(c["fixmask"]),
        lbd1, qnorm, large, relax=relax)]
    np.testing.assert_array_equal(got[2], want[2])
    for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert float(np.abs(a - b).max()) <= RTOL * float(np.abs(b).max())


# -- the node pass, transcribed ------------------------------------------------------


def _block_sum(v):
    """A block's sum as the kernel's block_sum takes it: in each warp lane
    i adds lane i + o for o = 16, 8, 4, 2, 1; then the warps' sums in order."""
    v = np.asarray(v, dtype=np.float64).reshape(-1, 32).copy()
    for o in (16, 8, 4, 2, 1):
        v[:, :o] = v[:, :o] + v[:, o:2 * o]
    s = 0.0
    for w in v[:, 0]:
        s = s + w
    return s


def _transcribed_node_pass(elv, plan, glv, fixmask, lbd1, relax, qnorm):
    """The node pass's residual form, its operations in the kernel's order,
    in elv's type T (numpy rounds each T operation as the card does):
    (qin, r, error)."""
    t = elv.dtype.type
    vals = elv.reshape(-1, 3)
    order, offsets, segs, holes = (x.numpy() for x in (plan.order, plan.offsets, plan.segs,
                                                       plan.holes))
    nu, units = len(segs), len(segs) + len(holes)
    qin = np.zeros(3 * units, dtype=elv.dtype)
    r = np.zeros(3 * units, dtype=elv.dtype)
    lbd, rel = t(lbd1), t(relax)
    nblocks = -(-units // NODE_THREADS)
    v = np.zeros(nblocks * NODE_THREADS)
    for u in range(units):
        q = [t(0), t(0), t(0)]
        if u < nu:
            row = segs[u]
            for p in range(offsets[u], offsets[u + 1]):
                for k in range(3):
                    q[k] = t(q[k] + vals[order[p], k])
        else:
            row = holes[u - nu]
        for k in range(3):
            i = 3 * row + k
            qin[i] = q[k]
            raw = t(fixmask[i] * t(t(lbd * glv[i]) - q[k]))
            r[i] = t(rel * raw)
            v[u] = v[u] + float(raw) * float(raw)
    partials = [_block_sum(v[b * NODE_THREADS:(b + 1) * NODE_THREADS]) for b in range(nblocks)]
    strided = np.zeros(NODE_THREADS)
    for i in range(NODE_THREADS):
        for b in range(i, nblocks, NODE_THREADS):
            strided[i] = strided[i] + partials[b]
    error = t(np.sqrt(_block_sum(strided)) / qnorm)
    return qin, r, error


@pytest.mark.parametrize("large", [False, True], ids=["small_strain", "gnl"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("name", ["box", "plate"])
def test_node_pass_transcription(name, dtype, large):
    """qin and r the plain version's bits (the plan's order is index_add_'s),
    error the plain version's to RTOL in float64 (float32: its 1e-6), and
    in float64 JAX's norm to RTOL."""
    c = _case(name, True)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    plan = _plan(c)
    relax, lbd1, qnorm = 0.7, 1.3, 7.0
    args = _args(c, tdt, large)
    weights = torch.as_tensor(c["weights"]).to(tdt)
    e, nu = tmat.per_gauss(args[7]), tmat.per_gauss(args[8])
    elv = kernels.stress_update_ref(args[0], args[1], args[4], args[6], large, du=args[5],
                                    dmat=args[2], sig_yield=args[3],
                                    g=tmat.shear_modulus(e, nu),
                                    h=tmat.hardening_modulus(e, ET_E), weights=weights)[3]
    glv, fixmask = (torch.as_tensor(c[k]).to(tdt) for k in ("glv", "fixmask"))
    qin, r, error = _transcribed_node_pass(elv.numpy(), plan, glv.numpy(), fixmask.numpy(),
                                           lbd1, relax, qnorm)
    plain = _port(c, tdt, large, relax, weights, plan, lbd1=lbd1, qnorm=qnorm)
    assert np.array_equal(qin, plain[3].numpy()) and np.array_equal(r, plain[4].numpy())
    assert error.dtype == dtype
    assert abs(float(error) - float(plain[5])) <= (RTOL if dtype == np.float64 else 1e-6) * \
        float(plain[5])
    if dtype == np.float64:
        want = jsys.residual(
            jnp.asarray(c["coords"]), jnp.asarray(c["eln"]), jnp.asarray(c["dmat"]),
            jnp.asarray(c["sy"]), jnp.asarray(c["disp"]), jnp.asarray(c["du"]),
            jnp.asarray(c["sig"]), jnp.asarray(c["e"]), jnp.asarray(c["nu"]), ET_E,
            jnp.asarray(c["glv"]), jnp.asarray(c["fixmask"]), lbd1, qnorm, large,
            relax=relax)
        plain_w = _port(c, tdt, large, relax, None, plan, lbd1=lbd1, qnorm=qnorm)
        elv_w = kernels.stress_update_ref(args[0], args[1], args[4], args[6], large,
                                          du=args[5], dmat=args[2], sig_yield=args[3],
                                          g=tmat.shear_modulus(e, nu),
                                          h=tmat.hardening_modulus(e, ET_E))[3]
        qin_w, _, error_w = _transcribed_node_pass(elv_w.numpy(), plan, glv.numpy(),
                                                   fixmask.numpy(), lbd1, relax, qnorm)
        assert np.array_equal(qin_w, plain_w[3].numpy())
        assert abs(float(error_w) - float(want[5])) <= RTOL * float(want[5])


def test_node_pass_sums_many_blocks_in_a_fixed_order():
    """More units than a block: the transcription's two-level sum against
    math.fsum of the squares (the ticket's block-order sum to 1e-15)."""
    import math

    rng = np.random.default_rng(4)
    raw = rng.normal(size=3 * 1000)
    v = (raw.reshape(-1, 3) ** 2).sum(axis=1)
    nblocks = -(-len(v) // NODE_THREADS)
    v = np.concatenate([v, np.zeros(nblocks * NODE_THREADS - len(v))])
    partials = [_block_sum(v[b * NODE_THREADS:(b + 1) * NODE_THREADS]) for b in range(nblocks)]
    strided = np.zeros(NODE_THREADS)
    for i in range(NODE_THREADS):
        for b in range(i, nblocks, NODE_THREADS):
            strided[i] = strided[i] + partials[b]
    exact = math.fsum(raw * raw)
    assert abs(_block_sum(strided) - exact) <= 1e-15 * exact


# -- the node table and the bound residual: made once ---------------------------------


@pytest.mark.parametrize("name", ["box", "plate"])
def test_element_table_is_the_connectivity(name):
    """K2's node table: int32 (10, ne), element-major, the connectivity."""
    eln = ti(_mesh(name).elnodes)
    table = kernels.element_table(eln)
    assert table.dtype == torch.int32 and table.shape == (10, eln.shape[0])
    assert table.is_contiguous() and torch.equal(table.long(), eln.t())
    with pytest.raises(ValueError):
        kernels.element_table(eln[:, :4])


def test_backend_builds_its_tables_and_residuals_once(monkeypatch):
    """A backend makes K2's node table at its first stress update and one
    bound residual for each (et_e, tier); its residuals reuse them."""
    made = {"table": 0, "bound": 0}
    table, bound = kernels.element_table, kernels.stress_residual_bound

    def count(key, fn):
        def counted(*a, **k):
            made[key] += 1
            return fn(*a, **k)
        return counted

    monkeypatch.setattr(kernels, "element_table", count("table", table))
    monkeypatch.setattr(kernels, "stress_residual_bound", count("bound", bound))
    be = TorchSystem(model_from_arrays(tension_model()), FcvmConfig(device="cpu",
                                                                   dtype="float64"),
                     torch.float64, torch.device("cpu"))
    assert made == {"table": 0, "bound": 0}  # made at the first stress update
    coords = be.tensor(be.mesh.coords)
    du = 1e-4 * torch.ones(be.ndof_pad, dtype=F64)
    sig_y, sig0 = be.gauss_full(100.0), be.gauss_zeros((6,))
    glv = torch.ones(be.ndof_pad, dtype=F64)
    for et_e in (0.1, 0.1, 0.0):
        be.residual(coords, sig_y, torch.zeros_like(du), du, sig0, glv, 1.0, 1.0, et_e)
    be.residual_refined(coords, sig_y, torch.zeros_like(du), du, sig0, glv, 1.0, 1.0, 0.1)
    be.stress_update(coords, sig_y, torch.zeros_like(du), du, sig0, 0.1)
    be.internal_force(coords, sig0, torch.zeros_like(du))
    assert made == {"table": 1, "bound": 3}
    assert torch.equal(be.element_table.long(), be.elnodes.t())


# -- the wrappers ---------------------------------------------------------------------


def _function(name):
    tree = ast.parse((ROOT / "fcvm_tpu_torch" / "ops" / "kernels.py").read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


@pytest.mark.parametrize("name, ref", [("node_force", "node_force_ref"),
                                       ("stress_residual_bound", "stress_residual_ref")])
def test_wrappers_have_no_fallback(name, ref):
    """No ``try``; the plain version called once, under a test of the
    tensors' device being the CPU."""
    fn = _function(name)
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == ref]
    ifs = [n for n in ast.walk(fn) if isinstance(n, ast.If)
           and any(isinstance(c, ast.Call) and getattr(c.func, "id", None) == ref
                   for b in n.body for c in ast.walk(b))]
    assert len(calls) == 1 and len(ifs) == 1
    assert "'cpu'" in ast.unparse(ifs[0].test) or '"cpu"' in ast.unparse(ifs[0].test)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """CPU tensors: the plain versions, no launch counted; a device that is
    neither the CPU nor CUDA raises before any launch."""
    c = _case("box", False)
    plan = _plan(c)
    launches = (kernels.stress_update.launches, kernels.node_force.launches)
    elv = torch.as_tensor(np.random.default_rng(2).normal(size=(c["eln"].shape[0], 30)))
    rows = c["disp"].shape[0] // 3
    assert torch.equal(kernels.node_force(elv, plan, rows=rows),
                       kernels.node_force_ref(elv, plan, rows))
    got = _port(c, torch.float64, True, 0.5, None, plan)
    want = kernels.stress_residual_ref(
        *(_args(c, torch.float64, True)[i] for i in (0, 1, 4, 5, 6, 3)),
        *(t64(c[k]) for k in ("glv", "fixmask")), 1.3, 7.0, True, 0.5,
        dmat=t64(c["dmat"]), g=tmat.shear_modulus(E, NU), h=tmat.hardening_modulus(E, ET_E),
        plan=plan)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (kernels.stress_update.launches, kernels.node_force.launches) == launches
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        kernels.node_force(elv.to("meta"), plan, rows=rows)
    with pytest.raises(ValueError, match="several devices"):
        kernels.stress_residual_bound(ti(c["eln"]), plan, t64(c["fixmask"]).to("meta"),
                                      t64(c["dmat"]), 1.0, 1.0)
