"""K2, the stress update and internal force, on the CPU, float64.

* Its plain version (``kernels.stress_update_ref``), reached through the
  port's ``update_stress_load`` and ``internal_force_from_stress``, against
  the JAX package's functions to ``RTOL``: small strain and GNL, one D and
  per-element D and E, plastic and elastic points, and element weights with
  zeros against the JAX force of the mesh without those elements.
* A NumPy transcription of the kernel's own formulation (``csrc/stress_update.cu``:
  node k of element e from its int32 node table at k ne + e, a Gauss point
  at a time, dN/dx from J^-1 and the kernel's table with no B,
  the Gauss points' rows added as (g0 + g1) + (g2 + g3)) against the JAX
  package's per-element update, to ``RTOL``: the index check of the kernel
  that runs without a card.  The table is read from the kernel's source
  (the Gauss-point geometry it includes, ``csrc/tet10.cuh``).
* The plain version is bit for bit the torch chain it was moved from.
* The wrapper has no fallback: no ``try``, and its plain version only on
  CPU tensors.
"""

import ast
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import F64, t64, ti

from fcvm_tpu.models import meshgen
from fcvm_tpu.ops import stress_update as jsu
from fcvm_tpu_torch.ops import elements as tel
from fcvm_tpu_torch.ops import kernels
from fcvm_tpu_torch.ops import material as tmat
from fcvm_tpu_torch.ops import stress_update as tsu
from fcvm_tpu_torch.utils.linalg3 import det3

ROOT = Path(__file__).resolve().parents[1]
KERNEL = ROOT / "fcvm_tpu_torch" / "csrc" / "tet10.cuh"  # K2's geometry (and K3's)
RTOL = 1e-12  # max |port - JAX| / max |JAX|: float64 sums in another order
E, NU, ET_E = 210000.0, 0.3, 0.1
MESHES = ("box", "plate")


def _mesh(name):
    if name == "box":
        return meshgen.box_tet10(2, 2, 2, 10.0, 10.0, 10.0)
    return meshgen.plate_with_hole_tet10(radius=10.0, width=50.0, height=100.0, thickness=5.0,
                                         n_circ=4, n_rad=2, n_thick=1)


def _close(got, want, rel=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _case(name, per_element, seed=18):
    """Seeded inputs on mesh ``name``: perturbed coordinates, a step-start
    displacement and increment of about 1% of an element, old stresses,
    the elasticity (one D, or per element with E from 0.5 to 2 times), and
    yield stresses that make about half the Gauss points plastic, each at
    least 10% from the surface in both configurations."""
    mesh = _mesh(name)
    rng = np.random.default_rng(seed)
    nn, ne = mesh.coords.shape[0], mesh.elnodes.shape[0]
    h = float(np.ptp(mesh.coords, axis=0).min()) / 8
    coords = mesh.coords + 0.05 * h * rng.uniform(-1, 1, size=mesh.coords.shape)
    disp = 0.01 * h * rng.normal(size=3 * nn + 3)  # padded past the nodes, as the solver's
    du = 1e-3 * h * rng.normal(size=3 * nn + 3)
    sig = rng.normal(scale=60.0, size=(ne, 4, 6))
    if per_element:
        e = E * rng.uniform(0.5, 2.0, size=ne)
        nu = NU + 0.05 * rng.uniform(-1, 1, size=ne)
    else:
        e, nu = E, NU
    dmat = tmat.hooke_dmat(e, nu, F64, torch.device("cpu")).numpy()
    svm = []
    for large in (False, True):
        _, trial, _, _ = _port(coords, mesh.elnodes, dmat, np.full((ne, 4), 1e30), disp, du, sig,
                               e, nu, large)
        svm.append(tmat.von_mises(torch.as_tensor(trial))[2].numpy())
    lo, hi = np.minimum(*svm), np.maximum(*svm)
    plastic = rng.uniform(size=(ne, 4)) < 0.5
    sy = np.where(plastic, rng.uniform(0.5, 0.9, size=(ne, 4)) * lo,
                  rng.uniform(1.1, 1.5, size=(ne, 4)) * hi)
    return dict(coords=coords, eln=mesh.elnodes, disp=disp, du=du, sig=sig, e=e, nu=nu,
                dmat=dmat, sy=sy)


def _material(x):
    return t64(x) if isinstance(x, np.ndarray) else x


def _port(coords, eln, dmat, sy, disp, du, sig, e, nu, large, weights=None):
    out = tsu.update_stress_load(t64(coords), ti(eln), t64(dmat), t64(sy), t64(disp), t64(du),
                                 t64(sig), _material(e), _material(nu), ET_E, large,
                                 weights=None if weights is None else t64(weights))
    return [v.numpy() for v in out]


def _jax(c, large, keep=None):
    """The JAX package's update_stress_load on the elements ``keep``."""
    keep = slice(None) if keep is None else keep
    per = isinstance(c["e"], np.ndarray)
    e = jnp.asarray(c["e"][keep]) if per else c["e"]
    nu = jnp.asarray(c["nu"][keep]) if per else c["nu"]
    dmat = c["dmat"][keep] if per else c["dmat"]
    out = jsu.update_stress_load(jnp.asarray(c["coords"]), jnp.asarray(c["eln"][keep]),
                                 jnp.asarray(dmat), jnp.asarray(c["sy"][keep]),
                                 jnp.asarray(c["disp"]), jnp.asarray(c["du"]),
                                 jnp.asarray(c["sig"][keep]), e, nu, ET_E, large)
    return [np.asarray(v) for v in out]


@pytest.mark.parametrize("per_element", [False, True], ids=["one_d", "per_element_d"])
@pytest.mark.parametrize("large", [False, True], ids=["small_strain", "gnl"])
@pytest.mark.parametrize("name", MESHES)
def test_update_stress_load_matches_jax(name, large, per_element):
    c = _case(name, per_element)
    sig_new, sig_test, pgp, qin = _port(c["coords"], c["eln"], c["dmat"], c["sy"], c["disp"],
                                        c["du"], c["sig"], c["e"], c["nu"], large)
    j_new, j_test, j_pgp, j_qin = _jax(c, large)
    assert 0.3 < pgp.mean() < 0.7  # plastic and elastic points both
    np.testing.assert_array_equal(pgp, j_pgp)
    _close(sig_new, j_new)
    _close(sig_test, j_test)
    _close(qin, j_qin)


@pytest.mark.parametrize("large", [False, True], ids=["small_strain", "gnl"])
@pytest.mark.parametrize("name", MESHES)
def test_weights_with_zeros_match_jax_without_those_elements(name, large):
    """Element weights of 0 and 1 (the sharded backend's padding) against
    the JAX package's update and force on the mesh without the weighted-out
    elements."""
    c = _case(name, True)
    ne = c["eln"].shape[0]
    weights = (np.random.default_rng(7).uniform(size=ne) > 0.3).astype(float)
    keep = weights > 0
    sig_new, _, pgp, qin = _port(c["coords"], c["eln"], c["dmat"], c["sy"], c["disp"], c["du"],
                                 c["sig"], c["e"], c["nu"], large, weights)
    j_new, _, j_pgp, j_qin = _jax(c, large, keep)
    np.testing.assert_array_equal(pgp[keep], j_pgp)
    _close(sig_new[keep], j_new)
    _close(qin, j_qin)
    qin_t = tsu.internal_force_from_stress(t64(c["coords"]), ti(c["eln"]), t64(c["sig"]),
                                           t64(c["disp"]), large, weights=t64(weights))
    j_force = jsu.internal_force_from_stress(
        jnp.asarray(c["coords"]), jnp.asarray(c["eln"][keep]), jnp.asarray(c["sig"][keep]),
        jnp.asarray(c["disp"]), large)
    _close(qin_t.numpy(), np.asarray(j_force))


@pytest.mark.parametrize("large", [False, True], ids=["small_strain", "gnl"])
@pytest.mark.parametrize("name", MESHES)
def test_internal_force_from_stress_matches_jax(name, large):
    c = _case(name, False)
    qin = tsu.internal_force_from_stress(t64(c["coords"]), ti(c["eln"]), t64(c["sig"]),
                                         t64(c["disp"]), large)
    want = jsu.internal_force_from_stress(jnp.asarray(c["coords"]), jnp.asarray(c["eln"]),
                                          jnp.asarray(c["sig"]), jnp.asarray(c["disp"]), large)
    _close(qin.numpy(), np.asarray(want))


# -- the kernel's formulation, transcribed ---------------------------------------


def _kernel_table():
    """The kernel's dN/dxi table [g][j][k] and Gauss weight, read from its source."""
    src = KERNEL.read_text()
    body = re.search(r"kDshp\[kTable\] = \{(.*?)\};", src, re.S).group(1)
    vals = [float(v) for v in body.split(",") if v.strip()]
    weight = float(re.search(r"kWeight = ([-+0-9.eE]+);", src).group(1))
    return np.array(vals).reshape(4, 3, 10), weight


def test_kernel_table_is_the_elements_table():
    table, weight = _kernel_table()
    assert np.array_equal(table, tel.DSHP10_AT_GP)
    assert np.all(tel.W10 == weight)


def _det3(m):
    return (m[0][0] * m[1][1] * m[2][2] - m[0][0] * m[1][2] * m[2][1]
            + m[0][2] * m[1][0] * m[2][1] - m[0][2] * m[1][1] * m[2][0]
            + m[0][1] * m[1][2] * m[2][0] - m[0][1] * m[1][0] * m[2][2])


def _transcribed(coords, eln, disp, sig, large, du=None, dmat=None, sy=None, g=None, h3g=None,
                 weights=None):
    """The kernel's steps for every element at once (arrays over elements),
    one Gauss point at a time: (sig_new, sig_test, pgp, elv), or elv alone
    without ``du``.  The node ids come from the kernel's int32 node table,
    node k of element e at k ne + e."""
    table, weight = _kernel_table()
    ne = eln.shape[0]
    nodes = kernels.element_table(ti(eln)).numpy().reshape(-1)
    node = nodes[np.arange(10)[None, :] * ne + np.arange(ne)[:, None]]  # (ne, 10)
    x = coords[node]  # (ne, 10, 3)
    if large:
        x = x + disp.reshape(-1, 3)[node]
    u = None if du is None else du.reshape(-1, 3)[node]
    dm = dmat if dmat is None or dmat.ndim == 3 else np.broadcast_to(dmat, (ne, 6, 6))
    new, test, pgp = np.zeros((ne, 4, 6)), np.zeros((ne, 4, 6)), np.zeros((ne, 4), bool)
    rows = np.zeros((4, ne, 10, 3))
    for gp in range(4):
        dn = table[gp]
        jac = [[sum(x[:, k, i] * dn[j, k] for k in range(10)) for j in range(3)]
               for i in range(3)]
        det = _det3(jac)
        m = jac
        ji = [[(m[1][1] * m[2][2] - m[2][1] * m[1][2]) / det,
               (m[0][2] * m[2][1] - m[0][1] * m[2][2]) / det,
               (m[0][1] * m[1][2] - m[0][2] * m[1][1]) / det],
              [(m[1][2] * m[2][0] - m[1][0] * m[2][2]) / det,
               (m[0][0] * m[2][2] - m[0][2] * m[2][0]) / det,
               (m[1][0] * m[0][2] - m[0][0] * m[1][2]) / det],
              [(m[1][0] * m[2][1] - m[2][0] * m[1][1]) / det,
               (m[2][0] * m[0][1] - m[0][0] * m[2][1]) / det,
               (m[0][0] * m[1][1] - m[1][0] * m[0][1]) / det]]

        def dndx(k):
            return [ji[0][i] * dn[0, k] + ji[1][i] * dn[1, k] + ji[2][i] * dn[2, k]
                    for i in range(3)]

        s = [sig[:, gp, v].copy() for v in range(6)]
        if du is not None:
            eps = [np.zeros(ne) for _ in range(6)]
            grad = [[np.zeros(ne) for _ in range(3)] for _ in range(3)]
            for k in range(10):
                d = dndx(k)
                u0, u1, u2 = u[:, k, 0], u[:, k, 1], u[:, k, 2]
                eps[0] += d[0] * u0
                eps[1] += d[1] * u1
                eps[2] += d[2] * u2
                eps[3] += d[1] * u0 + d[0] * u1
                eps[4] += d[2] * u0 + d[0] * u2
                eps[5] += d[2] * u1 + d[1] * u2
                for r in range(3):
                    for col in range(3):
                        grad[r][col] += u[:, k, r] * d[col]
            if large:
                f = [[(1.0 if r == col else 0.0) + grad[r][col] for col in range(3)]
                     for r in range(3)]
                st = [[s[0], s[3], s[4]], [s[3], s[1], s[5]], [s[4], s[5], s[2]]]
                fs = [[sum(f[r][j] * st[j][col] for j in range(3)) for col in range(3)]
                      for r in range(3)]
                detf = _det3(f)
                for v, (r, col) in enumerate(((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))):
                    s[v] = sum(fs[r][j] * f[col][j] for j in range(3)) / detf
            t = [s[r] + sum(dm[:, r, col] * eps[col] for col in range(6)) for r in range(6)]
            p = (t[0] + t[1] + t[2]) / 3.0
            dev = [t[0] - p, t[1] - p, t[2] - p, t[3], t[4], t[5]]
            svm = np.sqrt(1.5 * (dev[0] ** 2 + dev[1] ** 2 + dev[2] ** 2)
                          + 3.0 * (dev[3] ** 2 + dev[4] ** 2 + dev[5] ** 2))
            plastic = svm >= sy[:, gp]
            safe = np.where(svm == 0.0, 1.0, svm)
            fac = np.where(plastic, 1.0 - (1.0 - sy[:, gp] / safe) * 3.0 * g / h3g, 1.0)
            s = [dev[v] * fac + (p if v < 3 else 0.0) for v in range(6)]
            test[:, gp], new[:, gp], pgp[:, gp] = np.stack(t, -1), np.stack(s, -1), plastic
        scale = weight * np.abs(det)
        for k in range(10):
            d = dndx(k)
            rows[gp, :, k, 0] = (d[0] * s[0] + d[1] * s[3] + d[2] * s[4]) * scale
            rows[gp, :, k, 1] = (d[1] * s[1] + d[0] * s[3] + d[2] * s[5]) * scale
            rows[gp, :, k, 2] = (d[2] * s[2] + d[0] * s[4] + d[1] * s[5]) * scale
    elv = ((rows[0] + rows[1]) + (rows[2] + rows[3])).reshape(ne, 30)
    if weights is not None:
        elv = elv * weights[:, None]
    return elv if du is None else (new, test, pgp, elv)


@pytest.mark.parametrize("per_element", [False, True], ids=["one_d", "per_element_d"])
@pytest.mark.parametrize("large", [False, True], ids=["small_strain", "gnl"])
@pytest.mark.parametrize("name", MESHES)
def test_kernel_formulation_matches_jax(name, large, per_element):
    """The transcription against the JAX package's per-element update
    (``_element_stress_update``, vmapped as its ``update_stress_load`` maps
    it), every output per element."""
    c = _case(name, per_element)
    e = c["e"] if per_element else np.full(c["eln"].shape[0], E)
    nu = c["nu"] if per_element else np.full(c["eln"].shape[0], NU)
    g = e / (1.0 + nu) / 2.0
    h = ET_E * e / (1.0 - ET_E)
    new, test, pgp, elv = _transcribed(c["coords"], c["eln"], c["disp"], c["sig"], large,
                                       du=c["du"], dmat=c["dmat"], sy=c["sy"], g=g, h3g=h + 3 * g)
    eln = c["eln"]
    ax = 0 if per_element else None
    one = jax.vmap(functools.partial(jsu._element_stress_update, large_disp=large),
                   in_axes=(0, 0, 0, 0, 0, ax, ax, ax))
    dmat = jnp.asarray(c["dmat"])
    j_new, j_test, j_pgp, j_elv = (np.asarray(v) for v in one(
        jnp.asarray(c["coords"][eln]), jnp.asarray(c["disp"].reshape(-1, 3)[eln]),
        jnp.asarray(c["du"].reshape(-1, 3)[eln]), jnp.asarray(c["sig"]), jnp.asarray(c["sy"]),
        dmat, jnp.asarray(h) if per_element else h[0], jnp.asarray(g) if per_element else g[0]))
    np.testing.assert_array_equal(pgp, j_pgp)
    _close(new, j_new)
    _close(test, j_test)
    _close(elv, j_elv)


@pytest.mark.parametrize("large", [False, True], ids=["small_strain", "gnl"])
@pytest.mark.parametrize("name", MESHES)
def test_kernel_given_stress_formulation_matches_jax(name, large):
    """The transcription's given-stress form, weighted, summed into nodes,
    against the JAX package's internal_force_from_stress of the weighted
    stresses."""
    c = _case(name, False)
    ne = c["eln"].shape[0]
    weights = np.random.default_rng(9).uniform(0.5, 2.0, size=ne)
    elv = _transcribed(c["coords"], c["eln"], c["disp"], c["sig"], large, weights=weights)
    qin = np.zeros(c["disp"].shape[0])
    np.add.at(qin, (3 * c["eln"][:, :, None] + np.arange(3)).reshape(-1), elv.reshape(-1))
    want = jsu.internal_force_from_stress(
        jnp.asarray(c["coords"]), jnp.asarray(c["eln"]),
        jnp.asarray(c["sig"] * weights[:, None, None]), jnp.asarray(c["disp"]), large)
    _close(qin, np.asarray(want))


# -- the plain version is the chain it was moved from -------------------------------


def _parent_chain(coords, elnodes, dmat, sig_yield, disp, du, sig_old, e, nu, et_e, large,
                  weights, plan, ndof):
    """The torch chain of ``update_stress_load`` before K2, as it was."""
    e, nu = tmat.per_gauss(e), tmat.per_gauss(nu)
    g = tmat.shear_modulus(e, nu)
    h = tmat.hardening_modulus(e, et_e)
    coords_el = coords[elnodes]
    du_el = du.reshape(-1, 3)[elnodes]
    if large:
        coords_el = coords_el + disp.reshape(-1, 3)[elnodes]
    det, dshpg, bmat = tel.tet10_element_geometry(coords_el)
    scale = torch.as_tensor(tel.W10, dtype=coords_el.dtype) * det.abs()
    deps = torch.einsum("egkn,en->egk", bmat, du_el.reshape(-1, 30))
    sig_c = sig_old
    if large:
        f = torch.eye(3, dtype=du.dtype) + torch.einsum("eia,egbi->egab", du_el, dshpg)
        s_conv = torch.einsum("egij,egjl,egkl->egik", f, tmat.voigt_to_tensor(sig_old), f)
        sig_c = tmat.tensor_to_voigt(s_conv / det3(f)[..., None, None])
    sig_test = sig_c + tmat.apply_dmat(dmat, deps)
    sig_new, pgp = tmat.radial_return(sig_test, sig_yield, h, g)
    elv = torch.einsum("egkn,egk,eg->en", bmat, sig_new, scale)
    if weights is not None:
        elv = elv * weights[:, None]
    qin = kernels.segment_sum(elv.reshape(-1, 3).contiguous(), plan, rows=ndof // 3)
    return sig_new, sig_test, pgp, qin.reshape(-1)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("per_element", [False, True], ids=["one_d", "per_element_d"])
@pytest.mark.parametrize("large", [False, True], ids=["small_strain", "gnl"])
def test_plain_version_is_the_parents_chain_bit_for_bit(large, per_element, weighted):
    for dtype in (torch.float64, torch.float32):
        c = _case("plate", per_element)
        ne = c["eln"].shape[0]
        args = [torch.as_tensor(c[k]).to(dtype) for k in ("coords",)] + [ti(c["eln"])] + [
            torch.as_tensor(c[k]).to(dtype) for k in ("dmat", "sy", "disp", "du", "sig")]
        e, nu = ((torch.as_tensor(c[k]).to(dtype) for k in ("e", "nu")) if per_element
                 else (E, NU))
        weights = (torch.as_tensor(np.random.default_rng(3).uniform(size=ne)).to(dtype)
                   if weighted else None)
        ndof = args[4].shape[0]
        plan = kernels.segment_plan(args[1], rows=ndof // 3)
        want = _parent_chain(*args, e, nu, ET_E, large, weights, plan, ndof)
        got = tsu.update_stress_load(*args, e, nu, ET_E, large, weights=weights, plan=plan)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        coords_el = args[0][args[1]]
        if large:
            coords_el = coords_el + args[4].reshape(-1, 3)[args[1]]
        det, _, bmat = tel.tet10_element_geometry(coords_el)
        scale = torch.as_tensor(tel.W10, dtype=dtype) * det.abs()
        elv = torch.einsum("egkn,egk,eg->en", bmat, args[6], scale)
        if weights is not None:
            elv = elv * weights[:, None]
        want_q = kernels.segment_sum(elv.reshape(-1, 3).contiguous(), plan, rows=ndof // 3)
        got_q = tsu.internal_force_from_stress(args[0], args[1], args[6], args[4], large,
                                               weights=weights, plan=plan)
        assert torch.equal(got_q, want_q.reshape(-1))


# -- the wrapper ---------------------------------------------------------------------


def test_wrapper_has_no_fallback():
    """``kernels.stress_update`` has no ``try`` and calls its plain version
    once, under a test of the tensors' device being the CPU."""
    tree = ast.parse((ROOT / "fcvm_tpu_torch" / "ops" / "kernels.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "stress_update")
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    ifs = [n for n in ast.walk(fn) if isinstance(n, ast.If)
           and any(isinstance(c, ast.Call) and getattr(c.func, "id", None) == "stress_update_ref"
                   for b in n.body for c in ast.walk(b))]
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "stress_update_ref"]
    assert len(calls) == 1 and len(ifs) == 1
    assert "'cpu'" in ast.unparse(ifs[0].test) or '"cpu"' in ast.unparse(ifs[0].test)


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    """CPU tensors: the plain version, no launch counted; tensors on another
    device than the CPU or one CUDA device raise before any launch."""
    c = _case("box", False)
    before = kernels.stress_update.launches
    args = (t64(c["coords"]), ti(c["eln"]), t64(c["disp"]), t64(c["sig"]))
    got = kernels.stress_update(*args, du=t64(c["du"]), dmat=t64(c["dmat"]), sig_yield=t64(c["sy"]),
                                g=80769.0, h=23333.0)
    want = kernels.stress_update_ref(*args, du=t64(c["du"]), dmat=t64(c["dmat"]),
                                     sig_yield=t64(c["sy"]), g=80769.0, h=23333.0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.stress_update.launches == before
    with pytest.raises(ValueError, match="several devices"):
        kernels.stress_update(args[0].to("meta"), *args[1:])
