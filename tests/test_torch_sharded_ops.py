"""The port's sharded backend in pieces, its collectives, checkpoints and CLI.

The backend's pieces run on gloo worlds of CPU ranks (float64) and are held
against the port's single-device :class:`~fcvm_tpu_torch.runtime.backend.TorchSystem`
and the JAX package's ``LocalSystem`` (``tests/test_sharded_driver.py::
test_sharded_system_ops_match_local``): assembly, ``K_hat @ v``, ``K_hat @ W``
against its columns, the stress update and internal force, the deflated
solve, and the node-partitioned CG against the replicated one
(``test_node_partition_solve_matches_replicated``).  A checkpoint written by
one backend resumes under the other (``test_checkpoint_cross_backend_resume``),
and the CLI runs over two processes through ``--distributed --coordinator``
and over two spawned ranks through ``--devices 2`` (``tests/test_multihost.py``),
rank 0 alone writing an ``.out`` equal byte for byte to a single-device
run's.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_sharded_ranks as ranks
from test_multihost import CLI_CASE
from test_sharded_driver import _box_model
from torch_parity import assert_ranks_identical

import fcvm_tpu_torch as ft
from fcvm_tpu.config import get_config
from fcvm_tpu.ops import assembly as jasm
from fcvm_tpu.runtime.backend import LocalSystem
from fcvm_tpu_torch.parallel import dist as pdist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_collectives(world):
    outs = ranks.world(world, ranks.collectives)
    x = np.arange(4 * world, dtype=np.float64)
    total = x * sum(range(1, world + 1))
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["all_reduce"], total)
        np.testing.assert_array_equal(o["all_gather"], np.repeat(np.arange(world), 2)[:, None]
                                      * np.ones((1, 3)))
        np.testing.assert_array_equal(o["reduce_scatter"], total[4 * r:4 * (r + 1)])
        np.testing.assert_array_equal(o["broadcast"], np.zeros(3))


@pytest.fixture(scope="module")
def ops():
    """The backend's pieces on the 2x2x2 box, worlds of 2 and 4 ranks, and
    the single-device references (the port's and the JAX package's)."""
    model = _box_model(n=2)
    tmodel = ft.model_from_arrays(model)
    outs = {w: ranks.world(w, ranks.backend_ops, tmodel) for w in (2, 4)}
    loc = ft.runtime.backend.TorchSystem(tmodel, ranks.config(cg_rtol=1e-10), torch.float64,
                                         torch.device("cpu"))
    jloc = LocalSystem(model, get_config(), jnp.float64)
    return model, outs, loc, jloc


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ops_match_local(ops, world):
    """Assembly, ``K_hat @ v``, the stress update and internal force of a
    sharded world against both single-device backends, to the bars of
    ``test_sharded_system_ops_match_local``; every rank the same."""
    model, outs, loc, jloc = ops
    assert_ranks_identical(outs[world])
    o = outs[world][0]
    coords = loc.tensor(model.mesh.coords)
    esm, pinv, glv, rhs, gpc, vol, ls = loc.assemble(coords)
    jesm, _, jglv, jrhs, jgpc, jvol, jls = jloc.assemble(model.mesh.coords)
    for ref_esm, ref_glv, ref_rhs, ref_vol, ref_ls, ref_gpc in (
            (esm.numpy(), glv.numpy(), rhs.numpy(), float(vol), ls.numpy(), gpc.numpy()),
            (np.asarray(jesm), np.asarray(jglv), np.asarray(jrhs), float(jvol), np.asarray(jls),
             np.asarray(jgpc))):
        np.testing.assert_allclose(o["esm"], ref_esm, rtol=1e-10, atol=1e-7)
        np.testing.assert_allclose(o["glv"], ref_glv, rtol=1e-10, atol=1e-8)
        np.testing.assert_allclose(o["rhs"], ref_rhs, rtol=1e-10, atol=1e-8)
        np.testing.assert_allclose(o["volume"], ref_vol, rtol=1e-12)
        np.testing.assert_allclose(o["loadsums"], ref_ls, rtol=1e-10, atol=1e-8)
        np.testing.assert_allclose(o["gp_coords"], ref_gpc, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(o["pinv"], pinv.numpy(), rtol=1e-10, atol=1e-14)

    u = o["u"]
    khat = loc.assemble_operator(coords)[0]
    y_ref = loc.space.from_m(khat(loc.space.to_m(torch.as_tensor(u)))).numpy()
    kv = jasm.make_bc_matvec(jesm, jasm.element_dof_ids(jloc.elnodes), jloc.fixmask, jloc.plan)
    for y in (y_ref, np.asarray(kv(jnp.asarray(u)))):
        np.testing.assert_allclose(o["khat_u"], y, rtol=1e-10, atol=1e-8)

    sig_old = o["sig_old"]
    sn, _, pgp, qin = loc.stress_update(coords, loc.gauss_full(240.0), torch.as_tensor(o["disp"]),
                                        torch.as_tensor(o["du"]), torch.as_tensor(sig_old),
                                        0.1, True)
    jsn, _, jpgp, jqin = jloc.stress_update(
        jnp.asarray(model.mesh.coords), jloc.gauss_full(240.0), jnp.asarray(o["disp"]),
        jnp.asarray(o["du"]), jnp.asarray(sig_old), 0.1, True)
    for ref_sn, ref_pgp, ref_qin in ((sn.numpy(), pgp.numpy(), qin.numpy()),
                                     (np.asarray(jsn), np.asarray(jpgp), np.asarray(jqin))):
        np.testing.assert_allclose(o["sig_new"], ref_sn, rtol=1e-10, atol=1e-10)
        np.testing.assert_array_equal(o["pgp"], ref_pgp)
        np.testing.assert_allclose(o["qin"], ref_qin, rtol=1e-9, atol=1e-8)
    qf = loc.internal_force(coords, sn, torch.as_tensor(o["disp"]), True).numpy()
    jqf = np.asarray(jloc.internal_force(jnp.asarray(model.mesh.coords), jsn,
                                         jnp.asarray(o["disp"]), True))
    for ref in (qf, jqf):
        np.testing.assert_allclose(o["qf"], ref, rtol=1e-9, atol=1e-8)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_block_matvec_and_deflation(ops, world):
    """``K_hat @ W`` through K0m and one all_reduce equals its columns; a
    harvest builds a space whose deflated re-solve gives the same solution
    in fewer iterations; the re-Galerkin on the same operator returns the
    same Galerkin inverse (``test_sharded_block_matvec_matches_columnwise``,
    ``test_sharded_deflated_solve_same_solution_fewer_iters``)."""
    o = ops[1][world][0]
    np.testing.assert_allclose(o["kw"], o["cols"], rtol=1e-12, atol=1e-9)
    assert np.all(o["w"][o["fixmask_m"] < 0.5] == 0.0)
    x1, it1 = o["harvest"]
    x2, it2, relres = o["deflated"]
    assert np.max(np.abs(x2 - x1)) / np.max(np.abs(x1)) < 1e-6
    assert relres <= o["rtol"] and it2 < it1
    np.testing.assert_allclose(o["kw_inv2"], o["kw_inv"], rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("world", [2, 4])
def test_node_partition_solve_matches_replicated(ops, world):
    """The row-sliced PCG (one all_gather and one reduce_scatter per
    matvec, all-reduced dots) against the replicated one: the same
    iterations, plain, deflated and warm-started, and a warm start
    converges sooner to the criterion
    (``test_node_partition_solve_matches_replicated``).  The solutions
    agree to 1e-12 relative, or 1e-11 of the solution's largest entry for
    entries near zero: the row-sliced dots sum the ranks' partial dots, in
    another order than the replicated dot, and CG carries that rounding
    through its iterations (the JAX package's bar, 1e-15 absolute, sits
    below it; 1.1e-14 was measured on a 1.4e-3 solution)."""
    o = ops[1][world][0]
    assert o["np_ok"]

    def close(x, ref):
        np.testing.assert_allclose(x, ref, rtol=1e-12, atol=1e-11 * np.abs(ref).max())

    (x, it), (xr, itr) = o["np"], o["harvest"]
    assert it == itr
    close(x, xr)
    (xd, itd), (xrd, itrd, _) = o["np_d"], o["deflated"]
    assert itd == itrd
    close(xd, xrd)
    x0, it0, rel0 = o["np_x0"]
    assert it0 < it and rel0 <= o["rtol"]
    assert it0 == o["rep_x0"][1]
    close(x0, o["rep_x0"][0])


PLASTIC2 = dict(sig_yield=60.0, nstep=2, error_max=1e-11, et_e=0.1, target_lf=99.0)


def _match(res, ref):
    np.testing.assert_allclose(res["lbd"], ref["lbd"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(res["disp_total"], ref["disp_total"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(res["peeq_gp"], ref["peeq_gp"], rtol=0, atol=1e-12)


def test_checkpoint_cross_backend_resume(tmp_path):
    """Checkpoints are in user element order: two single-device steps
    resumed for two on two ranks, and two sharded steps (written by rank 0)
    resumed for two on one device, each equal to four straight steps."""
    model = ft.model_from_arrays(_box_model())
    kw = {"cg_rtol": 1e-12}
    full = ranks.solve(model, PLASTIC2, kw, continuation=ranks.add_once)
    assert len(full["lbd"]) == 5
    ck_local, ck_sharded = str(tmp_path / "local"), str(tmp_path / "sharded")
    ranks.solve(model, PLASTIC2, kw, checkpoint_path=ck_local)
    outs = ranks.world(2, ranks.solve, model, PLASTIC2, kw, None, None, ck_local)
    assert_ranks_identical(outs)
    _match(outs[0], full)
    outs = ranks.world(2, ranks.solve, model, PLASTIC2, kw, None, ck_sharded)
    assert sorted(os.listdir(ck_sharded)) == ["step_00001.npz", "step_00002.npz"]
    _match(ranks.solve(model, PLASTIC2, kw, resume_from=ck_sharded), full)


def test_more_ranks_than_devices_raise():
    """A sharded run never quietly runs on fewer devices than asked."""
    model = ft.model_from_arrays(_box_model(n=1))
    with pytest.raises(RuntimeError, match="needs a process group of 2 ranks"):
        ft.solve_collapse(model, ft.ControlParams(nstep=1), config=ranks.config(n_devices=2))
    with pytest.raises(RuntimeError, match="requested 4 devices, the process group has 2"):
        ranks.world(2, ranks.solve, model, PLASTIC2, {"n_devices": 4})
    with pytest.raises(RuntimeError, match="found 0 CUDA device"):
        pdist.init_process_group("cuda", world_size=1)
    assert pdist.group() is None
    case = ROOT + "/examples/plate_with_hole.toml"
    from fcvm_tpu_torch.__main__ import main

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--devices 2: found 0 CUDA device"):
            main(["run", case, "--devices", "2"])
    ft.FcvmConfig(n_devices=8, node_partition=True, force_sharded=True).check_supported()


def _cli(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.Popen([sys.executable, "-m", "fcvm_tpu_torch", *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_cli_distributed_two_processes(tmp_path):
    """``run --distributed --coordinator`` on two processes and ``run
    --devices 2 --cpu``: every rank solves, rank 0 alone prints and writes,
    and its ``.out`` equals a single-device run's byte for byte."""
    case = tmp_path / "case.toml"
    case.write_text(CLI_CASE)
    common = ["run", str(case), "--cpu", "--x64", "--no-plots"]
    port = pdist.free_port()
    procs = [_cli([*common, "--outdir", str(tmp_path / f"out{r}"), "--distributed",
                   "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                   "--process-id", str(r)], tmp_path) for r in range(2)]
    single = _cli([*common, "--outdir", str(tmp_path / "single")], tmp_path)
    spawned = _cli([*common, "--outdir", str(tmp_path / "spawned"), "--devices", "2"], tmp_path)
    done = [p.communicate(timeout=600) for p in (*procs, single, spawned)]
    for p, (out, err) in zip((*procs, single, spawned), done):
        assert p.returncode == 0, err[-3000:]
    assert "final load level" in done[0][0] and done[1][0] == ""
    assert not (tmp_path / "out1").exists()
    ref = (tmp_path / "single" / "mh_cli.out").read_bytes()
    assert (tmp_path / "out0" / "mh_cli.out").read_bytes() == ref
    assert (tmp_path / "spawned" / "mh_cli.out").read_bytes() == ref
    assert done[3][0].count("final load level") == 1
