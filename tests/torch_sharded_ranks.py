"""Rank functions of the sharded parity tests (``tests/test_torch_sharded_*.py``).

They run inside the processes that :func:`fcvm_tpu_torch.parallel.dist.spawn`
starts, one per rank of a gloo world on the CPU, so this module imports the
port alone (no JAX).  Each returns plain numbers and numpy arrays, which the
test compares across ranks and with the JAX package.
"""

import numpy as np
import torch

import fcvm_tpu_torch as ft
from fcvm_tpu_torch.parallel import dist as pdist

# the JAX package's default solver tiers off (tests/torch_parity.TIERS_OFF)
TIERS_OFF = dict(deflation=False, residual_refinement=False, precision_failover=False)


def world(n, fn, *args):
    """``fn(*args)`` on a gloo world of ``n`` CPU ranks, one thread each;
    every rank's result, rank order."""
    return pdist.spawn(fn, n, args=args, device="cpu", threads=1, timeout=600)


def config(**kw):
    """The port's float64 CPU configuration over the running world, with
    the solver tiers off unless ``kw`` turns them on."""
    return ft.FcvmConfig(**{"device": "cpu", "dtype": "float64", **TIERS_OFF,
                            "n_devices": pdist.world_size(), **kw})


def add_once(history, info):
    """A continuation: run ``nstep`` more steps once (two rounds)."""
    return "add" if len(history.lbd) <= 3 else "stop"


def summary(res, lines):
    """What the tests compare of an :class:`~fcvm_tpu_torch.AnalysisResults`."""
    h = res.history
    cs = res.cg_stats
    return dict(
        rank=pdist.rank(),
        **{k: list(map(float, getattr(h, k)))
           for k in ("lbd", "un", "load", "csr", "peeq", "peeqmax")},
        crip=list(map(int, h.crip)), disp_total=res.disp_total, peeq_gp=res.peeq_gp,
        sig_gp=res.sig_gp, csr_gp=res.csr_gp, gp_coords=res.gp_coords,
        volume=float(res.volume), loadsums=res.loadsums, coords=res.coords,
        eigenvalues=res.eigenvalues, eigenvectors=res.eigenvectors,
        steps=cs["steps"], solves=cs["solves"], iters=cs["iters"],
        predictor_solves=cs["predictor_solves"], predictor_iters=cs["predictor_iters"],
        harvests=cs["harvests"], buckling=cs["buckling"],
        refinement_activations=cs["refinement_activations"], lines=lines)


def solve(model, params_kw, cfg_kw=None, continuation=None, checkpoint_path=None,
          resume_from=None):
    """``solve_collapse`` on this rank; its :func:`summary` and the type of
    backend the configuration makes."""
    from fcvm_tpu_torch.runtime.backend import make_backend

    cfg = config(**(cfg_kw or {}))
    lines = []
    res = ft.solve_collapse(model, ft.ControlParams(**params_kw), continuation=continuation,
                            checkpoint_path=checkpoint_path, resume_from=resume_from,
                            progress=lines.append, config=cfg)
    out = summary(res, lines)
    out["backend"] = type(make_backend(model, cfg, torch.float64, torch.device("cpu"))).__name__
    return out


def breakdown_once(model, params_kw, cfg_kw=None):
    """:func:`solve` with the first pencil eigensolve of the run raising
    :class:`~fcvm_tpu_torch.EigensolveBreakdownError` (the sharded attempt),
    so the sharded backend falls back to the single-device ladder; the
    warnings it gave and the number of eigensolves are returned too."""
    import warnings

    from fcvm_tpu_torch.runtime import buckling as bk

    real, calls = bk.pencil_subspace, []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise bk.EigensolveBreakdownError("forced breakdown (test)")
        return real(*a, **kw)

    bk.pencil_subspace = flaky
    try:
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            out = solve(model, params_kw, cfg_kw)
    finally:
        bk.pencil_subspace = real
    out["warnings"] = [str(w.message) for w in warned]
    out["eigensolves"] = len(calls)
    return out


def collectives():
    """Each collective of :mod:`fcvm_tpu_torch.parallel.dist` on rank-made data."""
    r, n = pdist.rank(), pdist.world_size()
    x = torch.arange(4 * n, dtype=torch.float64) * (r + 1)
    return dict(
        all_reduce=pdist.all_reduce(x.clone()).numpy(),
        all_gather=pdist.all_gather(torch.full((2, 3), float(r))).numpy(),
        reduce_scatter=pdist.reduce_scatter(x.clone()).numpy(),
        broadcast=pdist.broadcast(torch.full((3,), float(r))).numpy())


def backend_ops(model, seed=0):
    """The sharded backend's pieces on this rank, gathered to user order:
    assembly, ``K_hat @ v`` and ``K_hat @ W`` against the columnwise
    products, the stress update and internal force on a seeded state, the
    replicated solve against the node-partitioned one (plain, warm-started
    and deflated), a harvest and the deflated re-solve, and the re-Galerkin."""
    from fcvm_tpu_torch.ops import deflation as dfl
    from fcvm_tpu_torch.parallel.system import ShardedSystem

    cfg = config(force_sharded=True, cg_rtol=1e-10)
    be = ShardedSystem(model, cfg, torch.float64, torch.device("cpu"))
    coords = be.tensor(model.mesh.coords)
    khat, pinv, glv, rhs, gpc, vol, ls = be.assemble_operator(coords)
    esm = khat.esm_t.permute(2, 0, 1)
    pc = be.operator_pc(khat, pinv)
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.normal(size=be.ndof_pad))
    w = torch.as_tensor(rng.normal(size=(be.ndof_pad, 5)))
    sp = be.space
    kw = be._block_op(khat.esm_t)(w)
    cols = torch.stack([khat(w[:, j]) for j in range(5)], dim=1)
    ne = model.mesh.n_elements
    disp = torch.as_tensor(rng.normal(size=be.ndof_pad) * 1e-3)
    du = torch.as_tensor(rng.normal(size=be.ndof_pad) * 1e-4)
    sig_old = rng.normal(size=(ne, 4, 6)) * 50.0
    sn, st, pgp, qin = be.stress_update(coords, be.gauss_full(240.0), disp, du,
                                        be.user_to_gauss(sig_old), 0.1, True)
    qf = be.internal_force(coords, sn, disp, True)

    res_h, h = be.solve_harvest(khat, pc, rhs, nstore=48)
    coef = dfl.ritz_coefficients(*torch.stack([h.alphas, h.betas, h.rzs]).numpy(),
                                 res_h.iters, 12)
    defl = be.build_deflation(khat, h.zs, coef)
    res_d = be.solve(khat, pc, rhs, defl=defl)
    defl2 = be.make_deflation(khat, defl.w)
    be.cfg.node_partition = True
    np_ok = be._np_solve_ok(pc)
    res_np = be.solve(khat, pc, rhs)
    res_np_d = be.solve(khat, pc, rhs, defl=defl)
    res_np_x0 = be.solve(khat, pc, rhs, x0=0.9 * res_h.x)
    be.cfg.node_partition = False
    res_rep_x0 = be.solve(khat, pc, rhs, x0=0.9 * res_h.x)
    return dict(
        esm=be.gauss_to_user(esm), glv=glv.numpy(), rhs=rhs.numpy(), volume=float(vol),
        loadsums=ls.numpy(), gp_coords=be.gauss_to_user(gpc), pinv=pinv[sp.npos].numpy(),
        khat_u=sp.from_m(khat(sp.to_m(u))).numpy(), u=u.numpy(), kw=kw.numpy(),
        cols=cols.numpy(), disp=disp.numpy(), du=du.numpy(), sig_old=sig_old,
        sig_new=be.gauss_to_user(sn), pgp=be.gauss_to_user(pgp), qin=qin.numpy(),
        qf=qf.numpy(), rtol=be.rtol, np_ok=np_ok,
        harvest=(res_h.x.numpy(), res_h.iters), deflated=(res_d.x.numpy(), res_d.iters,
                                                          res_d.relres),
        w=defl.w.numpy(), kw_inv=defl.kw_inv.numpy(), kw_inv2=defl2.kw_inv.numpy(),
        fixmask_m=sp.fixmask_m.numpy(),
        np=(res_np.x.numpy(), res_np.iters), np_d=(res_np_d.x.numpy(), res_np_d.iters),
        np_x0=(res_np_x0.x.numpy(), res_np_x0.iters, res_np_x0.relres),
        rep_x0=(res_rep_x0.x.numpy(), res_rep_x0.iters))
