"""Incremental-iterative collapse driver: Riks arc-length + restarts.

The port of :func:`fcvm_tpu.runtime.driver.solve_collapse` for the
small-strain analysis (``gnl="GNLN"``), itself a rebuild of the reference's
``calcDisp`` (``source code/fcVM.py:1083-1635``).  The host keeps the
control flow the reference keeps in Python: the elastic step, load
stepping, divergence restarts with shrinking increments (4-restart cap,
``fcVM.py:1457-1484``), adaptive step scaling (``fcVM.py:1530-1537``),
target-load-factor interception (``fcVM.py:1486-1510``), displacement
control, history recording and the ``continuation``/``monitor`` callbacks.
Every tensor operation runs through :class:`TorchSystem`.

Small strain keeps the elastic operator and preconditioner for the whole
analysis (modified Newton, as the reference keeps its elastic factor,
``fcVM.py:1400-1406``).  Reference quirks reproduced on purpose: the
restart's double division of the increment, and the ``Et * DL`` hardening
update (:func:`fcvm_tpu_torch.ops.material.update_peeq_csr`).

Intentional divergences from the reference, as in the JAX package: ``un``
takes the max nodal displacement norm over all nodes (the reference drops
the last node, ``fcVM.py:1494``); a CG solve that hits its iteration cap
plays the role of a failed factorization.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from fcvm_tpu_torch.config import FcvmConfig, pin_full_fp32
from fcvm_tpu_torch.models.inp import ControlParams
from fcvm_tpu_torch.models.spec import Model
from fcvm_tpu_torch.ops.precond import COARSE_BUILD_STATS
from fcvm_tpu_torch.runtime import system as sysm
from fcvm_tpu_torch.runtime.backend import TorchSystem
from fcvm_tpu_torch.runtime.profiling import PhaseTimers


@dataclasses.dataclass
class History:
    """Per-converged-step records (the reference's plot lists,
    ``fcVM.py:1184-1193``)."""

    un: list = dataclasses.field(default_factory=lambda: [0.0])
    load: list = dataclasses.field(default_factory=lambda: [0.0])
    crip: list = dataclasses.field(default_factory=lambda: [0])
    peeq: list = dataclasses.field(default_factory=lambda: [0.0])
    pressure: list = dataclasses.field(default_factory=lambda: [0.0])
    svm: list = dataclasses.field(default_factory=lambda: [0.0])
    triax: list = dataclasses.field(default_factory=lambda: [0.0])
    ecr: list = dataclasses.field(default_factory=lambda: [0.0])
    csr: list = dataclasses.field(default_factory=lambda: [0.0])
    peeqmax: list = dataclasses.field(default_factory=lambda: [0.0])
    lbd: list = dataclasses.field(default_factory=lambda: [0.0])


@dataclasses.dataclass
class AnalysisResults:
    """Everything ``calcDisp`` returns, plus solver statistics (host
    arrays)."""

    disp: np.ndarray  # requested output (total or incremental)
    disp_total: np.ndarray
    disp_el: np.ndarray
    eigenvalues: Optional[np.ndarray]  # buckling; None in small strain
    eigenvectors: Optional[np.ndarray]
    sig_gp: np.ndarray  # (ne, 4, 6)
    peeq_gp: np.ndarray  # (ne, 4)
    csr_gp: np.ndarray
    svm_gp: np.ndarray
    triax_gp: np.ndarray
    sig_yield_gp: np.ndarray
    history: History
    gp_coords: np.ndarray  # (ne, 4, 3)
    volume: float
    loadsums: np.ndarray
    fail: bool
    coords_old: np.ndarray
    coords: np.ndarray
    timers: dict
    cg_stats: dict
    disp_scale: float = 1.0


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def solve_collapse(
    model: Model,
    params: ControlParams,
    continuation: Optional[Callable] = None,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    progress: Optional[Callable[[str], None]] = None,
    monitor: Optional[Callable] = None,
    *,
    config: Optional[FcvmConfig] = None,
) -> AnalysisResults:
    """Run a small-strain collapse analysis (the Start-button pipeline).

    Args:
      model: mesh + material + BCs + loads
        (:class:`fcvm_tpu_torch.models.spec.Model`).
      params: the 21 control parameters; ``gnl`` must be ``"GNLN"``.
      continuation: optional callback ``(history, state_info) -> action``:
        ``None``/``"stop"``, ``"add"`` (run ``nstep`` more steps), ``"rev"``
        (reverse loading), ``("target", new_target_lf)``, ``("scale",
        disp_scale)``, or a list/tuple of those applied in order
        (``fcVM.py:2004-2080``).  Anything else raises ``ValueError``.
      checkpoint_path, resume_from: not ported yet (raise).
      progress: optional line logger (the reference's ``prn_upd``).
      monitor: optional per-converged-step observer
        ``(disp_nodes, history) -> None`` receiving the (nn, 3) total nodal
        displacements.
      config: solver configuration; ``None`` = ``FcvmConfig()``, whose
        defaults keep the JAX package's options that this slice raises for.

    Returns:
      :class:`AnalysisResults`.
    """
    cfg = config if config is not None else FcvmConfig()
    cfg.check_supported()
    if params.large_disp:
        raise NotImplementedError(
            "gnl='GNLY': geometric nonlinearity (tangent refresh, follower "
            "loads, buckling and imperfection seeding) is not ported yet "
            "(ROADMAP Queue 1 items 7, 8 and 13)"
        )
    if checkpoint_path is not None or resume_from is not None:
        raise NotImplementedError(
            "checkpoint_path/resume_from: checkpointing is not ported yet "
            "(ROADMAP Queue 1 item 12)"
        )
    device = cfg.resolve_device()
    dtype = cfg.resolve_dtype()
    pin_full_fp32()
    model.mesh.validate()
    log = progress or (lambda s: None)
    timers = PhaseTimers(torch.cuda.synchronize if device.type == "cuda" else None)

    relax = params.relax
    nstep = params.nstep
    mesh = model.mesh
    coords_np = mesh.coords.copy()

    backend = TorchSystem(model, cfg, dtype, device)
    et_e = float(params.et_e)
    movdof = backend.movdof
    has_movdof = backend.has_movdof

    cg_stats = {"solves": 0, "iters": 0, "time": 0.0,
                # the GNL tangent refresh's own time (none in small strain)
                "tangent_time": 0.0,
                "coarse_ridge_escalations": 0, "coarse_zero_fallbacks": 0,
                # per recorded step: Newton iterations, restarts and the CG
                # iterations of each of its solves
                "steps": []}
    step_solves = []

    def count_solve(iters: int, t0: float):
        cg_stats["solves"] += 1
        cg_stats["iters"] += iters
        cg_stats["time"] += time.perf_counter() - t0
        step_solves.append(iters)

    coords = backend.tensor(coords_np)
    with timers.phase("assemble"):
        esm, pinv, glv, rhs, gp_coords, volume, loadsums = backend.assemble(coords)
        khat = backend.operator(esm)
    before = (COARSE_BUILD_STATS["ridge_escalations"],
              COARSE_BUILD_STATS["zero_coarse_fallbacks"])
    with timers.phase("precond_build"):
        pc = backend.make_pc(esm, pinv)
    del esm, pinv  # the operator holds its own (Morton, element-major) copy
    esc = COARSE_BUILD_STATS["ridge_escalations"] - before[0]
    fb = COARSE_BUILD_STATS["zero_coarse_fallbacks"] - before[1]
    cg_stats["coarse_ridge_escalations"] += esc
    cg_stats["coarse_zero_fallbacks"] += fb
    if fb:
        log("WARNING: two-level coarse inverse non-finite at every ridge — "
            "continuing with the fine-level smoother ONLY (expect several "
            "times more CG iterations)")
    elif esc:
        log("two-level coarse build needed "
            f"{COARSE_BUILD_STATS['last_escalations']} ridge escalation(s)")
    qnorm = max(float(torch.linalg.vector_norm(glv)), 1.0)

    with timers.phase("elastic_solve"):
        t0 = time.perf_counter()
        res = backend.solve(khat, pc, rhs, x0=backend.u_fix)
        count_solve(res.iters, t0)
    ue = res.x
    disp_el = _host(ue)

    dl0 = 1.0 / nstep
    dl = dl0
    du = dl * ue

    zeros_gp6 = backend.gauss_zeros((6,))
    sig_new = sig_old = sig_test = zeros_gp6
    sig_yield = backend.gauss_full(params.sig_yield)
    peeq = backend.gauss_zeros()
    csr = backend.gauss_zeros()
    triax = backend.gauss_zeros()
    pressure_gp = backend.gauss_zeros()
    sigmises = backend.gauss_zeros()
    disp_new = torch.zeros(backend.ndof_pad, dtype=dtype, device=device)
    disp_old = torch.zeros_like(disp_new)
    history = History()

    # Displacement control: replace the load norm with the elastic reaction
    # on the driven boundary (fcVM.py:1169-1177).
    if has_movdof:
        *_, qelastic = backend.stress_update(coords, sig_yield, disp_new, ue,
                                             zeros_gp6, et_e)
        qnorm = float(torch.linalg.vector_norm(movdof * qelastic))

    def results(disp_scale=1.0):
        ndof = mesh.ndof  # strip the dof-alignment padding
        disp_total = _host(disp_new)[:ndof]
        disp = (disp_total if params.disp_output == "total"
                else disp_total - _host(disp_old)[:ndof])
        return AnalysisResults(
            disp=disp, disp_total=disp_total, disp_el=disp_el[:ndof],
            eigenvalues=None, eigenvectors=None,
            sig_gp=_host(sig_new), peeq_gp=_host(peeq), csr_gp=_host(csr),
            svm_gp=_host(sigmises), triax_gp=_host(triax),
            sig_yield_gp=_host(sig_yield), history=history,
            gp_coords=_host(gp_coords), volume=float(volume),
            loadsums=_host(loadsums), fail=False, coords_old=mesh.coords.copy(),
            coords=coords_np, timers=timers.totals(), cg_stats=cg_stats,
            disp_scale=disp_scale,
        )

    if nstep == 1:
        # Elastic analysis only (fcVM.py:1216-1223).
        disp_new = ue
        history.lbd = [0.0, 1.0]
        history.load = [0.0, 1.0]
        history.un.append(float(disp_new.abs().max()))
        for lst in (history.crip, history.peeq, history.pressure, history.svm,
                    history.triax, history.ecr, history.csr, history.peeqmax):
            lst.append(lst[0])
        return results()

    lbd = [0.0]
    step = -1
    cnt = True
    mrr = False  # maximum restarts reached
    target_lf = params.target_lf
    disp_scale = 1.0
    iterat_tot = 0

    def do_residual(du_, lbd1):
        return backend.residual(coords, sig_yield, disp_new, du_, sig_old,
                                glv, lbd1, qnorm, et_e, relax=relax)

    def record_step(qin, iterat, restart):
        nonlocal sig_yield, peeq, csr, triax, pressure_gp, sigmises
        sig_yield, peeq, csr, triax, pressure_gp, sigmises, ecr = backend.update_peeq_csr(
            sig_test, sig_new, sig_yield, peeq, csr, et_e, params.ultimate_strain)
        # the critical Gauss point in user (ne, 4) order (fcVM.py:1539-1557)
        (un, maxloc, csr_v, pr_v, svm_v, tri_v, ecr_v, peeq_v,
         peeqmax) = backend.record_stats(disp_new, csr, peeq, pressure_gp,
                                         sigmises, triax, ecr)
        history.un.append(un)
        history.crip.append(int(maxloc))
        history.csr.append(csr_v)
        history.pressure.append(pr_v)
        history.svm.append(svm_v)
        history.triax.append(tri_v)
        history.ecr.append(ecr_v)
        history.peeq.append(peeq_v)
        history.peeqmax.append(peeqmax)
        if has_movdof:
            history.load.append(float((movdof * qin).sum()))
        else:
            history.load.append(lbd[step + 1])
        history.lbd.append(lbd[step + 1])
        cg_stats["steps"].append(
            {"newton": iterat, "restarts": restart, "cg": list(step_solves)})
        step_solves.clear()
        if monitor is not None:
            monitor(_host(disp_new).reshape(-1, 3)[: mesh.n_nodes], history)

    with timers.phase("stepping"):
        while cnt:
            cnt = False
            pstep = 0
            while pstep < nstep and not mrr:
                step += 1
                pstep += 1
                restart = 0
                log(f"Step: {step}")
                a = du  # Riks control vector (fcVM.py:1316)
                sig_old = sig_new
                lbd.append(lbd[step] + dl)
                step_solves.clear()

                sig_new, sig_test, _, qin, r, error_dev = do_residual(du, lbd[step + 1])
                error = float(error_dev)
                iterat = 0
                log(f"Iteration: {iterat}, Error: {error:.2e}")

                while error > params.error_max and not mrr:
                    iterat += 1
                    iterat_tot += 1
                    t0 = time.perf_counter()
                    out = backend.newton_iteration(
                        coords, sig_yield, disp_new, du, sig_old, glv,
                        lbd[step], lbd[step + 1], qnorm, a, ue, r, et_e,
                        khat, pc, relax=relax)
                    error = float(out.error)
                    lbd[step + 1] = float(out.lbd1)
                    du = out.du
                    sig_new, sig_test, qin, r = out.sig_new, out.sig_test, out.qin, out.r
                    count_solve(out.cg_iters, t0)
                    log(f"Iteration: {iterat}, Error: {error:.2e}")

                    if iterat > params.iterat_max:
                        # Divergence restart with shrinking increments
                        # (fcVM.py:1457-1484).
                        restart += 1
                        log(f"RESTART # {restart}")
                        if restart > 4:
                            log("MAXIMUM RESTARTS REACHED")
                            step -= 1
                            del lbd[-1]
                            mrr = True
                            break
                        # reference quirk kept: the increment is divided by
                        # scale_re * restart twice on the first step
                        if step > 0:
                            dl = (lbd[step] - lbd[step - 1]) / params.scale_re / restart
                            du = (disp_new - disp_old) / params.scale_re / restart
                        else:
                            dl = dl0 / params.scale_re / restart
                            du = dl * ue / params.scale_re / restart
                        lbd[step + 1] = lbd[step] + dl
                        sig_new, sig_test, _, qin, r, error_dev = do_residual(
                            du, lbd[step + 1])
                        error = float(error_dev)
                        iterat = 0

                if mrr:
                    break

                if abs(target_lf - lbd[step]) < abs(lbd[step + 1] - lbd[step]):
                    # Intercept the target load factor exactly by linear
                    # rescaling of the final increment (fcVM.py:1486-1510).
                    log("REACHED TARGET LOAD")
                    fac = (target_lf - lbd[step]) / (lbd[step + 1] - lbd[step])
                    du = fac * du
                    sig_new = sig_old + fac * (sig_new - sig_old)
                    sig_test = sig_old + fac * (sig_test - sig_old)
                    lbd[step + 1] = target_lf
                    if has_movdof:
                        # consistent reaction for the interpolated state (the
                        # reference skips this record, fcVM.py:1486-1523)
                        qin = backend.internal_force(coords, sig_new, disp_new)
                    disp_new = disp_new + du
                    record_step(qin, iterat, restart)
                    break
                # Converged load step (fcVM.py:1515-1557).
                disp_old = disp_new
                dl = lbd[step + 1] - lbd[step]
                factor = 1.0
                if iterat > 10:
                    dl /= params.scale_dn
                    factor = 1.0 / params.scale_dn
                if iterat < 5:
                    dl *= params.scale_up
                    factor = params.scale_up
                disp_new, du = sysm.commit_step(disp_new, du, factor)
                record_step(qin, iterat, restart)

            if continuation is not None and not mrr:
                action = continuation(history, dict(step=step, dl=dl, target_lf=target_lf))
                # one atomic action (None/"stop"/"add"/"rev", ("target", v),
                # ("scale", v)) or an iterable of them, applied in order
                atomic = (
                    action is None
                    or isinstance(action, str)
                    or (isinstance(action, tuple) and len(action) == 2
                        and action[0] in ("target", "scale"))
                )
                try:
                    actions = [action] if atomic else list(action)
                except TypeError:
                    actions = [action]  # not iterable: reported below
                for act in actions:
                    if act == "add":
                        cnt = True
                    elif act == "rev":
                        cnt = True
                        dl = -dl
                        du = -du
                    elif isinstance(act, tuple) and len(act) == 2 and act[0] == "target":
                        cnt = True
                        target_lf = float(act[1])
                    elif isinstance(act, tuple) and len(act) == 2 and act[0] == "scale":
                        disp_scale = float(act[1])
                    elif act is None or act == "stop":
                        pass
                    else:
                        raise ValueError(
                            f"unrecognized continuation action {act!r} "
                            "(expected 'stop'/'add'/'rev', ('target', v), "
                            "('scale', v), or a list of those)"
                        )

    cg_stats["newton_iterations"] = iterat_tot
    log(f"total number of CG solves: {cg_stats['solves']}, iterations: {cg_stats['iters']}")
    log(f"total time evaluating K_inv * r: {cg_stats['time']:.3f}s")
    log(f"total number of Newton iterations: {iterat_tot}")
    history.load = history.load[: step + 2]
    return results(disp_scale=disp_scale)
