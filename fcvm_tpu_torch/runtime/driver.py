"""Incremental-iterative collapse driver: Riks arc-length + restarts.

The port of :func:`fcvm_tpu.runtime.driver.solve_collapse` for the
small-strain analysis (``gnl="GNLN"``) and the geometrically nonlinear one
(``gnl="GNLY"``), itself a rebuild of the reference's ``calcDisp``
(``source code/fcVM.py:1083-1635``).  The host keeps the control flow the
reference keeps in Python: the elastic step, the linear-buckling
pre-analysis and imperfection seeding of GNL runs (``fcVM.py:1195-1295``),
load stepping, divergence restarts with shrinking increments (4-restart cap,
``fcVM.py:1457-1484``), adaptive step scaling (``fcVM.py:1530-1537``),
target-load-factor interception (``fcVM.py:1486-1510``), displacement
control, history recording and the ``continuation``/``monitor`` callbacks.
Every tensor operation runs through the backend (:class:`TorchSystem` on one
device, :class:`fcvm_tpu_torch.parallel.system.ShardedSystem` over several,
where every rank runs this loop and one writes the checkpoints).  With
``solver="scipy"`` every linear solve is a host LU of the current operator
(factorised once per operator, as the reference factorises its stiffness),
and the recycling tiers are off.

Small strain keeps the elastic operator and preconditioner for the whole
analysis (modified Newton, as the reference keeps its elastic factor,
``fcVM.py:1400-1406``).  GNL refreshes them on the first Newton iteration
of each step attempt and on every iteration that starts with a plastic
Gauss point (``fcVM.py:1351``): tangent blocks on the deformed geometry,
follower loads, the nodal block Jacobi and a tangent predictor solve, whose
solution becomes the new ``ue`` and, scaled to ``|du|``, the arc-length
control vector (``fcVM.py:1351-1396``).  On top of the reference's loop
sit the JAX package's default solver tiers: Ritz-deflation recycling of
the correction solves (one harvesting solve, the space kept across load
steps until it goes stale, re-Galerkined on each tangent) and of the
tangent predictor (its own load-rhs space), and, in float32, precision
governance (:class:`_FloorWatch`):
a tolerance clamp near the arithmetic floor, float64 residual refinement,
and a float64 rerun of the whole analysis
(:class:`PrecisionFloorError`).  Reference quirks reproduced on purpose: the
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
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from fcvm_tpu_torch.config import FcvmConfig, pin_full_fp32
from fcvm_tpu_torch.models.inp import ControlParams
from fcvm_tpu_torch.models.spec import Model
from fcvm_tpu_torch.ops import deflation as dfl
from fcvm_tpu_torch.ops import solver as slv
from fcvm_tpu_torch.ops.precond import COARSE_BUILD_STATS
from fcvm_tpu_torch.runtime import system as sysm
from fcvm_tpu_torch.runtime.backend import make_backend
from fcvm_tpu_torch.runtime.checkpoint import latest_step, save_state
from fcvm_tpu_torch.runtime.profiling import PhaseTimers
from fcvm_tpu_torch.utils.indexing import pad_vector


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

    def limits(self, ultimate_strain: float, use_csr: bool):
        """(elastic limit index, ultimate limit index)
        (``fcVM.py:1595-1612``)."""
        csr = np.asarray(self.csr)
        nz = np.nonzero(csr)[0]
        el_limit = int(nz[0] - 1) if len(nz) else 0
        if use_csr:
            over = np.argwhere(csr > 1.0)
        else:
            over = np.argwhere(np.asarray(self.peeqmax) > ultimate_strain)
        ul_limit = int(over[0][0] - 1) if len(over) else 0
        return el_limit, ul_limit


_HISTORY_FIELDS = tuple(f.name for f in dataclasses.fields(History))


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


class PrecisionFloorError(RuntimeError):
    """The float32 Newton residual stagnated at an arithmetic floor above
    ``error_max``, too far above it to clamp.

    The reference has no such failure mode (its pipeline is float64 numpy +
    CHOLMOD, ``fcVM.py:1111-1135``).  :func:`solve_collapse` catches it and
    reruns the analysis in float64 (``config.precision_failover``)."""


# float32 residual-floor detector tuning (see _FloorWatch), the JAX
# package's values
_FLOOR_WINDOW = 4  # iterations of non-improvement that define "stagnant"
_FLOOR_IMPROVE = 0.7  # stagnant = best error improved < 30% over the window
_FLOOR_CLAMP_FACTOR = 10.0  # clamp only while 2*floor <= 10 * error_max
_FLOOR_ESCALATE_CAP = 1.0e-3  # escalate only below this absolute error: a
# stagnation above it is physics (limit-load imbalance), not roundoff
_FLOOR_RISE = 1.03  # rising-tail veto: an error on an arithmetic floor
# bounces around its level, a diverging attempt climbs away from it; act
# only when one of the last two errors is within 3% of the window best


class _FloorWatch:
    """Detect the float32 residual floor in a Newton error sequence.

    Converging Newton contracts the error at least geometrically; a
    sequence whose best error improves by less than 30% over 4 iterations
    while still above ``error_max`` sits on an arithmetic floor (or a
    physical limit state, told apart by ``_FLOOR_ESCALATE_CAP``).

    ``observe(error)`` returns ``None`` (keep iterating), ``("clamp", e)``
    (accept convergence at the tolerance ``e``) or ``"escalate"`` (the
    floor is too far above ``error_max``).  ``reset(attempt)`` starts a step
    attempt.  Clamp and escalate fire only from a step's second attempt on
    (the restart's smaller increment is a free second opinion), or on any
    attempt once a clamp has fired in the run.
    """

    def __init__(self, error_max: float, enabled: bool):
        self.error_max = error_max
        self.enabled = enabled
        self.errs: list = []
        self.attempt = 0
        self.run_floored = False  # a clamp fired earlier in this run

    def reset(self, attempt: int = 0):
        self.errs = []
        self.attempt = attempt

    def observe(self, error: float):
        if not self.enabled:
            return None
        self.errs.append(error)
        if len(self.errs) <= _FLOOR_WINDOW:
            return None
        best_now = min(self.errs[-_FLOOR_WINDOW:])
        best_before = min(self.errs[:-_FLOOR_WINDOW])
        if best_now <= _FLOOR_IMPROVE * best_before:
            return None  # still converging
        if best_now <= self.error_max:
            return None  # the exit criterion will fire on its own
        if min(self.errs[-2:]) > _FLOOR_RISE * best_now:
            return None  # rising tail: divergence, not a floor
        if self.attempt < 1 and not self.run_floored:
            return None  # first attempt: let the restart re-probe once
        if 2.0 * best_now <= _FLOOR_CLAMP_FACTOR * self.error_max:
            self.run_floored = True
            return ("clamp", 2.0 * best_now)
        if best_now <= _FLOOR_ESCALATE_CAP:
            return "escalate"
        return None  # physical stagnation: leave it to the restart ladder

    def escalate_at_mrr(self) -> bool:
        """Restarts exhausted: escalate iff the abandoned attempt's best
        error was roundoff-class (at most ``_FLOOR_ESCALATE_CAP``) yet above
        ``error_max``.  Large errors are genuine divergence, the normal end
        of a collapse analysis."""
        if not self.enabled or not self.errs:
            return False
        return self.error_max < min(self.errs) <= _FLOOR_ESCALATE_CAP


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
    """Run a collapse analysis (the Start-button pipeline).

    Args:
      model: mesh + material + BCs + loads
        (:class:`fcvm_tpu_torch.models.spec.Model`).
      params: the 21 control parameters.  With ``gnl="GNLY"`` and
        ``nstep == 1`` or ``max_imp != 0`` the buckling eigensolve runs on
        the elastic pre-stress (factors and modes in the results); with
        ``nstep == 1`` the analysis ends there, with ``max_imp != 0`` the
        blend of the two lowest modes scaled to ``max_imp`` is added to the
        coordinates and the analysis restarts from them.
      continuation: optional callback ``(history, state_info) -> action``:
        ``None``/``"stop"``, ``"add"`` (run ``nstep`` more steps), ``"rev"``
        (reverse loading), ``("target", new_target_lf)``, ``("scale",
        disp_scale)``, or a list/tuple of those applied in order
        (``fcVM.py:2004-2080``).  Anything else raises ``ValueError``.
      checkpoint_path: if set, the state of every converged step is saved
        there (:mod:`fcvm_tpu_torch.runtime.checkpoint`, the JAX package's
        files: user element order, unpadded vectors).
      resume_from: a directory of such checkpoints: the analysis continues
        from the newest one (its state cast to this run's dtype) after the
        elastic step, buckling and seeding have run again.
      progress: optional line logger (the reference's ``prn_upd``).
      monitor: optional per-converged-step observer
        ``(disp_nodes, history) -> None`` receiving the (nn, 3) total nodal
        displacements.
      config: solver configuration; ``None`` = ``FcvmConfig()``, the JAX
        package's defaults.

    When a float32 run raises :class:`PrecisionFloorError` and
    ``config.precision_failover`` is on, the whole analysis reruns in
    float64 (a warning says so); the callbacks then fire again from step 0,
    and the checkpoints, if any, are overwritten from step 1: the rerun does
    not resume from the float32 run's own checkpoints.

    Returns:
      :class:`AnalysisResults`.
    """
    cfg = config if config is not None else FcvmConfig()
    cfg.check_supported()
    try:
        return _solve_collapse_impl(model, params, continuation, checkpoint_path,
                                    resume_from, progress, monitor, cfg)
    except PrecisionFloorError as err:
        if not cfg.precision_failover or cfg.resolve_dtype() != torch.float32:
            raise
        msg = (f"f32 collapse run hit its residual floor ({err}); "
               "rerunning the analysis in the float64 tier")
        warnings.warn(msg)
        if progress is not None:
            progress(f"PRECISION FAILOVER: {msg}")
        return _solve_collapse_impl(model, params, continuation, checkpoint_path, None,
                                    progress, monitor,
                                    dataclasses.replace(cfg, dtype="float64"))


def _solve_collapse_impl(model, params, continuation, checkpoint_path, resume_from,
                         progress, monitor, cfg: FcvmConfig) -> AnalysisResults:
    """The driver of :func:`solve_collapse`, in ``cfg``'s dtype."""
    device = cfg.resolve_device()
    dtype = cfg.resolve_dtype()
    pin_full_fp32()
    model.mesh.validate()
    log = progress or (lambda s: None)
    timers = PhaseTimers(torch.cuda.synchronize if device.type == "cuda" else None)

    # the reference's GNL settings (fcVM.py:1087-1094)
    large_disp = params.large_disp
    relax = 1.0 if large_disp else params.relax
    disp_output = "total" if large_disp else params.disp_output
    scale_up = 1.1 if large_disp else params.scale_up
    nstep = params.nstep
    mesh = model.mesh
    coords_np = mesh.coords.copy()

    backend = make_backend(model, cfg, dtype, device)
    if cfg.solver == "scipy" and not backend.supports_scipy:
        raise ValueError("the scipy direct tier is single-device only")
    device = backend.device
    g2u = backend.gauss_to_user  # Gauss state -> host array, user element order
    et_e = float(params.et_e)
    movdof = backend.movdof
    has_movdof = backend.has_movdof

    cg_stats = {"solves": 0, "iters": 0, "time": 0.0,
                # the GNL tangent refreshes: their time (formation, follower
                # loads, block Jacobi, predictor solve), predictor solves
                # and their CG iterations (none in small strain)
                "tangent_time": 0.0, "predictor_solves": 0, "predictor_iters": 0,
                "coarse_ridge_escalations": 0, "coarse_zero_fallbacks": 0,
                # noise-aware stepping: steps accepted at a tolerance clamped
                # to ~2x the measured float32 residual floor
                "floor_clamps": 0, "floor_clamp_steps": [],
                # float64 residual refinement: activations, first refined step
                "refinement_activations": 0, "refined_from_step": None,
                # per harvesting solve: its step, CG iterations and the Ritz
                # vectors kept (0 = no deflation space built)
                "harvests": [],
                # per recorded step: Newton iterations, restarts, the CG
                # iterations of each of its correction solves and of each
                # of its tangent predictor solves
                "steps": [],
                # the buckling eigensolve: one record per tier tried
                # (runtime/buckling.buckling_from_arrays)
                "buckling": []}
    step_solves, step_predictors = [], []

    def count_solve(iters: int, t0: float):
        cg_stats["solves"] += 1
        cg_stats["iters"] += iters
        cg_stats["time"] += time.perf_counter() - t0
        step_solves.append(iters)

    # float32 precision governance (see _FloorWatch / PrecisionFloorError)
    floor_watch = _FloorWatch(
        params.error_max,
        enabled=cfg.precision_failover and dtype == torch.float32,
    )
    # float64 residual refinement: on a roundoff-class escalation, evaluate
    # residuals in float64 over the float32 state and hold du (and, after the
    # first refined commit, disp_new) in float64; the operator,
    # preconditioner and CG stay float32.  The float64 rerun remains the
    # last tier.
    refined = False
    refine_ok = cfg.residual_refinement and floor_watch.enabled

    def linear_system(coords):
        """The elastic operator and preconditioner, loads and right-hand
        side on the geometry ``coords``."""
        with timers.phase("assemble"):
            khat, pinv, glv, rhs, gp_coords, volume, loadsums = backend.assemble_operator(coords)
        before = (COARSE_BUILD_STATS["ridge_escalations"],
                  COARSE_BUILD_STATS["zero_coarse_fallbacks"])
        with timers.phase("precond_build"):
            pc = backend.operator_pc(khat, pinv)
        del pinv
        if getattr(khat, "diag", None) is not None:  # the compact diagonal the build read
            khat = khat._replace(diag=None)
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
        return khat, pc, glv, rhs, gp_coords, volume, loadsums

    # the scipy tier's host LU, factorised once per operator
    direct = {"khat": None, "solve": None}

    def solve(khat_, pc_, b, x0=None, defl_=None) -> slv.CGResult:
        """One linear solve: PCG, or the host LU of ``khat_`` on the scipy
        tier (which ignores ``x0``, has no deflation and reports 0 CG
        iterations)."""
        if cfg.solver != "scipy":
            return backend.solve(khat_, pc_, b, x0=x0, defl=defl_)
        if direct["khat"] is not khat_:
            direct.update(khat=khat_, solve=backend.scipy_direct(khat_))
        return slv.CGResult(direct["solve"](b), 0, 0.0)

    coords = backend.tensor(coords_np)
    khat, pc, glv, rhs, gp_coords, volume, loadsums = linear_system(coords)
    qnorm = max(float(torch.linalg.vector_norm(glv)), 1.0)

    # Ritz-deflation recycling: the held space (solve space) and the harvest
    # policy.  armed: the next correction solve without a held space
    # harvests; a harvest below deflation_min_iters disarms, a plain solve at
    # or past it re-arms.
    use_deflation = cfg.deflation and cfg.solver == "cg"
    defl = None
    defl_state = {"armed": True}
    # the GNL tangent predictor's own recycling: a load-rhs harvested basis
    # (solve space, (ndof, k)), re-Galerkined on each tangent, with the same
    # hysteresis (a residual-harvested space does nothing for a load rhs)
    use_ldefl = use_deflation and cfg.load_deflation
    lstate = {"w": None, "armed": True}
    riks_fn = sysm.riks_update_crisfield if cfg.arc_length == "crisfield" else sysm.riks_update

    def solve_policy(iters: int):
        nonlocal defl
        # stale against both the absolute bar and the harvest's own count:
        # where every solve runs past REFRESH_ITERS, an absolute test alone
        # would drop the space after each deflated solve
        stale_at = max(dfl.REFRESH_ITERS, defl_state.get("harvest_iters", 0))
        if defl is not None and iters >= stale_at:
            defl = None
            log(f"deflation space stale ({iters} iters), will re-harvest")
        elif defl is None and iters >= cfg.deflation_min_iters:
            defl_state["armed"] = True

    def harvesting_solve(b):
        """Correction solve that (re)builds the deflation space from its own
        Lanczos byproducts; a harvest shorter than deflation_min_iters
        builds nothing and disarms."""
        nonlocal defl
        res, h = backend.solve_harvest(khat, pc, b)
        alphas, betas, rzs = torch.stack([h.alphas, h.betas, h.rzs]).cpu().numpy()
        defl = None
        defl_state["harvest_iters"] = res.iters  # staleness reference
        kept = 0
        if res.iters < cfg.deflation_min_iters:
            defl_state["armed"] = False
        else:
            coef = dfl.ritz_coefficients(alphas, betas, rzs, res.iters, dfl.RITZ_K)
            if coef is not None:
                defl = backend.build_deflation(khat, h.zs, coef)
                kept = int((np.abs(coef).sum(axis=0) > 0).sum())
                log(f"deflation space: k={kept} (harvest solve: {res.iters} iters)")
        cg_stats["harvests"].append({"step": step, "iters": res.iters, "k": kept})
        return res

    def elastic_solve():
        with timers.phase("elastic_solve"):
            t0 = time.perf_counter()
            res = solve(khat, pc, rhs, x0=backend.u_fix)
            count_solve(res.iters, t0)
        return res.x

    ue = elastic_solve()
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
    eigenvalues = eigenvectors = None

    # Displacement control: replace the load norm with the elastic reaction
    # on the driven boundary (fcVM.py:1169-1177).
    if has_movdof:
        *_, qelastic = backend.stress_update(coords, sig_yield, disp_new, ue,
                                             zeros_gp6, et_e, large_disp)
        qnorm = float(torch.linalg.vector_norm(movdof * qelastic))

    def results(disp_scale=1.0):
        ndof = mesh.ndof  # strip the dof-alignment padding
        disp_total = _host(disp_new)[:ndof]
        disp = (disp_total if disp_output == "total"
                else disp_total - _host(disp_old)[:ndof])
        return AnalysisResults(
            disp=disp, disp_total=disp_total, disp_el=disp_el[:ndof],
            eigenvalues=None if eigenvalues is None else np.asarray(eigenvalues),
            eigenvectors=None if eigenvectors is None else np.asarray(eigenvectors)[:ndof],
            sig_gp=g2u(sig_new), peeq_gp=g2u(peeq), csr_gp=g2u(csr),
            svm_gp=g2u(sigmises), triax_gp=g2u(triax),
            sig_yield_gp=g2u(sig_yield), history=history,
            gp_coords=g2u(gp_coords), volume=float(volume),
            loadsums=_host(loadsums), fail=False, coords_old=mesh.coords.copy(),
            coords=coords_np, timers=timers.totals(), cg_stats=cg_stats,
            disp_scale=disp_scale,
        )

    # Linear buckling on the elastic pre-stress and imperfection seeding
    # (fcVM.py:1195-1295)
    run_buckling = large_disp and not (nstep > 1 and params.max_imp == 0.0)
    if run_buckling:
        with timers.phase("buckling"):
            # the elastic stresses of the full load: a huge yield stress
            # disables the radial return (fcVM.py:1195)
            sig_el_gp, *_ = backend.stress_update(coords, 1.0e6 * sig_yield, disp_new, ue,
                                                  zeros_gp6, et_e, False)
            eigenvalues, eigenvectors = backend.buckling(coords, sig_el_gp, k=2,
                                                         stats=cg_stats["buckling"])
            del sig_el_gp
        log(f"buckling load factors: {eigenvalues}")

    if nstep == 1:
        # Elastic (and linear-buckling) analysis only (fcVM.py:1216-1223).
        disp_new = ue
        history.lbd = [0.0, 1.0]
        history.load = [0.0, 1.0]
        history.un.append(float(disp_new.abs().max()))
        for lst in (history.crip, history.peeq, history.pressure, history.svm,
                    history.triax, history.ecr, history.csr, history.peeqmax):
            lst.append(lst[0])
        return results()

    if run_buckling and params.max_imp != 0.0:
        # Blend the two buckling modes into a geometric imperfection and
        # restart the analysis from the perturbed geometry (fcVM.py:1224-1295)
        ev1, ev2 = params.ev1, params.ev2
        v1, v2 = eigenvectors[:, 0], eigenvectors[:, 1]
        ua = ev1 / (ev1 + ev2) * v1 + ev2 / (ev1 + ev2) * v2
        ub = ev1 / (ev1 + ev2) * v1 - ev2 / (ev1 + ev2) * v2
        ma, mb = np.max(np.abs(ua)), np.max(np.abs(ub))
        if ma > mb:
            imper = params.max_imp / ma * np.sign(ua[np.argmax(np.abs(ua))]) * ua
        else:
            imper = params.max_imp / mb * np.sign(ub[np.argmax(np.abs(ub))]) * ub
        coords_np = coords_np + imper[: mesh.ndof].reshape(-1, 3)
        coords = backend.tensor(coords_np)
        del khat, pc
        khat, pc, glv, rhs, gp_coords, volume, loadsums = linear_system(coords)
        qnorm = max(float(torch.linalg.vector_norm(glv)), 1.0)
        ue = elastic_solve()
        disp_el = _host(ue)
        dl = dl0
        du = dl * ue

    lbd = [0.0]
    step = -1
    cnt = True
    mrr = False  # maximum restarts reached
    target_lf = params.target_lf
    disp_scale = 1.0
    iterat_tot = 0
    eff_error_max = params.error_max
    pgp = backend.gauss_false()

    if resume_from is not None:
        # the converged state of an earlier run's newest checkpoint, in this
        # run's dtype (a new capability against the reference, which has
        # only the in-session GUI continuation loop, fcVM.py:1659-1686)
        ck_step, st = latest_step(resume_from)
        if ck_step is not None:
            log(f"resuming from checkpoint step {ck_step}")

            def vec(key):
                return backend.tensor(pad_vector(st[key], backend.ndof_pad))

            disp_new, disp_old, du = vec("disp_new"), vec("disp_old"), vec("du")
            sig_new, sig_test, sig_yield, peeq, csr, pgp = (
                backend.user_to_gauss(st[k])
                for k in ("sig_new", "sig_test", "sig_yield", "peeq", "csr", "pgp"))
            lbd = [float(v) for v in st["lbd"]]
            step = len(lbd) - 2
            dl = float(st["dl"]) if "dl" in st else lbd[-1] - lbd[-2]
            history = History(**{k: [float(v) for v in st[f"hist_{k}"]]
                                 for k in _HISTORY_FIELDS})
            history.crip = [int(v) for v in history.crip]

    def do_residual(du_, lbd1):
        fn = backend.residual_refined if refined else backend.residual
        return fn(coords, sig_yield, disp_new, du_, sig_old, glv, lbd1, qnorm, et_e,
                  large_disp, relax=relax)

    def activate_refinement(where: str):
        nonlocal refined, du, eff_error_max
        refined = True
        du = du.to(torch.float64)
        eff_error_max = params.error_max  # a refined run resolves the true
        # tolerance: drop any noise clamp
        cg_stats["refinement_activations"] += 1
        if cg_stats["refined_from_step"] is None:
            cg_stats["refined_from_step"] = step
        floor_watch.reset(attempt=floor_watch.attempt)
        log(f"f32 RESIDUAL FLOOR {where}: switching to f64 residual refinement "
            "(operator and CG stay f32; config.residual_refinement)")

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
        cg_stats["steps"].append({"newton": iterat, "restarts": restart,
                                  "cg": list(step_solves),
                                  "predictor": list(step_predictors)})
        step_solves.clear()
        step_predictors.clear()
        if monitor is not None:
            monitor(_host(disp_new).reshape(-1, 3)[: mesh.n_nodes], history)
        if checkpoint_path:
            # every rank gathers its Gauss state; one process writes
            ndof = mesh.ndof
            state = dict(
                disp_new=_host(disp_new)[:ndof], disp_old=_host(disp_old)[:ndof],
                du=_host(du)[:ndof], sig_new=g2u(sig_new), sig_test=g2u(sig_test),
                sig_yield=g2u(sig_yield), peeq=g2u(peeq), csr=g2u(csr),
                pgp=g2u(pgp), lbd=np.asarray(lbd), dl=np.asarray(dl))
            for k in _HISTORY_FIELDS:
                state[f"hist_{k}"] = np.asarray(getattr(history, k))
            if backend.writes_files:
                save_state(checkpoint_path, step + 1, state)

    def tangent_step():
        """GNL tangent refresh (fcVM.py:1351-1396): a new operator and
        preconditioner, the tangent predictor as the new ``ue`` (warm-started
        from the last one; harvesting the load space when the policy asks,
        deflated by it when one is held), the follower loads as the new
        ``glv``, and the held correction space re-Galerkined on the new
        operator.  Returns (khat, pc, defl, a), ``a`` the new control
        vector."""
        nonlocal ue, glv
        t0 = time.perf_counter()
        # on the scipy tier the direct solve below is the predictor
        want_cg = cfg.solver != "scipy"
        lharvest = use_ldefl and lstate["w"] is None and lstate["armed"]
        khat_t, pc_t, glv, out, itp = backend.tangent_refresh(
            coords, sig_old, pgp, disp_new, pc, et_e, ue0=ue if want_cg else None,
            w=lstate["w"] if use_ldefl else None, solve_predictor=want_cg and not lharvest)
        if lharvest:
            res_p, h = backend.solve_harvest(khat_t, pc_t, out, x0=ue)
            ue, itp = res_p.x, res_p.iters
            if itp < cfg.deflation_min_iters:
                lstate["armed"] = False
            else:
                alphas, betas, rzs = torch.stack([h.alphas, h.betas, h.rzs]).cpu().numpy()
                coef = dfl.ritz_coefficients(alphas, betas, rzs, itp, dfl.RITZ_K)
                if coef is not None:
                    lstate["w"] = backend.deflation_basis(h.zs, coef)
                    log(f"load-deflation space (predictor solve: {itp} iters)")
        elif want_cg:
            ue = out
            if lstate["w"] is not None and itp >= dfl.REFRESH_ITERS:
                lstate["w"] = None
                log(f"load-deflation space stale ({itp} iters), will re-harvest")
            elif lstate["w"] is None and itp >= cfg.deflation_min_iters:
                lstate["armed"] = True
        if want_cg:
            cg_stats["predictor_solves"] += 1
            cg_stats["predictor_iters"] += itp
            step_predictors.append(itp)
        cg_stats["tangent_time"] += time.perf_counter() - t0
        if not want_cg:
            t1 = time.perf_counter()
            ue = solve(khat_t, pc_t, out).x  # out: the predictor's right-hand side
            count_solve(0, t1)
        defl_t = None if defl is None else backend.make_deflation(khat_t, defl.w)
        return khat_t, pc_t, defl_t, sysm.scaled_control_vector(ue, du)

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
                step_predictors.clear()

                sig_new, sig_test, pgp, qin, r, error_dev = do_residual(du, lbd[step + 1])
                error = float(error_dev)
                iterat = 0
                log(f"Iteration: {iterat}, Error: {error:.2e}")
                eff_error_max = params.error_max
                floor_watch.reset(attempt=0)
                floor_watch.observe(error)

                while error > eff_error_max and not mrr:
                    iterat += 1
                    iterat_tot += 1
                    if large_disp and (iterat == 1 or backend.any(pgp)):
                        khat, pc, defl, a = tangent_step()
                    # one Newton iteration: correction solve (a harvesting
                    # one when the policy asks), arc-length update, residual
                    # (fcVM.py:1304-1557)
                    t0 = time.perf_counter()
                    if use_deflation and defl is None and defl_state["armed"]:
                        res = harvesting_solve(r)
                    else:
                        res = solve(khat, pc, r, defl_=defl)
                        solve_policy(res.iters)
                    du, lbd1, _ = riks_fn(a, ue, res.x, du, lbd[step], lbd[step + 1])
                    lbd[step + 1] = float(lbd1)
                    sig_new, sig_test, pgp, qin, r, error_dev = do_residual(du, lbd[step + 1])
                    error = float(error_dev)
                    count_solve(res.iters, t0)
                    log(f"Iteration: {iterat}, Error: {error:.2e}")

                    act = floor_watch.observe(error)
                    if act == "escalate":
                        if refine_ok and not refined:
                            # first escalation tier: float64 residuals in
                            # place; the refined attempt gets a fresh
                            # iteration budget
                            activate_refinement(f"at step {step}")
                            iterat = 0
                            continue
                        raise PrecisionFloorError(
                            f"Newton error stagnant at ~{min(floor_watch.errs):.2e} > "
                            f"error_max {params.error_max:g} at step {step}"
                            + (" (with f64 residual refinement)" if refined else ""))
                    if act is not None and act[1] > eff_error_max:
                        eff_error_max = act[1]
                        if step not in cg_stats["floor_clamp_steps"]:
                            cg_stats["floor_clamps"] += 1
                            cg_stats["floor_clamp_steps"].append(step)
                        log(f"f32 RESIDUAL FLOOR at step {step}: error stagnant above "
                            f"error_max {params.error_max:g}; accepting this step at "
                            f"the noise-clamped tolerance {act[1]:.2e}")

                    if iterat > params.iterat_max:
                        # Divergence restart with shrinking increments
                        # (fcVM.py:1457-1484).
                        restart += 1
                        log(f"RESTART # {restart}")
                        if restart > 4:
                            if floor_watch.escalate_at_mrr() and refine_ok and not refined:
                                # roundoff-class abandonment: retry the
                                # restart ladder once with refined residuals
                                activate_refinement(f"at restart exhaustion, step {step}")
                                restart = 1
                            elif floor_watch.escalate_at_mrr():
                                raise PrecisionFloorError(
                                    "restarts exhausted with the Newton error "
                                    f"near-converged at ~{min(floor_watch.errs):.2e} "
                                    f"(> error_max {params.error_max:g}) at step {step}"
                                    + (" (with f64 residual refinement)" if refined
                                       else ""))
                            else:
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
                        if refined:
                            du = du.to(torch.float64)
                        lbd[step + 1] = lbd[step] + dl
                        sig_new, sig_test, pgp, qin, r, error_dev = do_residual(
                            du, lbd[step + 1])
                        error = float(error_dev)
                        iterat = 0
                        # a fresh attempt re-probes the floor
                        eff_error_max = params.error_max
                        floor_watch.reset(attempt=restart)
                        floor_watch.observe(error)

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
                        qin = backend.internal_force(coords, sig_new, disp_new, large_disp)
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
                    dl *= scale_up
                    factor = scale_up
                disp_new, du = sysm.commit_step(disp_new, du, factor)
                record_step(qin, iterat, restart)
                # decay the harvest-based staleness bar once per converged
                # step, so one hard harvest does not pin it for the rest of
                # the run
                if defl_state.get("harvest_iters", 0) > dfl.REFRESH_ITERS:
                    defl_state["harvest_iters"] = max(
                        dfl.REFRESH_ITERS, int(0.9 * defl_state["harvest_iters"]))

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
    if cg_stats["predictor_solves"]:
        log(f"tangent predictor solves: {cg_stats['predictor_solves']}, "
            f"iterations: {cg_stats['predictor_iters']}")
    log(f"total time evaluating K_inv * r: {cg_stats['time']:.3f}s")
    log(f"total number of Newton iterations: {iterat_tot}")
    history.load = history.load[: step + 2]
    return results(disp_scale=disp_scale)
