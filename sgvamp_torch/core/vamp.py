"""The VAMP iteration and its host loop (PyTorch port of sgvamp_tpu/core/vamp.py).

The whole multi-cohort state lives in (K, ...) tensors on one device (under
a mesh: its first device; the mesh divides the LD operator only, see
parallel/sharding.py). One
step is: the EM prior update, the meta denoiser, one CG of 2K lanes (the
LMMSE right-hand sides and the Hutchinson probes share A = gamw R + gam2 I,
so each LD pass serves both), and one 2K-lane LD pass for the noise
precision. PyTorch runs eagerly, so the JAX package's device control flow
(lax.cond on the iteration, the EM and CG while loops) is plain Python on
host values here.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from sgvamp_torch.config import VampConfig
from sgvamp_torch.core.cg import cg_batched, rowdot
from sgvamp_torch.core.denoiser import combine_cohorts, posterior_mean_and_slope
from sgvamp_torch.core.precond import (apply_block_jacobi, block_jacobi_eig,
                                       block_jacobi_from_eig,
                                       block_jacobi_inverse)
from sgvamp_torch.core.prior import PriorState, em_loop

logger = logging.getLogger("sgvamp")


@dataclasses.dataclass(frozen=True)
class VampInputs:
    """Per-run constant inputs.

    op: LD operator with the batched matvec (S*K, M) -> (S*K, M), carrying
        the (1-s) R + s I regularization.
    r:  (K, M) marginal-association vectors per cohort.
    a:  (K,) cohort weights N_k / Nt.
    N:  (K,) per-cohort sample counts.
    mask: optional (M,) 0/1 marker-validity mask; padded markers carry 0
        and are left out of every marker mean and trace, so a padded run
        equals the unpadded one.
    precond_q, precond_lam: optional one-time block-Jacobi factorization
        (core/precond.py block_jacobi_eig): eigenvectors (K, M/P, P, P) and
        eigenvalues (K, M/P, P) of the diagonal sub-blocks of Rused. When
        present, each step rebuilds the preconditioner with two batched
        matmuls instead of a batched inversion.
    """

    op: Any
    r: Tensor
    a: Tensor
    N: Tensor
    mask: Optional[Tensor] = None
    precond_q: Optional[Tensor] = None
    precond_lam: Optional[Tensor] = None

    @property
    def M_active(self):
        if self.mask is None:
            return self.r.shape[1]
        return torch.sum(self.mask)


@dataclasses.dataclass(frozen=True)
class VampState:
    """Complete VAMP iteration state.

    `it` is a host int. `gen` seeds the Rademacher probes when none are
    injected: a CPU torch.Generator that gives each step one seed for that
    step's draw on the state's device. It advances in place, by the same
    amount whatever M is, so a state shares it with the states that follow
    it and a run over padded markers draws the probes of the unpadded run
    (on the CPU, where a draw's first values do not depend on its length).
    """

    it: int
    xhat1: Tensor      # (M,)  denoised estimate (shared across cohorts)
    alpha1: Tensor     # (K,)  denoiser Onsager terms
    r1: Tensor         # (K, M) extrinsic means into the denoiser
    gam1: Tensor       # (K,)  extrinsic precisions into the denoiser
    xhat2: Tensor      # (K, M) LMMSE estimates
    r2: Tensor         # (K, M) extrinsic means into LMMSE
    alpha2: Tensor     # (K,)  LMMSE Onsager terms
    gam2: Tensor       # (K,)
    gamw: Tensor       # (K,)  noise precision (floored, used next iteration)
    sigma2_u: Tensor   # (K, M) warm start for the Hutchinson CG solve
    prior: PriorState
    gen: Optional[torch.Generator] = None


class StepAux(NamedTuple):
    """Per-iteration observables for writers and logging."""

    xhat1: Tensor        # (M,) damped denoised estimate of this iteration
    r1_in: Tensor        # (K, M) the r1 used this iteration
    gamw_raw: Tensor     # (K,) gamw before the 1.0 floor
    gamw: Tensor         # (K,) floored gamw
    gam1: Tensor         # (K,) updated gam1
    gam2: Tensor
    alpha1: Tensor
    alpha2: Tensor
    lam: Tensor          # scalar, post-update
    cg1_iters: Tensor    # (K,) int32
    cg1_converged: Tensor
    cg2_iters: Tensor
    cg2_converged: Tensor
    em_sweeps: int       # 0 when EM did not run
    em_rel_err: Tensor   # scalar
    mle_ok: Tensor       # always True until MLE is ported


def alignment_l2(xhat1: np.ndarray, x0v: np.ndarray) -> Tuple[float, float]:
    """Cosine alignment and relative L2 against the true signal. An all-zero
    xhat1 reports alignment 0.0 instead of NaN."""
    nx, n0 = np.linalg.norm(xhat1), np.linalg.norm(x0v)
    if n0 == 0.0:
        return 0.0, 0.0 if nx == 0.0 else float("inf")
    if nx == 0.0:
        return 0.0, 1.0
    return (float(np.inner(xhat1, x0v) / (nx * n0)),
            float(np.linalg.norm(xhat1 - x0v) / n0))


class StopMonitor:
    """Truth-free convergence and divergence detection (see
    sgvamp_tpu.core.vamp.StopMonitor): `converged` when the relative change
    of xhat1 falls below `tol`; `diverging` when min_k gam1_k falls below
    its running peak by more than a factor `gam1_drop`, or goes
    non-finite. The xhat1 at the gam1 peak is kept as the best iterate.
    Both criteria default off."""

    def __init__(self, tol: float = 0.0, gam1_drop: float = 0.0) -> None:
        self.tol = float(tol)
        self.gam1_drop = float(gam1_drop)
        self.prev_xhat1: Optional[np.ndarray] = None
        self.best_xhat1: Optional[np.ndarray] = None
        self.best_it: int = -1
        self.gam1_peak: float = -np.inf
        self.stopped_at: int = -1
        self.reason: Optional[str] = None

    def update(self, it: int, xhat1: np.ndarray, gam1: np.ndarray) -> Optional[str]:
        """Feed one iteration's (xhat1, gam1); returns a stop reason or None."""
        xhat1 = np.asarray(xhat1)
        g = float(np.min(np.asarray(gam1, np.float64)))
        finite = np.isfinite(g) and bool(np.all(np.isfinite(xhat1)))
        if finite and g >= self.gam1_peak:
            self.gam1_peak = g
            self.best_xhat1 = xhat1.copy()
            self.best_it = it
        reason = None
        if not finite:
            if self.gam1_drop > 0:
                reason = "diverging"
        elif (self.gam1_drop > 0 and self.best_it >= 0
                and g < self.gam1_peak / self.gam1_drop):
            reason = "diverging"
        elif self.tol > 0 and self.prev_xhat1 is not None:
            denom = float(np.linalg.norm(self.prev_xhat1))
            rel = float(np.linalg.norm(xhat1 - self.prev_xhat1)) / (denom + 1e-300)
            if rel < self.tol:
                reason = "converged"
        self.prev_xhat1 = xhat1
        if reason is not None and self.reason is None:
            self.stopped_at, self.reason = it, reason
        return reason


def init_state(inputs: VampInputs, cfg: VampConfig, prior: PriorState,
               gamw: float, gam1: float, seed: int = 0) -> VampState:
    """Initial state, on the device of inputs.r."""
    dtype = cfg.torch_dtype
    dev = inputs.r.device
    K, M = inputs.r.shape
    z = torch.zeros((K, M), dtype=dtype, device=dev)
    return VampState(
        it=0,
        xhat1=torch.zeros(M, dtype=dtype, device=dev),
        alpha1=torch.zeros(K, dtype=dtype, device=dev),
        r1=inputs.r.to(dtype),
        gam1=torch.full((K,), gam1, dtype=dtype, device=dev),
        xhat2=z,
        r2=z,
        alpha2=torch.zeros(K, dtype=dtype, device=dev),
        gam2=torch.zeros(K, dtype=dtype, device=dev),
        gamw=torch.full((K,), gamw, dtype=dtype, device=dev),
        sigma2_u=z,
        prior=prior.to(dtype, dev),
        gen=torch.Generator().manual_seed(seed),
    )


def vamp_step(
    state: VampState,
    inputs: VampInputs,
    cfg: VampConfig,
    u: Optional[Tensor] = None,
) -> Tuple[VampState, StepAux]:
    """One full VAMP iteration.

    `u` optionally injects the (K, M) Rademacher probe for the Hutchinson
    estimator (so that two engines can be compared step for step); when
    None, the probe is drawn from state.gen.
    """
    K, M = state.r1.shape
    dtype = cfg.torch_dtype
    r1s, gam1s = state.r1, state.gam1
    prior = state.prior
    it = state.it
    mask = inputs.mask
    M_active = inputs.M_active

    # ---- Prior update ----
    em_sweeps = 0
    em_rel_err = torch.zeros((), dtype=dtype, device=r1s.device)
    if cfg.prior_update == "em" and it >= cfg.update_prior_from:
        lam, om, em_sweeps, em_rel_err = em_loop(
            r1s, gam1s, inputs.a, prior.lam, prior.omegas, prior.sigmas,
            cfg.em_prior_maxit, cfg.em_rel_tol, mask=mask)
        prior = dataclasses.replace(prior, lam=lam, omegas=om)

    # ---- Denoising ----
    b, A, c = combine_cohorts(r1s, gam1s, inputs.a)
    xhat1_new, dxdb = posterior_mean_and_slope(b, A, prior.lam, prior.omegas,
                                               prior.sigmas)
    if cfg.rho_final is not None and cfg.rho_anneal_iters > 0:
        frac = min(it / cfg.rho_anneal_iters, 1.0)
        rho = cfg.rho + (cfg.rho_final - cfg.rho) * frac
    else:
        rho = cfg.rho
    xhat1 = rho * xhat1_new + (1 - rho) * state.xhat1 if it > 0 else xhat1_new

    # alpha1_k = mean_j d xhat_j / d r1_kj = c_k * mean_j d xhat_j / d b_j
    if mask is None:
        alpha1 = c * torch.mean(dxdb)
    else:
        alpha1 = c * (torch.sum(dxdb * mask) / M_active)
    if it > 0:
        alpha1 = rho * alpha1 + (1 - rho) * state.alpha1
    if cfg.clip_alpha1:
        alpha1 = torch.clamp(alpha1, 1e-5, 1 - 1e-5)

    # ---- LMMSE ----
    gam2 = gam1s * (1 - alpha1) / alpha1
    if cfg.gam_clamp > 0:
        gam2 = torch.clamp(gam2, 1.0 / cfg.gam_clamp, cfg.gam_clamp)
    r2 = (xhat1[None, :] - alpha1[:, None] * r1s) / (1 - alpha1)[:, None]
    gamw = state.gamw
    mu2 = gamw[:, None] * inputs.r + gam2[:, None] * r2

    if u is None:
        step_seed = int(torch.randint(0, 2 ** 62, (1,), generator=state.gen))
        gen = torch.Generator(device=r1s.device).manual_seed(step_seed)
        # drawn marker-major, so that padding M only appends to each row
        u = torch.randint(0, 2, (M, K), generator=gen,
                          device=r1s.device).T.to(dtype) * 2 - 1
    else:
        u = u.to(dtype)
    if mask is not None:
        u = u * mask[None, :]

    gamw2 = torch.cat([gamw, gamw])
    gam22 = torch.cat([gam2, gam2])

    def amatvec2(x: Tensor) -> Tensor:
        # A @ x = gamw * (R @ x) + gam2 * x, never materializing A
        return gamw2[:, None] * inputs.op.matvec(x) + gam22[:, None] * x

    precond = None
    if cfg.cg_precond_block:
        # Block-Jacobi M^{-1} from this iteration's (gamw, gam2), built once
        # and used by every CG iteration. Both lane groups share per-cohort
        # systems, so one (K, ...) inverse serves the 2K-lane solve. With
        # the engine's cached eigendecomposition the rebuild is two batched
        # matmuls; without it (vamp_step called directly) the blocks are
        # inverted here.
        if inputs.precond_q is not None:
            pinv = block_jacobi_from_eig(
                inputs.precond_q, inputs.precond_lam, gamw, gam2,
                dtype=cfg.precond_torch_dtype)
        else:
            pinv = block_jacobi_inverse(inputs.op, gamw, gam2,
                                        cfg.cg_precond_block,
                                        dtype=cfg.precond_torch_dtype)
        # the values keep their storage rounding; the cast to the apply's
        # compute type is hoisted out of the CG loop
        pinv = pinv.to(torch.promote_types(dtype, torch.float32))
        precond = lambda v: apply_block_jacobi(pinv, v)  # noqa: E731

    cg = cg_batched(
        amatvec2,
        torch.cat([mu2, u], dim=0),
        torch.cat([state.xhat2, state.sigma2_u], dim=0),
        cfg.cg_maxit, cfg.cg_rtol, cfg.cg_atol, cfg.cg_force_maxiter,
        precond=precond,
    )
    xhat2, sigma2_u = cg.x[:K], cg.x[K:]
    if cfg.lmmse_damp:
        xhat2 = rho * xhat2 + (1 - rho) * state.xhat2

    # ---- Hutchinson / Onsager-2 ----
    alpha2 = gam2 * rowdot(u, sigma2_u) / M_active
    if cfg.lmmse_damp:
        alpha2 = rho * alpha2 + (1 - rho) * state.alpha2
    if cfg.clip_alpha2:
        alpha2 = torch.clamp(alpha2, 1e-5, 1 - 1e-5)

    # ---- Precision recursions ----
    gam1_new = gam2 * (1 - alpha2) / alpha2
    if cfg.gam_clamp > 0:
        gam1_new = torch.clamp(gam1_new, 1.0 / cfg.gam_clamp, cfg.gam_clamp)
    r1_new = (xhat2 - alpha2[:, None] * r2) / (1 - alpha2)[:, None]

    # ---- Noise precision learning ----
    if cfg.learn_gamw:
        # One 2K-lane pass gives R @ xhat2 and R @ Sigma2_u together.
        Rboth = inputs.op.matvec(torch.cat([xhat2, sigma2_u], dim=0))
        z = (inputs.N - 2.0 * rowdot(xhat2, inputs.r)
             + rowdot(xhat2, Rboth[:K]))
        z = torch.clamp(z, min=0.0)
        gamw_raw = 1.0 / (z / inputs.N + rowdot(u, Rboth[K:]) / inputs.N)
    else:
        gamw_raw = gamw
    gamw_new = torch.clamp(gamw_raw, min=1.0)

    new_state = VampState(
        it=it + 1, xhat1=xhat1, alpha1=alpha1, r1=r1_new, gam1=gam1_new,
        xhat2=xhat2, r2=r2, alpha2=alpha2, gam2=gam2, gamw=gamw_new,
        sigma2_u=sigma2_u, prior=prior, gen=state.gen,
    )
    aux = StepAux(
        xhat1=xhat1, r1_in=r1s, gamw_raw=gamw_raw, gamw=gamw_new,
        gam1=gam1_new, gam2=gam2, alpha1=alpha1, alpha2=alpha2,
        lam=prior.lam,
        cg1_iters=cg.iters[:K], cg1_converged=cg.converged[:K],
        cg2_iters=cg.iters[K:], cg2_converged=cg.converged[K:],
        em_sweeps=em_sweeps, em_rel_err=em_rel_err,
        mle_ok=prior.mle_last_ok,
    )
    return new_state, aux


def _host(aux: StepAux) -> Dict[str, Any]:
    """The step's observables as numpy values (one device sync)."""
    return {name: (v.detach().cpu().numpy() if isinstance(v, Tensor) else v)
            for name, v in aux._asdict().items()}


class VampEngine:
    """Host loop around vamp_step, with reference-format output writing
    between steps."""

    def __init__(self, inputs: VampInputs, cfg: VampConfig, prior: PriorState,
                 gamw: float = 5.0, gam1: float = 1e-6, mesh=None) -> None:
        """mesh: a parallel.sharding.Mesh to cut the LD operator over (None:
        one device)."""
        if (cfg.cg_precond_block and cfg.cg_precond_eig
                and inputs.precond_q is None):
            # one-time factorization of the diagonal sub-blocks; every step
            # then rebuilds the shifted inverse from it. It is taken from
            # the operator before the mesh cuts it.
            Q, lam = block_jacobi_eig(inputs.op, cfg.cg_precond_block, 2048,
                                      cfg.precond_torch_dtype)
            inputs = dataclasses.replace(inputs, precond_q=Q, precond_lam=lam)
        if mesh is not None:
            from sgvamp_torch.parallel.sharding import shard_inputs
            inputs = shard_inputs(inputs, mesh)
        self.inputs = inputs
        self.cfg = cfg
        self.prior = prior
        self.gamw0 = gamw
        self.gam10 = gam1
        self.mesh = mesh

    def init_state(self, seed: int = 0) -> VampState:
        state = init_state(self.inputs, self.cfg, self.prior, self.gamw0,
                           self.gam10, seed)
        if self.mesh is not None:
            from sgvamp_torch.parallel.sharding import shard_state
            state = shard_state(state, self.mesh)
        return state

    def run(
        self,
        iterations: int,
        state: Optional[VampState] = None,
        fixed_u: Optional[np.ndarray] = None,
        writer: Optional[Any] = None,
        x0: Optional[np.ndarray] = None,
        Nt: Optional[float] = None,
        seed: int = 0,
        callback=None,
        M_out: Optional[int] = None,
        it0: int = 0,
        abort_on_nonfinite: bool = True,
        stop_tol: float = 0.0,
        stop_gam1_drop: float = 0.0,
    ) -> Dict[str, Any]:
        """Run `iterations` VAMP steps with per-iteration host I/O.

        Arguments as in sgvamp_tpu's VampEngine.run: fixed_u (iterations,
        K, M) injects the probes; writer is an io.writers.OutputWriter; x0
        is the true signal for the metrics; Nt scales the written xhat and
        r1 by 1/sqrt(Nt); M_out trims padded markers from the outputs; it0
        offsets iteration numbers; stop_tol / stop_gam1_drop are the
        StopMonitor thresholds (0 = off). A non-finite state ends the run
        (history["aborted_at"]) unless the monitor turns it into a stop.
        history["best_it"] / ["best_xhat1"] hold the monitor's iterate.
        """
        if state is None:
            state = self.init_state(seed)
        history: Dict[str, Any] = {
            "xhat1": [], "alignment": [], "l2": [], "params": [],
            "cg1_iters": [], "cg2_iters": [],
        }
        x0v = None if x0 is None else np.asarray(x0).squeeze()
        monitor = StopMonitor(tol=stop_tol, gam1_drop=stop_gam1_drop)
        bpp = getattr(self.inputs.op, "bytes_per_pass", lambda: 0)()
        dev = self.inputs.r.device
        for rel_it in range(iterations):
            it = it0 + rel_it
            logger.info(f"\n -----ITERATION {it} -----")
            t_step = time.perf_counter()
            u = (None if fixed_u is None
                 else torch.as_tensor(np.asarray(fixed_u[rel_it]), device=dev))
            state, aux_t = vamp_step(state, self.inputs, self.cfg, u)
            aux = _host(aux_t)
            xhat1 = aux["xhat1"][:M_out]
            dt_step = time.perf_counter() - t_step
            # LD passes: the fused CG's iterations + its initial residual +
            # the fused gamw pass; each reads the LD blocks once for all lanes.
            passes = int(max(np.max(aux["cg1_iters"]), np.max(aux["cg2_iters"]))) + 2
            if bpp and dt_step > 0:
                logger.debug(
                    f"[roofline] iteration {it}: {dt_step:.4f}s, "
                    f"{passes} LD passes, achieved "
                    f"{bpp * passes / dt_step / 1e9:.1f} GB/s (incl. dispatch)")
            r1_in = aux["r1_in"][:, :M_out]
            self._log_iteration(it, aux)
            stop_reason = monitor.update(it, xhat1, aux["gam1"])
            if abort_on_nonfinite and not (
                    np.all(np.isfinite(xhat1)) and np.all(np.isfinite(aux["gam1"]))):
                if stop_reason is not None:
                    logger.info(f"STOP at iteration {it} ({stop_reason}); best "
                                f"iterate: iteration {monitor.best_it}")
                    history["stopped_at"] = it
                    history["stop_reason"] = stop_reason
                else:
                    logger.info(
                        f"ERROR: non-finite state at iteration {it}; aborting run "
                        f"(outputs up to iteration {it - 1} are on disk)")
                    history["aborted_at"] = it
                break
            history["xhat1"].append(xhat1)
            history["cg1_iters"].append(aux["cg1_iters"])
            history["cg2_iters"].append(aux["cg2_iters"])
            lam = float(aux["lam"])
            K = aux["gamw"].shape[0]
            rows = [[it, float(aux["gamw"][k]), float(aux["gam1"][k]),
                     float(aux["gam2"][k]), float(aux["alpha1"][k]),
                     float(aux["alpha2"][k]), lam] for k in range(K)]
            history["params"].append(rows)
            if writer is not None:
                scale = 1.0 / np.sqrt(Nt) if Nt else 1.0
                writer.write_xhat(it, xhat1 * scale)
                for k in range(K):
                    writer.write_r1(it, r1_in[k] * scale, k + 1)
                    writer.write_params(rows[k], k)
            if x0v is not None:
                alignment, l2 = alignment_l2(xhat1, x0v)
                history["alignment"].append(alignment)
                history["l2"].append(l2)
                if writer is not None:
                    writer.write_metrics([it, alignment, l2])
            if callback is not None:
                callback(it, state, aux_t)
            if stop_reason is not None:
                logger.info(f"STOP at iteration {it} ({stop_reason}); best "
                            f"iterate: iteration {monitor.best_it}")
                history["stopped_at"] = it
                history["stop_reason"] = stop_reason
                break
        history["state"] = state
        history["best_it"] = monitor.best_it
        history["best_xhat1"] = monitor.best_xhat1
        return history

    def _log_iteration(self, it: int, aux: Dict[str, Any]) -> None:
        """Per-iteration diagnostics, as the JAX engine logs them."""
        cg1_c, cg2_c = aux["cg1_converged"], aux["cg2_converged"]
        if self.cfg.cg_force_maxiter:  # fixed budgets never "converge"
            cg1_c = cg2_c = np.ones_like(cg1_c)
        for k in range(aux["cg1_iters"].shape[0]):
            if not cg1_c[k]:
                logger.info(f"Cohort {k} WARNING: CG 1 convergence after "
                            f"{int(aux['cg1_iters'][k])} iterations not achieved!")
            if not cg2_c[k]:
                logger.info(f"Cohort {k} WARNING: CG 2 convergence after "
                            f"{int(aux['cg2_iters'][k])} iterations not achieved!")
        logger.debug(f"alpha1 = {aux['alpha1']}")
        logger.debug(f"gam2 = {aux['gam2']}")
        logger.debug(f"alpha2 = {aux['alpha2']}")
        logger.debug(f"gam1 = {aux['gam1']}")
        logger.debug(f"gamw = {aux['gamw_raw']}")
        logger.debug(f"lam = {float(aux['lam']):0.9f}")
        if self.cfg.prior_update == "em" and aux["em_sweeps"] > 0:
            logger.info(
                f"... prior-learning EM algorithm performed {aux['em_sweeps']} steps "
                f"and had final relative error = {float(aux['em_rel_err']):0.9f}")
