"""The VAMP iteration and its host loop (PyTorch port of sgvamp_tpu/core/vamp.py).

The whole multi-cohort state lives in (K, ...) tensors on one device (under
a mesh: its first device; the mesh divides the LD operator only, see
parallel/sharding.py). One
step is: the prior update (EM or MLE), the meta denoiser, one CG of 2K lanes (the
LMMSE right-hand sides and the Hutchinson probes share A = gamw R + gam2 I,
so each LD pass serves both), and one 2K-lane LD pass for the noise
precision.

Under several processes (a mesh from parallel/multihost.py) each process
runs the LMMSE half of the step for its own cohorts only: it holds their
operator, their CG lanes and their (K, M) LMMSE fields (xhat2, r2,
sigma2_u). The prior update and the denoiser read every cohort's r1 and
gam1, so the step ends with one exchange across processes (_exchange):
each process's r1 and gam1, and the per-cohort scalars that the logs and
writers read, all-gathered in one collective. The rest of the state is
whole on every process, and the prior update, the denoiser and the stop
criteria then compute the same values on every process from the same
gathered values - which is how the processes agree on a stop.

Two ways to run it, as in the JAX package. VampEngine.run is the host loop:
vamp_step dispatched eagerly, its observables read back and written out
after every step. run_scan / run_scan_stoppable are the fused run (JAX's
lax.scan): the step's pieces are captured once into CUDA graphs and
replayed over static buffers (_FusedStep), with the stop criteria on the
device (StopState) and the files written afterwards (write_scan_outputs).
The JAX package's device control flow becomes host branches: lax.cond on
the iteration chooses the set of graphs, and the EM, MLE and CG while loops
run in chunks whose device flag the host reads once a chunk.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from sgvamp_torch import resolve_device
from sgvamp_torch.config import VampConfig
from sgvamp_torch.core.cg import (CG_CHUNK, CGResult, cg_batched, cg_chunk, cg_finish,
                                  cg_init, cg_live, rowdot)
from sgvamp_torch.core.denoiser import combine_cohorts, posterior_mean_and_slope
from sgvamp_torch.core.precond import (apply_block_jacobi, block_jacobi_eig,
                                       block_jacobi_from_eig,
                                       block_jacobi_inverse)
from sgvamp_torch.core.prior import (EM_CHUNK, MLE_CHUNK, PriorState, em_chunk,
                                     em_finished, em_init, em_loop, em_result, mle_chunk,
                                     mle_finished, mle_init, mle_result, mle_update)
from sgvamp_torch.utils.profiling import anchor, count, span

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
    cohorts: None when this process runs all K cohorts; in a run over
        several processes (VampEngine under a multihost mesh sets it) the
        cohorts (lo, hi) of this process, whose operator and
        preconditioner alone it holds (op.K = hi - lo); r, a, N and mask
        stay whole.
    """

    op: Any
    r: Tensor
    a: Tensor
    N: Tensor
    mask: Optional[Tensor] = None
    precond_q: Optional[Tensor] = None
    precond_lam: Optional[Tensor] = None
    cohorts: Optional[Tuple[int, int]] = None

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
    Under several processes xhat2, r2 and sigma2_u hold this process's
    cohorts only (LOCAL_FIELDS); every other field is whole.
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
    em_sweeps: Tensor    # () int32, 0 when EM did not run
    em_rel_err: Tensor   # scalar
    mle_ok: Tensor       # () bool: the last MLE update was accepted (True when unused)
    cg_passes: Tensor    # () int32, CG iterations run (masked ones too): one LD pass each


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


class StopState(NamedTuple):
    """On-device mirror of StopMonitor's carry, for fused runs (the JAX
    package's StopState): the same criteria and update order as
    StopMonitor.update. reason codes: 0 = none, 1 = diverging, 2 =
    converged."""

    done: Tensor        # () bool: a criterion has fired; later steps do not run
    reason: Tensor      # () int32 code (0/1/2)
    stopped_at: Tensor  # () int32 iteration index, -1 when never stopped
    prev_xhat1: Tensor  # (M,) previous iteration's xhat1
    has_prev: Tensor    # () bool: prev_xhat1 is valid
    gam1_peak: Tensor   # () running peak of min_k gam1
    best_it: Tensor     # () int32, -1 before any finite iteration
    best_xhat1: Tensor  # (M,) snapshot at the gam1 peak
    n_ran: Tensor       # () int32: steps executed

    @staticmethod
    def create(M: int, dtype: torch.dtype, device=None) -> "StopState":
        device = resolve_device(device)

        def full(v, dt):
            return torch.full((), v, dtype=dt, device=device)
        return StopState(
            done=full(False, torch.bool), reason=full(0, torch.int32),
            stopped_at=full(-1, torch.int32),
            prev_xhat1=torch.zeros(M, dtype=dtype, device=device),
            has_prev=full(False, torch.bool), gam1_peak=full(-float("inf"), dtype),
            best_it=full(-1, torch.int32),
            best_xhat1=torch.zeros(M, dtype=dtype, device=device),
            n_ran=full(0, torch.int32))

    REASONS = {0: None, 1: "diverging", 2: "converged"}


def stop_state_update(mon: StopState, it, xhat1: Tensor, gam1: Tensor,
                      tol: float, gam1_drop: float) -> StopState:
    """One StopMonitor.update step on the device (the same order of
    criteria); `it` is the iteration's index, an int or a () int32 tensor.
    Reads nothing back to the host."""
    it = torch.as_tensor(it, dtype=torch.int32, device=xhat1.device)
    g = torch.min(gam1)
    finite = torch.isfinite(g) & torch.all(torch.isfinite(xhat1))
    take_best = finite & (g >= mon.gam1_peak)
    gam1_peak = torch.where(take_best, g, mon.gam1_peak)
    best_it = torch.where(take_best, it, mon.best_it)
    best_xhat1 = torch.where(take_best, xhat1, mon.best_xhat1)

    if gam1_drop > 0:
        diverging = ~finite | ((best_it >= 0) & (g < gam1_peak / gam1_drop))
    else:
        diverging = torch.zeros((), dtype=torch.bool, device=xhat1.device)
    # convergence is only ever evaluated on finite iterations (StopMonitor
    # takes its `not finite` branch first and never reaches the tol check)
    if tol > 0:
        denom = torch.linalg.norm(mon.prev_xhat1) + 1e-300
        rel = torch.linalg.norm(xhat1 - mon.prev_xhat1) / denom
        converged = ~diverging & finite & mon.has_prev & (rel < tol)
    else:
        converged = torch.zeros((), dtype=torch.bool, device=xhat1.device)
    reason = torch.where(diverging, 1, torch.where(converged, 2, 0)).to(torch.int32)
    fired = reason > 0
    return StopState(
        done=fired,
        reason=torch.where(fired, reason, mon.reason),
        stopped_at=torch.where(fired, it, mon.stopped_at),
        prev_xhat1=xhat1,
        has_prev=torch.ones((), dtype=torch.bool, device=xhat1.device),
        gam1_peak=gam1_peak,
        best_it=best_it,
        best_xhat1=best_xhat1,
        n_ran=mon.n_ran + 1,
    )


# the state's fields that hold this process's cohorts only in a run over
# several processes
LOCAL_FIELDS = ("xhat2", "r2", "sigma2_u")


def _own(inputs: VampInputs) -> slice:
    """The cohorts this process runs: all K, or its share under several
    processes."""
    if inputs.cohorts is None:
        return slice(0, inputs.r.shape[0])
    return slice(*inputs.cohorts)


def init_state(inputs: VampInputs, cfg: VampConfig, prior: PriorState,
               gamw: float, gam1: float, seed: int = 0) -> VampState:
    """Initial state, on the device of inputs.r."""
    dtype = cfg.torch_dtype
    dev = inputs.r.device
    K, M = inputs.r.shape
    own = _own(inputs)
    z = torch.zeros((own.stop - own.start, M), dtype=dtype, device=dev)
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


def _rho(cfg: VampConfig, it: int) -> float:
    """The damping factor of iteration `it` (annealed when configured)."""
    if cfg.rho_final is not None and cfg.rho_anneal_iters > 0:
        frac = min(it / cfg.rho_anneal_iters, 1.0)
        return cfg.rho + (cfg.rho_final - cfg.rho) * frac
    return cfg.rho


def draw_probe(gen: torch.Generator, K: int, M: int, device, dtype) -> Tensor:
    """The step's (K, M) Rademacher probe: one seed from the CPU generator
    `gen` (which advances by the same amount whatever M is), then a draw on
    `device` from that seed."""
    step_seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    g = torch.Generator(device=device).manual_seed(step_seed)
    # drawn marker-major, so that padding M only appends to each row; laid
    # out row-major, as a row of fixed_u is, so that rowdot sums a row in
    # the same order whatever the number of rows (a process of a run over
    # several holds some of the rows)
    return (torch.randint(0, 2, (M, K), generator=g, device=device).T.to(dtype) * 2
            - 1).contiguous()


def _upload_probe(row, device) -> Tensor:
    """A row of fixed_u (host memory) on `device`. On a CUDA device the copy
    from pageable memory waits for the stream to drain: a blocking span."""
    row = np.asarray(row)
    with span("sgv.probe", blocking=device.type == "cuda", bytes=row.nbytes):
        return torch.as_tensor(row, device=device)


class _Mid(NamedTuple):
    """What the part of the step before CG hands the part after it."""

    prior: PriorState  # after this step's update
    em_sweeps: Tensor
    em_rel_err: Tensor
    xhat1: Tensor
    alpha1: Tensor
    gam2: Tensor
    r2: Tensor
    u: Tensor          # the probe, masked
    gamw2: Tensor
    gam22: Tensor
    pinv: Optional[Tensor]


def _amatvec(inputs: VampInputs, mid: _Mid):
    def amatvec2(x: Tensor) -> Tensor:
        # A @ x = gamw * (R @ x) + gam2 * x, never materializing A
        return inputs.op.shifted_matvec(x, mid.gamw2, mid.gam22)
    return amatvec2


def _precond(mid: _Mid):
    if mid.pinv is None:
        return None
    return lambda v: apply_block_jacobi(mid.pinv, v)


def _before_cg(state: VampState, inputs: VampInputs, cfg: VampConfig, u: Tensor,
               rho, rhoc, first: bool, prior: PriorState,
               em_stats: Optional[tuple]) -> Tuple[_Mid, Tensor, Tensor]:
    """The step up to CG, from the prior after this step's update (the
    state's when none ran) and, when EM ran, its (sweeps, final relative
    error): the denoiser, the LMMSE set-up and the preconditioner. Returns
    CG's right-hand sides and warm start beside.
    rho and rhoc = 1 - rho are floats, or () tensors that the fused run
    fills before each replay; `first` is it == 0. u is this process's rows
    of the probe."""
    own = _own(inputs)
    dtype = cfg.torch_dtype
    r1s, gam1s = state.r1, state.gam1
    mask = inputs.mask
    M_active = inputs.M_active
    if em_stats is not None:
        em_sweeps, em_rel_err = em_stats
    else:
        em_sweeps = torch.zeros((), dtype=torch.int32, device=r1s.device)
        em_rel_err = torch.zeros((), dtype=dtype, device=r1s.device)

    # ---- Denoising ----
    b, A, c = combine_cohorts(r1s, gam1s, inputs.a)
    xhat1_new, dxdb = posterior_mean_and_slope(b, A, prior.lam, prior.omegas, prior.sigmas)
    xhat1 = xhat1_new if first else rho * xhat1_new + rhoc * state.xhat1

    # alpha1_k = mean_j d xhat_j / d r1_kj = c_k * mean_j d xhat_j / d b_j
    if mask is None:
        alpha1 = c * torch.mean(dxdb)
    else:
        alpha1 = c * (torch.sum(dxdb * mask) / M_active)
    if not first:
        alpha1 = rho * alpha1 + rhoc * state.alpha1
    if cfg.clip_alpha1:
        alpha1 = torch.clamp(alpha1, 1e-5, 1 - 1e-5)

    # ---- LMMSE (this process's cohorts) ----
    gam2 = gam1s * (1 - alpha1) / alpha1
    if cfg.gam_clamp > 0:
        gam2 = torch.clamp(gam2, 1.0 / cfg.gam_clamp, cfg.gam_clamp)
    a1, g2 = alpha1[own], gam2[own]
    r2 = (xhat1[None, :] - a1[:, None] * r1s[own]) / (1 - a1)[:, None]
    gamw = state.gamw[own]
    mu2 = gamw[:, None] * inputs.r[own] + g2[:, None] * r2

    u = u.to(dtype)
    if mask is not None:
        u = u * mask[None, :]

    pinv = None
    if cfg.cg_precond_block:
        # Block-Jacobi M^{-1} from this iteration's (gamw, gam2), built once
        # and used by every CG iteration. Both lane groups share per-cohort
        # systems, so one (K, ...) inverse serves the 2K-lane solve. With
        # the engine's cached eigendecomposition the rebuild is two batched
        # matmuls; without it (vamp_step called directly) the blocks are
        # inverted here.
        if inputs.precond_q is not None:
            pinv = block_jacobi_from_eig(
                inputs.precond_q, inputs.precond_lam, gamw, g2,
                dtype=cfg.precond_torch_dtype)
        else:
            pinv = block_jacobi_inverse(inputs.op, gamw, g2,
                                        cfg.cg_precond_block,
                                        dtype=cfg.precond_torch_dtype)
        # the values keep their storage rounding; the cast to the apply's
        # compute type is hoisted out of the CG loop
        pinv = pinv.to(torch.promote_types(dtype, torch.float32))

    mid = _Mid(prior=prior, em_sweeps=em_sweeps, em_rel_err=em_rel_err,
               xhat1=xhat1, alpha1=alpha1, gam2=gam2, r2=r2, u=u,
               gamw2=torch.cat([gamw, gamw]), gam22=torch.cat([g2, g2]), pinv=pinv)
    return (mid, torch.cat([mu2, u], dim=0),
            torch.cat([state.xhat2, state.sigma2_u], dim=0))


def _after_cg(state: VampState, inputs: VampInputs, cfg: VampConfig, mid: _Mid,
              cg: CGResult, rho, rhoc) -> Tuple[Dict[str, Tensor], PriorState, StepAux]:
    """The step after CG: damping, Hutchinson, the precision recursions and
    the gamw pass. Returns the new state's vectors by field name, its prior
    and the step's aux. Under several processes the fields and aux entries
    that _exchange gathers hold this process's cohorts only."""
    own = _own(inputs)
    K = own.stop - own.start
    M_active = inputs.M_active
    xhat2, sigma2_u = cg.x[:K], cg.x[K:]
    if cfg.lmmse_damp:
        xhat2 = rho * xhat2 + rhoc * state.xhat2

    # ---- Hutchinson / Onsager-2 ----
    gam2 = mid.gam2[own]
    alpha2 = gam2 * rowdot(mid.u, sigma2_u) / M_active
    if cfg.lmmse_damp:
        alpha2 = rho * alpha2 + rhoc * state.alpha2[own]
    if cfg.clip_alpha2:
        alpha2 = torch.clamp(alpha2, 1e-5, 1 - 1e-5)

    # ---- Precision recursions ----
    gam1_new = gam2 * (1 - alpha2) / alpha2
    if cfg.gam_clamp > 0:
        gam1_new = torch.clamp(gam1_new, 1.0 / cfg.gam_clamp, cfg.gam_clamp)
    r1_new = (xhat2 - alpha2[:, None] * mid.r2) / (1 - alpha2)[:, None]

    # ---- Noise precision learning ----
    if cfg.learn_gamw:
        # One 2K-lane pass gives R @ xhat2 and R @ Sigma2_u together.
        Rboth = inputs.op.matvec(torch.cat([xhat2, sigma2_u], dim=0))
        N = inputs.N[own]
        z = (N - 2.0 * rowdot(xhat2, inputs.r[own])
             + rowdot(xhat2, Rboth[:K]))
        z = torch.clamp(z, min=0.0)
        gamw_raw = 1.0 / (z / N + rowdot(mid.u, Rboth[K:]) / N)
    else:
        gamw_raw = state.gamw[own]
    gamw_new = torch.clamp(gamw_raw, min=1.0)

    prior = mid.prior
    fields = dict(xhat1=mid.xhat1, alpha1=mid.alpha1, r1=r1_new, gam1=gam1_new,
                  xhat2=xhat2, r2=mid.r2, alpha2=alpha2, gam2=mid.gam2, gamw=gamw_new,
                  sigma2_u=sigma2_u)
    aux = StepAux(
        xhat1=mid.xhat1, r1_in=state.r1, gamw_raw=gamw_raw, gamw=gamw_new,
        gam1=gam1_new, gam2=mid.gam2, alpha1=mid.alpha1, alpha2=alpha2,
        lam=prior.lam,
        cg1_iters=cg.iters[:K], cg1_converged=cg.converged[:K],
        cg2_iters=cg.iters[K:], cg2_converged=cg.converged[K:],
        em_sweeps=mid.em_sweeps, em_rel_err=mid.em_rel_err,
        mle_ok=prior.mle_last_ok, cg_passes=cg.passes,
    )
    return fields, prior, aux


# what the exchange gathers: state fields, then StepAux fields (the aux's
# gam1, alpha2 and gamw are the state's), largest elements first
_GATHERED = ("r1", "gam1", "alpha2", "gamw")
_GATHERED_AUX = ("gamw_raw", "cg1_iters", "cg2_iters", "cg1_converged", "cg2_converged")


def _sent(fields: Dict[str, Tensor], aux: StepAux) -> list:
    return [fields[f] for f in _GATHERED] + [getattr(aux, f) for f in _GATHERED_AUX]


def _pack(tensors) -> Tensor:
    """The tensors' bytes in one flat uint8 tensor (one collective moves
    them all, whatever their dtypes)."""
    return torch.cat([t.contiguous().view(torch.uint8).reshape(-1) for t in tensors])


def _unpack(parts, like) -> list:
    """Each process's _pack of tensors shaped as `like`, in rank order, as
    whole tensors: the processes' rows stacked along the leading axis."""
    out, off = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(torch.cat([p[off:off + n].clone().view(t.dtype).reshape(t.shape)
                              for p in parts], dim=0))
        off += n
    return out


def _merged(fields: Dict[str, Tensor], aux: StepAux, whole: list):
    """fields and aux with the exchanged entries whole."""
    got = dict(zip(_GATHERED + _GATHERED_AUX, whole))
    fields = dict(fields, **{f: got[f] for f in _GATHERED})
    aux = aux._replace(gam1=got["gam1"], alpha2=got["alpha2"], gamw=got["gamw"],
                       **{f: got[f] for f in _GATHERED_AUX})
    return fields, aux


def _exchange(fields: Dict[str, Tensor], aux: StepAux):
    """The step's one exchange across processes: every process's r1, gam1,
    alpha2 and gamw (and gamw_raw and the CG counts, for the logs and
    writers), all-gathered in one collective and made whole."""
    from sgvamp_torch.parallel.multihost import all_gather

    sent = _sent(fields, aux)
    return _merged(fields, aux, _unpack(all_gather(_pack(sent)), sent))


def _prior_update(cfg: VampConfig, it: int) -> Optional[str]:
    """The prior update iteration `it` runs: "em", "mle" or None."""
    return cfg.prior_update if it >= cfg.update_prior_from else None


def vamp_step(
    state: VampState,
    inputs: VampInputs,
    cfg: VampConfig,
    u: Optional[Tensor] = None,
) -> Tuple[VampState, StepAux]:
    """One full VAMP iteration, eagerly.

    `u` optionally injects the (K, M) Rademacher probe for the Hutchinson
    estimator (so that two engines can be compared step for step); when
    None, the probe is drawn from state.gen. Under several processes every
    process draws (or is given) the whole probe and keeps its own rows, so
    that the run draws the probes of a run of one process, and the step
    ends with the exchange. The device is read once per chunk of the EM
    loop, of the MLE solve and of CG (CG: none under cg_force_maxiter).
    """
    K, M = state.r1.shape
    it = state.it
    rho = _rho(cfg, it)

    prior, em_stats = state.prior, None
    update = _prior_update(cfg, it)
    if update == "em":
        lam, om, *em_stats = em_loop(state.r1, state.gam1, inputs.a, prior.lam, prior.omegas,
                                     prior.sigmas, cfg.em_prior_maxit, cfg.em_rel_tol,
                                     mask=inputs.mask)
        prior = dataclasses.replace(prior, lam=lam, omegas=om)
    elif update == "mle":
        prior = mle_update(state.r1, state.gam1, inputs.a, prior, cfg.mle_maxit, cfg.mle_tol,
                           mask=inputs.mask)
    if u is None:
        u = draw_probe(state.gen, K, M, state.r1.device, cfg.torch_dtype)
    mid, b, x0 = _before_cg(state, inputs, cfg, u[_own(inputs)], rho, 1 - rho, it == 0,
                            prior, em_stats)
    cg = cg_batched(_amatvec(inputs, mid), b, x0, cfg.cg_maxit, cfg.cg_rtol, cfg.cg_atol,
                    cfg.cg_force_maxiter, precond=_precond(mid))
    fields, prior, aux = _after_cg(state, inputs, cfg, mid, cg, rho, 1 - rho)
    if inputs.cohorts is not None:
        fields, aux = _exchange(fields, aux)
    return VampState(it=it + 1, prior=prior, gen=state.gen, **fields), aux


def _host(aux, skip=()) -> Dict[str, Any]:
    """A StepAux's fields (tensors or numpy arrays) as numpy values (one
    device sync), but those named in `skip`."""
    return {name: (v.detach().cpu().numpy() if isinstance(v, Tensor) else np.asarray(v))
            for name, v in aux._asdict().items() if name not in skip}


def _assign(dst, src) -> None:
    """Copy each tensor of src into the tensor of dst at the same place."""
    for d, v in zip(dst, src):
        d.copy_(v)


def _distinct(carry):
    """carry with each tensor that shares storage with an earlier one
    cloned: the pieces update a carry in place, field by field."""
    seen = set()
    out = []
    for t in carry:
        out.append(t.clone() if t.data_ptr() in seen else t)
        seen.add(t.data_ptr())
    return type(carry)(*out)


def _state_tensors(state: VampState) -> list:
    return ([getattr(state, f) for f in _VECTORS]
            + [getattr(state.prior, f.name) for f in dataclasses.fields(state.prior)])


def _clone_state(state: VampState, it: int, gen) -> VampState:
    prior = dataclasses.replace(state.prior, **{
        f.name: getattr(state.prior, f.name).clone() for f in dataclasses.fields(state.prior)})
    return VampState(it=it, gen=gen, prior=prior,
                     **{f: getattr(state, f).clone() for f in _VECTORS})


_VECTORS = ("xhat1", "alpha1", "r1", "gam1", "xhat2", "r2", "alpha2", "gam2", "gamw",
            "sigma2_u")


class _FusedStep:
    """The VAMP step as a short sequence of pieces over static buffers, for
    VampEngine.run_scan and run_scan_stoppable.

    The pieces are vamp_step's own (_before_cg, cg_init / cg_chunk,
    _after_cg, em_init / em_chunk, mle_init / mle_chunk), in this order: the
    prior update's init and chunks (the EM loop's or the MLE solve's),
    replayed until its device flag says done; the part before CG, from the
    update's result, with CG's first residual; CG chunks of CG_CHUNK
    iterations, replayed until no lane is active or maxiter iterations have
    run (under cg_force_maxiter one piece, "cg", of exactly maxiter
    unmasked iterations, whose output stays a static buffer of the pool);
    the part after CG with stop_state_update and the state's update (the
    prior's fields included). Each piece reads the engine's inputs, the
    static state S and the outputs of the pieces before it, and updates its
    carry (and the last one S) in place, so that on a CUDA device each is
    captured once into a torch.cuda.CUDAGraph (one memory pool for all) and
    replayed; on the CPU the same pieces run eagerly. A failure to capture or replay
    raises: there is no eager step on a CUDA device.

    The host branches of the step (it > 0, the prior update from
    update_prior_from, the stop thresholds) choose the set of pieces, each
    set captured at its first use. What changes from step to step is
    filled in before the replays: the probe u (drawn as vamp_step draws it, outside any graph),
    the iteration index and, when rho is annealed, rho.

    Under several processes the part after CG packs what the exchange
    gathers instead of writing it, the exchange runs eagerly between the
    replays (no graph holds a collective), and one more piece, "merge",
    unpacks the gathered values into S and the aux and then updates the
    stop monitor.

    Spans (utils/profiling.py): each piece's replays run inside a span
    sgv.piece.{prior, pre_cg, cg, post_cg, merge} that marks them as its
    device work, each host read of a device flag inside a blocking
    sgv.read, the exchange inside a blocking sgv.exchange and each capture
    inside sgv.capture (counter "captures").
    """

    def __init__(self, cfg: VampConfig, inputs: VampInputs, mesh, state: VampState) -> None:
        self.cfg, self.inputs = cfg, inputs
        dev = state.xhat1.device
        if mesh is not None and any(d != dev for d in mesh.devices.flat):
            raise ValueError(
                "a fused run needs every mesh cell on the device of the state "
                f"({dev}); this mesh spans {sorted(set(map(str, mesh.devices.flat)))}")
        self.dev = dev
        self.graphs = dev.type == "cuda"
        K, M = state.r1.shape
        dtype = cfg.torch_dtype
        self.own = _own(inputs)
        self.S = _clone_state(state, 0, None)
        # the probe's buffer (this process's rows), row-major as draw_probe
        # and fixed_u give it: the layout decides the order of rowdot's sums
        self.u = torch.zeros((K, M), dtype=dtype, device=dev)[self.own]
        self.it = torch.zeros((), dtype=torch.int32, device=dev)
        self.rho = None
        if cfg.rho_final is not None and cfg.rho_anneal_iters > 0:
            self.rho = (torch.zeros((), dtype=dtype, device=dev),
                        torch.zeros((), dtype=dtype, device=dev))
        self.mon = StopState.create(M, dtype, dev)
        self.pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self.sets: Dict[tuple, Dict[str, Any]] = {}   # key -> the pieces' outputs
        self.captured: Dict[tuple, Any] = {}          # (key, piece) -> CUDAGraph
        self.graph_launches: Dict[tuple, Dict[str, int]] = {}
        self.replays: Dict[tuple, int] = {}
        self.reads = {"em": 0, "mle": 0, "cg": 0, "stop": 0}

    def load(self, state: VampState, mon: Optional[StopState] = None) -> None:
        _assign(_state_tensors(self.S), _state_tensors(state))
        if mon is not None:
            _assign(self.mon, mon)

    def export(self, it: int, gen) -> VampState:
        return _clone_state(self.S, it, gen)

    def stop_state(self) -> StopState:
        return StopState(*[t.clone() for t in self.mon])

    def reset_stats(self) -> None:
        self.replays = {k: 0 for k in self.replays}
        self.reads = {k: 0 for k in self.reads}

    def launches(self) -> Dict[str, int]:
        """Band-kernel launches made by graph replays since reset_stats:
        each graph's launches, counted by the wrappers while it was
        captured, times its replays."""
        out: Dict[str, int] = {}
        for key, n in self.replays.items():
            for name, per in self.graph_launches.get(key, {}).items():
                out[name] = out.get(name, 0) + per * n
        return out

    def _run(self, sp: span, key: tuple, piece: str, fn, mutates=lambda: ()) -> None:
        """Run one piece inside the span sp, which marks the replay as its
        device work: captured at its first use on a CUDA device, then
        replayed; called as it is on the CPU."""
        k = (key, piece)
        self.replays[k] = self.replays.get(k, 0) + 1
        count("replays." + piece)
        if not self.graphs:
            fn()
            return
        if k not in self.captured:
            with span("sgv.capture", piece=piece):
                self.captured[k] = self._capture(k, fn, list(mutates()))
            count("captures")
        sp.device_begin()
        self.captured[k].replay()
        sp.device_end()
        for name, n in self.graph_launches[k].items():
            count("graph_launches." + name, n)

    def _capture(self, k: tuple, fn, mutates: list):
        """fn warmed up on a side stream (kernels built and loaded, lazy
        initialisations done), then captured; the warm-up's writes to the
        buffers it updates in place are undone, and the wrappers' counts of
        the capture (which launches nothing) go into graph_launches. The
        cyclic garbage collector is held off during the capture: an
        unreachable CUDA graph that it destroyed there would invalidate the
        capture."""
        from sgvamp_torch.ops.band_kernel import BAND_KERNELS

        saved = [t.clone() for t in mutates]
        current = torch.cuda.current_stream(self.dev)
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn()
        current.wait_stream(side)
        before = [w.launches for w in BAND_KERNELS]
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                fn()
        finally:
            if collecting:
                gc.enable()
        self.graph_launches[k] = {w.__name__: w.launches - n for w, n in zip(BAND_KERNELS, before)
                                  if w.launches != n}
        for w, n in zip(BAND_KERNELS, before):
            w.launches = n
        _assign(mutates, saved)
        return graph

    def _rho(self, it: int):
        rho = _rho(self.cfg, it)
        if self.rho is None:
            return rho, 1 - rho
        self.rho[0].fill_(rho)
        self.rho[1].fill_(1 - rho)
        return self.rho

    def _read(self, kind: str, flag: Tensor) -> bool:
        """The host read of a device flag (blocking: the host waits for the
        stream to drain, so the stream is anchored to the host's clock
        there)."""
        self.reads[kind] += 1
        count("reads." + kind)
        with span("sgv.read", blocking=True, kind=kind):
            done = bool(flag)
            anchor(self.dev)
        return done

    def step(self, it: int, u: Tensor, stop: Optional[Tuple[float, float]]) -> StepAux:
        """Iteration `it` from S into S with the probe u (from draw_probe, or
        a row of fixed_u); stop: the thresholds (tol, gam1_drop) of
        stop_state_update on the monitor, None for none.
        Returns the step's aux (static tensors, valid until the next
        step). Counts the step's LD passes ("ld_passes")."""
        cfg, inputs, S = self.cfg, self.inputs, self.S
        maxit = cfg.cg_maxit
        update = _prior_update(cfg, it)
        key = (it > 0, update, stop)
        P = self.sets.setdefault(key, {})
        self.it.fill_(it)
        probe = self.u
        probe.copy_(u[self.own])
        rho, rhoc = self._rho(it)
        divided = inputs.cohorts is not None

        def em_begin():
            P["em"] = _distinct(em_init(S.prior.lam.clone(), S.prior.omegas.clone()))
            P["em_done"] = em_finished(P["em"], cfg.em_prior_maxit)

        def em_sweeps():
            _assign(P["em"], em_chunk(P["em"], S.r1, S.gam1, inputs.a, S.prior.sigmas,
                                      cfg.em_prior_maxit, cfg.em_rel_tol, EM_CHUNK,
                                      mask=inputs.mask))
            P["em_done"].copy_(em_finished(P["em"], cfg.em_prior_maxit))

        def mle_begin():
            P["mle_problem"], carry = mle_init(S.r1, S.gam1, inputs.a, S.prior, inputs.mask)
            P["mle"] = _distinct(carry)
            P["mle_done"] = mle_finished(P["mle"], cfg.mle_maxit)

        def mle_iterations():
            _assign(P["mle"], mle_chunk(P["mle"], P["mle_problem"], cfg.mle_maxit, cfg.mle_tol,
                                        MLE_CHUNK))
            P["mle_done"].copy_(mle_finished(P["mle"], cfg.mle_maxit))

        def before():
            prior, em_stats = S.prior, None
            if update == "em":
                lam, om, *em_stats = em_result(P["em"])
                prior = dataclasses.replace(prior, lam=lam, omegas=om)
            elif update == "mle":
                prior = mle_result(P["mle_problem"], P["mle"], prior)
            mid, b, x0 = _before_cg(S, inputs, cfg, probe, rho, rhoc, it == 0, prior, em_stats)
            P["mid"] = mid
            P["cg"] = _distinct(cg_init(_amatvec(inputs, mid), b, x0, cfg.cg_rtol, cfg.cg_atol,
                                        cfg.cg_force_maxiter, precond=_precond(mid)))
            P["live"] = cg_live(P["cg"], maxit)

        def iterations(steps: int, masked: bool):
            mid = P["mid"]
            return cg_chunk(_amatvec(inputs, mid), P["cg"], steps, maxit,
                            cfg.cg_force_maxiter, _precond(mid), masked=masked)

        def cg_iterations():
            _assign(P["cg"], iterations(CG_CHUNK, True))
            P["live"].copy_(cg_live(P["cg"], maxit))

        def cg_forced():
            P["cg_out"] = iterations(maxit, False)

        def after(carry):
            fields, prior, aux = _after_cg(S, inputs, cfg, P["mid"], cg_finish(carry, maxit),
                                           rho, rhoc)
            # aux rows outlive this step's update of S: no aux tensor may be
            # one of S's buffers (r1_in is, gamw_raw may be)
            static = {t.data_ptr() for t in _state_tensors(S)}
            aux = aux._replace(**{f: v.clone() for f, v in aux._asdict().items()
                                  if v.data_ptr() in static})
            if divided:
                # what the exchange gathers waits in P["send"]; S keeps
                # this step's input values of those fields until "merge"
                P["sent"] = _sent(fields, aux)
                P["send"] = _pack(P["sent"])
                fields = {f: v for f, v in fields.items() if f not in _GATHERED}
            elif stop is not None:
                _assign(self.mon, stop_state_update(self.mon, self.it, aux.xhat1, aux.gam1,
                                                    *stop))
            for f, v in fields.items():
                getattr(S, f).copy_(v)
            for f in dataclasses.fields(prior):
                getattr(S.prior, f.name).copy_(getattr(prior, f.name))
            P["aux"] = aux

        def merge():
            fields, aux = _merged({}, P["aux"], _unpack(P["recv"], P["sent"]))
            if stop is not None:
                _assign(self.mon, stop_state_update(self.mon, self.it, aux.xhat1, aux.gam1,
                                                    *stop))
            for f in _GATHERED:
                getattr(S, f).copy_(fields[f])
            P["merged"] = aux

        def exchange():
            from sgvamp_torch.parallel.multihost import all_gather

            parts = all_gather(P["send"])
            if "recv" not in P:
                P["recv"] = torch.stack(parts)
            else:
                _assign(P["recv"], parts)

        def persistent():
            return _state_tensors(S) + list(self.mon)

        dev = self.dev
        if update is not None:
            with span("sgv.piece.prior", device=dev, update=update) as sp:
                self._run(sp, key, f"{update}_init", em_begin if update == "em" else mle_begin)
                if update == "em":
                    chunk, carry = em_sweeps, lambda: [*P["em"], P["em_done"]]
                else:
                    chunk, carry = mle_iterations, lambda: [*P["mle"], P["mle_done"]]
                while True:
                    self._run(sp, key, f"{update}_chunk", chunk, carry)
                    if self._read(update, P[f"{update}_done"]):
                        break
        with span("sgv.piece.pre_cg", device=dev) as sp:
            self._run(sp, key, "before_cg", before)
        with span("sgv.piece.cg", device=dev) as sp:
            if cfg.cg_force_maxiter:
                self._run(sp, key, "cg", cg_forced)
                chunks, passes, out = 1, maxit, "cg_out"
            else:
                chunks = 0
                while chunks * CG_CHUNK < maxit and self._read("cg", P["live"]):
                    self._run(sp, key, "cg_chunk", cg_iterations, lambda: [*P["cg"], P["live"]])
                    chunks += 1
                passes, out = chunks * CG_CHUNK, "cg"
            sp.attrs["chunks"] = chunks
        with span("sgv.piece.post_cg", device=dev) as sp:
            self._run(sp, key, "after_cg", lambda: after(P[out]), persistent)
        # CG's iterations (masked ones too), its first residual and the
        # gamw pass
        count("ld_passes", passes + 1 + int(cfg.learn_gamw))
        if not divided:
            return P["aux"]
        with span("sgv.exchange", blocking=True):
            exchange()
        with span("sgv.piece.merge", device=dev) as sp:
            self._run(sp, key, "merge", merge, persistent)
        return P["merged"]


class VampEngine:
    """Host loop around vamp_step, with reference-format output writing
    between steps."""

    def __init__(self, inputs: VampInputs, cfg: VampConfig, prior: PriorState,
                 gamw: float = 5.0, gam1: float = 1e-6, mesh=None) -> None:
        """mesh: a parallel.sharding.Mesh to cut the LD operator over (None:
        one device). A mesh from parallel/multihost.py::make_multihost_mesh
        divides the cohorts over the processes: this process keeps its own
        cohorts' operator (inputs.op may hold all K cohorts, which are then
        cut here, or this process's alone) and cuts it over its own rows of
        the mesh; r, a, N and mask stay whole."""
        if mesh is not None and mesh.processes is not None:
            from sgvamp_torch.parallel.multihost import own_cohorts
            from sgvamp_torch.parallel.sharding import cohort_slice

            K = inputs.r.shape[0]
            own = own_cohorts(K, mesh.processes, mesh.rank)
            op, q, lam = inputs.op, inputs.precond_q, inputs.precond_lam
            if op.K == K:
                op = cohort_slice(op, own.start, own.stop)
                q, lam = (None if t is None else t[own] for t in (q, lam))
            elif op.K != own.stop - own.start:
                raise ValueError(f"the operator holds {op.K} cohorts: neither all {K} nor "
                                 f"this process's {own.stop - own.start}")
            inputs = dataclasses.replace(inputs, op=op, precond_q=q, precond_lam=lam,
                                         cohorts=(own.start, own.stop))
        self.cells = None if mesh is None else mesh.local()
        if (cfg.cg_precond_block and cfg.cg_precond_eig
                and inputs.precond_q is None):
            # one-time factorization of the diagonal sub-blocks; every step
            # then rebuilds the shifted inverse from it. It is taken from
            # the operator before the mesh cuts it.
            with span("sgv.precond.eig"):
                Q, lam = block_jacobi_eig(inputs.op, cfg.cg_precond_block, 2048,
                                          cfg.precond_torch_dtype)
            inputs = dataclasses.replace(inputs, precond_q=Q, precond_lam=lam)
        if mesh is not None:
            from sgvamp_torch.parallel.sharding import shard_inputs
            inputs = shard_inputs(inputs, self.cells)
        self.inputs = inputs
        self.cfg = cfg
        self.prior = prior
        self.gamw0 = gamw
        self.gam10 = gam1
        self.mesh = mesh
        self.fused: Optional[_FusedStep] = None   # made by the first fused run

    def init_state(self, seed: int = 0) -> VampState:
        state = init_state(self.inputs, self.cfg, self.prior, self.gamw0,
                           self.gam10, seed)
        if self.mesh is not None:
            from sgvamp_torch.parallel.sharding import shard_state
            state = shard_state(state, self.cells)
        return state

    def _fetch_full(self, writer, fetch_aux_full: Optional[bool]) -> bool:
        """Whether each step's r1_in is read to the host (only a writer reads
        it). Under several processes the processes agree once, up front, in
        one all-gather of (holds a writer, explicit value): by default a
        writer on any process (the command line's process 0) opts every
        process in; explicit values that differ raise on every process,
        where an unagreed run would part ways."""
        code = -1 if fetch_aux_full is None else int(bool(fetch_aux_full))
        if self.inputs.cohorts is None:
            writers, explicit = [writer is not None], [code]
        else:
            from sgvamp_torch.parallel.multihost import all_gather

            flags = torch.stack(all_gather(
                torch.tensor([int(writer is not None), code], dtype=torch.int32)))
            writers, explicit = flags[:, 0].tolist(), flags[:, 1].tolist()
        vals = {v for v in explicit if v >= 0}
        if len(vals) > 1:
            raise ValueError(
                f"fetch_aux_full disagrees across processes (per-process values "
                f"{explicit}; -1 = unset): every process must pass the same value")
        fetch_full = bool(vals.pop()) if vals else any(writers)
        if any(writers) and not fetch_full:
            raise ValueError("fetch_aux_full=False is incompatible with a writer "
                             "(it needs the r1_in aux leaf)")
        return fetch_full

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
        fetch_aux_full: Optional[bool] = None,
    ) -> Dict[str, Any]:
        """Run `iterations` VAMP steps with per-iteration host I/O.

        Arguments as in sgvamp_tpu's VampEngine.run: fixed_u (iterations,
        K, M) injects the probes; writer is an io.writers.OutputWriter; x0
        is the true signal for the metrics; Nt scales the written xhat and
        r1 by 1/sqrt(Nt); M_out trims padded markers from the outputs; it0
        offsets iteration numbers; stop_tol / stop_gam1_drop are the
        StopMonitor thresholds (0 = off); fetch_aux_full: whether r1_in is
        read to the host each step (None: where a writer needs it, agreed
        across processes; see _fetch_full). A non-finite state ends the
        run (history["aborted_at"]) unless the monitor turns it into a
        stop. history["best_it"] / ["best_xhat1"] hold the monitor's
        iterate. Under several processes every process runs the same
        loop, and each decides to stop from the same gathered values.
        """
        with span("sgv.fit", steps=iterations):
            fetch_full = self._fetch_full(writer, fetch_aux_full)
            if state is None:
                state = self.init_state(seed)
            history: Dict[str, Any] = {
                "xhat1": [], "alignment": [], "l2": [], "params": [],
                "cg1_iters": [], "cg2_iters": [],
            }
            x0v = None if x0 is None else np.asarray(x0).squeeze()
            monitor = StopMonitor(tol=stop_tol, gam1_drop=stop_gam1_drop)
            dev = self.inputs.r.device
            for rel_it in range(iterations):
                it = it0 + rel_it
                logger.info(f"\n -----ITERATION {it} -----")
                with span("sgv.step", it=it):
                    u = None if fixed_u is None else _upload_probe(fixed_u[rel_it], dev)
                    state, aux_t = vamp_step(state, self.inputs, self.cfg, u)
                    with span("sgv.read", blocking=True, kind="aux"):
                        aux = _host(aux_t, skip=() if fetch_full else ("r1_in",))
                # CG's iterations (masked ones too), its first residual and the
                # gamw pass
                count("ld_passes", int(aux["cg_passes"]) + 1 + int(self.cfg.learn_gamw))
                xhat1 = aux["xhat1"][:M_out]
                r1_in = aux["r1_in"][:, :M_out] if fetch_full else None
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

    def run_scan(self, iterations: int, state: Optional[VampState] = None, seed: int = 0,
                 fixed_u: Optional[np.ndarray] = None) -> Tuple[VampState, StepAux]:
        """The whole run without host I/O (the JAX package's lax.scan over
        vamp_step): `iterations` steps, replayed as CUDA graphs on a CUDA
        device (see _FusedStep). Returns the state and a StepAux whose
        fields are stacked over the iterations, on the device. fixed_u
        (iterations, K, M) injects the probes, as in run. With the same
        seed the trajectory is the host loop's."""
        state, aux, _ = self._scan(iterations, state, seed, fixed_u, None, None)
        return state, aux

    def run_scan_stoppable(
        self,
        iterations: int,
        stop_tol: float = 0.0,
        stop_gam1_drop: float = 0.0,
        state: Optional[VampState] = None,
        stop_state: Optional[StopState] = None,
        seed: int = 0,
        fixed_u: Optional[np.ndarray] = None,
    ) -> Tuple[VampState, StepAux, StopState]:
        """run_scan with the StopMonitor's criteria on the device: a
        StopState is updated inside each step, and the host reads its
        `done` flag once a step. After a stop no step runs (the JAX
        package's dead lax.cond branch) and the probes' generator does not
        advance, so the trajectory and the selected iterate are the host
        loop's. Rows past the stop are all zero; the StopState's n_ran
        counts the rows that ran. stop_state threads the monitor across
        chunked calls."""
        return self._scan(iterations, state, seed, fixed_u,
                          (float(stop_tol), float(stop_gam1_drop)), stop_state)

    def _scan(self, iterations, state, seed, fixed_u, stop, stop_state):
        with span("sgv.fit", steps=iterations):
            if state is None:
                state = self.init_state(seed)
            K, M = state.r1.shape
            dev, dtype = state.r1.device, self.cfg.torch_dtype
            if self.fused is None:
                self.fused = _FusedStep(self.cfg, self.inputs, self.cells, state)
            F = self.fused
            if stop is not None and stop_state is None:
                stop_state = StopState.create(M, dtype, dev)
            F.load(state, stop_state)
            F.reset_stats()
            shapes = {"xhat1": (M,), "r1_in": (K, M), "lam": (), "em_sweeps": (),
                      "em_rel_err": (), "mle_ok": (), "cg_passes": ()}
            kinds = {"cg1_converged": torch.bool, "cg2_converged": torch.bool,
                     "mle_ok": torch.bool, "cg1_iters": torch.int32, "cg2_iters": torch.int32,
                     "em_sweeps": torch.int32, "cg_passes": torch.int32}
            rows = StepAux(**{f: torch.zeros((iterations, *shapes.get(f, (K,))),
                                             dtype=kinds.get(f, dtype), device=dev)
                              for f in StepAux._fields})
            it = state.it
            live = stop is None or not F._read("stop", stop_state.done)
            for rel_it in range(iterations if live else 0):
                with span("sgv.step", it=it):
                    if fixed_u is None:
                        with span("sgv.probe"):
                            u = draw_probe(state.gen, K, M, dev, dtype)
                    else:
                        u = _upload_probe(fixed_u[rel_it], dev)
                    aux = F.step(it, u, stop)
                    for row, v in zip(rows, aux):
                        row[rel_it].copy_(v)
                    it += 1
                    if stop is not None and F._read("stop", F.mon.done):
                        break
            if dev.type == "cuda":
                with span("sgv.sync", blocking=True):
                    torch.cuda.synchronize(dev)
                    anchor(dev)
            out = F.export(it, state.gen)
            return out, rows, (F.stop_state() if stop is not None else None)

    def write_scan_outputs(
        self,
        aux: StepAux,
        writer: Any,
        Nt: Optional[float] = None,
        x0: Optional[np.ndarray] = None,
        M_out: Optional[int] = None,
        it0: int = 0,
    ) -> Dict[str, Any]:
        """Write the reference-format files from a run_scan's stacked aux
        (tensors or numpy arrays), after the run: the same files, in the
        same bytes, as the host loop writes for the same rows."""
        aux = _host(aux)
        iters = aux["xhat1"].shape[0]
        K = aux["r1_in"].shape[1]
        scale = 1.0 / np.sqrt(Nt) if Nt else 1.0
        x0v = None if x0 is None else np.asarray(x0).squeeze()
        history: Dict[str, Any] = {"xhat1": [], "alignment": [], "l2": []}
        for rel_it in range(iters):
            it = it0 + rel_it
            xhat1 = aux["xhat1"][rel_it][:M_out]
            history["xhat1"].append(xhat1)
            writer.write_xhat(it, xhat1 * scale)
            lam = float(aux["lam"][rel_it])
            for k in range(K):
                writer.write_r1(it, aux["r1_in"][rel_it, k][:M_out] * scale, k + 1)
                writer.write_params([
                    it, float(aux["gamw"][rel_it, k]), float(aux["gam1"][rel_it, k]),
                    float(aux["gam2"][rel_it, k]), float(aux["alpha1"][rel_it, k]),
                    float(aux["alpha2"][rel_it, k]), lam,
                ], k)
            if x0v is not None:
                alignment, l2 = alignment_l2(xhat1, x0v)
                history["alignment"].append(alignment)
                history["l2"].append(l2)
                writer.write_metrics([it, alignment, l2])
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
                f"... prior-learning EM algorithm performed {int(aux['em_sweeps'])} steps "
                f"and had final relative error = {float(aux['em_rel_err']):0.9f}")
        elif self.cfg.prior_update == "mle" and not aux["mle_ok"]:
            logger.info("WARNING: MLE solve not accepted. No prior update!")
