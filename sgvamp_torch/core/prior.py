"""EM and MLE learning of the spike-and-slab mixture weights.

PyTorch port of sgvamp_tpu/core/prior.py. Each JAX while_loop becomes
pieces that a CUDA graph can hold, since none reads the device: an init, a
chunk (a fixed number of iterations, under which a loop that has stopped
keeps its values), a device flag that says the loop has finished, and the
result. em_loop and mle_update drive them eagerly and read the flag once
per chunk (EM_CHUNK sweeps, MLE_CHUNK Newton iterations).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from sgvamp_torch import resolve_device

# sweeps between two host reads of the stopping flag: the bench's prior
# runs at most 5 sweeps a step (one read), and a loop that stops within a
# chunk wastes at most EM_CHUNK - 1 sweeps of elementwise work
EM_CHUNK = 5
# Newton iterations between two host reads of the MLE solve's flag: a warm
# started solve converges in a few iterations, each two passes over the
# (K, M, L) probabilities
MLE_CHUNK = 4


@dataclasses.dataclass(frozen=True)
class PriorState:
    """Learnable prior parameters.

    lam:    scalar slab inclusion probability.
    omegas: (L-1,) slab mixture weights (sum to 1).
    sigmas: (L-1,) slab variances, already scaled by Nt; never updated.
    mle_gam: the MLE solve's cached Lagrange multiplier (its warm start).
    mle_gam_valid: whether mle_gam holds a previous solution.
    mle_last_ok: whether the most recent MLE update was accepted (True
            until an update is rejected; EM leaves it as it is).
    """

    lam: Tensor
    omegas: Tensor
    sigmas: Tensor
    mle_gam: Tensor
    mle_gam_valid: Tensor
    mle_last_ok: Tensor

    @staticmethod
    def create(lam: float, omegas, sigmas, dtype: torch.dtype = torch.float64,
               device=None) -> "PriorState":
        """The fields on `device` (None: the default CUDA device)."""
        device = resolve_device(device)

        def f(v):
            return torch.as_tensor(v, dtype=dtype, device=device)
        return PriorState(
            lam=f(lam), omegas=f(omegas), sigmas=f(sigmas), mle_gam=f(1.0),
            mle_gam_valid=torch.tensor(False, device=device),
            mle_last_ok=torch.tensor(True, device=device),
        )

    def to(self, dtype: torch.dtype, device: torch.device | str) -> "PriorState":
        """Floating fields cast to `dtype`; every field moved to `device`."""
        return PriorState(**{
            f.name: getattr(self, f.name).to(
                device=device,
                dtype=dtype if getattr(self, f.name).is_floating_point() else None)
            for f in dataclasses.fields(self)})


def em_update(
    r1s: Tensor, gam1s: Tensor, a: Tensor, lam: Tensor, omegas: Tensor,
    sigmas: Tensor, mask: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """One EM sweep over the (K, M, L-1) responsibility tensor.

    Returns updated (lam, omegas):
      lam    <- mean_j( sum_k a_k pi_kj / sum_k a_k )
      omegas <- sum_kj a_k pi xi_tilde / sum_kj a_k pi .
    `mask` (M,) excludes padded markers from both reductions.
    """
    r2 = (r1s * r1s)[:, :, None]                              # (K, M, 1)
    v = sigmas[None, None, :] + (1.0 / gam1s)[:, None, None]  # (K, 1, L-1)
    E = -r2 / (2.0 * v)                                       # (K, M, L-1)
    m = torch.amax(E, dim=2, keepdim=True)                    # (K, M, 1)
    xi = lam * omegas[None, None, :] * torch.exp(E - m) / torch.sqrt(v)
    sxi = torch.sum(xi, dim=2, keepdim=True)                  # (K, M, 1)
    xi_tilde = xi / sxi
    spike = (
        (1.0 - lam)
        * torch.exp(-r2 * gam1s[:, None, None] / 2.0 - m)
        * torch.sqrt(gam1s)[:, None, None]
    )
    pi = 1.0 / (1.0 + spike / sxi)                            # (K, M, 1)
    if mask is not None:
        pi = pi * mask[None, :, None]
        M_active = torch.sum(mask)
    else:
        M_active = r1s.shape[1]

    asum = torch.sum(a)
    new_lam = torch.sum(torch.einsum("k,kmo->mo", a, pi) / asum) / M_active
    num = torch.einsum("k,kml->l", a, pi[:, :, 0:1] * xi_tilde)
    den = torch.einsum("k,kmo->", a, pi)
    return new_lam, num / den


class EMCarry(NamedTuple):
    """The EM loop's state between chunks (sgvamp_tpu's _EMLoopState)."""

    lam: Tensor
    omegas: Tensor
    lam_err: Tensor
    omega_err: Tensor
    sweeps: Tensor     # () int32
    done: Tensor       # () bool: the last sweep met rel_tol


def em_init(lam: Tensor, omegas: Tensor) -> EMCarry:
    inf = torch.full((), float("inf"), dtype=lam.dtype, device=lam.device)
    return EMCarry(lam=lam, omegas=omegas, lam_err=inf, omega_err=inf,
                   sweeps=torch.zeros((), dtype=torch.int32, device=lam.device),
                   done=torch.zeros((), dtype=torch.bool, device=lam.device))


def em_chunk(c: EMCarry, r1s: Tensor, gam1s: Tensor, a: Tensor, sigmas: Tensor,
             maxit: int, rel_tol: float, steps: int,
             mask: Optional[Tensor] = None) -> EMCarry:
    """`steps` sweeps from carry c; a sweep after the loop has stopped (the
    tolerance met, or maxit sweeps run) keeps every value as it was."""
    lam, omegas, lam_err, omega_err, sweeps, done = c
    for _ in range(steps):
        new_lam, new_omegas = em_update(r1s, gam1s, a, lam, omegas, sigmas, mask=mask)
        new_omega_err = torch.linalg.norm(new_omegas - omegas) / torch.linalg.norm(omegas)
        new_lam_err = torch.abs(new_lam - lam) / new_lam  # divides by the UPDATED lam, as the reference does
        live = ~done & (sweeps < maxit)
        lam = torch.where(live, new_lam, lam)
        omegas = torch.where(live, new_omegas, omegas)
        lam_err = torch.where(live, new_lam_err, lam_err)
        omega_err = torch.where(live, new_omega_err, omega_err)
        sweeps = sweeps + live.to(torch.int32)
        done = done | (live & (new_omega_err < rel_tol) & (new_lam_err < rel_tol))
    return EMCarry(lam, omegas, lam_err, omega_err, sweeps, done)


def em_finished(c: EMCarry, maxit: int) -> Tensor:
    """() bool: no further sweep would change the carry."""
    return c.done | (c.sweeps >= maxit)


def em_result(c: EMCarry) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(lam, omegas, sweeps_performed, final_rel_err) of a finished loop."""
    return c.lam, c.omegas, c.sweeps, torch.maximum(c.lam_err, c.omega_err)


def em_loop(
    r1s: Tensor, gam1s: Tensor, a: Tensor, lam: Tensor, omegas: Tensor,
    sigmas: Tensor, maxit: int, rel_tol: float = 1e-6,
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """EM sweeps until the relative change of both lam and omegas is below
    rel_tol, or maxit sweeps; the device is read once per EM_CHUNK sweeps.

    Returns (lam, omegas, sweeps_performed, final_rel_err); the sweeps are
    a () int32 tensor.
    """
    c = em_init(lam, omegas)
    while True:
        c = em_chunk(c, r1s, gam1s, a, sigmas, maxit, rel_tol, EM_CHUNK, mask=mask)
        if bool(em_finished(c, maxit)):   # the host read of a chunk
            return em_result(c)


# ---------------------------------------------------------------------------
# MLE update: damped Newton on the KKT system of the penalized likelihood
# ---------------------------------------------------------------------------

MU_NEWTON = 1e-6             # at or below this damping, take plain Newton steps
MU_MIN, MU_MAX = 1e-12, 1e8
BACKTRACK_HALVINGS = 20      # t halves from 1 while t > 1e-6: at most 20 times


def _kkt_residual(x: Tensor, probs: Tensor, a: Tensor, omega0: Tensor,
                  mask: Optional[Tensor] = None) -> Tensor:
    """KKT residual of the penalized mixture-weight MLE at
    x = (omega_1..omega_L, gam); probs (K, M, L) is the exp of the JAX
    package's log_probs_shifted, taken once per solve:

      y[:L] = sum_{k,m} a_k probs_kml / (sum_l probs_kml omega_l)
              + (omega0 - 1)/omega + gam
      y[L]  = sum(omega) - 1
    """
    return _kkt_residual_and_w(x, probs, a, omega0, mask)[0]


def _kkt_residual_and_w(x, probs, a, omega0, mask):
    """The residual and the (K, M) weights mask / den that its sum takes."""
    L = omega0.shape[0]
    omega, gam = x[:L], x[L]
    den = torch.einsum("kml,l->km", probs, omega)              # (K, M)
    w = 1.0 / den
    if mask is not None:
        w = w * mask[None, :]
    grad = torch.einsum("k,kml,km->l", a, probs, w)
    y_omega = grad + (omega0 - 1.0) / omega + gam
    y_gam = torch.sum(omega) - 1.0
    return torch.cat([y_omega, y_gam[None]]), w


def _kkt_residual_and_jac(x: Tensor, probs: Tensor, a: Tensor, omega0: Tensor,
                          mask: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """The residual and its closed-form Jacobian in one pass:

      d y_l / d omega_j = - sum_km a_k P_kml P_kmj / den_km^2
                          - delta_lj (omega0_l - 1) / omega_l^2
      d y_l / d gam     = 1;   d y_gam / d omega_j = 1;  d y_gam/d gam = 0.
    """
    L = omega0.shape[0]
    omega = x[:L]
    y, w = _kkt_residual_and_w(x, probs, a, omega0, mask)
    G = torch.einsum("kml,kmj->lj", probs * (a[:, None] * w * w)[:, :, None], probs)
    J_oo = -G - torch.diag((omega0 - 1.0) / (omega * omega))
    ones = torch.ones((L, 1), dtype=x.dtype, device=x.device)
    J = torch.cat([torch.cat([J_oo, ones], dim=1),
                   torch.cat([ones.T, torch.zeros((1, 1), dtype=x.dtype, device=x.device)],
                             dim=1)])
    return y, J


def _solve_small(A: Tensor, b: Tensor) -> Tensor:
    """x with A x = b for a batch of small systems A (..., n, n), by Gaussian
    elimination with partial pivoting (the largest |a_ik|, the first on
    ties, as LAPACK's LU) and substitution, in plain tensor ops. It reads
    nothing back to the host, so a CUDA graph can hold it (torch.linalg.solve
    checks its pivots on the host). An exactly zero pivot (LU's info != 0)
    gives a non-finite x, as the JAX package's LU solve does, so that a
    Newton step through a singular J is not taken."""
    n = A.shape[-1]
    T = torch.cat([A, b[..., None]], dim=-1)                    # (..., n, n + 1)
    rows = torch.arange(n, device=A.device)
    for k in range(n - 1):
        p = k + torch.argmax(T[..., k:, k].abs(), dim=-1, keepdim=True)
        swap = torch.where(rows == k, p, torch.where(rows == p, k, rows))
        T = torch.gather(T, -2, swap[..., None].expand(T.shape))
        f = T[..., k + 1:, k:k + 1] / T[..., k:k + 1, k:k + 1]
        T = torch.cat([T[..., :k + 1, :], T[..., k + 1:, :] - f * T[..., k:k + 1, :]], dim=-2)
    x = [None] * n
    for i in reversed(range(n)):
        acc = T[..., i, n]
        for j in range(i + 1, n):
            acc = acc - T[..., i, j] * x[j]
        x[i] = acc / T[..., i, i]
    return torch.stack(x, dim=-1)


class MLEProblem(NamedTuple):
    """What one MLE solve holds fixed."""

    probs: Tensor        # (K, M, L) exp of the log-probabilities, spike first
    a: Tensor            # (K,) cohort weights
    omega0: Tensor       # (L,) the current prior's weights, spike first
    resid_scale: Tensor  # () the active markers: the residual is O(M_active)
    mask: Optional[Tensor]


class MLECarry(NamedTuple):
    """The Newton solve's state between chunks (sgvamp_tpu's _NewtonState)."""

    x: Tensor        # (L + 1,) the weights and the multiplier gam
    resid: Tensor    # () |KKT residual| at x
    mu: Tensor       # () Levenberg-Marquardt damping
    it: Tensor       # () int32
    done: Tensor     # () bool: converged
    failed: Tensor   # () bool: no productive step at any damping


def mle_init(r1s: Tensor, gam1s: Tensor, a: Tensor, prior: PriorState,
             mask: Optional[Tensor] = None) -> Tuple[MLEProblem, MLECarry]:
    """The solve's problem and first carry, warm started at the prior and
    its cached multiplier. The log-probabilities take the reference's
    global exp-max shift (one scalar max over (K, M, L)) and the spike
    variance 1e-16."""
    dtype, dev = prior.lam.dtype, prior.lam.device
    omega0 = torch.cat([(1.0 - prior.lam)[None], prior.lam * prior.omegas])
    sigma2 = torch.cat([torch.full((1,), 1e-16, dtype=dtype, device=dev), prior.sigmas])
    v = sigma2[None, None, :] + (1.0 / gam1s)[:, None, None]   # (K, 1, L)
    E = -(r1s * r1s)[:, :, None] / (2.0 * v)                   # (K, M, L)
    probs = torch.exp(E - torch.amax(E) - 0.5 * torch.log(v))
    if mask is not None:
        resid_scale = torch.clamp(torch.sum(mask), min=1.0)
    else:
        resid_scale = torch.full((), float(r1s.shape[1]), dtype=dtype, device=dev)
    problem = MLEProblem(probs=probs, a=a, omega0=omega0, resid_scale=resid_scale, mask=mask)
    gam_init = torch.where(prior.mle_gam_valid, prior.mle_gam, 1.0)
    x0 = torch.cat([omega0, gam_init[None]])
    carry = MLECarry(
        x=x0, resid=torch.linalg.norm(_kkt_residual(x0, probs, a, omega0, mask)),
        mu=torch.full((), MU_NEWTON, dtype=dtype, device=dev),
        it=torch.zeros((), dtype=torch.int32, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
        failed=torch.zeros((), dtype=torch.bool, device=dev))
    return problem, carry


def _newton_iteration(c: MLECarry, pb: MLEProblem, tol: float) -> MLECarry:
    """One iteration of sgvamp_tpu's Newton body: the Newton step where it is
    finite and mu <= MU_NEWTON, else the Marquardt-scaled LM step on the
    normal equations (solvable where J is singular); positivity
    backtracking; Newton steps accepted whenever finite, LM steps only when
    they lower the residual."""
    L = pb.omega0.shape[0]
    x, resid, mu = c.x, c.resid, c.mu
    y, J = _kkt_residual_and_jac(x, pb.probs, pb.a, pb.omega0, pb.mask)
    JTJ = J.T @ J
    g = J.T @ y
    d = torch.diagonal(JTJ)
    d = torch.where(d > 0.0, d, 1.0)
    newton_step, lm_step = _solve_small(torch.stack([J, JTJ + mu * torch.diag(d)]),
                                        torch.stack([y, g]))
    use_newton = torch.all(torch.isfinite(newton_step)) & (mu <= MU_NEWTON)
    step = torch.where(use_newton, newton_step, lm_step)
    # positivity backtracking, every halving at once: t_j = 2^-j, and the
    # loop stops at the first j whose weights are all positive, or at j = 20
    t_all = torch.cat([torch.ones(1, dtype=x.dtype, device=x.device),
                       torch.full((BACKTRACK_HALVINGS,), 0.5, dtype=x.dtype,
                                  device=x.device)]).cumprod(0)
    cand = x[None, :] - t_all[:, None] * step[None, :]
    last = torch.arange(BACKTRACK_HALVINGS + 1, device=x.device) == BACKTRACK_HALVINGS
    stop = ~torch.any(cand[:, :L] <= 0.0, dim=1) | last
    j = torch.argmax(stop.to(torch.int32)).reshape(1)
    t, x_new = t_all.index_select(0, j)[0], cand.index_select(0, j)[0]
    new_resid = torch.linalg.norm(_kkt_residual(x_new, pb.probs, pb.a, pb.omega0, pb.mask))
    bad = ~torch.all(torch.isfinite(x_new)) | ~torch.isfinite(new_resid)
    accept = ~bad & (use_newton | (new_resid < resid))
    resid_next = torch.where(accept, new_resid, resid)
    mu_next = torch.clamp(torch.where(accept, mu * 0.3, mu * 10.0), MU_MIN, MU_MAX * 10.0)
    # a tiny accepted step in the (near-)Newton regime is convergence
    # (fsolve's xtol); under heavy damping steps are short by construction
    step_small = accept & (mu <= 1e-4) & (
        torch.linalg.norm(t * step) < 1.49012e-8 * (1.0 + torch.linalg.norm(x)))
    return MLECarry(x=torch.where(accept, x_new, x), resid=resid_next, mu=mu_next,
                    it=c.it + 1, done=(resid_next < tol * pb.resid_scale) | step_small,
                    failed=mu_next > MU_MAX)


def mle_chunk(c: MLECarry, pb: MLEProblem, maxit: int, tol: float, steps: int) -> MLECarry:
    """`steps` Newton iterations from carry c; an iteration after the solve
    has stopped (converged, failed, or maxit iterations run) keeps every
    value as it was."""
    for _ in range(steps):
        n = _newton_iteration(c, pb, tol)
        live = ~(c.done | c.failed) & (c.it < maxit)
        c = MLECarry(*[torch.where(live, new, old) for new, old in zip(n, c)])
    return c


def mle_finished(c: MLECarry, maxit: int) -> Tensor:
    """() bool: no further iteration would change the carry."""
    return c.done | c.failed | (c.it >= maxit)


def mle_result(pb: MLEProblem, c: MLECarry, prior: PriorState) -> PriorState:
    """The prior after a finished solve, with the reference's guards: no
    update unless the solve converged (the residual below 1e-6 per active
    marker) to finite, positive weights; otherwise the weights renormalized
    and the multiplier cached."""
    L = pb.omega0.shape[0]
    x = c.x
    final_resid = torch.linalg.norm(_kkt_residual(x, pb.probs, pb.a, pb.omega0, pb.mask))
    ok = (~c.failed & (final_resid < 1e-6 * pb.resid_scale) & torch.all(x[:L] > 0.0)
          & torch.all(torch.isfinite(x)))
    w = x[:L] / torch.sum(x[:L])
    return PriorState(
        lam=torch.where(ok, 1.0 - w[0], prior.lam),
        omegas=torch.where(ok, w[1:] / torch.sum(w[1:]), prior.omegas),
        sigmas=prior.sigmas,
        mle_gam=torch.where(ok, x[L], prior.mle_gam),
        mle_gam_valid=prior.mle_gam_valid | ok,
        mle_last_ok=ok,
    )


def mle_update(
    r1s: Tensor, gam1s: Tensor, a: Tensor, prior: PriorState, maxit: int = 200,
    tol: float = 1e-10, mask: Optional[Tensor] = None,
) -> PriorState:
    """MLE prior update with fsolve-equivalent semantics: the (L+1) KKT
    system solved by Levenberg-Marquardt damped Newton (the robustness
    analogue of MINPACK hybrd's trust region, the engine of the reference's
    fsolve), warm started at the current prior, then the reference's
    reject-and-skip guards (mle_result). The device is read once per
    MLE_CHUNK iterations."""
    pb, c = mle_init(r1s, gam1s, a, prior, mask)
    while True:
        c = mle_chunk(c, pb, maxit, tol, MLE_CHUNK)
        if bool(mle_finished(c, maxit)):   # the host read of a chunk
            return mle_result(pb, c, prior)
