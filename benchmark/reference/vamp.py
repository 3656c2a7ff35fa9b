"""The plain reference of a fit: gVAMP over K cohorts that share one LD
panel, in plain PyTorch.

It follows the method's equations (the JAX package's docstrings state them;
nothing here calls the program) and computes in `dtype`: float64 for the
reference, bfloat16 for the control. The LD operator is any object with
matvec(x) over lanes (S, M), such as int8_band.Int8Band, which derives its
blocks from the band itself. One step (iteration `it`, damping rho):

  1. from the second step on, EM sweeps over the spike-and-slab mixture
     (at most em_maxit, until both relative changes fall below em_tol);
  2. the meta denoiser over the cohorts' (r1, gam1): the posterior mean
     xhat1 and its slope, damped from the second step on;
  3. LMMSE: one conjugate-gradient solve of (gamw_k R + gam2_k I) x = b over
     2K lanes (the K right-hand sides gamw r + gam2 r2 from the previous
     xhat2, the K probes u from the previous sigma2_u), exactly cg_maxit
     iterations when cg_force is set;
  4. Hutchinson's trace estimate alpha2 = gam2 u.sigma2_u / M, the damped
     precisions, the new r1 and gam1;
  5. the noise precision gamw from one 2K-lane LD pass.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Settings(NamedTuple):
    rho: float
    em_maxit: int
    em_tol: float
    cg_maxit: int
    cg_force: bool
    cg_rtol: float


def _em_sweep(r1, gam1, a, lam, om, sigmas):
    r2 = (r1 * r1)[:, :, None]
    v = sigmas[None, None, :] + (1.0 / gam1)[:, None, None]
    E = -r2 / (2.0 * v)
    m = E.amax(dim=2, keepdim=True)
    xi = lam * om[None, None, :] * torch.exp(E - m) / torch.sqrt(v)
    sxi = xi.sum(dim=2, keepdim=True)
    spike = (1.0 - lam) * torch.exp(-r2 * gam1[:, None, None] / 2.0 - m) \
        * torch.sqrt(gam1)[:, None, None]
    pi = 1.0 / (1.0 + spike / sxi)
    new_lam = (a[:, None] * pi[:, :, 0]).sum(dim=0).div(a.sum()).mean()
    num = (a[:, None, None] * pi * (xi / sxi)).sum(dim=(0, 1))
    den = (a[:, None] * pi[:, :, 0]).sum()
    return new_lam, num / den


def _denoise(r1, gam1, a, lam, om, sigmas):
    c = a * gam1
    A = c.sum()
    b = (c[:, None] * r1).sum(dim=0)
    s2 = 1.0 / (A + 1.0 / sigmas)
    w = om * torch.sqrt(s2 / sigmas)
    mu = b[:, None] * s2[None, :]
    score = 0.5 * (b * b)[:, None] * s2[None, :]
    m = score.amax(dim=1, keepdim=True)
    e = torch.exp(score - m)
    spike = (1.0 - lam) * torch.exp(-m[:, 0])
    num = lam * (w * e * mu).sum(dim=1)
    den = spike + lam * (w * e).sum(dim=1)
    dnum = lam * (w * e * (mu * mu + s2[None, :])).sum(dim=1)
    return num / den, c, (dnum * den - num * num) / (den * den)


def _nonzero(v):
    return torch.where(v == 0.0, torch.ones_like(v), v)


def _cg(amatvec, b, x, settings: Settings):
    """Conjugate gradients over the lanes of b from x: cg_maxit iterations
    when cg_force is set, else until ||r|| <= rtol ||b|| on every lane."""
    r = b - amatvec(x)
    p = r
    rz = (r * r).sum(dim=1)
    tol2 = settings.cg_rtol ** 2 * (b * b).sum(dim=1)
    for _ in range(settings.cg_maxit):
        if not settings.cg_force and bool((rz <= tol2).all()):
            break
        ap = amatvec(p)
        alpha = rz / _nonzero((p * ap).sum(dim=1))
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        rz_new = (r * r).sum(dim=1)
        p = r + (rz_new / _nonzero(rz))[:, None] * p
        rz = rz_new
    return x


def best_step(gam1: torch.Tensor, xhat1: torch.Tensor) -> torch.Tensor:
    """The iterate a truth-free stop monitor keeps: the last step at which
    min_k gam1 reaches its running peak among steps whose gam1 and xhat1
    are finite (the peak of the precision into the denoiser). gam1 (steps,
    K), xhat1 (steps, M); returns a () int64 tensor, without a host read."""
    g = gam1.min(dim=1).values
    ok = torch.isfinite(g) & torch.isfinite(xhat1).all(dim=1)
    g = torch.where(ok, g, torch.full_like(g, -float("inf")))
    steps = torch.arange(g.shape[0], device=g.device)
    return torch.where(g == g.max(), steps, torch.full_like(steps, -1)).max()


def fit(op, r: torch.Tensor, a: torch.Tensor, N: torch.Tensor, lam: float,
        omegas: torch.Tensor, sigmas: torch.Tensor, gamw0: float, gam10: float,
        u: torch.Tensor, settings: Settings, dtype: torch.dtype, each=None) -> torch.Tensor:
    """xhat1 after u.shape[0] steps from the initial state (xhat1 = 0,
    r1 = r, gam1 = gam10, gamw = gamw0, the prior (lam, omegas, sigmas),
    every other field 0); u (steps, K, M) holds each step's probes. each,
    where given, is called after every step with (it, xhat1, gam1, gamw,
    lam)."""
    K, M = r.shape
    dev = r.device
    f = dict(dtype=dtype, device=dev)
    r = r.to(dtype)
    a, N, om, sigmas = a.to(dtype), N.to(dtype), omegas.to(dtype), sigmas.to(dtype)
    lam = torch.tensor(lam, **f)
    xhat1 = torch.zeros(M, **f)
    alpha1 = torch.zeros(K, **f)
    r1, gam1 = r.clone(), torch.full((K,), gam10, **f)
    xhat2, sigma2_u = torch.zeros((K, M), **f), torch.zeros((K, M), **f)
    alpha2 = torch.zeros(K, **f)
    gamw = torch.full((K,), gamw0, **f)
    rho = settings.rho
    for it in range(u.shape[0]):
        first = it == 0
        if not first:
            for _ in range(settings.em_maxit):
                new_lam, new_om = _em_sweep(r1, gam1, a, lam, om, sigmas)
                om_err = torch.linalg.norm(new_om - om) / torch.linalg.norm(om)
                lam_err = torch.abs(new_lam - lam) / new_lam
                lam, om = new_lam, new_om
                if bool((om_err < settings.em_tol) & (lam_err < settings.em_tol)):
                    break
        x_new, c, dxdb = _denoise(r1, gam1, a, lam, om, sigmas)
        xhat1 = x_new if first else rho * x_new + (1 - rho) * xhat1
        a1 = c * dxdb.mean()
        alpha1 = a1 if first else rho * a1 + (1 - rho) * alpha1
        gam2 = gam1 * (1 - alpha1) / alpha1
        r2 = (xhat1[None, :] - alpha1[:, None] * r1) / (1 - alpha1)[:, None]
        probe = u[it].to(dtype)
        gw2, g22 = torch.cat([gamw, gamw]), torch.cat([gam2, gam2])

        def amatvec(v):
            return gw2[:, None] * op.matvec(v) + g22[:, None] * v

        x = _cg(amatvec, torch.cat([gamw[:, None] * r + gam2[:, None] * r2, probe]),
                torch.cat([xhat2, sigma2_u]), settings)
        xhat2 = rho * x[:K] + (1 - rho) * xhat2
        sigma2_u = x[K:]
        alpha2 = rho * (gam2 * (probe * sigma2_u).sum(dim=1) / M) + (1 - rho) * alpha2
        gam1 = gam2 * (1 - alpha2) / alpha2
        r1 = (xhat2 - alpha2[:, None] * r2) / (1 - alpha2)[:, None]
        Rboth = op.matvec(torch.cat([xhat2, sigma2_u]))
        z = torch.clamp(N - 2.0 * (xhat2 * r).sum(dim=1) + (xhat2 * Rboth[:K]).sum(dim=1),
                        min=0.0)
        gamw = torch.clamp(1.0 / (z / N + (probe * Rboth[K:]).sum(dim=1) / N), min=1.0)
        if each is not None:
            each(it, xhat1, gam1, gamw, lam)
    return xhat1
