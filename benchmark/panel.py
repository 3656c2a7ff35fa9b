"""A biobank-scale banded LD panel, its true signal and its traits, made on
the device from the run's seed.

The construction is sgvamp_torch/data/simulate.py::simulate_ld_band's
(taken from there and rewritten in PyTorch, so that set-up spends well
under a second where the numpy original spends tens of seconds at
M=524288): a banded lower factor L with a unit diagonal and a decaying band
gives R = L L^T, symmetric positive definite with L's bandwidth (half the
band storage's), and its diagonal is normalized to 1. The marginal associations of cohort k are
r_k = R x0 + eps_k with eps_k ~ N(0, (1 - h2) R), x0 = sqrt(N) beta and
beta sparse with slab variance h2 / cm. Every random number comes from one
torch.Generator on the device, seeded with the run's seed, in a few large
calls; the same seed gives the same panel, signal and traits.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Panel(NamedTuple):
    band: torch.Tensor   # (M, 2 bw + 1) float32, band[i, bw + d] = R[i, i + d]
    r: torch.Tensor      # (K, M) float32 marginal associations
    x0: torch.Tensor     # (M,) float64 true signal, sqrt(N) beta


def generator(seed: int, device) -> torch.Generator:
    """The device's generator for `seed`, any whole number from 0 to 2**64 - 1."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))


def _factor(M: int, hb: int, strength: float, decay: float, gen, device) -> torch.Tensor:
    """L's band, transposed: Lt[d, i] = L[i, i - d], with Lt[0] = 1 and row
    d zero for i < d."""
    prof = (decay ** torch.arange(1, hb + 1, dtype=torch.float64, device=device)
            * strength / math.sqrt(hb))
    Lt = torch.empty((hb + 1, M), dtype=torch.float64, device=device)
    Lt[0] = 1.0
    Lt[1:] = (torch.rand((hb, M), generator=gen, dtype=torch.float64, device=device)
              * 2.0 - 1.0) * prof[:, None]
    for d in range(1, hb + 1):
        Lt[d, :d] = 0.0
    return Lt


def make_panel(M: int, bandwidth: int, N: int, h2: float, lam: float, K: int,
               strength: float, decay: float, seed: int, device) -> Panel:
    """The panel, signal and K cohorts' traits (one shared signal, an
    independent noise draw per cohort)."""
    gen = generator(seed, device)
    # L's bandwidth. R = L L^T has L's bandwidth too (R[i, i + k] needs a
    # column within hb of both rows), so the band's storage is twice as wide
    # as its data, as in simulate_ld_band.
    hb = bandwidth // 2
    Lt = _factor(M, hb, strength, decay, gen, device)
    # R[i, i + k] = sum_d L[i, i - d] L[i + k, i - d] = sum_d Lt[d, i] Lt[d + k, i + k]
    upper = torch.zeros((hb + 1, M), dtype=torch.float64, device=device)
    for k in range(hb + 1):
        upper[k, :M - k] = (Lt[:hb - k + 1, :M - k] * Lt[k:, k:]).sum(dim=0)
    scale = upper[0].rsqrt()
    for k in range(hb + 1):
        upper[k, :M - k] *= scale[:M - k] * scale[k:]
    band = torch.zeros((M, 2 * bandwidth + 1), dtype=torch.float32, device=device)
    band[:, bandwidth:bandwidth + hb + 1] = upper.T.to(torch.float32)
    for k in range(1, hb + 1):
        band[k:, bandwidth - k] = band[:M - k, bandwidth + k]

    cm = max(int(M * lam), 1)
    idx = torch.randperm(M, generator=gen, device=device)[:cm]
    x0 = torch.zeros(M, dtype=torch.float64, device=device)
    x0[idx] = (torch.randn(cm, generator=gen, dtype=torch.float64, device=device)
               * math.sqrt(h2 / cm) * math.sqrt(N))
    # eps_k = sqrt(1 - h2) diag(scale) L w_k, so that Var(eps_k) = (1 - h2) R
    W = torch.randn((K, M), generator=gen, dtype=torch.float64, device=device)
    LW = Lt[0] * W
    for d in range(1, hb + 1):
        LW[:, d:] += Lt[d, d:] * W[:, :M - d]
    eps = math.sqrt(1.0 - h2) * scale * LW
    r = (band_matvec(upper, x0)[None, :] + eps).to(torch.float32)
    return Panel(band=band, r=r, x0=x0)


def slab_variances(conf) -> list:
    """The slab variances a configuration's prior starts from: the
    simulated slab's, h2 / cm scaled by N (cm = the markers with an
    effect)."""
    cm = max(int(conf["M"] * conf["lam"]), 1)
    return [conf["h2"] / cm * conf["N"]]


def band_matvec(upper: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = R x from the upper diagonals upper[k, i] = R[i, i + k]."""
    M = x.shape[0]
    y = upper[0] * x
    for k in range(1, upper.shape[0]):
        y[:M - k] += upper[k, :M - k] * x[k:]
        y[k:] += upper[k, :M - k] * x[:M - k]
    return y


def probes(sets: int, steps: int, K: int, M: int, seed: int, device) -> torch.Tensor:
    """(sets, steps, K, M) int8 Rademacher probes (+1 / -1), from a
    generator of their own so that adding probe sets leaves the panel as it
    is."""
    gen = generator(seed + 0x5EED, device)
    bits = torch.randint(0, 2, (sets, steps, K, M), generator=gen, dtype=torch.int8,
                         device=device)
    return bits * 2 - 1
