"""Spike-and-slab meta (multi-cohort) denoiser, vectorized over markers.

PyTorch port of sgvamp_tpu/core/denoiser.py; see there for the math. All
slab scores are shifted by the per-marker maximum before exponentiation,
so no exponent is positive and nothing overflows.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor


def combine_cohorts(r1s: Tensor, gam1s: Tensor, a: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Combine per-cohort extrinsic estimates into sufficient statistics.

    r1s (K, M), gam1s (K,), a (K,) -> b (M,) = sum_k c_k r1_k,
    A = sum_k c_k (scalar), c (K,) = a_k * gam1_k.
    """
    c = a * gam1s
    A = torch.sum(c)
    b = torch.einsum("k,km->m", c, r1s)
    return b, A, c


def posterior_mean_and_slope(
    b: Tensor, A: Tensor, lam: Tensor, omegas: Tensor, sigmas: Tensor,
) -> Tuple[Tensor, Tensor]:
    """Posterior mean E[x|b] and its derivative d E[x|b] / d b, both (M,)."""
    s2 = 1.0 / (A + 1.0 / sigmas)                    # (L-1,)
    w = omegas * torch.sqrt(s2 / sigmas)             # (L-1,)
    mu = b[:, None] * s2[None, :]                    # (M, L-1)
    score = 0.5 * (b * b)[:, None] * s2[None, :]     # (M, L-1), >= 0
    m = torch.amax(score, dim=1, keepdim=True)       # (M, 1)
    e = torch.exp(score - m)                         # (M, L-1), in (0, 1]
    spike = (1.0 - lam) * torch.exp(-m[:, 0])        # (M,)

    wsum = torch.einsum("l,ml->m", w, e)
    wmu = torch.einsum("l,ml->m", w, e * mu)
    wmu2 = torch.einsum("l,ml->m", w, e * (mu * mu + s2[None, :]))

    num = lam * wmu
    den = spike + lam * wsum
    xhat = num / den
    dnum = lam * wmu2
    dxdb = (dnum * den - num * num) / (den * den)
    return xhat, dxdb
