"""Data simulators, numpy only.

A copy of sgvamp_tpu/data/simulate.py::simulate_single, simulate_ld_band,
band_matvec and band_to_dense: importing anything under sgvamp_tpu imports
jax, which the port does not use. The same seed gives the same arrays in
both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SimData:
    y: np.ndarray              # (N,)
    beta: np.ndarray           # (M,)
    r: np.ndarray              # (M,)
    R: Optional[np.ndarray]    # (M, M) or None


def _sparse_beta(rng: np.random.Generator, M: int, lam: float, var: float) -> np.ndarray:
    cm = int(M * lam)
    beta = np.zeros(M)
    idx = rng.choice(M, size=cm, replace=False)
    beta[idx] = rng.normal(0.0, np.sqrt(var), size=cm)
    return beta


def simulate_single(
    N: int, M: int, h2: float = 0.8, lam: float = 0.5,
    rng: Optional[np.random.Generator] = None,
) -> SimData:
    """Single-cohort generator: binomial genotypes, beta variance 1/cm,
    noise sd sqrt(1/h2 - 1), y standardized, dense R = X^T X."""
    rng = rng or np.random.default_rng()
    X = rng.binomial(2, 0.4, size=(N, M)).astype(np.float64)
    X = (X - X.mean(axis=0)) / X.std(axis=0)
    beta = _sparse_beta(rng, M, lam, var=1.0 / int(M * lam))
    g = X @ beta
    w = rng.normal(0.0, np.sqrt(1.0 / h2 - 1.0), size=N)
    y = g + w
    y = (y - y.mean()) / y.std()
    X /= np.sqrt(N)
    return SimData(y=y, beta=beta, r=X.T @ y, R=X.T @ X)


def simulate_ld_band(
    N: int, M: int, bandwidth: int, h2: float = 0.8, lam: float = 0.1,
    rng: Optional[np.random.Generator] = None, dtype=np.float32,
    strength: float = 0.6, decay: float = 0.85, n_r: int = 1,
):
    """Large-M banded SPD LD panel in band storage - never materializes MxM.

    A banded lower factor L (unit diagonal, decaying band) gives
    R = L L^T, SPD and banded with twice L's bandwidth; the diagonal is then
    normalized to 1. `strength`/`decay` set L's off-diagonal mass.

    Returns (band, r, x0):
      band: (M, 2*bandwidth+1), band[i, bandwidth + d] = R[i, i+d];
      r = R x0 + eps with eps ~ N(0, (1-h2) R), one row per noise draw
          when n_r > 1;
      x0 = sqrt(N) * beta, beta sparse with slab variance h2/cm.
    """
    rng = rng or np.random.default_rng()
    hb = bandwidth // 2  # L bandwidth; R gets 2*hb = bandwidth
    prof = (decay ** np.arange(1, hb + 1) * strength / np.sqrt(hb)).astype(np.float64)
    Lb = np.empty((M, hb + 1), dtype=np.float64)
    Lb[:, 0] = 1.0
    Lb[:, 1:] = rng.uniform(-1.0, 1.0, size=(M, hb)) * prof[None, :]
    for d in range(1, hb + 1):  # zero out-of-range entries (row i < d)
        Lb[:d, d] = 0.0
    # R[i, i+k] = sum_d Lb[i, d] * Lb[i+k, d+k]
    upper = np.zeros((M, bandwidth + 1), dtype=np.float64)
    for k in range(0, bandwidth + 1):
        acc = np.zeros(M)
        for d in range(0, hb - k + 1):
            acc[: M - k] += Lb[: M - k, d] * Lb[k:, d + k]
        upper[:, k] = acc
    diag = upper[:, 0].copy()
    scale = 1.0 / np.sqrt(diag)
    for k in range(0, bandwidth + 1):
        upper[: M - k, k] *= scale[: M - k] * scale[k:] if k else scale * scale
    band = np.zeros((M, 2 * bandwidth + 1), dtype=dtype)
    band[:, bandwidth:] = upper
    for k in range(1, bandwidth + 1):
        band[k:, bandwidth - k] = upper[: M - k, k]

    cm = max(int(M * lam), 1)
    beta = _sparse_beta(rng, M, lam, var=h2 / cm)
    x0 = (np.sqrt(N) * beta).astype(np.float64)
    # eps = sqrt(1-h2) * diag(scale) L w, so that Var(eps) = (1-h2) R.
    W = rng.normal(0.0, 1.0, (n_r, M))
    LW = np.zeros((n_r, M))
    for d in range(0, hb + 1):
        if d:
            LW[:, d:] += Lb[d:, d] * W[:, : M - d]
        else:
            LW += Lb[:, 0] * W
    eps = np.sqrt(1.0 - h2) * scale * LW
    r = (band_matvec(band, x0)[None, :] + eps).astype(dtype)
    return band, (r[0] if n_r == 1 else r), x0


def band_matvec(band: np.ndarray, x: np.ndarray) -> np.ndarray:
    """y = R @ x with R in symmetric band storage."""
    M, nd = band.shape
    bw = (nd - 1) // 2
    y = band[:, bw] * x
    for k in range(1, bw + 1):
        y[: M - k] += band[: M - k, bw + k] * x[k:]
        y[k:] += band[k:, bw - k] * x[: M - k]
    return y


def band_to_dense(band: np.ndarray) -> np.ndarray:
    """Materialize band storage to dense (M, M) - small M only (tests)."""
    M, nd = band.shape
    bw = (nd - 1) // 2
    R = np.zeros((M, M), dtype=band.dtype)
    for d in range(-bw, bw + 1):
        idx = np.arange(max(0, -d), min(M, M - d))
        R[idx, idx + d] = band[idx, bw + d]
    return R
