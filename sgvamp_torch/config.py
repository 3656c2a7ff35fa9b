"""Configuration of the VAMP engine (PyTorch port of sgvamp_tpu/config.py).

The fields and defaults are the JAX package's, so one configuration means
the same run in both engines.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    """Spike-and-slab Gaussian mixture prior configuration.

    The prior is (1-lam)*delta_0 + lam * sum_l omega_l * N(0, sigma_l^2),
    with L-1 slab components. `vars_` / `probs` are the *unscaled* CLI
    values; the engine scales slab variances by Nt.
    """

    vars_: Tuple[float, ...] = (0.0, 1.0)
    probs: Tuple[float, ...] = (0.99, 0.01)

    def __post_init__(self) -> None:
        if len(self.vars_) != len(self.probs):
            raise ValueError("prior vars and probs must have equal length L")
        if len(self.vars_) < 2:
            raise ValueError("need at least one slab component (L >= 2)")

    @property
    def L(self) -> int:
        return len(self.probs)

    def init_lam(self) -> float:
        return 1.0 - self.probs[0]

    def init_omegas(self) -> Tuple[float, ...]:
        slab = self.probs[1:]
        tot = sum(slab)
        return tuple(p / tot for p in slab)

    def scaled_sigmas(self, Nt: float) -> Tuple[float, ...]:
        return tuple(v * Nt for v in self.vars_[1:])


@dataclasses.dataclass(frozen=True)
class VampConfig:
    """Configuration of the VAMP iteration; see sgvamp_tpu.config.VampConfig
    for the meaning of every field."""

    rho: float = 0.5
    rho_final: Optional[float] = None
    rho_anneal_iters: int = 0
    cg_maxit: int = 500
    cg_rtol: float = 1e-5
    cg_atol: float = 0.0
    cg_force_maxiter: bool = False
    cg_precond_block: int = 0
    cg_precond_dtype: str = "float32"
    cg_precond_eig: bool = True
    learn_gamw: bool = True
    lmmse_damp: bool = True
    prior_update: Optional[str] = "em"
    update_prior_from: int = 1
    em_prior_maxit: int = 100
    em_rel_tol: float = 1e-6
    mle_maxit: int = 200
    mle_tol: float = 1e-10
    dtype: str = "float64"
    clip_alpha1: bool = False
    clip_alpha2: bool = False
    gam_clamp: float = 0.0

    def __post_init__(self) -> None:
        if self.prior_update not in (None, "em", "mle"):
            raise ValueError(f"unknown prior_update: {self.prior_update!r}")
        if self.dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype: {self.dtype!r}")
        if self.cg_precond_dtype not in _DTYPES:
            raise ValueError(f"unsupported cg_precond_dtype: {self.cg_precond_dtype!r}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def precond_torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.cg_precond_dtype]
