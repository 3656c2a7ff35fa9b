"""EM learning of the spike-and-slab mixture weights.

PyTorch port of the EM half of sgvamp_tpu/core/prior.py. The JAX
while_loop becomes a Python loop with one host sync per sweep, to test
the relative-change stopping rule. The MLE update is not ported yet
(ROADMAP A11); PriorState keeps its fields as inert data so states move
between the engines unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import Tensor

from sgvamp_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class PriorState:
    """Learnable prior parameters.

    lam:    scalar slab inclusion probability.
    omegas: (L-1,) slab mixture weights (sum to 1).
    sigmas: (L-1,) slab variances, already scaled by Nt; never updated.
    mle_gam, mle_gam_valid, mle_last_ok: the MLE solver's warm start and
            status, carried unchanged until MLE is ported.
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


def em_loop(
    r1s: Tensor, gam1s: Tensor, a: Tensor, lam: Tensor, omegas: Tensor,
    sigmas: Tensor, maxit: int, rel_tol: float = 1e-6,
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, int, Tensor]:
    """EM sweeps until the relative change of both lam and omegas is below
    rel_tol, or maxit sweeps.

    Returns (lam, omegas, sweeps_performed, final_rel_err).
    """
    lam_err = omega_err = torch.full((), float("inf"), dtype=lam.dtype,
                                     device=lam.device)
    sweeps = 0
    while sweeps < maxit:
        new_lam, new_omegas = em_update(r1s, gam1s, a, lam, omegas, sigmas,
                                        mask=mask)
        omega_err = torch.linalg.norm(new_omegas - omegas) / torch.linalg.norm(omegas)
        lam_err = torch.abs(new_lam - lam) / new_lam  # divides by the UPDATED lam, as the reference does
        lam, omegas = new_lam, new_omegas
        sweeps += 1
        if bool((omega_err < rel_tol) & (lam_err < rel_tol)):
            break
    return lam, omegas, sweeps, torch.maximum(lam_err, omega_err)
