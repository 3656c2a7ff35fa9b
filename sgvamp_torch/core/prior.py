"""EM learning of the spike-and-slab mixture weights.

PyTorch port of the EM half of sgvamp_tpu/core/prior.py. The JAX
while_loop becomes pieces that a CUDA graph can hold, since none reads the
device: em_init, em_chunk (a fixed number of sweeps, under which a loop
that has stopped keeps its values) and em_finished, a device flag. em_loop
drives them eagerly and reads the flag once per chunk of EM_CHUNK sweeps.
The MLE update is not ported yet
(ROADMAP A11); PriorState keeps its fields as inert data so states move
between the engines unchanged.
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
