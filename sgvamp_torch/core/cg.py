"""Batched conjugate gradients over K independent SPD systems.

PyTorch port of sgvamp_tpu/core/cg.py. The stopping rule is scipy's:
a lane stops when ||r|| <= max(rtol*||b||, atol), checked at the top of
each iteration, with warm starts honoured. Converged lanes freeze under
masks while the others go on, so the matvec stays one batched call.

The JAX while_loop becomes a Python loop. Under force_maxiter it runs
exactly maxiter iterations and never syncs with the device; otherwise it
reads the active-lane count once per iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import Tensor


class CGResult(NamedTuple):
    x: Tensor          # (K, M) solutions
    iters: Tensor      # (K,) int32, iterations performed per lane
    converged: Tensor  # (K,) bool, True if tolerance reached before maxiter
    rnorm2: Tensor     # (K,) final squared residual norms


def rowdot(x: Tensor, y: Tensor) -> Tensor:
    """(K, M) x (K, M) -> (K,) row-wise dot products, as a product and a
    sum: einsum routes this through a batched GEMV, which on an H100 took
    most of the VAMP step at M=524288 (see PERF.md)."""
    return (x * y).sum(dim=1)


def _nonzero(v: Tensor) -> Tensor:
    return torch.where(v == 0.0, torch.ones_like(v), v)


def cg_batched(
    matvec: Callable[[Tensor], Tensor],
    b: Tensor,
    x0: Tensor,
    maxiter: int,
    rtol: float = 1e-5,
    atol: float = 0.0,
    force_maxiter: bool = False,
    precond: Optional[Callable[[Tensor], Tensor]] = None,
) -> CGResult:
    """Solve A_k x_k = b_k for every row k by masked batched CG.

    matvec: (K, M) -> (K, M), applies A_k to row k. precond: optional
    z = M^{-1} r; the stopping rule stays on the true residual norm.
    `converged[k]` has scipy's `info == 0` meaning: a lane that meets the
    tolerance only after its maxiter-th update is unconverged.
    """
    K = b.shape[0]
    tol2 = torch.clamp(rtol * rtol * rowdot(b, b), min=atol * atol)
    psolve = (lambda v: v) if precond is None else precond

    x = x0
    r = b - matvec(x0)
    p = psolve(r)
    rz = rowdot(r, p)
    rn2 = rz if precond is None else rowdot(r, r)
    if force_maxiter:
        active = torch.ones(K, dtype=torch.bool, device=b.device)
    else:
        active = rn2 > tol2
    iters = torch.zeros(K, dtype=torch.int32, device=b.device)

    for _ in range(maxiter):
        if force_maxiter:
            all_active = True
        else:
            n_active = int(active.sum())  # the one host sync per iteration
            if n_active == 0:
                break
            all_active = n_active == K
        ap = matvec(p)
        alpha = rz / _nonzero(rowdot(p, ap))
        x_new = x + alpha[:, None] * p
        r_new = r - alpha[:, None] * ap
        z = psolve(r_new)
        rz_new = rowdot(r_new, z)
        rn_new = rz_new if precond is None else rowdot(r_new, r_new)
        p_new = z + (rz_new / _nonzero(rz))[:, None] * p
        if all_active:
            x, r, p, rz, rn2 = x_new, r_new, p_new, rz_new, rn_new
            iters = iters + 1
        else:
            act = active[:, None]
            x = torch.where(act, x_new, x)
            r = torch.where(act, r_new, r)
            p = torch.where(act, p_new, p)
            rz = torch.where(active, rz_new, rz)
            rn2 = torch.where(active, rn_new, rn2)
            iters = iters + active.to(torch.int32)
        if not force_maxiter:
            active = active & (rn2 > tol2)
    converged = torch.where(iters < maxiter, ~active,
                            torch.zeros_like(active))
    return CGResult(x=x, iters=iters, converged=converged, rnorm2=rn2)
