"""Batched conjugate gradients over K independent SPD systems.

PyTorch port of sgvamp_tpu/core/cg.py. The stopping rule is scipy's:
a lane stops when ||r|| <= max(rtol*||b||, atol), checked at the top of
each iteration, with warm starts honoured. Converged lanes freeze under
masks while the others go on, so the matvec stays one batched call.

The JAX while_loop becomes three pieces that a CUDA graph can hold, since
none reads the device: cg_init (residual, first direction, tolerances),
cg_chunk (a fixed number of iterations; a device counter freezes every
lane once maxiter iterations have run, so a chunk may overrun maxiter) and
cg_finish. cg_batched drives them eagerly: under force_maxiter it runs
exactly maxiter iterations and never reads the device; otherwise it reads
whether a lane is still active once per chunk of CG_CHUNK iterations.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import Tensor

from sgvamp_torch.utils.profiling import span

# iterations between two host reads of the active lanes: a converged solve
# runs at most CG_CHUNK - 1 masked iterations (one LD pass each) past its
# last update, and the production solves converge in a few iterations a
# step (PERF.md §6, fused runs)
CG_CHUNK = 4


class CGResult(NamedTuple):
    x: Tensor          # (K, M) solutions
    iters: Tensor      # (K,) int32, iterations performed per lane
    converged: Tensor  # (K,) bool, True if tolerance reached before maxiter
    rnorm2: Tensor     # (K,) final squared residual norms
    passes: Tensor     # () int32, loop iterations run: one matvec each


class CGCarry(NamedTuple):
    """The loop's state between chunks."""

    x: Tensor
    r: Tensor
    p: Tensor
    rz: Tensor
    rn2: Tensor
    active: Tensor     # (K,) bool
    iters: Tensor      # (K,) int32
    n: Tensor          # () int32, loop iterations run
    tol2: Tensor


def rowdot(x: Tensor, y: Tensor) -> Tensor:
    """(K, M) x (K, M) -> (K,) row-wise dot products, as a product and a
    sum: einsum routes this through a batched GEMV, which on an H100 took
    most of the VAMP step at M=524288 (see PERF.md)."""
    return (x * y).sum(dim=1)


def _nonzero(v: Tensor) -> Tensor:
    return torch.where(v == 0.0, torch.ones_like(v), v)


def _identity(v: Tensor) -> Tensor:
    return v


def cg_init(matvec: Callable[[Tensor], Tensor], b: Tensor, x0: Tensor,
            rtol: float = 1e-5, atol: float = 0.0, force_maxiter: bool = False,
            precond: Optional[Callable[[Tensor], Tensor]] = None) -> CGCarry:
    """The carry before the first iteration (one matvec)."""
    K = b.shape[0]
    tol2 = torch.clamp(rtol * rtol * rowdot(b, b), min=atol * atol)
    psolve = precond or _identity
    r = b - matvec(x0)
    p = psolve(r)
    rz = rowdot(r, p)
    rn2 = rz if precond is None else rowdot(r, r)
    if force_maxiter:
        active = torch.ones(K, dtype=torch.bool, device=b.device)
    else:
        active = rn2 > tol2
    return CGCarry(x=x0, r=r, p=p, rz=rz, rn2=rn2, active=active,
                   iters=torch.zeros(K, dtype=torch.int32, device=b.device),
                   n=torch.zeros((), dtype=torch.int32, device=b.device), tol2=tol2)


def cg_chunk(matvec: Callable[[Tensor], Tensor], c: CGCarry, steps: int, maxiter: int,
             force_maxiter: bool = False,
             precond: Optional[Callable[[Tensor], Tensor]] = None,
             masked: bool = True) -> CGCarry:
    """`steps` iterations from carry c. masked: a lane updates while it is
    active and fewer than maxiter iterations have run (the counter n), else
    it keeps its values, element for element those of the last update.
    masked=False updates every lane, as force_maxiter does when the caller
    runs exactly maxiter iterations in all."""
    psolve = precond or _identity
    x, r, p, rz, rn2, active, iters, n = c.x, c.r, c.p, c.rz, c.rn2, c.active, c.iters, c.n
    for _ in range(steps):
        ap = matvec(p)
        alpha = rz / _nonzero(rowdot(p, ap))
        x_new = x + alpha[:, None] * p
        r_new = r - alpha[:, None] * ap
        z = psolve(r_new)
        rz_new = rowdot(r_new, z)
        rn_new = rz_new if precond is None else rowdot(r_new, r_new)
        p_new = z + (rz_new / _nonzero(rz))[:, None] * p
        if not masked:
            x, r, p, rz, rn2 = x_new, r_new, p_new, rz_new, rn_new
            iters = iters + 1
            continue
        live = active & (n < maxiter)
        act = live[:, None]
        x = torch.where(act, x_new, x)
        r = torch.where(act, r_new, r)
        p = torch.where(act, p_new, p)
        rz = torch.where(live, rz_new, rz)
        rn2 = torch.where(live, rn_new, rn2)
        iters = iters + live.to(torch.int32)
        n = n + 1
        if not force_maxiter:
            active = active & (rn2 > c.tol2)
    if not masked:
        n = n + steps
    return CGCarry(x=x, r=r, p=p, rz=rz, rn2=rn2, active=active, iters=iters, n=n,
                   tol2=c.tol2)


def cg_live(c: CGCarry, maxiter: int) -> Tensor:
    """() bool: another iteration would update a lane."""
    return c.active.any() & (c.n < maxiter)


def cg_finish(c: CGCarry, maxiter: int) -> CGResult:
    converged = torch.where(c.iters < maxiter, ~c.active, torch.zeros_like(c.active))
    return CGResult(x=c.x, iters=c.iters, converged=converged, rnorm2=c.rn2, passes=c.n)


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
    tolerance only after its maxiter-th update is unconverged. Without
    force_maxiter the device is read once per CG_CHUNK iterations.
    """
    c = cg_init(matvec, b, x0, rtol, atol, force_maxiter, precond)
    done = 0
    while done < maxiter:
        if not force_maxiter:
            with span("sgv.read", blocking=True, kind="cg"):   # the host read of a chunk
                live = bool(c.active.any())
            if not live:
                break
        steps = min(CG_CHUNK, maxiter - done)
        c = cg_chunk(matvec, c, steps, maxiter, force_maxiter, precond,
                     masked=not force_maxiter)
        done += steps
    return cg_finish(c, maxiter)
