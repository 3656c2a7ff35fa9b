"""Block-Jacobi preconditioner for the LMMSE conjugate-gradient solves
(PyTorch port of sgvamp_tpu/core/precond.py).

Per VAMP iteration the system is A_k = gamw_k * Rused_k + gam2_k * I with
fresh scalars (gamw, gam2), so the preconditioner is rebuilt every step:
take the (K, nb, B, B) diagonal blocks of Rused (each operator exposes them
via diag_blocks()), optionally restrict to P x P diagonal sub-blocks
(P = sub_block <= B), shift by gam2, and invert. The scalars enter the
inverse only through the eigenvalues, so a one-time eigendecomposition
(block_jacobi_eig) turns each rebuild into two batched matmuls
(block_jacobi_from_eig).

These are plain torch calls (torch.linalg.eigh / inv, batched matmul), as
the JAX package leaves them to XLA outside any Pallas kernel. The batch of
K*M/P independent P x P problems is walked in chunks by a Python loop, so
that only one chunk's temporaries are live at biobank scale.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import Tensor


def _chunked_map(fn: Callable, leaves: Tuple[Tensor, ...], chunk: int):
    """Apply fn to chunk-sized slices of the leaves' leading axis and
    concatenate the outputs. fn maps a tuple of (n, ...) slices to a tensor
    or a tuple of tensors with leading axis n."""
    total = leaves[0].shape[0]
    outs = [fn(tuple(x[i:i + chunk] for x in leaves))
            for i in range(0, total, chunk)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))
    return torch.cat(outs, dim=0)


def _extract_sub_blocks(op, sub_block: int) -> Tensor:
    """(K, M/P, P, P) diagonal P x P sub-blocks of Rused (shared by the
    direct and the eigendecomposition set-up)."""
    D = op.diag_blocks()  # (K, nb, B, B)
    K, nb, B, _ = D.shape
    P = sub_block or B
    if B % P:
        raise ValueError(f"sub_block={P} must divide the storage block {B}")
    if P < B:
        ns = B // P
        Dv = D.reshape(K, nb, ns, P, ns, P)
        # (K, nb, P, P, ns) -> (K, nb, ns, P, P)
        D = torch.diagonal(Dv, dim1=2, dim2=4).movedim(-1, 2)
        D = D.reshape(K, nb * ns, P, P)
    return D


def block_jacobi_inverse(op, gamw: Tensor, gam2: Tensor, sub_block: int = 0,
                         dtype: torch.dtype = torch.float32,
                         setup_chunk: int = 2048) -> Tensor:
    """Inverse diagonal P x P blocks of A = gamw * Rused + gam2 * I.

    op exposes diag_blocks() -> (K, nb, B, B); gamw, gam2 are the (K,)
    scalars of this VAMP iteration; sub_block is P (0 or B: the full
    storage block); dtype is the storage dtype of the inverse blocks (the
    preconditioner only steers CG, so bfloat16 is safe); setup_chunk caps
    how many problems are inverted at once (0: all). Returns
    (K, M // P, P, P).
    """
    D = _extract_sub_blocks(op, sub_block)
    K, nbp, P, _ = D.shape
    ct = torch.promote_types(D.dtype, gamw.dtype)
    eye = torch.eye(P, dtype=ct, device=D.device)
    total = K * nbp

    def shift_invert(args):
        d, w, s = args
        A = w[:, None, None] * d + s[:, None, None] * eye
        inv = torch.linalg.inv(A)
        # the inverse of an SPD matrix is SPD; symmetrize the LU's rounding
        # away so that CG's M^{-1} inner product stays an inner product
        return (0.5 * (inv + inv.transpose(-1, -2))).to(dtype)

    Pinv = _chunked_map(
        shift_invert,
        (D.reshape(total, P, P), gamw.repeat_interleave(nbp),
         gam2.repeat_interleave(nbp)),
        setup_chunk or total)
    return Pinv.reshape(K, nbp, P, P)


def block_jacobi_eig(op, sub_block: int = 0, setup_chunk: int = 2048,
                     dtype=None) -> Tuple[Tensor, Tensor]:
    """One-time eigendecomposition of the diagonal sub-blocks: D = Q L Q^T,
    so that inv(gamw * D + gam2 * I) = Q diag(1 / (gamw * l + gam2)) Q^T.

    Returns (Q, lam): (K, M/P, P, P) eigenvectors stored at `dtype`
    (default: the blocks' dtype) and (K, M/P, P) eigenvalues at the blocks'
    own dtype."""
    D = _extract_sub_blocks(op, sub_block)
    K, nbp, P, _ = D.shape
    total = K * nbp
    qdt = dtype if dtype is not None else D.dtype

    def eigh(args):
        # quantized storages with per-row scales give blocks that are
        # symmetric only up to quantization error: factorize the symmetric
        # part, as jnp.linalg.eigh does (torch reads one triangle only)
        d = args[0]
        lam, Q = torch.linalg.eigh(0.5 * (d + d.transpose(-1, -2)))
        return lam, Q.to(qdt)   # cast per chunk: one chunk of full-precision Q live

    lam, Q = _chunked_map(eigh, (D.reshape(total, P, P),), setup_chunk or total)
    return Q.reshape(K, nbp, P, P), lam.reshape(K, nbp, P)


def block_jacobi_from_eig(Q: Tensor, lam: Tensor, gamw: Tensor, gam2: Tensor,
                          dtype: torch.dtype = torch.float32,
                          chunk: int = 2048) -> Tensor:
    """Per-iteration inverse blocks from the cached factorization:
    Pinv = Q diag(1 / (gamw * lam + gam2)) Q^T, symmetric by construction.
    The shift is taken at lam's precision and rounded to Q's storage dtype;
    the product is rounded to float32 before the cast to `dtype`, as the JAX
    package's einsum (preferred_element_type=float32) leaves it: the
    preconditioner only steers CG."""
    K, nbp, P, _ = Q.shape
    c = (1.0 / (gamw[:, None, None] * lam + gam2[:, None, None])).to(Q.dtype)
    ct = torch.promote_types(Q.dtype, torch.float32)
    total = K * nbp

    def rebuild(args):
        q, cc = args[0].to(ct), args[1].to(ct)
        return ((q * cc[:, None, :]) @ q.transpose(-1, -2)).to(torch.float32).to(dtype)

    Pinv = _chunked_map(rebuild, (Q.reshape(total, P, P), c.reshape(total, P)),
                        chunk or total)
    return Pinv.reshape(K, nbp, P, P)


def apply_block_jacobi(Pinv: Tensor, v: Tensor) -> Tensor:
    """z = blockdiag(Pinv) @ v, batched over lanes.

    v: (L, M) with L a multiple of K (the fused multi-RHS CG stacks lane
    groups that share per-cohort systems, e.g. L = 2K). v keeps its own
    precision: the product is taken in at least float32, so a bfloat16
    Pinv only loses precision on the preconditioner's side."""
    K, nbp, P, _ = Pinv.shape
    L, M = v.shape
    ct = torch.promote_types(v.dtype, torch.float32)
    vb = v.reshape(L // K, K, nbp, P).to(ct)
    z = torch.einsum("knpq,cknq->cknp", Pinv.to(ct), vb)
    return z.reshape(L, M).to(v.dtype)
