"""Dense and block-banded LD operators (PyTorch port of
sgvamp_tpu/core/operators.py::DenseLD and ::BandedLD).

Every operator has the batched matvec contract x (S*K, M) -> (S*K, M):
row s*K + k is multiplied by cohort k's matrix, so one pass over the
matrix serves S right-hand sides. The (1-s) R + s I regularization is
folded into the matvec. Both matvecs here are one torch.einsum, as the JAX
package leaves them to XLA outside any Pallas kernel. The banded operator
that the main path runs is ops/band_kernel.py::SymBandedLD, which stores
half of BandedLD's blocks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import Tensor

from sgvamp_torch import resolve_device

_ACCUM = {"": None, "float32": torch.float32, "float64": torch.float64}


def _regularize(y: Tensor, x: Tensor, s: float) -> Tensor:
    # Rused @ x = (1-s) * (R @ x) + s * x
    if s == 0.0:
        return y
    return (1.0 - s) * y + s * x


def default_diag_block(M: int) -> int:
    """The block size DenseLD.diag_blocks takes when none is given: the
    largest divisor of M at most 256."""
    return max(b for b in range(1, min(256, M) + 1) if M % b == 0)


def _regularize_diag(D: Tensor, s: float) -> Tensor:
    # diagonal blocks of Rused = (1-s) R + s I, from diagonal blocks of R
    if s == 0.0:
        return D
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    return (1.0 - s) * D + s * eye


@dataclasses.dataclass(frozen=True)
class DenseLD:
    """Dense stacked LD operator: mats (K, M, M), one matrix per cohort."""

    mats: Tensor
    s: float = 0.0

    @property
    def K(self) -> int:
        return self.mats.shape[0]

    @property
    def M(self) -> int:
        return self.mats.shape[-1]

    def bytes_per_pass(self) -> int:
        """Bytes of LD data read by one matvec (roofline accounting)."""
        return self.mats.numel() * self.mats.element_size()

    def matvec(self, x: Tensor) -> Tensor:
        S = x.shape[0] // self.K
        xs = x.reshape(S, self.K, self.M).to(self.mats.dtype)
        y = torch.einsum("kij,skj->ski", self.mats, xs)
        return _regularize(y.reshape(x.shape).to(x.dtype), x, self.s)

    def diag_blocks(self, block_size: int = 0) -> Tensor:
        """(K, nb, B, B) f32 regularized diagonal blocks of Rused (for the
        block-Jacobi preconditioner, core/precond.py). Default block: the
        largest divisor of M at most 256."""
        B = block_size or default_diag_block(self.M)
        if self.M % B:
            raise ValueError(f"M={self.M} not a multiple of block {B}")
        nb = self.M // B
        Dv = self.mats.reshape(self.K, nb, B, nb, B)
        D = torch.diagonal(Dv, dim1=1, dim2=3).movedim(-1, 1).float()
        return _regularize_diag(D, self.s)


def _to_torch(blocks: np.ndarray, name: str, device) -> Tensor:
    t = torch.from_numpy(blocks)
    return (t.to(torch.bfloat16) if name == "bfloat16" else t).to(device)


def _block_dtype(dtype, fallback) -> tuple:
    """(dtype name, numpy dtype the blocks are packed in): bfloat16 blocks
    are packed in float32 and rounded to nearest even afterwards."""
    if dtype is None:
        name = np.dtype(fallback).name
    elif isinstance(dtype, torch.dtype):
        name = str(dtype).split(".")[-1]
    else:
        name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in ("float32", "float64", "bfloat16"):
        raise ValueError(f"unsupported BandedLD dtype: {dtype!r}")
    return name, np.dtype(np.float32 if name == "bfloat16" else name)


@dataclasses.dataclass(frozen=True)
class BandedLD:
    """Block-banded LD operator over full-band storage.

    For each of nb = M/B block rows the 2*hb + 1 diagonal-adjacent (B, B)
    blocks are kept, zero-padded at the edges:

      blocks[k, i, d] = R_k[i*B:(i+1)*B, (i+d-hb)*B:(i+d-hb+1)*B]

    matvec gathers the neighbouring x blocks and contracts them with one
    einsum. accum_dtype ("" | "float32" | "float64"): the type products are
    summed in when it is wider than the blocks' (float32 for bfloat16
    blocks).
    """

    blocks: Tensor
    s: float = 0.0
    accum_dtype: str = ""

    def __post_init__(self) -> None:
        if self.accum_dtype not in _ACCUM:
            raise ValueError(f"accum_dtype must be one of {sorted(_ACCUM)}, "
                             f"got {self.accum_dtype!r}")

    @property
    def K(self) -> int:
        return self.blocks.shape[0]

    @property
    def nb(self) -> int:
        return self.blocks.shape[1]

    @property
    def hb(self) -> int:
        return (self.blocks.shape[2] - 1) // 2

    @property
    def B(self) -> int:
        return self.blocks.shape[-1]

    @property
    def M(self) -> int:
        return self.nb * self.B

    def bytes_per_pass(self) -> int:
        """Bytes of LD blocks read by one matvec (roofline accounting)."""
        return self.blocks.numel() * self.blocks.element_size()

    def diag_blocks(self) -> Tensor:
        """(K, nb, B, B) f32 regularized diagonal blocks of Rused (for the
        block-Jacobi preconditioner, core/precond.py)."""
        return _regularize_diag(self.blocks[:, :, self.hb].float(), self.s)

    def matvec(self, x: Tensor) -> Tensor:
        K, nb, B, hb = self.K, self.nb, self.B, self.hb
        S = x.shape[0] // K
        xb = x.reshape(S, K, nb, B)
        # zeros outside the matrix (matching the zero-padded edge blocks)
        edge = xb.new_zeros(S, K, hb, B)
        yb = self.apply_padded(torch.cat([edge, xb, edge], dim=2))
        return _regularize(yb.reshape(x.shape).to(x.dtype), x, self.s)

    def apply_padded(self, xpad: Tensor) -> Tensor:
        """(S, K, nb, B) block rows of R x, without the s term, from xpad
        (S, K, nb + 2*hb, B): the x blocks -hb .. nb+hb-1 of these block
        rows. The whole operator pads with zeros; a shard of block rows
        (parallel/sharding.py) with its neighbours' x blocks."""
        nb, hb = self.nb, self.hb
        xpad = xpad.to(self.blocks.dtype)
        # neighbour table: for block row i the x blocks i-hb .. i+hb
        xn = torch.stack([xpad[:, :, d:d + nb] for d in range(2 * hb + 1)], dim=3)
        acc = _ACCUM[self.accum_dtype]
        blocks = self.blocks
        if acc is not None and acc != blocks.dtype:
            # torch.einsum has no separate accumulation type: widen the
            # operands (exact), so products and sums are taken in `acc`
            blocks, xn = blocks.to(acc), xn.to(acc)
        return torch.einsum("kndij,skndj->skni", blocks, xn)

    def to_dense(self) -> Tensor:
        """Materialize dense (K, M, M) on the CPU - tests only."""
        K, nb, B, hb = self.K, self.nb, self.B, self.hb
        blocks = self.blocks.cpu()
        blocks = (blocks.float() if blocks.dtype == torch.bfloat16 else blocks).numpy()
        out = np.zeros((K, self.M, self.M), dtype=blocks.dtype)
        for i in range(nb):
            for d in range(2 * hb + 1):
                j = i + d - hb
                if 0 <= j < nb:
                    out[:, i * B:(i + 1) * B, j * B:(j + 1) * B] = blocks[:, i, d]
        eye = np.eye(self.M, dtype=out.dtype)
        return torch.from_numpy((1.0 - self.s) * out + self.s * eye[None])

    @staticmethod
    def from_band(band: np.ndarray, block_size: int, K: int = 1, s: float = 0.0,
                  dtype=None, device=None) -> "BandedLD":
        """Pack symmetric band storage (M, 2*bw+1), band[i, bw + d] =
        R[i, i+d], into block-banded form without materializing M x M.
        M is padded up to a block multiple with identity rows (callers mask
        the padded markers). dtype None: the band's own. The tensors go to
        `device` (None: the default CUDA device)."""
        device = resolve_device(device)
        band = np.asarray(band)
        M, nd = band.shape
        bw = (nd - 1) // 2
        B = block_size
        pad = (-M) % B
        if pad:
            ext = np.zeros((pad, nd), dtype=band.dtype)
            ext[:, bw] = 1.0
            band = np.concatenate([band, ext], axis=0)
            M = M + pad
        nb = M // B
        hb = -(-bw // B)  # block half-bandwidth
        band_r = band.reshape(nb, B, nd)
        name, out_dtype = _block_dtype(dtype, band.dtype)
        blocks = np.zeros((nb, 2 * hb + 1, B, B), dtype=out_dtype)
        p = np.arange(B)[:, None]
        q = np.arange(B)[None, :]
        for d in range(2 * hb + 1):
            col = bw + (d - hb) * B + q - p           # (B, B) band-column index
            valid = (col >= 0) & (col < nd)
            vals = np.take_along_axis(band_r, np.clip(col, 0, nd - 1)[None, :, :], axis=2)
            blocks[:, d] = np.where(valid[None], vals, 0.0)
        t = _to_torch(blocks, name, device)
        stacked = t[None].repeat(K, 1, 1, 1, 1).contiguous()
        return BandedLD(blocks=stacked, s=s,
                        accum_dtype="float32" if name != "float64" else "")

    @staticmethod
    def from_dense(mats, block_size: int, bandwidth_blocks: int, s: float = 0.0,
                   dtype=None, device=None) -> "BandedLD":
        """Pack a dense (K, M, M) stack into block-banded storage; entries
        outside the band are dropped."""
        device = resolve_device(device)
        mats = np.asarray(mats)
        K, M, _ = mats.shape
        B, hb = block_size, bandwidth_blocks
        if M % B:
            raise ValueError(f"M={M} must be a multiple of block_size={B}")
        nb = M // B
        name, out_dtype = _block_dtype(dtype, mats.dtype)
        out = np.zeros((K, nb, 2 * hb + 1, B, B), dtype=out_dtype)
        for i in range(nb):
            for d in range(2 * hb + 1):
                j = i + d - hb
                if 0 <= j < nb:
                    out[:, i, d] = mats[:, i * B:(i + 1) * B, j * B:(j + 1) * B]
        return BandedLD(blocks=_to_torch(out, name, device), s=s,
                        accum_dtype="" if name == "float64" else "float32")
