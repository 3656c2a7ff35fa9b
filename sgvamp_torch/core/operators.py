"""Dense, block-banded and block-sparse LD operators (PyTorch port of
sgvamp_tpu/core/operators.py::DenseLD, ::BandedLD and ::BlockSparseLD).

Every operator has the batched matvec contract x (S*K, M) -> (S*K, M):
row s*K + k is multiplied by cohort k's matrix, so one pass over the
matrix serves S right-hand sides. The (1-s) R + s I regularization is
folded into the matvec. The matvecs here are plain torch (an einsum; for
BlockSparseLD a gather, a batched product and a fixed-order sum), as the JAX
package leaves them to XLA outside any Pallas kernel. The banded operator
that the main path runs is ops/band_kernel.py::SymBandedLD, which stores
half of BandedLD's blocks.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

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


class LDOperator:
    """What every LD operator gives besides its matvec: shifted_matvec, A's
    product in CG (core/vamp.py::_amatvec). SymBandedLD computes it in its
    own pass, with the same bits."""

    def shifted_matvec(self, x: Tensor, gamw: Tensor, gam2: Tensor) -> Tensor:
        """gamw[:, None] * self.matvec(x) + gam2[:, None] * x; gamw, gam2
        (S*K,)."""
        return gamw[:, None] * self.matvec(x) + gam2[:, None] * x


@dataclasses.dataclass(frozen=True)
class DenseLD(LDOperator):
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
class BandedLD(LDOperator):
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


@contextlib.contextmanager
def _ieee_float32(t: Tensor):
    """Products of float32 CUDA tensors like t in IEEE float32: where the
    caller let cuBLAS take them in TF32 (torch.backends.cuda.matmul
    .fp32_precision "tf32", which the legacy switches set too), TF32 is off
    while the block products are taken and on again after; otherwise
    nothing is written."""
    m = torch.backends.cuda.matmul
    loose = t.is_cuda and t.dtype == torch.float32 and m.fp32_precision == "tf32"
    if loose:
        m.fp32_precision = "ieee"
    try:
        yield
    finally:
        if loose:
            m.fp32_precision = "tf32"


def _row_buckets(rows: Tensor, nb: int) -> tuple:
    """The block rows grouped by their slot count d: a (row ids (n,),
    slots (n, d)) pair for each d, each row's slots in ascending order. A
    row with no slot is in no bucket (its y is zero). The tables hold each
    slot once: a row with many slots does not widen the others."""
    r = rows.long()
    order = torch.sort(r, stable=True).indices
    counts = torch.bincount(r, minlength=nb)
    start = torch.cumsum(counts, 0) - counts
    buckets = []
    for d in torch.unique(counts).tolist():
        if d:
            ids = torch.nonzero(counts == d).flatten()
            j = torch.arange(d, device=rows.device)
            buckets.append((ids, order[start[ids, None] + j[None, :]]))
    return tuple(buckets)


def _key_runs(keys: np.ndarray) -> tuple:
    """(the key of each run, its length) for the runs of equal consecutive
    keys. A CSR row's entries in one tile are one run, so a panel of a few
    tiles a row has a few runs a row, not one an entry."""
    new = np.ones(keys.size, dtype=bool)
    np.not_equal(keys[1:], keys[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    return keys[starts], np.diff(starts, append=keys.size)


# tiles of bfloat16 blocks widened to float32 at a time where the product
# of bf16 operands summed in f32 is not at hand (the CPU): bounds the
# widened copy to this many (B, B) f32 tiles
_WIDEN_TILES = 1024


@dataclasses.dataclass(frozen=True)
class BlockSparseLD(LDOperator):
    """Block-sparse LD operator: (B, B) tiles at arbitrary block coordinates.

    It keeps every entry of any sparsity pattern, long-range LD far off the
    band included, storing only the tiles that hold a nonzero:

      blocks: (K, nnzb, B, B) tiles, over the union of the K cohorts'
              patterns (a cohort lacking a tile holds zeros there);
      rows, cols: (nnzb,) int32 block row and block column of each tile;
      nb: block rows; s: the regularization weight; accum_dtype ("" |
              "float32" | "float64"): the type the products are summed in
              when it is wider than the blocks' (float32 for bfloat16).

    matvec gathers the x blocks by `cols` (x rounded to the blocks' dtype,
    as in the JAX package) and takes every tile's product in one batched
    product, summed in accum_dtype (bf16 tiles on CUDA without a widened
    copy, as JAX's preferred_element_type). Each block row's products are
    then added through the table of the rows with its slot count, in one
    fixed order. No atomics: the same bits on every run, on the CPU and on
    CUDA alike.
    """

    blocks: Tensor
    rows: Tensor
    cols: Tensor
    nb: int
    s: float = 0.0
    accum_dtype: str = ""

    def __post_init__(self) -> None:
        if self.accum_dtype not in _ACCUM:
            raise ValueError(f"accum_dtype must be one of {sorted(_ACCUM)}, "
                             f"got {self.accum_dtype!r}")
        object.__setattr__(self, "_buckets", _row_buckets(self.rows, self.nb))
        # the diagonal blocks' slots, found once (nonzero reads the device,
        # which a CUDA graph cannot hold)
        object.__setattr__(self, "_diag",
                           torch.nonzero(self.rows == self.cols).flatten()[:self.nb])

    @property
    def K(self) -> int:
        return self.blocks.shape[0]

    @property
    def nnzb(self) -> int:
        return self.blocks.shape[1]

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
        block-Jacobi preconditioner, core/precond.py): the first nb slots
        with rows == cols, in slot order, as the JAX package takes them.
        from_csr stores every diagonal block, in block-row order; the
        all-zero slots of a shard's padding (rows = cols = 0) come after
        every real slot and are never taken."""
        return _regularize_diag(self.blocks.index_select(1, self._diag).float(), self.s)

    def apply(self, xb: Tensor) -> Tensor:
        """(S, K, nb, B) block rows of R x, without the s term and in the
        accumulation dtype, from the x blocks (S, K, nb, B)."""
        S, K, nb, B = xb.shape
        n = self.nnzb
        # (K * nnzb, B, S): each tile's x block, its S columns side by side
        xn = xb.to(self.blocks.dtype).index_select(2, self.cols).permute(1, 2, 3, 0)
        xn = xn.reshape(K * n, B, S)
        blocks = self.blocks.reshape(K * n, B, B)
        acc = _ACCUM[self.accum_dtype]
        if acc is None or acc == blocks.dtype:
            with _ieee_float32(blocks):
                yn = torch.bmm(blocks, xn)
        elif blocks.is_cuda:
            # cuBLAS takes the bf16 operands and sums in acc: no copy
            yn = torch.bmm(blocks, xn, out_dtype=acc)
        else:
            # widen (exact) a bounded run of tiles at a time
            yn = xn.new_empty((K * n, B, S), dtype=acc)
            for t in range(0, K * n, _WIDEN_TILES):
                c = slice(t, t + _WIDEN_TILES)
                yn[c] = torch.bmm(blocks[c].to(acc), xn[c].to(acc))
        yn = yn.reshape(K, n, B, S)
        y = yn.new_zeros((K, nb, B, S))
        for ids, slots in self._buckets:
            y.index_copy_(1, ids, yn[:, slots].sum(dim=2))
        return y.permute(3, 0, 1, 2)

    def matvec(self, x: Tensor) -> Tensor:
        """R @ x rowwise; x stacks S right-hand sides per cohort ((S*K, M)),
        and one pass over the blocks serves all of them."""
        S = x.shape[0] // self.K
        y = self.apply(x.reshape(S, self.K, self.nb, self.B))
        return _regularize(y.reshape(x.shape).to(x.dtype), x, self.s)

    def to_dense(self) -> Tensor:
        """Materialize dense (K, M, M) on the CPU - tests only."""
        B = self.B
        blocks = self.blocks.cpu()
        blocks = (blocks.float() if blocks.dtype == torch.bfloat16 else blocks).numpy()
        out = np.zeros((self.K, self.M, self.M), dtype=blocks.dtype)
        for n, (i, j) in enumerate(zip(self.rows.tolist(), self.cols.tolist())):
            out[:, i * B:(i + 1) * B, j * B:(j + 1) * B] = blocks[:, n]
        eye = np.eye(self.M, dtype=out.dtype)
        return torch.from_numpy((1.0 - self.s) * out + self.s * eye[None])

    @staticmethod
    def from_csr(Rs, block_size: int, s: float = 0.0, dtype=None,
                 M: Optional[int] = None, device=None,
                 cohorts: Optional[slice] = None) -> "BlockSparseLD":
        """Build from K scipy sparse matrices without densifying M x M, as
        the JAX package builds it (numpy on the host): the block pattern is
        the union over the cohorts plus every diagonal block, slots in
        ascending (row, col) order, and the padded markers past M get a
        unit diagonal (the mask leaves them out of every statistic; this
        keeps the operator SPD). dtype None: the first matrix's. The
        tensors go to `device` (None: the default CUDA device). cohorts:
        fill the blocks of these cohorts only (a process's share of a run
        over several processes), over the union pattern of all K."""
        device = resolve_device(device)
        Rs = [R.tocoo() for R in Rs]
        if M is None:
            M = Rs[0].shape[0]
        B = block_size
        pad = (-M) % B
        nb = (M + pad) // B

        # each entry's tile key, as runs of equal keys; the union pattern,
        # ascending: np.unique over the runs, not over every entry
        runs = [_key_runs((R.row // B).astype(np.int64) * nb + (R.col // B)) for R in Rs]
        diag = np.arange(nb, dtype=np.int64) * (nb + 1)
        uniq = np.unique(np.concatenate([diag] + [run_key for run_key, _ in runs]))
        rows = (uniq // nb).astype(np.int32)
        cols = (uniq % nb).astype(np.int32)

        name, out_dtype = _block_dtype(dtype, np.asarray(Rs[0].data).dtype)
        own = slice(None) if cohorts is None else cohorts
        Rs, runs = Rs[own], runs[own]
        K = len(Rs)
        blocks = np.zeros((K, uniq.shape[0], B, B), out_dtype)
        for k, (R, (run_key, length)) in enumerate(zip(Rs, runs)):
            slot = np.repeat(np.searchsorted(uniq, run_key), length)
            # one flat index an entry: (slot, row in block, column in block)
            flat = (slot * B + R.row % B) * B + R.col % B
            del slot
            blocks[k].reshape(-1)[flat] = R.data
            del flat
        if pad:
            dslot = np.searchsorted(uniq, diag)
            idx = np.arange(M, M + pad)
            blocks[:, dslot[idx // B], idx % B, idx % B] = 1.0
        return BlockSparseLD(
            blocks=_to_torch(blocks, name, device),
            rows=torch.from_numpy(rows).to(device), cols=torch.from_numpy(cols).to(device),
            nb=nb, s=s, accum_dtype="" if name == "float64" else "float32")
