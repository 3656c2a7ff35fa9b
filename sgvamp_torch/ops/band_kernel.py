"""Symmetric block-banded LD operator with int8 half storage.

Only the upper-triangle block diagonals U[i, d] = R[block i, block i+d],
d = 0..hb, are stored: (K, nb, hb+1, B, B) int8 with one f32 scale per
block (q = round(U / scale), scale = max|U| / 127). A matvec adds both
the row part U[i,d] @ x_{i+d} and the mirrored part U[i,d]^T @ x_i.

On a CUDA tensor the matvec runs the hand-written kernel in
csrc/sym_band_int8.cu, which replaces the TPU kernel
sgvamp_tpu/ops/band_kernel.py::_sym_band_kernel_streamed (quantized
flavor); see that file's header for its design. On a CPU tensor it runs
the plain PyTorch version, sym_band_matvec_int8_ref. Other storage types,
the slab layout and the sharded matvec are not ported yet (ROADMAP B3-B9,
A14).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import Tensor


def sym_band_matvec_int8_ref(upper: Tensor, scales: Tensor, x: Tensor) -> Tensor:
    """Plain PyTorch version of the kernel: y = R x per cohort, in f32.

    upper (K, nb, hb+1, B, B) int8, scales (K, nb, hb+1) f32, x (K, S, nb*B)
    bf16 -> y (K, S, nb*B) f32. Each block's dot is taken in f32 and then
    scaled, as in the kernel.
    """
    K, nb, nslot, B, _ = upper.shape
    S = x.shape[1]
    hb = nslot - 1
    xb = x.float().reshape(K, S, nb, B)
    xpad = torch.cat([xb, xb.new_zeros(K, S, hb, B)], dim=2)
    y = xb.new_zeros(K, S, nb, B)
    for d in range(hb + 1):
        U = upper[:, :, d].float()                       # (K, nb, B, B)
        sc = scales[:, None, :, d, None]                 # (K, 1, nb, 1)
        # row part: y_i[p] += sc[i,d] sum_q U[i,d][p,q] x_{i+d}[q]
        y += sc * torch.einsum("knpq,ksnq->ksnp", U, xpad[:, :, d:d + nb])
        if d:
            # mirror part: y_{i+d}[q] += sc[i,d] sum_p U[i,d][p,q] x_i[p]
            mir = sc * torch.einsum("knpq,ksnp->ksnq", U, xb)
            y[:, :, d:] += mir[:, :, :nb - d]
    return y.reshape(K, S, nb * B)


def _check(upper: Tensor, scales: Tensor, x: Tensor) -> None:
    if upper.dtype != torch.int8 or upper.dim() != 5 or upper.shape[-1] != upper.shape[-2]:
        raise ValueError("upper must be (K, nb, hb+1, B, B) int8")
    K, nb, nslot, B, _ = upper.shape
    if scales.dtype != torch.float32 or tuple(scales.shape) != (K, nb, nslot):
        raise ValueError(f"scales must be ({K}, {nb}, {nslot}) float32")
    if x.dtype != torch.bfloat16 or x.dim() != 3 or x.shape[0] != K or x.shape[2] != nb * B:
        raise ValueError(f"x must be ({K}, S, {nb * B}) bfloat16")
    if not (upper.device == scales.device == x.device):
        raise ValueError("upper, scales and x must be on one device")


def sym_band_matvec_int8(upper: Tensor, scales: Tensor, x: Tensor) -> Tensor:
    """y = R x per cohort; arguments as for sym_band_matvec_int8_ref.

    CUDA tensors go through the CUDA kernel (or raise), CPU tensors through
    the plain version. `sym_band_matvec_int8.launches` counts kernel
    launches.
    """
    _check(upper, scales, x)
    if x.device.type == "cpu":
        return sym_band_matvec_int8_ref(upper, scales, x)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 band kernel for device {x.device}")
    if not (upper.is_contiguous() and scales.is_contiguous() and x.is_contiguous()):
        raise ValueError("upper, scales and x must be contiguous")
    from sgvamp_torch.ops._build import load_library

    K, nb, nslot, B, _ = upper.shape
    S = x.shape[1]
    if B not in (64, 128, 256) or not 1 <= S <= 4:
        raise ValueError(f"the int8 band kernel takes B in (64, 128, 256) and "
                         f"S in 1..4, got B={B}, S={S}")
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = load_library().sgv_sym_band_int8_matvec(
            upper.data_ptr(), scales.data_ptr(), x.data_ptr(), y.data_ptr(),
            K, nb, nslot - 1, B, S, stream)
    if err != 0:
        raise RuntimeError(f"sym_band_int8 kernel launch failed (error {err})")
    sym_band_matvec_int8.launches += 1
    return y


sym_band_matvec_int8.launches = 0


@dataclasses.dataclass(frozen=True)
class SymBandedLD:
    """Symmetric block-banded LD operator, int8 diag layout.

    upper: (K, nb, hb+1, B, B) int8 upper-triangle block diagonals.
    scales: (K, nb, hb+1) f32 per-block dequantization scales.
    Same matvec contract as the other operators: x is (S*K, M).
    """

    upper: Tensor
    scales: Tensor
    s: float = 0.0

    def __post_init__(self) -> None:
        if self.upper.dtype != torch.int8:
            raise NotImplementedError(
                "only int8 SymBandedLD storage is ported (bf16/f32 is "
                "ROADMAP B3, int4 B5, hybrid B6)")

    @property
    def K(self) -> int:
        return self.upper.shape[0]

    @property
    def nb(self) -> int:
        return self.upper.shape[1]

    @property
    def hb(self) -> int:
        return self.upper.shape[2] - 1

    @property
    def B(self) -> int:
        return self.upper.shape[-1]

    @property
    def M(self) -> int:
        return self.nb * self.B

    def bytes_per_pass(self) -> int:
        """Bytes of LD blocks and scales one matvec needs (roofline
        accounting; the kernel's actual HBM reads are in PERF.md)."""
        return (self.upper.numel() * self.upper.element_size()
                + self.scales.numel() * self.scales.element_size())

    def matvec(self, x: Tensor) -> Tensor:
        S = x.shape[0] // self.K
        # (K, S, M) lanes in bf16; the caller's x stays unrounded for the
        # regularization term below.
        xs = x.reshape(S, self.K, self.M).transpose(0, 1).to(torch.bfloat16).contiguous()
        y = sym_band_matvec_int8(self.upper, self.scales, xs)
        y = y.transpose(0, 1).reshape(x.shape).to(x.dtype)
        if self.s != 0.0:
            y = (1.0 - self.s) * y + self.s * x
        return y

    @staticmethod
    def from_band(band: np.ndarray, block_size: int, K: int = 1,
                  s: float = 0.0, dtype="int8", layout: str = "diag",
                  mesh=None, device: torch.device | str = "cpu") -> "SymBandedLD":
        """Pack symmetric band storage (M, 2*bw+1) into int8 upper blocks.

        Bit-identical to sgvamp_tpu's SymBandedLD.from_band(..., dtype="int8")
        (its numpy path). M is padded up to a block multiple with an
        identity diagonal on the padded markers, which callers mask.
        """
        if dtype not in ("int8", np.int8, torch.int8):
            raise NotImplementedError(
                f"SymBandedLD dtype={dtype!r} is not ported (bf16/f32 is "
                "ROADMAP B3, int4 B5, hybrid B6)")
        if layout != "diag":
            raise NotImplementedError("the slab layout is not ported (ROADMAP B7)")
        if mesh is not None:
            raise NotImplementedError("the sharded matvec is not ported (ROADMAP A14)")
        upper, scales = pack_int8(np.asarray(band), block_size)
        if K > 1:
            upper = np.repeat(upper[None], K, axis=0)
            scales = np.repeat(scales[None], K, axis=0)
        else:
            upper, scales = upper[None], scales[None]
        return SymBandedLD(upper=torch.from_numpy(upper).to(device),
                           scales=torch.from_numpy(scales).to(device), s=s)

    def to_dense(self) -> Tensor:
        """Materialize (K, M, M) in f32 - tests only."""
        K, nb, hbp1, B = self.K, self.nb, self.hb + 1, self.B
        up = self.upper.cpu().float().numpy() * self.scales.cpu().numpy()[..., None, None]
        out = np.zeros((K, self.M, self.M), dtype=np.float32)
        for k in range(K):
            for i in range(nb):
                for d in range(hbp1):
                    j = i + d
                    if j < nb:
                        blk = up[k, i, d]
                        out[k, i * B:(i + 1) * B, j * B:(j + 1) * B] += blk
                        if d > 0:
                            out[k, j * B:(j + 1) * B, i * B:(i + 1) * B] += blk.T
        eye = np.eye(self.M, dtype=out.dtype)
        return torch.from_numpy((1.0 - self.s) * out + self.s * eye[None])


def pack_int8(band: np.ndarray, B: int):
    """(M, 2*bw+1) band -> (upper (nb, hb+1, B, B) int8, scales (nb, hb+1) f32).

    The numpy path of sgvamp_tpu's from_band, step for step, so that the
    bits agree: blocks in f32, past-the-matrix blocks forced to zero, then
    per-block symmetric quantization (zero blocks get scale 0).
    """
    M, nd_full = band.shape
    bw = (nd_full - 1) // 2
    pad = (-M) % B
    if pad:
        ext = np.zeros((pad, nd_full), dtype=band.dtype)
        ext[:, bw] = 1.0
        band = np.concatenate([band, ext], axis=0)
        M = M + pad
    nb = M // B
    hb = -(-bw // B)
    band_r = band.reshape(nb, B, nd_full)
    upper = np.zeros((nb, hb + 1, B, B), dtype=np.float32)
    p = np.arange(B)[:, None]
    q = np.arange(B)[None, :]
    for d in range(hb + 1):
        col = bw + d * B + q - p
        valid = (col >= 0) & (col < nd_full)
        colc = np.clip(col, 0, nd_full - 1)
        vals = np.take_along_axis(band_r, colc[None, :, :], axis=2)
        upper[:, d] = np.where(valid[None], vals, 0.0)
    # Blocks whose columns run past the matrix are exactly zero.
    for d in range(1, hb + 1):
        upper[nb - d:, d] = 0.0
    amax = np.abs(upper).max(axis=(-2, -1))  # (nb, hb+1)
    sc = amax / 127.0
    safe = np.where(sc == 0.0, 1.0, sc)
    q8 = np.clip(np.rint(upper / safe[..., None, None]), -127, 127).astype(np.int8)
    return q8, sc.astype(np.float32)
