"""The plain reference's LD operator over int8 blocks, in plain PyTorch.

From the band it is given it derives the int8 blocks and their scales by
the storage's stated rule (B x B blocks of the upper band, one float32
scale per block, max|block| / 127, values rounded half to even and clipped
to [-127, 127]), and it reads each pass's lanes rounded to bfloat16, as the
int8 operator states. Nothing here calls the program. A configuration names
this file as its `reference_operator`; another storage brings a file of its
own with the same `operator(band, conf, dtype)`.
"""

from __future__ import annotations

import torch


def operator(band: torch.Tensor, conf, dtype: torch.dtype) -> "Int8Band":
    """The configuration's panel as the reference reads it, in dtype."""
    return Int8Band(band, conf["B"], dtype)


def upper_blocks(band: torch.Tensor, B: int) -> torch.Tensor:
    """(nb, hb + 1, B, B) float32 blocks of a band (M, 2 bw + 1) whose M is
    a multiple of B: block (i, d) holds R[iB + p, (i + d)B + q]; blocks
    past the matrix's end are zero."""
    M, nd = band.shape
    bw = (nd - 1) // 2
    if M % B:
        raise ValueError(f"M={M} is not a multiple of B={B}")
    nb, hb = M // B, -(-bw // B)
    rows = band.reshape(nb, B, nd)
    up = torch.zeros((nb, hb + 1, B, B), dtype=torch.float32, device=band.device)
    for d in range(hb + 1):
        for p in range(B):
            lo = bw + d * B - p          # band column of q = 0
            a, b = max(0, -lo), min(B, nd - lo)
            if a < b:
                up[:, d, p, a:b] = rows[:, p, lo + a:lo + b]
        if d:
            up[nb - d:, d] = 0.0
    return up


def int8_blocks(band: torch.Tensor, B: int):
    """(q (nb, hb + 1, B, B) int8, scales (nb, hb + 1) float32): the upper
    blocks quantized by the storage's rule."""
    up = upper_blocks(band, B)
    scale = up.abs().amax(dim=(-2, -1)) / 127.0
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(up / safe[..., None, None]), -127, 127).to(torch.int8)
    return q, scale


class Int8Band:
    """R from int8 blocks, dequantized in `dtype`; matvec(x) for any number
    of lanes (every lane sees the one panel), each lane rounded to bfloat16
    on the way in."""

    def __init__(self, band: torch.Tensor, B: int, dtype: torch.dtype):
        q, scale = int8_blocks(band, B)
        self.blocks = q.to(dtype) * scale.to(dtype)[..., None, None]
        self.blocks_with_data = int((scale != 0).sum())
        self.nb, self.hb, self.B = q.shape[0], q.shape[1] - 1, B
        self.dtype = dtype

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        S, M = x.shape
        nb, B = self.nb, self.B
        xb = x.to(torch.bfloat16).to(self.dtype).reshape(S, nb, B)
        y = torch.zeros((S, nb, B), dtype=self.dtype, device=x.device)
        for d in range(self.hb + 1):
            U = self.blocks[:nb - d, d]
            y[:, :nb - d] += torch.einsum("ipq,siq->sip", U, xb[:, d:])
            if d:   # the mirror: R[(i + d)B + q, iB + p] = U[i][p, q]
                y[:, d:] += torch.einsum("ipq,sip->siq", U, xb[:, :nb - d])
        return y.reshape(S, M).to(x.dtype)
