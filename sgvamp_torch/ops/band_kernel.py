"""Symmetric block-banded LD operator over upper-triangle block storage.

Only the upper-triangle block diagonals U[i, d] = R[block i, block i+d],
d = 0..hb, are stored. A matvec adds both the row part U[i,d] @ x_{i+d}
and the mirrored part U[i,d]^T @ x_i. Five storage types:

  float    (K, nb, hb+1, B, B) bfloat16 / float32 / float64 blocks, no
           scales; x is cast to the block dtype. With layout="slab" the
           same blocks are stored as (K, nb, (hb+1)*B, B) stacked
           transposes T_i[d*B + q, p] = U[i, d][p, q], so that the row part
           of block row i is one product of T_i with the contiguous
           (hb+1)*B window of x.
  int8     (K, nb, hb+1, B, B) int8, one f32 scale per block
           (q = round(U / scale), scale = max|U| / 127).
  int4     (K, nb, hb+1, B, B/2) int8 bytes holding two 4-bit values each
           (low nibble = column j, high nibble = column j + B/2), one f32
           scale per block ROW (max|row| / 7), the unit diagonal of the
           d=0 block stripped before quantizing (the matvec adds x back).
  hybrid   (K, nb, hb+2, B, B/2) int8: slots 0 and 1 are the d=0 block's
           int8 column halves (per-row scales max|row| / 127, diagonal
           stripped), slot d+1 is diagonal d >= 1 packed as int4.

The quantized types take x in bf16 and sum in f32, in diag layout and the
streamed flavor only. Float blocks have two flavors in either layout
(SymBandedLD.mode): "streamed" gathers every output block row on its own
and reads each off-diagonal block twice; "resident" keeps the x and y of a
run of block rows in a CTA's shared memory, reads each block once and
takes both its terms, and is limited by that shared memory
(SymBandedLD.fits_shared_memory); "auto" takes the resident flavor where
it fits.

On a CUDA tensor each matvec runs a hand-written kernel, one per row of
this table; on a CPU tensor it runs the plain PyTorch version beside the
wrapper (*_ref). The kernels replace the TPU kernels of
sgvamp_tpu/ops/band_kernel.py; see the sources' headers for their design.

  wrapper                     source                      replaces
  sym_band_matvec_int8        csrc/sym_band_int8.cu       _sym_band_kernel_streamed, int8
  sym_band_matvec             csrc/sym_band_float.cu      same, float blocks
  sym_band_matvec_int4        csrc/sym_band_int4.cu       same, packed4
  sym_band_matvec_hybrid      csrc/sym_band_hybrid.cu     same, hybrid
  sym_slab_matvec_streamed    csrc/sym_slab_streamed.cu   _sym_slab_kernel_streamed
  sym_band_matvec_resident    csrc/sym_band_resident.cu   _sym_band_kernel
  sym_band_matvec_window      csrc/sym_band_resident.cu   _sym_band_kernel, window=True
  sym_slab_matvec_resident    csrc/sym_slab_resident.cu   _sym_slab_kernel

The sharded matvec (SymBandedLD.mesh in the TPU package, with the
spill=True variants of the two streamed kernels) is not ported yet
(ROADMAP A14, B4).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import Tensor

from sgvamp_torch import resolve_device

_FLOAT_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
_FLOAT_NAMES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float64": torch.float64}


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _band_sum(xb: Tensor, hb: int, rowpart: Callable, mirpart: Callable) -> Tensor:
    """y_i = sum_d rowpart(d, x_{i+d}) + sum_{d>=1} mirpart(d, x_{i-d})[i-d].

    xb (K, S, nb, B); rowpart(d, xw) and mirpart(d, xb) return (K, S, nb, B)
    contributions indexed by the block row that STORES the block."""
    K, S, nb, B = xb.shape
    xpad = torch.cat([xb, xb.new_zeros(K, S, hb, B)], dim=2)
    y = None
    for d in range(hb + 1):
        row = rowpart(d, xpad[:, :, d:d + nb])
        y = row if y is None else y + row
        if d:
            mir = mirpart(d, xb)
            y[:, :, d:] += mir[:, :, :nb - d]
    return y.reshape(K, S, nb * B)


def sym_band_matvec_int8_ref(upper: Tensor, scales: Tensor, x: Tensor) -> Tensor:
    """Plain PyTorch version of the int8 kernel: y = R x per cohort, in f32.

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


def _diag_ref(upper: Tensor, x: Tensor) -> Tensor:
    K, nb, nslot, B, _ = upper.shape
    acc = torch.promote_types(upper.dtype, torch.float32)
    xb = x.to(acc).reshape(K, x.shape[1], nb, B)

    def rowpart(d, xw):
        return torch.einsum("knpq,ksnq->ksnp", upper[:, :, d].to(acc), xw)

    def mirpart(d, xs):
        return torch.einsum("knpq,ksnp->ksnq", upper[:, :, d].to(acc), xs)

    return _band_sum(xb, nslot - 1, rowpart, mirpart)


def sym_band_matvec_ref(upper: Tensor, x: Tensor) -> Tensor:
    """Plain PyTorch version of the float-block kernel.

    upper (K, nb, hb+1, B, B) and x (K, S, nb*B) in one of bfloat16,
    float32, float64 -> y in f32 (f64 for f64 blocks). Products and sums
    are taken in the output type: a float32 block times a float32 x is a
    true float32 product (the TPU's matrix unit truncates f32 operands to
    bf16 at its default precision; this port does not)."""
    return _diag_ref(upper, x)


def _x_windows(xb: Tensor, hb: int) -> Tensor:
    """(K, S, nb, B) -> (K, S, nb, (hb+1)*B): row i holds x_i .. x_{i+hb},
    zeros past the end (a view of the zero-padded x)."""
    K, S, nb, B = xb.shape
    xpad = torch.cat([xb, xb.new_zeros(K, S, hb, B)], dim=2)
    return xpad.reshape(K, S, (nb + hb) * B).unfold(2, (hb + 1) * B, B)


def _slab_ref(upper: Tensor, x: Tensor) -> Tensor:
    K, nb, rows, B = upper.shape
    hb = rows // B - 1
    acc = torch.promote_types(upper.dtype, torch.float32)
    xb = x.to(acc).reshape(K, x.shape[1], nb, B)
    T = upper.to(acc)
    # row part: y_i[p] = sum_w T_i[w, p] xwin_i[w], one product per block row
    y = torch.einsum("knwp,ksnw->ksnp", T, _x_windows(xb, hb))
    for d in range(1, hb + 1):
        # mirror part: y_{i+d}[q] += sum_p T_i[d*B + q, p] x_i[p]
        mir = torch.einsum("knqp,ksnp->ksnq", T[:, :, d * B:(d + 1) * B], xb)
        y[:, :, d:] += mir[:, :, :nb - d]
    return y.reshape(K, x.shape[1], nb * B)


def sym_slab_matvec_streamed_ref(upper: Tensor, rows_per_step: int, x: Tensor) -> Tensor:
    """Plain PyTorch version of the streamed slab kernel.

    upper (K, nb, (hb+1)*B, B) slabs T_i[d*B + q, p] = U[i, d][p, q] and
    x (K, S, nb*B) in one of bfloat16, float32, float64 -> y in f32 (f64
    for f64 slabs). The row part is one product of T_i with the
    (hb+1)*B window of x (blocks past the matrix end are zeros by
    from_band's invariant); the mirror part contracts both operands over
    their last axis. rows_per_step is checked and otherwise unused."""
    _gather_rows(upper, x.shape[1], rows_per_step)
    return _slab_ref(upper, x)


def sym_slab_matvec_resident_ref(upper: Tensor, rows_per_step: int, x: Tensor) -> Tensor:
    """Plain PyTorch version of the resident slab kernel: the same sums as
    sym_slab_matvec_streamed_ref, from the same storage (the two kernels
    differ in how often they read a block, not in what they add)."""
    _resident_rows(upper, x.shape[1], rows_per_step)
    return _slab_ref(upper, x)


def _window_ref(upper: Tensor, x: Tensor) -> Tensor:
    K, nb, nslot, B, _ = upper.shape
    hb = nslot - 1
    ni = nb - hb            # interior block rows
    if hb < 1 or ni <= 0:
        return _diag_ref(upper, x)
    acc = torch.promote_types(upper.dtype, torch.float32)
    S = x.shape[1]
    xb = x.to(acc).reshape(K, S, nb, B)
    U = upper.to(acc)
    y = xb.new_zeros(K, S, nb, B)
    # W_i[d*B + q, p] = U[i, d][p, q]: the window's operand
    W = U[:, :ni].transpose(-1, -2).reshape(K, ni, (hb + 1) * B, B)
    y[:, :, :ni] = torch.einsum("knwp,ksnw->ksnp", W, _x_windows(xb, hb)[:, :, :ni])
    for d in range(hb + 1):
        last = nb - d       # block rows i with i + d inside the matrix
        if last > ni:       # edge rows, per diagonal
            y[:, :, ni:last] += torch.einsum("knpq,ksnq->ksnp", U[:, ni:last, d],
                                             xb[:, :, ni + d:])
        if d:
            y[:, :, d:] += torch.einsum("knpq,ksnp->ksnq", U[:, :last, d], xb[:, :, :last])
    return y.reshape(K, S, nb * B)


def sym_band_matvec_resident_ref(upper: Tensor, rows_per_step: int, x: Tensor) -> Tensor:
    """Plain PyTorch version of the resident diag kernel.

    upper (K, nb, hb+1, B, B) and x (K, S, nb*B) in one of bfloat16,
    float32, float64 -> y in f32 (f64 for f64 blocks). Every block adds its
    row term into y_i and its mirror term into y_{i+d}: the sums of
    sym_band_matvec_ref (the two kernels differ in how often they read a
    block, not in what they add). rows_per_step is checked and otherwise
    unused."""
    _resident_rows(upper, x.shape[1], rows_per_step)
    return _diag_ref(upper, x)


def sym_band_matvec_window_ref(upper: Tensor, rows_per_step: int, x: Tensor) -> Tensor:
    """Plain PyTorch version of the resident diag kernel with window=True:
    the row part of the interior block rows (i + hb < nb) is one product
    over the (hb+1)*B window of x, and per diagonal on the last hb rows."""
    _resident_rows(upper, x.shape[1], rows_per_step)
    return _window_ref(upper, x)


def _unpack4(packed: Tensor):
    """(..., B, B/2) int8 bytes -> (lo, hi) f32 halves (..., B, B/2): the
    sign-extended low nibble (column j) and high nibble (column j + B/2)."""
    p32 = packed.to(torch.int32)
    lo = ((p32 & 0xF) ^ 8) - 8
    hi = p32 >> 4          # arithmetic shift of the sign-extended byte
    return lo.float(), hi.float()


def _packed_ref(upper: Tensor, scales: Tensor, x: Tensor, hybrid: bool) -> Tensor:
    K, nb, nslot, B, Bh = upper.shape
    hb = nslot - (2 if hybrid else 1)
    xb = x.float().reshape(K, x.shape[1], nb, B)

    def halves(d):
        if hybrid and d == 0:   # int8 column halves in slots 0, 1
            return upper[:, :, 0].float(), upper[:, :, 1].float()
        return _unpack4(upper[:, :, d + 1 if hybrid else d])

    def rowscale(d):            # (K, 1, nb, B) on the block's row axis p
        return scales[:, None, :, (d + 1 if hybrid and d else d)]

    def rowpart(d, xw):
        lo, hi = halves(d)
        out = (torch.einsum("knpj,ksnj->ksnp", lo, xw[..., :Bh])
               + torch.einsum("knpj,ksnj->ksnp", hi, xw[..., Bh:]))
        out = out * rowscale(d)
        if d == 0:              # the stripped unit diagonal
            out = out + xw
        return out

    def mirpart(d, xs):
        lo, hi = halves(d)
        # the per-row scale sits on the contraction axis: it is folded into
        # x, and that product is rounded to bf16 as the TPU kernel does
        xsc = (xs * rowscale(d)).to(torch.bfloat16).float()
        return torch.cat([torch.einsum("knpj,ksnp->ksnj", lo, xsc),
                          torch.einsum("knpj,ksnp->ksnj", hi, xsc)], dim=-1)

    return _band_sum(xb, hb, rowpart, mirpart)


def sym_band_matvec_int4_ref(upper: Tensor, scales: Tensor, x: Tensor) -> Tensor:
    """Plain PyTorch version of the int4 kernel.

    upper (K, nb, hb+1, B, B/2) int8 (two nibbles a byte), scales
    (K, nb, hb+1, B) f32 per block row, x (K, S, nb*B) bf16 -> y f32. Row
    part: the f32 dot is scaled per output row, and x is added for d = 0.
    Mirror part: bf16(x * scale) is contracted with the unscaled block."""
    return _packed_ref(upper, scales, x, hybrid=False)


def sym_band_matvec_hybrid_ref(upper: Tensor, scales: Tensor, x: Tensor) -> Tensor:
    """Plain PyTorch version of the hybrid kernel.

    upper (K, nb, hb+2, B, B/2) int8: slots 0, 1 the d=0 block's int8
    column halves, slot d+1 diagonal d >= 1 as int4; scales (K, nb, hb+2, B)
    f32 per block row; x (K, S, nb*B) bf16 -> y f32."""
    return _packed_ref(upper, scales, x, hybrid=True)


# ---------------------------------------------------------------------------
# wrappers: the CUDA kernel on a CUDA tensor, the plain version on the CPU
# ---------------------------------------------------------------------------

def _check_x(x: Tensor, K: int, M: int, dtype: torch.dtype) -> None:
    if x.dtype != dtype or x.dim() != 3 or x.shape[0] != K or x.shape[2] != M:
        raise ValueError(f"x must be ({K}, S, {M}) {str(dtype).split('.')[-1]}")


def _check_quantized(upper: Tensor, scales: Tensor, x: Tensor,
                     block_shape, scale_shape, what: str) -> None:
    if upper.dtype != torch.int8 or upper.dim() != 5 or not block_shape(upper):
        raise ValueError(f"upper must be {what} int8")
    want = scale_shape(upper)
    if scales.dtype != torch.float32 or tuple(scales.shape) != want:
        raise ValueError(f"scales must be {want} float32")
    if not (upper.device == scales.device == x.device):
        raise ValueError("upper, scales and x must be on one device")


def _launch(wrapper, library: str, entry: str, x: Tensor, tensors, dims,
            B: int, out_dtype: torch.dtype) -> Tensor:
    """Launch one band kernel on x's CUDA device and count the launch on
    `wrapper`. tensors: the device arrays before y in the C signature;
    dims: the ints after y."""
    if x.device.type != "cuda":
        raise ValueError(f"no band kernel for device {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("upper, scales and x must be contiguous")
    S = x.shape[1]
    if B not in (64, 128, 256) or not 1 <= S <= 4:
        raise ValueError(f"the band kernels take B in (64, 128, 256) and "
                         f"S in 1..4, got B={B}, S={S}")
    from sgvamp_torch.ops._build import load_library

    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(load_library(library), entry)(
            *[t.data_ptr() for t in tensors], y.data_ptr(), *dims, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: kernel launch failed (error {err})")
    wrapper.launches += 1
    return y


def sym_band_matvec_int8(upper: Tensor, scales: Tensor, x: Tensor) -> Tensor:
    """y = R x per cohort; arguments as for sym_band_matvec_int8_ref.

    CUDA tensors go through the CUDA kernel (or raise), CPU tensors through
    the plain version. `sym_band_matvec_int8.launches` counts kernel
    launches.
    """
    _check_quantized(upper, scales, x, lambda u: u.shape[-1] == u.shape[-2],
                     lambda u: tuple(u.shape[:3]), "(K, nb, hb+1, B, B)")
    K, nb, nslot, B, _ = upper.shape
    _check_x(x, K, nb * B, torch.bfloat16)
    if x.device.type == "cpu":
        return sym_band_matvec_int8_ref(upper, scales, x)
    return _launch(sym_band_matvec_int8, "sym_band_int8", "sgv_sym_band_int8_matvec",
                   x, (upper, scales, x), (K, nb, nslot - 1, B, x.shape[1]), B,
                   torch.float32)


def sym_band_matvec(upper: Tensor, x: Tensor) -> Tensor:
    """y = R x per cohort over float blocks; arguments as for
    sym_band_matvec_ref. `sym_band_matvec.launches` counts kernel launches."""
    if (upper.dtype not in _FLOAT_CODES or upper.dim() != 5
            or upper.shape[-1] != upper.shape[-2]):
        raise ValueError("upper must be (K, nb, hb+1, B, B) bfloat16, float32 "
                         "or float64")
    K, nb, nslot, B, _ = upper.shape
    _check_x(x, K, nb * B, upper.dtype)
    if upper.device != x.device:
        raise ValueError("upper and x must be on one device")
    if x.device.type == "cpu":
        return sym_band_matvec_ref(upper, x)
    return _launch(sym_band_matvec, "sym_band_float", "sgv_sym_band_float_matvec",
                   x, (upper, x),
                   (K, nb, nslot - 1, B, x.shape[1], _FLOAT_CODES[upper.dtype]), B,
                   torch.promote_types(upper.dtype, torch.float32))


def _half_blocks(u: Tensor) -> bool:
    return u.shape[-2] == 2 * u.shape[-1]


def sym_band_matvec_int4(upper: Tensor, scales: Tensor, x: Tensor) -> Tensor:
    """y = R x per cohort over int4 blocks; arguments as for
    sym_band_matvec_int4_ref. `sym_band_matvec_int4.launches` counts kernel
    launches."""
    _check_quantized(upper, scales, x, _half_blocks, lambda u: tuple(u.shape[:4]),
                     "(K, nb, hb+1, B, B/2)")
    K, nb, nslot, B, _ = upper.shape
    _check_x(x, K, nb * B, torch.bfloat16)
    if x.device.type == "cpu":
        return sym_band_matvec_int4_ref(upper, scales, x)
    return _launch(sym_band_matvec_int4, "sym_band_int4", "sgv_sym_band_int4_matvec",
                   x, (upper, scales, x), (K, nb, nslot - 1, B, x.shape[1]), B,
                   torch.float32)


def sym_band_matvec_hybrid(upper: Tensor, scales: Tensor, x: Tensor) -> Tensor:
    """y = R x per cohort over hybrid int8/int4 blocks; arguments as for
    sym_band_matvec_hybrid_ref. `sym_band_matvec_hybrid.launches` counts
    kernel launches."""
    _check_quantized(upper, scales, x,
                     lambda u: _half_blocks(u) and u.shape[2] >= 2,
                     lambda u: tuple(u.shape[:4]), "(K, nb, hb+2, B, B/2)")
    K, nb, nslot, B, _ = upper.shape
    _check_x(x, K, nb * B, torch.bfloat16)
    if x.device.type == "cpu":
        return sym_band_matvec_hybrid_ref(upper, scales, x)
    return _launch(sym_band_matvec_hybrid, "sym_band_hybrid",
                   "sgv_sym_band_hybrid_matvec", x, (upper, scales, x),
                   (K, nb, nslot - 2, B, x.shape[1]), B, torch.float32)


# the kernels over float blocks that give one warp one block row: what a CTA
# of G block rows may ask for on an H100 (csrc/sym_band_tile.cuh)
SHARED_MEMORY_BYTES = 232448
MAX_ROWS_PER_CTA = 16


def _geometry(upper: Tensor) -> tuple:
    """(K, nb, hb, B) of float blocks in diag (5-D) or slab (4-D) layout."""
    if upper.dim() == 5:
        return upper.shape[0], upper.shape[1], upper.shape[2] - 1, upper.shape[-1]
    return upper.shape[0], upper.shape[1], upper.shape[2] // upper.shape[3] - 1, upper.shape[3]


def _acc_bytes(storage_bytes: int) -> int:
    return 8 if storage_bytes == 8 else 4


def _run_shared_bytes(G: int, hb: int, B: int, S: int, storage_bytes: int) -> int:
    """Shared memory of a resident kernel's CTA: x of G + 2*hb block rows,
    the run's row sums, and hb slots of mirror sums, S lanes each."""
    return S * B * (G * (hb + 2) + 2 * hb) * _acc_bytes(storage_bytes)


def _resident_rows(upper: Tensor, S: int, rows_per_step: int) -> int:
    """Block rows a CTA of a resident kernel takes: rows_per_step where it
    is given (it must divide nb, as in the JAX package, and fit the card),
    else the most that fit; raises ValueError where none does."""
    _, nb, hb, B = _geometry(upper)
    nbytes = upper.element_size()
    if rows_per_step:
        G = rows_per_step
        if nb % G:
            raise ValueError(f"rows_per_step={G} must divide nb={nb}")
        if G > MAX_ROWS_PER_CTA or _run_shared_bytes(G, hb, B, S, nbytes) > SHARED_MEMORY_BYTES:
            raise ValueError(
                f"rows_per_step={G} is too much for a resident kernel's CTA (at most "
                f"{MAX_ROWS_PER_CTA} block rows and {SHARED_MEMORY_BYTES} bytes of shared "
                f"memory; hb={hb}, B={B}, S={S} need "
                f"{_run_shared_bytes(G, hb, B, S, nbytes)})")
        return G
    if not SymBandedLD.fits_shared_memory(hb, B, S, nbytes):
        raise ValueError(
            f"the resident kernel does not fit this operator (hb={hb}, B={B}, S={S}, "
            f"{nbytes}-byte blocks: {SymBandedLD.resident_rows(hb, B, S, nbytes)} block rows "
            f"in {SHARED_MEMORY_BYTES} bytes of shared memory); use mode='streamed' or 'auto'")
    return SymBandedLD.resident_rows(hb, B, S, nbytes)


def _gather_rows(upper: Tensor, S: int, rows_per_step: int) -> int:
    """Block rows (warps) a CTA of the streamed slab kernel takes.
    rows_per_step is checked as the JAX package checks its chunk (it must
    divide nb and be >= hb); the kernel carries nothing between block rows,
    so any count up to MAX_ROWS_PER_CTA whose x window fits will do."""
    _, nb, hb, B = _geometry(upper)
    G = rows_per_step
    if G and (nb % G or G < hb):
        raise ValueError(f"rows_per_step={G} must divide nb={nb} and be >= hb={hb}")
    acc = _acc_bytes(upper.element_size())
    for g in (16, 8, 4, 2, 1):
        if g <= (G or 8) and S * B * (2 * g + 2 * hb) * acc <= SHARED_MEMORY_BYTES:
            return g
    raise ValueError(f"hb={hb}, B={B}, S={S}: the x window of one block row does not fit "
                     f"{SHARED_MEMORY_BYTES} bytes of shared memory")


def _check_float(upper: Tensor, x: Tensor, slab: bool) -> None:
    ok = (upper.dim() == 4 and upper.shape[2] % upper.shape[3] == 0 if slab
          else upper.dim() == 5 and upper.shape[-1] == upper.shape[-2])
    if upper.dtype not in _FLOAT_CODES or not ok:
        raise ValueError("upper must be "
                         + ("(K, nb, (hb+1)*B, B)" if slab else "(K, nb, hb+1, B, B)")
                         + " bfloat16, float32 or float64")
    K, nb, _, B = _geometry(upper)
    _check_x(x, K, nb * B, upper.dtype)
    if upper.device != x.device:
        raise ValueError("upper and x must be on one device")


def _launch_rows(wrapper, library: str, upper: Tensor, x: Tensor, G: int) -> Tensor:
    K, nb, hb, B = _geometry(upper)
    return _launch(wrapper, library, f"sgv_{library}_matvec", x, (upper, x),
                   (K, nb, hb, B, x.shape[1], G, _FLOAT_CODES[upper.dtype]), B,
                   torch.promote_types(upper.dtype, torch.float32))


def sym_slab_matvec_streamed(upper: Tensor, rows_per_step: int, x: Tensor) -> Tensor:
    """y = R x per cohort over float slabs, streamed flavor; arguments as
    for sym_slab_matvec_streamed_ref. `sym_slab_matvec_streamed.launches`
    counts kernel launches."""
    _check_float(upper, x, slab=True)
    G = _gather_rows(upper, x.shape[1], rows_per_step)
    if x.device.type == "cpu":
        return sym_slab_matvec_streamed_ref(upper, rows_per_step, x)
    return _launch_rows(sym_slab_matvec_streamed, "sym_slab_streamed", upper, x, G)


def sym_slab_matvec_resident(upper: Tensor, rows_per_step: int, x: Tensor) -> Tensor:
    """y = R x per cohort over float slabs, resident flavor; arguments as
    for sym_slab_matvec_resident_ref. Raises ValueError where the run of
    block rows does not fit a CTA's shared memory.
    `sym_slab_matvec_resident.launches` counts kernel launches."""
    _check_float(upper, x, slab=True)
    G = _resident_rows(upper, x.shape[1], rows_per_step)
    if x.device.type == "cpu":
        return sym_slab_matvec_resident_ref(upper, rows_per_step, x)
    return _launch_rows(sym_slab_matvec_resident, "sym_slab_resident", upper, x, G)


def sym_band_matvec_resident(upper: Tensor, rows_per_step: int, x: Tensor) -> Tensor:
    """y = R x per cohort over float blocks in diag layout, resident
    flavor; arguments as for sym_band_matvec_resident_ref.
    `sym_band_matvec_resident.launches` counts kernel launches."""
    _check_float(upper, x, slab=False)
    G = _resident_rows(upper, x.shape[1], rows_per_step)
    if x.device.type == "cpu":
        return sym_band_matvec_resident_ref(upper, rows_per_step, x)
    return _launch_rows(sym_band_matvec_resident, "sym_band_resident", upper, x, G)


def sym_band_matvec_window(upper: Tensor, rows_per_step: int, x: Tensor) -> Tensor:
    """sym_band_matvec_resident for an operator with window=True. On the
    card both run the kernel of csrc/sym_band_resident.cu (its header says
    why the flag changes nothing there); this wrapper keeps a launch count
    of its own, `sym_band_matvec_window.launches`."""
    _check_float(upper, x, slab=False)
    G = _resident_rows(upper, x.shape[1], rows_per_step)
    if x.device.type == "cpu":
        return sym_band_matvec_window_ref(upper, rows_per_step, x)
    return _launch_rows(sym_band_matvec_window, "sym_band_resident", upper, x, G)


BAND_KERNELS = (sym_band_matvec_int8, sym_band_matvec, sym_band_matvec_int4,
                sym_band_matvec_hybrid, sym_slab_matvec_streamed,
                sym_band_matvec_resident, sym_band_matvec_window,
                sym_slab_matvec_resident)
for _w in BAND_KERNELS:
    _w.launches = 0


def band_kernel_of(op: "SymBandedLD", S: int = 2) -> tuple:
    """(wrapper, plain version, their arguments before x, dtype of x) for
    the operator's storage, layout and mode, routed as the JAX operator's
    matvec routes; S lanes a cohort decide what "auto" fits."""
    resident = op._use_resident(S)    # raises for a quantized resident operator
    G = op.rows_per_step
    if not resident and G and (op.nb % G or G < op.hb):
        raise ValueError(f"rows_per_step={G} must divide nb={op.nb} and be >= hb={op.hb}")
    if op.hybrid:
        return (sym_band_matvec_hybrid, sym_band_matvec_hybrid_ref,
                (op.upper, op.scales), torch.bfloat16)
    if op.packed:
        return (sym_band_matvec_int4, sym_band_matvec_int4_ref,
                (op.upper, op.scales), torch.bfloat16)
    if op.quantized:
        return (sym_band_matvec_int8, sym_band_matvec_int8_ref,
                (op.upper, op.scales), torch.bfloat16)
    xdt = op.upper.dtype
    if op.layout == "slab":
        if resident:
            return sym_slab_matvec_resident, sym_slab_matvec_resident_ref, (op.upper, G), xdt
        return sym_slab_matvec_streamed, sym_slab_matvec_streamed_ref, (op.upper, G), xdt
    if resident and op.window:
        return sym_band_matvec_window, sym_band_matvec_window_ref, (op.upper, G), xdt
    if resident:
        return sym_band_matvec_resident, sym_band_matvec_resident_ref, (op.upper, G), xdt
    return sym_band_matvec, sym_band_matvec_ref, (op.upper,), xdt


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SymBandedLD:
    """Symmetric block-banded LD operator.

    upper: upper-triangle block diagonals, in one of the storage types of
    the module docstring. scales: None for float blocks, (K, nb, hb+1) f32
    for int8, (K, nb, nslot, B) f32 per block row for int4 (`packed`) and
    hybrid (`hybrid`). layout: "diag" ((K, nb, hb+1, B, B) blocks) or
    "slab" ((K, nb, (hb+1)*B, B) stacked transposes, float blocks only).
    mode: "auto" takes the resident kernel where fits_shared_memory says
    its run of block rows fits a CTA and the streamed kernel above that;
    "resident" and "streamed" force one (tests, A/B timing). rows_per_step:
    block rows a CTA of a resident kernel takes (0: the most that fit; it
    must divide nb); for a streamed kernel it is checked as the JAX package
    checks its chunk and otherwise only shapes the slab kernel's launch.
    window: the resident diag kernel's row part as one product over the
    (hb+1)*B window of x. Same matvec contract as the other operators: x is
    (S*K, M).
    """

    upper: Tensor
    scales: Optional[Tensor] = None
    packed: bool = False
    hybrid: bool = False
    s: float = 0.0
    rows_per_step: int = 0
    window: bool = False
    layout: str = "diag"
    mode: str = "auto"

    def __post_init__(self) -> None:
        if self.packed and self.hybrid:
            raise ValueError("packed (int4) and hybrid storage exclude each other")
        if self.layout not in ("diag", "slab"):
            raise ValueError(f"layout must be 'diag' or 'slab', got {self.layout!r}")
        if self.mode not in ("auto", "resident", "streamed"):
            raise ValueError(f"mode must be 'auto', 'resident' or 'streamed', got {self.mode!r}")
        if self.upper.dtype == torch.int8:
            if self.scales is None:
                raise ValueError("int8, int4 and hybrid storage need scales")
            if self.layout == "slab":
                raise ValueError("quantization supports the diag layout only")
        elif self.upper.dtype not in _FLOAT_CODES or self.packed or self.hybrid:
            raise ValueError(f"unsupported SymBandedLD storage: {self.upper.dtype}")
        if self.upper.dim() != (4 if self.layout == "slab" else 5):
            raise ValueError(f"{self.layout} layout needs "
                             f"{4 if self.layout == 'slab' else 5}-dimensional blocks, "
                             f"got {tuple(self.upper.shape)}")

    @property
    def K(self) -> int:
        return self.upper.shape[0]

    @property
    def nb(self) -> int:
        return self.upper.shape[1]

    @property
    def hb(self) -> int:
        if self.layout == "slab":
            return self.upper.shape[2] // self.upper.shape[3] - 1
        if self.hybrid:
            return self.upper.shape[2] - 2  # slots 0, 1 both hold d=0
        return self.upper.shape[2] - 1

    @property
    def B(self) -> int:
        if self.packed or self.hybrid:
            return self.upper.shape[-1] * 2
        return self.upper.shape[-1]

    @property
    def M(self) -> int:
        return self.nb * self.B

    @property
    def quantized(self) -> bool:
        """int8 per-block quantized storage (int4 is `packed` and the
        int8/int4 mix is `hybrid` instead)."""
        return (self.upper.dtype == torch.int8 and not self.packed
                and not self.hybrid)

    def bytes_per_pass(self) -> int:
        """Bytes of LD blocks and scales one matvec needs (roofline
        accounting; the kernels' actual HBM reads are in PERF.md)."""
        n = self.upper.numel() * self.upper.element_size()
        if self.scales is not None:
            n += self.scales.numel() * self.scales.element_size()
        return n

    @staticmethod
    def resident_rows(hb: int, B: int, S: int = 2, storage_bytes: int = 2) -> int:
        """Block rows G (8, 4, 2 or 1; 0 for none) a resident kernel's CTA
        can take: the most whose x (G + 2*hb block rows), row sums (G) and
        mirror sums (hb*G), S lanes of B accumulator words each (4 bytes,
        8 for float64 blocks), fit the 232,448 bytes of shared memory a
        CTA can use on an H100."""
        for g in (8, 4, 2, 1):
            if _run_shared_bytes(g, hb, B, S, storage_bytes) <= SHARED_MEMORY_BYTES:
                return g
        return 0

    @staticmethod
    def fits_shared_memory(hb: int, B: int, S: int = 2, storage_bytes: int = 2) -> bool:
        """The size rule of mode="auto" on this card: whether a resident
        kernel's run is long enough to read fewer bytes than the streamed
        gather. A run of G block rows reads 1 + hb/(2G) of the stored
        blocks (its neighbour's last rows once more), the gather
        (2hb+1)/(hb+1), so the resident kernel is taken when
        2 * resident_rows(...) > hb + 1, with 232,448 bytes of shared
        memory a CTA. The rule does not depend on M: no CTA holds more
        than its run."""
        return 2 * SymBandedLD.resident_rows(hb, B, S, storage_bytes) > hb + 1

    def _use_resident(self, S: int) -> bool:
        if self.upper.dtype == torch.int8:
            if self.mode == "resident":
                raise ValueError(
                    "quantized SymBandedLD has no resident kernel "
                    "(dequant lives in the streamed flavor); use "
                    "mode='streamed' or 'auto'")
            return False
        if self.mode == "resident":
            return True
        if self.mode == "streamed":
            return False
        return SymBandedLD.fits_shared_memory(self.hb, self.B, S,
                                              self.upper.element_size())

    def matvec(self, x: Tensor) -> Tensor:
        S = x.shape[0] // self.K
        # (K, S, M) lanes in bf16 for the quantized storages, in the block
        # dtype for float blocks; the caller's x stays unrounded for the
        # regularization term below.
        kernel, _, args, comp = band_kernel_of(self, S)
        xs = x.reshape(S, self.K, self.M).transpose(0, 1).to(comp).contiguous()
        y = kernel(*args, xs).transpose(0, 1).reshape(x.shape).to(x.dtype)
        if self.s != 0.0:
            y = (1.0 - self.s) * y + self.s * x
        return y

    def _dequantized_d0(self) -> Tensor:
        """(K, nb, B, B) f32 d=0 blocks of R (before the s-regularization)."""
        if self.hybrid:
            D = torch.cat([self.upper[:, :, 0], self.upper[:, :, 1]], dim=-1).float()
        elif self.packed:
            D = torch.cat(_unpack4(self.upper[:, :, 0]), dim=-1)
        else:
            if self.layout == "slab":   # T_i rows [0, B) hold U[i, 0]^T
                D = self.upper[:, :, :self.B].transpose(-1, -2).float()
            else:
                D = self.upper[:, :, 0].float()
            if self.quantized:
                D = D * self.scales[:, :, 0, None, None]
            return D
        D = D * self.scales[:, :, 0, :, None]          # per row (p axis)
        return D + torch.eye(self.B, dtype=D.dtype, device=D.device)

    def diag_blocks(self) -> Tensor:
        """(K, nb, B, B) f32 regularized diagonal blocks of Rused (for the
        block-Jacobi preconditioner, core/precond.py). from_band stores the
        full diagonal block at d=0, so this is exact."""
        D = self._dequantized_d0()
        if self.s != 0.0:
            eye = torch.eye(self.B, dtype=D.dtype, device=D.device)
            D = (1.0 - self.s) * D + self.s * eye
        return D

    @staticmethod
    def from_band(band: np.ndarray, block_size: int, K: int = 1,
                  s: float = 0.0, dtype=None, layout: str = "diag",
                  mesh=None, device=None) -> "SymBandedLD":
        """Pack symmetric band storage (M, 2*bw+1) into upper blocks.

        dtype: None (the default) for the band's own float dtype, or
        "float32", "float64", "bfloat16", "int8", "int4", "hybrid".
        layout: "diag", or "slab" for float blocks
        (T_i[d*B + q, p] = U[i, d][p, q]). The blocks are bit-identical to
        sgvamp_tpu's SymBandedLD.from_band (its numpy path). M is padded
        up to a block multiple with an identity diagonal on the padded
        markers, which callers mask. The tensors go to `device` (None: the
        default CUDA device).
        """
        if mesh is not None:
            raise NotImplementedError("the sharded matvec is not ported (ROADMAP A14)")
        if layout not in ("diag", "slab"):
            raise ValueError(f"layout must be 'diag' or 'slab', got {layout!r}")
        band = np.asarray(band)
        name = _dtype_name(dtype if dtype is not None else band.dtype)
        if name in ("int8", "int4", "hybrid") and layout == "slab":
            raise ValueError("quantization supports the diag layout only")
        device = resolve_device(device)
        scales = None
        if name in ("int8", "int4", "hybrid"):
            packer = {"int8": pack_int8, "int4": pack_int4, "hybrid": pack_hybrid}[name]
            upper, scales = packer(band, block_size)
        else:
            # bfloat16 is rounded to nearest even from the f32 blocks, below
            upper = pack_blocks(band, block_size,
                                np.float32 if name == "bfloat16" else np.dtype(name))
        if layout == "slab":
            nb, nslot, B, _ = upper.shape
            upper = np.ascontiguousarray(upper.transpose(0, 1, 3, 2)).reshape(nb, nslot * B, B)
        upper_t = torch.from_numpy(upper)
        if name == "bfloat16":
            upper_t = upper_t.to(torch.bfloat16)

        def stack(t):   # one copy per cohort, made on the device
            return t.to(device)[None].repeat(K, *([1] * t.dim())).contiguous()

        return SymBandedLD(upper=stack(upper_t),
                           scales=None if scales is None else stack(torch.from_numpy(scales)),
                           packed=name == "int4", hybrid=name == "hybrid", s=s,
                           layout=layout)

    def to_dense(self) -> Tensor:
        """Materialize (K, M, M) on the CPU - tests only. f32 for the
        quantized and bf16 storages, else the blocks' dtype."""
        K, nb, hbp1, B = self.K, self.nb, self.hb + 1, self.B
        up = self.upper.cpu()
        sc = None if self.scales is None else self.scales.cpu().numpy()
        if self.hybrid or self.packed:
            far = up[:, :, 2:] if self.hybrid else up[:, :, 1:]
            far_sc = sc[:, :, 2:] if self.hybrid else sc[:, :, 1:]
            far = torch.cat(_unpack4(far), dim=-1).numpy() * far_sc[..., None]
            d0 = dataclasses.replace(self, upper=up, scales=self.scales.cpu(),
                                     s=0.0)._dequantized_d0().numpy()
            up = np.concatenate([d0[:, :, None], far], axis=2)
        elif self.quantized:
            up = up.float().numpy() * sc[..., None, None]
        elif up.dtype == torch.bfloat16:
            up = up.float().numpy()
        else:
            up = up.numpy()
        if self.layout == "slab":
            up = up.reshape(K, nb, hbp1, B, B).transpose(0, 1, 2, 4, 3)
        out = np.zeros((K, self.M, self.M), dtype=up.dtype)
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


# ---------------------------------------------------------------------------
# numpy packers (the numpy path of sgvamp_tpu's from_band, step for step,
# so that the bits agree)
# ---------------------------------------------------------------------------

def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    if isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    if name not in ("float32", "float64", "bfloat16", "int8", "int4", "hybrid"):
        raise ValueError(f"unsupported SymBandedLD dtype: {dtype!r}")
    return name


def pack_blocks(band: np.ndarray, B: int, out_dtype=np.float32) -> np.ndarray:
    """(M, 2*bw+1) band -> (nb, hb+1, B, B) upper blocks in out_dtype.

    M is padded to a block multiple with an identity diagonal; blocks
    whose columns run past the matrix are forced to exact zero, so the
    kernels need no edge masking even on adversarial input."""
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
    upper = np.zeros((nb, hb + 1, B, B), dtype=out_dtype)
    p = np.arange(B)[:, None]
    q = np.arange(B)[None, :]
    for d in range(hb + 1):
        col = bw + d * B + q - p
        valid = (col >= 0) & (col < nd_full)
        colc = np.clip(col, 0, nd_full - 1)
        vals = np.take_along_axis(band_r, colc[None, :, :], axis=2)
        upper[:, d] = np.where(valid[None], vals, 0.0)
    for d in range(1, hb + 1):
        upper[nb - d:, d] = 0.0
    return upper


def pack_int8(band: np.ndarray, B: int):
    """(M, 2*bw+1) band -> (upper (nb, hb+1, B, B) int8, scales (nb, hb+1) f32):
    f32 blocks, then per-block symmetric quantization (zero blocks get
    scale 0)."""
    upper = pack_blocks(band, B, np.float32)
    amax = np.abs(upper).max(axis=(-2, -1))  # (nb, hb+1)
    sc = amax / 127.0
    safe = np.where(sc == 0.0, 1.0, sc)
    q8 = np.clip(np.rint(upper / safe[..., None, None]), -127, 127).astype(np.int8)
    return q8, sc.astype(np.float32)


def _quantize_rows(blocks: np.ndarray, levels: float, out_dtype):
    """Per-row symmetric quantization of (..., B, B) f32 blocks: returns
    (q (..., B, B) out_dtype, scales (..., B) f32), scale = max|row| / levels."""
    sc = np.abs(blocks).max(axis=-1) / np.float32(levels)
    safe = np.where(sc == 0.0, 1.0, sc)
    q = np.rint(blocks / safe[..., None])
    np.clip(q, -levels, levels, out=q)
    return q.astype(out_dtype), sc.astype(np.float32)


def _pack_nibbles(q: np.ndarray) -> np.ndarray:
    """(..., B, B) int8 values in [-7, 7] -> (..., B, B/2) int8 bytes: low
    nibble column j, high nibble column j + B/2."""
    Bh = q.shape[-1] // 2
    u = q.view(np.uint8)
    return ((u[..., :Bh] & 0xF) | (u[..., Bh:] << 4)).view(np.int8)


def _stripped_blocks(band: np.ndarray, B: int, what: str) -> np.ndarray:
    if B % 2:
        raise ValueError(f"{what} packing needs an even block size")
    upper = pack_blocks(band, B, np.float32)
    upper[:, 0] -= np.eye(B, dtype=upper.dtype)   # the kernel adds x back
    return upper


def pack_int4(band: np.ndarray, B: int):
    """(M, 2*bw+1) band -> (upper (nb, hb+1, B, B/2) int8, scales
    (nb, hb+1, B) f32): unit diagonal of d=0 stripped, per-row scales
    max|row| / 7, two values a byte as contiguous column halves."""
    q, sc = _quantize_rows(_stripped_blocks(band, B, "int4"), 7.0, np.int8)
    return _pack_nibbles(q), sc


def pack_hybrid(band: np.ndarray, B: int):
    """(M, 2*bw+1) band -> (upper (nb, hb+2, B, B/2) int8, scales
    (nb, hb+2, B) f32): d=0 as int8 column halves in slots 0, 1 (per-row
    scales max|row| / 127, diagonal stripped), d >= 1 as int4 in slot d+1."""
    upper = _stripped_blocks(band, B, "hybrid")
    Bh = B // 2
    q0, sc0 = _quantize_rows(upper[:, 0], 127.0, np.int8)
    qf, scf = _quantize_rows(upper[:, 1:], 7.0, np.int8)
    del upper
    packed = np.concatenate([q0[:, None, :, :Bh], q0[:, None, :, Bh:],
                             _pack_nibbles(qf)], axis=1)
    scales = np.concatenate([sc0[:, None], sc0[:, None], scf], axis=1)
    return packed, scales
