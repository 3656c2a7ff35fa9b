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
(SymBandedLD.mode), and both read each stored block once and take both its
terms. "streamed" keeps only a run's own mirror sums on chip and hands the
mirror sums that cross into the next run to a second, short launch through
a scratch of partial sums, so it takes any band; the int8 kernel does the
same (int4 and hybrid gather: one CTA an output block row, which reads
every off-diagonal slot twice). Where the runs alone would put few warps
on the card (a band of few block rows and many diagonals), the int8 and
the float streamed kernels cut it into tiles of G block rows and D
diagonals (_int8_tiles, _float_tiles, _slab_tiles). "resident" keeps the x
and y of a run of block rows in a CTA's shared memory, reads the
neighbour's last blocks again for the mirror terms that cross into its
run, and is limited by that shared memory
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

The sharded matvec. An operator that parallel/sharding.py::shard_inputs
has cut over a (cohort, shard) mesh holds one piece per mesh cell (its
block rows nb/n at a time, on the cell's device) and runs
SymBandedLD._matvec_sharded: each cell gets its slice of x with the next
cell's first hb blocks appended (the halo), runs the SPILL form of its
streamed kernel, which returns (y_l, carry) - carry being the mirror terms
of the cell's blocks that land in the next cell's first hb block rows - and
the caller adds each carry into the head of the next cell's y_l. The spill
forms are second entry points of the same sources (spill=True in the TPU
kernels), with wrappers, plain versions and launch counts of their own:

  sym_band_matvec_int8_spill      csrc/sym_band_int8.cu
  sym_band_matvec_spill           csrc/sym_band_float.cu
  sym_band_matvec_int4_spill      csrc/sym_band_int4.cu
  sym_band_matvec_hybrid_spill    csrc/sym_band_hybrid.cu
  sym_slab_matvec_streamed_spill  csrc/sym_slab_streamed.cu
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import logging
import re
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import Tensor

from sgvamp_torch import native, resolve_device
from sgvamp_torch.utils.profiling import span

logger = logging.getLogger("sgvamp")
_FLOAT_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
_FLOAT_NAMES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float64": torch.float64}


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _band_sum(xb: Tensor, hb: int, rowpart: Callable, mirpart: Callable,
              halo: Optional[Tensor] = None):
    """y_i = sum_d rowpart(d, x_{i+d}) + sum_{d>=1} mirpart(d, x_{i-d})[i-d].

    xb (K, S, nb, B); rowpart(d, xw) and mirpart(d, xb) return (K, S, nb, B)
    contributions indexed by the block row that STORES the block.

    halo None: the whole operator; x past its end is zeros and mirror terms
    past it are dropped. halo (K, S, hb, B), the next shard's first hb x
    blocks: the spill form of one shard. The row part reads the halo, and
    the mirror terms that land past the local end, block (i, d) into row
    i + d - nb, are summed into a carry: returns (y, carry (K, S,
    max(hb, 1)*B))."""
    K, S, nb, B = xb.shape
    spill = halo is not None
    xpad = torch.cat([xb, halo if spill else xb.new_zeros(K, S, hb, B)], dim=2)
    carry = xb.new_zeros(K, S, max(hb, 1), B)
    y = None
    for d in range(hb + 1):
        row = rowpart(d, xpad[:, :, d:d + nb])
        y = row if y is None else y + row
        if d:
            mir = mirpart(d, xb)
            y[:, :, d:] += mir[:, :, :nb - d]
            carry[:, :, :d] += mir[:, :, nb - d:]
    y = y.reshape(K, S, nb * B)
    return (y, carry.reshape(K, S, -1)) if spill else y


def _own_and_halo(x: Tensor, nb: int, hb: int, B: int, spill: bool) -> tuple:
    """(x as (K, S, nb, B) blocks, halo): halo None for the whole operator,
    else the (K, S, hb, B) blocks that follow the shard's own in a
    halo-extended x. What lies past the halo is ignored (the JAX package
    pads the halo to a whole chunk of its kernel)."""
    K, S = x.shape[:2]
    own = x[:, :, :nb * B].reshape(K, S, nb, B)
    if not spill:
        return own, None
    return own, x[:, :, nb * B:(nb + hb) * B].reshape(K, S, hb, B)


def _int8_ref(upper: Tensor, scales: Tensor, x: Tensor, spill: bool):
    K, nb, nslot, B, _ = upper.shape
    xb, halo = _own_and_halo(x.float(), nb, nslot - 1, B, spill)

    def scale(d):                                        # (K, 1, nb, 1)
        return scales[:, None, :, d, None]

    def rowpart(d, xw):
        # y_i[p] += sc[i,d] sum_q U[i,d][p,q] x_{i+d}[q]
        return scale(d) * torch.einsum("knpq,ksnq->ksnp", upper[:, :, d].float(), xw)

    def mirpart(d, xs):
        # y_{i+d}[q] += sc[i,d] sum_p U[i,d][p,q] x_i[p]
        return scale(d) * torch.einsum("knpq,ksnp->ksnq", upper[:, :, d].float(), xs)

    return _band_sum(xb, nslot - 1, rowpart, mirpart, halo)


def sym_band_matvec_int8_ref(upper: Tensor, scales: Tensor, x: Tensor) -> Tensor:
    """Plain PyTorch version of the int8 kernel: y = R x per cohort, in f32.

    upper (K, nb, hb+1, B, B) int8, scales (K, nb, hb+1) f32, x (K, S, nb*B)
    bf16 -> y (K, S, nb*B) f32. Each block's dot is taken in f32 and then
    scaled, as in the kernel.
    """
    return _int8_ref(upper, scales, x, spill=False)


def sym_band_matvec_int8_spill_ref(upper: Tensor, scales: Tensor, x: Tensor) -> tuple:
    """Plain PyTorch version of the int8 kernel's spill form: one shard's
    (y_l (K, S, nb*B), carry (K, S, max(hb, 1)*B)) in f32 from its nb block
    rows and x (K, S, (nb+hb)*B or longer) bf16, the shard's x followed by
    the next shard's first hb blocks (_band_sum)."""
    return _int8_ref(upper, scales, x, spill=True)


def _diag_ref(upper: Tensor, x: Tensor, spill: bool = False):
    K, nb, nslot, B, _ = upper.shape
    acc = torch.promote_types(upper.dtype, torch.float32)
    xb, halo = _own_and_halo(x.to(acc), nb, nslot - 1, B, spill)

    def rowpart(d, xw):
        return torch.einsum("knpq,ksnq->ksnp", upper[:, :, d].to(acc), xw)

    def mirpart(d, xs):
        return torch.einsum("knpq,ksnp->ksnq", upper[:, :, d].to(acc), xs)

    return _band_sum(xb, nslot - 1, rowpart, mirpart, halo)


def sym_band_matvec_ref(upper: Tensor, x: Tensor) -> Tensor:
    """Plain PyTorch version of the float-block kernel.

    upper (K, nb, hb+1, B, B) and x (K, S, nb*B) in one of bfloat16,
    float32, float64 -> y in f32 (f64 for f64 blocks). Products and sums
    are taken in the output type: a float32 block times a float32 x is a
    true float32 product (the TPU's matrix unit truncates f32 operands to
    bf16 at its default precision; this port does not)."""
    return _diag_ref(upper, x)


def sym_band_matvec_spill_ref(upper: Tensor, x: Tensor) -> tuple:
    """Plain PyTorch version of the float-block kernel's spill form: one
    shard's (y_l, carry) in f32 (f64 for f64 blocks) from its nb block rows
    and x (K, S, (nb+hb)*B or longer) in the block dtype, halo included
    (_band_sum)."""
    return _diag_ref(upper, x, spill=True)


def _x_windows(xb: Tensor, hb: int, halo: Optional[Tensor] = None) -> Tensor:
    """(K, S, nb, B) -> (K, S, nb, (hb+1)*B): row i holds x_i .. x_{i+hb};
    past the end zeros, or the (K, S, hb, B) halo (a view of the padded x)."""
    K, S, nb, B = xb.shape
    xpad = torch.cat([xb, xb.new_zeros(K, S, hb, B) if halo is None else halo], dim=2)
    return xpad.reshape(K, S, (nb + hb) * B).unfold(2, (hb + 1) * B, B)


def _slab_ref(upper: Tensor, x: Tensor, spill: bool = False):
    K, nb, rows, B = upper.shape
    hb = rows // B - 1
    S = x.shape[1]
    acc = torch.promote_types(upper.dtype, torch.float32)
    xb, halo = _own_and_halo(x.to(acc), nb, hb, B, spill)
    T = upper.to(acc)
    # row part: y_i[p] = sum_w T_i[w, p] xwin_i[w], one product per block row
    y = torch.einsum("knwp,ksnw->ksnp", T, _x_windows(xb, hb, halo))
    carry = xb.new_zeros(K, S, max(hb, 1), B)
    for d in range(1, hb + 1):
        # mirror part: y_{i+d}[q] += sum_p T_i[d*B + q, p] x_i[p]; past the
        # local end it lands in the carry (the spill form, see _band_sum)
        mir = torch.einsum("knqp,ksnp->ksnq", T[:, :, d * B:(d + 1) * B], xb)
        y[:, :, d:] += mir[:, :, :nb - d]
        carry[:, :, :d] += mir[:, :, nb - d:]
    y = y.reshape(K, S, nb * B)
    return (y, carry.reshape(K, S, -1)) if spill else y


def sym_slab_matvec_streamed_ref(upper: Tensor, rows_per_step: int, x: Tensor) -> Tensor:
    """Plain PyTorch version of the streamed slab kernel.

    upper (K, nb, (hb+1)*B, B) slabs T_i[d*B + q, p] = U[i, d][p, q] and
    x (K, S, nb*B) in one of bfloat16, float32, float64 -> y in f32 (f64
    for f64 slabs). The row part is one product of T_i with the
    (hb+1)*B window of x (blocks past the matrix end are zeros by
    from_band's invariant); the mirror part contracts both operands over
    their last axis. rows_per_step is checked as the JAX package checks it
    (_check_chunk) and otherwise unused."""
    _check_chunk(upper, rows_per_step)
    return _slab_ref(upper, x)


def sym_slab_matvec_streamed_spill_ref(upper: Tensor, rows_per_step: int, x: Tensor) -> tuple:
    """Plain PyTorch version of the streamed slab kernel's spill form: one
    shard's (y_l, carry) from its nb slabs and x (K, S, (nb+hb)*B or longer)
    in the block dtype, halo included. The window of the last hb block rows
    reaches into the halo; the mirror terms past the local end are the
    carry (K, S, max(hb, 1)*B). rows_per_step as for
    sym_slab_matvec_streamed_ref."""
    _check_chunk(upper, rows_per_step)
    return _slab_ref(upper, x, spill=True)


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


def _packed_ref(upper: Tensor, scales: Tensor, x: Tensor, hybrid: bool,
                spill: bool = False):
    K, nb, nslot, B, Bh = upper.shape
    hb = nslot - (2 if hybrid else 1)
    xb, halo = _own_and_halo(x.float(), nb, hb, B, spill)

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

    return _band_sum(xb, hb, rowpart, mirpart, halo)


def sym_band_matvec_int4_ref(upper: Tensor, scales: Tensor, x: Tensor) -> Tensor:
    """Plain PyTorch version of the int4 kernel.

    upper (K, nb, hb+1, B, B/2) int8 (two nibbles a byte), scales
    (K, nb, hb+1, B) f32 per block row, x (K, S, nb*B) bf16 -> y f32. Row
    part: the f32 dot is scaled per output row, and x is added for d = 0.
    Mirror part: bf16(x * scale) is contracted with the unscaled block."""
    return _packed_ref(upper, scales, x, hybrid=False)


def sym_band_matvec_int4_spill_ref(upper: Tensor, scales: Tensor, x: Tensor) -> tuple:
    """Plain PyTorch version of the int4 kernel's spill form: one shard's
    (y_l, carry) in f32 from its nb block rows and x (K, S, (nb+hb)*B or
    longer) bf16, halo included; the carry's mirror terms round
    bf16(x * scale) as all mirror terms do."""
    return _packed_ref(upper, scales, x, hybrid=False, spill=True)


def sym_band_matvec_hybrid_ref(upper: Tensor, scales: Tensor, x: Tensor) -> Tensor:
    """Plain PyTorch version of the hybrid kernel.

    upper (K, nb, hb+2, B, B/2) int8: slots 0, 1 the d=0 block's int8
    column halves, slot d+1 diagonal d >= 1 as int4; scales (K, nb, hb+2, B)
    f32 per block row; x (K, S, nb*B) bf16 -> y f32."""
    return _packed_ref(upper, scales, x, hybrid=True)


def sym_band_matvec_hybrid_spill_ref(upper: Tensor, scales: Tensor, x: Tensor) -> tuple:
    """Plain PyTorch version of the hybrid kernel's spill form: one shard's
    (y_l, carry) in f32, as sym_band_matvec_int4_spill_ref."""
    return _packed_ref(upper, scales, x, hybrid=True, spill=True)


# ---------------------------------------------------------------------------
# wrappers: the CUDA kernel on a CUDA tensor, the plain version on the CPU
# ---------------------------------------------------------------------------

def _check_x(x: Tensor, K: int, nb: int, hb: int, B: int, dtype: torch.dtype,
             spill: bool = False) -> Tensor:
    """x as the kernel takes it. The whole operator: (K, S, nb*B). The
    spill form: (K, S, (nb+hb)*B), the shard's x and the halo; a longer x
    is cut there (the JAX package pads the halo to a whole chunk of its
    kernel), and a shard narrower than hb is refused, since halo and carry
    reach one neighbour only."""
    name = str(dtype).split(".")[-1]
    if not spill:
        if x.dtype != dtype or x.dim() != 3 or x.shape[0] != K or x.shape[2] != nb * B:
            raise ValueError(f"x must be ({K}, S, {nb * B}) {name}")
        return x
    if nb < hb:
        raise ValueError(f"the spill form needs a shard of at least hb={hb} block rows, got {nb}")
    Mx = (nb + hb) * B
    if x.dtype != dtype or x.dim() != 3 or x.shape[0] != K or x.shape[2] < Mx:
        raise ValueError(f"x must be ({K}, S, {Mx} or more: the shard's x and a halo of "
                         f"{hb} blocks) {name}")
    return x if x.shape[2] == Mx else x[:, :, :Mx].contiguous()


def _check_quantized(upper: Tensor, scales: Tensor, x: Tensor,
                     block_shape, scale_shape, what: str) -> None:
    if upper.dtype != torch.int8 or upper.dim() != 5 or not block_shape(upper):
        raise ValueError(f"upper must be {what} int8")
    want = scale_shape(upper)
    if scales.dtype != torch.float32 or tuple(scales.shape) != want:
        raise ValueError(f"scales must be {want} float32")
    if not (upper.device == scales.device == x.device):
        raise ValueError("upper, scales and x must be on one device")


def _launch(wrapper, library: str, x: Tensor, tensors, dims, B: int,
            out_dtype: torch.dtype, spill_hb: Optional[int] = None,
            partials: Optional[tuple] = None):
    """Run one band kernel's pass on x's CUDA device and count it on
    `wrapper`. tensors: the device arrays before y in the C signature;
    dims: the ints after the outputs. spill_hb None: the library's
    `matvec` entry, returns y shaped as x. spill_hb = hb: its `spill`
    entry over a halo-extended x, returns (y_l, carry). partials: the shape
    of the streamed kernels' scratch (_partials_shape), allocated here in
    y's type and passed after the outputs."""
    if x.device.type != "cuda":
        raise ValueError(f"no band kernel for device {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("upper, scales and x must be contiguous")
    K, S, Mx = x.shape
    if B not in (64, 128, 256) or not 1 <= S <= 4:
        raise ValueError(f"the band kernels take B in (64, 128, 256) and "
                         f"S in 1..4, got B={B}, S={S}")
    from sgvamp_torch.ops._build import VARIANTS, load_library

    stem = VARIANTS.get(library, (library,))[0]   # the source's entry names
    if spill_hb is None:
        entry = f"sgv_{stem}_matvec"
        outs = (torch.empty(x.shape, dtype=out_dtype, device=x.device),)
    else:
        entry = f"sgv_{stem}_spill"
        y = torch.empty((K, S, Mx - spill_hb * B), dtype=out_dtype, device=x.device)
        # the kernel writes all of the carry, except that hb = 0 has none
        carry = (torch.empty((K, S, spill_hb * B), dtype=out_dtype, device=x.device)
                 if spill_hb else torch.zeros((K, S, B), dtype=out_dtype, device=x.device))
        outs = (y, carry)
    if partials is not None:
        outs += (torch.empty(partials, dtype=out_dtype, device=x.device),)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(load_library(library), entry)(
            *[t.data_ptr() for t in tensors], *[o.data_ptr() for o in outs], *dims, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: kernel launch failed (error {err})")
    wrapper.launches += 1
    return outs[0] if spill_hb is None else outs[:2]


def _int8(wrapper, plain, upper: Tensor, scales: Tensor, x: Tensor, spill: bool):
    """The int8 wrappers' body: `plain` on CPU tensors, else the kernel (a
    pass of the read-once kernel over tiles of G block rows and D diagonals,
    and its fold of the partial sums, counted once), counted on `wrapper`.
    The matvec form takes the tiles of _int8_tiles, the spill form runs of
    _int8_runs with every diagonal (D = hb + 1)."""
    _check_quantized(upper, scales, x, lambda u: u.shape[-1] == u.shape[-2],
                     lambda u: tuple(u.shape[:3]), "(K, nb, hb+1, B, B)")
    K, nb, nslot, B, _ = upper.shape
    hb = nslot - 1
    x = _check_x(x, K, nb, hb, B, torch.bfloat16, spill)
    if x.device.type == "cpu":
        return plain(upper, scales, x)
    S = x.shape[1]
    sms = _sm_count(x.device)
    G, D = (_int8_runs(nb, sms), hb + 1) if spill else _int8_tiles(nb, hb, sms)
    return _launch(wrapper, _int8_library, x, (upper, scales, x),
                   (K, nb, hb, B, S, G, D), B, torch.float32, hb if spill else None,
                   partials=_partials_shape(K, S, nb, hb, G, B, spill, D))


# the library the int8 wrappers launch: its build that counts block bytes
# while int8_block_bytes runs
_int8_library = "sym_band_int8"


def int8_block_bytes(fn: Callable[[], Any]) -> int:
    """The bytes of int8 blocks that the int8 kernel copies from device
    memory while fn() runs, counted by the kernel itself: fn's int8 passes
    (either wrapper) launch the build of csrc/sym_band_int8.cu that counts
    them (ops/_build.py VARIANTS; the same kernel, the same results), and
    the count is read once the device has finished."""
    from sgvamp_torch.ops._build import load_library

    global _int8_library
    lib = load_library("sym_band_int8_counted")
    count = ctypes.c_ulonglong(0)
    if err := lib.sgv_sym_band_int8_block_bytes(ctypes.addressof(count), 1):
        raise RuntimeError(f"sgv_sym_band_int8_block_bytes failed (error {err})")
    _int8_library = "sym_band_int8_counted"
    try:
        fn()
    finally:
        _int8_library = "sym_band_int8"
    if err := lib.sgv_sym_band_int8_block_bytes(ctypes.addressof(count), 1):
        raise RuntimeError(f"sgv_sym_band_int8_block_bytes failed (error {err})")
    return count.value


def sym_band_matvec_int8(upper: Tensor, scales: Tensor, x: Tensor) -> Tensor:
    """y = R x per cohort; arguments as for sym_band_matvec_int8_ref.

    CUDA tensors go through the CUDA kernel (or raise), CPU tensors through
    the plain version. `sym_band_matvec_int8.launches` counts kernel
    launches.
    """
    return _int8(sym_band_matvec_int8, sym_band_matvec_int8_ref, upper, scales, x, False)


def sym_band_matvec_int8_spill(upper: Tensor, scales: Tensor, x: Tensor) -> tuple:
    """One shard's (y_l, carry); arguments as for
    sym_band_matvec_int8_spill_ref. `sym_band_matvec_int8_spill.launches`
    counts kernel launches."""
    return _int8(sym_band_matvec_int8_spill, sym_band_matvec_int8_spill_ref, upper, scales, x,
                 True)


def _float(wrapper, plain, upper: Tensor, x: Tensor, spill: bool):
    """As _int8, for the float-block wrappers of the diag layout, over the
    tiles of _float_tiles."""
    x = _check_float(upper, x, slab=False, spill=spill)
    if x.device.type == "cpu":
        return plain(upper, x)
    K, nb, hb, B = _geometry(upper)
    S = x.shape[1]
    G, D = _float_tiles(nb, hb, _sm_count(x.device), spill)
    return _launch(wrapper, "sym_band_float", x, (upper, x),
                   (K, nb, hb, B, S, G, D, _FLOAT_CODES[upper.dtype]), B,
                   torch.promote_types(upper.dtype, torch.float32), hb if spill else None,
                   partials=_partials_shape(K, S, nb, hb, G, B, spill, D))


def sym_band_matvec(upper: Tensor, x: Tensor) -> Tensor:
    """y = R x per cohort over float blocks; arguments as for
    sym_band_matvec_ref. `sym_band_matvec.launches` counts kernel launches."""
    return _float(sym_band_matvec, sym_band_matvec_ref, upper, x, False)


def sym_band_matvec_spill(upper: Tensor, x: Tensor) -> tuple:
    """One shard's (y_l, carry) over float blocks; arguments as for
    sym_band_matvec_spill_ref. `sym_band_matvec_spill.launches` counts
    kernel launches."""
    return _float(sym_band_matvec_spill, sym_band_matvec_spill_ref, upper, x, True)


def _half_blocks(u: Tensor) -> bool:
    return u.shape[-2] == 2 * u.shape[-1]


def _packed(wrapper, plain, upper: Tensor, scales: Tensor, x: Tensor, hybrid: bool,
            spill: bool):
    """As _int8, for the int4 and the hybrid wrappers."""
    if hybrid:
        _check_quantized(upper, scales, x,
                         lambda u: _half_blocks(u) and u.shape[2] >= 2,
                         lambda u: tuple(u.shape[:4]), "(K, nb, hb+2, B, B/2)")
    else:
        _check_quantized(upper, scales, x, _half_blocks, lambda u: tuple(u.shape[:4]),
                         "(K, nb, hb+1, B, B/2)")
    K, nb, nslot, B, _ = upper.shape
    hb = nslot - (2 if hybrid else 1)
    x = _check_x(x, K, nb, hb, B, torch.bfloat16, spill)
    if x.device.type == "cpu":
        return plain(upper, scales, x)
    return _launch(wrapper, "sym_band_hybrid" if hybrid else "sym_band_int4", x,
                   (upper, scales, x), (K, nb, hb, B, x.shape[1]), B, torch.float32,
                   hb if spill else None)


def sym_band_matvec_int4(upper: Tensor, scales: Tensor, x: Tensor) -> Tensor:
    """y = R x per cohort over int4 blocks; arguments as for
    sym_band_matvec_int4_ref. `sym_band_matvec_int4.launches` counts kernel
    launches."""
    return _packed(sym_band_matvec_int4, sym_band_matvec_int4_ref, upper, scales, x,
                   False, False)


def sym_band_matvec_int4_spill(upper: Tensor, scales: Tensor, x: Tensor) -> tuple:
    """One shard's (y_l, carry) over int4 blocks; arguments as for
    sym_band_matvec_int4_spill_ref. `sym_band_matvec_int4_spill.launches`
    counts kernel launches."""
    return _packed(sym_band_matvec_int4_spill, sym_band_matvec_int4_spill_ref, upper,
                   scales, x, False, True)


def sym_band_matvec_hybrid(upper: Tensor, scales: Tensor, x: Tensor) -> Tensor:
    """y = R x per cohort over hybrid int8/int4 blocks; arguments as for
    sym_band_matvec_hybrid_ref. `sym_band_matvec_hybrid.launches` counts
    kernel launches."""
    return _packed(sym_band_matvec_hybrid, sym_band_matvec_hybrid_ref, upper, scales, x,
                   True, False)


def sym_band_matvec_hybrid_spill(upper: Tensor, scales: Tensor, x: Tensor) -> tuple:
    """One shard's (y_l, carry) over hybrid blocks; arguments as for
    sym_band_matvec_hybrid_spill_ref. `sym_band_matvec_hybrid_spill.launches`
    counts kernel launches."""
    return _packed(sym_band_matvec_hybrid_spill, sym_band_matvec_hybrid_spill_ref, upper,
                   scales, x, True, True)


# the band kernels as a device trace (torch.profiler, cli.main --profile-dir)
# names them: a kernel event's name is its demangled __global__ instantiation.
# int4 and hybrid are one template told apart by its last argument; an int8
# or float streamed pass is two launches, the kernel and fold_partials_kernel
# (an int8 or float diag pass whose tiles cut the band's diagonals:
# fold_tiles_kernel).
TRACED_KERNELS = {
    "int4": r"sym_band_packed_kernel<\d+, \d+, false>",
    "hybrid": r"sym_band_packed_kernel<\d+, \d+, true>",
    "int8": r"sym_band_int8_kernel\b",
    "fold": r"fold_(?:partials|tiles)_kernel\b",
    "float": r"sym_band_float_kernel\b",
    "resident": r"sym_band_resident_kernel\b",
    "slab-resident": r"sym_slab_resident_kernel\b",
    "slab-streamed": r"sym_slab_streamed_kernel\b",
}
_TRACED_ANY = re.compile("|".join(sorted({re.match(r"\w+", p)[0]
                                           for p in TRACED_KERNELS.values()})))


def traced_kernel_counts(names) -> dict:
    """Events of each band kernel among a trace's kernel event names, by the
    keys of TRACED_KERNELS, and under "other" the events that name a band
    kernel yet match none of them (an instantiation this table misses)."""
    names = [n for n in names if _TRACED_ANY.search(n)]
    counts = {k: sum(bool(re.search(p, n)) for n in names) for k, p in TRACED_KERNELS.items()}
    counts["other"] = sum(not any(re.search(p, n) for p in TRACED_KERNELS.values())
                          for n in names)
    return counts


# the kernels over float blocks that give one warp one block row: what a CTA
# of G block rows may ask for on an H100 (csrc/sym_band_tile.cuh)
SHARED_MEMORY_BYTES = 232448
MAX_ROWS_PER_CTA = 16
# the longest run of block rows a CTA of the streamed float diag kernel
# takes (csrc/sym_band_float.cu kMaxRunRows): its shared memory, 3 G S B
# accumulator words, fits for every B, S and type, and whatever hb is; the
# spill form always takes it
DIAG_RUN_ROWS = 8
# warps an SM that the float diag kernel's grid should hold before it cuts
# the band's diagonals into ranges: as the int8 kernel's, a warp streams its
# blocks with about 4 KB in flight (kStreamAhead row groups of 512 bytes),
# so the card needs several warps an SM to reach its rate. The bench shape
# (nb=4096, hb=2) holds 31 an SM; a dense panel's whole triangle (nb=64,
# hb=64, K=2) in runs of 8 is 16 CTAs on 132 SMs, and the warp of block
# row 0 streams 65 blocks.
FLOAT_MIN_WARPS_PER_SM = 6


# the longest run of block rows a CTA of the streamed slab kernel's matvec
# form takes (csrc/sym_slab_streamed.cu: the instances of 8 warps; the spill
# form's runs of 16 take every diagonal)
SLAB_RUN_ROWS = 8


# the int8 kernel's longest run of block rows, one warp each
# (csrc/sym_band_int8.cu kMaxRunRows)
INT8_MAX_RUN_ROWS = 8
# the most ranges the streamed diag kernels may cut the band's diagonals
# into (csrc/sym_band_tile.cuh kMaxRanges)
MAX_RANGES = 128
# warps an SM that the int8 kernel's grid should hold before it cuts the
# band's diagonals into ranges: a warp streams its blocks at a few GB/s, with
# two 2 KB chunks in flight, so the card needs several warps an SM to reach
# its rate. The bench shape (nb=4096, hb=2) holds 31 an SM over two waves,
# a 1024-row shard 7.8; a dense panel's whole triangle (nb=64, hb=64) in
# runs alone holds one warp on half the SMs.
INT8_MIN_WARPS_PER_SM = 6


def _runs(nb: int, sms: int, longest: int) -> int:
    """G, the block rows a CTA of a streamed diag kernel takes over nb block
    rows on a card of `sms` SMs: the longest run halved until it still
    gives every SM a CTA (or 1). Longer runs send fewer mirror sums through
    the scratch of partial sums; a 1024-row shard at G = 8 would leave 4 of
    an H100's 132 SMs idle."""
    G = longest
    while G > 1 and -(-nb // G) < sms:
        G //= 2
    return G


def _int8_runs(nb: int, sms: int) -> int:
    """G of the int8 kernel: _runs up to INT8_MAX_RUN_ROWS. A CTA's shared
    memory (each warp's ring of 3 chunks of 2 KB, and 3 G S B floats) is at
    most 147,456 bytes (B = 256, S = 4), so it fits at every B and S, and hb
    and the tile's diagonals do not enter."""
    return _runs(nb, sms, INT8_MAX_RUN_ROWS)


def _tile_count(nb: int, hb: int, G: int, D: int) -> int:
    """The tiles of a streamed diag kernel's matvec grid: for each run c of
    G block rows (of ceil(nb / G)), one a range of D diagonals up to the
    last that holds data in the run's first block row, min(hb, nb - 1 - c G)
    (csrc/sym_band_tile.cuh::tiles_of, which counts them by range)."""
    return sum(-(-(min(hb, nb - 1 - r0) + 1) // D) for r0 in range(0, nb, G))


def _int8_tiles(nb: int, hb: int, sms: int) -> tuple:
    """(G, D): the int8 kernel's tiles over nb block rows and hb diagonals
    past the first on a card of `sms` SMs, for the matvec form. G from
    _int8_runs; D = hb + 1, every diagonal in one range, where the runs put
    INT8_MIN_WARPS_PER_SM warps an SM on the card, else the fewest ranges J
    (D = ceil((hb + 1) / J), at most MAX_RANGES) whose tiles do, or the
    most there may be. A warp of a tile streams at most D blocks, so a band
    of few block rows and many diagonals no longer waits on the warp of its
    longest row."""
    G = _int8_runs(nb, sms)
    return G, _diagonals(nb, hb, G, INT8_MIN_WARPS_PER_SM * sms)


def _float_tiles(nb: int, hb: int, sms: int, spill: bool = False) -> tuple:
    """(G, D): the float diag kernel's tiles. The matvec form by
    _int8_tiles' rule: G from _runs up to DIAG_RUN_ROWS, D = hb + 1 where
    those runs put FLOAT_MIN_WARPS_PER_SM warps an SM on the card, else the
    fewest even ranges whose tiles do; (1, 2) on a dense M=8192 panel's
    whole triangle (nb=64, hb=64), 2112 one-warp tiles over two cohorts.
    The spill form: runs of DIAG_RUN_ROWS, every diagonal in one range."""
    if spill:
        return DIAG_RUN_ROWS, hb + 1
    G = _runs(nb, sms, DIAG_RUN_ROWS)
    return G, _diagonals(nb, hb, G, FLOAT_MIN_WARPS_PER_SM * sms)


@functools.lru_cache(maxsize=None)
def _diagonals(nb: int, hb: int, G: int, warps: int) -> int:
    """D for runs of G: the fewest ranges whose tiles hold `warps` warps
    (the count grows with the ranges: a binary search)."""
    def enough(J):
        return G * _tile_count(nb, hb, G, -(-(hb + 1) // J)) >= warps

    lo, hi = 1, min(hb + 1, MAX_RANGES)
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if enough(mid) else (mid + 1, hi)
    return -(-(hb + 1) // lo)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """SMs of a CUDA device (1 for any other: _launch refuses it)."""
    if device.type != "cuda":
        return 1
    return torch.cuda.get_device_properties(device).multi_processor_count


def _partials_shape(K: int, S: int, nb: int, hb: int, G: int, B: int, spill: bool,
                    D: Optional[int] = None) -> tuple:
    """The streamed kernels' scratch of partial sums in y's type, (K, S,
    rows, B). The mirror sums that leave a CTA's run of G block rows
    (csrc/sym_band_tile.cuh::Partials) take F hb rows: hb slots for each of
    the first min(hb, G) block rows of each run, and in the spill form for
    each of the carry's hb block rows. The streamed diag kernels' tiles (D
    diagonals of a run, csrc/sym_band_tile.cuh::Scratch) leave the mirror
    sums as they are (which leave depends on the run only); when D cuts the
    diagonals into J = ceil((hb + 1) / D) > 1 ranges, no tile holds a whole
    row sum, and each stores its run's rows after the slots of its cohort
    and lane: J nb rows more."""
    F = -(-nb // G) * min(hb, G) + (hb if spill else 0)
    J = 1 if D is None else -(-(hb + 1) // D)
    return K, S, F * hb + (J * nb if J > 1 else 0), B


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


def _check_chunk(upper: Tensor, rows_per_step: int) -> None:
    """rows_per_step of a streamed slab kernel, checked as the JAX package
    checks its chunk, with its message: where it is given it must divide nb
    and be >= hb. The card's shared memory does not enter: the port's plain
    versions compute wherever the JAX kernel does."""
    _, nb, hb, _ = _geometry(upper)
    G = rows_per_step
    if G and (nb % G or G < hb):
        raise ValueError(f"rows_per_step={G} must divide nb={nb} and be >= hb={hb}")


def _slab_runs(hb: int, S: int, B: int, storage_bytes: int, rows_per_step: int = 0) -> int:
    """G of the streamed slab kernel's spill form, which takes every
    diagonal: the longest of 16, 8, 4, 2, 1 block rows (at most
    rows_per_step where it is given, else 8) whose x window fits a CTA's
    shared memory (the kernel needs S B (2 G + hb) accumulator words, within
    the S B (2 G + 2 hb) checked here). Raises ValueError where none does:
    on the card only."""
    acc = _acc_bytes(storage_bytes)
    for g in (16, 8, 4, 2, 1):
        if g <= (rows_per_step or 8) and S * B * (2 * g + 2 * hb) * acc <= SHARED_MEMORY_BYTES:
            return g
    raise ValueError(f"hb={hb}, B={B}, S={S}: the x window of one block row does not fit "
                     f"{SHARED_MEMORY_BYTES} bytes of shared memory")


def _slab_shared_bytes(G: int, D: int, S: int, B: int, storage_bytes: int) -> int:
    """Shared memory of a streamed slab kernel's CTA over a tile of G block
    rows and D diagonals: its x window of G + D - 1 block rows and the run's
    mirror sums, S lanes each (csrc/sym_slab_streamed.cu)."""
    return S * B * (2 * G + D - 1) * _acc_bytes(storage_bytes)


def _slab_tiles(nb: int, hb: int, sms: int, S: int, B: int, storage_bytes: int,
                rows_per_step: int = 0) -> tuple:
    """(G, D): the streamed slab kernel's tiles for the matvec form. Runs of
    SLAB_RUN_ROWS (at most rows_per_step where it is given) over every
    diagonal, the schedule before tiles, where their nb warps are
    FLOAT_MIN_WARPS_PER_SM an SM and their window fits: the bench shape
    (nb=4096, hb=2) and nb=1024, hb=2, where runs of 4 were 0.4-1.0% slower
    on an H100. Else G from _runs and D by the float diag kernel's rule
    (_diagonals), then cut into more even ranges, up to MAX_RANGES, until
    the tile's x window and mirror sums fit a CTA's shared memory
    (_slab_shared_bytes): (1, 2) on a dense M=8192 panel's whole triangle
    (nb=64, hb=64). Raises ValueError, with the sizes, where no D within
    MAX_RANGES fits: on the card only."""
    longest = min(SLAB_RUN_ROWS, rows_per_step or SLAB_RUN_ROWS)
    warps = FLOAT_MIN_WARPS_PER_SM * sms
    if nb >= warps and _slab_shared_bytes(longest, hb + 1, S, B,
                                          storage_bytes) <= SHARED_MEMORY_BYTES:
        return longest, hb + 1
    G = _runs(nb, sms, longest)
    J = -(-(hb + 1) // _diagonals(nb, hb, G, warps))
    # the most diagonals whose window fits beside the run's mirror sums
    fit = SHARED_MEMORY_BYTES // (S * B * _acc_bytes(storage_bytes)) - 2 * G + 1
    if fit >= 1:
        J = max(J, -(-(hb + 1) // fit))
    if fit < 1 or J > MAX_RANGES:
        raise ValueError(
            f"the streamed slab kernel has no tile for nb={nb}, hb={hb}, B={B}, S={S}, "
            f"{storage_bytes}-byte slabs: runs of G={G} leave room for {max(fit, 0)} diagonals "
            f"a tile in {SHARED_MEMORY_BYTES} bytes of shared memory, and {hb + 1} diagonals "
            f"need more than {MAX_RANGES} ranges of them")
    return G, -(-(hb + 1) // J)


def _check_float(upper: Tensor, x: Tensor, slab: bool, spill: bool = False) -> Tensor:
    """Checks float blocks against x; returns x as the kernel takes it
    (_check_x)."""
    ok = (upper.dim() == 4 and upper.shape[2] % upper.shape[3] == 0 if slab
          else upper.dim() == 5 and upper.shape[-1] == upper.shape[-2])
    if upper.dtype not in _FLOAT_CODES or not ok:
        raise ValueError("upper must be "
                         + ("(K, nb, (hb+1)*B, B)" if slab else "(K, nb, hb+1, B, B)")
                         + " bfloat16, float32 or float64")
    K, nb, hb, B = _geometry(upper)
    if upper.device != x.device:
        raise ValueError("upper and x must be on one device")
    return _check_x(x, K, nb, hb, B, upper.dtype, spill)


def _launch_rows(wrapper, library: str, upper: Tensor, x: Tensor, G: int):
    K, nb, hb, B = _geometry(upper)
    return _launch(wrapper, library, x, (upper, x),
                   (K, nb, hb, B, x.shape[1], G, _FLOAT_CODES[upper.dtype]), B,
                   torch.promote_types(upper.dtype, torch.float32))


def _slab_streamed(wrapper, plain, upper: Tensor, rows_per_step: int, x: Tensor, spill: bool):
    """As _int8, for the streamed slab wrappers: the matvec form over the
    tiles of _slab_tiles, the spill form in runs of _slab_runs over every
    diagonal. rows_per_step is checked as in the JAX package; the card's
    shared memory enters only the launch."""
    x = _check_float(upper, x, slab=True, spill=spill)
    _check_chunk(upper, rows_per_step)
    if x.device.type == "cpu":
        return plain(upper, rows_per_step, x)
    K, nb, hb, B = _geometry(upper)
    S, nbytes, code = x.shape[1], upper.element_size(), _FLOAT_CODES[upper.dtype]
    if spill:
        G, D = _slab_runs(hb, S, B, nbytes, rows_per_step), hb + 1
        dims = (K, nb, hb, B, S, G, code)
    else:
        G, D = _slab_tiles(nb, hb, _sm_count(x.device), S, B, nbytes, rows_per_step)
        dims = (K, nb, hb, B, S, G, D, code)
    return _launch(wrapper, "sym_slab_streamed", x, (upper, x), dims, B,
                   torch.promote_types(upper.dtype, torch.float32), hb if spill else None,
                   partials=_partials_shape(K, S, nb, hb, G, B, spill, D))


def sym_slab_matvec_streamed(upper: Tensor, rows_per_step: int, x: Tensor) -> Tensor:
    """y = R x per cohort over float slabs, streamed flavor; arguments as
    for sym_slab_matvec_streamed_ref. `sym_slab_matvec_streamed.launches`
    counts kernel launches."""
    return _slab_streamed(sym_slab_matvec_streamed, sym_slab_matvec_streamed_ref, upper,
                          rows_per_step, x, False)


def sym_slab_matvec_streamed_spill(upper: Tensor, rows_per_step: int, x: Tensor) -> tuple:
    """One shard's (y_l, carry) over float slabs; arguments as for
    sym_slab_matvec_streamed_spill_ref.
    `sym_slab_matvec_streamed_spill.launches` counts kernel launches."""
    return _slab_streamed(sym_slab_matvec_streamed_spill, sym_slab_matvec_streamed_spill_ref,
                          upper, rows_per_step, x, True)


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
                sym_slab_matvec_resident,
                sym_band_matvec_int8_spill, sym_band_matvec_spill,
                sym_band_matvec_int4_spill, sym_band_matvec_hybrid_spill,
                sym_slab_matvec_streamed_spill)
for _w in BAND_KERNELS:
    _w.launches = 0


def band_kernel_of(op: "SymBandedLD", S: int = 2, spill: bool = False) -> tuple:
    """(wrapper, plain version, their arguments before x, dtype of x) for
    the operator's storage, layout and mode, routed as the JAX operator's
    matvec routes; S lanes a cohort decide what "auto" fits. spill: `op` is
    one shard of a sharded operator and takes the spill form of its
    streamed kernel, whatever its mode and window say (as the JAX operator
    does under a mesh)."""
    # raises for a quantized resident operator
    resident = False if spill else op._use_resident(S)
    G = op.rows_per_step
    if not resident and G and (op.nb % G or G < op.hb):
        raise ValueError(f"rows_per_step={G} must divide nb={op.nb} and be >= hb={op.hb}")
    if op.upper.dtype == torch.int8:
        if op.hybrid:
            pair = ((sym_band_matvec_hybrid_spill, sym_band_matvec_hybrid_spill_ref) if spill
                    else (sym_band_matvec_hybrid, sym_band_matvec_hybrid_ref))
        elif op.packed:
            pair = ((sym_band_matvec_int4_spill, sym_band_matvec_int4_spill_ref) if spill
                    else (sym_band_matvec_int4, sym_band_matvec_int4_ref))
        else:
            pair = ((sym_band_matvec_int8_spill, sym_band_matvec_int8_spill_ref) if spill
                    else (sym_band_matvec_int8, sym_band_matvec_int8_ref))
        return (*pair, (op.upper, op.scales), torch.bfloat16)
    xdt = op.upper.dtype
    if spill:
        if op.layout == "slab":
            return (sym_slab_matvec_streamed_spill, sym_slab_matvec_streamed_spill_ref,
                    (op.upper, G), xdt)
        return sym_band_matvec_spill, sym_band_matvec_spill_ref, (op.upper,), xdt
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

    mesh, shards: set together by parallel/sharding.py::shard_inputs when
    the mesh divides the block rows. shards[c][j] is the piece of mesh cell
    (c, j) - cohorts c*K/n_cohort.., block rows j*nb/n_shard.. - a
    SymBandedLD of its own on that cell's device; `upper` and `scales` then
    keep the whole operator's shape and dtype without storage (meta
    tensors), and matvec runs _matvec_sharded, the spill form of the
    streamed kernel in every cell whatever mode and window say.
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
    mesh: Any = None
    shards: tuple = ()

    def __post_init__(self) -> None:
        if (self.mesh is None) != (not self.shards):
            raise ValueError("a mesh is pinned together with the operator's pieces: use "
                             "sgvamp_torch.parallel.sharding.shard_inputs")
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
        """The size rule of mode="auto" on this card, the JAX package's
        routing: the resident kernel is taken when 2 * resident_rows(...) >
        hb + 1, with 232,448 bytes of shared memory a CTA. The rule was
        drawn against a streamed gather that read (2hb+1)/(hb+1) of the
        stored blocks; a run of G block rows of the resident kernel reads
        1 + hb/(2G) (its neighbour's last rows once more), and the streamed
        kernels now read every block once plus their partial sums, so at
        every hb they read fewer bytes than the resident kernel (whether
        that makes them faster is measured in PERF.md). The rule does not
        depend on M: no CTA holds more than its run."""
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
        comp = torch.bfloat16 if self.upper.dtype == torch.int8 else self.upper.dtype
        xs = x.reshape(S, self.K, self.M).transpose(0, 1).to(comp)
        if self.mesh is not None:
            y = self._matvec_sharded(xs)
        else:
            kernel, _, args, _ = band_kernel_of(self, S)
            y = kernel(*args, xs.contiguous())
        y = y.transpose(0, 1).reshape(x.shape).to(x.dtype)
        if self.s != 0.0:
            y = (1.0 - self.s) * y + self.s * x
        return y

    def _matvec_sharded(self, xs: Tensor) -> Tensor:
        """y (K, S, M) from xs (K, S, M) over the mesh's pieces.

        One process drives every cell, in turn. Cell (c, j) gets its
        cohorts' slice of x with the next cell's first hb blocks appended
        (the halo; zeros after the last cell, the wraparound leg) on its own
        device, and runs the spill form of its streamed kernel there. The
        carry it returns - its blocks' mirror terms that land in the next
        cell's first hb block rows - moves to that cell's device and is
        added into the head of its y_l; the last cell's carry is zeros
        (blocks past the global end are) and goes nowhere. y is gathered on
        the device of xs.
        """
        n_c, n = self.mesh.devices.shape
        K_l, M_l, hbB = self.K // n_c, self.M // n, self.hb * self.B
        K, S, _ = xs.shape
        xpad = torch.cat([xs, xs.new_zeros(K, S, hbB)], dim=2) if hbB else xs
        rows = []
        for c in range(n_c):
            ys, carry = [], None
            for j in range(n):
                piece = self.shards[c][j]
                x_ext = xpad[c * K_l:(c + 1) * K_l, :, j * M_l:(j + 1) * M_l + hbB]
                kernel, _, args, _ = band_kernel_of(piece, S, spill=True)
                y_l, spilled = kernel(*args, x_ext.to(piece.upper.device).contiguous())
                if j and hbB:
                    y_l[:, :, :hbB] += carry.to(y_l.device)
                carry = spilled
                ys.append(y_l.to(xs.device))
            rows.append(torch.cat(ys, dim=2))
        return torch.cat(rows, dim=0)

    def _gathered(self) -> "SymBandedLD":
        """A sharded operator whole again, on the CPU and without its mesh
        (the inverse of shard_inputs' cut, for to_dense)."""
        def whole(field):
            return torch.cat([torch.cat([getattr(p, field).cpu() for p in row], dim=1)
                              for row in self.shards], dim=0)

        return dataclasses.replace(self, upper=whole("upper"),
                                   scales=None if self.scales is None else whole("scales"),
                                   mesh=None, shards=())

    def _dequantized_d0(self) -> Tensor:
        """(K, nb, B, B) f32 d=0 blocks of R (before the s-regularization)."""
        if self.mesh is not None:   # from the pieces, on the first cell's device
            dev = self.shards[0][0].upper.device
            return torch.cat([torch.cat([p._dequantized_d0().to(dev) for p in row], dim=1)
                              for row in self.shards], dim=0)
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
                  device=None) -> "SymBandedLD":
        """Pack symmetric band storage (M, 2*bw+1) into upper blocks.

        dtype: None (the default) for the band's own float dtype, or
        "float32", "float64", "bfloat16", "int8", "int4", "hybrid".
        layout: "diag", or "slab" for float blocks
        (T_i[d*B + q, p] = U[i, d][p, q]). The blocks are bit-identical to
        sgvamp_tpu's SymBandedLD.from_band; int8 and hybrid blocks of a
        float32 band are packed by the host C++ packer of
        sgvamp_torch.native where it builds, else by pack_int8 /
        pack_hybrid (the same bits). M is padded
        up to a block multiple with an identity diagonal on the padded
        markers, which callers mask. The tensors go to `device` (None: the
        default CUDA device).
        """
        if layout not in ("diag", "slab"):
            raise ValueError(f"layout must be 'diag' or 'slab', got {layout!r}")
        band = np.asarray(band)
        name = _dtype_name(dtype if dtype is not None else band.dtype)
        if name in ("int8", "int4", "hybrid") and layout == "slab":
            raise ValueError("quantization supports the diag layout only")
        device = resolve_device(device)
        scales = None
        with span("sgv.ingest.pack", storage=name):
            if name in ("int8", "int4", "hybrid"):
                # a float32 band packs int8 and hybrid blocks through the native
                # one-pass packer where it builds (the same bits as the numpy one)
                got = None
                if band.dtype == np.float32 and name != "int4":
                    got = (native.band_pack_i8 if name == "int8"
                           else native.band_pack_hybrid)(band, block_size)
                    logger.info(f"{name} blocks packed through the "
                                f"{'numpy' if got is None else 'native'} path")
                if got is None:
                    got = {"int8": pack_int8, "int4": pack_int4, "hybrid": pack_hybrid}[name](
                        band, block_size)
                upper, scales = got
            else:
                # bfloat16 is rounded to nearest even from the f32 blocks, below
                upper = pack_blocks(band, block_size,
                                    np.float32 if name == "bfloat16" else np.dtype(name))
            if layout == "slab":
                nb, nslot, B, _ = upper.shape
                upper = np.ascontiguousarray(upper.transpose(0, 1, 3, 2)).reshape(
                    nb, nslot * B, B)
            upper_t = torch.from_numpy(upper)
            if name == "bfloat16":
                upper_t = upper_t.to(torch.bfloat16)

        def stack(t):   # one copy per cohort, made on the device
            return t.to(device)[None].repeat(K, *([1] * t.dim())).contiguous()

        host = [upper_t] + ([] if scales is None else [torch.from_numpy(scales)])
        with span("sgv.ingest.copy", blocking=device.type == "cuda", storage=name,
                  bytes=sum(t.numel() * t.element_size() for t in host)):
            upper_d, *scales_d = [stack(t) for t in host]
        return SymBandedLD(upper=upper_d, scales=scales_d[0] if scales_d else None,
                           packed=name == "int4", hybrid=name == "hybrid", s=s,
                           layout=layout)

    def to_dense(self) -> Tensor:
        """Materialize (K, M, M) on the CPU - tests only. f32 for the
        quantized and bf16 storages, else the blocks' dtype."""
        if self.mesh is not None:
            return self._gathered().to_dense()
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
