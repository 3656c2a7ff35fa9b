"""Symmetric block-banded LD operator over upper-triangle block storage.

Only the upper-triangle block diagonals U[i, d] = R[block i, block i+d],
d = 0..hb, are stored. A matvec adds both the row part U[i,d] @ x_{i+d}
and the mirrored part U[i,d]^T @ x_i. Five storage types:

  float    (K, nb, hb+1, B, B) bfloat16 / float32 / float64 blocks, no
           scales; x is cast to the block dtype.
  int8     (K, nb, hb+1, B, B) int8, one f32 scale per block
           (q = round(U / scale), scale = max|U| / 127).
  int4     (K, nb, hb+1, B, B/2) int8 bytes holding two 4-bit values each
           (low nibble = column j, high nibble = column j + B/2), one f32
           scale per block ROW (max|row| / 7), the unit diagonal of the
           d=0 block stripped before quantizing (the matvec adds x back).
  hybrid   (K, nb, hb+2, B, B/2) int8: slots 0 and 1 are the d=0 block's
           int8 column halves (per-row scales max|row| / 127, diagonal
           stripped), slot d+1 is diagonal d >= 1 packed as int4.

The quantized types take x in bf16 and sum in f32. On a CUDA tensor each
matvec runs a hand-written kernel (csrc/sym_band_int8.cu,
sym_band_float.cu, sym_band_int4.cu, sym_band_hybrid.cu), which replace
the flavors of the TPU kernel
sgvamp_tpu/ops/band_kernel.py::_sym_band_kernel_streamed; see the sources'
headers for their design. On a CPU tensor it runs the plain PyTorch
version beside the wrapper (sym_band_matvec*_ref). The TPU package also
has a VMEM-resident kernel that serves small float panels; here every
diag-layout float operator goes through the streamed kernel's port. The
slab layout, the resident kernels and the sharded matvec are not ported
yet (ROADMAP B4, B7-B9, A14).
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


def sym_band_matvec_ref(upper: Tensor, x: Tensor) -> Tensor:
    """Plain PyTorch version of the float-block kernel.

    upper (K, nb, hb+1, B, B) and x (K, S, nb*B) in one of bfloat16,
    float32, float64 -> y in f32 (f64 for f64 blocks). Products and sums
    are taken in the output type: a float32 block times a float32 x is a
    true float32 product (the TPU's matrix unit truncates f32 operands to
    bf16 at its default precision; this port does not)."""
    K, nb, nslot, B, _ = upper.shape
    acc = torch.promote_types(upper.dtype, torch.float32)
    xb = x.to(acc).reshape(K, x.shape[1], nb, B)

    def rowpart(d, xw):
        return torch.einsum("knpq,ksnq->ksnp", upper[:, :, d].to(acc), xw)

    def mirpart(d, xs):
        return torch.einsum("knpq,ksnp->ksnq", upper[:, :, d].to(acc), xs)

    return _band_sum(xb, nslot - 1, rowpart, mirpart)


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


BAND_KERNELS = (sym_band_matvec_int8, sym_band_matvec, sym_band_matvec_int4,
                sym_band_matvec_hybrid)
for _w in BAND_KERNELS:
    _w.launches = 0


def band_kernel_of(op: "SymBandedLD") -> tuple:
    """(wrapper, plain version, their arguments before x, dtype of x) for
    the operator's storage."""
    if op.hybrid:
        return (sym_band_matvec_hybrid, sym_band_matvec_hybrid_ref,
                (op.upper, op.scales), torch.bfloat16)
    if op.packed:
        return (sym_band_matvec_int4, sym_band_matvec_int4_ref,
                (op.upper, op.scales), torch.bfloat16)
    if op.quantized:
        return (sym_band_matvec_int8, sym_band_matvec_int8_ref,
                (op.upper, op.scales), torch.bfloat16)
    return sym_band_matvec, sym_band_matvec_ref, (op.upper,), op.upper.dtype


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SymBandedLD:
    """Symmetric block-banded LD operator, diag layout.

    upper: upper-triangle block diagonals, in one of the storage types of
    the module docstring. scales: None for float blocks, (K, nb, hb+1) f32
    for int8, (K, nb, nslot, B) f32 per block row for int4 (`packed`) and
    hybrid (`hybrid`). Same matvec contract as the other operators: x is
    (S*K, M).
    """

    upper: Tensor
    scales: Optional[Tensor] = None
    packed: bool = False
    hybrid: bool = False
    s: float = 0.0

    def __post_init__(self) -> None:
        if self.packed and self.hybrid:
            raise ValueError("packed (int4) and hybrid storage exclude each other")
        if self.upper.dtype == torch.int8:
            if self.scales is None:
                raise ValueError("int8, int4 and hybrid storage need scales")
        elif self.upper.dtype not in _FLOAT_CODES or self.packed or self.hybrid:
            raise ValueError(f"unsupported SymBandedLD storage: {self.upper.dtype}")

    @property
    def K(self) -> int:
        return self.upper.shape[0]

    @property
    def nb(self) -> int:
        return self.upper.shape[1]

    @property
    def hb(self) -> int:
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

    def matvec(self, x: Tensor) -> Tensor:
        S = x.shape[0] // self.K
        # (K, S, M) lanes in bf16 for the quantized storages, in the block
        # dtype for float blocks; the caller's x stays unrounded for the
        # regularization term below.
        kernel, _, args, comp = band_kernel_of(self)
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
                  s: float = 0.0, dtype="int8", layout: str = "diag",
                  mesh=None, device=None) -> "SymBandedLD":
        """Pack symmetric band storage (M, 2*bw+1) into upper blocks.

        dtype: "int8" (the default: the main path's storage), "int4",
        "hybrid", "float32", "float64", "bfloat16", or None for the band's
        own float dtype. The blocks are
        bit-identical to sgvamp_tpu's SymBandedLD.from_band (its numpy
        path). M is padded up to a block multiple with an identity
        diagonal on the padded markers, which callers mask. The tensors go
        to `device` (None: the default CUDA device).
        """
        if layout != "diag":
            raise NotImplementedError("the slab layout is not ported (ROADMAP B7)")
        if mesh is not None:
            raise NotImplementedError("the sharded matvec is not ported (ROADMAP A14)")
        device = resolve_device(device)
        band = np.asarray(band)
        name = _dtype_name(dtype if dtype is not None else band.dtype)
        scales = None
        if name in ("int8", "int4", "hybrid"):
            packer = {"int8": pack_int8, "int4": pack_int4, "hybrid": pack_hybrid}[name]
            upper, scales = packer(band, block_size)
            upper_t = torch.from_numpy(upper)
        elif name == "bfloat16":
            # round-to-nearest-even from the f32 blocks
            upper_t = torch.from_numpy(pack_blocks(band, block_size, np.float32)
                                       ).to(torch.bfloat16)
        else:
            upper_t = torch.from_numpy(pack_blocks(band, block_size, np.dtype(name)))

        def stack(t):   # one copy per cohort, made on the device
            return t.to(device)[None].repeat(K, *([1] * t.dim())).contiguous()

        return SymBandedLD(upper=stack(upper_t),
                           scales=None if scales is None else stack(torch.from_numpy(scales)),
                           packed=name == "int4", hybrid=name == "hybrid", s=s)

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
