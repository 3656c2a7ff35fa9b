"""Device-memory read-bandwidth probe (Triton).

Replaces sgvamp_tpu/ops/membench.py::_read_kernel. The denominator of a
bandwidth-bound kernel's roofline share has to be a bandwidth-bound
measurement itself, so the probe does the cheapest work per byte there
is: it streams the array and keeps a running elementwise max over a
1024-wide accumulator (the TPU probe's (8, 128) tile).

The Triton kernel runs P programs; program p folds a contiguous run of
1024-wide rows into its own accumulator row, seeded from row p of the
previous pass's output, so repeated passes are chained by a data
dependence. The (P, 1024) partials fold to the (8, 128) result with one
small max. Timing n and 2n chained passes with CUDA events and taking the
difference removes launch and fill costs, as the TPU probe does.

On the card a byte-sized array (the int8 LD blocks) is read as its own
bytes through a view as int32; the bf16 stand-in the TPU probe uses is a
Mosaic workaround that does not apply here.
"""

from __future__ import annotations

import functools

import torch
from torch import Tensor

_LANES = 8 * 128
_ROWS = 8  # rows of 1024 that one program loads per step


def _prep(u: Tensor, chunk_bytes: int = 4 << 20, max_bytes: int = 1 << 30) -> Tensor:
    """Flatten and truncate to whole chunks, as the TPU probe does (so
    read_max covers the same elements): chunk_bytes chunks, at most
    max_bytes, at least one 1024-wide row. Byte-sized dtypes become an
    int32 view of the same bytes."""
    flat = u.reshape(-1)
    if flat.element_size() == 1:
        flat = flat[: min(flat.numel(), max_bytes) // 4 * 4].view(torch.int32)
    elif flat.numel() * flat.element_size() > max_bytes:
        flat = flat[: max_bytes // flat.element_size()]
    chunk = max(_LANES, (chunk_bytes // flat.element_size()) // _LANES * _LANES)
    n_chunks = flat.numel() // chunk
    if n_chunks == 0:
        chunk, n_chunks = flat.numel() // _LANES * _LANES, 1
    if chunk == 0:
        raise ValueError(f"array too small to probe ({flat.numel()} elements)")
    return flat[: n_chunks * chunk]


def _lowest(dtype: torch.dtype) -> float:
    return -float("inf") if dtype.is_floating_point else torch.iinfo(dtype).min


def read_max_ref(u: Tensor) -> Tensor:
    """Plain PyTorch version: the (8, 128) elementwise max over the probed
    1024-wide rows of u."""
    flat = _prep(u)
    return torch.amax(flat.reshape(-1, _LANES), dim=0).reshape(8, 128)


def _programs(n_rows: int, device: torch.device) -> tuple:
    """(P, rows per program): about four programs per SM, each over a run
    of rows that is a multiple of _ROWS."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per = -(-n_rows // (4 * sms))
    per = -(-per // _ROWS) * _ROWS
    return -(-n_rows // per), per


def _read_kernel(u_ptr, a_ptr, o_ptr, n_rows, rows_per_prog,
                 ROWS: tl.constexpr, LANES: tl.constexpr):
    # Triton kernel body, compiled by _jit_read_kernel: program p folds
    # rows [p*rows_per_prog, (p+1)*rows_per_prog) of the (n_rows, LANES)
    # array into row p of a_ptr and writes the result to row p of o_ptr.
    pid = tl.program_id(0)
    cols = tl.arange(0, LANES)
    acc = tl.load(a_ptr + pid * LANES + cols)
    r0 = pid * rows_per_prog
    r_end = tl.minimum(r0 + rows_per_prog, n_rows)
    for r in range(r0, r_end, ROWS):
        rows = r + tl.arange(0, ROWS)
        ok = rows[:, None] < r_end
        x = tl.load(u_ptr + rows[:, None].to(tl.int64) * LANES + cols[None, :],
                    mask=ok, other=0)
        x = tl.where(ok, x, acc[None, :])
        # max is exact in any type; cast back so the carried type stays put
        acc = tl.maximum(acc, tl.max(x, axis=0)).to(acc.dtype)
    tl.store(o_ptr + pid * LANES + cols, acc)


@functools.lru_cache(maxsize=None)
def _jit_read_kernel():
    # Triton is imported here, at first launch, so that the module imports
    # without it; the kernel body finds `tl` among this module's globals.
    global tl
    import triton
    import triton.language as tl

    return triton.jit(_read_kernel)


def _read_once(flat: Tensor, part: Tensor, rows_per_prog: int) -> Tensor:
    """One pass of the Triton probe: (P, 1024) partial maxima seeded from
    `part`. `_read_once.launches` counts kernel launches."""
    n_rows = flat.numel() // _LANES
    out = torch.empty_like(part)
    _jit_read_kernel()[(part.shape[0],)](flat, part, out, n_rows, rows_per_prog,
                                         ROWS=_ROWS, LANES=_LANES, num_warps=8)
    _read_once.launches += 1
    return out


_read_once.launches = 0


def _check_cuda(flat: Tensor) -> None:
    if flat.device.type != "cuda":
        raise ValueError(f"no read-probe kernel for device {flat.device}")
    if not flat.is_contiguous():
        raise ValueError("the read probe needs a contiguous array")


def read_max(u: Tensor) -> Tensor:
    """The (8, 128) running max the probe computes, as one pass (the
    correctness hook). CPU tensors take read_max_ref; CUDA tensors run the
    Triton kernel or raise."""
    if u.device.type == "cpu":
        return read_max_ref(u)
    flat = _prep(u)
    _check_cuda(flat)
    P, per = _programs(flat.numel() // _LANES, flat.device)
    seed = torch.full((P, _LANES), _lowest(flat.dtype), dtype=flat.dtype,
                      device=flat.device)
    part = _read_once(flat, seed, per)
    return torch.amax(part, dim=0).reshape(8, 128)


def measure_read_gbps(u: Tensor, n: int = 32, reps: int = 4):
    """Measured device-memory read rate over u's probed bytes.

    Times chains of n and 2n passes with CUDA events, the minimum of
    `reps` runs each, and differences them. Each timed chain waits behind a
    device sleep of twice its enqueue time (utils/kernel_bench.py::_once),
    so that the events time the card's reads back to back, not the host's
    launches (at a few MB a pass those are the slower). Needs a CUDA tensor:
    there is no CPU number to give. Returns (GB/s, seconds per pass).
    """
    from sgvamp_torch.utils.kernel_bench import _enqueue_s, _once

    flat = _prep(u)
    _check_cuda(flat)
    nbytes = flat.numel() * flat.element_size()
    P, per = _programs(flat.numel() // _LANES, flat.device)
    seed = torch.full((P, _LANES), _lowest(flat.dtype), dtype=flat.dtype,
                      device=flat.device)

    def chain(k):
        part = seed
        for _ in range(k):
            part = _read_once(flat, part, per)
        return part

    def timed(k):
        # _enqueue_s runs the chain twice: the warm-up (and Triton's compile
        # on the first call), then the enqueue it times
        sleep_s = _enqueue_s(lambda: chain(k), flat.device)
        return min(_once(lambda: chain(k), flat.device, sleep_s) for _ in range(reps))

    t_n, t_2n = timed(n), timed(2 * n)
    per_pass = max((t_2n - t_n) / n, 1e-12)
    return nbytes / per_pass / 1e9, per_pass
