"""A/B timing of the LD-operator kernels (PyTorch port of
tools/kernel_bench.py).

    python -m sgvamp_torch.utils.kernel_bench [--M 524288] [--bandwidth 256]
        [--B 256] [--K 1] [--S 2] [--passes 50] [--dtype bfloat16]
        [--variants resident8,streamed8,slab,einsum,memread] [--cg]
        [--platform cpu]

Times chained matvec passes (each pass's output is the next one's input),
n and 2n of them, and takes the difference over n, so that launch and fill
costs cancel. On a CUDA device the chains are timed with CUDA events; with
--platform cpu the host clock times the plain PyTorch versions, and the
lines say "device": "cpu" (not a device number). PyTorch runs eagerly:
there is no compile to warm.

Variant grammar, as the JAX tool's: einsum | [slab](resident|streamed|
window)?[G]: `einsum` is BandedLD, anything else SymBandedLD in diag or
slab layout, with mode forced to resident (`window`: resident with
window=True) or streamed, or left "auto", and G = rows_per_step. `memread`
is the read probe of sgvamp_torch.ops.membench over the diag blocks.

Prints one JSON line per variant: {"variant": ..., "ms_per_pass": ...,
"GBps": <block bytes / pass time>, "kernel": <the wrapper that ran>}; a
variant that raises prints {"variant": ..., "error": ...} and the next one
runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from sgvamp_torch import default_device
from sgvamp_torch.core.cg import cg_batched
from sgvamp_torch.core.operators import BandedLD
from sgvamp_torch.data.simulate import simulate_ld_band
from sgvamp_torch.ops.band_kernel import SymBandedLD, band_kernel_of
from sgvamp_torch.ops.membench import measure_read_gbps


def build(M: int, bandwidth: int, seed: int = 0) -> np.ndarray:
    """The bench's banded panel (N=300000, h2=0.7, lam=0.01) in band storage."""
    band, _, _ = simulate_ld_band(300000, M, bandwidth, h2=0.7, lam=0.01,
                                  rng=np.random.default_rng(seed), dtype=np.float32)
    return band


def make(variant: str, band: np.ndarray, B: int, K: int, dtype: str, device):
    """The operator a variant names (see the module docstring)."""
    if variant.startswith("einsum"):
        return BandedLD.from_band(band, block_size=B, K=K, dtype=dtype, device=device)
    rest, layout = variant, "diag"
    if rest.startswith("slab"):
        layout, rest = "slab", rest[len("slab"):]
    op = SymBandedLD.from_band(band, block_size=B, K=K, dtype=dtype, layout=layout,
                               device=device)
    kw = {}
    for mode in ("resident", "streamed", "window"):
        if rest.startswith(mode):
            rest = rest[len(mode):]
            kw["mode"] = "resident" if mode == "window" else mode
            kw["window"] = mode == "window"
    if rest:
        kw["rows_per_step"] = int(rest)
    return dataclasses.replace(op, **kw)


def _seconds(fn, device, reps: int = 4) -> float:
    """The least of `reps` timings of fn(), after one warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def time_passes(op, x: torch.Tensor, n: int) -> float:
    """Seconds per matvec pass: the n / 2n difference of chained passes."""
    def chain(k):
        v = x
        for _ in range(k):
            # 0.02 damping keeps the iterate finite over k unnormalized passes
            v = op.matvec(v) * 0.02
        return v

    t_n = _seconds(lambda: chain(n), x.device)
    t_2n = _seconds(lambda: chain(2 * n), x.device)
    return max((t_2n - t_n) / n, 1e-12)


def time_cg(op, x: torch.Tensor, n: int) -> float:
    """Seconds per CG iteration (matvec + axpys and dots) at a fixed budget."""
    lanes = x.shape[0]
    gamw = torch.full((lanes, 1), 5.0, dtype=x.dtype, device=x.device)
    gam2 = torch.full((lanes, 1), 1.0, dtype=x.dtype, device=x.device)

    def solve():
        return cg_batched(lambda v: gamw * op.matvec(v) + gam2 * v, x,
                          torch.zeros_like(x), maxiter=n, force_maxiter=True).x

    return _seconds(solve, x.device, reps=1) / n


def main(argv=None, band: np.ndarray = None) -> list:
    """Runs the variants and returns their lines as dicts. `band`: band
    storage (M, 2*bandwidth+1) to use instead of simulating the panel."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--M", type=int, default=524288)
    ap.add_argument("--bandwidth", type=int, default=256)
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--K", type=int, default=1)
    ap.add_argument("--S", type=int, default=2)
    ap.add_argument("--passes", type=int, default=50)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--variants", default="resident8,streamed8,streamed16")
    ap.add_argument("--cg", action="store_true",
                    help="also time a full CG iteration (matvec + vector ops)")
    ap.add_argument("--platform", default=None,
                    help="cuda (the default) or cpu (plain versions, host clock)")
    args = ap.parse_args(argv)
    if args.platform not in (None, "cuda", "cpu"):
        raise SystemExit(f"--platform {args.platform} is not supported: use cuda or cpu")
    device = torch.device("cpu") if args.platform == "cpu" else default_device()
    if band is None:
        band = build(args.M, args.bandwidth)
    rng = np.random.default_rng(1)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for variant in args.variants.split(","):
        try:
            if variant == "memread":
                op = make("resident", band, args.B, args.K, args.dtype, device)
                gbps, per_pass = measure_read_gbps(op.upper, n=max(10, args.passes // 2))
                emit({"variant": "memread", "M": args.M, "dtype": args.dtype,
                      "device": device.type, "ms_per_pass": round(per_pass * 1e3, 4),
                      "GBps": round(gbps, 1)})
                continue
            op = make(variant, band, args.B, args.K, args.dtype, device)
            x = torch.from_numpy(
                rng.normal(size=(args.S * args.K, op.M)).astype(np.float32)).to(device)
            dt = time_passes(op, x, args.passes)
            row = {"variant": variant, "M": args.M, "K": args.K, "S": args.S, "B": args.B,
                   "bandwidth": args.bandwidth, "dtype": args.dtype, "device": device.type,
                   "kernel": ("torch.einsum" if isinstance(op, BandedLD)
                              else band_kernel_of(op, args.S)[0].__name__),
                   "ms_per_pass": round(dt * 1e3, 4),
                   "GBps": round(op.bytes_per_pass() / dt / 1e9, 1)}
            if args.cg:
                dt_cg = time_cg(op, x, args.passes)
                row["ms_per_cg_iter"] = round(dt_cg * 1e3, 4)
                row["vector_overhead_ms"] = round((dt_cg - dt) * 1e3, 4)
            emit(row)
        except Exception as e:  # keep going: a variant that is refused is data too
            emit({"variant": variant, "error": f"{type(e).__name__}: {e}"[:300]})
    return rows


if __name__ == "__main__":
    main()
    sys.exit(0)
