"""The A/B matrix behind the LD-storage choice (the PyTorch counterpart of
tools/ab_matrix.py).

    python -m sgvamp_torch.utils.ab_matrix --out FILE [--size large]
        [--bandwidth 256] [--passes 40] [--budget-s 900] [--skip-steps]
        [--skip-solves] [--fresh] [--platform cpu]

Writes one JSON document, the JAX tool's shape:

  * matvec_grid: ms per chained operator pass for every {bfloat16, int8,
    int4, hybrid} x {B=128, 256} x {diag, slab} cell, by
    sgvamp_torch.utils.kernel_bench (n and 2n chains differenced, CUDA
    events), streamed mode. Quantized storage is diag only: its slab cells
    say "unsupported". iter_s_est on a cell is derived: 1 / (ms_per_pass x
    (cg_maxit + 2)). Each cell also names the wrapper that ran and its
    launches.
  * step_by_dtype: the step child of sgvamp_torch.bench for each storage
    at the bench's default B, diag, streamed: iter/s (fused, and the host
    loop's median) and the quality gate's alignments.
  * solve_by_dtype: the bench's solve child for each storage: rtol 1e-5
    time to tolerance, plain against block-Jacobi CG, on the strength-4
    panel, the production regime a storage has to survive (int4's 16
    levels are expected to stall CG at maxiter).

The grid runs in this process over one band: the bench's problem, built
once and cached (SGVAMP_BENCH_CACHE_DIR), which its step children load too.
The step and solve rows run `python -m sgvamp_torch.bench` children, each
under --budget-s. Rows are written as they come; a rerun with the same M,
bandwidth and passes keeps the rows that hold no error (--fresh measures
everything again). No row is served from a cache of earlier measurements:
a child that fails leaves its error in the row. --out has no default:
BENCH_AB.json at the repo root is the JAX package's record.

Exit status, as sgvamp_torch.bench's: 1 when a grid cell (other than an
"unsupported" one) or a step or solve row holds an error, after the
document is written and printed; else 0. A solve that does not converge
(int4) is that row's finding, not an error.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

from sgvamp_torch import bench, default_device
from sgvamp_torch.utils import kernel_bench

DTYPES = ("bfloat16", "int8", "int4", "hybrid")
BLOCKS = (128, 256)
LAYOUTS = ("diag", "slab")
CG_MAXIT = {"small": 20, "large": 100, "xl": 100}
M_OF = {"small": 16384, "large": 524288, "xl": 1048576}
VARIANT_LAYOUT = {"streamed": "diag", "slabstreamed": "slab"}


def run_kernel_bench(dtype, B, band, passes, platform):
    """kernel_bench's streamed diag and slab variants over `band`, one call
    each, with the launches each made; a call that raises leaves an error
    row for its variant."""
    rows = []
    for variant in VARIANT_LAYOUT:
        argv = ["--M", str(band.shape[0]), "--bandwidth", str((band.shape[1] - 1) // 2),
                "--B", str(B), "--dtype", dtype, "--passes", str(passes),
                "--variants", variant] + (["--platform", platform] if platform else [])
        before = bench._launch_counts()
        try:
            with contextlib.redirect_stdout(sys.stderr):  # stdout holds the document
                got = kernel_bench.main(argv, band=band)
        except Exception as e:  # a variant that fails is a row too
            got = [{"variant": variant, "error": f"{type(e).__name__}: {e}"[:300]}]
        for row in got:
            row["launches"] = bench._since(before)
        rows += got
    return rows


def run_bench_child(mode, dtype, size, budget_s, platform):
    """One `python -m sgvamp_torch.bench` child (mode 'step' or 'solve')
    at this storage and size; its JSON dict, or an {"error": ...} row."""
    env = {"SGVAMP_BENCH_SIZE": size, "SGVAMP_BENCH_LD_DTYPE": dtype}
    if platform:
        env["SGVAMP_BENCH_PLATFORM"] = platform
    return bench.run_child(mode, budget_s, extra_env=env)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True,
                    help="the JSON document (rerun with the same file to resume)")
    ap.add_argument("--size", default="large", choices=list(M_OF))
    ap.add_argument("--bandwidth", type=int, default=256)
    ap.add_argument("--passes", type=int, default=40)
    ap.add_argument("--budget-s", type=float, default=900.0,
                    help="per child process")
    ap.add_argument("--skip-steps", action="store_true",
                    help="only the matvec grid, no step children")
    ap.add_argument("--skip-solves", action="store_true",
                    help="skip the per-storage production-solve rows")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore existing rows and measure everything")
    ap.add_argument("--platform", default=None,
                    help="cuda (the default) or cpu (plain versions, host clock)")
    args = ap.parse_args(argv)
    if args.platform not in (None, "cuda", "cpu"):
        raise SystemExit(f"--platform {args.platform} is not supported: use cuda or cpu")
    if args.platform != "cpu":
        default_device()  # raises without a card

    M = M_OF[args.size]
    bandwidth = 128 if args.size == "small" else args.bandwidth
    cg_maxit = CG_MAXIT[args.size]
    doc = {"M": M, "bandwidth": bandwidth, "cg_maxit": cg_maxit,
           "passes": args.passes,
           "ld_passes_per_iter": cg_maxit + 2,
           "protocol": {
               "ms_per_pass": "chained operator passes (n vs 2n chains differenced, the "
                              "least of 4 timings, CUDA events), "
                              "sgvamp_torch/utils/kernel_bench.py",
               "iter_s_est": "derived: 1 / (ms_per_pass * ld_passes_per_iter)",
               "step": "sgvamp_torch.bench step child (snapshot-restart timing of the "
                       "fused step and of the host loop, 10-iteration quality gate with "
                       "StopMonitor) at the bench-default B (recorded per row), diag, "
                       "streamed",
               "solve": "sgvamp_torch.bench solve child: rtol=1e-5 time to tolerance, "
                        "plain vs block-Jacobi CG, strength=4 ill-conditioned panel",
           },
           "matvec_grid": [], "step_by_dtype": {}, "solve_by_dtype": {}}
    if os.path.exists(args.out) and not args.fresh:
        try:
            with open(args.out) as f:
                old = json.load(f)
            # resume only rows measured under the same config
            if (old.get("M"), old.get("bandwidth"), old.get("passes")) == \
                    (M, bandwidth, args.passes):
                doc["matvec_grid"] = [r for r in old.get("matvec_grid", [])
                                      if "error" not in r or "unsupported" in r]
                doc["step_by_dtype"] = {
                    k: v for k, v in old.get("step_by_dtype", {}).items() if "error" not in v}
                doc["solve_by_dtype"] = {
                    k: v for k, v in old.get("solve_by_dtype", {}).items() if "error" not in v}
        except (OSError, ValueError):
            pass

    def save():
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)

    have = {(r.get("dtype"), r.get("B"), r.get("layout")) for r in doc["matvec_grid"]}
    band = None
    for dtype in DTYPES:
        for B in BLOCKS:
            if all((dtype, B, lay) in have for lay in LAYOUTS):
                continue
            if band is None:
                band = bench.build_problem(M, bandwidth, bench.N_SAMPLES, bench.LAM,
                                           bench.H2)[0]
            print(f"[ab] {time.strftime('%H:%M:%S')} matvec {dtype} B={B}",
                  file=sys.stderr, flush=True)
            for r in run_kernel_bench(dtype, B, band, args.passes, args.platform):
                layout = VARIANT_LAYOUT[r["variant"]]
                if (dtype, B, layout) in have:
                    continue
                cell = {"dtype": dtype, "B": B, "layout": layout}
                if "error" in r:
                    if "diag layout only" in r["error"]:
                        # per-block (int8) and per-row (int4) scales are laid
                        # out for the diag kernels
                        cell["unsupported"] = "quantized storage is diag-only"
                    else:
                        cell["error"] = r["error"]
                elif r["ms_per_pass"] <= 0:  # kernel_bench's floor: no time to report
                    cell["error"] = "the 2n-pass chain took no longer than the n-pass chain"
                else:
                    cell["ms_per_pass"] = r["ms_per_pass"]
                    cell["GBps"] = r["GBps"]
                    cell["iter_s_est"] = round(1e3 / (r["ms_per_pass"] * (cg_maxit + 2)), 3)
                    cell["kernel"] = r["kernel"]
                    cell["launches"] = r["launches"]
                doc["matvec_grid"].append(cell)
                have.add((dtype, B, layout))
            save()
    del band

    if not args.skip_steps:
        for dtype in DTYPES:
            if dtype in doc["step_by_dtype"]:
                continue
            print(f"[ab] {time.strftime('%H:%M:%S')} step child {dtype}",
                  file=sys.stderr, flush=True)
            got = run_bench_child("step", dtype, args.size, args.budget_s, args.platform)
            B = bench._params(args.size)[2]
            if "error" in got:
                doc["step_by_dtype"][dtype] = dict(got, B=B)
            else:
                s, h = got["iter_s_samples"], got["iter_s_samples_host"]
                doc["step_by_dtype"][dtype] = {
                    "B": B,
                    "iter_ms_median": round(float(np.median(s)) * 1e3, 2),
                    "iter_s": round(1.0 / float(np.median(s)), 3),
                    "iter_ms_median_host": round(float(np.median(h)) * 1e3, 2),
                    "align_it10": got["align"],
                    "align_best": got["align_best"],
                    "align_best_it": got["align_best_it"],
                    "align_stop": got.get("align_stop"),
                    "stop_it": got.get("stop_it"),
                    "stop_reason": got.get("stop_reason"),
                    "compile_s": got["compile_s"],
                    "launches": got["launches_fused"],
                }
            save()

    if not args.skip_solves:
        for dtype in DTYPES:
            if dtype in doc["solve_by_dtype"]:
                continue
            print(f"[ab] {time.strftime('%H:%M:%S')} solve child {dtype}",
                  file=sys.stderr, flush=True)
            row = run_bench_child("solve", dtype, args.size, args.budget_s, args.platform)
            doc["solve_by_dtype"][dtype] = dict(row, B=bench._params(args.size)[2])
            save()

    ok = [r for r in doc["matvec_grid"] if "ms_per_pass" in r]
    if ok:
        best = min(ok, key=lambda r: r["ms_per_pass"])
        doc["fastest_cell"] = {k: best[k] for k in ("dtype", "B", "layout", "ms_per_pass")}
    save()
    print(json.dumps(doc, indent=1))
    return doc


def failures(doc: dict) -> list:
    """The grid cells and the step and solve rows that hold an error."""
    return ([c for c in doc["matvec_grid"] if "error" in c]
            + [dict(r, row=f"{kind} {d}")
               for kind in ("step", "solve")
               for d, r in doc[f"{kind}_by_dtype"].items() if "error" in r])


if __name__ == "__main__":
    sys.exit(1 if failures(main()) else 0)
