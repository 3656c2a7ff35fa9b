"""The readings that the limits in benchmark/limits/ are set from, in one
process (set-up is long, so each seed's set-up is paid once):

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--seconds 2] [--out FILE]

For each of --seeds, one run of the cell with a short window (every number
it compared: the lower reading is the largest over them); for each of
--control-seeds, the controls (harness.control): the program with its int4
storage path switched on, and the reference computed in bfloat16; the
upper reading is the smallest number a control gives. One JSON line each, on
standard output and appended to --out.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time

import torch

from benchmark import harness


def _emit(row, out) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def _finite(numbers):
    """JSON has no infinity: a number that is not finite as null."""
    def one(v):
        if isinstance(v, list):
            return [one(x) for x in v]
        return v if math.isfinite(v) else None
    return {k: one(v) for k, v in numbers.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default="int4,reference-bfloat16")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t = time.perf_counter()
        seen = {}
        res = harness.run_cell(args.workload, seed, args.seconds, False, seen=seen)
        _emit({"workload": args.workload, "seed": seed, "side": "program",
               "correct": res["correct"], "attempted": res["attempted"],
               "numbers": _finite(seen), "metrics": res["metrics"],
               "device": res["device"], "seconds": time.perf_counter() - t}, args.out)
        gc.collect()
        torch.cuda.empty_cache()
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        for kind in args.controls.split(","):
            t = time.perf_counter()
            res = harness.control(args.workload, seed, "cuda", kind)
            _emit({"workload": args.workload, "seed": seed, "side": f"control {kind}",
                   "numbers": _finite(res),
                   "seconds": time.perf_counter() - t}, args.out)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
