"""One run of one cell of the port's benchmark, from the root of a checkout:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (one JSON object:
correct, attempted, failed, metrics, device, with --trace 1 breakdown, and
last the numbers compared with their limits, which also end standard
error). Exits with another code than 0 and prints no result where the card
the cell asks for is missing, where the port cannot be imported, or where
the run holds a module of JAX or of the JAX package.
"""

import time

T0 = time.perf_counter()   # set-up is timed from here, before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches at fixed paths inside the checkout (the port builds its
    # CUDA libraries into sgvamp_torch/build/ by itself)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")
    import torch

    from benchmark import harness

    torch.set_num_threads(4)
    try:
        chips = harness.cell(args.workload, ROOT)["workload"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"benchmark: the cell needs {chips} CUDA card(s); "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        try:
            import sgvamp_torch  # noqa: F401
        except ImportError as e:
            print(f"benchmark: the port does not import: {e}", file=sys.stderr)
            return 4
        out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               t0=T0, root=ROOT)
    except harness.Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return e.code
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the run holds modules it may not: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
