"""Where a band kernel's time goes: one JSON line per case, on one GPU.

    python -m sgvamp_torch.utils.kernel_diag [--bytes 201326592] [--out FILE]

For each storage of SymBandedLD (int8, int4, hybrid, bfloat16, float32) the
streamed diag kernel, and for the two float storages also the streamed
slab, resident diag and resident slab kernels, are timed on random blocks
at B=128 whose total size is held near `--bytes`, for hb in (0, 2) and S
in (1, 2, 4) lanes. hb=0 has no mirror
blocks, so nothing is read twice; S scales the multiply-adds and leaves
the bytes and the decoding of the blocks unchanged. Each line gives ms per
pass (CUDA events over 100 launches after a warm-up), GB/s over
bytes_per_pass(), the block elements decoded per second (every stored
off-diagonal block is decoded twice, as a row and as a mirror block), and
the same call's read-probe time for those bytes. A kernel bound by bytes
runs near the probe's time at hb=0 whatever S is; one bound by decoding
keeps its elements per second from hb=0 to hb=2. The streamed kernels read
every off-diagonal block twice, the resident ones once (plus hb/(2G) of
them at the run boundaries): at hb=2 the difference between the two
flavors of one storage is what the second read costs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from sgvamp_torch.ops import band_kernel as bk
from sgvamp_torch.ops.membench import measure_read_gbps

B = 128


FLAVORS = {"streamed": ("diag", "streamed"), "slab-streamed": ("slab", "streamed"),
           "resident": ("diag", "resident"), "slab-resident": ("slab", "resident")}


def _random_operator(storage: str, nb: int, hb: int, device,
                     flavor: str = "streamed") -> bk.SymBandedLD:
    g = torch.Generator(device).manual_seed(nb + hb)
    if storage in ("bfloat16", "float32"):
        layout, mode = FLAVORS[flavor]
        shape = (1, nb, hb + 1, B, B) if layout == "diag" else (1, nb, (hb + 1) * B, B)
        up = torch.randn(shape, generator=g, device=device)
        return bk.SymBandedLD(upper=up.to(getattr(torch, storage)), layout=layout, mode=mode)
    nslot = hb + (2 if storage == "hybrid" else 1)
    last = B if storage == "int8" else B // 2
    up = torch.randint(-128, 128, (1, nb, nslot, B, last), generator=g,
                       device=device).to(torch.int8)
    sc_shape = (1, nb, nslot) if storage == "int8" else (1, nb, nslot, B)
    sc = torch.rand(sc_shape, generator=g, device=device) / 100
    return bk.SymBandedLD(upper=up, scales=sc, packed=storage == "int4",
                          hybrid=storage == "hybrid")


def _ms(fn, n: int = 100) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bytes", type=int, default=201326592,
                    help="block bytes of every case (default: the bench's int8 blocks)")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_diag needs a CUDA device: it reports device times only")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    lines = []
    cases = [(st, "streamed") for st in ("int8", "int4", "hybrid", "bfloat16", "float32")]
    cases += [(st, fl) for st in ("bfloat16", "float32") for fl in FLAVORS if fl != "streamed"]
    for storage, flavor in cases:
        per_elem = {"int8": 1.0, "int4": 0.5, "hybrid": 0.5, "bfloat16": 2.0,
                    "float32": 4.0}[storage]
        for hb in (0, 2):
            nslot = hb + (2 if storage == "hybrid" else 1)
            slot_bytes = B * B * per_elem
            nb = max(int(args.bytes // (nslot * slot_bytes)), hb + 1)
            op = _random_operator(storage, nb, hb, device, flavor)
            gbps, probe_s = measure_read_gbps(op.upper, n=20)
            # decoded block products: nb diagonal + 2 per stored off-diagonal
            decoded = (op.nb + 2 * sum(op.nb - d for d in range(1, hb + 1))) * B * B
            for S in (1, 2, 4):
                kernel, _, k_args, xdt = bk.band_kernel_of(op, S)
                x = torch.randn((1, S, op.M), device=device).to(xdt)
                ms = _ms(lambda: kernel(*k_args, x))
                lines.append({
                    "card": smi, "storage": storage, "flavor": flavor,
                    "kernel": kernel.__name__, "hb": hb, "nb": op.nb, "S": S,
                    "bytes_per_pass": op.bytes_per_pass(), "ms": ms,
                    "gbps_over_bytes_per_pass": op.bytes_per_pass() / ms / 1e6,
                    "decoded_elements_per_s": decoded / ms * 1e3,
                    "probe_ms_for_the_blocks": probe_s * 1e3, "probe_gbps": gbps})
                print(json.dumps(lines[-1]), flush=True)
            del op, k_args, x
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(ln) + "\n" for ln in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
