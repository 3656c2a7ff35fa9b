"""Where a band kernel's time goes: one JSON line per case, on one GPU.

    python -m sgvamp_torch.utils.kernel_diag [--bytes 201326592] [--out FILE]
        [--storages int8,int4,hybrid,bfloat16,float32] [--hb 0,1,2]
        [--bench-hb 2] [--tile-shapes 64:64:2,4096:2:1,64:1:1:2:256]
        [--int8-tiles 1:2,1:all,8:3] [--float-tiles 1:2,8:all]
        [--slab-tiles 1:2,8:all]

For each storage of SymBandedLD (int8, int4, hybrid, bfloat16, float32) the
streamed diag kernel, and for the two float storages also the streamed
slab, resident diag and resident slab kernels, are timed on random blocks
at B=128 whose total size is held near `--bytes`, for each hb of `--hb`
(default 0, 1, 2) and S in (1, 2, 4) lanes; the resident kernels take the
most block rows a CTA that fit (SymBandedLD.resident_rows), so a wide band
(hb=16) can be timed on them too. hb=0 has no mirror blocks;
S scales the multiply-adds and leaves the bytes and the decoding of the
blocks unchanged. Each line gives ms per pass (CUDA events over 100
launches after a warm-up, the card asleep for 20 ms while the host queues
them, so that launches shorter than their host-side cost run back to
back), GB/s over bytes_per_pass(), the block elements decoded per second
(the int4 and hybrid gathers decode every stored off-diagonal slot twice,
as a row and as a mirror block; the other kernels every stored element
once), and the same call's read-probe time for those bytes. Last,
for each hb of `--bench-hb` (default 2), lines per storage at the bench
shape (M=524288, S=2): the streamed diag kernel (for the float storages
also the streamed slab kernel), its spill form on one shard of four (1024
block rows and the halo), and the chained operator pass of the operator cut
four ways over a one-card mesh beside the unsharded one
(utils/kernel_bench.py's time_passes, as chip_smoke.py's phase 6b times
it: host dispatch included), three times each to show its spread. A kernel
bound by bytes runs near the probe's time at hb=0 whatever S is; one bound
by decoding keeps its elements per second from hb=0 to hb=2. The int4 and
hybrid kernels read every off-diagonal slot twice, the int8 and float
streamed kernels every block once (plus their partial sums), the resident
ones once plus hb/(2G) of them at the run boundaries. `--tile-shapes`
(nb:hb:K, nb:hb:K:S or nb:hb:K:S:B, S=2 and B=128 by default; 64:64:2 is a
dense M=8192 panel's whole triangle over two cohorts, 4096:2:1 the bench
shape) also times the int8 kernel and the float streamed kernels (those
of `--storages` among int8, bfloat16 and float32; for float blocks the
diag and the slab kernel) over random bands of those shapes, with the
wrapper's own tiles and with each tile G:D of `--int8-tiles` /
`--float-tiles` / `--slab-tiles` (G block rows and D diagonals; all: every
diagonal) in place of its choice (ops/band_kernel.py::_int8_tiles,
_float_tiles, _slab_tiles); for int8, where the tile takes every diagonal,
the spill form on one shard of four too, with runs of G
(ops/band_kernel.py::_int8_runs). `--storages` times only
the storages that a change touches (the whole run takes minutes). Run from
another checkout's root with this file's path, the script times that
checkout's package (PYTHONPATH=. python /path/to/kernel_diag.py).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from typing import Optional

import torch

from sgvamp_torch.ops import band_kernel as bk
from sgvamp_torch.ops.membench import measure_read_gbps
from sgvamp_torch.utils import kernel_bench

B = 128
STORAGES = ("int8", "int4", "hybrid", "bfloat16", "float32")
BENCH_NB, BENCH_S, BENCH_SHARDS = 4096, 2, 4   # M=524288
PASSES = 20   # chained passes of a pass timing, as chip_smoke.py's BENCH_PASSES
PROFILED_PASSES = 20   # --tile-shapes: passes under torch.profiler a line


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
    """CUDA events over n calls; the card sleeps first while the host
    enqueues them, so short kernels run back to back."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)   # cycles: about 20 ms at 1.98 GHz
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _one_card_shards(op: bk.SymBandedLD, n: int) -> bk.SymBandedLD:
    """op cut n ways by shard_inputs over a (1, n) mesh whose cells are all
    the one card: its matvec runs the n spill launches a pass."""
    from sgvamp_torch import VampInputs
    from sgvamp_torch.parallel.sharding import make_mesh, shard_inputs

    dev = op.upper.device
    inputs = VampInputs(op=op, r=torch.zeros((op.K, op.M), device=dev),
                        a=torch.ones(op.K, device=dev), N=torch.ones(op.K, device=dev))
    return shard_inputs(inputs, make_mesh(1, n, devices=[dev] * n)).op


@contextlib.contextmanager
def forced_int8_tiles(G: int, D: Optional[int] = None):
    """Within the block the int8 wrappers take runs of G block rows whatever
    ops/band_kernel.py's rules would choose: the matvec form in tiles of D
    diagonals (None: every diagonal; at most hb + 1) in place of
    _int8_tiles', the spill form, which takes every diagonal, in place of
    _int8_runs'."""
    rules = bk._int8_tiles, bk._int8_runs
    bk._int8_tiles = lambda nb, hb, sms: (G, hb + 1 if D is None else min(D, hb + 1))
    bk._int8_runs = lambda nb, sms: G
    try:
        yield
    finally:
        bk._int8_tiles, bk._int8_runs = rules


@contextlib.contextmanager
def forced_float_tiles(G: int, D: Optional[int] = None):
    """Within the block the float diag wrappers take runs of G block rows
    in place of ops/band_kernel.py::_float_tiles' choice: the matvec form in
    tiles of D diagonals (None: every diagonal; at most hb + 1), the spill
    form, which takes every diagonal, in runs of G."""
    rule = bk._float_tiles
    bk._float_tiles = lambda nb, hb, sms, spill=False: (
        G, hb + 1 if D is None or spill else min(D, hb + 1))
    try:
        yield
    finally:
        bk._float_tiles = rule


@contextlib.contextmanager
def forced_slab_tiles(G: int, D: Optional[int] = None):
    """Within the block the streamed slab wrappers take runs of G block
    rows in place of ops/band_kernel.py's rules: the matvec form in tiles of
    D diagonals (None: every diagonal; at most hb + 1) in place of
    _slab_tiles', the spill form, which takes every diagonal, in place of
    _slab_runs'. The card refuses a tile whose x window does not fit a CTA
    (the wrapper raises RuntimeError)."""
    rules = bk._slab_tiles, bk._slab_runs
    bk._slab_tiles = lambda nb, hb, sms, S, B, storage_bytes, rows_per_step=0: (
        G, hb + 1 if D is None else min(D, hb + 1))
    bk._slab_runs = lambda hb, S, B, storage_bytes, rows_per_step=0: G
    try:
        yield
    finally:
        bk._slab_tiles, bk._slab_runs = rules


def _flat(out) -> torch.Tensor:
    return torch.cat([t.flatten() for t in (out if isinstance(out, tuple) else (out,))])


def _tile_lines(smi: str, device, storage: str, nb: int, hb: int, K: int, S: int, Bs: int,
                tiles: list, layout: str = "diag") -> list:
    """A streamed kernel (int8, or float blocks in bfloat16 / float32, in
    diag or slab `layout`) over random blocks (zero past the matrix's end)
    of nb block rows, hb diagonals past the first, K cohorts, S lanes and
    block size Bs: the matvec form with the wrapper's own tiles and with each of `tiles` ((G,
    D), D None for every diagonal); for int8, where D is every diagonal (and
    for the wrapper's own), the spill form too over an interior shard of
    BENCH_SHARDS when one holds more than hb block rows. Each form's cases
    run in the order own, tiles, then back (A B C C B A), so that each is
    timed twice and a drift of the card falls on both sides. Each line its
    ms, its scaled error against the plain version, GB/s over the held
    blocks, and the device µs a pass of the kernel and of its fold
    (torch.profiler over PROFILED_PASSES passes: each launch's own span,
    without the gaps; a fold_tiles launched as the kernel's programmatic
    dependent starts while the kernel's last CTAs run, and its span holds
    that wait). A checkout from before the float kernels' tiles times its
    own schedule only (runs of DIAG_RUN_ROWS, every diagonal; the slab
    kernel: runs of its _gather_rows)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device).manual_seed(nb + hb)
    quantized = storage == "int8"
    if quantized:
        up = torch.randint(-128, 128, (K, nb, hb + 1, Bs, Bs), generator=g, device=device,
                           dtype=torch.int8)
        sc = torch.rand((K, nb, hb + 1), generator=g, device=device) / 100
        xdt = torch.bfloat16
    else:
        up = torch.randn((K, nb, hb + 1, Bs, Bs), generator=g, device=device).to(
            getattr(torch, storage))
        xdt = up.dtype
    for d in range(1, hb + 1):
        up[:, max(nb - d, 0):, d] = 0
    x = torch.randn((K, S, nb * Bs), generator=g, device=device).to(xdt)
    sms = bk._sm_count(device)
    held = K * sum(min(hb, nb - 1 - i) + 1 for i in range(nb))
    if quantized:
        # a checkout from before the tiles takes runs of _int8_runs, every diagonal
        own = (bk._int8_tiles(nb, hb, sms) if hasattr(bk, "_int8_tiles")
               else (bk._int8_runs(nb, sms), hb + 1))
        forms = [("whole", bk.sym_band_matvec_int8, bk.sym_band_matvec_int8_ref, (up, sc, x),
                  held, own)]
        force, names = forced_int8_tiles, ("sym_band_int8_kernel", "fold_")
    elif layout == "slab":
        up = up.transpose(-1, -2).reshape(K, nb, (hb + 1) * Bs, Bs).contiguous()
        tiled = hasattr(bk, "_slab_tiles")
        own = (bk._slab_tiles(nb, hb, sms, S, Bs, up.element_size()) if tiled
               else (bk._gather_rows(up, S, 0), hb + 1))
        forms = [("whole", bk.sym_slab_matvec_streamed, bk.sym_slab_matvec_streamed_ref,
                  (up, 0, x), held, own)]
        force, names = forced_slab_tiles, ("sym_slab_streamed_kernel", "fold_")
        tiles = tiles if tiled else []
    else:
        tiled = hasattr(bk, "_float_tiles")
        own = bk._float_tiles(nb, hb, sms) if tiled else (bk.DIAG_RUN_ROWS, hb + 1)
        forms = [("whole", bk.sym_band_matvec, bk.sym_band_matvec_ref, (up, x), held, own)]
        force, names = forced_float_tiles, ("sym_band_float_kernel", "fold_")
        tiles = tiles if tiled else []
    nb_l = nb // BENCH_SHARDS
    if quantized and nb_l > hb:
        x_l = torch.randn((K, S, (nb_l + hb) * Bs), generator=g, device=device)
        forms.append(("one shard of 4", bk.sym_band_matvec_int8_spill,
                      bk.sym_band_matvec_int8_spill_ref,
                      (up[:, nb_l:2 * nb_l].contiguous(), sc[:, nb_l:2 * nb_l].contiguous(),
                       x_l.to(torch.bfloat16)),
                      K * nb_l * (hb + 1), (bk._int8_runs(nb_l, sms), hb + 1)))
    elem = up.element_size()
    lines = []
    for form, kernel, plain, args, n_held, own_tiles in forms:
        want = _flat(plain(*args))
        cases = [None] + [t for t in dict.fromkeys(tiles) if form == "whole" or t[1] is None]
        for tile in cases + cases[::-1]:
            G, D = own_tiles if tile is None else (tile[0], min(tile[1] or hb + 1, hb + 1))
            with contextlib.nullcontext() if tile is None else force(*tile):
                err = float((_flat(kernel(*args)) - want).abs().max() / want.abs().max())
                ms = _ms(lambda: kernel(*args))
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(PROFILED_PASSES):
                        kernel(*args)
                    torch.cuda.synchronize()
            ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            us = {name: sum(e.device_time_total for e in ev if pat in e.key) / PROFILED_PASSES
                  for name, pat in zip(("kernel_us", "fold_us"), names)}
            lines.append({"card": smi, "storage": storage, "layout": layout,
                          "shape": "tiles", "form": form,
                          "nb": nb if form == "whole" else nb_l, "hb": hb, "K": K, "S": S,
                          "B": Bs, "G": G, "D": D, "chosen": tile is None, "ms": ms,
                          "scaled_err": err, "held_block_bytes": n_held * Bs * Bs * elem,
                          "gbps_over_held_blocks": n_held * Bs * Bs * elem / ms / 1e6, **us})
            print(json.dumps(lines[-1]), flush=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bytes", type=int, default=201326592,
                    help="block bytes of every case (default: the bench's int8 blocks)")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    ap.add_argument("--storages", default=",".join(STORAGES),
                    help="comma-separated storages to time (default: all)")
    ap.add_argument("--hb", default="0,1,2",
                    help="comma-separated block diagonals of the random cases")
    ap.add_argument("--bench-hb", default="2",
                    help="comma-separated block diagonals of the bench-shape cases "
                         "(2 is the bench's bandwidth 256)")
    ap.add_argument("--tile-shapes", default="",
                    help="comma-separated nb:hb:K[:S[:B]] of random bands over which to time "
                         "the int8 and float diag kernels (those of --storages) with their "
                         "own tiles and the --int8-tiles / --float-tiles ones")
    ap.add_argument("--int8-tiles", default="",
                    help="comma-separated tiles G:D (D 'all': every diagonal) to force on "
                         "the int8 kernel over the --tile-shapes bands")
    ap.add_argument("--float-tiles", default="",
                    help="the same for the float diag kernel (bfloat16, float32)")
    ap.add_argument("--slab-tiles", default="",
                    help="the same for the streamed slab kernel (bfloat16, float32)")
    args = ap.parse_args(argv)
    storages = [v for v in args.storages.split(",") if v]
    hbs = [int(v) for v in args.hb.split(",") if v]
    bench_hbs = [int(v) for v in args.bench_hb.split(",") if v]
    if not set(storages) <= set(STORAGES):
        raise SystemExit(f"--storages takes {', '.join(STORAGES)}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_diag needs a CUDA device: it reports device times only")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    lines = []
    cases = [(st, "streamed") for st in storages]
    cases += [(st, fl) for st in ("bfloat16", "float32") if st in storages
              for fl in FLAVORS if fl != "streamed"]
    for storage, flavor in cases:
        per_elem = {"int8": 1.0, "int4": 0.5, "hybrid": 0.5, "bfloat16": 2.0,
                    "float32": 4.0}[storage]
        for hb in hbs:
            nslot = hb + (2 if storage == "hybrid" else 1)
            slot_bytes = B * B * per_elem
            nb = max(int(args.bytes // (nslot * slot_bytes)), hb + 1)
            nb -= nb % 16 if nb > 16 else 0   # any run of the resident kernels divides it
            op = _random_operator(storage, nb, hb, device, flavor)
            gbps, probe_s = measure_read_gbps(op.upper, n=20)
            # decoded block elements: the gathers decode a stored off-diagonal
            # slot twice, the other kernels once
            twice = 2 if storage in ("int4", "hybrid") else 1
            decoded = (op.nb + twice * sum(op.nb - d for d in range(1, hb + 1))) * B * B
            for S in (1, 2, 4):
                if flavor in ("resident", "slab-resident"):
                    G = bk.SymBandedLD.resident_rows(hb, B, S, op.upper.element_size())
                    if not G:
                        continue
                    op = dataclasses.replace(op, rows_per_step=G)
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
    def forced(spec):
        return [(int(G), None if D == "all" else int(D))
                for G, D in (v.split(":") for v in spec.split(",") if v)]

    tiles = {("int8", "diag"): forced(args.int8_tiles)}
    for layout, spec in (("diag", args.float_tiles), ("slab", args.slab_tiles)):
        tiles.update({(st, layout): forced(spec) for st in ("bfloat16", "float32")})
    for shape in [v for v in args.tile_shapes.split(",") if v]:
        dims = [int(v) for v in shape.split(":")]
        nb, hb, K, S, Bs = dims + [BENCH_S, B][len(dims) - 3:]
        for (storage, layout), forced_tiles in tiles.items():
            if storage in storages:
                lines += _tile_lines(smi, device, storage, nb, hb, K, S, Bs, forced_tiles,
                                     layout)
    bench = [(st, "streamed", hb) for hb in bench_hbs for st in storages]
    bench += [(st, "slab-streamed", hb) for hb in bench_hbs for st in ("bfloat16", "float32")
              if st in storages]
    for storage, flavor, hb in bench:
        op = _random_operator(storage, BENCH_NB, hb, device, flavor)
        nb_l = BENCH_NB // BENCH_SHARDS
        piece = dataclasses.replace(  # an interior shard: a halo to read, a carry to write
            op, upper=op.upper[:, nb_l:2 * nb_l].contiguous(),
            scales=None if op.scales is None else op.scales[:, nb_l:2 * nb_l].contiguous())
        for form, o, spill in (("whole", op, False), ("one shard of 4", piece, True)):
            kernel, _, k_args, xdt = bk.band_kernel_of(o, BENCH_S, spill=spill)
            x = torch.randn((1, BENCH_S, o.M + (o.hb * B if spill else 0)),
                            device=device).to(xdt)
            ms = _ms(lambda: kernel(*k_args, x))
            lines.append({"card": smi, "storage": storage, "flavor": flavor, "shape": "bench",
                          "form": form, "kernel": kernel.__name__, "hb": o.hb, "nb": o.nb,
                          "S": BENCH_S, "bytes_per_pass": o.bytes_per_pass(), "ms": ms})
            print(json.dumps(lines[-1]), flush=True)
        if flavor != "streamed":
            del op, piece, k_args, x
            continue
        sh = _one_card_shards(op, BENCH_SHARDS)
        lanes = torch.randn((BENCH_S, op.M), device=device)
        passes = {name: [kernel_bench.time_passes(o, lanes, PASSES) * 1e3 for _ in range(3)]
                  for name, o in (("sharded_pass_ms", sh), ("unsharded_pass_ms", op))}
        lines.append({"card": smi, "storage": storage, "flavor": flavor, "shape": "bench",
                      "form": f"chained pass, {BENCH_SHARDS} shards on one card", "hb": op.hb,
                      "nb": op.nb, "S": BENCH_S, "passes": PASSES, **passes})
        print(json.dumps(lines[-1]), flush=True)
        del op, piece, sh, k_args, x
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(ln) + "\n" for ln in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
