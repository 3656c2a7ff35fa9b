#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, a few lines of output each (and fail on the first that fails):
  0. device: needs CUDA (there is no CPU fallback); prints the card's name
     and power limit as nvidia-smi reports them.
  1. build: compiles the seven sgvamp_torch/csrc/*.cu with nvcc (sm_90a),
     and sym_band_int8.cu a second time with its counter of block bytes,
     one process per library, all started together; then the host C++ of
     the ingestion (sgvamp_torch/native/ldparse.cpp) with g++, and fails
     unless it builds and loads.
  2. kernels against their plain PyTorch versions on the card: the five
     storages of the streamed diag matvec (int8, float blocks in bfloat16 /
     float32 / float64, int4, hybrid) and, for the three float types, the
     streamed slab, resident diag (with and without `window`) and resident
     slab kernels, on a small ragged operator (M=1000, bandwidth 300, K=2,
     S=2) at B = 64, 128, 256, and at the full bench shape (M=524288,
     bandwidth 256, B=128, K=1, S=2; bfloat16 and float32 for the float
     kernels), scaled error <= 1e-5 (1e-12 for float64); ms/pass of kernel
     and plain version at the full shape, and of BandedLD.matvec (one
     einsum over full-band storage) on the same band. A wide band where
     mode "auto" takes the streamed kernels (random bfloat16 blocks, hb=16,
     M=524288, S=2): the streamed diag and slab kernels and the resident
     kernel forced onto it (runs of 8 block rows), each against its plain
     version and timed. At the bench shape the int8 and float diag
     wrappers must keep the runs with every diagonal in one range
     (ops/band_kernel.py::_int8_tiles, _float_tiles). The Triton read
     probe against its plain version, exactly. A small engine run on the
     GPU against the same run on the CPU (plain versions).
  3. the engine's library path: with the kernels' launch counts at zero,
     the bench's sequence at its geometry - the read-probe ceiling over the
     int8 LD blocks, then VampEngine.run (EM prior, fused 2K-lane CG with a
     fixed 100-iteration budget) - and checks: every matvec went through
     the int8 kernel (102 launches per iteration), the best iterate's
     alignment >= 0.9, the state finite up to it, the reference-format
     output files written.
  4. the command-line path: sgvamp_torch.cli.simulate gen-band writes the
     panel files, sgvamp_torch.cli.main ingests them and runs the
     production solve (CG to rtol 1e-5, block-Jacobi preconditioner,
     divergence stop) with --ld-dtype hybrid at M=524288, then with
     --ld-dtype bfloat16 (mode "auto": the resident kernel) and int4, and
     with --operator banded --ld-dtype bfloat16 (no band kernel), at
     M=65536. Each run starts with the launch counts at zero and must
     launch its own kernel once per LD pass and no other band kernel, write
     the reference-format files, ingest through the native library only
     (its log names the path of every step) and reach a best-iterate
     alignment >= 0.9. After the hybrid run, on the host at M=524288: its
     load/R in parts (.npz load, CSR -> band, packing, copy to the card),
     the native band and the native hybrid and int8 packs held bitwise
     against their numpy versions, both timed; then where the run's
     precond/eig goes (torch.linalg.eigh over the 8192 64 x 64 blocks on
     the card and on the host, in one chunk and in chunks of 2048, and
     block_jacobi_eig under torch.profiler).
  4b. the .ld path: from the M=65536 panel, two cohorts' PLINK files (.ld
     tables with PLINK's header and the band's one-sided pairs, .bim files
     on two chromosomes that share positions, each cohort without its own
     2% of the markers and with its own N, r over its own markers), then
     sgvamp_torch.cli.main --ld-files --bim-files --operator sym --ld-dtype
     int8 with the biobank flags (no --bandwidth: the merged panel sorts
     the chromosomes' markers together, which doubles the band): phase 4's
     checks with the int8 kernel, both tables parsed, assembled and packed
     natively, the merged .bim holding every marker once in the panel's
     order; the parse rate of the .ld text.
  5. the operator-flavor path at the bench shape, over the band of phase 2:
     with the launch counts at zero, sgvamp_torch.utils.kernel_bench.main
     over einsum, streamed, resident, window, slab, slabstreamed and
     slabresident in bfloat16, each variant launching its own kernel and no
     other; then VampEngine.run (EM prior, fixed 100-iteration CG budget, 4
     iterations) over the bfloat16 slab-streamed operator and over the
     bfloat16 resident operator, with phase 3's checks on each.
  6. the sharded path, on a (cohort, shard) mesh whose cells are all this
     one card (the cells run one after another; nothing runs on the CPU and
     nothing is caught and passed over):
     6a. the spill forms of the streamed kernels - the five storages of the
         diag kernel and the slab kernel in its three float types - against
         their plain versions, every shard, both outputs (y_l and carry),
         on two ragged operators (M=1000, K=2, S=2; bandwidth 300 and 100)
         at B = 64, 128, 256 cut 2 and 4 ways (shard_inputs must refuse a
         shard narrower than hb), and at the bench shape cut 4 ways
         (nb_l=1024, hb=2; taken in phase 2's loop, where each operator is
         on the card); the shards composed on the card against the
         unsharded kernel's y, and the last shard's carry exactly zero;
     6b. ms per launch of each spill kernel on one shard of four at the
         bench shape beside its plain version and its bound, and ms per
         whole sharded operator pass (chained as kernel_bench chains them)
         beside the unsharded operator's;
     6c. phase 3's engine run (int8, M=524288, same seed) under a (1, 4)
         mesh: 4 x 102 launches of the int8 spill kernel per iteration and
         no other band kernel, phase 3's checks, and gam1, gamw and xhat1
         of every iteration against phase 3's unsharded run; then the same
         over the bfloat16 slab operator (the slab spill kernel);
     6d. sgvamp_torch.cli.main --mesh-shard 4 over phase 4's M=65536 files
         with --ld-dtype hybrid, int4 and bfloat16, and --mesh-cohort 2
         --mesh-shard 2 with the panel given twice (K=2, hybrid): each run
         launches its spill kernel once per LD pass and mesh cell and no
         other band kernel.
  7. the fused run (VampEngine.run_scan_stoppable, the step replayed as
     CUDA graphs), each against its host-loop run of the same call:
     7a. phase 3's engine run (after a 2-step run that captures the
         graphs): no eager kernel launch, 102 int8 launches by replay per
         executed iteration (each graph's launches counted while it was
         captured, times its replays), xhat1, gam1 and gamw of every
         iteration within a scaled 1e-5 of phase 3's (the deviation and
         whether the bits are equal printed), the same stop and best
         iterate; s/iteration, host reads a step, and device ms a step and
         the device-busy share of both runs (torch.profiler over 2 steps
         of each, whose trace must count the 102 int8 kernels a step
         inside the graphs);
     7b. the same for phase 6c's int8 run under the (1, 4) mesh (4 x 102
         spill launches per iteration); ms per chained sharded pass
         replayed from a CUDA graph beside the eager chain and 6b's figure;
     7c. sgvamp_torch.cli.main --fused 1 over phase 4's M=524288 hybrid
         files: phase 4's checks with the launches counted by replay, then
         the same file set, stop and best iterate as phase 4's run, every
         file within a scaled 1e-5 (how many are equal to the byte
         printed), and both runs' infer seconds.
  8. MLE prior learning and checkpoints:
     8a. phase 3's engine run with prior_update="mle" (4 iterations), in the
         host loop and through run_scan_stoppable (graphs captured by a
         2-step run first): 102 int8 launches an iteration in each (by
         replay in the fused run, none eagerly), every iteration's xhat1,
         gam1, gamw, lam and mle_ok equal bit for bit, an MLE update
         accepted, the best iterate's alignment >= 0.9; s/iteration and
         device ms a step (torch.profiler over steps 1-2) of both modes
         beside phase 3's and 7a's EM numbers, host reads and Newton
         chunks a step;
     8b. sgvamp_torch.cli.main with the biobank flags, --prior-update mle
         and --checkpoint-every 2, three runs: 4 iterations; 2 with
         --checkpoint-dir; --resume 1 to 4 (phase 4's checks on each): the
         resumed set's per-iteration files and CSVs equal to the
         uninterrupted run's to the byte, at most 3 checkpoint files; with
         --fused 1 over phase 4's M=524288 hybrid files, and with --fused 0
         over its M=65536 files; seconds a save and MB a checkpoint file.
  9. BlockSparseLD and runs over a process group:
     9a. BlockSparseLD.from_csr over phase 4's M=524288 panel file (B=128:
         12286 blocks), float32 and bfloat16 blocks: the matvec at S=2
         against scipy's CSR product in float64 (scaled 1e-5), a repeat
         equal to the bit, ms a pass by CUDA events beside its bound and
         the block bytes over 3.35 TB/s and over phase 3's probe, and one
         BSR torch.sparse tensor @ x (or the reason torch refuses it);
         then the same CSR with symmetric long-range blocks (block rows i
         and i + nb/2, every 64 block rows): kept, against scipy; the same
         CSR with one heavy block row (a tile in every block column) in
         bfloat16: against scipy, ms a pass, and the bytes a pass holds
         beyond its inputs at most a quarter of the blocks'; and at
         M=65536 cli.main --operator sym warns that it drops them,
         --operator blocksparse does not.
     9b. cli.main --operator blocksparse --ld-dtype bfloat16 with the
         biobank flags at M=524288, --fused 0 and --fused 1: no band
         kernel launched, the same files to the byte, a repeat of the first
         iterations writing the same xhat1, best-iterate alignment >= 0.9;
         seconds of load/R, precond/eig and infer.
     9c. phase 4's M=65536 int8 files through cli.main as a process group
         of one over NCCL (--coordinator-address localhost:<free port>
         --num-processes 1 --process-id 0), --fused 0 and 1: the files of
         the run without the flags to the byte, the log naming NCCL.
     9d. python -m sgvamp_torch.dryrun's dryrun_multichip(8) on the card:
         the six operators over a (2, 4) mesh whose cells are all the
         card, two steps each against the unsharded steps; the quantized
         and a float spill kernel launched.
  10. the last modules: --profile-dir, the genotype simulators, plots:
     10a. phase 4's hybrid run (--fused 0) and 7c's (--fused 1) at M=524288
          again with --profile-dir: cli_run's checks, one trace file
          (process0.*.pt.trace.json) whose JSON parses and whose
          sym_band_packed_kernel<B, S, true> (hybrid) events equal the
          run's launches (the
          wrapper's eager count, a fused run's warm-ups included, plus its
          graph replays), no other band kernel in it, and the output files
          of the unprofiled run to the byte; the trace's MB and the infer
          seconds with and without it.
     10b. simulate gen-phen-mult (N=16384, M=8192, K=2, h2 0.8, lam 0.1,
          seed 0; dense genotypes on the host, seconds printed), then
          cli.main --K 2 over its files with --operator dense (no band
          kernel) and --operator sym --ld-dtype int8, then bfloat16,
          --block-size 128 without --bandwidth (the whole upper triangle,
          hb >= nb - 1): the int8 kernel, and the float diag kernel
          (sym_band_matvec: mode "auto" takes the streamed kernel there),
          once per LD pass, best-iterate alignment >= 0.9 in each and each
          sym run within 0.02 of the dense one, the three runs' infer
          seconds; the int8 kernel against its plain version at that shape
          (K=2, S=2) with the wrapper's tiles of the band
          (ops/band_kernel.py::_int8_tiles, which must cut the diagonals
          there) and with the runs alone (G=1, every diagonal), the same
          bits on a repeat, the two timed beside each other, the plain
          version, the bound and torch.matmul over the dense float32
          panel, the block bytes the counting build copies (every held
          block once); the float diag kernel over the same panel in
          bfloat16 and float32 blocks the same way, with its wrapper's
          tiles (_float_tiles, which must cut the diagonals there) and the
          runs alone (8 block rows, every diagonal), beside torch.matmul
          over the dense panel in the block type; the streamed slab kernel
          over the same blocks in bfloat16 and float32 the same way, with
          its wrapper's tiles (_slab_tiles, which must cut the diagonals
          there) and the runs of 8 it took before them (8 block rows,
          every diagonal); then the engine (EM, CG_MAXIT forced, 5
          iterations) over the panel in bfloat16, each cohort's own
          blocks and r, in diag and in slab layout with the same probes:
          sym_band_matvec, then sym_slab_matvec_streamed, once per LD pass
          and no other band kernel, best-iterate alignment >= 0.9 in each
          and the slab run's within 0.005 of the diag run's.
     10c. write_bed an N=16384 x M=8192 panel (binomial(2, 0.4), seed 1),
          read_bed it back (equal; MB/s), simulate phen over it, R from
          the same standardized genotypes on the card in float64, then
          cli.main --operator sym --ld-dtype int8: the int8 kernel once
          per LD pass, best-iterate alignment >= 0.9.
     10d. where matplotlib imports: cli.plots over 10b's CSVs and
          cli.vis_ld over one of its R files, each PNG written; where it
          does not, a line says so.
  11. the port bench and its A/B matrix, each a `python -m` child of this
     script over the problem cache phase 2 fills with its M=524288 panel
     (the bench's own problem, equal to the bit), so the host generates it
     once:
     11a. python -m sgvamp_torch.bench at its default size, the solve on:
          exit 0 and no child error, the timed state finite, the
          StopMonitor's iterate aligned >= 0.9 (printed beside phase 3's),
          matvec_ms and the fused iter_ms_median within 15% of phase 6b's
          chained int8 operator pass and 7a's fused s/iteration, 102 int8
          launches a timed step by graph replay (none eager) and in the
          host loop, the read probe and the int8 kernel launched by the
          matvec child, the int8 kernel by the solve child, the int8
          preconditioned solve converged; its JSON line printed;
     11b. first every wrapper the A/B matrix launches (int8, int4, hybrid
          and bfloat16 diag streamed, bfloat16 slab streamed, bfloat16
          resident) on the card at its shapes, M=16384, bandwidth 128, S=2,
          B=128 and 256, and at M=524288, bandwidth 256, B=256, against its
          plain version (scaled error <= 1e-5); then python -m
          sgvamp_torch.utils.ab_matrix --size small, the whole grid with
          steps and solves: a row per storage x block x layout, the
          quantized slab cells "unsupported", every other cell measured
          and launching its own kernel and no other, every step row
          measured with its storage's kernel (22 launches a timed step) and
          its StopMonitor's iterate aligned >= 0.9, int8's preconditioned
          solve converged (int4 stalling is that row's finding), and every
          wrapper launched at a block size it was checked at; its document
          printed on one line.
Then a JSON line of the kernels' numbers, and the result line last.
"""

import dataclasses
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# bench geometry (bench.py _params / N_SAMPLES, LAM, H2)
M_FULL, BW_FULL, B_FULL = 524288, 256, 128
M_CLI_SMALL = 65536
N_SAMPLES, LAM, H2 = 300000, 0.01, 0.7
SCALED_TOL = 1e-5     # kernel vs plain version: max|dy| / max|y|
F64_TOL = 1e-12
ITERATIONS = 6        # engine library path (fixed CG budget)
FLAVOR_ITERATIONS = 4 # the same over the slab-streamed and the resident operator
MESH_ITERATIONS = 4   # the same under the (1, 4) mesh
MESH_SHARDS = 4
WIDE_HB = 16          # the wide band: mode "auto" takes the streamed kernels from hb=15
# sharded against unsharded engine run, same seed, per iteration: relative L2
# of xhat1, relative difference of gam1 and gamw (on an H100 the runs differ
# by at most 6.3e-14 in xhat1 and not at all in gam1 and gamw: only the head
# rows of a shard sum in another order)
MESH_XHAT_TOL, MESH_PARAM_TOL = 1e-5, 1e-4
CLI_ITERATIONS = 10
MLE_ITERATIONS = 4    # phase 8a: the engine path under MLE
STOP_TOL, STOP_DROP = 1e-4, 10.0   # the engine paths' StopMonitor thresholds
# a fused run against its host-loop counterpart, per iteration: max|d| / max|x|
# of xhat1, gam1 and gamw (the same kernels on the same inputs: equal bits
# are expected, the tolerance is the kernels')
FUSED_TOL = SCALED_TOL
PROFILED_BLOCKS = 512  # of the 8192 64 x 64 blocks whose eigh torch.profiler traces
CG_MAXIT = 100
MIN_ALIGNMENT = 0.9
# phase 11a: the port bench's matvec_ms and fused iter_ms against phase 6b's
# chained int8 operator pass and 7a's fused s/iteration, relative
BENCH_TOL = 0.15
# phase 10: the dense genotype generators (numpy on the host, as in the JAX
# package): gen-phen-mult's cohorts and the .bed panel, and their signal
MULT_N, MULT_M = 16384, 8192
MULT_ITERATIONS = 5   # 10b's engine runs over its panel, diag and slab bfloat16
BED_N, BED_M = 16384, 8192
SIM_LAM, SIM_H2 = 0.1, 0.8
STORAGES = ("int8", "bfloat16", "float32", "int4", "hybrid")
# the kernels of the slab layout and the resident mode: (layout, mode, window),
# the wrapper each must take, and the kernel_bench variants that name it
FLAVORS = {"slab-streamed": ("slab", "streamed", False),
           "resident": ("diag", "resident", False),
           "window": ("diag", "resident", True),
           "slab-resident": ("slab", "resident", False)}
FLAVOR_WRAPPER = {"slab-streamed": "sym_slab_matvec_streamed",
                  "resident": "sym_band_matvec_resident",
                  "window": "sym_band_matvec_window",
                  "slab-resident": "sym_slab_matvec_resident"}
BENCH_VARIANTS = {"einsum": None, "streamed": "sym_band_matvec",
                  "resident": "sym_band_matvec_resident", "window": "sym_band_matvec_window",
                  "slab": "sym_slab_matvec_resident", "slabstreamed": "sym_slab_matvec_streamed",
                  "slabresident": "sym_slab_matvec_resident"}
BENCH_PASSES = 20
# the spill forms: the wrapper each storage (or "slab-streamed" flavor) takes
SPILL_WRAPPER = {"int8": "sym_band_matvec_int8_spill", "bfloat16": "sym_band_matvec_spill",
                 "float32": "sym_band_matvec_spill", "float64": "sym_band_matvec_spill",
                 "int4": "sym_band_matvec_int4_spill", "hybrid": "sym_band_matvec_hybrid_spill",
                 "slab-streamed": "sym_slab_matvec_streamed_spill"}

# NVIDIA H100 SXM data sheet: HBM bytes/s, dense operations/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "int4": 1979e12, "hybrid": 1979e12,
            "bfloat16": 989e12, "float32": 67e12}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, n: int) -> float:
    """Mean ms per call of fn over n calls, by CUDA events, after one
    warm-up call. The card first sleeps for 20 ms while the host enqueues,
    so that calls shorter than their host-side launch are timed back to
    back on the card."""
    import torch

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


def kernel_and_plain_ms(kernel, plain, n_kernel: int = 50, n_plain: int = 5) -> tuple:
    """(kernel ms, plain ms), the minimum of two timings each, taken in the
    order plain, kernel, kernel, plain so both see the same card state."""
    t_plain = [cuda_ms(plain, n_plain)]
    t_kern = [cuda_ms(kernel, n_kernel) for _ in range(2)]
    t_plain.append(cuda_ms(plain, n_plain))
    return min(t_kern), min(t_plain)


def scaled_err(y, y_ref) -> tuple:
    """(max abs error, max abs error / max |y_ref|)."""
    err = float((y - y_ref).abs().max())
    return err, err / float(y_ref.abs().max())


def kernel_vs_plain(op, S: int, seed: int, what: str, tol: float = SCALED_TOL) -> tuple:
    """Run the operator's kernel and its plain version on one random x
    (K, S, M) on the card; fail above `tol`. Returns (abs err, scaled err)."""
    import torch

    from sgvamp_torch.ops.band_kernel import band_kernel_of

    kernel, plain, args, xdt = band_kernel_of(op, S)
    x = torch.randn((op.K, S, op.M), generator=torch.Generator(op.upper.device).manual_seed(seed),
                    device=op.upper.device).to(xdt)
    y = kernel(*args, x)
    torch.cuda.synchronize()
    abs_err, rel = scaled_err(y, plain(*args, x))
    if not rel <= tol:
        fail(f"{kernel.__name__}, {what}: scaled error {rel:.3e} > {tol}")
    return abs_err, rel


def held_blocks(nb: int, hb: int) -> int:
    """Stored blocks of one cohort's band that hold data: the nb diagonal
    blocks and, for each d = 1..hb, the nb - d that lie inside the matrix
    (the rest of the nb (hb + 1) slots are zero past its end)."""
    return nb + sum(max(nb - d, 0) for d in range(1, hb + 1))


def bound_ms(op, S: int, storage: str) -> tuple:
    """The least time the card could take for one matvec of `op` with S
    lanes: (ms, "bytes" or "operations", bytes moved). Bytes: the blocks
    that hold data and their scales (every slot of the storage has the same
    bytes), x read once, y written once, over the HBM rate; operations: two
    per stored element and lane for each block product the band holds (row
    and mirror), over the peak rate of the storage's type."""
    xb, yb = {"float32": (4, 4), "float64": (8, 8)}.get(storage, (2, 4))
    held = held_blocks(op.nb, op.hb)
    nbytes = (op.bytes_per_pass() * held // (op.nb * (op.hb + 1))
              + op.K * S * op.M * (xb + yb))
    ops = 2.0 * S * op.K * (2 * held - op.nb) * op.B * op.B
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[storage]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes)


def design_block_bytes(op, S: int, spill: bool = False) -> int:
    """Bytes of blocks the operator's kernel reads a pass (all cohorts) by
    its design, worked out here, not measured; with spill, of the spill form
    over the shard `op` (whose blocks past its end multiply the halo, so it
    reads them too). The streamed kernels over float and int8 blocks read
    every block once (their partial sums are not blocks); the int4 and
    hybrid ones gather: every off-diagonal slot twice. The resident kernels
    read every block once, and at each run boundary the blocks of the
    previous run's last hb rows whose mirror terms cross it once more. The
    int8 kernel's count is also measured (counted_block_bytes)."""
    from sgvamp_torch.ops.band_kernel import _resident_rows

    nb, hb = op.nb, op.hb
    # stored off-diagonal blocks that hold data
    off = nb * hb if spill else held_blocks(nb, hb) - nb
    if not spill and op._use_resident(S):
        G = _resident_rows(op.upper, S, op.rows_per_step)
        off += sum(1 for r0 in range(G, nb, G) for a in range(1, min(hb, r0) + 1)
                   for d in range(a, hb + 1) if d - a < G and r0 + d - a < nb)
    elif op.packed or op.hybrid:
        off *= 2
    full_block = op.B * op.B * op.upper.element_size()
    far_block = full_block // 2 if op.packed or op.hybrid else full_block
    d0_block = far_block if op.packed else full_block
    return op.K * (nb * d0_block + off * far_block)


def counted_block_bytes(op, S: int, kernel, args, x, spill: bool = False) -> int:
    """The block bytes the int8 kernel copies in one pass over x, counted by
    the kernel itself (band_kernel.int8_block_bytes: the build of
    csrc/sym_band_int8.cu with a counter); fails unless the count is the
    design's, every stored block that holds data once."""
    from sgvamp_torch.ops.band_kernel import int8_block_bytes

    read = int8_block_bytes(lambda: kernel(*args, x))
    design = design_block_bytes(op, S, spill)
    if read != design:
        fail(f"{kernel.__name__} copied {read} block bytes in a pass, its design {design}")
    return read


def wide_band(dev, S: int) -> dict:
    """The wide-band case: random bfloat16 blocks at hb=16, M=524288 (zero
    past the panel's end, as from_band leaves them), where mode "auto" takes
    the streamed kernels. The streamed diag and slab kernels and the
    resident diag kernel forced onto the band (runs of 8 block rows), each
    against its plain version (scaled error <= SCALED_TOL) and timed beside
    it; their bounds and the block bytes each reads."""
    import torch

    from sgvamp_torch.ops.band_kernel import SymBandedLD, band_kernel_of

    nb, hb = M_FULL // B_FULL, WIDE_HB
    g = torch.Generator(dev).manual_seed(16)
    upper = torch.randn((1, nb, hb + 1, B_FULL, B_FULL), generator=g, device=dev,
                        dtype=torch.bfloat16)
    for d in range(1, hb + 1):
        upper[:, nb - d:, d] = 0
    op = SymBandedLD(upper=upper, mode="streamed")
    if SymBandedLD.fits_shared_memory(hb, B_FULL, S, 2):
        fail(f"mode 'auto' would take the resident kernel at hb={hb}")
    res = {}
    for name, o in (("streamed", op), ("slab-streamed", with_flavor(op, "slab-streamed")),
                    ("resident", dataclasses.replace(op, mode="resident", rows_per_step=8))):
        abs_err, rel = kernel_vs_plain(o, S, 16, f"{name}, wide band hb={hb}")
        kernel, plain, args, xdt = band_kernel_of(o, S)
        x = torch.randn((1, S, o.M), generator=torch.Generator(dev).manual_seed(0),
                        device=dev).to(xdt)
        ms_kern, ms_plain = kernel_and_plain_ms(lambda: kernel(*args, x),
                                                lambda: plain(*args, x), n_kernel=20,
                                                n_plain=2)
        b_ms, b_by, nbytes = bound_ms(o, S, "bfloat16")
        res[name] = {"kernel": kernel.__name__, "hb": hb, "M": o.M, "S": S,
                     "abs_err": abs_err, "rel_err": rel, "ms": ms_kern, "plain_ms": ms_plain,
                     "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                     "design_block_bytes": design_block_bytes(o, S)}
        print(f"[2 wide band] {kernel.__name__}, random bfloat16 blocks, hb={hb}, M={o.M}, "
              f"S={S}: scaled error {rel:.2e} (tol {SCALED_TOL}); kernel {ms_kern:.4f} ms/pass, "
              f"plain {ms_plain:.4f}, bound {b_ms:.4f} ms ({b_by}), "
              f"{res[name]['design_block_bytes']} block bytes read by its design of "
              f"{o.bytes_per_pass()} stored", flush=True)
    return res


def shard_bound_ms(piece, S: int, storage: str) -> tuple:
    """bound_ms for the spill form over one shard: its blocks and scales and
    x with the halo read once, y_l and carry written once; two operations
    per stored element and lane for each block product the shard takes (its
    rows' row terms, and the mirror terms of its blocks into y_l or carry)."""
    xb, yb = {"float32": (4, 4), "float64": (8, 8)}.get(storage, (2, 4))
    rows = piece.nb + piece.hb
    nbytes = piece.bytes_per_pass() + piece.K * S * rows * piece.B * (xb + yb)
    ops = 2.0 * S * piece.K * piece.nb * (2 * piece.hb + 1) * piece.B * piece.B
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[storage]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes)


def one_card_mesh(n_cohort: int, n_shard: int):
    """A mesh whose every cell is the card."""
    import torch

    from sgvamp_torch.parallel.sharding import make_mesh

    return make_mesh(n_cohort, n_shard, devices=[torch.device("cuda:0")] * (n_cohort * n_shard))


def shard_operator(op, n_shard: int):
    """`op` cut n_shard ways over a one-card mesh, through shard_inputs."""
    import torch

    from sgvamp_torch import VampInputs
    from sgvamp_torch.parallel.sharding import shard_inputs

    dev = op.upper.device
    inputs = VampInputs(op=op, r=torch.zeros((op.K, op.M), device=dev),
                        a=torch.ones(op.K, device=dev), N=torch.ones(op.K, device=dev))
    return shard_inputs(inputs, one_card_mesh(1, n_shard)).op


def spill_vs_plain(op, n_shard: int, S: int, seed: int, what: str, tol: float) -> tuple:
    """Every shard's spill kernel against its plain version on the card,
    both outputs; then the shards composed (each carry added into the next
    shard's head) against the unsharded kernel's y, the last shard's carry
    exactly zero, and the sharded operator's matvec against the unsharded
    one's. Fails above `tol` (scaled by max |y|). Returns (the worst
    absolute error of a kernel against its plain version, the worst scaled
    error of all comparisons, the sharded operator)."""
    import torch

    from sgvamp_torch.ops.band_kernel import band_kernel_of

    dev = op.upper.device
    sh = shard_operator(op, n_shard)
    whole, _, wargs, xdt = band_kernel_of(op, S)
    x = torch.randn((op.K, S, op.M), generator=torch.Generator(dev).manual_seed(seed),
                    device=dev).to(xdt)
    want = whole(*wargs, x)
    scale = float(want.abs().max())
    hbB, M_l = op.hb * op.B, op.M // n_shard
    xpad = torch.cat([x, x.new_zeros(op.K, S, hbB)], dim=2)
    worst_abs = worst = 0.0
    ys, carry = [], None
    for j, piece in enumerate(sh.shards[0]):
        kernel, plain, args, _ = band_kernel_of(piece, S, spill=True)
        x_ext = xpad[:, :, j * M_l:(j + 1) * M_l + hbB].contiguous()
        y_l, spilled = kernel(*args, x_ext)
        torch.cuda.synchronize()
        for got, ref, name in zip((y_l, spilled), plain(*args, x_ext), ("y_l", "carry")):
            err = float((got - ref).abs().max())
            worst_abs, worst = max(worst_abs, err), max(worst, err / scale)
            if got.shape != ref.shape or not err / scale <= tol:
                fail(f"{kernel.__name__}, {what}, shard {j} of {n_shard}: {name} "
                     f"{tuple(got.shape)} scaled error {err / scale:.3e} > {tol}")
        if j and hbB:
            y_l[:, :, :hbB] += carry
        carry = spilled
        ys.append(y_l)
    if float(carry.abs().max()) != 0.0:
        fail(f"{what}: the last shard's carry is not exactly zero "
             f"(max {float(carry.abs().max()):.3e})")
    rel = float((torch.cat(ys, dim=2) - want).abs().max()) / scale
    lanes = x.transpose(0, 1).reshape(S * op.K, op.M).to(want.dtype)
    rel_op = scaled_err(sh.matvec(lanes), op.matvec(lanes))[1]
    if not max(rel, rel_op) <= tol:
        fail(f"{what}: {n_shard} shards composed against the unsharded kernel: scaled "
             f"error {rel:.3e}, sharded against unsharded operator {rel_op:.3e} > {tol}")
    return worst_abs, max(worst, rel, rel_op), sh


def with_flavor(op, flavor: str):
    """A float diag-layout operator on the card as the operator of `flavor`
    over the same blocks (slab storage by transposing them there)."""
    layout, mode, window = FLAVORS[flavor]
    upper = op.upper
    if layout == "slab":
        K, nb, nslot, B, _ = upper.shape
        upper = upper.transpose(-1, -2).reshape(K, nb, nslot * B, B).contiguous()
    return dataclasses.replace(op, upper=upper, layout=layout, mode=mode, window=window)


def reset_launches() -> None:
    from sgvamp_torch.ops.band_kernel import BAND_KERNELS
    from sgvamp_torch.ops.membench import _read_once

    for w in BAND_KERNELS:
        w.launches = 0
    _read_once.launches = 0


def band_launches() -> dict:
    from sgvamp_torch.ops.band_kernel import BAND_KERNELS

    return {w.__name__: w.launches for w in BAND_KERNELS}


def gen_band(prefix: str, M: int) -> float:
    """Write the panel files {prefix}_R.npz, _r.npy, _bet.npy through the
    simulation command line; returns the seconds it took."""
    from sgvamp_torch.cli import simulate as cli_simulate

    t0 = time.perf_counter()
    rc = cli_simulate.main(["gen-band", "-out", prefix, "-N", str(N_SAMPLES), "-M", str(M),
                            "-h2", str(H2), "-lam", str(LAM), "--bandwidth", str(BW_FULL),
                            "--seed", "0", "--uncompressed"])
    if rc != 0:
        fail(f"cli.simulate gen-band returned {rc}")
    return time.perf_counter() - t0


def load_panel(prefix: str, M: int) -> tuple:
    """(band, r, x0) of the files gen_band wrote, through the loaders the
    command line uses."""
    from sgvamp_torch.data import loaders

    band, bw, dropped = loaders.csr_to_band(loaders.load_R(prefix + "_R.npz"), BW_FULL)
    if dropped or bw != BW_FULL or band.shape != (M, 2 * BW_FULL + 1):
        fail(f"csr_to_band: band {band.shape}, bandwidth {bw}, dropped {dropped}")
    r = loaders.load_r(prefix + "_r.npy", M, N_SAMPLES)
    x0 = loaders.load_true_signal(prefix + "_bet.npy", M, N_SAMPLES)
    return band, r, x0


def engine_over(op, r, M, device, cg_maxit=CG_MAXIT, mesh=None, prior_update="em",
                prior=(LAM, H2), n=N_SAMPLES):
    """The bench's engine over a packed operator: float32, the prior learned
    by `prior_update` (EM by default), a fixed CG budget; under `mesh`
    where one is given. r (M,) for one cohort or (K, M), each of n samples;
    prior the (lam, h2) of the signal, its variance scaled as the command
    line scales it (by the samples of all cohorts)."""
    import torch

    from sgvamp_torch import PriorState, VampConfig, VampEngine, VampInputs

    r = np.atleast_2d(np.asarray(r, np.float32))
    K = r.shape[0]
    mask = torch.zeros(op.M, dtype=torch.float32, device=device)
    mask[:M] = 1.0
    rp = torch.zeros((K, op.M), dtype=torch.float32, device=device)
    rp[:, :M] = torch.from_numpy(r)
    cfg = VampConfig(prior_update=prior_update, dtype="float32", cg_maxit=cg_maxit,
                     cg_force_maxiter=True, em_prior_maxit=5, rho=0.5,
                     lmmse_damp=True)
    lam, h2 = prior
    cm = max(int(M * lam), 1)
    state = PriorState.create(lam, [1.0], [h2 / cm * n * K], device=device)
    inputs = VampInputs(op=op, r=rp,
                        a=torch.full((K,), 1.0 / K, dtype=torch.float32, device=device),
                        N=torch.full((K,), float(n), device=device),
                        mask=mask)
    return VampEngine(inputs, cfg, state, gamw=5.0, gam1=1e-6, mesh=mesh)


def mult_engine_run(op, rs, x0, own: str, u) -> dict:
    """Phase 10b's engine run over the dense panel's K=2 operator `op`: the
    bench's engine (engine_over: EM, a fixed CG budget) with gen-phen-mult's
    prior, both cohorts' r (K, M) and the probes u (MULT_ITERATIONS, K,
    op.M) injected, started with the launch counts at zero, and its checks:
    `own` once per LD pass (CG_MAXIT + 2 a step) and no other band kernel,
    a finite best iterate aligned with x0 at MIN_ALIGNMENT or better."""
    import torch

    from sgvamp_torch.core.vamp import alignment_l2

    M = rs.shape[1]
    engine = engine_over(op, rs, M, op.upper.device, prior=(SIM_LAM, SIM_H2), n=MULT_N)
    reset_launches()
    t0 = time.perf_counter()
    hist = engine.run(MULT_ITERATIONS, fixed_u=u, x0=x0, stop_tol=STOP_TOL,
                      stop_gam1_drop=STOP_DROP)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = band_launches()
    executed = hist.get("stopped_at", hist.get("aborted_at", MULT_ITERATIONS - 1)) + 1
    passes = (CG_MAXIT + 2) * executed
    what = f"10b engine over {own}"
    if launches[own] != passes:
        fail(f"{what}: {launches[own]} launches for {passes} LD passes")
    moved = {k: v for k, v in launches.items() if k != own and v}
    if moved:
        fail(f"{what}: other band kernels were launched: {moved}")
    best = hist["best_xhat1"]
    if "aborted_at" in hist or hist["best_it"] < 0 or not np.all(np.isfinite(best)):
        fail(f"{what}: non-finite state before the best iterate (best_it {hist['best_it']})")
    align = alignment_l2(best, x0)[0]
    if not align >= MIN_ALIGNMENT:
        fail(f"{what}: best-iterate alignment {align:.5f} < {MIN_ALIGNMENT}")
    return {"launches": launches[own], "passes": passes, "executed": executed,
            "best_it": hist["best_it"], "alignment": align,
            "alignments": [float(v) for v in hist["alignment"]],
            "s_per_iteration": total_s / executed}


def small_engine(device, seed=3):
    from sgvamp_torch.data.simulate import simulate_ld_band
    from sgvamp_torch.ops.band_kernel import SymBandedLD

    M = 16384
    band, r, _ = simulate_ld_band(N_SAMPLES, M, 256, h2=H2, lam=LAM,
                                  rng=np.random.default_rng(seed))
    op = SymBandedLD.from_band(band, block_size=128, dtype="int8", device=device)
    return engine_over(op, r, M, device, cg_maxit=20)


class LogCapture(logging.Handler):
    """Keeps the messages of the "sgvamp" logger while a run is driven."""

    def __init__(self) -> None:
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record) -> None:
        self.lines.append(record.getMessage())

    def __enter__(self):
        logging.getLogger("sgvamp").addHandler(self)
        return self

    def __exit__(self, *exc) -> None:
        logging.getLogger("sgvamp").removeHandler(self)

    def floats(self, pattern: str) -> list:
        return [float(m.group(1)) for ln in self.lines
                for m in [re.search(pattern, ln)] if m]


def cli_run(prefix: str, out_dir: str, M: int, ld_dtype: str, own, extra=(),
            operator: str = "sym", K: int = 1, per_pass: int = 1, tag: str = "",
            inputs=None, truth=None, iterations: int = CLI_ITERATIONS, label=None,
            check_alignment: bool = True, native=True, prior=(LAM, H2)) -> dict:
    """One production-mode run of sgvamp_torch.cli.main over the panel
    files at `prefix` (the README's biobank flags), with its checks.
    `own` is the name of the wrapper this storage must launch, None for an
    operator that launches no band kernel (--operator banded). K > 1 gives
    the panel K times; per_pass is the launches an LD pass makes (the mesh
    cells of a sharded run); tag goes into the output files' name.
    `inputs` replaces the data flags (LD, r and signal files, --N, --M,
    --bandwidth) and `truth` the true signal of the reference panel, both
    for the .ld path of phase 4b. Every ingestion step must have taken the
    native library. `iterations` is the run's --iterations; `label` the
    phase printed; check_alignment False leaves out the alignment check (a
    resumed run, whose monitor starts after the first iterations); native
    False for an operator built from the CSR, which takes no native step
    (--operator blocksparse), None for a dense .npy panel, whose CSR ->
    band has only its numpy path (in both packages). prior: the (lam, h2)
    of the panel's signal, from which --prior-probs and --prior-vars are
    set."""
    import torch

    from sgvamp_torch.cli import main as cli_main
    from sgvamp_torch.core.vamp import alignment_l2
    from sgvamp_torch.io.writers import read_bin
    from sgvamp_torch.utils import profiling

    name = f"bb_{operator}_{ld_dtype}{tag}"
    lam, h2 = prior
    cm = max(int(M * lam), 1)
    if inputs is None:
        inputs = ["--ld-files", ",".join([prefix + "_R.npz"] * K),
                  "--r-files", ",".join([prefix + "_r.npy"] * K),
                  "--true-signal-file", prefix + "_bet.npy",
                  "--N", str(N_SAMPLES), "--M", str(M), "--bandwidth", str(BW_FULL)]
    argv = [*inputs, "--out-dir", out_dir, "--out-name", name, "--K", str(K),
            "--iterations", str(iterations),
            "--prior-probs", f"{1 - lam:g},{lam:g}", "--prior-vars", f"0,{h2 / cm:.6g}",
            "--operator", operator, "--ld-dtype", ld_dtype, "--block-size", str(B_FULL),
            "--cg-maxit", "500", "--cg-rtol", "1e-5",
            "--cg-precond-block", "64", "--cg-precond-dtype", "bfloat16",
            "--lmmse-damp", "1", "--rho", "0.5", "--stop-on-divergence", "1", *extra]
    reset_launches()
    profiling.reset()
    t0 = time.perf_counter()
    with LogCapture() as log:
        rc = cli_main.main(argv)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = band_launches()
    snap = profiling.snapshot()
    spent = {k: v["seconds"] for k, v in snap["totals"].items()}
    steps = snap["totals"].get("sgv.step", {"calls": 0})["calls"]
    flags = "".join(f" {e}" for e in extra)
    what = f"cli.main --operator {operator} --ld-dtype {ld_dtype}{flags} at M={M}"
    if rc != 0:
        fail(f"{what} returned {rc}")
    for need in (f"{name}_cohort_{K}.csv", f"{name}_metrics.csv", f"{name}_xhat_it_0.bin",
                 f"{name}_xhat_best.bin"):
        if not os.path.exists(os.path.join(out_dir, need)):
            fail(f"{what}: output file {need} missing (have {sorted(os.listdir(out_dir))})")
    # the tracer's counters: a fused run replays its pieces from graphs
    # ("replays.<piece>"), each run once eagerly (its warm-up) before its
    # capture, so its LD passes are the replays'
    fused = {k: v for k, v in snap["counts"].items()
             if k.startswith(("replays.", "reads.", "graph_launches."))} or None
    warm_up = {}
    if fused:
        warm_up = {k: v for k, v in counts.items() if v}
        counts = {k[len("graph_launches."):]: v for k, v in fused.items()
                  if k.startswith("graph_launches.")}
    passes = [snap["counts"].get("ld_passes", 0)]
    if sum(passes) == 0:
        fail(f"{what}: the run logged no LD pass")
    if own is not None and counts.get(own, 0) != per_pass * sum(passes):
        fail(f"{what}: {own} launched {counts.get(own, 0)} times, the run logged "
             f"{sum(passes)} LD passes of {per_pass} launches each")
    others = {k: v for k, v in list(counts.items()) + list(warm_up.items()) if k != own and v}
    if others:
        fail(f"{what}: other band kernels were launched: {others}")
    routes = [ln for ln in log.lines if "through the n" in ln and "path" in ln]
    if native is not None and ((native and not routes)
                               or any("through the numpy path" in ln for ln in routes)):
        fail(f"{what}: ingestion did not run through the native library only: {routes}")
    with open(os.path.join(out_dir, f"{name}_cohort_1.csv")) as f:
        rows = [ln.split("\t") for ln in f.read().splitlines()[1:]]
    if not rows or not np.all(np.isfinite(np.asarray(rows, dtype=np.float64))):
        fail(f"{what}: non-finite or missing rows in {name}_cohort_1.csv")
    stopped = [ln for ln in log.lines
               if ln.startswith(("STOP at iteration", "Early stop at iteration"))]
    if any("ERROR: non-finite" in ln for ln in log.lines) or not (
            stopped or len(rows) == iterations):
        fail(f"{what}: the run neither stopped through the StopMonitor nor ran "
             f"{iterations} iterations ({len(rows)} rows)")
    best = read_bin(os.path.join(out_dir, f"{name}_xhat_best.bin"))
    bet = np.load(prefix + "_bet.npy").reshape(-1) if truth is None else truth
    if best.shape != (M,) or not np.all(np.isfinite(best)):
        fail(f"{what}: best iterate has shape {best.shape} or is not finite")
    align = alignment_l2(best, bet)[0]
    if check_alignment and not align >= MIN_ALIGNMENT:
        fail(f"{what}: best-iterate alignment {align:.5f} < {MIN_ALIGNMENT}")
    early = [int(v) for v in log.floats(r"Early stop at iteration (\d+)")]
    chosen = [int(v) for v in log.floats(r"Selected iterate \(iteration (-?\d+)\) written")]
    res = {"operator": operator, "ld_dtype": ld_dtype, "M": M, "K": K, "flags": list(extra),
           "launches": counts.get(own, 0) if own else 0, "iterations": len(rows),
           "stopped_at": early[0] if early else None, "best_it": chosen[0] if chosen else None,
           "name": name, "fused": fused, "warm_up_launches": warm_up,
           "passes": passes, "ingest_s": spent.get("cli.load.R", 0.0),
           "precond_eig_s": spent.get("cli.precond.eig", 0.0),
           "infer_s": spent.get("cli.infer", 0.0),
           "s_per_iteration": (spent["sgv.fit" if fused else "sgv.step"] / steps
                               if steps else float("nan")),
           "total_s": total_s, "alignment": align, "routes": routes,
           "stop": stopped[0] if stopped else "ran all iterations",
           "checkpoint_bytes": [int(v) for v in log.floats(r"\[checkpoint\] .*: (\d+) bytes")],
           "checkpoint_s": log.floats(r"\[checkpoint\] .* bytes in ([0-9.]+) s"),
           "resumed": any(ln.startswith("Resumed from checkpoint") for ln in log.lines),
           "backend": next((m.group(1) for ln in log.lines
                            for m in [re.search(r"over the (\w+) backend", ln)] if m), None),
           "blocks_stored": next((ln for ln in log.lines
                                  if ln.startswith("Block-sparse LD:")), None)}
    label = label or ("4b" if truth is not None else ("7c" if fused else ("6d" if tag else "4")))
    print(f"[{label} cli] --operator {operator} --ld-dtype {ld_dtype}{flags}, "
          f"K={K}, M={M}: {total_s:.1f} s in all; "
          f"ingestion (load/R) {res['ingest_s']:.2f} s, "
          f"preconditioner eigendecomposition {res['precond_eig_s']:.2f} s, inference "
          f"{res['infer_s']:.2f} s = {res['s_per_iteration']:.4f} s/iteration "
          f"({'the fused fits over their steps' if fused else 'the host loop steps mean'}); "
          f"{len(rows)} iterations, LD passes {passes}, "
          f"{own or 'band kernel'} launches {res['launches']}"
          f"{f' by graph replays (and {warm_up} in the warm-ups)' if fused else ''}, other "
          f"band kernels 0; "
          f"{res['stop']}; best-iterate alignment "
          f"{align:.5f}", flush=True)
    return res


def host_ingestion(prefix: str, dev) -> dict:
    """The command line's load/R at M_FULL in its parts, on the host: the
    .npz load, CSR -> band, the hybrid (and int8) packing, the copy to the
    card; the native band and packs held bitwise against the numpy
    versions, each path timed."""
    import torch

    from sgvamp_torch import native
    from sgvamp_torch.data import loaders
    from sgvamp_torch.ops.band_kernel import pack_hybrid, pack_int8

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0

    def same_bits(a, b):
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
            a.view(np.uint8), b.view(np.uint8))

    t = {}
    csr, t["npz_load"] = timed(loaders.load_R, prefix + "_R.npz")
    (band, bw, dropped), t["band_native"] = timed(loaders.csr_to_band, csr, BW_FULL)
    (band_np, _, _), t["band_numpy"] = timed(loaders.csr_to_band_numpy, csr, BW_FULL)
    if dropped or bw != BW_FULL or not same_bits(band, band_np):
        fail(f"native CSR -> band differs from the numpy version (dropped {dropped}, bw {bw})")
    del band_np, csr
    packs = {}
    for what, nat, plain in (("hybrid", native.band_pack_hybrid, pack_hybrid),
                             ("int8", native.band_pack_i8, pack_int8)):
        packs[what], t[f"pack_{what}_native"] = timed(nat, band, B_FULL)
        want, t[f"pack_{what}_numpy"] = timed(plain, band, B_FULL)
        if packs[what] is None or not all(same_bits(a, b) for a, b in zip(packs[what], want)):
            fail(f"native {what} packing differs from the numpy version (or did not run)")
        del want

    def to_card(upper, scales):
        out = [torch.from_numpy(a).to(dev)[None].contiguous() for a in (upper, scales)]
        torch.cuda.synchronize()
        return out
    _, t["copy_to_card_hybrid"] = timed(to_card, *packs["hybrid"])
    parts = t["npz_load"] + t["band_native"] + t["pack_hybrid_native"] + t["copy_to_card_hybrid"]
    print(f"[4 ingestion] M={M_FULL}, host: .npz load {t['npz_load']:.2f} s, CSR -> band "
          f"native {t['band_native']:.2f} s (numpy {t['band_numpy']:.2f} s, bitwise equal), "
          f"hybrid pack native {t['pack_hybrid_native']:.2f} s (numpy "
          f"{t['pack_hybrid_numpy']:.2f} s, bitwise equal), int8 pack native "
          f"{t['pack_int8_native']:.2f} s (numpy {t['pack_int8_numpy']:.2f} s, bitwise equal), "
          f"copy of the hybrid blocks to the card {t['copy_to_card_hybrid']:.2f} s; the parts "
          f"of the hybrid run's load/R add up to {parts:.2f} s (PERF.md §5: load/R 8.38 s on an "
          f"H100 through the numpy path)", flush=True)
    return dict(t, parts_s=parts)


def precond_eig_profile(band, dev) -> dict:
    """Where the hybrid run's precond/eig goes: torch.linalg.eigh over the
    M_FULL / 64 diagonal 64 x 64 blocks, in one chunk and in chunks of 2048,
    on the card and on the host; block_jacobi_eig (what VampEngine calls),
    timed; torch.linalg.eigh over PROFILED_BLOCKS of the blocks under
    torch.profiler (the whole batch makes a trace of about 90 launches a
    block, whose processing takes minutes), its top operations by device
    and by host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sgvamp_torch.core.precond import _extract_sub_blocks, block_jacobi_eig
    from sgvamp_torch.ops.band_kernel import SymBandedLD

    op = SymBandedLD.from_band(band, block_size=B_FULL, dtype="hybrid", device=dev)
    D = _extract_sub_blocks(op, 64).reshape(-1, 64, 64)
    D = 0.5 * (D + D.transpose(-1, -2))
    out = {"blocks": int(D.shape[0])}

    def eigh_s(x, chunk):
        t0 = time.perf_counter()
        for i in range(0, x.shape[0], chunk):
            torch.linalg.eigh(x[i:i + chunk])
        if x.is_cuda:
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    eigh_s(D[:64], 64)        # warm-up: the solver's first call
    for where, x in (("card", D), ("host", D.cpu())):
        for chunk in (x.shape[0], 2048):
            out[f"eigh_{where}_chunk{chunk}_s"] = eigh_s(x, chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    block_jacobi_eig(op, 64, 2048, torch.bfloat16)
    torch.cuda.synchronize()
    out["block_jacobi_eig_s"] = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.linalg.eigh(D[:PROFILED_BLOCKS])
        torch.cuda.synchronize()
    ev = prof.key_averages()

    def top(events, attr):
        rows = sorted(events, key=lambda e: getattr(e, attr), reverse=True)[:6]
        return [(e.key, e.count, round(getattr(e, attr) / 1e3, 3)) for e in rows]
    # device time from the kernels themselves (aten ops would count it twice)
    out["top_by_device_ms"] = top([e for e in ev if e.device_type == DeviceType.CUDA],
                                  "device_time_total")
    out["top_by_host_ms"] = top(ev, "cpu_time_total")
    print(f"[4 precond/eig] {out['blocks']} blocks of 64 x 64 (the hybrid run's): "
          f"torch.linalg.eigh on the card {out[f'eigh_card_chunk{D.shape[0]}_s']:.3f} s in one "
          f"chunk, {out['eigh_card_chunk2048_s']:.3f} s in chunks of 2048; on the host "
          f"{out[f'eigh_host_chunk{D.shape[0]}_s']:.3f} s / {out['eigh_host_chunk2048_s']:.3f} s; "
          f"block_jacobi_eig {out['block_jacobi_eig_s']:.3f} s; eigh over {PROFILED_BLOCKS} "
          f"blocks under torch.profiler, top operations by device time (name, calls, ms) "
          f"{out['top_by_device_ms']}, by host time {out['top_by_host_ms']}",
          flush=True)
    return out


def write_ld_cohorts(prefix: str, work: str) -> dict:
    """Two cohorts' PLINK files from the panel at `prefix` (M_CLI_SMALL):
    .bim files on two chromosomes that share positions (markers 0..M/2-1 on
    chromosome 1, the rest on 2, at the same base pairs), each cohort
    without its own 2% of the markers and with its own N; a .ld table each
    with PLINK's header and the one-sided pairs i < j of the panel's band
    (within a chromosome) among its own markers, R to 9 decimals in fixed
    width; r files over its own markers, in local order (the panel's r
    scaled by sqrt(N_k / N)). Returns the command line's data flags, the
    true signal in the order of the merged panel and the text's size."""
    import scipy.sparse

    from sgvamp_torch.data import harmonize, loaders

    M, half = M_CLI_SMALL, M_CLI_SMALL // 2
    rng = np.random.default_rng(11)
    gone = rng.permutation(M)[:2 * (M // 50)].reshape(2, -1)     # disjoint 2% each
    N = [N_SAMPLES, 2 * N_SAMPLES // 3]
    R = scipy.sparse.triu(loaders.load_R(prefix + "_R.npz"), k=1).tocoo()
    keep = (R.row < half) == (R.col < half)                          # within a chromosome
    a, b, v = R.row[keep].astype(np.int64), R.col[keep].astype(np.int64), R.data[keep]
    del R
    chrom = np.where(np.arange(M) < half, 1, 2)
    bp = 10000 + 100 * (np.arange(M) % half)
    # a marker's "CHR BP SNP" and R's field in fixed width, as bytes
    rec = np.frombuffer("".join(f"{c:>6}{p:>13}{'rs' + str(i):>13}" for i, (c, p)
                                in enumerate(zip(chrom, bp))).encode(), np.uint8).reshape(M, 32)
    header = (f"{'CHR_A':>6}{'BP_A':>13}{'SNP_A':>13}{'CHR_B':>6}{'BP_B':>13}{'SNP_B':>13}"
              f"{'R':>14}\n").encode()
    r_panel = np.load(prefix + "_r.npy").reshape(-1)
    flags = {"ld": [], "bim": [], "r": [], "M": []}
    nbytes = 0
    for k, tag in enumerate(("ca", "cb")):
        own = np.ones(M, bool)
        own[gone[k]] = False
        idx = np.flatnonzero(own)
        with open(os.path.join(work, tag + ".bim"), "w") as f:
            f.writelines(f"{chrom[i]}\trs{i}\t0\t{bp[i]}\tA\tG\n" for i in idx)
        np.save(os.path.join(work, tag + "_r.npy"), r_panel[idx] * np.sqrt(N[k] / N_SAMPLES))
        sel = np.flatnonzero(own[a] & own[b])
        path = os.path.join(work, tag + ".ld")
        with open(path, "wb") as f:
            f.write(header)
            for lo in range(0, sel.size, 1 << 21):
                s_ = sel[lo:lo + (1 << 21)]
                q = np.rint(np.abs(v[s_]) * 1e9).astype(np.int64)
                line = np.empty((s_.size, 79), np.uint8)      # 2 x 32, then R in 14
                line[:, :32] = rec[a[s_]]
                line[:, 32:64] = rec[b[s_]]
                line[:, 64:66] = ord(" ")
                line[:, 66] = np.where(v[s_] < 0, ord("-"), ord(" "))
                line[:, 67] = ord("0") + q // 1000000000
                line[:, 68] = ord(".")
                frac = q % 1000000000
                for d in range(9):
                    line[:, 77 - d] = ord("0") + frac % 10
                    frac //= 10
                line[:, 78] = ord("\n")
                f.write(line.tobytes())
        nbytes += os.path.getsize(path)
        flags["ld"].append(path)
        flags["bim"].append(os.path.join(work, tag + ".bim"))
        flags["r"].append(os.path.join(work, tag + "_r.npy"))
        flags["M"].append(str(idx.size))
    # the merged panel's order (harmonize is deterministic on one machine):
    # the true signal goes to the command line in that order
    panel = harmonize.harmonize(flags["bim"], N)
    order = np.array([int(rs_[2:]) for rs_ in panel.variants])
    bet = np.load(prefix + "_bet.npy").reshape(-1)[order]
    np.save(os.path.join(work, "ld_bet.npy"), bet)
    inputs = ["--ld-files", ",".join(flags["ld"]), "--bim-files", ",".join(flags["bim"]),
              "--r-files", ",".join(flags["r"]), "--true-signal-file",
              os.path.join(work, "ld_bet.npy"), "--N", ",".join(map(str, N)),
              "--M", ",".join(flags["M"])]
    return {"inputs": inputs, "truth": bet, "order": order, "ld_bytes": nbytes,
            "pairs_in_band": int(a.size), "N": N}


def engine_run(op, r, x0, own: str, iterations: int, phase: str, before_run=None,
               mesh=None) -> dict:
    """VampEngine.run at the bench geometry over `op` with a fixed CG
    budget, started with the launch counts at zero, and its checks: 102
    launches of `own` per executed iteration (times the mesh's cells under
    `mesh`, which cuts `op`) and no other band kernel, a best iterate that
    is finite and aligned, the reference-format files. `before_run(engine)`
    runs after the counts are reset and before the run (the read probe of
    phase 3)."""
    import torch

    from sgvamp_torch.core.vamp import alignment_l2
    from sgvamp_torch.io.writers import OutputWriter, read_bin
    from sgvamp_torch.ops.membench import _read_once

    device = op.upper.device
    engine = engine_over(op, r, M_FULL, device, mesh=mesh)
    per_it = 102 * (mesh.devices.size if mesh is not None else 1)
    stamps = []
    reset_launches()
    extra = before_run(engine) if before_run else None
    with tempfile.TemporaryDirectory() as out_dir:
        writer = OutputWriter(out_dir, "smoke", K=1)
        t0 = time.perf_counter()
        hist = engine.run(iterations, writer=writer, x0=x0, stop_tol=STOP_TOL,
                          stop_gam1_drop=STOP_DROP,
                          callback=lambda it, s, a: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = dict(band_launches(), read_max=_read_once.launches)
        files = sorted(os.listdir(out_dir))
        best_it = hist["best_it"]
        best_bin = (read_bin(writer.xhat_path(best_it))
                    if best_it >= 0 and os.path.exists(writer.xhat_path(best_it)) else None)
    end_it = hist.get("stopped_at", hist.get("aborted_at", iterations - 1))
    executed = end_it + 1
    s_per_it = float(np.median(np.diff(stamps))) if len(stamps) > 1 else float("nan")
    best = hist["best_xhat1"]
    best_align = alignment_l2(best, x0)[0] if best is not None else float("nan")
    print(f"[{phase}] {executed} iterations, {s_per_it:.4f} s/iteration "
          f"(median after the first), {own} launches {launches[own]} (expect "
          f"{per_it * executed}), probe launches {launches['read_max']}; alignment "
          f"{[round(v, 5) for v in hist['alignment']]}; stop {hist.get('stop_reason')} at "
          f"{hist.get('stopped_at')}; best iterate {best_it}, alignment {best_align:.5f}",
          flush=True)
    if launches[own] != per_it * executed:
        fail(f"{phase}: {own} launched {launches[own]} times, expected {per_it * executed}")
    moved = {k: v for k, v in launches.items() if k not in (own, "read_max") and v}
    if moved:
        fail(f"{phase}: the engine path over {own} launched other band kernels: {moved}")
    if "aborted_at" in hist or best_it < 0 or not np.all(np.isfinite(best)):
        fail(f"{phase}: non-finite state before the best iterate (best_it {best_it})")
    if best.shape != (M_FULL,):
        fail(f"{phase}: best iterate has shape {best.shape}, expected ({M_FULL},)")
    if not best_align >= MIN_ALIGNMENT:
        fail(f"{phase}: best-iterate alignment {best_align:.5f} < {MIN_ALIGNMENT}")
    for need in ("smoke_cohort_1.csv", "smoke_metrics.csv", "smoke_xhat_it_0.bin"):
        if need not in files:
            fail(f"{phase}: output file {need} missing (have {files})")
    if best_bin is None or not np.array_equal(best_bin, best.astype(np.float64)):
        fail(f"{phase}: smoke_xhat_it_{best_it}.bin does not hold the best iterate")
    return {"launches": launches, "executed": executed, "s_per_iteration": s_per_it,
            "mean_s_per_iteration": total_s / executed,
            "alignment": best_align, "extra": extra, "xhat1": hist["xhat1"],
            "params": hist["params"], "best_it": best_it, "best_xhat1": best,
            "stopped_at": hist.get("stopped_at")}


def profiled_steps(run, kernel_name: str, steps: int = 2) -> tuple:
    """run() (`steps` VAMP steps) under torch.profiler: (device ms a step,
    summed over the trace's device events: kernels, kernels inside CUDA
    graphs, copies and fills; launches of `kernel_name` a step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.device_time_total for e in ev) / 1e3 / steps
    return device_ms, sum(e.count for e in ev if kernel_name in e.key) / steps


def fused_run(op, r, x0, own: str, iterations: int, phase: str, host: dict,
              mesh=None) -> dict:
    """Phase 7a / 7b: the engine run of `host` (phase 3's or 6c's host-loop
    run, same operator, seed and stop thresholds) as run_scan_stoppable, the
    step's CUDA graphs captured by a first 2-step run. The measured run must
    launch no kernel eagerly, and its replays `own` 102 times per executed
    iteration (times the mesh's cells); every iteration's xhat1, gam1 and
    gamw within FUSED_TOL of the host loop's (max|d| / max|x|), the same
    stop and best iterate. Then one 2-step run of each mode under
    torch.profiler: device ms a step, and the int8 kernel's launches in the
    fused run's trace (kernels inside the graphs)."""
    import torch

    device = op.upper.device
    engine = engine_over(op, r, M_FULL, device, mesh=mesh)
    per_it = 102 * (mesh.devices.size if mesh is not None else 1)
    t0 = time.perf_counter()
    engine.run_scan_stoppable(2, STOP_TOL, STOP_DROP)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    _, aux, mon = engine.run_scan_stoppable(iterations, STOP_TOL, STOP_DROP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eager = {k: v for k, v in band_launches().items() if v}
    replayed, reads = engine.fused.launches(), dict(engine.fused.reads)
    n = int(mon.n_ran)
    stopped_at = int(mon.stopped_at) if bool(mon.done) else None
    if eager:
        fail(f"{phase}: the fused run launched kernels eagerly: {eager}")
    if replayed != {own: per_it * n}:
        fail(f"{phase}: graph replays launched {replayed}, expected {{{own!r}: {per_it * n}}}")
    if n != host["executed"] or stopped_at != host["stopped_at"]:
        fail(f"{phase}: ran {n} iterations, stopped at {stopped_at}; the host loop "
             f"{host['executed']}, {host['stopped_at']}")
    if int(mon.best_it) != host["best_it"]:
        fail(f"{phase}: best iterate {int(mon.best_it)}, the host loop's {host['best_it']}")
    dev = {"xhat1": [], "gam1": [], "gamw": []}
    same = True
    for it in range(n):
        want = {"xhat1": np.asarray(host["xhat1"][it]),
                "gamw": np.asarray(host["params"][it])[:, 1],
                "gam1": np.asarray(host["params"][it])[:, 2]}
        for name in dev:
            got = getattr(aux, name)[it].cpu().numpy().reshape(want[name].shape)
            same = same and np.array_equal(got, want[name].astype(got.dtype))
            dev[name].append(float(np.abs(got - want[name]).max() / np.abs(want[name]).max()))
    best = mon.best_xhat1.cpu().numpy()
    best_dev = float(np.abs(best - host["best_xhat1"]).max() / np.abs(host["best_xhat1"]).max())
    if not max(max(v) for v in dev.values()) <= FUSED_TOL or not best_dev <= FUSED_TOL:
        fail(f"{phase}: the fused run deviates from the host loop: {dev}, best {best_dev}")
    fused_ms, traced = profiled_steps(lambda: engine.run_scan_stoppable(2, STOP_TOL, STOP_DROP),
                                      "sym_band_int8_kernel")
    host_ms, _ = profiled_steps(lambda: engine.run(2, stop_tol=STOP_TOL,
                                                   stop_gam1_drop=STOP_DROP),
                                "sym_band_int8_kernel")
    if traced != per_it:
        fail(f"{phase}: the profiler traced {traced} int8 kernels a fused step, "
             f"the capture counted {per_it}")
    s_it = wall / n
    res = {"executed": n, "stopped_at": stopped_at, "best_it": int(mon.best_it),
           "launches": replayed, "host_reads": reads, "host_reads_per_step": {
               k: v / n for k, v in reads.items()},
           "deviation": dev, "best_deviation": best_dev, "bitwise_equal": same,
           "capture_run_s": capture_s, "s_per_iteration": s_it,
           "host_s_per_iteration": host["mean_s_per_iteration"],
           "host_median_s_per_iteration": host["s_per_iteration"],
           "device_ms_per_step": fused_ms, "host_device_ms_per_step": host_ms,
           "busy_share": fused_ms / 1e3 / s_it,
           "host_busy_share": host_ms / 1e3 / host["s_per_iteration"],
           "traced_int8_kernels_per_step": traced}
    print(f"[{phase}] {n} iterations fused, stop at {stopped_at}, best iterate "
          f"{res['best_it']} (host loop: the same); {own} launched {replayed.get(own)} times by "
          f"graph replays ({per_it} a step, {traced} a step in the profiler's trace), none "
          f"eagerly; host reads a step {res['host_reads_per_step']}; against the host loop, "
          f"max|d|/max|x| per iteration: xhat1 {[f'{v:.1e}' for v in dev['xhat1']]}, gam1 "
          f"{[f'{v:.1e}' for v in dev['gam1']]}, gamw {[f'{v:.1e}' for v in dev['gamw']]}, best "
          f"{best_dev:.1e} (tol {FUSED_TOL}), bit for bit: {same}; {s_it:.4f} s/iteration "
          f"(host loop {host['mean_s_per_iteration']:.4f}, median after the first "
          f"{host['s_per_iteration']:.4f}); device {fused_ms:.2f} ms a step (host loop "
          f"{host_ms:.2f}), busy {100 * res['busy_share']:.1f}% of the fused run's mean step "
          f"(host loop {100 * res['host_busy_share']:.1f}% of its median step); capture run "
          f"of 2 steps {capture_s:.2f} s",
          flush=True)
    return res


def graphed_ms(fn, n: int = 5) -> float:
    """ms per call of fn captured once into a CUDA graph (after a warm-up
    call on a side stream) and replayed, by cuda_ms; the capture's wrapper
    counts are taken back (a capture launches nothing)."""
    import torch

    from sgvamp_torch.ops.band_kernel import BAND_KERNELS

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    counts = [w.launches for w in BAND_KERNELS]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for w, c in zip(BAND_KERNELS, counts):
        w.launches = c
    return cuda_ms(graph.replay, n)


def compare_cli_files(host: dict, host_dir: str, fused: dict, fused_dir: str) -> dict:
    """Phase 7c: the fused command-line run against the host loop's
    (phase 4) over the same files: the same file set, the same stop and
    best iterate, every .bin and every CSV column within FUSED_TOL (max|d| /
    max|x|); how many files are equal to the byte."""
    from sgvamp_torch.io.writers import read_bin

    def files(d, name):
        out = {}
        for f in os.listdir(d):
            rest = f[len(name) + 1:]
            if f.startswith(name + "_") and rest.split("_")[0] in ("cohort", "metrics", "xhat",
                                                                  "r1"):
                out[rest] = os.path.join(d, f)
        return out

    a, b = files(host_dir, host["name"]), files(fused_dir, fused["name"])
    if sorted(a) != sorted(b):
        fail(f"7c: the fused run wrote {sorted(b)}, the host loop {sorted(a)}")
    if (fused["stopped_at"], fused["best_it"]) != (host["stopped_at"], host["best_it"]):
        fail(f"7c: stop and best iterate {fused['stopped_at']}, {fused['best_it']}; the host "
             f"loop's {host['stopped_at']}, {host['best_it']}")
    worst, equal = 0.0, 0
    for rest in sorted(a):
        with open(a[rest], "rb") as fa, open(b[rest], "rb") as fb:
            equal += fa.read() == fb.read()
        if rest.endswith(".bin"):
            x, y = read_bin(a[rest]), read_bin(b[rest])
        else:
            x, y = (np.loadtxt(p, delimiter="\t", skiprows=1, ndmin=2) for p in (a[rest], b[rest]))
        if x.shape != y.shape:
            fail(f"7c: {rest}: shape {y.shape}, the host loop's {x.shape}")
        scale = np.maximum(np.abs(x).max(axis=0), 1e-300)
        worst = max(worst, float(np.max(np.abs(y - x).max(axis=0) / scale)))
    if not worst <= FUSED_TOL:
        fail(f"7c: the fused run's files deviate from the host loop's by {worst:.3e}")
    res = {"files": len(a), "byte_equal": equal, "worst_deviation": worst,
           "infer_s": fused["infer_s"], "host_infer_s": host["infer_s"]}
    print(f"[7c cli] --fused 1 against phase 4's host loop: the same {len(a)} files, "
          f"{equal} equal to the byte, worst max|d|/max|x| {worst:.1e} (tol {FUSED_TOL}); "
          f"stop {fused['stopped_at']}, best iterate {fused['best_it']} (the same); infer "
          f"{fused['infer_s']:.2f} s against {host['infer_s']:.2f} s", flush=True)
    return res


def compare_runs(sharded: dict, whole: dict, phase: str) -> dict:
    """A sharded engine run against the unsharded run from the same seed:
    per iteration up to the unsharded run's best iterate (past it the run
    is diverging and amplifies any rounding), the relative L2 difference of
    xhat1 and the relative differences of gam1 and gamw (the largest over
    cohorts). Fails above MESH_XHAT_TOL and MESH_PARAM_TOL."""
    n = min(len(sharded["xhat1"]), whole["best_it"] + 1)
    dev = {"xhat1": [], "gam1": [], "gamw": []}
    for it in range(n):
        a, b = np.asarray(sharded["xhat1"][it], np.float64), np.asarray(whole["xhat1"][it],
                                                                        np.float64)
        dev["xhat1"].append(float(np.linalg.norm(a - b) / np.linalg.norm(b)))
        pa, pb = np.asarray(sharded["params"][it]), np.asarray(whole["params"][it])
        for name, col in (("gamw", 1), ("gam1", 2)):
            dev[name].append(float(np.max(np.abs(pa[:, col] - pb[:, col]) / np.abs(pb[:, col]))))
    print(f"[{phase}] against the unsharded run of the same seed, iterations 0..{n - 1}: "
          f"xhat1 relative L2 {[f'{v:.2e}' for v in dev['xhat1']]} (tol {MESH_XHAT_TOL}), "
          f"gam1 {[f'{v:.2e}' for v in dev['gam1']]}, gamw {[f'{v:.2e}' for v in dev['gamw']]} "
          f"(tol {MESH_PARAM_TOL})", flush=True)
    if n == 0 or not max(dev["xhat1"]) <= MESH_XHAT_TOL:
        fail(f"{phase}: xhat1 deviates from the unsharded run: {dev['xhat1']}")
    if not max(dev["gam1"] + dev["gamw"]) <= MESH_PARAM_TOL:
        fail(f"{phase}: gam1 or gamw deviates from the unsharded run: {dev}")
    return dev


def mle_engine_run(op, r, x0, em_host: dict, em_fused: dict) -> dict:
    """Phase 8a: phase 3's engine run (int8, M_FULL, same seed, fixed CG
    budget, StopMonitor) with prior_update="mle", MLE_ITERATIONS steps in the
    host loop and, after a 2-step run that captures the graphs, through
    run_scan_stoppable. Each run starts with the launch counts at zero; the
    host loop must launch the int8 kernel 102 times an executed iteration
    and no other band kernel, the fused run nothing eagerly and 102 int8
    launches a step by replay. Every iteration's xhat1, gam1, gamw, lam and
    mle_ok equal between the two bit for bit, at least one MLE update
    accepted, the best iterate's alignment >= MIN_ALIGNMENT. Device ms a
    step from torch.profiler over steps 1-2 (each with an MLE update) of
    each mode."""
    import torch

    from sgvamp_torch.core.vamp import alignment_l2

    phase, own, per_it = "8a engine path, MLE", "sym_band_matvec_int8", 102
    engine = engine_over(op, r, M_FULL, op.upper.device, prior_update="mle")
    mle_ok, stamps = [], []

    def keep(it, state, aux):
        mle_ok.append(bool(aux.mle_ok))
        stamps.append(time.perf_counter())

    reset_launches()
    t0 = time.perf_counter()
    hist = engine.run(MLE_ITERATIONS, x0=x0, stop_tol=STOP_TOL, stop_gam1_drop=STOP_DROP,
                      callback=keep)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    host_launches = {k: v for k, v in band_launches().items() if v}
    n = len(hist["xhat1"])
    if host_launches != {own: per_it * n}:
        fail(f"{phase}: the host loop launched {host_launches}, expected {{{own!r}: {per_it * n}}}")
    t0 = time.perf_counter()
    engine.run_scan_stoppable(2, STOP_TOL, STOP_DROP)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    _, aux, mon = engine.run_scan_stoppable(MLE_ITERATIONS, STOP_TOL, STOP_DROP)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    eager = {k: v for k, v in band_launches().items() if v}
    replayed, reads = engine.fused.launches(), dict(engine.fused.reads)
    if eager:
        fail(f"{phase}: the fused run launched kernels eagerly: {eager}")
    if int(mon.n_ran) != n or int(mon.best_it) != hist["best_it"]:
        fail(f"{phase}: the fused run ran {int(mon.n_ran)} steps, best {int(mon.best_it)}; the "
             f"host loop {n}, best {hist['best_it']}")
    if replayed != {own: per_it * n}:
        fail(f"{phase}: graph replays launched {replayed}, expected {{{own!r}: {per_it * n}}}")
    for it in range(n):
        p = np.asarray(hist["params"][it], np.float64)
        pairs = {"xhat1": (aux.xhat1[it], hist["xhat1"][it]), "gamw": (aux.gamw[it], p[:, 1]),
                 "gam1": (aux.gam1[it], p[:, 2]), "lam": (aux.lam[it], p[0, 6]),
                 "mle_ok": (aux.mle_ok[it], mle_ok[it])}
        for name, (got, want) in pairs.items():
            got = got.cpu().numpy()
            if not np.array_equal(got, np.asarray(want).astype(got.dtype)):
                fail(f"{phase}: iteration {it}: {name} of the fused run differs from the host "
                     f"loop's")
    if not any(mle_ok[1:]):
        fail(f"{phase}: no MLE update was accepted ({mle_ok})")
    best = hist["best_xhat1"]
    align = alignment_l2(best, x0)[0] if best is not None else float("nan")
    if not align >= MIN_ALIGNMENT:
        fail(f"{phase}: best-iterate alignment {align:.5f} < {MIN_ALIGNMENT}")
    state1 = engine.run(1)["state"]
    fused_ms, traced = profiled_steps(
        lambda: engine.run_scan_stoppable(2, STOP_TOL, STOP_DROP, state=state1),
        "sym_band_int8_kernel")
    host_ms, _ = profiled_steps(lambda: engine.run(2, state=state1), "sym_band_int8_kernel")
    res = {"executed": n, "stopped_at": hist.get("stopped_at"), "best_it": hist["best_it"],
           "alignment": align, "mle_ok": mle_ok, "lam": [float(v) for v in aux.lam[:n].cpu()],
           "launches": host_launches, "fused_launches": replayed, "host_reads": reads,
           "host_reads_per_step": {k: v / n for k, v in reads.items()},
           "newton_chunks_per_step": reads["mle"] / n,
           "s_per_iteration": float(np.median(np.diff(stamps))) if n > 1 else float("nan"),
           "mean_s_per_iteration": host_s / n, "fused_s_per_iteration": fused_s / n,
           "capture_run_s": capture_s, "device_ms_per_step": host_ms,
           "fused_device_ms_per_step": fused_ms, "traced_int8_kernels_per_step": traced}
    print(f"[{phase}] {n} iterations, stop {res['stopped_at']}, best iterate {res['best_it']} "
          f"(fused: the same), alignment {align:.5f}; MLE accepted {mle_ok}, lam "
          f"{[f'{v:.6f}' for v in res['lam']]}; every iteration's xhat1, gam1, gamw, lam and "
          f"mle_ok equal bit for bit in both modes; {own} {per_it * n} launches in each (the "
          f"fused run's by replay, none eagerly); {res['s_per_iteration']:.4f} s/iteration "
          f"(median after the first; mean {res['mean_s_per_iteration']:.4f}), fused "
          f"{res['fused_s_per_iteration']:.4f}; device {host_ms:.2f} ms a step with MLE (fused "
          f"{fused_ms:.2f}; the fused trace holds {traced} of the {per_it} int8 kernels a "
          f"step); EM (phases 3, 7a): {em_host['s_per_iteration']:.4f} s/iteration, "
          f"fused {em_fused['s_per_iteration']:.4f}, device "
          f"{em_fused['host_device_ms_per_step']:.2f}"
          f" / {em_fused['device_ms_per_step']:.2f} ms a step; fused host reads a step "
          f"{res['host_reads_per_step']}, Newton chunks a step {res['newton_chunks_per_step']:.2f}"
          f"; capture run of 2 steps {capture_s:.2f} s", flush=True)
    return res


def checkpoint_legs(prefix: str, root: str, M: int, ld_dtype: str, own: str, fused: str) -> dict:
    """Phase 8b: cli.main with the biobank flags, --prior-update mle,
    --fused `fused` and --checkpoint-every 2, three times over the panel at
    `prefix`: 4 iterations at once; 2 with --checkpoint-dir; --resume 1 to 4.
    Each run has cli_run's checks (the resumed one launches its kernel once
    per LD pass of its own 2 iterations; its best iterate is not held to
    MIN_ALIGNMENT, see below). The per-iteration files and CSVs
    of the resumed set equal the uninterrupted set's to the byte (the
    selected iterate, xhat_best, is the resumed monitor's own); at most
    `keep` (3) checkpoint files remain."""
    ck = os.path.join(root, f"ck_{M}_{fused}")
    flags = ("--prior-update", "mle", "--fused", fused, "--checkpoint-every", "2")
    label = f"8b checkpoints, --fused {fused}"
    kw = dict(tag="_mle", label=label)
    full_dir = os.path.join(root, f"full_{M}_{fused}")
    res_dir = os.path.join(root, f"res_{M}_{fused}")
    full = cli_run(prefix, full_dir, M, ld_dtype, own, extra=flags, iterations=4, **kw)
    part = cli_run(prefix, res_dir, M, ld_dtype, own, extra=(*flags, "--checkpoint-dir", ck),
                   iterations=2, **kw)
    # the resumed run's monitor starts at iteration 2: its selected iterate
    # is its own, past the uninterrupted run's peak, so it is not held to
    # MIN_ALIGNMENT; its files must equal the uninterrupted run's, which is
    resumed = cli_run(prefix, res_dir, M, ld_dtype, own,
                      extra=(*flags, "--checkpoint-dir", ck, "--resume", "1"), iterations=4,
                      check_alignment=False, **kw)
    if not resumed["resumed"] or part["resumed"]:
        fail(f"{label}: the third run did not resume from the second's checkpoint")
    name = full["name"]
    files = sorted(f for f in os.listdir(full_dir)
                   if f.startswith(name + "_") and f != f"{name}_xhat_best.bin")
    have = sorted(f for f in os.listdir(res_dir)
                  if f.startswith(name + "_") and f != f"{name}_xhat_best.bin")
    if files != have or not files:
        fail(f"{label}: the resumed set wrote {have}, the uninterrupted run {files}")
    differ = [f for f in files if open(os.path.join(full_dir, f), "rb").read()
              != open(os.path.join(res_dir, f), "rb").read()]
    if differ:
        fail(f"{label}: resumed files differ from the uninterrupted run's: {differ}")
    kept = sorted(os.listdir(ck))
    if not 0 < len(kept) <= 3:
        fail(f"{label}: {len(kept)} checkpoint files remain: {kept}")
    saves = part["checkpoint_s"] + resumed["checkpoint_s"]
    sizes = part["checkpoint_bytes"] + resumed["checkpoint_bytes"]
    res = {"M": M, "fused": fused, "files": len(files), "byte_equal": len(files),
           "checkpoints_kept": kept, "saves": len(saves), "save_s": saves,
           "mean_save_s": float(np.mean(saves)) if saves else float("nan"),
           "mb_per_file": float(np.mean(sizes)) / 1e6 if sizes else float("nan"),
           "launches": [full["launches"], part["launches"], resumed["launches"]],
           "infer_s": [full["infer_s"], part["infer_s"], resumed["infer_s"]],
           "alignment": [full["alignment"], part["alignment"], resumed["alignment"]]}
    print(f"[{label}] M={M}: the resumed set's {len(files)} per-iteration files and CSVs equal "
          f"the uninterrupted run's to the byte; {len(kept)} checkpoint files kept ({kept}); "
          f"{len(saves)} saves, {res['mean_save_s']:.4f} s a save ({[f'{v:.4f}' for v in saves]}),"
          f" {res['mb_per_file']:.2f} MB a file; {own} launches {res['launches']}; infer "
          f"{[f'{v:.2f}' for v in res['infer_s']]} s; best-iterate alignment "
          f"{[f'{v:.5f}' for v in res['alignment']]}", flush=True)
    return res


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def blocksparse_full(prefix: str, small_prefix: str, work: str, probe_gbps: float,
                     dev) -> dict:
    """Phase 9a: BlockSparseLD at the bench shape, from phase 4's M_FULL
    panel file: the f64 scipy product as the reference, a repeat equal to
    the bit, ms a pass beside its bounds and the BSR library call, the
    long-range check at M_FULL (and the sym path's warning at
    M_CLI_SMALL)."""
    import scipy.sparse
    import torch

    from sgvamp_torch.cli import main as cli_main
    from sgvamp_torch.core.operators import BlockSparseLD
    from sgvamp_torch.data import loaders

    S, B = 2, B_FULL
    R = loaders.as_csr(loaders.load_R(prefix + "_R.npz"))
    t0 = time.perf_counter()
    op32 = BlockSparseLD.from_csr([R], block_size=B, dtype="float32", device=dev)
    build_s = time.perf_counter() - t0
    ops = {"float32": op32,
           "bfloat16": dataclasses.replace(op32, blocks=op32.blocks.to(torch.bfloat16))}
    nb = op32.nb
    # scipy's own conversion to (B, B) blocks (M_FULL is a multiple of B)
    # holds the same blocks in the same (row, column) order
    bsr = R.tobsr(blocksize=(B, B))
    bsr.sort_indices()
    keys = np.repeat(np.arange(nb), np.diff(bsr.indptr)) * nb + bsr.indices
    want_nnzb = len(keys)
    if not (op32.nnzb == want_nnzb and np.array_equal(
            op32.rows.cpu().numpy().astype(np.int64) * nb + op32.cols.cpu().numpy(), keys)
            and np.array_equal(op32.blocks[0].cpu().numpy(), bsr.data.astype(np.float32))):
        fail(f"9a: from_csr stored {op32.nnzb} blocks; scipy's BSR conversion holds "
             f"{want_nnzb}, or other values")
    del bsr, keys
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(S, M_FULL))).to(
        dev, torch.float32)
    res = {"M": M_FULL, "B": B, "S": S, "nnzb": op32.nnzb, "from_csr_s": build_s}

    def reference(Rm, blocks_dtype):
        """The f64 scipy product of what the blocks hold and x as they see it."""
        Rr = Rm.copy()
        Rr.data = torch.from_numpy(np.asarray(Rm.data, np.float32)).to(
            blocks_dtype).double().numpy()
        xr = x.cpu().to(blocks_dtype).double().numpy()
        return torch.from_numpy(np.asarray(Rr @ xr.T).T.copy())

    for name, op in ops.items():
        y = op.matvec(x)
        if not torch.equal(op.matvec(x), y):
            fail(f"9a: a repeated {name} blocksparse matvec gave other bits")
        want = reference(R, op.blocks.dtype)
        abs_err, rel = scaled_err(y.cpu().double(), want)
        if not rel <= SCALED_TOL:
            fail(f"9a: the {name} blocksparse matvec deviates from scipy's: {rel:.3e}")
        block_bytes = op.bytes_per_pass()
        moved = block_bytes + 2 * S * M_FULL * 4 + 8 * op.nnzb
        ops_s = 2 * S * op.nnzb * B * B / PEAK_OPS[name]
        bytes_s = moved / HBM_BYTES_PER_S
        res[name] = {"block_bytes": block_bytes, "ms": cuda_ms(lambda: op.matvec(x), 10),
                     "bound_ms": max(bytes_s, ops_s) * 1e3,
                     "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                     "block_bytes_hbm_ms": block_bytes / HBM_BYTES_PER_S * 1e3,
                     "block_bytes_probe_ms": block_bytes / (probe_gbps * 1e9) * 1e3,
                     "abs_err": abs_err, "scaled_err": rel}
        # the one-call library product: a BSR tensor times x
        crow = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(torch.bincount(op.rows.long(), minlength=nb), 0)
        try:
            bsr = torch.sparse_bsr_tensor(crow, op.cols.long(), op.blocks[0],
                                          size=(M_FULL, M_FULL))
            X = x.T.contiguous().to(op.blocks.dtype)
            yl = (bsr @ X).T.float()
            lib_rel = scaled_err(yl.cpu().double(), want)[1]
            res[name].update(library_ms=cuda_ms(lambda: bsr @ X, 10),
                             library_scaled_err=lib_rel)
        except (RuntimeError, NotImplementedError, TypeError) as e:
            res[name].update(library_ms=None, library_refused=str(e).splitlines()[0][:200])
        torch.cuda.empty_cache()
    del ops

    # long-range entries: block rows i and i + nb/2 paired every 64 block rows
    rng = np.random.default_rng(11)
    i = np.arange(0, nb // 2, 64)
    rr = (i[:, None, None] * B + np.arange(B)[None, :, None]) + 0 * np.arange(B)[None, None, :]
    cc = ((i[:, None, None] + nb // 2) * B + np.arange(B)[None, None, :]) + 0 * rr
    vals = 0.01 * rng.uniform(-1.0, 1.0, rr.shape).astype(np.float32)
    L = scipy.sparse.coo_matrix((vals.ravel(), (rr.ravel(), cc.ravel())), shape=R.shape)
    R_lr = (R + L + L.T).tocsr()
    op_lr = BlockSparseLD.from_csr([R_lr], block_size=B, dtype="float32", device=dev)
    y_lr = op_lr.matvec(x)
    want_lr, want_band = reference(R_lr, torch.float32), reference(R, torch.float32)
    rel_lr = scaled_err(y_lr.cpu().double(), want_lr)[1]
    effect = scaled_err(want_band, want_lr)[1]
    if op_lr.nnzb != want_nnzb + 2 * len(i) or not rel_lr <= SCALED_TOL or not effect > 1e-4:
        fail(f"9a: long-range blocks: {op_lr.nnzb} stored (expected {want_nnzb + 2 * len(i)}), "
             f"deviation from scipy {rel_lr:.3e}, effect of the entries {effect:.3e}")
    res["long_range"] = {"blocks_added": 2 * len(i), "scaled_err": rel_lr,
                         "effect_on_y": effect}
    del op_lr, R_lr, y_lr
    torch.cuda.empty_cache()

    # one heavy block row: block row h holds a tile in every block column
    # (LD from one region to all others), every other row one more; the
    # bytes one pass holds beyond its inputs, against the stored blocks
    h = nb // 2
    j = np.array([c for c in range(nb) if abs(c - h) > 2])
    L = scipy.sparse.coo_matrix((np.full(len(j), 1e-3, np.float32),
                                 (np.full(len(j), h * B + 5), j * B + 9)), shape=R.shape)
    R_hv = (R + L + L.T).tocsr()
    op_hv = BlockSparseLD.from_csr([R_hv], block_size=B, dtype="float32", device=dev)
    op_hv = dataclasses.replace(op_hv, blocks=op_hv.blocks.to(torch.bfloat16))
    widest = int(torch.bincount(op_hv.rows.long(), minlength=nb).max())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y_hv = op_hv.matvec(x)
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - base
    rel_hv = scaled_err(y_hv.cpu().double(), reference(R_hv, torch.bfloat16))[1]
    res["heavy_row"] = {"nnzb": op_hv.nnzb, "widest_row": widest,
                        "block_bytes": op_hv.bytes_per_pass(), "transient_bytes": transient,
                        "padded_table_bytes": S * nb * widest * B * 4,
                        "ms": cuda_ms(lambda: op_hv.matvec(x), 10), "scaled_err": rel_hv}
    if (widest < nb - 5 or not rel_hv <= SCALED_TOL
            or not transient <= 0.25 * op_hv.bytes_per_pass()):
        fail(f"9a: heavy block row: widest row {widest} of {nb} blocks, deviation from scipy "
             f"{rel_hv:.3e}, {transient} bytes held by a pass over "
             f"{op_hv.bytes_per_pass()} bytes of blocks")
    del op_hv, R_hv, y_hv, R
    torch.cuda.empty_cache()

    # the sym path drops what is outside its band, and says so
    R_sm = loaders.as_csr(loaders.load_R(small_prefix + "_R.npz"))
    nb_sm = M_CLI_SMALL // B
    i = np.arange(0, nb_sm // 2, 64)
    pairs = [(a * B + 3, (a + nb_sm // 2) * B + 5) for a in i]
    L = scipy.sparse.coo_matrix((np.full(len(pairs), 0.01, np.float32),
                                 ([p[0] for p in pairs], [p[1] for p in pairs])),
                                shape=R_sm.shape)
    lr_prefix = os.path.join(work, "lr")
    scipy.sparse.save_npz(lr_prefix + "_R.npz", (R_sm + L + L.T).tocsr(), compressed=False)
    for ext in ("_r.npy", "_bet.npy"):
        os.symlink(small_prefix + ext, lr_prefix + ext)
    sym_warn = {}
    for operator in ("sym", "blocksparse"):
        argv = ["--ld-files", lr_prefix + "_R.npz", "--r-files", lr_prefix + "_r.npy",
                "--N", str(N_SAMPLES), "--M", str(M_CLI_SMALL), "--bandwidth", str(BW_FULL),
                "--iterations", "1", "--operator", operator, "--ld-dtype", "float32",
                "--block-size", str(B)]
        with LogCapture() as log:
            if cli_main.main(argv) != 0:
                fail(f"9a: cli.main --operator {operator} over the long-range panel failed")
        sym_warn[operator] = [ln for ln in log.lines if "outside bandwidth" in ln]
    if len(sym_warn["sym"]) != 1 or sym_warn["blocksparse"]:
        fail(f"9a: the sym run must warn of dropped entries and blocksparse not: {sym_warn}")
    res["sym_warning"] = sym_warn["sym"][0]
    print(f"[9a blocksparse] M={M_FULL}, B={B}, S={S}: {res['nnzb']} blocks "
          f"(from_csr {build_s:.1f} s); " + "; ".join(
              f"{n} {res[n]['ms']:.4f} ms/pass (bound {res[n]['bound_ms']:.4f} ms by "
              f"{res[n]['bound_by']}, block bytes {res[n]['block_bytes_hbm_ms']:.4f} ms at "
              f"3.35 TB/s, {res[n]['block_bytes_probe_ms']:.4f} ms at the probe's "
              f"{probe_gbps:.1f} GB/s), BSR @ x "
              f"{res[n]['library_ms'] if res[n]['library_ms'] is None else round(res[n]['library_ms'], 4)}"
              f" ms, against scipy {res[n]['scaled_err']:.1e}"
              for n in ("bfloat16", "float32")) +
          f"; long-range: {res['long_range']['blocks_added']} blocks kept, against scipy {rel_lr:.1e} (the entries "
          f"move y by {effect:.1e}); heavy block row ({res['heavy_row']['widest_row']} tiles, "
          f"{res['heavy_row']['nnzb']} in all): bfloat16 {res['heavy_row']['ms']:.4f} ms/pass, "
          f"{res['heavy_row']['transient_bytes'] / 1e6:.1f} MB held by a pass over "
          f"{res['heavy_row']['block_bytes'] / 1e6:.1f} MB of blocks (a table padded to the "
          f"widest row would gather {res['heavy_row']['padded_table_bytes'] / 1e9:.2f} GB), "
          f"against scipy {res['heavy_row']['scaled_err']:.1e}; "
          f"--operator sym: {res['sym_warning']!r}", flush=True)
    return res


def same_files(a_dir: str, a_name: str, b_dir: str, b_name: str, what: str,
               only=None) -> int:
    """Fails unless the two runs wrote the same files (after their name),
    equal to the byte; returns how many. only: the suffixes to compare."""
    def files(d, name):
        return {f[len(name):]: os.path.join(d, f) for f in os.listdir(d)
                if f.startswith(name + "_") and (only is None or f[len(name):] in only)}

    a, b = files(a_dir, a_name), files(b_dir, b_name)
    if sorted(a) != sorted(b) or not a:
        fail(f"{what}: file sets differ: {sorted(a)} against {sorted(b)}")
    for rest in a:
        with open(a[rest], "rb") as fa, open(b[rest], "rb") as fb:
            if fa.read() != fb.read():
                fail(f"{what}: {rest} differs")
    return len(a)


def blocksparse_cli(prefix: str, work: str) -> dict:
    """Phase 9b: cli.main --operator blocksparse --ld-dtype bfloat16 with
    the biobank flags at M_FULL, host loop and --fused 1 (the same files to
    the byte), and a repeat of the host loop's first iterations (the same
    xhat1 files to the byte)."""
    runs = {}
    for key, extra, iters in (("host loop", ("--fused", "0"), CLI_ITERATIONS),
                              ("fused", ("--fused", "1"), CLI_ITERATIONS),
                              ("repeat", ("--fused", "0"), 3)):
        runs[key] = cli_run(prefix, os.path.join(work, "bs_" + key.replace(" ", "_")), M_FULL,
                            "bfloat16", None, extra=extra, operator="blocksparse",
                            iterations=iters, label="9b", check_alignment=key != "repeat",
                            native=False)
    name = runs["host loop"]["name"]
    d = {k: os.path.join(work, "bs_" + k.replace(" ", "_")) for k in runs}
    n_equal = same_files(d["host loop"], name, d["fused"], name, "9b --fused 1")
    first = {f"_xhat_it_{i}.bin" for i in range(3)}
    same_files(d["host loop"], name, d["repeat"], name, "9b repeat", only=first)
    for k in ("host loop", "fused"):
        if runs[k]["stopped_at"] != runs["host loop"]["stopped_at"]:
            fail(f"9b: the {k} run stopped at {runs[k]['stopped_at']}")
    print(f"[9b cli] --operator blocksparse: {runs['host loop']['blocks_stored']}; --fused 1 "
          f"wrote the host loop's {n_equal} files to the byte; a repeat wrote the same xhat1 "
          f"files; load/R {runs['host loop']['ingest_s']:.2f} s, precond/eig "
          f"{runs['host loop']['precond_eig_s']:.2f} s, infer "
          f"{runs['host loop']['infer_s']:.2f} s (fused {runs['fused']['infer_s']:.2f} s)",
          flush=True)
    keep = ("iterations", "stopped_at", "best_it", "alignment", "ingest_s", "precond_eig_s",
            "infer_s", "s_per_iteration", "passes", "total_s", "blocks_stored")
    return {k: {f: v[f] for f in keep} for k, v in runs.items()}


def process_group_of_one(small_prefix: str, work: str) -> dict:
    """Phase 9c: phase 4's M_CLI_SMALL int8 files through cli.main as a
    process group of one over NCCL (--coordinator-address, --num-processes
    1, --process-id 0), host loop and fused: the files of the run without
    the flags, to the byte, and the NCCL backend named in the log."""
    import torch.distributed as dist

    res = {}
    for fused in ("0", "1"):
        runs = {}
        for key in ("plain", "group"):
            flags = (["--coordinator-address", f"localhost:{free_port()}", "--num-processes",
                      "1", "--process-id", "0"] if key == "group" else [])
            runs[key] = cli_run(small_prefix, os.path.join(work, f"pg_{key}_{fused}"),
                                M_CLI_SMALL, "int8", "sym_band_matvec_int8",
                                extra=("--fused", fused, *flags), label="9c")
        if runs["group"]["backend"] != "NCCL" or runs["plain"]["backend"] is not None:
            fail(f"9c: backends {runs['group']['backend']} (group), "
                 f"{runs['plain']['backend']} (plain)")
        if dist.is_initialized():
            fail("9c: cli.main left its process group behind")
        name = runs["plain"]["name"]
        n_equal = same_files(os.path.join(work, f"pg_plain_{fused}"), name,
                             os.path.join(work, f"pg_group_{fused}"), name,
                             f"9c --fused {fused}")
        res[f"fused {fused}"] = {"files_equal": n_equal,
                                 "infer_s": runs["group"]["infer_s"],
                                 "plain_infer_s": runs["plain"]["infer_s"],
                                 "launches": runs["group"]["launches"]}
        print(f"[9c process group] --fused {fused}: one process over NCCL wrote the plain "
              f"run's {n_equal} files to the byte; infer {runs['group']['infer_s']:.2f} s "
              f"against {runs['plain']['infer_s']:.2f} s", flush=True)
    return res


def dryrun_on_the_card() -> dict:
    """Phase 9d: sgvamp_torch.dryrun.dryrun_multichip(8) with its default
    devices, the card: two VAMP steps of each of the six operators over a
    (2, 4) mesh whose cells are all the card, against the same steps
    unsharded; the sym operators' spill kernels launched under the mesh."""
    from sgvamp_torch.dryrun import OPERATORS, dryrun_multichip

    reset_launches()
    t0 = time.perf_counter()
    dryrun_multichip(8)
    seconds = time.perf_counter() - t0
    launched = {k: v for k, v in band_launches().items() if v}
    quantized = ("sym_band_matvec_int8_spill", "sym_band_matvec_int4_spill",
                 "sym_band_matvec_hybrid_spill")
    float_spill = [k for k in launched if k.endswith("_spill") and k not in quantized]
    if any(not launched.get(k) for k in quantized) or not float_spill:
        fail(f"9d: the dry run over the card's (2, 4) mesh launched {launched}: every "
             f"quantized spill kernel and a float one must run")
    print(f"[9d dryrun] {len(OPERATORS)} operators over a (2, 4) mesh of the card, two steps "
          f"each, held against the unsharded steps in {seconds:.1f} s; band kernel launches "
          f"{launched}", flush=True)
    return {"seconds": seconds, "launches": launched}


def trace_kernels(trace_dir: str) -> tuple:
    """The one Chrome trace a process group of one writes into trace_dir:
    (path, MB, {band kernel: events} by band_kernel.traced_kernel_counts,
    {band kernel: mean us}, the band kernel events' distinct names)."""
    from sgvamp_torch.ops.band_kernel import TRACED_KERNELS, traced_kernel_counts

    traces = os.listdir(trace_dir)
    if len(traces) != 1 or not re.fullmatch(r"process0\.\d+\.pt\.trace\.json", traces[0]):
        fail(f"--profile-dir {trace_dir}: expected one process0.*.pt.trace.json, have {traces}")
    path = os.path.join(trace_dir, traces[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    counts = traced_kernel_counts(e["name"] for e in kernels)
    mean_us = {k: float(np.mean([e["dur"] for e in kernels if re.search(p, e["name"])]))
               for k, p in TRACED_KERNELS.items() if counts[k]}
    names = sorted({e["name"] for e in kernels
                    if any(traced_kernel_counts([e["name"]]).values())})
    return path, os.path.getsize(path) / 1e6, counts, mean_us, names


def profiled_cli(prefix: str, work: str, ref: dict, ref_dir: str, fused: str) -> dict:
    """Phase 10a: phase 4's (--fused 0) or 7c's (--fused 1) hybrid run at
    M_FULL again with --profile-dir: cli_run's checks; one trace, whose
    hybrid kernel events equal the run's launches (the wrapper's eager
    count, a fused run's warm-ups included, plus its graph replays) and
    which holds no other band kernel; the output files equal to the byte
    to the unprofiled run's."""
    label = f"10a --profile-dir, --fused {fused}"
    own = "sym_band_matvec_hybrid"
    out = os.path.join(work, f"prof_out_{fused}")
    trace_dir = os.path.join(work, f"prof_trace_{fused}")
    res = cli_run(prefix, out, M_FULL, "hybrid", own,
                  extra=("--fused", fused, "--profile-dir", trace_dir), label=label)
    name = res["name"]
    only = {f[len(name):] for f in os.listdir(ref_dir)
            if f.startswith(name + "_") and not f.startswith(name + "_mesh")}
    n_equal = same_files(ref_dir, name, out, name, label, only=only)
    t0 = time.perf_counter()
    path, mb, counts, mean_us, names = trace_kernels(trace_dir)
    read_s = time.perf_counter() - t0
    launches = res["launches"] + res["warm_up_launches"].get(own, 0)
    want = {k: launches if k == "hybrid" else 0 for k in counts}
    if counts != want:
        fail(f"{label}: the trace holds the kernel events {counts} ({names}); the run's counters "
             f"{launches} launches of {own} (graph replays {res['launches'] if res['fused'] else 0}"
             f", eager {res['warm_up_launches'].get(own, 0) if res['fused'] else launches})")
    out_res = {"fused": fused, "trace_mb": mb, "trace_read_s": read_s,
               "kernel_events": counts["hybrid"], "kernel_names": names, "launches": launches,
               "replayed": res["launches"] if res["fused"] else 0,
               "kernel_mean_us": mean_us.get("hybrid"),
               "infer_s": res["infer_s"], "unprofiled_infer_s": ref["infer_s"],
               "files_equal": n_equal, "alignment": res["alignment"]}
    print(f"[{label}] {os.path.basename(path)}: {mb:.1f} MB, read in {read_s:.2f} s; "
          f"hybrid kernel events {counts['hybrid']} = the run's "
          f"{launches} launches ({out_res['replayed']} by graph replay), no other band kernel "
          f"({counts}; {names}), {mean_us.get('hybrid', float('nan')):.1f} us a launch "
          f"by the trace; the "
          f"unprofiled run's {n_equal} files to the byte; infer {res['infer_s']:.2f} s traced "
          f"against {ref['infer_s']:.2f} s", flush=True)
    return out_res


def multi_cohort_path(work: str, dev) -> dict:
    """Phase 10b: simulate gen-phen-mult (dense genotypes on the host, K=2,
    one shared beta), then cli.main --K 2 over its files with --operator
    dense (torch.matmul, no band kernel) and with --operator sym --ld-dtype
    int8 and bfloat16, --block-size 128 and no --bandwidth (the whole upper
    triangle: the band reaches M - 1, so hb >= nb - 1), all at the biobank
    flags: best-iterate alignment >= MIN_ALIGNMENT in each, each sym run
    within 0.02 of the dense one; the int8 kernel, and in the bfloat16 run
    the float diag kernel (mode "auto": the resident kernel does not fit),
    once per LD pass. Then at the runs' shape (K=2, S=2): the int8 kernel
    against its plain version, with the wrapper's tiles
    (ops/band_kernel.py::_int8_tiles) and with the runs alone (G=1, every
    diagonal: the split before tiles), the same bits on a repeat, timed
    beside each other and the plain version, the block bytes the counting
    build copies (every held block once), torch.matmul over the dense
    float32 panel; the float diag kernel over the same panel in bfloat16 and
    float32 blocks, the same way, with the wrapper's tiles
    (ops/band_kernel.py::_float_tiles, which must cut the diagonals there)
    and with the runs alone (DIAG_RUN_ROWS block rows, every diagonal),
    torch.matmul over the dense panel in the block type; the streamed slab
    kernel over the same blocks the same way, with the wrapper's tiles
    (ops/band_kernel.py::_slab_tiles, which must cut the diagonals there)
    and with the runs of SLAB_RUN_ROWS block rows over every diagonal that
    it took before them; and the engine over the panel in bfloat16 blocks
    (each cohort's own), in diag and slab layout with the same probes
    (mult_engine_run), whose best-iterate alignments must agree within
    0.005."""
    import torch

    from sgvamp_torch.cli import simulate as cli_simulate
    from sgvamp_torch.data import loaders
    from sgvamp_torch.ops.band_kernel import (DIAG_RUN_ROWS, SLAB_RUN_ROWS, SymBandedLD,
                                              _float_tiles, _int8_tiles, _slab_tiles, _sm_count,
                                              band_kernel_of)
    from sgvamp_torch.utils.kernel_diag import (forced_float_tiles, forced_int8_tiles,
                                                forced_slab_tiles)

    N, M = MULT_N, MULT_M
    pre = os.path.join(work, "mult")
    t0 = time.perf_counter()
    if cli_simulate.main(["gen-phen-mult", "--out", pre, "--N", str(N), "--M", str(M),
                          "--K", "2", "--h2", str(SIM_H2), "--lam", str(SIM_LAM),
                          "--seed", "0"]) != 0:
        fail("10b: simulate gen-phen-mult failed")
    gen_s = time.perf_counter() - t0
    inputs = ["--ld-files", f"{pre}_0_R.npy,{pre}_1_R.npy",
              "--r-files", f"{pre}_0_r.npy,{pre}_1_r.npy",
              "--true-signal-file", pre + "_bet.npy", "--N", str(N), "--M", str(M)]
    runs = {}
    for key, operator, ld_dtype, own in (("dense", "dense", "float32", None),
                                         ("sym", "sym", "int8", "sym_band_matvec_int8"),
                                         ("sym bfloat16", "sym", "bfloat16", "sym_band_matvec")):
        runs[key] = cli_run(pre, os.path.join(work, "mult_out"), M, ld_dtype, own,
                            operator=operator, K=2, tag="_mult", inputs=inputs,
                            label="10b", native=None, prior=(SIM_LAM, SIM_H2))
    gaps = {k: abs(runs["dense"]["alignment"] - runs[k]["alignment"])
            for k in ("sym", "sym bfloat16")}
    for k, gap in gaps.items():
        if not gap <= 0.02:
            fail(f"10b: best-iterate alignment {runs['dense']['alignment']:.5f} (dense) against "
                 f"{runs[k]['alignment']:.5f} ({k})")
    band = loaders.csr_to_band(np.load(pre + "_0_R.npy"), None)[0]
    op = SymBandedLD.from_band(band, block_size=B_FULL, K=2, dtype="int8", device=dev)
    nb, hb = op.nb, op.hb
    if nb != M // B_FULL or hb < nb - 1:
        fail(f"10b: the int8 operator has nb={nb}, hb={hb}: its band does not cover the panel")
    sms = _sm_count(torch.device(dev))
    tiles = _int8_tiles(nb, hb, sms)
    runs_only = (1, hb + 1)
    if tiles == runs_only:
        fail(f"10b: the int8 wrapper keeps the runs alone (G, D) = {tiles} on the whole triangle")
    abs_err, rel = kernel_vs_plain(op, 2, 10, f"int8 at M={M}, nb={nb}, hb={hb}, K=2")
    kernel, plain, args, xdt = band_kernel_of(op, 2)
    x = torch.randn((op.K, 2, op.M), generator=torch.Generator(dev).manual_seed(3),
                    device=dev).to(xdt)
    y = kernel(*args, x)
    if not torch.equal(y, kernel(*args, x)):
        fail(f"10b: the int8 kernel with tiles {tiles} gives other bits on a repeat")
    del y
    with forced_int8_tiles(*runs_only):
        old_abs_err, old_rel = kernel_vs_plain(op, 2, 10, f"int8 at nb={nb}, hb={hb}, runs alone")
    ms, plain_ms = kernel_and_plain_ms(lambda: kernel(*args, x), lambda: plain(*args, x))

    def old_split():
        with forced_int8_tiles(*runs_only):
            kernel(*args, x)

    # the runs alone in the plain version's place: runs, tiles, tiles, runs
    new_ms, old_ms = kernel_and_plain_ms(lambda: kernel(*args, x), old_split, n_plain=50)
    bound, bound_by, nbytes = bound_ms(op, 2, "int8")
    counted = counted_block_bytes(op, 2, kernel, args, x)
    del op
    # the library calls: torch.matmul over the dense panel (the same R x
    # before quantization or rounding), both cohorts, in float32 and bfloat16
    R = torch.from_numpy(np.load(pre + "_0_R.npy")).to(dev, torch.float32).expand(2, M, M)
    R, xm = R.contiguous(), x.float().transpose(1, 2).contiguous()
    library_ms = {"float32": cuda_ms(lambda: torch.matmul(R, xm), 20)}
    R, xm = R.to(torch.bfloat16), xm.to(torch.bfloat16)
    library_ms["bfloat16"] = cuda_ms(lambda: torch.matmul(R, xm), 20)
    del R, xm
    torch.cuda.empty_cache()
    # the float diag kernel over the same panel, with its tiles and with the
    # runs alone; the slab streamed kernel over the same blocks, with its
    # tiles and with the runs of 8 it took before them
    floats, slabs = {}, {}
    float_runs = (DIAG_RUN_ROWS, hb + 1)
    slab_runs = (SLAB_RUN_ROWS, hb + 1)
    for storage in ("bfloat16", "float32"):
        opf = dataclasses.replace(SymBandedLD.from_band(band, block_size=B_FULL, K=2,
                                                        dtype=storage, device=dev),
                                  mode="streamed")
        ftiles = _float_tiles(nb, hb, sms)
        if ftiles == float_runs:
            fail(f"10b: the float diag wrapper keeps the runs alone {ftiles} on the whole "
                 f"triangle")
        f_abs, f_rel = kernel_vs_plain(opf, 2, 11, f"{storage} at M={M}, nb={nb}, hb={hb}, K=2")
        kf, pf, af, xdf = band_kernel_of(opf, 2)
        xf = x.to(xdf)
        yf = kf(*af, xf)
        if not torch.equal(yf, kf(*af, xf)):
            fail(f"10b: the {storage} diag kernel with tiles {ftiles} gives other bits on a "
                 f"repeat")
        del yf
        with forced_float_tiles(*float_runs):
            fo_abs, fo_rel = kernel_vs_plain(opf, 2, 11, f"{storage} at nb={nb}, hb={hb}, runs "
                                                          f"alone")
        f_ms, f_plain_ms = kernel_and_plain_ms(lambda: kf(*af, xf), lambda: pf(*af, xf))

        def float_old_split():
            with forced_float_tiles(*float_runs):
                kf(*af, xf)

        f_new_ms, f_old_ms = kernel_and_plain_ms(lambda: kf(*af, xf), float_old_split,
                                                 n_plain=20)
        f_bound, f_bound_by, f_bytes = bound_ms(opf, 2, storage)
        floats[storage] = {"nb": nb, "hb": hb, "K": 2, "S": 2, "tiles": list(ftiles),
                           "max_abs_err": f_abs, "scaled_err": f_rel, "ms": f_ms,
                           "plain_ms": f_plain_ms, "bound_ms": f_bound, "bound_by": f_bound_by,
                           "bytes": f_bytes, "library_ms": library_ms[storage],
                           "library_call": f"torch.matmul, dense {storage} panel",
                           "runs_alone": {"tiles": list(float_runs), "ms": f_old_ms,
                                          "tiles_ms": f_new_ms, "max_abs_err": fo_abs,
                                          "scaled_err": fo_rel}}
        del af
        ops = with_flavor(opf, "slab-streamed")
        del opf
        stiles = _slab_tiles(nb, hb, sms, 2, B_FULL, ops.upper.element_size())
        if stiles == slab_runs:
            fail(f"10b: the slab wrapper keeps the runs of {SLAB_RUN_ROWS} on the whole "
                 f"triangle")
        s_abs, s_rel = kernel_vs_plain(ops, 2, 12, f"slab-streamed {storage} at M={M}, "
                                                   f"nb={nb}, hb={hb}, K=2")
        ks, ps, as_, _ = band_kernel_of(ops, 2)
        ys = ks(*as_, xf)
        if not torch.equal(ys, ks(*as_, xf)):
            fail(f"10b: the {storage} slab kernel with tiles {stiles} gives other bits on a "
                 f"repeat")
        del ys
        with forced_slab_tiles(*slab_runs):
            so_abs, so_rel = kernel_vs_plain(ops, 2, 12, f"slab-streamed {storage} at nb={nb}, "
                                                         f"hb={hb}, runs of {SLAB_RUN_ROWS}")
        s_ms, s_plain_ms = kernel_and_plain_ms(lambda: ks(*as_, xf), lambda: ps(*as_, xf))

        def slab_old_split():
            with forced_slab_tiles(*slab_runs):
                ks(*as_, xf)

        # the runs of 8 in the plain version's place: runs, tiles, tiles, runs
        s_new_ms, s_old_ms = kernel_and_plain_ms(lambda: ks(*as_, xf), slab_old_split,
                                                 n_plain=20)
        s_bound, s_bound_by, s_bytes = bound_ms(ops, 2, storage)
        slabs[storage] = {"kernel": ks.__name__, "nb": nb, "hb": hb, "K": 2, "S": 2,
                          "tiles": list(stiles), "max_abs_err": s_abs, "scaled_err": s_rel,
                          "ms": s_ms, "plain_ms": s_plain_ms, "bound_ms": s_bound,
                          "bound_by": s_bound_by, "bytes": s_bytes,
                          "library_ms": library_ms[storage],
                          "library_call": f"torch.matmul, dense {storage} panel",
                          "runs_of_8": {"tiles": list(slab_runs), "ms": s_old_ms,
                                        "tiles_ms": s_new_ms, "max_abs_err": so_abs,
                                        "scaled_err": so_rel}}
        del ops, as_, xf
        torch.cuda.empty_cache()
    # the engine over the panel in bfloat16, each cohort's own blocks, in diag
    # and slab layout, with the same probes
    t1 = time.perf_counter()
    band1 = loaders.csr_to_band(np.load(pre + "_1_R.npy"), None)[0]
    uppers = [SymBandedLD.from_band(b, block_size=B_FULL, dtype="bfloat16", device=dev).upper
              for b in (band, band1)]
    del band1
    ope = SymBandedLD(upper=torch.cat(uppers), mode="streamed")
    del uppers
    pack_s = time.perf_counter() - t1
    rs = np.stack([loaders.load_r(f"{pre}_{k}_r.npy", M, N) for k in range(2)])
    x0 = loaders.load_true_signal(pre + "_bet.npy", M, N)
    u = np.random.default_rng(17).choice(np.float32([-1.0, 1.0]),
                                         size=(MULT_ITERATIONS, 2, ope.M))
    engines = {"diag": mult_engine_run(ope, rs, x0, "sym_band_matvec", u)}
    engines["slab"] = mult_engine_run(with_flavor(ope, "slab-streamed"), rs, x0,
                                      "sym_slab_matvec_streamed", u)
    del ope
    torch.cuda.empty_cache()
    engine_gap = abs(engines["slab"]["alignment"] - engines["diag"]["alignment"])
    if not engine_gap <= 0.005:
        fail(f"10b: the slab engine run's best-iterate alignment "
             f"{engines['slab']['alignment']:.5f} against the diag run's "
             f"{engines['diag']['alignment']:.5f}")
    del band
    res = {"N": N, "M": M, "gen_s": gen_s, "gap": gaps["sym"], "gap_bf16": gaps["sym bfloat16"],
           "runs": {k: {f: v[f] for f in ("alignment", "launches", "passes", "iterations",
                                          "ingest_s", "precond_eig_s", "infer_s", "total_s")}
                    for k, v in runs.items()},
           "int8_full_band": {"nb": nb, "hb": hb, "K": 2, "S": 2, "tiles": list(tiles),
                              "max_abs_err": abs_err, "scaled_err": rel, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                              "bytes": nbytes, "block_bytes_read": counted,
                              "library_ms": library_ms["float32"],
                              "library_call": "torch.matmul, dense float32 panel",
                              "runs_alone": {"tiles": list(runs_only), "ms": old_ms,
                                             "tiles_ms": new_ms, "max_abs_err": old_abs_err,
                                             "scaled_err": old_rel}},
           "bf16_full_band": dict(floats["bfloat16"], float32=floats["float32"]),
           "slab_full_band": dict(slabs["bfloat16"], float32=slabs["float32"],
                                  launches=engines["slab"]["launches"]),
           "engines": dict(engines, pack_s=pack_s, gap=engine_gap)}
    sym16 = runs["sym bfloat16"]
    print(f"[10b gen-phen-mult] N={N}, M={M}, K=2: generated on the host in {gen_s:.1f} s; "
          f"best-iterate alignment dense {runs['dense']['alignment']:.5f}, sym int8 "
          f"{runs['sym']['alignment']:.5f} (gap {gaps['sym']:.5f}), sym bfloat16 "
          f"{sym16['alignment']:.5f} (gap {gaps['sym bfloat16']:.5f}); int8 launches "
          f"{runs['sym']['launches']} for {sum(runs['sym']['passes'])} LD passes, "
          f"sym_band_matvec launches {sym16['launches']} for {sum(sym16['passes'])} LD passes; "
          f"infer int8 {runs['sym']['infer_s']:.2f} s, bfloat16 {sym16['infer_s']:.2f} s, "
          f"dense {runs['dense']['infer_s']:.2f} s", flush=True)
    print(f"[10b int8 whole triangle] nb={nb}, hb={hb}, K=2, S=2, tiles (G, D) = {tiles}: "
          f"scaled error {rel:.1e}, the same bits on a repeat, {ms:.4f} ms a pass (plain "
          f"{plain_ms:.4f}, bound {bound:.4f}, {bound_by}, {nbytes} bytes; torch.matmul over "
          f"the dense float32 panel {library_ms['float32']:.4f}); runs alone {runs_only}: "
          f"scaled error {old_rel:.1e}, {old_ms:.4f} ms against {new_ms:.4f} with tiles in the "
          f"same order (runs, tiles, tiles, runs); {counted} block bytes copied by the "
          f"counting build", flush=True)
    for storage, f in floats.items():
        ro = f["runs_alone"]
        print(f"[10b {storage} whole triangle] sym_band_matvec, tiles (G, D) = "
              f"{tuple(f['tiles'])}: scaled error {f['scaled_err']:.1e}, the same bits on a "
              f"repeat, {f['ms']:.4f} ms a pass (plain {f['plain_ms']:.4f}, bound "
              f"{f['bound_ms']:.4f}, {f['bound_by']}, {f['bytes']} bytes; torch.matmul over "
              f"the dense {storage} panel {f['library_ms']:.4f}); runs alone "
              f"{tuple(ro['tiles'])}: scaled error {ro['scaled_err']:.1e}, {ro['ms']:.4f} ms "
              f"against {ro['tiles_ms']:.4f} with tiles in the same order (runs, tiles, tiles, "
              f"runs)", flush=True)
    for storage, f in slabs.items():
        ro = f["runs_of_8"]
        print(f"[10b slab-streamed {storage} whole triangle] {f['kernel']}, tiles (G, D) = "
              f"{tuple(f['tiles'])}: scaled error {f['scaled_err']:.1e}, the same bits on a "
              f"repeat, {f['ms']:.4f} ms a pass (plain {f['plain_ms']:.4f}, bound "
              f"{f['bound_ms']:.4f}, {f['bound_by']}, {f['bytes']} bytes; torch.matmul over "
              f"the dense {storage} panel {f['library_ms']:.4f}); runs of {SLAB_RUN_ROWS} "
              f"{tuple(ro['tiles'])}: scaled error {ro['scaled_err']:.1e}, {ro['ms']:.4f} ms "
              f"against {ro['tiles_ms']:.4f} with tiles in the same order (runs, tiles, tiles, "
              f"runs)", flush=True)
    for layout, e in engines.items():
        print(f"[10b engine {layout} bfloat16] each cohort's own blocks (packed in "
              f"{pack_s:.1f} s), {MULT_ITERATIONS} iterations with the same probes: "
              f"{e['executed']} executed, {e['launches']} launches for {e['passes']} LD "
              f"passes, other band kernels 0, {e['s_per_iteration']:.4f} s/iteration; "
              f"alignment {[round(v, 5) for v in e['alignments']]}, best iterate "
              f"{e['best_it']} {e['alignment']:.5f}"
              + (f" (diag run's {engines['diag']['alignment']:.5f}, gap {engine_gap:.5f})"
                 if layout == "slab" else ""), flush=True)
    return res


def bed_path(work: str, dev) -> dict:
    """Phase 10c: write_bed an N x M genotype panel (binomial(2, 0.4), seed
    1), read it back (equal, MB/s), simulate phen over it, R from the same
    standardized genotypes on the card in float64, then cli.main --operator
    sym --ld-dtype int8 --block-size 128 with the biobank flags: the int8
    kernel once per LD pass, best-iterate alignment >= MIN_ALIGNMENT."""
    import torch

    from sgvamp_torch.cli import simulate as cli_simulate
    from sgvamp_torch.data.bed import read_bed, write_bed

    N, M = BED_N, BED_M
    pre = os.path.join(work, "geno")
    G = np.random.default_rng(1).binomial(2, 0.4, size=(N, M)).astype(np.float64)
    t0 = time.perf_counter()
    write_bed(pre + ".bed", G)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = read_bed(pre + ".bed")
    read_s = time.perf_counter() - t0
    if not np.array_equal(back, G):
        fail("10c: read_bed does not give back the genotypes write_bed wrote")
    del back
    bed_mb = os.path.getsize(pre + ".bed") / 1e6
    t0 = time.perf_counter()
    if cli_simulate.main(["phen", "--bed", pre + ".bed", "--out", pre, "--M", str(M),
                          "--h2", str(SIM_H2), "--lam", str(SIM_LAM), "--seed", "0"]) != 0:
        fail("10c: simulate phen failed")
    phen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    X = torch.from_numpy(G).to(dev)
    del G
    X = (X - X.mean(0)) / X.std(0, correction=0) / np.sqrt(N)
    np.save(pre + "_R.npy", (X.T @ X).cpu().numpy())
    del X
    torch.cuda.empty_cache()
    r_s = time.perf_counter() - t0
    run = cli_run(pre, os.path.join(work, "geno_out"), M, "int8", "sym_band_matvec_int8",
                  tag="_bed", label="10c", native=None, prior=(SIM_LAM, SIM_H2),
                  inputs=["--ld-files", pre + "_R.npy", "--r-files", pre + "_r.npy",
                          "--true-signal-file", pre + "_bet.npy", "--N", str(N),
                          "--M", str(M)])
    res = {"N": N, "M": M, "bed_mb": bed_mb, "write_s": write_s, "read_s": read_s,
           "read_MB_per_s": bed_mb / read_s, "phen_s": phen_s, "R_on_card_s": r_s,
           "alignment": run["alignment"], "launches": run["launches"],
           "passes": run["passes"], "infer_s": run["infer_s"], "total_s": run["total_s"]}
    print(f"[10c .bed] N={N}, M={M}: write_bed {write_s:.2f} s, read_bed {read_s:.2f} s = "
          f"{res['read_MB_per_s']:.1f} MB/s over {bed_mb:.1f} MB; simulate phen {phen_s:.1f} s; "
          f"R on the card (float64) {r_s:.1f} s; sym int8 best-iterate alignment "
          f"{run['alignment']:.5f}, {run['launches']} launches for {sum(run['passes'])} LD "
          f"passes", flush=True)
    return res


def plots_path(work: str) -> dict:
    """Phase 10d, where matplotlib imports: cli.plots over 10b's sym run's
    CSVs and cli.vis_ld over its first R file; each PNG must exist."""
    try:
        import matplotlib
    except ImportError:
        print("[10d plots] matplotlib does not import here: plots and vis_ld not run "
              "(not a fault of the port)", flush=True)
        return {"ran": False}
    from sgvamp_torch.cli import plots, vis_ld

    out = os.path.join(work, "mult_out")
    t0 = time.perf_counter()
    plots.main(["--csv-params", os.path.join(out, "bb_sym_int8_mult_cohort_1.csv"),
                "--csv-metrics", os.path.join(out, "bb_sym_int8_mult_metrics.csv"),
                "--out-name", "plots_10d"])
    vis_ld.main(["--ld-file", os.path.join(work, "mult_0_R.npy"), "--ld-format", "npy",
                 "--out-dir", out])
    seconds = time.perf_counter() - t0
    pngs = [os.path.join(out, f) for f in ("plots_10d.png", "mult_0_R.png")]
    if not all(os.path.exists(p) for p in pngs):
        fail(f"10d: missing {[p for p in pngs if not os.path.exists(p)]}")
    print(f"[10d plots] plots and vis_ld ran (matplotlib {matplotlib.__version__}) in "
          f"{seconds:.1f} s: {[os.path.basename(p) for p in pngs]}", flush=True)
    return {"ran": True, "seconds": seconds}


def run_module(args: list, what: str, timeout: float) -> tuple:
    """`python -m <args>` from the checkout's root with this process's
    environment: (stdout, stderr, seconds). Fails on a non-zero exit or a
    time-out."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                              timeout=timeout, cwd=os.path.dirname(os.path.abspath(__file__)))
    except subprocess.TimeoutExpired:
        fail(f"{what}: python -m {' '.join(args)} ran past {timeout:.0f} s")
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{what}: python -m {' '.join(args)} exited {proc.returncode}: "
             f"{proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    return proc.stdout, proc.stderr, seconds


def port_bench(int8_run: dict, fused_int8: dict, pass_ms: float) -> dict:
    """Phase 11a: python -m sgvamp_torch.bench at the default (large) size,
    the solve child on, over the problem cache phase 2 filled. Checks: exit
    0 and no child error, the timed state finite, the StopMonitor's iterate
    aligned >= MIN_ALIGNMENT, matvec_ms and the fused iter_ms_median within
    BENCH_TOL of phase 6b's chained int8 operator pass (the same timer over
    the same operator) and 7a's fused s/iteration, 102 int8 launches a
    timed step by graph replay (none eager) and eagerly in the host loop,
    the read probe and the int8 kernel launched by the matvec child, the
    int8 kernel by the solve child, the preconditioned solve converged."""
    out, err, seconds = run_module(["sgvamp_torch.bench"], "11a bench", 900)
    line = json.loads(out.splitlines()[-1])
    step = line["launches"]["step"]
    n = 102 * 12   # 4 blocks x 3 steps
    mv = line["launches"]["matvec"]["launches"]
    solve = line["solve_rtol1e5"]
    checks = {
        "no child failed": line["errors"] == {},
        "step timed, state finite": line["step_timed"] and line["state_finite"],
        f"align_stop_vs_x0 >= {MIN_ALIGNMENT}": line["align_stop_vs_x0"] >= MIN_ALIGNMENT,
        f"matvec_ms within {BENCH_TOL:.0%} of 6b's chained int8 pass":
            abs(line["matvec_ms"] / pass_ms - 1) <= BENCH_TOL,
        f"fused iter_ms_median within {BENCH_TOL:.0%} of 7a":
            abs(line["iter_ms_median"] / 1e3 / fused_int8["s_per_iteration"] - 1) <= BENCH_TOL,
        "102 int8 launches a fused step, by replay": step["launches_fused"] ==
            {"sym_band_matvec_int8": n} and step["launches_fused_eager"] == {},
        "102 int8 launches a host-loop step": step["launches_host"] == {"sym_band_matvec_int8": n},
        "matvec child: the probe and the int8 kernel": set(mv) == {"read_max",
                                                                   "sym_band_matvec_int8"},
        "solve child: the int8 kernel": set(solve["launches"]) == {"sym_band_matvec_int8"},
        "int8 preconditioned solve converged": solve["precond_converged"],
        "the card's own spec": line["hbm_spec_GBps"] == HBM_BYTES_PER_S / 1e9,
    }
    bad = [k for k, ok in checks.items() if not ok]
    print(f"[11a bench] python -m sgvamp_torch.bench, M={line['M']} B={line['block_size']} "
          f"{line['ld_dtype']}, in {seconds:.1f} s (problem loaded from the cache in "
          f"{line['gen_s']} s): fused {line['iter_ms_median']} ms/iteration (7a "
          f"{fused_int8['s_per_iteration'] * 1e3:.2f}), host loop "
          f"{line['iter_ms_median_host']} ms (3: {int8_run['s_per_iteration'] * 1e3:.2f}), "
          f"device {line['device_ms_per_step']} ms a fused step; matvec {line['matvec_ms']} ms "
          f"(6b {pass_ms:.4f}), {line['matvec_GBps']} GB/s, ceiling "
          f"{line['hbm_read_ceiling_GBps']}, {line['roofline_frac_vs_spec']} of "
          f"{line['hbm_spec_GBps']} GB/s; align_stop {line['align_stop_vs_x0']} (phase 3's best "
          f"iterate {int8_run['alignment']:.5f}), stop {line['stop_reason']} at "
          f"{line['stop_it']}; solve plain {solve['plain_iters']} its {solve['plain_s']} s, "
          f"precond {solve['precond_iters']} its {solve['precond_s']} s; compile_s "
          f"{line['compile_s']}, kernels built {line['kernels_built']}; launches "
          f"{line['launches']}; checks failed: {bad}", flush=True)
    if bad:
        fail(f"11a: the port bench failed {bad}: {err[-1500:]}")
    print(json.dumps(line), flush=True)
    return dict(line, seconds=seconds)


def ab_kernels_vs_plain(dev) -> dict:
    """Phase 11b, before the A/B matrix runs: every wrapper its grid, step
    and solve rows launch, called on the card at the shapes they give it
    and held against its plain version (scaled error <= SCALED_TOL): int8,
    int4 and hybrid diag streamed, bfloat16 diag and slab streamed, and
    bfloat16 resident (the solve rows' mode "auto" takes it), each at
    M=16384, bandwidth 128, K=1, S=2 and B=128 and 256 (--size small), and
    at M=524288, bandwidth 256, B=256 (the full-size grid's other block;
    its B=128 cells are phase 2's full shape). The panels are the bench's
    problems, which the A/B matrix then finds in the cache. Returns
    {wrapper: {B: worst scaled error}}."""
    from sgvamp_torch import bench
    from sgvamp_torch.ops.band_kernel import SymBandedLD, band_kernel_of
    from sgvamp_torch.utils import ab_matrix

    shapes = [(ab_matrix.M_OF["small"], 128, B) for B in ab_matrix.BLOCKS]
    shapes.append((M_FULL, BW_FULL, 256))
    worst = {}
    for M, bw, B in shapes:
        band = bench.build_problem(M, bw, bench.N_SAMPLES, bench.LAM, bench.H2)[0]
        for storage in ab_matrix.DTYPES:
            diag = dataclasses.replace(
                SymBandedLD.from_band(band, block_size=B, dtype=storage, device=dev),
                mode="streamed")
            ops = {"diag": diag}
            if storage == "bfloat16":
                ops["slab"] = dataclasses.replace(
                    SymBandedLD.from_band(band, block_size=B, dtype=storage, layout="slab",
                                          device=dev), mode="streamed")
                ops["resident"] = dataclasses.replace(diag, mode="resident")
            for form, op in ops.items():
                name = band_kernel_of(op, 2)[0].__name__
                _, rel = kernel_vs_plain(op, 2, B, f"{storage} {form}, 11b M={M} bandwidth "
                                                   f"{bw} hb={op.hb} B={B} K=1 S=2")
                got = worst.setdefault(name, {})
                got[B] = max(got.get(B, 0.0), rel)
            del ops, diag
        del band
    print(f"[11b kernels] the A/B matrix's wrappers against their plain versions at "
          f"M=16384 bandwidth 128 B=128 and 256, and M={M_FULL} bandwidth {BW_FULL} B=256, "
          f"K=1 S=2: worst scaled error "
          + ", ".join(f"{k} " + " ".join(f"B={B} {v:.2e}" for B, v in b.items())
                      for k, b in worst.items())
          + f" (tol {SCALED_TOL})", flush=True)
    return worst


def ab_grid(out: str, checked: dict) -> dict:
    """Phase 11b: python -m sgvamp_torch.utils.ab_matrix --size small over
    the whole grid, steps and solves. Checks: one row per storage x block x
    layout, quantized slab cells "unsupported", every other cell measured
    and launching its own kernel and no other, every step row measured with
    its storage's kernel and its StopMonitor's iterate aligned >=
    MIN_ALIGNMENT, int8's preconditioned solve converged (int4 may stall:
    that is the solve row's finding, not a failure), and every wrapper the
    matrix launched held against its plain version at each block size it
    ran (`checked`, ab_kernels_vs_plain's)."""
    _, err, seconds = run_module(["sgvamp_torch.utils.ab_matrix", "--size", "small",
                                  "--out", out], "11b ab_matrix", 600)
    with open(out) as f:
        doc = json.load(f)
    own = {"bfloat16": "sym_band_matvec", "int8": "sym_band_matvec_int8",
           "int4": "sym_band_matvec_int4", "hybrid": "sym_band_matvec_hybrid"}
    cells = {(c["dtype"], c["B"], c["layout"]): c for c in doc["matvec_grid"]}
    bad = []
    if len(cells) != len(doc["matvec_grid"]) or len(cells) != 16:
        bad.append(f"{len(doc['matvec_grid'])} rows for {len(cells)} cells, expected 16")
    for (dtype, B, layout), c in cells.items():
        if dtype != "bfloat16" and layout == "slab":
            if "unsupported" not in c:
                bad.append(f"{dtype} B={B} slab: {c}")
            continue
        kernel = "sym_slab_matvec_streamed" if layout == "slab" else own[dtype]
        if "ms_per_pass" not in c or c.get("kernel") != kernel or set(c["launches"]) != {kernel}:
            bad.append(f"{dtype} B={B} {layout}: {c}")
    for dtype, row in doc["step_by_dtype"].items():
        if ("error" in row or row["launches"] != {own[dtype]: 22 * 12}
                or not row["align_stop"] >= MIN_ALIGNMENT):
            bad.append(f"step {dtype}: {row}")
    if set(doc["step_by_dtype"]) != set(own) or set(doc["solve_by_dtype"]) != set(own):
        bad.append(f"step rows {sorted(doc['step_by_dtype'])}, solve rows "
                   f"{sorted(doc['solve_by_dtype'])}")
    if not doc["solve_by_dtype"].get("int8", {}).get("precond_converged"):
        bad.append(f"int8 solve {doc['solve_by_dtype'].get('int8')}")
    launches = {}
    for c in doc["matvec_grid"]:
        for k, v in c.get("launches", {}).items():
            launches[k] = launches.get(k, 0) + v
    for rows in (doc["step_by_dtype"], doc["solve_by_dtype"]):
        for row in rows.values():
            for k, v in row.get("launches", {}).items():
                launches[k] = launches.get(k, 0) + v
    ran_at = {}   # wrapper -> the block sizes at which the matrix launched it
    for c in doc["matvec_grid"]:
        for k in c.get("launches", {}):
            ran_at.setdefault(k, set()).add(c["B"])
    for rows in (doc["step_by_dtype"], doc["solve_by_dtype"]):
        for row in rows.values():
            for k in row.get("launches", {}):
                ran_at.setdefault(k, set()).add(row["B"])
    for k, blocks in ran_at.items():
        if not blocks <= set(checked.get(k, {})):
            bad.append(f"{k} launched at B={sorted(blocks)}, held against its plain version "
                       f"at B={sorted(checked.get(k, {}))}")
    print(f"[11b ab_matrix] --size small (M={doc['M']}) in {seconds:.1f} s: "
          + ", ".join(f"{d} B={B} {lay} " + (f"{c['ms_per_pass']} ms" if "ms_per_pass" in c
                                             else "unsupported")
                      for (d, B, lay), c in cells.items())
          + "; steps " + ", ".join(f"{d} {r.get('iter_ms_median')} ms (host "
                                   f"{r.get('iter_ms_median_host')})"
                                   for d, r in doc["step_by_dtype"].items())
          + "; solves " + ", ".join(f"{d} precond {r.get('precond_iters')} its converged "
                                    f"{r.get('precond_converged')}, plain "
                                    f"{r.get('plain_iters')} converged "
                                    f"{r.get('plain_converged')}"
                                    for d, r in doc["solve_by_dtype"].items())
          + f"; fastest {doc.get('fastest_cell')}; launches {launches}; checks failed: {bad}",
          flush=True)
    if bad:
        fail(f"11b: the A/B matrix failed {bad}: {err[-1500:]}")
    print(json.dumps(doc), flush=True)
    return {"seconds": seconds, "launches": launches, "fastest_cell": doc.get("fastest_cell")}


def main() -> None:
    import torch

    from sgvamp_torch import bench as port_bench_mod
    from sgvamp_torch import native
    from sgvamp_torch.core.operators import BandedLD
    from sgvamp_torch.data.simulate import simulate_ld_band
    from sgvamp_torch.ops import _build
    from sgvamp_torch.ops.band_kernel import (DIAG_RUN_ROWS, SLAB_RUN_ROWS, SymBandedLD,
                                              _float_tiles, _int8_runs, _int8_tiles,
                                              _slab_tiles, band_kernel_of)
    from sgvamp_torch.ops.membench import (_prep, measure_read_gbps, read_max,
                                           read_max_ref)
    from sgvamp_torch.utils import kernel_bench

    t_start = time.perf_counter()
    seconds = {}

    # ---- 0. device ----
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on a GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[0 device] {torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {smi}", flush=True)

    # ---- 1. build ----
    t0 = time.perf_counter()
    libs = _build.build()
    for lib in libs:
        _build.load_library(lib)
    seconds["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        native_lib = native.build()
    except RuntimeError as e:
        fail(f"the native ingestion library did not build: {e}")
    if not native.available():
        fail(f"the native ingestion library {native_lib} built but did not load")
    seconds["build_native"] = time.perf_counter() - t0
    print(f"[1 build] native ingestion (sgvamp_torch/native/ldparse.cpp, g++): "
          f"{os.path.basename(native_lib)} in {seconds['build_native']:.2f} s", flush=True)
    ptxas = []
    for lib in libs:
        with open(os.path.join(_build.BUILD_DIR, lib + ".log")) as f:
            text = f.read()
        regs = [int(v) for v in re.findall(r"Used (\d+) registers", text)]
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill stores", text)]
        ptxas.append(f"{lib}: {len(regs)} kernels, <= {max(regs, default=0)} registers, "
                     f"<= {max(spills, default=0)} bytes spilled")
    print(f"[1 build] {seconds['build']:.2f} s for {len(libs)} libraries; " + "; ".join(ptxas),
          flush=True)
    if len(libs) != 8:
        fail(f"expected eight kernel libraries (seven sources and the int8 kernel's "
             f"counting build), built {sorted(libs)}")

    # ---- 2. kernels vs their plain versions ----
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    band_small, _, _ = simulate_ld_band(10000, 1000, 300, rng=rng)
    ragged_err = {}
    for storage in STORAGES + ("float64",):
        for B in (64, 128, 256):
            tol = F64_TOL if storage == "float64" else SCALED_TOL
            # the streamed diag kernels (float storage would take the
            # resident kernel under mode "auto")
            op_s = dataclasses.replace(
                SymBandedLD.from_band(band_small, block_size=B, K=2, dtype=storage, device=dev),
                mode="streamed")
            what = f"ragged M=1000 hb={op_s.hb} B={B} K=2 S=2"
            _, rel = kernel_vs_plain(op_s, 2, B, f"{storage}, {what}", tol)
            ragged_err[storage] = max(ragged_err.get(storage, 0.0), rel)
            if op_s.upper.dtype == torch.int8:
                continue
            slab = SymBandedLD.from_band(band_small, block_size=B, K=2, dtype=storage,
                                         layout="slab", device=dev)
            for flavor, wrapper in FLAVOR_WRAPPER.items():
                op_f = with_flavor(op_s, flavor)
                if op_f.layout == "slab" and not torch.equal(op_f.upper, slab.upper):
                    fail(f"from_band(layout='slab') differs from the transposed diag blocks "
                         f"({storage}, B={B})")
                if band_kernel_of(op_f, 2)[0].__name__ != wrapper:
                    fail(f"{flavor} operator is routed to {band_kernel_of(op_f, 2)[0].__name__}")
                _, rel = kernel_vs_plain(op_f, 2, B, f"{flavor} {storage}, {what}", tol)
                key = f"{flavor} {storage}"
                ragged_err[key] = max(ragged_err.get(key, 0.0), rel)
    print("[2 ragged] M=1000, bandwidth 300, K=2, S=2, B in (64, 128, 256): worst scaled "
          "error " + ", ".join(f"{k} {v:.2e}" for k, v in ragged_err.items())
          + f" (tol {SCALED_TOL}, float64 {F64_TOL})", flush=True)
    seconds["kernels_ragged"] = time.perf_counter() - t0

    # ---- 6a. the spill kernels on the ragged operators ----
    t0 = time.perf_counter()
    band_narrow, _, _ = simulate_ld_band(10000, 1000, 100, rng=rng)
    spill_err, spill_cases, refused = {}, 0, 0
    for storage in STORAGES + ("float64",):
        tol = F64_TOL if storage == "float64" else SCALED_TOL
        for bw, band_r in ((300, band_small), (100, band_narrow)):
            for B in (64, 128, 256):
                op_s = dataclasses.replace(
                    SymBandedLD.from_band(band_r, block_size=B, K=2, dtype=storage, device=dev),
                    mode="streamed")
                ops = {storage: op_s}
                if op_s.upper.dtype != torch.int8:
                    ops[f"slab-streamed {storage}"] = with_flavor(op_s, "slab-streamed")
                for key, op_f in ops.items():
                    own = SPILL_WRAPPER["slab-streamed" if op_f.layout == "slab" else storage]
                    if band_kernel_of(op_f, 2, spill=True)[0].__name__ != own:
                        fail(f"the spill form of {key} is routed to "
                             f"{band_kernel_of(op_f, 2, spill=True)[0].__name__}")
                    for n in (2, 4):
                        what = f"ragged M=1000 bandwidth {bw} hb={op_f.hb} B={B} K=2 S=2"
                        if op_f.nb % n or op_f.nb // n < op_f.hb:
                            try:
                                shard_operator(op_f, n)
                            except ValueError:
                                refused += 1
                                continue
                            fail(f"shard_inputs took {key}, {what}, cut {n} ways: shards of "
                                 f"{op_f.nb / n} block rows, hb={op_f.hb}")
                        _, rel, _ = spill_vs_plain(op_f, n, 2, B + n, f"{key}, {what}", tol)
                        spill_err[key] = max(spill_err.get(key, 0.0), rel)
                        spill_cases += 1
    print(f"[6a ragged] M=1000, bandwidth 300 and 100, K=2, S=2, B in (64, 128, 256), 2 and 4 "
          f"shards: {spill_cases} operators cut and composed, {refused} refused by "
          f"shard_inputs (shard narrower than hb); worst scaled error of y_l, carry, the "
          f"composition and the sharded operator: "
          + ", ".join(f"{k} {v:.2e}" for k, v in spill_err.items())
          + f" (tol {SCALED_TOL}, float64 {F64_TOL}); every last carry exactly zero", flush=True)
    if refused == 0:
        fail("no ragged case was refused by shard_inputs")
    seconds["spill_ragged"] = time.perf_counter() - t0

    work = tempfile.TemporaryDirectory(prefix="sgvamp_smoke_")
    prefix = os.path.join(work.name, "bb")
    seconds["gen_band_full"] = gen_band(prefix, M_FULL)
    t0 = time.perf_counter()
    band, r_full, x0 = load_panel(prefix, M_FULL)
    seconds["load_panel_full"] = time.perf_counter() - t0
    print(f"[2 set-up] gen-band at M={M_FULL} wrote its files in "
          f"{seconds['gen_band_full']:.1f} s; .npz -> band {band.shape} in "
          f"{seconds['load_panel_full']:.1f} s", flush=True)
    # the port bench's problem is this panel (the same simulate_ld_band call,
    # equal to the bit): phase 11 finds it in its cache and generates none
    for k in [k for k in os.environ if k.startswith("SGVAMP_BENCH_")]:
        del os.environ[k]
    os.environ["SGVAMP_BENCH_CACHE_DIR"] = os.path.join(work.name, "bench_cache")
    os.makedirs(os.environ["SGVAMP_BENCH_CACHE_DIR"])
    np.savez(port_bench_mod.problem_path(M_FULL, BW_FULL), band=band,
             r=r_full.astype(np.float32), x0=x0)

    t0 = time.perf_counter()
    S = 2
    full = {}      # storage or "flavor storage" -> numbers at the full shape
    op_int8 = None

    def measure(op, key, storage, label):
        abs_err, rel = kernel_vs_plain(op, S, 0, f"{key}, full shape")
        kernel, plain, args, xdt = band_kernel_of(op, S)
        xf = torch.randn((1, S, op.M), generator=torch.Generator(dev).manual_seed(0),
                         device=dev).to(xdt)
        ms_kern, ms_plain = kernel_and_plain_ms(lambda: kernel(*args, xf),
                                                lambda: plain(*args, xf))
        b_ms, b_by, nbytes = bound_ms(op, S, storage)
        read = design_block_bytes(op, S)
        full[key] = {"abs_err": abs_err, "rel_err": rel, "ms": ms_kern,
                     "plain_ms": ms_plain, "bound_ms": b_ms, "bound_by": b_by,
                     "bytes": nbytes, "bytes_per_pass": op.bytes_per_pass(),
                     "kernel": kernel.__name__}
        counted = ""
        if key == "int8":
            full[key]["block_bytes_read"] = counted_block_bytes(op, S, kernel, args, xf)
            full[key]["hb"] = op.hb
            full[key]["tiles"] = _int8_tiles(op.nb, op.hb, torch.cuda.get_device_properties(
                0).multi_processor_count)
            if full[key]["tiles"][1] != op.hb + 1:
                fail(f"the int8 wrapper cuts the bench shape's diagonals: {full[key]['tiles']}")
            counted = (f", {full[key]['block_bytes_read']} counted by the kernel, tiles (G, D) = "
                       f"{full[key]['tiles']}")
        if key in ("bfloat16", "float32"):
            full[key]["tiles"] = _float_tiles(op.nb, op.hb, torch.cuda.get_device_properties(
                0).multi_processor_count)
            if full[key]["tiles"] != (DIAG_RUN_ROWS, op.hb + 1):
                fail(f"the float diag wrapper leaves the bench shape's runs of "
                     f"{DIAG_RUN_ROWS} block rows: tiles {full[key]['tiles']}")
            counted = f", tiles (G, D) = {full[key]['tiles']}"
        if key.startswith("slab-streamed"):
            full[key]["tiles"] = _slab_tiles(op.nb, op.hb, torch.cuda.get_device_properties(
                0).multi_processor_count, S, op.B, op.upper.element_size())
            if full[key]["tiles"] != (SLAB_RUN_ROWS, op.hb + 1):
                fail(f"the slab wrapper leaves the bench shape's runs of {SLAB_RUN_ROWS} block "
                     f"rows: tiles {full[key]['tiles']}")
            counted = f", tiles (G, D) = {full[key]['tiles']}"
        print(f"[2 {key}] {kernel.__name__}, full shape upper {tuple(op.upper.shape)} "
              f"{str(op.upper.dtype).split('.')[-1]} ({label}), "
              f"{op.bytes_per_pass()} bytes per pass, {nbytes} with x and y, {read} block "
              f"bytes read by the kernel's design{counted}: scaled error {rel:.2e} (max abs "
              f"{abs_err:.3e}, tol "
              f"{SCALED_TOL}); kernel {ms_kern:.4f} ms/pass = "
              f"{op.bytes_per_pass() / ms_kern / 1e6:.1f} GB/s over bytes_per_pass, "
              f"plain {ms_plain:.4f} ms/pass, bound {b_ms:.4f} ms ({b_by} at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s)", flush=True)

    spill = {}     # the same for the spill forms: one shard of MESH_SHARDS

    def measure_spill(op, key, storage):
        """6a and 6b at the bench shape: the operator cut MESH_SHARDS ways."""
        abs_err, rel, sh = spill_vs_plain(op, MESH_SHARDS, S, 0, f"{key}, full shape",
                                          SCALED_TOL)
        piece = sh.shards[0][1]   # an interior shard: a halo to read, a carry to write
        kernel, plain, args, xdt = band_kernel_of(piece, S, spill=True)
        xe = torch.randn((1, S, piece.M + piece.hb * piece.B),
                         generator=torch.Generator(dev).manual_seed(0), device=dev).to(xdt)
        ms_kern, ms_plain = kernel_and_plain_ms(lambda: kernel(*args, xe),
                                                lambda: plain(*args, xe))
        b_ms, b_by, nbytes = shard_bound_ms(piece, S, storage)
        lanes = torch.randn((S, op.M), generator=torch.Generator(dev).manual_seed(1),
                            device=dev)
        pass_ms = kernel_bench.time_passes(sh, lanes, BENCH_PASSES) * 1e3
        whole_ms = kernel_bench.time_passes(op, lanes, BENCH_PASSES) * 1e3
        read = design_block_bytes(piece, S, spill=True)
        spill[key] = {"abs_err": abs_err, "rel_err": rel, "ms": ms_kern, "plain_ms": ms_plain,
                      "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                      "pass_ms": pass_ms, "unsharded_pass_ms": whole_ms,
                      "kernel": kernel.__name__}
        counted = ""
        if key == "int8":
            spill[key]["block_bytes_read"] = counted_block_bytes(piece, S, kernel, args, xe,
                                                                 spill=True)
            counted = f", {spill[key]['block_bytes_read']} counted by the kernel"
        print(f"[6a 6b {key}] {kernel.__name__}, one shard of {MESH_SHARDS} at the full shape, "
              f"upper {tuple(piece.upper.shape)}: worst scaled error of y_l, carry, the "
              f"composition and the sharded operator {rel:.2e} (max abs {abs_err:.3e}, tol "
              f"{SCALED_TOL}), last carry exactly zero; kernel {ms_kern:.4f} ms/launch "
              f"(unsharded kernel {full[key]['ms']:.4f} ms/pass), plain {ms_plain:.4f}, bound "
              f"{b_ms:.4f} ms ({b_by}, {nbytes} bytes at {HBM_BYTES_PER_S / 1e12} TB/s), "
              f"{read} block bytes read by the kernel's design{counted}; "
              f"chained operator pass: sharded {pass_ms:.4f} ms ({MESH_SHARDS} launches, the "
              f"x slices, the carries and the gather), unsharded {whole_ms:.4f} ms", flush=True)

    for storage in STORAGES:
        t1 = time.perf_counter()
        op = dataclasses.replace(
            SymBandedLD.from_band(band, block_size=B_FULL, dtype=storage, device=dev),
            mode="streamed")
        measure(op, storage, storage, f"packed in {time.perf_counter() - t1:.1f} s")
        measure_spill(op, storage, storage)
        if storage == "int8":
            op_int8 = op
        if storage in ("bfloat16", "float32"):
            for flavor in FLAVORS:
                measure(with_flavor(op, flavor), f"{flavor} {storage}", storage,
                        "the same blocks")
            measure_spill(with_flavor(op, "slab-streamed"), f"slab-streamed {storage}", storage)
            del op
            # the one PyTorch call that computes the same product: BandedLD's
            # einsum over full-band storage, (2hb+1)/(hb+1) of the blocks
            t1 = time.perf_counter()
            full_band = BandedLD.from_band(band, block_size=B_FULL, dtype=storage, device=dev)
            pack_s = time.perf_counter() - t1
            xl = torch.randn((S, full_band.M), generator=torch.Generator(dev).manual_seed(0),
                             device=dev)
            sym = SymBandedLD.from_band(band, block_size=B_FULL, dtype=storage, device=dev)
            err, rel = scaled_err(full_band.matvec(xl), sym.matvec(xl))
            if not rel <= SCALED_TOL:
                fail(f"BandedLD.matvec vs the {storage} sym operator: scaled error {rel:.3e}")
            ms_lib = min(cuda_ms(lambda: full_band.matvec(xl), 10) for _ in range(2))
            full[f"einsum {storage}"] = {"ms": ms_lib, "bytes_per_pass": full_band.bytes_per_pass()}
            print(f"[2 einsum {storage}] BandedLD.matvec over blocks "
                  f"{tuple(full_band.blocks.shape)} (packed in {pack_s:.1f} s), "
                  f"{full_band.bytes_per_pass()} bytes per pass: {ms_lib:.4f} ms/pass; scaled "
                  f"difference from the sym operator {rel:.2e}", flush=True)
            del full_band, sym, xl
            torch.cuda.empty_cache()
    seconds["kernels_full"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wide = wide_band(dev, S)
    torch.cuda.empty_cache()
    seconds["wide_band"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    uf = torch.randn(16 << 20, generator=torch.Generator(dev).manual_seed(2), device=dev)
    uf[12345] = 1e6
    probe_err = 0.0
    for name, arr in (("float32", uf), ("int8 LD blocks", op_int8.upper)):
        err = float((read_max(arr).double() - read_max_ref(arr).double()).abs().max())
        if err != 0.0:
            fail(f"Triton read probe differs from its plain version on {name} by {err}")
        probe_err = max(probe_err, err)
    del uf
    probe_plain_ms = cuda_ms(lambda: read_max_ref(op_int8.upper), 10)
    # the one PyTorch call that computes the probe's function: a max over
    # the same bytes
    probed = _prep(op_int8.upper)
    probe_library_ms = cuda_ms(lambda: torch.amax(probed.reshape(-1, 1024), dim=0), 10)
    probe_bytes = probed.numel() * probed.element_size()
    print(f"[2 read probe] Triton read_max equals read_max_ref exactly "
          f"(float32, int8); plain version {probe_plain_ms:.4f} ms/pass, torch.amax "
          f"{probe_library_ms:.4f} ms/pass over the int8 blocks", flush=True)

    # the same small engine run through the kernel and through the CPU's
    # plain versions, with the same probes
    runs = {}
    for d in (dev, torch.device("cpu")):
        eng = small_engine(d)
        u = np.random.default_rng(4).choice([-1.0, 1.0], size=(3, 1, eng.inputs.op.M))
        runs[d.type] = eng.run(3, fixed_u=u)
    a, b = runs["cuda"]["xhat1"][-1], runs["cpu"]["xhat1"][-1]
    small_rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    if not (np.all(np.isfinite(a)) and small_rel <= 1e-3):
        fail(f"small engine run, GPU vs CPU: xhat1 relative L2 {small_rel:.3e} > 1e-3")
    print(f"[2 engine parity] M=16384, 3 iterations: GPU vs CPU xhat1 "
          f"relative L2 {small_rel:.2e} (tol 1e-3)", flush=True)
    seconds["probe_and_parity"] = time.perf_counter() - t0

    # ---- 3. the engine's library path ----
    t0 = time.perf_counter()
    logging.basicConfig(stream=sys.stdout, format="%(message)s")
    logging.getLogger("sgvamp").setLevel(logging.DEBUG)
    int8_run = engine_run(op_int8, r_full, x0, "sym_band_matvec_int8", ITERATIONS,
                          "3 engine path",
                          before_run=lambda eng: measure_read_gbps(op_int8.upper, n=20))
    gbps, probe_s = int8_run["extra"]
    launches = int8_run["launches"]
    ms_int8, bpp = full["int8"]["ms"], full["int8"]["bytes_per_pass"]
    print(f"[3 engine path] read ceiling {gbps:.1f} GB/s ({probe_s * 1e3:.4f} ms/pass "
          f"over the int8 blocks); int8 band kernel {ms_int8:.4f} ms/pass = "
          f"{100 * bpp / ms_int8 / 1e6 / gbps:.1f}% of it", flush=True)
    if launches["read_max"] == 0:
        fail("the read probe kernel was not launched on the engine path")
    seconds["engine_path"] = time.perf_counter() - t0

    # ---- 7a. the engine's library path, fused ----
    t0 = time.perf_counter()
    fused = {"int8": fused_run(op_int8, r_full, x0, "sym_band_matvec_int8", ITERATIONS,
                               "7a fused engine path", int8_run)}
    torch.cuda.empty_cache()
    seconds["fused_engine_path"] = time.perf_counter() - t0

    # ---- 8a. the engine's library path under MLE, both modes ----
    t0 = time.perf_counter()
    mle_run = mle_engine_run(op_int8, r_full, x0, int8_run, fused["int8"])
    torch.cuda.empty_cache()
    seconds["mle_engine_path"] = time.perf_counter() - t0

    # ---- 4. the command-line path ----
    t0 = time.perf_counter()
    out_dir = os.path.join(work.name, "out")
    cli = {"hybrid": cli_run(prefix, out_dir, M_FULL, "hybrid", "sym_band_matvec_hybrid")}
    seconds["cli_hybrid_full"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ingestion = dict(host_ingestion(prefix, dev), cli_load_R_s=cli["hybrid"]["ingest_s"],
                     cli_precond_eig_s=cli["hybrid"]["precond_eig_s"])
    eig_profile = precond_eig_profile(band, dev)
    torch.cuda.empty_cache()
    seconds["ingestion_and_eig_profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    small_prefix = os.path.join(work.name, "sm")
    seconds["gen_band_small"] = gen_band(small_prefix, M_CLI_SMALL)
    # the resident and int4 kernels at the shapes this path gives them
    band_sm = load_panel(small_prefix, M_CLI_SMALL)[0]
    for storage, key in (("bfloat16", "resident bfloat16"), ("int4", "int4")):
        op = SymBandedLD.from_band(band_sm, block_size=B_FULL, dtype=storage, device=dev)
        if band_kernel_of(op, S)[0].__name__ != full[key]["kernel"]:
            fail(f"--ld-dtype {storage} at M={M_CLI_SMALL} would run "
                 f"{band_kernel_of(op, S)[0].__name__}, expected {full[key]['kernel']}")
        abs_err, rel = kernel_vs_plain(op, S, 5, f"{key}, M={M_CLI_SMALL}")
        full[key]["abs_err"] = max(full[key]["abs_err"], abs_err)
        del op
    del band_sm
    cli["bfloat16"] = cli_run(small_prefix, out_dir, M_CLI_SMALL, "bfloat16",
                              "sym_band_matvec_resident")
    cli["int4"] = cli_run(small_prefix, out_dir, M_CLI_SMALL, "int4", "sym_band_matvec_int4",
                          extra=("--cg-rtol", "1e-3"))
    cli["banded"] = cli_run(small_prefix, out_dir, M_CLI_SMALL, "bfloat16", None,
                            operator="banded")
    seconds["cli_small"] = time.perf_counter() - t0

    # ---- 4b. the .ld path: two cohorts' PLINK tables and .bim files ----
    t0 = time.perf_counter()
    ld = write_ld_cohorts(small_prefix, work.name)
    seconds["ld_write"] = time.perf_counter() - t0
    cli["ld int8"] = cli_run(small_prefix, out_dir, len(ld["truth"]), "int8",
                             "sym_band_matvec_int8", K=2, tag="_ld", inputs=ld["inputs"],
                             truth=ld["truth"])
    name = "bb_sym_int8_ld"
    with open(os.path.join(out_dir, name + ".bim")) as f:
        merged = [ln.split("\t")[1] for ln in f.read().splitlines()]
    if merged != [f"rs{i}" for i in ld["order"]] or len(set(merged)) != M_CLI_SMALL:
        fail(f"the merged .bim does not hold the {M_CLI_SMALL} markers once each in the "
             f"panel's order ({len(merged)} lines, {len(set(merged))} distinct)")
    routes = cli["ld int8"]["routes"]
    parse_s = [float(m.group(1)) for ln in routes
               for m in [re.search(r"parsed through the native path in ([0-9.]+) s", ln)] if m]
    if (len(parse_s) != 2 or sum("assembled through the native path" in ln for ln in routes) != 2
            or sum("int8 blocks packed through the native path" in ln for ln in routes) != 2):
        fail(f".ld path: both tables must be parsed, assembled and packed natively: {routes}")
    seconds["ld_path"] = time.perf_counter() - t0
    ld_path = {"ld_bytes": ld["ld_bytes"], "pairs_in_band": ld["pairs_in_band"], "N": ld["N"],
               "parse_s": parse_s, "parse_MB_per_s": ld["ld_bytes"] / sum(parse_s) / 1e6,
               "write_s": seconds["ld_write"], "phase_s": seconds["ld_path"]}
    print(f"[4b .ld] two cohorts at M={M_CLI_SMALL} ({ld['pairs_in_band']} pairs in the band, "
          f"{ld['ld_bytes'] / 1e9:.2f} GB of .ld text, written in {seconds['ld_write']:.1f} s): "
          f"parsed natively in {parse_s[0]:.2f} + {parse_s[1]:.2f} s = "
          f"{ld_path['parse_MB_per_s']:.0f} MB/s; merged .bim {len(merged)} markers once each; "
          f"phase {seconds['ld_path']:.1f} s in all", flush=True)

    # ---- 5. the operator-flavor path ----
    t0 = time.perf_counter()
    bench_rows, bench_launches = {}, {}
    for variant, own in BENCH_VARIANTS.items():
        reset_launches()
        rows = kernel_bench.main(
            ["--M", str(M_FULL), "--bandwidth", str(BW_FULL), "--B", str(B_FULL), "--K", "1",
             "--S", str(S), "--passes", str(BENCH_PASSES), "--dtype", "bfloat16",
             "--variants", variant], band=band)
        torch.cuda.synchronize()
        counts = band_launches()
        if len(rows) != 1 or "error" in rows[0]:
            fail(f"kernel_bench variant {variant}: {rows}")
        # two warm-ups (the second times the host's enqueue) and four timed
        # chains of n and of 2n passes; a second try (a 2n chain no slower
        # than its n chain) would show here as more
        expect = 18 * BENCH_PASSES if own else 0
        got = {k: v for k, v in counts.items() if v}
        want = {own: expect} if own else {}
        if got != want:
            fail(f"kernel_bench variant {variant} launched {got}, expected {want}")
        bench_rows[variant] = rows[0]
        bench_launches[variant] = expect
    print("[5 kernel_bench] bfloat16, bench shape, ms per chained operator pass (kernel, "
          "casts, lane transposes and the regularization): "
          + ", ".join(f"{v} {r['ms_per_pass']} ({r['kernel']})" for v, r in bench_rows.items())
          + "; each variant launched its own kernel 18 x passes times and no other",
          flush=True)
    seconds["kernel_bench"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    op_bf16 = SymBandedLD.from_band(band, block_size=B_FULL, dtype="bfloat16", device=dev)
    del band
    flavor_runs = {}
    for flavor in ("slab-streamed", "resident"):
        flavor_runs[flavor] = engine_run(with_flavor(op_bf16, flavor), r_full, x0,
                                         FLAVOR_WRAPPER[flavor], FLAVOR_ITERATIONS,
                                         f"5 engine path, bfloat16 {flavor}")
        torch.cuda.empty_cache()
    seconds["flavor_engine_paths"] = time.perf_counter() - t0

    # ---- 6c. the engine path under the mesh ----
    t0 = time.perf_counter()
    mesh = one_card_mesh(1, MESH_SHARDS)
    mesh_runs = {}
    for key, op_m, own, whole_run in (
            ("int8", op_int8, "sym_band_matvec_int8_spill", int8_run),
            ("bfloat16 slab-streamed", with_flavor(op_bf16, "slab-streamed"),
             "sym_slab_matvec_streamed_spill", flavor_runs["slab-streamed"])):
        phase = f"6c engine path, {key}, (1, {MESH_SHARDS}) mesh"
        mesh_runs[key] = engine_run(op_m, r_full, x0, own, MESH_ITERATIONS, phase, mesh=mesh)
        mesh_runs[key]["deviation"] = compare_runs(mesh_runs[key], whole_run, phase)
        print(f"[{phase}] {mesh_runs[key]['s_per_iteration']:.4f} s/iteration against "
              f"{whole_run['s_per_iteration']:.4f} unsharded", flush=True)
        del op_m
        torch.cuda.empty_cache()
    seconds["mesh_engine_paths"] = time.perf_counter() - t0

    # ---- 7b. the engine path under the mesh, fused; the sharded pass replayed ----
    t0 = time.perf_counter()
    fused["int8 mesh"] = fused_run(op_int8, r_full, x0, "sym_band_matvec_int8_spill",
                                   MESH_ITERATIONS,
                                   f"7b fused engine path, int8, (1, {MESH_SHARDS}) mesh",
                                   mesh_runs["int8"], mesh=mesh)
    sh = shard_operator(op_int8, MESH_SHARDS)
    lanes = torch.randn((S, op_int8.M), generator=torch.Generator(dev).manual_seed(1),
                        device=dev)

    def chained(o):
        def run():
            v = lanes
            for _ in range(BENCH_PASSES):
                v = o.matvec(v) * 0.02
            return v
        return run

    passes = {}
    for key, o in (("sharded", sh), ("unsharded", op_int8)):
        passes[f"{key}_eager_ms"] = cuda_ms(chained(o), 3) / BENCH_PASSES
        passes[f"{key}_replayed_ms"] = graphed_ms(chained(o)) / BENCH_PASSES
    fused["int8 mesh"]["pass_ms"] = dict(passes, sharded_eager_6b_ms=spill["int8"]["pass_ms"])
    print(f"[7b sharded pass] int8, {MESH_SHARDS} shards on the card, ms per chained "
          f"operator pass ({BENCH_PASSES} passes): replayed from a CUDA graph "
          f"{passes['sharded_replayed_ms']:.4f}, eager {passes['sharded_eager_ms']:.4f} (6b's "
          f"eager figure {spill['int8']['pass_ms']:.4f}); unsharded replayed "
          f"{passes['unsharded_replayed_ms']:.4f}, eager {passes['unsharded_eager_ms']:.4f}",
          flush=True)
    del sh, lanes, op_int8, op_bf16
    torch.cuda.empty_cache()
    seconds["fused_mesh_path"] = time.perf_counter() - t0

    # ---- 6d. the command line under the mesh ----
    t0 = time.perf_counter()
    shard_flags = ("--mesh-shard", str(MESH_SHARDS))
    mesh_cli = {
        "hybrid": cli_run(small_prefix, out_dir, M_CLI_SMALL, "hybrid",
                          "sym_band_matvec_hybrid_spill", extra=shard_flags,
                          per_pass=MESH_SHARDS, tag="_mesh"),
        "int4": cli_run(small_prefix, out_dir, M_CLI_SMALL, "int4",
                        "sym_band_matvec_int4_spill",
                        extra=shard_flags + ("--cg-rtol", "1e-3"), per_pass=MESH_SHARDS,
                        tag="_mesh"),
        "bfloat16": cli_run(small_prefix, out_dir, M_CLI_SMALL, "bfloat16",
                            "sym_band_matvec_spill", extra=shard_flags, per_pass=MESH_SHARDS,
                            tag="_mesh"),
        "hybrid K=2": cli_run(small_prefix, out_dir, M_CLI_SMALL, "hybrid",
                              "sym_band_matvec_hybrid_spill",
                              extra=("--mesh-cohort", "2", "--mesh-shard", "2"), K=2,
                              per_pass=4, tag="_mesh22"),
    }
    seconds["mesh_cli"] = time.perf_counter() - t0

    # ---- 7c. the command line with --fused 1 ----
    t0 = time.perf_counter()
    fused_dir = os.path.join(work.name, "out_fused")
    fused_cli = cli_run(prefix, fused_dir, M_FULL, "hybrid", "sym_band_matvec_hybrid",
                        extra=("--fused", "1"))
    fused_cli["against_host_loop"] = compare_cli_files(cli["hybrid"], out_dir, fused_cli,
                                                       fused_dir)
    seconds["fused_cli"] = time.perf_counter() - t0

    # ---- 8b. the command line with checkpoints and --resume, under MLE ----
    t0 = time.perf_counter()
    ckpt = {"hybrid fused": checkpoint_legs(prefix, work.name, M_FULL, "hybrid",
                                            "sym_band_matvec_hybrid", "1"),
            "hybrid host loop": checkpoint_legs(small_prefix, work.name, M_CLI_SMALL, "hybrid",
                                                "sym_band_matvec_hybrid", "0")}
    seconds["checkpoint_cli"] = time.perf_counter() - t0

    # ---- 9. BlockSparseLD and a process group of one ----
    t0 = time.perf_counter()
    blocksparse = blocksparse_full(prefix, small_prefix, work.name, gbps, dev)
    seconds["blocksparse_full"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    blocksparse["cli"] = blocksparse_cli(prefix, work.name)
    seconds["blocksparse_cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    processes = process_group_of_one(small_prefix, work.name)
    seconds["process_group"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    processes["dryrun"] = dryrun_on_the_card()
    seconds["dryrun_on_the_card"] = time.perf_counter() - t0

    # ---- 10. --profile-dir, the genotype simulators, plots ----
    t0 = time.perf_counter()
    traced = {"host loop": profiled_cli(prefix, work.name, cli["hybrid"], out_dir, "0"),
              "fused": profiled_cli(prefix, work.name, fused_cli, fused_dir, "1")}
    seconds["profile_dir"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mult = multi_cohort_path(work.name, dev)
    seconds["gen_phen_mult"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    geno = bed_path(work.name, dev)
    seconds["bed_phen"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    figures = plots_path(work.name)
    seconds["plots"] = time.perf_counter() - t0

    # ---- 11. the port bench and the A/B matrix ----
    t0 = time.perf_counter()
    bench_line = port_bench(int8_run, fused["int8"], spill["int8"]["unsharded_pass_ms"])
    seconds["port_bench"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ab = ab_grid(os.path.join(work.name, "ab_small.json"), ab_kernels_vs_plain(dev))
    seconds["ab_matrix"] = time.perf_counter() - t0
    step_launches = bench_line["launches"]["step"]
    bench_int8 = {"step_fused": step_launches["launches_fused"]["sym_band_matvec_int8"],
                  "step_host": step_launches["launches_host"]["sym_band_matvec_int8"],
                  "matvec": bench_line["launches"]["matvec"]["launches"]["sym_band_matvec_int8"],
                  "solve": bench_line["launches"]["solve"]["launches"]["sym_band_matvec_int8"]}
    work.cleanup()
    seconds["total"] = time.perf_counter() - t_start

    print(json.dumps({"seconds": {k: round(v, 2) for k, v in seconds.items()},
                      "cli": list(cli.values()) + list(mesh_cli.values()),
                      "ingestion": ingestion, "precond_eig": eig_profile, "ld_path": ld_path,
                      "kernel_bench": list(bench_rows.values()),
                      "wide_band": wide,
                      "engine_paths": {
                          "int8": {k: int8_run[k] for k in ("executed", "s_per_iteration",
                                                            "alignment")},
                          **{f: {k: v[k] for k in ("executed", "s_per_iteration", "alignment")}
                             for f, v in flavor_runs.items()},
                          **{f"{f}, (1, {MESH_SHARDS}) mesh":
                             {k: v[k] for k in ("executed", "s_per_iteration", "alignment",
                                                "deviation")}
                             for f, v in mesh_runs.items()}},
                      "fused": fused, "fused_cli": fused_cli, "mle": mle_run,
                      "checkpoints": ckpt, "blocksparse": blocksparse,
                      "process_group": processes,
                      "last_modules": {"profile_dir": traced, "gen_phen_mult": mult,
                                       "bed": geno, "plots": figures},
                      "port_bench": {k: bench_line[k] for k in (
                          "seconds", "value", "iter_ms_median", "iter_ms_median_host",
                          "device_ms_per_step", "matvec_ms", "matvec_GBps",
                          "hbm_read_ceiling_GBps", "roofline_frac_vs_spec",
                          "align_stop_vs_x0", "solve_rtol1e5")},
                      "ab_matrix": ab}))

    def band_entry(name, key, source, line, n_launch, library=None, **extra):
        f = full[key]
        return dict({"name": name, "route": "cuda", "source": source,
                     "replaces": f"sgvamp_tpu/ops/band_kernel.py:{line}",
                     "launches": n_launch, "max_abs_err": f["abs_err"], "ms": f["ms"],
                     "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
                     "bound_by": f["bound_by"], "library_ms": library},
                **{k: f[k] for k in ("block_bytes_read",) if k in f}, **extra)

    def float_entry(name, flavor, source, line, n_launch, **extra):
        """A float kernel's entry: timed in bfloat16 at the top level, its
        float32 numbers beside; BandedLD.matvec as the library call."""
        k16 = f"{flavor} bfloat16".strip()
        k32 = f"{flavor} float32".strip()
        return band_entry(
            name, k16, source, line, n_launch, library=full["einsum bfloat16"]["ms"],
            timed_storage="bfloat16", library_call="BandedLD.matvec", **extra,
            float32=dict({k: full[k32][k] for k in
                          ("ms", "plain_ms", "bound_ms", "bound_by", "abs_err")},
                         library_ms=full["einsum float32"]["ms"]))

    def spill_entry(name, key, source, line, n_launch, **extra):
        """A spill kernel's entry: ms per launch on one shard of MESH_SHARDS
        at the bench shape; no PyTorch call computes a shard's (y_l, carry)."""
        f = spill[key]
        return dict({"name": name, "route": "cuda", "source": source,
                     "replaces": f"sgvamp_tpu/ops/band_kernel.py:{line}",
                     "launches": n_launch, "max_abs_err": f["abs_err"], "ms": f["ms"],
                     "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
                     "bound_by": f["bound_by"], "library_ms": None,
                     "shards": MESH_SHARDS, "sharded_pass_ms": f["pass_ms"],
                     "unsharded_pass_ms": f["unsharded_pass_ms"]},
                **{k: f[k] for k in ("block_bytes_read",) if k in f}, **extra)

    def spill32(key):
        return {k: spill[key][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "abs_err",
                                           "pass_ms", "unsharded_pass_ms")}

    csrc = "sgvamp_torch/csrc/"
    packed = {"design": "mma.sync m16n8k16 bf16 on slots decoded without I2F, gather, cp.async"}
    read_once = {"design": "read once: a warp a block row walks each block once (16-byte "
                           "loads), runs of G rows keep their own mirror sums in shared "
                           "memory, the rest go through a scratch of partial sums and a "
                           "second launch"}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def float_once(G, D):
        return {"design": f"read once over tiles of G={G} block rows and D={D} diagonals, a "
                          "warp a block row walks each block of the tile once (16-byte loads), "
                          "the run's own mirror sums in shared memory, the mirror sums that "
                          "leave the run, and with several diagonal ranges the tiles' row "
                          "sums, through a scratch of partial sums and a second launch"}

    def int8_once(G, D):
        return {"design": f"read once over tiles of G={G} block rows and D={D} diagonals, a "
                          "warp a block row walks each int8 block of the tile once (cp.async "
                          "ring, decoded without I2F), dot then scale, mirror sums that "
                          "leave the run, and with several diagonal ranges the tiles' row "
                          "sums, through a scratch of partial sums and a second launch"}

    print(smi)
    print(json.dumps({"kernels": [
        band_entry("sym_band_matvec_int8", "int8", csrc + "sym_band_int8.cu", 179,
                   launches["sym_band_matvec_int8"],
                   **int8_once(*full["int8"]["tiles"]),
                   fused_launches=fused["int8"]["launches"]["sym_band_matvec_int8"],
                   mle_launches=mle_run["launches"]["sym_band_matvec_int8"],
                   mle_fused_launches=mle_run["fused_launches"]["sym_band_matvec_int8"],
                   full_band=dict(mult["int8_full_band"],
                                  launches=mult["runs"]["sym"]["launches"],
                                  **int8_once(*mult["int8_full_band"]["tiles"])),
                   bed_launches=geno["launches"], bench_launches=bench_int8,
                   ab_matrix_launches=ab["launches"]["sym_band_matvec_int8"]),
        float_entry("sym_band_matvec", "", csrc + "sym_band_float.cu", 179,
                    bench_launches["streamed"], **float_once(*full["bfloat16"]["tiles"]),
                    full_band=dict(mult["bf16_full_band"],
                                   launches=mult["runs"]["sym bfloat16"]["launches"],
                                   **float_once(*mult["bf16_full_band"]["tiles"])),
                    ab_matrix_launches=ab["launches"]["sym_band_matvec"]),
        band_entry("sym_band_matvec_int4", "int4", csrc + "sym_band_int4.cu", 179,
                   cli["int4"]["launches"], **packed,
                   ab_matrix_launches=ab["launches"]["sym_band_matvec_int4"]),
        band_entry("sym_band_matvec_hybrid", "hybrid", csrc + "sym_band_hybrid.cu", 179,
                   cli["hybrid"]["launches"], **packed, fused_launches=fused_cli["launches"],
                   ab_matrix_launches=ab["launches"]["sym_band_matvec_hybrid"],
                   checkpoint_launches=[n for c in ckpt.values() for n in c["launches"]],
                   traced_events={k: v["kernel_events"] for k, v in traced.items()}),
        float_entry("sym_slab_matvec_streamed", "slab-streamed", csrc + "sym_slab_streamed.cu",
                    333, flavor_runs["slab-streamed"]["launches"]["sym_slab_matvec_streamed"],
                    **float_once(*full["slab-streamed bfloat16"]["tiles"]),
                    full_band=dict(mult["slab_full_band"],
                                   **float_once(*mult["slab_full_band"]["tiles"])),
                    ab_matrix_launches=ab["launches"]["sym_slab_matvec_streamed"]),
        float_entry("sym_band_matvec_resident", "resident", csrc + "sym_band_resident.cu", 46,
                    flavor_runs["resident"]["launches"]["sym_band_matvec_resident"]),
        float_entry("sym_band_matvec_window", "window", csrc + "sym_band_resident.cu", 83,
                    bench_launches["window"]),
        float_entry("sym_slab_matvec_resident", "slab-resident", csrc + "sym_slab_resident.cu",
                    106, bench_launches["slab"] + bench_launches["slabresident"]),
        {"name": "read_max", "route": "triton",
         "source": "sgvamp_torch/ops/membench.py",
         "replaces": "sgvamp_tpu/ops/membench.py:38",
         "launches": launches["read_max"], "max_abs_err": probe_err,
         "ms": probe_s * 1e3, "plain_ms": probe_plain_ms,
         "bound_ms": probe_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": probe_library_ms,
         "bench_launches": bench_line["launches"]["matvec"]["launches"]["read_max"]},
        spill_entry("sym_band_matvec_int8_spill", "int8", csrc + "sym_band_int8.cu", 197,
                    mesh_runs["int8"]["launches"]["sym_band_matvec_int8_spill"],
                    **int8_once(_int8_runs(M_FULL // B_FULL // MESH_SHARDS, sms),
                                full["int8"]["hb"] + 1),
                    fused_launches=fused["int8 mesh"]["launches"]["sym_band_matvec_int8_spill"]),
        spill_entry("sym_band_matvec_spill", "bfloat16", csrc + "sym_band_float.cu", 197,
                    mesh_cli["bfloat16"]["launches"], timed_storage="bfloat16",
                    float32=spill32("float32"), **read_once),
        spill_entry("sym_band_matvec_int4_spill", "int4", csrc + "sym_band_int4.cu", 197,
                    mesh_cli["int4"]["launches"], **packed),
        spill_entry("sym_band_matvec_hybrid_spill", "hybrid", csrc + "sym_band_hybrid.cu", 197,
                    mesh_cli["hybrid"]["launches"] + mesh_cli["hybrid K=2"]["launches"],
                    **packed),
        spill_entry("sym_slab_matvec_streamed_spill", "slab-streamed bfloat16",
                    csrc + "sym_slab_streamed.cu", 380,
                    mesh_runs["bfloat16 slab-streamed"]["launches"][
                        "sym_slab_matvec_streamed_spill"],
                    timed_storage="bfloat16", float32=spill32("slab-streamed float32"),
                    **read_once),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
