#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, a few lines of output each (and fail on the first that fails):
  0. device: needs CUDA (there is no CPU fallback); prints the card's name
     and power limit as nvidia-smi reports them.
  1. build: compiles the seven sgvamp_torch/csrc/*.cu with nvcc (sm_90a),
     one process per source, all started together.
  2. kernels against their plain PyTorch versions on the card: the five
     storages of the streamed diag matvec (int8, float blocks in bfloat16 /
     float32 / float64, int4, hybrid) and, for the three float types, the
     streamed slab, resident diag (with and without `window`) and resident
     slab kernels, on a small ragged operator (M=1000, bandwidth 300, K=2,
     S=2) at B = 64, 128, 256, and at the full bench shape (M=524288,
     bandwidth 256, B=128, K=1, S=2; bfloat16 and float32 for the float
     kernels), scaled error <= 1e-5 (1e-12 for float64); ms/pass of kernel
     and plain version at the full shape, and of BandedLD.matvec (one
     einsum over full-band storage) on the same band. The Triton read probe
     against its plain version, exactly. A small engine run on the GPU
     against the same run on the CPU (plain versions).
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
     the reference-format files and reach a best-iterate alignment >= 0.9.
  5. the operator-flavor path at the bench shape, over the band of phase 2:
     with the launch counts at zero, sgvamp_torch.utils.kernel_bench.main
     over einsum, streamed, resident, window, slab, slabstreamed and
     slabresident in bfloat16, each variant launching its own kernel and no
     other; then VampEngine.run (EM prior, fixed 100-iteration CG budget, 4
     iterations) over the bfloat16 slab-streamed operator and over the
     bfloat16 resident operator, with phase 3's checks on each.
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
CLI_ITERATIONS = 10
CG_MAXIT = 100
MIN_ALIGNMENT = 0.9
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

# NVIDIA H100 SXM data sheet: HBM bytes/s, dense operations/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "int4": 1979e12, "hybrid": 1979e12,
            "bfloat16": 989e12, "float32": 67e12}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, n: int) -> float:
    """Mean ms per call of fn over n calls, by CUDA events, after one
    warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def bound_ms(op, S: int, storage: str) -> tuple:
    """The least time the card could take for one matvec of `op` with S
    lanes: (ms, "bytes" or "operations", bytes moved). Bytes: blocks,
    scales and x read once, y written once, over the HBM rate; operations:
    two per stored element and lane for each block product the band holds
    (row and mirror), over the peak rate of the storage's type."""
    xb, yb = {"float32": (4, 4), "float64": (8, 8)}.get(storage, (2, 4))
    nbytes = op.bytes_per_pass() + op.K * S * op.M * (xb + yb)
    blocks = op.nb + 2 * sum(op.nb - d for d in range(1, op.hb + 1))
    ops = 2.0 * S * op.K * blocks * op.B * op.B
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[storage]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes)


def block_bytes_read(op, S: int) -> int:
    """Bytes of blocks the operator's kernel reads a pass (all cohorts). The
    streamed kernels gather: every off-diagonal block twice. The resident
    kernels read every block once, and at each run boundary the blocks of
    the previous run's last hb rows whose mirror terms cross it once more."""
    from sgvamp_torch.ops.band_kernel import _resident_rows

    nb, hb = op.nb, op.hb
    off = sum(nb - d for d in range(1, hb + 1))      # stored off-diagonal blocks
    if op._use_resident(S):
        G = _resident_rows(op.upper, S, op.rows_per_step)
        off += sum(1 for r0 in range(G, nb, G) for a in range(1, min(hb, r0) + 1)
                   for d in range(a, hb + 1) if d - a < G and r0 + d - a < nb)
    else:
        off *= 2
    full_block = op.B * op.B * op.upper.element_size()
    far_block = full_block // 2 if op.packed or op.hybrid else full_block
    d0_block = far_block if op.packed else full_block
    return op.K * (nb * d0_block + off * far_block)


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


def engine_over(op, r, M, device, cg_maxit=CG_MAXIT):
    """The bench's engine over a packed operator: float32, EM prior, a
    fixed CG budget."""
    import torch

    from sgvamp_torch import PriorState, VampConfig, VampEngine, VampInputs

    mask = torch.zeros(op.M, dtype=torch.float32, device=device)
    mask[:M] = 1.0
    rp = torch.zeros((1, op.M), dtype=torch.float32, device=device)
    rp[0, :M] = torch.from_numpy(np.asarray(r, np.float32))
    cfg = VampConfig(prior_update="em", dtype="float32", cg_maxit=cg_maxit,
                     cg_force_maxiter=True, em_prior_maxit=5, rho=0.5,
                     lmmse_damp=True)
    cm = max(int(M * LAM), 1)
    prior = PriorState.create(LAM, [1.0], [H2 / cm * N_SAMPLES], device=device)
    inputs = VampInputs(op=op, r=rp,
                        a=torch.ones(1, dtype=torch.float32, device=device),
                        N=torch.full((1,), float(N_SAMPLES), device=device),
                        mask=mask)
    return VampEngine(inputs, cfg, prior, gamw=5.0, gam1=1e-6)


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
            operator: str = "sym") -> dict:
    """One production-mode run of sgvamp_torch.cli.main over the panel
    files at `prefix` (the README's biobank flags), with its checks.
    `own` is the name of the wrapper this storage must launch, None for an
    operator that launches no band kernel (--operator banded)."""
    import torch

    from sgvamp_torch.cli import main as cli_main
    from sgvamp_torch.core.vamp import alignment_l2
    from sgvamp_torch.io.writers import read_bin

    name = f"bb_{operator}_{ld_dtype}"
    cm = max(int(M * LAM), 1)
    argv = ["--ld-files", prefix + "_R.npz", "--r-files", prefix + "_r.npy",
            "--true-signal-file", prefix + "_bet.npy",
            "--out-dir", out_dir, "--out-name", name,
            "--N", str(N_SAMPLES), "--M", str(M), "--iterations", str(CLI_ITERATIONS),
            "--prior-probs", f"{1 - LAM:g},{LAM:g}", "--prior-vars", f"0,{H2 / cm:.6g}",
            "--operator", operator, "--ld-dtype", ld_dtype, "--block-size", str(B_FULL),
            "--bandwidth", str(BW_FULL), "--cg-maxit", "500", "--cg-rtol", "1e-5",
            "--cg-precond-block", "64", "--cg-precond-dtype", "bfloat16",
            "--lmmse-damp", "1", "--rho", "0.5", "--stop-on-divergence", "1", *extra]
    reset_launches()
    t0 = time.perf_counter()
    with LogCapture() as log:
        rc = cli_main.main(argv)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = band_launches()
    what = f"cli.main --operator {operator} --ld-dtype {ld_dtype} at M={M}"
    if rc != 0:
        fail(f"{what} returned {rc}")
    for need in (f"{name}_cohort_1.csv", f"{name}_metrics.csv", f"{name}_xhat_it_0.bin",
                 f"{name}_xhat_best.bin"):
        if not os.path.exists(os.path.join(out_dir, need)):
            fail(f"{what}: output file {need} missing (have {sorted(os.listdir(out_dir))})")
    passes = [int(v) for v in log.floats(r"\[roofline\] iteration \d+: [0-9.]+s, (\d+) LD passes")]
    step_s = log.floats(r"\[roofline\] iteration \d+: ([0-9.]+)s")
    if sum(passes) == 0:
        fail(f"{what}: the run logged no LD pass")
    if own is not None and counts[own] != sum(passes):
        fail(f"{what}: {own} launched {counts[own]} times, the run logged "
             f"{sum(passes)} LD passes")
    others = {k: v for k, v in counts.items() if k != own and v}
    if others:
        fail(f"{what}: other band kernels were launched: {others}")
    with open(os.path.join(out_dir, f"{name}_cohort_1.csv")) as f:
        rows = [ln.split("\t") for ln in f.read().splitlines()[1:]]
    if not rows or not np.all(np.isfinite(np.asarray(rows, dtype=np.float64))):
        fail(f"{what}: non-finite or missing rows in {name}_cohort_1.csv")
    stopped = [ln for ln in log.lines if ln.startswith("STOP at iteration")]
    if any("ERROR: non-finite" in ln for ln in log.lines) or not (
            stopped or len(rows) == CLI_ITERATIONS):
        fail(f"{what}: the run neither stopped through the StopMonitor nor ran "
             f"{CLI_ITERATIONS} iterations ({len(rows)} rows)")
    best = read_bin(os.path.join(out_dir, f"{name}_xhat_best.bin"))
    bet = np.load(prefix + "_bet.npy").reshape(-1)
    if best.shape != (M,) or not np.all(np.isfinite(best)):
        fail(f"{what}: best iterate has shape {best.shape} or is not finite")
    align = alignment_l2(best, bet)[0]
    if not align >= MIN_ALIGNMENT:
        fail(f"{what}: best-iterate alignment {align:.5f} < {MIN_ALIGNMENT}")
    res = {"operator": operator, "ld_dtype": ld_dtype, "M": M,
           "launches": counts[own] if own else 0, "iterations": len(rows),
           "passes": passes, "ingest_s": sum(log.floats(r"\[timer\] load/R: ([0-9.]+)s")),
           "precond_eig_s": sum(log.floats(r"\[timer\] precond/eig: ([0-9.]+)s")),
           "infer_s": sum(log.floats(r"\[timer\] infer: ([0-9.]+)s")),
           "s_per_iteration": float(np.median(step_s[1:])) if len(step_s) > 1 else float("nan"),
           "total_s": total_s, "alignment": align,
           "stop": stopped[0] if stopped else "ran all iterations"}
    print(f"[4 cli] --operator {operator} --ld-dtype {ld_dtype}, M={M}: {total_s:.1f} s in all; "
          f"ingestion "
          f"(load/R: .npz -> band -> blocks -> card) {res['ingest_s']:.2f} s, "
          f"preconditioner eigendecomposition {res['precond_eig_s']:.2f} s, inference "
          f"{res['infer_s']:.2f} s = {res['s_per_iteration']:.4f} s/iteration (median "
          f"after the first); {len(rows)} iterations, LD passes {passes}, "
          f"{own or 'band kernel'} launches {res['launches']}, other band kernels 0; "
          f"{res['stop']}; best-iterate alignment "
          f"{align:.5f}", flush=True)
    return res


def engine_run(op, r, x0, own: str, iterations: int, phase: str, before_run=None) -> dict:
    """VampEngine.run at the bench geometry over `op` with a fixed CG
    budget, started with the launch counts at zero, and its checks: 102
    launches of `own` per executed iteration and no other band kernel, a
    best iterate that is finite and aligned, the reference-format files.
    `before_run(engine)` runs after the counts are reset and before the
    run (the read probe of phase 3)."""
    import torch

    from sgvamp_torch.core.vamp import alignment_l2
    from sgvamp_torch.io.writers import OutputWriter, read_bin
    from sgvamp_torch.ops.membench import _read_once

    device = op.upper.device
    engine = engine_over(op, r, M_FULL, device)
    stamps = []
    reset_launches()
    extra = before_run(engine) if before_run else None
    with tempfile.TemporaryDirectory() as out_dir:
        writer = OutputWriter(out_dir, "smoke", K=1)
        hist = engine.run(iterations, writer=writer, x0=x0, stop_tol=1e-4,
                          stop_gam1_drop=10.0,
                          callback=lambda it, s, a: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
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
          f"{102 * executed}), probe launches {launches['read_max']}; alignment "
          f"{[round(v, 5) for v in hist['alignment']]}; stop {hist.get('stop_reason')} at "
          f"{hist.get('stopped_at')}; best iterate {best_it}, alignment {best_align:.5f}",
          flush=True)
    if launches[own] != 102 * executed:
        fail(f"{phase}: {own} launched {launches[own]} times, expected {102 * executed}")
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
            "alignment": best_align, "extra": extra}


def main() -> None:
    import torch

    from sgvamp_torch.core.operators import BandedLD
    from sgvamp_torch.data.simulate import simulate_ld_band
    from sgvamp_torch.ops import _build
    from sgvamp_torch.ops.band_kernel import SymBandedLD, band_kernel_of
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
    if len(libs) != 7:
        fail(f"expected seven kernel libraries, built {sorted(libs)}")

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

    work = tempfile.TemporaryDirectory(prefix="sgvamp_smoke_")
    prefix = os.path.join(work.name, "bb")
    seconds["gen_band_full"] = gen_band(prefix, M_FULL)
    t0 = time.perf_counter()
    band, r_full, x0 = load_panel(prefix, M_FULL)
    seconds["load_panel_full"] = time.perf_counter() - t0
    print(f"[2 set-up] gen-band at M={M_FULL} wrote its files in "
          f"{seconds['gen_band_full']:.1f} s; .npz -> band {band.shape} in "
          f"{seconds['load_panel_full']:.1f} s", flush=True)

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
        read = block_bytes_read(op, S)
        full[key] = {"abs_err": abs_err, "rel_err": rel, "ms": ms_kern,
                     "plain_ms": ms_plain, "bound_ms": b_ms, "bound_by": b_by,
                     "bytes": nbytes, "bytes_per_pass": op.bytes_per_pass(),
                     "block_bytes_read": read, "kernel": kernel.__name__}
        print(f"[2 {key}] {kernel.__name__}, full shape upper {tuple(op.upper.shape)} "
              f"{str(op.upper.dtype).split('.')[-1]} ({label}), "
              f"{op.bytes_per_pass()} bytes per pass, {nbytes} with x and y, {read} block "
              f"bytes read by the kernel: scaled error {rel:.2e} (max abs {abs_err:.3e}, tol "
              f"{SCALED_TOL}); kernel {ms_kern:.4f} ms/pass = "
              f"{op.bytes_per_pass() / ms_kern / 1e6:.1f} GB/s over bytes_per_pass, "
              f"plain {ms_plain:.4f} ms/pass, bound {b_ms:.4f} ms ({b_by} at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s)", flush=True)

    for storage in STORAGES:
        t1 = time.perf_counter()
        op = dataclasses.replace(
            SymBandedLD.from_band(band, block_size=B_FULL, dtype=storage, device=dev),
            mode="streamed")
        measure(op, storage, storage, f"packed in {time.perf_counter() - t1:.1f} s")
        if storage == "int8":
            op_int8 = op
        if storage in ("bfloat16", "float32"):
            for flavor in FLAVORS:
                measure(with_flavor(op, flavor), f"{flavor} {storage}", storage,
                        "the same blocks")
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
    del op_int8
    torch.cuda.empty_cache()
    seconds["engine_path"] = time.perf_counter() - t0

    # ---- 4. the command-line path ----
    t0 = time.perf_counter()
    out_dir = os.path.join(work.name, "out")
    cli = {"hybrid": cli_run(prefix, out_dir, M_FULL, "hybrid", "sym_band_matvec_hybrid")}
    seconds["cli_hybrid_full"] = time.perf_counter() - t0
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
        # one warm-up and four timed chains of n and of 2n passes
        expect = 15 * BENCH_PASSES if own else 0
        got = {k: v for k, v in counts.items() if v}
        want = {own: expect} if own else {}
        if got != want:
            fail(f"kernel_bench variant {variant} launched {got}, expected {want}")
        bench_rows[variant] = rows[0]
        bench_launches[variant] = expect
    print("[5 kernel_bench] bfloat16, bench shape, ms per chained operator pass (kernel, "
          "casts, lane transposes and the regularization): "
          + ", ".join(f"{v} {r['ms_per_pass']} ({r['kernel']})" for v, r in bench_rows.items())
          + "; each variant launched its own kernel 15 x passes times and no other",
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
    del op_bf16
    seconds["flavor_engine_paths"] = time.perf_counter() - t0
    work.cleanup()
    seconds["total"] = time.perf_counter() - t_start

    print(json.dumps({"seconds": {k: round(v, 2) for k, v in seconds.items()},
                      "cli": list(cli.values()),
                      "kernel_bench": list(bench_rows.values()),
                      "engine_paths": {
                          "int8": {k: int8_run[k] for k in ("executed", "s_per_iteration",
                                                            "alignment")},
                          **{f: {k: v[k] for k in ("executed", "s_per_iteration", "alignment")}
                             for f, v in flavor_runs.items()}}}))

    def band_entry(name, key, source, line, n_launch, library=None, **extra):
        f = full[key]
        return dict({"name": name, "route": "cuda", "source": source,
                     "replaces": f"sgvamp_tpu/ops/band_kernel.py:{line}",
                     "launches": n_launch, "max_abs_err": f["abs_err"], "ms": f["ms"],
                     "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
                     "bound_by": f["bound_by"], "library_ms": library,
                     "bytes": f["bytes"], "block_bytes_read": f["block_bytes_read"]}, **extra)

    def float_entry(name, flavor, source, line, n_launch):
        """A float kernel's entry: timed in bfloat16 at the top level, its
        float32 numbers beside; BandedLD.matvec as the library call."""
        k16 = f"{flavor} bfloat16".strip()
        k32 = f"{flavor} float32".strip()
        return band_entry(
            name, k16, source, line, n_launch, library=full["einsum bfloat16"]["ms"],
            timed_storage="bfloat16", library_call="BandedLD.matvec",
            library_bytes=full["einsum bfloat16"]["bytes_per_pass"],
            float32=dict({k: full[k32][k] for k in
                          ("ms", "plain_ms", "bound_ms", "bound_by", "bytes", "abs_err",
                           "block_bytes_read")},
                         library_ms=full["einsum float32"]["ms"],
                         library_bytes=full["einsum float32"]["bytes_per_pass"]))

    csrc = "sgvamp_torch/csrc/"
    print(smi)
    print(json.dumps({"kernels": [
        band_entry("sym_band_matvec_int8", "int8", csrc + "sym_band_int8.cu", 179,
                   launches["sym_band_matvec_int8"]),
        float_entry("sym_band_matvec", "", csrc + "sym_band_float.cu", 179,
                    bench_launches["streamed"]),
        band_entry("sym_band_matvec_int4", "int4", csrc + "sym_band_int4.cu", 179,
                   cli["int4"]["launches"]),
        band_entry("sym_band_matvec_hybrid", "hybrid", csrc + "sym_band_hybrid.cu", 179,
                   cli["hybrid"]["launches"]),
        float_entry("sym_slab_matvec_streamed", "slab-streamed", csrc + "sym_slab_streamed.cu",
                    333, flavor_runs["slab-streamed"]["launches"]["sym_slab_matvec_streamed"]),
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
         "library_ms": probe_library_ms, "bytes": probe_bytes},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
