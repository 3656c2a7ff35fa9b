#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (and fail on the first that fails):
  0. device: needs CUDA (there is no CPU fallback); prints the card's name
     and power limit as nvidia-smi reports them.
  1. build: compiles sgvamp_torch/csrc/*.cu with nvcc (sm_90a).
  2. kernels: the CUDA int8 band matvec against its plain PyTorch version
     on the card, on a small ragged operator and at the full bench shape
     (M=524288, bandwidth 256, B=128, K=1, S=2), scaled error <= 1e-5;
     ms/pass of both. The Triton read probe against its plain version,
     exactly. A small engine run on the GPU against the same run on the
     CPU (plain versions).
  3. main path: with the kernels' launch counts at zero, the bench's
     sequence at its geometry - the read-probe ceiling over the int8 LD
     blocks, then VampEngine.run for 10 iterations (EM prior, fused 2K-lane
     CG with a fixed 100-iteration budget) - and checks: every matvec went
     through the CUDA kernel (102 launches per iteration), the best
     iterate's alignment >= 0.9, the state finite up to it, the
     reference-format output files written.
Then a JSON line of the kernels' numbers, and the result line last.
"""

import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# bench geometry (bench.py _params / N_SAMPLES, LAM, H2)
M_FULL, BW_FULL, B_FULL = 524288, 256, 128
N_SAMPLES, LAM, H2 = 300000, 0.01, 0.7
SCALED_TOL = 1e-5     # kernel vs plain version: max|dy| / max|y|
ITERATIONS = 10
CG_MAXIT = 100
MIN_ALIGNMENT = 0.9


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


def scaled_err(y, y_ref) -> tuple:
    """(max abs error, max abs error / max |y_ref|)."""
    err = float((y - y_ref).abs().max())
    return err, err / float(y_ref.abs().max())


def engine_problem(M, bandwidth, B, device, seed=0, cg_maxit=CG_MAXIT):
    """The bench's problem at (M, bandwidth), packed int8 at block size B:
    (engine, x0)."""
    import torch

    from sgvamp_torch import PriorState, VampConfig, VampEngine, VampInputs
    from sgvamp_torch.data.simulate import simulate_ld_band
    from sgvamp_torch.ops.band_kernel import SymBandedLD

    band, r, x0 = simulate_ld_band(N_SAMPLES, M, bandwidth, h2=H2, lam=LAM,
                                   rng=np.random.default_rng(seed))
    op = SymBandedLD.from_band(band, block_size=B, device=device)
    del band
    mask = torch.zeros(op.M, dtype=torch.float32, device=device)
    mask[:M] = 1.0
    rp = torch.zeros((1, op.M), dtype=torch.float32, device=device)
    rp[0, :M] = torch.from_numpy(r)
    cfg = VampConfig(prior_update="em", dtype="float32", cg_maxit=cg_maxit,
                     cg_force_maxiter=True, em_prior_maxit=5, rho=0.5,
                     lmmse_damp=True)
    cm = max(int(M * LAM), 1)
    prior = PriorState.create(LAM, [1.0], [H2 / cm * N_SAMPLES])
    inputs = VampInputs(op=op, r=rp,
                        a=torch.ones(1, dtype=torch.float32, device=device),
                        N=torch.full((1,), float(N_SAMPLES), device=device),
                        mask=mask)
    return VampEngine(inputs, cfg, prior, gamw=5.0, gam1=1e-6), x0


def main() -> None:
    import torch

    from sgvamp_torch.core.vamp import alignment_l2
    from sgvamp_torch.data.simulate import simulate_ld_band
    from sgvamp_torch.io.writers import OutputWriter, read_bin
    from sgvamp_torch.ops import _build
    from sgvamp_torch.ops.band_kernel import (SymBandedLD, sym_band_matvec_int8,
                                              sym_band_matvec_int8_ref)
    from sgvamp_torch.ops.membench import (_read_once, measure_read_gbps,
                                           read_max, read_max_ref)

    # ---- 0. device ----
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on a GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"[0 device] {torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # ---- 1. build ----
    t0 = time.perf_counter()
    _build.load_library()
    with open(os.path.join(_build.BUILD_DIR, "build.log")) as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    print(f"[1 build] {time.perf_counter() - t0:.2f} s; ptxas: "
          + " | ".join(ptxas[:4]), flush=True)

    # ---- 2. kernels vs their plain versions ----
    rng = np.random.default_rng(1)
    band, _, _ = simulate_ld_band(10000, 1000, 300, rng=rng)
    small = SymBandedLD.from_band(band, block_size=128, K=2, device=dev)
    x = torch.from_numpy(rng.normal(size=(2, 2, small.M))).to(dev, torch.bfloat16)
    _, small_err = scaled_err(sym_band_matvec_int8(small.upper, small.scales, x),
                              sym_band_matvec_int8_ref(small.upper, small.scales, x))
    if not small_err <= SCALED_TOL:
        fail(f"int8 band kernel, ragged M=1000 hb={small.hb} K=2 S=2: "
             f"scaled error {small_err:.3e} > {SCALED_TOL}")

    t0 = time.perf_counter()
    engine, x0 = engine_problem(M_FULL, BW_FULL, B_FULL, dev)
    op = engine.inputs.op
    print(f"[2 set-up] bench problem simulated and packed in "
          f"{time.perf_counter() - t0:.1f} s: upper {tuple(op.upper.shape)} int8, "
          f"{op.bytes_per_pass()} bytes per pass", flush=True)
    xf = torch.randn((1, 2, op.M), generator=torch.Generator(dev).manual_seed(0),
                     device=dev).to(torch.bfloat16)
    y = sym_band_matvec_int8(op.upper, op.scales, xf)
    y_ref = sym_band_matvec_int8_ref(op.upper, op.scales, xf)
    band_abs, band_err = scaled_err(y, y_ref)
    del y, y_ref
    if not band_err <= SCALED_TOL:
        fail(f"int8 band kernel at the full shape: scaled error {band_err:.3e} > {SCALED_TOL}")
    # twin, kernel, kernel, twin: both versions see the same card state
    t_plain = [cuda_ms(lambda: sym_band_matvec_int8_ref(op.upper, op.scales, xf), 5)]
    t_kern = [cuda_ms(lambda: sym_band_matvec_int8(op.upper, op.scales, xf), 50)
              for _ in range(2)]
    t_plain.append(cuda_ms(lambda: sym_band_matvec_int8_ref(op.upper, op.scales, xf), 5))
    ms_kern, ms_plain = min(t_kern), min(t_plain)
    bpp = op.bytes_per_pass()
    print(f"[2 band kernel] scaled error {small_err:.2e} (ragged, K=2) and "
          f"{band_err:.2e} (full shape, max abs {band_abs:.3e}), tol {SCALED_TOL}; "
          f"CUDA {ms_kern:.4f} ms/pass = {bpp / ms_kern / 1e6:.1f} GB/s, plain "
          f"{ms_plain:.4f} ms/pass = {bpp / ms_plain / 1e6:.1f} GB/s "
          f"(over bytes_per_pass)", flush=True)

    uf = torch.randn(16 << 20, generator=torch.Generator(dev).manual_seed(2), device=dev)
    uf[12345] = 1e6
    probe_err = 0.0
    for name, arr in (("float32", uf), ("int8 LD blocks", op.upper)):
        err = float((read_max(arr).double() - read_max_ref(arr).double()).abs().max())
        if err != 0.0:
            fail(f"Triton read probe differs from its plain version on {name} by {err}")
        probe_err = max(probe_err, err)
    probe_plain_ms = cuda_ms(lambda: read_max_ref(op.upper), 10)
    print(f"[2 read probe] Triton read_max equals read_max_ref exactly "
          f"(float32, int8); plain version {probe_plain_ms:.4f} ms/pass over "
          f"the int8 blocks", flush=True)

    # the same small engine run through the kernel and through the CPU's
    # plain versions, with the same probes
    runs = {}
    for d in (dev, torch.device("cpu")):
        eng, _ = engine_problem(16384, 256, 128, d, seed=3, cg_maxit=20)
        u = np.random.default_rng(4).choice([-1.0, 1.0], size=(3, 1, eng.inputs.op.M))
        runs[d.type] = eng.run(3, fixed_u=u)
    a, b = runs["cuda"]["xhat1"][-1], runs["cpu"]["xhat1"][-1]
    small_rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    if not (np.all(np.isfinite(a)) and small_rel <= 1e-3):
        fail(f"small engine run, GPU vs CPU: xhat1 relative L2 {small_rel:.3e} > 1e-3")
    print(f"[2 engine parity] M=16384, 3 iterations: GPU vs CPU xhat1 "
          f"relative L2 {small_rel:.2e} (tol 1e-3)", flush=True)

    # ---- 3. the main path ----
    logging.basicConfig(stream=sys.stdout, format="%(message)s")
    logging.getLogger("sgvamp").setLevel(logging.DEBUG)
    stamps = []
    sym_band_matvec_int8.launches = 0
    _read_once.launches = 0
    gbps, probe_s = measure_read_gbps(op.upper, n=20)
    with tempfile.TemporaryDirectory() as out_dir:
        writer = OutputWriter(out_dir, "smoke", K=1)
        hist = engine.run(ITERATIONS, writer=writer, x0=x0, stop_tol=1e-4,
                          stop_gam1_drop=10.0,
                          callback=lambda it, s, a: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        launches = {"band": sym_band_matvec_int8.launches, "probe": _read_once.launches}
        files = sorted(os.listdir(out_dir))
        best_it = hist["best_it"]
        best_bin = (read_bin(writer.xhat_path(best_it))
                    if best_it >= 0 and os.path.exists(writer.xhat_path(best_it)) else None)
    end_it = hist.get("stopped_at", hist.get("aborted_at", ITERATIONS - 1))
    executed = end_it + 1
    s_per_it = float(np.median(np.diff(stamps))) if len(stamps) > 1 else float("nan")
    best = hist["best_xhat1"]
    best_align = alignment_l2(best, x0)[0] if best is not None else float("nan")
    print(f"[3 main path] read ceiling {gbps:.1f} GB/s ({probe_s * 1e3:.4f} ms/pass "
          f"over the int8 blocks); band kernel {ms_kern:.4f} ms/pass = "
          f"{100 * bpp / ms_kern / 1e6 / gbps:.1f}% of it", flush=True)
    print(f"[3 main path] {executed} iterations, {s_per_it:.4f} s/iteration "
          f"(median after the first), band kernel launches {launches['band']} "
          f"(expect {102 * executed}), probe launches {launches['probe']}; "
          f"alignment {[round(v, 5) for v in hist['alignment']]}; stop "
          f"{hist.get('stop_reason')} at {hist.get('stopped_at')}; best iterate "
          f"{best_it}, alignment {best_align:.5f}", flush=True)
    if launches["band"] != 102 * executed:
        fail(f"band kernel launched {launches['band']} times, expected {102 * executed}")
    if launches["probe"] == 0:
        fail("the read probe kernel was not launched on the main path")
    if "aborted_at" in hist or best_it < 0 or not np.all(np.isfinite(best)):
        fail(f"non-finite state before the best iterate (best_it {best_it})")
    if best.shape != (M_FULL,):
        fail(f"best iterate has shape {best.shape}, expected ({M_FULL},)")
    if not best_align >= MIN_ALIGNMENT:
        fail(f"best-iterate alignment {best_align:.5f} < {MIN_ALIGNMENT}")
    for need in ("smoke_cohort_1.csv", "smoke_metrics.csv", "smoke_xhat_it_0.bin"):
        if need not in files:
            fail(f"output file {need} missing (have {files})")
    if best_bin is None or not np.array_equal(best_bin, best.astype(np.float64)):
        fail(f"smoke_xhat_it_{best_it}.bin does not hold the best iterate")

    print(json.dumps({"kernels": [
        {"name": "sym_band_matvec_int8", "route": "cuda",
         "source": "sgvamp_torch/csrc/sym_band_int8.cu",
         "replaces": "sgvamp_tpu/ops/band_kernel.py:179",
         "launches": launches["band"], "max_abs_err": band_abs,
         "ms": ms_kern, "plain_ms": ms_plain},
        {"name": "read_max", "route": "triton",
         "source": "sgvamp_torch/ops/membench.py",
         "replaces": "sgvamp_tpu/ops/membench.py:38",
         "launches": launches["probe"], "max_abs_err": probe_err,
         "ms": probe_s * 1e3, "plain_ms": probe_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
