"""The port's bench (python -m sgvamp_torch.bench) against the JAX bench
(bench.py), on the CPU at the small size.

Held together: the sizes of every SGVAMP_BENCH_SIZE, the problem (equal to
the bit), the step child's quality gate on the same problem with the same
injected probes, the CPU baseline (the same source), the final line's keys
and what a failing child does. Tolerances of the gate: the int8 operator in
float32 on both sides is the quantized flavor of tests/test_torch_vamp.py
(the JAX package's __graft_entry__.py tolerances), so the alignments (at
it=10, the best, and the StopMonitor's iterate) must agree within 2e-3, and
the best iteration, the stop iteration and its reason must be the same.
"""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jbench
from sgvamp_torch import bench as tbench
from sgvamp_tpu.data.simulate import simulate_ld_band as jax_simulate_ld_band

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(tbench.__file__)))
ALIGN_TOL = 2e-3
KNOBS = ("SGVAMP_BENCH_SIZE", "SGVAMP_BENCH_B", "SGVAMP_BENCH_K", "SGVAMP_BENCH_CHILD",
         "SGVAMP_BENCH_PLATFORM", "SGVAMP_BENCH_SOLVE", "SGVAMP_BENCH_LD_DTYPE",
         "SGVAMP_BENCH_OPERATOR", "SGVAMP_BENCH_LAYOUT", "SGVAMP_BENCH_MODE",
         "SGVAMP_BENCH_BUDGET_S", "SGVAMP_BENCH_MV_REPS")
# the final line's keys: bench.main()'s, less the one with no counterpart,
# plus the port's own (see sgvamp_torch/bench.py's docstring)
DROPPED = {"xla_cache_entries"}
ADDED = {"iter_ms_median_host", "iter_ms_samples_host", "device_ms_per_step",
         "kernels_built", "launches", "errors"}


@pytest.fixture
def env(monkeypatch, tmp_path):
    """The bench's knobs unset, the small size on the CPU, and the problem
    cache in a temporary directory."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SGVAMP_BENCH_SIZE", "small")
    monkeypatch.setenv("SGVAMP_BENCH_PLATFORM", "cpu")
    monkeypatch.setenv("SGVAMP_BENCH_CACHE_DIR", str(tmp_path / "cache"))
    return monkeypatch


@pytest.fixture(scope="module")
def small_problem():
    """The bench's small problem, made by the JAX package's simulator."""
    M, bw = 16384, 128
    band, r, x0 = jax_simulate_ld_band(jbench.N_SAMPLES, M, bw, h2=jbench.H2, lam=jbench.LAM,
                                       rng=np.random.default_rng(0), dtype=np.float32)
    return band, r, x0


@pytest.mark.parametrize("B", [None, "64"])
@pytest.mark.parametrize("size", ["small", "medium", "large", "xl", None])
def test_params_match_the_jax_bench(env, size, B):
    env.delenv("SGVAMP_BENCH_SIZE")
    if size:
        env.setenv("SGVAMP_BENCH_SIZE", size)
    if B:
        env.setenv("SGVAMP_BENCH_B", B)
    assert tbench._params() == jbench._params()
    assert (tbench.N_SAMPLES, tbench.LAM, tbench.H2) == (jbench.N_SAMPLES, jbench.LAM, jbench.H2)
    assert tbench._DEFAULT_LD_DTYPE == jbench._DEFAULT_LD_DTYPE == "int8"


def test_problem_is_the_jax_simulators_to_the_bit(env, small_problem, tmp_path):
    got = tbench.build_problem(16384, 128, tbench.N_SAMPLES, tbench.LAM, tbench.H2)
    path = tbench.problem_path(16384, 128)
    assert os.path.dirname(path) == str(tmp_path / "cache") and os.path.exists(path)
    again = tbench.build_problem(16384, 128, tbench.N_SAMPLES, tbench.LAM, tbench.H2)
    for a, b, c in zip(got, again, small_problem):
        assert a.dtype == c.dtype and np.array_equal(a, c) and np.array_equal(b, c)
    # K cohorts: independent noise draws over one panel
    got = tbench.build_problem(4096, 64, 20000, 0.05, 0.7, seed=3, K=2)
    want = jax_simulate_ld_band(20000, 4096, 64, h2=0.7, lam=0.05, n_r=2,
                                rng=np.random.default_rng(3), dtype=np.float32)
    assert got[1].shape == (2, 4096)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert tbench.problem_path(4096, 64, K=2, seed=3).endswith("problem_M4096_bw64_K2_s3.npz")


def test_gen_band_files_hold_the_bench_problem(env, tmp_path):
    """chip_smoke.py hands gen-band's panel files, read back as the command
    line reads them, to the bench's problem cache: they are build_problem's
    arrays to the bit."""
    from sgvamp_torch.cli import simulate as cli_simulate
    from sgvamp_torch.data import loaders

    M, bw, N = 4096, 256, tbench.N_SAMPLES
    prefix = str(tmp_path / "bb")
    assert cli_simulate.main(["gen-band", "-out", prefix, "-N", str(N), "-M", str(M), "-h2",
                              str(tbench.H2), "-lam", str(tbench.LAM), "--bandwidth", str(bw),
                              "--seed", "0", "--uncompressed"]) == 0
    band, got_bw, dropped = loaders.csr_to_band(loaders.load_R(prefix + "_R.npz"), bw)
    r = loaders.load_r(prefix + "_r.npy", M, N)
    x0 = loaders.load_true_signal(prefix + "_bet.npy", M, N)
    want = tbench.build_problem(M, bw, N, tbench.LAM, tbench.H2)
    assert (got_bw, dropped) == (bw, 0)
    assert band.dtype == want[0].dtype and np.array_equal(band, want[0])
    assert np.array_equal(r.astype(np.float32), want[1]) and np.array_equal(r, want[1])
    assert np.array_equal(x0, want[2])


def _jax_gate(band, r, x0, u):
    """bench.py's quality gate (time_step_child, bench.py:231-272) on the
    JAX engine with the probes u[it] injected."""
    import jax

    from sgvamp_tpu.core import vamp as V

    M, bw, B, cg_maxit, _ = jbench._params()
    _, inputs, state, cfg = jbench._setup_tpu(band, r, jbench.N_SAMPLES, jbench.LAM,
                                              jbench.H2, cg_maxit, B)
    step = jax.jit(lambda s, i, uu: V.vamp_step(s, i, cfg, uu))

    def _align(xh):
        xh = np.asarray(xh[: x0.shape[0]], np.float64)
        denom = np.linalg.norm(xh) * np.linalg.norm(x0)
        a = float(xh @ np.asarray(x0, np.float64) / denom) if denom else 0.0
        return a if np.isfinite(a) else -1.0

    state, aux = step(state, inputs, u[0])
    mon = V.StopMonitor(tol=1e-4, gam1_drop=10.0)
    mon.update(1, np.asarray(state.xhat1), np.asarray(aux.gam1))
    align_best, align_best_it = _align(state.xhat1), 1
    for gate_it in range(2, 11):
        state, aux = step(state, inputs, u[gate_it - 1])
        a = _align(state.xhat1)
        if a > align_best:
            align_best, align_best_it = a, gate_it
        mon.update(gate_it, np.asarray(state.xhat1), np.asarray(aux.gam1))
    return {"align": _align(state.xhat1), "align_best": align_best,
            "align_best_it": align_best_it, "align_stop": _align(mon.best_xhat1),
            "stop_it": mon.stopped_at, "stop_reason": mon.reason}


def test_step_gate_matches_the_jax_bench_with_the_same_probes(env, small_problem):
    band, r, x0 = small_problem
    M, bw, B, cg_maxit, iters = tbench._params()
    u = np.random.default_rng(7).choice([-1.0, 1.0], size=(10, 1, M)).astype(np.float32)
    want = _jax_gate(band, r, x0, u)
    got = tbench.time_step_child(band, r, tbench.N_SAMPLES, tbench.LAM, tbench.H2, iters,
                                 cg_maxit, B, x0=x0, repeats=1, fixed_u=u)
    for key in ("align", "align_best", "align_stop"):
        assert abs(got[key] - want[key]) <= ALIGN_TOL, (key, got[key], want[key])
    for key in ("align_best_it", "stop_it", "stop_reason"):
        assert got[key] == want[key], (key, got, want)
    assert want["align_stop"] > 0.95
    # one block of each timing, the state finite, no kernel on the CPU
    assert len(got["iter_s_samples"]) == len(got["iter_s_samples_host"]) == 1
    assert all(s > 0 for s in got["iter_s_samples"] + got["iter_s_samples_host"])
    assert got["finite"] is True and got["timed_steps"] == iters
    assert got["kernels_built"] is False and got["device_ms_per_step"] == -1.0
    assert not (got["launches_fused"] or got["launches_fused_eager"] or got["launches_host"])


def test_baseline_is_the_jax_baseline(small_problem):
    assert inspect.getsource(tbench.baseline_cpu) == inspect.getsource(jbench.baseline_cpu)
    band, r, _ = small_problem
    for fn in (tbench.baseline_cpu, jbench.baseline_cpu):
        per_iter, parts = fn(band, r, tbench.N_SAMPLES, tbench.LAM, tbench.H2, 20,
                             sample_markers=200)
        assert set(parts) == {"matvec_s", "denoise_s", "em_s"}
        assert per_iter == pytest.approx((2 * 20 + 2) * parts["matvec_s"] + parts["denoise_s"]
                                         + parts["em_s"], rel=1e-12)


STEP = {"iter_s_samples": [0.04, 0.05, 0.045], "iter_s_samples_host": [0.07, 0.06, 0.08],
        "device_ms_per_step": 39.5, "compile_s": 2.0, "kernels_built": True, "finite": True,
        "align": 0.9, "align_best": 0.987, "align_best_it": 2, "align_stop": 0.987,
        "stop_it": 4, "stop_reason": "diverging", "timed_steps": 12,
        "launches_fused": {"sym_band_matvec_int8": 1224}, "launches_fused_eager": {},
        "launches_host": {"sym_band_matvec_int8": 1224}}
MATVEC = {"matvec_s": 1e-4, "memread_s": 7e-5, "bytes_per_pass": 2 * 10 ** 8,
          "ceiling_gbps": 2900.0, "probe_pre_gbps": 2900.0, "probe_post_gbps": 2850.0,
          "launches": {"read_max": 360, "sym_band_matvec_int8": 960}}
SOLVE = {"precond_block": 64, "precond_dtype": "bfloat16", "ld_dtype": "int8", "plain_s": 1.0,
         "plain_iters": 70, "plain_converged": True, "precond_s": 0.5, "precond_iters": 30,
         "precond_converged": True, "speedup": 2.0}


def _fake_problem(*a, **k):
    return (np.zeros((8, 3), np.float32), np.zeros(8, np.float32), np.zeros(8, np.float32))


def _line(capsys):
    return json.loads([ln for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith("{")][-1])


def test_final_line_has_the_jax_keys(env, capsys):
    # the JAX bench with its children answering
    env.setattr(jbench, "build_problem", _fake_problem)
    env.setattr(jbench, "baseline_cpu", lambda *a, **k: (1.0, {"matvec_s": 0.1}))
    jstep = {k: v for k, v in STEP.items() if not k.startswith(("launches", "iter_s_samples_h",
                                                                "device", "kernels", "timed"))}
    answers = {"step": dict(jstep, xla_cache_entries=3), "matvec": MATVEC, "solve": SOLVE}
    env.setattr(jbench, "run_child", lambda mode, budget, extra_env=None: answers[mode])
    env.setenv("SGVAMP_BENCH_SIZE", "large")
    jbench.main()
    want = _line(capsys)
    # the port's, with the same answers
    env.setattr(tbench, "build_problem", _fake_problem)
    env.setattr(tbench, "baseline_cpu", lambda *a, **k: (1.0, {"matvec_s": 0.1}))
    answers = {"step": STEP, "matvec": MATVEC, "solve": SOLVE}
    env.setattr(tbench, "run_child", lambda mode, budget, extra_env=None: answers[mode])
    assert tbench.main() == 0
    got = _line(capsys)
    assert set(got) == (set(want) - DROPPED) | ADDED
    same = ("metric", "value", "iter_ms_median", "iter_ms_min", "iter_ms_samples",
            "markers_per_sec", "ld_passes_per_iter", "bytes_per_pass", "effective_GBps",
            "cg_GFLOPs_per_chip", "matvec_GBps", "hbm_read_ceiling_GBps",
            "roofline_frac_vs_ceiling", "state_finite", "align_vs_x0", "align_stop_vs_x0",
            "stop_it", "stop_reason", "step_timed", "solve_rtol1e5", "M", "block_size")
    assert {k: got[k] for k in same} == {k: want[k] for k in same}
    assert got["matvec_ms"] == pytest.approx(want["matvec_ms"])
    assert got["iter_ms_median_host"] == 70.0 and got["device_ms_per_step"] == 39.5
    assert got["errors"] == {} and got["kernels_built"] is True
    assert got["launches"]["step"]["launches_fused"] == {"sym_band_matvec_int8": 1224}
    # the card's own spec: none on the CPU
    assert want["hbm_spec_GBps"] == 819.0
    assert got["hbm_spec_GBps"] == -1.0 and got["roofline_frac_vs_spec"] == -1.0


@pytest.mark.parametrize("failing", ["step", "matvec", "solve"])
def test_a_failing_child_is_named_and_main_exits_nonzero(env, capsys, failing):
    """No cached or estimated number stands in: the child's numbers read -1,
    the line names it, and main returns 1 after printing the line."""
    env.setattr(tbench, "build_problem", _fake_problem)
    env.setattr(tbench, "baseline_cpu", lambda *a, **k: (1.0, {"matvec_s": 0.1}))
    answers = {"step": STEP, "matvec": MATVEC, "solve": SOLVE,
               failing: {"error": f"{failing} child died"}}
    env.setattr(tbench, "run_child", lambda mode, budget, extra_env=None: answers[mode])
    assert tbench.main() == 1
    got = _line(capsys)
    assert got["errors"] == {failing: f"{failing} child died"}
    assert not (got["matvec_cached"] or got["step_cached"] or got["solve_cached"])
    assert got["fresh_cert"] is None
    if failing == "step":
        assert got["step_timed"] is False and got["value"] == -1.0
        assert got["iter_ms_median"] == -1.0 and got["iter_ms_samples"] == []
        # bench.py would estimate iter/s from the matvec here: the port does not
        assert got["state_finite"] is False
    elif failing == "matvec":
        assert got["matvec_ms"] == -1.0 and got["bytes_per_pass"] == -1
        assert got["hbm_read_ceiling_GBps"] == -1.0 and got["effective_GBps"] == -1.0
        assert got["value"] > 0
    else:
        assert got["solve_rtol1e5"] is None and got["value"] > 0


def test_default_platform_is_the_card(env):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default platform runs")
    env.delenv("SGVAMP_BENCH_PLATFORM")
    with pytest.raises(RuntimeError, match="--platform cpu"):
        tbench.main()
    with pytest.raises(RuntimeError, match="--platform cpu"):
        tbench._device()
    env.setenv("SGVAMP_BENCH_PLATFORM", "tpu")
    with pytest.raises(SystemExit, match="SGVAMP_BENCH_PLATFORM=tpu"):
        tbench.main()


def _without_jax(tmp_path) -> dict:
    """An environment in which `import jax` fails (and with it the JAX
    package), the small size on the CPU, the cache under tmp_path."""
    block = tmp_path / "block"
    (block / "jax").mkdir(parents=True)
    (block / "jax" / "__init__.py").write_text("raise ImportError('jax is blocked here')\n")
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    # one thread a process: the matvec child's n and 2n chains are timed by
    # the host clock, where threads descheduled by other processes could
    # make the shorter chain the slower one
    env.update(PYTHONPATH=str(block), SGVAMP_BENCH_SIZE="small", SGVAMP_BENCH_PLATFORM="cpu",
               SGVAMP_BENCH_MV_REPS="8", SGVAMP_BENCH_CACHE_DIR=str(tmp_path / "cache"),
               OMP_NUM_THREADS="1")
    return env


def test_module_entry_point_runs_without_jax(tmp_path):
    env = _without_jax(tmp_path)
    proc = subprocess.run([sys.executable, "-c", "import jax"], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0 and "jax is blocked here" in proc.stderr
    proc = subprocess.run([sys.executable, "-m", "sgvamp_torch.bench"], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    assert line["errors"] == {} and line["step_timed"] and line["state_finite"]
    assert line["metric"] == "vamp_iters_per_sec_M16k" and line["value"] > 0
    assert len(line["iter_ms_samples"]) == len(line["iter_ms_samples_host"]) == 4
    assert line["align_stop_vs_x0"] > 0.95 and line["matvec_ms"] > 0
    assert line["hbm_read_ceiling_GBps"] == -1.0 and line["hbm_spec_GBps"] == -1.0
    assert line["bytes_per_pass"] == 64 * 2 * 256 * 256 + 64 * 2 * 4
    solve = line["solve_rtol1e5"]
    assert solve["precond_converged"] and solve["precond_iters"] < solve["plain_iters"]
    assert os.path.exists(os.path.join(tmp_path, "cache", "problem_M16384_bw128_s0.npz"))
    assert os.path.exists(os.path.join(tmp_path, "cache", "problem_hard_M16384_bw128.npz"))
    # a child that fails for real: every child refuses the storage
    env["SGVAMP_BENCH_LD_DTYPE"] = "int3"
    proc = subprocess.run([sys.executable, "-m", "sgvamp_torch.bench"], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr[-2000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    assert set(line["errors"]) == {"step", "matvec", "solve"}
    assert line["value"] == -1.0 and line["matvec_ms"] == -1.0 and line["solve_rtol1e5"] is None
