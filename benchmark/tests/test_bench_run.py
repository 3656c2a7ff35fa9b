"""Whole runs of a tiny cell on the CPU (the harness's look for a card
skipped): the result line, the modules a run holds, the command's refusals,
and correct coming out false under each fault the cells can have."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_tiny
from benchmark import harness

ROOT = bench_tiny.ROOT
# the result line's keys in order: these five, with --trace 1 the
# breakdown where the trace holds device operations, and last the numbers
# compared, each beside its limit
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
LAST = "checks"


def keys_follow_the_rule(out):
    keys = list(out)
    if "breakdown" in keys:
        keys.remove("breakdown")
    return keys == KEYS + [LAST]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = bench_tiny.copy(str(tmp_path_factory.mktemp("bench")))
    return root, bench_tiny.add_tiny(root)


def run(tiny, seed=3, seconds=1.0, trace=False):
    root, name = tiny
    return harness.run_cell(name, seed, seconds, trace, device="cpu", root=root)


def test_the_result_line(tiny):
    out = run(tiny, seed=2 ** 31 + 5)
    assert keys_follow_the_rule(out) and "breakdown" not in out
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"iter_ms", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert set(out["checks"]) == {"xhat1_gap", "gam1_gap", "repeat_mismatch"}
    assert all(v["value"] <= v["limit"] for v in out["checks"].values())
    json.dumps(out, allow_nan=False)


def test_the_traced_result_line(tiny):
    out = run(tiny, seed=4, trace=True)
    # on the CPU the trace holds no device operation: no breakdown, and the
    # device's readers find nothing to read
    assert keys_follow_the_rule(out) and "breakdown" not in out
    assert set(out["metrics"]) == {"pack_s", "capture_s"}
    assert out["correct"] is True


def _stuck(orig):
    # every step returns the state it was given: each row is the first step's
    def run_scan(self, iterations, state=None, seed=0, fixed_u=None):
        _, aux = orig(self, 1, state=state, seed=seed, fixed_u=fixed_u[:1])
        return state, aux._replace(**{f: v.expand(iterations, *v.shape[1:]).clone()
                                      for f, v in aux._asdict().items()})
    return run_scan


def _altered(orig):
    # each step's estimate altered where the step produces it: its largest
    # entry doubled
    def run_scan(self, iterations, state=None, seed=0, fixed_u=None):
        state, aux = orig(self, iterations, state=state, seed=seed, fixed_u=fixed_u)
        x = aux.xhat1.clone()
        rows = torch.arange(x.shape[0])
        i = torch.argmax(x.abs(), dim=1)
        x[rows, i] = 2 * x[rows, i]
        return state, aux._replace(xhat1=x)
    return run_scan


def _half(orig):
    def combine_cohorts(r1s, gam1s, a):
        b, A, c = orig(r1s, gam1s, a)
        k = r1s.shape[0] // 2
        b2, A2, _ = orig(r1s[:k], gam1s[:k], a[:k] * (a.sum() / a[:k].sum()))
        return b2, A2, c
    return combine_cohorts


def _drifting(orig):
    # state leaking from fit to fit: each call's estimate and gam1 moved by
    # a millionth more than the last's, far inside xhat1_gap's limit
    calls = [0]

    def run_scan(self, iterations, state=None, seed=0, fixed_u=None):
        state, aux = orig(self, iterations, state=state, seed=seed, fixed_u=fixed_u)
        calls[0] += 1
        f = 1.0 + 1e-6 * calls[0]
        return state, aux._replace(xhat1=aux.xhat1 * f, gam1=aux.gam1 * f)
    return run_scan


class _Ticks:
    """A clock that moves one second a reading: the loop's fit reads it
    twice, its window once a fit and once at its start."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_cohorts", "answer_altered",
                                   "drifts_over_the_window"])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, fault):
    from sgvamp_torch.core import vamp

    if fault == "state_unchanged":
        monkeypatch.setattr(vamp.VampEngine, "run_scan", _stuck(vamp.VampEngine.run_scan))
    elif fault == "answer_altered":
        monkeypatch.setattr(vamp.VampEngine, "run_scan", _altered(vamp.VampEngine.run_scan))
    elif fault == "drifts_over_the_window":
        monkeypatch.setattr(vamp.VampEngine, "run_scan", _drifting(vamp.VampEngine.run_scan))
        # a window of four fits whatever the host's pace: the fourth repeats
        # the first's probe set
        root, name = tiny
        monkeypatch.setattr(harness.parts(harness.cell(name, root))[0], "time", _Ticks())
    else:
        monkeypatch.setattr(vamp, "combine_cohorts", _half(vamp.combine_cohorts))
    out = run(tiny, seed=6, seconds=12.0 if fault == "drifts_over_the_window" else 1.0)
    if fault == "drifts_over_the_window":
        assert out["attempted"] == 4 and out["checks"]["repeat_mismatch"]["value"] == 1
    assert out["correct"] is False
    assert any(v["value"] is None or v["value"] > v["limit"] for v in out["checks"].values())


@pytest.mark.parametrize("kind", ["int4", "reference-bfloat16"])
def test_the_controls_fail_a_limit(tiny, kind):
    root, name = tiny
    numbers = harness.control(name, 8, "cpu", kind, root=root)
    limits = harness.cell(name, root)["limits"]
    assert any(numbers[k] > limits[k] for k in limits if k in numbers)


def test_a_run_holds_no_jax(tiny):
    root, name = tiny
    code = ("import sys; from benchmark import harness; "
            f"harness.run_cell({name!r}, 9, 0.5, False, device='cpu', root={root!r}); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'sgvamp_tpu'}))")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    if harness.forbidden_modules():
        pytest.skip("this test process holds one of the names already")
    for near in ("sgvamp_tpu_like", "jaxlibs", "flaxen", "sgvamp_torch_x"):
        monkeypatch.setitem(sys.modules, near, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "hm3half-k1-int8.fixed-cg", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "hm3half-k1-int8.fixed-cg", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_estimates_are_deterministic_for_a_probe_set(tiny):
    root, name = tiny
    c = harness.cell(name, root)
    ctx = harness.set_up(c, 10, torch.device("cpu"), 0.0)
    loop = harness.parts(c)[0]
    a = loop.one_fit(ctx["system"], c["traffic"], ctx["inputs"], 1)
    b = loop.one_fit(ctx["system"], c["traffic"], ctx["inputs"], 1)
    assert np.array_equal(a.estimate, b.estimate) and torch.equal(a.gam1, b.gam1)
