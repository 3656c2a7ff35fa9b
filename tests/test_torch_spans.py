"""The port's tracer (sgvamp_torch/utils/profiling.py) and the benchmark's
readers of it (benchmark/program_spans.py, benchmark/metrics/), on the CPU.

With no profiler recording, a span only adds to its name's totals. Under a
CPU torch.profiler the spans keep records on the profiler's clock, nested
by parent and fit; the fused step's pieces, reads and steps are recorded
once each where they happen. The six readers are held to a synthetic trace
and record.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from sgvamp_torch.config import VampConfig
from sgvamp_torch.core import vamp
from sgvamp_torch.core.prior import PriorState
from sgvamp_torch.data.simulate import simulate_ld_band
from sgvamp_torch.ops.band_kernel import SymBandedLD
from sgvamp_torch.utils import profiling

READERS = ("prior_ms", "pre_cg_ms", "cg_ms", "post_cg_ms", "sync_idle_ms", "syncs_per_step")
PIECES = ("sgv.piece.prior", "sgv.piece.pre_cg", "sgv.piece.cg", "sgv.piece.post_cg")


@pytest.fixture(autouse=True)
def clean_tracer():
    profiling.reset()
    yield
    profiling.reset()


def test_span_without_profiler_records_nothing(monkeypatch):
    """No profiler: no record_function, no CUDA event, no record; the totals
    and counters still count."""
    def refuse(*a, **k):
        raise AssertionError("called with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    for _ in range(3):
        with profiling.span("sgv.fit", steps=1):
            with profiling.span("sgv.piece.cg", device=torch.device("cuda")) as sp:
                sp.device_begin()
                sp.device_end()
            with profiling.span("sgv.read", blocking=True, kind="em"):
                profiling.count("reads.em")
    snap = profiling.snapshot()
    assert snap["spans"] == [] and profiling.TRACER.stack == []
    assert {k: v["calls"] for k, v in snap["totals"].items()} == {
        "sgv.fit": 3, "sgv.piece.cg": 3, "sgv.read": 3}
    assert snap["counts"] == {"reads.em": 3} and sp.seconds > 0
    assert profiling.TRACER.fit is None


def _host_events(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CPU]


def test_spans_nest_on_the_profilers_clock():
    """Under a CPU profiler: each record's parent and fit id, and each record
    inside the profiler's record_function event of the same name."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with profiling.span("sgv.fit", steps=2):
                for it in range(2):
                    with profiling.span("sgv.step", it=it):
                        with profiling.span("sgv.read", blocking=True, kind="em"):
                            torch.ones(4).sum()
        with profiling.span("sgv.sync", blocking=True):
            pass
    spans = profiling.snapshot()["spans"]
    assert [s["name"] for s in spans] == (
        ["sgv.fit"] + ["sgv.step", "sgv.read"] * 2) * 2 + ["sgv.sync"]
    fits = [i for i, s in enumerate(spans) if s["name"] == "sgv.fit"]
    for i, s in enumerate(spans):
        if s["name"] in ("sgv.fit", "sgv.sync"):
            want = None
        elif s["name"] == "sgv.read":
            want = i - 1
        else:
            want = max(f for f in fits if f < i)
        assert s["parent"] == want, (i, s)
        assert s["fit"] == (None if s["name"] == "sgv.sync"
                            else spans[fits[0] if i < fits[1] else fits[1]]["fit"])
        assert s["blocking"] == (s["name"] in ("sgv.read", "sgv.sync"))
        assert s["start_ns"] <= s["end_ns"] and s["device_ms"] is None
    assert spans[fits[1]]["fit"] == spans[fits[0]]["fit"] + 1
    events = _host_events(prof)
    for name in ("sgv.fit", "sgv.step", "sgv.read", "sgv.sync"):
        evs = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in events if e.name() == name)
        recs = [(s["start_ns"], s["end_ns"]) for s in spans if s["name"] == name]
        assert len(evs) == len(recs), name
        for (e0, e1), (r0, r1) in zip(evs, recs):
            assert e0 <= r0 <= r1 <= e1, (name, e0, r0, r1, e1)


def _engine(force: bool, upf: int = 0):
    """int8 SymBandedLD over a ragged M on the CPU (f32), EM from step upf."""
    M, n = 250, 200
    band, r, _ = simulate_ld_band(n, M, 100, h2=0.6, lam=0.05, rng=np.random.default_rng(4),
                                  dtype=np.float64)
    op = SymBandedLD.from_band(band, block_size=64, dtype="int8", s=0.02, device="cpu")
    Mp = op.M
    rp = np.zeros((1, Mp), np.float32)
    rp[0, :M] = r
    cfg = VampConfig(prior_update="em", dtype="float32", cg_maxit=20 if force else 300,
                     cg_force_maxiter=force, cg_precond_block=0 if force else 32,
                     em_prior_maxit=5, rho=0.5, update_prior_from=upf)
    inputs = vamp.VampInputs(op=op, r=torch.from_numpy(rp), a=torch.ones(1),
                             N=torch.full((1,), float(n)),
                             mask=torch.from_numpy((np.arange(Mp) < M).astype(np.float32)))
    prior = PriorState.create(0.05, [1.0], [0.6 / 12 * n], device="cpu")
    return vamp.VampEngine(inputs, cfg, prior)


def _trace_of(spans, steps):
    """A trace whose one device operation spans the records' whole range."""
    return {"trace": {"ops": [(min(s["start_ns"] for s in spans),
                               max(s["end_ns"] for s in spans), "k")], "steps": steps}}


@pytest.mark.parametrize("force", [True, False], ids=["forced", "early-stop"])
def test_fused_run_records_each_piece_once_a_step(force):
    """A fused run_scan under a CPU profiler: one sgv.fit, a sgv.step a step,
    each piece once a step inside it, the reads the step counts as blocking
    spans (syncs_per_step's count), no capture on the CPU; the ingestion's
    spans and the counters."""
    engine = _engine(force)
    steps = 3
    engine.run_scan(1, seed=2)    # the step's pieces made once
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        engine.run_scan(steps, seed=2)
    snap = profiling.snapshot()
    spans = snap["spans"]
    names = [s["name"] for s in spans]
    assert names.count("sgv.fit") == 1 and names.count("sgv.step") == steps
    assert "sgv.capture" not in names and "sgv.sync" not in names
    fit = names.index("sgv.fit")
    step_ids = [i for i, n in enumerate(names) if n == "sgv.step"]
    assert all(spans[i]["parent"] == fit for i in step_ids)
    for piece in PIECES:
        parents = [s["parent"] for s in spans if s["name"] == piece]
        assert parents == step_ids, piece
    assert [s["attrs"]["it"] for s in spans if s["name"] == "sgv.step"] == list(range(steps))
    assert all(s["fit"] == spans[fit]["fit"] for s in spans)
    F = engine.fused
    reads = [s for s in spans if s["name"] == "sgv.read"]
    assert [s["blocking"] for s in spans if s["blocking"]] == [True] * len(reads)
    assert len(reads) == sum(F.reads.values()) > 0
    for kind in ("em", "cg"):
        assert sum(s["attrs"]["kind"] == kind for s in reads) == F.reads[kind]
        assert snap["counts"].get(f"reads.{kind}", 0) == F.reads[kind]
    syncs = harness.reader("syncs_per_step")(_trace_of(spans, steps))
    assert syncs * steps == sum(F.reads.values())
    want = {}
    for (_, piece), n in F.replays.items():
        want[f"replays.{piece}"] = want.get(f"replays.{piece}", 0) + n
    assert {k: v for k, v in snap["counts"].items() if k.startswith("replays.")} == want
    chunks = sum(s["attrs"]["chunks"] for s in spans if s["name"] == "sgv.piece.cg")
    assert chunks == want["replays.cg" if force else "replays.cg_chunk"]
    # on the CPU no piece has device time: the piece readers find nothing
    for name in ("prior_ms", "pre_cg_ms", "cg_ms", "post_cg_ms"):
        assert harness.reader(name)(_trace_of(spans, steps)) is None


def test_host_loop_and_ingestion_spans():
    """run(): a sgv.step a step holding the aux read, the LD passes counted;
    from_band: the pack and copy spans with their attributes."""
    with profile(activities=[ProfilerActivity.CPU]):
        engine = _engine(True, upf=1)
        engine.run(2, seed=2)
    snap = profiling.snapshot()
    spans = snap["spans"]
    by = {}
    for s in spans:
        by.setdefault(s["name"], []).append(s)
    pack, copy = by["sgv.ingest.pack"][0], by["sgv.ingest.copy"][0]
    assert pack["attrs"] == {"storage": "int8"} and not copy["blocking"]
    assert copy["attrs"]["storage"] == "int8" and copy["attrs"]["bytes"] > 0
    assert len(by["sgv.fit"]) == 1 and len(by["sgv.step"]) == 2
    aux = [s for s in by["sgv.read"] if s["attrs"]["kind"] == "aux"]
    assert [spans[s["parent"]]["name"] for s in aux] == ["sgv.step"] * 2
    # EM from step 1 only: one read of its flag a chunk, in step 1
    assert {s["attrs"]["kind"] for s in by["sgv.read"]} == {"aux", "em"}
    assert snap["counts"]["ld_passes"] == 2 * (20 + 2)


# a synthetic trace: device operations at 100-200, 300-400, 500-600 and
# 700-800 ns, so gaps begin at 200, 400 and 600
OPS = [(100, 200, "k"), (300, 400, "k"), (500, 600, "k"), (700, 800, "k")]


def _span(name, start, end, blocking=False, device=None):
    """A record as snapshot() gives it; device: its device interval (ns)."""
    lo, hi = device or (None, None)
    return {"name": name, "start_ns": start, "end_ns": end, "parent": None, "fit": 1,
            "blocking": blocking, "attrs": {}, "device_start_ns": lo, "device_end_ns": hi,
            "device_ms": None if device is None else (hi - lo) / 1e6}


SYNTHETIC = [
    _span("sgv.read", 10, 50, blocking=True),              # before the trace: left out
    _span("sgv.piece.cg", 20, 60, device=(0, 1000)),        # before the trace: left out
    _span("sgv.step", 90, 450),                              # the gap at 400 begins here
    _span("sgv.piece.prior", 95, 105, device=(90, 210)),     # busy 100
    _span("sgv.read", 190, 260, blocking=True),              # the gap at 200 begins here
    _span("sgv.piece.pre_cg", 240, 250, device=(250, 350)),  # busy 50
    _span("sgv.piece.cg", 260, 300, device=(350, 620)),      # busy 50 + 100
    _span("sgv.piece.post_cg", 460, 470, device=(690, 800)),  # busy 100; no span at 600
    _span("sgv.read", 900, 950, blocking=True),              # after the trace: left out
]


def test_readers_over_a_synthetic_trace(monkeypatch):
    monkeypatch.setattr(profiling, "snapshot",
                        lambda: {"totals": {}, "counts": {}, "spans": SYNTHETIC})
    r = {"trace": {"ops": OPS, "steps": 2}}
    got = {name: harness.reader(name)(r) for name in READERS}
    ms = {"prior_ms": 100, "pre_cg_ms": 50, "cg_ms": 150, "post_cg_ms": 100,
          "sync_idle_ms": 100}
    assert got == {**{k: pytest.approx(ns / 1e6 / 2) for k, ns in ms.items()},
                   "syncs_per_step": 0.5}
    from benchmark import program_spans

    assert program_spans.idle_split(r) == {"blocking": 100, "program": 100, "outside": 100}
    # without a trace, without steps, without spans in the trace's range
    for empty in ({"trace": None}, {"trace": {"ops": [], "steps": 2}},
                  {"trace": {"ops": [(2000, 3000, "k")], "steps": 2}}):
        assert {name: harness.reader(name)(empty) for name in READERS} == dict.fromkeys(READERS)


def test_readers_without_the_tracer(monkeypatch):
    """A port without snapshot() (the benchmark's parent side): no value."""
    monkeypatch.delattr(profiling, "snapshot")
    r = {"trace": {"ops": OPS, "steps": 2}}
    assert {name: harness.reader(name)(r) for name in READERS} == dict.fromkeys(READERS)
