"""The port's tracer: named spans and counters at the boundaries where the
work happens, and device_trace, a torch.profiler trace of a block (the JAX
package's jax.profiler trace) that TensorBoard's profiler plugin or
Perfetto (ui.perfetto.dev) opens.

A span (`with span("sgv.step", it=3): ...`) always adds its host seconds
and one call to its name's total, and does nothing else unless a torch
profiler is recording: one check of the profiler's flag, no
record_function, no event. While a profiler records (device_trace, or a
benchmark's traced run), a span also

- opens a record_function range of its name, so that the sgv.* ranges show
  in the trace over the launches they make;
- keeps a record: name, start and end (time.time_ns(), the profiler's host
  clock, taken inside the range), the enclosing recorded span, the fit it
  belongs to (each "sgv.fit" span starts a new fit id), whether the host
  waits on the device there (`blocking`) and its attributes;
- where the caller marks device work inside it (device_begin before the
  first launch, device_end after the last), records a CUDA event at each
  mark on the current stream.

anchor(device) records one more event where the host has just waited for
the stream to drain (after a read of a device value, a synchronise): it
fires at once, at a known time on the host's clock. snapshot() resolves the
marks after one synchronise, each against the first anchor after it: the
milliseconds between them and where they lie on the host's clock, the
clock of the profiler's trace. (An event recorded on an idle stream fires
when it is recorded, so the marks' interval holds the wait for a piece's
first launch; the device operations of the trace inside the interval are
the piece's work.)

count(name, n) adds to a counter whether or not a profiler records.
snapshot() returns the totals, the counters and the records; reset()
clears them. The state is one Tracer a process (TRACER), as the profiler
is one a process.
"""

from __future__ import annotations

import bisect
import contextlib
import logging
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

logger = logging.getLogger("sgvamp")

FIT = "sgv.fit"

_recording = torch._C._autograd._profiler_enabled


class Tracer:
    """The spans' totals ({name: [seconds, calls]}), the counters ({name:
    n}), and the records of the spans a profiler saw (see the module's
    docstring); `stack` holds the open recorded spans' indices, `fit` the
    id of the fit being run (None outside any), `fits` the ids handed
    out."""

    def __init__(self) -> None:
        self.totals: Dict[str, List[float]] = {}
        self.counts: Dict[str, int] = {}
        self.records: List[list] = []
        self.pending: List[list] = []   # records whose device marks are unresolved
        self.anchors: List[tuple] = []  # (event, host ns) of anchor()
        self.stack: List[int] = []
        self.fit: Optional[int] = None
        self.fits = 0


TRACER = Tracer()
_TOTALS = TRACER.totals
_clock = time.perf_counter

# a record's fields, in order: the last two are its CUDA events until
# snapshot() resolves them into _DEV, (device ms, start ns, end ns)
_NAME, _START, _END, _PARENT, _FIT, _BLOCKING, _ATTRS, _DEV, _EV0, _EV1 = range(10)


class span:
    """A named span (see the module's docstring). `blocking`: the host waits
    on the device inside it (a read of a device value, a synchronise, a copy
    from pageable memory). `device`: the device whose work device_begin and
    device_end mark (events are recorded on a CUDA device only). `attrs`
    go into the record; the caller may add to span.attrs before the span
    ends. span.seconds holds the host seconds once it has ended."""

    __slots__ = ("name", "blocking", "device", "attrs", "seconds", "_t0", "_rec", "_range",
                 "_outer_fit")

    def __init__(self, name: str, blocking: bool = False, device=None, **attrs) -> None:
        self.name = name
        self.blocking = blocking
        self.device = device
        self.attrs = attrs
        self._rec = None

    def __enter__(self) -> "span":
        if self.name == FIT:
            self._outer_fit = TRACER.fit
            TRACER.fits += 1
            TRACER.fit = TRACER.fits
        if _recording():
            self._open()
        self._t0 = _clock()
        return self

    def __exit__(self, typ, value, tb) -> None:
        self.seconds = s = _clock() - self._t0
        total = _TOTALS.get(self.name)
        if total is None:
            _TOTALS[self.name] = [s, 1]
        else:
            total[0] += s
            total[1] += 1
        if self._rec is not None:
            self._close()
        if self.name == FIT:
            TRACER.fit = self._outer_fit

    def _open(self) -> None:
        from torch.autograd.profiler import record_function

        self._range = record_function(self.name)
        self._range.__enter__()
        t = TRACER
        self._rec = [self.name, time.time_ns(), None, t.stack[-1] if t.stack else None, t.fit,
                     self.blocking, self.attrs, None, None, None]
        t.stack.append(len(t.records))
        t.records.append(self._rec)

    def _close(self) -> None:
        self._rec[_END] = time.time_ns()
        self._range.__exit__(None, None, None)
        if TRACER.stack:   # reset() may have cleared it while the span was open
            TRACER.stack.pop()

    def _event(self):
        if self._rec is None or self.device is None or self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def device_begin(self) -> None:
        """Mark the start of the span's device work (right before its first
        launch; later calls keep the first mark)."""
        if self._rec is not None and self._rec[_EV0] is None:
            self._rec[_EV0] = self._event()
            if self._rec[_EV0] is not None:
                TRACER.pending.append(self._rec)

    def device_end(self) -> None:
        """Mark the end of the span's device work so far (right after a
        launch; the last call's mark counts)."""
        if self._rec is not None:
            self._rec[_EV1] = self._event()


def anchor(device) -> None:
    """Place the device's stream on the host's clock here, where the host
    has just waited for it to drain (see the module's docstring); nothing
    unless a profiler records on a CUDA device."""
    if device.type == "cuda" and _recording():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        TRACER.anchors.append((ev, time.time_ns()))


def _resolve(t: Tracer) -> None:
    """The pending records' device marks as (ms between them, start ns, end
    ns on the host's clock), each through the first anchor taken after its
    span ended (a last one here, after the synchronise)."""
    torch.cuda.synchronize()
    last = torch.cuda.Event(enable_timing=True)
    last.record()
    t.anchors.append((last, time.time_ns()))
    last.synchronize()
    when = [a[1] for a in t.anchors]
    for r in t.pending:
        if r[_EV1] is not None:
            ev, ns = t.anchors[bisect.bisect_left(when, r[_END])]
            end = ns - r[_EV1].elapsed_time(ev) * 1e6
            ms = r[_EV0].elapsed_time(r[_EV1])
            r[_DEV] = (ms, round(end - ms * 1e6), round(end))
        r[_EV0] = r[_EV1] = None
    t.pending.clear()
    t.anchors.clear()


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    TRACER.counts[name] = TRACER.counts.get(name, 0) + n


def snapshot() -> Dict[str, Any]:
    """The tracer's record: "totals" {name: {"seconds", "calls"}} of every
    span, "counts" {name: n}, and "spans", one dict a recorded span (name,
    start_ns, end_ns, parent: the index of the enclosing recorded span or
    None, fit, blocking, attrs; device_ms, device_start_ns, device_end_ns:
    the milliseconds between its device marks and where they lie on the
    host's clock, None without both marks). Synchronises the device once
    where marks are still unresolved."""
    t = TRACER
    if t.pending:
        _resolve(t)
    none = (None, None, None)
    return {
        "totals": {k: {"seconds": v[0], "calls": v[1]} for k, v in t.totals.items()},
        "counts": dict(t.counts),
        "spans": [dict(zip(("device_ms", "device_start_ns", "device_end_ns"), r[_DEV] or none),
                       name=r[_NAME], start_ns=r[_START], end_ns=r[_END], parent=r[_PARENT],
                       fit=r[_FIT], blocking=r[_BLOCKING], attrs=dict(r[_ATTRS]))
                  for r in t.records],
    }


def reset() -> None:
    """Clear the totals, counters and records (the fit ids go on)."""
    t = TRACER
    t.totals.clear()
    t.counts.clear()
    t.records.clear()
    t.pending.clear()
    t.anchors.clear()
    t.stack.clear()


def report() -> str:
    """The spans' totals and the counters, one line each."""
    lines = [f"  {name}: {s:.3f}s over {n} calls" for name, (s, n) in sorted(TRACER.totals.items())]
    lines += [f"  {name}: {n}" for name, n in sorted(TRACER.counts.items())]
    return "spans and counters:\n" + "\n".join(lines) if lines else "spans and counters: (none)"


# torch.profiler leaves out kernel events stamped outside the trace's window
# on the host's clock, and the kernels' stamps reach that clock with an
# offset that moves from trace to trace: some are stamped before their own
# launch, and a traced run on an H100 lost its first LD pass that way. So on
# the card the window opens on an idle card this long before the block and
# closes this long after its last kernel; the card's test of --profile-dir
# prints the offset and holds it inside this pad.
TRACE_PAD_S = 0.02


@contextlib.contextmanager
def device_trace(out_dir: Optional[str], device=None) -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed block (no-op if
    out_dir is falsy): CPU and CUDA activity on a CUDA `device` (None: the
    default device, sgvamp_torch.default_device), CPU activity only on the
    CPU. Every process writes its own Chrome-trace JSON,
    {out_dir}/process{P}.{ns}.pt.trace.json with P its index in the process
    group (0 alone). The hand-written kernels show there as CUDA kernel
    events under their __global__ names, those replayed from a CUDA graph
    included, under the program's sgv.* spans."""
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from sgvamp_torch import resolve_device
    from sgvamp_torch.parallel import multihost

    cuda = resolve_device(device).type == "cuda"
    prof = profile(
        activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []),
        on_trace_ready=tensorboard_trace_handler(
            out_dir, worker_name=f"process{multihost.process_index()}"))
    if cuda:
        torch.cuda.synchronize()   # kernels launched before the block stay out
    prof.start()
    if cuda:
        time.sleep(TRACE_PAD_S)
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()   # the block's last kernels land in the trace
            time.sleep(TRACE_PAD_S)
        prof.stop()
        logger.info(f"device trace written to {out_dir}")
