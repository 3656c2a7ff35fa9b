"""The program's own spans (sgvamp_torch.utils.profiling), read for the
per-layer metrics of a --trace 1 run.

While the profiler records, the port keeps a record of each span it enters
(name, start and end on the profiler's host clock, blocking or not, and for
a piece of the step the interval between CUDA events recorded before its
first replay and after its last, placed on the same clock). A reader keeps
the records that overlap the trace's range, from the first device operation
of readings["trace"]["ops"] to the end of its last, so that an earlier
traced run in the same process is left out; a span that begins on the host
before the first device operation it causes (a fit's, a step's) still
counts.
Each function returns None where the run has no trace or the program keeps
no such span: an untraced run, the CPU, or a port without the tracer.
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, List, Optional

from benchmark.trace import _union


def spans(r: Dict[str, Any]) -> Optional[List[Dict[str, Any]]]:
    """The program's span records that overlap the trace's range."""
    t = r.get("trace")
    if t is None or not t.get("ops") or not t.get("steps"):
        return None
    try:
        from sgvamp_torch.utils.profiling import snapshot
    except ImportError:
        return None
    lo = min(s for s, _, _ in t["ops"])
    hi = max(e for _, e, _ in t["ops"])
    got = [s for s in snapshot()["spans"] if s["end_ns"] >= lo and s["start_ns"] <= hi]
    return got or None


def piece_ms(r: Dict[str, Any], name: str) -> Optional[float]:
    """Device-busy ms a traced step of the piece `name`: the union of the
    trace's device operations inside each of its spans' device intervals.
    (The interval alone would also hold the idle card before the piece's
    first graph launch and at the host reads between its chunks.)"""
    got = [s for s in spans(r) or () if s["name"] == name and s.get("device_end_ns")]
    if not got:
        return None
    ops = sorted(r["trace"]["ops"])
    starts = [a for a, _, _ in ops]
    longest = max(b - a for a, b, _ in ops)
    busy = 0
    for s in got:
        lo, hi = s["device_start_ns"], s["device_end_ns"]
        # the operations that can reach into [lo, hi] start after lo - longest
        near = ops[bisect.bisect_left(starts, lo - longest):bisect.bisect_right(starts, hi)]
        inside = [(max(a, lo), min(b, hi), n) for a, b, n in near if b > lo and a < hi]
        busy += _union(inside, lo, hi)[0] if inside else 0
    return busy / 1e6 / r["trace"]["steps"]


def _merged(intervals) -> List[List[int]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(merged: List[List[int]], starts: List[int], x: int) -> bool:
    i = bisect.bisect_right(starts, x) - 1
    return i >= 0 and x <= merged[i][1]


def idle_split(r: Dict[str, Any]) -> Optional[Dict[str, int]]:
    """The trace's idle ns between its first and last device operation, by
    where each gap began: inside a blocking program span ("blocking"),
    inside another program span ("program"), or outside every program
    span ("outside")."""
    got = spans(r)
    if got is None:
        return None
    ops = r["trace"]["ops"]
    _, gaps = _union(ops, min(s for s, _, _ in ops), max(e for _, e, _ in ops))
    blocking = _merged((s["start_ns"], s["end_ns"]) for s in got if s["blocking"])
    program = _merged((s["start_ns"], s["end_ns"]) for s in got)
    b0, p0 = [b[0] for b in blocking], [p[0] for p in program]
    split = {"blocking": 0, "program": 0, "outside": 0}
    for start, end in gaps:
        kind = ("blocking" if _inside(blocking, b0, start)
                else "program" if _inside(program, p0, start) else "outside")
        split[kind] += end - start
    return split
