"""The device trace of a --trace 1 run: torch.profiler over the first fits of
the window, reduced to the device's busy time, the traced window's length,
and the breakdown (the device operations that took most time, and the
longest idle gaps by what the host was doing).

The traced window is a host range of its own ("benchmark.traced"), padded
by 20 ms of idle card at both ends inside the profiler's window: kernel
stamps reach the trace's clock with an offset, and the profiler drops
events stamped outside its window. Busy time is the union of the intervals
of every device operation (kernels, copies, fills) clipped to the range.
The events are read from the profiler's raw results, without building its
tree of function events, which is slow over tens of thousands of launches.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch

_PAD_S = 0.02
_RANGE = "benchmark.traced"
TOP = 10


class Recorder:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.range = None
        self.events = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._sync()
        time.sleep(_PAD_S)
        self.range = record_function(_RANGE)
        self.range.__enter__()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stop(self) -> None:
        if self.prof is None or self.events is not None:
            return
        self._sync()
        self.range.__exit__(None, None, None)
        time.sleep(_PAD_S)
        self.prof.stop()
        self.events = self.prof.profiler.kineto_results.events()

    def summary(self, steps: int, fits: int, ld_passes: int) -> Optional[Dict[str, Any]]:
        """busy_s, window_s, breakdown, the device operations clipped to the
        range (ops: start ns, end ns, name), and the steps, fits and LD
        passes traced; None where the trace holds no device operation."""
        host, dev, lo, hi = [], [], None, None
        for e in self.events:
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.device_type() != torch.autograd.DeviceType.CPU and e.is_user_annotation():
                continue   # a host range mirrored on the device's timeline
            if e.device_type() == torch.autograd.DeviceType.CPU:
                if e.name() == _RANGE:
                    lo, hi = start, end
                else:
                    host.append((start, end, e.name()))
            else:
                dev.append((start, end, e.name()))
        if lo is None or not dev:
            return None
        dev = [(max(s, lo), min(t, hi), n) for s, t, n in dev if t > lo and s < hi]
        if not dev:
            return None
        busy, gaps = _union(dev, lo, hi)
        by_name: Dict[str, int] = {}
        for s, t, n in dev:
            by_name[n] = by_name.get(n, 0) + (t - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        return {
            "busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9, "steps": steps, "fits": fits,
            "ld_passes": ld_passes, "ops": dev,
            "breakdown": {
                "device_ops": [[n, ns / 1e9] for n, ns in ops],
                "idle_gaps": [[_host_at(host, (s + t) // 2), (t - s) / 1e9] for s, t in gaps],
            },
        }


def _union(intervals: List[Tuple[int, int, str]], lo: int, hi: int):
    """(ns covered by the intervals, the gaps between them within [lo, hi])."""
    busy, gaps, edge = 0, [], lo
    for s, t, _ in sorted(intervals):
        if s > edge:
            gaps.append((edge, s))
        if t > edge:
            busy += t - max(s, edge)
            edge = t
    if hi > edge:
        gaps.append((edge, hi))
    return busy, gaps


def _host_at(host: List[Tuple[int, int, str]], ns: int) -> str:
    """The innermost host event running at time ns (the shortest that spans
    it), or "host idle"."""
    best = None
    for s, t, n in host:
        if s <= ns <= t and (best is None or t - s < best[0]):
            best = (t - s, n)
    return best[1] if best else "host idle"
