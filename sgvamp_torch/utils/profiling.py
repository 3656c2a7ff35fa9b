"""Profiling and phase-timing utilities (sgvamp_tpu/utils/profiling.py):
structured phase timers, and device_trace, a torch.profiler trace of a
block (the JAX package's jax.profiler trace) that TensorBoard's profiler
plugin or Perfetto (ui.perfetto.dev) opens.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Iterator, Optional

logger = logging.getLogger("sgvamp")


class PhaseTimers:
    """Accumulating named wall-clock timers."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._open: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def start(self, name: str) -> None:
        """Explicit begin/end API for phases that span linear command-line code
        where a `with` block would force awkward nesting."""
        self._open[name] = time.perf_counter()

    def stop(self, name: str) -> None:
        t0 = self._open.pop(name, None)
        if t0 is None:
            return
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        logger.debug(f"[timer] {name}: {dt:.4f}s")

    def report(self) -> str:
        lines = [
            f"  {name}: {self.totals[name]:.3f}s over {self.counts[name]} calls"
            for name in sorted(self.totals)
        ]
        return "phase timers:\n" + "\n".join(lines) if lines else "phase timers: (none)"


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
    included."""
    if not out_dir:
        yield
        return
    import torch
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
