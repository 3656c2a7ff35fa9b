"""Phase timing (the PhaseTimers of sgvamp_tpu/utils/profiling.py; a device
trace through torch.profiler is not ported yet, ROADMAP A15)."""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Iterator

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
