"""One run of one cell: set-up, the measured window, the per-layer readings,
the check against the plain reference, and the result line.

Everything a cell is made of is found by name, so that a cell, a
configuration, a traffic mix, a loop or a per-layer metric is added as
files and entries, without an edit here:

  BENCHMARK.json                    the cells (workloads), configurations
                                    and metrics
  benchmark/configs/<config>.json   a configuration (its `file` in
                                    BENCHMARK.json): sizes, the operator's
                                    constructor and arguments, the engine's
                                    settings, the prior; and by path the
                                    files that build the program (`system`),
                                    the reference's fit (`reference`) and
                                    the reference's operator
                                    (`reference_operator`)
  benchmark/traffic/<traffic>.json  a traffic mix: its parameters, and by
                                    name the loop that reads them (`loop`)
  benchmark/loops/<loop>.py         a loop over the window: make_inputs,
                                    warm_up, window, counters, compare (the
                                    numbers the check compares), control
  benchmark/limits/<workload>.json  each compared number's limit
  benchmark/metrics/<metric>.py     a metric's reader: read(readings)
                                    returns its value, or None where the run
                                    has nothing for it to read (end-to-end
                                    metrics read the window and set-up by
                                    the host's clock, per-layer ones the
                                    spans, counters and the device trace)

The program under test is the port, sgvamp_torch (system.py); the
reference is benchmark/reference/ and imports nothing of it.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# modules a run may not hold, by their top-level names
FORBIDDEN = ("jax", "jaxlib", "flax", "sgvamp_tpu")


class Refused(Exception):
    """A run that prints no result: the exit code and the reason."""

    def __init__(self, code: int, reason: str):
        super().__init__(reason)
        self.code = code


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def spec(root: str = ROOT) -> Dict[str, Any]:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> Dict[str, Any]:
    """The workload `name` with its configuration, traffic, limits and
    metrics, each read from its own file."""
    s = spec(root)
    work = {w["name"]: w for w in s["workloads"]}
    if name not in work:
        raise Refused(2, f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in s["configs"]}[w["config"]]
    here = os.path.join(root, "benchmark")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return {
        "workload": w,
        "config": load_json(os.path.join(root, conf["file"])),
        "traffic": load_json(os.path.join(here, "traffic", w["traffic"] + ".json")),
        "limits": load_json(os.path.join(here, "limits", name + ".json")),
        "end_to_end": [m for m in s["end_to_end"] if mine(m)],
        "per_layer": [m for m in s["per_layer"] if mine(m)],
        "root": root,
    }


def _module(path: str):
    """The module at path, loaded once a process (by its absolute path)."""
    name = "benchmark_file_" + os.path.abspath(path).replace(os.sep, "_").replace(".", "_")
    if name not in sys.modules:
        mod_spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(mod_spec)
        # registered before it runs: dataclasses look their module up
        sys.modules[name] = mod
        try:
            mod_spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]


def reader(metric: str, root: str = ROOT):
    """benchmark/metrics/<metric>.py's read function."""
    return _module(os.path.join(root, "benchmark", "metrics", metric + ".py")).read


def parts(c: Dict[str, Any]):
    """The cell's modules, found by the names its files give: (loop,
    system, reference, reference_operator)."""
    conf, root = c["config"], c["root"]
    loop = _module(os.path.join(root, "benchmark", "loops", c["traffic"]["loop"] + ".py"))
    return (loop, _module(os.path.join(root, conf["system"])),
            _module(os.path.join(root, conf["reference"])),
            _module(os.path.join(root, conf["reference_operator"])))


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def set_up(c: Dict[str, Any], seed: int, device, t0: float) -> Dict[str, Any]:
    """The cell's inputs from the seed, the program's system over them, and
    its warm-up. Returns the run's context; its "setup_s" runs from t0.
    The device's peak memory is counted from the program's ingestion on."""
    loop, system, _, _ = parts(c)
    t = time.perf_counter()
    start_s = t - t0
    inputs = loop.make_inputs(c["config"], c["traffic"], seed, device)
    inputs_s = time.perf_counter() - t
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    sut = system.build(c["config"], c["traffic"], inputs, device)
    sut.spans.update(start_s=start_s, inputs_s=inputs_s)
    loop.warm_up(sut, c["traffic"], inputs)
    _sync(device)
    return {"inputs": inputs, "system": sut, "setup_s": time.perf_counter() - t0}


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def control(name: str, seed: int, device, kind: str, root: str = ROOT) -> Dict[str, float]:
    """A control's numbers over the seed's inputs (the loop's control):
    kind "reference-bfloat16", the reference computed in bfloat16 in the
    program's place, or a storage of the program's operator (int4)."""
    c = cell(name, root)
    device = torch.device(device)
    loop, system, ref, ref_op = parts(c)
    inputs = loop.make_inputs(c["config"], c["traffic"], seed, device)
    numbers = loop.control(c["config"], c["traffic"], ref, ref_op, system.build, inputs,
                             seed, device, kind)
    _free(device)
    return numbers


def device_block(device, chips: int) -> Dict[str, Any]:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             t0: Optional[float] = None, root: str = ROOT,
             seen: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One run of the cell: the result line's object (see README.md).
    seen, where given, receives every number the loop compared, those
    without a limit too (calibrate.py)."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device("cuda") if device is None else torch.device(device)
    c = cell(name, root)
    loop, _, ref, ref_op = parts(c)
    ctx = set_up(c, seed, device, t0)
    sut = ctx["system"]
    win = loop.window(sut, c["traffic"], ctx["inputs"], seconds, trace)
    dev = device_block(device, c["workload"]["chips"])
    found = forbidden_modules()
    if found:
        raise Refused(3, f"the run holds modules it may not: {', '.join(found)}")
    failed = sum(1 for f in win.fits if not np.all(np.isfinite(f.estimate)))
    readings = {"setup_s": ctx["setup_s"], "window_s": win.seconds,
                "fit_s": [f.seconds for f in win.fits], "spans": dict(sut.spans),
                "counters": loop.counters(win), "trace": win.trace, "device": dev["kind"],
                "config": c["config"]}
    print("set-up spans (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in dict(sut.spans, setup_s=ctx["setup_s"]).items()),
        file=sys.stderr)
    if trace and win.trace is not None:
        dev["busy_s"], dev["window_s"] = win.trace["busy_s"], win.trace["window_s"]
    # the program's state goes before the reference runs
    ctx["system"] = sut = None
    win.release()
    _free(device)
    numbers, extra = loop.compare(c["config"], c["traffic"], ref, ref_op, ctx["inputs"], win,
                                    seed, device)
    readings.update(extra)
    if seen is not None:
        seen.update(numbers)
    metrics = {}
    for m in (c["per_layer"] if trace else c["end_to_end"]):
        value = reader(m["name"], root)(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = c["limits"]
    correct = (failed == 0 and len(win.fits) > 0
               and all(numbers[k] <= limits[k] for k in limits))
    out = {"correct": correct, "attempted": len(win.fits), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and win.trace is not None:
        out["breakdown"] = win.trace["breakdown"]
    # the numbers compared, each beside its limit, last; JSON has no
    # infinity: a number that is not finite prints as null
    out["checks"] = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else None,
                         "limit": limits[k]} for k in limits}
    return out
