"""The system under test: the port, sgvamp_torch, built over the run's inputs
through its public API, as a user's pipeline builds it.

A configuration's file names the operator's constructor and its arguments
(for the int8 cells SymBandedLD.from_band: storage, layout, block size; the
host packer, then the copy to the card, one copy of the blocks per cohort),
the engine's settings and the prior; a traffic mix names the solver's
settings. A configuration names this file as its `system`; one that the
port builds another way brings a file of its own with the same build().
The spans it records are set-up's by the host's clock.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, NamedTuple

import torch

from benchmark import panel


class System(NamedTuple):
    engine: Any
    op: Any
    device: torch.device
    spans: Dict[str, float]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(conf: Dict[str, Any], traffic: Dict[str, Any], inputs: Dict[str, Any],
          device) -> System:
    """The operator by the constructor the configuration names (a class of
    sgvamp_torch and its static method, called with the band, the block
    size B, K, the device and the configuration's arguments; then the
    fields it sets),
    and the engine with the configuration's and the traffic's settings."""
    import sgvamp_torch
    from sgvamp_torch import PriorState, VampConfig, VampEngine, VampInputs

    spans = {}
    K, M = conf["K"], conf["M"]
    spec = conf["operator"]
    cls, method = spec["build"].split(".")
    t = time.perf_counter()
    op = getattr(getattr(sgvamp_torch, cls), method)(
        inputs["band"], block_size=conf["B"], K=K, device=device, **spec["args"])
    op = dataclasses.replace(op, **spec.get("set", {}))
    _sync(device)
    spans["pack_s"] = time.perf_counter() - t
    if op.M != M:
        raise ValueError(f"the operator holds M={op.M}, the configuration {M}")
    cfg = VampConfig(**conf["engine"], **traffic["engine"])
    prior = PriorState.create(conf["prior_lam"], conf["prior_omegas"],
                              panel.slab_variances(conf), device=device)
    f32 = dict(dtype=torch.float32, device=device)
    vin = VampInputs(op=op, r=inputs["r"].to(**f32), a=torch.full((K,), 1.0 / K, **f32),
                     N=torch.full((K,), float(conf["N"]), **f32),
                     mask=torch.ones(M, **f32))
    engine = VampEngine(vin, cfg, prior, gamw=conf["gamw0"], gam1=conf["gam10"])
    return System(engine=engine, op=op, device=device, spans=spans)
