"""The loop "fits": a closed loop of one client, a user's pipeline
that waits for each result, running back-to-back fits of a fixed number of
fused steps, each from the initial state (VampEngine.run_scan).

A traffic mix names its loop (`"loop": "fits"`, this file); the harness
finds benchmark/loops/<loop>.py by that name, so a mix that needs another
loop brings a file of its own. The mix's file gives this loop's
parameters:

  steps_per_fit      VAMP steps a fit runs
  engine             the solver's settings (VampConfig fields), with the
                     configuration's own
  probe_sets         fits cycle through this many sets of probes, made from
                     the seed (panel.probes) and handed to the program
  warmup_fits        fits run in set-up, before the window
  trace_fits         fits the profiler records in a --trace 1 run

A fit's answer is the iterate a truth-free stop monitor keeps
(reference.best_step: the step at the peak of min_k gam1), picked on the
card from the fit's stacked outputs; the fit ends with one host read of
it. The window starts fits until --seconds have passed and ends with the
last one's read, so it holds whole fits only.

What is compared (compare), once the window has closed and the program is
freed:
  repeat_mismatch  the window's fits whose answer or gam1 trajectory is not
                   bit for bit that of the window's first fit over the same
                   probe set (a fit is a function of its inputs: state
                   leaking between fits, a reused buffer or a replay that
                   drifts shows here);
  xhat1_gap        over probe sets drawn from the seed (the configuration's
                   check_fits), the widest relative L2 gap between the
                   window's last fit's answer and the float64 reference's
                   kept iterate over the same inputs;
  gam1_gap         over the same fits, the widest relative gap between the
                   program's gam1 and the reference's, per cohort, over the
                   first check_gam1_steps steps.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from benchmark import panel
from benchmark import trace as tracing
from benchmark.reference.vamp import best_step


@dataclasses.dataclass
class Fit:
    probe_set: int
    estimate: np.ndarray       # the kept iterate's xhat1, on the host
    gam1: torch.Tensor         # (steps, K) gam1 of every step, on the device
    steps: int
    seconds: float             # host clock, start to the estimate's read
    cg_passes: Optional[torch.Tensor]   # (steps,) CG iterations a step, on the device


@dataclasses.dataclass
class Window:
    fits: List[Fit]
    seconds: float
    trace: Optional[Dict[str, Any]]

    def release(self) -> None:
        """Moves what the fits hold on the card to the host."""
        for f in self.fits:
            f.gam1 = f.gam1.cpu()
            f.cg_passes = None


def make_inputs(conf: Dict[str, Any], traffic: Dict[str, Any], seed: int,
                device) -> Dict[str, Any]:
    """The run's inputs from the seed: the band (on the host, as the port's
    ingestion takes it), the traits (on the device) and the probe sets (on
    the host, as run_scan takes them)."""
    M, K = conf["M"], conf["K"]
    p = panel.make_panel(M, conf["bandwidth"], conf["N"], conf["h2"], conf["lam"], K,
                         conf["strength"], conf["decay"], seed, device)
    u = panel.probes(traffic["probe_sets"], traffic["steps_per_fit"], K, M, seed, device)
    return {"band": p.band.cpu().numpy(), "r": p.r, "probes": u.cpu().numpy()}


def one_fit(sut, traffic: Dict[str, Any], inputs: Dict[str, Any], j: int) -> Fit:
    """One fit over probe set j, from the initial state, ended by the host
    read of its estimate."""
    t = time.perf_counter()
    _, aux = sut.engine.run_scan(traffic["steps_per_fit"], state=sut.engine.init_state(),
                                 fixed_u=inputs["probes"][j])
    estimate = aux.xhat1[best_step(aux.gam1, aux.xhat1)].cpu().numpy()
    return Fit(probe_set=j, estimate=estimate, gam1=aux.gam1, steps=traffic["steps_per_fit"],
               seconds=time.perf_counter() - t, cg_passes=aux.cg_passes)


def warm_up(sut, traffic: Dict[str, Any], inputs: Dict[str, Any]) -> None:
    """The set-up's fits: the first loads the kernel libraries (built by nvcc
    in a checkout's first run) and captures the step's CUDA graphs; its
    seconds are the span capture_s."""
    for i in range(traffic["warmup_fits"]):
        f = one_fit(sut, traffic, inputs, i % traffic["probe_sets"])
        if i == 0:
            sut.spans["capture_s"] = f.seconds


def _ld_passes(fits: List[Fit]) -> int:
    # an LD pass for each CG iteration, for CG's first residual and for the
    # gamw update of every step
    passes = [f.cg_passes for f in fits if f.cg_passes is not None]
    cg = int(torch.cat(passes).sum()) if passes else 0
    return cg + 2 * sum(f.steps for f in fits)


def window(sut, traffic: Dict[str, Any], inputs: Dict[str, Any], seconds: float,
           trace: bool) -> Window:
    """Fits back to back until `seconds` have passed; with trace, the
    profiler records the first trace_fits of them."""
    fits: List[Fit] = []
    rec = tracing.Recorder(sut.device) if trace else None
    if rec is not None:
        rec.start()
    t0 = time.perf_counter()
    while True:
        fits.append(one_fit(sut, traffic, inputs, len(fits) % traffic["probe_sets"]))
        if rec is not None and len(fits) == traffic["trace_fits"]:
            rec.stop()
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    summary = None
    if rec is not None:
        rec.stop()
        traced = fits[:traffic["trace_fits"]]
        summary = rec.summary(steps=sum(f.steps for f in traced), fits=len(traced),
                              ld_passes=_ld_passes(traced))
    return Window(fits=fits, seconds=elapsed, trace=summary)


def counters(win: Window) -> Dict[str, float]:
    """Counts over the window's fits, read from the program's StepAux."""
    return {"fits": len(win.fits), "steps": sum(f.steps for f in win.fits),
            "ld_passes": _ld_passes(win.fits)}


def _picks(conf: Dict[str, Any], sets, seed: int) -> list:
    """The probe sets whose fits are compared, drawn from the seed."""
    order = sorted(sets)
    random.Random(seed).shuffle(order)
    return order[:conf["check_fits"]]


def _reference_fit(conf, traffic, ref, op, inputs, j: int, device, dtype):
    """The reference's fit over probe set j, computed in dtype: its kept
    iterate (ref.best_step) and its gam1 of every step (steps, K)."""
    K = conf["K"]
    eng = dict(conf["engine"], **traffic["engine"])
    sets = ref.Settings(
        rho=eng["rho"], em_maxit=eng["em_prior_maxit"], em_tol=eng["em_rel_tol"],
        cg_maxit=eng["cg_maxit"], cg_force=eng["cg_force_maxiter"], cg_rtol=eng["cg_rtol"])
    f64 = dict(dtype=torch.float64, device=device)
    xs, gs = [], []

    def keep(it, xhat1, gam1, gamw, lam):
        xs.append(xhat1)
        gs.append(gam1)

    ref.fit(op, inputs["r"].to(device), torch.full((K,), 1.0 / K, **f64),
            torch.full((K,), float(conf["N"]), **f64), conf["prior_lam"],
            torch.tensor(conf["prior_omegas"], **f64),
            torch.tensor(panel.slab_variances(conf), **f64), conf["gamw0"], conf["gam10"],
            torch.from_numpy(inputs["probes"][j]).to(device), sets, dtype, each=keep)
    xs, gs = torch.stack(xs), torch.stack(gs)
    return xs[ref.best_step(gs, xs)], gs


def _gaps(conf, traffic, ref, op, inputs, answers, device) -> Dict[str, float]:
    """xhat1_gap and gam1_gap over answers {probe set: (estimate, gam1)}, and
    gam1's widest gap at each step (gam1_gap_by_step, for calibration)."""
    xgap, by_step = 0.0, None
    T = conf["check_gam1_steps"]
    for j, (est, gam1) in answers.items():
        kept, gs = _reference_fit(conf, traffic, ref, op, inputs, j, device, torch.float64)
        est = torch.as_tensor(est).to(device, torch.float64)
        g = float(torch.linalg.norm(est - kept) / torch.linalg.norm(kept))
        # an answer that is not finite has no gap: it fails every limit
        xgap = max(xgap, g if math.isfinite(g) else math.inf)
        gam1 = torch.as_tensor(gam1).to(device, torch.float64)
        rel = ((gam1 - gs).abs() / gs.abs()).amax(dim=1)
        rel = torch.where(torch.isfinite(rel), rel, torch.full_like(rel, math.inf))
        by_step = rel if by_step is None else torch.maximum(by_step, rel)
    steps = by_step.tolist()
    return {"xhat1_gap": xgap, "gam1_gap": max(steps[:T]), "gam1_gap_by_step": steps}


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """a and b hold the same bits (a NaN equals the same NaN)."""
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def compare(conf, traffic, ref, ref_op, inputs, win: Window, seed: int, device):
    """The numbers compared (see the module's docstring) and what the
    reference's operator counts: (numbers, {"blocks_with_data": ...})."""
    first, last = {}, {}
    # for calibration: of each fit that differs from its set's first, the
    # first step whose gam1 differs (its step count where only the answer
    # differs)
    differ = []
    for f in win.fits:
        a = first.setdefault(f.probe_set, f)
        last[f.probe_set] = f
        if f is a:
            continue
        steps = [s for s in range(f.steps)
                 if not _same_bits(f.gam1[s].numpy(), a.gam1[s].numpy())]
        if steps or not _same_bits(f.estimate, a.estimate):
            differ.append(steps[0] if steps else f.steps)
    op = ref_op.operator(torch.from_numpy(inputs["band"]).to(device), conf, torch.float64)
    answers = {j: (last[j].estimate, last[j].gam1) for j in _picks(conf, last, seed)}
    numbers = _gaps(conf, traffic, ref, op, inputs, answers, device)
    numbers["repeat_mismatch"] = len(differ)
    numbers["repeat_first_step"] = differ
    return numbers, {"blocks_with_data": getattr(op, "blocks_with_data", None)}


def control(conf, traffic, ref, ref_op, build, inputs, seed: int, device,
            kind: str) -> Dict[str, float]:
    """A control's numbers over the inputs and the probe sets a run would
    compare. kind "reference-bfloat16": the reference computed in bfloat16,
    the precision below the configuration's float32, put in the program's
    place; any other kind is a storage of the program's operator, switched
    on in its place (int4: the storage below int8)."""
    js = _picks(conf, range(traffic["probe_sets"]), seed)
    if kind == "reference-bfloat16":
        op = ref_op.operator(torch.from_numpy(inputs["band"]).to(device), conf, torch.bfloat16)
        answers = {}
        for j in js:
            kept, gs = _reference_fit(conf, traffic, ref, op, inputs, j, device, torch.bfloat16)
            answers[j] = (kept.float().cpu(), gs.float().cpu())
        del op
    else:
        operator = dict(conf["operator"], args=dict(conf["operator"]["args"], dtype=kind))
        sut = build(dict(conf, operator=operator), traffic, inputs, device)
        answers = {}
        for j in js:
            f = one_fit(sut, traffic, inputs, j)
            answers[j] = (f.estimate, f.gam1.cpu())
        del sut
    op = ref_op.operator(torch.from_numpy(inputs["band"]).to(device), conf, torch.float64)
    return _gaps(conf, traffic, ref, op, inputs, answers, device)
