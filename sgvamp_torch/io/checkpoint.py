"""Checkpoint and resume of the VAMP state (the port of
sgvamp_tpu/io/checkpoint.py).

A VampState is saved field by field into a flat .npz: the host int `it`,
every tensor, the prior's fields, and the state of the CPU generator that
seeds each step's probe, so that a resumed run draws the probes the
uninterrupted run drew. Writes are atomic (a tmp file, then a rename), and
only the newest `keep` files are kept. A structure fingerprint (the port's
format tag, each field's name, dtype and shape) makes restoring into
another structure raise, as it does for a checkpoint the JAX package wrote.

Under several processes (parallel/multihost.py) the fields each process
holds for its own cohorts only are gathered whole on every process before a
save (a collective: every process calls save), and only process 0 writes.
A restore reads the same file on every process, each keeping its own
cohorts' rows. The file is the one a run of one process writes, so a run
over P processes resumes in a run over one, and the other way round.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import time
from typing import Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger("sgvamp")

FORMAT = "sgvamp_torch.VampState/1"
_GEN = "gen_state"


def _fields(state) -> dict:
    """The state's tensors by name (the prior's as prior.<name>), and the
    generator's state as a uint8 tensor when there is a generator."""
    out = {"it": torch.tensor(state.it, dtype=torch.int64)}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
    for f in dataclasses.fields(state.prior):
        out[f"prior.{f.name}"] = getattr(state.prior, f.name)
    if state.gen is not None:
        out[_GEN] = state.gen.get_state()
    return out


def _structure(fields: dict) -> str:
    return json.dumps({"format": FORMAT, "fields": [
        [name, str(t.dtype).replace("torch.", ""), list(t.shape)]
        for name, t in fields.items()]})


def _divided(state) -> bool:
    """Whether the state holds this process's cohorts only in its
    LOCAL_FIELDS (a run over several processes)."""
    return state.xhat2.shape[0] != state.r1.shape[0]


def _whole(state):
    """The state with every field whole: its LOCAL_FIELDS all-gathered from
    the processes when it is divided. Every process must call it."""
    from sgvamp_torch.core.vamp import LOCAL_FIELDS
    from sgvamp_torch.parallel.multihost import fetch_global

    if not _divided(state):
        return state
    return dataclasses.replace(state, **{f: fetch_global(getattr(state, f))
                                         for f in LOCAL_FIELDS})


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    # numpy has no bfloat16: its bits go as int16
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, it: int) -> str:
        return os.path.join(self.directory, f"vamp_state_{it:06d}.npz")

    def save(self, state, it: int) -> str:
        """Write `state` as the checkpoint of iteration `it` (the number of
        iterations it has run) and drop all but the newest `keep`. Under
        several processes every process calls it, process 0 writes, and it
        returns on every process once the file is written (a restore that
        follows then finds it on every process)."""
        import torch.distributed as dist

        from sgvamp_torch.parallel.multihost import process_index

        t0 = time.perf_counter()
        fields = _fields(_whole(state))
        path = self._path(it)
        if process_index() == 0:
            arrays = {name: _to_numpy(t) for name, t in fields.items()}
            arrays["__structure__"] = np.asarray(_structure(fields))
            tmp = path + ".tmp.npz"
            np.savez(tmp, **arrays)
            os.replace(tmp, path)
            self._gc()
            logger.debug(f"[checkpoint] {path}: {os.path.getsize(path)} bytes in "
                         f"{time.perf_counter() - t0:.4f} s")
        if dist.is_initialized():
            dist.barrier()
        return path

    def _existing(self):
        pat = re.compile(r"vamp_state_(\d+)\.npz$")
        out = []
        for name in os.listdir(self.directory):
            m = pat.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.directory, name)))
        return sorted(out)

    def _gc(self) -> None:
        existing = self._existing()
        for _, path in existing[: max(0, len(existing) - self.keep)]:
            os.remove(path)

    def restore_latest(self, template) -> Optional[Tuple[object, int]]:
        """Restore the newest checkpoint into the structure of `template`
        (a VampState, e.g. engine.init_state(seed)), onto the devices of its
        tensors; a template that holds its own cohorts only in its
        LOCAL_FIELDS gets its own rows of them. Returns (state, iteration),
        or None if there is none. Raises ValueError when the checkpoint
        holds another structure."""
        from sgvamp_torch.core.vamp import LOCAL_FIELDS
        from sgvamp_torch.parallel.multihost import own_cohorts

        existing = self._existing()
        if not existing:
            return None
        it, path = existing[-1]
        own = slice(None)
        whole = template
        if _divided(template):
            K, M = template.r1.shape
            own = own_cohorts(K)
            whole = dataclasses.replace(template, **{
                f: torch.empty((K, M), dtype=getattr(template, f).dtype, device="meta")
                for f in LOCAL_FIELDS})
        want = _fields(whole)
        with np.load(path) as data:
            if "__structure__" not in data.files:
                raise ValueError(
                    f"checkpoint {path} holds no {FORMAT} structure (written by another "
                    "program, such as the JAX package?) - refusing to restore it")
            saved = json.loads(str(data["__structure__"]))
            if saved["format"] != FORMAT:
                raise ValueError(f"checkpoint {path} has format {saved['format']!r}, "
                                 f"expected {FORMAT!r}")
            have = {name: (dtype, tuple(shape)) for name, dtype, shape in saved["fields"]}
            for name, t in want.items():
                dtype = str(t.dtype).replace("torch.", "")
                if name not in have or have[name][0] != dtype:
                    raise ValueError(
                        f"checkpoint {path} was written with a different state structure: "
                        f"field {name} is {have.get(name, ('missing',))[0]}, the current "
                        f"configuration expects {dtype}")
                if have[name][1] != tuple(t.shape):
                    raise ValueError(
                        f"checkpoint {path} field {name} has shape {have[name][1]} but the "
                        f"current configuration expects {tuple(t.shape)}")
            if set(have) != set(want):
                raise ValueError(f"checkpoint {path} holds fields {sorted(set(have) - set(want))} "
                                 "that the current configuration does not have")
            arrays = {name: torch.from_numpy(np.array(data[name])) for name in want}
        values = {}
        for name, t in _fields(template).items():
            v = arrays[name]
            if t.dtype == torch.bfloat16:
                v = v.view(torch.bfloat16)
            values[name] = (v[own] if name in LOCAL_FIELDS else v).to(t.device)
        gen = None
        if _GEN in values:
            gen = torch.Generator()
            gen.set_state(values.pop(_GEN))
        prior = dataclasses.replace(template.prior, **{
            f.name: values.pop(f"prior.{f.name}") for f in dataclasses.fields(template.prior)})
        state = dataclasses.replace(template, it=int(values.pop("it")), prior=prior, gen=gen,
                                    **values)
        return state, it
