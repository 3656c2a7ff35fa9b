"""Runs over several processes through torch.distributed (PyTorch port of
sgvamp_tpu/parallel/multihost.py).

The reference runs one MPI rank per cohort. Here, as in the JAX package,
one process runs per host (or per card), the mesh's cohort axis runs
across the processes and its shard axis stays inside each process's own
devices. So the traffic of every CG iteration stays inside a process: a
process holds the LD operator, the CG lanes and the LMMSE fields of its own
cohorts only, and the one exchange across processes is the per-iteration
combine of (gam1, r1) that the prior update and the denoiser read
(core/vamp.py), plus the scalars the logs and writers read, in the same
collective.

Runs of one process need none of this: multihost_init does nothing when no
group is configured (group_config).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import Tensor

from sgvamp_torch.parallel.sharding import Mesh

logger = logging.getLogger("sgvamp")

# collectives issued by this module since the last reset (tests count them
# to hold the exchange to once a VAMP step)
COLLECTIVES = {"all_gather": 0}


_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def group_config(coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None) -> Optional[Tuple[str, int, int]]:
    """(address, size, rank) of the process group to join, or None for a
    run of one process without one.

    Each value is the argument (the flags --coordinator-address,
    --num-processes and --process-id), else the variable torchrun sets:
    MASTER_ADDR with MASTER_PORT (the coordinator's host:port), WORLD_SIZE
    and RANK - the counterparts of the JAX package's JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES and JAX_PROCESS_ID. The variables count only all four
    together, as torchrun sets them: a part of them is not a launch, and is
    ignored with a warning. The JAX package's detection of a Cloud TPU pod
    has no counterpart. Raises ValueError, naming the flag, for values that
    define no group: a size or a rank without an address, an address
    without a size, or a group of several without a rank."""
    env = {v: os.environ.get(v) for v in _TORCHRUN}
    if all(env.values()):
        if coordinator_address is None:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        if num_processes is None:
            num_processes = int(env["WORLD_SIZE"])
        if process_id is None:
            process_id = int(env["RANK"])
    elif any(env.values()) and coordinator_address is None:
        logger.warning(f"{', '.join(v for v in _TORCHRUN if env[v])} set without "
                       f"{', '.join(v for v in _TORCHRUN if not env[v])}: not a torchrun "
                       f"launch, so a run of one process")
    need = "a run over several processes through torch.distributed"
    if coordinator_address is None:
        for flag, val in (("--num-processes", num_processes), ("--process-id", process_id)):
            if val is not None:
                raise ValueError(f"{flag} needs --coordinator-address: {need}")
        return None
    if num_processes is None:
        raise ValueError(f"--coordinator-address needs --num-processes: {need}")
    if process_id is None:
        if int(num_processes) > 1:
            raise ValueError(f"--coordinator-address with {num_processes} processes needs "
                             f"--process-id: {need}")
        process_id = 0
    return coordinator_address, int(num_processes), int(process_id)


def multihost_init(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None,
                   timeout_s: float = 600.0) -> bool:
    """Join the torch.distributed process group that group_config finds
    in the arguments or torchrun's variables; returns True for a run over
    several processes (or a group of one), False, doing nothing, without
    a configuration.

    backend None: "nccl" when CUDA is available, else "gloo" (the CPU's, as
    the JAX package picks gloo for CPU collectives); pass "gloo" for a run
    on the CPU of a machine with cards. Under NCCL each process uses the
    cards it can see: several processes on one host are separated by
    CUDA_VISIBLE_DEVICES. A group this process has already joined is kept
    (it must have the same size and rank)."""
    group = group_config(coordinator_address, num_processes, process_id)
    if group is None:
        return False
    coordinator_address, num_processes, process_id = group
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes, process_id):
            raise ValueError(
                f"this process already is process {dist.get_rank()} of "
                f"{dist.get_world_size()}, not {process_id} of {num_processes}")
        return True
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info(f"torch.distributed initialized: process {process_id}/{num_processes} "
                f"over the {backend.upper()} backend")
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _wire_device(t: Tensor) -> torch.device:
    """The device a collective moves t through: a card under NCCL, the CPU
    under gloo."""
    if dist.get_backend() == "nccl":
        return t.device if t.device.type == "cuda" else torch.device(
            "cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather(t: Tensor) -> List[Tensor]:
    """Every process's t (the same shape and dtype on each), in rank order,
    on t's device. Every process must call it."""
    COLLECTIVES["all_gather"] += 1
    wire = _wire_device(t)
    src = t.contiguous().to(wire)
    out = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(out, src)
    return [o.to(t.device) for o in out]


def fetch_global(t: Tensor) -> Tensor:
    """A tensor divided over the processes by cohort (its leading axis),
    whole on every process, through all_gather. Every process must call
    it. Without a process group, t itself."""
    if not dist.is_initialized():
        return t
    return torch.cat(all_gather(t), dim=0)


def own_cohorts(K: int, processes: Optional[int] = None,
                rank: Optional[int] = None) -> slice:
    """The cohorts of this process's rows of a multihost mesh: the K
    cohorts divided rank-major over the processes (default: the group's)."""
    P = process_count() if processes is None else processes
    p = process_index() if rank is None else rank
    if K % P:
        raise ValueError(f"{K} cohorts not divisible over {P} processes")
    return slice(p * K // P, (p + 1) * K // P)


def make_multihost_mesh(n_cohort: Optional[int] = None,
                        devices: Optional[Sequence] = None) -> Mesh:
    """The global (cohort, shard) mesh with the cohort axis across the
    processes of the torch.distributed group (one process without one).

    devices: this process's own devices (default: its visible cards), the
    same count on every process; the mesh's n_cohort x n_shard cells are
    the processes' devices, process-major. n_cohort defaults to the
    process count, so each process's devices form one shard group and the
    sharded matvec's traffic stays inside the process. As in the JAX
    package, a device count that n_cohort does not divide is refused; so
    is a cohort axis that would put one row across two processes (its
    shard axis would cross processes in every LD pass). On the CPU, give
    each process ["cpu"] * n_shard: a device may stand in several cells,
    which the process then runs in turn."""
    if devices is None:
        from sgvamp_torch import default_device
        default_device()   # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    P, rank = process_count(), process_index()
    n_dev = P * len(devices)
    if n_cohort is None:
        n_cohort = P
    if n_dev % n_cohort:
        raise ValueError(f"{n_dev} devices not divisible into {n_cohort} cohorts")
    if n_cohort % P:
        raise ValueError(f"a cohort axis of {n_cohort} over {P} processes would put a "
                         f"mesh row across processes; use a multiple of {P}")
    n_shard = n_dev // n_cohort
    rows_each = n_cohort // P
    own = [devices[r * n_shard:(r + 1) * n_shard] for r in range(rows_each)]
    return Mesh(own * P, processes=P if dist.is_initialized() else None, rank=rank)
