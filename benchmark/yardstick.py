"""The benchmark's frozen yardstick: the card's published peaks, the bytes an
LD pass must move, and the names of the band kernels in a device trace.

Frozen copies, kept here so that a change to the program cannot move the
yardstick it is measured by:

  needed_bytes          from chip_smoke.py::bound_ms (the byte count
                        corrected there to the blocks that hold data)
  BAND_KERNELS          the kernel names of
                        sgvamp_torch/ops/band_kernel.py::TRACED_KERNELS
  HBM_SPEC_BYTES_PER_S  sgvamp_torch/bench.py::HBM_SPEC_GBPS

needed_bytes counts from the operator's shapes and the blocks that hold
data, not from the tensors the program allocates, so the same work is
counted whatever implements it.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

# device-memory rate of each card, bytes a second, from its data sheet, by
# torch.cuda.get_device_name
HBM_SPEC_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

# bytes a stored element and a lane element take, by the operator's storage:
# (block element, block scale per block, x lane element, y lane element).
# The int8 operator reads its lanes in bfloat16 and writes them in float32.
STORAGE_BYTES = {"int8": (1, 4, 2, 4)}

# the band kernels and their folds as the profiler names them (a kernel
# event's name is its demangled __global__ instantiation): an LD pass is
# the union of their intervals. A kernel that a later design names
# otherwise is not counted, and the metrics that read it fall silent.
BAND_KERNELS = re.compile(
    r"sym_band_int8_kernel\b|fold_(?:partials|tiles)_kernel\b|sym_band_float_kernel\b"
    r"|sym_band_resident_kernel\b|sym_slab_resident_kernel\b|sym_slab_streamed_kernel\b"
    r"|sym_band_packed_kernel<")


def needed_bytes(blocks: int, B: int, M: int, K: int, S: int, storage: str) -> Optional[int]:
    """Bytes a pass over K cohorts with S lanes each must move when `blocks`
    blocks a cohort hold data: those blocks and their scales, x read once,
    y written once; None for a storage the table lacks."""
    if storage not in STORAGE_BYTES:
        return None
    elem, scale, xb, yb = STORAGE_BYTES[storage]
    return K * blocks * (B * B * elem + scale) + K * S * M * (xb + yb)


def bound_s(blocks_with_data: Optional[int], B: int, M: int, K: int, S: int, storage: str,
            device_name: str) -> Optional[float]:
    """The least seconds the card could take for one pass over a panel of
    which blocks_with_data blocks a cohort hold data (a nonzero scale):
    needed_bytes over the card's published rate; None for a card or a
    storage the tables lack, or where the blocks were not counted. The int8
    pass is bound by bytes: its two operations a stored element and lane
    are far below the int8 peak."""
    rate = HBM_SPEC_BYTES_PER_S.get(device_name)
    if rate is None or blocks_with_data is None:
        return None
    need = needed_bytes(blocks_with_data, B, M, K, S, storage)
    return None if need is None else need / rate


def band_kernel_s(ops: List[Tuple[int, int, str]]) -> float:
    """Seconds in which a band kernel or its fold ran, the union of their
    intervals, over a trace's device operations (start ns, end ns, name)."""
    busy, edge = 0, None
    for s, t, _ in sorted(op for op in ops if BAND_KERNELS.search(op[2])):
        if edge is None or s > edge:
            busy += t - s
            edge = t
        elif t > edge:
            busy += t - edge
            edge = t
    return busy / 1e9


def ld_pass_s(trace) -> Optional[float]:
    """Seconds a traced LD pass took: band_kernel_s over the LD passes the
    traced fits ran; None where the trace has no pass or no band kernel."""
    if trace is None or not trace["ld_passes"]:
        return None
    s = band_kernel_s(trace["ops"])
    return s / trace["ld_passes"] if s else None
