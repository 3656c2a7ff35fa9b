"""sgvamp_torch: the gVAMP engine of sgvamp_tpu, ported to PyTorch and CUDA.

The JAX package sgvamp_tpu is the reference; this package keeps its
module names and public signatures. It imports torch, numpy, scipy and the
standard library, never jax. The symmetric banded LD matvec runs
hand-written CUDA kernels (csrc/) on the GPU, one per storage type, and
their plain PyTorch versions on the CPU; the device-memory read probe is
a Triton kernel (ops/membench.py). The command line is cli/main.py.

Entry points run on the GPU unless the caller asks for the CPU: a
`device=None` argument resolves through default_device().
"""

import torch


def default_device() -> torch.device:
    """The device an entry point uses when the caller names none: CUDA.
    Raises without a CUDA device; there is no silent step down to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "sgvamp_torch runs on a CUDA device by default and none is "
            "available; pass device=\"cpu\" (--platform cpu on the command "
            "line) to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, or default_device() for None."""
    return default_device() if device is None else torch.device(device)


from sgvamp_torch.config import PriorConfig, VampConfig
from sgvamp_torch.core.cg import cg_batched
from sgvamp_torch.core.denoiser import combine_cohorts, posterior_mean_and_slope
from sgvamp_torch.core.operators import BandedLD, BlockSparseLD, DenseLD
from sgvamp_torch.core.prior import PriorState, em_loop, em_update, mle_update
from sgvamp_torch.core.vamp import (StopMonitor, VampEngine, VampInputs,
                                    VampState, vamp_step)
from sgvamp_torch.ops.band_kernel import SymBandedLD

__all__ = [
    "default_device",
    "resolve_device",
    "PriorConfig",
    "VampConfig",
    "cg_batched",
    "combine_cohorts",
    "posterior_mean_and_slope",
    "BandedLD",
    "BlockSparseLD",
    "DenseLD",
    "SymBandedLD",
    "PriorState",
    "em_update",
    "em_loop",
    "mle_update",
    "StopMonitor",
    "VampEngine",
    "VampInputs",
    "VampState",
    "vamp_step",
]
