"""sgvamp_torch: the gVAMP engine of sgvamp_tpu, ported to PyTorch and CUDA.

The JAX package sgvamp_tpu is the reference; this package keeps its
module names and public signatures. It imports torch, numpy and the
standard library, never jax. The int8 symmetric banded LD matvec runs a
hand-written CUDA kernel (csrc/sym_band_int8.cu) on the GPU and its plain
PyTorch version on the CPU; the device-memory read probe is a Triton
kernel (ops/membench.py).
"""

from sgvamp_torch.config import PriorConfig, VampConfig
from sgvamp_torch.core.cg import cg_batched
from sgvamp_torch.core.denoiser import combine_cohorts, posterior_mean_and_slope
from sgvamp_torch.core.operators import DenseLD
from sgvamp_torch.core.prior import PriorState, em_loop, em_update
from sgvamp_torch.core.vamp import (StopMonitor, VampEngine, VampInputs,
                                    VampState, vamp_step)
from sgvamp_torch.ops.band_kernel import SymBandedLD

__all__ = [
    "PriorConfig",
    "VampConfig",
    "cg_batched",
    "combine_cohorts",
    "posterior_mean_and_slope",
    "DenseLD",
    "SymBandedLD",
    "PriorState",
    "em_update",
    "em_loop",
    "StopMonitor",
    "VampEngine",
    "VampInputs",
    "VampState",
    "vamp_step",
]
