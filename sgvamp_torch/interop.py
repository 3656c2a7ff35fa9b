"""Build the port's objects from numpy arrays.

The JAX package's values, handed over as numpy arrays (np.asarray of its
arrays), become the port's operator, inputs, prior and state, so that both
engines can start from the same packed blocks and the same iterate. This
module takes numpy only and never sees a JAX type.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from sgvamp_torch import resolve_device
from sgvamp_torch.core.operators import BandedLD
from sgvamp_torch.core.prior import PriorState
from sgvamp_torch.core.vamp import VampInputs, VampState
from sgvamp_torch.ops.band_kernel import SymBandedLD


def _t(v, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    # a copy: arrays handed over from JAX are read-only
    return torch.tensor(np.asarray(v), dtype=dtype, device=resolve_device(device))


def operator_from_numpy(upper: np.ndarray, scales: Optional[np.ndarray] = None,
                        s: float = 0.0, packed: bool = False,
                        hybrid: bool = False,
                        dtype: Optional[torch.dtype] = None,
                        device=None, layout: str = "diag", mode: str = "auto",
                        window: bool = False, rows_per_step: int = 0) -> SymBandedLD:
    """SymBandedLD from the JAX operator's fields as numpy arrays.

    int8, int4 (`packed`) and hybrid storage: `upper` int8 and its f32
    `scales`, unchanged. Float blocks, in diag or slab `layout`: `scales`
    None and `upper` a float32 or float64 array; bf16 blocks cross as
    float32 values (exact) with dtype=torch.bfloat16. `mode`, `window` and
    `rows_per_step` as the JAX operator has them. Tensors go to `device`
    (None: the default CUDA device)."""
    if scales is not None:
        dtype = torch.int8
    return SymBandedLD(
        upper=_t(upper, device, dtype).contiguous(),
        scales=None if scales is None else _t(scales, device, torch.float32).contiguous(),
        packed=packed, hybrid=hybrid, s=s, layout=layout, mode=mode, window=window,
        rows_per_step=rows_per_step)


def banded_from_numpy(blocks: np.ndarray, s: float = 0.0, accum_dtype: str = "",
                      dtype: Optional[torch.dtype] = None, device=None) -> BandedLD:
    """BandedLD from the JAX operator's (K, nb, 2*hb+1, B, B) blocks as a
    numpy array (bf16 blocks cross as float32 values with
    dtype=torch.bfloat16), its s and its accum_dtype."""
    return BandedLD(blocks=_t(blocks, device, dtype).contiguous(), s=s,
                    accum_dtype=accum_dtype)


def inputs_from_numpy(op, r: np.ndarray, a: np.ndarray, N: np.ndarray,
                      mask: Optional[np.ndarray] = None,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> VampInputs:
    """VampInputs with r, a, N (and mask) as `dtype` tensors on `device`."""
    return VampInputs(op=op, r=_t(r, device, dtype), a=_t(a, device, dtype),
                      N=_t(N, device, dtype),
                      mask=None if mask is None else _t(mask, device, dtype))


def prior_from_numpy(lam, omegas, sigmas, dtype: torch.dtype = torch.float64,
                     device=None,
                     mle_gam=1.0, mle_gam_valid=False,
                     mle_last_ok=True) -> PriorState:
    """PriorState from its fields' values."""
    return PriorState(
        lam=_t(lam, device, dtype), omegas=_t(omegas, device, dtype),
        sigmas=_t(sigmas, device, dtype), mle_gam=_t(mle_gam, device, dtype),
        mle_gam_valid=_t(mle_gam_valid, device, torch.bool),
        mle_last_ok=_t(mle_last_ok, device, torch.bool))


def state_from_numpy(arrays: Mapping[str, np.ndarray],
                     device=None,
                     seed: int = 0) -> VampState:
    """VampState from a dict of its fields as arrays: it, xhat1, alpha1, r1,
    gam1, xhat2, r2, alpha2, gam2, gamw, sigma2_u, and the prior's lam,
    omegas, sigmas. Tensors keep the arrays' dtypes. The probe generator
    is seeded from `seed`: the JAX PRNG key has no counterpart."""
    names = ("xhat1", "alpha1", "r1", "gam1", "xhat2", "r2", "alpha2",
             "gam2", "gamw", "sigma2_u")
    dtype = _t(arrays["xhat1"], "cpu").dtype
    device = resolve_device(device)
    return VampState(
        it=int(arrays["it"]),
        prior=prior_from_numpy(arrays["lam"], arrays["omegas"],
                               arrays["sigmas"], dtype=dtype, device=device),
        gen=torch.Generator().manual_seed(seed),
        **{n: _t(arrays[n], device) for n in names})
