"""The port's read probe against the JAX package's, on the CPU.

read_max_ref must pick the same elements and give the same (8, 128) max
as the JAX Pallas probe in interpret mode: a max is exact, so they must
be equal. The Triton kernel itself runs only on the card
(tests/test_torch_gpu.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sgvamp_torch.ops.membench import measure_read_gbps, read_max, read_max_ref
from sgvamp_tpu.ops.membench import read_max as jax_read_max


@pytest.mark.parametrize("n", [3 << 20, (1 << 20) + 5000, 3000])
def test_read_max_ref_matches_jax_f32(n):
    u = np.random.default_rng(n).normal(size=n).astype(np.float32)
    u[n // 3] = 1e6
    want = np.asarray(jax_read_max(jnp.asarray(u), interpret=True))
    got = read_max_ref(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)


def test_read_max_ref_matches_jax_bf16():
    u = np.random.default_rng(1).normal(size=(1 << 20) + 3000).astype(np.float32)
    want = np.asarray(jax_read_max(jnp.asarray(u).astype(jnp.bfloat16),
                                   interpret=True)).astype(np.float32)
    got = read_max_ref(torch.from_numpy(u).to(torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_int8_is_read_as_its_own_bytes():
    u = torch.from_numpy(np.random.default_rng(2).integers(
        -127, 128, size=(1 << 20) + 7).astype(np.int8))
    got = read_max_ref(u)
    assert got.dtype == torch.int32 and got.shape == (8, 128)
    flat = u[: (1 << 20)].view(torch.int32)  # whole 4 MB chunk of int32 words
    assert torch.equal(got, flat.reshape(-1, 1024).amax(0).reshape(8, 128))


def test_cpu_read_max_is_the_plain_version_and_measuring_needs_a_card():
    u = torch.randn(1 << 16)
    assert torch.equal(read_max(u), read_max_ref(u))
    with pytest.raises(ValueError, match="device cpu"):
        measure_read_gbps(u, n=2, reps=1)
