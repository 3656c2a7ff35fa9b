"""The port's int8 SymBandedLD against the JAX package's, on the CPU.

Packing must be bit-identical; the port's plain matvec must match the JAX
Pallas kernel (interpret mode) on the same packed arrays. Both sum exact
bf16*int8 products in f32, in different orders, so the matvecs agree to
a scaled 1e-5, the tolerance of tests/test_pallas_kernel.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sgvamp_torch.data.simulate import band_to_dense as band_to_dense_port
from sgvamp_torch.data.simulate import simulate_ld_band as simulate_port
from sgvamp_torch.interop import operator_from_numpy
from sgvamp_torch.ops.band_kernel import (SymBandedLD, sym_band_matvec_int8,
                                          sym_band_matvec_int8_ref)
from sgvamp_tpu.data.simulate import band_to_dense, simulate_ld_band
from sgvamp_tpu.ops.band_kernel import SymBandedLD as JaxSymBandedLD

SCALED_TOL = 1e-5


def _band(M, bw, seed, dtype=np.float32):
    return simulate_ld_band(10000, M, bw, rng=np.random.default_rng(seed),
                            dtype=dtype)[0]


def test_simulator_copy_matches():
    for dtype in (np.float32, np.float64):
        a = simulate_ld_band(5000, 300, 40, h2=0.6, lam=0.05, n_r=2,
                             rng=np.random.default_rng(4), dtype=dtype)
        b = simulate_port(5000, 300, 40, h2=0.6, lam=0.05, n_r=2,
                          rng=np.random.default_rng(4), dtype=dtype)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(band_to_dense(a[0]), band_to_dense_port(b[0]))


@pytest.mark.parametrize("B,bw,M,K", [(128, 200, 700, 1), (64, 100, 300, 2),
                                      (32, 70, 250, 1), (32, 16, 96, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_from_band_bit_identical(B, bw, M, K, dtype):
    band = _band(M, bw, seed=B + M, dtype=dtype)
    want = JaxSymBandedLD.from_band(band, block_size=B, K=K, dtype="int8")
    got = SymBandedLD.from_band(band, block_size=B, K=K, dtype="int8", device="cpu")
    assert got.upper.dtype == torch.int8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.upper.numpy(), np.asarray(want.upper))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert got.bytes_per_pass() == want.bytes_per_pass()
    assert (got.nb, got.hb, got.B, got.M) == (want.nb, want.hb, want.B, want.M)


@pytest.mark.parametrize("B,bw,M,K", [(64, 100, 300, 1), (64, 100, 300, 2),
                                      (32, 70, 250, 2)])
def test_matvec_matches_jax_and_dense(B, bw, M, K):
    band = _band(M, bw, seed=7 + K)
    jop = JaxSymBandedLD.from_band(band, block_size=B, K=K, dtype="int8", s=0.1)
    op = operator_from_numpy(np.asarray(jop.upper), np.asarray(jop.scales), s=0.1,
                             device="cpu")
    assert op.hb >= 2 and M % B  # ragged M, two off-diagonal block bands
    x = np.random.default_rng(1).normal(size=(2 * K, op.M)).astype(np.float32)
    y = op.matvec(torch.from_numpy(x)).numpy().astype(np.float64)
    y_jax = np.asarray(jop.matvec(jnp.asarray(x)), np.float64)
    scale = np.abs(y_jax).max()
    np.testing.assert_allclose(y / scale, y_jax / scale, rtol=0, atol=SCALED_TOL)
    # both against the dequantized dense matrix times bf16-rounded x, with
    # the regularization applied to the unrounded x
    Rq = op.to_dense().numpy().astype(np.float64)   # (K, M, M), includes s*I
    np.testing.assert_array_equal(Rq, np.asarray(jop.to_dense(), np.float64))
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy().reshape(2, K, op.M)
    x64 = x.astype(np.float64).reshape(2, K, op.M)
    want = (np.einsum("kij,skj->ski", Rq, xb) + 0.1 * (x64 - xb)).reshape(2 * K, op.M)
    np.testing.assert_allclose(y / scale, want / scale, rtol=0, atol=SCALED_TOL)
    np.testing.assert_allclose(y_jax / scale, want / scale, rtol=0, atol=SCALED_TOL)


def test_cpu_wrapper_takes_the_plain_version():
    band = _band(300, 100, seed=3)
    op = SymBandedLD.from_band(band, block_size=64, dtype="int8", device="cpu")
    x = torch.randn(1, 2, op.M, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    before = sym_band_matvec_int8.launches
    y = sym_band_matvec_int8(op.upper, op.scales, x)
    assert sym_band_matvec_int8.launches == before  # no kernel on the CPU
    assert torch.equal(y, sym_band_matvec_int8_ref(op.upper, op.scales, x))
    with pytest.raises(ValueError, match="bfloat16"):
        sym_band_matvec_int8(op.upper, op.scales, x.float())


def test_unported_flavors_raise():
    band = _band(300, 100, seed=3)
    # the sharded matvec is ported: a mesh is pinned by shard_inputs, with the
    # operator's pieces, and never alone
    op = SymBandedLD.from_band(band, block_size=64, dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="shard_inputs"):
        dataclasses.replace(op, mesh=object())
    # the slab layout is ported for float blocks and refused for quantized ones
    assert SymBandedLD.from_band(band, block_size=64, device="cpu", layout="slab").layout == "slab"
    with pytest.raises(ValueError, match="diag layout only"):
        SymBandedLD.from_band(band, block_size=64, dtype="int8", device="cpu", layout="slab")
