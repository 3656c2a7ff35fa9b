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


@pytest.mark.parametrize("case", ["int8", "float32", "int8-s", "int8-mesh", "int8-lanes",
                                  "banded"])
def test_shifted_matvec_is_the_shift_over_matvec_bit_for_bit(case):
    """SymBandedLD.shifted_matvec(x, gamw, gam2) is gamw[:, None] *
    matvec(x) + gam2[:, None] * x bit for bit, and core/vamp.py's A product
    takes it. On the CPU every pass takes the copied route, and the counters
    say so; the lanes wrapper on the CPU is its plain version, that same
    expression. Every other operator has shifted_matvec from LDOperator."""
    from types import SimpleNamespace

    from sgvamp_torch.core.operators import BandedLD, LDOperator
    from sgvamp_torch.core.vamp import VampInputs, _amatvec
    from sgvamp_torch.ops.band_kernel import (sym_band_matvec_int8_lanes,
                                              sym_band_matvec_int8_lanes_ref)
    from sgvamp_torch.parallel import sharding
    from sgvamp_torch.utils import profiling

    K = 2
    if case == "banded":
        op = BandedLD.from_band(_band(512, 100, seed=5), block_size=64, K=K, device="cpu")
        assert isinstance(op, LDOperator)
    else:
        op = SymBandedLD.from_band(_band(512, 100, seed=5), block_size=64, K=K,
                                   dtype="float32" if case == "float32" else "int8",
                                   s=0.1 if case == "int8-s" else 0.0, device="cpu")
    if case == "int8-mesh":
        inputs = VampInputs(op=op, r=torch.zeros(K, op.M), a=torch.full((K,), 0.5),
                            N=torch.full((K,), 1e4))
        op = sharding.shard_inputs(inputs, sharding.make_mesh(
            1, 2, devices=[torch.device("cpu")] * 2)).op
        assert op.mesh is not None
    g = torch.Generator().manual_seed(len(case))
    x = torch.randn(2 * K, op.M, generator=g)
    gamw, gam2 = torch.rand(2 * K, generator=g) + 0.5, 40 * torch.rand(2 * K, generator=g)
    plain = op.matvec(x)
    want = gamw[:, None] * plain + gam2[:, None] * x
    profiling.reset()
    if case == "int8-lanes":   # the wrapper alone: no pass of the router
        assert torch.equal(sym_band_matvec_int8_lanes(op.upper, op.scales, x, gamw, gam2), want)
        assert torch.equal(sym_band_matvec_int8_lanes(op.upper, op.scales, x), plain)
        assert torch.equal(sym_band_matvec_int8_lanes_ref(op.upper, op.scales, x, gamw, gam2),
                           want)
        assert profiling.snapshot()["counts"] == {}
        return
    assert torch.equal(op.shifted_matvec(x, gamw, gam2), want)
    amat = _amatvec(SimpleNamespace(op=op), SimpleNamespace(gamw2=gamw, gam22=gam2))
    assert torch.equal(amat(x), want)
    counts = profiling.snapshot()["counts"]
    assert counts.get("ld_passes.in_place", 0) == 0
    assert counts.get("ld_passes.copied", 0) == (0 if case == "banded" else 2)


@pytest.mark.parametrize("how", ["resident", "rows_per_step"])
def test_int8_operator_refusals_hold_for_shifted_matvec(how):
    """shifted_matvec refuses what matvec refuses (band_kernel_of's checks):
    an int8 operator has no resident kernel, and its rows_per_step must
    divide nb and reach hb. The card's test holds the same on the card."""
    op = SymBandedLD.from_band(_band(512, 100, seed=5), block_size=64, dtype="int8",
                               device="cpu")
    op = (dataclasses.replace(op, mode="resident") if how == "resident"
          else dataclasses.replace(op, rows_per_step=3))
    x, v = torch.zeros(2, op.M), torch.ones(2)
    for call in (lambda: op.matvec(x), lambda: op.shifted_matvec(x, v, v)):
        with pytest.raises(ValueError, match="resident" if how == "resident" else "divide"):
            call()


def test_lanes_wrapper_refuses_bad_input():
    from sgvamp_torch.ops.band_kernel import sym_band_matvec_int8_lanes

    op = SymBandedLD.from_band(_band(300, 100, seed=3), block_size=64, dtype="int8",
                               device="cpu")
    x, v = torch.zeros(2, op.M), torch.ones(2)
    for args in [(x.double(),), (x[:, :-64],), (x[None],), (x, v), (x, v, v[:1]),
                 (x, v, v.double())]:
        with pytest.raises(ValueError):
            sym_band_matvec_int8_lanes(op.upper, op.scales, *args)
    with pytest.raises(ValueError, match="int8"):
        sym_band_matvec_int8_lanes(op.upper.float(), op.scales, x)


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
