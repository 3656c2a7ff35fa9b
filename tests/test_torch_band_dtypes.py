"""The port's SymBandedLD in float, int4 and hybrid storage against the JAX
package's, on the CPU.

Packing must be bit-identical. Each plain matvec must match the JAX Pallas
kernel (interpret mode, streamed flavor) on the same packed arrays: both sum
the same products in f32 in different orders, so they agree to a scaled
1e-5, the tolerance of tests/test_pallas_kernel.py. Engine trajectories in
f32 get the JAX package's own quantized-flavor tolerances
(__graft_entry__.py): relative L2 <= 1e-3 for xhat1, alpha2 and gamw,
<= 1e-1 for gam1.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import sgvamp_torch
from sgvamp_torch import interop
from sgvamp_torch.config import VampConfig as TConfig
from sgvamp_torch.core import vamp as tvamp
from sgvamp_torch.core.prior import PriorState as TPrior
from sgvamp_torch.ops import band_kernel as tbk
from sgvamp_torch.ops.band_kernel import SymBandedLD
from sgvamp_tpu.config import VampConfig as JConfig
from sgvamp_tpu.core import vamp as jvamp
from sgvamp_tpu.core.prior import PriorState as JPrior
from sgvamp_tpu.data.simulate import simulate_ld_band
from sgvamp_tpu.ops.band_kernel import SymBandedLD as JSym

SCALED_TOL = 1e-5
DTYPES = ["float32", "bfloat16", "int4", "hybrid"]
GEOMETRIES = [(128, 48, 300), (128, 200, 700), (64, 96, 300)]  # (B, bw, ragged M)


def _band(M, bw, seed, dtype=np.float32):
    return simulate_ld_band(10000, M, bw, rng=np.random.default_rng(seed),
                            dtype=dtype)[0]


def _np(a):
    """A JAX array as numpy; bf16 crosses as float32 (exact)."""
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _tnp(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _cross(jop, s=None):
    """The JAX operator's arrays as the port's operator, unchanged."""
    return interop.operator_from_numpy(
        _np(jop.upper), None if jop.scales is None else np.asarray(jop.scales),
        s=jop.s if s is None else s, packed=jop.packed, hybrid=jop.hybrid,
        dtype=torch.bfloat16 if jop.upper.dtype == jnp.bfloat16 else None,
        device="cpu")


@pytest.mark.parametrize("B,bw,M", GEOMETRIES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("band_dtype", [np.float32, np.float64])
def test_from_band_bit_identical(dtype, B, bw, M, band_dtype):
    band = _band(M, bw, seed=B + M, dtype=band_dtype)
    K = 2 if B == 64 else 1
    want = JSym.from_band(band, block_size=B, K=K, dtype=dtype)
    got = SymBandedLD.from_band(band, block_size=B, K=K, dtype=dtype, device="cpu")
    assert str(got.upper.dtype).split(".")[-1] == str(want.upper.dtype)
    np.testing.assert_array_equal(_tnp(got.upper), _np(want.upper))
    if want.scales is None:
        assert got.scales is None
    else:
        assert got.scales.dtype == torch.float32
        np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert got.bytes_per_pass() == want.bytes_per_pass()
    assert ((got.K, got.nb, got.hb, got.B, got.M, got.packed, got.hybrid, got.quantized)
            == (want.K, want.nb, want.hb, want.B, want.M, want.packed, want.hybrid,
                want.quantized))


def test_from_band_keeps_the_band_dtype_when_none():
    band = _band(300, 96, seed=2, dtype=np.float64)
    want = JSym.from_band(band, block_size=64, dtype=None)
    got = SymBandedLD.from_band(band, block_size=64, dtype=None, device="cpu")
    assert got.upper.dtype == torch.float64
    np.testing.assert_array_equal(got.upper.numpy(), np.asarray(want.upper))


def test_past_the_end_blocks_are_zero_and_padding_is_identity():
    B, bw, M = 64, 96, 300
    clean = _band(M, bw, seed=9)
    band = clean.copy()
    band[-10:, -5:] = 0.7   # entries that point past the (padded) matrix end
    for dtype in DTYPES + ["int8"]:
        op = SymBandedLD.from_band(band, block_size=B, dtype=dtype, device="cpu")
        R = op.to_dense()[0].double().numpy()
        assert R.shape == (320, 320)
        np.testing.assert_array_equal(R[M:, :M], 0.0)
        np.testing.assert_array_equal(R[M:, M:], np.eye(320 - M))
        want = SymBandedLD.from_band(clean, block_size=B, dtype=dtype, device="cpu")
        assert torch.equal(op.upper, want.upper)


@pytest.mark.parametrize("B,bw,M,K", [(128, 48, 300, 1), (128, 200, 700, 2),
                                      (64, 96, 300, 2), (64, 0, 192, 2)])
@pytest.mark.parametrize("dtype", DTYPES + ["float64"])
def test_matvec_matches_jax_and_dense(dtype, B, bw, M, K):
    # bandwidth 0 is the unit diagonal alone: hb = 0, blocks replaced below
    band = _band(M, bw, seed=7 + K) if bw else np.ones((M, 1), np.float32)
    jop = JSym.from_band(band.astype(np.float64 if dtype == "float64" else np.float32),
                         block_size=B, K=K, dtype=dtype, s=0.1)
    if not bw:
        # random diagonal blocks in the storage itself (hb = 0, no mirrors)
        rng = np.random.default_rng(5)
        if jop.scales is not None:
            up = rng.integers(-128, 128, size=jop.upper.shape).astype(np.int8)
            sc = (rng.random(jop.scales.shape) / 50).astype(np.float32)
            jop = dataclasses.replace(jop, upper=jnp.asarray(up), scales=jnp.asarray(sc))
        else:
            up = rng.normal(size=jop.upper.shape).astype(np.float32)
            jop = dataclasses.replace(jop, upper=jnp.asarray(up).astype(jop.upper.dtype))
    # the kernel being ported is the streamed one; the JAX package would
    # route a small float panel to its VMEM-resident kernel
    jop = dataclasses.replace(jop, mode="streamed")
    op = _cross(jop)
    assert op.hb == -(-bw // B) and op.K == K
    x = np.random.default_rng(1).normal(size=(2 * K, op.M)).astype(
        np.float64 if dtype == "float64" else np.float32)
    y = op.matvec(torch.from_numpy(x)).numpy().astype(np.float64)
    y_jax = np.asarray(jop.matvec(jnp.asarray(x)), np.float64)
    scale = np.abs(y_jax).max()
    tol = 1e-13 if dtype == "float64" else SCALED_TOL
    np.testing.assert_allclose(y / scale, y_jax / scale, rtol=0, atol=tol)
    # against the dense matrix in f64 times the rounded x, with the
    # regularization applied to the unrounded x
    Rq = op.to_dense().double().numpy()
    xr = torch.from_numpy(x)
    if dtype != "float64":
        xr = xr.to(torch.float32 if dtype == "float32" else torch.bfloat16)
    xr = xr.double().numpy().reshape(2, K, op.M)
    x64 = x.astype(np.float64).reshape(2, K, op.M)
    want = (np.einsum("kij,skj->ski", Rq, xr) + 0.1 * (x64 - xr)).reshape(2 * K, op.M)
    # int4 and hybrid round x * scale to bf16 (2^-9 relative) inside every
    # mirror term, which the dense product does not
    dense_tol = 5e-3 if dtype in ("int4", "hybrid") else max(tol, 1e-12)
    np.testing.assert_allclose(y / scale, want / scale, rtol=0, atol=dense_tol)


@pytest.mark.parametrize("dtype", DTYPES + ["int8", "float64"])
def test_diag_blocks_and_to_dense_match_jax(dtype):
    band = _band(300, 96, seed=11, dtype=np.float64 if dtype == "float64" else np.float32)
    jop = JSym.from_band(band, block_size=64, K=2, dtype=dtype, s=0.05)
    op = _cross(jop)
    D = op.diag_blocks()
    assert D.dtype == torch.float32 and tuple(D.shape) == (2, op.nb, 64, 64)
    np.testing.assert_array_equal(D.numpy(), np.asarray(jop.diag_blocks()))
    if dtype != "bfloat16":   # JAX regularizes the bf16 dense matrix in bf16
        np.testing.assert_array_equal(op.to_dense().numpy(), np.asarray(jop.to_dense()))
    np.testing.assert_array_equal(
        dataclasses.replace(op, s=0.0).to_dense().double().numpy(),
        np.asarray(dataclasses.replace(jop, s=0.0).to_dense().astype(jnp.float64)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_wrappers_take_the_plain_version(dtype):
    op = SymBandedLD.from_band(_band(300, 100, seed=3), block_size=64, dtype=dtype,
                               device="cpu")
    kernel, plain, args, xdt = tbk.band_kernel_of(op)
    x = torch.randn(1, 2, op.M, generator=torch.Generator().manual_seed(0)).to(xdt)
    before = [k.launches for k in tbk.BAND_KERNELS]
    y = kernel(*args, x)
    assert [k.launches for k in tbk.BAND_KERNELS] == before  # no kernel on the CPU
    assert y.dtype == torch.float32 and torch.equal(y, plain(*args, x))
    with pytest.raises(ValueError):
        kernel(*args, x.double())
    with pytest.raises(ValueError):
        kernel(*args, x[:, :, :-1])


def test_bad_storage_raises():
    up = torch.zeros((1, 2, 2, 64, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="scales"):
        SymBandedLD(upper=up)
    with pytest.raises(ValueError, match="exclude"):
        SymBandedLD(upper=up, scales=torch.zeros(1, 2, 2, 64), packed=True, hybrid=True)
    with pytest.raises(ValueError, match="unsupported"):
        SymBandedLD(upper=torch.zeros((1, 2, 2, 64, 64), dtype=torch.float16))
    with pytest.raises(ValueError, match="unsupported SymBandedLD dtype"):
        SymBandedLD.from_band(_band(128, 10, 0), block_size=64, dtype="int2", device="cpu")
    with pytest.raises(ValueError, match="even"):
        SymBandedLD.from_band(_band(99, 10, 0), block_size=33, dtype="int4", device="cpu")


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        assert sgvamp_torch.default_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        sgvamp_torch.default_device()
    band = _band(128, 10, 0)
    for call in (lambda: SymBandedLD.from_band(band, block_size=64, dtype="int8"),
                 lambda: TPrior.create(0.1, [1.0], [1.0]),
                 lambda: interop.prior_from_numpy(0.1, [1.0], [1.0]),
                 lambda: interop.inputs_from_numpy(None, band, band[0], band[0]),
                 lambda: interop.operator_from_numpy(np.zeros((1, 1, 1, 64, 64), np.float32)),
                 lambda: interop.state_from_numpy({"xhat1": band[0]})):
        with pytest.raises(RuntimeError, match="--platform cpu"):
            call()
    assert sgvamp_torch.resolve_device("cpu") == torch.device("cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _params(hist, col):
    return np.array([[row[col] for row in rows] for rows in hist["params"]])


@pytest.mark.parametrize("dtype", ["int4", "hybrid", "bfloat16"])
def test_f32_trajectory_matches(dtype):
    K, M, B, bw, iters = 2, 300, 64, 100, 3     # ragged M (pads to 320), hb = 2
    n, lam, h2 = 200, 0.05, 0.7
    band, r, x0 = simulate_ld_band(n, M, bw, h2=h2, lam=lam, n_r=K,
                                   rng=np.random.default_rng(12), dtype=np.float64)
    jop = JSym.from_band(band.astype(np.float32), block_size=B, K=K, dtype=dtype, s=0.02)
    top = _cross(jop)
    Mp = top.M
    mask = (np.arange(Mp) < M).astype(np.float32)
    rp = np.zeros((K, Mp), np.float32)
    rp[:, :M] = r
    a, Nk = np.full(K, 1.0 / K, np.float32), np.full(K, float(n), np.float32)
    cfg = dict(prior_update="em", dtype="float32", cg_maxit=20,
               cg_force_maxiter=True, em_prior_maxit=5, rho=0.5)
    prior = (lam, [1.0], [h2 / max(int(M * lam), 1) * n])
    jeng = jvamp.VampEngine(
        jvamp.VampInputs(op=jop, r=jnp.asarray(rp), a=jnp.asarray(a),
                         N=jnp.asarray(Nk), mask=jnp.asarray(mask)),
        JConfig(**cfg), JPrior.create(*prior))
    teng = tvamp.VampEngine(
        interop.inputs_from_numpy(top, rp, a, Nk, mask=mask, device="cpu"),
        TConfig(**cfg), TPrior.create(*prior, device="cpu"))
    u = np.random.default_rng(21).choice([-1.0, 1.0], size=(iters, K, Mp))
    hj = jeng.run(iters, fixed_u=u, M_out=M, x0=x0)
    ht = teng.run(iters, fixed_u=u, M_out=M, x0=x0)
    assert len(ht["xhat1"]) == len(hj["xhat1"]) == iters
    for it in range(iters):
        assert _rel(ht["xhat1"][it], hj["xhat1"][it]) <= 1e-3, it
    # columns of the params rows: it, gamw, gam1, gam2, alpha1, alpha2, lam
    for name, col, tol in (("alpha2", 5, 1e-3), ("gamw", 1, 1e-3), ("gam1", 2, 1e-1)):
        assert _rel(_params(ht, col), _params(hj, col)) <= tol, name
