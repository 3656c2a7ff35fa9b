"""The port's kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. This file
imports no jax, so it also runs where the JAX package is not installed;
there the JAX settings in conftest.py must be skipped:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from sgvamp_torch.data.simulate import simulate_ld_band
from sgvamp_torch.ops.band_kernel import (BAND_KERNELS, SymBandedLD, band_kernel_of,
                                          sym_band_matvec,
                                          sym_band_matvec_hybrid,
                                          sym_band_matvec_int4,
                                          sym_band_matvec_int8,
                                          sym_band_matvec_int8_ref,
                                          sym_band_matvec_resident,
                                          sym_band_matvec_window,
                                          sym_slab_matvec_resident,
                                          sym_slab_matvec_streamed)
from sgvamp_torch.ops.membench import measure_read_gbps, read_max, read_max_ref

pytestmark = pytest.mark.gpu

# max|kernel - plain| / max|plain|: both sum exact bf16*int8 products in
# f32, in different orders
SCALED_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.parametrize("B,bw,M,K,S", [
    (128, 300, 1000, 2, 2),   # ragged M, hb=3
    (128, 256, 4096, 1, 2),   # the bench's hb=2
    (64, 100, 777, 1, 1),
    (64, 10, 640, 3, 3),      # hb=1, K=3
    (256, 600, 3000, 1, 4),   # over 48 KB of shared memory
])
def test_band_kernel_matches_plain(cuda, B, bw, M, K, S):
    rng = np.random.default_rng(B + bw + M)
    band, _, _ = simulate_ld_band(10000, M, bw, rng=rng)
    op = SymBandedLD.from_band(band, block_size=B, K=K, dtype="int8", device=cuda)
    x = torch.from_numpy(rng.normal(size=(K, S, op.M))).to(cuda, torch.bfloat16)
    before = sym_band_matvec_int8.launches
    y = sym_band_matvec_int8(op.upper, op.scales, x)
    torch.cuda.synchronize()
    assert sym_band_matvec_int8.launches == before + 1
    want = sym_band_matvec_int8_ref(op.upper, op.scales, x)
    assert y.dtype == torch.float32 and y.shape == want.shape
    err = float((y - want).abs().max() / want.abs().max())
    assert err <= SCALED_TOL, err
    # the gather design writes every output once, with no atomics: the
    # same bits on every run
    assert torch.equal(y, sym_band_matvec_int8(op.upper, op.scales, x))


def test_band_kernel_rejects_bad_input(cuda):
    band, _, _ = simulate_ld_band(10000, 512, 64, rng=np.random.default_rng(0))
    op = SymBandedLD.from_band(band, block_size=128, dtype="int8", device=cuda)
    x = torch.zeros((1, 2, op.M), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        sym_band_matvec_int8(op.upper, op.scales, x.float())
    with pytest.raises(ValueError):
        sym_band_matvec_int8(op.upper, op.scales, torch.zeros_like(x).repeat(1, 5, 1))
    with pytest.raises(ValueError):
        sym_band_matvec_int8(op.upper, op.scales.cpu(), x)


# Products of a bf16 x with bf16, int4 or int8 values are exact in f32, so
# only the order of the f32 sums differs: scaled 1e-5. f32 blocks round
# each product too (same bound); f64 blocks sum in f64.
@pytest.mark.parametrize("B,bw,M,K,S", [
    (128, 300, 1000, 2, 2),   # ragged M, hb=3
    (128, 100, 1024, 1, 1),   # hb=1
    (128, 0, 512, 2, 4),      # hb=0: diagonal blocks only
    (64, 150, 777, 1, 2),     # hb=3
    (64, 60, 640, 2, 4),      # hb=1
    (64, 0, 256, 1, 1),       # hb=0
    (256, 700, 3000, 1, 4),   # hb=3
    (256, 200, 2048, 2, 1),   # hb=1
    (256, 0, 1024, 1, 2),     # hb=0
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64", "int4", "hybrid"])
def test_new_band_kernels_match_plain(cuda, dtype, B, bw, M, K, S):
    rng = np.random.default_rng(B + bw + M)
    if bw:
        band, _, _ = simulate_ld_band(10000, M, bw, rng=rng)
    else:
        band = np.ones((M, 1), np.float32)   # bandwidth 0: the unit diagonal
    op = dataclasses.replace(
        SymBandedLD.from_band(band, block_size=B, K=K, dtype=dtype, device=cuda),
        mode="streamed")
    assert op.hb == -(-bw // B)
    if not bw:  # identity blocks exercise nothing: randomize the storage
        g = torch.Generator(cuda).manual_seed(M)
        if op.upper.dtype == torch.int8:
            up = torch.randint(-128, 128, op.upper.shape, generator=g, device=cuda).to(torch.int8)
            sc = torch.rand(op.scales.shape, generator=g, device=cuda) / 100
            op = SymBandedLD(upper=up, scales=sc, packed=op.packed, hybrid=op.hybrid)
        else:
            op = SymBandedLD(upper=torch.randn(op.upper.shape, generator=g, device=cuda,
                                               dtype=torch.float32).to(op.upper.dtype),
                             mode="streamed")
    kernel, plain, args, xdt = band_kernel_of(op)
    x = torch.from_numpy(rng.normal(size=(K, S, op.M))).to(cuda, xdt)
    before = kernel.launches
    y = kernel(*args, x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(*args, x)
    assert y.dtype == want.dtype and y.shape == want.shape
    assert y.dtype == (torch.float64 if dtype == "float64" else torch.float32)
    err = float((y - want).abs().max() / want.abs().max())
    assert err <= (1e-12 if dtype == "float64" else SCALED_TOL), err
    assert torch.equal(y, kernel(*args, x))  # no atomics: reproducible bits


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int4", "hybrid", "int8"])
def test_operator_matvec_on_gpu_matches_cpu(cuda, dtype):
    rng = np.random.default_rng(5)
    band, _, _ = simulate_ld_band(10000, 900, 200, rng=rng)
    kw = dict(block_size=128, K=2, dtype=dtype, s=0.05)
    gpu = SymBandedLD.from_band(band, device=cuda, **kw)
    cpu = SymBandedLD.from_band(band, device="cpu", **kw)
    x = torch.from_numpy(rng.normal(size=(4, gpu.M)).astype(np.float32))
    y, want = gpu.matvec(x.to(cuda)).cpu(), cpu.matvec(x)
    assert float((y - want).abs().max() / want.abs().max()) <= SCALED_TOL


def test_new_band_kernels_reject_bad_input(cuda):
    band, _, _ = simulate_ld_band(10000, 512, 64, rng=np.random.default_rng(0))
    for dtype, kernel in (("int4", sym_band_matvec_int4), ("hybrid", sym_band_matvec_hybrid)):
        op = SymBandedLD.from_band(band, block_size=128, dtype=dtype, device=cuda)
        x = torch.zeros((1, 2, op.M), dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError):
            kernel(op.upper, op.scales, x.float())
        with pytest.raises(ValueError):
            kernel(op.upper, op.scales[:, :, :1], x)
        with pytest.raises(ValueError):
            kernel(op.upper, op.scales, x.repeat(1, 3, 1))  # S = 6
    op = SymBandedLD.from_band(band, block_size=128, dtype="float32", device=cuda)
    with pytest.raises(ValueError):   # x must be in the block dtype
        sym_band_matvec(op.upper, torch.zeros((1, 2, op.M), dtype=torch.bfloat16, device=cuda))
    with pytest.raises(ValueError):
        sym_band_matvec(op.upper, torch.zeros((1, 2, op.M), device="cpu"))
    op32 = SymBandedLD.from_band(band, block_size=32, dtype="float32", device=cuda)
    with pytest.raises(ValueError, match="B in"):
        sym_band_matvec(op32.upper, torch.zeros((1, 2, op32.M), device=cuda))


# The kernels of the slab layout and of the resident mode: the geometries
# above plus block-row counts that no run length divides and a band wider
# than a run (hb >= G). (layout, mode, window) name the kernel.
FLAVORS = {
    "slab-streamed": (sym_slab_matvec_streamed, dict(layout="slab", mode="streamed")),
    "resident": (sym_band_matvec_resident, dict(layout="diag", mode="resident")),
    "window": (sym_band_matvec_window, dict(layout="diag", mode="resident", window=True)),
    "slab-resident": (sym_slab_matvec_resident, dict(layout="slab", mode="resident")),
}


@pytest.mark.parametrize("B,bw,M,K,S,G", [
    (128, 300, 1000, 2, 2, 0),   # ragged M, hb=3, nb=8
    (128, 100, 1024, 1, 1, 4),   # hb=1
    (128, 0, 512, 2, 4, 0),      # hb=0: diagonal blocks only
    (64, 150, 777, 1, 2, 0),     # hb=3, nb=13: the last run is short
    (64, 300, 1920, 2, 3, 2),    # hb=5 over runs of 2: mirrors cross several runs
    (64, 60, 640, 2, 4, 5),      # hb=1, runs of 5
    (256, 700, 3000, 1, 4, 0),   # hb=3
    (256, 200, 2048, 2, 1, 1),   # hb=1, one block row a CTA
    (256, 0, 1024, 1, 2, 0),     # hb=0
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_slab_and_resident_kernels_match_plain(cuda, flavor, dtype, B, bw, M, K, S, G):
    rng = np.random.default_rng(B + bw + M)
    band = (simulate_ld_band(10000, M, bw, rng=rng)[0] if bw
            else np.ones((M, 1), np.float32))
    own, kw = FLAVORS[flavor]
    if flavor == "slab-streamed" and G and G < -(-bw // B):
        G = 0      # a streamed chunk below hb is refused, as in the JAX package
    op = dataclasses.replace(
        SymBandedLD.from_band(band, block_size=B, K=K, dtype=dtype, layout=kw["layout"],
                              device=cuda),
        mode=kw["mode"], window=kw.get("window", False), rows_per_step=G)
    if not bw:  # identity blocks exercise nothing: randomize the storage
        g = torch.Generator(cuda).manual_seed(M)
        op = dataclasses.replace(op, upper=torch.randn(
            op.upper.shape, generator=g, device=cuda, dtype=torch.float32).to(op.upper.dtype))
    kernel, plain, args, xdt = band_kernel_of(op, S)
    assert kernel is own and xdt == op.upper.dtype
    x = torch.from_numpy(rng.normal(size=(K, S, op.M))).to(cuda, xdt)
    before = [w.launches for w in BAND_KERNELS]
    y = kernel(*args, x)
    torch.cuda.synchronize()
    after = [w.launches for w in BAND_KERNELS]
    assert sum(after) == sum(before) + 1 and kernel.launches == before[
        BAND_KERNELS.index(kernel)] + 1
    want = plain(*args, x)
    assert y.dtype == want.dtype and y.shape == want.shape
    assert y.dtype == (torch.float64 if dtype == "float64" else torch.float32)
    err = float((y - want).abs().max() / want.abs().max())
    assert err <= (1e-12 if dtype == "float64" else SCALED_TOL), err
    assert torch.equal(y, kernel(*args, x))  # no atomics: reproducible bits


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_slab_and_resident_operator_on_gpu_matches_cpu(cuda, flavor):
    rng = np.random.default_rng(6)
    band, _, _ = simulate_ld_band(10000, 900, 200, rng=rng)
    _, kw = FLAVORS[flavor]
    ops = {d: dataclasses.replace(
        SymBandedLD.from_band(band, block_size=128, K=2, dtype="float32", s=0.05,
                              layout=kw["layout"], device=d),
        mode=kw["mode"], window=kw.get("window", False)) for d in (cuda, "cpu")}
    x = torch.from_numpy(rng.normal(size=(4, ops["cpu"].M)).astype(np.float32))
    y, want = ops[cuda].matvec(x.to(cuda)).cpu(), ops["cpu"].matvec(x)
    assert float((y - want).abs().max() / want.abs().max()) <= SCALED_TOL


def test_slab_and_resident_kernels_reject_bad_input(cuda):
    band, _, _ = simulate_ld_band(10000, 1024, 200, rng=np.random.default_rng(0))
    slab = SymBandedLD.from_band(band, block_size=128, dtype="float32", layout="slab",
                                 device=cuda)
    diag = SymBandedLD.from_band(band, block_size=128, dtype="float32", device=cuda)
    x = torch.zeros((1, 2, diag.M), device=cuda)
    for kernel, op in ((sym_slab_matvec_streamed, slab), (sym_slab_matvec_resident, slab),
                       (sym_band_matvec_resident, diag), (sym_band_matvec_window, diag)):
        with pytest.raises(ValueError):   # x must be in the block dtype
            kernel(op.upper, 0, x.to(torch.bfloat16))
        with pytest.raises(ValueError):
            kernel(op.upper, 0, x.cpu())
        with pytest.raises(ValueError):
            kernel(op.upper, 0, x.repeat(1, 3, 1))   # S = 6
        with pytest.raises(ValueError, match="divide"):
            kernel(op.upper, 3, x)                   # nb = 8
        with pytest.raises(ValueError):              # the other layout's blocks
            kernel((diag if op is slab else slab).upper, 0, x)
    for kernel, op in ((sym_slab_matvec_resident, slab), (sym_band_matvec_resident, diag)):
        x4 = torch.zeros((1, 4, 8 * 256), dtype=torch.float64, device=cuda)
        wide = torch.zeros((1, 8, 8 * 256, 256) if op is slab else (1, 8, 8, 256, 256),
                           dtype=torch.float64, device=cuda)   # hb = 7
        with pytest.raises(ValueError, match="does not fit"):
            kernel(wide, 0, x4)
        with pytest.raises(ValueError, match="too much"):
            kernel(wide, 8, x4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_read_probe_matches_plain(cuda, dtype):
    pytest.importorskip("triton")
    g = torch.Generator(cuda).manual_seed(0)
    if dtype == torch.int8:
        u = torch.randint(-127, 128, (3 << 20,), generator=g, device=cuda).to(dtype)
    else:
        u = torch.randn(3 << 20, generator=g, device=cuda).to(dtype)
        u[123457] = 1e6
    assert torch.equal(read_max(u), read_max_ref(u))


def test_read_probe_rate_is_finite(cuda):
    pytest.importorskip("triton")
    u = torch.randn(64 << 20, device=cuda)
    gbps, per_pass = measure_read_gbps(u, n=4, reps=2)
    assert np.isfinite(gbps) and gbps > 0 and per_pass > 0
