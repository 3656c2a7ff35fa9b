"""The port's kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. This file
imports no jax, so it also runs where the JAX package is not installed;
there the JAX settings in conftest.py must be skipped:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from sgvamp_torch.data.simulate import simulate_ld_band
from sgvamp_torch.ops.band_kernel import (BAND_KERNELS, SymBandedLD, band_kernel_of,
                                          traced_kernel_counts,
                                          sym_band_matvec,
                                          sym_band_matvec_ref,
                                          sym_band_matvec_spill,
                                          sym_band_matvec_spill_ref,
                                          sym_band_matvec_hybrid,
                                          sym_band_matvec_int4,
                                          sym_band_matvec_int8,
                                          sym_band_matvec_int8_lanes,
                                          sym_band_matvec_int8_lanes_ref,
                                          sym_band_matvec_int8_ref,
                                          sym_band_matvec_int8_spill,
                                          sym_band_matvec_int8_spill_ref,
                                          sym_band_matvec_resident,
                                          sym_band_matvec_window,
                                          sym_slab_matvec_resident,
                                          sym_slab_matvec_streamed,
                                          sym_slab_matvec_streamed_ref,
                                          sym_slab_matvec_streamed_spill,
                                          sym_slab_matvec_streamed_spill_ref)
from sgvamp_torch.ops.membench import measure_read_gbps, read_max, read_max_ref
from sgvamp_torch.utils import profiling
from sgvamp_torch.utils.profiling import TRACE_PAD_S
from torch_packed_slots import packed_slots, term_magnitudes, worst_termwise_error

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
    # no atomics, sums in a fixed order: the same bits on every run
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


# The spill forms (one shard of a sharded operator): every shard's (y_l,
# carry) against the plain version, then the shards composed on the card
# against the unsharded kernel. (storage, layout) name the kernel.
SPILL = {
    "int8": ("int8", "diag", "sym_band_matvec_int8_spill"),
    "bfloat16": ("bfloat16", "diag", "sym_band_matvec_spill"),
    "float32": ("float32", "diag", "sym_band_matvec_spill"),
    "float64": ("float64", "diag", "sym_band_matvec_spill"),
    "int4": ("int4", "diag", "sym_band_matvec_int4_spill"),
    "hybrid": ("hybrid", "diag", "sym_band_matvec_hybrid_spill"),
    "slab-bfloat16": ("bfloat16", "slab", "sym_slab_matvec_streamed_spill"),
    "slab-float32": ("float32", "slab", "sym_slab_matvec_streamed_spill"),
    "slab-float64": ("float64", "slab", "sym_slab_matvec_streamed_spill"),
}


def _cut(op, j, n):
    """Shard j of n of an unsharded operator: its block rows, contiguous."""
    nb_l = op.nb // n
    rows = slice(j * nb_l, (j + 1) * nb_l)
    return dataclasses.replace(
        op, upper=op.upper[:, rows].contiguous(),
        scales=None if op.scales is None else op.scales[:, rows].contiguous())


@pytest.mark.parametrize("B,bw,M,K,S,n", [
    (128, 300, 1000, 2, 2, 2),   # ragged M, nb=8, hb=3
    (64, 300, 1000, 2, 2, 2),    # nb=16, hb=5
    (128, 100, 1024, 1, 1, 4),   # hb=1, two block rows a shard
    (128, 0, 512, 2, 4, 2),      # hb=0: no halo, a carry of zeros
    (64, 60, 640, 2, 3, 5),      # nb=10 over 5 shards
    (256, 700, 4096, 1, 4, 4),   # hb=3
    (256, 200, 2048, 2, 1, 8),   # hb=1, one block row a shard (nb_l == hb)
])
@pytest.mark.parametrize("storage", sorted(SPILL))
def test_spill_kernels_match_plain_and_compose(cuda, storage, B, bw, M, K, S, n):
    dtype, layout, name = SPILL[storage]
    rng = np.random.default_rng(B + bw + M)
    band = (simulate_ld_band(10000, M, bw, rng=rng)[0] if bw
            else np.ones((M, 1), np.float32))
    op = dataclasses.replace(
        SymBandedLD.from_band(band, block_size=B, K=K, dtype=dtype, layout=layout,
                              device=cuda), mode="streamed")
    assert op.nb % n == 0 and op.nb // n >= op.hb
    tol = 1e-12 if dtype == "float64" else SCALED_TOL
    whole, _, wargs, xdt = band_kernel_of(op, S)
    x = torch.from_numpy(rng.normal(size=(K, S, op.M))).to(cuda, xdt)
    want = whole(*wargs, x)
    scale = float(want.abs().max())
    hbB, M_l = op.hb * B, op.M // n
    xpad = torch.cat([x, x.new_zeros(K, S, hbB)], dim=2)
    ys, carry = [], None
    for j in range(n):
        kernel, plain, args, _ = band_kernel_of(_cut(op, j, n), S, spill=True)
        assert kernel.__name__ == name
        x_ext = xpad[:, :, j * M_l:(j + 1) * M_l + hbB].contiguous()
        before = [w.launches for w in BAND_KERNELS]
        y_l, spilled = kernel(*args, x_ext)
        torch.cuda.synchronize()
        after = [w.launches for w in BAND_KERNELS]
        assert sum(after) == sum(before) + 1
        assert kernel.launches == before[BAND_KERNELS.index(kernel)] + 1
        py, pc = plain(*args, x_ext)
        assert y_l.dtype == py.dtype == want.dtype and y_l.shape == py.shape == (K, S, M_l)
        assert spilled.dtype == pc.dtype and spilled.shape == pc.shape == (K, S, max(hbB, B))
        assert float((y_l - py).abs().max()) / scale <= tol
        assert float((spilled - pc).abs().max()) / scale <= tol
        y2, c2 = kernel(*args, x_ext)   # no atomics: reproducible bits
        assert torch.equal(y_l, y2) and torch.equal(spilled, c2)
        if j and hbB:
            y_l[:, :, :hbB] += carry
        carry = spilled
        ys.append(y_l)
    assert float((torch.cat(ys, dim=2) - want).abs().max()) / scale <= tol
    # what leaves the global panel is exact zeros
    assert float(carry.abs().max()) == 0.0


@pytest.mark.parametrize("storage", sorted(SPILL))
def test_sharded_operator_on_one_card_matches_unsharded(cuda, storage):
    """shard_inputs on a mesh whose four cells are one card: the sharded
    matvec launches the spill kernel once a cell and no other band kernel,
    and agrees with the unsharded operator."""
    from sgvamp_torch.core.vamp import VampInputs
    from sgvamp_torch.parallel.sharding import make_mesh, shard_inputs

    dtype, layout, name = SPILL[storage]
    rng = np.random.default_rng(7)
    band, _, _ = simulate_ld_band(10000, 2000, 200, rng=rng)
    op = SymBandedLD.from_band(band, block_size=128, K=2, dtype=dtype, layout=layout, s=0.05,
                               device=cuda)       # nb=16, hb=2
    x = torch.from_numpy(rng.normal(size=(4, op.M))).to(
        cuda, torch.float64 if dtype == "float64" else torch.float32)
    want = op.matvec(x)
    for shape in ((1, 4), (2, 2)):
        mesh = make_mesh(*shape, devices=[cuda] * 4)
        sh = shard_inputs(VampInputs(op=op, r=x[:2], a=x.new_ones(2), N=x.new_ones(2)), mesh)
        assert sh.op.mesh is mesh
        for w in BAND_KERNELS:
            w.launches = 0
        got = sh.op.matvec(x)
        torch.cuda.synchronize()
        assert {w.__name__: w.launches for w in BAND_KERNELS if w.launches} == {name: 4}
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= (1e-12 if dtype == "float64" else SCALED_TOL), (shape, err)
    with pytest.raises(ValueError):    # a spill wrapper never steps down to the CPU's version
        kernel, _, args, xdt = band_kernel_of(sh.op.shards[0][0], 2, spill=True)
        kernel(*args, torch.zeros((1, 2, 10 * 128), dtype=xdt))


# The streamed float kernels (csrc/sym_band_float.cu, csrc/sym_slab_streamed.cu)
# read every stored block once: mirror sums that leave a CTA's run of block
# rows go through a scratch of partial sums and a second launch. Held against
# their plain versions on random blocks (zero past the panel's end, as
# from_band leaves them): wide bands where mode="auto" routes here (hb 15,
# 16), hb=0 (no partials), runs cut short by a ragged nb, and in the spill
# form shards narrower than a run; the same bits on a repeat; the last
# shard's carry exactly zero. (layout) -> (wrapper, plain, spill wrapper,
# spill plain).
STREAMED_FLOAT = {
    "diag": (sym_band_matvec, sym_band_matvec_ref, sym_band_matvec_spill,
             sym_band_matvec_spill_ref),
    "slab": (sym_slab_matvec_streamed, sym_slab_matvec_streamed_ref,
             sym_slab_matvec_streamed_spill, sym_slab_matvec_streamed_spill_ref),
}


def _random_blocks(layout, dtype, K, nb, hb, B, seed, device):
    """Random float blocks U[i, d], zero where i + d >= nb, in `layout`."""
    g = torch.Generator(device).manual_seed(seed)
    up = torch.randn((K, nb, hb + 1, B, B), generator=g, device=device)
    for d in range(1, hb + 1):
        up[:, max(nb - d, 0):, d] = 0.0
    if layout == "slab":
        up = up.transpose(-1, -2).reshape(K, nb, (hb + 1) * B, B)
    return up.to(getattr(torch, dtype)).contiguous()


def _streamed_args(layout, upper, G=0):
    return (upper,) if layout == "diag" else (upper, G)


@pytest.mark.parametrize("B,hb,nb,K,S,G", [
    (64, 15, 40, 1, 2, 0),     # wide: "auto" takes the streamed kernel
    (64, 16, 37, 2, 1, 0),     # wide, ragged nb: the last run is short
    (128, 15, 32, 1, 4, 0),
    (128, 16, 48, 1, 2, 16),   # slab: rows_per_step=16, runs of 8 at most (the tiles' rule)
    (128, 0, 9, 2, 3, 0),      # hb=0: no mirror blocks, no partials
    (256, 3, 11, 1, 2, 0),
    (256, 1, 5, 1, 4, 0),      # fewer block rows than a run
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
@pytest.mark.parametrize("layout", sorted(STREAMED_FLOAT))
def test_streamed_float_kernels_read_once_match_plain(cuda, layout, dtype, B, hb, nb, K, S, G):
    kernel, plain, _, _ = STREAMED_FLOAT[layout]
    upper = _random_blocks(layout, dtype, K, nb, hb, B, B + hb + nb, cuda)
    args = _streamed_args(layout, upper, G)
    x = torch.from_numpy(np.random.default_rng(nb + S).normal(size=(K, S, nb * B))).to(
        cuda, upper.dtype)
    before = [w.launches for w in BAND_KERNELS]
    y = kernel(*args, x)
    torch.cuda.synchronize()
    after = [w.launches for w in BAND_KERNELS]
    # one pass, two launches on the card (the kernel and its fold), counted once
    assert sum(after) == sum(before) + 1 and kernel.launches == before[
        BAND_KERNELS.index(kernel)] + 1
    want = plain(*args, x)
    assert y.dtype == want.dtype and y.shape == want.shape == (K, S, nb * B)
    err = float((y - want).abs().max() / want.abs().max())
    assert err <= (1e-12 if dtype == "float64" else SCALED_TOL), err
    assert torch.equal(y, kernel(*args, x))  # no atomics: reproducible bits


@pytest.mark.parametrize("B,hb,nb,n,K,S", [
    (64, 15, 60, 4, 1, 2),     # wide, shards of hb block rows
    (128, 16, 64, 4, 2, 1),    # wide
    (128, 3, 12, 3, 1, 4),     # shards of 4 block rows: narrower than a run
    (64, 5, 10, 2, 2, 3),      # shards of 5, hb=5
    (128, 1, 8, 8, 1, 2),      # one block row a shard
    (256, 2, 9, 3, 1, 1),
    (128, 0, 6, 3, 2, 2),      # hb=0: no halo, a carry of one zero block
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
@pytest.mark.parametrize("layout", sorted(STREAMED_FLOAT))
def test_streamed_float_spill_kernels_read_once_match_plain(cuda, layout, dtype, B, hb, nb, n,
                                                             K, S):
    whole, _, kernel, plain = STREAMED_FLOAT[layout]
    upper = _random_blocks(layout, dtype, K, nb, hb, B, B + hb + nb + n, cuda)
    tol = 1e-12 if dtype == "float64" else SCALED_TOL
    x = torch.from_numpy(np.random.default_rng(nb + n).normal(size=(K, S, nb * B))).to(
        cuda, upper.dtype)
    want = whole(*_streamed_args(layout, upper), x)
    scale = float(want.abs().max())
    nb_l, hbB = nb // n, hb * B
    xpad = torch.cat([x, x.new_zeros(K, S, hbB)], dim=2)
    ys, carry = [], None
    for j in range(n):
        args = _streamed_args(layout, upper[:, j * nb_l:(j + 1) * nb_l].contiguous())
        x_ext = xpad[:, :, j * nb_l * B:((j + 1) * nb_l + hb) * B].contiguous()
        before = kernel.launches
        y_l, spilled = kernel(*args, x_ext)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        py, pc = plain(*args, x_ext)
        assert y_l.shape == py.shape == (K, S, nb_l * B)
        assert spilled.shape == pc.shape == (K, S, max(hbB, B))
        assert float((y_l - py).abs().max()) / scale <= tol
        assert float((spilled - pc).abs().max()) / scale <= tol
        y2, c2 = kernel(*args, x_ext)   # no atomics: reproducible bits
        assert torch.equal(y_l, y2) and torch.equal(spilled, c2)
        if j and hbB:
            y_l[:, :, :hbB] += carry
        carry = spilled
        ys.append(y_l)
    assert float(carry.abs().max()) == 0.0
    assert float((torch.cat(ys, dim=2) - want).abs().max()) / scale <= tol


@pytest.mark.parametrize("dtype", ["bfloat16", "float64"])
@pytest.mark.parametrize("layout", sorted(STREAMED_FLOAT))
def test_streamed_float_kernels_refuse_unaligned_upper(cuda, layout, dtype):
    """The walker reads the blocks 16 bytes at a time: blocks that start off
    a 16-byte boundary are refused with cudaErrorMisalignedAddress (716)
    and nothing is launched."""
    kernel = STREAMED_FLOAT[layout][0]
    upper = _random_blocks(layout, dtype, 1, 4, 1, 64, 0, cuda)
    off = torch.empty(upper.numel() + 1, dtype=upper.dtype, device=cuda)[1:].view(upper.shape)
    off.copy_(upper)
    assert off.is_contiguous() and off.data_ptr() % 16
    x = torch.zeros((1, 2, 4 * 64), dtype=upper.dtype, device=cuda)
    before = kernel.launches
    with pytest.raises(RuntimeError, match=r"\(error 716\)"):
        kernel(*_streamed_args(layout, off), x)
    assert kernel.launches == before


# The tensor-core decode and fragment maps of the int4 and hybrid kernels
# (csrc/sym_band_packed.cuh) on slots that hold every byte value in every
# position, at every block size, lane count and band up to hb = 3, in both
# forms: scaled 1e-5 against the plain version (exact products, f32 sums in
# another order), both by max|y| and element by element by the sum of the
# element's own |terms|, and the same bits on a second run.
@pytest.mark.parametrize("hb", range(4))
@pytest.mark.parametrize("S", range(1, 5))
@pytest.mark.parametrize("B", [64, 128, 256])
@pytest.mark.parametrize("spill", [False, True], ids=["matvec", "spill"])
@pytest.mark.parametrize("storage", ["int4", "hybrid"])
def test_packed_kernels_on_every_byte_value(cuda, storage, spill, B, S, hb):
    from sgvamp_torch.ops import band_kernel

    nb, K = 5, 1 + hb % 2
    upper, scales = packed_slots(B, hb, nb, K, storage == "hybrid", seed=B + 10 * S + hb)
    u, sc = torch.from_numpy(upper).to(cuda), torch.from_numpy(scales).to(cuda)
    rng = np.random.default_rng(S + hb)
    x = torch.from_numpy(rng.normal(size=(K, S, (nb + (hb if spill else 0)) * B))).to(
        cuda, torch.bfloat16)
    kernel = getattr(band_kernel, f"sym_band_matvec_{storage}{'_spill' if spill else ''}")
    plain = getattr(band_kernel, kernel.__name__ + "_ref")
    before = kernel.launches
    got = kernel(u, sc, x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(u, sc, x)
    got, want = (got, want) if spill else ((got,), (want,))
    scale = float(want[0].abs().max())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        err = float((g - w).abs().max()) / scale
        assert err <= SCALED_TOL, err
    mags = term_magnitudes(upper, scales, x.float().cpu().numpy(), storage == "hybrid", spill)
    err = worst_termwise_error([g.cpu() for g in got], [w.cpu() for w in want], mags)
    assert err <= SCALED_TOL, err
    again = kernel(u, sc, x)
    again = again if spill else (again,)
    assert all(torch.equal(g, a) for g, a in zip(got, again))  # no atomics


@pytest.mark.parametrize("which", ["upper", "scales", "x"])
@pytest.mark.parametrize("storage", ["int4", "hybrid"])
def test_packed_kernels_refuse_unaligned_inputs(cuda, storage, which):
    """The kernel copies upper, scales and x 16 bytes at a time: an array
    that starts off a 16-byte boundary (a contiguous view one element into
    a buffer) is refused with cudaErrorMisalignedAddress (716) and nothing
    is launched."""
    from sgvamp_torch.ops import band_kernel

    B, hb, nb = 128, 2, 5
    upper, scales = packed_slots(B, hb, nb, 1, storage == "hybrid", seed=3)
    args = {"upper": torch.from_numpy(upper).to(cuda),
            "scales": torch.from_numpy(scales).to(cuda),
            "x": torch.from_numpy(np.random.default_rng(4).normal(size=(1, 1, nb * B))).to(
                cuda, torch.bfloat16)}
    t = args[which]
    off = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)[1:].view(t.shape)
    off.copy_(t)
    assert off.is_contiguous() and off.data_ptr() % 16
    args[which] = off
    kernel = getattr(band_kernel, f"sym_band_matvec_{storage}")
    before = kernel.launches
    with pytest.raises(RuntimeError, match=r"\(error 716\)"):
        kernel(args["upper"], args["scales"], args["x"])
    assert kernel.launches == before


# The int8 kernel reads every stored block once (csrc/sym_band_int8.cu): runs
# of G block rows a CTA, one warp a block row, mirror sums that leave a run
# through the scratch of partial sums and a second launch. Held against the
# plain versions (scaled 1e-5: exact bf16*int8 products, f32 sums in another
# order, dot then scale in both) at the wrapper's own G and at forced ones,
# so that every design edge is reached at a small nb: hb 0..3 and 16, nb not
# a multiple of G and nb < G, shards narrower than a run, K up to 3, S 1..4,
# B 64/128/256; the same bits on a repeat, the last carry of a chain exactly
# zero. None: the wrapper's choice (ops/band_kernel.py::_int8_runs).
INT8_RUNS = [None, 8, 4, 2, 3, 5, 1]


def _runs_id(runs):
    return "chosen" if runs is None else f"G{runs}"


def _int8_blocks(K, nb, hb, B, seed, device, every_byte=False):
    """int8 blocks U[i, d], zero where i + d >= nb (as from_band leaves
    them), and per-block scales log-uniform on 1e-4..1e2. every_byte: down
    the nb*B >= 256 rows of the stored blocks every column of every slot
    runs through all 256 byte values, the first and the last column too."""
    rng = np.random.default_rng(seed)
    if every_byte:
        n, sl, p, q = np.ix_(np.arange(nb), np.arange(hb + 1), np.arange(B), np.arange(B))
        up = ((n * B + p + 97 * sl + 29 * q) % 256).astype(np.uint8).view(np.int8)
        up = np.broadcast_to(up, (K, nb, hb + 1, B, B)).copy()
    else:
        up = rng.integers(-128, 128, size=(K, nb, hb + 1, B, B), dtype=np.int8)
        for d in range(1, hb + 1):
            up[:, max(nb - d, 0):, d] = 0
    scales = (10.0 ** rng.uniform(-4, 2, size=(K, nb, hb + 1))).astype(np.float32)
    return torch.from_numpy(up).to(device), torch.from_numpy(scales).to(device)


@pytest.fixture
def force_int8_runs(monkeypatch):
    """force(runs): the int8 wrappers take runs of G = runs block rows, or
    their own choice for None."""
    from sgvamp_torch.ops import band_kernel

    def force(runs):
        if runs is not None:
            monkeypatch.setattr(band_kernel, "_int8_runs", lambda nb, sms: runs)
    return force


def _int8_termwise(upper, scales, x, spill):
    """Per output element, the sum of the absolute values of its terms: the
    plain version over |U|, |x| (as in torch_packed_slots.term_magnitudes)."""
    from sgvamp_torch.ops.band_kernel import _int8_ref

    got = _int8_ref(upper.float().abs().cpu(), scales.cpu(), x.float().abs().cpu(), spill)
    return got if spill else (got,)


@pytest.mark.parametrize("runs", INT8_RUNS, ids=_runs_id)
@pytest.mark.parametrize("B,hb,nb,K,S", [
    (64, 16, 37, 2, 1),     # wide, ragged: the last run is short
    (128, 16, 40, 1, 2),
    (128, 2, 11, 3, 3),     # K=3
    (256, 3, 13, 1, 4),
    (128, 0, 9, 2, 2),      # hb=0: no mirror blocks, no partials, one launch
    (64, 1, 5, 1, 4),       # fewer block rows than a run
    (256, 2, 3, 2, 1),
    (128, 63, 64, 2, 2),    # hb = nb - 1 and hb = nb (a dense panel's band of width
    (128, 64, 64, 2, 2),    # M - 1 at B=128): the whole upper triangle
])
def test_int8_kernel_reads_once_matches_plain(cuda, force_int8_runs, runs, B, hb, nb, K, S):
    force_int8_runs(runs)
    upper, scales = _int8_blocks(K, nb, hb, B, B + hb + nb, cuda)
    x = torch.from_numpy(np.random.default_rng(nb + S).normal(size=(K, S, nb * B))).to(
        cuda, torch.bfloat16)
    before = [w.launches for w in BAND_KERNELS]
    y = sym_band_matvec_int8(upper, scales, x)
    torch.cuda.synchronize()
    after = [w.launches for w in BAND_KERNELS]
    # one pass, two launches on the card (the kernel and its fold), counted once
    assert sum(after) == sum(before) + 1
    assert sym_band_matvec_int8.launches == before[BAND_KERNELS.index(sym_band_matvec_int8)] + 1
    want = sym_band_matvec_int8_ref(upper, scales, x)
    assert y.dtype == want.dtype == torch.float32 and y.shape == want.shape == (K, S, nb * B)
    err = float((y - want).abs().max() / want.abs().max())
    assert err <= SCALED_TOL, err
    assert torch.equal(y, sym_band_matvec_int8(upper, scales, x))  # no atomics


@pytest.mark.parametrize("runs", INT8_RUNS[:5], ids=_runs_id)
@pytest.mark.parametrize("B,hb,nb,n,K,S", [
    (128, 2, 4096, 4, 1, 2),   # the bench shape cut four ways: shards of 1024 block rows
    (64, 16, 64, 4, 2, 1),     # wide, shards of hb block rows
    (128, 3, 12, 3, 1, 4),     # shards of 4 block rows: narrower than a run
    (64, 5, 10, 2, 3, 3),      # shards of 5, hb=5, K=3
    (128, 1, 8, 8, 1, 2),      # one block row a shard
    (256, 2, 9, 3, 1, 1),
    (128, 0, 6, 3, 2, 2),      # hb=0: no halo, a carry of one zero block
])
def test_int8_spill_kernel_reads_once_matches_plain(cuda, force_int8_runs, runs, B, hb, nb, n,
                                                    K, S):
    force_int8_runs(runs)
    upper, scales = _int8_blocks(K, nb, hb, B, B + hb + nb + n, cuda)
    x = torch.from_numpy(np.random.default_rng(nb + n).normal(size=(K, S, nb * B))).to(
        cuda, torch.bfloat16)
    want = sym_band_matvec_int8_ref(upper, scales, x)
    scale = float(want.abs().max())
    nb_l, hbB = nb // n, hb * B
    xpad = torch.cat([x, x.new_zeros(K, S, hbB)], dim=2)
    ys, carry = [], None
    for j in range(n):
        rows = slice(j * nb_l, (j + 1) * nb_l)
        u, sc = upper[:, rows].contiguous(), scales[:, rows].contiguous()
        x_ext = xpad[:, :, j * nb_l * B:((j + 1) * nb_l + hb) * B].contiguous()
        before = sym_band_matvec_int8_spill.launches
        y_l, spilled = sym_band_matvec_int8_spill(u, sc, x_ext)
        torch.cuda.synchronize()
        assert sym_band_matvec_int8_spill.launches == before + 1
        py, pc = sym_band_matvec_int8_spill_ref(u, sc, x_ext)
        assert y_l.shape == py.shape == (K, S, nb_l * B)
        assert spilled.shape == pc.shape == (K, S, max(hbB, B))
        assert float((y_l - py).abs().max()) / scale <= SCALED_TOL
        assert float((spilled - pc).abs().max()) / scale <= SCALED_TOL
        y2, c2 = sym_band_matvec_int8_spill(u, sc, x_ext)   # no atomics
        assert torch.equal(y_l, y2) and torch.equal(spilled, c2)
        if j and hbB:
            y_l[:, :, :hbB] += carry
        carry = spilled
        ys.append(y_l)
    assert float(carry.abs().max()) == 0.0
    assert float((torch.cat(ys, dim=2) - want).abs().max()) / scale <= SCALED_TOL


# Every byte value -128..127 in every position of every slot, at every
# block size, lane count and band up to hb = 3, in both forms, with a
# run length G that varies with the case: scaled 1e-5 by max|y| and element by
# element by the sum of the element's own |terms| (the scales span six
# decades), and the same bits on a second run.
@pytest.mark.parametrize("hb", range(4))
@pytest.mark.parametrize("S", range(1, 5))
@pytest.mark.parametrize("B", [64, 128, 256])
@pytest.mark.parametrize("spill", [False, True], ids=["matvec", "spill"])
def test_int8_kernel_on_every_byte_value(cuda, force_int8_runs, spill, B, S, hb):
    force_int8_runs(INT8_RUNS[(B // 64 + S + hb) % len(INT8_RUNS)])
    nb, K = 5, 1 + hb % 2
    upper, scales = _int8_blocks(K, nb, hb, B, B + 10 * S + hb, cuda, every_byte=True)
    rng = np.random.default_rng(S + hb)
    x = torch.from_numpy(rng.normal(size=(K, S, (nb + (hb if spill else 0)) * B))).to(
        cuda, torch.bfloat16)
    kernel = sym_band_matvec_int8_spill if spill else sym_band_matvec_int8
    plain = sym_band_matvec_int8_spill_ref if spill else sym_band_matvec_int8_ref
    before = kernel.launches
    got = kernel(upper, scales, x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(upper, scales, x)
    got, want = (got, want) if spill else ((got,), (want,))
    scale = float(want[0].abs().max())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        err = float((g - w).abs().max()) / scale
        assert err <= SCALED_TOL, err
    mags = _int8_termwise(upper, scales, x, spill)
    err = worst_termwise_error([g.cpu() for g in got], [w.cpu() for w in want],
                               [m.numpy() for m in mags])
    assert err <= SCALED_TOL, err
    again = kernel(upper, scales, x)
    again = again if spill else (again,)
    assert all(torch.equal(g, a) for g, a in zip(got, again))  # no atomics


@pytest.mark.parametrize("runs", [None, 3], ids=_runs_id)
@pytest.mark.parametrize("B,hb,nb,K", [
    (128, 2, 1024, 1),   # one shard of the bench shape's four
    (64, 16, 37, 2),     # wide, ragged
    (256, 1, 5, 1),
    (128, 0, 9, 2),      # hb=0: the diagonal blocks alone
])
@pytest.mark.parametrize("spill", [False, True], ids=["matvec", "spill"])
def test_int8_kernel_reads_every_block_once(cuda, force_int8_runs, spill, B, hb, nb, K, runs):
    """The build that counts the block bytes its warps copy
    (band_kernel.int8_block_bytes) copies each stored block that holds data
    once a pass: the blocks (i, d) with i + d < nb, and in the spill form
    every block of the shard (those past its end multiply the halo). Its
    results are the default build's, bit for bit."""
    from sgvamp_torch.ops.band_kernel import int8_block_bytes

    force_int8_runs(runs)
    upper, scales = _int8_blocks(K, nb, hb, B, nb + hb, cuda)
    x = torch.from_numpy(np.random.default_rng(hb).normal(
        size=(K, 2, (nb + (hb if spill else 0)) * B))).to(cuda, torch.bfloat16)
    kernel = sym_band_matvec_int8_spill if spill else sym_band_matvec_int8
    got = []
    n = int8_block_bytes(lambda: got.append(kernel(upper, scales, x)))
    blocks = nb * (hb + 1) if spill else sum(min(hb, nb - 1 - i) + 1 for i in range(nb))
    assert n == K * blocks * B * B
    want = kernel(upper, scales, x)
    got, want = (got[0], want) if spill else ((got[0],), (want,))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# The int8 kernel's tiles (csrc/sym_band_int8.cu): runs of G block rows and
# ranges of D diagonals, so that a band of few block rows and many diagonals
# (a dense panel's whole upper triangle, hb >= nb - 1) fills the card; with
# more than one range the tiles' row sums go through the scratch too and
# fold_tiles adds them. Held against the plain version (scaled 1e-5) at the
# rule's own tiles (ops/band_kernel.py::_int8_tiles) and at forced ones, the
# same bits on a repeat, one read of every held block by the counting build.


@pytest.fixture
def force_int8_tiles():
    """force(tiles): until the test ends the int8 wrappers take tiles (G, D)
    (D None: every diagonal; utils/kernel_diag.py::forced_int8_tiles), or
    their own choice for None."""
    from sgvamp_torch.utils.kernel_diag import forced_int8_tiles

    with contextlib.ExitStack() as stack:
        yield lambda tiles: tiles is None or stack.enter_context(forced_int8_tiles(*tiles))


def _tiles_id(tiles):
    return "chosen" if tiles is None else f"G{tiles[0]}D{tiles[1] or 'all'}"


def _int8_pass(upper, scales, x):
    """One counted pass of the int8 matvec kernel and its plain version."""
    before = [w.launches for w in BAND_KERNELS]
    y = sym_band_matvec_int8(upper, scales, x)
    torch.cuda.synchronize()
    after = [w.launches for w in BAND_KERNELS]
    assert sum(after) == sum(before) + 1   # the kernel and its fold, counted once
    assert sym_band_matvec_int8.launches == before[BAND_KERNELS.index(sym_band_matvec_int8)] + 1
    want = sym_band_matvec_int8_ref(upper, scales, x)
    assert y.dtype == want.dtype == torch.float32 and y.shape == want.shape
    return y, want


@pytest.mark.parametrize("S", range(1, 5))
@pytest.mark.parametrize("wider", [0, 1], ids=["hb=nb-1", "hb=nb"])
@pytest.mark.parametrize("nb", [16, 64])
@pytest.mark.parametrize("B", [64, 128, 256])
def test_int8_kernel_on_whole_triangle_matches_plain(cuda, B, nb, wider, S):
    """The wrapper's own tiles over a dense panel's whole triangle, K 1 or 2."""
    hb, K = nb - 1 + wider, 1 + S % 2
    upper, scales = _int8_blocks(K, nb, hb, B, B + nb + hb + S, cuda)
    x = torch.from_numpy(np.random.default_rng(nb + S).normal(size=(K, S, nb * B))).to(
        cuda, torch.bfloat16)
    y, want = _int8_pass(upper, scales, x)
    err = float((y - want).abs().max() / want.abs().max())
    assert err <= SCALED_TOL, err
    assert torch.equal(y, sym_band_matvec_int8(upper, scales, x))  # no atomics


@pytest.mark.parametrize("tiles", [None, (1, 1), (1, None), (8, 1), (8, 3), (3, 2), (5, 7),
                                   (2, None), (4, 2)], ids=_tiles_id)
@pytest.mark.parametrize("B,hb,nb,K,S", [
    (64, 15, 16, 2, 1),     # whole triangles
    (128, 13, 13, 1, 2),
    (256, 9, 9, 2, 3),
    (128, 16, 37, 2, 4),    # a band, ragged: the last run is short
    (64, 2, 11, 3, 2),      # K=3
    (128, 0, 9, 2, 2),      # hb=0: one range whatever is forced
])
def test_int8_kernel_forced_tiles_match_plain(cuda, force_int8_tiles, tiles, B, hb, nb, K, S):
    force_int8_tiles(tiles)
    upper, scales = _int8_blocks(K, nb, hb, B, B + 3 * hb + nb, cuda)
    x = torch.from_numpy(np.random.default_rng(hb + S).normal(size=(K, S, nb * B))).to(
        cuda, torch.bfloat16)
    y, want = _int8_pass(upper, scales, x)
    err = float((y - want).abs().max() / want.abs().max())
    assert err <= SCALED_TOL, err
    assert torch.equal(y, sym_band_matvec_int8(upper, scales, x))  # no atomics


@pytest.mark.parametrize("S", range(1, 5))
@pytest.mark.parametrize("B", [64, 128, 256])
def test_int8_whole_triangle_on_every_byte_value(cuda, force_int8_tiles, B, S):
    """Every byte value in every position of every slot of a whole triangle
    (nb=5, hb=5), with tiles that vary with the case: scaled 1e-5 by max|y|
    and element by element by the sum of the element's own |terms|, the same
    bits on a second run."""
    force_int8_tiles([None, (1, 1), (2, 2), (3, None)][(B // 64 + S) % 4])
    nb = hb = 5
    K = 1 + S % 2
    upper, scales = _int8_blocks(K, nb, hb, B, B + 10 * S, cuda, every_byte=True)
    x = torch.from_numpy(np.random.default_rng(S).normal(size=(K, S, nb * B))).to(
        cuda, torch.bfloat16)
    y, want = _int8_pass(upper, scales, x)
    err = float((y - want).abs().max()) / float(want.abs().max())
    assert err <= SCALED_TOL, err
    mags = _int8_termwise(upper, scales, x, False)
    err = worst_termwise_error([y.cpu()], [want.cpu()], [m.numpy() for m in mags])
    assert err <= SCALED_TOL, err
    assert torch.equal(y, sym_band_matvec_int8(upper, scales, x))  # no atomics


@pytest.mark.parametrize("tiles", [None, (1, 1), (8, 3), (1, None)], ids=_tiles_id)
@pytest.mark.parametrize("B,nb,hb,K", [(128, 64, 64, 2), (64, 16, 15, 1), (256, 16, 16, 2)])
def test_int8_whole_triangle_reads_every_block_once(cuda, force_int8_tiles, tiles, B, nb, hb,
                                                    K):
    """The counting build copies each held block (i + d < nb) of a whole
    triangle once a pass, whatever the tiles; its results are the default
    build's, bit for bit."""
    from sgvamp_torch.ops.band_kernel import int8_block_bytes

    force_int8_tiles(tiles)
    upper, scales = _int8_blocks(K, nb, hb, B, nb + hb, cuda)
    x = torch.from_numpy(np.random.default_rng(hb).normal(size=(K, 2, nb * B))).to(
        cuda, torch.bfloat16)
    got = []
    n = int8_block_bytes(lambda: got.append(sym_band_matvec_int8(upper, scales, x)))
    assert n == K * sum(min(hb, nb - 1 - i) + 1 for i in range(nb)) * B * B
    assert torch.equal(got[0], sym_band_matvec_int8(upper, scales, x))


# The int8 kernel's lanes form (sym_band_matvec_int8_lanes, the route of
# SymBandedLD.matvec and shifted_matvec on the card): x f32 in the caller's
# (S, K, M) lanes, rounded to bf16 as the kernel loads it, y in the same
# layout, and A's shift gamw y + gam2 x where each row's sum becomes final
# (the kernel, fold_partials, or fold_tiles when the band is cut into J > 1
# ranges). Held bit for bit against the copied route over the same kernel
# (x cast and transposed to (K, S, M), y transposed back, the shift as torch
# ops), with x holding ties halfway between two bf16 values, subnormals,
# +-Inf and a NaN; a NaN must stay one.


def _copied_route(upper, scales, x, gamw=None, gam2=None):
    """The parent's expression: the kernel over x's bf16 copy in (K, S, M)."""
    K, M = upper.shape[0], x.shape[1]
    S = x.shape[0] // K
    xs = x.reshape(S, K, M).transpose(0, 1).to(torch.bfloat16).contiguous()
    y = sym_band_matvec_int8(upper, scales, xs).transpose(0, 1).reshape(x.shape)
    return y if gamw is None else gamw[:, None] * y + gam2[:, None] * x


def _same_bits(a, b):
    """NaN where the other has NaN, every other value bit for bit (the sign
    of a zero too)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.masked_fill(nan, 0).view(torch.int32), b.masked_fill(nan, 0).view(torch.int32))


def _lanes_x(S, K, M, seed, device, finite=False):
    """x (S*K, M) f32: normal values, a quarter of them moved to a tie
    halfway between two bf16 values, a twentieth f32 subnormals, and unless
    `finite` a NaN in lane 0 and +-Inf in the last lane."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S * K, M)).astype(np.float32)
    bits = x.view(np.uint32)
    tie = rng.random(size=x.shape) < 0.25
    bits[tie] = (bits[tie] & 0xFFFF0000) | 0x8000
    sub = rng.random(size=x.shape) < 0.05
    x[sub] = rng.choice(np.array([1e-40, -2.5e-39, 5.9e-39, -1e-45], np.float32), int(sub.sum()))
    if not finite:
        x[0, M // 3] = np.nan
        x[-1, M // 2], x[-1, M // 2 + 7] = np.inf, -np.inf
    return torch.from_numpy(x).to(device)


def _lanes_pass(upper, scales, x, *vecs):
    """One counted pass of the lanes form, held to the copied route."""
    before = [w.launches for w in BAND_KERNELS]
    got = sym_band_matvec_int8_lanes(upper, scales, x, *vecs)
    torch.cuda.synchronize()
    after = [w.launches for w in BAND_KERNELS]
    assert sum(after) == sum(before) + 1   # the kernel and its fold, counted once
    assert sym_band_matvec_int8.launches == before[BAND_KERNELS.index(sym_band_matvec_int8)] + 1
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _same_bits(got, _copied_route(upper, scales, x, *vecs))
    return got


@pytest.mark.parametrize("tiles", [(3, None), (5, None), (3, 2)], ids=_tiles_id)
@pytest.mark.parametrize("hb", [0, 2, 5])
@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("K", [1, 3])
def test_int8_lanes_form_equals_the_copied_route_bit_for_bit(cuda, force_int8_tiles, K, S, hb,
                                                             tiles):
    """nb = 13 block rows, not a multiple of G: runs of 3 (H = min(hb, 3)
    rows of each through fold_partials, the rest shifted in the kernel) and
    5, every diagonal in one range, or ranges of 2 (J = 2 at hb = 2, 3 at
    hb = 5: fold_tiles shifts every row); hb = 0 has no fold at all."""
    force_int8_tiles(tiles)
    B, nb = [64, 128, 256][(K + S + hb) % 3], 13
    upper, scales = _int8_blocks(K, nb, hb, B, K + S + hb, cuda)
    x = _lanes_x(S, K, nb * B, 10 * K + S + hb, cuda)
    g = torch.Generator(cuda).manual_seed(hb + S)
    gamw = torch.rand(S * K, generator=g, device=cuda) * 3 + 0.1
    gam2 = torch.rand(S * K, generator=g, device=cuda) * 50
    for vecs in ((), (gamw, gam2)):
        got = _lanes_pass(upper, scales, x, *vecs)
        assert torch.isnan(got[0]).any() and not torch.isnan(got[1:-1]).any()
        assert _same_bits(got, sym_band_matvec_int8_lanes(upper, scales, x, *vecs))  # no atomics


@pytest.mark.parametrize("K,nb", [(1, 4096), (8, 1024)], ids=["hm3half", "k8"])
def test_int8_lanes_form_at_the_cells_shapes(cuda, K, nb):
    """The wrapper's own tiles at B = 128, hb = 2 and 2K lanes: one cohort
    over M = 524288 and eight over M = 131072; the plain matvec and A's
    product, and x as a view 4 bytes off a 16-byte boundary (the wrapper
    copies it)."""
    upper, scales = _int8_blocks(K, nb, 2, 128, K + nb, cuda)
    x = _lanes_x(2, K, nb * 128, K, cuda)
    g = torch.Generator(cuda).manual_seed(K)
    gamw, gam2 = torch.rand(2 * K, generator=g, device=cuda), torch.rand(2 * K, generator=g,
                                                                          device=cuda)
    _lanes_pass(upper, scales, x)
    _lanes_pass(upper, scales, x, gamw, gam2)
    off = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape).copy_(x)
    assert off.data_ptr() % 16
    _lanes_pass(upper, scales, off, gamw, gam2)


@pytest.mark.parametrize("tiles", [None, (3, None), (3, 2)], ids=_tiles_id)
@pytest.mark.parametrize("hb", [2, 5])
@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("K", [1, 3])
def test_int8_lanes_form_matches_its_plain_version(cuda, force_int8_tiles, K, S, hb, tiles):
    """The lanes form against sym_band_matvec_int8_lanes_ref (the plain int8
    version over x's bf16 copy, then the shift in torch) at SCALED_TOL of
    max|plain|, with and without the shift, over finite x: the wrapper's own
    tiles, and forced ones with J = 1 and J > 1."""
    force_int8_tiles(tiles)
    B, nb = [64, 128, 256][(K + S + hb) % 3], 13
    upper, scales = _int8_blocks(K, nb, hb, B, 7 * K + S + hb, cuda)
    x = _lanes_x(S, K, nb * B, K + 3 * S + hb, cuda, finite=True)
    g = torch.Generator(cuda).manual_seed(hb + S)
    gamw = torch.rand(S * K, generator=g, device=cuda) * 3 + 0.1
    gam2 = torch.rand(S * K, generator=g, device=cuda) * 50
    for vecs in ((), (gamw, gam2)):
        got = sym_band_matvec_int8_lanes(upper, scales, x, *vecs)
        want = sym_band_matvec_int8_lanes_ref(upper, scales, x, *vecs)
        assert got.shape == want.shape and torch.isfinite(got).all()
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= SCALED_TOL, (vecs != (), err)


@pytest.mark.parametrize("method", ["matvec", "shifted_matvec"])
@pytest.mark.parametrize("how", ["resident", "rows_per_step"])
def test_int8_operator_refusals_hold_on_the_card(cuda, how, method):
    """On the card as on the CPU, an int8 operator has no resident kernel
    and its rows_per_step must divide nb and reach hb: matvec and
    shifted_matvec raise before the lanes form is chosen."""
    rng = np.random.default_rng(4)
    band, _, _ = simulate_ld_band(10000, 1024, 200, rng=rng)
    op = SymBandedLD.from_band(band, block_size=128, dtype="int8", device=cuda)
    op = (dataclasses.replace(op, mode="resident") if how == "resident"
          else dataclasses.replace(op, rows_per_step=3))
    x, v = torch.zeros(2, op.M, device=cuda), torch.ones(2, device=cuda)
    before = sym_band_matvec_int8.launches
    with pytest.raises(ValueError, match="resident" if how == "resident" else "divide"):
        op.matvec(x) if method == "matvec" else op.shifted_matvec(x, v, v)
    assert sym_band_matvec_int8.launches == before


def test_int8_lanes_form_rejects_bad_input(cuda):
    upper, scales = _int8_blocks(2, 5, 2, 64, 3, cuda)
    x = torch.zeros(4, 5 * 64, device=cuda)
    v = torch.ones(4, device=cuda)
    for args in [(x.double(),), (x[:3],), (x[:, :-64],), (x, v), (x, v, v[:2]),
                 (x, v, v.double()), (x, v, v.cpu())]:
        with pytest.raises(ValueError):
            sym_band_matvec_int8_lanes(upper, scales, *args)


# The float diag kernel over tiles of the band (csrc/sym_band_float.cu's
# matvec form, whose (G, D) ops/band_kernel.py::_float_tiles picks): whole
# triangles and a ragged band, at the rule's own tiles and at forced ones, in
# bfloat16, float32 and float64 blocks, against the plain version (f64:
# 1e-12), the same bits on a repeat.
FLOAT_TOL = {"bfloat16": SCALED_TOL, "float32": SCALED_TOL, "float64": 1e-12}


@pytest.fixture
def force_float_tiles():
    """force(tiles): until the test ends the float diag wrappers take tiles
    (G, D) (D None: every diagonal; utils/kernel_diag.py::forced_float_tiles),
    or their own choice for None."""
    from sgvamp_torch.utils.kernel_diag import forced_float_tiles

    with contextlib.ExitStack() as stack:
        yield lambda tiles: tiles is None or stack.enter_context(forced_float_tiles(*tiles))


def _float_pass(upper, x):
    """One counted pass of the float diag matvec kernel, its scaled error
    against the plain version, and a second pass that must give its bits."""
    before = [w.launches for w in BAND_KERNELS]
    y = sym_band_matvec(upper, x)
    torch.cuda.synchronize()
    after = [w.launches for w in BAND_KERNELS]
    assert sum(after) == sum(before) + 1   # the kernel and its fold, counted once
    assert sym_band_matvec.launches == before[BAND_KERNELS.index(sym_band_matvec)] + 1
    want = sym_band_matvec_ref(upper, x)
    assert y.dtype == want.dtype and y.shape == want.shape
    assert torch.equal(y, sym_band_matvec(upper, x))  # no atomics
    return float((y - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("S", range(1, 5))
@pytest.mark.parametrize("wider", [0, 1], ids=["hb=nb-1", "hb=nb"])
@pytest.mark.parametrize("B", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
def test_float_kernel_on_whole_triangle_matches_plain(cuda, force_float_tiles, dtype, B, wider,
                                                      S):
    """A whole triangle (nb=16), K 1 or 2, with tiles that vary with the
    case: the rule's own, one diagonal a tile, every diagonal."""
    force_float_tiles([None, (1, 1), (2, 3), (8, 2), (3, None)][(B // 64 + S + wider) % 5])
    nb = 16
    hb, K = nb - 1 + wider, 1 + S % 2
    upper = _random_blocks("diag", dtype, K, nb, hb, B, B + nb + hb + S, cuda)
    x = torch.from_numpy(np.random.default_rng(nb + S).normal(size=(K, S, nb * B))).to(
        cuda, upper.dtype)
    err = _float_pass(upper, x)
    assert err <= FLOAT_TOL[dtype], err


@pytest.mark.parametrize("tiles", [None, (1, 1), (1, None), (8, 1), (8, 3), (3, 2), (5, 7),
                                   (2, None), (4, 2)], ids=_tiles_id)
@pytest.mark.parametrize("B,hb,nb,K,S", [
    (64, 15, 16, 2, 1),     # whole triangles
    (128, 13, 13, 1, 2),
    (256, 9, 9, 2, 3),
    (128, 16, 37, 2, 4),    # a band, ragged: the last run is short
    (64, 2, 11, 3, 2),      # K=3
    (128, 0, 9, 2, 2),      # hb=0: one range whatever is forced
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
def test_float_kernel_forced_tiles_match_plain(cuda, force_float_tiles, dtype, tiles, B, hb, nb,
                                               K, S):
    force_float_tiles(tiles)
    upper = _random_blocks("diag", dtype, K, nb, hb, B, B + 3 * hb + nb, cuda)
    x = torch.from_numpy(np.random.default_rng(hb + S).normal(size=(K, S, nb * B))).to(
        cuda, upper.dtype)
    err = _float_pass(upper, x)
    assert err <= FLOAT_TOL[dtype], err


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
def test_float_kernel_on_a_dense_panel_triangle_matches_plain(cuda, dtype):
    """Row 1g's shape, a dense M=8192 panel's whole triangle at B=128 (nb=64,
    hb=64, K=2, S=2), with the rule's own tiles, (1, 2) on an H100."""
    from sgvamp_torch.ops.band_kernel import _float_tiles, _sm_count

    nb = hb = 64
    if _sm_count(cuda) == 132:
        assert _float_tiles(nb, hb, 132) == (1, 2)
    upper = _random_blocks("diag", dtype, 2, nb, hb, 128, 64, cuda)
    x = torch.from_numpy(np.random.default_rng(64).normal(size=(2, 2, nb * 128))).to(
        cuda, upper.dtype)
    err = _float_pass(upper, x)
    assert err <= FLOAT_TOL[dtype], err


@pytest.mark.parametrize("tiles", [(1, 1), (1, None)], ids=_tiles_id)
@pytest.mark.parametrize("dtype", ["bfloat16", "float64"])
def test_float_tiled_kernel_refuses_unaligned_upper(cuda, force_float_tiles, dtype, tiles):
    """Blocks that start off a 16-byte boundary are refused with
    cudaErrorMisalignedAddress (716), nothing launched, whether the tiles cut
    the diagonals (J = 2) or not."""
    force_float_tiles(tiles)
    upper = _random_blocks("diag", dtype, 1, 4, 1, 64, 0, cuda)
    off = torch.empty(upper.numel() + 1, dtype=upper.dtype, device=cuda)[1:].view(upper.shape)
    off.copy_(upper)
    assert off.is_contiguous() and off.data_ptr() % 16
    x = torch.zeros((1, 2, 4 * 64), dtype=upper.dtype, device=cuda)
    before = sym_band_matvec.launches
    with pytest.raises(RuntimeError, match=r"\(error 716\)"):
        sym_band_matvec(off, x)
    assert sym_band_matvec.launches == before


# The streamed slab kernel over tiles of the band (csrc/sym_slab_streamed.cu's
# matvec form, whose (G, D) ops/band_kernel.py::_slab_tiles picks): whole
# triangles and a ragged band, at the rule's own tiles and at forced ones
# (utils/kernel_diag.py::forced_slab_tiles), in bfloat16, float32 and float64
# slabs, against the plain version (f64: 1e-12), the same bits on a repeat.
@pytest.fixture
def force_slab_tiles():
    """force(tiles): until the test ends the streamed slab wrappers take
    tiles (G, D) (D None: every diagonal), or their own choice for None."""
    from sgvamp_torch.utils.kernel_diag import forced_slab_tiles

    with contextlib.ExitStack() as stack:
        yield lambda tiles: tiles is None or stack.enter_context(forced_slab_tiles(*tiles))


def _slab_pass(upper, x, rows_per_step=0):
    """One counted pass of the streamed slab matvec kernel, its scaled error
    against the plain version, and a second pass that must give its bits."""
    before = [w.launches for w in BAND_KERNELS]
    y = sym_slab_matvec_streamed(upper, rows_per_step, x)
    torch.cuda.synchronize()
    after = [w.launches for w in BAND_KERNELS]
    assert sum(after) == sum(before) + 1   # the kernel and its fold, counted once
    assert sym_slab_matvec_streamed.launches == before[
        BAND_KERNELS.index(sym_slab_matvec_streamed)] + 1
    want = sym_slab_matvec_streamed_ref(upper, rows_per_step, x)
    assert y.dtype == want.dtype and y.shape == want.shape
    assert torch.equal(y, sym_slab_matvec_streamed(upper, rows_per_step, x))  # no atomics
    return float((y - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("S", range(1, 5))
@pytest.mark.parametrize("nb", [16, 64])
@pytest.mark.parametrize("B", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
def test_slab_kernel_on_whole_triangle_matches_plain(cuda, force_slab_tiles, dtype, B, nb, S):
    """A whole triangle (hb = nb - 1 or nb as S is odd or even), K 1 or 2,
    with tiles that vary with the case: the rule's own, one diagonal a tile,
    every diagonal where the window fits (nb=16)."""
    tiles = [None, (1, 1), (2, 3), (8, 2), (3, None) if nb == 16 else (4, 5)]
    force_slab_tiles(tiles[(B // 64 + S + nb) % 5])
    hb, K = nb - S % 2, 1 + (S % 2 if nb == 16 else 0)
    upper = _random_blocks("slab", dtype, K, nb, hb, B, B + nb + hb + S, cuda)
    x = torch.from_numpy(np.random.default_rng(nb + S).normal(size=(K, S, nb * B))).to(
        cuda, upper.dtype)
    err = _slab_pass(upper, x)
    assert err <= FLOAT_TOL[dtype], err


@pytest.mark.parametrize("tiles", [None, (1, 1), (1, None), (8, 1), (8, 3), (3, 2), (5, 7),
                                   (2, None), (4, 2)], ids=_tiles_id)
@pytest.mark.parametrize("B,hb,nb,K,S", [
    (64, 15, 16, 2, 1),     # whole triangles
    (128, 13, 13, 1, 2),
    (256, 9, 9, 2, 3),
    (128, 16, 37, 2, 4),    # a band, ragged: the last run is short
    (64, 2, 11, 3, 2),      # K=3
    (128, 0, 9, 2, 2),      # hb=0: one range whatever is forced
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
def test_slab_kernel_forced_tiles_match_plain(cuda, force_slab_tiles, dtype, tiles, B, hb, nb,
                                              K, S):
    force_slab_tiles(tiles)
    upper = _random_blocks("slab", dtype, K, nb, hb, B, B + 3 * hb + nb, cuda)
    x = torch.from_numpy(np.random.default_rng(hb + S).normal(size=(K, S, nb * B))).to(
        cuda, upper.dtype)
    err = _slab_pass(upper, x)
    assert err <= FLOAT_TOL[dtype], err


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
def test_slab_kernel_on_a_dense_panel_triangle_matches_plain(cuda, dtype):
    """Row 2g's shape, a dense M=8192 panel's whole triangle at B=128 (nb=64,
    hb=64, K=2, S=2), with the rule's own tiles, (1, 2) on an H100. Before
    tiles the wrapper refused float64 slabs there: one block row's x window
    did not fit a CTA."""
    from sgvamp_torch.ops.band_kernel import _slab_tiles, _sm_count

    nb = hb = 64
    if _sm_count(cuda) == 132:
        nbytes = {"bfloat16": 2, "float32": 4, "float64": 8}[dtype]
        assert _slab_tiles(nb, hb, 132, 2, 128, nbytes) == (1, 2)
    upper = _random_blocks("slab", dtype, 2, nb, hb, 128, 64, cuda)
    x = torch.from_numpy(np.random.default_rng(64).normal(size=(2, 2, nb * 128))).to(
        cuda, upper.dtype)
    err = _slab_pass(upper, x)
    assert err <= FLOAT_TOL[dtype], err


@pytest.mark.parametrize("dtype", ["bfloat16", "float64"])
def test_slab_spill_kernel_in_runs_of_16_matches_plain(cuda, dtype):
    """rows_per_step=16 gives the spill form runs of 16 block rows (the
    kernel's 16-warp instance; the matvec form's runs stay within 8): two
    shards of 32 block rows, each against its plain version, composed
    against the whole operator, the same bits on a repeat."""
    from sgvamp_torch.ops.band_kernel import _slab_runs

    B, hb, nb, S = 128, 3, 64, 2
    assert _slab_runs(hb, S, B, 8 if dtype == "float64" else 2, 16) == 16
    upper = _random_blocks("slab", dtype, 1, nb, hb, B, 16, cuda)
    x = torch.from_numpy(np.random.default_rng(16).normal(size=(1, S, nb * B))).to(
        cuda, upper.dtype)
    want = sym_slab_matvec_streamed_ref(upper, 16, x)
    scale, tol = float(want.abs().max()), FLOAT_TOL[dtype]
    nb_l, hbB = nb // 2, hb * B
    xpad = torch.cat([x, x.new_zeros(1, S, hbB)], dim=2)
    ys, carry = [], None
    for j in range(2):
        piece = upper[:, j * nb_l:(j + 1) * nb_l].contiguous()
        x_ext = xpad[:, :, j * nb_l * B:((j + 1) * nb_l + hb) * B].contiguous()
        before = sym_slab_matvec_streamed_spill.launches
        y_l, spilled = sym_slab_matvec_streamed_spill(piece, 16, x_ext)
        torch.cuda.synchronize()
        assert sym_slab_matvec_streamed_spill.launches == before + 1
        py, pc = sym_slab_matvec_streamed_spill_ref(piece, 16, x_ext)
        assert float((y_l - py).abs().max()) / scale <= tol
        assert float((spilled - pc).abs().max()) / scale <= tol
        y2, c2 = sym_slab_matvec_streamed_spill(piece, 16, x_ext)
        assert torch.equal(y_l, y2) and torch.equal(spilled, c2)
        if j:
            y_l[:, :, :hbB] += carry
        carry = spilled
        ys.append(y_l)
    assert float(carry.abs().max()) == 0.0
    assert float((torch.cat(ys, dim=2) - want).abs().max()) / scale <= tol


@pytest.mark.parametrize("tiles", [(1, 1), (1, None)], ids=_tiles_id)
@pytest.mark.parametrize("dtype", ["bfloat16", "float64"])
def test_slab_tiled_kernel_refuses_unaligned_upper(cuda, force_slab_tiles, dtype, tiles):
    """Slabs that start off a 16-byte boundary are refused with
    cudaErrorMisalignedAddress (716), nothing launched, whether the tiles cut
    the diagonals (J = 2) or not."""
    force_slab_tiles(tiles)
    upper = _random_blocks("slab", dtype, 1, 4, 1, 64, 0, cuda)
    off = torch.empty(upper.numel() + 1, dtype=upper.dtype, device=cuda)[1:].view(upper.shape)
    off.copy_(upper)
    assert off.is_contiguous() and off.data_ptr() % 16
    x = torch.zeros((1, 2, 4 * 64), dtype=upper.dtype, device=cuda)
    before = sym_slab_matvec_streamed.launches
    with pytest.raises(RuntimeError, match=r"\(error 716\)"):
        sym_slab_matvec_streamed(off, 0, x)
    assert sym_slab_matvec_streamed.launches == before


@pytest.mark.parametrize("spill", [False, True], ids=["matvec", "spill"])
def test_int8_kernel_refuses_unaligned_upper(cuda, spill):
    """The walker reads the blocks 16 bytes at a time: blocks that start off
    a 16-byte boundary are refused with cudaErrorMisalignedAddress (716)
    and nothing is launched. scales and x are read a value at a time and
    need no alignment."""
    B, hb, nb = 64, 1, 4
    upper, scales = _int8_blocks(1, nb, hb, B, 0, cuda)
    off = torch.empty(upper.numel() + 1, dtype=upper.dtype, device=cuda)[1:].view(upper.shape)
    off.copy_(upper)
    assert off.is_contiguous() and off.data_ptr() % 16
    x = torch.zeros((1, 2, (nb + (hb if spill else 0)) * B), dtype=torch.bfloat16, device=cuda)
    kernel = sym_band_matvec_int8_spill if spill else sym_band_matvec_int8
    before = kernel.launches
    with pytest.raises(RuntimeError, match=r"\(error 716\)"):
        kernel(off, scales, x)
    assert kernel.launches == before
    xo = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape)
    xo.copy_(torch.ones_like(x))
    so = torch.empty(scales.numel() + 1, dtype=scales.dtype, device=cuda)[1:].view(scales.shape)
    so.copy_(scales)
    got = kernel(upper, so, xo)
    plain = sym_band_matvec_int8_spill_ref if spill else sym_band_matvec_int8_ref
    want = plain(upper, so, xo)
    got, want = (got, want) if spill else ((got,), (want,))
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= SCALED_TOL * float(want[0].abs().max())


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


# ---------------------------------------------------------------------------
# fused runs: the VAMP step replayed as CUDA graphs
# ---------------------------------------------------------------------------

def _fused_engine(device, force: bool, mesh: bool, update: str = "em"):
    """An int8 engine at M=4096 (hb=2): the bench's fixed CG budget, or the
    CLI's solve to rtol 1e-5 with the block-Jacobi preconditioner; under a
    (1, 2) mesh whose cells are this card; the prior learned by `update`."""
    from sgvamp_torch import PriorState, VampConfig, VampEngine, VampInputs
    from sgvamp_torch.parallel.sharding import make_mesh

    M, N = 4096, 300000
    band, r, _ = simulate_ld_band(N, M, 256, h2=0.7, lam=0.01, rng=np.random.default_rng(5))
    op = SymBandedLD.from_band(band, block_size=128, dtype="int8", device=device)
    cfg = VampConfig(prior_update=update, dtype="float32", cg_maxit=20 if force else 500,
                     cg_force_maxiter=force, cg_precond_block=0 if force else 64,
                     em_prior_maxit=5 if force else 100, rho=0.5, lmmse_damp=True)
    inputs = VampInputs(op=op, r=torch.as_tensor(r[None], dtype=torch.float32, device=device),
                        a=torch.ones(1, device=device),
                        N=torch.full((1,), float(N), device=device))
    return VampEngine(inputs, cfg, PriorState.create(0.01, [1.0], [0.7 / 40 * N], device=device),
                      mesh=make_mesh(1, 2, devices=[device] * 2) if mesh else None)


@pytest.mark.parametrize("force,mesh", [(True, False), (False, False), (True, True)],
                         ids=["fixed-budget", "solve", "fixed-budget-mesh"])
def test_fused_replay_matches_eager_steps_bit_for_bit(cuda, force, mesh):
    engine = _fused_engine(cuda, force, mesh)
    hist = engine.run(4, seed=1)
    state, aux = engine.run_scan(4, seed=1)
    assert len(engine.fused.captured) >= 2   # the graphs of it 0 and of it > 0
    for it in range(4):
        assert torch.equal(aux.xhat1[it].cpu(), torch.from_numpy(hist["xhat1"][it])), it
        params = np.asarray(hist["params"][it])
        assert np.array_equal(aux.gamw[it].cpu().numpy(), params[:, 1].astype(np.float32))
        assert np.array_equal(aux.gam1[it].cpu().numpy(), params[:, 2].astype(np.float32))
    for f in ("xhat1", "r1", "xhat2", "sigma2_u", "gamw", "gam1"):
        assert torch.equal(getattr(state, f), getattr(hist["state"], f)), f
    # the replays launched the kernel once per LD pass, nothing else
    own = "sym_band_matvec_int8_spill" if mesh else "sym_band_matvec_int8"
    passes = int(aux.cg_passes.sum()) + 2 * 4
    assert engine.fused.launches() == {own: passes * (2 if mesh else 1)}


@pytest.mark.parametrize("mesh", [False, True], ids=["unsharded", "mesh"])
def test_fused_int8_step_takes_the_lanes_form(cuda, mesh):
    """Every LD pass of the fused int8 step over one card (CG's A p and the
    gamw pass) takes the kernel's lanes form: ld_passes.copied reads 0 (the
    counters count at capture); under a mesh every pass takes the spill
    form over copied lanes."""
    engine = _fused_engine(cuda, True, mesh)
    profiling.reset()
    engine.run_scan(2, seed=1)
    counts = profiling.snapshot()["counts"]
    taken, other = ("ld_passes.copied", "ld_passes.in_place") if mesh else (
        "ld_passes.in_place", "ld_passes.copied")
    assert counts.get(taken, 0) > 0 and counts.get(other, 0) == 0, counts


def test_fused_step_refuses_a_host_read_during_capture(cuda, monkeypatch):
    """A host read inside the step cannot be captured: the run raises, and
    no step runs eagerly in its place (the piece that reads, the part after
    CG, has no graph; the pieces before it were captured)."""
    from sgvamp_torch.core import vamp

    engine = _fused_engine(cuda, True, False)
    rowdot = vamp.rowdot

    def reads_the_host(x, y):
        return rowdot(x, y) + 0.0 * float(x.sum())

    monkeypatch.setattr(vamp, "rowdot", reads_the_host)
    with pytest.raises(RuntimeError):
        engine.run_scan(2)
    assert sorted(p for _, p in engine.fused.captured) == ["before_cg", "cg"]


@pytest.mark.parametrize("force", [True, False], ids=["fixed-budget", "solve"])
def test_fused_replay_with_mle_matches_eager_steps_bit_for_bit(cuda, force):
    """Under MLE the graphs replay the Newton solve's pieces: every
    iteration, the learned prior and its warm start equal the host loop's."""
    engine = _fused_engine(cuda, force, False, update="mle")
    hist = engine.run(4, seed=1)
    state, aux = engine.run_scan(4, seed=1)
    assert any(k[1] == "mle" for k, _ in engine.fused.captured)
    for it in range(4):
        assert torch.equal(aux.xhat1[it].cpu(), torch.from_numpy(hist["xhat1"][it])), it
        params = np.asarray(hist["params"][it])
        assert np.array_equal(aux.gam1[it].cpu().numpy(), params[:, 2].astype(np.float32))
        assert np.array_equal(aux.lam[it].cpu().numpy(), np.float32(params[0, 6]))
    for f in ("lam", "omegas", "mle_gam", "mle_gam_valid", "mle_last_ok"):
        assert torch.equal(getattr(state.prior, f), getattr(hist["state"].prior, f)), f
    assert bool(aux.mle_ok[1:].all()) and bool(state.prior.mle_gam_valid)
    assert engine.fused.reads["mle"] >= 3


def _graph(fn, mutates=()):
    """fn captured into a CUDA graph after a warm-up on a side stream whose
    writes to `mutates` are undone."""
    saved = [t.clone() for t in mutates]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    for t, v in zip(mutates, saved):
        t.copy_(v)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def _mle_inputs(case, device):
    """A VAMP-like state (K=2, M=300, L=2; r1 = x + noise at precision gam1)
    or tests/test_prior.py's singular one (two identical slab components),
    in float64 on `device`."""
    from sgvamp_torch.core.prior import PriorState

    rng = np.random.default_rng(3 if case == "singular" else 1)
    if case == "singular":
        r1s, gam1s, a = rng.normal(size=(1, 200)) * 2.0, [1.0], [1.0]
        lam, omegas, sigmas = 0.3, [0.5, 0.5], [1.0, 1.0]
    else:
        x = np.where(rng.random(300) < 0.2, rng.normal(0, 1.0, 300), 0.0)
        gam1s = rng.uniform(0.5, 2.0, 2)
        r1s = x[None, :] + rng.normal(size=(2, 300)) / np.sqrt(gam1s)[:, None]
        a, lam, omegas, sigmas = [0.5, 0.5], 0.25, [1.0], [1.0]
    t = [torch.as_tensor(np.asarray(v, np.float64), device=device) for v in (r1s, gam1s, a)]
    return t, PriorState.create(lam, omegas, sigmas, device=device)


@pytest.mark.parametrize("case", ["panel", "singular"])
def test_mle_pieces_in_graphs_equal_the_eager_loop(cuda, case):
    """mle_init and mle_chunk captured into graphs and replayed until the
    device flag says finished give the eager mle_update's bits; the solve
    reads nothing back to the host inside a piece (a read would make the
    capture raise)."""
    from sgvamp_torch.core import prior as tprior

    (r1s, gam1s, a), prior = _mle_inputs(case, cuda)
    maxit = 60
    want = tprior.mle_update(r1s, gam1s, a, prior, maxit=maxit)
    P = {}

    def begin():
        P["pb"], P["c"] = tprior.mle_init(r1s, gam1s, a, prior)

    def chunk():
        new = tprior.mle_chunk(P["c"], P["pb"], maxit, 1e-10, tprior.MLE_CHUNK)
        for dst, v in zip(P["c"], new):
            dst.copy_(v)

    g_begin = _graph(begin)
    g_chunk = _graph(chunk, list(P["c"]))
    g_begin.replay()
    while True:
        g_chunk.replay()
        if bool(tprior.mle_finished(P["c"], maxit)):
            break
    got = tprior.mle_result(P["pb"], P["c"], prior)
    for f in ("lam", "omegas", "mle_gam", "mle_gam_valid", "mle_last_ok"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert bool(got.mle_last_ok) == (case == "panel")
    assert bool(torch.isfinite(P["c"].x).all())


# ---------------------------------------------------------------------------
# BlockSparseLD and runs over a process group (a group of one over NCCL)
# ---------------------------------------------------------------------------

def _blocksparse_csr(M, seed):
    """A banded panel as a CSR matrix plus symmetric long-range entries (a
    block row i paired with i + nb/2 every 4 block rows, B=128)."""
    import scipy.sparse

    from sgvamp_torch.core.operators import BandedLD

    band, r, _ = simulate_ld_band(20000, M, 200, h2=0.7, lam=0.02,
                                  rng=np.random.default_rng(seed), dtype=np.float64)
    R = BandedLD.from_band(band, block_size=128, device="cpu").to_dense()[0].numpy()[:M, :M]
    nb = M // 128
    for i in range(0, nb // 2, 4):
        a, b = i * 128 + 3, (i + nb // 2) * 128 + 5
        R[a, b] = R[b, a] = 0.01
    return scipy.sparse.csr_matrix(R), r


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 2])
def test_blocksparse_matvec_on_the_card_matches_the_cpu(cuda, dtype, S):
    from sgvamp_torch.core.operators import BlockSparseLD

    R, _ = _blocksparse_csr(2048, 3)
    on_card = BlockSparseLD.from_csr([R, R * 0.5], block_size=128, s=0.05, dtype=dtype,
                                     device=cuda)
    f64 = BlockSparseLD.from_csr([R, R * 0.5], block_size=128, s=0.05, device="cpu")
    x = torch.from_numpy(np.random.default_rng(S).normal(size=(2 * S, on_card.M)))
    xt = x.to(cuda, torch.float64 if dtype == "float64" else torch.float32)
    y = on_card.matvec(xt)
    # the f64 product of what the blocks hold and x as they see it
    xr = x.to(on_card.blocks.dtype).double()
    blocks = on_card.blocks.cpu().double()
    want = BlockSparseLD(blocks=blocks, rows=f64.rows, cols=f64.cols, nb=f64.nb).matvec(
        xr) * 0.95 + 0.05 * x
    err = float((y.cpu().double() - want).abs().max() / want.abs().max())
    assert err <= (1e-12 if dtype == "float64" else SCALED_TOL), err
    # no atomics: the same bits on a repeat
    assert torch.equal(on_card.matvec(xt), y)


def test_blocksparse_float32_products_stay_ieee_under_a_callers_tf32(cuda):
    """A caller that allows TF32 gets the IEEE float32 product all the
    same, and its setting back."""
    from sgvamp_torch.core.operators import BlockSparseLD

    R, _ = _blocksparse_csr(2048, 3)
    op = BlockSparseLD.from_csr([R], block_size=128, dtype="float32", device=cuda)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, op.M))).to(cuda,
                                                                             torch.float32)
    m = torch.backends.cuda.matmul
    m.fp32_precision = "ieee"
    want = op.matvec(x)
    try:
        m.fp32_precision = "tf32"
        got = op.matvec(x)
        assert m.fp32_precision == "tf32"
    finally:
        m.fp32_precision = "ieee"
    assert torch.equal(got, want)


def test_dryrun_multichip_on_the_card(cuda, capsys):
    """The dry run with its default devices: the six operators over a
    (2, 2) mesh of the card, the sym ones through their spill kernels."""
    from sgvamp_torch.dryrun import OPERATORS, dryrun_multichip

    for w in BAND_KERNELS:
        w.launches = 0
    dryrun_multichip(4)
    ok = [ln for ln in capsys.readouterr().out.splitlines() if "device=cuda parity ok" in ln]
    assert len(ok) == len(OPERATORS)
    launched = {w.__name__ for w in BAND_KERNELS if w.launches}
    assert {"sym_band_matvec_int8_spill", "sym_band_matvec_int4_spill",
            "sym_band_matvec_hybrid_spill"} <= launched, launched


def _blocksparse_engine(device):
    from sgvamp_torch import PriorState, VampConfig, VampEngine, VampInputs
    from sgvamp_torch.core.operators import BlockSparseLD

    R, r = _blocksparse_csr(4096, 5)
    op = BlockSparseLD.from_csr([R], block_size=128, dtype="bfloat16", device=device)
    cfg = VampConfig(prior_update="em", dtype="float32", cg_maxit=500, cg_precond_block=64,
                     rho=0.5, lmmse_damp=True)
    N = 20000
    inputs = VampInputs(op=op, r=torch.as_tensor(r[None], dtype=torch.float32, device=device),
                        a=torch.ones(1, device=device), N=torch.full((1,), float(N), device=device))
    return VampEngine(inputs, cfg, PriorState.create(0.02, [1.0], [0.7 / 80 * N], device=device))


def test_blocksparse_fused_run_matches_the_host_loop_bit_for_bit(cuda):
    engine = _blocksparse_engine(cuda)
    hist = engine.run(4, seed=2)
    state, aux = engine.run_scan(4, seed=2)
    for it in range(4):
        assert torch.equal(aux.xhat1[it].cpu(), torch.from_numpy(hist["xhat1"][it])), it
        assert np.array_equal(aux.gam1[it].cpu().numpy(),
                              np.asarray(hist["params"][it])[:, 2].astype(np.float32))
    for f in ("xhat1", "r1", "xhat2", "sigma2_u", "gamw", "gam1"):
        assert torch.equal(getattr(state, f), getattr(hist["state"], f)), f


@pytest.mark.parametrize("fused", ["0", "1"])
def test_process_group_of_one_over_nccl_writes_the_plain_run_s_files(cuda, tmp_path, fused,
                                                                     caplog):
    import os
    import socket

    import torch.distributed as dist

    from sgvamp_torch.cli import main as cli
    from sgvamp_torch.cli import simulate

    if not dist.is_nccl_available():
        pytest.skip("this PyTorch has no NCCL")
    assert simulate.main(["gen-band", "--out", str(tmp_path / "p"), "--N", "20000", "--M",
                          "4096", "--h2", "0.7", "--lam", "0.02", "--bandwidth", "200",
                          "--seed", "3"]) == 0
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    def run(out, *extra):
        assert cli.main(["--ld-files", str(tmp_path / "p_R.npz"), "--r-files",
                         str(tmp_path / "p_r.npy"), "--true-signal-file",
                         str(tmp_path / "p_bet.npy"), "--out-dir", str(out), "--out-name", "g",
                         "--N", "20000", "--M", "4096", "--iterations", "4", "--operator",
                         "sym", "--ld-dtype", "int8", "--block-size", "128",
                         "--cg-precond-block", "64", "--fused", fused, *extra]) == 0
        return {n: (out / n).read_bytes() for n in sorted(os.listdir(out))}

    plain = run(tmp_path / "plain")
    with caplog.at_level("INFO", logger="sgvamp"):
        group = run(tmp_path / "group", "--coordinator-address", f"localhost:{port}",
                    "--num-processes", "1", "--process-id", "0")
    assert any("over the NCCL backend" in m for m in caplog.messages)
    assert not dist.is_initialized()   # main left the group it made
    assert sorted(group) == sorted(plain) and "g_xhat_it_3.bin" in plain
    for name in plain:
        assert group[name] == plain[name], name


# the trace of --profile-dir: the kernels loaded through ctypes appear as CUDA
# kernel events under their __global__ names (band_kernel.TRACED_KERNELS), one
# a launch
TRACED = {"hybrid": ("sym_band_matvec_hybrid", {"hybrid": 1}),
          "int8": ("sym_band_matvec_int8", {"int8": 1, "fold": 1})}


@pytest.mark.parametrize("ld_dtype", ["hybrid", "int8"])
@pytest.mark.parametrize("fused", ["0", "1"])
def test_profile_dir_traces_every_launch(cuda, tmp_path, fused, ld_dtype):
    """cli.main --profile-dir on the card: one trace, whose kernel events of
    the storage's kernel equal the run's launches (the wrappers' eager
    counts, a fused run's warm-ups included, plus its graph replays from the
    tracer's counter "graph_launches.<wrapper>"; an int8 pass is the kernel
    and its fold), no other band kernel; the files equal the run's without
    the flag."""
    import glob
    import json
    import os

    from sgvamp_torch.cli import main as cli
    from sgvamp_torch.cli import simulate

    assert simulate.main(["gen-band", "--out", str(tmp_path / "p"), "--N", "20000", "--M",
                          "4096", "--h2", "0.7", "--lam", "0.02", "--bandwidth", "200",
                          "--seed", "3"]) == 0

    def run(out, *extra):
        assert cli.main(["--ld-files", str(tmp_path / "p_R.npz"), "--r-files",
                         str(tmp_path / "p_r.npy"), "--true-signal-file",
                         str(tmp_path / "p_bet.npy"), "--out-dir", str(out), "--out-name", "g",
                         "--N", "20000", "--M", "4096", "--iterations", "4", "--operator",
                         "sym", "--ld-dtype", ld_dtype, "--block-size", "128",
                         "--cg-precond-block", "64", "--fused", fused, *extra]) == 0
        return {n: (out / n).read_bytes() for n in sorted(os.listdir(out))}

    wrapper = next(w for w in BAND_KERNELS if w.__name__ == TRACED[ld_dtype][0])
    plain = run(tmp_path / "plain")
    before = wrapper.launches
    profiling.reset()
    traced = run(tmp_path / "traced", "--profile-dir", str(tmp_path / "prof"))
    launches = (wrapper.launches - before
                + profiling.snapshot()["counts"].get(f"graph_launches.{wrapper.__name__}", 0))
    assert traced == plain and launches > 0
    (trace,) = glob.glob(str(tmp_path / "prof" / "process0.*.pt.trace.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    counts = traced_kernel_counts(e["name"] for e in kernels)
    # an eager launch runs one kernel under its own correlation; a graph
    # launch runs all of its graph's kernels under the graph launch's
    stamp = {e["args"]["correlation"]: e["ts"] for e in kernels}
    want = {k: TRACED[ld_dtype][1].get(k, 0) * launches for k in counts}
    # a kernel's stamp against its launch's, on the trace's clock: the
    # offset device_trace's padded window must cover
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"
               and e["name"] in ("cudaLaunchKernel", "cudaLaunchKernelExC")]
    offsets = [stamp[e["args"]["correlation"]] - e["ts"] for e in runtime
               if e["args"]["correlation"] in stamp]
    unmatched = len(runtime) - len(offsets)
    graphs = {e["args"]["correlation"] for e in events
              if e.get("cat") == "cuda_runtime" and e["name"] == "cudaGraphLaunch"}
    print(f"[trace] --fused {fused} {ld_dtype}: {counts} for {launches} launches; "
          f"{len(offsets)} kernel launches, {unmatched} without a kernel event; kernel "
          f"stamp - launch stamp min {min(offsets):.0f} us, median "
          f"{sorted(offsets)[len(offsets) // 2]:.0f} us; {len(graphs)} graph launches, "
          f"{sum(e['args']['correlation'] in graphs for e in kernels)} kernels from them")
    assert counts == want, (counts, launches)
    assert min(offsets) > -TRACE_PAD_S * 1e6
    if fused == "0":   # a capture's launches run no kernel; eager ones each run one
        assert unmatched == 0


# the tracer's spans on the card (sgvamp_torch/utils/profiling.py): a fused
# run traced by torch.profiler after an untraced one that captured the
# graphs, the probes handed in as numpy rows (their copy from pageable memory
# blocks) and EM from step 1 (a blocking read of its flag a chunk)
RUNTIME = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch", "cudaMemcpyAsync",
           "cudaMemsetAsync")


def _traced_fused_run(cuda, steps=4):
    """(the tracer's snapshot, the device operations as (start ns, end ns,
    name, host ns of their launch)) of a traced run_scan."""
    import time

    from torch.profiler import ProfilerActivity, profile

    engine = _fused_engine(cuda, True, False)
    u = np.where(np.random.default_rng(7).random((steps, 1, engine.inputs.r.shape[1])) < 0.5,
                 -1.0, 1.0).astype(np.float32)
    engine.run_scan(steps, fixed_u=u)
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        engine.run_scan(steps, fixed_u=u)
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    snap = profiling.snapshot()
    launched, ops = {}, []
    events = prof.profiler.kineto_results.events()
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU and e.name() in RUNTIME:
            launched[e.correlation_id()] = e.start_ns()
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CPU and not e.is_user_annotation():
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                        launched.get(e.correlation_id())))
    assert ops and all(op[3] is not None for op in ops), [op for op in ops if op[3] is None][:5]
    return snap, sorted(ops)


def _busy_ns(ops):
    busy, edge = 0, None
    for s, t, *_ in sorted(ops):
        if edge is None or s > edge:
            busy, edge = busy + t - s, t
        elif t > edge:
            busy, edge = busy + t - edge, t
    return busy


def test_traced_fused_pieces_add_up_to_the_busy_time(cuda):
    """The four pieces' device ms (benchmark/metrics: the busy time of the
    trace's device operations inside each piece's device interval, its CUDA
    events placed on the host's clock) and the work outside the pieces (the
    probes' copies, the aux rows, the fit's loads) add up to the run's busy
    time; the operations launched inside a piece's span lie inside its
    device interval, up to the placement's error (printed)."""
    from benchmark import harness

    steps = 4
    snap, ops = _traced_fused_run(cuda, steps)
    pieces = [s for s in snap["spans"] if s["name"].startswith("sgv.piece.")]
    assert sorted({s["name"] for s in pieces}) == [
        "sgv.piece.cg", "sgv.piece.post_cg", "sgv.piece.pre_cg", "sgv.piece.prior"]
    inside, out_by = set(), 0
    for s in pieces:
        mine = [op for op in ops if s["start_ns"] <= op[3] <= s["end_ns"]]
        assert mine and s["device_end_ns"] is not None, s
        out_by = max(out_by, s["device_start_ns"] - min(op[0] for op in mine),
                     max(op[1] for op in mine) - s["device_end_ns"])
        inside.update(mine)
    r = {"trace": {"ops": [op[:3] for op in ops], "steps": steps}}
    piece_ms = {m: harness.reader(m)(r) for m in ("prior_ms", "pre_cg_ms", "cg_ms", "post_cg_ms")}
    outside = [op for op in ops if op not in inside]
    names = {}
    for op in outside:
        names[op[2][:40]] = names.get(op[2][:40], 0) + (op[1] - op[0]) / 1e6
    busy_ms, outside_ms = _busy_ns(ops) / 1e6, _busy_ns(outside) / 1e6
    total_ms = sum(piece_ms.values()) * steps
    print(f"[spans] pieces a step {piece_ms} ms: {total_ms:.4f} ms in {steps} steps; busy "
          f"{busy_ms:.4f} ms, outside the pieces {outside_ms:.4f} ({names}); an operation "
          f"outside its piece's device interval by at most {out_by / 1e3:.1f} us")
    assert out_by < 200e3
    assert abs(total_ms + outside_ms - busy_ms) <= 0.03 * busy_ms


def test_second_run_scan_makes_no_capture(cuda):
    """The first fused run captures each piece once (sgv.capture, counter
    "captures"); a second on the same engine captures nothing."""
    engine = _fused_engine(cuda, True, False)
    profiling.reset()
    engine.run_scan(3, seed=1)
    first = profiling.snapshot()
    assert first["counts"]["captures"] == len(engine.fused.captured) >= 4
    assert first["totals"]["sgv.capture"]["calls"] == len(engine.fused.captured)
    profiling.reset()
    engine.run_scan(3, seed=1)
    again = profiling.snapshot()
    assert "sgv.capture" not in again["totals"] and "captures" not in again["counts"]
    assert again["totals"]["sgv.step"]["calls"] == 3


def test_blocking_spans_end_after_the_operations_they_wait_for(cuda):
    """Each sgv.read and sgv.sync span ends after the device operations
    launched before its end; the largest excess of an operation's end over
    the span's is the offset between the card's stamps and the host's
    clock, held inside TRACE_PAD_S."""
    snap, ops = _traced_fused_run(cuda)
    blocking = [s for s in snap["spans"] if s["name"] in ("sgv.read", "sgv.sync")]
    assert {s["name"] for s in blocking} == {"sgv.read", "sgv.sync"}
    excess = []
    for s in blocking:
        waited = max(op[1] for op in ops if op[3] <= s["end_ns"])
        excess.append(waited - s["end_ns"])
    print(f"[spans] {len(blocking)} blocking spans: device end - span end max "
          f"{max(excess) / 1e3:.1f} us, min {min(excess) / 1e3:.1f} us")
    assert max(excess) < TRACE_PAD_S * 1e9


@pytest.fixture
def bench_small(cuda, monkeypatch, tmp_path):
    """sgvamp_torch.bench at the small size on the card (its knobs unset,
    the problem cached under tmp_path); returns (bench, its problem)."""
    import os

    from sgvamp_torch import bench

    for k in [k for k in os.environ if k.startswith("SGVAMP_BENCH_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("SGVAMP_BENCH_SIZE", "small")
    monkeypatch.setenv("SGVAMP_BENCH_CACHE_DIR", str(tmp_path))
    M, bw, _, _, _ = bench._params()
    return bench, bench.build_problem(M, bw, bench.N_SAMPLES, bench.LAM, bench.H2)


def test_bench_step_child_on_the_card(bench_small):
    """Both timings finite, the quality gate's iterate aligned, and the timed
    blocks' int8 passes all kernels: cg_maxit + 2 = 22 a step, by graph
    replay in the fused blocks (none eager) and eagerly in the host loop."""
    bench, (band, r, x0) = bench_small
    M, bw, B, cg_maxit, iters = bench._params()
    got = bench.time_step_child(band, r, bench.N_SAMPLES, bench.LAM, bench.H2, iters, cg_maxit,
                                B, x0=x0)
    samples = got["iter_s_samples"] + got["iter_s_samples_host"]
    assert len(samples) == 8 and all(np.isfinite(s) and s > 0 for s in samples)
    assert np.isfinite(got["device_ms_per_step"]) and got["device_ms_per_step"] > 0
    assert got["finite"] and got["align_stop"] > 0.95
    n = got["timed_steps"] * (cg_maxit + 2)
    assert got["launches_fused"] == {"sym_band_matvec_int8": n}
    assert got["launches_host"] == {"sym_band_matvec_int8": n}
    assert got["launches_fused_eager"] == {}


def test_bench_matvec_child_on_the_card(bench_small):
    """The child's bytes a pass are the operator's, the read probe ran, and
    its ceiling is at least the chained pass's own rate."""
    bench, (band, r, _) = bench_small
    M, bw, B, cg_maxit, _ = bench._params()
    matvec_s, memread_s, bpp, pre, post, launches = bench.time_matvec_child(
        band, r, bench.N_SAMPLES, bench.LAM, bench.H2, cg_maxit, B)
    op = SymBandedLD.from_band(band, block_size=B, dtype="int8", device="cuda")
    assert bpp == op.bytes_per_pass()
    assert launches["read_max"] > 0 and launches["sym_band_matvec_int8"] > 0
    assert set(launches) == {"read_max", "sym_band_matvec_int8"}
    assert 0 < memread_s and 0 < matvec_s
    assert max(pre, post) >= bpp / matvec_s / 1e9
