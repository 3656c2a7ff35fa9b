"""The port's SymBandedLD in slab layout and in the resident mode against the
JAX package's, on the CPU.

Packing must be bit-identical. Each plain version must match the JAX
operator's matvec in the matching layout / mode / window / rows_per_step (the
Pallas kernels in interpret mode) on the same packed arrays: in float64 to
rtol 1e-10 / atol 1e-12 and against the dense product, as
tests/test_pallas_kernel.py holds the JAX kernels; in float32 and bfloat16
both sum the same products in f32 in different orders, so they agree to a
scaled 1e-5. float64 engine trajectories match to 1e-8 with equal CG counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sgvamp_torch import interop
from sgvamp_torch.config import VampConfig as TConfig
from sgvamp_torch.core import precond as tpre
from sgvamp_torch.core import vamp as tvamp
from sgvamp_torch.core.prior import PriorState as TPrior
from sgvamp_torch.ops import band_kernel as tbk
from sgvamp_torch.ops.band_kernel import SymBandedLD
from sgvamp_tpu.config import VampConfig as JConfig
from sgvamp_tpu.core import precond as jpre
from sgvamp_tpu.core import vamp as jvamp
from sgvamp_tpu.core.prior import PriorState as JPrior
from sgvamp_tpu.data.simulate import band_to_dense, simulate_ld_band
from sgvamp_tpu.ops.band_kernel import SymBandedLD as JSym
from sgvamp_tpu.ops.band_kernel import _sym_band_matvec_streamed, _sym_slab_matvec_streamed

SCALED_TOL = 1e-5
M_RAGGED = 700   # deliberately not a block multiple
GEOMETRIES = [(128, 48), (128, 200), (256, 100)]     # test_pallas_kernel.py:58
NP_DTYPE = {"float64": np.float64, "float32": np.float32, "bfloat16": np.float32}

# (layout, mode, window, B, bw, rows_per_step): the parametrisations of
# tests/test_pallas_kernel.py:24, 40, 58, 107-108, 128-129
FLAVOR_CASES = (
    [("diag", "resident", False, B, bw, 0) for B, bw in GEOMETRIES]
    + [("diag", "resident", True, B, bw, 0) for B, bw in [(128, 48), (128, 200)]]
    + [("slab", "resident", False, B, bw, 0) for B, bw in GEOMETRIES]
    + [("diag", "streamed", False, B, bw, G)
       for B, bw, G in [(128, 48, 0), (128, 200, 0), (256, 100, 0), (128, 200, 2),
                        (128, 48, 2), (128, 100, 3)]]
    + [("slab", "streamed", False, B, bw, G)
       for B, bw, G in [(128, 48, 0), (128, 200, 2), (256, 100, 0), (128, 100, 3)]]
    + [("diag", "resident", True, 128, 200, 2), ("slab", "resident", False, 128, 200, 3)]
)


def _band(M, bw, seed, dtype=np.float64):
    return simulate_ld_band(10000, M, bw, rng=np.random.default_rng(seed), dtype=dtype)[0]


def _np(a):
    """A JAX array as numpy; bf16 crosses as float32 (exact)."""
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _tnp(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _cross(jop):
    """The JAX operator's arrays and flavor as the port's operator."""
    return interop.operator_from_numpy(
        _np(jop.upper), None if jop.scales is None else np.asarray(jop.scales), s=jop.s,
        packed=jop.packed, hybrid=jop.hybrid,
        dtype=torch.bfloat16 if jop.upper.dtype == jnp.bfloat16 else None, device="cpu",
        layout=jop.layout, mode=jop.mode, window=jop.window, rows_per_step=jop.rows_per_step)


# ---------------------------------------------------------------------------
# the repaired default
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("band_dtype", [np.float32, np.float64])
def test_from_band_default_dtype_is_the_bands_own(band_dtype):
    """SymBandedLD.from_band(band, block_size=B) gives the band's float
    dtype and the same blocks in both packages."""
    band = _band(300, 96, seed=2, dtype=band_dtype)
    want = JSym.from_band(band, block_size=64)
    got = SymBandedLD.from_band(band, block_size=64, device="cpu")
    assert str(got.upper.dtype).split(".")[-1] == str(want.upper.dtype) == np.dtype(band_dtype).name
    assert got.scales is None and want.scales is None
    np.testing.assert_array_equal(got.upper.numpy(), np.asarray(want.upper))
    assert ((got.layout, got.mode, got.window, got.rows_per_step)
            == (want.layout, want.mode, want.window, want.rows_per_step)
            == ("diag", "auto", False, 0))


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,bw", GEOMETRIES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
def test_slab_packing_bit_identical(dtype, B, bw):
    band = _band(M_RAGGED, bw, seed=B + bw, dtype=NP_DTYPE[dtype])
    K = 2 if bw == 48 else 1
    want = JSym.from_band(band, block_size=B, K=K, dtype=dtype, layout="slab", s=0.1)
    got = SymBandedLD.from_band(band, block_size=B, K=K, dtype=dtype, layout="slab", s=0.1,
                                device="cpu")
    assert str(got.upper.dtype).split(".")[-1] == str(want.upper.dtype) == dtype
    assert tuple(got.upper.shape) == want.upper.shape == (K, got.nb, (got.hb + 1) * B, B)
    np.testing.assert_array_equal(_tnp(got.upper), _np(want.upper))
    assert got.bytes_per_pass() == want.bytes_per_pass()
    assert ((got.K, got.nb, got.hb, got.B, got.M, got.layout)
            == (want.K, want.nb, want.hb, want.B, want.M, "slab"))
    assert got.hb == -(-bw // B)
    # to_dense and diag_blocks equal the diag layout's, and the JAX package's
    diag = SymBandedLD.from_band(band, block_size=B, K=K, dtype=dtype, s=0.1, device="cpu")
    assert torch.equal(got.to_dense(), diag.to_dense())
    assert torch.equal(got.diag_blocks(), diag.diag_blocks())
    np.testing.assert_array_equal(got.diag_blocks().numpy(), np.asarray(want.diag_blocks()))
    if dtype != "bfloat16":   # JAX regularizes the bf16 dense matrix in bf16
        np.testing.assert_array_equal(got.to_dense().numpy(), np.asarray(want.to_dense()))


# ---------------------------------------------------------------------------
# the plain versions against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout,mode,window,B,bw,G", FLAVOR_CASES)
@pytest.mark.parametrize("K", [1, 2])
def test_f64_plain_versions_match_jax_and_dense(layout, mode, window, B, bw, G, K):
    rng = np.random.default_rng(B + bw + G + K)
    band = _band(M_RAGGED, bw, seed=3 + K)
    R = band_to_dense(band)
    jop = dataclasses.replace(
        JSym.from_band(band, block_size=B, K=K, s=0.1, layout=layout),
        mode=mode, window=window, rows_per_step=G)
    op = _cross(jop)
    assert (op.layout, op.mode, op.window, op.rows_per_step) == (layout, mode, window, G)
    x = rng.normal(size=(2 * K, op.M))
    y = op.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jop.matvec(jnp.asarray(x))),
                               rtol=1e-10, atol=1e-12)
    want = x[:, :M_RAGGED] @ (0.9 * R + 0.1 * np.eye(M_RAGGED)).T
    np.testing.assert_allclose(y[:, :M_RAGGED], want, rtol=1e-10, atol=1e-12)
    # padded markers carry an identity diagonal: Rused @ x = x there
    np.testing.assert_allclose(y[:, M_RAGGED:], x[:, M_RAGGED:], atol=1e-12)


@pytest.mark.parametrize("layout,mode,window,B,bw,G", FLAVOR_CASES[::2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_f32_bf16_plain_versions_match_jax(dtype, layout, mode, window, B, bw, G):
    K = 2
    rng = np.random.default_rng(B + bw + G)
    band = _band(M_RAGGED, bw, seed=5, dtype=np.float32)
    jop = dataclasses.replace(
        JSym.from_band(band, block_size=B, K=K, s=0.1, dtype=dtype, layout=layout),
        mode=mode, window=window, rows_per_step=G)
    op = _cross(jop)
    assert str(op.upper.dtype).split(".")[-1] == dtype
    x = rng.normal(size=(2 * K, op.M)).astype(np.float32)
    y = op.matvec(torch.from_numpy(x)).numpy().astype(np.float64)
    y_jax = np.asarray(jop.matvec(jnp.asarray(x)), np.float64)
    scale = np.abs(y_jax).max()
    np.testing.assert_allclose(y / scale, y_jax / scale, rtol=0, atol=SCALED_TOL)


# Wide bands, where mode="auto" takes the streamed kernels (hb >= 15): the
# plain versions that the kernels are held against on the card, against the
# Pallas streamed kernels in interpret mode and the dense product, in
# float64 to 1e-10. B=8 keeps the unrolled Pallas loops small; M is ragged
# (nb=32), the Pallas chunk is 16 block rows (>= hb, as it must be), and the
# spill form cuts the panel into two shards of 16 block rows.
WIDE_B, WIDE_M, WIDE_G = 8, 253, 16


@pytest.mark.parametrize("layout,form,bw", [
    ("diag", "matvec", 123),   # hb=16
    ("slab", "matvec", 118),   # hb=15
    ("diag", "spill", 127),    # hb=16
    ("slab", "spill", 121),    # hb=16
])
def test_wide_band_plain_versions_match_jax_and_dense(layout, form, bw):
    B, G, K, S = WIDE_B, WIDE_G, 1, 2
    band = _band(WIDE_M, bw, seed=bw)
    R = band_to_dense(band)
    jop = JSym.from_band(band, block_size=B, K=K, layout=layout)
    op = SymBandedLD.from_band(band, block_size=B, K=K, layout=layout, device="cpu")
    np.testing.assert_array_equal(op.upper.numpy(), np.asarray(jop.upper))
    assert (op.nb, op.hb) == (32, -(-bw // B)) and op.hb >= 15
    x = np.random.default_rng(bw).normal(size=(K, S, op.M))
    dense = op.to_dense()[0].numpy()
    np.testing.assert_array_equal(dense, np.asarray(jop.to_dense())[0])
    want = x[0] @ dense.T                                  # (S, M)
    np.testing.assert_allclose(want[:, :WIDE_M], x[0, :, :WIDE_M] @ R.T, rtol=1e-10,
                               atol=1e-12)
    jfun = _sym_slab_matvec_streamed if layout == "slab" else _sym_band_matvec_streamed
    if form == "matvec":
        plain = tbk.sym_slab_matvec_streamed_ref if layout == "slab" else tbk.sym_band_matvec_ref
        args = (op.upper, 0) if layout == "slab" else (op.upper,)
        y = plain(*args, torch.from_numpy(x)).numpy()
        jy, _ = jfun(jop.upper, jnp.asarray(x), op.nb, interpret=True, rows_per_step=G)
        np.testing.assert_allclose(y, np.asarray(jy), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(y[0], want, rtol=1e-10, atol=1e-12)
        return
    plain = (tbk.sym_slab_matvec_streamed_spill_ref if layout == "slab"
             else tbk.sym_band_matvec_spill_ref)
    nb_l, hbB = op.nb // 2, op.hb * B
    xpad = np.concatenate([x, np.zeros((K, S, G * B))], axis=2)
    ys, carry = [], None
    for j in range(2):
        rows = slice(j * nb_l, (j + 1) * nb_l)
        x_ext = xpad[:, :, j * nb_l * B:(j * nb_l + nb_l + G) * B]   # halo, padded to a chunk
        piece = op.upper[:, rows].contiguous()
        y_l, spilled = plain(*((piece, 0) if layout == "slab" else (piece,)),
                             torch.from_numpy(x_ext))
        jy, jc = jfun(jop.upper[:, rows], jnp.asarray(x_ext), nb_l, interpret=True,
                      rows_per_step=G, spill=True)
        np.testing.assert_allclose(y_l.numpy(), np.asarray(jy), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(spilled.numpy(), np.asarray(jc), rtol=1e-10, atol=1e-12)
        assert spilled.shape == (K, S, hbB)
        y_l = y_l.numpy()
        if j:
            y_l[:, :, :hbB] += carry
        carry = spilled.numpy()
        ys.append(y_l)
    assert np.all(carry == 0)   # what leaves the panel: exact zeros
    np.testing.assert_allclose(np.concatenate(ys, axis=2)[0], want, rtol=1e-10, atol=1e-12)


def test_diagonal_only_band_has_no_mirrors():
    """hb = 0 in every flavor: no mirror terms, no run boundary to cross."""
    rng = np.random.default_rng(6)
    M, B = 384, 128
    band = rng.normal(size=(M, 1))
    x = rng.normal(size=(2, M))
    for layout in ("diag", "slab"):
        for mode in ("resident", "streamed"):
            op = dataclasses.replace(
                SymBandedLD.from_band(band, block_size=B, layout=layout, device="cpu"), mode=mode)
            assert op.hb == 0
            np.testing.assert_allclose(op.matvec(torch.from_numpy(x)).numpy(), x * band[:, 0],
                                       rtol=1e-12, atol=1e-13)


# ---------------------------------------------------------------------------
# errors, as in the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int8", "int4", "hybrid"])
def test_quantized_storage_has_no_slab_layout_and_no_resident_kernel(dtype):
    band = _band(256, 32, seed=3)
    for pkg, kw in ((JSym, {}), (SymBandedLD, {"device": "cpu"})):
        with pytest.raises(ValueError, match="diag layout only"):
            pkg.from_band(band, block_size=128, dtype=dtype, layout="slab", **kw)
    jop = dataclasses.replace(JSym.from_band(band, block_size=128, dtype=dtype), mode="resident")
    with pytest.raises(ValueError, match="no resident kernel"):
        jop.matvec(jnp.ones((2, jop.M), jnp.float32))
    op = dataclasses.replace(
        SymBandedLD.from_band(band, block_size=128, dtype=dtype, device="cpu"), mode="resident")
    with pytest.raises(ValueError, match="no resident kernel"):
        op.matvec(torch.ones((2, op.M)))
    with pytest.raises(ValueError, match="diag layout only"):
        SymBandedLD(upper=op.upper[:, :, 0], scales=op.scales, layout="slab")


@pytest.mark.parametrize("layout,mode,G,message", [
    ("diag", "resident", 3, "rows_per_step=3 must divide nb=8"),
    ("slab", "resident", 5, "rows_per_step=5 must divide nb=8"),
    ("diag", "streamed", 3, "must divide nb=8 and be >= hb=2"),
    ("slab", "streamed", 3, "must divide nb=8 and be >= hb=2"),
    ("diag", "streamed", 1, "must divide nb=8 and be >= hb=2"),   # divides, but below hb
    ("slab", "streamed", 1, "must divide nb=8 and be >= hb=2"),
])
def test_bad_rows_per_step_raises_as_in_jax(layout, mode, G, message):
    band = _band(1024, 200, seed=4)     # nb = 8, hb = 2 at B = 128
    jop = dataclasses.replace(JSym.from_band(band, block_size=128, layout=layout),
                              mode=mode, rows_per_step=G)
    with pytest.raises(ValueError, match=message):
        jop.matvec(jnp.ones((2, jop.M)))
    op = _cross(jop)
    with pytest.raises(ValueError, match=message):
        op.matvec(torch.ones((2, op.M), dtype=torch.float64))


def test_bad_fields_raise():
    up = torch.zeros((1, 2, 2, 64, 64))
    with pytest.raises(ValueError, match="layout"):
        SymBandedLD(upper=up, layout="rows")
    with pytest.raises(ValueError, match="mode"):
        SymBandedLD(upper=up, mode="fast")
    with pytest.raises(ValueError, match="4-dimensional"):
        SymBandedLD(upper=up, layout="slab")
    with pytest.raises(ValueError, match="5-dimensional"):
        SymBandedLD(upper=up[:, :, 0])
    with pytest.raises(ValueError, match="layout"):
        SymBandedLD.from_band(_band(128, 10, 0), block_size=64, layout="rows", device="cpu")


# ---------------------------------------------------------------------------
# the size rule of this card and the routing of mode="auto"
# ---------------------------------------------------------------------------

def test_fits_shared_memory_ceiling():
    """A resident kernel's CTA holds, for a run of G block rows and S lanes
    of B accumulator words, G + 2 hb rows of x, G of row sums and hb G of
    mirror sums in at most 232,448 bytes; "auto" wants 2 G > hb + 1."""
    assert tbk.SHARED_MEMORY_BYTES == 232448
    # the bench shape (hb=2, B=128, S=2): 36 KiB for G=8 in bf16 and f32
    assert tbk._run_shared_bytes(8, 2, 128, 2, 2) == 2 * 128 * 36 * 4 == 36864
    assert SymBandedLD.resident_rows(2, 128, 2, 2) == 8
    assert SymBandedLD.fits_shared_memory(2, 128, 2, 2)
    assert SymBandedLD.fits_shared_memory(2, 128, 2, 4)
    # float64, B=256, S=4: 8 KiB a row; hb=3 leaves G=4, hb=5 G=2, hb=7 G=1
    assert SymBandedLD.resident_rows(3, 256, 4, 8) == 4
    assert SymBandedLD.fits_shared_memory(3, 256, 4, 8)
    assert SymBandedLD.resident_rows(5, 256, 4, 8) == 2
    assert not SymBandedLD.fits_shared_memory(5, 256, 4, 8)     # 2 * 2 > 6 fails
    assert SymBandedLD.fits_shared_memory(5, 256, 2, 8)         # S=2: G=4, 8 > 6
    assert SymBandedLD.resident_rows(7, 256, 4, 8) == 1
    assert SymBandedLD.resident_rows(14, 256, 4, 8) == 0        # not even one row
    assert not SymBandedLD.fits_shared_memory(14, 256, 4, 8)
    # the rule does not depend on M: no CTA holds more than its run
    for B in (64, 128, 256):
        assert SymBandedLD.fits_shared_memory(2, B, 4, 4)


class _Calls:
    """Counts calls of the plain versions (the CPU's route) by name."""

    NAMES = ("sym_band_matvec_ref", "sym_band_matvec_resident_ref",
             "sym_band_matvec_window_ref", "sym_slab_matvec_streamed_ref",
             "sym_slab_matvec_resident_ref", "sym_band_matvec_int8_ref")

    def __init__(self, monkeypatch):
        self.count = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            monkeypatch.setattr(tbk, name, self._wrap(name, getattr(tbk, name)))

    def _wrap(self, name, fn):
        def counted(*args, **kw):
            self.count[name] += 1
            return fn(*args, **kw)
        return counted

    def taken(self):
        out = sorted(k for k, v in self.count.items() if v)
        for k in self.count:
            self.count[k] = 0
        return out


def test_auto_mode_routes_by_the_size_rule(monkeypatch):
    calls = _Calls(monkeypatch)
    # below the rule: hb=2, B=64, S=2 - every float operator takes its resident kernel
    band = _band(500, 100, seed=8)
    x = torch.ones((2, 512), dtype=torch.float64)
    diag = SymBandedLD.from_band(band, block_size=64, device="cpu")
    slab = SymBandedLD.from_band(band, block_size=64, layout="slab", device="cpu")
    assert diag.mode == slab.mode == "auto" and diag._use_resident(2)
    for op, want in (
            (diag, ["sym_band_matvec_resident_ref"]),
            (dataclasses.replace(diag, window=True), ["sym_band_matvec_window_ref"]),
            (slab, ["sym_slab_matvec_resident_ref"]),
            (dataclasses.replace(diag, mode="streamed"), ["sym_band_matvec_ref"]),
            (dataclasses.replace(slab, mode="streamed"), ["sym_slab_matvec_streamed_ref"]),
            (SymBandedLD.from_band(band, block_size=64, dtype="int8", device="cpu"),
             ["sym_band_matvec_int8_ref"])):
        op.matvec(x.to(torch.float32) if op.quantized else x)
        assert calls.taken() == want
    # above the rule: float64, B=256, hb=5, S=4 leaves runs of 2 block rows
    wide = np.zeros((1536, 2 * 1280 + 1))
    wide[:, 1280] = 1.0
    big = SymBandedLD.from_band(wide, block_size=256, device="cpu")
    big_slab = SymBandedLD.from_band(wide, block_size=256, layout="slab", device="cpu")
    assert big.hb == 5 and not big._use_resident(4) and big._use_resident(2)
    x4 = torch.ones((4, big.M), dtype=torch.float64)
    big.matvec(x4)
    assert calls.taken() == ["sym_band_matvec_ref"]
    big_slab.matvec(x4)
    assert calls.taken() == ["sym_slab_matvec_streamed_ref"]
    big.matvec(x4[:2])      # S = 2 fits again
    assert calls.taken() == ["sym_band_matvec_resident_ref"]
    # forcing the resident kernel above the rule raises; it does not stream instead
    for op in (big, big_slab):
        with pytest.raises(ValueError, match="does not fit"):
            dataclasses.replace(op, mode="resident").matvec(x4)
        assert calls.taken() == []
    # a run length given by hand only has to fit the shared memory
    dataclasses.replace(big, mode="resident", rows_per_step=2).matvec(x4)
    assert calls.taken() == ["sym_band_matvec_resident_ref"]
    with pytest.raises(ValueError, match="too much"):
        dataclasses.replace(big_slab, mode="resident", rows_per_step=3).matvec(x4)


@pytest.mark.parametrize("flavor", ["resident", "window", "slab-resident", "slab-streamed"])
def test_cpu_wrappers_take_the_plain_version(flavor):
    kw = {"resident": dict(mode="resident"), "window": dict(mode="resident", window=True),
          "slab-resident": dict(mode="resident"), "slab-streamed": dict(mode="streamed")}[flavor]
    op = dataclasses.replace(
        SymBandedLD.from_band(_band(300, 100, seed=3, dtype=np.float32), block_size=64,
                              layout="slab" if flavor.startswith("slab") else "diag",
                              device="cpu"), **kw)
    kernel, plain, args, xdt = tbk.band_kernel_of(op)
    assert kernel.__name__ == {"resident": "sym_band_matvec_resident",
                               "window": "sym_band_matvec_window",
                               "slab-resident": "sym_slab_matvec_resident",
                               "slab-streamed": "sym_slab_matvec_streamed"}[flavor]
    x = torch.randn(1, 2, op.M, generator=torch.Generator().manual_seed(0)).to(xdt)
    before = [k.launches for k in tbk.BAND_KERNELS]
    y = kernel(*args, x)
    assert [k.launches for k in tbk.BAND_KERNELS] == before  # no kernel on the CPU
    assert y.dtype == torch.float32 and torch.equal(y, plain(*args, x))
    with pytest.raises(ValueError):
        kernel(*args, x.double())
    with pytest.raises(ValueError):
        kernel(*args, x[:, :, :-1])
    with pytest.raises(ValueError):   # the other layout's blocks
        kernel(op.upper[:, :, 0] if op.layout == "diag" else op.upper[:, :, None], 0, x)


# ---------------------------------------------------------------------------
# the slice as a whole: engine trajectories and the preconditioner
# ---------------------------------------------------------------------------

N, LAM, H2 = 20000, 0.05, 0.7


def _engines(jop, M, r, extra=None):
    top = _cross(jop)
    K, Mp = top.K, top.M
    mask = (np.arange(Mp) < M).astype(np.float64)
    rp = np.zeros((K, Mp))
    rp[:, :M] = r
    a, Nk = np.full(K, 1.0 / K), np.full(K, float(N))
    cfg = dict(prior_update="em", dtype="float64", cg_maxit=200, cg_rtol=1e-7,
               em_prior_maxit=20, rho=0.5)
    cfg.update(extra or {})
    prior = (LAM, [1.0], [H2 / max(int(M * LAM), 1) * N])
    jeng = jvamp.VampEngine(
        jvamp.VampInputs(op=jop, r=jnp.asarray(rp), a=jnp.asarray(a), N=jnp.asarray(Nk),
                         mask=jnp.asarray(mask)),
        JConfig(**cfg), JPrior.create(*prior))
    teng = tvamp.VampEngine(
        interop.inputs_from_numpy(top, rp, a, Nk, mask=mask, dtype=torch.float64, device="cpu"),
        TConfig(**cfg), TPrior.create(*prior, device="cpu"))
    return jeng, teng, Mp


@pytest.mark.parametrize("layout,mode,window,G", [
    ("slab", "streamed", False, 0), ("diag", "resident", False, 0),
    ("diag", "resident", True, 5), ("slab", "resident", False, 0)])
@pytest.mark.parametrize("K", [1, 2])
def test_f64_trajectory_matches(layout, mode, window, G, K):
    M, B, bw, iters = 300, 64, 100, 4     # ragged M (pads to 320), hb = 2
    band, r, x0 = simulate_ld_band(N, M, bw, h2=H2, lam=LAM, n_r=K,
                                   rng=np.random.default_rng(30 + K), dtype=np.float64)
    jop = dataclasses.replace(
        JSym.from_band(band, block_size=B, K=K, s=0.05, layout=layout),
        mode=mode, window=window, rows_per_step=G)
    jeng, teng, Mp = _engines(jop, M, np.atleast_2d(r))
    u = np.random.default_rng(K).choice([-1.0, 1.0], size=(iters, K, Mp))
    hj = jeng.run(iters, fixed_u=u, M_out=M, x0=x0)
    ht = teng.run(iters, fixed_u=u, M_out=M, x0=x0)
    assert len(ht["xhat1"]) == len(hj["xhat1"]) == iters
    for it in range(iters):
        np.testing.assert_allclose(ht["xhat1"][it], hj["xhat1"][it], rtol=1e-8,
                                   atol=1e-8 * np.abs(hj["xhat1"][it]).max())
        np.testing.assert_array_equal(ht["cg1_iters"][it], hj["cg1_iters"][it])
        np.testing.assert_array_equal(ht["cg2_iters"][it], hj["cg2_iters"][it])
    np.testing.assert_allclose(ht["alignment"], hj["alignment"], rtol=1e-8)
    assert hj["alignment"][-1] > 0.9  # a run that learns something


@pytest.mark.parametrize("sub_block", [0, 32])
def test_block_jacobi_over_a_slab_operator_matches_jax(sub_block):
    band = _band(300, 96, seed=12)
    jop = JSym.from_band(band, block_size=64, K=2, s=0.02, layout="slab")
    op = _cross(jop)
    got = tpre._extract_sub_blocks(op, sub_block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpre._extract_sub_blocks(jop, sub_block)))
    P = sub_block or 64
    assert tuple(got.shape) == (2, op.M // P, P, P) and got.dtype == torch.float32
    diag = SymBandedLD.from_band(band, block_size=64, K=2, s=0.02, device="cpu")
    assert torch.equal(got, tpre._extract_sub_blocks(diag, sub_block))
    gamw, gam2 = np.array([2.0, 0.5]), np.array([0.3, 4.0])
    want = np.asarray(jpre.block_jacobi_inverse(
        jop, jnp.asarray(gamw), jnp.asarray(gam2), sub_block, dtype=jnp.float64))
    inv = tpre.block_jacobi_inverse(op, torch.from_numpy(gamw), torch.from_numpy(gam2),
                                    sub_block, dtype=torch.float64).numpy()
    # both invert the same float32 blocks in float64 with LAPACK
    np.testing.assert_allclose(inv, want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


def test_preconditioned_trajectory_over_a_slab_operator_matches():
    """Direct block inversion in f64 every step over a slab operator: the
    same arithmetic in both engines."""
    K, M, B, bw, iters = 1, 300, 64, 100, 3
    band, r, x0 = simulate_ld_band(N, M, bw, h2=H2, lam=LAM, n_r=K,
                                   rng=np.random.default_rng(41), dtype=np.float64)
    jop = JSym.from_band(band, block_size=B, K=K, s=0.05, layout="slab")
    jeng, teng, Mp = _engines(jop, M, np.atleast_2d(r), dict(
        cg_precond_block=32, cg_precond_dtype="float64", cg_precond_eig=False))
    u = np.random.default_rng(2).choice([-1.0, 1.0], size=(iters, K, Mp))
    hj = jeng.run(iters, fixed_u=u, M_out=M, x0=x0)
    ht = teng.run(iters, fixed_u=u, M_out=M, x0=x0)
    for it in range(iters):
        np.testing.assert_allclose(ht["xhat1"][it], hj["xhat1"][it], rtol=1e-8,
                                   atol=1e-8 * np.abs(hj["xhat1"][it]).max())
        np.testing.assert_array_equal(ht["cg1_iters"][it], hj["cg1_iters"][it])
