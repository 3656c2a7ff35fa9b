"""The streamed slab kernel's tiles of the band, on the CPU: the wrapper's
rule as a plain function, the grid's tiles and scratch rows, the kernel's
schedule over tiles emulated in plain torch on a dense panel's whole
triangle, and the CPU path's independence of the card's shared memory.

The kernel (csrc/sym_slab_streamed.cu) gives a CTA a tile of the band: a run
of G block rows, one warp a block row, and a range of D diagonals, with the
x window of block rows r0 + d0 .. r0 + G - 1 + d1 in shared memory beside
the run's mirror sums. The mirror sums that leave a run go through the
scratch of partial sums (sym_band_tile.cuh::Partials); with more than one
range each tile's row sums go through a second part of the scratch to
fold_tiles. It runs only on the card (tests/test_torch_gpu.py -k slab, where
forced tiles reach every edge of the scratch and the fold); here the plain
version it is held against there, the JAX package's Pallas kernel in
interpret mode, to_dense() and the emulation of its schedule are held
against each other: bfloat16 and float32 slabs sum in f32 in other orders
(scaled 1e-5), float64 slabs in f64 (scaled 1e-10).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sgvamp_torch.ops import band_kernel as tbk
from sgvamp_torch.ops.band_kernel import SymBandedLD
from sgvamp_tpu.data.simulate import simulate_ld_band
from sgvamp_tpu.ops.band_kernel import SymBandedLD as JSym
from sgvamp_tpu.ops.band_kernel import _sym_slab_matvec_streamed

H100_SMS = 132
TOL = {"bfloat16": 1e-5, "float32": 1e-5, "float64": 1e-10}
STORAGE_BYTES = {"bfloat16": 2, "float32": 4, "float64": 8}
# B=8 keeps the unrolled Pallas loops small; M is ragged
TRI_B, TRI_M = 8, 60


def _scaled(got, want, scale):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()) / scale


def _tile_table(nb, hb, G, D):
    """The tiles of the matvec grid as csrc/sym_band_tile.cuh::tiles_of lists
    them: range by range, the runs whose first block row has data at the
    range's first diagonal, in order; [(j, r0), ...]."""
    J, runs = -(-(hb + 1) // D), -(-nb // G)
    return [(j, c * G) for j in range(J)
            for c in range(min(runs, (nb - 1 - j * D) // G + 1 if j * D <= nb - 1 else 0))]


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", sorted(STORAGE_BYTES))
@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("nb", [4096, 1024])
def test_slab_tiles_keep_the_runs_where_they_fill_the_card(nb, storage, S):
    """The bench shape (M=524288, nb=4096, hb=2), and nb=1024 (where runs of
    4 were slower on an H100), keep the schedule before tiles: runs of 8
    block rows, every diagonal in one range."""
    assert tbk._slab_tiles(nb, 2, H100_SMS, S, 128, STORAGE_BYTES[storage]) == (8, 3)


@pytest.mark.parametrize("storage", sorted(STORAGE_BYTES))
def test_slab_tiles_cut_the_dense_panel_triangle(storage):
    """Row 2g: a dense M=8192 panel's whole triangle (nb=64, hb=64, K=2,
    S=2, B=128) is cut as the float diag kernel cuts it, one block row and
    two diagonals a tile: 2112 one-warp tiles over the two cohorts."""
    G, D = tbk._slab_tiles(64, 64, H100_SMS, 2, 128, STORAGE_BYTES[storage])
    assert (G, D) == (1, 2) == tbk._float_tiles(64, 64, H100_SMS)
    assert 2 * len(_tile_table(64, 64, G, D)) == 2112


@pytest.mark.parametrize("nb", [1, 2, 3, 5, 16, 17, 64, 100, 128, 257, 512, 1024])
def test_slab_tiles_fit_a_cta_for_every_band(nb):
    """For every hb up to nb (a whole triangle reaches hb = nb - 1 or nb), B
    64/128/256, S 1-4 and each slab type: the runs of SLAB_RUN_ROWS over
    every diagonal where nb block rows are FLOAT_MIN_WARPS_PER_SM warps an
    SM and their window fits; else G from _runs up to SLAB_RUN_ROWS, at
    least the float diag rule's ranges, even ranges (D = ceil((hb + 1) /
    J)), no more than MAX_RANGES, and the tile's x window and mirror sums
    within a CTA's shared memory; more ranges only where the float rule's
    tile would not fit."""
    G = tbk._runs(nb, H100_SMS, tbk.SLAB_RUN_ROWS)
    runs = tbk.SLAB_RUN_ROWS
    many = nb >= tbk.FLOAT_MIN_WARPS_PER_SM * H100_SMS
    for hb in range(nb + 1):
        J_float = -(-(hb + 1) // tbk._diagonals(nb, hb, G, tbk.FLOAT_MIN_WARPS_PER_SM * H100_SMS))
        for B in (64, 128, 256):
            for S in range(1, 5):
                for nbytes in STORAGE_BYTES.values():
                    got = tbk._slab_tiles(nb, hb, H100_SMS, S, B, nbytes)
                    if many and tbk._slab_shared_bytes(runs, hb + 1, S, B, nbytes) <= \
                            tbk.SHARED_MEMORY_BYTES:
                        assert got == (runs, hb + 1)
                        continue
                    assert got[0] == G <= tbk.SLAB_RUN_ROWS
                    D = got[1]
                    J = -(-(hb + 1) // D)
                    assert 1 <= D <= hb + 1 and D == -(-(hb + 1) // J)
                    assert J_float <= J <= tbk.MAX_RANGES
                    assert tbk._slab_shared_bytes(G, D, S, B, nbytes) <= tbk.SHARED_MEMORY_BYTES
                    if J > J_float:   # cut further: the float rule's tile does not fit
                        D_float = -(-(hb + 1) // J_float)
                        assert tbk._slab_shared_bytes(G, D_float, S, B, nbytes) > \
                            tbk.SHARED_MEMORY_BYTES
                        # and one range fewer would not fit either
                        assert tbk._slab_shared_bytes(G, -(-(hb + 1) // (J - 1)), S, B,
                                                      nbytes) > tbk.SHARED_MEMORY_BYTES


@pytest.mark.parametrize("rows_per_step", [1, 2, 3, 4, 5, 8, 16, 32])
def test_rows_per_step_caps_the_slab_runs(rows_per_step):
    """rows_per_step, where it is given, caps G (as _gather_rows took it
    before tiles); the rule halves G from there until every SM has a CTA."""
    for nb in (16, 64, 96, 512, 4096):
        G, D = tbk._slab_tiles(nb, 2, H100_SMS, 2, 128, 2, rows_per_step)
        assert G <= rows_per_step
        assert G == tbk._runs(nb, H100_SMS, min(tbk.SLAB_RUN_ROWS, rows_per_step))
        assert (D == 3) == (nb == 4096)   # elsewhere the runs alone are too few warps
    assert tbk._slab_tiles(4096, 2, H100_SMS, 2, 128, 2, 4) == (4, 3)


def test_slab_tiles_refuse_on_the_card_with_the_sizes():
    """Where no D within MAX_RANGES fits (f64 slabs at B=256, S=4, 4001
    diagonals), the rule raises with the sizes; the wrapper calls it only on
    the card."""
    with pytest.raises(ValueError, match=r"nb=8192, hb=4000, B=256, S=4, 8-byte slabs: runs of "
                                         r"G=8 leave room for 13 diagonals"):
        tbk._slab_tiles(8192, 4000, H100_SMS, 4, 256, 8)


@pytest.mark.parametrize("hb,S,B,nbytes,rows_per_step,want", [
    (2, 2, 128, 2, 0, 8),      # the bench shape: runs of 8, as before tiles
    (2, 2, 128, 4, 16, 16),    # rows_per_step=16: runs of 16 (the 16-warp instance)
    (24, 4, 128, 8, 0, 4),     # the window takes the room of the runs
    (5, 2, 128, 2, 3, 2),      # at most rows_per_step: 2 of 16, 8, 4, 2, 1
])
def test_slab_spill_runs(hb, S, B, nbytes, rows_per_step, want):
    """The spill form keeps its runs and one range (_slab_runs: _gather_rows'
    rule before tiles), and its window check stays on the card."""
    assert tbk._slab_runs(hb, S, B, nbytes, rows_per_step) == want


def test_slab_spill_runs_refuse_a_window_that_does_not_fit():
    with pytest.raises(ValueError, match="hb=64, B=128, S=2: the x window of one block row"):
        tbk._slab_runs(64, 2, 128, 8)


# ---------------------------------------------------------------------------
# the grid and the scratch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb,hb", [(8, 8), (8, 7), (64, 64), (37, 16), (9, 3), (4, 0),
                                   (128, 1), (512, 2)])
@pytest.mark.parametrize("G,D", [(None, None), (1, 1), (1, 2), (8, 1), (8, 3), (3, 2), (5, 7),
                                 (2, None), (8, None)], ids=str)
def test_slab_tiles_cover_every_held_slab_once(nb, hb, G, D):
    """Each sub-block of a slab that holds data (i + d < nb) lies in one
    tile, and every tile holds one: no CTA is launched only to return. A
    tile's x window (block rows r0 + d0 .. r0 + G - 1 + d1, G + D - 1 of
    them at most) holds every x_{i+d} its sub-blocks multiply. None: the
    rule's own tiles at S=2, B=128, bfloat16."""
    if G is None:
        G, D = tbk._slab_tiles(nb, hb, H100_SMS, 2, 128, 2)
    D = min(D or hb + 1, hb + 1)
    seen = {}
    for tile in _tile_table(nb, hb, G, D):
        j, r0 = tile
        d0, d1 = j * D, min(j * D + D - 1, hb)
        held = [(i, d) for i in range(r0, min(r0 + G, nb)) for d in range(d0, d1 + 1)
                if i + d < nb]
        assert held, tile
        for i, d in held:
            assert (i, d) not in seen
            assert 0 <= i + d - (r0 + d0) < G + D - 1
            seen[i, d] = tile
    assert sorted(seen) == [(i, d) for i in range(nb) for d in range(hb + 1) if i + d < nb]
    assert len(_tile_table(nb, hb, G, D)) == tbk._tile_count(nb, hb, G, D)


@pytest.mark.parametrize("nb,hb", [(64, 64), (16, 15), (4096, 2), (512, 2), (128, 1), (64, 1)])
@pytest.mark.parametrize("storage", sorted(STORAGE_BYTES))
def test_slab_tile_scratch_has_the_kernels_rows(nb, hb, storage):
    """At the rule's tiles the wrapper's scratch has the rows the kernel
    indexes (csrc/sym_band_tile.cuh::Scratch): Partials' F hb slots, then J
    nb rows of the tiles' row sums where J > 1."""
    G, D = tbk._slab_tiles(nb, hb, H100_SMS, 2, 128, STORAGE_BYTES[storage])
    J = -(-(hb + 1) // D)
    F = -(-nb // G) * min(hb, G)
    assert tbk._partials_shape(2, 2, nb, hb, G, 128, False, D) == (
        2, 2, F * hb + (J * nb if J > 1 else 0), 128)


# ---------------------------------------------------------------------------
# the schedule over tiles, emulated
# ---------------------------------------------------------------------------

def _emulate_slab_tiles(upper, x, G, D):
    """The kernel's matvec schedule over tiles of G block rows and D
    diagonals, in plain torch, in the accumulation type: for each tile, each
    warp's row part (column sums of its sub-blocks with x_{i+d} from the
    window) in its registers, the mirror sums (row sums with x_i) that stay
    in the run in shared memory, those that leave it in Partials' slots;
    the warp's row part plus its row's in-run mirror sums to y with one
    range, else to the tile's row of the scratch; then the fold in its fixed
    order (fold_partials with one range; fold_tiles' groups of 16-byte
    sources with more). The scratch, shaped by _partials_shape, starts as
    NaN: a slot read but never written poisons y, and each is written once.
    Returns y."""
    K, nb, rows, B = upper.shape
    hb, S = rows // B - 1, x.shape[1]
    acc = torch.promote_types(upper.dtype, torch.float32)
    J, H = -(-(hb + 1) // D), min(hb, G)
    F = -(-nb // G) * H
    P = max(S * B // (16 // acc.itemsize), 256) // (S * B // (16 // acc.itemsize))
    scratch = torch.full(tbk._partials_shape(K, S, nb, hb, G, B, False, D), float("nan"),
                         dtype=acc)
    T = upper.to(acc).reshape(K, nb, hb + 1, B, B)   # T[k, i, d, q, p] = U[i, d][p, q]
    xb = x.to(acc).reshape(K, S, nb, B)
    y = torch.full((K, S, nb, B), float("nan"), dtype=acc)

    def slot(t, d):   # Partials: row f(t), slot d - 1
        return ((t // G) * H + t % G) * hb + d - 1

    for j, r0 in _tile_table(nb, hb, G, D):
        cacc = torch.zeros(K, S, G, B, dtype=acc)   # each warp's row part
        ym = torch.zeros(K, S, G, B, dtype=acc)     # the mirror sums that stay in the run
        for d in range(j * D, min(j * D + D - 1, hb) + 1):
            for i in range(r0, min(r0 + G, nb - d)):
                cacc[:, :, i - r0] += torch.einsum("kqp,ksq->ksp", T[:, i, d], xb[:, :, i + d])
                if d:
                    m = torch.einsum("kqp,ksp->ksq", T[:, i, d], xb[:, :, i])
                    if i + d < r0 + G:
                        ym[:, :, i + d - r0] += m
                    else:
                        assert torch.isnan(scratch[:, :, slot(i + d, d)]).all()
                        scratch[:, :, slot(i + d, d)] = m
        for t in range(r0, min(r0 + G, nb)):
            own = ym[:, :, t - r0] + cacc[:, :, t - r0]
            if J == 1:
                y[:, :, t] = own
            else:
                assert torch.isnan(scratch[:, :, F * hb + j * nb + t]).all()
                scratch[:, :, F * hb + j * nb + t] = own
    for t in range(nb):
        o, r0 = t % G, t - t % G
        slots = [slot(t, d) for d in range(o + 1, min(hb, t) + 1)] if o < H else []
        if J == 1:
            for q in slots:
                y[:, :, t] += scratch[:, :, q]
            continue
        nj = min((nb - 1 - r0) // D + 1, J)
        src = [F * hb + q * nb + t for q in range(nj)] + slots
        groups = []
        for g in range(P):
            part = torch.zeros(K, S, B, dtype=acc)
            for q in src[g::P]:
                part += scratch[:, :, q]
            groups.append(part)
        tot = groups[0]
        for part in groups[1:]:
            tot = tot + part
        y[:, :, t] = tot
    return y.reshape(K, S, nb * B)


@pytest.fixture(scope="module")
def slab_triangle():
    """A dense panel's whole upper triangle at B=8, ragged M=60 (nb=8): the
    band of width M - 1 (hb = nb = 8) and one block narrower (hb = 7), as
    bfloat16, float32 and float64 slabs from the JAX package's packer and
    the port's, equal; x in each slab type, and Pallas in interpret mode
    over each (one chunk of nb block rows: >= hb)."""
    nb = 8
    band = simulate_ld_band(10000, TRI_M, TRI_M - 1, rng=np.random.default_rng(99))[0]
    x = np.random.default_rng(5).normal(size=(2, 2, nb * TRI_B))
    x[:, :, TRI_M:] = 0   # past M, as the operator pads it
    out, xs = {}, {}
    for storage in sorted(STORAGE_BYTES):
        xs[storage] = torch.from_numpy(x).to(getattr(torch, storage))
        for hb, b in ((nb, band), (nb - 1, band[:, TRI_B:-TRI_B])):
            jop = JSym.from_band(b, block_size=TRI_B, dtype=storage, layout="slab")
            op = SymBandedLD.from_band(b, block_size=TRI_B, K=2, dtype=storage, layout="slab",
                                       device="cpu")
            np.testing.assert_array_equal(op.upper[0].double().numpy(),
                                          np.asarray(jop.upper, np.float64)[0])
            assert (op.nb, op.hb) == (nb, hb)
            jx = jnp.asarray(xs[storage][:1].double().numpy(), jop.upper.dtype)
            jy, _ = _sym_slab_matvec_streamed(jop.upper, jx, nb, interpret=True,
                                              rows_per_step=nb)
            out[storage, hb] = op, np.asarray(jy, np.float64)
    return out, xs


@pytest.mark.parametrize("storage", sorted(STORAGE_BYTES))
@pytest.mark.parametrize("hb", [8, 7])
@pytest.mark.parametrize("G,D", [(None, None), (1, 1), (1, 9), (8, 1), (8, 3), (3, 2), (4, 5),
                                 (5, 9), (2, 4)], ids=str)
def test_slab_tiled_schedule_matches_plain_pallas_and_dense(slab_triangle, storage, hb, G, D):
    """The emulated schedule at the rule's (G, D) on an H100 (None) and at
    forced ones from one diagonal a tile to every one, on the whole
    triangle: against sym_slab_matvec_streamed_ref, Pallas in interpret mode
    and to_dense()."""
    ops, xs = slab_triangle
    op, jy = ops[storage, hb]
    x = xs[storage]
    if G is None:
        G, D = tbk._slab_tiles(op.nb, op.hb, H100_SMS, 2, TRI_B, STORAGE_BYTES[storage])
    D = min(D, hb + 1)
    got = _emulate_slab_tiles(op.upper, x, G, D)
    assert not torch.isnan(got).any()
    want = tbk.sym_slab_matvec_streamed_ref(op.upper, 0, x)
    scale = float(want.abs().max())
    assert _scaled(got, want, scale) <= TOL[storage]
    assert _scaled(got[:1], jy, scale) <= TOL[storage]
    dense = op.to_dense().double().numpy()
    M = dense.shape[-1]
    for k in range(2):
        assert _scaled(got[k, :, :M], x[k, :, :M].double().numpy() @ dense[k].T,
                       scale) <= TOL[storage]


# ---------------------------------------------------------------------------
# the CPU path does not depend on the card's shared memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", sorted(STORAGE_BYTES))
def test_cpu_slab_matvec_ignores_the_cards_shared_memory(slab_triangle, monkeypatch, storage):
    """With SHARED_MEMORY_BYTES far below what one block row's x window
    takes (before tiles the CPU wrapper and the plain version refused it),
    both still compute on the CPU, and equal Pallas in interpret mode and
    to_dense(); the card's rule is what refuses."""
    ops, xs = slab_triangle
    op, jy = ops[storage, 8]
    x = xs[storage]
    want = tbk.sym_slab_matvec_streamed_ref(op.upper, 0, x)
    monkeypatch.setattr(tbk, "SHARED_MEMORY_BYTES", 64)
    acc = 8 if storage == "float64" else 4
    assert 2 * TRI_B * (2 * 1 + 2 * op.hb) * acc > tbk.SHARED_MEMORY_BYTES   # no run fitted
    with pytest.raises(ValueError, match="the x window of one block row does not fit"):
        tbk._slab_runs(op.hb, 2, TRI_B, STORAGE_BYTES[storage])
    with pytest.raises(ValueError, match="has no tile"):
        tbk._slab_tiles(op.nb, op.hb, H100_SMS, 2, TRI_B, STORAGE_BYTES[storage])
    scale = float(want.abs().max())
    kernel, _, args, _ = tbk.band_kernel_of(dataclasses.replace(op, mode="streamed"), 2)
    assert kernel is tbk.sym_slab_matvec_streamed
    for got in (tbk.sym_slab_matvec_streamed(op.upper, 0, x),
                tbk.sym_slab_matvec_streamed_ref(op.upper, 8, x), kernel(*args, x)):
        assert torch.equal(got, want) or _scaled(got, want, scale) <= TOL[storage]
        assert _scaled(got[:1], jy, scale) <= TOL[storage]
        dense = op.to_dense().double().numpy()
        M = dense.shape[-1]
        for k in range(2):
            assert _scaled(got[k, :, :M], x[k, :, :M].double().numpy() @ dense[k].T,
                           scale) <= TOL[storage]


@pytest.fixture(scope="module")
def wide_slab():
    """A band wider than a run (M=253, bandwidth 121 at B=8: nb=32, hb=16)
    in float64 slabs, cut into two shards of 16 block rows; x and the JAX
    spill kernel's (y_l, carry) of each shard in interpret mode, with its
    chunk of 16 block rows (>= hb, as it must be) and the halo padded to
    it."""
    B, G = 8, 16
    band = simulate_ld_band(10000, 253, 121, rng=np.random.default_rng(121), dtype=np.float64)[0]
    jop = JSym.from_band(band, block_size=B, layout="slab")
    op = SymBandedLD.from_band(band, block_size=B, layout="slab", device="cpu")
    assert (op.nb, op.hb) == (32, 16)
    x = np.random.default_rng(7).normal(size=(1, 2, op.M))
    xpad = np.concatenate([x, np.zeros((1, 2, G * B))], axis=2)
    shards = []
    for j in range(2):
        rows = slice(j * G, (j + 1) * G)
        x_ext = xpad[:, :, j * G * B:(2 * j + 2) * G * B]
        jy, jc = _sym_slab_matvec_streamed(jop.upper[:, rows], jnp.asarray(x_ext), G,
                                           interpret=True, rows_per_step=G, spill=True)
        shards.append((op.upper[:, rows].contiguous(), torch.from_numpy(x_ext),
                       np.asarray(jy), np.asarray(jc)))
    return op, torch.from_numpy(x), shards


def test_cpu_slab_spill_ignores_the_cards_shared_memory(wide_slab, monkeypatch):
    """The spill wrapper and its plain version on the CPU, with
    SHARED_MEMORY_BYTES patched below one block row's window (refused before
    tiles): each shard's (y_l, carry) equals the JAX spill kernel's, and the
    shards composed equal the whole operator and to_dense() (f64, 1e-10)."""
    op, x, shards = wide_slab
    monkeypatch.setattr(tbk, "SHARED_MEMORY_BYTES", 64)
    with pytest.raises(ValueError, match="the x window of one block row does not fit"):
        tbk._slab_runs(op.hb, 2, 8, 8)
    want = x[0].numpy() @ op.to_dense()[0].numpy().T
    hbB = op.hb * 8
    for fn in (tbk.sym_slab_matvec_streamed_spill, tbk.sym_slab_matvec_streamed_spill_ref):
        ys, carry = [], None
        for upper, x_ext, jy, jc in shards:
            y_l, spilled = fn(upper, 16, x_ext)
            np.testing.assert_allclose(y_l.numpy(), jy, rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(spilled.numpy(), jc, rtol=1e-10, atol=1e-12)
            y_l = y_l.numpy()
            if carry is not None:
                y_l[:, :, :hbB] += carry
            carry = spilled.numpy()
            ys.append(y_l)
        assert np.all(carry == 0)
        np.testing.assert_allclose(np.concatenate(ys, axis=2)[0], want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("fn", ["sym_slab_matvec_streamed", "sym_slab_matvec_streamed_ref",
                                "sym_slab_matvec_streamed_spill",
                                "sym_slab_matvec_streamed_spill_ref"])
@pytest.mark.parametrize("G", [3, 1])
def test_cpu_slab_rows_per_step_errors_keep_jaxs_message(fn, G):
    """On the CPU only the JAX package's check of rows_per_step remains, with
    its message: it must divide nb and be >= hb (3 divides no 8; 1 < hb)."""
    band = simulate_ld_band(10000, 64, 20, rng=np.random.default_rng(4))[0]
    op = SymBandedLD.from_band(band, block_size=8, layout="slab", device="cpu")
    assert (op.nb, op.hb) == (8, 3)
    jop = JSym.from_band(band, block_size=8, layout="slab")
    message = f"rows_per_step={G} must divide nb=8 and be >= hb=3"
    with pytest.raises(ValueError, match=message):
        _sym_slab_matvec_streamed(jop.upper, jnp.ones((1, 2, 64)), 8, interpret=True,
                                  rows_per_step=G)
    x = torch.ones((1, 2, (8 + (3 if "spill" in fn else 0)) * 8), dtype=op.upper.dtype)
    with pytest.raises(ValueError, match=message):
        getattr(tbk, fn)(op.upper, G, x)
    assert math.isfinite(float(getattr(tbk, fn)(op.upper, 4, x)[0].sum()))
