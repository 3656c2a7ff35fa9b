"""The int8 kernel's read-once design, on the CPU: its plain versions against
the JAX package's Pallas kernel at a band wider than the kernel's runs, the
wrapper's choice of tiles as a plain function, and the kernel's schedule
over tiles emulated in plain torch on a dense panel's whole triangle. The
float diag kernel (csrc/sym_band_float.cu) takes the same tiles over
bfloat16, float32 and float64 blocks: its rule and the same emulation over
its blocks are held here too.

The kernel (csrc/sym_band_int8.cu) gives a CTA a tile of the band: a run of
G block rows, one warp a block row, and a range of D diagonals. It sends the
mirror sums that leave a run through a scratch of partial sums
(sym_band_tile.cuh::Partials), and with more than one range each tile's row
sums through a second part of the scratch, to a second launch (or the
spill form's carry). It runs only on the card (tests/test_torch_gpu.py,
where forced tiles reach every edge of the scratch and the fold); here the
plain versions it is held against there are held against Pallas in
interpret mode (f32 sums of exact bf16 * int8 products in another order:
scaled 1e-5), and so is the emulation of its schedule.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sgvamp_torch.ops import band_kernel as tbk
from sgvamp_torch.ops.band_kernel import SymBandedLD
from sgvamp_tpu.data.simulate import simulate_ld_band
from sgvamp_tpu.ops.band_kernel import SymBandedLD as JSym
from sgvamp_tpu.ops.band_kernel import _sym_band_matvec_streamed

SCALED_TOL = 1e-5
H100_SMS = 132

# B=8 keeps the unrolled Pallas loops small; M is ragged (nb=32, hb=16 at
# bandwidth 127), the Pallas chunk is 16 block rows (>= hb, as it must be),
# and the spill form cuts the panel into two shards of 16 block rows: wider
# than any run the kernel takes (G <= 8), so partial sums and carries both
# do their work.
WIDE_B, WIDE_M, WIDE_BW, WIDE_G = 8, 253, 127, 16


@pytest.fixture(scope="module")
def wide():
    band = simulate_ld_band(10000, WIDE_M, WIDE_BW, rng=np.random.default_rng(WIDE_BW))[0]
    jop = JSym.from_band(band, block_size=WIDE_B, dtype="int8")
    op = SymBandedLD.from_band(band, block_size=WIDE_B, dtype="int8", device="cpu")
    np.testing.assert_array_equal(op.upper.numpy(), np.asarray(jop.upper))
    np.testing.assert_array_equal(op.scales.numpy(), np.asarray(jop.scales))
    assert (op.nb, op.hb) == (32, 16)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 2, op.M))).to(torch.bfloat16)
    return jop, op, x


def _scaled(got, want, scale):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()) / scale


def test_wide_band_int8_plain_version_matches_pallas_and_dense(wide):
    jop, op, x = wide
    y = tbk.sym_band_matvec_int8_ref(op.upper, op.scales, x).numpy()
    jy, _ = _sym_band_matvec_streamed(jop.upper, jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                      op.nb, interpret=True, rows_per_step=WIDE_G,
                                      scales=jop.scales)
    scale = float(np.abs(y).max())
    assert _scaled(y, jy, scale) <= SCALED_TOL
    dense = op.to_dense()[0].numpy().astype(np.float64)
    assert _scaled(y[0], x[0].double().numpy() @ dense.T, scale) <= SCALED_TOL
    # a run of 8 block rows is shorter than hb: the JAX kernel, which carries
    # mirror terms one chunk ahead, refuses it (the port's kernel does not)
    with pytest.raises(ValueError, match="must divide nb=32 and be >= hb=16"):
        _sym_band_matvec_streamed(jop.upper, jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                  op.nb, interpret=True, rows_per_step=8, scales=jop.scales)


def test_wide_band_int8_spill_plain_version_matches_pallas_over_two_shards(wide):
    jop, op, x = wide
    B, hbB, nb_l = WIDE_B, op.hb * WIDE_B, op.nb // 2
    whole = tbk.sym_band_matvec_int8_ref(op.upper, op.scales, x).numpy()
    scale = float(np.abs(whole).max())
    xpad = torch.cat([x, x.new_zeros(1, 2, WIDE_G * B)], dim=2)
    ys, carry = [], None
    for j in range(2):
        rows = slice(j * nb_l, (j + 1) * nb_l)
        x_ext = xpad[:, :, j * nb_l * B:(j * nb_l + nb_l + WIDE_G) * B]   # halo, padded to a chunk
        y_l, spilled = tbk.sym_band_matvec_int8_spill_ref(
            op.upper[:, rows].contiguous(), op.scales[:, rows].contiguous(), x_ext)
        jy, jc = _sym_band_matvec_streamed(
            jop.upper[:, rows], jnp.asarray(x_ext.float().numpy(), jnp.bfloat16), nb_l,
            interpret=True, rows_per_step=WIDE_G, spill=True, scales=jop.scales[:, rows])
        assert spilled.shape == (1, 2, hbB)
        assert _scaled(y_l, jy, scale) <= SCALED_TOL
        assert _scaled(spilled, jc, scale) <= SCALED_TOL
        y_l = y_l.numpy()
        if j:
            y_l[:, :, :hbB] += carry
        carry = spilled.numpy()
        ys.append(y_l)
    assert np.all(carry == 0)   # what leaves the panel: exact zeros
    assert _scaled(np.concatenate(ys, axis=2), whole, scale) <= SCALED_TOL


@pytest.mark.parametrize("nb,sms,want", [
    (4096, H100_SMS, 8),   # the bench shape, M=524288
    (1024, H100_SMS, 4),   # one shard of four: 128 runs of 8 would idle 4 SMs
    (512, H100_SMS, 2),    # the CLI's M=65536
    (2048, H100_SMS, 8),
    (1056, H100_SMS, 8),   # 132 runs of 8: one a SM
    (100, H100_SMS, 1),
    (4096, 8, 8),
    (5, 1, 8),
])
def test_int8_runs_choice(nb, sms, want):
    assert tbk._int8_runs(nb, sms) == want


@pytest.mark.parametrize("sms", [1, 16, 108, 132, 264])
def test_int8_runs_fit_a_cta_and_fill_the_card(sms):
    for nb in list(range(1, 70)) + [127, 128, 500, 512, 1000, 1024, 1500, 2048, 4096, 8191]:
        G = tbk._int8_runs(nb, sms)
        assert G in (1, 2, 4, 8) and G <= tbk.INT8_MAX_RUN_ROWS <= tbk.MAX_ROWS_PER_CTA
        # the longest run that gives every SM a CTA
        assert G == 1 or math.ceil(nb / G) >= sms
        assert G == tbk.INT8_MAX_RUN_ROWS or math.ceil(nb / (2 * G)) < sms
        for B in (64, 128, 256):
            # each warp's ring: 3 chunks of up to 4 row groups of 512 bytes
            # (B * B / 512 row groups a block)
            ring = G * 3 * min(4, B * B // 512) * 512
            for S in range(1, 5):   # x, row and mirror sums of the run
                assert ring + 3 * G * S * B * 4 <= tbk.SHARED_MEMORY_BYTES


@pytest.mark.parametrize("spill", [False, True], ids=["matvec", "spill"])
@pytest.mark.parametrize("hb", [1, 2, 3, 16])
def test_int8_partials_are_written_once_and_all_folded(hb, spill):
    """The scratch that _partials_shape sizes for the int8 kernel's runs
    (the wrapper's choice, and the shortest and longest) has the F rows of
    sym_band_tile.cuh::Partials, which the kernel writes and the fold reads:
    C H + (hb in the spill form), with C runs of G and H = min(hb, G).
    That each mirror sum that leaves its run is written once and folded is
    held on the card, at forced run lengths."""
    for nb in sorted({hb, hb + 1, 7, 37, 512, 1024} - {0}):
        for G in {tbk._int8_runs(nb, H100_SMS), 1, tbk.INT8_MAX_RUN_ROWS}:
            C, H = -(-nb // G), min(hb, G)
            F = C * H + (hb if spill else 0)
            assert tbk._partials_shape(2, 3, nb, hb, G, 64, spill) == (2, 3, F * hb, 64)


# ---------------------------------------------------------------------------
# tiles of the band: the rule, the grid, the scratch and the schedule
# ---------------------------------------------------------------------------

def _tile_table(nb, hb, G, D):
    """The tiles of the matvec grid as csrc/sym_band_tile.cuh::tiles_of lists
    them: range by range, the runs whose first block row has data at the
    range's first diagonal, in order; [(j, r0), ...]."""
    J, runs = -(-(hb + 1) // D), -(-nb // G)
    return [(j, c * G) for j in range(J)
            for c in range(min(runs, (nb - 1 - j * D) // G + 1 if j * D <= nb - 1 else 0))]


@pytest.mark.parametrize("nb,hb", [(4096, 2), (1024, 2)])
def test_int8_tiles_keep_the_runs_where_they_fill_the_card(nb, hb):
    """At the bench shape and at one shard of its four the rule gives
    today's schedule: the runs of _int8_runs, every diagonal in one range."""
    assert tbk._int8_tiles(nb, hb, H100_SMS) == (tbk._int8_runs(nb, H100_SMS), hb + 1)


@pytest.mark.parametrize("nb,hb", [(64, 64), (64, 63), (16, 15), (16, 16), (512, 2), (37, 16),
                                   (300, 40), (5, 0), (1, 0)])
@pytest.mark.parametrize("sms", [16, 132])
def test_int8_tiles_put_enough_warps_on_the_card(nb, hb, sms):
    """The fewest ranges whose tiles hold INT8_MIN_WARPS_PER_SM warps an SM,
    or the most ranges there may be where none does; the ranges even
    (D = ceil((hb + 1) / J)); every B and S within the shared memory."""
    G, D = tbk._int8_tiles(nb, hb, sms)
    assert G == tbk._int8_runs(nb, sms) and 1 <= D <= hb + 1
    J = -(-(hb + 1) // D)
    assert D == -(-(hb + 1) // J) and J <= tbk.MAX_RANGES
    want = tbk.INT8_MIN_WARPS_PER_SM * sms

    def warps(j):
        return G * tbk._tile_count(nb, hb, G, -(-(hb + 1) // j))

    assert warps(J) >= want or J == min(hb + 1, tbk.MAX_RANGES)
    assert J == 1 or warps(J - 1) < want
    assert warps(J) == G * len(_tile_table(nb, hb, G, D))
    for B in (64, 128, 256):
        for S in range(1, 5):
            ring = G * 3 * min(4, B * B // 512) * 512
            assert ring + 3 * G * S * B * 4 <= tbk.SHARED_MEMORY_BYTES
    if (nb, hb, sms) == (64, 64, 132):   # the dense panel of chip_smoke.py phase 10b
        assert (G, D) == (1, 2) and warps(J) == 1056
    if (nb, hb, sms) == (512, 2, 132):   # the CLI's M=65536: 2-6% faster than (2, 3) on an H100
        assert (G, D) == (2, 2)


@pytest.mark.parametrize("nb,hb", [(8, 8), (8, 7), (64, 64), (37, 16), (9, 3), (4, 0)])
@pytest.mark.parametrize("G,D", [(1, 1), (1, 2), (8, 1), (8, 3), (3, 2), (5, 7), (2, None),
                                 (8, None)])
def test_int8_tiles_cover_every_held_block_once(nb, hb, G, D):
    """Each stored block that holds data (i + d < nb) lies in one tile of the
    grid, and every tile holds one: no CTA is launched only to return."""
    D = min(D or hb + 1, hb + 1)
    seen = {}
    for tile in _tile_table(nb, hb, G, D):
        j, r0 = tile
        held = [(i, d) for i in range(r0, min(r0 + G, nb))
                for d in range(j * D, min(j * D + D - 1, hb) + 1) if i + d < nb]
        assert held, tile
        for b in held:
            assert b not in seen
            seen[b] = tile
    assert sorted(seen) == [(i, d) for i in range(nb) for d in range(hb + 1) if i + d < nb]
    assert len(_tile_table(nb, hb, G, D)) == tbk._tile_count(nb, hb, G, D)


@pytest.mark.parametrize("hb", [1, 2, 16, 64])
def test_int8_tile_scratch_has_the_kernels_rows(hb):
    """_partials_shape with D: Partials' F rows of hb slots (C runs of G,
    H = min(hb, G) of their rows), then with J > 1 ranges J nb rows of the
    tiles' row sums, as csrc/sym_band_tile.cuh::Scratch counts them; one
    range leaves the float kernels' F hb rows."""
    for nb in sorted({hb, hb + 1, 7, 64, 1024}):
        for G in (1, 3, 8):
            F = -(-nb // G) * min(hb, G)
            assert tbk._partials_shape(2, 3, nb, hb, G, 64, False, hb + 1) == (2, 3, F * hb, 64)
            for D in sorted({1, 2, hb} - {hb + 1}):
                J = -(-(hb + 1) // D)
                assert J > 1
                assert tbk._partials_shape(2, 3, nb, hb, G, 64, False, D) == (
                    2, 3, F * hb + J * nb, 64)


def _emulate_tiles(upper, scales, x, G, D):
    """The kernels' matvec schedule over tiles of G block rows and D
    diagonals, in plain torch (f32): int8 blocks with their scales, or
    bfloat16 / float32 blocks with scales None. Each tile's row sums and the
    mirror sums that stay in its run in its own buffers, the mirror sums
    that leave it in Partials' slots, with J > 1 ranges the tiles' rows in
    the second part of the scratch, then the fold in its fixed order
    (fold_partials with one range; fold_tiles' groups of sources with
    more). The scratch, shaped by _partials_shape, starts as NaN: a slot
    read but never written poisons y, and each is written once. Returns y
    and the scratch."""
    K, nb, nslot, B, _ = upper.shape
    hb, S = nslot - 1, x.shape[1]
    J, H, P = -(-(hb + 1) // D), min(hb, G), 256 // (S * B // 4)
    F = -(-nb // G) * H
    scratch = torch.full(tbk._partials_shape(K, S, nb, hb, G, B, False, D), float("nan"))
    xb = x.float().reshape(K, S, nb, B)
    y = torch.full((K, S, nb, B), float("nan"))

    def slot(t, d):   # Partials: row f(t), slot d - 1
        return ((t // G) * H + t % G) * hb + d - 1

    for j, r0 in _tile_table(nb, hb, G, D):
        own = torch.zeros(K, S, G, B)   # row sums + the mirror sums that stay in the run
        for d in range(j * D, min(j * D + D - 1, hb) + 1):
            for i in range(r0, min(r0 + G, nb - d)):
                u = upper[:, i, d].float()
                sc = 1.0 if scales is None else scales[:, i, d, None, None]
                own[:, :, i - r0] += sc * torch.einsum("kpq,ksq->ksp", u, xb[:, :, i + d])
                if d:
                    m = sc * torch.einsum("kpq,ksp->ksq", u, xb[:, :, i])
                    if i + d < r0 + G:
                        own[:, :, i + d - r0] += m
                    else:
                        assert torch.isnan(scratch[:, :, slot(i + d, d)]).all()
                        scratch[:, :, slot(i + d, d)] = m
        for t in range(r0, min(r0 + G, nb)):
            if J == 1:
                y[:, :, t] = own[:, :, t - r0]
            else:
                assert torch.isnan(scratch[:, :, F * hb + j * nb + t]).all()
                scratch[:, :, F * hb + j * nb + t] = own[:, :, t - r0]
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
            acc = torch.zeros(K, S, B)
            for q in src[g::P]:
                acc += scratch[:, :, q]
            groups.append(acc)
        tot = groups[0]
        for acc in groups[1:]:
            tot = tot + acc
        y[:, :, t] = tot
    return y.reshape(K, S, nb * B), scratch


@pytest.fixture(scope="module")
def triangle():
    """A dense panel's whole upper triangle at B=8, ragged M=60 (nb=8): the
    band of width M - 1 (hb = nb = 8) and one block narrower (hb = 7 = nb -
    1), both from the JAX package's packer and the port's, equal; x, and
    Pallas in interpret mode over each (one chunk of nb block rows: >= hb)."""
    M, nb = 60, 8
    band = simulate_ld_band(10000, M, M - 1, rng=np.random.default_rng(99))[0]
    x = np.random.default_rng(5).normal(size=(2, 2, nb * WIDE_B))
    x[:, :, M:] = 0   # past M, as the operator pads it
    x = torch.from_numpy(x).to(torch.bfloat16)
    out = {}
    for hb, b in ((nb, band), (nb - 1, band[:, WIDE_B:-WIDE_B])):
        jop = JSym.from_band(b, block_size=WIDE_B, dtype="int8")
        op = SymBandedLD.from_band(b, block_size=WIDE_B, K=2, dtype="int8", device="cpu")
        np.testing.assert_array_equal(op.upper[0].numpy(), np.asarray(jop.upper)[0])
        assert (op.nb, op.hb) == (nb, hb)
        jy, _ = _sym_band_matvec_streamed(jop.upper, jnp.asarray(x[:1].float().numpy(),
                                                                 jnp.bfloat16),
                                          nb, interpret=True, rows_per_step=nb,
                                          scales=jop.scales)
        out[hb] = op, np.asarray(jy)
    return out, x


@pytest.mark.parametrize("hb", [8, 7])
@pytest.mark.parametrize("G,D", [(None, None), (1, 1), (1, 9), (8, 1), (8, 3), (3, 2), (4, 5),
                                 (5, 9), (2, 4)], ids=lambda v: str(v))
def test_tiled_schedule_matches_plain_pallas_and_dense(triangle, hb, G, D):
    """The emulated schedule over tiles, at the rule's own (G, D) on an H100
    (None) and at forced ones from one diagonal a tile to every one, on the
    whole triangle: against sym_band_matvec_int8_ref, Pallas in interpret
    mode and to_dense(), scaled 1e-5."""
    ops, x = triangle
    op, jy = ops[hb]
    if G is None:
        G, D = tbk._int8_tiles(op.nb, op.hb, H100_SMS)
    D = min(D, hb + 1)
    got, _ = _emulate_tiles(op.upper, op.scales, x, G, D)
    assert not torch.isnan(got).any()
    want = tbk.sym_band_matvec_int8_ref(op.upper, op.scales, x)
    scale = float(want.abs().max())
    assert _scaled(got, want, scale) <= SCALED_TOL
    assert _scaled(got[:1], jy, scale) <= SCALED_TOL
    dense = op.to_dense().numpy().astype(np.float64)
    M = dense.shape[-1]
    for k in range(2):
        assert _scaled(got[k, :, :M], x[k, :, :M].double().numpy() @ dense[k].T,
                       scale) <= SCALED_TOL


# ---------------------------------------------------------------------------
# the float diag kernel's tiles: the rule and the schedule over float blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb,hb,spill", [(4096, 2, False), (1024, 2, True), (1024, 16, True),
                                         (8, 7, True)])
def test_float_tiles_keep_the_runs_where_they_fill_the_card(nb, hb, spill):
    """At the bench shape the matvec form, and on one shard of its four (or
    any shard) the spill form, keep the schedule before tiles: runs of
    DIAG_RUN_ROWS block rows, every diagonal in one range."""
    assert tbk._float_tiles(nb, hb, H100_SMS, spill) == (tbk.DIAG_RUN_ROWS, hb + 1)


@pytest.mark.parametrize("nb,hb", [(64, 64), (64, 63), (16, 15), (16, 16), (512, 2), (37, 16),
                                   (300, 40), (5, 0), (1, 0)])
@pytest.mark.parametrize("sms", [16, 132])
def test_float_tiles_put_enough_warps_on_the_card(nb, hb, sms):
    """The runs of DIAG_RUN_ROWS halved until every SM has a CTA; the fewest
    even ranges whose tiles hold FLOAT_MIN_WARPS_PER_SM warps an SM, or the
    most there may be; every B, S and block type within the shared memory
    (3 G S B accumulator words, f64 for f64 blocks)."""
    G, D = tbk._float_tiles(nb, hb, sms)
    assert G in (1, 2, 4, 8) and G <= tbk.DIAG_RUN_ROWS
    assert G == 1 or math.ceil(nb / G) >= sms
    assert G == tbk.DIAG_RUN_ROWS or math.ceil(nb / (2 * G)) < sms
    J = -(-(hb + 1) // D)
    assert 1 <= D <= hb + 1 and D == -(-(hb + 1) // J) and J <= tbk.MAX_RANGES
    want = tbk.FLOAT_MIN_WARPS_PER_SM * sms

    def warps(j):
        return G * tbk._tile_count(nb, hb, G, -(-(hb + 1) // j))

    assert warps(J) >= want or J == min(hb + 1, tbk.MAX_RANGES)
    assert J == 1 or warps(J - 1) < want
    assert warps(J) == G * len(_tile_table(nb, hb, G, D))
    assert 3 * G * 4 * 256 * 8 <= tbk.SHARED_MEMORY_BYTES
    if (nb, hb, sms) == (64, 64, 132):   # row 1g: chip_smoke.py phase 10b's panel
        assert (G, D) == (1, 2) and warps(J) == 1056
    if (nb, hb, sms) == (16, 15, 132):
        assert (G, D) == (1, 1)


@pytest.mark.parametrize("nb,hb", [(64, 64), (16, 15), (4096, 2), (512, 2), (128, 1), (64, 1)])
def test_float_tile_scratch_has_the_kernels_rows(nb, hb):
    """At the rule's tiles the wrapper's scratch has the rows the float
    kernel indexes (csrc/sym_band_tile.cuh::Scratch): Partials' F hb slots,
    then J nb rows of the tiles' row sums where J > 1."""
    G, D = tbk._float_tiles(nb, hb, H100_SMS)
    J = -(-(hb + 1) // D)
    F = -(-nb // G) * min(hb, G)
    assert tbk._partials_shape(2, 2, nb, hb, G, 128, False, D) == (
        2, 2, F * hb + (J * nb if J > 1 else 0), 128)


@pytest.fixture(scope="module")
def float_triangle():
    """The triangle fixture's panel (B=8, M=60, nb=8; hb = 8 and 7) packed
    as bfloat16 and float32 blocks by the JAX package and the port, equal;
    x in each block type, and Pallas in interpret mode over each."""
    M, nb = 60, 8
    band = simulate_ld_band(10000, M, M - 1, rng=np.random.default_rng(99))[0]
    x = np.random.default_rng(5).normal(size=(2, 2, nb * WIDE_B))
    x[:, :, M:] = 0
    out, xs = {}, {}
    for storage in ("bfloat16", "float32"):
        xs[storage] = torch.from_numpy(x).to(getattr(torch, storage))
        for hb, b in ((nb, band), (nb - 1, band[:, WIDE_B:-WIDE_B])):
            jop = JSym.from_band(b, block_size=WIDE_B, dtype=storage)
            op = SymBandedLD.from_band(b, block_size=WIDE_B, K=2, dtype=storage, device="cpu")
            np.testing.assert_array_equal(op.upper[0].float().numpy(),
                                          np.asarray(jop.upper, np.float32)[0])
            assert (op.nb, op.hb) == (nb, hb)
            jx = jnp.asarray(xs[storage][:1].float().numpy(), jop.upper.dtype)
            jy, _ = _sym_band_matvec_streamed(jop.upper, jx, nb, interpret=True,
                                              rows_per_step=nb)
            out[storage, hb] = op, np.asarray(jy, np.float64)
    return out, xs


@pytest.mark.parametrize("storage", ["bfloat16", "float32"])
@pytest.mark.parametrize("hb", [8, 7])
@pytest.mark.parametrize("G,D", [(None, None), (1, 1), (1, 9), (8, 1), (8, 3), (3, 2), (4, 5),
                                 (5, 9), (2, 4)], ids=lambda v: str(v))
def test_float_tiled_schedule_matches_plain_pallas_and_dense(float_triangle, storage, hb, G, D):
    """The emulated schedule over float blocks, at the float rule's (G, D)
    on an H100 (None) and at forced ones from one diagonal a tile to every
    one, on the whole triangle: against sym_band_matvec_ref, Pallas in
    interpret mode and to_dense(), scaled 1e-5 (f32 sums of the same
    products in other orders)."""
    ops, xs = float_triangle
    op, jy = ops[storage, hb]
    x = xs[storage]
    if G is None:
        G, D = tbk._float_tiles(op.nb, op.hb, H100_SMS)
    D = min(D, hb + 1)
    got, _ = _emulate_tiles(op.upper, None, x, G, D)
    assert not torch.isnan(got).any()
    want = tbk.sym_band_matvec_ref(op.upper, x)
    scale = float(want.abs().max())
    assert _scaled(got, want, scale) <= SCALED_TOL
    assert _scaled(got[:1], jy, scale) <= SCALED_TOL
    dense = op.to_dense().double().numpy()
    M = dense.shape[-1]
    for k in range(2):
        assert _scaled(got[k, :, :M], x[k, :, :M].double().numpy() @ dense[k].T,
                       scale) <= SCALED_TOL
