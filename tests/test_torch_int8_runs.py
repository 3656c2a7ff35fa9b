"""The int8 kernel's read-once design, on the CPU: its plain versions against
the JAX package's Pallas kernel at a band wider than the kernel's runs, and
the wrapper's choice of run length as a plain function.

The kernel (csrc/sym_band_int8.cu) gives a CTA a run of G block rows, one
warp a block row, and sends the mirror sums that leave a run through a
scratch of partial sums (sym_band_tile.cuh::Partials) to a second launch,
or to the spill form's carry. It runs only on the card
(tests/test_torch_gpu.py, where forced run lengths reach every edge of the
partial sums and the fold); here the plain versions it is held against
there are held against Pallas in interpret mode (f32 sums of exact
bf16 * int8 products in another order: scaled 1e-5).
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
            assert tbk._partials_shape(2, 3, nb, hb, G, 64, spill) == (2, 3, F, hb, 64)
