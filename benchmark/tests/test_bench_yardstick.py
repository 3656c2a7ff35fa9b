"""The frozen byte count and the band kernels' time in a trace."""

import pytest
import torch

from benchmark import yardstick

H100 = "NVIDIA H100 80GB HBM3"


def held_blocks(nb, hb):
    # chip_smoke.py::held_blocks: the nb diagonal blocks and, for each
    # d = 1..hb, the nb - d that lie inside the matrix
    return nb + sum(max(nb - d, 0) for d in range(1, hb + 1))


def test_needed_bytes_row_1f():
    # PERF.md row 1f: a dense M=8192 panel's whole triangle, K=2, S=2: the
    # 2080 of 4160 slots a cohort that hold data
    assert held_blocks(64, 64) == 2080
    assert yardstick.needed_bytes(held_blocks(64, 64), 128, 8192, 2, 2, "int8") == 68_370_688


def test_needed_bytes_row_1():
    # PERF.md row 1, the bench shape (nb=4096, hb=2, K=1, S=2): 12,285 of
    # the 12,288 slots lie inside the matrix; row 1's 207,667,200 counts all
    # 12,288
    assert held_blocks(4096, 2) == 12285
    assert yardstick.needed_bytes(12285, 128, 524288, 1, 2, "int8") == 207_618_036
    assert yardstick.needed_bytes(12288, 128, 524288, 1, 2, "int8") == 207_667_200


def test_bound_counts_the_blocks_that_hold_data():
    assert yardstick.bound_s(12285, 128, 524288, 1, 2, "int8", "cpu") is None
    t = yardstick.bound_s(12285, 128, 524288, 1, 2, "int8", H100)
    assert abs(t - 207_618_036 / 3.35e12) < 1e-15
    # the bench panel's outer block diagonal is all zero: 8191 blocks hold data
    t = yardstick.bound_s(8191, 128, 524288, 1, 2, "int8", H100)
    assert abs(t - (8191 * 16388 + 6_291_456) / 3.35e12) < 1e-15


@pytest.mark.parametrize("storage", ["bfloat16", "float32", "int4"])
def test_a_storage_the_table_lacks_has_no_bound(storage):
    assert yardstick.needed_bytes(8191, 128, 524288, 1, 2, storage) is None
    assert yardstick.bound_s(8191, 128, 524288, 1, 2, storage, H100) is None
    assert yardstick.bound_s(None, 128, 524288, 1, 2, "int8", H100) is None


def test_the_panels_outer_block_diagonal_holds_no_data():
    # simulate_ld_band's R keeps its factor's bandwidth, half the storage's:
    # at bandwidth 256 and B=128 the blocks of the third diagonal are zero
    from benchmark import panel
    from benchmark.reference import int8_band

    p = panel.make_panel(2048, 256, 300000, 0.7, 0.01, 1, 0.6, 0.85, 1, "cpu")
    op = int8_band.Int8Band(p.band, 128, torch.float64)
    assert op.blocks_with_data == 16 + 15
    assert held_blocks(16, 2) == 16 + 15 + 14


def test_band_kernel_time_is_the_union_of_the_band_kernels():
    ops = [(0, 100, "void sym_band_int8_kernel<128, 2, false>(Args)"),
           # the fold, launched as a dependent, overlaps the kernel's tail
           (90, 120, "void fold_partials_kernel<Vec16<float> >(Scratch)"),
           (120, 400, "void at::native::elementwise_kernel<128, 2>(int)"),
           (400, 450, "void sym_band_int8_kernel<128, 2, true>(Args)"),
           (450, 460, "void fold_tiles_kernel<Vec16<float> >(Scratch)")]
    assert yardstick.band_kernel_s(ops) == pytest.approx(180e-9)
    trace = {"ops": ops, "ld_passes": 2}
    assert yardstick.ld_pass_s(trace) == pytest.approx(90e-9)
    assert yardstick.ld_pass_s({"ops": ops[2:3], "ld_passes": 2}) is None
    assert yardstick.ld_pass_s(None) is None
