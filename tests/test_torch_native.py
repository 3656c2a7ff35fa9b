"""The port's host C++ ingestion (sgvamp_torch.native) against the JAX
package's native library and the port's own numpy versions, on the CPU.

Every function must give the same bits on the same numpy inputs: the .ld
parser's triplets (and its error texts), CSR -> band in the four index /
value dtype pairs, triplets -> band in float32 and float64, and the int8
and hybrid block packers at B = 64 and 128 over a ragged M.
"""

import os

import numpy as np
import pytest
import scipy.sparse
import torch

from sgvamp_torch import native as tnat
from sgvamp_torch.data import loaders as tld
from sgvamp_torch.ops import band_kernel as tbk
from sgvamp_torch.ops.band_kernel import SymBandedLD
from sgvamp_tpu import native as jnat
from sgvamp_tpu.data import loaders as jld
from sgvamp_tpu.data.simulate import simulate_ld_band


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8) if a.dtype.kind == "f" else a


def assert_same_bits(*arrays):
    for a in arrays[1:]:
        assert a.shape == arrays[0].shape and a.dtype == arrays[0].dtype
        np.testing.assert_array_equal(_bits(a), _bits(arrays[0]))


@pytest.fixture(scope="module")
def band():
    """A ragged float32 band: M = 1000 is no multiple of 64 or 128."""
    return simulate_ld_band(10000, 1000, 150, rng=np.random.default_rng(0))[0]


@pytest.fixture(scope="module")
def triplets():
    """One-sided LD triplets over M = 300 with a pair given twice, a pair
    given in both orders, a diagonal entry and pairs far outside bw = 20."""
    rng = np.random.default_rng(1)
    M = 300
    a = rng.integers(0, M, 4000)
    b = np.clip(a + rng.integers(-30, 31, a.size), 0, M - 1)
    v = rng.uniform(-1, 1, a.size)
    a = np.concatenate([a, [5, 7, 9, 11]])
    b = np.concatenate([b, [6, 6, 9, 290]])
    v = np.concatenate([v, [0.25, -0.5, 0.75, 0.1]])
    a = np.concatenate([a, [5, 6]])
    b = np.concatenate([b, [6, 7]])
    v = np.concatenate([v, [0.3, 0.4]])
    return a.astype(np.int64), b.astype(np.int64), v, M


def test_library_builds_into_the_build_directory():
    assert tnat.available()
    path = tnat.library_path()
    assert os.path.dirname(path) == tnat.BUILD_DIR and os.path.exists(path)
    assert os.path.basename(path).startswith("libldparse_")
    assert tnat.build() == path          # an unchanged source is not rebuilt
    assert tnat.get_lib() is tnat.get_lib()


def test_build_without_gxx_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tnat, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnat, "library_path", lambda: str(tmp_path / "lib.so"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tnat.build()
    assert os.listdir(tmp_path) == []    # no partial library left behind


@pytest.mark.parametrize("B", [64, 128])
@pytest.mark.parametrize("what", ["int8", "hybrid"])
def test_packers_bit_identical(band, B, what):
    ours = (tnat.band_pack_i8 if what == "int8" else tnat.band_pack_hybrid)(band, B)
    jax_native = (jnat.band_pack_i8 if what == "int8" else jnat.band_pack_hybrid)(band, B)
    plain = (tbk.pack_int8 if what == "int8" else tbk.pack_hybrid)(band, B)
    for i in range(2):
        assert_same_bits(ours[i], jax_native[i], plain[i])
    nb, hb = -(-1000 // B), -(-150 // B)
    assert ours[0].shape[:2] == (nb, hb + 1 + (what == "hybrid"))


def test_packers_refuse_what_they_cannot_pack(band):
    assert tnat.band_pack_hybrid(band, 63) is None        # the hybrid layout needs an even B
    assert tnat.band_pack_i8(band.astype(np.float64), 64) is None


@pytest.mark.parametrize("what", ["int8", "hybrid"])
def test_from_band_takes_the_native_packer_and_matches_the_numpy_one(band, what, monkeypatch,
                                                                     caplog):
    with caplog.at_level("INFO", logger="sgvamp"):
        op = SymBandedLD.from_band(band, block_size=64, K=2, dtype=what, device="cpu")
    assert f"{what} blocks packed through the native path" in caplog.messages
    monkeypatch.setattr(tnat, "get_lib", lambda: None)
    caplog.clear()
    with caplog.at_level("INFO", logger="sgvamp"):
        ref = SymBandedLD.from_band(band, block_size=64, K=2, dtype=what, device="cpu")
    assert f"{what} blocks packed through the numpy path" in caplog.messages
    assert torch.equal(op.upper, ref.upper) and torch.equal(op.scales, ref.scales)
    assert op.hybrid == ref.hybrid == (what == "hybrid")


def _noncanonical(idx_dtype, val_dtype, M=400, bw=40, seed=2):
    """A symmetric banded CSR with unsorted columns and duplicate entries
    (scipy sums them on use), built without canonicalizing."""
    rng = np.random.default_rng(seed)
    A = scipy.sparse.random(M, M, density=0.05, random_state=seed, format="coo")
    A = scipy.sparse.coo_matrix(A + A.T)
    keep = np.abs(A.row - A.col) <= bw + 10          # some entries beyond bw
    row, col, dat = A.row[keep], A.col[keep], A.data[keep]
    dup = rng.choice(row.size, 50, replace=False)
    row = np.concatenate([row, row[dup], np.arange(M)])
    col = np.concatenate([col, col[dup], np.arange(M)])
    dat = np.concatenate([dat, rng.uniform(-1, 1, 50), np.ones(M)])
    order = rng.permutation(row.size)
    row, col, dat = row[order], col[order], dat[order]
    order = np.argsort(row, kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=M))])
    R = scipy.sparse.csr_matrix(
        (dat[order].astype(val_dtype), col[order].astype(idx_dtype), indptr.astype(idx_dtype)),
        shape=(M, M))
    assert not R.has_canonical_format
    return R, bw


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("val_dtype", [np.float32, np.float64])
def test_csr_to_band_bit_identical(idx_dtype, val_dtype):
    R, bw = _noncanonical(idx_dtype, val_dtype)
    arrays = [R.indptr.copy(), R.indices.copy(), R.data.copy()]
    for bandwidth in (None, bw):
        got = tld.csr_to_band(R, bandwidth)
        want = jld.csr_to_band(R, bandwidth)
        plain = tld.csr_to_band_numpy(R, bandwidth)
        assert got[1:] == want[1:] == plain[1:]
        assert_same_bits(got[0], want[0], plain[0])
    for a, b in zip(arrays, (R.indptr, R.indices, R.data)):
        np.testing.assert_array_equal(a, b)           # canonicalized on a copy
    # the raw entry points on the raw (non-canonical) arrays: last write wins
    ours = tnat.csr_to_band(R.indptr, R.indices, R.data, R.shape[0], bw)
    theirs = jnat.csr_to_band(R.indptr, R.indices, R.data, R.shape[0], bw)
    assert ours[1] == theirs[1] > 0
    assert_same_bits(ours[0], theirs[0])
    assert (tnat.csr_max_bandwidth(R.indptr, R.indices, R.shape[0])
            == jnat.csr_max_bandwidth(R.indptr, R.indices, R.shape[0]) == bw + 10)


def test_csr_entry_points_refuse_dtypes_they_have_no_symbol_for():
    R, bw = _noncanonical(np.int32, np.float32)
    assert tnat.csr_to_band(R.indptr.astype(np.int64), R.indices, R.data, 400, bw) is None
    assert tnat.csr_to_band(R.indptr, R.indices, R.data.astype(np.float16), 400, bw) is None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bw", [20, 35])
def test_triplets_to_band_bit_identical(triplets, dtype, bw):
    a, b, v, M = triplets
    ours = tnat.triplets_to_band(a, b, v, M, bw, dtype=dtype)
    theirs = jnat.triplets_to_band(a, b, v, M, bw, dtype=dtype)
    plain = tld.triplets_to_band_numpy(a, b, v, M, bw, dtype=dtype)
    assert ours[1] == theirs[1] == plain[1] > 0
    assert_same_bits(ours[0], theirs[0], plain[0])
    # the pair given twice and the pair given in both orders: the last write wins
    assert ours[0][5, bw + 1] == ours[0][6, bw - 1] == dtype(0.3)
    assert ours[0][6, bw + 1] == ours[0][7, bw - 1] == dtype(0.4)
    assert ours[0][9, bw] == dtype(0.75)      # a diagonal entry replaces the unit diagonal
    assert tnat.max_bandwidth(a, b) == jnat.max_bandwidth(a, b) == 279


def test_triplets_to_band_refuses_other_dtypes(triplets):
    a, b, v, M = triplets
    with pytest.raises(ValueError, match="float32 or float64"):
        tnat.triplets_to_band(a, b, v, M, 20, dtype=np.float16)


VARIANTS = [f"rs{i}" for i in range(12)]
LD_BODY = [("rs0", "rs1", "0.5"), ("rs2", "rs5", "-0.125"), ("rs11", "rs3", "1e-3"),
           ("rs4", "rs4", "0.9999999999999999"),
           ("rs7", "rs8", "-0.333333333333333314829616256247")]


def _ld_text(style: str) -> str:
    if style == "plink":      # PLINK's aligned output: leading spaces, padded columns
        head = " CHR_A         BP_A        SNP_A  CHR_B         BP_B        SNP_B           R\n"
        rows = [f"{1:>6}{100 + i:>13}{a:>13}{1:>7}{200 + i:>13}{b:>13} {r:>11}\n"
                for i, (a, b, r) in enumerate(LD_BODY)]
        return head + "".join(rows)
    if style == "tabs_crlf_blank":
        rows = [f"1\t{100 + i}\t{a}\t1\t{200 + i}\t{b}\t{r}\r\n"
                for i, (a, b, r) in enumerate(LD_BODY)]
        return ("CHR_A\tBP_A\tSNP_A\tCHR_B\tBP_B\tSNP_B\tR\r\n\r\n" + rows[0] + "\n"
                + "".join(rows[1:]) + "\n\n")
    # extra columns, in another order
    rows = [f"{r} x{i} {b} 7 {a} 8\n" for i, (a, b, r) in enumerate(LD_BODY)]
    return "R EXTRA SNP_B DP SNP_A R2\n" + "".join(rows)


@pytest.mark.parametrize("style", ["plink", "tabs_crlf_blank", "extra_columns"])
def test_parse_ld_bit_identical(tmp_path, style):
    path = tmp_path / "t.ld"
    path.write_text(_ld_text(style))
    ours = tnat.parse_ld(str(path), VARIANTS)
    theirs = jnat.parse_ld(str(path), VARIANTS)
    plain = tld.parse_ld_numpy(str(path), VARIANTS)
    for i in range(3):
        assert_same_bits(ours[i], theirs[i], plain[i])
    np.testing.assert_array_equal(ours[0], [0, 2, 11, 4, 7])
    np.testing.assert_array_equal(ours[1], [1, 5, 3, 4, 8])


@pytest.mark.parametrize("text,error", [
    ("SNP_A SNP_B R\nrs0 rs1\n", "short line 2"),
    ("SNP_A SNP_B R\nrs0 rs1 0.5\n\nrs0 rsX 0.5\n", "unknown SNP on line 4"),
    ("SNP_A SNP_B R2\nrs0 rs1 0.5\n", "missing SNP_A/SNP_B/R columns in .ld header"),
    ("", "missing SNP_A/SNP_B/R columns in .ld header"),
    (None, "cannot open"),
])
def test_parse_ld_errors_have_the_jax_text(tmp_path, text, error):
    path = tmp_path / "t.ld"
    if text is not None:
        path.write_text(text)
    messages = []
    for parse in (tnat.parse_ld, jnat.parse_ld, tld.parse_ld_numpy):
        with pytest.raises(ValueError, match=error) as exc:
            parse(str(path), VARIANTS)
        messages.append(str(exc.value))
    assert messages[0] == messages[1] == messages[2]


def test_parse_ld_resolves_a_repeated_name_to_its_first_position(tmp_path):
    path = tmp_path / "t.ld"
    path.write_text("SNP_A SNP_B R\nrs1 rs2 0.5\nrs2 rs3 0.25\n")
    variants = ["rs1", "rs2", "rs0", "rs2", "rs3"]
    ours = tnat.parse_ld(str(path), variants)
    for got in (jnat.parse_ld(str(path), variants), tld.parse_ld_numpy(str(path), variants)):
        for i in range(3):
            assert_same_bits(ours[i], got[i])
    np.testing.assert_array_equal(ours[0], [0, 1])
    np.testing.assert_array_equal(ours[1], [1, 4])


def test_loaders_fall_back_to_numpy_without_the_library(tmp_path, triplets, monkeypatch,
                                                        caplog):
    """Without the library every loader takes its numpy version: the same
    results, and the log says so."""
    path = tmp_path / "t.ld"
    path.write_text(_ld_text("plink"))
    vindex = {v: i for i, v in enumerate(VARIANTS)}
    R, _ = _noncanonical(np.int32, np.float64)
    want = (tld.load_ld_table(str(path), vindex), tld.csr_to_band(R, 30))
    monkeypatch.setattr(tnat, "get_lib", lambda: None)
    assert not tnat.available()
    with caplog.at_level("INFO", logger="sgvamp"):
        got = (tld.load_ld_table(str(path), vindex), tld.csr_to_band(R, 30))
    assert any("parsed through the numpy path" in m for m in caplog.messages)
    assert any(m.startswith("CSR -> band") and "numpy path" in m for m in caplog.messages)
    for i in range(3):
        assert_same_bits(got[0][i], want[0][i])
    assert got[1][1:] == want[1][1:]
    assert_same_bits(got[1][0], want[1][0])
