"""The port's PLINK ingestion (.bim harmonization, .ld tables, the
missing-SNP fills, the band-direct loader, plink2np and the .ld/.bim
command line) against the JAX package's, on the CPU.

harmonize must give the same panel and write the same merged .bim, byte
for byte: the union of variant IDs sorted as text, then by coordinate with
the same (unstable) quicksort, so ties across chromosomes land in the same
order on the machine both run on; a numeric column that the merge left
with a gap is written as float ("2.0", a cM of "0.50" as "0.5"). The
loaders and fills are numpy on both sides and must agree exactly. The
command lines draw their Hutchinson probes from different generators, so
their runs are compared on the file set, the merged .bim (byte-equal),
the CSV headers and shapes and iteration 0's xhat1 (no probe enters it);
the port's own runs are compared with each other, byte for byte.
"""

import csv
import os
import shutil

import numpy as np
import pytest
import scipy.sparse

from sgvamp_torch.cli import main as tcli
from sgvamp_torch.cli import plink2np as tp2n
from sgvamp_torch.data import harmonize as thz
from sgvamp_torch.data import loaders as tld
from sgvamp_tpu.cli import main as jcli
from sgvamp_tpu.cli import plink2np as jp2n
from sgvamp_tpu.data import harmonize as jhz
from sgvamp_tpu.data import loaders as jld


def _bim_line(chrom, rs_, cm, bp):
    return f"{chrom}\t{rs_}\t{cm}\t{bp}\tA\tG\n"


def _write(path, text):
    path.write_text(text)
    return str(path)


def _harmonize_case(tmp_path, case):
    """.bim files for one case; returns (paths, N list)."""
    rng = np.random.default_rng(7)
    M = 120
    # two chromosomes that share positions: ties on Coordinate everywhere
    chrom = [1 + (i >= M // 2) for i in range(M)]
    bp = [1000 + 10 * (i % (M // 2)) for i in range(M)]
    cm = ["0.50" if i % 9 == 0 else "0" for i in range(M)]

    def bim(name, keep, chrom_of=lambda i: chrom[i]):
        return _write(tmp_path / f"{name}.bim", "".join(
            _bim_line(chrom_of(i), f"rs{i}", cm[i], bp[i]) for i in keep))

    def subset(frac):
        return np.sort(rng.choice(M, int(M * frac), replace=False))

    if case == "K1":
        return [bim("a", rng.permutation(M))], [1000]
    if case == "K2":
        return [bim("a", subset(0.9)), bim("b", subset(0.85))], [1000, 3000]
    if case == "K2_full_overlap":
        return [bim("a", range(M)), bim("b", rng.permutation(M))], [1000, 3000]
    if case == "K2_chromosome_X":
        return [bim("a", subset(0.9), lambda i: "X" if i % 5 == 0 else chrom[i]),
                bim("b", subset(0.9))], [1000, 1000]
    # K3: N ties between cohorts 1 and 2, so a SNP only they hold comes from 1
    return ([bim("a", subset(0.8)), bim("b", subset(0.8)), bim("c", subset(0.8))],
            [1000, 2000, 2000])


HARMONIZE_CASES = ["K1", "K2", "K2_full_overlap", "K2_chromosome_X", "K3"]


def _assert_same_panel(t, j):
    assert t.variants == j.variants and t.M == j.M
    for name in ("i_maps", "sources", "missing"):
        assert len(getattr(t, name)) == len(getattr(j, name))
        for a, b in zip(getattr(t, name), getattr(j, name)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", HARMONIZE_CASES)
def test_harmonize_matches_jax(tmp_path, case):
    paths, N = _harmonize_case(tmp_path, case)
    t = thz.harmonize(paths, N, str(tmp_path / "t.out"))
    j = jhz.harmonize(paths, N, str(tmp_path / "j.out"))
    _assert_same_panel(t, j)
    got, want = (tmp_path / "t.out").read_bytes(), (tmp_path / "j.out").read_bytes()
    assert got == want
    lines = got.decode().splitlines()
    assert len(lines) == t.M == len(set(t.variants))
    assert [ln.split("\t") for ln in lines] == [list(r) for r in zip(*t.bim_ref.values())]
    if case in ("K2", "K3"):
        # the merge left gaps: the numeric columns are written as floats
        assert "\t0.5\t" in got.decode() and lines[0].split("\t")[0] in ("1.0", "2.0")
        assert any(m.size for m in t.missing)
    if case in ("K1", "K2_full_overlap"):
        assert "\t0.5\t" in got.decode() and lines[0].split("\t")[3] == "1000"
    if case == "K3":
        # a SNP cohort 0 lacks and both 1 and 2 hold comes from cohort 1
        both = t.missing[0][np.isin(t.missing[0], t.i_maps[1])
                            & np.isin(t.missing[0], t.i_maps[2])]
        assert both.size and np.all(t.sources[0][both] == 1)
    # the ties on Coordinate interleave the two chromosomes
    chroms = [ln.split("\t")[0] for ln in lines]
    assert len(set(chroms[:len(chroms) // 2])) > 1


def test_harmonize_without_out_path_and_identity_panel(tmp_path):
    paths, N = _harmonize_case(tmp_path, "K2")
    _assert_same_panel(thz.harmonize(paths, N), jhz.harmonize(paths, N))
    assert os.listdir(tmp_path) == ["a.bim", "b.bim"]
    assert thz.identity_panel(5, 2).bim_ref == {}


def test_read_bim_types_columns_as_the_jax_reader(tmp_path):
    path = _write(tmp_path / "a.bim", "  1 rs5 0.50 7 A G\n\n1\trs6\t0\t7\tA\tNA\r\n")
    bim = thz.read_bim(path)
    want = jhz.read_bim(path)
    for name in thz.BIM_COLUMNS:
        kind = {"i": "i", "f": "f"}.get(want[name].dtype.kind, "O")
        assert bim[name].dtype.kind == kind, name
    assert bim["Position"].tolist() == [0.5, 0.0]
    assert bim["Allele2"][0] == "G" and np.isnan(bim["Allele2"][1])
    with pytest.raises(ValueError, match="record 1 has 5 fields"):
        thz.read_bim(_write(tmp_path / "b.bim", "1 rs5 0 7 A\n"))


# ---------------------------------------------------------------------------
# .ld tables, the fills and the band-direct loader
# ---------------------------------------------------------------------------

def _cohort_files(d, tag, variants, chrom, coords, R_local, r_local):
    """A cohort's .bim, .ld (PLINK's header, one-sided pairs i < j) and
    local-order r .npy."""
    with open(d / f"{tag}.bim", "w") as f:
        for rs_, c, bp in zip(variants, chrom, coords):
            f.write(_bim_line(c, rs_, 0, bp))
    with open(d / f"{tag}.ld", "w") as f:
        f.write(" CHR_A BP_A SNP_A CHR_B BP_B SNP_B R\n")
        for i in range(len(variants)):
            for j in range(i + 1, len(variants)):
                if R_local[i, j] != 0.0:
                    f.write(f"{chrom[i]}\t{coords[i]}\t{variants[i]}\t{chrom[j]}\t"
                            f"{coords[j]}\t{variants[j]}\t{R_local[i, j]!r}\n")
    np.save(d / f"{tag}_r.npy", r_local)
    return str(d / f"{tag}.bim"), str(d / f"{tag}.ld"), str(d / f"{tag}_r.npy")


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    """Two cohorts over overlapping panels of 40 variants on two
    chromosomes that share positions, with consistent banded LD."""
    d = tmp_path_factory.mktemp("ldcohorts")
    rng = np.random.default_rng(0)
    M, N = 40, 4000
    variants = [f"rs{i}" for i in range(M)]
    chrom = [1 + (i >= M // 2) for i in range(M)]
    coords = [10 * (1 + i % (M // 2)) for i in range(M)]
    X = rng.binomial(2, 0.4, size=(N, M)).astype(np.float64)
    X = (X - X.mean(0)) / X.std(0)
    beta = np.zeros(M)
    beta[rng.choice(M, 6, replace=False)] = rng.normal(0, 0.4, 6)
    y = X @ beta + rng.normal(0, 0.5, N)
    Xn = X / np.sqrt(N)
    R = Xn.T @ Xn
    r_ref = Xn.T @ y
    dist = np.abs(np.arange(M)[:, None] - np.arange(M)[None, :])
    R_sp = np.where((np.abs(R) > 0.02) & (dist <= 6), R, 0.0)
    files = {}
    for tag, sel in (("c0", list(range(30))), ("c1", list(range(10, 40)))):
        files[tag] = _cohort_files(d, tag, [variants[i] for i in sel], [chrom[i] for i in sel],
                                   [coords[i] for i in sel], R_sp[np.ix_(sel, sel)], r_ref[sel])
    np.save(d / "beta.npy", (beta / np.sqrt(N)).reshape(M, 1))
    return d, files, M


def _panels(files, N=(4000, 5000)):
    bims = [files["c0"][0], files["c1"][0]]
    t, j = thz.harmonize(bims, list(N)), jhz.harmonize(bims, list(N))
    _assert_same_panel(t, j)
    return t, j


def _rs(files, panel):
    return [tld.scatter_to_reference(np.load(files[c][2]), panel.i_maps[k], panel.M)
            for k, c in enumerate(("c0", "c1"))]


def _assert_csr_equal(a, b):
    a, b = scipy.sparse.csr_matrix(a), scipy.sparse.csr_matrix(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    for x, y in ((a.indptr, b.indptr), (a.indices, b.indices), (a.data, b.data)):
        np.testing.assert_array_equal(x, y)


def test_load_R_ld_matches_jax(cohorts):
    _, files, _ = cohorts
    tp, _ = _panels(files)
    vindex = {rs_: i for i, rs_ in enumerate(tp.variants)}
    for c in ("c0", "c1"):
        got = tld.load_R(files[c][1], vindex)
        _assert_csr_equal(got, jld.load_R(files[c][1], vindex))
        assert got.shape == (tp.M, tp.M) and np.all(got.diagonal() == 1.0)
        rows, cols, vals = tld.load_ld_table(files[c][1], vindex)
        _assert_csr_equal(tld.triplets_to_csr(rows, cols, vals, tp.M),
                          jld.triplets_to_csr(rows, cols, vals, tp.M))
    with pytest.raises(ValueError, match="requires .bim files"):
        tld.load_R(files["c0"][1])


@pytest.mark.parametrize("N", [(4000, 5000), (5000, 4000)])
def test_fills_match_jax(cohorts, N):
    _, files, _ = cohorts
    tp, jp = _panels(files, N)
    vindex = {rs_: i for i, rs_ in enumerate(tp.variants)}
    Rs = [tld.load_R(files[c][1], vindex) for c in ("c0", "c1")]
    rs = _rs(files, tp)
    got, want = tld.fill_missing_csr(Rs, rs, tp), jld.fill_missing_csr(Rs, rs, jp)
    for a, b in zip(got[0], want[0]):
        _assert_csr_equal(a, b)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    got, want = tld.fill_missing_from_source(Rs, rs, tp), jld.fill_missing_from_source(Rs, rs, jp)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(a, b)
    # the sparse and the dense fill agree
    for a, b in zip(tld.fill_missing_csr(Rs, rs, tp)[0], got[0]):
        np.testing.assert_array_equal(a.toarray(), b)
    trips = [tld.load_ld_table(files[c][1], vindex) for c in ("c0", "c1")]
    got, want = tld.fill_missing_triplets(trips, rs, tp), jld.fill_missing_triplets(trips, rs, jp)
    for a, b in zip(got[0], want[0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    assert all(len(got[0][k][0]) > len(trips[k][0]) for k in range(2))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bandwidth", [None, 8])
def test_ld_files_to_bands_matches_jax(cohorts, dtype, bandwidth):
    _, files, _ = cohorts
    tp, jp = _panels(files)
    paths = [files["c0"][1], files["c1"][1]]
    got = tld.ld_files_to_bands(paths, _rs(files, tp), tp, bandwidth, dtype=dtype)
    want = jld.ld_files_to_bands(paths, _rs(files, jp), jp, bandwidth, dtype=dtype)
    assert got[0].dtype == want[0].dtype == dtype
    np.testing.assert_array_equal(got[0].view(np.uint8), want[0].view(np.uint8))
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    assert got[2:] == want[2:]
    if bandwidth is None:
        assert got[3] == 0 and got[2] > 6   # the tie order spreads the band
    else:
        assert got[3] > 0


def test_plink2np_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    snps = [f"rs{i}" for i in range(30)]
    # values as PLINK prints them (%g, 6 significant digits): the JAX
    # converter's text reader rounds 17-digit decimals differently in the
    # last bit, the port's float() (and strtod) correctly
    beta = [f"{v:g}" for v in rng.normal(size=30)]
    beta[4] = "NA"
    text = "CHR SNP BP A1 TEST NMISS BETA STAT P\n" + "".join(
        f"1 {s} {i} A ADD 100 {b} 1.0 0.5\n" for i, (s, b) in enumerate(zip(snps, beta)))
    ld = " CHR_A BP_A SNP_A CHR_B BP_B SNP_B R\n" + "".join(
        f"1 {i} {snps[i]} 1 {j} {snps[j]} {rng.uniform(-1, 1):g}\n"
        for i in range(30) for j in range(i + 1, min(i + 4, 30)))
    for side in ("t", "j"):
        (tmp_path / side).mkdir()
        _write(tmp_path / side / "x.assoc.linear", text)
        _write(tmp_path / side / "x.ld", ld)
    for side, mod in (("t", tp2n), ("j", jp2n)):
        assert mod.main(["--r-file", str(tmp_path / side / "x.assoc.linear"),
                         "--ld-file", str(tmp_path / side / "x.ld")]) == 0
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    assert (tmp_path / "t" / "x.npy").read_bytes() == (tmp_path / "j" / "x.npy").read_bytes()
    assert np.isnan(np.load(tmp_path / "t" / "x.npy")[4])
    _assert_csr_equal(scipy.sparse.load_npz(tmp_path / "t" / "x.npz"),
                      scipy.sparse.load_npz(tmp_path / "j" / "x.npz"))
    with pytest.raises(SystemExit, match="needs --r-file"):
        tp2n.main(["--ld-file", str(tmp_path / "t" / "x.ld")])


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f, delimiter="\t"))


def _run_ld(cli, cohorts, out, operator, extra=(), N="4000,5000"):
    d, files, _ = cohorts
    return cli.main([
        "--ld-files", f"{files['c0'][1]},{files['c1'][1]}",
        "--r-files", f"{files['c0'][2]},{files['c1'][2]}",
        "--bim-files", f"{files['c0'][0]},{files['c1'][0]}",
        "--true-signal-file", str(d / "beta.npy"),
        "--out-dir", str(out), "--out-name", "t",
        "--N", N, "--M", "30,30", "--K", "2",
        "--iterations", "4", "--s", "0.2", "--platform", "cpu",
        "--operator", operator, "--block-size", "8", "--seed", "11", *extra])


@pytest.mark.parametrize("operator,extra", [
    ("sym", ("--x64", "0", "--dtype", "float32", "--ld-dtype", "int8")),
    ("dense", ("--x64", "1")),
    ("banded", ("--x64", "1")),
])
def test_cli_ld_bim_matches_the_jax_cli(cohorts, tmp_path, operator, extra, caplog):
    _, _, M = cohorts
    with caplog.at_level("INFO", logger="sgvamp"):
        assert _run_ld(tcli, cohorts, tmp_path / "t", operator, extra) == 0
    assert _run_ld(jcli, cohorts, tmp_path / "j", operator, extra) == 0
    tn, jn = sorted(os.listdir(tmp_path / "t")), sorted(os.listdir(tmp_path / "j"))
    assert tn == jn and "t.bim" in tn and "t_metrics.csv" in tn
    assert (tmp_path / "t" / "t.bim").read_bytes() == (tmp_path / "j" / "t.bim").read_bytes()
    assert len((tmp_path / "t" / "t.bim").read_text().splitlines()) == M
    for name in ("t_cohort_1.csv", "t_cohort_2.csv", "t_metrics.csv"):
        tr, jr = _read_csv(tmp_path / "t" / name), _read_csv(tmp_path / "j" / name)
        assert tr[0] == jr[0] and len(tr) == len(jr) == 5
    tol = 1e-4 if operator == "sym" else 1e-9
    np.testing.assert_allclose(np.fromfile(tmp_path / "t" / "t_xhat_it_0.bin"),
                               np.fromfile(tmp_path / "j" / "t_xhat_it_0.bin"),
                               rtol=tol, atol=tol * 1e-3)
    # both tables went through the native parser
    parsed = [m for m in caplog.messages if "parsed through the native path" in m]
    assert len(parsed) == 2


def test_cli_ld_operators_agree(cohorts, tmp_path):
    """The band-direct ingestion (banded, sym float64) reproduces the CSR
    ingestion (dense) when the band holds every entry: same probes, same
    files up to f64 rounding."""
    outs = {}
    for operator, extra in (("dense", ()), ("banded", ()), ("sym", ("--ld-dtype", "float64"))):
        assert _run_ld(tcli, cohorts, tmp_path / operator, operator,
                       ("--x64", "1", *extra)) == 0
        outs[operator] = np.fromfile(tmp_path / operator / "t_xhat_it_3.bin")
    np.testing.assert_allclose(outs["banded"], outs["dense"], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(outs["sym"], outs["dense"], rtol=1e-8, atol=1e-12)


def test_cli_ld_without_bim_files_is_refused(cohorts):
    """Without --bim-files the panel's names are snp0, snp1, ...: the .ld
    table's first name is unknown, in both command lines."""
    _, files, _ = cohorts
    argv = ["--ld-files", files["c0"][1], "--r-files", files["c0"][2], "--N", "4000",
            "--M", "30", "--platform", "cpu", "--operator", "dense"]
    messages = []
    for cli in (tcli, jcli):
        with pytest.raises(ValueError, match="unknown SNP on line 2") as exc:
            cli.main(argv)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


def test_cli_ld_equals_the_npz_run(cohorts, tmp_path):
    """One cohort: the .ld table with its .bim gives the same files, byte
    for byte, as the same matrix in an .npz in reference order."""
    d, files, _ = cohorts
    panel = thz.harmonize([files["c0"][0]], [4000])
    R = tld.load_R(files["c0"][1], {v: i for i, v in enumerate(panel.variants)})
    scipy.sparse.save_npz(tmp_path / "R.npz", R)
    np.save(tmp_path / "r.npy",
            tld.scatter_to_reference(np.load(files["c0"][2]), panel.i_maps[0], panel.M))
    base = ["--N", "4000", "--M", "30", "--iterations", "3", "--platform", "cpu",
            "--x64", "0", "--dtype", "float32", "--operator", "sym", "--ld-dtype", "hybrid",
            "--block-size", "8", "--seed", "2", "--out-name", "t"]
    assert tcli.main(["--ld-files", files["c0"][1], "--r-files", files["c0"][2],
                      "--bim-files", files["c0"][0], "--out-dir", str(tmp_path / "ld"),
                      *base]) == 0
    assert tcli.main(["--ld-files", str(tmp_path / "R.npz"), "--r-files",
                      str(tmp_path / "r.npy"), "--out-dir", str(tmp_path / "npz"), *base]) == 0
    names = sorted(os.listdir(tmp_path / "npz"))
    assert sorted(os.listdir(tmp_path / "ld")) == sorted(names + ["t.bim"])
    for name in names:
        assert (tmp_path / "ld" / name).read_bytes() == (tmp_path / "npz" / name).read_bytes()
    shutil.rmtree(tmp_path / "ld")
