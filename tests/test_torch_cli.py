"""The port's command line (sgvamp_torch.cli) against the JAX package's, on
the CPU: simulate -> ingest -> infer -> files.

The simulators and loaders are numpy on both sides, so their outputs must
be equal to the byte. The inference runs draw their Hutchinson probes from
different generators (jax.random bits cannot be reproduced in torch), so
the two command lines are compared on the file set, the CSV headers and shapes, and
the best alignment (within 0.02), not entry by entry.
"""

import csv
import os
import shutil

import numpy as np
import pytest
import scipy.sparse
import torch

from sgvamp_torch.cli import main as tcli
from sgvamp_torch.cli import simulate as tsim
from sgvamp_torch.data import harmonize as thz
from sgvamp_torch.data import loaders as tld
from sgvamp_tpu.cli import main as jcli
from sgvamp_tpu.cli import simulate as jsim
from sgvamp_tpu.data import harmonize as jhz
from sgvamp_tpu.data import loaders as jld


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f, delimiter="\t"))


@pytest.fixture(scope="module")
def phen_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("phen")
    assert tsim.main(["gen-phen", "--out", str(d / "sim"), "--N", "1500", "--M", "200",
                      "--h2", "0.8", "--lam", "0.1", "--seed", "0"]) == 0
    return d


@pytest.fixture(scope="module")
def band_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("band")
    assert tsim.main(["gen-band", "--out", str(d / "p"), "--N", "20000", "--M", "1000",
                      "--h2", "0.7", "--lam", "0.02", "--bandwidth", "64", "--seed", "3",
                      "--K", "2", "--uncompressed"]) == 0
    return d


# ---------------------------------------------------------------------------
# simulators and loaders: equal to the JAX package's, byte for byte
# ---------------------------------------------------------------------------

def test_gen_phen_files_byte_equal(phen_dir, tmp_path):
    assert jsim.main(["gen-phen", "--out", str(tmp_path / "sim"), "--N", "1500", "--M", "200",
                      "--h2", "0.8", "--lam", "0.1", "--seed", "0"]) == 0
    names = sorted(os.listdir(tmp_path))
    assert names == ["sim_R.npy", "sim_bet.npy", "sim_phen.npy", "sim_r.npy"]
    for name in names:
        assert (phen_dir / name).read_bytes() == (tmp_path / name).read_bytes(), name


@pytest.mark.parametrize("extra", [["--K", "2", "--uncompressed"], ["--strength", "2.0"]])
def test_gen_band_files_byte_equal(tmp_path, extra):
    args = ["gen-band", "--N", "20000", "--M", "700", "--h2", "0.7", "--lam", "0.02",
            "--bandwidth", "48", "--seed", "3", *extra]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    assert tsim.main(args + ["--out", str(tmp_path / "t" / "p")]) == 0
    assert jsim.main(args + ["--out", str(tmp_path / "j" / "p")]) == 0
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and "p_R.npz" in names
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name


@pytest.mark.parametrize("bandwidth", [None, 64, 20])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_csr_to_band_matches(band_dir, bandwidth, dtype):
    R = scipy.sparse.load_npz(band_dir / "p_R.npz")
    want = jld.csr_to_band(R, bandwidth, dtype=dtype)   # native for f32, numpy for f64
    got = tld.csr_to_band(R, bandwidth, dtype=dtype)
    assert got[1:] == want[1:] and got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])
    if bandwidth == 20:
        assert got[2] > 0   # entries outside the band are dropped and counted
    # a dense matrix and a COO matrix take the other branch
    dense = np.asarray(R.todense())
    np.testing.assert_array_equal(tld.csr_to_band(dense, bandwidth, dtype=dtype)[0], want[0])
    np.testing.assert_array_equal(tld.csr_to_band(R.tocoo(), bandwidth, dtype=dtype)[0], want[0])


def test_csr_to_band_sums_duplicates_without_touching_the_input():
    rows = np.array([0, 0, 1, 1, 2, 0])
    cols = np.array([0, 1, 0, 1, 2, 1])
    vals = np.array([1.0, 0.25, 0.5, 1.0, 1.0, 0.25])
    R = scipy.sparse.csr_matrix((vals, cols, np.array([0, 2, 4, 5])), shape=(3, 3))
    R.indices = np.array([0, 1, 0, 1, 2], dtype=R.indices.dtype)
    dup = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(3, 3))
    want = jld.csr_to_band(dup, None, dtype=np.float64)
    got = tld.csr_to_band(dup, None, dtype=np.float64)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0][0, 2] == 0.5   # the two (0, 1) entries summed
    raw = scipy.sparse.csr_matrix(
        (np.array([1.0, 0.25, 0.25, 1.0]), np.array([0, 1, 1, 1]), np.array([0, 3, 4])),
        shape=(2, 2))
    before = raw.data.copy()
    band = tld.csr_to_band(raw, None, dtype=np.float64)[0]
    assert band[0, 2] == 0.5 and np.array_equal(raw.data, before)


def test_loaders_match(tmp_path):
    rng = np.random.default_rng(0)
    r = rng.normal(size=7)
    np.save(tmp_path / "r.npy", r)
    np.savetxt(tmp_path / "r.txt", r)
    with open(tmp_path / "r.linear", "w") as f:
        f.write(" CHR   SNP    BP  A1   TEST  NMISS    BETA    STAT    P\n")
        for i, v in enumerate(r):
            beta = "NA" if i == 3 else f"{v:.6g}"
            f.write(f"  1  rs{i}  {100 + i}  A  ADD  500  {beta}  0.1  0.5\n")
    for name in ("r.npy", "r.txt", "r.linear"):
        want = jld.load_r(str(tmp_path / name), 7, 500.0)
        got = tld.load_r(str(tmp_path / name), 7, 500.0)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    assert tld.load_r(str(tmp_path / "r.linear"), 7, 500.0)[3] == 0.0
    with pytest.raises(ValueError, match="Unsupported r"):
        tld.load_r("r.csv", 7, 1.0)
    i_map = np.array([4, 0, 2])
    np.testing.assert_array_equal(tld.scatter_to_reference(r[:3], i_map, 6),
                                  jld.scatter_to_reference(r[:3], i_map, 6))
    # true signal: .npy and .bin, strict length
    np.save(tmp_path / "x.npy", r.reshape(7, 1))
    r.astype("<f8").tofile(tmp_path / "x.bin")
    for name in ("x.npy", "x.bin"):
        np.testing.assert_array_equal(tld.load_true_signal(str(tmp_path / name), 7, 300.0),
                                      jld.load_true_signal(str(tmp_path / name), 7, 300.0))
        with pytest.raises(ValueError, match="expected exactly"):
            tld.load_true_signal(str(tmp_path / name), 6, 300.0)
    # LD matrices
    A = rng.normal(size=(5, 5))
    np.save(tmp_path / "R.npy", A)
    scipy.sparse.save_npz(tmp_path / "R.npz", scipy.sparse.csr_matrix(np.triu(A)))
    Rs = [tld.load_R(str(tmp_path / "R.npy")), tld.load_R(str(tmp_path / "R.npz"))]
    np.testing.assert_array_equal(tld.to_dense_stack(Rs, 5), jld.to_dense_stack(Rs, 5))
    np.testing.assert_array_equal(tld.as_csr(Rs[0]).toarray(), jld.as_csr(Rs[0]).toarray())
    assert tld.as_csr(Rs[1]).format == "csr"
    for load_R in (tld.load_R, jld.load_R):   # a .ld table needs the .bim files' index
        with pytest.raises(ValueError, match="requires .bim files"):
            load_R("panel.ld")
    with pytest.raises(ValueError, match="Unsupported R"):
        tld.load_R("panel.txt")


def test_identity_panel_matches():
    want, got = jhz.identity_panel(5, 2), thz.identity_panel(5, 2)
    assert got.variants == want.variants and got.M == want.M
    for name in ("i_maps", "sources", "missing"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------

def test_parser_has_the_same_flags_and_defaults():
    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices and tuple(a.choices))
                for a in parser._actions}
    assert table(tcli.build_parser()) == table(jcli.build_parser())


README_BIOBANK = [
    "--ld-files", ".biobank/bb_R.npz", "--r-files", ".biobank/bb_r.npy",
    "--true-signal-file", ".biobank/bb_bet.npy",
    "--out-dir", ".biobank/out", "--out-name", "bb",
    "--N", "300000", "--M", "524288", "--iterations", "10",
    "--prior-probs", "0.99,0.01", "--prior-vars", "0,0.000133537",
    "--operator", "sym", "--ld-dtype", "int8", "--block-size", "128", "--bandwidth", "256",
    "--cg-maxit", "500", "--cg-rtol", "1e-5", "--cg-precond-block", "64",
    "--cg-precond-dtype", "bfloat16", "--lmmse-damp", "1", "--rho", "0.5",
    "--stop-on-divergence", "1"]


def test_readme_biobank_command_line_parses_and_is_not_rejected():
    args = tcli.build_parser().parse_args(README_BIOBANK)
    tcli._reject_unported(args)   # raises for an unported flag
    assert args.cg_precond_block == 64 and args.ld_dtype == "int8"


BASE = ["--ld-files", "R.npz", "--r-files", "r.npy", "--N", "10", "--M", "10",
        "--platform", "cpu"]


@pytest.mark.parametrize("extra,named", [
    (["--platform", "tpu"], "--platform tpu"),
])
def test_unported_flags_are_rejected_by_name(extra, named):
    with pytest.raises(SystemExit) as exc:
        tcli.main(BASE + extra)
    assert named in str(exc.value) and "cuda" in str(exc.value)


@pytest.mark.parametrize("extra", [
    ["--coordinator-address", "localhost:1", "--num-processes", "2", "--process-id", "1"],
    ["--num-processes", "2"],
    ["--process-id", "0"],
    ["--operator", "blocksparse"],
    ["--profile-dir", "prof"],
])
def test_multi_process_flags_and_blocksparse_pass_the_gate(extra):
    """--operator blocksparse, the multi-process flags and --profile-dir are
    ported: no flag is refused any more but --platform tpu."""
    args = tcli.build_parser().parse_args(BASE + extra)
    tcli._reject_unported(args)
    if extra[0] in ("--operator", "--profile-dir"):
        with pytest.raises(FileNotFoundError):
            tcli.main(BASE + extra)


@pytest.mark.parametrize("extra", [["--fused", "1", "--checkpoint-dir", "ck"],
                                   ["--checkpoint-dir", "ck"], ["--resume", "1"],
                                   ["--prior-update", "mle"], ["--mle-prior-update", "mle"]])
def test_checkpoint_and_mle_flags_parse_and_run(phen_dir, tmp_path, extra):
    """The checkpoint and MLE flags are ported: a run with them writes its
    files (--resume without --checkpoint-dir has nothing to resume from, as
    in the JAX command line), its checkpoints, and under MLE the learned
    prior."""
    extra = [str(tmp_path / v) if v == "ck" else v for v in extra]
    args = tcli.build_parser().parse_args(BASE + extra)
    tcli._reject_unported(args)
    assert args.prior_update == ("mle" if "mle" in extra else "em")
    d = str(phen_dir / "sim")
    assert tcli.main(["--ld-files", d + "_R.npy", "--r-files", d + "_r.npy",
                      "--true-signal-file", d + "_bet.npy", "--out-dir", str(tmp_path / "out"),
                      "--out-name", "t", "--N", "1500", "--M", "200", "--iterations", "2",
                      "--prior-probs", "0.9,0.1", "--prior-vars", "0,0.04",
                      "--platform", "cpu", *extra]) == 0
    rows = _read_csv(tmp_path / "out" / "t_cohort_1.csv")
    assert len(rows) == 3 and rows[1][-1] != rows[2][-1]   # lam learned at iteration 1
    if "--checkpoint-dir" in extra:
        want = (["vamp_state_000002.npz"] if "--fused" in extra
                else ["vamp_state_000001.npz", "vamp_state_000002.npz"])
        assert sorted(os.listdir(tmp_path / "ck")) == want


@pytest.mark.parametrize("extra", [["--mesh-cohort", "2"], ["--mesh-shard", "2"]])
def test_mesh_flags_are_not_rejected(extra):
    """The sharded run is ported: the flags pass the gate (and the run then
    stops at the missing input files, as any run would)."""
    tcli._reject_unported(tcli.build_parser().parse_args(BASE + extra))
    with pytest.raises(FileNotFoundError):
        tcli.main(BASE + extra)


@pytest.mark.parametrize("extra,message", [
    (["--ld-dtype", "int8"], "--ld-dtype int8 requires --operator sym"),
    (["--ld-dtype", "hybrid", "--operator", "dense"], "requires --operator sym"),
    (["--ld-dtype", "float16", "--operator", "sym"], "--ld-dtype float16"),
    (["--K", "2"], "number of cohorts"),
    (["--L", "3"], "prior variances"),
])
def test_argument_checks(extra, message):
    with pytest.raises(SystemExit) as exc:
        tcli.main(BASE + extra)
    assert message in str(exc.value)
    with pytest.raises(SystemExit, match="is required"):
        tcli.main(["--platform", "cpu", "--r-files", "r.npy", "--N", "1", "--M", "1"])


def test_default_platform_is_cuda_and_raises_without_it(band_dir):
    argv = ["--ld-files", str(band_dir / "p_R.npz"), "--r-files", str(band_dir / "p_0_r.npy"),
            "--N", "20000", "--M", "1000", "--operator", "sym", "--ld-dtype", "int8",
            "--block-size", "128", "--iterations", "1"]
    if torch.cuda.is_available():
        assert tcli.main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="--platform cpu"):
            tcli.main(argv)


# ---------------------------------------------------------------------------
# inference through the command line
# ---------------------------------------------------------------------------

def test_cli_end_to_end_single_cohort(phen_dir, tmp_path):
    out = tmp_path / "out"
    assert tcli.main([
        "--ld-files", str(phen_dir / "sim_R.npy"), "--r-files", str(phen_dir / "sim_r.npy"),
        "--true-signal-file", str(phen_dir / "sim_bet.npy"),
        "--out-dir", str(out), "--out-name", "t", "--N", "1500", "--M", "200",
        "--iterations", "5", "--s", "0.1", "--platform", "cpu", "--x64", "1"]) == 0
    rows = _read_csv(out / "t_cohort_1.csv")
    assert rows[0] == ["it", "gamw", "gam1", "gam2", "alpha1", "alpha2", "lam"]
    assert len(rows) == 6
    mrows = _read_csv(out / "t_metrics.csv")
    assert len(mrows) == 6 and float(mrows[-1][1]) > 0.9
    assert (out / "t_r1_cohort_1_it_4.bin").exists()
    assert np.fromfile(out / "t_xhat_it_4.bin", dtype="<f8").shape == (200,)
    assert not (out / "t_xhat_best.bin").exists()   # no stop criterion armed


# the preconditioner's sub-block must divide both operators' diagonal blocks:
# 200 (dense: the largest divisor of M up to 256) and 64 (sym: --block-size)
@pytest.mark.parametrize("precond", [[], ["--cg-precond-block", "8"]])
def test_cli_sym_at_full_bandwidth_matches_dense(phen_dir, tmp_path, precond):
    """--operator sym with full bandwidth must reproduce the dense run (f64)."""
    outs = {}
    for op in ("dense", "sym"):
        out = tmp_path / op
        assert tcli.main([
            "--ld-files", str(phen_dir / "sim_R.npy"), "--r-files", str(phen_dir / "sim_r.npy"),
            "--out-dir", str(out), "--out-name", "t", "--N", "1500", "--M", "200",
            "--iterations", "3", "--s", "0.1", "--platform", "cpu", "--x64", "1",
            "--operator", op, "--block-size", "64", "--bandwidth", "200",
            "--seed", "7", "--cg-rtol", "1e-12" if precond else "1e-5", *precond]) == 0
        outs[op] = np.fromfile(out / "t_xhat_it_2.bin", dtype="<f8")
    assert outs["sym"].shape == (200,)   # the padded markers are trimmed
    np.testing.assert_allclose(outs["sym"], outs["dense"], rtol=1e-8, atol=1e-12)


def _run_band(cli, band_dir, out, ld_dtype, extra=()):
    return cli.main([
        "--ld-files", str(band_dir / "p_R.npz"), "--r-files", str(band_dir / "p_0_r.npy"),
        "--true-signal-file", str(band_dir / "p_bet.npy"),
        "--out-dir", str(out), "--out-name", "b", "--N", "20000", "--M", "1000",
        "--iterations", "6", "--platform", "cpu", "--x64", "0", "--dtype", "float32",
        "--operator", "sym", "--ld-dtype", ld_dtype, "--block-size", "128",
        "--bandwidth", "64", "--prior-probs", "0.98,0.02", "--prior-vars", "0,0.035",
        "--lmmse-damp", "1", "--cg-precond-block", "64", "--cg-precond-dtype", "bfloat16",
        "--stop-on-divergence", "1", "--compile-cache-dir", "", *extra])


@pytest.mark.parametrize("ld_dtype", ["int8", "int4", "hybrid", "bfloat16"])
def test_cli_matches_the_jax_cli(band_dir, tmp_path, ld_dtype):
    extra = ["--cg-rtol", "1e-3"] if ld_dtype == "int4" else []
    assert _run_band(tcli, band_dir, tmp_path / "t", ld_dtype, extra) == 0
    assert _run_band(jcli, band_dir, tmp_path / "j", ld_dtype, extra) == 0
    tn, jn = sorted(os.listdir(tmp_path / "t")), sorted(os.listdir(tmp_path / "j"))
    assert "b_xhat_best.bin" in tn and "b_cohort_1.csv" in tn and "b_metrics.csv" in tn
    # the probes differ, so a run may stop one iteration apart: the files
    # of the iterations both ran must be the same set
    common = min(len(_read_csv(tmp_path / d / "b_metrics.csv")) for d in "tj") - 1
    assert common >= 2

    def upto(names):
        return [n for n in names if "_it_" not in n
                or int(n.rsplit("_it_", 1)[1].split(".")[0]) < common]
    assert upto(tn) == upto(jn)
    for name in ("b_cohort_1.csv", "b_metrics.csv"):
        tr, jr = _read_csv(tmp_path / "t" / name), _read_csv(tmp_path / "j" / name)
        assert tr[0] == jr[0]
        assert {len(r) for r in tr} == {len(r) for r in jr} == {len(tr[0])}
    for name in ("b_xhat_it_0.bin", "b_xhat_best.bin", "b_r1_cohort_1_it_1.bin"):
        assert ((tmp_path / "t" / name).stat().st_size
                == (tmp_path / "j" / name).stat().st_size == 1000 * 8)
    best = {d: max(float(r[1]) for r in _read_csv(tmp_path / d / "b_metrics.csv")[1:])
            for d in "tj"}
    assert best["t"] > 0.95 and abs(best["t"] - best["j"]) <= 0.02, best
    # iteration 0 uses no probe-dependent quantity in xhat1: equal to f32 rounding
    np.testing.assert_allclose(np.fromfile(tmp_path / "t" / "b_xhat_it_0.bin"),
                               np.fromfile(tmp_path / "j" / "b_xhat_it_0.bin"),
                               rtol=1e-4, atol=1e-7)


def test_cli_best_file_holds_the_selected_iterate(band_dir, tmp_path):
    assert _run_band(tcli, band_dir, tmp_path, "hybrid") == 0
    rows = _read_csv(tmp_path / "b_cohort_1.csv")[1:]
    gam1 = [float(r[2]) for r in rows]
    best_it = int(np.argmax(gam1))
    np.testing.assert_array_equal(np.fromfile(tmp_path / "b_xhat_best.bin"),
                                  np.fromfile(tmp_path / f"b_xhat_it_{best_it}.bin"))


@pytest.mark.parametrize("ld_dtype", ["int8", "hybrid"])
def test_shared_panel_path_dedupe(band_dir, tmp_path, ld_dtype):
    """Listing the SAME .npz once per cohort must give outputs identical to
    listing per-cohort COPIES of the file: the deduped load / convert /
    pack path changes cost, not results."""
    R = str(band_dir / "p_R.npz")
    R2 = str(tmp_path / "copy_R.npz")
    shutil.copy(R, R2)
    rfiles = f"{band_dir / 'p_0_r.npy'},{band_dir / 'p_1_r.npy'}"
    results = {}
    for name, ld in (("shared", f"{R},{R}"), ("copies", f"{R},{R2}")):
        rundir = tmp_path / name
        assert tcli.main([
            "--ld-files", ld, "--r-files", rfiles, "--out-dir", str(rundir),
            "--out-name", "t", "--N", "20000,20000", "--M", "1000", "--K", "2",
            "--iterations", "3", "--platform", "cpu", "--x64", "0", "--dtype", "float32",
            "--operator", "sym", "--block-size", "128", "--ld-dtype", ld_dtype,
            "--seed", "5"]) == 0
        results[name] = (rundir / "t_xhat_it_2.bin").read_bytes()
        assert (rundir / "t_cohort_2.csv").exists()
    assert results["shared"] == results["copies"]


def test_seed_selects_the_probes(band_dir, tmp_path):
    outs = {}
    for name, seed in (("a", "1"), ("b", "1"), ("c", "2")):
        assert _run_band(tcli, band_dir, tmp_path / name, "int8", ["--seed", seed]) == 0
        outs[name] = (tmp_path / name / "b_xhat_it_2.bin").read_bytes()
    assert outs["a"] == outs["b"] and outs["a"] != outs["c"]
