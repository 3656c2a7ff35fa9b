"""The port's BandedLD (full-band block storage, one einsum) against the JAX
package's, on the CPU, and --operator banded through both command lines.

Packing is numpy on both sides: equal to the bit. The matvec is one einsum
in both: float64 agrees to 1e-12, float32 and bfloat16 (summed in f32 in
different orders) to a scaled 1e-5. float64 engine trajectories match to 1e-8
with equal CG counts. The command lines draw their probes from different
generators, so they are compared on the file set, headers, sizes and the
best alignment, as tests/test_torch_cli.py compares --operator sym.
"""

import csv
import os

import numpy as np
import pytest
import scipy.sparse
import torch

import jax.numpy as jnp
from sgvamp_torch import interop
from sgvamp_torch.cli import main as tcli
from sgvamp_torch.cli import simulate as tsim
from sgvamp_torch.config import VampConfig as TConfig
from sgvamp_torch.core import precond as tpre
from sgvamp_torch.core import vamp as tvamp
from sgvamp_torch.core.operators import BandedLD
from sgvamp_torch.core.prior import PriorState as TPrior
from sgvamp_torch.data import loaders as tld
from sgvamp_torch.ops.band_kernel import SymBandedLD
from sgvamp_tpu.cli import main as jcli
from sgvamp_tpu.config import VampConfig as JConfig
from sgvamp_tpu.core import precond as jpre
from sgvamp_tpu.core import vamp as jvamp
from sgvamp_tpu.core.operators import BandedLD as JBanded
from sgvamp_tpu.core.prior import PriorState as JPrior
from sgvamp_tpu.data import loaders as jld
from sgvamp_tpu.data.simulate import band_to_dense, simulate_ld_band

SCALED_TOL = 1e-5
GEOMETRIES = [(128, 48, 700), (128, 200, 700), (64, 96, 300), (64, 0, 192)]   # (B, bw, M)


def _band(M, bw, seed, dtype=np.float64):
    if not bw:
        return np.random.default_rng(seed).normal(size=(M, 1)).astype(dtype)
    return simulate_ld_band(10000, M, bw, rng=np.random.default_rng(seed), dtype=dtype)[0]


def _np(a):
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _tnp(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _cross(jop):
    return interop.banded_from_numpy(
        _np(jop.blocks), s=jop.s, accum_dtype=jop.accum_dtype,
        dtype=torch.bfloat16 if jop.blocks.dtype == jnp.bfloat16 else None, device="cpu")


@pytest.mark.parametrize("B,bw,M", GEOMETRIES)
@pytest.mark.parametrize("dtype", [None, "float32", "float64", "bfloat16"])
def test_from_band_blocks_equal(dtype, B, bw, M):
    band = _band(M, bw, seed=B + M, dtype=np.float32 if dtype == "bfloat16" else np.float64)
    K = 2 if B == 64 else 1
    want = JBanded.from_band(band, block_size=B, K=K, s=0.1, dtype=dtype)
    got = BandedLD.from_band(band, block_size=B, K=K, s=0.1, dtype=dtype, device="cpu")
    assert str(got.blocks.dtype).split(".")[-1] == str(want.blocks.dtype)
    assert tuple(got.blocks.shape) == want.blocks.shape == (K, got.nb, 2 * got.hb + 1, B, B)
    np.testing.assert_array_equal(_tnp(got.blocks), _np(want.blocks))
    assert got.accum_dtype == want.accum_dtype and got.s == want.s
    assert got.bytes_per_pass() == want.bytes_per_pass()
    assert (got.K, got.nb, got.hb, got.B, got.M) == (want.K, want.nb, want.hb, want.B, want.M)
    # the operator holds (2hb+1)/(hb+1) of the symmetric storage's blocks
    sym = SymBandedLD.from_band(band, block_size=B, K=K, dtype=dtype, device="cpu")
    assert got.bytes_per_pass() * (got.hb + 1) == sym.bytes_per_pass() * (2 * got.hb + 1)


@pytest.mark.parametrize("dtype", [None, np.float32])
def test_from_dense_blocks_equal(dtype):
    rng = np.random.default_rng(3)
    mats = rng.normal(size=(2, 192, 192))
    want = JBanded.from_dense(mats, block_size=64, bandwidth_blocks=1, s=0.05, dtype=dtype)
    got = BandedLD.from_dense(mats, block_size=64, bandwidth_blocks=1, s=0.05, dtype=dtype,
                              device="cpu")
    assert str(got.blocks.dtype).split(".")[-1] == str(want.blocks.dtype)
    np.testing.assert_array_equal(got.blocks.numpy(), np.asarray(want.blocks))
    assert got.accum_dtype == want.accum_dtype
    with pytest.raises(ValueError, match="multiple"):
        BandedLD.from_dense(mats, block_size=50, bandwidth_blocks=1, device="cpu")
    # entries outside the band are dropped
    D = got.to_dense().numpy()
    np.testing.assert_array_equal(D[:, :64, 128:], 0.0)
    np.testing.assert_array_equal(D, np.asarray(want.to_dense()))


@pytest.mark.parametrize("B,bw,M", GEOMETRIES)
@pytest.mark.parametrize("K", [1, 2])
def test_f64_matvec_diag_blocks_and_to_dense_match(B, bw, M, K):
    band = _band(M, bw, seed=7 + K)
    jop = JBanded.from_band(band, block_size=B, K=K, s=0.1)
    op = _cross(jop)
    assert op.blocks.dtype == torch.float64 and op.accum_dtype == ""
    x = np.random.default_rng(1).normal(size=(2 * K, op.M))
    y = op.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jop.matvec(jnp.asarray(x))), rtol=1e-12, atol=1e-12)
    if bw:   # and the dense product (the unpadded part)
        R = band_to_dense(band)
        want = x[:, :M] @ (0.9 * R + 0.1 * np.eye(M)).T
        np.testing.assert_allclose(y[:, :M], want, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(y[:, M:], x[:, M:], atol=1e-12)
    D = op.diag_blocks()
    assert D.dtype == torch.float32 and tuple(D.shape) == (K, op.nb, B, B)
    np.testing.assert_array_equal(D.numpy(), np.asarray(jop.diag_blocks()))
    np.testing.assert_array_equal(op.to_dense().numpy(), np.asarray(jop.to_dense()))
    # the same matrix as the symmetric half-storage operator
    sym = SymBandedLD.from_band(band, block_size=B, K=K, s=0.1, device="cpu")
    np.testing.assert_allclose(op.to_dense().numpy(), sym.to_dense().numpy(), atol=1e-15)
    assert torch.equal(D, sym.diag_blocks())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,bw,M", GEOMETRIES[:3])
def test_f32_bf16_matvec_matches(dtype, B, bw, M):
    K = 2
    band = _band(M, bw, seed=9, dtype=np.float32)
    jop = JBanded.from_band(band, block_size=B, K=K, s=0.1, dtype=dtype)
    op = _cross(jop)
    assert op.accum_dtype == "float32" and str(op.blocks.dtype).split(".")[-1] == dtype
    x = np.random.default_rng(2).normal(size=(2 * K, op.M)).astype(np.float32)
    y = op.matvec(torch.from_numpy(x))
    assert y.dtype == torch.float32
    y_jax = np.asarray(jop.matvec(jnp.asarray(x)), np.float64)
    scale = np.abs(y_jax).max()
    np.testing.assert_allclose(y.numpy().astype(np.float64) / scale, y_jax / scale,
                               rtol=0, atol=SCALED_TOL)


def test_bad_accum_dtype_raises():
    with pytest.raises(ValueError, match="accum_dtype"):
        BandedLD(blocks=torch.zeros(1, 2, 3, 4, 4), accum_dtype="float16")
    with pytest.raises(ValueError, match="unsupported BandedLD dtype"):
        BandedLD.from_band(_band(128, 10, 0), block_size=64, dtype="int8", device="cpu")
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="--platform cpu"):
            BandedLD.from_band(_band(128, 10, 0), block_size=64)
        with pytest.raises(RuntimeError, match="--platform cpu"):
            interop.banded_from_numpy(np.zeros((1, 1, 1, 4, 4)))


@pytest.mark.parametrize("sub_block", [0, 32])
def test_block_jacobi_over_banded_matches_jax(sub_block):
    band = _band(300, 96, seed=12)
    jop = JBanded.from_band(band, block_size=64, K=2, s=0.02)
    op = _cross(jop)
    got = tpre._extract_sub_blocks(op, sub_block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpre._extract_sub_blocks(jop, sub_block)))
    tQ, tlam = tpre.block_jacobi_eig(op, sub_block, 2048, torch.float32)
    jQ, jlam = jpre.block_jacobi_eig(jop, sub_block, 2048, jnp.float32)
    np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam), rtol=1e-4, atol=1e-5)


N, LAM, H2 = 20000, 0.05, 0.7


@pytest.mark.parametrize("K", [1, 2])
def test_f64_trajectory_over_banded_matches(K):
    M, B, bw, iters = 300, 64, 100, 4     # ragged M (pads to 320), hb = 2
    band, r, x0 = simulate_ld_band(N, M, bw, h2=H2, lam=LAM, n_r=K,
                                   rng=np.random.default_rng(50 + K), dtype=np.float64)
    jop = JBanded.from_band(band, block_size=B, K=K, s=0.05)
    top = _cross(jop)
    Mp = top.M
    mask = (np.arange(Mp) < M).astype(np.float64)
    rp = np.zeros((K, Mp))
    rp[:, :M] = np.atleast_2d(r)
    a, Nk = np.full(K, 1.0 / K), np.full(K, float(N))
    cfg = dict(prior_update="em", dtype="float64", cg_maxit=200, cg_rtol=1e-7,
               em_prior_maxit=20, rho=0.5)
    prior = (LAM, [1.0], [H2 / max(int(M * LAM), 1) * N])
    jeng = jvamp.VampEngine(
        jvamp.VampInputs(op=jop, r=jnp.asarray(rp), a=jnp.asarray(a), N=jnp.asarray(Nk),
                         mask=jnp.asarray(mask)),
        JConfig(**cfg), JPrior.create(*prior))
    teng = tvamp.VampEngine(
        interop.inputs_from_numpy(top, rp, a, Nk, mask=mask, dtype=torch.float64, device="cpu"),
        TConfig(**cfg), TPrior.create(*prior, device="cpu"))
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
    assert hj["alignment"][-1] > 0.9


def test_estimate_bandwidth_matches():
    rng = np.random.default_rng(0)
    A = np.triu(np.tril(rng.normal(size=(40, 40)), 7), -3)
    for R in (A, scipy.sparse.csr_matrix(A), np.zeros((5, 5))):
        for q in (1.0, 0.9):
            assert tld.estimate_bandwidth(R, q) == jld.estimate_bandwidth(R, q)
    assert tld.estimate_bandwidth(A) == 7 and tld.estimate_bandwidth(np.zeros((3, 3))) == 0


# ---------------------------------------------------------------------------
# --operator banded through the command line
# ---------------------------------------------------------------------------

def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f, delimiter="\t"))


@pytest.fixture(scope="module")
def band_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("band")
    assert tsim.main(["gen-band", "--out", str(d / "p"), "--N", "20000", "--M", "1000",
                      "--h2", "0.7", "--lam", "0.02", "--bandwidth", "64", "--seed", "3",
                      "--uncompressed"]) == 0
    # the same panel as a dense .npy, for the from_dense branch
    R = scipy.sparse.load_npz(d / "p_R.npz")
    np.save(d / "p_R.npy", np.asarray(R.todense()))
    return d


def _run_banded(cli, band_dir, out, ld_file, ld_dtype, extra=()):
    return cli.main([
        "--ld-files", str(band_dir / ld_file), "--r-files", str(band_dir / "p_r.npy"),
        "--true-signal-file", str(band_dir / "p_bet.npy"),
        "--out-dir", str(out), "--out-name", "b", "--N", "20000", "--M", "1000",
        "--iterations", "6", "--platform", "cpu", "--x64", "0", "--dtype", "float32",
        "--operator", "banded", "--ld-dtype", ld_dtype, "--block-size", "128",
        "--prior-probs", "0.98,0.02", "--prior-vars", "0,0.035",
        "--lmmse-damp", "1", "--cg-precond-block", "64", "--cg-precond-dtype", "bfloat16",
        "--stop-on-divergence", "1", "--compile-cache-dir", "", *extra])


@pytest.mark.parametrize("ld_file,ld_dtype,extra", [
    ("p_R.npz", "float32", ["--bandwidth", "64"]),      # band-direct, from_band
    ("p_R.npz", "bfloat16", ["--bandwidth", "64"]),
    ("p_R.npy", "float32", []),                          # dense, from_dense, bandwidth estimated
    ("p_R.npy", "float32", ["--bandwidth", "64"]),
])
def test_cli_banded_matches_the_jax_cli(band_dir, tmp_path, ld_file, ld_dtype, extra):
    assert _run_banded(tcli, band_dir, tmp_path / "t", ld_file, ld_dtype, extra) == 0
    assert _run_banded(jcli, band_dir, tmp_path / "j", ld_file, ld_dtype, extra) == 0
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


def test_cli_banded_f64_equals_sym_and_writes_the_same_bytes_twice(band_dir, tmp_path):
    """In float64 with one seed the banded and the sym operator hold the same
    matrix: the runs agree to rtol 1e-8, and a rerun is equal to the byte."""
    outs = {}
    for name, op in (("banded", "banded"), ("again", "banded"), ("sym", "sym")):
        out = tmp_path / name
        assert tcli.main([
            "--ld-files", str(band_dir / "p_R.npz"), "--r-files", str(band_dir / "p_r.npy"),
            "--out-dir", str(out), "--out-name", "t", "--N", "20000", "--M", "1000",
            "--iterations", "3", "--platform", "cpu", "--x64", "1", "--operator", op,
            "--block-size", "128", "--bandwidth", "64", "--seed", "7", "--cg-rtol", "1e-10",
            "--prior-probs", "0.98,0.02", "--prior-vars", "0,0.035"]) == 0
        outs[name] = (out / "t_xhat_it_2.bin").read_bytes()
    assert outs["banded"] == outs["again"]
    np.testing.assert_allclose(np.frombuffer(outs["banded"], "<f8"),
                               np.frombuffer(outs["sym"], "<f8"), rtol=1e-8, atol=1e-12)


def test_cli_banded_rejects_quantized_storage():
    with pytest.raises(SystemExit, match="requires --operator sym"):
        tcli.main(["--ld-files", "R.npz", "--r-files", "r.npy", "--N", "10", "--M", "10",
                   "--platform", "cpu", "--operator", "banded", "--ld-dtype", "int8"])
