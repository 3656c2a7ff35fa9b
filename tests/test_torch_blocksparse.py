"""The port's BlockSparseLD (sgvamp_torch.core.operators), its cut over a
mesh (parallel/sharding.py, kind "blocksparse") and --operator blocksparse
on the command line, against the JAX package's, on the CPU.

Both packages get the same scipy matrices: two cohorts with different
patterns, long-range entries far off the band, and a ragged M whose
padded markers get an identity diagonal. Tolerances:
  * from_csr: blocks, rows and cols identical, bf16 included;
  * matvec against JAX and against to_dense(): float64 1e-12, float32 a
    scaled 1e-6, bfloat16 (x rounded to bf16, f32 sums) a scaled 1e-5 -
    "scaled" is max|a - b| / max|b|;
  * the sharded operator against the unsharded one and JAX's sharded one:
    1e-12 in float64 (the cells' partial sums are added in another order);
  * float64 trajectories with injected probes: 1e-8 against JAX (other
    reduction orders everywhere);
  * run_scan against run, and a repeated matvec: bit for bit;
  * the command lines, with the same probe injected into both (their
    generators differ): the same file set and CSV headers, every value
    within 1e-8 in float64; the port's --fused 1 files equal its host
    loop's to the byte.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from sgvamp_torch import interop
from sgvamp_torch.cli import main as tcli
from sgvamp_torch.config import VampConfig as TConfig
from sgvamp_torch.core import operators
from sgvamp_torch.core import vamp as tvamp
from sgvamp_torch.core.operators import BlockSparseLD as TBS
from sgvamp_torch.core.prior import PriorState as TPrior
from sgvamp_torch.parallel import sharding as tsh
from sgvamp_tpu.cli import main as jcli
from sgvamp_tpu.config import VampConfig as JConfig
from sgvamp_tpu.core import vamp as jvamp
from sgvamp_tpu.core.operators import BlockSparseLD as JBS
from sgvamp_tpu.core.prior import PriorState as JPrior
from sgvamp_tpu.parallel import sharding as jsh

B = 64
N = 5000


def _sparse_ld(rng, M, bw, long_range):
    """Banded LD plus symmetric long-range entries, made diagonally
    dominant (so SPD)."""
    diags, offs = [], []
    for d in range(-bw, bw + 1):
        v = np.ones(M) if d == 0 else np.exp(-abs(d) / 8.0) * rng.uniform(0.4, 0.6, M - abs(d))
        diags.append(v)
        offs.append(d)
    R = scipy.sparse.diags(diags, offs, shape=(M, M), format="lil")
    for i, j, v in long_range:
        R[i, j] = v
        R[j, i] = v
    R = R.tocsr()
    return (R + scipy.sparse.diags(np.abs(R).sum(axis=1).A1 - 1.0, 0)).tocsr()


def _pair(M, seed=0):
    rng = np.random.default_rng(seed)
    R1 = _sparse_ld(rng, M, 12, [(10, M - 20, 0.3), (100, 300, -0.2)])
    R2 = _sparse_ld(rng, M, 6, [(5, 250, 0.15), (200, M - 10, 0.25)])
    return [R1, R2]


@pytest.fixture(scope="module")
def ragged():
    return _pair(500)        # nb = 8, the last 12 markers padded


@pytest.fixture(scope="module")
def even():
    return _pair(512, seed=1)


def _both(Rs, dtype=None, s=0.0, M=None):
    jop = JBS.from_csr(Rs, block_size=B, s=s, dtype=None if dtype is None else np.dtype(dtype),
                       M=M)
    top = TBS.from_csr(Rs, block_size=B, s=s, dtype=dtype, M=M, device="cpu")
    return jop, top


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _scaled(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
                 / np.abs(np.asarray(b, np.float64)).max())


# ---------------------------------------------------------------------------
# (a) from_csr, matvec, diag_blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", ["csr", "shuffled"])
@pytest.mark.parametrize("dtype", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("which", ["ragged", "even"])
def test_from_csr_is_the_jax_operator(request, which, dtype, order):
    """From CSR matrices (a tile's entries in a row are one run of equal
    keys) and from COO matrices with their entries shuffled (runs of one
    entry): the same operator as the JAX package's."""
    Rs = request.getfixturevalue(which)
    if order == "shuffled":
        rng = np.random.default_rng(7)
        Rs = [scipy.sparse.coo_matrix((c.data[p], (c.row[p], c.col[p])), shape=c.shape)
              for c in (R.tocoo() for R in Rs) for p in [rng.permutation(c.nnz)]]
    jop, top = _both(Rs, dtype, s=0.05)
    assert (top.nb, top.s, top.accum_dtype, top.K) == (jop.nb, jop.s, jop.accum_dtype, 2)
    assert top.blocks.dtype == {None: torch.float64, "float32": torch.float32,
                                "bfloat16": torch.bfloat16}[dtype]
    np.testing.assert_array_equal(_np(top.blocks), np.asarray(jop.blocks).astype(
        _np(top.blocks).dtype))
    assert top.rows.dtype == top.cols.dtype == torch.int32
    np.testing.assert_array_equal(top.rows.numpy(), np.asarray(jop.rows))
    np.testing.assert_array_equal(top.cols.numpy(), np.asarray(jop.cols))
    # the long-range blocks are stored, far off the band
    assert int((top.cols - top.rows).abs().max()) >= top.nb - 2
    assert top.bytes_per_pass() == jop.bytes_per_pass()
    if which == "ragged":
        M = Rs[0].shape[0]
        dense = top.to_dense()
        eye = torch.eye(top.M - M, dtype=dense.dtype).expand(2, -1, -1)
        torch.testing.assert_close(dense[:, M:, M:], eye, rtol=0, atol=1e-15)
        assert not dense[:, :M, M:].any() and not dense[:, M:, :M].any()
    # one process's share of the cohorts: the union pattern, its blocks
    part = TBS.from_csr(Rs, block_size=B, s=0.05, dtype=dtype, device="cpu",
                        cohorts=slice(1, 2))
    assert torch.equal(part.rows, top.rows) and torch.equal(part.blocks, top.blocks[1:])


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("dtype,tol", [(None, 1e-12), ("float32", 1e-6), ("bfloat16", 1e-5)])
def test_matvec_matches_jax_and_dense(ragged, dtype, tol, S):
    jop, top = _both(ragged, dtype, s=0.05)
    x = np.random.default_rng(S).normal(size=(S * 2, top.M))
    xdt = np.float64 if dtype is None else np.float32
    x = x.astype(xdt)
    got = top.matvec(torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == x.shape
    want_j = np.asarray(jop.matvec(jnp.asarray(x)))
    # to_dense in f64: R takes x as the blocks see it (bf16 rounds it), the
    # s term x itself
    xr = torch.from_numpy(x).to(top.blocks.dtype).double().numpy().reshape(S, 2, -1)
    Rs = top.to_dense().double().numpy() - 0.05 * np.eye(top.M)
    want_d = (np.einsum("kij,skj->ski", Rs, xr) + 0.05 * x.reshape(S, 2, -1)).reshape(x.shape)
    if dtype is None:
        np.testing.assert_allclose(got.numpy(), want_j, rtol=0, atol=tol * np.abs(want_j).max())
        np.testing.assert_allclose(got.numpy(), want_d, rtol=0, atol=tol * np.abs(want_d).max())
    else:
        assert _scaled(got.numpy(), want_j) <= tol
        assert _scaled(got.numpy(), want_d) <= tol
    # no atomics: a repeat gives the same bits
    assert torch.equal(top.matvec(torch.from_numpy(x)), got)


def test_heavy_block_row_adds_no_padding(monkeypatch):
    """One block row with a tile in every block column (LD from one region
    to all others): every slot stands once in the row tables, whatever the
    widest row, and the matvec holds against JAX and to_dense(), in
    float64 and in bfloat16 widened a few tiles at a time."""
    rng = np.random.default_rng(5)
    M = 1000
    nb = -(-M // B)
    R = _sparse_ld(rng, M, 6, [(3, j * B + 7, 0.01) for j in range(2, nb)])
    monkeypatch.setattr(operators, "_WIDEN_TILES", 5)
    for dtype, tol in ((None, 1e-12), ("bfloat16", 1e-5)):
        jop, top = _both([R], dtype, s=0.05)
        assert np.bincount(top.rows.numpy(), minlength=nb)[0] == nb
        slots = torch.cat([t.flatten() for _, t in top._buckets])
        assert torch.equal(torch.sort(slots).values, torch.arange(top.nnzb))
        x = np.random.default_rng(1).normal(size=(2, top.M)).astype(
            np.float64 if dtype is None else np.float32)
        got = top.matvec(torch.from_numpy(x)).numpy()
        xr = torch.from_numpy(x).to(top.blocks.dtype).double().numpy().reshape(2, 1, -1)
        Rs = top.to_dense().double().numpy() - 0.05 * np.eye(top.M)
        want_d = (np.einsum("kij,skj->ski", Rs, xr) + 0.05 * x.reshape(2, 1, -1)).reshape(x.shape)
        assert _scaled(got, np.asarray(jop.matvec(jnp.asarray(x)))) <= tol
        assert _scaled(got, want_d) <= tol


def test_tf32_is_off_for_the_products_and_the_callers_setting_comes_back():
    """_ieee_float32 writes nothing by default; where the caller allowed
    TF32 (here through the legacy switch) it is off inside and the
    caller's setting, as either API reads it, is back after."""
    import types

    m = torch.backends.cuda.matmul
    f32_card = types.SimpleNamespace(is_cuda=True, dtype=torch.float32)
    with operators._ieee_float32(f32_card):
        assert m.fp32_precision in ("none", "ieee")
    try:
        torch.set_float32_matmul_precision("medium")
        for t in (f32_card, torch.zeros(1)):
            with operators._ieee_float32(t):
                assert m.fp32_precision == ("ieee" if t is f32_card else "tf32")
            assert m.fp32_precision == "tf32"
            assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision("highest")
    assert torch.get_float32_matmul_precision() == "highest"


def _pad_slots(op, n):
    """op's slot list padded with n all-zero blocks at rows = cols = 0, as
    the JAX package pads it under a shard axis."""
    return dataclasses.replace(
        op, blocks=torch.cat([op.blocks, op.blocks.new_zeros((op.K, n, op.B, op.B))], dim=1),
        rows=torch.cat([op.rows, op.rows.new_zeros(n)]),
        cols=torch.cat([op.cols, op.cols.new_zeros(n)]))


@pytest.mark.parametrize("which", ["ragged", "even"])
def test_diag_blocks_equal_jax_padded_and_unpadded(request, which):
    jop, top = _both(request.getfixturevalue(which), s=0.05)
    want = np.asarray(jop.diag_blocks())
    assert torch.equal(top.diag_blocks(), torch.from_numpy(want.copy()))
    padded = _pad_slots(top, 3)
    jpad = dataclasses.replace(
        jop, blocks=jnp.pad(jop.blocks, ((0, 0), (0, 3), (0, 0), (0, 0))),
        rows=jnp.pad(jop.rows, (0, 3)), cols=jnp.pad(jop.cols, (0, 3)))
    assert np.array_equal(np.asarray(jpad.diag_blocks()), want)
    assert torch.equal(padded.diag_blocks(), top.diag_blocks())
    # the padding adds zeros into block row 0: the same product
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, top.M)))
    assert torch.equal(padded.matvec(x), top.matvec(x))


def test_interop_carries_the_jax_operator_across(ragged):
    jop, top = _both(ragged, "bfloat16")
    op = interop.blocksparse_from_numpy(
        np.asarray(jop.blocks.astype(jnp.float32)), np.asarray(jop.rows), np.asarray(jop.cols),
        jop.nb, s=jop.s, accum_dtype=jop.accum_dtype, dtype=torch.bfloat16, device="cpu")
    for f in ("blocks", "rows", "cols"):
        assert torch.equal(getattr(op, f), getattr(top, f)), f
    assert (op.nb, op.s, op.accum_dtype) == (top.nb, top.s, top.accum_dtype)


# ---------------------------------------------------------------------------
# (b) under a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_sharded_operator_matches_unsharded_and_jax(ragged, shape):
    jop, top = _both(ragged, s=0.05)
    if shape == (1, 4):
        assert top.nnzb % 4, "the case must pad the slot list"
    K = 2
    jmesh = jsh.make_mesh(*shape)
    jin = jvamp.VampInputs(op=jop, r=jnp.zeros((K, jop.M)), a=jnp.full((K,), 0.5),
                           N=jnp.full((K,), float(N)))
    jsharded = jsh.shard_inputs(jin, jmesh).op
    mesh = interop.mesh_like(shape, device="cpu")
    inputs = tvamp.VampInputs(op=top, r=torch.zeros((K, top.M), dtype=torch.float64),
                              a=torch.full((K,), 0.5, dtype=torch.float64),
                              N=torch.full((K,), float(N), dtype=torch.float64))
    sh = tsh.shard_inputs(inputs, mesh).op
    assert isinstance(sh, tsh.MeshLD) and sh.kind == "blocksparse"
    n = shape[1]
    w = -(-top.nnzb // n)
    for row in sh.cells:
        for j, cell in enumerate(row):
            assert cell.nnzb == w and cell.s == 0.0 and cell.K == K // shape[0]
    assert int(sh.cells[0][-1].rows[-1]) == 0 or top.nnzb % n == 0
    x = np.random.default_rng(5).normal(size=(2 * K, top.M))
    got = sh.matvec(torch.from_numpy(x)).numpy()
    want = top.matvec(torch.from_numpy(x)).numpy()
    want_j = np.asarray(jsharded.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(got, want_j, rtol=0, atol=1e-12 * np.abs(want).max())
    assert torch.equal(sh.matvec(torch.from_numpy(x)), torch.from_numpy(got))
    assert torch.equal(sh.diag_blocks(), top.diag_blocks())


# ---------------------------------------------------------------------------
# (c) the engine
# ---------------------------------------------------------------------------

def _problem(Rs, seed=7):
    rng = np.random.default_rng(seed)
    M = Rs[0].shape[0]
    beta = np.where(rng.random(M) < 0.1, rng.normal(0, 0.3, M), 0.0)
    r = np.stack([R @ beta + rng.normal(0, 0.05, M) for R in Rs])
    return r, beta


def _engines(Rs, cfg, mesh_shape=None):
    jop, top = _both(Rs)
    r, beta = _problem(Rs)
    K, M = r.shape
    Mp = top.M
    rp = np.zeros((K, Mp))
    rp[:, :M] = r
    mask = (np.arange(Mp) < M).astype(np.float64)
    a, Nk = np.full(K, 1.0 / K), np.full(K, float(N))
    prior_args = (0.1, [1.0], [0.5 * N])
    jin = jvamp.VampInputs(op=jop, r=jnp.asarray(rp), a=jnp.asarray(a), N=jnp.asarray(Nk),
                           mask=jnp.asarray(mask))
    jeng = jvamp.VampEngine(jin, JConfig(**cfg), JPrior.create(*prior_args))
    tin = interop.inputs_from_numpy(top, rp, a, Nk, mask=mask, dtype=torch.float64,
                                    device="cpu")
    mesh = None if mesh_shape is None else interop.mesh_like(mesh_shape, device="cpu")
    teng = tvamp.VampEngine(tin, TConfig(**cfg), TPrior.create(*prior_args, device="cpu"),
                            mesh=mesh)
    return jeng, teng, M


F64 = dict(prior_update="em", dtype="float64", cg_maxit=300, cg_rtol=1e-10, lmmse_damp=True,
           cg_precond_block=64)


def test_f64_trajectory_with_preconditioner_matches_jax(ragged):
    jeng, teng, M = _engines(ragged, F64)
    iters = 4
    u = np.random.default_rng(9).choice([-1.0, 1.0], size=(iters, 2, teng.inputs.op.M))
    hj = jeng.run(iters, fixed_u=u, M_out=M)
    ht = teng.run(iters, fixed_u=u, M_out=M)
    for it in range(iters):
        top = np.abs(hj["xhat1"][it]).max()
        np.testing.assert_allclose(ht["xhat1"][it], hj["xhat1"][it], rtol=1e-8,
                                   atol=1e-8 * top)
        np.testing.assert_allclose(np.asarray(ht["params"][it]), np.asarray(hj["params"][it]),
                                   rtol=1e-8)
        np.testing.assert_array_equal(ht["cg1_iters"][it], hj["cg1_iters"][it])
    assert np.abs(ht["xhat1"][-1]).max() > 0


@pytest.mark.parametrize("mesh_shape", [None, (1, 4)])
def test_run_scan_equals_run_bit_for_bit(ragged, mesh_shape):
    _, teng, _ = _engines(ragged, F64, mesh_shape)
    hist = teng.run(3, seed=4)
    state, aux = teng.run_scan(3, seed=4)
    for it in range(3):
        assert torch.equal(aux.xhat1[it], torch.from_numpy(hist["xhat1"][it]))
        assert np.array_equal(aux.gam1[it].numpy(), np.asarray(hist["params"][it])[:, 2])
    for f in tvamp._VECTORS:
        assert torch.equal(getattr(state, f), getattr(hist["state"], f)), f


# ---------------------------------------------------------------------------
# (d) the command line
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    d = tmp_path_factory.mktemp("bs")
    Rs = _pair(500, seed=3)
    r, beta = _problem(Rs)
    for k, R in enumerate(Rs):
        scipy.sparse.save_npz(d / f"R{k}.npz", R)
        np.save(d / f"r{k}.npy", r[k] * np.sqrt(N))
    np.save(d / "bet.npy", (beta * np.sqrt(N)).reshape(-1, 1))
    return d


def _same_probe(monkeypatch, K, M):
    """The same (K, M) Rademacher probe in every step of both command
    lines (their generators differ)."""
    U = np.random.default_rng(17).choice([-1.0, 1.0], size=(K, M))
    monkeypatch.setattr(jax.random, "rademacher",
                        lambda key, shape, dtype: jnp.asarray(U[:, :shape[1]], dtype))
    monkeypatch.setattr(tvamp, "draw_probe", lambda gen, K_, M_, device, dtype: torch.as_tensor(
        U[:K_, :M_], dtype=dtype, device=device))


def _argv(d, out, K, *extra):
    return ["--ld-files", ",".join(str(d / f"R{k}.npz") for k in range(K)),
            "--r-files", ",".join(str(d / f"r{k}.npy") for k in range(K)),
            "--true-signal-file", str(d / "bet.npy"), "--out-dir", str(out), "--out-name", "b",
            "--N", str(N), "--M", "500", "--K", str(K), "--iterations", "4",
            "--operator", "blocksparse", "--block-size", str(B), "--platform", "cpu",
            "--x64", "1", "--cg-rtol", "1e-10", "--cg-precond-block", "32", *extra]


def _files(out):
    return {n: (out / n).read_bytes() for n in sorted(os.listdir(out))}


def _assert_files_close(got, want):
    assert sorted(got) == sorted(want) and "b_xhat_it_3.bin" in got
    for name in want:
        if name.endswith(".bin"):
            a, b = (np.frombuffer(v[name], "<f8") for v in (got, want))
            np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8 * np.abs(b).max(),
                                       err_msg=name)
        else:
            ga, wa = (v[name].decode().splitlines() for v in (got, want))
            assert ga[0] == wa[0] and len(ga) == len(wa)
            for x, y in zip(ga[1:], wa[1:]):
                np.testing.assert_allclose(np.array(x.split("\t"), float),
                                           np.array(y.split("\t"), float), rtol=1e-8,
                                           atol=1e-12, err_msg=name)


@pytest.mark.parametrize("K", [1, 2])
def test_cli_blocksparse_npz_matches_the_jax_cli(npz, tmp_path, monkeypatch, caplog, K):
    _same_probe(monkeypatch, K, 512)
    with caplog.at_level("INFO", logger="sgvamp"):
        assert tcli.main(_argv(npz, tmp_path / "t", K)) == 0
    blocks_t = [m for m in caplog.messages if m.startswith("Block-sparse LD:")]
    caplog.clear()
    with caplog.at_level("INFO", logger="sgvamp"):
        assert jcli.main(_argv(npz, tmp_path / "j", K, "--compile-cache-dir", "")) == 0
    blocks_j = [m for m in caplog.messages if m.startswith("Block-sparse LD:")]
    assert blocks_t == blocks_j and len(blocks_t) == 1 and "(64x64)" in blocks_t[0]
    _assert_files_close(_files(tmp_path / "t"), _files(tmp_path / "j"))
    # the fused run writes the host loop's files, byte for byte
    assert tcli.main(_argv(npz, tmp_path / "f", K, "--fused", "1")) == 0
    assert _files(tmp_path / "f") == _files(tmp_path / "t")


def test_cli_sym_drops_the_long_range_entries_blocksparse_keeps(npz, tmp_path, caplog):
    base = _argv(npz, tmp_path / "s", 1, "--iterations", "1")
    with caplog.at_level("INFO", logger="sgvamp"):
        assert tcli.main(base + ["--operator", "sym", "--bandwidth", "40"]) == 0
    assert any("LD entries outside bandwidth" in m for m in caplog.messages)
    caplog.clear()
    with caplog.at_level("INFO", logger="sgvamp"):
        assert tcli.main(base) == 0
    assert not any("outside bandwidth" in m for m in caplog.messages)


def test_cli_blocksparse_two_ld_cohorts_matches_the_jax_cli(tmp_path, monkeypatch):
    from test_torch_ld import _cohort_files

    rng = np.random.default_rng(0)
    M, n = 40, 4000
    variants = [f"rs{i}" for i in range(M)]
    chrom = [1 + (i >= M // 2) for i in range(M)]
    coords = [10 * (1 + i % (M // 2)) for i in range(M)]
    X = rng.binomial(2, 0.4, size=(n, M)).astype(np.float64)
    X = (X - X.mean(0)) / X.std(0)
    beta = np.zeros(M)
    beta[rng.choice(M, 6, replace=False)] = rng.normal(0, 0.4, 6)
    Xn = X / np.sqrt(n)
    R = Xn.T @ Xn
    r_ref = Xn.T @ (X @ beta + rng.normal(0, 0.5, n))
    dist = np.abs(np.arange(M)[:, None] - np.arange(M)[None, :])
    # the band plus the pairs 25 markers apart: blocks far off the band
    R_sp = np.where((np.abs(R) > 0.02) & ((dist <= 6) | (dist == 25)), R, 0.0)
    files = [_cohort_files(tmp_path, tag, [variants[i] for i in sel], [chrom[i] for i in sel],
                           [coords[i] for i in sel], R_sp[np.ix_(sel, sel)], r_ref[sel])
             for tag, sel in (("c0", list(range(30))), ("c1", list(range(10, 40))))]
    np.save(tmp_path / "beta.npy", (beta / np.sqrt(n)).reshape(M, 1))
    _same_probe(monkeypatch, 2, M + (-M) % 8)

    def run(cli, out, *extra):
        return cli.main([
            "--ld-files", ",".join(f[1] for f in files),
            "--r-files", ",".join(f[2] for f in files),
            "--bim-files", ",".join(f[0] for f in files),
            "--true-signal-file", str(tmp_path / "beta.npy"),
            "--out-dir", str(out), "--out-name", "b", "--N", "4000,5000", "--M", "30,30",
            "--K", "2", "--iterations", "4", "--s", "0.2", "--platform", "cpu", "--x64", "1",
            "--operator", "blocksparse", "--block-size", "8", "--seed", "11",
            "--cg-rtol", "1e-10", *extra])

    assert run(tcli, tmp_path / "t") == 0
    assert run(jcli, tmp_path / "j", "--compile-cache-dir", "") == 0
    got, want = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert got["b.bim"] == want["b.bim"]
    _assert_files_close({k: v for k, v in got.items() if k != "b.bim"},
                        {k: v for k, v in want.items() if k != "b.bim"})
