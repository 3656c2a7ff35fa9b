"""The port's block-Jacobi preconditioner against the JAX package's, on the
CPU, on the same blocks.

In f64 both compute the same factorizations with LAPACK, so the results
agree to rtol 1e-10; eigenvectors are defined up to sign, so they are
compared through the rebuilt inverse blocks, not entry by entry.
Preconditioned CG must take the same number of iterations in both (the
test systems keep condition numbers at or below 81, where CG is not
chaotic in rounding).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sgvamp_torch.config import VampConfig as TConfig
from sgvamp_torch.core import precond as tpre
from sgvamp_torch.core import vamp as tvamp
from sgvamp_torch.core.cg import cg_batched as tcg
from sgvamp_torch.core.operators import DenseLD as TDenseLD
from sgvamp_torch.core.prior import PriorState as TPrior
from sgvamp_torch.ops.band_kernel import SymBandedLD
from sgvamp_tpu.config import VampConfig as JConfig
from sgvamp_tpu.core import precond as jpre
from sgvamp_tpu.core import vamp as jvamp
from sgvamp_tpu.core.cg import cg_batched as jcg
from sgvamp_tpu.core.operators import DenseLD as JDenseLD
from sgvamp_tpu.core.prior import PriorState as JPrior
from sgvamp_tpu.data.simulate import band_to_dense, simulate_ld_band
from sgvamp_tpu.ops.band_kernel import SymBandedLD as JSym

RTOL = 1e-10


class _Blocks:
    """An operator that only exposes given diagonal blocks."""

    def __init__(self, D):
        self.D = D

    def diag_blocks(self):
        return self.D


def _spd_blocks(K, nb, B, seed, cond=81.0):
    """(K, nb, B, B) f64 SPD blocks with eigenvalues in [1, cond]."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(K, nb, B, B)))
    lam = np.exp(rng.uniform(0.0, np.log(cond), size=(K, nb, B)))
    lam[..., 0], lam[..., -1] = 1.0, cond
    return np.einsum("knpi,kni,knqi->knpq", Q, lam, Q)


def _ops(D):
    return _Blocks(jnp.asarray(D)), _Blocks(torch.from_numpy(D))


@pytest.mark.parametrize("sub_block", [0, 8, 16])
def test_extract_sub_blocks_matches(sub_block):
    D = _spd_blocks(2, 3, 16, seed=0)
    jop, top = _ops(D)
    got = tpre._extract_sub_blocks(top, sub_block).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpre._extract_sub_blocks(jop, sub_block)))
    P = sub_block or 16
    assert got.shape == (2, 3 * 16 // P, P, P)
    ns = 16 // P   # sub-block j of storage block n sits at index n * ns + j
    for n, j in ((0, 0), (1, ns - 1), (2, 0)):
        np.testing.assert_array_equal(
            got[1, n * ns + j], D[1, n][j * P:(j + 1) * P, j * P:(j + 1) * P])
    with pytest.raises(ValueError, match="divide"):
        tpre._extract_sub_blocks(top, 5)


@pytest.mark.parametrize("sub_block,chunk", [(0, 2048), (8, 2048), (8, 5), (16, 0)])
def test_block_jacobi_inverse_matches(sub_block, chunk):
    D = _spd_blocks(2, 7, 16, seed=1)
    gamw, gam2 = np.array([2.0, 0.5]), np.array([0.3, 4.0])
    jop, top = _ops(D)
    want = np.asarray(jpre.block_jacobi_inverse(
        jop, jnp.asarray(gamw), jnp.asarray(gam2), sub_block, dtype=jnp.float64,
        setup_chunk=chunk))
    got = tpre.block_jacobi_inverse(
        top, torch.from_numpy(gamw), torch.from_numpy(gam2), sub_block,
        dtype=torch.float64, setup_chunk=chunk)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    # and it is the inverse: Pinv (gamw D + gam2 I) = I on the first block
    P = sub_block or 16
    A = gamw[0] * D[0, 0][:P, :P] + gam2[0] * np.eye(P)
    np.testing.assert_allclose(got[0, 0].numpy() @ A, np.eye(P), atol=1e-10)


@pytest.mark.parametrize("sub_block,chunk", [(0, 2048), (8, 5), (16, 0)])
def test_eig_and_rebuild_match(sub_block, chunk):
    D = _spd_blocks(2, 7, 16, seed=2)
    gamw, gam2 = np.array([2.0, 0.5]), np.array([0.3, 4.0])
    jop, top = _ops(D)
    jQ, jlam = jpre.block_jacobi_eig(jop, sub_block, chunk)
    tQ, tlam = tpre.block_jacobi_eig(top, sub_block, chunk)
    assert tQ.dtype == tlam.dtype == torch.float64
    assert tuple(tQ.shape) == jQ.shape and tuple(tlam.shape) == jlam.shape
    np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam), rtol=RTOL)
    want = np.asarray(jpre.block_jacobi_from_eig(
        jQ, jlam, jnp.asarray(gamw), jnp.asarray(gam2), dtype=jnp.float64, chunk=chunk))
    got = tpre.block_jacobi_from_eig(tQ, tlam, torch.from_numpy(gamw),
                                     torch.from_numpy(gam2), dtype=torch.float64,
                                     chunk=chunk).numpy()
    # both round the product to float32 (the JAX einsum's
    # preferred_element_type), from f64 factors that agree to 1e-10
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7 * np.abs(want).max())
    # the rebuilt blocks equal the direct inverse, to that float32 rounding
    direct = tpre.block_jacobi_inverse(top, torch.from_numpy(gamw), torch.from_numpy(gam2),
                                       sub_block, dtype=torch.float64).numpy()
    np.testing.assert_allclose(got, direct, rtol=0, atol=2e-7 * np.abs(direct).max())
    # the f64 eigenvectors themselves, through the product they define
    P = tQ.shape[-1]
    tq, jq = tQ.numpy(), np.asarray(jQ)
    np.testing.assert_allclose(np.einsum("knpi,kni,knqi->knpq", tq, tlam.numpy(), tq),
                               np.einsum("knpi,kni,knqi->knpq", jq, np.asarray(jlam), jq),
                               rtol=RTOL, atol=RTOL * 81)
    np.testing.assert_allclose(np.einsum("knpi,knqi->knpq", tq, tq),
                               np.broadcast_to(np.eye(P), tq.shape), atol=1e-12)


def test_eig_storage_dtype_and_low_precision_rebuild():
    D = _spd_blocks(1, 5, 16, seed=3).astype(np.float32)
    jop, top = _ops(D)
    gamw, gam2 = np.array([1.5], np.float32), np.array([0.7], np.float32)
    tQ, tlam = tpre.block_jacobi_eig(top, 8, 2048, torch.bfloat16)
    jQ, jlam = jpre.block_jacobi_eig(jop, 8, 2048, jnp.bfloat16)
    assert tQ.dtype == torch.bfloat16 and tlam.dtype == torch.float32
    assert jQ.dtype == jnp.bfloat16 and jlam.dtype == jnp.float32
    got = tpre.block_jacobi_from_eig(tQ, tlam, torch.from_numpy(gamw),
                                     torch.from_numpy(gam2), dtype=torch.bfloat16)
    want = jpre.block_jacobi_from_eig(jQ, jlam, jnp.asarray(gamw), jnp.asarray(gam2),
                                      dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    # bf16 eigenvectors (2^-9 relative) from two f32 LAPACK runs: the
    # rebuilt blocks agree to a few bf16 roundings of their largest entry
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), w, rtol=0, atol=0.03 * np.abs(w).max())


@pytest.mark.parametrize("pdtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("lanes", [1, 2])
def test_apply_block_jacobi_matches(pdtype, lanes):
    K, nbp, P = 2, 6, 8
    rng = np.random.default_rng(4)
    Pinv = rng.normal(size=(K, nbp, P, P))
    v = rng.normal(size=(lanes * K, nbp * P))
    jP = jnp.asarray(Pinv).astype(pdtype)
    tP = torch.from_numpy(np.array(jP.astype(jnp.float64))).to(getattr(torch, pdtype))
    want = np.asarray(jpre.apply_block_jacobi(jP, jnp.asarray(v)))
    got = tpre.apply_block_jacobi(tP, torch.from_numpy(v))
    assert got.dtype == torch.float64 and got.shape == v.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("s", [0.0, 0.1])
@pytest.mark.parametrize("block_size", [0, 20])
def test_dense_diag_blocks_match(s, block_size):
    rng = np.random.default_rng(5)
    mats = rng.normal(size=(2, 60, 60))
    want = np.asarray(JDenseLD(mats=jnp.asarray(mats), s=s).diag_blocks(block_size))
    got = TDenseLD(mats=torch.from_numpy(mats), s=s).diag_blocks(block_size)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="multiple"):
        TDenseLD(mats=torch.from_numpy(mats)).diag_blocks(7)


@pytest.mark.parametrize("P", [8, 16])
def test_preconditioned_cg_iteration_counts_match(P):
    """Banded SPD systems with condition number <= 81, block-Jacobi with
    P x P blocks: the port's CG takes exactly the JAX CG's iterations, fewer
    than without the preconditioner."""
    K, M, B = 2, 96, 16
    rng = np.random.default_rng(6)
    D = _spd_blocks(K, M // B, B, seed=7, cond=40.0)
    A = np.zeros((K, M, M))
    for i in range(M // B):
        A[:, i * B:(i + 1) * B, i * B:(i + 1) * B] = D[:, i]
    off = rng.normal(size=(K, M, M)) * (np.abs(np.subtract.outer(np.arange(M), np.arange(M))) < 20)
    A = A + 0.02 * (off + off.transpose(0, 2, 1))
    ev = np.linalg.eigvalsh(A)
    assert ev.min() > 0 and (ev.max(axis=1) / ev.min(axis=1)).max() <= 81
    b = rng.normal(size=(K, M))
    one = np.ones(K)
    jop, top = _ops(D)
    jP = jpre.block_jacobi_inverse(jop, jnp.asarray(one), jnp.asarray(0 * one), P,
                                   dtype=jnp.float64)
    tP = tpre.block_jacobi_inverse(top, torch.from_numpy(one), torch.from_numpy(0 * one), P,
                                   dtype=torch.float64)
    jA, tA = jnp.asarray(A), torch.from_numpy(A)
    jres = jcg(lambda x: jnp.einsum("kij,kj->ki", jA, x), jnp.asarray(b),
               jnp.zeros((K, M)), 200, 1e-8,
               precond=lambda v: jpre.apply_block_jacobi(jP, v))
    tres = tcg(lambda x: torch.einsum("kij,kj->ki", tA, x), torch.from_numpy(b),
               torch.zeros((K, M), dtype=torch.float64), 200, 1e-8,
               precond=lambda v: tpre.apply_block_jacobi(tP, v))
    plain = tcg(lambda x: torch.einsum("kij,kj->ki", tA, x), torch.from_numpy(b),
                torch.zeros((K, M), dtype=torch.float64), 200, 1e-8)
    np.testing.assert_array_equal(tres.iters.numpy(), np.asarray(jres.iters))
    assert bool(tres.converged.all()) and bool(np.asarray(jres.converged).all())
    assert int(tres.iters.max()) < int(plain.iters.max())
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tres.x.numpy(), np.linalg.solve(A, b[..., None])[..., 0],
                               rtol=1e-5, atol=1e-7)


N, LAM, H2 = 20000, 0.05, 0.7


def _dense_engines(K, cfg_extra, seed=0):
    M = 160
    band, r, x0 = simulate_ld_band(N, M, 24, h2=H2, lam=LAM, n_r=K,
                                   rng=np.random.default_rng(seed), dtype=np.float64)
    r = np.atleast_2d(r)
    R = np.repeat(band_to_dense(band)[None], K, axis=0)
    cfg = dict(prior_update="em", dtype="float64", cg_maxit=200, cg_rtol=1e-7,
               em_prior_maxit=20, rho=0.5)
    cfg.update(cfg_extra)
    a, Nk = np.full(K, 1.0 / K), np.full(K, float(N))
    prior = (LAM, [1.0], [H2 / max(int(M * LAM), 1) * N])
    jeng = jvamp.VampEngine(
        jvamp.VampInputs(op=JDenseLD(mats=jnp.asarray(R), s=0.05), r=jnp.asarray(r),
                         a=jnp.asarray(a), N=jnp.asarray(Nk)),
        JConfig(**cfg), JPrior.create(*prior))
    teng = tvamp.VampEngine(
        tvamp.VampInputs(op=TDenseLD(mats=torch.from_numpy(R), s=0.05),
                         r=torch.from_numpy(r), a=torch.from_numpy(a),
                         N=torch.from_numpy(Nk)),
        TConfig(**cfg), TPrior.create(*prior, device="cpu"))
    return jeng, teng, x0, M


@pytest.mark.parametrize("K", [1, 2])
def test_preconditioned_f64_dense_trajectory_matches(K):
    """Direct block inversion in f64 every step: the same arithmetic in both
    engines, so rtol 1e-8 over 5 iterations and equal CG counts."""
    jeng, teng, x0, M = _dense_engines(
        K, dict(cg_precond_block=16, cg_precond_dtype="float64", cg_precond_eig=False))
    assert teng.inputs.precond_q is None
    u = np.random.default_rng(K).choice([-1.0, 1.0], size=(5, K, M))
    hj = jeng.run(5, fixed_u=u, x0=x0)
    ht = teng.run(5, fixed_u=u, x0=x0)
    assert len(ht["xhat1"]) == len(hj["xhat1"]) == 5
    for it in range(5):
        np.testing.assert_allclose(ht["xhat1"][it], hj["xhat1"][it], rtol=1e-8,
                                   atol=1e-8 * np.abs(hj["xhat1"][it]).max())
        np.testing.assert_array_equal(ht["cg1_iters"][it], hj["cg1_iters"][it])
        np.testing.assert_array_equal(ht["cg2_iters"][it], hj["cg2_iters"][it])
    np.testing.assert_allclose(ht["alignment"], hj["alignment"], rtol=1e-8)
    assert hj["alignment"][-1] > 0.9


def test_cached_eig_trajectory_matches_and_saves_iterations():
    """The engine's cached eigendecomposition (f32 blocks, as diag_blocks
    gives them): the two preconditioners differ by f32 rounding, so the CG
    runs to a tight tolerance where its solution does not depend on the
    preconditioner."""
    extra = dict(cg_precond_block=16, cg_precond_dtype="float32")
    jeng, teng, x0, M = _dense_engines(1, dict(extra, cg_rtol=1e-12), seed=3)
    assert teng.inputs.precond_q is not None
    assert tuple(teng.inputs.precond_q.shape) == (1, M // 16, 16, 16)
    assert tuple(teng.inputs.precond_lam.shape) == (1, M // 16, 16)
    np.testing.assert_allclose(teng.inputs.precond_lam.numpy(),
                               np.asarray(jeng.inputs.precond_lam), rtol=1e-4)
    u = np.random.default_rng(8).choice([-1.0, 1.0], size=(4, 1, M))
    hj = jeng.run(4, fixed_u=u, x0=x0)
    ht = teng.run(4, fixed_u=u, x0=x0)
    for it in range(4):
        np.testing.assert_allclose(ht["xhat1"][it], hj["xhat1"][it], rtol=1e-8,
                                   atol=1e-8 * np.abs(hj["xhat1"][it]).max())
    _, plain, _, _ = _dense_engines(1, dict(cg_rtol=1e-12), seed=3)
    hp = plain.run(4, fixed_u=u, x0=x0)
    assert sum(int(c.max()) for c in ht["cg1_iters"]) < sum(int(c.max()) for c in hp["cg1_iters"])
    np.testing.assert_allclose(ht["xhat1"][-1], hp["xhat1"][-1], rtol=1e-6,
                               atol=1e-8 * np.abs(hp["xhat1"][-1]).max())


def test_sym_operator_preconditioner_blocks():
    """The engine factorizes the sym operator's own diagonal blocks, in
    P x P sub-blocks of the storage block."""
    band = simulate_ld_band(10000, 300, 96, rng=np.random.default_rng(2))[0]
    jop = JSym.from_band(band, block_size=64, K=1, dtype="hybrid", s=0.02)
    op = SymBandedLD.from_band(band, block_size=64, K=1, dtype="hybrid", s=0.02, device="cpu")
    tQ, tlam = tpre.block_jacobi_eig(op, 32, 2048, torch.float32)
    jQ, jlam = jpre.block_jacobi_eig(jop, 32, 2048, jnp.float32)
    assert tuple(tlam.shape) == (1, op.M // 32, 32)
    np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam), rtol=1e-4, atol=1e-5)
    one = np.ones(1, np.float32)
    got = tpre.block_jacobi_from_eig(tQ, tlam, torch.from_numpy(one), torch.from_numpy(one))
    want = np.asarray(jpre.block_jacobi_from_eig(jQ, jlam, jnp.asarray(one), jnp.asarray(one)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
