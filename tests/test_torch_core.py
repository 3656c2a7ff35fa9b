"""The port's denoiser, EM prior and batched CG against the JAX package's.

Same numpy inputs, float64 on both sides: values agree to rtol 1e-10 (only
the order of reductions differs), and CG iteration counts and converged
flags are equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sgvamp_torch.core import cg as tcg
from sgvamp_torch.core import denoiser as tden
from sgvamp_torch.core import prior as tprior
from sgvamp_torch.config import VampConfig
from sgvamp_tpu.core import cg as jcg
from sgvamp_tpu.core import denoiser as jden
from sgvamp_tpu.core import prior as jprior

RTOL = 1e-10


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("K,L1", [(1, 1), (3, 2), (2, 4)])
def test_denoiser_matches(K, L1):
    rng = np.random.default_rng(K * 10 + L1)
    M = 500
    r1s = rng.normal(size=(K, M)) * 3
    gam1s = rng.uniform(0.5, 5, size=K)
    a = rng.dirichlet(np.ones(K))
    lam = 0.07
    omegas = rng.dirichlet(np.ones(L1))
    sigmas = rng.uniform(0.5, 20, size=L1)
    want = jden.combine_cohorts(jnp.asarray(r1s), jnp.asarray(gam1s), jnp.asarray(a))
    got = tden.combine_cohorts(_t(r1s), _t(gam1s), _t(a))
    for g, w in zip(got, want):
        _close(g, w)
    want = jden.posterior_mean_and_slope(want[0], want[1], jnp.asarray(lam),
                                         jnp.asarray(omegas), jnp.asarray(sigmas))
    got = tden.posterior_mean_and_slope(got[0], got[1], torch.tensor(lam, dtype=torch.float64),
                                        _t(omegas), _t(sigmas))
    for g, w in zip(got, want):
        _close(g, w, atol=1e-300)


def _em_inputs(K, L1, masked, seed):
    rng = np.random.default_rng(seed)
    M = 400
    beta = np.where(rng.uniform(size=M) < 0.1, rng.normal(size=M) * 2, 0.0)
    r1s = beta[None] + rng.normal(size=(K, M)) * 0.5
    gam1s = rng.uniform(2, 6, size=K)
    a = rng.dirichlet(np.ones(K))
    omegas = rng.dirichlet(np.ones(L1))
    sigmas = rng.uniform(1, 8, size=L1)
    mask = (np.arange(M) < M - 37).astype(np.float64) if masked else None
    return r1s, gam1s, a, 0.3, omegas, sigmas, mask


@pytest.mark.parametrize("K,L1,masked", [(1, 1, False), (2, 3, True), (3, 2, False)])
def test_em_update_and_loop_match(K, L1, masked):
    r1s, gam1s, a, lam, om, sig, mask = _em_inputs(K, L1, masked, seed=K + L1)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    want = jprior.em_update(jnp.asarray(r1s), jnp.asarray(gam1s), jnp.asarray(a),
                            jnp.asarray(lam), jnp.asarray(om), jnp.asarray(sig), mask=jm)
    got = tprior.em_update(_t(r1s), _t(gam1s), _t(a), torch.tensor(lam, dtype=torch.float64),
                           _t(om), _t(sig), mask=tm)
    for g, w in zip(got, want):
        _close(g, w)
    for maxit, tol in ((5, 1e-6), (100, 1e-6), (100, 1e-3)):
        want = jprior.em_loop(jnp.asarray(r1s), jnp.asarray(gam1s), jnp.asarray(a),
                              jnp.asarray(lam), jnp.asarray(om), jnp.asarray(sig),
                              maxit, tol, mask=jm)
        got = tprior.em_loop(_t(r1s), _t(gam1s), _t(a),
                             torch.tensor(lam, dtype=torch.float64), _t(om), _t(sig),
                             maxit, tol, mask=tm)
        assert got[2] == int(want[2])  # same number of sweeps
        _close(got[0], want[0])
        _close(got[1], want[1])
        _close(got[3], want[3], rtol=1e-6)  # a relative change: cancels digits


def _spd_batch(K, M, seed):
    """K SPD systems of increasing condition number, so lanes converge at
    different iterations."""
    rng = np.random.default_rng(seed)
    mats = []
    for k in range(K):
        Q, _ = np.linalg.qr(rng.normal(size=(M, M)))
        eig = np.geomspace(1.0, 3.0 ** (1 + k), M)
        mats.append((Q * eig) @ Q.T)
    A = np.stack(mats)
    return A, rng.normal(size=(K, M)), rng.normal(size=(K, M)) * 0.1


@pytest.mark.parametrize("maxiter,rtol,atol,force", [
    (200, 1e-5, 0.0, False),    # lanes converge at different iterations (masked)
    (12, 1e-5, 0.0, False),     # maxiter cuts the slow lanes: unconverged
    (30, 1e-8, 1e-3, False),    # atol decides for some lanes
    (25, 1e-5, 0.0, True),      # fixed budget, no lane ever freezes
])
def test_cg_matches(maxiter, rtol, atol, force):
    K, M = 4, 300
    A, b, x0 = _spd_batch(K, M, seed=maxiter)
    want = jcg.cg_batched(lambda x: jnp.einsum("kij,kj->ki", jnp.asarray(A), x),
                          jnp.asarray(b), jnp.asarray(x0), maxiter, rtol, atol, force)
    At = _t(A)
    got = tcg.cg_batched(lambda x: torch.einsum("kij,kj->ki", At, x),
                         _t(b), _t(x0), maxiter, rtol, atol, force)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    _close(got.x, want.x, rtol=1e-8, atol=1e-12)
    _close(got.rnorm2, want.rnorm2, rtol=1e-6, atol=1e-20)
    if not force and maxiter == 200:
        assert len(set(got.iters.tolist())) > 1 and got.converged.all()
    if maxiter == 12:
        assert not got.converged.all()
    if force:
        assert (got.iters == maxiter).all() and not got.converged.any()


def test_cg_already_converged_lane():
    """A lane whose warm start already meets the tolerance does no
    iterations and reports converged, as in the JAX solver."""
    K, M = 3, 200
    A, b, x0 = _spd_batch(K, M, seed=5)
    x0[1] = np.linalg.solve(A[1], b[1])
    want = jcg.cg_batched(lambda x: jnp.einsum("kij,kj->ki", jnp.asarray(A), x),
                          jnp.asarray(b), jnp.asarray(x0), 100, 1e-6)
    At = _t(A)
    got = tcg.cg_batched(lambda x: torch.einsum("kij,kj->ki", At, x),
                         _t(b), _t(x0), 100, 1e-6)
    assert int(got.iters[1]) == 0 and bool(got.converged[1])
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    _close(got.x, want.x, rtol=1e-8, atol=1e-12)


def test_config_matches_jax():
    """Same fields and defaults as the JAX package's configs, so that one
    configuration means the same run in both engines."""
    import dataclasses

    from sgvamp_torch.config import PriorConfig
    from sgvamp_tpu.config import PriorConfig as JPriorConfig
    from sgvamp_tpu.config import VampConfig as JVampConfig

    for port, ref in ((VampConfig, JVampConfig), (PriorConfig, JPriorConfig)):
        assert ([(f.name, f.default) for f in dataclasses.fields(port)]
                == [(f.name, f.default) for f in dataclasses.fields(ref)])
    pc, jc = PriorConfig((0.0, 1.0, 4.0), (0.9, 0.06, 0.04)), \
        JPriorConfig((0.0, 1.0, 4.0), (0.9, 0.06, 0.04))
    assert (pc.L, pc.init_lam(), pc.init_omegas(), pc.scaled_sigmas(1e4)) == \
        (jc.L, jc.init_lam(), jc.init_omegas(), jc.scaled_sigmas(1e4))
    with pytest.raises(ValueError):
        PriorConfig((0.0,), (1.0,))


def test_unported_options_raise():
    # MLE prior learning is ported: the option constructs
    assert VampConfig(prior_update="mle").prior_update == "mle"
    # the block-Jacobi preconditioner is ported: its options construct
    cfg = VampConfig(cg_precond_block=32, cg_precond_dtype="bfloat16")
    assert cfg.precond_torch_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="cg_precond_dtype"):
        VampConfig(cg_precond_dtype="int8")
    assert VampConfig(dtype="float32").torch_dtype == torch.float32
