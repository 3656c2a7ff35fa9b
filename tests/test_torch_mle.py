"""The port's MLE prior update (sgvamp_torch.core.prior.mle_update and its
pieces) against the JAX package's, on the CPU.

The same numpy inputs go to both on every scenario of tests/test_prior.py's
MLE tests. Tolerances: float64, 1e-9 relative in lam, omegas and mle_gam
and the same accepted flag (the two solve the same (L+1) Newton systems
with two LU solves that round differently); float32 at M=65536, the JAX
test's own 2e-2 against EM's sparsity, and the same accepted flag.

The L=3 scenario ("l3-guarded", ill-posed by design) takes a chaotic Newton
path: the two packages' iterates differ by 4e-14 after the first iteration
and by O(1) after about 30 (measured), before both reach the same root. Its
agreement holds for these inputs and this arithmetic (the elimination of
_solve_small divides by the pivot; scaling by the pivot's reciprocal, as
LAPACK's getf2 does, ends it rejected after 200 iterations), not for any
perturbation of them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgvamp_torch.core import prior as tprior
from sgvamp_tpu.core import prior as jprior
from test_prior import _vamp_like_state

F64_TOL = 1e-9


def _near_degenerate(gap):
    rng = np.random.default_rng(8)
    K, M = 2, 300
    sigmas = np.asarray([2.0, 2.0 * (1.0 + gap)])
    x = np.where(rng.random(M) < 0.2, rng.normal(0, 1.2, M), 0.0)
    gam1s = rng.uniform(0.5, 2.0, K)
    r1s = x[None, :] + rng.normal(size=(K, M)) / np.sqrt(gam1s)[:, None]
    return r1s, gam1s, np.full(K, 0.5), 0.25, np.asarray([0.5, 0.5]), sigmas


def _extreme_spread():
    rng = np.random.default_rng(21)
    K, M = 2, 300
    x = np.where(rng.random(M) < 0.2, rng.normal(0, 1.0, M), 0.0)
    gam1s = np.asarray([1e-6, 1e2])
    r1s = x[None, :] + rng.normal(size=(K, M)) / np.sqrt(gam1s)[:, None]
    return r1s, gam1s, np.asarray([0.5, 0.5]), 0.25, np.asarray([1.0]), np.asarray([1.5])


def _singular():
    """Exactly duplicated components: J is singular by construction."""
    rng = np.random.default_rng(3)
    return (rng.normal(size=(1, 200)) * 2.0, np.asarray([1.0]), np.asarray([1.0]), 0.3,
            np.asarray([0.5, 0.5]), np.asarray([1.0, 1.0]))


def _padded(seed=2, pad=40):
    """A VAMP-like state whose last `pad` markers are padding (r1 = 0, mask 0)."""
    r1s, gam1s, a, lam, omegas, sigmas = _vamp_like_state(seed, L=2)
    r1s = np.concatenate([r1s, np.zeros((r1s.shape[0], pad))], axis=1)
    mask = (np.arange(r1s.shape[1]) < r1s.shape[1] - pad).astype(np.float64)
    return r1s, gam1s, a, lam, omegas, sigmas, mask


SCENARIOS = {
    "fixed-point-1": lambda: _vamp_like_state(1, L=2),
    "fixed-point-2": lambda: _vamp_like_state(2, L=2),
    "fixed-point-4": lambda: _vamp_like_state(4, L=2),
    "l3-guarded": lambda: _vamp_like_state(0, L=3),
    "failure-skips": lambda: (np.zeros((1, 20)), np.asarray([1e18]), np.asarray([1.0]), 0.25,
                              np.asarray([1.0]), np.asarray([1e-30])),
    "near-degenerate-1e-6": lambda: _near_degenerate(1e-6),
    "near-degenerate-1e-9": lambda: _near_degenerate(1e-9),
    "extreme-gam1-spread": _extreme_spread,
    "singular-jacobian": _singular,
}
KWARGS = {"failure-skips": dict(maxit=5, tol=1e-30)}


def _both(r1s, gam1s, a, lam, omegas, sigmas, mask=None, dtype=np.float64, **kw):
    """(JAX's, the port's) updated prior as dicts of numpy values."""
    td = torch.float64 if dtype == np.float64 else torch.float32
    jmask = None if mask is None else jnp.asarray(mask, dtype)
    j = jprior.mle_update(jnp.asarray(r1s, dtype), jnp.asarray(gam1s, dtype),
                          jnp.asarray(a, dtype),
                          jprior.PriorState.create(lam, omegas, sigmas, dtype=dtype),
                          mask=jmask, **kw)
    t = tprior.mle_update(*(torch.as_tensor(np.asarray(v, dtype)) for v in (r1s, gam1s, a)),
                          tprior.PriorState.create(lam, omegas, sigmas, dtype=td, device="cpu"),
                          mask=None if mask is None else torch.as_tensor(mask, dtype=td), **kw)
    fields = ("lam", "omegas", "sigmas", "mle_gam", "mle_gam_valid", "mle_last_ok")
    return ({f: np.asarray(getattr(j, f)) for f in fields},
            {f: getattr(t, f).numpy() for f in fields})


def _assert_f64_match(j, t):
    assert bool(t["mle_last_ok"]) == bool(j["mle_last_ok"])
    assert bool(t["mle_gam_valid"]) == bool(j["mle_gam_valid"])
    for f in ("lam", "omegas", "mle_gam"):
        assert t[f].dtype == np.float64, f
        np.testing.assert_allclose(t[f], j[f], rtol=F64_TOL, atol=0, err_msg=f)
    np.testing.assert_array_equal(t["sigmas"], j["sigmas"])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_mle_update_matches_jax_f64(name):
    j, t = _both(*SCENARIOS[name](), **KWARGS.get(name, {}))
    _assert_f64_match(j, t)
    # the outcomes tests/test_prior.py asserts of the JAX package hold here
    accepted = {"failure-skips": False, "singular-jacobian": False}.get(name, True)
    assert bool(t["mle_last_ok"]) == accepted
    assert np.all(np.isfinite(t["omegas"])) and np.all(t["omegas"] >= 0)


def test_mle_update_with_mask_matches_jax():
    r1s, gam1s, a, lam, omegas, sigmas, mask = _padded()
    j, t = _both(r1s, gam1s, a, lam, omegas, sigmas, mask=mask)
    _assert_f64_match(j, t)
    assert bool(t["mle_last_ok"])
    # the padded markers take no part: the unpadded problem's solution
    _, t0 = _both(r1s[:, :-40], gam1s, a, lam, omegas, sigmas)
    np.testing.assert_allclose(t["lam"], t0["lam"], rtol=F64_TOL)


def test_mle_accepts_at_large_M_f32():
    K, M = 1, 65536
    rng = np.random.default_rng(0)
    beta = np.where(rng.random(M) < 0.01, rng.normal(0, 3.0, M), 0.0)
    r1s = (beta + rng.normal(0, 0.5, M))[None]
    j, t = _both(r1s, [4.0], [1.0], 0.02, [1.0], [9.0], dtype=np.float32)
    assert bool(t["mle_last_ok"]) and bool(j["mle_last_ok"])
    assert t["lam"].dtype == np.float32
    np.testing.assert_allclose(t["lam"], j["lam"], rtol=2e-2)
    f = lambda v: torch.as_tensor(np.asarray(v, np.float32))  # noqa: E731
    lam_em = tprior.em_loop(f(r1s), f([4.0]), f([1.0]), f(0.02), f([1.0]), f([9.0]), 100)[0]
    np.testing.assert_allclose(t["lam"], lam_em.numpy(), rtol=2e-2)


def _kkt_inputs(rng, K=3, M=64, L=4):
    log_probs = rng.normal(size=(K, M, L)) - 1.0
    a = rng.dirichlet(np.ones(K))
    omega0 = rng.dirichlet(np.ones(L))
    x = np.concatenate([omega0 * 0.9 + 0.02, [0.7]])
    return log_probs, a, omega0, x


@pytest.mark.parametrize("use_mask", [False, True], ids=["no-mask", "mask"])
def test_kkt_jacobian_matches_autodiff_and_jax(use_mask):
    rng = np.random.default_rng(0)
    log_probs, a, omega0, x = _kkt_inputs(rng)
    mask = (rng.random(64) < 0.8).astype(np.float64) if use_mask else None
    tm = None if mask is None else torch.from_numpy(mask)
    probs, ta, to, tx = (torch.from_numpy(v) for v in (np.exp(log_probs), a, omega0, x))
    y, J = tprior._kkt_residual_and_jac(tx, probs, ta, to, tm)
    y_ref = tprior._kkt_residual(tx, probs, ta, to, tm)
    J_ref = torch.func.jacrev(lambda z: tprior._kkt_residual(z, probs, ta, to, tm))(tx)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(J.numpy(), J_ref.numpy(), rtol=1e-9, atol=1e-12)
    jm = None if mask is None else jnp.asarray(mask)
    jy, jJ = jprior._kkt_residual_and_jac(jnp.asarray(x), jnp.asarray(log_probs), jnp.asarray(a),
                                          jnp.asarray(omega0), jm)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [2, 3, 5])
def test_small_solve_matches_lapack_and_flags_a_zero_pivot(n):
    """_solve_small against LAPACK (torch.linalg.solve_ex, numpy) and JAX's
    LU solve; a system with an exactly zero pivot (info != 0) gives a
    non-finite x, as JAX's does, so the Newton step is not taken."""
    rng = np.random.default_rng(n)
    A = rng.normal(size=(2, n, n))
    A[1, 0, 0] = 0.0    # a first pivot that must be swapped in
    b = rng.normal(size=(2, n))
    x = tprior._solve_small(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(A, b[..., None])[..., 0], rtol=1e-10)
    S = A.copy()
    S[:, :, n // 2] = 0.0   # a zero column
    xs = tprior._solve_small(torch.from_numpy(S), torch.from_numpy(b)).numpy()
    _, info = torch.linalg.solve_ex(torch.from_numpy(S), torch.from_numpy(b))
    assert np.all(info.numpy() != 0)
    for k in range(2):
        assert not np.all(np.isfinite(xs[k]))
        assert not np.all(np.isfinite(np.asarray(
            jnp.linalg.solve(jnp.asarray(S[k]), jnp.asarray(b[k])))))


@pytest.mark.parametrize("name", ["fixed-point-1", "l3-guarded", "singular-jacobian", "mask"])
@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_mle_chunks_give_the_bits_of_one_chunk(monkeypatch, name, chunk):
    """However the iterations are cut into chunks (the host reads between
    them), the solve gives the bits of one chunk of maxit iterations."""
    if name == "mask":
        *args, mask = _padded()
        mask = torch.from_numpy(mask)
    else:
        args, mask = SCENARIOS[name](), None
    r1s, gam1s, a, lam, omegas, sigmas = args
    t = [torch.as_tensor(np.asarray(v, np.float64)) for v in (r1s, gam1s, a)]
    prior = tprior.PriorState.create(lam, omegas, sigmas, device="cpu")
    maxit = 40
    monkeypatch.setattr(tprior, "MLE_CHUNK", maxit)
    want = tprior.mle_update(*t, prior, maxit=maxit, mask=mask)
    monkeypatch.setattr(tprior, "MLE_CHUNK", chunk)
    got = tprior.mle_update(*t, prior, maxit=maxit, mask=mask)
    for f in ("lam", "omegas", "mle_gam", "mle_gam_valid", "mle_last_ok"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    # the pieces as a graph replays them
    pb, c = tprior.mle_init(*t, prior, mask)
    chunks = 0
    while not bool(tprior.mle_finished(c, maxit)):
        c = tprior.mle_chunk(c, pb, maxit, 1e-10, chunk)
        chunks += 1
    assert chunks == -(-max(int(c.it), 1) // chunk)
    res = tprior.mle_result(pb, c, prior)
    for f in ("lam", "omegas", "mle_gam", "mle_last_ok"):
        assert torch.equal(getattr(res, f), getattr(want, f)), f
    if name == "singular-jacobian":
        assert int(c.it) == maxit or bool(c.failed)   # never converges, never NaN
        assert bool(torch.isfinite(c.x).all())


def test_mle_warm_start_uses_the_cached_multiplier():
    """A second update starts from the first one's multiplier, as in the
    JAX package: the same lam, omegas and mle_gam after two updates."""
    r1s, gam1s, a, lam, omegas, sigmas = _vamp_like_state(1, L=2)
    jp = jprior.PriorState.create(lam, omegas, sigmas)
    tp = tprior.PriorState.create(lam, omegas, sigmas, device="cpu")
    t = [torch.from_numpy(np.asarray(v, np.float64)) for v in (r1s, gam1s, a)]
    for scale in (1.0, 1.1):
        jp = jprior.mle_update(jnp.asarray(r1s * scale), jnp.asarray(gam1s), jnp.asarray(a), jp)
        tp = tprior.mle_update(t[0] * scale, t[1], t[2], tp)
        assert bool(tp.mle_gam_valid)
    for f in ("lam", "omegas", "mle_gam"):
        np.testing.assert_allclose(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                   rtol=F64_TOL, err_msg=f)
