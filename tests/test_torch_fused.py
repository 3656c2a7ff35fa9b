"""The port's fused runs (run_scan, run_scan_stoppable, StopState,
write_scan_outputs, --fused 1) and the chunked EM and CG loops they rest
on, on the CPU.

On the CPU the fused run calls the same pieces over the same static buffers
that a CUDA device captures into graphs, so it must equal the host loop bit
for bit. Against the JAX package: the same numpy inputs and injected probes;
f64 trajectories to 1e-8 (tests/test_torch_vamp.py), CG to its parity
tolerance at condition numbers <= 81 (tests/test_torch_core.py), the
degenerate f32 panel of tests/test_stopping.py to 1e-6 relative, files to
the byte.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgvamp_torch.cli import main as tcli
from sgvamp_torch.cli import simulate as tsim
from sgvamp_torch.config import VampConfig as TConfig
from sgvamp_torch.core import cg as tcg
from sgvamp_torch.core import prior as tprior
from sgvamp_torch.core import vamp as tvamp
from sgvamp_torch.core.operators import BandedLD as TBanded
from sgvamp_torch.core.operators import DenseLD as TDenseLD
from sgvamp_torch.io.writers import OutputWriter as TWriter
from sgvamp_torch.ops.band_kernel import SymBandedLD as TSym
from sgvamp_torch.parallel.sharding import make_mesh
from sgvamp_tpu.cli import main as jcli
from sgvamp_tpu.config import VampConfig as JConfig
from sgvamp_tpu.core import cg as jcg
from sgvamp_tpu.core import prior as jprior
from sgvamp_tpu.core import vamp as jvamp
from sgvamp_tpu.core.operators import BandedLD as JBanded
from sgvamp_tpu.core.operators import DenseLD as JDenseLD
from sgvamp_tpu.data.simulate import band_to_dense, simulate_ld_band
from sgvamp_tpu.io.writers import OutputWriter as JWriter

N, LAM, H2 = 20000, 0.05, 0.7


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# stop_state_update against the JAX package's
# ---------------------------------------------------------------------------

M_STOP = 16


def _monitor_case(case):
    """(monitor fields, it, xhat1, gam1) in numpy f64."""
    rng = np.random.default_rng(len(case))
    x = rng.normal(size=M_STOP)
    mon = dict(done=False, reason=0, stopped_at=-1, prev_xhat1=np.zeros(M_STOP),
               has_prev=False, gam1_peak=-np.inf, best_it=-1, best_xhat1=np.zeros(M_STOP),
               n_ran=0)
    if case == "first":
        return mon, 0, x, np.array([3.0, 5.0])
    mon.update(prev_xhat1=x * (1 + 1e-5), has_prev=True, gam1_peak=4.0, best_it=1,
               best_xhat1=x * 2, n_ran=2)
    if case == "has_prev":
        return mon, 2, x, np.array([6.0, 9.0])
    if case == "tie":
        return mon, 2, x, np.array([4.0, 7.0])
    if case == "nonfinite_x":
        x[3] = np.nan
        return mon, 2, x, np.array([6.0, 9.0])
    if case == "nonfinite_g":
        return mon, 2, x, np.array([np.inf, 9.0])
    # "both": the gam1 collapse and a settled xhat1 in the same step
    return mon, 2, x, np.array([0.1, 9.0])


@pytest.mark.parametrize("tol,drop", [(0.0, 0.0), (1e-3, 0.0), (0.0, 10.0), (1e-3, 10.0)])
@pytest.mark.parametrize("case", ["first", "has_prev", "tie", "nonfinite_x", "nonfinite_g",
                                  "both"])
def test_stop_state_update_matches_jax(case, tol, drop):
    mon, it, x, g = _monitor_case(case)
    jmon = jvamp.StopState(**{k: jnp.asarray(v, dtype=jnp.int32 if k in (
        "reason", "stopped_at", "best_it", "n_ran") else None) for k, v in mon.items()})
    tmon = tvamp.StopState(**{k: torch.as_tensor(v, dtype=torch.int32 if k in (
        "reason", "stopped_at", "best_it", "n_ran") else None) for k, v in mon.items()})
    want = jvamp.stop_state_update(jmon, jnp.asarray(it, jnp.int32), jnp.asarray(x),
                                   jnp.asarray(g), tol, drop)
    got = tvamp.stop_state_update(tmon, it, _t(x), _t(g), tol, drop)
    for name, w, v in zip(tvamp.StopState._fields, want, got):
        w = np.asarray(w)
        assert v.shape == w.shape and v.dtype == _t(w).dtype, name
        assert np.array_equal(v.numpy(), w, equal_nan=True), name
    if case == "both" and drop > 0:
        assert int(got.reason) == 1   # divergence is checked first
    if case == "tie":
        assert int(got.best_it) == it


def test_stop_state_create_matches_jax():
    want = jvamp.StopState.create(5, jnp.float32)
    got = tvamp.StopState.create(5, torch.float32, device="cpu")
    for name, w, v in zip(tvamp.StopState._fields, want, got):
        assert np.array_equal(v.numpy(), np.asarray(w)) and v.dtype == _t(np.asarray(w)).dtype
    assert tvamp.StopState.REASONS == jvamp.StopState.REASONS


# ---------------------------------------------------------------------------
# the chunked CG and EM loops
# ---------------------------------------------------------------------------

def _cg_per_iteration(matvec, b, x0, maxiter, rtol=1e-5, atol=0.0, force_maxiter=False,
                      precond=None):
    """cg_batched as it read the device once per iteration, before the
    chunks: the yardstick of the chunked loop's bits."""
    K = b.shape[0]
    tol2 = torch.clamp(rtol * rtol * tcg.rowdot(b, b), min=atol * atol)
    psolve = (lambda v: v) if precond is None else precond
    x = x0
    r = b - matvec(x0)
    p = psolve(r)
    rz = tcg.rowdot(r, p)
    rn2 = rz if precond is None else tcg.rowdot(r, r)
    active = (torch.ones(K, dtype=torch.bool) if force_maxiter else rn2 > tol2)
    iters = torch.zeros(K, dtype=torch.int32)
    for _ in range(maxiter):
        if force_maxiter:
            all_active = True
        else:
            n_active = int(active.sum())
            if n_active == 0:
                break
            all_active = n_active == K
        ap = matvec(p)
        alpha = rz / tcg._nonzero(tcg.rowdot(p, ap))
        x_new = x + alpha[:, None] * p
        r_new = r - alpha[:, None] * ap
        z = psolve(r_new)
        rz_new = tcg.rowdot(r_new, z)
        rn_new = rz_new if precond is None else tcg.rowdot(r_new, r_new)
        p_new = z + (rz_new / tcg._nonzero(rz))[:, None] * p
        if all_active:
            x, r, p, rz, rn2 = x_new, r_new, p_new, rz_new, rn_new
            iters = iters + 1
        else:
            act = active[:, None]
            x = torch.where(act, x_new, x)
            r = torch.where(act, r_new, r)
            p = torch.where(act, p_new, p)
            rz = torch.where(active, rz_new, rz)
            rn2 = torch.where(active, rn_new, rn2)
            iters = iters + active.to(torch.int32)
        if not force_maxiter:
            active = active & (rn2 > tol2)
    converged = torch.where(iters < maxiter, ~active, torch.zeros_like(active))
    return x, iters, converged, rn2


def _spd_batch(K, M, seed):
    """K SPD systems of condition numbers 3 .. 3^K (<= 81 for K = 4), so
    lanes converge at different iterations."""
    rng = np.random.default_rng(seed)
    mats = []
    for k in range(K):
        Q, _ = np.linalg.qr(rng.normal(size=(M, M)))
        mats.append((Q * np.geomspace(1.0, 3.0 ** (1 + k), M)) @ Q.T)
    return np.stack(mats), rng.normal(size=(K, M)), rng.normal(size=(K, M)) * 0.1


@pytest.fixture(scope="module")
def spd():
    A, b, x0 = _spd_batch(4, 300, seed=200)   # tests/test_torch_core.py's systems
    # a block-diagonal inverse of A's 20 x 20 diagonal blocks as preconditioner
    blocks = A.reshape(4, 15, 20, 15, 20)[:, np.arange(15), :, np.arange(15)].transpose(1, 0, 2, 3)
    pinv = np.linalg.inv(blocks)
    return A, b, x0, pinv


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("precond", [False, True], ids=["plain", "block-jacobi"])
@pytest.mark.parametrize("maxiter,force", [(100, False), (13, False), (13, True)],
                         ids=["converge", "cut", "forced"])
def test_cg_chunks_equal_per_iteration_loop_and_match_jax(spd, monkeypatch, chunk, precond,
                                                         maxiter, force):
    monkeypatch.setattr(tcg, "CG_CHUNK", chunk)
    A, b, x0, pinv = spd
    At, Pt = _t(A), _t(pinv)

    def mv(x):
        return torch.einsum("kij,kj->ki", At, x)

    pre = (lambda v: torch.einsum("knpq,knq->knp", Pt, v.reshape(4, 15, 20)).reshape(4, 300)
           ) if precond else None
    want = _cg_per_iteration(mv, _t(b), _t(x0), maxiter, 1e-5, 0.0, force, pre)
    got = tcg.cg_batched(mv, _t(b), _t(x0), maxiter, 1e-5, 0.0, force, pre)
    # the pieces as a graph replays them: whole chunks, masked past maxiter
    c = tcg.cg_init(mv, _t(b), _t(x0), 1e-5, 0.0, force, pre)
    n_chunks = 0
    while bool(tcg.cg_live(c, maxiter)):
        c = tcg.cg_chunk(mv, c, chunk, maxiter, force, pre, masked=True)
        n_chunks += 1
    pieces = tcg.cg_finish(c, maxiter)
    assert int(pieces.passes) == chunk * n_chunks >= int(pieces.iters.max())
    for res in (got, pieces):
        for g, w in zip((res.x, res.iters, res.converged, res.rnorm2), want):
            assert torch.equal(g, w)
    if force:
        assert int(got.passes) == maxiter
    elif chunk == 1:
        assert int(got.passes) == int(got.iters.max())
    if not force:
        assert maxiter % chunk or chunk == 1   # the chunk does not divide maxiter
        if maxiter == 100:
            assert len(set(want[1].tolist())) > 1 and bool(want[2].all())
    jpre = None
    if precond:
        jp = jnp.asarray(pinv)
        jpre = lambda v: jnp.einsum("knpq,knq->knp", jp, v.reshape(4, 15, 20)).reshape(4, 300)  # noqa: E731
    jres = jcg.cg_batched(lambda x: jnp.einsum("kij,kj->ki", jnp.asarray(A), x),
                          jnp.asarray(b), jnp.asarray(x0), maxiter, 1e-5, 0.0, force,
                          precond=jpre)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(jres.iters))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(jres.converged))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(jres.x), rtol=1e-8, atol=1e-12)


def _em_per_sweep(r1s, gam1s, a, lam, omegas, sigmas, maxit, rel_tol, mask=None):
    """em_loop as it read the device once per sweep, before the chunks."""
    lam_err = omega_err = torch.full((), float("inf"), dtype=lam.dtype)
    sweeps = 0
    while sweeps < maxit:
        new_lam, new_omegas = tprior.em_update(r1s, gam1s, a, lam, omegas, sigmas, mask=mask)
        omega_err = torch.linalg.norm(new_omegas - omegas) / torch.linalg.norm(omegas)
        lam_err = torch.abs(new_lam - lam) / new_lam
        lam, omegas = new_lam, new_omegas
        sweeps += 1
        if bool((omega_err < rel_tol) & (lam_err < rel_tol)):
            break
    return lam, omegas, sweeps, torch.maximum(lam_err, omega_err)


@pytest.mark.parametrize("maxit,tol,chunk", [(3, 1e-6, 5), (100, 1e-6, 5), (100, 1e-3, 1),
                                             (100, 1e-6, 7), (0, 1e-6, 5)])
def test_em_chunks_equal_per_sweep_loop_and_match_jax(monkeypatch, maxit, tol, chunk):
    monkeypatch.setattr(tprior, "EM_CHUNK", chunk)
    rng = np.random.default_rng(maxit + chunk)
    K, M, L1 = 2, 300, 3
    r1s = rng.normal(size=(K, M)) * 2.0
    gam1s = rng.uniform(0.5, 2.0, size=K)
    a = rng.dirichlet(np.ones(K))
    om, sig = rng.dirichlet(np.ones(L1)), rng.uniform(1, 8, size=L1)
    mask = (np.arange(M) < M - 21).astype(np.float64)
    args = (_t(r1s), _t(gam1s), _t(a), torch.tensor(0.3, dtype=torch.float64), _t(om), _t(sig))
    want = _em_per_sweep(*args, maxit, tol, mask=_t(mask))
    got = tprior.em_loop(*args, maxit, tol, mask=_t(mask))
    assert got[2].dtype == torch.int32 and int(got[2]) == want[2]
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        assert torch.equal(g, w)
    # the pieces, chunk after chunk as a graph replays them
    c = tprior.em_init(args[3], args[4])
    while not bool(tprior.em_finished(c, maxit)):
        c = tprior.em_chunk(c, args[0], args[1], args[2], args[5], maxit, tol, chunk,
                            mask=_t(mask))
    for g, w in zip(tprior.em_result(c), got):
        assert torch.equal(g, w)
    j = jprior.em_loop(jnp.asarray(r1s), jnp.asarray(gam1s), jnp.asarray(a), jnp.asarray(0.3),
                       jnp.asarray(om), jnp.asarray(sig), maxit, tol, mask=jnp.asarray(mask))
    assert int(got[2]) == int(j[2])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(j[0]), rtol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(j[1]), rtol=1e-12)


# ---------------------------------------------------------------------------
# run_scan and run_scan_stoppable against the host loop and the JAX engine
# ---------------------------------------------------------------------------

def _dense_pair(K=2, seed=0):
    M = 160
    band, r, x0 = simulate_ld_band(N, M, 24, h2=H2, lam=LAM, n_r=K,
                                   rng=np.random.default_rng(seed), dtype=np.float64)
    r = np.atleast_2d(r)
    R = np.repeat(band_to_dense(band)[None], K, axis=0)
    cfg = dict(prior_update="em", dtype="float64", cg_maxit=200, cg_rtol=1e-7,
               em_prior_maxit=20, rho=0.5)
    a, Nk = np.full(K, 1.0 / K), np.full(K, float(N))
    prior = (LAM, [1.0], [H2 / max(int(M * LAM), 1) * N])
    jeng = jvamp.VampEngine(
        jvamp.VampInputs(op=JDenseLD(mats=jnp.asarray(R), s=0.05), r=jnp.asarray(r),
                         a=jnp.asarray(a), N=jnp.asarray(Nk)),
        JConfig(**cfg), jprior.PriorState.create(*prior))
    teng = tvamp.VampEngine(
        tvamp.VampInputs(op=TDenseLD(mats=_t(R), s=0.05), r=_t(r), a=_t(a), N=_t(Nk)),
        TConfig(**cfg), tprior.PriorState.create(*prior, device="cpu"))
    return jeng, teng, x0, M


@pytest.fixture(scope="module")
def dense_pair():
    return _dense_pair()


def _sym_engine(force, mesh=False, anneal=False, upf=1):
    """int8 SymBandedLD over a ragged M (padded, masked), f32."""
    M, n = 250, 200
    band, r, _ = simulate_ld_band(n, M, 100, h2=H2, lam=LAM, rng=np.random.default_rng(4),
                                  dtype=np.float64)
    op = TSym.from_band(band, block_size=64, dtype="int8", s=0.02, device="cpu")
    Mp = op.M
    rp = np.zeros((1, Mp), np.float32)
    rp[0, :M] = r
    cfg = TConfig(prior_update="em", dtype="float32", cg_maxit=20 if force else 300,
                  cg_force_maxiter=force, cg_precond_block=0 if force else 32,
                  em_prior_maxit=5, rho=0.5, update_prior_from=upf,
                  rho_final=0.8 if anneal else None, rho_anneal_iters=3 if anneal else 0)
    inputs = tvamp.VampInputs(op=op, r=_t(rp), a=torch.ones(1), N=torch.full((1,), float(n)),
                              mask=_t((np.arange(Mp) < M).astype(np.float32)))
    prior = tprior.PriorState.create(LAM, [1.0], [H2 / 15 * n], device="cpu")
    return tvamp.VampEngine(inputs, cfg, prior,
                            mesh=make_mesh(1, 2, devices=["cpu"] * 2) if mesh else None)


def _assert_rows_equal_host(aux, hist, n):
    for it in range(n):
        assert torch.equal(aux.xhat1[it], torch.from_numpy(hist["xhat1"][it])), it
        p = np.asarray(hist["params"][it])
        for col, name in ((1, "gamw"), (2, "gam1"), (3, "gam2"), (4, "alpha1"), (5, "alpha2")):
            assert np.array_equal(getattr(aux, name)[it].numpy(),
                                  p[:, col].astype(getattr(aux, name).numpy().dtype)), (it, name)
        assert np.array_equal(aux.cg1_iters[it].numpy(), hist["cg1_iters"][it])


@pytest.mark.parametrize("which", ["dense-f64", "int8-forced-anneal", "int8-precond-em-at-0",
                                   "int8-mesh"])
def test_run_scan_equals_host_loop_bit_for_bit(dense_pair, which):
    if which == "dense-f64":
        engine = dense_pair[1]
    else:
        engine = _sym_engine(force="forced" in which or "mesh" in which,
                             mesh="mesh" in which, anneal="anneal" in which,
                             upf=0 if "at-0" in which else 1)
    hist = engine.run(5, seed=2)
    state, aux = engine.run_scan(5, seed=2)
    _assert_rows_equal_host(aux, hist, 5)
    for f in tvamp._VECTORS:
        assert torch.equal(getattr(state, f), getattr(hist["state"], f)), f
    assert torch.equal(state.prior.lam, hist["state"].prior.lam) and state.it == 5
    # the probes' generator advanced as the host loop's did
    assert torch.equal(state.gen.get_state(), hist["state"].gen.get_state())
    # a second call continues from the returned state
    _, aux2 = engine.run_scan(2, state=state)
    h2 = engine.run(2, state=hist["state"])
    _assert_rows_equal_host(aux2, h2, 2)


def test_run_scan_fixed_u_matches_jax_f64(dense_pair):
    jeng, teng, x0, M = dense_pair
    u = np.random.default_rng(3).choice([-1.0, 1.0], size=(5, 2, M))
    hj = jeng.run(5, fixed_u=u, x0=x0)
    state, aux = teng.run_scan(5, fixed_u=u)
    for it in range(5):
        want = hj["xhat1"][it]
        np.testing.assert_allclose(aux.xhat1[it].numpy(), want, rtol=1e-8,
                                   atol=1e-8 * np.abs(want).max())
        p = np.asarray(hj["params"][it])
        for col, name in ((1, "gamw"), (2, "gam1"), (3, "gam2"), (4, "alpha1"), (5, "alpha2")):
            np.testing.assert_allclose(getattr(aux, name)[it].numpy(), p[:, col], rtol=1e-8,
                                       err_msg=name)
        np.testing.assert_array_equal(aux.cg1_iters[it].numpy(), hj["cg1_iters"][it])
    np.testing.assert_allclose(state.xhat2.numpy(), np.asarray(hj["state"].xhat2), rtol=1e-8,
                               atol=1e-8 * float(np.abs(np.asarray(hj["state"].xhat2)).max()))


def test_run_scan_stoppable_equals_host_loop(dense_pair):
    engine = _sym_engine(force=False)
    hist = engine.run(12, seed=0, stop_tol=1e-3, stop_gam1_drop=10.0)
    state, aux, mon = engine.run_scan_stoppable(12, 1e-3, 10.0, seed=0)
    n = int(mon.n_ran)
    assert n == len(hist["xhat1"]) and int(mon.stopped_at) == hist.get("stopped_at", -1)
    assert int(mon.best_it) == hist["best_it"]
    assert tvamp.StopState.REASONS[int(mon.reason)] == hist.get("stop_reason")
    _assert_rows_equal_host(aux, hist, n)
    assert torch.equal(mon.best_xhat1, torch.from_numpy(hist["best_xhat1"]))
    assert not aux.xhat1[n:].any() and not aux.gam1[n:].any()


def _degenerate_pair(dtype, K=8, M=2048):
    """tests/test_stopping.py::_degenerate_engine in both packages, from
    the same numpy band, in `dtype`."""
    rng = np.random.default_rng(0)
    n, lam, h2 = 300000, 0.01, 0.7
    band, r, _ = simulate_ld_band(n, M, 64, h2=h2, lam=lam, rng=rng, dtype=np.dtype(dtype))
    cm = max(int(M * lam), 1)
    cfg = dict(prior_update="em", dtype=dtype, cg_maxit=50, cg_force_maxiter=True,
               em_prior_maxit=5, rho=0.5, lmmse_damp=True)
    prior = (lam, [1.0], [h2 / cm * n])
    rp = np.tile(r[None], (K, 1))
    a, Nk = np.full(K, 1.0 / K, dtype), np.full(K, float(n), dtype)
    jeng = jvamp.VampEngine(
        jvamp.VampInputs(op=JBanded.from_band(band, block_size=128, dtype=dtype, K=K),
                         r=jnp.asarray(rp), a=jnp.asarray(a), N=jnp.asarray(Nk)),
        JConfig(**cfg), jprior.PriorState.create(*prior), gamw=5.0, gam1=1e-6)
    teng = tvamp.VampEngine(
        tvamp.VampInputs(op=TBanded.from_band(band, block_size=128, dtype=dtype, K=K,
                                              device="cpu"),
                         r=_t(rp), a=_t(a), N=_t(Nk)),
        TConfig(**cfg), tprior.PriorState.create(*prior, device="cpu"), gamw=5.0, gam1=1e-6)
    return jeng, teng, M, K


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_run_scan_stoppable_on_degenerate_panel_matches_jax(dtype):
    """In f32, tests/test_stopping.py's panel (K=8, M=2048) stops diverging
    at iteration 6 with its best iterate at 3 in both packages; the two
    engines' rounding (XLA's einsums and torch's) is amplified by the
    collapse: 9e-8 at iteration 0, 8e-7 at 2, 7e-5 at the best iterate,
    2e-2 at the stop (measured, the same for the port's host loop), so the
    rows up to the best iterate are held to the f32 trajectory tolerance of
    tests/test_torch_vamp.py, 1e-3. In f64 the panel is cut to K=4, M=1024
    for time (it stops at 5, best 2) and every row that ran agrees to 1e-6
    (measured: 3e-12)."""
    jeng, teng, M, K = (_degenerate_pair(dtype) if dtype == "float32"
                        else _degenerate_pair(dtype, K=4, M=1024))
    u = np.random.default_rng(1).choice([-1.0, 1.0], size=(16, K, M)).astype(dtype)
    hj = jeng.run(16, fixed_u=u, stop_gam1_drop=10.0)
    assert hj.get("stop_reason") == "diverging"
    state, aux, mon = teng.run_scan_stoppable(16, stop_gam1_drop=10.0, fixed_u=u)
    n = int(mon.n_ran)
    assert int(mon.stopped_at) == hj["stopped_at"] and n == hj["stopped_at"] + 1
    assert int(mon.best_it) == hj["best_it"]
    assert bool(mon.done) and tvamp.StopState.REASONS[int(mon.reason)] == "diverging"
    tol, rows = (1e-6, n) if dtype == "float64" else (1e-3, hj["best_it"] + 1)
    assert _rel(mon.best_xhat1.numpy(), hj["best_xhat1"]) <= tol
    for it in range(rows):
        assert _rel(aux.xhat1[it].numpy(), hj["xhat1"][it]) <= tol, it
    assert not aux.xhat1[n:].any() and not aux.r1_in[n:].any() and not aux.cg_passes[n:].any()
    if dtype == "float64":
        return
    # two chunks of 8, the monitor threaded through, reproduce one run of 16
    s1, a1, m1 = teng.run_scan_stoppable(8, stop_gam1_drop=10.0, fixed_u=u[:8])
    s2, a2, m2 = teng.run_scan_stoppable(8, stop_gam1_drop=10.0, fixed_u=u[8:], state=s1,
                                         stop_state=m1)
    for f in tvamp.StopState._fields:
        assert torch.equal(getattr(m2, f), getattr(mon, f)), f
    for f in tvamp.StepAux._fields:
        assert torch.equal(torch.cat([getattr(a1, f), getattr(a2, f)]), getattr(aux, f)), f
    assert torch.equal(s2.xhat1, state.xhat1) and s2.it == state.it


def test_write_scan_outputs_byte_equal_to_jax(dense_pair, tmp_path):
    _, teng, x0, M = dense_pair
    _, aux = teng.run_scan(4, seed=5)
    rows = {f: v.numpy() for f, v in aux._asdict().items()}
    jaux = jvamp.StepAux(**{f: rows[f] for f in jvamp.StepAux._fields})
    taux = tvamp.StepAux(**rows)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    kw = dict(Nt=2.0 * N, x0=x0[:M - 7], M_out=M - 7, it0=3)
    hj = jvamp.VampEngine.write_scan_outputs(None, jaux, JWriter(str(jdir), "run", K=2), **kw)
    ht = teng.write_scan_outputs(taux, TWriter(str(tdir), "run", K=2), **kw)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and "run_r1_cohort_2_it_6.bin" in names
    for name in names:
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name
    assert hj["alignment"] == ht["alignment"]


# ---------------------------------------------------------------------------
# --fused 1 on the command line
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    d = tmp_path_factory.mktemp("fused_panel")
    assert tsim.main(["gen-band", "--out", str(d / "p"), "--N", "20000", "--M", "1000",
                      "--h2", "0.7", "--lam", "0.02", "--bandwidth", "64", "--seed", "3",
                      "--uncompressed"]) == 0
    return d


def _cli_args(d, out, armed, extra=()):
    return ["--ld-files", str(d / "p_R.npz"), "--r-files", str(d / "p_r.npy"),
            "--true-signal-file", str(d / "p_bet.npy"), "--out-dir", str(out),
            "--out-name", "run", "--N", "20000", "--M", "1000", "--iterations", "5",
            "--platform", "cpu", "--x64", "0", "--operator", "sym", "--ld-dtype", "int8",
            "--block-size", "128", "--cg-precond-block", "64", "--stop-on-divergence",
            "1" if armed else "0", *extra]


@pytest.mark.parametrize("armed", [False, True], ids=["unarmed", "armed"])
def test_cli_fused_files_equal_host_loop_and_jax_file_set(panel, tmp_path, armed):
    assert jcli.main(_cli_args(panel, tmp_path / "jax", armed) + ["--fused", "1"]) == 0
    jnames = sorted(os.listdir(tmp_path / "jax"))
    assert ("run_xhat_best.bin" in jnames) == armed
    for mesh in ((), ("--mesh-shard", "2")):
        host, fused = tmp_path / f"host{len(mesh)}", tmp_path / f"fused{len(mesh)}"
        assert tcli.main(_cli_args(panel, host, armed, mesh) + ["--fused", "0"]) == 0
        assert tcli.main(_cli_args(panel, fused, armed, mesh) + ["--fused", "1"]) == 0
        names = sorted(os.listdir(fused))
        assert names == jnames == sorted(os.listdir(host)), mesh
        for name in names:
            assert (host / name).read_bytes() == (fused / name).read_bytes(), (mesh, name)
