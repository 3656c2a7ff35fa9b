"""The port's VAMP engine against the JAX engine, on the CPU.

Both engines start from the same numpy problem and get the same Rademacher
probes (fixed_u / u=). Tolerances:
  * float64 with DenseLD: the same arithmetic in another reduction order,
    so rtol 1e-8 over 5 iterations and equal CG iteration counts;
  * float32 with int8 SymBandedLD: the JAX package's own quantized-flavor
    tolerances (__graft_entry__.py): relative L2 <= 1e-3 for xhat1, alpha2
    and gamw, <= 1e-1 for gam1, which amplifies alpha2's rounding by
    about 1/alpha2.
"""

import csv
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sgvamp_torch import interop
from sgvamp_torch.config import VampConfig as TConfig
from sgvamp_torch.core import vamp as tvamp
from sgvamp_torch.core.operators import DenseLD as TDenseLD
from sgvamp_torch.core.prior import PriorState as TPrior
from sgvamp_torch.io.writers import OutputWriter as TWriter
from sgvamp_tpu.config import VampConfig as JConfig
from sgvamp_tpu.core import vamp as jvamp
from sgvamp_tpu.core.operators import DenseLD as JDenseLD
from sgvamp_tpu.core.prior import PriorState as JPrior
from sgvamp_tpu.data.simulate import band_to_dense, simulate_ld_band
from sgvamp_tpu.io.writers import OutputWriter as JWriter
from sgvamp_tpu.ops.band_kernel import SymBandedLD as JSym

N, LAM, H2 = 20000, 0.05, 0.7
PARAMS = ("gamw", "gam1", "gam2", "alpha1", "alpha2", "lam")


def _problem(M, bw, K, seed, n=N):
    band, r, x0 = simulate_ld_band(n, M, bw, h2=H2, lam=LAM, n_r=K,
                                   rng=np.random.default_rng(seed),
                                   dtype=np.float64)
    return band, np.atleast_2d(r), x0


def _probes(iters, K, M, seed):
    return np.random.default_rng(seed).choice([-1.0, 1.0], size=(iters, K, M))


def _prior_args(M, n=N):
    return LAM, [1.0], [H2 / max(int(M * LAM), 1) * n]


def _dense_engines(K, dtype="float64", seed=0):
    M = 160
    band, r, x0 = _problem(M, 24, K, seed)
    R = np.repeat(band_to_dense(band)[None], K, axis=0)
    cfg = dict(prior_update="em", dtype=dtype, cg_maxit=200, cg_rtol=1e-7,
               em_prior_maxit=20, rho=0.5)
    a, Nk = np.full(K, 1.0 / K), np.full(K, float(N))
    jeng = jvamp.VampEngine(
        jvamp.VampInputs(op=JDenseLD(mats=jnp.asarray(R), s=0.05), r=jnp.asarray(r),
                         a=jnp.asarray(a), N=jnp.asarray(Nk)),
        JConfig(**cfg), JPrior.create(*_prior_args(M)))
    teng = tvamp.VampEngine(
        tvamp.VampInputs(op=TDenseLD(mats=torch.from_numpy(R), s=0.05),
                         r=torch.from_numpy(r), a=torch.from_numpy(a),
                         N=torch.from_numpy(Nk)),
        TConfig(**cfg), TPrior.create(*_prior_args(M), device="cpu"))
    return jeng, teng, x0, M


def _params(hist, name):
    col = PARAMS.index(name) + 1
    return np.array([[row[col] for row in rows] for rows in hist["params"]])


@pytest.mark.parametrize("K", [1, 2])
def test_f64_dense_trajectory_matches(K):
    jeng, teng, x0, M = _dense_engines(K)
    u = _probes(5, K, M, seed=K)
    hj = jeng.run(5, fixed_u=u, x0=x0)
    ht = teng.run(5, fixed_u=u, x0=x0)
    assert len(ht["xhat1"]) == len(hj["xhat1"]) == 5
    for it in range(5):
        np.testing.assert_allclose(ht["xhat1"][it], hj["xhat1"][it], rtol=1e-8,
                                   atol=1e-8 * np.abs(hj["xhat1"][it]).max())
        np.testing.assert_array_equal(ht["cg1_iters"][it], hj["cg1_iters"][it])
        np.testing.assert_array_equal(ht["cg2_iters"][it], hj["cg2_iters"][it])
    for name in PARAMS:
        np.testing.assert_allclose(_params(ht, name), _params(hj, name), rtol=1e-8,
                                   err_msg=name)
    np.testing.assert_allclose(ht["alignment"], hj["alignment"], rtol=1e-8)
    assert hj["alignment"][-1] > 0.9  # a run that learns something


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("K", [1, 2])
def test_f32_int8_banded_trajectory_matches(K):
    M, B, bw, iters = 300, 64, 100, 3     # ragged M (pads to 320), hb = 2
    n = 200  # N/M near the bench's: z = N - 2 x.r + x.R x stays far above f32 rounding
    band, r, x0 = _problem(M, bw, K, seed=10 + K, n=n)
    jop = JSym.from_band(band, block_size=B, K=K, dtype="int8", s=0.02)
    top = interop.operator_from_numpy(np.asarray(jop.upper), np.asarray(jop.scales),
                                      s=0.02, device="cpu")
    assert top.hb >= 2 and top.M > M
    Mp = top.M
    mask = (np.arange(Mp) < M).astype(np.float32)
    rp = np.zeros((K, Mp), np.float32)
    rp[:, :M] = r
    a, Nk = np.full(K, 1.0 / K, np.float32), np.full(K, float(n), np.float32)
    cfg = dict(prior_update="em", dtype="float32", cg_maxit=20,
               cg_force_maxiter=True, em_prior_maxit=5, rho=0.5)
    jeng = jvamp.VampEngine(
        jvamp.VampInputs(op=jop, r=jnp.asarray(rp), a=jnp.asarray(a),
                         N=jnp.asarray(Nk), mask=jnp.asarray(mask)),
        JConfig(**cfg), JPrior.create(*_prior_args(M, n)))
    teng = tvamp.VampEngine(
        interop.inputs_from_numpy(top, rp, a, Nk, mask=mask, device="cpu"),
        TConfig(**cfg), TPrior.create(*_prior_args(M, n), device="cpu"))
    u = _probes(iters, K, Mp, seed=20 + K)
    hj = jeng.run(iters, fixed_u=u, M_out=M, x0=x0)
    ht = teng.run(iters, fixed_u=u, M_out=M, x0=x0)
    for it in range(iters):
        assert _rel(ht["xhat1"][it], hj["xhat1"][it]) <= 1e-3, it
        assert np.all(ht["cg1_iters"][it] == 20) and np.all(hj["cg1_iters"][it] == 20)
    for name, tol in (("alpha2", 1e-3), ("gamw", 1e-3), ("gam1", 1e-1)):
        assert _rel(_params(ht, name), _params(hj, name)) <= tol, name
    assert ht["xhat1"][-1].shape == (M,)


def _read_table(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter="\t"))
    return rows[0], np.array(rows[1:], np.float64)


def test_writer_files_match(tmp_path):
    K = 2
    jeng, teng, x0, M = _dense_engines(K, seed=5)
    u = _probes(4, K, M, seed=6)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jeng.run(4, fixed_u=u, x0=x0, Nt=2.0 * N, writer=JWriter(str(jdir), "run", K=K))
    teng.run(4, fixed_u=u, x0=x0, Nt=2.0 * N, writer=TWriter(str(tdir), "run", K=K))
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert "run_metrics.csv" in names and "run_r1_cohort_2_it_3.bin" in names
    for name in names:
        if name.endswith(".csv"):
            hj, vj = _read_table(jdir / name)
            ht, vt = _read_table(tdir / name)
            assert hj == ht, name
            np.testing.assert_allclose(vt, vj, rtol=1e-8, err_msg=name)
        else:
            vj = np.fromfile(jdir / name, "<f8")
            vt = np.fromfile(tdir / name, "<f8")
            np.testing.assert_allclose(vt, vj, rtol=1e-8, atol=1e-8 * np.abs(vj).max(),
                                       err_msg=name)


def _jax_state_arrays(state):
    names = ("xhat1", "alpha1", "r1", "gam1", "xhat2", "r2", "alpha2", "gam2",
             "gamw", "sigma2_u")
    out = {n: np.asarray(getattr(state, n)) for n in names}
    out["it"] = np.asarray(state.it)
    for n in ("lam", "omegas", "sigmas"):
        out[n] = np.asarray(getattr(state.prior, n))
    return out


def test_step_from_a_jax_state_matches():
    K = 2
    jeng, teng, x0, M = _dense_engines(K, seed=8)
    u = _probes(3, K, M, seed=9)
    state = jeng.run(2, fixed_u=u)["state"]
    assert int(state.it) == 2
    jnext, jaux = jvamp.vamp_step(state, jeng.inputs, jeng.cfg, jnp.asarray(u[2]))
    tstate = interop.state_from_numpy(_jax_state_arrays(state), device="cpu")
    assert tstate.it == 2 and tstate.xhat1.dtype == torch.float64
    tnext, taux = tvamp.vamp_step(tstate, teng.inputs, teng.cfg, torch.from_numpy(u[2]))
    assert tnext.it == 3
    for name in ("xhat1", "r1", "gam1", "xhat2", "alpha1", "alpha2", "gam2", "gamw",
                 "sigma2_u"):
        want = np.asarray(getattr(jnext, name))
        np.testing.assert_allclose(getattr(tnext, name).numpy(), want, rtol=1e-8,
                                   atol=1e-8 * np.abs(want).max(), err_msg=name)
    np.testing.assert_allclose(tnext.prior.lam.numpy(), np.asarray(jnext.prior.lam),
                               rtol=1e-8)
    assert taux.em_sweeps == int(jaux.em_sweeps)
    np.testing.assert_array_equal(taux.cg1_iters.numpy(), np.asarray(jaux.cg1_iters))


def test_generated_probes_are_rademacher_and_seeded():
    """Without injected probes the port draws them from its own seeded
    generator: the same seed gives the same run."""
    _, teng, x0, M = _dense_engines(1, seed=11)
    h1 = teng.run(2, seed=3)
    h2 = teng.run(2, seed=3)
    np.testing.assert_array_equal(h1["xhat1"][-1], h2["xhat1"][-1])
    s = teng.init_state(seed=3)
    u = torch.randint(0, 2, (1, M), generator=s.gen).double() * 2 - 1
    assert set(u.unique().tolist()) == {-1.0, 1.0}
