"""The port's checkpoints (sgvamp_torch.io.checkpoint.CheckpointManager) and
resumed runs, on the CPU, after tests/test_checkpoint.py.

A checkpoint holds the whole VampState, the probes' generator and the MLE
warm start included, so a resumed run continues the uninterrupted one bit
for bit: in the host loop, in the fused run (whose pieces run eagerly on
the CPU over the buffers a CUDA device captures), and across the two. The
command line's per-iteration files and CSVs of a resumed run are the
uninterrupted run's to the byte. A checkpoint of another structure, a JAX
one included, is refused.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgvamp_torch.cli import main as tcli
from sgvamp_torch.cli import simulate as tsim
from sgvamp_torch.config import VampConfig
from sgvamp_torch.core import vamp as tvamp
from sgvamp_torch.core.operators import BandedLD
from sgvamp_torch.core.prior import PriorState
from sgvamp_torch.io.checkpoint import CheckpointManager
from sgvamp_tpu import PriorState as JPrior
from sgvamp_tpu import VampConfig as JConfig
from sgvamp_tpu import VampEngine as JEngine
from sgvamp_tpu import VampInputs as JInputs
from sgvamp_tpu.core.operators import BandedLD as JBanded
from sgvamp_tpu.data.simulate import simulate_ld_band
from sgvamp_tpu.io.checkpoint import CheckpointManager as JCheckpointManager


def _problem(M):
    rng = np.random.default_rng(0)
    band, r, x0 = simulate_ld_band(20000, M, bandwidth=24, rng=rng, dtype=np.float64,
                                   h2=0.7, lam=0.1)
    return band, r


def _engine(M=200, update="mle", dtype="float64"):
    """tests/test_checkpoint.py's engine in the port: BandedLD over a
    ragged M, padded and masked."""
    N, lam, h2 = 20000, 0.1, 0.7
    band, r = _problem(M)
    op = BandedLD.from_band(band, block_size=64, dtype=dtype, device="cpu")
    Mp = op.M
    td = torch.float64 if dtype == "float64" else torch.float32
    rp = torch.zeros((1, Mp), dtype=td)
    rp[0, :M] = torch.from_numpy(r)
    cfg = VampConfig(prior_update=update, dtype=dtype, cg_maxit=200)
    prior = PriorState.create(lam, [1.0], [h2 / int(M * lam) * N], dtype=td, device="cpu")
    inputs = tvamp.VampInputs(op=op, r=rp, a=torch.ones(1, dtype=td),
                              N=torch.full((1,), float(N), dtype=td),
                              mask=(torch.arange(Mp) < M).to(td))
    return tvamp.VampEngine(inputs, cfg, prior)


@pytest.fixture(scope="module")
def engine():
    return _engine()


def _assert_states_equal(a, b):
    assert a.it == b.it
    for f in tvamp._VECTORS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("lam", "omegas", "sigmas", "mle_gam", "mle_gam_valid", "mle_last_ok"):
        assert torch.equal(getattr(a.prior, f), getattr(b.prior, f)), f
    assert torch.equal(a.gen.get_state(), b.gen.get_state())


def test_checkpoint_roundtrip_and_gc(engine, tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=3)
    state = engine.init_state(seed=9)
    for it in range(1, 6):
        state = engine.run(1, state=state, it0=it - 1)["state"]
        ck.save(state, it)
    assert sorted(os.listdir(tmp_path)) == [f"vamp_state_00000{i}.npz" for i in (3, 4, 5)]
    restored, it = ck.restore_latest(engine.init_state(seed=9))
    assert it == 5
    _assert_states_equal(restored, state)
    assert bool(restored.prior.mle_gam_valid)    # the MLE warm start came back
    assert restored.gen is not state.gen          # a generator of its own


def test_restore_none_when_empty(engine, tmp_path):
    assert CheckpointManager(str(tmp_path)).restore_latest(engine.init_state()) is None


def _jax_state():
    band, r = _problem(200)
    op = JBanded.from_band(band, block_size=64)
    rp = np.zeros(op.M)
    rp[:200] = r
    eng = JEngine(JInputs(op=op, r=jnp.asarray(rp)[None], a=jnp.asarray([1.0]),
                          N=jnp.asarray([20000.0]),
                          mask=jnp.asarray((np.arange(op.M) < 200).astype(np.float64))),
                  JConfig(prior_update="mle", dtype="float64", cg_maxit=200),
                  JPrior.create(0.1, [1.0], [0.7 / 20 * 20000]))
    return eng, eng.run(1, seed=1)["state"]


@pytest.mark.parametrize("other", ["dtype", "shape", "jax"])
def test_restore_refuses_another_structure(engine, tmp_path, other):
    ck = CheckpointManager(str(tmp_path))
    if other == "jax":
        jeng, jstate = _jax_state()
        JCheckpointManager(str(tmp_path)).save(jstate, 1)
        with pytest.raises(ValueError, match="structure"):
            ck.restore_latest(engine.init_state())
        # and the JAX package refuses the port's
        ck.save(engine.run(1)["state"], 2)
        with pytest.raises(ValueError):
            JCheckpointManager(str(tmp_path)).restore_latest(jeng.init_state())
        return
    ck.save(engine.run(1)["state"], 1)
    template = (_engine(dtype="float32") if other == "dtype" else _engine(M=300)).init_state()
    with pytest.raises(ValueError, match="structure" if other == "dtype" else "shape"):
        ck.restore_latest(template)


def _run(engine, mode, n, **kw):
    """n steps in the host loop or the fused run: (state, xhat1 rows)."""
    if mode == "host":
        h = engine.run(n, **kw)
        return h["state"], [torch.from_numpy(x) for x in h["xhat1"]]
    kw.pop("callback", None)
    kw.pop("it0", None)
    state, aux = engine.run_scan(n, **kw)
    return state, list(aux.xhat1)


@pytest.mark.parametrize("update,saved,resumed", [
    ("em", "host", "host"), ("mle", "host", "host"), ("mle", "fused", "fused"),
    ("mle", "host", "fused"), ("mle", "fused", "host")])
def test_resumed_run_continues_the_trajectory_bit_for_bit(tmp_path, update, saved, resumed):
    engine = _engine(update=update)
    full, rows = _run(engine, "host", 6, seed=3)
    ck = CheckpointManager(str(tmp_path))
    state, first = _run(engine, saved, 3, seed=3,
                        callback=lambda it, st, aux: ck.save(st, it + 1))
    if saved == "fused":
        ck.save(state, 3)
    restored, it0 = ck.restore_latest(engine.init_state(seed=3))
    assert it0 == 3 == restored.it
    final, rest = _run(engine, resumed, 3, state=restored, it0=it0)
    _assert_states_equal(final, full)
    for a, b in zip(first + rest, rows):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_panel")
    assert tsim.main(["gen-band", "--out", str(d / "p"), "--N", "20000", "--M", "1000",
                      "--h2", "0.7", "--lam", "0.02", "--bandwidth", "64", "--seed", "3",
                      "--uncompressed"]) == 0
    return d


def _cli(d, out, iterations, extra=()):
    return tcli.main([
        "--ld-files", str(d / "p_R.npz"), "--r-files", str(d / "p_r.npy"),
        "--true-signal-file", str(d / "p_bet.npy"), "--out-dir", str(out), "--out-name", "run",
        "--N", "20000", "--M", "1000", "--iterations", str(iterations), "--platform", "cpu",
        "--x64", "0", "--operator", "sym", "--ld-dtype", "int8", "--block-size", "128",
        "--cg-precond-block", "64", "--stop-on-divergence", "1", "--prior-update", "mle",
        *extra])


@pytest.mark.parametrize("extra", [("--fused", "0"), ("--fused", "1"),
                                   ("--fused", "1", "--mesh-shard", "2")],
                         ids=["host-loop", "fused", "fused-mesh"])
def test_cli_resume_writes_the_uninterrupted_files(panel, tmp_path, extra):
    """4 iterations at once, and 2 with --checkpoint-dir then --resume 1 to
    4: the same per-iteration files and CSVs, to the byte. The stop
    monitor is not checkpointed, so the selected iterate (xhat_best) is the
    resumed run's own."""
    ck = ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "2"]
    assert _cli(panel, tmp_path / "full", 4, extra) == 0
    assert _cli(panel, tmp_path / "res", 2, (*extra, *ck)) == 0
    assert _cli(panel, tmp_path / "res", 4, (*extra, *ck, "--resume", "1")) == 0
    names = sorted(os.listdir(tmp_path / "full"))
    assert names == sorted(os.listdir(tmp_path / "res"))
    assert "run_xhat_it_3.bin" in names and "run_metrics.csv" in names
    for name in names:
        if name != "run_xhat_best.bin":
            assert ((tmp_path / "full" / name).read_bytes()
                    == (tmp_path / "res" / name).read_bytes()), name
    kept = sorted(os.listdir(tmp_path / "ck"))
    assert 0 < len(kept) <= 3 and kept[-1] == "vamp_state_000004.npz"
    # a resumed run already at its iteration count runs nothing
    assert _cli(panel, tmp_path / "res", 4, (*extra, *ck, "--resume", "1")) == 0
    assert (tmp_path / "full" / "run_metrics.csv").read_bytes() == \
        (tmp_path / "res" / "run_metrics.csv").read_bytes()
