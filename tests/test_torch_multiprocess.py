"""The port's runs over several processes (sgvamp_torch.parallel.multihost,
the once-a-step exchange of core/vamp.py, io/checkpoint.py and the command
line's --coordinator-address / --num-processes / --process-id), on the
CPU: two processes over gloo, each with a (1, 4) shard mesh of CPU cells
(tests/torch_multiproc_child.py, which imports torch and sgvamp_torch
only), spawned once for every phase, as the JAX package's
tests/test_multiprocess.py spawns its children.

The parent holds what the children wrote against:
  * the JAX package's one-process engine on the same numpy inputs and
    probes, at the JAX package's own multi-process tolerances (relative L2
    of xhat1 1e-9 in f64, 2e-4 for int8, 2e-3 for int4 and hybrid; the
    per-cohort parameters at 1e-8, 1e-3, 1e-2);
  * the port's one-process run, bit for bit;
  * the one-process command line's files, byte for byte.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_multiproc_child as child
from sgvamp_torch.cli import main as tcli
from sgvamp_torch.cli import simulate as tsim
from sgvamp_torch.io.checkpoint import CheckpointManager
from sgvamp_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "torch_multiproc_child.py")
NPROC = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The two children's outputs, after a one-process checkpoint and the
    command line's panel are made for them."""
    d = tmp_path_factory.mktemp("mp")
    panel = d / "panel"
    panel.mkdir()
    assert tsim.main(["gen-band", "--out", str(panel / "p"), "--N", "20000", "--M", "1024",
                      "--h2", "0.7", "--lam", "0.02", "--bandwidth", "100", "--seed", "3",
                      "--uncompressed"]) == 0
    _, _, u = child.numpy_case()
    mgr = CheckpointManager(str(d / "ck_one"))
    child.port_engine("sym_int8").run(2, fixed_u=u, seed=3,
                                      callback=lambda it, st, aux: mgr.save(st, it + 1))
    out = d / "out"
    out.mkdir()
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, CHILD, str(pid), str(NPROC), str(port),
                               str(out), str(panel)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO)
             for pid in range(NPROC)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed (rc={p.returncode}):\n{text[-6000:]}"
    return d, out, panel, outs


def _load(out, name, pid):
    with np.load(out / f"{name}_p{pid}.npz") as f:
        return {k: f[k] for k in f.files}


def test_children_ran_every_phase(spawned):
    _, _, _, outs = spawned
    for pid, text in enumerate(outs):
        for phase in ("mesh", *(f"parity operator={op}" for op in child.OPERATORS),
                      "collectives", "agreement", "checkpoint", "cli"):
            assert f"OK {phase} process={pid}" in text, phase
        assert f"DONE process={pid}" in text


@pytest.fixture(scope="module")
def port_one_process():
    """The port's one-process runs of the parity problems."""
    _, _, u = child.numpy_case()
    runs = {}
    for op in child.OPERATORS:
        engine = child.port_engine(op)
        runs[op] = child.history_arrays(engine.run(child.ITERS, fixed_u=u))
        if op in ("sym_int8", "blocksparse"):
            runs[op + "_scan"] = child.scan_arrays(engine.run_scan(child.ITERS, fixed_u=u)[1])
    return runs


def _jax_one_process(op_name):
    """The JAX package's one-process engine on the same numpy inputs."""
    import jax.numpy as jnp

    from sgvamp_tpu.config import VampConfig
    from sgvamp_tpu.core.operators import BandedLD, BlockSparseLD
    from sgvamp_tpu.core.prior import PriorState
    from sgvamp_tpu.core.vamp import VampEngine, VampInputs
    from sgvamp_tpu.ops.band_kernel import SymBandedLD

    band, rs, u = child.numpy_case()
    K, B, N = child.K, child.B, child.N
    if op_name.startswith("sym"):
        dtype = {"sym": None, "sym_int8": "int8", "sym_int4": "int4",
                 "sym_hybrid": "hybrid"}[op_name]
        op = SymBandedLD.from_band(band, block_size=B, K=K, dtype=dtype)
    elif op_name == "blocksparse":
        op = BlockSparseLD.from_csr([child.blocksparse_csr(band)] * K, block_size=B)
    else:
        op = BandedLD.from_band(band, block_size=B, K=K)
    cfg = VampConfig(**child.config(op_name))
    dt = jnp.float32 if cfg.dtype == "float32" else jnp.float64
    cm = max(int(child.M * 0.05), 1)
    prior = PriorState.create(0.05, [1.0], [0.7 / cm * float(K * N)])
    inputs = VampInputs(op=op, r=jnp.asarray(rs, dt), a=jnp.full((K,), 1.0 / K, dt),
                        N=jnp.full((K,), float(N), dt))
    hist = VampEngine(inputs, cfg, prior, gamw=5.0, gam1=1e-6).run(child.ITERS, fixed_u=u)
    return child.history_arrays(hist)


@pytest.mark.parametrize("op_name", child.OPERATORS)
def test_two_processes_match_the_jax_one_process_engine(spawned, op_name):
    _, out, _, _ = spawned
    got = [_load(out, op_name, pid) for pid in range(NPROC)]
    # every process ends with the same whole values
    for f in ("xhat1", "params"):
        assert np.array_equal(got[0][f], got[1][f]), f
    want = _jax_one_process(op_name)
    tol, ptol = ((2e-3, 1e-2) if op_name in ("sym_int4", "sym_hybrid")
                 else (2e-4, 1e-3) if op_name == "sym_int8" else (1e-9, 1e-8))
    for it in range(child.ITERS):
        a, b = got[0]["xhat1"][it], want["xhat1"][it]
        assert np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30) < tol, it
        # gamw, gam1, gam2, alpha1, alpha2 and lam of both cohorts
        np.testing.assert_allclose(got[0]["params"][it], want["params"][it], rtol=ptol)


@pytest.mark.parametrize("op_name", child.OPERATORS)
def test_two_processes_match_the_port_s_one_process_run(spawned, port_one_process, op_name):
    _, out, _, _ = spawned
    got = _load(out, op_name, 0)
    want = port_one_process[op_name]
    for f in ("xhat1", "params"):
        assert np.array_equal(got[f], want[f]), f


@pytest.mark.parametrize("op_name", ["sym_int8", "blocksparse"])
def test_two_process_fused_run_matches_the_one_process_one(spawned, port_one_process,
                                                           op_name):
    _, out, _, _ = spawned
    want = port_one_process[op_name + "_scan"]
    for pid in range(NPROC):
        got = _load(out, op_name + "_scan", pid)
        for f in ("xhat1", "r1_in", "gam1", "gam2", "gamw", "alpha1", "alpha2", "lam",
                  "cg1_iters", "cg2_iters"):
            assert np.array_equal(got[f], want[f]), (pid, f)


def test_exchanges_happen_once_a_step_not_once_an_ld_pass(spawned):
    _, out, _, _ = spawned
    for pid in range(NPROC):
        c = _load(out, "collectives", pid)
        assert int(c["matvec"]) == 0
        # the host loop agrees on fetch_aux_full once, up front
        assert (int(c["run1"]), int(c["run3"])) == (2, 4)
        assert (int(c["scan1"]), int(c["scan3"]), int(c["stoppable3"])) == (1, 3, 3)
        # the stop criteria read the same gathered values on every process:
        # the same stop, and no step run by one process alone
        assert (int(c["host_stopped_at"]), int(c["fused_n_ran"])) == (1, 2)


def test_fetch_aux_full_is_agreed_and_a_conflict_raises_everywhere(spawned):
    _, out, _, _ = spawned
    for pid in range(NPROC):
        a = _load(out, "agreement", pid)
        assert a["fetched"].tolist() == [True, False]
        assert bool(a["raised"])


def test_checkpoint_resumes_over_two_processes_and_over_one(spawned, port_one_process):
    d, out, _, _ = spawned
    want = port_one_process["sym_int8"]
    # process 0 alone wrote the checkpoints of the run over two
    assert sorted(os.listdir(out / "ck_two")) == ["vamp_state_000001.npz",
                                                 "vamp_state_000002.npz"]
    for name in ("ck_resumed", "ck_from_one"):
        for pid in range(NPROC):
            got = _load(out, name, pid)
            assert np.array_equal(got["xhat1"][0], want["xhat1"][2]), (name, pid)
            assert np.array_equal(got["params"][0], want["params"][2]), (name, pid)
    # the checkpoint of the run over two, resumed in one process
    _, _, u = child.numpy_case()
    engine = child.port_engine("sym_int8")
    state, it = CheckpointManager(str(out / "ck_two")).restore_latest(engine.init_state(3))
    hist = child.history_arrays(engine.run(1, state=state, fixed_u=u[it:], it0=it))
    assert it == 2 and np.array_equal(hist["xhat1"][0], want["xhat1"][2])
    assert np.array_equal(hist["params"][0], want["params"][2])


def _files(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("case", ["sym", "int8", "blocksparse", "ckpt", "ckpt-resumed-in-one"])
def test_cli_over_two_processes_writes_the_one_process_files(spawned, tmp_path, case):
    """ckpt: checkpoints of 2 iterations and a resume to 4, over two
    processes and over one; ckpt-resumed-in-one: the two processes'
    checkpoints (written by process 0) resumed in one process."""
    _, out, panel, _ = spawned
    ref = tmp_path / "ref"

    def one(name):
        extra = [str(tmp_path / "ck") if v == "CK" else v for v in child.CLI_CASES[name]]
        for flag in ("--mesh-shard", "--profile-dir"):   # the run of one holds neither
            if flag in extra:
                i = extra.index(flag)
                extra = extra[:i] + extra[i + 2:]
        assert tcli.main(child.cli_argv(str(panel), str(ref), "c", *extra)) == 0

    if case.startswith("ckpt"):
        one("ckpt")
        if case == "ckpt-resumed-in-one":
            shutil.rmtree(tmp_path / "ck")
            shutil.copytree(out / "cli_ck_two", tmp_path / "ck")
        one("resume")
    else:
        one(case)
    got, want = _files(out / f"cli_{case.split('-')[0]}"), _files(ref)
    assert sorted(got) == sorted(want) and "c_xhat_it_1.bin" in got
    for name in want:
        assert got[name] == want[name], name
    if case.startswith("ckpt"):
        assert "c_xhat_it_3.bin" in got


def test_every_process_writes_its_own_trace(spawned):
    """--profile-dir over two processes (the int8 CLI case, --fused 1): one
    trace a process, named by its index, each holding CPU events; the
    traced run's files are the one-process run's (above)."""
    _, out, _, _ = spawned
    traces = sorted(os.listdir(out / "cli_prof"))
    assert [t.split(".")[0] for t in traces] == ["process0", "process1"], traces
    for t in traces:
        assert t.endswith(".pt.trace.json")
        with open(out / "cli_prof" / t) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("cat") == "cpu_op" for e in events), t


def test_multihost_init_without_configuration_returns_false(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.multihost_init() is False
    assert not torch.distributed.is_initialized()
    assert (multihost.process_count(), multihost.process_index()) == (1, 0)
    t = torch.arange(3.0)
    assert multihost.fetch_global(t) is t


_TORCHRUN = {"MASTER_ADDR": "h", "MASTER_PORT": "7", "WORLD_SIZE": "3", "RANK": "2"}


@pytest.mark.parametrize("flags,env,want", [
    ((None, None, None), {}, None),
    (("a:1", 2, 1), {}, ("a:1", 2, 1)),
    (("a:1", 1, None), {}, ("a:1", 1, 0)),
    ((None, None, None), _TORCHRUN, ("h:7", 3, 2)),
    (("a:1", None, 0), _TORCHRUN, ("a:1", 3, 0)),
    ((None, None, None), {"MASTER_ADDR": "h"}, None),
    ((None, None, None), {"MASTER_ADDR": "h", "MASTER_PORT": "7", "RANK": "0"}, None),
], ids=["none", "flags", "flags-of-one", "torchrun", "flags-over-torchrun",
        "stray-address", "torchrun-in-part"])
def test_group_config_takes_the_flags_else_all_of_torchruns_variables(monkeypatch, caplog,
                                                                      flags, env, want):
    """One resolver for the command line and multihost_init: each value is
    the flag, else torchrun's variable, and the variables count only all
    four together; a part of them is a run of one process, with a warning."""
    for var in _TORCHRUN:
        monkeypatch.delenv(var, raising=False)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    with caplog.at_level("WARNING", logger="sgvamp"):
        assert multihost.group_config(*flags) == want
    partial = 0 < len(env) < 4 and flags[0] is None
    assert any("not a torchrun launch" in m for m in caplog.messages) == partial


@pytest.mark.parametrize("flags,named", [
    (("a:1", None, None), "--coordinator-address needs --num-processes"),
    (("a:1", 2, None), "--coordinator-address with 2 processes needs --process-id"),
    ((None, 2, None), "--num-processes needs --coordinator-address"),
    ((None, None, 0), "--process-id needs --coordinator-address"),
])
def test_group_config_refuses_what_defines_no_group(monkeypatch, flags, named):
    for var in _TORCHRUN:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match=named):
        multihost.group_config(*flags)
    with pytest.raises(ValueError, match=named):
        multihost.multihost_init(*flags)
    assert not torch.distributed.is_initialized()


def test_make_multihost_mesh_in_one_process():
    mesh = multihost.make_multihost_mesh(2, devices=["cpu"] * 4)
    assert mesh.shape == {"cohort": 2, "shard": 2} and mesh.processes is None
    assert mesh.local() is mesh and mesh.row_process(1) == 0
    # the cohort axis defaults to the process count
    assert multihost.make_multihost_mesh(devices=["cpu"] * 4).shape == {"cohort": 1,
                                                                        "shard": 4}
    with pytest.raises(ValueError, match="4 devices not divisible into 3 cohorts"):
        multihost.make_multihost_mesh(3, devices=["cpu"] * 4)
    assert multihost.own_cohorts(4, processes=2, rank=1) == slice(2, 4)
    with pytest.raises(ValueError, match="not divisible over 2 processes"):
        multihost.own_cohorts(3, processes=2, rank=0)


def test_dryrun_multichip_holds_every_operator_against_the_unsharded_step(capsys):
    from sgvamp_torch.dryrun import OPERATORS, dryrun_multichip

    dryrun_multichip(4, devices=["cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split("operator=")[1].split()[0] for ln in lines if "parity ok" in ln] == list(
        OPERATORS)
    assert all("mesh={'cohort': 2, 'shard': 2} device=cpu" in ln
               for ln in lines if "parity ok" in ln)


def test_dryrun_multichip_runs_on_the_card_unless_given_the_cpu(monkeypatch):
    """Without devices the dry run takes the visible cards, and raises
    where there is none rather than stepping down to the CPU."""
    from sgvamp_torch.dryrun import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runs on a CUDA device by default"):
        dryrun_multichip(2)
