"""One process of a run over several processes of the port, for
tests/test_torch_multiprocess.py: torch.distributed over gloo on the CPU,
each process with a (1, 4) shard mesh of CPU cells, the cohort axis across
the processes. It imports torch and sgvamp_torch only.

    python torch_multiproc_child.py <process_id> <num_processes> <port> <out_dir> <panel_dir>

It writes what the parent compares into out_dir (process p's files end in
_p<p>) and prints one "OK <phase> process=<p>" line a phase:
  * parity: the six operators (banded with the block-Jacobi
    preconditioner, sym f64, int8, int4, hybrid, blocksparse), 3 host-loop
    iterations with injected probes; the fused run for int8 and blocksparse;
  * collectives: the exchanges of a run counted, one a VAMP step;
  * agreement: fetch_aux_full agreed across processes, and a conflict
    raising on every process;
  * checkpoint: a run over these processes resumed from a checkpoint that
    process 0 wrote;
  * cli: cli.main over these processes, with and without --fused 1 (the
    int8 case with --profile-dir: a trace from each process).
"""

import os
import shutil
import sys

import numpy as np
import torch

OPERATORS = ("banded", "sym", "sym_int8", "sym_int4", "sym_hybrid", "blocksparse")
K, M, B, ITERS, N = 2, 1024, 128, 3, 20000


def numpy_case(K=K, M=M):
    """(band, rs, probes) of the parity runs, from seeds, in numpy."""
    from sgvamp_torch.data.simulate import simulate_ld_band

    band, r, _ = simulate_ld_band(N, M, 64, h2=0.7, lam=0.05, rng=np.random.default_rng(0),
                                  dtype=np.float64)
    rs = np.tile(r[None], (K, 1)) * (1.0 + 0.01 * np.arange(K)[:, None])
    u = (np.random.default_rng(99).integers(0, 2, size=(ITERS, K, M)) * 2 - 1).astype(np.float64)
    return band, rs, u


def config(op_name):
    """The parity runs' VampConfig keywords, as the JAX package's test
    sets them."""
    quant = op_name in ("sym_int8", "sym_int4", "sym_hybrid")
    return dict(prior_update="em", dtype="float32" if quant else "float64",
                cg_maxit=100 if quant else 200, cg_rtol=1e-5 if quant else 1e-10, rho=0.5,
                lmmse_damp=True,
                **({"cg_precond_block": 64, "cg_precond_dtype": "float64"}
                   if op_name == "banded" else {}))


def blocksparse_csr(band):
    """The band as a scipy CSR matrix (the blocksparse runs' input)."""
    import scipy.sparse

    from sgvamp_torch.core.operators import BandedLD

    dense = BandedLD.from_band(band, block_size=B, device="cpu").to_dense()[0].numpy()
    return scipy.sparse.csr_matrix(dense)


def port_engine(op_name, mesh=None):
    """The port's engine over the parity problem of op_name."""
    from sgvamp_torch.config import VampConfig
    from sgvamp_torch.core.operators import BandedLD, BlockSparseLD
    from sgvamp_torch.core.prior import PriorState
    from sgvamp_torch.core.vamp import VampEngine, VampInputs
    from sgvamp_torch.ops.band_kernel import SymBandedLD

    band, rs, _ = numpy_case()
    if op_name.startswith("sym"):
        dtype = {"sym": None, "sym_int8": "int8", "sym_int4": "int4",
                 "sym_hybrid": "hybrid"}[op_name]
        op = SymBandedLD.from_band(band, block_size=B, K=K, dtype=dtype, device="cpu")
    elif op_name == "blocksparse":
        op = BlockSparseLD.from_csr([blocksparse_csr(band)] * K, block_size=B, device="cpu")
    else:
        op = BandedLD.from_band(band, block_size=B, K=K, device="cpu")
    cfg = VampConfig(**config(op_name))
    dt = cfg.torch_dtype
    Nt = float(K * N)
    cm = max(int(M * 0.05), 1)
    prior = PriorState.create(0.05, [1.0], [0.7 / cm * Nt], device="cpu")
    inputs = VampInputs(op=op, r=torch.as_tensor(rs, dtype=dt), a=torch.full((K,), 1.0 / K,
                                                                               dtype=dt),
                        N=torch.full((K,), float(N), dtype=dt))
    return VampEngine(inputs, cfg, prior, gamw=5.0, gam1=1e-6, mesh=mesh)


def history_arrays(hist):
    return dict(xhat1=np.stack(hist["xhat1"]), params=np.asarray(hist["params"], np.float64))


def scan_arrays(aux):
    return {f: v.numpy() for f, v in aux._asdict().items()}


def run_parity(mesh, pid, out):
    _, _, u = numpy_case()
    for op_name in OPERATORS:
        engine = port_engine(op_name, mesh)
        assert engine.inputs.cohorts == (pid, pid + 1)
        assert engine.inputs.op.K == 1
        hist = engine.run(ITERS, fixed_u=u)
        np.savez(os.path.join(out, f"{op_name}_p{pid}.npz"), **history_arrays(hist))
        if op_name in ("sym_int8", "blocksparse"):
            _, aux = engine.run_scan(ITERS, fixed_u=u)
            np.savez(os.path.join(out, f"{op_name}_scan_p{pid}.npz"), **scan_arrays(aux))
            # the fused run is the host loop, bit for bit
            for it in range(ITERS):
                assert np.array_equal(aux.xhat1[it].numpy(), hist["xhat1"][it]), it
        print(f"OK parity operator={op_name} process={pid}", flush=True)


def run_collectives(mesh, pid, out):
    """The exchanges across processes: one a VAMP step, none in an LD pass."""
    from sgvamp_torch.parallel import multihost

    _, _, u = numpy_case()
    engine = port_engine("blocksparse", mesh)
    counts = {}
    multihost.COLLECTIVES["all_gather"] = 0
    engine.inputs.op.matvec(torch.ones((2, M), dtype=torch.float64))
    counts["matvec"] = multihost.COLLECTIVES["all_gather"]
    for n in (1, 3):
        multihost.COLLECTIVES["all_gather"] = 0
        engine.run(n, fixed_u=u)
        counts[f"run{n}"] = multihost.COLLECTIVES["all_gather"]
        multihost.COLLECTIVES["all_gather"] = 0
        engine.run_scan(n, fixed_u=u)
        counts[f"scan{n}"] = multihost.COLLECTIVES["all_gather"]
    multihost.COLLECTIVES["all_gather"] = 0
    engine.run_scan_stoppable(3, stop_tol=1e-30, fixed_u=u)
    counts["stoppable3"] = multihost.COLLECTIVES["all_gather"]
    # a stop: every process stops at the same step, in both modes
    counts["host_stopped_at"] = engine.run(3, fixed_u=u, stop_tol=1e30).get("stopped_at", -1)
    counts["fused_n_ran"] = int(engine.run_scan_stoppable(3, stop_tol=1e30, fixed_u=u)[2].n_ran)
    np.savez(os.path.join(out, f"collectives_p{pid}.npz"), **counts)
    print(f"OK collectives process={pid}", flush=True)


def run_agreement(mesh, pid, out):
    import tempfile

    from sgvamp_torch.io.writers import OutputWriter

    engine = port_engine("sym", mesh)
    writer = OutputWriter(tempfile.mkdtemp(), "agree", K) if pid == 0 else None
    # a writer on process 0 alone opts every process in
    fetched = [engine._fetch_full(writer, None)]
    engine.run(1, writer=writer, Nt=float(N * K))
    fetched.append(engine._fetch_full(None, None))
    try:
        engine.run(1, fetch_aux_full=(pid == 0))
    except ValueError as e:
        assert "disagrees across processes" in str(e), e
        raised = True
    else:
        raised = False
    np.savez(os.path.join(out, f"agreement_p{pid}.npz"), fetched=np.asarray(fetched),
             raised=raised)
    print(f"OK agreement process={pid}", flush=True)


def run_checkpoint(mesh, pid, out):
    """Two iterations with a checkpoint after each (process 0 writes), then
    the third from the newest checkpoint, restored over these processes;
    and the run resumed from the parent's one-process checkpoint."""
    from sgvamp_torch.io.checkpoint import CheckpointManager

    _, _, u = numpy_case()
    ck = os.path.join(out, "ck_two")
    engine = port_engine("sym_int8", mesh)
    mgr = CheckpointManager(ck)
    engine.run(2, fixed_u=u, seed=3, callback=lambda it, st, aux: mgr.save(st, it + 1))
    state, it = mgr.restore_latest(engine.init_state(3))
    assert it == 2 and state.xhat2.shape[0] == 1
    hist = engine.run(1, state=state, fixed_u=u[2:], it0=2)
    np.savez(os.path.join(out, f"ck_resumed_p{pid}.npz"), **history_arrays(hist))
    one = CheckpointManager(os.path.join(os.path.dirname(out), "ck_one"))
    state, it = one.restore_latest(engine.init_state(3))
    hist = engine.run(1, state=state, fixed_u=u[it:], it0=it)
    np.savez(os.path.join(out, f"ck_from_one_p{pid}.npz"), **history_arrays(hist))
    print(f"OK checkpoint process={pid}", flush=True)


def cli_argv(panel, out, name, *extra):
    """The command line of the CLI phase (two cohorts of one panel)."""
    return ["--ld-files", ",".join([os.path.join(panel, "p_R.npz")] * 2),
            "--r-files", ",".join([os.path.join(panel, "p_r.npy")] * 2),
            "--true-signal-file", os.path.join(panel, "p_bet.npy"), "--out-dir", out,
            "--out-name", name, "--N", "20000,30000", "--M", "1024", "--K", "2",
            "--iterations", "3", "--block-size", "64", "--platform", "cpu", "--seed", "1",
            *extra]


CLI_CASES = {
    "sym": ["--operator", "sym", "--cg-precond-block", "32", "--mesh-shard", "2"],
    "int8": ["--operator", "sym", "--ld-dtype", "int8", "--x64", "0", "--fused", "1",
             "--profile-dir", "PROF"],
    "blocksparse": ["--operator", "blocksparse"],
    "ckpt": ["--operator", "sym", "--iterations", "2", "--checkpoint-dir", "CK"],
    "resume": ["--operator", "sym", "--iterations", "4", "--checkpoint-dir", "CK",
               "--resume", "1"],
}


def cli_case(name, out):
    dirs = {"CK": os.path.join(out, "cli_ck"), "PROF": os.path.join(out, "cli_prof")}
    return [dirs.get(v, v) for v in CLI_CASES[name]]


def run_cli(pid, nproc, port, out, panel):
    from sgvamp_torch.cli import main as cli

    flags = ["--coordinator-address", f"localhost:{port}", "--num-processes", str(nproc),
             "--process-id", str(pid)]
    for name in CLI_CASES:
        # the resumed run continues the checkpointed run's files
        d = os.path.join(out, "cli_" + ("ckpt" if name == "resume" else name))
        # process 0 owns every output file: a second writer would repeat the
        # CSV rows, which the parent's byte comparison would see
        assert cli.main(cli_argv(panel, d, "c", *cli_case(name, out), *flags)) == 0
        if name == "ckpt" and pid == 0:
            # the checkpoints of two iterations, for a resume in one process
            shutil.copytree(os.path.join(out, "cli_ck"), os.path.join(out, "cli_ck_two"))
    print(f"OK cli process={pid}", flush=True)


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    out, panel = sys.argv[4], sys.argv[5]
    torch.set_num_threads(2)

    from sgvamp_torch.parallel import multihost

    assert multihost.multihost_init(f"localhost:{port}", nproc, pid, backend="gloo")
    assert multihost.process_count() == nproc and multihost.process_index() == pid
    mesh = multihost.make_multihost_mesh(devices=["cpu"] * 4)
    assert mesh.shape == {"cohort": nproc, "shard": 4}
    # the mesh's rows are the processes: row p is process p's own cells
    assert [mesh.row_process(r) for r in range(nproc)] == list(range(nproc))
    assert mesh.local().shape == {"cohort": 1, "shard": 4} and mesh.processes == nproc
    print(f"OK mesh process={pid}", flush=True)

    run_parity(mesh, pid, out)
    run_collectives(mesh, pid, out)
    run_agreement(mesh, pid, out)
    run_checkpoint(mesh, pid, out)
    run_cli(pid, nproc, port, out, panel)
    assert "jax" not in sys.modules and "sgvamp_tpu" not in sys.modules
    torch.distributed.destroy_process_group()
    print(f"DONE process={pid}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
