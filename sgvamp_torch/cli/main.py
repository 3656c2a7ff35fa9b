"""sgVAMP command line (PyTorch port of sgvamp_tpu/cli/main.py).

The same flags, defaults and value semantics as the JAX command line, so an
invocation ports by changing the module name. Without the multi-process
flags all K cohorts run inside one process: on one CUDA GPU unless
--platform cpu is given, or, with
--mesh-cohort / --mesh-shard, with the LD operator cut over a (cohort,
shard) mesh of the visible GPUs (parallel/sharding.py). A mesh with more
cells than there are GPUs takes them round-robin, and under --platform cpu
every cell is the CPU: the sharded path then runs its cells in turn.

Ported: --operator dense, --operator banded and --operator blocksparse
(float storage) and --operator sym with --ld-dtype float64, float32,
bfloat16, int8, int4 or hybrid; .npz / .npy LD inputs and PLINK .ld tables
with --bim-files (harmonized across cohorts, missing SNPs filled from their
source cohort, the merged .bim written to --out-dir); the host loop with
the block-Jacobi preconditioner, the StopMonitor and reference-format
output files, and --fused 1 (the whole run replayed as CUDA graphs of the
VAMP step, the stop criteria on the device); --prior-update em|mle|none;
checkpoints (--checkpoint-dir: after every iteration of the host loop,
between chunks of --checkpoint-every iterations of a fused run) and
--resume 1; runs over several processes (--coordinator-address,
--num-processes, --process-id, or torchrun's MASTER_ADDR / MASTER_PORT /
WORLD_SIZE / RANK): the cohorts divided over the processes
(parallel/multihost.py), process 0 owning stdout and every output file.
--operator sym leaves the operator's mode at "auto", so float storage
runs the resident kernel where its run fits a CTA's shared memory.
--profile-dir writes a torch.profiler trace of the inference
(utils/profiling.py::device_trace), one Chrome-trace JSON per process.
Every flag of the JAX command line is accepted; only --platform tpu is
refused.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional

import numpy as np


def _pad_band(band: "np.ndarray", bw: int) -> "np.ndarray":
    """Center symmetric band storage (M, 2w+1) inside (M, 2bw+1) at the
    shared bandwidth bw (returns the input unchanged when already there)."""
    w = (band.shape[1] - 1) // 2
    if w == bw:
        return band
    full = np.zeros((band.shape[0], 2 * bw + 1), band.dtype)
    full[:, bw - w:bw + w + 1] = band
    return full


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="VAMP for summary statistics (PyTorch/CUDA)")
    # -- reference-compatible surface --
    p.add_argument("-ld_files", "--ld-files", help="Path to LD matrices (.npz/.npy/.ld), separated by comma")
    p.add_argument("-r_files", "--r-files", help="Path to XTy files (.txt/.npy/.linear) separated by comma")
    p.add_argument("-true_signal_file", "--true-signal-file", help="Path to true signal .npy/.bin file", default=None)
    p.add_argument("-out_dir", "--out-dir", help="Output directory")
    p.add_argument("-out_name", "--out-name", help="Output file name")
    p.add_argument("-N", "--N", help="Number of samples in each cohort, separated by comma")
    p.add_argument("-M", "--M", help="Number of markers in each cohort, separated by comma")
    p.add_argument("-K", "--K", help="Number of cohorts", default=1)
    p.add_argument("-L", "--L", help="Number of prior mixture components", default=2)
    p.add_argument("-iterations", "--iterations", help="Number of iterations", default=10)
    p.add_argument("-prior_vars", "--prior-vars", help="Prior mixture variances", default="0,1")
    p.add_argument("-prior_probs", "--prior-probs", help="Prior mixture probabilities", default="0.99,0.01")
    p.add_argument("-gamw", "--gamw", help="Initial noise precision", default=5)
    p.add_argument("-gam1", "--gam1", help="Initial signal precision", default=0.000001)
    p.add_argument("-lmmse_damp", "--lmmse-damp", help="Use LMMSE damping", default=False)
    p.add_argument("-learn_gamw", "--learn-gamw", help="Learn or fix gamw", default=True)
    p.add_argument("-rho", "--rho", help="Damping factor rho", default=0.5)
    p.add_argument("-cg_maxit", "--cg-maxit", help="CG max iterations", default=500)
    p.add_argument("-s", "--s", help="Rused = (1-s) * R + s * Id", default=0.0)
    p.add_argument("-prior_update", "--prior-update", "--mle-prior-update",
                   dest="prior_update", help="Prior learning: 'em', 'mle' or 'none'", default="em")
    p.add_argument("-update_prior_from", "--update-prior-from",
                   help="Learn prior probabilities from this iteration onwards", default=1)
    p.add_argument("-em_prior_maxit", "--em-prior-maxit",
                   help="Max prior-learning EM iterations", default=100)
    p.add_argument("-bim_files", "--bim-files", help="Paths to .bim files, separated by comma", default=None)
    # -- device execution --
    g = p.add_argument_group("device execution")
    g.add_argument("--platform", help="Device to run on (cuda/cpu); default cuda", default=None)
    g.add_argument("--x64", help="Default to float64 (1/0); default on for cpu, off for cuda", default=None)
    g.add_argument("--dtype", help="Compute dtype: float32/float64/bfloat16", default=None)
    g.add_argument("--ld-dtype", help="LD block storage dtype (e.g. bfloat16 halves the "
                   "footprint; int8 with per-block scales halves it again; "
                   "int4 packs two values per byte with per-row scales and "
                   "halves it once more (lossier: ~16 quantization levels "
                   "per row - screening only, CG can break down on "
                   "ill-conditioned panels); hybrid keeps the diagonal "
                   "blocks at full int8 precision and packs only the far "
                   "blocks int4 (2/3 of int8's traffic, production-solve "
                   "safe) - int8/int4/hybrid are sym operator only; matvec "
                   "still accumulates in float32); defaults to --dtype",
                   default=None)
    g.add_argument("--mesh-cohort", help="Mesh size over the cohort axis", type=int, default=1)
    g.add_argument("--mesh-shard", help="Mesh size over the marker-shard axis", type=int, default=None)
    g.add_argument("--operator", default="dense",
                   choices=["dense", "banded", "sym", "blocksparse"],
                   help="LD operator: dense, banded (block-banded einsum), sym "
                   "(kernels over upper-triangle blocks), or blocksparse "
                   "(arbitrary block coordinates)")
    g.add_argument("--block-size", help="Banded operator block size", type=int, default=256)
    g.add_argument("--bandwidth", help="Banded operator half bandwidth (elements); auto if omitted",
                   type=int, default=None)
    g.add_argument("--cg-rtol", help="CG relative tolerance", type=float, default=1e-5)
    g.add_argument("--cg-precond-block", type=int, default=0,
                   help="Block-Jacobi CG preconditioner sub-block size "
                   "(0 = off; must divide --block-size)")
    g.add_argument("--cg-precond-dtype", default="float32",
                   help="Preconditioner inverse-block storage dtype")
    g.add_argument("--rho-final", help="Anneal damping linearly to this value",
                   type=float, default=None)
    g.add_argument("--rho-anneal-iters", help="Iterations over which rho anneals",
                   type=int, default=0)
    g.add_argument("--seed", help="PRNG seed for Hutchinson probes", type=int, default=0)
    g.add_argument("--clip-alpha1", default=0,
                   help="Clip alpha1 into [1e-5, 1-1e-5] (1/0); off by default for parity")
    g.add_argument("--clip-alpha2", default=0,
                   help="Clip alpha2 into [1e-5, 1-1e-5] (1/0). alpha2 is "
                   "provably in (0,1) for an SPD operator, so this only "
                   "removes Hutchinson/CG estimator noise. Off by default "
                   "for parity")
    g.add_argument("--gam-clamp", type=float, default=0.0,
                   help="Clamp gam1/gam2 into [1/x, x] (try 1e8). 0 = off (parity)")
    g.add_argument("--stop-tol", type=float, default=0.0,
                   help="Early-stop when the relative change of xhat1 "
                   "between iterations falls below this tolerance "
                   "(converged). 0 = off (fixed iteration count, post-hoc "
                   "selection)")
    g.add_argument("--stop-on-divergence", default=0,
                   help="Early-stop when min-over-cohorts gam1 collapses "
                   "below its running peak by --stop-gam1-drop, or goes "
                   "non-finite (1/0), and report the best iterate. Off by "
                   "default for parity")
    g.add_argument("--stop-gam1-drop", type=float, default=10.0,
                   help="Divergence factor for --stop-on-divergence: "
                   "trigger when min_k gam1 < peak/this")
    g.add_argument("--fused", help="Run all iterations as one fused scan (1/0)",
                   default=0)
    g.add_argument("--checkpoint-dir", help="Directory for checkpoint/resume state", default=None)
    g.add_argument("--checkpoint-every", type=int, default=10,
                   help="With --fused 1: checkpoint between chunks of this many iterations")
    g.add_argument("--resume", help="Resume from the latest checkpoint (1/0)", default=0)
    g.add_argument("--profile-dir", help="Write a torch.profiler trace of the run here "
                   "(one Chrome-trace JSON per process)", default=None)
    g.add_argument("--compile-cache-dir", default="~/.cache/sgvamp_tpu/xla",
                   help="Accepted for compatibility with the JAX command line; "
                   "PyTorch compiles nothing, so it has no effect")
    d = p.add_argument_group("multi-host execution")
    d.add_argument("--coordinator-address", default=None,
                   help="host:port of process 0's coordinator service")
    d.add_argument("--num-processes", type=int, default=None,
                   help="Total number of processes (hosts)")
    d.add_argument("--process-id", type=int, default=None,
                   help="This process's id in [0, num-processes)")
    return p


def _reject_unported(args) -> None:
    """SystemExit for a --platform the port does not run on, naming it."""
    if args.platform not in (None, "cuda", "cpu"):
        raise SystemExit(f"--platform {args.platform} is not supported by "
                         "sgvamp_torch: use cuda (the default) or cpu")


def _fused_run(engine, iterations: int, writer, x0, Nt: float, M: int, seed: int,
               stop_tol: float, stop_drop: float, ckpt=None, every: int = 1,
               state=None, start_it: int = 0) -> dict:
    """--fused 1: iterations start_it .. iterations - 1 through
    VampEngine.run_scan (or, with a stop criterion armed,
    run_scan_stoppable: the criteria on the device, no step after the
    stop), in one chunk, or with a CheckpointManager `ckpt` in chunks of
    `every` iterations with a checkpoint after each; the reference-format
    files from each chunk's stacked aux. The monitor is not checkpointed: a
    resumed run starts a fresh one. Unarmed runs track the best iterate
    with a host StopMonitor fed from the aux. Returns the history the host
    loop's branch returns."""
    from sgvamp_torch.core.vamp import StopMonitor, StopState

    armed = stop_tol > 0 or stop_drop > 0
    monitor = StopMonitor()
    st = state if state is not None else engine.init_state(seed)
    mon = None
    history = {"xhat1": [], "alignment": [], "l2": []}
    it = start_it
    while it < iterations:
        n = iterations - it if ckpt is None else min(max(1, every), iterations - it)
        if armed:
            st, aux, mon = engine.run_scan_stoppable(n, stop_tol=stop_tol,
                                                     stop_gam1_drop=stop_drop, state=st,
                                                     stop_state=mon)
            n = int(mon.n_ran) - (it - start_it)
            aux = type(aux)(*[v[:n] for v in aux])   # the rows that ran
        else:
            st, aux = engine.run_scan(n, state=st)
        if writer is not None:
            h = engine.write_scan_outputs(aux, writer, Nt=Nt, x0=x0, M_out=M, it0=it)
            for key in history:
                history[key].extend(h[key])
        else:
            history["xhat1"].extend(aux.xhat1[i].cpu().numpy()[:M] for i in range(n))
        if not armed:
            for i in range(n):
                monitor.update(it + i, history["xhat1"][it - start_it + i],
                               aux.gam1[i].cpu().numpy())
        if ckpt is not None:
            ckpt.save(st, it + n)
        it += n
        if armed and bool(mon.done):
            break
    if not armed:
        history["best_it"] = monitor.best_it
        history["best_xhat1"] = monitor.best_xhat1
    elif mon is None:
        # a resumed run already at its iteration count: nothing ran
        history["best_it"], history["best_xhat1"] = -1, None
    else:
        if bool(mon.done):
            history["stopped_at"] = int(mon.stopped_at)
            history["stop_reason"] = StopState.REASONS[int(mon.reason)]
        history["best_it"] = int(mon.best_it)
        history["best_xhat1"] = (mon.best_xhat1.cpu().numpy()
                                 if history["best_it"] >= 0 else None)
    return history


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    logging.basicConfig(format="%(message)s", level=logging.DEBUG)
    log = logging.getLogger("sgvamp")
    log.info(" ### VAMP for summary statistics (PyTorch/CUDA) ###\n")

    _reject_unported(args)
    import torch
    import torch.distributed as dist

    from sgvamp_torch import default_device
    from sgvamp_torch.parallel import multihost

    try:
        group = multihost.group_config(args.coordinator_address, args.num_processes,
                                       args.process_id)
    except ValueError as e:
        raise SystemExit(str(e))

    device = torch.device("cpu") if args.platform == "cpu" else default_device()
    # several processes: join the group before anything runs on the device
    was_joined = dist.is_initialized()
    multi = group is not None and multihost.multihost_init(
        *group, backend="gloo" if device.type == "cpu" else None)
    level = log.level
    if multihost.process_index() != 0:
        # process 0 owns stdout and every output file
        log.setLevel(logging.WARNING)
    try:
        return _run(args, log, device, multi)
    finally:
        log.setLevel(level)
        if multi and not was_joined:
            dist.destroy_process_group()


def _run(args, log, device, multi: bool) -> int:
    """main's run on `device`; multi: a run over a torch.distributed group,
    its cohorts divided over the processes."""
    import torch

    from sgvamp_torch.config import _DTYPES, PriorConfig, VampConfig
    from sgvamp_torch.core.operators import BandedLD, BlockSparseLD, DenseLD
    from sgvamp_torch.core.prior import PriorState
    from sgvamp_torch.core.vamp import VampEngine, VampInputs, alignment_l2
    from sgvamp_torch.data import harmonize as hz
    from sgvamp_torch.data import loaders
    from sgvamp_torch.io.checkpoint import CheckpointManager
    from sgvamp_torch.io.writers import OutputWriter, write_bin
    from sgvamp_torch.ops.band_kernel import SymBandedLD
    from sgvamp_torch.parallel import multihost
    from sgvamp_torch.utils import profiling
    from sgvamp_torch.utils.profiling import device_trace, span

    owns_output = multihost.process_index() == 0
    if args.compile_cache_dir:
        log.info("--compile-cache-dir has no effect: PyTorch compiles nothing\n")
    want_x64 = (device.type == "cpu") if args.x64 is None else bool(int(args.x64))
    dtype = args.dtype or ("float64" if want_x64 else "float32")
    ld_dtype = args.ld_dtype or dtype
    if ld_dtype in ("int8", "int4", "hybrid") and args.operator != "sym":
        # Only the sym kernels carry dequantization scales; a plain cast
        # would truncate correlations in [-1, 1] to zero.
        raise SystemExit(f"--ld-dtype {ld_dtype} requires --operator sym")
    if ld_dtype not in ("float64", "float32", "bfloat16", "int8", "int4", "hybrid"):
        raise SystemExit(f"--ld-dtype {ld_dtype} is not supported")
    if ld_dtype == "int4" and args.cg_rtol and args.cg_rtol <= 1e-4:
        log.info("WARNING: --ld-dtype int4 with --cg-rtol <= 1e-4: CG may "
                 "not reach tolerance under 16-level quantization on "
                 "ill-conditioned LD; use --ld-dtype hybrid (int8 diagonal "
                 "blocks, int4 far blocks) for production solves\n")

    # -- parse values with reference semantics --
    for flag, val in [("--ld-files", args.ld_files), ("--r-files", args.r_files),
                      ("--N", args.N), ("--M", args.M)]:
        if not val:
            raise SystemExit(f"{flag} is required")
    K = int(args.K)
    L = int(args.L)
    iterations = int(args.iterations)
    gamw = float(args.gamw)
    gam1 = float(args.gam1)
    rho = float(args.rho)
    lmmse_damp = bool(int(args.lmmse_damp))
    learn_gamw = bool(int(args.learn_gamw))
    cg_maxit = int(args.cg_maxit)
    s = float(args.s)
    prior_update = None if args.prior_update in (None, "none", "") else args.prior_update
    update_prior_from = int(args.update_prior_from)
    em_prior_maxit = int(args.em_prior_maxit)

    ld_paths = args.ld_files.split(",")
    r_paths = args.r_files.split(",")
    N_list = [int(n) for n in args.N.split(",")]
    M_list = [int(m) for m in args.M.split(",")]
    prior_vars = [float(x) for x in args.prior_vars.split(",")]
    prior_probs = [float(x) for x in args.prior_probs.split(",")]

    if len(ld_paths) != K:
        raise SystemExit("Specified number of cohorts is not equal to number of LD matrices provided!")
    if len(r_paths) != K:
        raise SystemExit("Specified number of cohorts is not equal to number of marginal estimates provided!")
    if len(prior_vars) != L:
        raise SystemExit("Number of prior variances must be L!")
    if len(prior_probs) != L:
        raise SystemExit("Number of prior mixture probabilites must be L!")
    if len(N_list) == 1 and K > 1:
        N_list = N_list * K
    if len(M_list) == 1 and K > 1:
        M_list = M_list * K

    for key, val in sorted(vars(args).items()):
        log.info(f"--{key.replace('_', '-')} {val}")
    log.info("")

    Nt = float(sum(N_list))
    a = np.asarray(N_list, dtype=np.float64) / Nt

    # -- device mesh --
    mesh = None
    own = slice(0, K)   # the cohorts whose operator this process holds
    if multi:
        # the cohort axis across the processes, --mesh-shard over each
        # process's own devices (its cards round-robin; the CPU under
        # --platform cpu)
        P = multihost.process_count()
        rows = max((args.mesh_cohort if args.mesh_cohort > 1 else P) // P, 1)
        local = ([device] if device.type == "cpu" else
                 [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
        n_local = rows * (args.mesh_shard or max(len(local) // rows, 1))
        mesh = multihost.make_multihost_mesh(
            args.mesh_cohort if args.mesh_cohort > 1 else None,
            devices=[local[i % len(local)] for i in range(n_local)])
        own = multihost.own_cohorts(K)
        log.info(f"Running on multi-host mesh {mesh.shape} over {P} processes")
    elif args.mesh_cohort > 1 or args.mesh_shard:
        from sgvamp_torch.parallel.sharding import make_mesh
        # the cards taken round-robin; under --platform cpu every cell is the
        # CPU. Without --mesh-shard the shard axis takes the devices the
        # cohort axis leaves, as in the JAX command line.
        on_cpu = device.type == "cpu"
        n_mesh = max(args.mesh_cohort, 1) * max(args.mesh_shard or 1, 1)
        n_dev = n_mesh if on_cpu else torch.cuda.device_count()
        n_shard = args.mesh_shard or max(n_dev // max(args.mesh_cohort, 1), 1)
        mesh = make_mesh(args.mesh_cohort, n_shard,
                         devices=[device] * n_mesh if on_cpu else None)
        log.info(f"Running on mesh {mesh.shape}")

    # -- harmonization: the reference panel of the cohorts' markers --
    with span("cli.load.bim") as sp:
        if args.bim_files:
            bim_paths = args.bim_files.split(",")
            out_bim = os.path.join(args.out_dir, args.out_name + ".bim") if args.out_dir else None
            if out_bim:
                os.makedirs(args.out_dir, exist_ok=True)
            panel = hz.harmonize(bim_paths, N_list, out_bim if owns_output else None)
        else:
            if len(set(M_list)) != 1:
                raise SystemExit("Without --bim-files all cohorts must share the same M")
            panel = hz.identity_panel(M_list[0], K)
        M = panel.M
        log.info(f"Total number of markers in reference is {M}")
    log.debug(f"Handling .bim files took {sp.seconds:.3f} seconds\n")

    # -- r vectors --
    with span("cli.load.r") as sp:
        rs = []
        for k in range(K):
            r_local = loaders.load_r(r_paths[k], M_list[k], N_list[k])
            rs.append(loaders.scatter_to_reference(r_local, panel.i_maps[k], M))
    log.debug(f"Loading r vectors took {sp.seconds:.3f} seconds\n")

    # -- LD matrices --
    with span("cli.load.R") as sp:
        B = args.block_size

        def cat_sym(ops):
            if len(ops) == 1:
                return ops[0]
            return SymBandedLD(
                upper=torch.cat([o.upper for o in ops], dim=0),
                scales=(torch.cat([o.scales for o in ops], dim=0)
                        if ops[0].scales is not None else None),
                packed=ops[0].packed, hybrid=ops[0].hybrid, s=s)

        # the quantized and bf16 storages round at block-pack time; the staged
        # band arrays stay float
        band_dtype = np.dtype(np.float64 if ld_dtype == "float64" else np.float32)
        all_ld_tables = all(p.endswith(".ld") for p in ld_paths)
        all_sparse = all(p.endswith((".ld", ".npz")) for p in ld_paths)
        if args.operator in ("banded", "sym") and all_sparse:
            # Band-direct ingestion: .ld triplets or sparse .npz -> symmetric
            # band storage -> block-banded operator, never materializing MxM.
            if all_ld_tables:
                bands, rs, bw, dropped = loaders.ld_files_to_bands(
                    ld_paths, rs, panel, args.bandwidth, dtype=band_dtype)
                band_views = list(bands)
                # the cross-cohort missing-SNP fill can make bands differ per
                # cohort even for identical paths: never share packs here
                pack_keys = list(range(K))
            else:
                # Each UNIQUE path is loaded, converted and block-packed once:
                # the shared-panel meta-analysis workflow lists one file once
                # per cohort.
                uniq = {}
                for p in ld_paths:
                    if p not in uniq:
                        log.info(f"LD file {p}:")
                        uniq[p] = loaders.csr_to_band(
                            loaders.load_R(p), args.bandwidth, dtype=band_dtype)
                dropped = sum(d for _, _, d in uniq.values())
                bw = max(w for _, w, _ in uniq.values())
                band_views = [uniq[p][0] for p in ld_paths]
                pack_keys = list(ld_paths)
                del uniq
            rs = np.stack(rs)
            if dropped:
                log.info(f"WARNING: {dropped} LD entries outside bandwidth {bw} dropped")
            ctor = SymBandedLD.from_band if args.operator == "sym" else BandedLD.from_band
            pack_cache = {}
            for k in range(own.start, own.stop):
                if pack_keys[k] not in pack_cache:
                    pack_cache[pack_keys[k]] = ctor(_pad_band(band_views[k], bw), block_size=B,
                                                    s=s, dtype=ld_dtype, device=device)
            del band_views
            ops = [pack_cache[key] for key in pack_keys[own]]
            del pack_cache
            if args.operator == "sym":
                op = cat_sym(ops)
            else:
                op = ops[0] if len(ops) == 1 else BandedLD(
                    blocks=torch.cat([o.blocks for o in ops], dim=0), s=s,
                    accum_dtype=ops[0].accum_dtype)
            del ops
            Mp = op.M
            pad = Mp - M
        else:
            vindex = {rs_: i for i, rs_ in enumerate(panel.variants)}
            Rs = []
            for p in ld_paths:
                log.info(f"LD file {p}:")
                Rs.append(loaders.load_R(p, vindex))
            if any(p.endswith(".ld") for p in ld_paths) and K > 1:
                # sparse-level fill: never materializes K M x M dense matrices
                Rs, rs = loaders.fill_missing_csr(Rs, rs, panel)
            rs = np.stack(rs)
            if args.operator == "blocksparse":
                # built from the CSRs directly: every entry of any sparsity
                # pattern is kept, without materializing M x M
                op = BlockSparseLD.from_csr([loaders.as_csr(R, M) for R in Rs], block_size=B,
                                            s=s, dtype=ld_dtype, M=M, device=device, cohorts=own)
                Mp = op.M
                pad = Mp - M
                log.info(f"Block-sparse LD: {op.nnzb} of {op.nb * op.nb} "
                         f"({op.B}x{op.B}) blocks stored")
            elif args.operator == "sym":
                # dense .npy (or mixed) inputs go through CSR, one per cohort: the
                # dense stack is never needed on this path
                bands, dropped = [], 0
                for R in Rs:
                    band_k, _, d_k = loaders.csr_to_band(R, args.bandwidth, dtype=band_dtype)
                    bands.append(band_k)
                    dropped += d_k
                bw = max((b.shape[1] - 1) // 2 for b in bands)
                if dropped:
                    log.info(f"WARNING: {dropped} LD entries outside bandwidth {bw} dropped")
                op = cat_sym([SymBandedLD.from_band(_pad_band(b, bw), block_size=B, s=s,
                                                    dtype=ld_dtype, device=device)
                              for b in bands[own]])
                del bands
                Mp = op.M
                pad = Mp - M
            elif args.operator == "banded":
                dense = loaders.to_dense_stack(Rs[own], M)
                bw = args.bandwidth
                if bw is None:
                    bw = max(loaders.estimate_bandwidth(R) for R in Rs)
                pad = (-M) % B
                if pad:
                    dense = np.pad(dense, ((0, 0), (0, pad), (0, pad)))
                    for i in range(pad):  # keep padded diagonal SPD
                        dense[:, M + i, M + i] = 1.0
                hb = -(-(bw + B - 1) // B)
                op = BandedLD.from_dense(dense, block_size=B, bandwidth_blocks=hb, s=s,
                                         dtype=ld_dtype, device=device)
                Mp = dense.shape[-1]
            else:
                dense = loaders.to_dense_stack(Rs[own], M)
                op = DenseLD(mats=torch.as_tensor(dense).to(device=device, dtype=_DTYPES[ld_dtype]),
                             s=s)
                pad, Mp = 0, M
        log.info(f"Loaded {K} LD matrices of shape ({M}, {M})")
    log.debug(f"Loading R matrices took {sp.seconds:.3f} seconds\n")

    # -- true signal (scaled by the first cohort's N) --
    x0 = None
    if args.true_signal_file:
        x0 = loaders.load_true_signal(args.true_signal_file, M, N_list[0])
        log.info(f"True signals loaded. Shape: {x0.shape}\n")

    # -- engine --
    cfg = VampConfig(
        rho=rho, cg_maxit=cg_maxit, cg_rtol=args.cg_rtol, learn_gamw=learn_gamw,
        lmmse_damp=lmmse_damp, prior_update=prior_update,
        update_prior_from=update_prior_from, em_prior_maxit=em_prior_maxit,
        dtype=dtype, rho_final=args.rho_final,
        rho_anneal_iters=args.rho_anneal_iters,
        cg_precond_block=args.cg_precond_block,
        cg_precond_dtype=args.cg_precond_dtype,
        clip_alpha1=bool(int(args.clip_alpha1)),
        clip_alpha2=bool(int(args.clip_alpha2)),
        gam_clamp=args.gam_clamp,
    )
    tdtype = cfg.torch_dtype
    pc = PriorConfig(vars_=tuple(prior_vars), probs=tuple(prior_probs))
    prior = PriorState.create(pc.init_lam(), pc.init_omegas(), pc.scaled_sigmas(Nt),
                              device=device)

    def dev(v):
        return torch.as_tensor(np.asarray(v)).to(device=device, dtype=tdtype)

    mask = None
    if pad:
        mask = dev(np.concatenate([np.ones(M), np.zeros(pad)]))
    inputs = VampInputs(
        op=op,
        r=dev(np.pad(rs, ((0, 0), (0, pad))) if pad else rs),
        a=dev(a),
        N=dev(N_list),
        mask=mask,
    )
    with span("cli.precond.eig"):
        engine = VampEngine(inputs, cfg, prior, gamw=gamw, gam1=gam1, mesh=mesh)

    ckpt = None
    state = None
    start_it = 0
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir)
        if bool(int(args.resume)):
            restored = ckpt.restore_latest(engine.init_state(args.seed))
            if restored is not None:
                state, start_it = restored
                log.info(f"Resumed from checkpoint at iteration {start_it}")

    writer = None
    if args.out_dir and owns_output:
        writer = OutputWriter(args.out_dir, args.out_name, K, append=start_it > 0)

    log.info("...Running sgVAMP\n")
    stop_tol = float(args.stop_tol)
    stop_drop = (float(args.stop_gam1_drop)
                 if bool(int(args.stop_on_divergence)) else 0.0)
    with device_trace(args.profile_dir, device), span("cli.infer") as sp:
        if bool(int(args.fused)):
            history = _fused_run(engine, iterations, writer, x0, Nt, M, args.seed,
                                 stop_tol, stop_drop, ckpt=ckpt, every=args.checkpoint_every,
                                 state=state, start_it=start_it)
        else:
            cb = None if ckpt is None else (lambda it, st, aux: ckpt.save(st, it + 1))
            history = engine.run(
                iterations - start_it, state=state, writer=writer, x0=x0, Nt=Nt,
                seed=args.seed, callback=cb, M_out=M, it0=start_it,
                stop_tol=stop_tol, stop_gam1_drop=stop_drop,
            )
    log.info(f"sgVAMP inference running time: {sp.seconds:0.4f}s\n")
    log.debug(profiling.report())
    if history.get("stopped_at") is not None:
        log.info(f"Early stop at iteration {history['stopped_at']} "
                 f"({history['stop_reason']}); best iterate: "
                 f"iteration {history.get('best_it')}\n")
    # Persist the monitor-selected iterate (xhat1 at the running gam1 peak)
    # whenever a stop criterion is armed: the deliverable of an
    # early-stopped run is a file, not a metrics-CSV row.
    best_x = history.get("best_xhat1")
    if writer is not None and best_x is not None and (stop_tol > 0 or stop_drop > 0):
        best_path = os.path.join(args.out_dir, f"{args.out_name}_xhat_best.bin")
        # same 1/sqrt(Nt) scale as the per-iteration xhat bins
        write_bin(best_path,
                  np.asarray(best_x)[:M] * (1.0 / np.sqrt(Nt) if Nt else 1.0))
        log.info(f"Selected iterate (iteration {history.get('best_it')}) "
                 f"written to {best_path}\n")

    # -- post-hoc metrics --
    if x0 is not None and history.get("xhat1"):
        x0v = x0.squeeze()
        aligns, l2s = [], []
        for xh in history["xhat1"]:
            al, l2 = alignment_l2(xh[:M], x0v)
            aligns.append(al)
            l2s.append(l2)
        log.info(f"Alignment(x1hat, x0) over iterations: \n {aligns}\n")
        log.info(f"L2 error(x1hat, x0) over iterations: \n {l2s}\n")
        bi = history.get("best_it", -1)
        if bi is not None and 0 <= bi - start_it < len(aligns):
            log.info(f"Selected iterate (gam1 peak): iteration {bi}, "
                     f"alignment {aligns[bi - start_it]:0.6f}, "
                     f"L2 {l2s[bi - start_it]:0.6f}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
