"""sgVAMP command line (PyTorch port of sgvamp_tpu/cli/main.py).

The same flags, defaults and value semantics as the JAX command line, so an
invocation ports by changing the module name. All K cohorts run inside one
process on one device: a CUDA GPU unless --platform cpu is given.

Ported: --operator dense, --operator banded (float storage) and
--operator sym with --ld-dtype float64, float32, bfloat16, int8, int4 or
hybrid; .npz / .npy LD inputs; the host loop with the block-Jacobi
preconditioner, the StopMonitor and reference-format output files.
--operator sym leaves the operator's mode at "auto", so float storage
runs the resident kernel where its run fits a CTA's shared memory. Not
ported yet: --operator blocksparse, the sharded run (--mesh-*, the
multi-host flags), --fused, checkpoints, --prior-update mle, .ld tables
and --bim-files, --profile-dir. Each is rejected with a message that
names the flag and its ROADMAP item; none is silently ignored.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
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
    g.add_argument("--profile-dir", help="Write a device trace of the run here", default=None)
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
    """SystemExit for every flag whose code is not ported, naming it."""
    def no(flag: str, item: str) -> None:
        raise SystemExit(f"{flag} is not ported to sgvamp_torch yet ({item})")

    if args.platform not in (None, "cuda", "cpu"):
        raise SystemExit(f"--platform {args.platform} is not supported by "
                         "sgvamp_torch: use cuda (the default) or cpu")
    if args.mesh_cohort > 1:
        no("--mesh-cohort > 1", "ROADMAP A14, multi-GPU")
    if args.mesh_shard:
        no("--mesh-shard", "ROADMAP A14, multi-GPU")
    for flag, val in (("--coordinator-address", args.coordinator_address),
                      ("--num-processes", args.num_processes),
                      ("--process-id", args.process_id)):
        if val is not None:
            no(flag, "ROADMAP A14, multi-GPU")
    if bool(int(args.fused)):
        no("--fused 1", "ROADMAP A12, fused runs")
    if args.checkpoint_dir:
        no("--checkpoint-dir", "ROADMAP A9, checkpoint and resume")
    if bool(int(args.resume)):
        no("--resume", "ROADMAP A9, checkpoint and resume")
    if args.prior_update == "mle":
        no("--prior-update mle", "ROADMAP A11, MLE prior learning")
    if args.operator == "blocksparse":
        no("--operator blocksparse", "ROADMAP A, BlockSparseLD")
    if args.bim_files:
        no("--bim-files", "ROADMAP A, .bim harmonization without pandas")
    if args.ld_files and any(p.endswith(".ld") for p in args.ld_files.split(",")):
        no(".ld input in --ld-files", "ROADMAP A, PLINK .ld tables without pandas")
    if args.profile_dir:
        no("--profile-dir", "ROADMAP A15, tooling")


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    logging.basicConfig(format="%(message)s", level=logging.DEBUG)
    log = logging.getLogger("sgvamp")
    log.info(" ### VAMP for summary statistics (PyTorch/CUDA) ###\n")

    _reject_unported(args)

    import torch

    from sgvamp_torch import default_device
    from sgvamp_torch.config import _DTYPES, PriorConfig, VampConfig
    from sgvamp_torch.core.operators import BandedLD, DenseLD
    from sgvamp_torch.core.prior import PriorState
    from sgvamp_torch.core.vamp import VampEngine, VampInputs, alignment_l2
    from sgvamp_torch.data import harmonize as hz
    from sgvamp_torch.data import loaders
    from sgvamp_torch.io.writers import OutputWriter, write_bin
    from sgvamp_torch.ops.band_kernel import SymBandedLD
    from sgvamp_torch.utils.profiling import PhaseTimers

    device = torch.device("cpu") if args.platform == "cpu" else default_device()
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

    timers = PhaseTimers()

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

    # -- the marker panel (no .bim files: all cohorts share it) --
    ts = time.time()
    timers.start("load/bim")
    if len(set(M_list)) != 1:
        raise SystemExit("Without --bim-files all cohorts must share the same M")
    panel = hz.identity_panel(M_list[0], K)
    M = panel.M
    log.info(f"Total number of markers in reference is {M}")
    timers.stop("load/bim")
    log.debug(f"Handling .bim files took {time.time() - ts:.3f} seconds\n")

    # -- r vectors --
    ts = time.time()
    timers.start("load/r")
    rs = []
    for k in range(K):
        r_local = loaders.load_r(r_paths[k], M_list[k], N_list[k])
        rs.append(loaders.scatter_to_reference(r_local, panel.i_maps[k], M))
    rs = np.stack(rs)
    timers.stop("load/r")
    log.debug(f"Loading r vectors took {time.time() - ts:.3f} seconds\n")

    # -- LD matrices --
    ts = time.time()
    timers.start("load/R")
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
    if args.operator in ("banded", "sym") and all(p.endswith(".npz") for p in ld_paths):
        # Band-direct ingestion: sparse .npz -> symmetric band storage ->
        # block-banded operator, never materializing MxM. Each UNIQUE path
        # is loaded, converted and block-packed once: the shared-panel
        # meta-analysis workflow lists one file once per cohort.
        uniq = {}
        for p in ld_paths:
            if p not in uniq:
                uniq[p] = loaders.csr_to_band(
                    loaders.load_R(p), args.bandwidth, dtype=band_dtype)
        dropped = sum(d for _, _, d in uniq.values())
        bw = max(w for _, w, _ in uniq.values())
        if dropped:
            log.info(f"WARNING: {dropped} LD entries outside bandwidth {bw} dropped")
        ctor = SymBandedLD.from_band if args.operator == "sym" else BandedLD.from_band
        pack_cache = {}
        for p in uniq:
            pack_cache[p] = ctor(_pad_band(uniq[p][0], bw), block_size=B, s=s,
                                 dtype=ld_dtype, device=device)
        del uniq
        ops = [pack_cache[p] for p in ld_paths]
        del pack_cache
        if args.operator == "sym":
            op = cat_sym(ops)
        else:
            op = ops[0] if K == 1 else BandedLD(
                blocks=torch.cat([o.blocks for o in ops], dim=0), s=s,
                accum_dtype=ops[0].accum_dtype)
        del ops
        Mp = op.M
        pad = Mp - M
    elif args.operator == "sym":
        # dense .npy (or mixed) inputs go through CSR, one per cohort: the
        # dense stack is never needed on this path
        bands, dropped = [], 0
        for p in ld_paths:
            band_k, _, d_k = loaders.csr_to_band(
                loaders.load_R(p), args.bandwidth, dtype=band_dtype)
            bands.append(band_k)
            dropped += d_k
        bw = max((b.shape[1] - 1) // 2 for b in bands)
        if dropped:
            log.info(f"WARNING: {dropped} LD entries outside bandwidth {bw} dropped")
        op = cat_sym([SymBandedLD.from_band(_pad_band(b, bw), block_size=B, s=s,
                                            dtype=ld_dtype, device=device)
                      for b in bands])
        del bands
        Mp = op.M
        pad = Mp - M
    elif args.operator == "banded":
        Rs = [loaders.load_R(p) for p in ld_paths]
        dense = loaders.to_dense_stack(Rs, M)
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
        dense = loaders.to_dense_stack([loaders.load_R(p) for p in ld_paths], M)
        op = DenseLD(mats=torch.as_tensor(dense).to(device=device, dtype=_DTYPES[ld_dtype]),
                     s=s)
        pad, Mp = 0, M
    log.info(f"Loaded {K} LD matrices of shape ({M}, {M})")
    timers.stop("load/R")
    log.debug(f"Loading R matrices took {time.time() - ts:.3f} seconds\n")

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
    with timers.phase("precond/eig"):
        engine = VampEngine(inputs, cfg, prior, gamw=gamw, gam1=gam1)

    writer = None
    if args.out_dir:
        writer = OutputWriter(args.out_dir, args.out_name, K)

    log.info("...Running sgVAMP\n")
    stop_tol = float(args.stop_tol)
    stop_drop = (float(args.stop_gam1_drop)
                 if bool(int(args.stop_on_divergence)) else 0.0)
    ts = time.time()
    with timers.phase("infer"):
        history = engine.run(
            iterations, writer=writer, x0=x0, Nt=Nt, seed=args.seed, M_out=M,
            stop_tol=stop_tol, stop_gam1_drop=stop_drop,
        )
    log.info(f"sgVAMP inference running time: {time.time() - ts:0.4f}s\n")
    log.debug(timers.report())
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
        if bi is not None and 0 <= bi < len(aligns):
            log.info(f"Selected iterate (gam1 peak): iteration {bi}, "
                     f"alignment {aligns[bi]:0.6f}, "
                     f"L2 {l2s[bi]:0.6f}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
