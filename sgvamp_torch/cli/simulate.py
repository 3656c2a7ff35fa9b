"""Simulation CLI: test data for the sgVAMP command line, as sub-commands:

  gen-phen       single cohort, dense genotypes: {out}_{phen,bet,r,R}.npy
  gen-phen-mult  K cohorts sharing one beta (--K, default 2), fresh dense
                 genotypes per cohort: {out}_bet.npy and
                 {out}_{i}_{phen,r,R}.npy for i = 0..K-1
  phen           a phenotype over real PLINK .bed genotypes (--bed; N comes
                 from the .fam file): {out}_{phen,bet,r}.npy, no R
  gen-band       biobank-scale banded LD panel at any M (never materializes
                 MxM), written as files cli.main ingests: {out}_R.npz sparse
                 CSR, {out}_r.npy, {out}_bet.npy

The same seed writes the same files as sgvamp_tpu.cli.simulate.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

from sgvamp_torch.data import simulate as sim


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Simulate data for sgVAMP")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, with_bed=False, with_K=False):
        if with_bed:
            sp.add_argument("-bed", "--bed", help="Path to bed file", required=True)
        sp.add_argument("-out", "--out", help="Output path", required=True)
        sp.add_argument("-N", "--N", help="Number of samples", required=not with_bed)
        sp.add_argument("-M", "--M", help="Number of markers", required=True)
        sp.add_argument("-h2", "--h2", help="Heritability", default=0.8)
        sp.add_argument("-lam", "--lam", help="Sparsity (lambda)", default=0.5)
        if with_K:
            sp.add_argument("-K", "--K", help="Number of cohorts", default=2)
        sp.add_argument("--seed", help="RNG seed", type=int, default=None)

    common(sub.add_parser("gen-phen", help="single-cohort synthetic genotypes"))
    common(sub.add_parser("gen-phen-mult", help="multi-cohort, shared signal"),
           with_K=True)
    common(sub.add_parser("phen", help="phenotype over real .bed genotypes"),
           with_bed=True)
    gb = sub.add_parser("gen-band",
                        help="biobank-scale banded LD panel (sparse .npz)")
    common(gb)
    gb.add_argument("--bandwidth", type=int, default=256,
                    help="LD band half-width (elements)")
    gb.add_argument("--strength", type=float, default=0.6,
                    help="off-diagonal correlation mass (4.0 ~ dense "
                    "genotyping-panel conditioning)")
    gb.add_argument("--decay", type=float, default=0.85)
    gb.add_argument("--K", type=int, default=1,
                    help="cohorts: K r-vectors (independent noise draws "
                    "over the shared panel), written {out}_{k}_r.npy")
    gb.add_argument("--uncompressed", action="store_true",
                    help="write the CSR .npz without zlib (a larger file "
                    "that loads faster)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    rng = np.random.default_rng(args.seed)
    M = int(args.M)
    h2, lam = float(args.h2), float(args.lam)

    if args.cmd == "gen-phen":
        d = sim.simulate_single(int(args.N), M, h2, lam, rng)
        np.save(args.out + "_phen.npy", d.y)
        np.save(args.out + "_bet.npy", d.beta.reshape(M, 1))
        np.save(args.out + "_r.npy", d.r)
        np.save(args.out + "_R.npy", d.R)
        print(f"wrote {args.out}_{{phen,bet,r,R}}.npy  "
              f"(Var(g)={np.var(d.y - 0):.3f} target h2={h2})")
    elif args.cmd == "gen-phen-mult":
        ds = sim.simulate_multi(int(args.N), M, int(args.K), h2, lam, rng)
        np.save(args.out + "_bet.npy", ds[0].beta.reshape(M, 1))
        for i, d in enumerate(ds):
            np.save(f"{args.out}_{i}_phen.npy", d.y)
            np.save(f"{args.out}_{i}_r.npy", d.r)
            np.save(f"{args.out}_{i}_R.npy", d.R)
        print(f"wrote {args.out}_bet.npy and per-cohort files for K={args.K}")
    elif args.cmd == "gen-band":
        import scipy.sparse as sp

        bw = int(args.bandwidth)
        N = int(args.N)
        K = int(args.K)
        band, r, x0 = sim.simulate_ld_band(
            N, M, bw, h2=h2, lam=lam, rng=rng, dtype=np.float32,
            strength=float(args.strength), decay=float(args.decay), n_r=K)
        # band -> symmetric CSR per diagonal, without touching M x M dense
        offs = list(range(-bw, bw + 1))
        R = sp.diags(
            [band[:M - d, bw + d] if d >= 0 else band[-d:, bw + d]
             for d in offs],
            offs, shape=(M, M), format="csr", dtype=np.float32)
        sp.save_npz(args.out + "_R.npz", R, compressed=not args.uncompressed)
        # x0 = sqrt(N) * beta in engine scale; the file carries beta, and
        # cli.main's load_true_signal multiplies by sqrt(N) again
        np.save(args.out + "_bet.npy",
                (np.asarray(x0, np.float64) / np.sqrt(N)).reshape(M, 1))
        r2d = np.atleast_2d(r)
        if K > 1:
            for k in range(K):
                np.save(f"{args.out}_{k}_r.npy", r2d[k])
            rname = f"{args.out}_{{0..{K - 1}}}_r.npy"
        else:
            np.save(args.out + "_r.npy", r2d[0])
            rname = f"{args.out}_r.npy"
        print(f"wrote {args.out}_R.npz ({R.nnz} nnz), {rname}, "
              f"{args.out}_bet.npy  (matched prior: "
              f"--prior-probs {1 - lam:g},{lam:g} --prior-vars "
              f"0,{h2 / max(int(M * lam), 1):.6g})")
    elif args.cmd == "phen":
        d = sim.simulate_from_bed(args.bed, M, h2, lam, rng)
        np.save(args.out + "_phen.npy", d.y)
        np.save(args.out + "_bet.npy", d.beta.reshape(M, 1))
        np.save(args.out + "_r.npy", d.r)
        print(f"wrote {args.out}_{{phen,bet,r}}.npy")
    return 0


if __name__ == "__main__":
    sys.exit(main())
