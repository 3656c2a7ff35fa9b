"""Post-run plotting: a 5-panel figure (l2, alignment, gam1, gam2, lam)
from the cohort-parameter and metrics CSVs that cli.main writes.

A copy of sgvamp_tpu/cli/plots.py, with the same flags; matplotlib (Agg
backend) is imported only when main() runs, so the package imports
without it."""

from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Plot sgVAMP hyperparameters and metrics")
    p.add_argument("-csv_params", "--csv-params", help="Path to cohort CSV file", required=True)
    p.add_argument("-csv_metrics", "--csv-metrics", help="Path to metrics CSV file", required=True)
    p.add_argument("-out_name", "--out-name", help="Output file name", required=True)
    return p


def read_params(path: str) -> dict:
    cols = {"it": [], "gamw": [], "gam1": [], "gam2": [],
            "alpha1": [], "alpha2": [], "lam": []}
    with open(path) as f:
        reader = csv.reader(f, delimiter="\t")
        next(reader, None)
        for row in reader:
            cols["it"].append(int(row[0]))
            for i, k in enumerate(["gamw", "gam1", "gam2", "alpha1", "alpha2", "lam"]):
                cols[k].append(float(row[i + 1]))
    return cols


def read_metrics(path: str) -> dict:
    out = {"alignment": [], "l2": []}
    with open(path) as f:
        reader = csv.reader(f, delimiter="\t")
        next(reader, None)
        for row in reader:
            out["alignment"].append(float(row[1]))
            out["l2"].append(float(row[2]))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    params = read_params(args.csv_params)
    metrics = read_metrics(args.csv_metrics)
    out_dir = os.path.dirname(args.csv_metrics)

    plt.rcParams.update({"font.size": 15})
    fig, ax = plt.subplots(5, figsize=(12, 10), dpi=300)
    ax[0].plot(metrics["l2"], "-o")
    ax[1].plot(metrics["alignment"], "-o")
    ax[2].plot(params["gam1"], "-o", label="gam1")
    ax[3].plot(params["gam2"], "-o", label="gam2")
    ax[4].plot(params["lam"], "-o", label="lam")
    for a, lbl in zip(ax, ["L2_err(xhat1,x0)", "Align(xhat1,x0)", "gam1", "gam2", "lam"]):
        a.set_ylabel(lbl)
    ax[3].set_xlabel("iteration")
    fig.tight_layout()
    out_fpath = os.path.join(out_dir, args.out_name + ".png")
    print("...saving to file", out_fpath)
    fig.savefig(out_fpath)
    return 0


if __name__ == "__main__":
    sys.exit(main())
