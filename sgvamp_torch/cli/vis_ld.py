"""LD-matrix heatmap: |R| of a .npz (sparse) or .npy LD file as
{out_dir}/{file's base name}.png.

A copy of sgvamp_tpu/cli/vis_ld.py, with the same flags; matplotlib (Agg
backend) is imported only when main() runs, so the package imports
without it."""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import scipy.sparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Visualize an LD matrix")
    p.add_argument("-ld_file", "--ld-file", help="Path to LD matrix", required=True)
    p.add_argument("-ld_format", "--ld-format", help="npy or npz", default="npz")
    p.add_argument("-out_dir", "--out-dir", help="Output directory", required=True)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if args.ld_format == "npz":
        R = scipy.sparse.load_npz(args.ld_file).toarray()
    elif args.ld_format == "npy":
        # an archive saved by np.savez holds the matrix as "arr_0"; a plain
        # .npy loads directly
        loaded = np.load(args.ld_file)
        R = loaded["arr_0"] if hasattr(loaded, "files") else loaded
    else:
        raise SystemExit("Unsupported LD format!")

    fig, ax = plt.subplots(1)
    t = ax.imshow(np.abs(R))
    fig.colorbar(t)
    base = os.path.basename(args.ld_file).split(".")[0]
    out_fpath = os.path.join(args.out_dir, base + ".png")
    print("...Saving LD matrix figure to file", out_fpath)
    fig.savefig(out_fpath)
    return 0


if __name__ == "__main__":
    sys.exit(main())
