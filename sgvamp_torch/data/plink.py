"""PLINK output converters (the counterpart of sgvamp_tpu/data/plink.py,
without pandas): the BETA column of a .assoc.linear file to .npy, and a .ld
table to a symmetric unit-diagonal CSR .npz through the same .ld reader
and triplets_to_csr as the .ld runtime loader."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse

from sgvamp_torch.data.harmonize import typed_column
from sgvamp_torch.data.loaders import load_ld_table, read_column, triplets_to_csr


def linear_to_npy(linear_path: str, out_path: str | None = None) -> Tuple[str, np.ndarray]:
    """Extract the BETA column of a .assoc.linear file to .npy (NA -> NaN)."""
    r = typed_column(read_column(linear_path, "BETA"))
    out = out_path or linear_path.split(".assoc.linear")[0] + ".npy"
    np.save(out, r)
    return out, r


def ld_to_npz(ld_path: str, linear_path: str, out_path: str | None = None) -> str:
    """Convert a PLINK .ld table to a symmetric unit-diagonal CSR .npz,
    indexing SNPs by the .linear file's SNP order."""
    snps = read_column(linear_path, "SNP")
    idx = {rs: i for i, rs in enumerate(snps)}
    rows, cols, vals = load_ld_table(ld_path, idx)
    R = triplets_to_csr(rows, cols, vals, len(snps))
    out = out_path or ld_path.split(".ld")[0] + ".npz"
    scipy.sparse.save_npz(out, R, compressed=True)
    return out
