"""Reference-format output writers (a copy of sgvamp_tpu/io/writers.py).

  * {out}_cohort_{k}.csv  tab-delimited, header
    [it, gamw, gam1, gam2, alpha1, alpha2, lam]
  * {out}_metrics.csv     tab-delimited, header [it, alignment, l2]
  * {out}_xhat_it_{it}.bin        little-endian float64
  * {out}_r1_cohort_{k}_it_{it}.bin  little-endian float64
"""

from __future__ import annotations

import csv
import os
from typing import Sequence

import numpy as np

PARAMS_HEADER = ["it", "gamw", "gam1", "gam2", "alpha1", "alpha2", "lam"]
METRICS_HEADER = ["it", "alignment", "l2"]


class OutputWriter:
    def __init__(self, out_dir: str, out_name: str, K: int,
                 append: bool = False) -> None:
        """`append=True` (resume) keeps existing CSVs and only creates
        headers for files that do not exist yet."""
        self.out_dir = out_dir
        self.out_name = out_name
        self.K = K
        os.makedirs(out_dir, exist_ok=True)
        for k in range(K):
            path = self._cohort_path(k)
            if not (append and os.path.exists(path)):
                self._write_row(path, PARAMS_HEADER, mode="w")
        if not (append and os.path.exists(self.metrics_path)):
            self._write_row(self.metrics_path, METRICS_HEADER, mode="w")

    def _cohort_path(self, cohort_idx: int) -> str:
        # cohort files are 1-indexed
        return os.path.join(self.out_dir, f"{self.out_name}_cohort_{cohort_idx + 1}.csv")

    @property
    def metrics_path(self) -> str:
        return os.path.join(self.out_dir, f"{self.out_name}_metrics.csv")

    def xhat_path(self, it: int) -> str:
        return os.path.join(self.out_dir, f"{self.out_name}_xhat_it_{it}.bin")

    def r1_path(self, it: int, k: int) -> str:
        return os.path.join(self.out_dir, f"{self.out_name}_r1_cohort_{k}_it_{it}.bin")

    def _write_row(self, path: str, row: Sequence, mode: str = "a") -> None:
        with open(path, mode, newline="") as f:
            csv.writer(f, delimiter="\t").writerow(row)

    def write_params(self, params: Sequence, cohort_idx: int) -> None:
        self._write_row(self._cohort_path(cohort_idx), params)

    def write_metrics(self, metrics: Sequence) -> None:
        self._write_row(self.metrics_path, metrics)

    def write_xhat(self, it: int, xhat: np.ndarray) -> None:
        write_bin(self.xhat_path(it), xhat)

    def write_r1(self, it: int, r1: np.ndarray, k: int) -> None:
        write_bin(self.r1_path(it, k), r1)


def write_bin(path: str, x: np.ndarray) -> None:
    """Write a vector as packed little-endian float64 (reference format)."""
    np.asarray(x).squeeze().astype("<f8").tofile(path)


def read_bin(path: str, M: int | None = None) -> np.ndarray:
    """Read a reference-format binary vector."""
    x = np.fromfile(path, dtype="<f8")
    if M is not None:
        x = x[:M]
    return x
