"""The marker panel shared by the cohorts (the part of
sgvamp_tpu/data/harmonize.py that needs no .bim files).

Without .bim files all cohorts share the same M markers in the same order
(identity_panel). Merging cohort .bim files into a reference panel is not
ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class HarmonizedPanel:
    """Result of cross-cohort SNP harmonization.

    variants:  reference variant list (length M).
    M:         reference panel size.
    i_maps:    per-cohort local->reference index arrays.
    sources:   per-cohort (M,) int arrays: for each reference SNP, the
               cohort that supplies its data for this cohort.
    missing:   per-cohort arrays of reference indices absent locally.
    """

    variants: List[str]
    M: int
    i_maps: List[np.ndarray]
    sources: List[np.ndarray]
    missing: List[np.ndarray]


def identity_panel(M: int, K: int) -> HarmonizedPanel:
    """Trivial panel when no .bim files are given: all cohorts share the
    same M markers in the same order."""
    i_map = np.arange(M, dtype=np.int64)
    return HarmonizedPanel(
        variants=[f"snp{i}" for i in range(M)],
        M=M,
        i_maps=[i_map.copy() for _ in range(K)],
        sources=[np.full(M, k, dtype=np.int64) for k in range(K)],
        missing=[np.empty(0, dtype=np.int64) for _ in range(K)],
    )
