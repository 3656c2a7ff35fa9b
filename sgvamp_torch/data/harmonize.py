"""SNP harmonization across cohorts from PLINK .bim files, without pandas
(the counterpart of sgvamp_tpu/data/harmonize.py).

K .bim files are merged into one reference panel: an outer join on the
variant ID, the union sorted by ID, then by coordinate with numpy's
quicksort (which, as the JAX package's DataFrame sort, is not stable: ties
keep no particular order); per-cohort maps from local to reference index;
for each SNP a cohort lacks, the cohort that supplies its data. The
merged .bim is written as the JAX package writes it: a numeric column that
the merge left with a gap is float64 there, so its integers come out as
"2.0".

A table is a dict of columns, each a numpy array of dtype int64, float64
or object (str, with float NaN where a value is missing), typed as the
JAX package's reader types them: a column of integers is int64, of numbers
float64, anything else object.

Without .bim files all cohorts share the same M markers in the same order
(identity_panel).
"""

from __future__ import annotations

import csv
import dataclasses
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

BIM_COLUMNS = ["Chromosome", "Variant", "Position", "Coordinate", "Allele1", "Allele2"]

# the tokens a delimited-text reader takes for a missing value
NA_TOKENS = frozenset(["", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None",
                       "n/a", "nan", "null"])
_INT = re.compile(r"[+-]?\d+\Z")
_FLOAT = re.compile(r"[+-]?((\d+\.?\d*|\.\d+)([eE][+-]?\d+)?|inf|infinity)\Z", re.I)

Table = Dict[str, np.ndarray]


@dataclasses.dataclass
class HarmonizedPanel:
    """Result of cross-cohort SNP harmonization.

    variants:  reference variant list (length M), coordinate-sorted.
    M:         reference panel size.
    bim_ref:   the merged .bim in reference order: BIM_COLUMNS -> arrays of
               the strings written to its file ({} without .bim files).
    i_maps:    per-cohort local->reference index arrays.
    sources:   per-cohort (M,) int arrays: for each reference SNP, the
               cohort that supplies its data for this cohort - itself when
               present locally, else the holder cohort with the largest N.
    missing:   per-cohort arrays of reference indices absent locally.
    """

    variants: List[str]
    M: int
    bim_ref: Dict[str, np.ndarray]
    i_maps: List[np.ndarray]
    sources: List[np.ndarray]
    missing: List[np.ndarray]


def typed_column(tokens: Sequence[str]) -> np.ndarray:
    """A column of text fields as the JAX package's reader types it: int64
    when every field is an integer, float64 when every field is a number or
    missing (NaN), else object (the strings, NaN where missing)."""
    na = np.fromiter((t in NA_TOKENS for t in tokens), bool, len(tokens))
    if not na.any() and all(_INT.match(t) for t in tokens):
        return np.array([int(t) for t in tokens], np.int64)
    if all(n or _FLOAT.match(t) for t, n in zip(tokens, na)):
        return np.array([np.nan if n else float(t) for t, n in zip(tokens, na)], np.float64)
    out = np.empty(len(tokens), object)
    out[:] = [np.nan if n else t for t, n in zip(tokens, na)]
    return out


def read_bim(path: str) -> Table:
    """A .bim file (six whitespace-separated columns, no header, blank lines
    skipped) as a table of BIM_COLUMNS."""
    with open(path) as f:
        rows = [line.split() for line in f]
    rows = [r for r in rows if r]
    for n, r in enumerate(rows, start=1):
        if len(r) != len(BIM_COLUMNS):
            raise ValueError(f"{path}: record {n} has {len(r)} fields, a .bim has "
                             f"{len(BIM_COLUMNS)}")
    cols = list(zip(*rows)) if rows else [()] * len(BIM_COLUMNS)
    table = {name: typed_column(list(c)) for name, c in zip(BIM_COLUMNS, cols)}
    variant = np.empty(len(rows), object)
    variant[:] = [r[1] for r in rows]
    table["Variant"] = variant   # IDs stay strings, whatever they look like
    return table


def _missing(col: np.ndarray) -> np.ndarray:
    if col.dtype == object:
        return np.fromiter((isinstance(v, float) and v != v for v in col), bool, col.size)
    if col.dtype.kind == "f":
        return np.isnan(col)
    return np.zeros(col.size, bool)


def _take(col: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """col[idx] where idx >= 0, missing where idx is -1: an integer column
    that gains a gap becomes float64."""
    gap = idx < 0
    if not gap.any():
        return col[idx]
    if col.dtype == object:
        out = np.empty(idx.size, object)
        out[:] = np.nan
    else:
        out = np.full(idx.size, np.nan, np.float64)
    out[~gap] = col[idx[~gap]]
    return out


def _fill(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """left with its missing values taken from right: float64 stays float64
    when right is numeric; a mix with strings becomes object."""
    gap = _missing(left)
    if not gap.any():
        return left
    if left.dtype != object and right.dtype != object:
        out = left.astype(np.float64)
        out[gap] = right[gap]
        return out
    out = np.empty(left.size, object)
    out[:] = left.tolist()
    out[gap] = right[gap].tolist()
    return out


def _merge(left: Table, right: Table) -> Table:
    """Outer join of two tables on Variant, the union of IDs in sorted
    order; a column missing on the left is filled from the right's."""
    for t in (left, right):
        ids = t["Variant"]
        if len(set(ids)) != ids.size:
            raise ValueError("a .bim file lists a variant ID twice: the panels cannot be "
                             "merged on their IDs")
    keys = np.array(sorted(set(left["Variant"]) | set(right["Variant"])), object)

    def positions(t):
        where = {v: i for i, v in enumerate(t["Variant"])}
        return np.array([where.get(v, -1) for v in keys], np.int64)

    li, ri = positions(left), positions(right)
    out = {"Variant": keys}
    for name in BIM_COLUMNS:
        if name != "Variant":
            out[name] = _fill(_take(left[name], li), _take(right[name], ri))
    return out


def _text(col: np.ndarray) -> np.ndarray:
    """A column as the strings its file holds: integers as integers, floats
    in their shortest round-trip form, missing values empty."""
    gap = _missing(col)
    if col.dtype.kind == "f":
        out = col.astype(str).astype(object)
    else:
        out = np.empty(col.size, object)
        out[:] = [repr(v) if isinstance(v, float) else str(v) for v in col.tolist()]
    out[gap] = ""
    return out


def harmonize(
    bim_paths: Sequence[str],
    N_list: Sequence[float],
    out_bim_path: Optional[str] = None,
) -> HarmonizedPanel:
    """Merge K cohort .bim files into a reference panel: an outer join on
    Variant, then a sort by Coordinate; the merged .bim is optionally
    written (tab-separated, no header)."""
    K = len(bim_paths)
    bims = [read_bim(p) for p in bim_paths]
    ref = bims[0]
    for k in range(1, K):
        ref = _merge(ref, bims[k])
    # the rows with a coordinate in quicksort order, those without last
    coord = ref["Coordinate"]
    gap = _missing(coord)
    rows = np.arange(coord.size)
    order = np.concatenate([rows[~gap][coord[~gap].argsort(kind="quicksort")], rows[gap]])
    ref = {name: col[order] for name, col in ref.items()}
    variants = list(ref["Variant"])
    M = len(variants)
    bim_ref = {name: _text(ref[name]) for name in BIM_COLUMNS}
    if out_bim_path is not None:
        with open(out_bim_path, "w", newline="") as f:
            w = csv.writer(f, delimiter="\t", lineterminator="\n",
                           quoting=csv.QUOTE_MINIMAL)
            w.writerows(zip(*(bim_ref[name] for name in BIM_COLUMNS)))

    idx: Dict[str, int] = {rs: i for i, rs in enumerate(variants)}
    N_arr = np.asarray(N_list, dtype=np.float64)

    # One (K, M) presence table and a masked argmax give each missing SNP
    # its source: the largest-N cohort that holds it, the first on ties.
    i_maps = [np.array([idx[v] for v in bims[k]["Variant"]], np.int64) for k in range(K)]
    present = np.zeros((K, M), dtype=bool)
    for k in range(K):
        present[k, i_maps[k]] = True

    sources, missing = [], []
    for k in range(K):
        source = np.full(M, k, dtype=np.int64)
        miss = np.flatnonzero(~present[k])
        if miss.size:
            scores = np.where(present[:, miss], N_arr[:, None], -np.inf)
            source[miss] = np.argmax(scores, axis=0)
        sources.append(source)
        missing.append(miss.astype(np.int64))
    return HarmonizedPanel(variants=variants, M=M, bim_ref=bim_ref, i_maps=i_maps,
                           sources=sources, missing=missing)


def identity_panel(M: int, K: int) -> HarmonizedPanel:
    """Trivial panel when no .bim files are given: all cohorts share the
    same M markers in the same order."""
    i_map = np.arange(M, dtype=np.int64)
    return HarmonizedPanel(
        variants=[f"snp{i}" for i in range(M)],
        M=M,
        bim_ref={},
        i_maps=[i_map.copy() for _ in range(K)],
        sources=[np.full(M, k, dtype=np.int64) for k in range(K)],
        missing=[np.empty(0, dtype=np.int64) for _ in range(K)],
    )
