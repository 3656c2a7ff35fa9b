"""Host-side loaders for summary statistics: r vectors, LD matrices, true
signals and the cross-cohort missing-SNP fill (numpy, scipy and the host
C++ of sgvamp_torch.native; the counterpart of sgvamp_tpu/data/loaders.py).

  r:  .txt (loadtxt), .npy, PLINK .linear (BETA column, NaN->0, *sqrt(N))
  R:  sparse .npz, dense .npy, PLINK .ld table (SNP_A, SNP_B, R ->
      symmetric matrix with unit diagonal)
  x0: .bin packed doubles or .npy, both *sqrt(N)

The .ld parser, the CSR -> band pass and the triplet -> band assembly run
through the native library where it builds, else through their numpy
versions here (parse_ld_numpy, csr_to_band_numpy, triplets_to_band_numpy),
which give the same bits. Each logs which path it took.
"""

from __future__ import annotations

import logging
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse

from sgvamp_torch import native
from sgvamp_torch.data.harmonize import HarmonizedPanel, typed_column
from sgvamp_torch.utils.profiling import span

logger = logging.getLogger("sgvamp")


def read_column(path: str, name: str) -> List[str]:
    """The fields of column `name` of a whitespace-separated table with a
    header line (blank lines skipped, a short row read as missing)."""
    with open(path) as f:
        header = f.readline().split()
        if name not in header:
            raise ValueError(f"{path}: no {name} column in header {header}")
        col = header.index(name)
        rows = (line.split() for line in f)
        return [r[col] if col < len(r) else "" for r in rows if r]


def load_r(path: str, M_local: int, N: float) -> np.ndarray:
    """Load a cohort's marginal-association vector in local index space."""
    if path.endswith(".txt"):
        r = np.loadtxt(path).reshape(M_local)
    elif path.endswith(".npy"):
        r = np.load(path).reshape(M_local)
    elif path.endswith(".linear"):
        r = np.asarray(typed_column(read_column(path, "BETA")),
                       np.float64).reshape(M_local)
        r[np.isnan(r)] = 0.0
        r = r * np.sqrt(N)
    else:
        raise ValueError(f"Unsupported r vector format: {path}")
    return np.asarray(r, dtype=np.float64)


def scatter_to_reference(r_local: np.ndarray, i_map: np.ndarray, M: int) -> np.ndarray:
    """Place local-order values into reference index space."""
    out = np.zeros(M, dtype=np.float64)
    out[i_map] = r_local
    return out


def parse_ld_numpy(path: str, variants) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """native.parse_ld's numpy version: the same triplets from the same
    file, the same ValueError texts (a missing SNP_A/SNP_B/R header, a short
    line, an unknown SNP, a file that cannot be opened), a repeated name
    resolved to its first position; values read by float()."""
    index = {}
    for i, rs_ in enumerate(variants):
        index.setdefault(rs_, i)
    try:
        f = open(path, "rb")
    except OSError:
        raise ValueError(f"ldparse: cannot open {path} in {path}") from None
    with f:
        header = f.readline().split()
        try:
            ca, cb, cr = (header.index(c) for c in (b"SNP_A", b"SNP_B", b"R"))
        except ValueError:
            raise ValueError(f"ldparse: missing SNP_A/SNP_B/R columns in .ld header "
                             f"in {path}") from None
        need = max(ca, cb, cr)
        rows, cols, vals = [], [], []
        for lineno, line in enumerate(f, start=2):
            toks = line.split()
            if not toks:
                continue
            if len(toks) <= need:
                raise ValueError(f"ldparse: short line {lineno} in {path}")
            a = index.get(toks[ca].decode())
            b = index.get(toks[cb].decode())
            if a is None or b is None:
                raise ValueError(f"ldparse: unknown SNP on line {lineno} in {path}")
            rows.append(a)
            cols.append(b)
            vals.append(float(toks[cr]))
    return (np.asarray(rows, np.int64), np.asarray(cols, np.int64),
            np.asarray(vals, np.float64))


def load_ld_table(path: str, variant_index: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a PLINK .ld table into (rows, cols, vals) in reference index
    space: the native parser (one streaming pass, a hash-map SNP lookup), or
    parse_ld_numpy without it. A name resolves to its position among the
    keys of `variant_index` (insertion-ordered, built from the harmonized
    list), as in the JAX package's native path."""
    keys = list(variant_index.keys())
    with span("sgv.load.ld_parse") as sp:
        got = native.parse_ld(path, keys)
        route = "native"
        if got is None:
            got, route = parse_ld_numpy(path, keys), "numpy"
        sp.attrs.update(route=route, pairs=len(got[0]))
    logger.info(f"{path}: {len(got[0])} LD pairs parsed through the {route} path "
                f"in {sp.seconds:.3f} s")
    return got


def triplets_to_csr(rows, cols, vals, M: int) -> scipy.sparse.csr_matrix:
    """Symmetric CSR with unit diagonal from one-sided LD triplets (a pair
    given twice sums, as scipy's COO -> CSR does)."""
    ind_r = np.concatenate([np.arange(M), rows, cols])
    ind_c = np.concatenate([np.arange(M), cols, rows])
    v = np.concatenate([np.ones(M), vals, vals])
    return scipy.sparse.csr_matrix((v, (ind_r, ind_c)), shape=(M, M))


def load_R(path: str, variant_index: Optional[dict] = None):
    """Load an LD matrix: scipy CSR for .npz and .ld, dense ndarray for .npy.
    A .ld table needs the variant index of the .bim files."""
    if path.endswith(".npz"):
        return scipy.sparse.load_npz(path)
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".ld"):
        if variant_index is None:
            raise ValueError(".ld input requires .bim files for variant indexing")
        rows, cols, vals = load_ld_table(path, variant_index)
        return triplets_to_csr(rows, cols, vals, len(variant_index))
    raise ValueError(f"Unsupported R matrix format: {path}")


def as_csr(R, M: Optional[int] = None):
    """CSR view of anything load_R returns (sparse matrix or dense .npy)."""
    if scipy.sparse.issparse(R):
        return R.tocsr()
    return scipy.sparse.csr_matrix(np.asarray(R))


def _take(panel: HarmonizedPanel, k: int, j: int) -> np.ndarray:
    """Cohort k's missing reference indices whose source is cohort j."""
    return panel.missing[k][panel.sources[k][panel.missing[k]] == j]


def fill_missing_csr(
    Rs: List, rs: List[np.ndarray], panel: HarmonizedPanel
) -> Tuple[List, List[np.ndarray]]:
    """Sparse missing-SNP fill: fill_missing_from_source semantics without
    ever materializing an M x M dense matrix.

    For cohort k's missing indices assigned to source cohort j, cohort j's
    LD rows AND columns at those indices replace whatever cohort k had
    there (later sources overwrite earlier ones on row/column
    intersections, as the dense version's row-then-column assignment does).
    """
    K = len(Rs)
    out_R, out_r = [], []
    for k in range(K):
        A = as_csr(Rs[k]).tocoo()
        M = A.shape[0]
        row, col, dat = A.row, A.col, A.data
        r_k = np.array(rs[k], copy=True)
        for j in range(K):
            if j == k:
                continue
            take = _take(panel, k, j)
            if take.size == 0:
                continue
            in_take = np.zeros(M, dtype=bool)
            in_take[take] = True
            keep = ~(in_take[row] | in_take[col])
            Bj = as_csr(Rs[j]).tocoo()
            sel = in_take[Bj.row] | in_take[Bj.col]
            row = np.concatenate([row[keep], Bj.row[sel]])
            col = np.concatenate([col[keep], Bj.col[sel]])
            dat = np.concatenate([dat[keep], Bj.data[sel]])
            r_k[take] = np.asarray(rs[j])[take]
        out_R.append(scipy.sparse.csr_matrix((dat, (row, col)), shape=(M, M)))
        out_r.append(r_k)
    return out_R, out_r


def fill_missing_from_source(
    Rs: List, rs: List[np.ndarray], panel: HarmonizedPanel
) -> Tuple[List, List[np.ndarray]]:
    """Fill each cohort's missing reference SNPs from its source cohorts, on
    dense copies: for cohort k's missing index set assigned to source
    cohort j, cohort j's LD rows and columns and r entries at those indices
    go into cohort k's arrays."""
    K = len(Rs)
    dense = [np.asarray(R.todense()) if scipy.sparse.issparse(R) else np.array(R)
             for R in Rs]
    out_r = [r.copy() for r in rs]
    for k in range(K):
        for j in range(K):
            if j == k:
                continue
            take = _take(panel, k, j)
            if take.size == 0:
                continue
            dense[k][take, :] = dense[j][take, :]
            dense[k][:, take] = dense[j][:, take]
            out_r[k][take] = rs[j][take]
    return dense, out_r


def csr_to_band_numpy(R, bandwidth: Optional[int] = None,
                      dtype=np.float32) -> Tuple[np.ndarray, int, int]:
    """csr_to_band's numpy version (and its only path for a dense input or a
    float64 band). A sparse input is walked in CSR order (rows from indptr,
    one flat scatter), which avoids the COO conversion's sort."""
    if scipy.sparse.issparse(R):
        Rc = _canonical_csr(R)
        M = Rc.shape[0]
        d = Rc.indices.astype(np.int64)
        d -= np.repeat(np.arange(M, dtype=np.int64), np.diff(Rc.indptr))
        data = Rc.data
    else:
        coo = scipy.sparse.coo_matrix(R)
        coo.sum_duplicates()
        M = R.shape[0]
        d = coo.col.astype(np.int64) - coo.row
        data = coo.data
    if bandwidth is None:
        bandwidth = int(np.abs(d).max()) if d.size else 0
    nd = 2 * bandwidth + 1
    band = np.zeros((M, nd), dtype)
    keep = np.abs(d) <= bandwidth
    dropped = int(d.size - np.count_nonzero(keep))
    if scipy.sparse.issparse(R):
        row = np.repeat(np.arange(M, dtype=np.int64), np.diff(Rc.indptr))
    else:
        row = coo.row.astype(np.int64)
    flat = row * nd
    flat += d
    flat += bandwidth
    if dropped:
        flat, data = flat[keep], data[keep]
    band.reshape(-1)[flat] = data
    return band, bandwidth, dropped


def _canonical_csr(R) -> scipy.sparse.csr_matrix:
    """R as CSR whose duplicate entries are summed, as scipy sums them on
    use; on a copy, since tocsr() of a csr_matrix returns the matrix
    itself and sum_duplicates would change the caller's arrays."""
    Rc = R.tocsr()
    if not Rc.has_canonical_format:
        Rc = Rc.copy()
        Rc.sum_duplicates()
    return Rc


def csr_to_band(R, bandwidth: Optional[int] = None,
                dtype=np.float32) -> Tuple[np.ndarray, int, int]:
    """Convert a scipy sparse (or dense) symmetric matrix to symmetric band
    storage (M, 2*bw+1) without densifying MxM.

    Returns (band, bandwidth, dropped_entries). Entries outside the chosen
    bandwidth are dropped (counted); the diagonal is taken from the matrix
    itself; duplicate entries sum, as scipy's CSR does. A sparse input and
    a float32 band go through the native one-pass writer, anything else
    (or no library) through csr_to_band_numpy.
    """
    if scipy.sparse.issparse(R) and np.dtype(dtype) == np.float32 and native.available():
        Rc = _canonical_csr(R)
        M = Rc.shape[0]
        bw = bandwidth
        if bw is None:
            bw = native.csr_max_bandwidth(Rc.indptr, Rc.indices, M)
        if bw is not None:
            got = native.csr_to_band(Rc.indptr, Rc.indices, Rc.data, M, bw)
            if got is not None:
                logger.info(f"CSR -> band (M={M}, bandwidth {bw}) through the native path")
                return got[0], int(bw), got[1]
    band, bw, dropped = csr_to_band_numpy(R, bandwidth, dtype)
    logger.info(f"CSR -> band (M={band.shape[0]}, bandwidth {bw}) through the numpy path")
    return band, bw, dropped


def fill_missing_triplets(
    triplets: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    rs: List[np.ndarray],
    panel: HarmonizedPanel,
) -> Tuple[List[Tuple[np.ndarray, np.ndarray, np.ndarray]], List[np.ndarray]]:
    """Triplet-level missing-SNP fill (the band-direct analogue of
    fill_missing_from_source): cohort k receives, from each source cohort
    j, all of j's LD triplets touching k's missing indices assigned to j,
    appended after its own, plus j's r values there."""
    K = len(triplets)
    out_t = [list(t) for t in triplets]
    out_r = [r.copy() for r in rs]
    for k in range(K):
        for j in range(K):
            if j == k:
                continue
            take = _take(panel, k, j)
            if take.size == 0:
                continue
            aj, bj, vj = triplets[j]
            sel = np.isin(aj, take) | np.isin(bj, take)
            out_t[k][0] = np.concatenate([out_t[k][0], aj[sel]])
            out_t[k][1] = np.concatenate([out_t[k][1], bj[sel]])
            out_t[k][2] = np.concatenate([out_t[k][2], vj[sel]])
            out_r[k][take] = rs[j][take]
    return [tuple(t) for t in out_t], out_r


def triplets_to_band_numpy(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                           M: int, bw: int, dtype=np.float32) -> Tuple[np.ndarray, int]:
    """native.triplets_to_band's numpy version: a unit diagonal, then each
    triplet written at (a, b) and mirrored at (b, a) in triplet order, so
    that where two writes meet the last one wins. Returns (band, dropped)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    nd = 2 * bw + 1
    band = np.zeros((M, nd), dtype)
    band[:, bw] = 1.0
    d = cols - rows
    keep = np.abs(d) <= bw
    dropped = int(d.size - np.count_nonzero(keep))
    rows, cols, d, v = rows[keep], cols[keep], d[keep], vals[keep].astype(dtype)
    # the writes in the native order: (a, b) then its mirror, triplet by triplet
    flat = np.stack([rows * nd + bw + d, cols * nd + bw - d], axis=1).reshape(-1)
    v2 = np.repeat(v, 2)
    # the last write to each cell: the first occurrence in the reversed order
    _, first_rev = np.unique(flat[::-1], return_index=True)
    last = flat.size - 1 - first_rev
    band.reshape(-1)[flat[last]] = v2[last]
    return band, dropped


def ld_files_to_bands(
    ld_paths: Sequence[str],
    rs: List[np.ndarray],
    panel: HarmonizedPanel,
    bandwidth: Optional[int] = None,
    dtype=np.float32,
) -> Tuple[np.ndarray, List[np.ndarray], int, int]:
    """Load PLINK .ld files straight into symmetric band storage (K, M, nd)
    without ever materializing MxM - the biobank-scale ingestion path.
    With several files, each cohort's missing SNPs are filled from their
    source cohorts first (fill_missing_triplets).

    Returns (bands, filled_rs, bandwidth, dropped_entries).
    """
    vindex = {rs_: i for i, rs_ in enumerate(panel.variants)}
    M = panel.M
    triplets = [load_ld_table(p, vindex) for p in ld_paths]
    if len(ld_paths) > 1:
        triplets, rs = fill_missing_triplets(triplets, rs, panel)
    if bandwidth is None:
        bandwidth = 0
        for a, b, _ in triplets:
            if len(a):
                got = native.max_bandwidth(a, b)
                w = got if got is not None else int(np.abs(a - b).max())
                bandwidth = max(bandwidth, w)
    bands = np.zeros((len(ld_paths), M, 2 * bandwidth + 1), dtype)
    dropped = 0
    for k, (a, b, v) in enumerate(triplets):
        got = native.triplets_to_band(a, b, v, M, bandwidth, dtype=dtype)
        route = "native"
        if got is None:
            got, route = triplets_to_band_numpy(a, b, v, M, bandwidth, dtype=dtype), "numpy"
        bands[k], d = got
        dropped += d
        logger.info(f"{ld_paths[k]}: cohort {k + 1}'s band (M={M}, bandwidth {bandwidth}) "
                    f"assembled through the {route} path")
    return bands, rs, bandwidth, dropped


def load_true_signal(path: str, M: int, N: float) -> np.ndarray:
    """Load x0 and scale by sqrt(N). A signal file of the wrong length means
    a mismatched panel, so the length is checked strictly."""
    if path.endswith(".bin"):
        with open(path, "rb") as f:
            buf = f.read(M * 8 + 8)
        if len(buf) != M * 8:
            raise ValueError(
                f"{path}: {len(buf) // 8}{'+' if len(buf) > M * 8 else ''} "
                f"float64 values, expected exactly M={M}")
        x0 = np.asarray(struct.unpack(str(M) + "d", buf), dtype=np.float64)
    elif path.endswith(".npy"):
        x0 = np.load(path).astype(np.float64).reshape(-1)
        if x0.size != M:
            raise ValueError(
                f"{path}: {x0.size} values, expected exactly M={M}")
    else:
        raise ValueError(f"Unsupported true signal format: {path}")
    return x0 * np.sqrt(N)


def to_dense_stack(Rs: Sequence, M: int) -> np.ndarray:
    """Stack per-cohort LD matrices into a dense (K, M, M) float array."""
    out = np.empty((len(Rs), M, M), dtype=np.float64)
    for k, R in enumerate(Rs):
        out[k] = np.asarray(R.todense()) if scipy.sparse.issparse(R) else np.asarray(R)
    return out


def estimate_bandwidth(R, quantile: float = 1.0) -> int:
    """Max |i-j| over nonzero entries (optionally a quantile for outlier-
    robust banding). Used to pick BandedLD bandwidth for sparse LD."""
    if scipy.sparse.issparse(R):
        coo = R.tocoo()
        d = np.abs(coo.row - coo.col)
    else:
        nz = np.nonzero(np.asarray(R))
        d = np.abs(nz[0] - nz[1])
    if d.size == 0:
        return 0
    if quantile >= 1.0:
        return int(d.max())
    return int(np.quantile(d, quantile))
