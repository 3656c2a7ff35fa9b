"""Host-side loaders for summary statistics: r vectors, LD matrices and true
signals (numpy and scipy only; the counterpart of sgvamp_tpu/data/loaders.py).

  r:  .txt (loadtxt), .npy, PLINK .linear (BETA column, NaN->0, *sqrt(N))
  R:  sparse .npz, dense .npy (PLINK .ld tables are not ported yet)
  x0: .bin packed doubles or .npy, both *sqrt(N)
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.sparse


def _read_linear_beta(path: str) -> np.ndarray:
    """The BETA column of a whitespace-delimited PLINK .linear table with a
    header line; NA and empty fields read as NaN."""
    with open(path) as f:
        header = f.readline().split()
        if "BETA" not in header:
            raise ValueError(f"{path}: no BETA column in header {header}")
        col = header.index("BETA")
        vals = []
        for line in f:
            fields = line.split()
            if not fields:
                continue
            tok = fields[col] if col < len(fields) else "nan"
            try:
                vals.append(float(tok))
            except ValueError:   # NA and the like
                vals.append(np.nan)
    return np.asarray(vals, dtype=np.float64)


def load_r(path: str, M_local: int, N: float) -> np.ndarray:
    """Load a cohort's marginal-association vector in local index space."""
    if path.endswith(".txt"):
        r = np.loadtxt(path).reshape(M_local)
    elif path.endswith(".npy"):
        r = np.load(path).reshape(M_local)
    elif path.endswith(".linear"):
        r = _read_linear_beta(path).reshape(M_local)
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


def load_R(path: str, variant_index: Optional[dict] = None):
    """Load an LD matrix: scipy CSR for .npz, dense ndarray for .npy."""
    if path.endswith(".npz"):
        return scipy.sparse.load_npz(path)
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".ld"):
        raise NotImplementedError(
            f"{path}: PLINK .ld tables are not ported yet (ROADMAP queue A)")
    raise ValueError(f"Unsupported R matrix format: {path}")


def as_csr(R, M: Optional[int] = None):
    """CSR view of anything load_R returns (sparse matrix or dense .npy)."""
    if scipy.sparse.issparse(R):
        return R.tocsr()
    return scipy.sparse.csr_matrix(np.asarray(R))


def csr_to_band(R, bandwidth: Optional[int] = None,
                dtype=np.float32) -> Tuple[np.ndarray, int, int]:
    """Convert a scipy sparse (or dense) symmetric matrix to symmetric band
    storage (M, 2*bw+1) without densifying MxM.

    Returns (band, bandwidth, dropped_entries). Entries outside the chosen
    bandwidth are dropped (counted); the diagonal is taken from the matrix
    itself; duplicate entries sum, as scipy's CSR does. A sparse input is
    walked in CSR order (rows from indptr, one flat scatter), which at
    M=524288 / 135M entries avoids the COO conversion's sort.
    """
    if scipy.sparse.issparse(R):
        Rc = R.tocsr()
        if not Rc.has_canonical_format:
            # on a copy: tocsr() of a csr_matrix returns the matrix itself
            Rc = Rc.copy()
            Rc.sum_duplicates()
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
