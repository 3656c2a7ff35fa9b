"""Host C++ ingestion (native/ldparse.cpp), bound with ctypes.

The shared library is compiled with g++ at first use into
sgvamp_torch/build/ (ignored by git), under a name that carries a hash of
the source and the flags: an edited source is rebuilt, an unchanged one is
reused. Every entry point returns None when the library is unavailable (no
g++, or a failed build); the callers in data/loaders.py and
ops/band_kernel.py then take their numpy versions, which compute the same
bits. available() says which of the two paths a run takes.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("sgvamp")

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ldparse.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(SOURCE)), "build")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i8p = ctypes.POINTER(ctypes.c_int8)
_i64 = ctypes.c_int64


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libldparse_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ldparse.cpp unless its library exists; returns the library's
    path. Raises RuntimeError (with g++'s output) when g++ is missing or
    fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp],
                                  capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"g++ could not be run: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)   # atomic for a concurrent loader
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built at first use), or None when it cannot be
    built; the outcome of the first call holds for the process."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _bind(ctypes.CDLL(build()))
            except (RuntimeError, OSError) as e:
                logger.info(f"native ingestion unavailable, numpy path taken: {e}")
        return _lib


def available() -> bool:
    """True when ingestion runs through the native library."""
    return get_lib() is not None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every exported symbol's signature."""
    def sig(name, restype, *argtypes):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, list(argtypes)

    sig("ldparse_parse", ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, _i64)
    sig("ldparse_error", ctypes.c_char_p, ctypes.c_void_p)
    sig("ldparse_count", _i64, ctypes.c_void_p)
    sig("ldparse_copy", None, ctypes.c_void_p, _i64p, _i64p, _f64p)
    sig("ldparse_free", None, ctypes.c_void_p)
    sig("ldparse_max_bandwidth", _i64, _i64, _i64p, _i64p)
    sig("ldparse_to_band", _i64, _i64, _i64p, _i64p, _f64p, _i64, _i64, _f32p)
    sig("ldparse_to_band_f64", _i64, _i64, _i64p, _i64p, _f64p, _i64, _i64, _f64p)
    for iname, ip in (("i32", _i32p), ("i64", _i64p)):
        for vname, vp in (("f32", _f32p), ("f64", _f64p)):
            sig(f"ldparse_csr_to_band_{iname}_{vname}", _i64, _i64, ip, ip, vp, _i64, _f32p)
        sig(f"ldparse_csr_max_bw_{iname}", _i64, _i64, ip, ip)
    for name in ("ldparse_band_pack_i8", "ldparse_band_pack_hybrid"):
        sig(name, None, _f32p, _i64, _i64, _i64, _i64, _i64, _i8p, _f32p)
    return lib


def _ptr(x: np.ndarray, p):
    return x.ctypes.data_as(p)


def parse_ld(path: str, variants) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Parse a PLINK .ld table in one streaming pass: (rows, cols, vals)
    as int64, int64, float64, the SNP_A / SNP_B names resolved to their
    position in `variants` (the first one where a name repeats). Raises
    ValueError on a missing SNP_A/SNP_B/R header, a short line, an unknown
    SNP or a file that cannot be opened; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    blob = "\n".join(variants).encode()
    h = lib.ldparse_parse(path.encode(), blob, len(variants))
    if not h:
        raise MemoryError("ldparse_parse allocation failed")
    try:
        err = lib.ldparse_error(h)
        if err:
            raise ValueError(f"ldparse: {err.decode()} in {path}")
        n = lib.ldparse_count(h)
        a = np.empty(n, np.int64)
        b = np.empty(n, np.int64)
        v = np.empty(n, np.float64)
        if n:
            lib.ldparse_copy(h, _ptr(a, _i64p), _ptr(b, _i64p), _ptr(v, _f64p))
        return a, b, v
    finally:
        lib.ldparse_free(h)


def max_bandwidth(rows: np.ndarray, cols: np.ndarray) -> Optional[int]:
    """max |rows - cols| over the triplets (0 when there are none)."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    return int(lib.ldparse_max_bandwidth(len(rows), _ptr(rows, _i64p), _ptr(cols, _i64p)))


def _pack(fn_name: str, band: np.ndarray, B: int,
          hybrid: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Run one of the block packers; hybrid storage has one slot more, half
    as many bytes a block row and a scale per row."""
    lib = get_lib()
    if lib is None or band.dtype != np.float32:
        return None
    band = np.ascontiguousarray(band)
    M_orig, nd = band.shape
    bw = (nd - 1) // 2
    nb = -(-M_orig // B)
    hb = -(-bw // B)
    nslot = hb + 1 + hybrid
    upper = np.empty((nb, nslot, B, B // 2 if hybrid else B), np.int8)
    scales = np.empty((nb, nslot, B) if hybrid else (nb, nslot), np.float32)
    getattr(lib, fn_name)(_ptr(band, _f32p), M_orig, nd, B, nb, hb,
                          _ptr(upper, _i8p), _ptr(scales, _f32p))
    return upper, scales


def band_pack_i8(band: np.ndarray, B: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """float32 band storage (M, 2*bw+1) -> int8 upper-triangle blocks
    (nb, hb+1, B, B) and per-block float32 scales (nb, hb+1), bit-identical
    to ops/band_kernel.pack_int8. None for another band dtype or without the
    library."""
    return _pack("ldparse_band_pack_i8", band, B, hybrid=False)


def band_pack_hybrid(band: np.ndarray, B: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """float32 band storage -> hybrid blocks (nb, hb+2, B, B/2) int8 and
    per-row float32 scales (nb, hb+2, B): slots 0, 1 the d=0 block's int8
    column halves, slot d+1 the far block d packed int4; bit-identical to
    ops/band_kernel.pack_hybrid. None for an odd B, another band dtype or
    without the library."""
    if B % 2:
        return None
    return _pack("ldparse_band_pack_hybrid", band, B, hybrid=True)


def _csr_suffixes(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray):
    """(index suffix, value suffix) of the CSR entry points, or None when
    the dtypes have no native symbol."""
    if indptr.dtype != indices.dtype:
        return None
    iname = {np.dtype(np.int32): "i32", np.dtype(np.int64): "i64"}.get(indptr.dtype)
    vname = {np.dtype(np.float32): "f32", np.dtype(np.float64): "f64"}.get(data.dtype)
    if iname is None or vname is None:
        return None
    return iname, vname


def csr_to_band(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                M: int, bw: int) -> Optional[Tuple[np.ndarray, int]]:
    """float32 symmetric band storage (M, 2*bw+1) from CSR arrays in one
    row-ordered pass, the diagonal taken from the matrix itself; returns
    (band, dropped_count). The CSR must be canonical (no duplicate column
    in a row: the pass would keep the last). None without the library or
    for dtypes it has no entry point for."""
    lib = get_lib()
    sfx = _csr_suffixes(indptr, indices, data)
    if lib is None or sfx is None:
        return None
    indptr = np.ascontiguousarray(indptr)
    indices = np.ascontiguousarray(indices)
    data = np.ascontiguousarray(data)
    band = np.zeros((M, 2 * bw + 1), np.float32)
    ip = _i32p if sfx[0] == "i32" else _i64p
    vp = _f32p if sfx[1] == "f32" else _f64p
    fn = getattr(lib, f"ldparse_csr_to_band_{sfx[0]}_{sfx[1]}")
    dropped = fn(M, _ptr(indptr, ip), _ptr(indices, ip), _ptr(data, vp), bw,
                 _ptr(band, _f32p))
    return band, int(dropped)


def csr_max_bandwidth(indptr: np.ndarray, indices: np.ndarray, M: int) -> Optional[int]:
    """max |col - row| over the CSR's entries, or None."""
    lib = get_lib()
    sfx = _csr_suffixes(indptr, indices, np.empty(0, np.float32))
    if lib is None or sfx is None:
        return None
    indptr = np.ascontiguousarray(indptr)
    indices = np.ascontiguousarray(indices)
    ip = _i32p if sfx[0] == "i32" else _i64p
    fn = getattr(lib, f"ldparse_csr_max_bw_{sfx[0]}")
    return int(fn(M, _ptr(indptr, ip), _ptr(indices, ip)))


def triplets_to_band(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                     M: int, bw: int, dtype=np.float32) -> Optional[Tuple[np.ndarray, int]]:
    """Symmetric band storage (M, 2*bw+1) in float32 or float64 with a unit
    diagonal from one-sided triplets, in triplet order (a pair given twice:
    the last one wins); returns (band, dropped_count), or None."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.float64):
        raise ValueError(f"triplets_to_band: float32 or float64 bands only, got {dtype}")
    band = np.zeros((M, 2 * bw + 1), dtype)
    if dtype == np.float64:
        fn, bp = lib.ldparse_to_band_f64, _f64p
    else:
        fn, bp = lib.ldparse_to_band, _f32p
    dropped = fn(len(rows), _ptr(rows, _i64p), _ptr(cols, _i64p), _ptr(vals, _f64p),
                 M, bw, _ptr(band, bp))
    return band, int(dropped)
