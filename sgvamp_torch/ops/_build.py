"""Build and load the port's CUDA kernels.

Each source sgvamp_torch/csrc/<name>.cu is compiled with nvcc for sm_90a
into its own shared library with a plain C interface, and loaded with
ctypes. The first load builds every source that has no library yet, one
nvcc process per source, all started together. The libraries go into
sgvamp_torch/build/ (ignored by git) under names that carry a hash of the
source, the shared headers and the flags, so an edited source is rebuilt
and an unchanged one is reused. A library of VARIANTS is built from another
library's source with flags of its own.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_QUANT = [_P] * 4 + [_I] * 5 + [_P]
_QUANT_TILES = [_P] * 5 + [_I] * 7 + [_P]
_QUANT_LANES = [_P] * 7 + [_I] * 7 + [_P]
_ROWS = [_P] * 3 + [_I] * 7 + [_P]
_STREAMED = [_P] * 4 + [_I] * 7 + [_P]
_STREAMED_TILES = [_P] * 4 + [_I] * 8 + [_P]


def _spill(argtypes: list, n_in: int) -> list:
    """The spill form's signature: one more pointer, carry, after y."""
    return argtypes[:n_in + 1] + [_P] + argtypes[n_in + 1:]


# entry points and argument types of each library: pointers (the stream
# last) as c_void_p, or ctypes passes them as 32-bit ints
ENTRY_POINTS = {
    # upper, scales, x, y, [carry,] partials, K, nb, hb, B, S, block rows and
    # diagonals a CTA, stream; the lanes form: upper, scales, x, y, partials,
    # gamw, gam2, then the same
    "sym_band_int8": {"sgv_sym_band_int8_matvec": _QUANT_TILES,
                      "sgv_sym_band_int8_spill": _spill(_QUANT_TILES, 3),
                      "sgv_sym_band_int8_lanes": _QUANT_LANES},
    # the same, and (count out, reset): the block bytes its warps copied
    "sym_band_int8_counted": {"sgv_sym_band_int8_matvec": _QUANT_TILES,
                              "sgv_sym_band_int8_spill": _spill(_QUANT_TILES, 3),
                              "sgv_sym_band_int8_lanes": _QUANT_LANES,
                              "sgv_sym_band_int8_block_bytes": [_P, _I]},
    # upper, scales, x, y, [carry,] K, nb, hb, B, S, stream
    "sym_band_int4": {"sgv_sym_band_int4_matvec": _QUANT,
                      "sgv_sym_band_int4_spill": _spill(_QUANT, 3)},
    "sym_band_hybrid": {"sgv_sym_band_hybrid_matvec": _QUANT,
                        "sgv_sym_band_hybrid_spill": _spill(_QUANT, 3)},
    # upper, x, y, [carry,] partials, K, nb, hb, B, S, block rows and
    # diagonals a CTA, dtype code, stream
    "sym_band_float": {"sgv_sym_band_float_matvec": _STREAMED_TILES,
                       "sgv_sym_band_float_spill": _spill(_STREAMED_TILES, 2)},
    # the same; the spill form without the diagonals a CTA (every one)
    "sym_slab_streamed": {"sgv_sym_slab_streamed_matvec": _STREAMED_TILES,
                          "sgv_sym_slab_streamed_spill": _spill(_STREAMED, 2)},
    # upper, x, y, K, nb, hb, B, S, block rows a CTA, dtype code, stream
    "sym_band_resident": {"sgv_sym_band_resident_matvec": _ROWS},
    "sym_slab_resident": {"sgv_sym_slab_resident_matvec": _ROWS},
}

# library: (the library whose source it is built from, its extra nvcc flags)
VARIANTS = {"sym_band_int8_counted": ("sym_band_int8", ["-DSGV_COUNT_BLOCK_BYTES"])}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        found = os.path.join(CUDA_HOME, "bin", "nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _source(name: str) -> str:
    return os.path.join(CSRC, VARIANTS.get(name, (name,))[0] + ".cu")


def _flags(name: str) -> list:
    return NVCC_FLAGS + VARIANTS.get(name, (name, []))[1]


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for src in [_source(name)] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile every source whose library does not exist yet, in parallel;
    returns {name: library path}. nvcc's resource report (-Xptxas -v) goes
    to build/<name>.log."""
    paths = {name: library_path(name) for name in ENTRY_POINTS}
    todo = [name for name, path in paths.items() if not os.path.exists(path)]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs, tmps = {}, {}
    try:
        for name in todo:
            fd, tmps[name] = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs[name] = subprocess.Popen(
                [nvcc, *_flags(name), "-I", CSRC, "-o", tmps[name], _source(name)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        failed = []
        for name, proc in procs.items():
            out, _ = proc.communicate()
            with open(os.path.join(BUILD_DIR, name + ".log"), "w") as f:
                f.write(out)
            if proc.returncode != 0:
                failed.append(f"{name}.cu: nvcc failed ({proc.returncode}):\n{out}")
            else:
                os.replace(tmps[name], paths[name])  # atomic for a concurrent loader
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
        for tmp in tmps.values():
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, with its entry points'
    signatures set."""
    lib = ctypes.CDLL(build()[name])
    for entry, argtypes in ENTRY_POINTS[name].items():
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = _I
    return lib
