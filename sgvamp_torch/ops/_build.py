"""Build and load the port's CUDA kernels.

The sources in sgvamp_torch/csrc/ are compiled with nvcc for sm_90a into
one shared library with a plain C interface, on first use, and loaded
with ctypes. The library goes into sgvamp_torch/build/ (ignored by git)
under a name that carries a hash of the sources, so an edited source is
rebuilt and an unchanged one is reused.
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


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        found = os.path.join(CUDA_HOME, "bin", "nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsgvamp_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the CUDA sources unless the library for them exists; returns
    its path. nvcc's resource report (-Xptxas -v) goes to build.log."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()],
                              capture_output=True, text=True)
        with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's signature set."""
    lib = ctypes.CDLL(build())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sgv_sym_band_int8_matvec.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.sgv_sym_band_int8_matvec.restype = i
    return lib
