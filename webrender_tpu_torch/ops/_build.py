"""Builds `csrc/tile_raster.cu` at first use and loads it with ctypes.

The library goes to `build/` at the repository root, named by a hash of
the source and the flags, so a changed source rebuilds.  The build needs
`nvcc` (`$CUDA_HOME/bin`, `/usr/local/cuda/bin` or the PATH).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / \
    "tile_raster.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
# no fast math: division and sqrtf stay IEEE-rounded; no FMA contraction
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lib = None
build_log = ""


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"tile_raster_{h.hexdigest()[:16]}.so"


def load():
    """The loaded kernel library, built first if its source changed.
    `build_log` is nvcc's output (ptxas's register counts), kept beside
    the library for later runs."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    so = library_path()
    log = so.with_suffix(".log")
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                              str(SOURCE)], capture_output=True, text=True)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
        log.write_text(build_log)
        os.replace(tmp, so)
    elif log.exists():
        build_log = log.read_text()
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.wr_tile_raster.argtypes = [p, p, p, p, p, p, ctypes.c_longlong,
                                   p, i, i, p, i, i, p, i, i, p, i, i, i, i,
                                   i, i, i, i, i, ctypes.c_float, p]
    lib.wr_tile_raster.restype = i
    lib.wr_error_string.argtypes = [i]
    lib.wr_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def error_string(err: int) -> str:
    return f"cudaError {err}: {load().wr_error_string(err).decode()}"
