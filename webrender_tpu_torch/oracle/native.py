"""ctypes binding for the native span rasterizer (native/span_raster.cpp —
the SWGL role), the CPU baseline and accelerated oracle beside the numpy
one (`oracle/sw.py`, `use_native`).

The port's copy of `webrender_tpu/oracle/native.py`.  It loads the
repository's `native/libspanraster.so` as it is (`make -C native`
rebuilds it).  Unlike the JAX package's copy it never builds and never
falls back: a caller asks `available()`, and
`SoftwareRenderer(use_native=True)` raises when the library does not
load.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

LIBRARY = Path(__file__).resolve().parents[2] / "native" / \
    "libspanraster.so"

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not LIBRARY.exists():
        return None
    lib = ctypes.CDLL(str(LIBRARY))
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.wr_raster_pass.restype = ctypes.c_int
    lib.wr_raster_pass.argtypes = [
        f32p, ctypes.c_int64,            # f32_buf
        i32p, ctypes.c_int64,            # instances
        f32p, ctypes.c_int64,            # transforms
        i32p, ctypes.c_int64,            # order
        f32p,                             # bboxes
        f32p, ctypes.c_int64, ctypes.c_int64,   # color atlas
        f32p, ctypes.c_int64, ctypes.c_int64,   # alpha atlas
        f32p, ctypes.c_int64, ctypes.c_int64,   # surface atlas
        f32p, ctypes.c_int64, ctypes.c_int64,   # target
        ctypes.c_float, ctypes.c_float,  # origin
    ]
    lib.wr_pack_rgba8.restype = ctypes.c_int
    lib.wr_pack_rgba8.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_uint8)]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def raster_pass(f32_buf: np.ndarray, instances: np.ndarray,
                transforms: np.ndarray, order: np.ndarray,
                bboxes: np.ndarray, color_atlas: np.ndarray,
                alpha_atlas: np.ndarray, surface_atlas: np.ndarray,
                target: np.ndarray, origin) -> None:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native span rasterizer does not load")
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)

    def fp(a):
        return a.ctypes.data_as(f32p)

    def ip(a):
        return a.ctypes.data_as(i32p)

    if not target.flags["C_CONTIGUOUS"]:
        raise ValueError("raster_pass wants a C-contiguous target")
    rc = lib.wr_raster_pass(
        fp(f32_buf), f32_buf.shape[0],
        ip(instances), instances.shape[0],
        fp(transforms), transforms.shape[0],
        ip(order), order.shape[0],
        fp(bboxes),
        fp(color_atlas), color_atlas.shape[1], color_atlas.shape[2],
        fp(alpha_atlas), alpha_atlas.shape[0], alpha_atlas.shape[1],
        fp(surface_atlas), surface_atlas.shape[1], surface_atlas.shape[2],
        fp(target), target.shape[1], target.shape[2],
        float(origin[0]), float(origin[1]))
    if rc != 0:
        raise RuntimeError(f"wr_raster_pass failed ({rc})")


def pack_rgba8(fb: np.ndarray) -> np.ndarray:
    """Planar [4, h, w] premultiplied f32 -> (h, w, 4) RGBA8 with the
    oracle's exact unorm conversion (C++ OpenMP; ~10x faster than the
    numpy epilogue on 4K frames)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native span rasterizer does not load")
    fb = np.ascontiguousarray(fb, np.float32)
    h, w = fb.shape[1], fb.shape[2]
    out = np.empty((h, w, 4), np.uint8)
    rc = lib.wr_pack_rgba8(fb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           h, w,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"wr_pack_rgba8 failed ({rc})")
    return out
