"""ctypes FreeType binding for true LCD subpixel glyph rasterization —
the `wr_glyph_rasterizer/src/platform/unix/font.rs:460` path
(FT_LOAD_TARGET_LCD + FT_Render_Glyph(FT_RENDER_MODE_LCD) with
FT_LCD_FILTER_DEFAULT).  The reference does no gamma preblending on
FreeType platforms (font.rs:784), so neither does this.

matplotlib's bundled ft2font only exposes grayscale rendering; this
binds the system libfreetype directly for the LCD pixel mode."""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import numpy as np

FT_LOAD_TARGET_LCD = 3 << 16
FT_RENDER_MODE_LCD = 3
FT_LCD_FILTER_DEFAULT = 1
FT_PIXEL_MODE_LCD = 5

FT_Pos = ctypes.c_long
FT_Fixed = ctypes.c_long


class _FTBitmap(ctypes.Structure):
    _fields_ = [("rows", ctypes.c_uint),
                ("width", ctypes.c_uint),
                ("pitch", ctypes.c_int),
                ("buffer", ctypes.POINTER(ctypes.c_ubyte)),
                ("num_grays", ctypes.c_ushort),
                ("pixel_mode", ctypes.c_ubyte),
                ("palette_mode", ctypes.c_ubyte),
                ("palette", ctypes.c_void_p)]


class _FTGlyphMetrics(ctypes.Structure):
    _fields_ = [(n, FT_Pos) for n in
                ("width", "height", "horiBearingX", "horiBearingY",
                 "horiAdvance", "vertBearingX", "vertBearingY",
                 "vertAdvance")]


class _FTVector(ctypes.Structure):
    _fields_ = [("x", FT_Pos), ("y", FT_Pos)]


class _FTGeneric(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("finalizer", ctypes.c_void_p)]


class _FTGlyphSlot(ctypes.Structure):
    _fields_ = [("library", ctypes.c_void_p),
                ("face", ctypes.c_void_p),
                ("next", ctypes.c_void_p),
                ("glyph_index", ctypes.c_uint),
                ("generic", _FTGeneric),
                ("metrics", _FTGlyphMetrics),
                ("linearHoriAdvance", FT_Fixed),
                ("linearVertAdvance", FT_Fixed),
                ("advance", _FTVector),
                ("format", ctypes.c_uint),  # FT_Glyph_Format (FourCC)
                ("_pad0", ctypes.c_uint),   # align to 8 before pointers
                ("bitmap", _FTBitmap),
                ("bitmap_left", ctypes.c_int),
                ("bitmap_top", ctypes.c_int)]
    # (outline + the rest are not accessed)


class _FTBBox(ctypes.Structure):
    _fields_ = [("xMin", FT_Pos), ("yMin", FT_Pos),
                ("xMax", FT_Pos), ("yMax", FT_Pos)]


class _FTFaceRec(ctypes.Structure):
    _fields_ = [("num_faces", ctypes.c_long),
                ("face_index", ctypes.c_long),
                ("face_flags", ctypes.c_long),
                ("style_flags", ctypes.c_long),
                ("num_glyphs", ctypes.c_long),
                ("family_name", ctypes.c_char_p),
                ("style_name", ctypes.c_char_p),
                ("num_fixed_sizes", ctypes.c_int),
                ("available_sizes", ctypes.c_void_p),
                ("num_charmaps", ctypes.c_int),
                ("charmaps", ctypes.c_void_p),
                ("generic", _FTGeneric),
                ("bbox", _FTBBox),
                ("units_per_EM", ctypes.c_ushort),
                ("ascender", ctypes.c_short),
                ("descender", ctypes.c_short),
                ("height", ctypes.c_short),
                ("max_advance_width", ctypes.c_short),
                ("max_advance_height", ctypes.c_short),
                ("underline_position", ctypes.c_short),
                ("underline_thickness", ctypes.c_short),
                ("glyph", ctypes.POINTER(_FTGlyphSlot)),
                ("size", ctypes.c_void_p),
                ("charmap", ctypes.c_void_p)]


class LcdRasterizer:
    """Thread-local FreeType contexts (FT is not thread-safe) rendering
    LCD per-channel coverage masks."""

    def __init__(self):
        self._tls = threading.local()

    def _ctx(self):
        tl = self._tls
        lib = getattr(tl, "lib", None)
        if lib is None:
            lib = ctypes.CDLL("libfreetype.so.6")
            handle = ctypes.c_void_p()
            rc = lib.FT_Init_FreeType(ctypes.byref(handle))
            if rc != 0:
                raise OSError(f"FT_Init_FreeType rc={rc}")
            lib.FT_Library_SetLcdFilter(handle, FT_LCD_FILTER_DEFAULT)
            tl.lib = lib
            tl.handle = handle
            tl.faces = {}
            tl.buffers = {}
        return tl

    def _face(self, tl, source_key, data: Optional[bytes],
              path: Optional[str], index: int):
        face = tl.faces.get(source_key)
        if face is not None:
            return face
        face = ctypes.POINTER(_FTFaceRec)()
        if data is not None:
            buf = ctypes.create_string_buffer(data, len(data))
            tl.buffers[source_key] = buf  # keep alive for the face
            rc = tl.lib.FT_New_Memory_Face(tl.handle, buf, len(data),
                                           index, ctypes.byref(face))
        else:
            rc = tl.lib.FT_New_Face(tl.handle, path.encode(), index,
                                    ctypes.byref(face))
        if rc != 0:
            raise OSError(f"FT_New_Face rc={rc}")
        tl.faces[source_key] = face
        return face

    def render(self, source_key, data: Optional[bytes], path: Optional[str],
               index: int, size_px: float, glyph_index: int,
               subpx_x: float = 0.0
               ) -> Tuple[np.ndarray, float, float]:
        """→ ((h, w, 3) f32 LCD channel coverage, left, top).  `subpx_x`
        offsets the outline by the quantized subpixel position before
        rendering (FT_Outline_Translate, the SubpixelOffset role)."""
        tl = self._ctx()
        face = self._face(tl, source_key, data, path, index)
        rc = tl.lib.FT_Set_Char_Size(face, 0, int(round(size_px * 64.0)),
                                     72, 72)
        if rc != 0:
            raise OSError(f"FT_Set_Char_Size rc={rc}")
        rc = tl.lib.FT_Load_Glyph(face, glyph_index, FT_LOAD_TARGET_LCD)
        if rc != 0:
            raise OSError(f"FT_Load_Glyph rc={rc}")
        slot = face.contents.glyph.contents
        if subpx_x:
            # translate the outline by the quantized subpixel x before
            # rendering (26.6 units)
            tl.lib.FT_Outline_Translate(
                ctypes.byref(_outline_of(slot)),
                int(round(subpx_x * 64.0)), 0)
        rc = tl.lib.FT_Render_Glyph(ctypes.byref(slot), FT_RENDER_MODE_LCD)
        if rc != 0:
            raise OSError(f"FT_Render_Glyph rc={rc}")
        bm = slot.bitmap
        if bm.rows == 0 or bm.width == 0:
            return (np.zeros((0, 0, 3), np.float32),
                    float(slot.bitmap_left), float(slot.bitmap_top))
        assert bm.pixel_mode == FT_PIXEL_MODE_LCD, bm.pixel_mode
        rows, width = int(bm.rows), int(bm.width)  # width = 3*w px
        pitch = int(bm.pitch)
        raw = np.ctypeslib.as_array(bm.buffer, shape=(rows * abs(pitch),))
        img = np.zeros((rows, width), np.uint8)
        for r in range(rows):
            base = r * abs(pitch)
            img[r] = raw[base:base + width]
        if pitch < 0:
            img = img[::-1]
        w = width // 3
        masks = img.reshape(rows, w, 3).astype(np.float32) / 255.0
        return masks, float(slot.bitmap_left), float(slot.bitmap_top)


class _FTOutline(ctypes.Structure):
    _fields_ = [("n_contours", ctypes.c_short),
                ("n_points", ctypes.c_short),
                ("points", ctypes.c_void_p),
                ("tags", ctypes.c_void_p),
                ("contours", ctypes.c_void_p),
                ("flags", ctypes.c_int)]


def _outline_of(slot: _FTGlyphSlot) -> _FTOutline:
    """The outline field sits directly after bitmap_left/bitmap_top in
    FT_GlyphSlotRec (8-byte aligned)."""
    off = (_FTGlyphSlot.bitmap_top.offset + 4 + 7) & ~7
    addr = ctypes.addressof(slot) + off
    return _FTOutline.from_address(addr)
