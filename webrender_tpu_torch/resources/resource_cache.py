"""Resource cache — images, fonts, glyphs, and their atlas residency.

Mirrors `webrender/src/resource_cache.rs` (ResourceCache :439) +
`texture_cache.rs`: image templates are registered via transactions;
at prepare time primitives request their image/glyphs, which allocates atlas
space and queues texel uploads. The renderer consumes `take_uploads()` each
frame and applies them to the HBM atlas arrays via dynamic_update_slice
(the PBO upload path of `renderer/upload.rs`, minus the PBOs).

Atlas texel format is premultiplied RGBA float32 (color) / float32 (alpha):
TPU kernels blend in f32, so the conversion happens once at upload.
"""
from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api.font import (FontInstanceKey, FontInstanceOptions, FontKey,
                        FontRenderMode, GlyphDimensions)
from ..api.image import ImageData, ImageDescriptor, ImageFormat
from .atlas import AtlasFullError, AtlasRegion, ShelfAllocator

ATLAS_COLOR = 0
ATLAS_ALPHA = 1
ATLAS_SURFACE = 2


@dataclass
class PendingUpload:
    atlas: int                 # ATLAS_COLOR / ATLAS_ALPHA
    region: AtlasRegion
    texels: np.ndarray         # color: (h, w, 4) f32 premult; alpha: (h, w) f32


@dataclass
class ImageTemplate:
    descriptor: ImageDescriptor
    data: ImageData
    generation: int = 0
    region: Optional[AtlasRegion] = None
    uploaded_generation: int = -1


def _pixel_bytes(tpl: ImageTemplate) -> int:
    pixels = tpl.data.pixels
    return 0 if pixels is None else pixels.nbytes


@dataclass
class CachedGlyph:
    region: Optional[AtlasRegion]   # None for blank glyphs (e.g. spaces)
    left: float                     # bearing: bitmap origin relative to pen
    top: float
    width: int
    height: int
    subpixel: bool = False          # region holds rgb LCD masks (color atlas)


def _subpixel_masks(alpha: np.ndarray, shift: float = 0.0) -> np.ndarray:
    """(h, w) coverage → (h, w+1, 4) LCD channel masks: r/g/b sample the
    coverage at x−1/3, x, x+1/3 (linear taps; the FreeType LCD + FIR
    pipeline approximated on the already box-filtered raster). `shift`
    renders the glyph at a quantized subpixel x offset
    (wr_glyph_rasterizer SubpixelOffset)."""
    h, w = alpha.shape
    pad = np.zeros((h, w + 2), np.float32)
    pad[:, 1:w + 1] = alpha

    def tap(off):
        # sample pad at x + off (x in -0.5-extended grid), linear interp
        xs = np.arange(w + 1, dtype=np.float32) + off
        x0 = np.floor(xs).astype(np.int32)
        fr = xs - x0
        x0 = np.clip(x0, -1, w)
        x1 = np.clip(x0 + 1, 0, w + 1)
        return pad[:, x0 + 1] * (1.0 - fr) + pad[:, x1] * fr

    r = tap(-shift - 1.0 / 3.0)
    g = tap(-shift)
    b = tap(-shift + 1.0 / 3.0)
    out = np.stack([r, g, b, np.maximum(np.maximum(r, g), b)], axis=-1)
    return out.astype(np.float32)


def _shift_bitmap(alpha: np.ndarray, shift: float) -> np.ndarray:
    """(h, w) coverage → (h, w+1) coverage resampled at x − shift (the
    grayscale subpixel-position raster)."""
    h, w = alpha.shape
    pad = np.zeros((h, w + 2), np.float32)
    pad[:, 1:w + 1] = alpha
    xs = np.arange(w + 1, dtype=np.float32) - shift
    x0 = np.floor(xs).astype(np.int32)
    fr = xs - x0
    x0 = np.clip(x0, -1, w)
    x1 = np.clip(x0 + 1, 0, w + 1)
    return (pad[:, x0 + 1] * (1.0 - fr) + pad[:, x1] * fr).astype(np.float32)


def _apply_font_flags(arr: np.ndarray, left: float, top: float, flags):
    """TRANSPOSE/FLIP_X/FLIP_Y glyph transforms applied to the rasterized
    bitmap + bearings (wr_glyph_rasterizer FontTransform swap_xy/flip_*;
    bearing math mirrors platform/unix/font.rs:713-724).  `arr` is (h, w)
    coverage or (h, w, 3) LCD channel masks; bearings are y-up
    (left, top)."""
    from ..api.font import FontInstanceFlags as F
    h, w = arr.shape[:2]
    tr = bool(flags & F.TRANSPOSE)
    fx = bool(flags & F.FLIP_X)
    fy = bool(flags & F.FLIP_Y)
    # The outline path applies the ops by PREPENDING to the glyph-space
    # input (FontTransform flip_x/swap_xy, rasterizer.rs:356-368): the
    # point pipeline is swap → flip_x → flip_y → scale, so the composite
    # bitmap transform differs per flag combination (derived from the
    # y-up bbox mapping; bearings are y-up (left, top)):
    # FontTransform operates in y-DOWN glyph space (the FT matrix hands
    # negated skews to FreeType's y-up outlines); pipeline on the y-down
    # input point: swap → flip_x → flip_y → scale.  Derived bitmap ops
    # per combination (t_ = transpose; bearings stay y-up (left, top)):
    t_ = np.swapaxes(arr, 0, 1)
    if tr and fx and fy:
        arr, left, top = t_[::-1, ::-1], top - h, left + w
    elif tr and fx:
        arr, left, top = t_[:, ::-1], top - h, -left
    elif tr and fy:
        arr, left, top = t_[::-1, :], -top, left + w
    elif tr:
        arr, left, top = t_, -top, -left
    else:
        if fx:
            arr = arr[:, ::-1]
            left = -(left + w)
        if fy:
            arr = arr[::-1, :]
            top = -(top - h)
    return np.ascontiguousarray(arr), float(left), float(top)


def _to_premult_rgba_f32(desc: ImageDescriptor, data: ImageData,
                         crop=None) -> np.ndarray:
    """Convert template pixels to premultiplied RGBA float32 (h, w, 4);
    `crop` = (x0, y0, w, h) extracts an image-space sub-rect (huge-image
    path, the image_tiling.rs role)."""
    if data.solid is not None:
        ch, cw = (crop[3], crop[2]) if crop else (desc.height, desc.width)
        texel = np.asarray(data.solid, np.float32) / 255.0
        if desc.format == ImageFormat.BGRA8:
            texel = texel[[2, 1, 0, 3]]
            texel[3] = np.float32(data.solid[3]) / 255.0
        return np.broadcast_to(texel, (ch, cw, 4)).copy()
    px = data.pixels
    assert px is not None, "image template has no pixel data"
    h, w = desc.height, desc.width
    fmt = desc.format
    if fmt == ImageFormat.BGRA8:
        arr = px.reshape(h, w, 4).astype(np.float32) / 255.0
        arr = arr[..., [2, 1, 0, 3]]  # BGRA → RGBA
    elif fmt == ImageFormat.RGBA8:
        arr = px.reshape(h, w, 4).astype(np.float32) / 255.0
    elif fmt == ImageFormat.R8:
        a = px.reshape(h, w).astype(np.float32) / 255.0
        arr = np.stack([a, a, a, np.ones_like(a)], axis=-1)
    elif fmt == ImageFormat.RG8:
        rg = px.reshape(h, w, 2).astype(np.float32) / 255.0
        arr = np.stack([rg[..., 0], rg[..., 1], np.zeros((h, w), np.float32),
                        np.ones((h, w), np.float32)], axis=-1)
    elif fmt == ImageFormat.RGBAF32:
        arr = px.reshape(h, w, 4).astype(np.float32)
    else:
        raise NotImplementedError(f"image format {fmt}")
    if crop is not None:
        x0, y0, cw, ch = crop
        arr = arr[y0:y0 + ch, x0:x0 + cw]
    # Texel data arrives already premultiplied (wrench premultiplies PNGs at
    # load — yaml_frame_reader.rs:569 — and Gecko supplies premultiplied
    # BGRA); AlphaType::Alpha images are premultiplied at sample time.
    return arr


class FontContext:
    """FreeType-backed glyph rasterization via matplotlib's bundled ft2font
    (the `wr_glyph_rasterizer` platform/unix/font.rs role)."""

    def __init__(self):
        from matplotlib import ft2font
        self._ft = ft2font
        self.faces: Dict[Tuple[int, int], object] = {}
        self._design_adv: Dict[Tuple[int, int, int], float] = {}
        self._sources: Dict[Tuple[int, int], Tuple] = {}
        self._lcd = None
        import threading
        self._tls = threading.local()

    class _NullFace:
        """Bitmap-strike-only fonts (text/embedded-bitmaps): ft2font
        cannot even open them at a scalable size.  The null face keeps
        the pipeline deterministic on every backend — zero glyph indices,
        zero advances, empty rasters — instead of crashing scene build
        (platform font backends would select the nearest strike; not
        exposed through this binding)."""
        units_per_EM = 1000

        def get_char_index(self, cp):
            return 0

        def set_size(self, *a):
            raise RuntimeError("bitmap-strike-only font")

    def add_font(self, key: FontKey, data: Optional[bytes], path: Optional[str],
                 index: int = 0) -> None:
        try:
            if data is not None:
                face = self._ft.FT2Font(io.BytesIO(data))
            else:
                face = self._ft.FT2Font(path)
        except RuntimeError:
            face = self._NullFace()
        self.faces[(key.namespace, key.key)] = face
        self._sources[(key.namespace, key.key)] = (data, path, index)

    def thread_local_face(self, key: FontKey):
        """FT faces are not thread-safe: worker threads of the glyph pool
        open their own face from the stored source (rasterizer.rs keeps
        per-worker FreeType contexts the same way)."""
        import threading
        tl = self._tls
        k = (key.namespace, key.key)
        faces = getattr(tl, "faces", None)
        if faces is None:
            faces = tl.faces = {}
        face = faces.get(k)
        if face is None:
            data, path, _index = self._sources[k]
            face = self._ft.FT2Font(io.BytesIO(data)) if data is not None \
                else self._ft.FT2Font(path)
            faces[k] = face
        return face

    def rasterize_lcd(self, key: FontKey, size: float, glyph_index: int,
                      subpx_x: float = 0.0):
        """True LCD subpixel raster via the system FreeType
        (platform/unix/font.rs:460 FT_RENDER_MODE_LCD + default FIR
        filter) → ((h, w, 3) channel coverage, left, top)."""
        if self._lcd is None:
            from .ft_lcd import LcdRasterizer
            self._lcd = LcdRasterizer()
        data, path, index = self._sources[(key.namespace, key.key)]
        return self._lcd.render((key.namespace, key.key), data, path,
                                index, size, glyph_index, subpx_x)

    def has_font(self, key: FontKey) -> bool:
        return (key.namespace, key.key) in self.faces

    def delete_font(self, key: FontKey) -> None:
        self.faces.pop((key.namespace, key.key), None)

    def glyph_index(self, key: FontKey, ch: str) -> int:
        face = self.faces[(key.namespace, key.key)]
        return face.get_char_index(ord(ch))

    def linear_advance(self, key: FontKey, size: float, gi: int) -> float:
        """Design-space advance scaled linearly to `size` px — FreeType's
        per-size metrics round through ppem, so advance(2s) != 2*advance(s)
        and layouts at different scales drift (text/mix-blend-layers);
        WR's Au-quantized sizes scale exactly."""
        k = (key.namespace, key.key, gi)
        da = self._design_adv.get(k)
        if da is None:
            face = self.faces[(key.namespace, key.key)]
            upem = face.units_per_EM
            try:
                face.set_size(float(upem), 72)
                g = face.load_glyph(gi, self._ft.LoadFlags.NO_HINTING)
                da = g.linearHoriAdvance / 65536.0 / float(upem)
            except RuntimeError:
                da = 0.0  # bitmap-strike-only font (see rasterize)
            self._design_adv[k] = da
        return da * size

    def rasterize(self, key: FontKey, size: float, glyph_index: int,
                  mono: bool = False, synthetic_bold: float = 0.0,
                  synthetic_italics_deg: float = 0.0, face=None):
        """Render one glyph → (alpha f32 (h, w), left, top, advance).

        left/top: FreeType bitmap bearings — bitmap origin is at
        (pen_x + left, pen_y - top), y-down device space. `mono` renders
        1-bit (FontRenderMode::Mono); synthetic bold/italics emulate the
        wr_glyph_rasterizer embolden/oblique transforms.
        """
        if face is None:
            face = self.faces[(key.namespace, key.key)]
        try:
            face.set_size(size, 72)  # size in px when dpi=72
        except RuntimeError:
            # bitmap-strike-only font (text/embedded-bitmaps): ft2font
            # cannot select arbitrary sizes; degrade to an empty raster
            # deterministically on every backend instead of crashing the
            # pipeline (platform font backends would pick the nearest
            # strike — not exposed through this binding)
            return (np.zeros((0, 0), np.float32), 0.0, 0.0, 0.0)
        glyph = face.load_glyph(glyph_index, self._ft.LoadFlags.RENDER)
        x0, y0, x1, y1 = glyph.bbox  # 26.6 fixed point
        w = (x1 - x0 + 63) // 64 + 1
        h = (y1 - y0 + 63) // 64 + 1
        # NOTE: glyph.width is the advance — zero for combining marks
        # (diacritics.yaml), so only the bbox decides emptiness
        if w <= 1 or h <= 1:
            return (np.zeros((0, 0), np.float32), 0.0, 0.0,
                    glyph.linearHoriAdvance / 65536.0)
        bold_px = int(round(synthetic_bold)) if synthetic_bold > 0 else 0
        shear = float(np.tan(np.radians(synthetic_italics_deg)))             if synthetic_italics_deg else 0.0
        extra_w = bold_px + int(np.ceil(abs(shear) * h))
        img = self._ft.FT2Image(w + extra_w, h)
        # draw_glyph_to_bitmap places the bitmap at (x + bbox.x0/64, ...):
        # glyphs with negative left bearing (combining marks) need a
        # compensating offset or they clip away (diacritics.yaml)
        xoff = int(-(x0 // 64)) if x0 < 0 else 0
        face.draw_glyph_to_bitmap(img, xoff, 0, glyph, antialiased=not mono)
        bitmap = np.asarray(img, dtype=np.uint8)
        alpha = bitmap.astype(np.float32) / 255.0
        if mono:
            alpha = (alpha >= 0.5).astype(np.float32)
        if bold_px:
            out = alpha.copy()
            for dx in range(1, bold_px + 1):
                out[:, dx:] = np.maximum(out[:, dx:], alpha[:, :-dx])
            alpha = out
        if shear:
            out = np.zeros_like(alpha)
            hh = alpha.shape[0]
            for row in range(hh):
                off = shear * (hh - 1 - row)
                i = int(np.floor(off))
                fr = off - i
                shifted = np.roll(alpha[row], i) * (1 - fr) +                     np.roll(alpha[row], i + 1) * fr
                if i >= 0:
                    shifted[:i + 1] = alpha[row][:i + 1] * 0
                out[row] = shifted
            alpha = out
        # crop trailing blank row/col introduced by the padding
        nz = np.nonzero(alpha)
        if len(nz[0]) == 0:
            return (np.zeros((0, 0), np.float32), 0.0, 0.0,
                    glyph.linearHoriAdvance / 65536.0)
        alpha = alpha[: nz[0].max() + 1, : nz[1].max() + 1]
        advance = glyph.linearHoriAdvance / 65536.0
        return alpha, x0 / 64.0, y1 / 64.0, advance


class DeferredFontContext:
    """Stands in for `FontContext` until a font is needed.  `faces` is an
    empty table until then, so memory reports work without FreeType."""

    def __init__(self):
        self._ctx: Optional[FontContext] = None
        self.faces: Dict = {}

    def context(self) -> FontContext:
        if self._ctx is None:
            self._ctx = FontContext()
            self.faces = self._ctx.faces
        return self._ctx

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.context(), name)


class BlobImageHandler:
    """image.rs BlobImageHandler (:374) / AsyncBlobImageRasterizer (:419):
    the embedder registers a callback that rasterizes serialized drawing
    commands into pixels on demand. Through the threaded RenderApi the
    rasterization runs on the SceneBuilder thread during scene build
    (render_api._rasterize_blobs, the AsyncBlobImageRasterizer role);
    direct RenderBackend use falls back to lazy rasterization at the
    first prepare-time request."""

    def rasterize(self, descriptor: ImageDescriptor, blob: bytes,
                  tile_offset=None) -> np.ndarray:
        """Return (h, w, 4) u8 RGBA pixels for the blob."""
        raise NotImplementedError


class CheckerboardBlobHandler(BlobImageHandler):
    """wrench/src/blob.rs:116 CheckerboardRenderer-style test handler: the
    blob bytes encode (tile_size, color)."""

    def rasterize(self, descriptor, blob, tile_offset=None):
        import struct
        ts, r, g, b = struct.unpack("<iBBB", blob[:7])
        h, w = descriptor.height, descriptor.width
        ox, oy = tile_offset or (0, 0)
        ys, xs = np.mgrid[oy:oy + h, ox:ox + w]
        on = ((xs // ts) ^ (ys // ts)) & 1
        img = np.zeros((h, w, 4), np.uint8)
        img[..., 0] = np.where(on, r, 255)
        img[..., 1] = np.where(on, g, 255)
        img[..., 2] = np.where(on, b, 255)
        img[..., 3] = 255
        return img


class ResourceCache:
    """resource_cache.rs ResourceCache analog (images + fonts + glyphs +
    blob images)."""

    def __init__(self, color_atlas_size=(4096, 4096),
                 alpha_atlas_size=(2048, 2048), fonts=None):
        """`fonts`: the glyph answers' source; by default a FontContext
        built when the first font is added or used (fonts.py), so that a
        machine without matplotlib's ft2font builds frames without text."""
        self.color_atlas_size = color_atlas_size
        self.alpha_atlas_size = alpha_atlas_size
        self.color_alloc = ShelfAllocator(color_atlas_size[1], color_atlas_size[0])
        self.alpha_alloc = ShelfAllocator(alpha_atlas_size[1], alpha_atlas_size[0])
        # texture_cache.rs eviction role: a frame stamp marks cache use;
        # on atlas pressure the caches are flushed and re-filled on demand
        # (the reference's ClearCaches / eviction-notice flow, collapsed)
        self.frame_id = 0
        self._glyph_last_use: Dict = {}
        self._glyph_pool = None
        self.images: Dict[int, ImageTemplate] = {}
        # running totals for `memory_report`: the bytes of the templates'
        # pixels and of the cached glyphs' RGBA texels
        self._image_bytes = 0
        self._glyph_bytes = 0
        self.fonts = fonts if fonts is not None else \
            DeferredFontContext()
        self.font_instances: Dict[Tuple[int, int], Tuple[FontKey, float, FontInstanceOptions]] = {}
        self.glyphs: Dict[Tuple, CachedGlyph] = {}
        self.pending_uploads: List[PendingUpload] = []
        self.blob_handler: Optional[BlobImageHandler] = None
        # renderer::ExternalImageHandler plumbing (image.rs External)
        self.external_handler = None
        self._locked_external: List = []
        # LRU stamps + derived caches (crops of huge images, converted YUV)
        self._image_last_use: Dict[int, int] = {}
        self._crop_cache: Dict[Tuple, Tuple] = {}
        self._crop_last_use: Dict[Tuple, int] = {}
        self._yuv_cache: Dict[Tuple, Tuple] = {}
        self._yuv_last_use: Dict[Tuple, int] = {}
        # raw YUV plane residency (in-kernel conversion path)
        self._yuvp_cache: Dict[Tuple, Tuple] = {}
        self._yuvp_last_use: Dict[Tuple, int] = {}
        # monotonically increasing generation shared across add/update so a
        # deleted-then-re-added key never reuses a stale derived-cache entry
        self._generation = 0
        # glyph-metric table cache (frame-build fast path); invalidated by
        # bumping _cache_gen whenever any glyph entry is evicted
        self._metric_cache: Dict[Tuple, Tuple] = {}
        self._cache_gen = 0
        # rendered pattern sources (render_task_cache.rs role): content-keyed
        # textures rasterized once on demand (nine-patch gradient sources)
        self._rendered_sources: Dict[Tuple, int] = {}
        self._synthetic_next = -2

    def get_or_render_source(self, content_key: Tuple, width: int,
                             height: int, render) -> int:
        """Content-keyed rendered texture → image key (the
        render_task_cache.rs role: rasterize once, reuse every frame).
        `render()` returns premultiplied (h, w, 4) u8 texels."""
        key = self._rendered_sources.get(content_key)
        if key is not None and key in self.images:
            return key
        key = self._synthetic_next
        self._synthetic_next -= 1
        px = render()
        self.add_image_template(
            key, ImageDescriptor(ImageFormat.RGBA8, width, height),
            ImageData(pixels=px))
        self._rendered_sources[content_key] = key
        return key

    # --- transaction resource updates (render_api.rs ResourceUpdate) -------
    def add_image_template(self, key: int, descriptor: ImageDescriptor,
                           data: ImageData, tiling=None) -> None:
        """resource_cache.rs:792"""
        old = self.images.get(key)
        if old is not None:
            self._release_image_entries(key, old)
        self._generation += 1
        self._set_template(key, ImageTemplate(descriptor, data,
                                              generation=self._generation))

    def update_image_template(self, key: int, descriptor: ImageDescriptor,
                              data: ImageData, dirty_rect=None) -> None:
        tpl = self.images.get(key)
        self._generation += 1
        region = None
        if tpl and tpl.descriptor.width == descriptor.width \
                and tpl.descriptor.height == descriptor.height:
            region = tpl.region
        elif tpl is not None:
            self._release_image_entries(key, tpl)
        self._set_template(key, ImageTemplate(descriptor, data,
                                              generation=self._generation,
                                              region=region))

    def delete_image_template(self, key: int) -> None:
        self._generation += 1
        tpl = self.images.pop(key, None)
        if tpl is not None:
            self._image_bytes -= _pixel_bytes(tpl)
            self._release_image_entries(key, tpl)
        self._image_last_use.pop(key, None)

    def _set_template(self, key: int, tpl: ImageTemplate) -> None:
        old = self.images.get(key)
        if old is not None:
            self._image_bytes -= _pixel_bytes(old)
        self.images[key] = tpl
        self._image_bytes += _pixel_bytes(tpl)

    def replace_images(self, images: Dict[int, ImageTemplate]) -> None:
        """Installs `images` (a capture's templates) in place of the
        cache's."""
        self.images = images
        self._image_bytes = sum(_pixel_bytes(t) for t in images.values())

    def _release_image_entries(self, key: int, tpl: ImageTemplate) -> None:
        """Free the template's atlas region and every derived-cache entry
        (crops, yuv conversions) referencing it."""
        if tpl.region is not None:
            self.color_alloc.free(tpl.region)
            tpl.region = None
        for ck in [k for k in self._crop_cache if k[0] == key]:
            region = self._crop_cache.pop(ck)[0]
            self._crop_last_use.pop(ck, None)
            self.color_alloc.free(region)
        for yk in [k for k in self._yuv_cache if key in k[1]]:
            region = self._yuv_cache.pop(yk)[0]
            self._yuv_last_use.pop(yk, None)
            self.color_alloc.free(region)
        for yk in [k for k in self._yuvp_cache if key in k[1]]:
            planes = self._yuvp_cache.pop(yk)
            self._yuvp_last_use.pop(yk, None)
            for region, _, _ in planes:
                self.alpha_alloc.free(region)

    def add_font(self, key: FontKey, data=None, path=None, index=0) -> None:
        self._generation += 1
        self.fonts.add_font(key, data, path, index)

    def delete_font(self, key: FontKey) -> None:
        self._generation += 1
        self.fonts.delete_font(key)

    def add_font_instance(self, key: FontInstanceKey, font_key: FontKey,
                          size: float, options: FontInstanceOptions) -> None:
        self._generation += 1
        self.font_instances[(key.namespace, key.key)] = (font_key, size, options)

    def delete_font_instance(self, key: FontInstanceKey) -> None:
        self._generation += 1
        self.font_instances.pop((key.namespace, key.key), None)

    def content_epoch(self) -> Tuple[int, int]:
        """Epoch pair summarizing everything a built Frame reads from this
        cache: (_generation — template/font mutations, _cache_gen — atlas
        address churn from eviction/clears).  A Frame built at epoch E is
        byte-identical to one rebuilt at the same E, so the backend skips
        frame building entirely when nothing changed (gpu_cache.rs:5-25
        epoch design — unchanged content costs zero serialization)."""
        return (self._generation, self._cache_gen)

    # --- prepare-time requests (resource_cache.rs request_image :926) ------
    MAX_DIRECT_DIM = 2048  # larger images upload only their visible sub-rect

    def set_blob_image_handler(self, handler: "BlobImageHandler") -> None:
        """render_api.rs set_blob_image_handler role."""
        self.blob_handler = handler

    def set_blob_image_visible_area(self, key: int, area) -> None:
        """render_api.rs Transaction::set_blob_image_visible_area: restrict
        rasterization to `area` = (x0, y0, x1, y1) in image px; a changed
        area drops the cached raster so the next request re-rasterizes
        exactly the new area (tiled-blob visible-window role)."""
        tpl = self.images.get(key)
        if tpl is None:
            return
        new = tuple(int(v) for v in area)
        if getattr(tpl, "blob_visible_area", None) == new:
            return
        tpl.blob_visible_area = new
        self._image_bytes -= _pixel_bytes(tpl)
        tpl.data.pixels = None
        tpl.generation += 1

    def set_external_image_handler(self, handler) -> None:
        """renderer/mod.rs set_external_image_handler role."""
        self.external_handler = handler

    def unlock_external_images(self) -> None:
        """Release every external image locked during this frame's
        prepare (the renderer's unlock pass after uploads)."""
        h = self.external_handler
        for ext in self._locked_external:
            if h is not None:
                h.unlock(ext.id, ext.channel_index)
        self._locked_external.clear()

    # ------------------------------------------------------------------
    # allocation with eviction pressure (texture_cache.rs LRU eviction:
    # only entries NOT touched this frame are evicted, so regions already
    # embedded in the frame being built stay valid)
    # ------------------------------------------------------------------
    def _evict_stale_images(self) -> int:
        freed = self._evict_stale_images_inner()
        if freed:
            # atlas addresses changed — retained frames referencing them
            # are invalid (gpu_cache.rs epoch role)
            self._cache_gen += 1
        return freed

    def _evict_stale_images_inner(self) -> int:
        freed = 0
        for key, tpl in self.images.items():
            if tpl.region is not None and \
                    self._image_last_use.get(key, -1) < self.frame_id:
                self.color_alloc.free(tpl.region)
                tpl.region = None
                tpl.uploaded_generation = -1
                freed += 1
        for ck in [k for k, lu in self._crop_last_use.items()
                   if lu < self.frame_id]:
            entry = self._crop_cache.pop(ck, None)
            self._crop_last_use.pop(ck, None)
            if entry is not None:
                self.color_alloc.free(entry[0])
                freed += 1
        for yk in [k for k, lu in self._yuv_last_use.items()
                   if lu < self.frame_id]:
            entry = self._yuv_cache.pop(yk, None)
            self._yuv_last_use.pop(yk, None)
            if entry is not None:
                self.color_alloc.free(entry[0])
                freed += 1
        for yk in [k for k, lu in self._yuvp_last_use.items()
                   if lu < self.frame_id]:
            planes = self._yuvp_cache.pop(yk, None)
            self._yuvp_last_use.pop(yk, None)
            if planes is not None:
                for region, _, _ in planes:
                    self.alpha_alloc.free(region)
                freed += 1
        return freed

    def _evict_stale_glyphs(self) -> int:
        """Free glyphs not used this frame (both atlases — grayscale masks
        live in the alpha atlas, LCD masks in the color atlas)."""
        freed = 0
        for gk in [k for k, lu in self._glyph_last_use.items()
                   if lu < self.frame_id]:
            cg = self.glyphs.pop(gk, None)
            self._glyph_last_use.pop(gk, None)
            if cg is not None:
                self._glyph_bytes -= cg.width * cg.height * 4
            if cg is not None and cg.region is not None:
                (self.color_alloc if cg.subpixel
                 else self.alpha_alloc).free(cg.region)
                freed += 1
        if freed:
            self._cache_gen += 1
            self._metric_cache.clear()
        return freed

    def request_glyph_metrics(self, font_instance_key: int, ids_key: tuple,
                              scale: float, render_mode, subpx_x: float):
        """Frame-build fast path: cached (table [U,7], ok [U], subpx) glyph
        metric arrays for a sorted unique id tuple — skips per-glyph dict
        walks on repeat frames.  Table cols: left, top, w, h, region.x,
        region.y, subpixel.  Touches the LRU stamps so eviction never frees
        glyphs referenced through a cached table."""
        key = (font_instance_key, ids_key, scale, render_mode, subpx_x,
               self._cache_gen)
        hit = self._metric_cache.get(key)
        if hit is not None:
            table, ok, subpx, cache_keys = hit
            fid = self.frame_id
            self._glyph_last_use.update((k, fid) for k in cache_keys)
            return table, ok, subpx
        cache = self.request_glyphs(font_instance_key, list(ids_key),
                                    scale=scale, render_mode=render_mode,
                                    subpx_x=subpx_x)
        u = len(ids_key)
        table = np.zeros((u, 6), np.float64)
        ok = np.zeros(u, bool)
        subpx = False
        for k, gid in enumerate(ids_key):
            cg = cache.get(int(gid))
            if cg is None or cg.region is None:
                continue
            ok[k] = True
            subpx = subpx or cg.subpixel
            table[k] = (cg.left, cg.top, cg.width, cg.height,
                        cg.region.x, cg.region.y)
        # the per-glyph cache keys this table pins (for LRU touching)
        fi = self.font_instances.get((0, font_instance_key))
        cache_keys = []
        if fi is not None:
            font_key, size, options = fi
            from ..api.font import FontInstanceFlags
            mode = render_mode if render_mode is not None else \
                options.render_mode
            mono = mode == FontRenderMode.MONO
            sp = mode == FontRenderMode.SUBPIXEL
            sz = size * scale
            bold = sz / 16.0 if (options.flags &
                                 FontInstanceFlags.SYNTHETIC_BOLD) else 0.0
            italics = options.synthetic_italics.angle_deg
            cache_keys = [(font_key.namespace, font_key.key, sz, gi, mono,
                           bold, italics, sp, subpx_x) for gi in ids_key]
        self._metric_cache[key] = (table, ok, subpx, cache_keys)
        return table, ok, subpx

    def _alloc_color(self, w: int, h: int, what: str) -> AtlasRegion:
        region = self.color_alloc.alloc(w, h)
        if region is None:
            self._evict_stale_images()
            self._evict_stale_glyphs()
            region = self.color_alloc.alloc(w, h)
        if region is None:
            raise AtlasFullError(f"color atlas full ({what}, {w}x{h})")
        return region

    def _alloc_alpha(self, w: int, h: int, what: str) -> AtlasRegion:
        region = self.alpha_alloc.alloc(w, h)
        if region is None:
            self._evict_stale_glyphs()
            region = self.alpha_alloc.alloc(w, h)
        if region is None:
            raise AtlasFullError(f"alpha atlas full ({what}, {w}x{h})")
        return region

    def request_image(self, key: int):
        tpl = self.images.get(key)
        if tpl is None:
            return None
        self._image_last_use[key] = self.frame_id
        if tpl.data.external is not None:
            # external image: lock for this frame, upload when the
            # handler's generation changed (or always, if untracked)
            ext = tpl.data.external
            assert self.external_handler is not None, \
                "external image used with no ExternalImageHandler"
            img = self.external_handler.lock(ext.id, ext.channel_index)
            self._locked_external.append(ext)
            if tpl.region is None:
                tpl.region = self._alloc_color(tpl.descriptor.width,
                                               tpl.descriptor.height,
                                               "image")
            gen = ("ext", img.generation)
            if img.generation is None or tpl.uploaded_generation != gen:
                texels = _to_premult_rgba_f32(
                    tpl.descriptor, ImageData(pixels=img.pixels))
                self.pending_uploads.append(PendingUpload(
                    ATLAS_COLOR,
                    AtlasRegion(tpl.region.x, tpl.region.y,
                                tpl.descriptor.width, tpl.descriptor.height),
                    texels))
                tpl.uploaded_generation = gen if img.generation is not None \
                    else -2
            return tpl.region, tpl.descriptor
        if tpl.data.pixels is None and tpl.data.blob is not None:
            # blob rasterization (doc/blob.md async path, run lazily).
            # With a visible area set (render_api.rs
            # set_blob_image_visible_area) only that sub-rect rasterizes —
            # content outside the area stays blank until the area moves
            # (rawtest.rs test_blob_visible_area semantics)
            assert self.blob_handler is not None, "no blob image handler"
            area = getattr(tpl, "blob_visible_area", None)
            if area is None:
                px = self.blob_handler.rasterize(tpl.descriptor,
                                                 tpl.data.blob)
            else:
                W, H = tpl.descriptor.width, tpl.descriptor.height
                ax0 = max(0, int(area[0]))
                ay0 = max(0, int(area[1]))
                ax1 = min(W, int(area[2]))
                ay1 = min(H, int(area[3]))
                px = np.zeros((H, W, 4), np.uint8)
                if ax1 > ax0 and ay1 > ay0:
                    sub_desc = ImageDescriptor(
                        ImageFormat.RGBA8, ax1 - ax0, ay1 - ay0,
                        flags=tpl.descriptor.flags)
                    px[ay0:ay1, ax0:ax1] = self.blob_handler.rasterize(
                        sub_desc, tpl.data.blob, tile_offset=(ax0, ay0))
            tpl.data.pixels = px
            self._image_bytes += px.nbytes
            tpl.descriptor = ImageDescriptor(
                ImageFormat.RGBA8, tpl.descriptor.width,
                tpl.descriptor.height, flags=tpl.descriptor.flags)
        if tpl.region is None:
            tpl.region = self._alloc_color(tpl.descriptor.width,
                                           tpl.descriptor.height, "image")
        if tpl.uploaded_generation != tpl.generation:
            texels = _to_premult_rgba_f32(tpl.descriptor, tpl.data)
            up_region = AtlasRegion(tpl.region.x, tpl.region.y,
                                    tpl.descriptor.width, tpl.descriptor.height)
            self.pending_uploads.append(
                PendingUpload(ATLAS_COLOR, up_region, texels))
            tpl.uploaded_generation = tpl.generation
        return tpl.region, tpl.descriptor

    def request_image_resampled(self, key: int, rkey: Tuple, w: int, h: int,
                                render):
        """Device-resolution pre-resample of a huge image's visible region
        (image_tiling.rs role, re-designed: instead of decomposing into
        512px tiles — which cannot all be atlas-resident for an 8192²
        source — the host resamples the visible rect at device resolution
        with the same bilinear math the device would use, and the kernel
        samples it 1:1).  `render()` returns (h, w, 4) premultiplied f32."""
        tpl = self.images.get(key)
        if tpl is None:
            return None
        ck = (key, "resample", tpl.generation) + rkey
        hit = self._crop_cache.get(ck)
        if hit is not None:
            self._crop_last_use[ck] = self.frame_id
            return hit
        mine = [k for k in self._crop_cache
                if k[0] == key and len(k) > 1 and k[1] == "resample"]
        if len(mine) >= 2:
            for k in mine:
                if self._crop_last_use.get(k, -1) < self.frame_id:
                    entry = self._crop_cache.pop(k)
                    self._crop_last_use.pop(k, None)
                    self.color_alloc.free(entry[0])
        region = self._alloc_color(w, h, "resample")
        region = AtlasRegion(region.x, region.y, w, h)
        texels = render()
        self.pending_uploads.append(PendingUpload(ATLAS_COLOR, region,
                                                  texels))
        result = (region,)
        self._crop_cache[ck] = result
        self._crop_last_use[ck] = self.frame_id
        return result

    def request_image_sub(self, key: int, img_rect):
        """Upload only the visible image-space sub-rect of a huge image
        (the image_tiling.rs 512px-tile decomposition re-designed as lazy
        sub-rect residency). img_rect = (x0, y0, x1, y1) in image px.
        Returns (AtlasRegion of the crop, descriptor, crop_origin)."""
        tpl = self.images.get(key)
        if tpl is None:
            return None
        desc = tpl.descriptor
        x0 = max(0, int(np.floor(img_rect[0])) - 1)
        y0 = max(0, int(np.floor(img_rect[1])) - 1)
        x1 = min(desc.width, int(np.ceil(img_rect[2])) + 1)
        y1 = min(desc.height, int(np.ceil(img_rect[3])) + 1)
        cw = max(1, min(x1 - x0, self.MAX_DIRECT_DIM))
        ch = max(1, min(y1 - y0, self.MAX_DIRECT_DIM))
        ck = (key, x0, y0, cw, ch, tpl.generation)
        hit = self._crop_cache.get(ck)
        if hit is not None:
            self._crop_last_use[ck] = self.frame_id
            return hit
        # bound the per-key crop count: scrolling over a huge image must not
        # leak atlas space (evict this key's crops not used this frame)
        mine = [k for k in self._crop_cache if k[0] == key]
        if len(mine) >= 4:
            for k in mine:
                if self._crop_last_use.get(k, -1) < self.frame_id:
                    entry = self._crop_cache.pop(k)
                    self._crop_last_use.pop(k, None)
                    self.color_alloc.free(entry[0])
        region = self._alloc_color(cw, ch, "crop")
        region = AtlasRegion(region.x, region.y, cw, ch)
        texels = _to_premult_rgba_f32(desc, tpl.data, crop=(x0, y0, cw, ch))
        self.pending_uploads.append(PendingUpload(ATLAS_COLOR, region, texels))
        result = (region, desc, (x0, y0))
        self._crop_cache[ck] = result
        self._crop_last_use[ck] = self.frame_id
        return result

    # GlyphRasterizer rayon-pool role (rasterizer.rs:141): uncached glyph
    # batches rasterize on a thread pool when enabled (GLYPH_BATCH_SIZE=32)
    GLYPH_BATCH_SIZE = 32
    glyph_workers: int = 0   # 0 = synchronous (single-core hosts)

    def request_glyphs(self, font_instance_key: int,
                       glyph_indices, subpixel_quantize: bool = True,
                       scale: float = 1.0,
                       render_mode=None,
                       subpx_x: float = 0.0) -> Dict[int, CachedGlyph]:
        """resource_cache.rs request_glyphs :1092 → GlyphRasterizer.

        `scale`: device scale of the text's transform — glyphs raster at
        size·scale so scaled text stays sharp (the FontTransform /
        glyph raster-space role); returned metrics are in RASTER px."""
        fi = self.font_instances.get((0, font_instance_key))
        if fi is None:
            return {}
        font_key, size, options = fi
        size = size * scale
        from ..api.font import FontInstanceFlags
        mode = render_mode if render_mode is not None else \
            options.render_mode
        mono = mode == FontRenderMode.MONO
        subpx = mode == FontRenderMode.SUBPIXEL
        bold = size / 16.0 if (options.flags &
                               FontInstanceFlags.SYNTHETIC_BOLD) else 0.0
        italics = options.synthetic_italics.angle_deg
        ttf_flags = options.flags & (FontInstanceFlags.TRANSPOSE |
                                     FontInstanceFlags.FLIP_X |
                                     FontInstanceFlags.FLIP_Y)
        out = {}
        ids = sorted(set(glyph_indices))
        raster_cache = {}
        missing = [gi for gi in ids
                   if (font_key.namespace, font_key.key, size, gi, mono,
                       bold, italics, subpx, subpx_x) not in self.glyphs]
        if self.glyph_workers > 0 and len(missing) > 1:
            # rasterizer.rs:141 — batch uncached glyphs across the pool
            import concurrent.futures
            if self._glyph_pool is None:
                self._glyph_pool = concurrent.futures.ThreadPoolExecutor(
                    self.glyph_workers)

            def raster_one(gi):
                face = self.fonts.thread_local_face(font_key)
                return gi, self.fonts.rasterize(
                    font_key, size, gi, mono=mono, synthetic_bold=bold,
                    synthetic_italics_deg=italics, face=face)
            for gi, res in self._glyph_pool.map(
                    raster_one, missing,
                    chunksize=self.GLYPH_BATCH_SIZE):
                raster_cache[gi] = res
        for gi in ids:
            cache_key = (font_key.namespace, font_key.key, size, gi,
                         mono, bold, italics, subpx, subpx_x,
                         int(ttf_flags))
            cached = self.glyphs.get(cache_key)
            if cached is None:
                alpha, left, top, _adv = raster_cache.get(gi) or \
                    self.fonts.rasterize(
                        font_key, size, gi, mono=mono, synthetic_bold=bold,
                        synthetic_italics_deg=italics)
                h, w = alpha.shape
                if h == 0 or w == 0:
                    cached = CachedGlyph(None, left, top, w, h)
                elif subpx:
                    # true LCD per-channel masks via system FreeType
                    # (FT_RENDER_MODE_LCD, platform/unix/font.rs:460);
                    # synthetic bold/italics fall back to the grayscale
                    # tap fabrication (no FT embolden binding)
                    masks = None
                    if bold == 0.0 and italics == 0.0:
                        try:
                            m3, l_, t_ = self.fonts.rasterize_lcd(
                                font_key, size, gi, subpx_x)
                            if ttf_flags:
                                m3, l_, t_ = _apply_font_flags(
                                    m3, l_, t_, ttf_flags)
                            masks = np.concatenate(
                                [m3, m3.max(-1, keepdims=True)], -1)
                            left, top = l_, t_
                        except Exception:  # noqa: BLE001 — fall back
                            masks = None
                    if masks is None:
                        if ttf_flags:
                            alpha, left, top = _apply_font_flags(
                                alpha, left, top, ttf_flags)
                        masks = _subpixel_masks(alpha, subpx_x)
                    h2, w2 = masks.shape[:2]
                    # 2-texel zero border: bilinear taps of the 1-texel-
                    # inset uv ring never reach atlas neighbours, keeping
                    # the Pallas DMA path bit-identical to clamped sampling
                    pm = np.zeros((h2 + 4, w2 + 4, 4), np.float32)
                    pm[2:2 + h2, 2:2 + w2] = masks
                    region = self._alloc_color(w2 + 4, h2 + 4, "subpx glyph")
                    region = AtlasRegion(region.x, region.y, w2 + 4, h2 + 4)
                    self.pending_uploads.append(
                        PendingUpload(ATLAS_COLOR, region, pm))
                    cached = CachedGlyph(region, left, top, w2, h2,
                                         subpixel=True)
                else:
                    if ttf_flags:
                        alpha, left, top = _apply_font_flags(
                            alpha, left, top, ttf_flags)
                        h, w = alpha.shape
                    if subpx_x > 0.0 and not mono:
                        alpha = _shift_bitmap(alpha, subpx_x)
                        h, w = alpha.shape
                    pa = np.zeros((h + 4, w + 4), np.float32)
                    pa[2:2 + h, 2:2 + w] = alpha
                    region = self._alloc_alpha(w + 4, h + 4, "glyph")
                    region = AtlasRegion(region.x, region.y, w + 4, h + 4)
                    self.pending_uploads.append(
                        PendingUpload(ATLAS_ALPHA, region, pa))
                    cached = CachedGlyph(region, left, top, w, h)
                self.glyphs[cache_key] = cached
                self._glyph_bytes += cached.width * cached.height * 4
            out[gi] = cached
            self._glyph_last_use[cache_key] = self.frame_id
        return out

    # ------------------------------------------------------------------
    # cache pressure (texture_cache.rs eviction / ClearCaches role)
    # ------------------------------------------------------------------
    def begin_frame(self) -> None:
        self.frame_id += 1

    def clear_glyph_caches(self) -> None:
        """Drop all cached glyph atlas entries; they re-rasterize on the
        next request (the texture cache's eviction response).  Subpixel
        (LCD) masks live in the color atlas and are freed individually."""
        for cg in self.glyphs.values():
            if cg.subpixel and cg.region is not None:
                self.color_alloc.free(cg.region)
        self.glyphs.clear()
        self._glyph_bytes = 0
        self._glyph_last_use.clear()
        self._metric_cache.clear()
        self._cache_gen += 1
        # raw YUV planes share the alpha atlas with glyph masks
        self._yuvp_cache.clear()
        self._yuvp_last_use.clear()
        self.alpha_alloc = ShelfAllocator(self.alpha_alloc.width,
                                          self.alpha_alloc.height)

    def clear_image_caches(self) -> None:
        for tpl in self.images.values():
            tpl.region = None
            tpl.uploaded_generation = -1
        self._crop_cache.clear()
        self._crop_last_use.clear()
        self._yuv_cache.clear()
        self._yuv_last_use.clear()
        self._yuvp_cache.clear()
        self._yuvp_last_use.clear()
        self.color_alloc = ShelfAllocator(self.color_alloc.width,
                                          self.color_alloc.height)
        # subpixel glyph masks live in the color atlas too
        self.glyphs.clear()
        self._glyph_bytes = 0
        self._glyph_last_use.clear()
        self._metric_cache.clear()
        self._cache_gen += 1
        self.alpha_alloc = ShelfAllocator(self.alpha_alloc.width,
                                          self.alpha_alloc.height)

    def memory_pressure(self) -> None:
        """render_api ClearCaches / NotifyMemoryPressure.  Pending uploads
        are dropped too: they address regions of the cleared allocators and
        every consumer re-requests (and re-uploads) after a clear."""
        self.clear_glyph_caches()
        self.clear_image_caches()
        self.pending_uploads.clear()

    def font_instance(self, font_instance_key: int):
        return self.font_instances.get((0, font_instance_key))

    def request_yuv_planes(self, yuv_keys, fmt: str):
        """Raw plane residency for the in-kernel YUV path (yuv.glsl
        sample_yuv role): Y/U/V land in the ALPHA atlas as three A8
        regions; NV12 / interleaved sources are split into planar on the
        host (a u8 shuffle — the per-pixel color conversion happens in
        the raster kernel).  Returns ((region,w,h) x3) or None (missing
        template or >8-bit data → caller falls back to host conversion)."""
        cache_key = ("yuvp", tuple(yuv_keys),
                     tuple(self.images[k].generation
                           for k in yuv_keys if k in self.images))
        hit = self._yuvp_cache.get(cache_key)
        if hit is not None:
            self._yuvp_last_use[cache_key] = self.frame_id
            return hit
        raw = []
        for k in yuv_keys:
            tpl = self.images.get(k)
            if tpl is None or tpl.data.pixels is None:
                return None
            desc = tpl.descriptor
            px = tpl.data.pixels
            if desc.format == ImageFormat.R8:
                raw.append(px.reshape(desc.height, desc.width)
                           .astype(np.float32) / 255.0)
            elif desc.format == ImageFormat.RG8:
                raw.append(px.reshape(desc.height, desc.width, 2)
                           .astype(np.float32) / 255.0)
            elif desc.format in (ImageFormat.RGBA8, ImageFormat.BGRA8):
                arr = px.reshape(desc.height, desc.width, -1) \
                    .astype(np.float32) / 255.0
                if desc.format == ImageFormat.BGRA8 and arr.shape[-1] == 4:
                    arr = arr[..., [2, 1, 0, 3]]
                raw.append(arr)
            else:
                return None  # R16 / P010: host-convert fallback
        if fmt == "planar" and len(raw) == 3:
            planes = [raw[0], raw[1], raw[2]]
        elif fmt == "nv12" and len(raw) == 2 and raw[1].ndim == 3:
            planes = [raw[0], raw[1][..., 0], raw[1][..., 1]]
        elif fmt == "interleaved" and raw[0].ndim == 3:
            # yuv.glsl:219 — interleaved samples .gbr
            planes = [raw[0][..., 1], raw[0][..., 2], raw[0][..., 0]]
        else:
            return None
        out = []
        for pl_ in planes:
            h, w = pl_.shape
            region = self._alloc_alpha(w, h, "yuv plane")
            region = AtlasRegion(region.x, region.y, w, h)
            self.pending_uploads.append(
                PendingUpload(ATLAS_ALPHA, region, pl_))
            out.append((region, w, h))
        result = tuple(out)
        self._yuvp_cache[cache_key] = result
        self._yuvp_last_use[cache_key] = self.frame_id
        return result

    def request_yuv_image(self, yuv_keys, fmt: str, color_space, color_range,
                          color_depth):
        """YUV planes → RGBA conversion at upload (the `yuv.glsl` matrices,
        host-side for now; an in-kernel YUV path is a later optimization).
        Returns (AtlasRegion, w, h) of the converted RGBA image."""
        from ..api.display_item import ColorRange, YuvColorSpace
        cache_key = ("yuv", tuple(yuv_keys),
                     tuple(self.images[k].generation
                           for k in yuv_keys if k in self.images))
        hit = self._yuv_cache.get(cache_key)
        if hit is not None:
            self._yuv_last_use[cache_key] = self.frame_id
            return hit
        planes = []
        for k in yuv_keys:
            tpl = self.images.get(k)
            if tpl is None:
                return None
            desc = tpl.descriptor
            px = tpl.data.pixels
            if desc.format == ImageFormat.R8:
                planes.append(px.reshape(desc.height, desc.width)
                              .astype(np.float32) / 255.0)
            elif desc.format == ImageFormat.RG8:
                planes.append(px.reshape(desc.height, desc.width, 2)
                              .astype(np.float32) / 255.0)
            elif desc.format == ImageFormat.R16:
                planes.append(px.reshape(desc.height, desc.width)
                              .astype(np.float32) / 65535.0)
            else:
                arr = px.reshape(desc.height, desc.width, -1) \
                    .astype(np.float32) / 255.0
                if desc.format == ImageFormat.BGRA8 and arr.shape[-1] == 4:
                    # normalize to channel order 0=Y/U,1=U/V,2=V (PNG-
                    # sourced planes arrive swizzled as BGRA)
                    arr = arr[..., [2, 1, 0, 3]]
                planes.append(arr)
        if fmt == "planar":
            y, u, v = planes[0], planes[1], planes[2]
        elif fmt == "nv12":
            y = planes[0]
            u, v = planes[1][..., 0], planes[1][..., 1]
        elif fmt == "interleaved":
            # yuv.glsl:219 — interleaved texels sample .gbr: Y lives in G,
            # Cb in B, Cr in R
            y = planes[0][..., 1]
            u, v = planes[0][..., 2], planes[0][..., 0]
        else:
            raise NotImplementedError(f"yuv format {fmt}")
        h, w = y.shape
        # upsample chroma to luma size (bilinear would match GL; nearest is
        # within reftest fuzz for 2x)
        if u.shape != y.shape:
            ry, rx = h // u.shape[0], w // u.shape[1]
            u = np.repeat(np.repeat(u, ry, 0), rx, 1)[:h, :w]
            v = np.repeat(np.repeat(v, ry, 0), rx, 1)[:h, :w]
        if color_range == ColorRange.LIMITED:
            y = (y - 16.0 / 255.0) * (255.0 / 219.0)
            u = (u - 128.0 / 255.0) * (255.0 / 224.0)
            v = (v - 128.0 / 255.0) * (255.0 / 224.0)
        else:
            u = u - 128.0 / 255.0
            v = v - 128.0 / 255.0
        if color_space == YuvColorSpace.REC601:
            kr, kb = 0.299, 0.114
        elif color_space == YuvColorSpace.REC709:
            kr, kb = 0.2126, 0.0722
        elif color_space == YuvColorSpace.REC2020:
            kr, kb = 0.2627, 0.0593
        else:  # IDENTITY (GBR)
            kr, kb = None, None
        if kr is None:
            r, g, b = v, y, u
        else:
            kg = 1.0 - kr - kb
            r = y + 2.0 * (1.0 - kr) * v
            b = y + 2.0 * (1.0 - kb) * u
            g = y - (2.0 * kr * (1.0 - kr) / kg) * v - \
                (2.0 * kb * (1.0 - kb) / kg) * u
        rgba = np.clip(np.stack(
            [r, g, b, np.ones_like(y)], axis=-1), 0.0, 1.0).astype(np.float32)
        region = self._alloc_color(w, h, "yuv")
        region = AtlasRegion(region.x, region.y, w, h)
        self.pending_uploads.append(PendingUpload(ATLAS_COLOR, region, rgba))
        result = (region, w, h)
        self._yuv_cache[cache_key] = result
        self._yuv_last_use[cache_key] = self.frame_id
        return result

    # --- observability -------------------------------------------------------
    def memory_report(self) -> Dict[str, int]:
        """MemoryReport (wr_malloc_size_of role): byte sizes per cache."""
        return {
            "image_templates": self._image_bytes,
            "glyph_cache": self._glyph_bytes,
            "color_atlas": self.color_atlas_size[0] *
            self.color_atlas_size[1] * 16,
            "alpha_atlas": self.alpha_atlas_size[0] *
            self.alpha_atlas_size[1] * 4,
            "fonts": len(self.fonts.faces),
        }

    # --- renderer side -----------------------------------------------------
    def take_uploads(self) -> List[PendingUpload]:
        out = self.pending_uploads
        self.pending_uploads = []
        return out
