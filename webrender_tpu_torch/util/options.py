"""Configuration — `renderer/init.rs:118` WebRenderOptions and
`webrender_api/lib.rs:664` DebugFlags equivalents: startup options + runtime
debug toggles threaded through the backend/renderer."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Tuple


class DebugFlags(enum.IntFlag):
    """webrender_api/lib.rs:664-737 DebugFlags — full set at the
    reference's bit positions.  Flags tied to GL specifics keep their
    slot (so bit patterns round-trip through captures) and map onto the
    nearest TPU-pipeline behavior or act as recorded-but-inert toggles."""
    NONE = 0
    PROFILER_DBG = 1 << 0
    RENDER_TARGET_DBG = 1 << 1
    TEXTURE_CACHE_DBG = 1 << 2
    GPU_TIME_QUERIES = 1 << 3
    GPU_SAMPLE_QUERIES = 1 << 4
    DISABLE_BATCHING = 1 << 5
    EPOCHS = 1 << 6
    ECHO_DRIVER_MESSAGES = 1 << 7
    SHOW_OVERDRAW = 1 << 8
    GPU_CACHE_DBG = 1 << 9
    TEXTURE_CACHE_DBG_CLEAR_EVICTED = 1 << 10
    PICTURE_CACHING_DBG = 1 << 11
    TILE_CACHE_DBG = 1 << 11            # legacy alias used in this repo
    PRIMITIVE_DBG = 1 << 12
    ZOOM_DBG = 1 << 13
    SMALL_SCREEN = 1 << 14
    DISABLE_OPAQUE_PASS = 1 << 15
    DISABLE_ALPHA_PASS = 1 << 16
    DISABLE_CLIP_MASKS = 1 << 17
    DISABLE_TEXT_PRIMS = 1 << 18
    DISABLE_GRADIENT_PRIMS = 1 << 19
    OBSCURE_IMAGES = 1 << 20
    GLYPH_FLASHING = 1 << 21
    SMART_PROFILER = 1 << 22
    INVALIDATION_DBG = 1 << 23
    PROFILER_CAPTURE = 1 << 25
    FORCE_PICTURE_INVALIDATION = 1 << 26
    WINDOW_VISIBILITY_DBG = 1 << 27
    RESTRICT_BLOB_SIZE = 1 << 28
    SURFACE_PROMOTION_LOGGING = 1 << 29
    # TPU-edition extras (no reference slot): disable picture caching /
    # raster-root scaling entirely, highlight backdrop filters
    DISABLE_PICTURE_CACHING = 1 << 30
    DISABLE_RASTER_ROOT_SCALING = 1 << 31
    HIGHLIGHT_BACKDROP_FILTERS = 1 << 24


@dataclass
class QualitySettings:
    """webrender_api QualitySettings."""
    force_subpixel_aa_where_possible: bool = False


@dataclass
class WebRenderOptions:
    """renderer/init.rs:118-199 WebRenderOptions, TPU edition."""
    device_pixel_ratio: float = 1.0
    clear_color: Optional[Tuple[float, float, float, float]] = (1, 1, 1, 1)
    # cache sizes (texture_cache.rs budgets)
    color_atlas_size: Tuple[int, int] = (4096, 4096)
    alpha_atlas_size: Tuple[int, int] = (2048, 2048)
    surface_atlas_size: Tuple[int, int] = (2048, 4096)
    # pipeline
    enable_picture_caching: bool = True
    support_low_priority_transactions: bool = False
    enable_multithreading: bool = True
    # debugging
    debug_flags: DebugFlags = DebugFlags.NONE
    precache_kernels: bool = False   # compile common kernel variants upfront
    quality: QualitySettings = field(default_factory=QualitySettings)


def apply_options(backend, options: WebRenderOptions) -> None:
    """Thread options into an existing backend/renderer (the SetParameter /
    SetFlags runtime path, render_backend.rs:11)."""
    backend.dpr = options.device_pixel_ratio
    r = backend.renderer
    r.picture_caching = options.enable_picture_caching and not (
        options.debug_flags & DebugFlags.DISABLE_PICTURE_CACHING)
    r.debug_flags = int(options.debug_flags)
    r.profiler = backend.profiler
