"""Profiler — counters, per-stage timings, expected budgets, and the
port's frame recorder.

Mirrors `webrender/src/profiler.rs`: the full named-counter registry with
*expected ranges* (the implicit 60 Hz SLOs, profiler.rs:346-366 and the
whole counter table through :560), the UI string presets
(profiler.rs:55-105, including nested-preset expansion and the
`#graph` / `*indicator` / `|`,`_` layout tokens), RenderReasons
accounting (profiler.rs:244-261), and text report output in place of the
on-screen overlay. `ProfilerHooks`-style callbacks let an embedder attach
markers.

The frame recorder (`span`, `count`, `end_frame`, `frames`) is the port's
one tracing system: process-wide, like `ops.tile_raster.LaunchCounts`, so
that a reader finds the frames after the backend that made them is gone.
A span records `(name, start_ns, end_ns, parent, thread)` on
`time.perf_counter_ns`'s clock; its parent is the name of the innermost
span still open on the same thread.  Every span closed and every count
made between two frame ends belongs to the later frame;
`Renderer.render_device` ends a frame on every way out.  The last
`RING_FRAMES` frames are kept in memory, nothing is written out.  A span
or a count never waits for the device or reads a tensor's values.
`set_enabled(False)` makes `span` a shared no-op and `count` a return.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from threading import get_ident
from time import perf_counter_ns
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple


@dataclass
class CounterDef:
    name: str          # snake_case key used at call sites
    label: str         # overlay label (profiler.rs counter strings)
    unit: str = "ms"
    # expected (max, avg) budgets — highlight when exceeded
    expected_max: Optional[float] = None
    expected_avg: Optional[float] = None


def _c(name, label, unit="ms", mx=None, avg=None):
    return CounterDef(name, label, unit, mx, avg)


# The full profiler.rs counter table (profiler.rs:118-289 ids,
# :346-560 labels/units/expected ranges).  Counters that measure GL
# driver minutiae are kept — the TPU pipeline has direct analogs
# (staging copies → host-side np staging, cache textures → HBM arrays).
COUNTER_LIST: List[CounterDef] = [
    # frame stage times (profiler.rs:346-353)
    _c("frame_build_time", "Frame building", "ms", 6.0, 3.0),
    _c("visibility_time", "Visibility", "ms", 3.0, 2.0),
    _c("prepare_time", "Prepare", "ms", 3.0, 2.0),
    _c("batching_time", "Batching", "ms", 3.0, 2.0),
    _c("renderer_time", "Renderer", "ms", 8.0, 5.0),
    _c("frame_cpu_total", "Frame CPU total", "ms", 15.0, 6.0),
    _c("gpu_time", "GPU", "ms", 15.0, 8.0),
    # transaction times (:355-359)
    _c("content_send_time", "Content send", "ms", 1.0, 1.0),
    _c("api_send_time", "API send", "ms", 1.0, 0.4),
    _c("dl_build_time", "DisplayList", "ms", 5.0, 3.0),
    _c("dl_mem", "DisplayList mem", "MB", 20.0),
    _c("scene_build_time", "Scene building", "ms", 4.0, 3.0),
    _c("slow_frames", "Slow frame", "", 0.0),
    _c("slow_transactions", "Slow transaction", "", 0.0),
    _c("frame_time", "Frame time", "ms"),
    # texture upload path (:366-378)
    _c("texture_uploads", "Texture uploads", "count", 10.0),
    _c("texture_uploads_mem", "Texture uploads mem", "MB", 10.0),
    _c("texture_cache_update_time", "Texture cache update", "ms", 3.0),
    _c("staging_cpu_allocation_time", "Staging CPU allocation", "ms"),
    _c("staging_gpu_allocation_time", "Staging GPU allocation", "ms"),
    _c("staging_cpu_copy_time", "Staging CPU copy", "ms"),
    _c("staging_gpu_copy_time", "Staging GPU copy", "ms"),
    _c("upload_time", "Upload time", "ms"),
    _c("upload_num_copy_batches", "Upload copy batches", "count"),
    _c("total_upload_time", "Texture cache upload", "ms", 5.0),
    _c("create_cache_texture_time", "Cache texture creation", "ms", 2.0),
    _c("delete_cache_texture_time", "Cache texture deletion", "ms", 1.0),
    _c("gpu_cache_upload_time", "GPU cache upload", "ms", 2.0),
    # blobs (:380-383)
    _c("rasterized_blobs", "Rasterized blobs", "count", 15.0),
    _c("rasterized_blob_tiles", "Rasterized blob tiles", "count", 15.0),
    _c("rasterized_blobs_px", "Rasterized blob pixels", "px", 300_000.0),
    _c("blob_rasterization_time", "Blob rasterization", "ms", 8.0),
    # glyphs (:385-386)
    _c("rasterized_glyphs", "Rasterized glyphs", "count", 15.0),
    _c("glyph_resolve_time", "Glyph resolve", "ms", 4.0),
    # frame content stats (:388-...)
    _c("draw_calls", "Draw calls", "count", 120.0, 90.0),
    _c("vertices", "Vertices", "count", 5000.0),
    _c("primitives", "Primitives", "count", 5000.0),
    _c("visible_primitives", "Visible primitives", "count"),
    _c("used_targets", "Used targets", "count"),
    _c("created_targets", "Created targets", "count"),
    _c("picture_cache_slices", "Picture cache slices", "count"),
    _c("color_passes", "Color passes", "count"),
    _c("alpha_passes", "Alpha passes", "count"),
    _c("picture_tiles", "Picture tiles", "count"),
    _c("rendered_picture_tiles", "Rendered picture tiles", "count"),
    _c("rendered_picture_px", "Rendered picture pixels", "px"),
    # template memory (:FONT_TEMPLATES..)
    _c("font_templates", "Font templates", "count"),
    _c("font_templates_mem", "Font templates mem", "MB"),
    _c("image_templates", "Image templates", "count"),
    _c("image_templates_mem", "Image templates mem", "MB"),
    # gpu cache (:181-185)
    _c("gpu_cache_rows_total", "GPU cache rows total", "count"),
    _c("gpu_cache_rows_updated", "GPU cache rows updated", "count"),
    _c("gpu_cache_blocks_total", "GPU cache blocks total", "count"),
    _c("gpu_cache_blocks_updated", "GPU cache blocks updated", "count"),
    _c("gpu_cache_blocks_saved", "GPU cache blocks saved", "count"),
    # atlas occupancy (:189-208 — per-format pixels/textures/pressure;
    # the TPU edition has color + alpha shelf atlases and frame atlases)
    _c("atlas_items_mem", "Atlas items mem", "MB"),
    _c("atlas_color_pixels", "Atlas RGBA8 linear pixels", "px"),
    _c("atlas_color_textures", "Atlas RGBA8 linear textures", "count"),
    _c("atlas_color_pressure", "Atlas RGBA8 linear pressure", "%"),
    _c("atlas_glyph_pixels", "Atlas RGBA8 glyphs pixels", "px"),
    _c("atlas_glyph_textures", "Atlas RGBA8 glyphs textures", "count"),
    _c("atlas_glyph_pressure", "Atlas RGBA8 glyphs pressure", "%"),
    _c("atlas_alpha_pixels", "Atlas A8 pixels", "px"),
    _c("atlas_alpha_textures", "Atlas A8 textures", "count"),
    _c("atlas_alpha_pressure", "Atlas A8 pressure", "%"),
    _c("atlas_standalone_pressure", "Texture cache standalone pressure", "%"),
    # eviction / external (:210-216)
    _c("texture_cache_eviction_count", "Texture cache eviction count",
       "count"),
    _c("texture_cache_youngest_eviction", "Texture cache youngest evicted",
       "frames"),
    _c("external_image_bytes", "External image mem", "MB"),
    _c("atlas_textures_mem", "Atlas textures mem", "MB"),
    _c("standalone_textures_mem", "Standalone textures mem", "MB"),
    _c("picture_tiles_mem", "Picture tiles mem", "MB"),
    _c("render_target_mem", "Render targets mem", "MB"),
    _c("depth_targets_mem", "Depth targets mem", "MB"),
    # gpu samplers (:218-221)
    _c("alpha_targets_samplers", "Alpha targets samplers", "%"),
    _c("transparent_pass_samplers", "Transparent pass samplers", "%"),
    _c("opaque_pass_samplers", "Opaque pass samplers", "%"),
    _c("total_samplers", "Total samplers", "%"),
    # interners (:223-239) — the TPU edition's analogs are its keyed
    # caches (item-group cache, glyph cache, cached render sources)
    _c("interned_primitives", "Interned primitives", "count"),
    _c("interned_clips", "Interned clips", "count"),
    _c("interned_text_runs", "Interned text runs", "count"),
    _c("interned_normal_borders", "Interned normal borders", "count"),
    _c("interned_image_borders", "Interned image borders", "count"),
    _c("interned_images", "Interned images", "count"),
    _c("interned_yuv_images", "Interned YUV images", "count"),
    _c("interned_line_decorations", "Interned line decorations", "count"),
    _c("interned_linear_gradients", "Interned linear gradients", "count"),
    _c("interned_radial_gradients", "Interned radial gradients", "count"),
    _c("interned_conic_gradients", "Interned conic gradients", "count"),
    _c("interned_pictures", "Interned pictures", "count"),
    _c("interned_filter_data", "Interned filter data", "count"),
    _c("interned_backdrop_captures", "Interned backdrop captures", "count"),
    _c("interned_backdrop_renders", "Interned backdrop renders", "count"),
    _c("interned_polygons", "Interned polygons", "count"),
    _c("interned_box_shadows", "Interned box shadows", "count"),
    # shader/compile (:242 — XLA compiles play the role of shader builds)
    _c("shader_build_time", "Shader build time", "ms"),
    # render reasons (:244-261) — see Profiler.note_render_reasons
    _c("render_reason_scene", "Reason scene", "count"),
    _c("render_reason_animated_property", "Reason animated property",
       "count"),
    _c("render_reason_resource_update", "Reason resource update", "count"),
    _c("render_reason_async_image", "Reason async image", "count"),
    _c("render_reason_clear_resources", "Reason clear resources", "count"),
    _c("render_reason_apz", "Reason APZ", "count"),
    _c("render_reason_resize", "Reason resize", "count"),
    _c("render_reason_widget", "Reason widget", "count"),
    _c("render_reason_texture_cache_flush", "Reason cache flush", "count"),
    _c("render_reason_snapshot", "Reason snapshot", "count"),
    _c("render_reason_post_resource_update_hooks", "Reason resource hook",
       "count"),
    _c("render_reason_config_change", "Reason config change", "count"),
    _c("render_reason_content_sync", "Reason content sync", "count"),
    _c("render_reason_flush", "Reason flush", "count"),
    _c("render_reason_testing", "Reason testing", "count"),
    _c("render_reason_other", "Reason other", "count"),
    _c("render_reason_vsync", "On vsync", "count"),
    # texture churn (:263-264)
    _c("textures_created", "Textures created", "count"),
    _c("textures_deleted", "Textures deleted", "count"),
    # slow-frame breakdown (:266-274)
    _c("slow_frame_cpu_count", "Total slow frames CPU", "count"),
    _c("slow_frame_gpu_count", "Total slow frames GPU", "count"),
    _c("slow_frame_build_count", "Slow: frame build", "count"),
    _c("slow_upload_count", "Slow: upload", "count"),
    _c("slow_render_count", "Slow: render", "count"),
    _c("slow_draw_calls_count", "Slow: draw calls", "count"),
    _c("slow_targets_count", "Slow: targets", "count"),
    _c("slow_blob_count", "Slow: blobs", "count"),
    # profiler.rs:497 labels SLOW_SCROLL_AFTER_SCENE_COUNT "Slow: after
    # scene"; "Slow scroll frames" is the preset's graph item (:799) —
    # registered as its own counter here so every preset label resolves
    _c("slow_scroll_after_scene_count", "Slow: after scene", "count"),
    _c("slow_scroll_frames", "Slow scroll frames", "count"),
    # gpu memory rollups (:276-278)
    _c("gpu_cache_mem", "GPU cache mem", "MB"),
    _c("gpu_buffer_mem", "GPU buffer mem", "MB"),
    _c("gpu_total_mem", "GPU total mem", "MB"),
    _c("gpu_cache_prepare_time", "GPU cache prepare", "ms"),
    _c("frame_send_time", "Frame send", "ms"),
    _c("update_document_time", "Update document", "ms"),
    # compositor surfaces (:285-287)
    _c("compositor_surface_underlays", "Compositor surface underlays",
       "count"),
    _c("compositor_surface_overlays", "Compositor surface overlays",
       "count"),
    _c("compositor_surface_blits", "Compositor surface blits", "count"),
    # TPU-edition extras (not in the reference: engine mix + recoveries)
    _c("raster_passes", "Raster passes", "count"),
    _c("rendered_tiles", "Rendered tiles", "count"),
    _c("instances", "Instances", "count"),
    _c("gpu_buffer_floats", "GPU buffer floats", "count"),
    _c("atlas_oom_recoveries", "Atlas OOM recoveries", "count"),
    _c("surface_atlas_recoveries", "Surface atlas recoveries", "count"),
    _c("frame_builds_skipped", "Frame builds skipped", "count"),
    _c("scroll_fast_builds", "Scroll fast builds", "count"),
    _c("slice_cache_disabled_runs", "Slice cache disabled runs", "count"),
]

COUNTERS: Dict[str, CounterDef] = {c.name: c for c in COUNTER_LIST}
_BY_LABEL: Dict[str, CounterDef] = {c.label: c for c in COUNTER_LIST}


# profiler.rs:55-105 PROFILER_PRESETS — same UI string syntax: comma-
# separated counter labels or preset names; `#x` requests a graph (here:
# rendered with min/avg/max history), `*x` an indicator, `$x` a text
# label, `|` column break / `_` vertical space / ` ` spacer (layout
# tokens, kept as separators in the text report).
PROFILER_PRESETS: Dict[str, str] = {
    "Default": ("FPS,|,Slow indicators,_,Time graphs,|,Frame times, ,"
                "Transaction times, ,Frame stats, ,Memory, ,Interners,_,"
                "GPU time queries,_,Paint phase graph"),
    "Compact": "FPS, ,Frame times, ,Frame stats",
    "Slow indicators": "*Slow transaction,*Slow frame",
    "Transaction times": "DisplayList,Scene building,Content send,API send",
    "Frame times": ("Frame CPU total,Frame building,Visibility,Prepare,"
                    "Batching,Glyph resolve,Texture cache update,"
                    "Shader build time,Renderer,GPU"),
    "Frame stats": ("Primitives,Visible primitives,Draw calls,Vertices,"
                    "Color passes,Alpha passes,Rendered picture tiles,"
                    "Rasterized glyphs"),
    "Texture cache stats": ("Atlas textures mem, Standalone textures mem, "
                            "Picture tiles mem, Render targets mem, "
                            "Depth targets mem, Atlas items mem, "
                            "Texture cache standalone pressure, "
                            "Texture cache eviction count, "
                            "Texture cache youngest evicted, , "
                            "Atlas RGBA8 linear pixels, "
                            "Atlas RGBA8 glyphs pixels, Atlas A8 pixels, "
                            "Atlas RGBA8 linear textures, "
                            "Atlas RGBA8 glyphs textures, Atlas A8 textures, "
                            "Atlas RGBA8 linear pressure, "
                            "Atlas RGBA8 glyphs pressure, Atlas A8 pressure"),
    "Texture upload perf": ("#Texture cache update,#Texture cache upload, ,"
                            "#Staging CPU allocation,#Staging GPU allocation,"
                            "#Staging CPU copy,#Staging GPU copy,"
                            "#Upload time, ,#Upload copy batches,"
                            "#Rasterized glyphs, ,#Cache texture creation,"
                            "#Cache texture deletion"),
    "Time graphs": ("#DisplayList,#Scene building,#Blob rasterization, ,"
                    "#Frame CPU total,#Frame building,#Renderer,"
                    "#Texture cache update, ,#GPU,"),
    "Backend graphs": ("#Frame building, #Visibility, #Prepare, #Batching, "
                       "#Glyph resolve"),
    "Renderer graphs": ("#Rendered picture tiles,#Draw calls,"
                        "#Rasterized glyphs,#Texture uploads, ,"
                        "#Texture cache update,#Renderer,"),
    "GPU Memory": ("External image mem, Atlas textures mem, "
                   "Standalone textures mem, Picture tiles mem, "
                   "Render targets mem, Depth targets mem, Atlas items mem, "
                   "GPU cache mem, GPU buffer mem, GPU total mem"),
    "CPU Memory": ("Image templates, Image templates mem, Font templates,"
                   "Font templates mem, DisplayList mem"),
    "Memory": "$CPU,CPU Memory, ,$GPU,GPU Memory",
    "Interners": ("Interned primitives,Interned clips,Interned pictures,"
                  "Interned text runs,Interned normal borders,"
                  "Interned image borders,Interned images,"
                  "Interned YUV images,Interned line decorations,"
                  "Interned linear gradients,Interned radial gradients,"
                  "Interned conic gradients,Interned filter data,"
                  "Interned backdrop renders, Interned backdrop captures"),
    "GPU samplers": ("Alpha targets samplers,Transparent pass samplers,"
                     "Opaque pass samplers,Total samplers"),
    "Render reasons": ("Reason scene, Reason animated property, "
                       "Reason resource update, Reason async image, "
                       "Reason clear resources, Reason APZ, Reason resize, "
                       "Reason widget, Reason cache flush, Reason snapshot, "
                       "Reason resource hook, Reason config change, "
                       "Reason content sync, Reason flush, On vsync, "
                       "Reason testing, Reason other"),
    "Slow frame breakdown": ("Total slow frames CPU, Total slow frames GPU, "
                             "Slow: frame build, Slow: upload, Slow: render, "
                             "Slow: draw calls, Slow: targets, Slow: blobs, "
                             "Slow: after scene, Slow scroll frames"),
    "Compositor": ("Compositor surface underlays,"
                   "Compositor surface overlays,Compositor surface blits"),
    "Video": "FPS,_,#Rendered picture tiles,_,Compositor",
}

# webrender_api/src/lib.rs:610-645 RenderReasons bit → counter key
# (profiler.rs:244-261 RENDER_REASON_* events)
RENDER_REASON_COUNTERS: List[Tuple[int, str]] = [
    (1 << 0, "render_reason_scene"),
    (1 << 1, "render_reason_animated_property"),
    (1 << 2, "render_reason_resource_update"),
    (1 << 3, "render_reason_async_image"),
    (1 << 4, "render_reason_clear_resources"),
    (1 << 5, "render_reason_apz"),
    (1 << 6, "render_reason_resize"),
    (1 << 7, "render_reason_widget"),
    (1 << 8, "render_reason_texture_cache_flush"),
    (1 << 9, "render_reason_snapshot"),
    (1 << 10, "render_reason_post_resource_update_hooks"),
    (1 << 11, "render_reason_config_change"),
    (1 << 12, "render_reason_content_sync"),
    (1 << 13, "render_reason_flush"),
    (1 << 14, "render_reason_testing"),
    (1 << 15, "render_reason_other"),
    (1 << 16, "render_reason_vsync"),
]


class Profiler:
    """Rolling counters + report text (the overlay renderer's data model)."""

    def __init__(self, window: int = 120):
        self.window = window
        self.samples: Dict[str, List[float]] = {}
        self.hooks: List[Callable[[str, float], None]] = []

    def set(self, name: str, value: float) -> None:
        buf = self.samples.setdefault(name, [])
        buf.append(value)
        if len(buf) > self.window:
            del buf[: len(buf) - self.window]
        for hook in self.hooks:
            hook(name, value)

    def get(self, name: str):
        buf = self.samples.get(name)
        return buf[-1] if buf else None

    def bump(self, name: str, by: float = 1.0) -> None:
        """Monotonic event counter (profiler.rs event counters)."""
        self.set(name, (self.get(name) or 0.0) + by)

    def note_render_reasons(self, reasons: int) -> None:
        """Record RenderReasons bits for a generated frame
        (render_backend.rs render_reasons → profiler RENDER_REASON_*)."""
        for bit, key in RENDER_REASON_COUNTERS:
            if reasons & bit:
                self.bump(key)

    def timer(self, name: str):
        """Times a block into the counter `name` (ms); the overlay's scene
        and frame build times are recorded as the recorder's spans too
        (`TIMER_SPANS`), from the same two clock readings."""
        return _Timer(TIMER_SPANS.get(name), self, name)

    def add_hook(self, fn: Callable[[str, float], None]) -> None:
        """ProfilerHooks (profiler.rs:1440) analog."""
        self.hooks.append(fn)

    def stats(self, name: str) -> Optional[Tuple[float, float, float]]:
        buf = self.samples.get(name)
        if not buf:
            return None
        return min(buf), sum(buf) / len(buf), max(buf)

    def exceeded_budgets(self) -> List[str]:
        out = []
        for name, c in COUNTERS.items():
            st = self.stats(name)
            if st is None:
                continue
            _, avg, mx = st
            if c.expected_max is not None and mx > c.expected_max:
                out.append(f"{name}: max {mx:.2f} > {c.expected_max}")
            elif c.expected_avg is not None and avg > c.expected_avg:
                out.append(f"{name}: avg {avg:.2f} > {c.expected_avg}")
        return out

    # -- preset UI strings (profiler.rs:806-830 append_to_ui) -------------
    @staticmethod
    def expand_preset(ui: str, _depth: int = 0) -> List[Tuple[str, str]]:
        """Expand a profiler UI string into (style, counter-label) items.
        Styles: 'counter', 'graph' (#), 'indicator' (*), 'label' ($),
        'break' (| / _ / empty).  Nested preset names expand recursively
        (find_preset, profiler.rs:107-113)."""
        items: List[Tuple[str, str]] = []
        if _depth > 8:          # cycle guard
            return items
        for raw in ui.split(","):
            tok = raw.strip()
            if tok in ("", "|", "_"):
                items.append(("break", tok))
                continue
            style, name = "counter", tok
            if tok[0] in "#*$":
                style = {"#": "graph", "*": "indicator", "$": "label"}[tok[0]]
                name = tok[1:].strip()
            if name in PROFILER_PRESETS and style == "counter":
                items.extend(
                    Profiler.expand_preset(PROFILER_PRESETS[name],
                                           _depth + 1))
            else:
                items.append((style, name))
        return items

    def preset_report(self, preset: str = "Default") -> str:
        """Render a preset as a text report (the overlay analog).
        Unknown labels (FPS, GPU time queries, …) resolve through the
        renderer-fed counters when present and are dimmed otherwise."""
        ui = PROFILER_PRESETS.get(preset, preset)
        lines = [f"[{preset}]"]
        for style, label in self.expand_preset(ui):
            if style == "break":
                if label in ("|", "_"):
                    lines.append("-" * 8)
                continue
            if style == "label":
                lines.append(f"== {label} ==")
                continue
            cdef = _BY_LABEL.get(label)
            key = cdef.name if cdef else label
            st = self.stats(key)
            if st is None:
                lines.append(f"  {label:36s}        -")
                continue
            mn, avg, mx = st
            unit = cdef.unit if cdef else ""
            if style == "graph":
                n = len(self.samples.get(key, []))
                lines.append(f"  {label:36s} {mn:8.2f}/{avg:8.2f}/{mx:8.2f}"
                             f" {unit} (n={n})")
            elif style == "indicator":
                flag = "!" if (self.get(key) or 0.0) > 0 else "ok"
                lines.append(f"  {label:36s} [{flag}]")
            else:
                over = ""
                if cdef and cdef.expected_max is not None \
                        and mx > cdef.expected_max:
                    over = "  ** over budget **"
                lines.append(f"  {label:36s} {avg:10.2f} {unit}{over}")
        return "\n".join(lines)

    def report(self) -> str:
        lines = ["counter                     min      avg      max  unit"]
        for name in sorted(self.samples):
            mn, avg, mx = self.stats(name)
            unit = COUNTERS[name].unit if name in COUNTERS else ""
            lines.append(f"{name:24s} {mn:8.2f} {avg:8.2f} {mx:8.2f}  {unit}")
        over = self.exceeded_budgets()
        if over:
            lines.append("over budget: " + "; ".join(over))
        return "\n".join(lines)


# --- the frame recorder -----------------------------------------------------
RING_FRAMES = 2048
# the overlay's timers that are the recorder's spans too
TIMER_SPANS = {"scene_build_time": "txn.scene_build",
               "frame_build_time": "frame.build"}


class Span(NamedTuple):
    """One timed step: nanoseconds on `time.perf_counter_ns`'s clock, the
    name of the span it ran inside (None at the root), and its thread."""
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    thread: int


@dataclass(frozen=True)
class FrameTrace:
    """One recorded frame: its number (from 0), the clock when it ended,
    its spans in the order they closed, and its counters summed."""
    index: int
    end_ns: int
    spans: Tuple[Span, ...]
    counts: Dict[str, int]

    def ms(self, name: str) -> float:
        """Milliseconds in the frame's spans named `name` (0 without
        one)."""
        return sum(s.end_ns - s.start_ns for s in self.spans
                   if s.name == name) / 1e6

    @property
    def start_ns(self) -> int:
        """The earliest start among the frame's spans (its end without
        one): with `end_ns`, the frame's recorded wall time."""
        return min((s.start_ns for s in self.spans), default=self.end_ns)


class _OpenSpans(threading.local):
    def __init__(self):
        self.stack: List[Tuple[str, int]] = []   # (name, start_ns)


_open = _OpenSpans()
_enabled = True
_spans: list = []       # the open frame's spans, as tuples
_counts: list = []      # the open frame's counts, as (name, n)
_ring: collections.deque = collections.deque(maxlen=RING_FRAMES)
_next_frame = 0
_end_lock = threading.Lock()
_NOOP = contextlib.nullcontext()


class _Span:
    """The span `name`: one shared object a name, whose open calls keep
    their start on their thread's stack, so that it nests and runs on
    several threads at once."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _open.stack.append((self.name, perf_counter_ns()))
        return self

    def __exit__(self, *exc):
        _close(perf_counter_ns())
        return False


def _close(end: int) -> None:
    """Records the calling thread's innermost open span as ending at
    `end`."""
    stack = _open.stack
    name, start = stack.pop()
    _spans.append((name, start, end, stack[-1][0] if stack else None,
                   get_ident()))


class _SpanTable(dict):
    def __missing__(self, name):
        s = self[name] = _Span(name)
        return s


_by_name = _SpanTable()


class _Timer:
    """`Profiler.timer`: the block's ms into a profiler counter and, where
    `name` is given and the recorder is on, the span `name` from the same
    two clock readings."""
    __slots__ = ("name", "profiler", "sample", "start")

    def __init__(self, name: Optional[str], profiler: "Profiler",
                 sample: str):
        self.name = name if _enabled else None
        self.profiler = profiler
        self.sample = sample

    def __enter__(self):
        self.start = perf_counter_ns()
        if self.name is not None:
            _open.stack.append((self.name, self.start))
        return self

    def __exit__(self, *exc):
        end = perf_counter_ns()
        if self.name is not None:
            _close(end)
        self.profiler.set(self.sample, (end - self.start) / 1e6)
        return False


def span(name: str):
    """A context manager that records the block as the span `name`."""
    return _by_name[name] if _enabled else _NOOP


def traced(name: str):
    """Decorates a function so that each call is recorded as the span
    `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Adds `n` (a host integer) to the open frame's counter `name`."""
    if _enabled:
        _counts.append((name, n))


def end_frame() -> None:
    """Closes the open frame: what was recorded since the last frame end
    becomes the newest frame of the ring."""
    global _spans, _counts, _next_frame
    if not _enabled:
        return
    with _end_lock:
        _ring.append((_next_frame, perf_counter_ns(), _spans, _counts))
        _next_frame += 1
        _spans, _counts = [], []


def frames() -> List[FrameTrace]:
    """The frames the ring holds, oldest first."""
    out = []
    for index, end_ns, spans, counts in list(_ring):
        summed: Dict[str, int] = {}
        for name, n in list(counts):
            summed[name] = summed.get(name, 0) + n
        out.append(FrameTrace(index, end_ns,
                              tuple(Span._make(s) for s in list(spans)),
                              summed))
    return out


def set_enabled(on: bool) -> None:
    """Turns the recorder on or off, dropping the open frame; off,
    nothing is recorded."""
    global _enabled, _spans, _counts
    _enabled = bool(on)
    _spans, _counts = [], []


def reset(ring_frames: int = RING_FRAMES) -> None:
    """Empties the recorder, the open frame and the calling thread's open
    spans; frames are numbered from 0 again and the ring holds the last
    `ring_frames`."""
    global _ring, _spans, _counts, _next_frame
    with _end_lock:
        _ring = collections.deque(maxlen=ring_frames)
        _spans, _counts = [], []
        _next_frame = 0
    _open.stack.clear()
