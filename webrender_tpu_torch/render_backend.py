"""Render backend — transaction processing + document state, on the port.

The counterpart of `webrender_tpu/render_backend.py` with the port's
`Renderer` (torch atlases, the CUDA tile-raster kernel) and a resource
cache that builds its font context on first use.  The logic is the JAX
package's, line for line, on the port's own host layers.

Mirrors `webrender/src/render_backend.rs` (RenderBackend::run :785,
process_api_msg :968, Document::build_frame :510) collapsed into a
synchronous single-host pipeline: transactions update the Scene/resources,
scene building flattens display lists, frame building emits device arrays,
and the Renderer executes them. The reference's thread pipeline (app → scene
builder → backend → render thread) maps onto this sequential flow; an async
wrapper can overlap scene building with rendering later without changing
these semantics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from .api.color import ColorF
from .api.transaction import (AddFont, AddFontInstance,
                                           AddImage, DeleteFont,
                                           DeleteFontInstance, DeleteImage,
                                           SetBlobImageVisibleArea,
                                           Transaction, UpdateImage)
from .api.units import Point2D, Rect, Transform
from .frame.frame_builder import Frame, FrameBuilder
from .resources.atlas import (AtlasFullError, FrameAtlas,
                                           SurfaceAtlasFullError)
from .scene.scene import BuiltScene, Scene
from .scene.scene_builder import build_scene
from .util.profiler import Profiler, span, traced

from .renderer import Renderer
from .resources import ResourceCache


def _flatten_floats(v) -> tuple:
    """Flatten an arbitrarily nested scroll-offset value (Point2D, tuple,
    list of sampled offsets, …) to a hashable float tuple."""
    try:
        return (float(v),)
    except (TypeError, ValueError):
        out = []
        for item in v:
            out.extend(_flatten_floats(item))
        return tuple(out)


@dataclass(frozen=True, eq=True)
class _FrameInputsKey:
    """Every input the frame builder reads, by name (not position), so the
    resolved-identity retention's skip-scroll comparison can't silently
    compare the wrong field when the key grows."""
    scene: int
    resources: int
    device_size: Tuple[int, int]
    dpr: float
    scroll: tuple
    properties: tuple
    # the frame builder's flavour (`FrameBuilder.gl_flavor`): the JAX
    # package's key leaves it out, and a backend whose flavour changes
    # would present the frame of the other one
    gl_flavor: bool = False

    def matches_except_scroll(self, other: "_FrameInputsKey") -> bool:
        return (self.scene == other.scene
                and self.resources == other.resources
                and self.device_size == other.device_size
                and self.dpr == other.dpr
                and self.properties == other.properties
                and self.gl_flavor == other.gl_flavor)


def _same_resolved(a, b) -> bool:
    """Whether two resolves of a spatial tree feed the frame builder the
    same values: per node (world matrix, axis-aligned, invertible,
    backface)."""
    return len(a) == len(b) and all(
        (tuple(r.world.m), r.is_2d_axis_aligned, r.is_invertible,
         r.backface) ==
        (tuple(o.world.m), o.is_2d_axis_aligned, o.is_invertible, o.backface)
        for r, o in zip(a, b))


class RenderBackend:
    """One document (render_backend.rs Document) + its pipeline state."""

    def __init__(self, device_size: Tuple[int, int], dpr: float = 1.0,
                 background_color: Optional[ColorF] = ColorF.WHITE,
                 renderer: Optional[Renderer] = None,
                 resources: Optional[ResourceCache] = None,
                 device="cuda"):
        """`device` (the card by default; "cpu" on request) is used when
        no `renderer` is given."""
        self.device_size = device_size
        self.dpr = dpr
        self.background_color = background_color
        self.scene = Scene()
        self.resources = resources or ResourceCache()
        self.renderer = renderer or Renderer(device)
        self.frame_builder = FrameBuilder()
        self.built_scene: Optional[BuiltScene] = None
        self.scroll_offsets: Dict[int, Point2D] = {}
        self.properties: Dict[int, Transform] = {}
        self.frame_ready = False
        self.last_frame: Optional[Frame] = None
        # frame retention (render_backend.rs frame_is_valid +
        # gpu_cache.rs epochs): the input snapshot that produced
        # last_frame; identical inputs → the built frame is reused
        # without touching the frame builder at all
        self._last_frame_key = None
        # the resolved spatial tree last_frame was built from
        self._last_resolved = None
        self._frame_used_externals = False
        self._scene_generation = 0
        self.profiler = Profiler()
        self._hit_tester = None

    # ------------------------------------------------------------------
    @traced("txn")
    def send_transaction(self, txn: Transaction) -> None:
        """render_api.rs send_transaction :1249 → process_transaction.
        (The threaded pipeline in render_api.py splits these stages across
        the scene-builder and backend threads; this synchronous entry runs
        them in order on the caller.)"""
        self.apply_resource_updates(txn)
        scene_changed = self.apply_scene_ops(txn)
        self.apply_frame_ops(txn)
        if scene_changed:
            self.rebuild_scene()
        if txn.generate_frame_flag:
            self.frame_ready = True
            # Render-reason accounting (profiler.rs RenderReasons rows) —
            # mirrored from the threaded WebRenderInstance path so the
            # synchronous embedder/test path populates the same counters.
            self.profiler.note_render_reasons(
                int(getattr(txn, "render_reasons", 0)))

    def apply_scene_ops(self, txn: Transaction) -> bool:
        scene_changed = False
        for op, payload in txn.scene_ops:
            if op == "set_display_list":
                epoch, dl = payload
                self.scene.set_display_list(dl.pipeline_id, epoch, dl)
                scene_changed = True
            elif op == "set_root_pipeline":
                self.scene.root_pipeline_id = payload
                scene_changed = True
            elif op == "remove_pipeline":
                self.scene.remove_pipeline(payload)
                scene_changed = True
        return scene_changed

    def apply_frame_ops(self, txn: Transaction) -> None:
        for op, payload in txn.frame_ops:
            if op == "scroll":
                self.scroll_offsets[payload.external_scroll_id] = payload.offset
            elif op == "dynamic_properties":
                for pv in payload.transforms:
                    self.properties[pv.key] = pv.value

    @traced("txn.resource_updates")
    def apply_resource_updates(self, txn: Transaction) -> None:
        for update in txn.resource_updates:
            self._apply_resource_update(update)

    def rebuild_scene(self):
        """Scene build (scene_building.rs build): runs on the scene-builder
        thread in the threaded pipeline."""
        if not self.scene.has_root_pipeline:
            return None
        with self.profiler.timer("scene_build_time"):
            built = build_scene(self.scene, self.background_color)
        self.install_built_scene(built)
        return built

    def install_built_scene(self, built: BuiltScene) -> None:
        self.built_scene = built
        self._scene_generation += 1
        self._hit_tester = None

    def _apply_resource_update(self, update) -> None:
        if isinstance(update, AddImage):
            self.resources.add_image_template(update.key, update.descriptor,
                                              update.data, update.tiling)
        elif isinstance(update, UpdateImage):
            self.resources.update_image_template(update.key, update.descriptor,
                                                 update.data, update.dirty_rect)
        elif isinstance(update, SetBlobImageVisibleArea):
            self.resources.set_blob_image_visible_area(update.key,
                                                       update.area)
        elif isinstance(update, DeleteImage):
            self.resources.delete_image_template(update.key)
        elif isinstance(update, AddFont):
            self.resources.add_font(update.key, update.data, update.path,
                                    update.index)
        elif isinstance(update, DeleteFont):
            self.resources.delete_font(update.key)
        elif isinstance(update, AddFontInstance):
            self.resources.add_font_instance(update.key, update.font_key,
                                             update.size, update.options)
        elif isinstance(update, DeleteFontInstance):
            self.resources.delete_font_instance(update.key)

    def _frame_inputs_key(self):
        """Snapshot of every input the frame builder reads.  Scene and
        resource state are epoch counters (bumped on mutation); scroll
        offsets and animated properties are compared by value.  Returned
        as a named structure so the scroll-insensitive comparison in
        build_frame can't drift when fields are added."""
        return _FrameInputsKey(
            scene=self._scene_generation,
            resources=self.resources.content_epoch(),
            device_size=self.device_size, dpr=self.dpr,
            scroll=tuple(sorted((k, _flatten_floats(p))
                                for k, p in self.scroll_offsets.items())),
            properties=tuple(sorted((k, tuple(t.m))
                                    for k, t in self.properties.items())),
            gl_flavor=bool(self.frame_builder.gl_flavor))

    # ------------------------------------------------------------------
    @traced("frame")
    def build_frame(self) -> Optional[Frame]:
        if self.built_scene is None:
            return None
        # Epoch-gated retention (gpu_cache.rs:5-25 role, redesigned at
        # whole-frame granularity: the Frame's device arrays ARE the GPU
        # cache, so identical inputs reuse them with zero serialization;
        # the reference instead patches a persistent GPU buffer because
        # its frame build is imperative — ours is a pure function of
        # these inputs, making the retention check exact).
        with span("frame.retention"):
            key = self._frame_inputs_key()
        if self.last_frame is not None and key == self._last_frame_key \
                and not self._frame_used_externals:
            # (frames that locked external images always rebuild — their
            # content is app-managed and invisible to the epochs, and the
            # lock/unlock protocol must run every frame)
            self.profiler.bump("frame_builds_skipped")
            return self.last_frame
        # the frame's one resolve of its spatial tree: the retention below,
        # the frame builder and the next frame's comparison all read it
        w, h = self.device_size
        with span("frame.resolve"):
            resolved = self.built_scene.spatial_tree.resolve(
                scroll_offsets=self.scroll_offsets,
                transform_properties=self.properties,
                viewport=Rect(0, 0, w / self.dpr, h / self.dpr))
        # Resolved-identity retention: scroll offsets are consumed ONLY by
        # the resolve, so offsets that move no node — ids absent from the
        # tree, or offsets clamped back to the stored value — produce
        # bit-identical resolved transforms and therefore a bit-identical
        # frame.  The reference reaches the same end through gpu_cache
        # epochs + unchanged tile dependencies (gpu_cache.rs:5-25,
        # tile_cache.rs); here the frame is a pure function of (scene,
        # resources, resolved), making the check exact.
        if self.last_frame is not None and not self._frame_used_externals \
                and key.matches_except_scroll(self._last_frame_key):
            with span("frame.retention"):
                same = _same_resolved(resolved, self._last_resolved)
            if same:
                self._last_frame_key = key
                self.profiler.bump("frame_builds_skipped")
                return self.last_frame
        self.resources.begin_frame()
        with self.profiler.timer("frame_build_time"):
            def _build():
                return self.frame_builder.build(
                    self.built_scene, self.resources, self.device_size,
                    self.dpr, properties=self.properties,
                    resolved=resolved)

            try:
                frame = _build()
            except SurfaceAtlasFullError:
                # per-frame surface demand can't be reduced by clearing
                # resource caches — recover by enabling emergency region
                # aliasing and growing the cap, rebuilding until it fits
                # or the absolute HBM ceiling is hit (the reference's task
                # graph allocates targets without a fixed cap,
                # render_task_graph.rs:800)
                fb = self.frame_builder
                while True:
                    fb.surface_emergency = True
                    self.profiler.bump("surface_atlas_recoveries")
                    try:
                        frame = _build()
                        break
                    except SurfaceAtlasFullError:
                        if fb.surface_max_height >= FrameAtlas.ABS_MAX_HEIGHT:
                            raise
                        fb.surface_max_height = min(
                            fb.surface_max_height * 2,
                            FrameAtlas.ABS_MAX_HEIGHT)
            except AtlasFullError:
                # texture-cache OOM recovery (renderer/mod.rs:1289): clear
                # every cache and rebuild once; a scene that still exceeds
                # the atlases after a full clear is a genuine error
                self.resources.memory_pressure()
                self.profiler.bump("atlas_oom_recoveries")
                frame = _build()
        self.last_frame = frame
        # re-snapshot AFTER the build: rasterization/eviction during the
        # build moves the resource epochs, and the frame just built
        # reflects that post-build state
        with span("frame.retention"):
            self._last_frame_key = self._frame_inputs_key()
        self._last_resolved = resolved
        self._frame_used_externals = bool(self.resources._locked_external)
        # external images stay locked only across the frame's prepare
        # (renderer/mod.rs unlock_external_images after uploads resolve)
        self.resources.unlock_external_images()
        self._feed_frame_counters(frame)
        return frame

    def _feed_frame_counters(self, frame: Frame) -> None:
        """Populate the profiler.rs frame-stat counters (:388-420) from the
        built frame + resource caches."""
        from .frame.frame_builder import PASS_RASTER, TARGET_ROOT
        prof = self.profiler
        prof.set("raster_passes", float(len(frame.passes)))
        prof.set("instances", float(frame.instances.shape[0]))
        prof.set("visible_primitives", float(frame.instances.shape[0]))
        prof.set("gpu_buffer_floats", float(frame.f32_buf.shape[0]))
        prof.set("gpu_buffer_mem",
                 frame.f32_buf.nbytes / (1024.0 * 1024.0))
        color = sum(1 for p in frame.passes
                    if p.kind == PASS_RASTER and p.target == TARGET_ROOT)
        prof.set("color_passes", float(color))
        prof.set("alpha_passes", float(len(frame.passes) - color))
        prof.set("used_targets", float(
            len({(p.kind == PASS_RASTER, p.target) for p in frame.passes})))
        res = self.resources
        rep = res.memory_report()
        prof.set("image_templates", float(len(res.images)))
        prof.set("image_templates_mem",
                 rep["image_templates"] / (1024.0 * 1024.0))
        prof.set("font_templates", float(rep["fonts"]))
        prof.set("atlas_textures_mem",
                 (rep["color_atlas"] + rep["alpha_atlas"])
                 / (1024.0 * 1024.0))
        prof.set("gpu_total_mem",
                 prof.get("atlas_textures_mem")
                 + (prof.get("gpu_buffer_mem") or 0.0))
        # interner analogs: the keyed caches that persist across frames
        prof.set("interned_text_runs", float(len(res.glyphs)))
        prof.set("interned_images", float(len(res.images)))
        prof.set("slice_cache_disabled_runs",
                 float(getattr(self.frame_builder,
                               "slice_cache_disabled_runs", 0)))

    def render(self) -> np.ndarray:
        """Build + execute a frame; returns premultiplied RGBA8 (h, w, 4)."""
        frame = self.build_frame()
        assert frame is not None, "no scene to render"
        with self.profiler.timer("renderer_time"):
            img = self.renderer.render(frame, self.resources)
        return img

    # ------------------------------------------------------------------
    def hit_test(self, point) -> list:
        """render_api.rs RenderApi::hit_test (:1279)."""
        from .frame.hit_test import HitTester
        if self.built_scene is None:
            return []
        if self._hit_tester is None:
            self._hit_tester = HitTester(self.built_scene,
                                         self.scroll_offsets,
                                         self.properties)
        return self._hit_tester.hit_test(point)

    def save_capture(self, root: str, bits=None) -> None:
        from .util.capture import CaptureBits, save_capture
        save_capture(self, root, bits or (CaptureBits.SCENE |
                                          CaptureBits.FRAME))

    def render_software(self, use_native: bool = False,
                        float32: bool = False) -> np.ndarray:
        """Render the same frame on the CPU fidelity oracle (`oracle/sw.py`),
        over the renderer's atlases read back from its device once
        (`Renderer.host_atlases`): the render path keeps no host mirror.
        `float32`: with the oracle's float64 `where`s held in float32, as
        the device computes (`oracle.sw.float32_where`).  `use_native`:
        its raster passes on the native span rasterizer
        (`oracle/native.py`), which raises where the library does not
        load."""
        from .oracle import sw
        frame = self.build_frame()
        assert frame is not None
        # the pending uploads reach the atlases before they are read back
        self.renderer.apply_uploads(self.resources.take_uploads())
        oracle = sw.SoftwareRenderer(*self.renderer.host_atlases(),
                                     use_native=use_native)
        if not float32:
            return oracle.render(frame)
        with sw.float32_where():
            return oracle.render(frame)


class MultiDocumentBackend:
    """render_backend.rs Documents map (:785 run loop dispatches per
    DocumentId): independent documents — own scene, scroll state and frame
    builder — share one Renderer (HBM atlases) and one ResourceCache, like
    the reference\'s per-document `Document` structs behind a single
    backend thread."""

    def __init__(self, device="cuda"):
        self.renderer = Renderer(device)
        self.resources = ResourceCache()
        self.documents: Dict[object, RenderBackend] = {}

    def add_document(self, document_id, device_size: Tuple[int, int],
                     dpr: float = 1.0,
                     background_color: Optional[ColorF] = ColorF.WHITE
                     ) -> None:
        self.documents[document_id] = RenderBackend(
            device_size, dpr, background_color,
            renderer=self.renderer, resources=self.resources)

    def delete_document(self, document_id) -> None:
        self.documents.pop(document_id, None)

    def send_transaction(self, document_id, txn: Transaction) -> None:
        self.documents[document_id].send_transaction(txn)

    def render(self, document_id) -> np.ndarray:
        return self.documents[document_id].render()
