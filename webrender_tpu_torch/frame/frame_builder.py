"""Frame building: BuiltScene + resources + frame params → Frame.

Mirrors `webrender/src/frame_builder.rs` (FrameBuilder::build :507) with the
pass structure re-designed for TPU execution (SURVEY.md §7.5-7.6):

 * visibility/culling happens while preparing (device-bbox intersection with
   the viewport — `visibility.rs` role);
 * prepare writes per-primitive pattern payloads into the flat GPU buffer
   (`prepare.rs` role);
 * offscreen surfaces (filters, mix-blend, shadows — `picture.rs` /
   `render_task_graph.rs` role) become raster/blur passes targeting a
   per-frame surface atlas, ordered dependencies-first;
 * batching becomes per-tile fixed-shape instance lists (`tiles.py`).

The output Frame is a set of numpy arrays + pass descriptors that the
renderer executes as jitted XLA/Pallas computations.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api.color import ColorF
from ..api.display_item import (BoxShadowClipMode, ClipMode, ExtendMode,
                                FilterOpKind, ImageRendering, LineStyle,
                                MixBlendMode, RepeatMode)
from ..api.font import FontRenderMode
from ..api.units import Rect, Transform
from ..resources.atlas import AtlasRegion, FrameAtlas
from ..resources.resource_cache import ResourceCache
from ..scene.clip import ClipKind, ClipNode
from ..scene.prims import (BackdropFilterPrim, BoxShadowPrim, ClearPrim,
                           CompositeOps, ConicGradientPrim, ImagePrim,
                           LineDecorationPrim, LinearGradientPrim,
                           NinePatchBorderPrim, NormalBorderPrim, PicturePrim,
                           PrimCommon, RadialGradientPrim, RectanglePrim,
                           TextRunPrim, YuvImagePrim)
from ..scene.scene import BuiltScene
from ..scene.spatial_tree import ResolvedSpatialNode, SpatialNodeKind
from ..util.profiler import count, span, traced
from .gpu import (BLEND_ADD, BLEND_CH_CLEAR, BLEND_CLEAR,
                  BLEND_LINEAR_BASE, BLEND_MIX_BASE, BLEND_SVGFE_MIX_BASE,
                  BLEND_NORMAL, BLEND_PD_ATOP, BLEND_PD_IN, BLEND_PD_LIGHTER,
                  BLEND_PD_OUT, BLEND_PD_XOR, CLIP_STRIDE,
                  GRAD_LUT_SIZE, GpuBufferBuilder, KIND_BORDER,
                  KIND_BOX_SHADOW, KIND_CLEAR, KIND_CONIC_GRAD, KIND_GLYPH,
                  KIND_IMAGE, KIND_LINEAR_GRAD, KIND_LINE_DEC, KIND_PICTURE,
                  KIND_RADIAL_GRAD, KIND_SOLID, KIND_SUBPX_GLYPH, KIND_YUV,
                  gradient_stops_records,
                  identity_color_matrix, pad_pow2, pad_pow2_rows)
from .tiles import TILE_H, TILE_W, bin_instances
from .transforms import (build_transform_palette, device_bounds_of_rect,
                         device_bounds_of_rects, node_homography)

PASS_RASTER = 0
PASS_BLUR_H = 1
PASS_BLUR_V = 2
PASS_COPY = 3          # copy src_region (src_target) → region (surface atlas)
PASS_CHANNEL_LUT = 4   # per-channel 256-entry LUT on straight-alpha values
PASS_DOWNSCALE = 5     # 2x2 box downscale src_region → region (half size)
PASS_SRGB = 6          # float srgb<->linear on straight rgb (SVGFE linear)
PASS_ARITH = 7         # feComposite arithmetic: k1·a·b + k2·a + k3·b + k4
PASS_COLOR_MATRIX = 8  # straight-alpha 4x5 color matrix → quantized surface

TARGET_ROOT = -1
TARGET_SURFACE = 2  # matches resources.ATLAS_SURFACE

# WR clamps per-pass blur std dev and downscales instead
# render_task.rs MAX_BLUR_STD_DEVIATION=4.0: large blurs downscale the
# source by powers of two until sigma <= 4, blur there, and upsample at
# composite — matching the reference's pass structure makes the blur
# pixel-comparable (the wide-kernel-at-full-res alternative is cheap on
# the VPU but blurs measurably differently)
MAX_BLUR_SIGMA = 4.0
MIN_DOWNSCALING_RT_SIZE = 8


@dataclass
class RenderPass:
    kind: int
    target: int = TARGET_ROOT
    region: Tuple[int, int, int, int] = (0, 0, 0, 0)  # x, y, w, h in target
    origin: Tuple[float, float] = (0.0, 0.0)  # device coords of region (0,0)
    clear: Optional[Tuple[float, float, float, float]] = None
    tile_insts: Optional[np.ndarray] = None
    tile_counts: Optional[np.ndarray] = None
    nx: int = 0
    ny: int = 0
    # blur/copy/lut/downscale passes:
    src_region: Tuple[int, int, int, int] = (0, 0, 0, 0)
    src_target: int = TARGET_SURFACE
    sigma: float = 0.0
    # cs_blur.glsl blur_region: sampling clamps into [0.5, blur_region-0.5]
    # of the source task (content beyond it reads the clamped edge); None
    # means the full src_region
    blur_region: Optional[Tuple[int, int]] = None
    lut: Optional[np.ndarray] = None      # [4, 256] channel LUT
    # PASS_COLOR_MATRIX: flattened 4x5 straight-alpha matrix (blend.glsl
    # CalculateFilter default case), applied src_region → region with u8
    # quantization at the target write (brush_blend renders the filtered
    # backdrop into the wrapping picture's RGBA8 surface — the quantize
    # point matters for bit-exactness, e.g. 127·0.5 → 63.5 → 64)
    color_matrix: Optional[np.ndarray] = None
    srgb_to_linear: bool = True           # PASS_SRGB direction
    src_region2: Tuple[int, int, int, int] = (0, 0, 0, 0)  # PASS_ARITH b
    kvals: Tuple[float, float, float, float] = (0, 0, 0, 0)
    arith_linear: bool = False            # PASS_ARITH in linearRGB
    # raster-root scaling (picture.rs MAX_SURFACE_SIZE): the pass rasters
    # the device region at 1/step resolution; texel (i,j) covers device
    # (origin + step·(j+0.5), origin + step·(i+0.5))
    raster_step: float = 1.0
    # painter order of instance ids when not ascending (backdrop instances
    # are allocated after their successors); per-tile slot lists already
    # encode it — this is for the per-instance oracle
    inst_order: Optional[np.ndarray] = None
    tile_hashes: Optional[np.ndarray] = None  # [nt] u64 content hashes
    # picture-cache slice info (tile_cache.rs slices, max 12): when set,
    # this root pass can render through a persistent content-space tile
    # cache — tiles are keyed in the scroll root's space, so a pure scroll
    # is a tile-offset remap + recomposite with ZERO re-rasterization.
    slice_key: Optional[Tuple] = None         # persistent identity
    slice_delta: Optional[Tuple[int, int]] = None  # content→device offset
    cache_insts: Optional[np.ndarray] = None  # content-space tile lists
    cache_counts: Optional[np.ndarray] = None
    cache_nx: int = 0
    cache_ny: int = 0
    cache_anchor: Tuple[int, int] = (0, 0)    # grid origin in content tiles
    cache_hashes: Optional[np.ndarray] = None  # offset-neutral content hash
    cache_crop: Optional[Tuple[int, int, int, int]] = None  # device clip


@dataclass
class Frame:
    """frame_builder.rs Frame (:1129) — device-ready arrays + passes."""
    f32_buf: np.ndarray
    instances: np.ndarray
    transforms: np.ndarray
    passes: List[RenderPass]
    fb_size: Tuple[int, int]              # (w, h)
    clear_color: Tuple[float, float, float, float]
    inst_bboxes: Optional[np.ndarray] = None  # [N, 4] device AABBs (oracle/debug)
    # rows of surface atlas this frame needs; the renderer grows its HBM
    # surface array to cover it (FrameAtlas soft height)
    surface_rows: int = 2048
    # frame built under the llvmpipe-calibrated GL pipeline (reftest lines
    # gated to platform(linux,mac) — see blend.GL_FLAVOR_FLAG)
    gl_flavor: bool = False


class _FrozenGb:
    """Read-only stand-in for GpuBufferBuilder during the scroll fast
    path: pass emission only snapshots the (already final) instances."""

    def __init__(self, instances: np.ndarray):
        self._inst = instances

    def snapshot_instances(self) -> np.ndarray:
        return self._inst


class _MetaStore:
    """Per-instance device AABBs + opaque interiors as growing numpy
    buffers (SoA — the per-frame bump-allocated FrameVec role of
    frame_allocator.rs; lets binning/hashing run vectorized)."""

    def __init__(self, cap: int = 1024):
        self._cap = cap
        self.bbox = np.zeros((cap, 4), np.float32)
        # opaque interior rect (occlusion culling — rectangle_occlusion.rs):
        # instances binned under an opaque full-tile cover are dropped
        self.opaque = np.zeros((cap, 4), np.float32)
        self.opaque_mask = np.zeros(cap, bool)
        self.n = 0

    def _ensure(self, need: int) -> None:
        if need <= self._cap:
            return
        cap = self._cap
        while cap < need:
            cap *= 2
        for name in ("bbox", "opaque"):
            buf = np.zeros((cap, 4), np.float32)
            buf[: self.n] = getattr(self, name)[: self.n]
            setattr(self, name, buf)
        m = np.zeros(cap, bool)
        m[: self.n] = self.opaque_mask[: self.n]
        self.opaque_mask = m
        self._cap = cap

    def push(self, bbox, opaque=None) -> int:
        self._ensure(self.n + 1)
        i = self.n
        self.bbox[i] = bbox
        if opaque is not None:
            self.opaque[i] = opaque
            self.opaque_mask[i] = True
        self.n += 1
        return i

    def push_block(self, bboxes: np.ndarray, opaques: np.ndarray = None,
                   mask: np.ndarray = None) -> None:
        k = bboxes.shape[0]
        self._ensure(self.n + k)
        self.bbox[self.n: self.n + k] = bboxes
        if opaques is not None:
            self.opaque[self.n: self.n + k] = opaques
            self.opaque_mask[self.n: self.n + k] = mask
        self.n += k


class FrameBuilder:
    def __init__(self, surface_atlas_size=(2048, 4096)):
        # (h, w) — matches renderer's surface atlas array
        self.surface_atlas_size = surface_atlas_size
        # surface-OOM recovery state (render_backend.build_frame ladder):
        # grown cap + emergency aliasing persist across builds so content
        # that once overflowed keeps its recovered configuration
        self.surface_max_height = FrameAtlas.MAX_HEIGHT
        self.surface_emergency = False
        # replicate the GL CI's pixel pipeline where it differs from the
        # swgl CI (cached gradient tasks, …); reftest lines gated to
        # platform(linux/mac) PNGs are compared under this flavor
        self.gl_flavor = False
        # scroll-translation fast path state (_try_scroll_fast_path)
        self._fast_state = None

    def build(self, scene: BuiltScene, resources: ResourceCache,
              device_size: Tuple[int, int], dpr: float,
              properties: Dict[int, Transform],
              resolved: List[ResolvedSpatialNode]) -> Frame:
        """The frame of `scene` over `resolved`, its spatial tree resolved
        by the caller at `device_size` / `dpr` with the scroll offsets and
        the animated `properties`."""
        self.scene = scene
        self.resources = resources
        self.device_size = device_size
        self.dpr = dpr
        w, h = device_size
        self.viewport = Rect(0, 0, w, h)
        self._properties = properties
        self.resolved = resolved
        with span("frame.resolve"):
            self.H_dev = [node_homography(r.world, dpr) for r in resolved]
            palette = build_transform_palette(resolved, dpr)
            # synthetic palette row: identity device-space mapping, used
            # by composite (picture) instances whose rects are already
            # device px
            dev_row = np.zeros((1, palette.shape[1]), np.float32)
            dev_row[0, 0:9] = np.eye(3, dtype=np.float32).reshape(-1)
            dev_row[0, 9:11] = 1.0
            self.device_spatial = palette.shape[0]
            self.palette = np.concatenate([palette, dev_row], axis=0)
        fast = self._try_scroll_fast_path()
        if fast is not None:
            return fast
        count("spatial_nodes", len(self.resolved))

        self.gb = GpuBufferBuilder()
        self.metas = _MetaStore()
        self.passes: List[RenderPass] = []
        self.slice_cache_disabled_runs = 0
        self.surface_atlas = FrameAtlas(self.surface_atlas_size[1],
                                        self.surface_atlas_size[0],
                                        max_height=self.surface_max_height)
        self.surface_atlas.emergency = self.surface_emergency
        self._clip_cache: Dict[Tuple, Tuple[int, int, Optional[Tuple]]] = {}
        self._clip_meta: Dict[int, Tuple] = {}
        # clip records `_serialize_clips` writes (its cache's misses)
        self._clip_rows = 0
        self._scroll_root_cache: Dict[int, Optional[int]] = {}
        self._descendant_cache: Dict[Tuple[int, int], bool] = {}
        # active preserve-3d BSP fragment: device-space convex polygon
        # applied as an extra clip on emitted instances (ps_split_composite)
        self._poly_clip: Optional[Tuple[Tuple[float, float], ...]] = None
        self._viewport_clip_cache: Dict[int, Tuple[ClipNode, ...]] = {}
        self._lut_cache: Dict[Tuple, int] = {}
        # raster-root context (picture.rs raster roots / MAX_SURFACE_SIZE):
        # when set to (root_spatial, scale), content rasters in root-LOCAL
        # coordinates × scale instead of device space
        self._rctx: Optional[Tuple[int, float]] = None
        # surface regions read by composite instances, grouped by the
        # surface scope that will consume them; freed for aliasing once
        # that scope's raster pass is emitted (render_task_graph.rs:800)
        self._region_scopes: List[List[AtlasRegion]] = [[]]
        # >0 while preparing content that renders into an offscreen surface
        # (subpixel text demotes to grayscale there — ps_text_run only
        # dual-source-blends against opaque framebuffers)
        self._surface_depth = 0
        self._rctx_H: Dict[Tuple, np.ndarray] = {}
        self._rctx_row: Dict[Tuple, int] = {}

        root_insts: List[int] = []
        with span("frame.prepare"):
            self._process_picture(scene.root, root_insts)

        bg = scene.background_color or ColorF.WHITE
        with span("frame.passes"):
            self._emit_root_passes(root_insts, (0, 0, w, h),
                                   bg.premultiplied())
            f32_buf, instances = self.gb.finish()
            bboxes = np.zeros((instances.shape[0], 4), np.float32)
            bboxes[: self.metas.n] = self.metas.bbox[: self.metas.n]
        count("clip_rows", self._clip_rows)
        # palette flag bit 2: the instance's node is not 2D axis-aligned
        rows = instances[: self.gb.num_instances, 1]
        count("transformed_instances",
              int(np.count_nonzero(self.palette[rows, 11].astype(np.int32)
                                   & 4)))
        # picture caching (SURVEY.md §5.7): per-tile content hashes let the
        # renderer skip unchanged tiles (TileCacheInstance dependency
        # tracking re-designed: hash of each tile's instance payload +
        # transform + clip content in paint order)
        self._compute_tile_hashes(f32_buf, instances)
        used = self.surface_atlas.used_height
        rows = self.surface_atlas_size[0]
        while rows < used:
            rows *= 2
        frame = Frame(f32_buf, instances, self.palette, self.passes,
                      (w, h), bg.premultiplied(), bboxes,
                      surface_rows=rows, gl_flavor=self.gl_flavor)
        self._capture_fast_state(scene, resources, frame, root_insts, rows,
                                 bg.premultiplied())
        return frame

    # ------------------------------------------------------------------
    # Scroll-translation fast path (spatial_tree.rs UpdateDocument's
    # "scrolled-only" frame update: WR re-resolves the spatial tree and
    # patches the transform palette without re-running scene/prim prepare;
    # here the whole prepare stage — payload emission, glyph raster,
    # clip serialization — is skipped and only transform palette, clip
    # transform rows, device bboxes, binning/occlusion and tile hashes
    # are recomputed).  Strictly gated: any condition that could change a
    # payload byte falls back to the full build.
    # ------------------------------------------------------------------
    _FAST_MAX_BUILDS = 256      # resync cadence (defense in depth)
    _FAST_MAX_DELTA = 3000.0    # cumulative px before the ±4096 cull
    #                             margin of the captured build could bite

    def _capture_fast_state(self, scene, resources, frame: Frame,
                            root_insts: List, rows: int, bg) -> None:
        self._fast_state = None
        # only pure root-raster frames (no offscreen surfaces: their task
        # rects/payloads are device-space and would need re-preparing)
        if any(not (p.kind == PASS_RASTER and p.target == TARGET_ROOT)
               for p in frame.passes):
            return
        if any(not isinstance(e, (int, np.integer)) for e in root_insts):
            return
        T = len(self.resolved)
        if self.palette.shape[0] != T + 1:
            return  # raster-root rows were appended (transformed surfaces)
        inst = frame.instances
        if inst.shape[0] and int(inst[:, 1].max()) > T:
            return
        if (inst[:, 0] == KIND_PICTURE).any():
            return  # composites read the surface atlas (device-space uvs)
        self._fast_state = {
            "scene": scene, "device_size": self.device_size,
            "dpr": self.dpr, "gl_flavor": self.gl_flavor,
            "res_epoch": resources.content_epoch(),
            "resolved": self.resolved, "H_dev": self.H_dev,
            "f32_buf": frame.f32_buf, "instances": inst,
            "bboxes": frame.inst_bboxes, "metas": self.metas,
            "root_insts": list(root_insts), "clip_meta": dict(self._clip_meta),
            "descendant_cache": self._descendant_cache,
            "surface_rows": rows, "bg": bg,
            "cum": np.zeros((T, 2), np.float64), "builds": 0,
        }

    def _try_scroll_fast_path(self) -> Optional[Frame]:
        """This build's frame (its inputs already set on the builder) made
        by patching the captured build's, or None where a patch could not
        be bitwise the full build."""
        st = self._fast_state
        if st is None or st["scene"] is not self.scene \
                or st["device_size"] != self.device_size \
                or st["dpr"] != self.dpr \
                or st["gl_flavor"] != self.gl_flavor \
                or st["builds"] >= self._FAST_MAX_BUILDS \
                or st["res_epoch"] != self.resources.content_epoch():
            return None
        w, h = self.device_size
        resolved = self.resolved
        old = st["resolved"]
        T = len(old)
        if len(resolved) != T:
            return None
        H_new = self.H_dev
        H_old = st["H_dev"]
        k = np.zeros((T, 2), np.float64)
        for i in range(T):
            r, o = resolved[i], old[i]
            if (r.is_2d_axis_aligned, r.is_invertible, r.backface) != \
                    (o.is_2d_axis_aligned, o.is_invertible, o.backface):
                return None
            Hn, Ho = H_new[i], H_old[i]
            if Hn[2, 2] != Ho[2, 2] or not (
                    Hn[0, 0] == Ho[0, 0] and Hn[0, 1] == Ho[0, 1]
                    and Hn[0, 2] == Ho[0, 2] and Hn[1, 0] == Ho[1, 0]
                    and Hn[1, 1] == Ho[1, 1] and Hn[1, 2] == Ho[1, 2]):
                return None
            rx = round(Hn[2, 0] - Ho[2, 0])
            ry = round(Hn[2, 1] - Ho[2, 1])
            # the delta must be an integer EXACTLY (snap invariance needs
            # tx' == tx + k bit-for-bit, not within a tolerance)
            if Hn[2, 0] != Ho[2, 0] + rx or Hn[2, 1] != Ho[2, 1] + ry:
                return None
            k[i] = (rx, ry)
        if not k.any():
            return None  # no node moved: nothing to patch
        if np.abs(st["cum"] + k).max() > self._FAST_MAX_DELTA:
            return None
        inst = st["instances"]
        N = inst.shape[0]
        kk = np.concatenate([k, np.zeros((1, 2))], axis=0)
        ki = kk[inst[:, 1]]                     # per-instance delta
        moved = (ki != 0).any(axis=1)
        if not moved.any():
            return None
        f32_old = st["f32_buf"]
        # per-chain check: every clip node must move exactly with the
        # instances it clips (a fixed clip over moving content — or vice
        # versa — changes bboxes/coverage non-uniformly)
        caddr = inst[:, 3].astype(np.int64)
        ccnt = inst[:, 4].astype(np.int64)
        groups: Dict[Tuple[int, int], np.ndarray] = {}
        patch_rows: List[Tuple[int, int]] = []  # (f32 base, node)
        for i in np.nonzero(ccnt > 0)[0]:
            key = (int(caddr[i]), int(ccnt[i]))
            g = groups.get(key)
            if g is None:
                nodes = []
                for j in range(key[1]):
                    base = key[0] + j * CLIP_STRIDE
                    node = int(f32_old[base + 13])
                    kind = f32_old[base + 14]
                    if kind == 3.0:
                        return None  # device polygon clips (preserve-3d)
                    if not (0 <= node <= T):
                        return None
                    nodes.append((base, node))
                g = groups[key] = nodes
            for base, node in g:
                if (kk[node] != ki[i]).any():
                    return None
        seen = set()
        for g in groups.values():
            for base, node in g:
                if base not in seen and kk[node].any():
                    seen.add(base)
                    patch_rows.append((base, node))
        # culling margin: every moved bbox must sit strictly inside the
        # build-time ±4096 viewport clamp before AND after the shift
        bb = st["bboxes"]
        ids = np.nonzero(moved)[0]
        k4 = np.concatenate([ki[ids], ki[ids]], axis=1).astype(np.float32)
        for arr in (bb[ids], bb[ids] + k4):
            if (arr[:, 0] <= -4096.0).any() or (arr[:, 1] <= -4096.0).any() \
                    or (arr[:, 2] >= w + 4096.0).any() \
                    or (arr[:, 3] >= h + 4096.0).any():
                return None
        # ---- commit: patch state and re-emit passes -------------------
        f32_buf = f32_old
        if patch_rows:
            f32_buf = f32_old.copy()
            for base, node in patch_rows:
                f32_buf[base + 96:base + 108] = self.palette[node]
        self.metas = st["metas"]
        self.metas.bbox[ids] += k4
        om = self.metas.opaque_mask[:N]
        oids = np.nonzero(moved & om)[0]
        if oids.size:
            self.metas.opaque[oids] += np.concatenate(
                [ki[oids], ki[oids]], axis=1).astype(np.float32)
        bboxes = self.metas.bbox[:N].copy()
        # clip-node device bounds in the meta cache shift with their node
        new_meta = {}
        for addr, (nodes_info, has_poly) in st["clip_meta"].items():
            out = []
            for (node, kind, mode, db) in nodes_info:
                if db is not None and 0 <= node < T and kk[node].any():
                    db = (db[0] + kk[node][0], db[1] + kk[node][1],
                          db[2] + kk[node][0], db[3] + kk[node][1])
                out.append((node, kind, mode, db))
            new_meta[addr] = (tuple(out), has_poly)
        self._clip_meta = new_meta
        self._descendant_cache = st["descendant_cache"]
        self._scroll_root_cache = {}
        self._poly_clip = None
        self._rctx = None
        self.slice_cache_disabled_runs = 0
        self.gb = _FrozenGb(inst)
        self.passes = []
        self._emit_root_passes(st["root_insts"], (0, 0, w, h), st["bg"])
        self._compute_tile_hashes(f32_buf, inst)
        frame = Frame(f32_buf, inst, self.palette, self.passes,
                      (w, h), st["bg"], bboxes,
                      surface_rows=st["surface_rows"],
                      gl_flavor=self.gl_flavor)
        st["resolved"] = resolved
        st["H_dev"] = H_new
        st["f32_buf"] = f32_buf
        st["bboxes"] = bboxes
        st["clip_meta"] = new_meta
        st["cum"] += k
        st["builds"] += 1
        return frame

    _FNV_OFFSET = np.uint64(0xcbf29ce484222325)
    _FNV_PRIME = np.uint64(0x9e3779b97f4a7c15)

    def _hash_instances(self, f32_buf: np.ndarray, instances: np.ndarray,
                        delta=None, sr: Optional[int] = None) -> np.ndarray:
        """FNV fold over each instance's payload / clip / transform content,
        fully vectorized.  With `delta` (a picture-cache slice's content →
        device translation), transform rows of slice content are hashed in
        OFFSET-NEUTRAL form: the constant terms of the inverse homography
        absorb the translation, so a pure scroll leaves the hash alone."""
        N = instances.shape[0]
        PRIME = self._FNV_PRIME
        with np.errstate(over="ignore"):
            h = np.full(N, self._FNV_OFFSET)
            for c in (0, 5, 6):
                h = (h ^ instances[:, c].astype(np.uint64)) * PRIME
            offs = np.clip(instances[:, 2].astype(np.int64)[:, None]
                           + np.arange(64)[None, :], 0, f32_buf.size - 1)
            # +0.0 canonicalizes -0.0 (bitwise distinct, renders equal)
            pay = np.ascontiguousarray(f32_buf[offs] + 0.0).view(np.uint64)
            for c in range(pay.shape[1]):
                h = (h ^ pay[:, c]) * PRIME
            trows = np.ascontiguousarray(
                self.palette[instances[:, 1]], np.float32)
            if delta is not None:
                trows = self._neutralize_rows(trows, delta)
            tr = np.ascontiguousarray(trows + np.float32(0.0)).view(
                np.uint32).astype(np.uint64)
            for c in range(tr.shape[1]):
                h = (h ^ tr[:, c]) * PRIME
            # clip content: few unique (addr, count) groups (clip chains
            # are cached at serialization) — hash each group once
            caddr = instances[:, 3].astype(np.int64)
            ccount = instances[:, 4].astype(np.int64)
            groups = {}
            ch = np.zeros(N, np.uint64)
            for i in np.nonzero(ccount > 0)[0]:
                key = (caddr[i], ccount[i])
                g = groups.get(key)
                if g is None:
                    blob = np.array(
                        f32_buf[key[0]: key[0] + key[1] * CLIP_STRIDE],
                        np.float32)
                    if delta is not None:
                        for j in range(int(key[1])):
                            b = j * CLIP_STRIDE + 96
                            node = int(blob[j * CLIP_STRIDE + 13])
                            if sr is not None and \
                                    self._is_descendant(node, sr):
                                row = blob[b:b + 12].reshape(1, 12)
                                blob[b:b + 12] = self._neutralize_rows(
                                    row, delta)[0]
                    g = np.uint64(hash((blob + np.float32(0.0)).tobytes())
                                  & 0xFFFFFFFFFFFFFFFF)
                    groups[key] = g
                ch[i] = g
            h = (h ^ ch) * PRIME
        return h

    @staticmethod
    def _neutralize_rows(trows: np.ndarray, delta) -> np.ndarray:
        """Inverse-homography rows re-expressed for content space: local =
        (content + Δ)·Hinv, so the constant terms gain Δ·(linear part) —
        after which a Δ change leaves the row bytes unchanged for nodes
        that scroll with the content."""
        dx, dy = float(delta[0]), float(delta[1])
        out = trows.copy()
        out[:, 6] = trows[:, 6] + dx * trows[:, 0] + dy * trows[:, 3]
        out[:, 7] = trows[:, 7] + dx * trows[:, 1] + dy * trows[:, 4]
        out[:, 8] = trows[:, 8] + dx * trows[:, 2] + dy * trows[:, 5]
        return out

    def _fold_tile_hashes(self, inst_h: np.ndarray, tile_insts: np.ndarray,
                          base: np.uint64) -> np.ndarray:
        PRIME = self._FNV_PRIME
        with np.errstate(over="ignore"):
            ih = np.where(tile_insts >= 0,
                          inst_h[np.maximum(tile_insts, 0)],
                          np.uint64(0x517cc1b727220a95))
            th = np.full(tile_insts.shape[0], self._FNV_OFFSET ^ base)
            for s in range(tile_insts.shape[1]):
                th = (th ^ ih[:, s]) * PRIME
        return th

    @traced("frame.tile_hashes")
    def _compute_tile_hashes(self, f32_buf: np.ndarray,
                             instances: np.ndarray) -> None:
        """Per-tile content hashes (picture.rs dependency tracking role):
        the single-root whole-frame cache, plus per-slice offset-neutral
        hashes for picture-cache slices."""
        root_passes = [p for p in self.passes
                       if p.target == TARGET_ROOT and p.kind == PASS_RASTER]
        slice_passes = [p for p in root_passes if p.slice_key is not None]
        if len(root_passes) == 1 and not slice_passes:
            p = root_passes[0]
            h = self._hash_instances(f32_buf, instances)
            p.tile_hashes = self._fold_tile_hashes(
                h, p.tile_insts,
                np.uint64(hash(p.clear) & 0xFFFFFFFFFFFFFFFF))
            return
        for p in slice_passes:
            sr = p.slice_key[2]
            seg = p.inst_order.astype(np.int64)
            h = self._hash_instances(f32_buf, instances[seg],
                                     delta=p.slice_delta, sr=sr)
            # cache_insts holds global instance ids; scatter seg hashes
            gh = np.zeros(instances.shape[0], np.uint64)
            gh[seg] = h
            th = self._fold_tile_hashes(gh, p.cache_insts, np.uint64(0))
            th = self._mark_fixed_clip_tiles(p, instances, th)
            p.cache_hashes = th

    def _mark_fixed_clip_tiles(self, p: RenderPass, instances: np.ndarray,
                               th: np.ndarray) -> np.ndarray:
        """Tiles crossed by a FIXED (non-scrolling) clip edge depend on the
        scroll offset: mix Δ into their hash so they re-raster per scroll
        while interior tiles stay cached."""
        rects = self._fixed_clip_rects(p, instances)
        if not rects:
            return th
        dx, dy = p.slice_delta
        ax, ay = p.cache_anchor
        nx, ny = p.cache_nx, p.cache_ny
        mix = np.uint64(hash((dx, dy)) & 0xFFFFFFFFFFFFFFFF)
        grid = th.reshape(ny, nx)
        with np.errstate(over="ignore"):
            for (x0, y0, x1, y1) in rects:
                cx0, cy0 = x0 - dx, y0 - dy
                cx1, cy1 = x1 - dx, y1 - dy
                tx0 = int(np.floor((cx0 - 1) / TILE_W)) - ax
                ty0 = int(np.floor((cy0 - 1) / TILE_H)) - ay
                tx1 = int(np.ceil((cx1 + 1) / TILE_W)) - ax
                ty1 = int(np.ceil((cy1 + 1) / TILE_H)) - ay
                # interior tiles strictly inside the clip are offset-safe
                ix0 = int(np.ceil((cx0 + 1) / TILE_W)) - ax
                iy0 = int(np.ceil((cy0 + 1) / TILE_H)) - ay
                ix1 = int(np.floor((cx1 - 1) / TILE_W)) - ax
                iy1 = int(np.floor((cy1 - 1) / TILE_H)) - ay
                band = np.zeros((ny, nx), bool)
                band[max(ty0, 0):max(min(ty1, ny), 0),
                     max(tx0, 0):max(min(tx1, nx), 0)] = True
                band[max(iy0, 0):max(min(iy1, ny), 0),
                     max(ix0, 0):max(min(ix1, nx), 0)] = False
                grid = np.where(band, (grid ^ mix) * self._FNV_PRIME, grid)
        return grid.reshape(-1)

    # ------------------------------------------------------------------
    # picture traversal / surfaces
    # ------------------------------------------------------------------
    def _process_picture(self, pic: PicturePrim, out: List[int]) -> None:
        if pic.composite.preserve_3d:
            # children of a preserve-3d context are individual 3D planes:
            # BSP-split against each other and drawn back-to-front, each
            # fragment clipped to its device polygon (picture.rs
            # PlaneSplitter + ps_split_composite)
            for child, poly in self._split_planes(pic.children):
                prev = self._poly_clip
                if poly is not None:
                    self._poly_clip = poly
                # Non-axis-aligned 3D planes raster into a local-space
                # surface and split-composite samples it (picture.rs:
                # Picture3DContext planes always get a surface;
                # ps_split_composite) — matches the reference's
                # double-sample output for rotated/perspective planes
                # (perspective-surface-scale.yaml).
                if isinstance(child, PicturePrim) and self._rctx is None \
                        and child.shadow is None \
                        and not self.resolved[
                            child.common.spatial_node].is_2d_axis_aligned:
                    self._build_surface(child, out, plane=True)
                else:
                    self._emit_child(child, out)
                self._poly_clip = prev
            return
        batch: List = []
        tbatch: List = []
        gbatch: List = []
        ibatch: List = []
        for child in pic.children:
            if type(child) is RectanglePrim:
                self._flush_text_batch(tbatch, out)
                self._flush_gradient_batch(gbatch, out)
                self._flush_image_batch(ibatch, out)
                batch.append(child)
                continue
            if type(child) is TextRunPrim:
                self._flush_rect_batch(batch, out)
                self._flush_gradient_batch(gbatch, out)
                self._flush_image_batch(ibatch, out)
                tbatch.append(child)
                continue
            if type(child) in (LinearGradientPrim, RadialGradientPrim,
                               ConicGradientPrim):
                self._flush_rect_batch(batch, out)
                self._flush_text_batch(tbatch, out)
                self._flush_image_batch(ibatch, out)
                gbatch.append(child)
                continue
            if type(child) is ImagePrim:
                self._flush_rect_batch(batch, out)
                self._flush_text_batch(tbatch, out)
                self._flush_gradient_batch(gbatch, out)
                ibatch.append(child)
                continue
            self._flush_rect_batch(batch, out)
            self._flush_text_batch(tbatch, out)
            self._flush_gradient_batch(gbatch, out)
            self._flush_image_batch(ibatch, out)
            self._emit_child(child, out)
        self._flush_rect_batch(batch, out)
        self._flush_text_batch(tbatch, out)
        self._flush_gradient_batch(gbatch, out)
        self._flush_image_batch(ibatch, out)

    def _prepare_images_vec(self, prims: List, out: List[int]) -> None:
        """Vectorized image prepare for the common direct-residency case
        (small-enough templates); oversized/missing templates fall back to
        the scalar path."""
        c0: PrimCommon = prims[0].common
        pal = self._pal(c0.spatial_node)
        if int(pal[11]) & 1:
            return
        if not c0.is_backface_visible and self._prim_backfacing(c0):
            return
        if self._sc_backface_culled(c0.backface_cull_spatial):
            return
        axis_aligned = self.resolved[c0.spatial_node].is_2d_axis_aligned \
            and self._rctx is None
        lim = self.resources.MAX_DIRECT_DIM
        # only batch when every template takes the direct path — a mixed
        # batch would reorder instances vs painter order
        for p_ in prims:
            tpl = self.resources.images.get(p_.image_key)
            if tpl is None or tpl.descriptor.width > lim or \
                    tpl.descriptor.height > lim:
                for q_ in prims:
                    self._prepare_prim(q_, out)
                return
        geom = self._geom_vec(prims, c0, axis_aligned)
        if geom is None:
            return
        rects, cov, edge_aa, db, keep, clip_addr, clip_count = geom
        k = int(keep.sum())
        pay = np.zeros((k, 26), np.float32)
        pay[:, 0:4] = rects[keep]
        pay[:, 4:8] = cov[keep]
        ok_rows = np.ones(k, bool)
        opq_rows = np.zeros(k, bool)
        i = 0
        for p_, kp in zip(prims, keep):
            if not kp:
                continue
            req = self.resources.request_image(p_.image_key)
            if req is None:
                ok_rows[i] = False
                i += 1
                continue
            region, desc = req
            lr = p_.common.local_rect
            stretch_w = p_.stretch_size.width or lr.w
            stretch_h = p_.stretch_size.height or lr.h
            nearest = 1.0 if p_.image_rendering in (
                ImageRendering.PIXELATED, ImageRendering.CROSP_EDGES) \
                else 0.0
            row = pay[i]
            row[8:12] = (region.x, region.y, region.x + desc.width,
                         region.y + desc.height)
            row[12:16] = _premult(p_.color)
            row[16:18] = (nearest, 0.0)
            row[18:22] = (stretch_w, stretch_h, p_.tile_spacing.width,
                          p_.tile_spacing.height)
            row[22:26] = (desc.width / max(stretch_w, 1e-6),
                          desc.height / max(stretch_h, 1e-6), 0.0, 0.0)
            # IS_OPAQUE templates drawn gap-free at full alpha mod are
            # occluders (rectangle_occlusion.rs push; segment.rs's
            # opaque-interior role): anything binned below a full-tile
            # cover is dropped by bin_instances
            opq_rows[i] = bool(desc.is_opaque and p_.color.a >= 1.0 and
                               p_.tile_spacing.width == 0 and
                               p_.tile_spacing.height == 0)
            i += 1
        if not ok_rows.any():
            return
        pay = pay[ok_rows]
        k2 = int(ok_rows.sum())
        addrs = self.gb.push_f32_block(pay)
        row_t = self._row(c0.spatial_node)
        inst = np.empty((k2, 8), np.int64)
        inst[:, 0] = KIND_IMAGE
        inst[:, 1] = row_t
        inst[:, 2] = addrs
        inst[:, 3] = clip_addr
        inst[:, 4] = clip_count
        inst[:, 5] = BLEND_NORMAL
        inst[:, 6] = edge_aa[keep][ok_rows]
        inst[:, 7] = 0
        idxs = self.gb.push_instance_block(inst)
        db2 = db[keep][ok_rows].astype(np.float32)
        opq = np.empty((k2, 4), np.float32)
        opq[:, 0] = db2[:, 0] + 1.0
        opq[:, 1] = db2[:, 1] + 1.0
        opq[:, 2] = db2[:, 2] - 1.0
        opq[:, 3] = db2[:, 3] - 1.0
        omask = opq_rows[ok_rows] & (clip_count == 0) & axis_aligned
        self.metas.push_block(db2, opq, omask)
        out.extend(idxs.tolist())

    def _flush_image_batch(self, batch: List, out: List[int]) -> None:
        if not batch:
            return
        groups: List[Tuple[Tuple, List]] = []
        for prim in batch:
            c = prim.common
            key = (c.spatial_node, c.clip_chain, c.backface_cull_spatial,
                   c.is_backface_visible, c.containing_block)
            if groups and groups[-1][0] == key:
                groups[-1][1].append(prim)
            else:
                groups.append((key, [prim]))
        for _, prims in groups:
            if len(prims) < 4:
                for prim in prims:
                    self._prepare_prim(prim, out)
            else:
                self._prepare_images_vec(prims, out)
        batch.clear()

    def _flush_gradient_batch(self, batch: List, out: List[int]) -> None:
        if not batch:
            return
        groups: List[Tuple[Tuple, List]] = []
        for prim in batch:
            c = prim.common
            key = (c.spatial_node, c.clip_chain, c.backface_cull_spatial,
                   c.is_backface_visible, c.containing_block)
            if groups and groups[-1][0] == key:
                groups[-1][1].append(prim)
            else:
                groups.append((key, [prim]))
        for _, prims in groups:
            if len(prims) < 4:
                for prim in prims:
                    self._prepare_prim(prim, out)
            else:
                self._prepare_gradients_vec(prims, out)
        batch.clear()

    def _flush_rect_batch(self, batch: List, out: List[int]) -> None:
        """Vectorized solid-rect prepare: consecutive RectanglePrims are
        grouped by (spatial, clip chain) and processed as numpy blocks —
        the prepare.rs hot loop without per-prim Python (painter order is
        preserved: the batch only spans consecutive children)."""
        if not batch:
            return
        if len(batch) < 4:
            for prim in batch:
                self._prepare_prim(prim, out)
            batch.clear()
            return
        groups: List[Tuple[Tuple, List]] = []
        for prim in batch:
            c = prim.common
            key = (c.spatial_node, c.clip_chain, c.backface_cull_spatial,
                   c.is_backface_visible, c.containing_block)
            if groups and groups[-1][0] == key:
                groups[-1][1].append(prim)
            else:
                groups.append((key, [prim]))
        for _, prims in groups:
            if len(prims) < 4:
                for prim in prims:
                    self._prepare_prim(prim, out)
            else:
                self._prepare_rects_vec(prims, out)
        batch.clear()

    def _flush_text_batch(self, batch: List, out: List[int]) -> None:
        """Consecutive text runs sharing (spatial, clip chain, clip rect,
        font instance) prepare as ONE vectorized glyph block."""
        if not batch:
            return
        groups: List[Tuple[Tuple, List]] = []
        for prim in batch:
            c = prim.common
            key = (c.spatial_node, c.clip_chain, c.clip_rect,
                   prim.font_instance_key, prim.frame_offset,
                   c.backface_cull_spatial,
                   c.is_backface_visible, c.containing_block)
            if groups and groups[-1][0] == key:
                groups[-1][1].append(prim)
            else:
                groups.append((key, [prim]))
        for _, prims in groups:
            if len(prims) == 1:
                self._prepare_prim(prims[0], out)
                continue
            c = prims[0].common
            pal = self._pal(c.spatial_node)
            if int(pal[11]) & 1:
                continue
            if not c.is_backface_visible and self._prim_backfacing(c):
                continue
            if self._sc_backface_culled(c.backface_cull_spatial):
                continue
            self._prepare_text_runs(prims, c, out)
        batch.clear()

    def _geom_vec(self, prims: List, c0: PrimCommon, axis_aligned: bool):
        """_emit_common vectorized over prims sharing (spatial, clips):
        snap, coverage, edge AA, clip serialization, device bounds.
        Returns (rects, cov, edge_aa, db, keep, clip_addr, clip_count) or
        None when everything culls."""
        M = len(prims)
        rects = np.array([(p.common.local_rect.x0, p.common.local_rect.y0,
                           p.common.local_rect.x1, p.common.local_rect.y1)
                          for p in prims], np.float64)
        clips = np.array([(p.common.clip_rect.x0, p.common.clip_rect.y0,
                           p.common.clip_rect.x1, p.common.clip_rect.y1)
                          for p in prims], np.float64)
        H = self._H(c0.spatial_node)
        finite = np.isfinite(rects).all(1)
        if axis_aligned:
            # _snap_rect vectorized (half-even rounding like Python round)
            sx, sy = H[0, 0], H[1, 1]
            tx, ty = H[2, 0], H[2, 1]
            if abs(sx) >= 1e-9 and abs(sy) >= 1e-9 and \
                    np.isfinite((sx, sy, tx, ty)).all():
                # util.rs snap: floor(v + 0.5) half-up (see _snap_rect)
                snapped = np.empty_like(rects)
                snapped[:, 0] = (np.floor(rects[:, 0] * sx + tx + 0.5)
                                 - tx) / sx
                snapped[:, 1] = (np.floor(rects[:, 1] * sy + ty + 0.5)
                                 - ty) / sy
                snapped[:, 2] = (np.floor(rects[:, 2] * sx + tx + 0.5)
                                 - tx) / sx
                snapped[:, 3] = (np.floor(rects[:, 3] * sy + ty + 0.5)
                                 - ty) / sy
                rects = np.where(finite[:, None], snapped, rects)
        cov = np.empty_like(rects)
        cov[:, 0] = np.maximum(rects[:, 0], clips[:, 0])
        cov[:, 1] = np.maximum(rects[:, 1], clips[:, 1])
        cov[:, 2] = np.minimum(rects[:, 2], clips[:, 2])
        cov[:, 3] = np.minimum(rects[:, 3], clips[:, 3])
        keep = (cov[:, 2] > cov[:, 0]) & (cov[:, 3] > cov[:, 1])
        if axis_aligned:
            edge_aa = ((cov[:, 0] <= rects[:, 0]) * 1
                       + (cov[:, 1] <= rects[:, 1]) * 2
                       + (cov[:, 2] >= rects[:, 2]) * 4
                       + (cov[:, 3] >= rects[:, 3]) * 8)
        else:
            edge_aa = np.full(M, 0xF, np.int64)
        clip_addr, clip_count, clip_bbox = self._serialize_clips(
            c0.clip_chain, c0.spatial_node)
        db = device_bounds_of_rects(H, cov)
        if clip_bbox is not None:
            db[:, 0] = np.maximum(db[:, 0], clip_bbox[0])
            db[:, 1] = np.maximum(db[:, 1], clip_bbox[1])
            db[:, 2] = np.minimum(db[:, 2], clip_bbox[2])
            db[:, 3] = np.minimum(db[:, 3], clip_bbox[3])
        vp = self.viewport
        db[:, 0] = np.maximum(db[:, 0], vp.x0 - 4096)
        db[:, 1] = np.maximum(db[:, 1], vp.y0 - 4096)
        db[:, 2] = np.minimum(db[:, 2], vp.x1 + 4096)
        db[:, 3] = np.minimum(db[:, 3], vp.y1 + 4096)
        keep &= np.isfinite(db).all(1) & finite
        keep &= (db[:, 2] > db[:, 0]) & (db[:, 3] > db[:, 1])
        if not keep.any():
            return None
        return rects, cov, edge_aa, db, keep, clip_addr, clip_count

    def _prepare_rects_vec(self, prims: List, out: List[int]) -> None:
        c0: PrimCommon = prims[0].common
        pal = self._pal(c0.spatial_node)
        if int(pal[11]) & 1:
            return
        if not c0.is_backface_visible and self._prim_backfacing(c0):
            return
        if self._sc_backface_culled(c0.backface_cull_spatial):
            return
        axis_aligned = self.resolved[c0.spatial_node].is_2d_axis_aligned \
            and self._rctx is None
        geom = self._geom_vec(prims, c0, axis_aligned)
        if geom is None:
            return
        rects, cov, edge_aa, db, keep, clip_addr, clip_count = geom
        colors = np.array([(p.color.r, p.color.g, p.color.b, p.color.a)
                          for p in prims], np.float64)
        k = int(keep.sum())
        # premultiplied colors quantized to the u8 grid (_premult)
        a = colors[keep, 3]
        prem = np.empty((k, 4), np.float64)
        prem[:, 0] = colors[keep, 0] * a
        prem[:, 1] = colors[keep, 1] * a
        prem[:, 2] = colors[keep, 2] * a
        prem[:, 3] = a
        prem = np.round(prem * 255.0) / 255.0
        pay = np.empty((k, 12), np.float32)
        pay[:, 0:4] = rects[keep]
        pay[:, 4:8] = cov[keep]
        pay[:, 8:12] = prem
        addrs = self.gb.push_f32_block(pay)
        row = self._row(c0.spatial_node)
        inst = np.empty((k, 8), np.int64)
        inst[:, 0] = KIND_SOLID
        inst[:, 1] = row
        inst[:, 2] = addrs
        inst[:, 3] = clip_addr
        inst[:, 4] = clip_count
        inst[:, 5] = BLEND_NORMAL
        inst[:, 6] = edge_aa[keep]
        inst[:, 7] = 0
        idxs = self.gb.push_instance_block(inst)
        opq = np.empty((k, 4), np.float32)
        opq[:, 0] = db[keep, 0] + 1.0
        opq[:, 1] = db[keep, 1] + 1.0
        opq[:, 2] = db[keep, 2] - 1.0
        opq[:, 3] = db[keep, 3] - 1.0
        omask = (prem[:, 3] >= 1.0) & (clip_count == 0) & axis_aligned
        self.metas.push_block(db[keep].astype(np.float32), opq, omask)
        out.extend(idxs.tolist())

    def _prepare_gradients_vec(self, prims: List, out: List[int]) -> None:
        """Vectorized gradient prepare: geometry/emission as one block,
        the 12-float kind-specific tails filled in a cheap scalar loop
        (stops addresses hit the LUT cache)."""
        c0: PrimCommon = prims[0].common
        pal = self._pal(c0.spatial_node)
        if int(pal[11]) & 1:
            return
        if not c0.is_backface_visible and self._prim_backfacing(c0):
            return
        if self._sc_backface_culled(c0.backface_cull_spatial):
            return
        axis_aligned = self.resolved[c0.spatial_node].is_2d_axis_aligned \
            and self._rctx is None
        geom = self._geom_vec(prims, c0, axis_aligned)
        if geom is None:
            return
        rects, cov, edge_aa, db, keep, clip_addr, clip_count = geom
        k = int(keep.sum())
        pay = np.zeros((k, 22), np.float32)
        pay[:, 0:4] = rects[keep]
        pay[:, 4:8] = cov[keep]
        kinds = np.empty(k, np.int64)
        opq_rows = np.zeros(k, bool)
        i = 0
        for p_, kp in zip(prims, keep):
            if not kp:
                continue
            lr = p_.common.local_rect
            ts = p_.tile_size
            sp = p_.tile_spacing
            # all-opaque stops + gap-free tiling that actually covers the
            # rect = an occluding gradient (rectangle_occlusion.rs push);
            # degenerate tile sizes (e.g. NaN-laced lists sanitized to 0)
            # cover nothing and must never occlude
            tw0 = ts.width or lr.w
            th0 = ts.height or lr.h
            opq_rows[i] = (sp.width == 0 and sp.height == 0 and
                           np.isfinite(tw0) and np.isfinite(th0) and
                           tw0 >= lr.w - 0.5 and th0 >= lr.h - 0.5 and
                           all(st.color.a >= 1.0 and
                               np.isfinite(st.offset) for st in p_.stops))
            tw = ts.width or lr.w
            th = ts.height or lr.h
            if sp.width == 0 and sp.height == 0 and \
                    tw >= lr.w - 0.5 and th >= lr.h - 0.5:
                tw, th = lr.w, lr.h
            addr, n = self._gradient_stops_addr(p_.stops)
            g = p_.gradient
            ext = float(g.extend_mode.value)
            row = pay[i]
            glq = self._gradient_gl_quant(p_, tw, th)
            if isinstance(p_, LinearGradientPrim):
                kinds[i] = KIND_LINEAR_GRAD
                row[8:12] = (g.start_point.x, g.start_point.y,
                             g.end_point.x, g.end_point.y)
                row[12:16] = (float(addr), ext, float(n), glq)
                row[16:20] = (tw, th, sp.width, sp.height)
            elif isinstance(p_, RadialGradientPrim):
                kinds[i] = KIND_RADIAL_GRAD
                row[8:12] = (g.center.x, g.center.y,
                             g.radius.width, g.radius.height)
                row[12:16] = (float(addr), ext, float(n), glq)
                row[16:18] = (g.start_offset, g.end_offset)
                row[18:22] = (tw, th, sp.width, sp.height)
            else:
                kinds[i] = KIND_CONIC_GRAD
                row[8:12] = (g.center.x, g.center.y, g.angle, 0.0)
                row[12:16] = (float(addr), ext, float(n), glq)
                row[16:18] = (g.start_offset, g.end_offset)
                row[18:22] = (tw, th, sp.width, sp.height)
            i += 1
        # NaN-laced gradients (gradient/linear-nan.yaml): the reference
        # renders deterministically; NaN payloads would also diverge
        # between backends (NaN propagation differs across compilers), so
        # sanitize here — one choke point all engines inherit
        np.nan_to_num(pay, copy=False, nan=0.0, posinf=3.4e38,
                      neginf=-3.4e38)
        addrs = self.gb.push_f32_block(pay)
        row_t = self._row(c0.spatial_node)
        inst = np.empty((k, 8), np.int64)
        inst[:, 0] = kinds
        inst[:, 1] = row_t
        inst[:, 2] = addrs
        inst[:, 3] = clip_addr
        inst[:, 4] = clip_count
        inst[:, 5] = BLEND_NORMAL
        inst[:, 6] = edge_aa[keep]
        inst[:, 7] = 0
        idxs = self.gb.push_instance_block(inst)
        db2 = db[keep].astype(np.float32)
        opq = np.empty((k, 4), np.float32)
        opq[:, 0] = db2[:, 0] + 1.0
        opq[:, 1] = db2[:, 1] + 1.0
        opq[:, 2] = db2[:, 2] - 1.0
        opq[:, 3] = db2[:, 3] - 1.0
        omask = opq_rows & (clip_count == 0) & axis_aligned
        self.metas.push_block(db2, opq, omask)
        out.extend(idxs.tolist())

    def _emit_child(self, child, out: List[int]) -> None:
        if isinstance(child, PicturePrim):
            if child.composite.needs_surface or child.shadow is not None \
                    or self._needs_raster_root(child):
                self._build_surface(child, out)
            else:
                self._process_picture(child, out)
        else:
            self._prepare_prim(child, out)

    def _needs_raster_root(self, child: PicturePrim) -> bool:
        """Disabled by design: the reference rasterizes perspective
        subtrees in raster-root LOCAL space (clamped to MAX_SURFACE_SIZE)
        and resamples at composite; this engine rasterizes direct to device
        in one pass — sharper output, no intermediate surface
        (raster_root_*_8192.yaml intentionally differ by the reference's
        double-resample softness). The raster-root context machinery
        (_rctx/_H/_row, pattern_picture p[37] local mode) remains available
        for surfaces that would otherwise exceed the atlas."""
        return False

    def _clip_local_to_viewport(self, lr, spatial: int,
                                margin: float = 0.0):
        """Intersect a local rect with the device viewport mapped into
        local space (the visible part bounds the raster-root scale).
        `margin` (LOCAL units) widens the window for content that the
        surface's filters pull into view — drop-shadow offsets and blur
        taps read source pixels that are themselves off-screen
        (filter-drop-shadow-clip-3.yaml: the inflation must happen in the
        surface's local space, not device space)."""
        try:
            Hinv = np.linalg.inv(self._H(spatial))
        except np.linalg.LinAlgError:
            return lr
        vb = device_bounds_of_rect(Hinv, self.viewport.x0, self.viewport.y0,
                                   self.viewport.x1, self.viewport.y1)
        out = (max(lr[0], vb[0] - margin), max(lr[1], vb[1] - margin),
               min(lr[2], vb[2] + margin), min(lr[3], vb[3] + margin))
        if out[2] <= out[0] or out[3] <= out[1]:
            return None
        return out

    def _split_planes(self, children):
        """BSP-order preserve-3d child planes; → [(child, polygon|None)]
        where polygon is a device-space convex fragment (None = whole
        plane, no clip needed)."""
        from . import plane_split as ps
        polys = []
        quads = {}
        for i, child in enumerate(children):
            q = None
            if isinstance(child, PicturePrim):
                q = self._plane_quad(child)
            elif hasattr(child, "common"):
                # bare prims in a preserve-3d context are planes too —
                # coplanar planes keep DISPLAY LIST order through the
                # splitter (split/same-plane.yaml)
                q = self._quad_of_rect(child.common.spatial_node,
                                       child.common.local_rect)
            quads[i] = q
            if q is not None:
                polys.append(ps.Polygon(q, i))
        if len(polys) < 2:
            return [(c, None) for c in
                    sorted(children, key=self._child_depth)]
        frags = ps.split_planes(polys)
        out = []
        emitted_whole = set()
        for f in frags:
            child = children[f.anchor]
            if not f.was_split:
                if f.anchor in emitted_whole:
                    continue
                emitted_whole.add(f.anchor)
                out.append((child, None))
            else:
                pts = [(float(p[0]), float(p[1])) for p in f.pts]
                out.append((child, tuple(pts)))
        # children without geometry keep their depth-sorted position
        rest = [children[i] for i, q in quads.items() if q is None]
        for c in sorted(rest, key=self._child_depth):
            out.append((c, None))
        return out

    def _plane_quad(self, pic: PicturePrim):
        """Device-space 3D quad ([4,3] x,y,z) of a preserve-3d child's
        content plane (picture.rs map_pic_to_world polygon)."""
        spatial = pic.common.spatial_node
        r = self._local_content_rect(pic, spatial)
        if r is None or r[2] <= r[0] or r[3] <= r[1]:
            return None
        from ..api.units import Rect as _Rect
        return self._quad_of_rect(spatial,
                                  _Rect.from_bounds(r[0], r[1], r[2], r[3]))

    def _quad_of_rect(self, spatial: int, rect):
        if int(self.palette[spatial][11]) & 1:
            return None  # non-invertible
        if rect.x1 <= rect.x0 or rect.y1 <= rect.y0:
            return None
        m = np.asarray(self.resolved[spatial].world.m,
                       np.float64).reshape(4, 4)
        corners = np.array([[rect.x0, rect.y0, 0.0, 1.0],
                            [rect.x1, rect.y0, 0.0, 1.0],
                            [rect.x1, rect.y1, 0.0, 1.0],
                            [rect.x0, rect.y1, 0.0, 1.0]], np.float64)
        dev = corners @ m
        w = dev[:, 3]
        if np.any(w <= 1e-6):
            return None  # behind the eye: skip splitting for this plane
        return dev[:, :3] / w[:, None]

    def _local_content_rect(self, pic: PicturePrim, spatial: int):
        """Union of descendant prim rects expressed in `spatial`'s space."""
        bbox = None

        def add(rect):
            nonlocal bbox
            if rect is None:
                return
            bbox = rect if bbox is None else (
                min(bbox[0], rect[0]), min(bbox[1], rect[1]),
                max(bbox[2], rect[2]), max(bbox[3], rect[3]))

        def map_rect(r: Rect, src: int):
            if src == spatial:
                return (r.x0, r.y0, r.x1, r.y1)
            ms = np.asarray(self.resolved[src].world.m,
                            np.float64).reshape(4, 4)
            md = np.asarray(self.resolved[spatial].world.m,
                            np.float64).reshape(4, 4)
            try:
                rel = ms @ np.linalg.inv(md)
            except np.linalg.LinAlgError:
                return None
            cs = np.array([[r.x0, r.y0, 0, 1], [r.x1, r.y0, 0, 1],
                           [r.x1, r.y1, 0, 1], [r.x0, r.y1, 0, 1]],
                          np.float64) @ rel
            w = cs[:, 3]
            if np.any(np.abs(w) < 1e-9):
                return None
            xy = cs[:, :2] / w[:, None]
            return (float(xy[:, 0].min()), float(xy[:, 1].min()),
                    float(xy[:, 0].max()), float(xy[:, 1].max()))

        def walk(p):
            for ch in p.children:
                if isinstance(ch, PicturePrim):
                    walk(ch)
                else:
                    c = ch.common
                    r = c.local_rect.intersection(c.clip_rect) \
                        if c.clip_rect is not None else c.local_rect
                    if r is not None:
                        add(map_rect(r, c.spatial_node))
        walk(pic)
        return bbox

    def _child_depth(self, child) -> float:
        m = self.resolved[child.common.spatial_node].world.m
        w = m[15] if abs(m[15]) > 1e-9 else 1e-9
        return m[14] / w

    def _prim_backfacing(self, c) -> bool:
        """Backface culls only inside a 3D context, with orientation
        evaluated RELATIVE to the prim's containing block — subtrees
        flattened by composite ops are exempt from ancestor 3D rotations
        (visibility.rs VisibleFace vs scene_building.rs:2214;
        split/filter.yaml)."""
        st = self.scene.spatial_tree
        if not st.in_3d_context(c.spatial_node):
            return False
        nz = st.orientation_normal_z(c.spatial_node, self._properties)
        ncb = st.orientation_normal_z(c.containing_block, self._properties)
        return nz * ncb < 0

    def _sc_backface_culled(self, spatial: Optional[int]) -> bool:
        """SC-level backface: own plane orientation, no 3D-context
        requirement (backface-sc.yaml vs backface-both-sides.yaml)."""
        if spatial is None:
            return False
        return self.scene.spatial_tree.orientation_normal_z(
            spatial, self._properties) < 0

    # ------------------------------------------------------------------
    # raster-root contexts: map nodes into the active raster space
    # ------------------------------------------------------------------
    def _has_perspective_ancestor(self, node: int) -> bool:
        """Perspective reference frames establish raster roots even when the
        projected content currently sits at z=0 (picture.rs: perspective
        forces local-space rasterization — raster_root_A_8192.yaml)."""
        tree = self.scene.spatial_tree
        i = node
        while i is not None:
            n = tree.nodes[i]
            if n is None:
                break
            if n.kind == SpatialNodeKind.REFERENCE_FRAME and n.is_perspective:
                return True
            i = n.parent
        return False

    def _dev_vec(self, spatial: int, vx: float, vy: float):
        """Map a LOCAL-space vector to raster space through the linear
        part of the node's transform (drop-shadow offsets rotate with the
        content — filter-drop-shadow-clip-2)."""
        H = self._H(spatial)
        return (vx * H[0, 0] + vy * H[1, 0], vx * H[0, 1] + vy * H[1, 1])

    def _H(self, node: int) -> np.ndarray:
        """local→raster-space 2D homography for `node` (device space when
        no raster-root context is active)."""
        if self._rctx is None:
            return self.H_dev[node]
        key = (self._rctx, node)
        H = self._rctx_H.get(key)
        if H is None:
            root, s = self._rctx
            rel = self.H_dev[node] @ np.linalg.inv(self.H_dev[root])
            rel = rel.copy()
            rel[:, 0] *= s
            rel[:, 1] *= s
            self._rctx_H[key] = H = rel
        return H

    def _row(self, node: int) -> int:
        """Transform-palette row index for `node` in the active raster
        space (extra rows are appended for raster-root contexts)."""
        if self._rctx is None:
            return node
        key = (self._rctx, node)
        idx = self._rctx_row.get(key)
        if idx is None:
            rel = self._H(node)
            row = np.zeros((1, self.palette.shape[1]), np.float32)
            flags = 0.0
            try:
                Hinv = np.linalg.inv(rel)
            except np.linalg.LinAlgError:
                Hinv = np.eye(3)
                flags = 1.0
            w = abs(rel[2, 2]) if abs(rel[2, 2]) > 1e-9 else 1.0
            row[0, 0:9] = Hinv.reshape(-1).astype(np.float32)
            row[0, 9] = max(float(np.hypot(rel[0, 0], rel[0, 1])) / w, 1e-9)
            row[0, 10] = max(float(np.hypot(rel[1, 0], rel[1, 1])) / w, 1e-9)
            row[0, 11] = flags
            idx = self.palette.shape[0]
            self.palette = np.concatenate([self.palette, row], axis=0)
            self._rctx_row[key] = idx
        return idx

    def _pal(self, node: int) -> np.ndarray:
        idx = self._row(node)   # may grow self.palette — resolve index first
        return self.palette[idx]

    # ------------------------------------------------------------------
    # picture-cache slices (tile_cache.rs: up to 12 slices per scroll
    # root; SURVEY.md §5.7).  Consecutive runs of root prims sharing a
    # scroll root become slices whose tiles are keyed in the scroll
    # root's CONTENT space — a pure scroll is a tile remap at composite,
    # not a re-raster.
    # ------------------------------------------------------------------
    MAX_CACHE_SLICES = 12  # tile_cache.rs:32

    def _scroll_root_of(self, node: int) -> Optional[int]:
        """Outermost real scroll-frame ancestor (excluding the implicit
        root scroll node), or None."""
        hit = self._scroll_root_cache.get(node)
        if hit is not None or node in self._scroll_root_cache:
            return hit
        tree = self.scene.spatial_tree
        out = None
        i = node
        while i is not None and 0 <= i < len(tree.nodes):
            n = tree.nodes[i]
            if n is None:
                break
            if n.kind == SpatialNodeKind.SCROLL_FRAME and n.index > 1:
                out = n.index
            i = n.parent
        self._scroll_root_cache[node] = out
        return out

    def _is_descendant(self, node: int, anc: int) -> bool:
        key = (node, anc)
        hit = self._descendant_cache.get(key)
        if hit is not None:
            return hit
        tree = self.scene.spatial_tree
        i = node
        out = False
        while i is not None and 0 <= i < len(tree.nodes):
            if i == anc:
                out = True
                break
            n = tree.nodes[i]
            if n is None:
                break
            i = n.parent
        self._descendant_cache[key] = out
        return out

    def _emit_root_passes(self, insts: List, region, clear) -> None:
        w, h = region[2], region[3]
        has_backdrop = any(isinstance(e, tuple) for e in insts)
        runs = None
        if not has_backdrop and insts:
            runs = self._assign_slices(insts)
        if not runs or all(r[0] is None for r in runs):
            self._emit_target_passes(insts, TARGET_ROOT, region, (0.0, 0.0),
                                     clear)
            return
        instances = self.gb.snapshot_instances()
        for i, (sr, ids) in enumerate(runs):
            seg_ids = np.asarray(ids, np.int64)
            tile_insts, tile_counts, nx, ny = bin_instances(
                seg_ids, self.metas.bbox[seg_ids], (0.0, 0.0), (w, h),
                opaque=self.metas.opaque[seg_ids],
                opaque_mask=self.metas.opaque_mask[seg_ids])
            p = RenderPass(
                PASS_RASTER, TARGET_ROOT, region, (0.0, 0.0),
                clear=clear if i == 0 else None,
                tile_insts=tile_insts, tile_counts=tile_counts,
                nx=nx, ny=ny, inst_order=seg_ids.astype(np.int32))
            if sr is not None:
                self._attach_slice_cache(p, sr, i, seg_ids, instances,
                                         (w, h))
            self.passes.append(p)

    def _assign_slices(self, insts: List):
        """Consecutive runs by scroll root; a run is a cache slice only if
        its content is offset-invariant (see _run_cacheable)."""
        instances = self.gb.snapshot_instances()
        n_nodes = len(self.resolved)
        if not insts:
            return []
        # vectorized run split: scroll roots resolve once per unique
        # spatial node, runs come from the boundary diff (no per-instance
        # Python)
        e_arr = np.asarray(insts, np.int64)
        spat = instances[e_arr, 1]
        uniq = np.unique(spat)
        lut = np.empty(uniq.shape[0], np.int64)
        for j, s_ in enumerate(uniq):
            sr_ = self._scroll_root_of(int(s_)) if s_ < n_nodes else None
            lut[j] = -1 if sr_ is None else sr_
        srs = lut[np.searchsorted(uniq, spat)]
        cut = np.flatnonzero(np.diff(srs)) + 1
        starts = np.concatenate([[0], cut])
        ends = np.concatenate([cut, [len(e_arr)]])
        runs: List[Tuple[Optional[int], List[int]]] = [
            (None if srs[a] < 0 else int(srs[a]), e_arr[a:b].tolist())
            for a, b in zip(starts, ends)]
        if len(runs) == 1 and runs[0][0] is None:
            return runs
        # cap (tile_cache.rs MAX_CACHE_SLICES): overflow merges, uncached
        if len(runs) > self.MAX_CACHE_SLICES:
            merged: List[int] = []
            for _, ids in runs[self.MAX_CACHE_SLICES - 1:]:
                merged.extend(ids)
            runs = runs[: self.MAX_CACHE_SLICES - 1] + [(None, merged)]
        out = []
        for sr, ids in runs:
            if sr is not None and not self._run_cacheable(sr, ids, instances):
                # observability for the silent-loss case (mix-blend
                # headers, polygon clips, …): pages that lose scroll
                # caching show up in the profiler instead of just
                # getting slower (profiler.rs role for
                # "Rendered picture tiles" anomalies)
                self.slice_cache_disabled_runs += 1
                sr = None
            out.append((sr, ids))
        return out

    def _run_cacheable(self, sr: int, ids: List[int],
                       instances: np.ndarray) -> bool:
        # scroll root must map content→device by a pure integer translation
        pal = self.palette[sr]
        if not (abs(pal[0] - 1) < 1e-6 and abs(pal[4] - 1) < 1e-6 and
                abs(pal[1]) < 1e-9 and abs(pal[3]) < 1e-9 and
                abs(pal[2]) < 1e-9 and abs(pal[5]) < 1e-9 and
                abs(pal[8] - 1) < 1e-6):
            return False
        Hd = self.H_dev[sr]
        dx, dy = float(Hd[2, 0]), float(Hd[2, 1])
        if abs(dx - round(dx)) > 1e-3 or abs(dy - round(dy)) > 1e-3:
            return False
        arr = instances[np.asarray(ids, np.int64)]
        if (arr[:, 5] != BLEND_NORMAL).any():  # exotic blends need backdrop
            return False
        if (arr[:, 0] == KIND_CLEAR).any():    # clears punch lower slices
            return False
        fixed_rects = set()
        for rec in arr:
            if rec[4] == 0:
                continue
            meta = self._clip_meta.get(int(rec[3]))
            if meta is None:
                return False
            nodes_info, has_poly = meta
            if has_poly:
                return False
            for (node, kind, mode, db) in nodes_info:
                if self._is_descendant(node, sr):
                    continue
                # fixed clip: only axis-aligned rect CLIPs survive (their
                # tiles get edge-dirty marking); anything else varies
                # sub-tile with the offset
                if db is None or kind != ClipKind.RECT or \
                        mode != ClipMode.CLIP:
                    return False
                fixed_rects.add(tuple(round(v, 2) for v in db))
        if len(fixed_rects) > 4:
            return False
        return True

    def _attach_slice_cache(self, p: RenderPass, sr: int, run_idx: int,
                            seg_ids: np.ndarray, instances: np.ndarray,
                            size) -> None:
        w, h = size
        Hd = self.H_dev[sr]
        dx = int(round(float(Hd[2, 0])))
        dy = int(round(float(Hd[2, 1])))
        # content-space window covering the device viewport + margins; the
        # window SIZE is a pure function of the viewport so a scroll only
        # moves the anchor (same grid, tiles remap)
        ax = int(math.floor((0 - dx) / TILE_W)) - 1
        ay = int(math.floor((0 - dy) / TILE_H)) - 1
        nxc = int(math.ceil(w / TILE_W)) + 3
        nyc = int(math.ceil(h / TILE_H)) + 3
        cb = self.metas.bbox[seg_ids].astype(np.float64).copy()
        cb[:, 0] -= dx
        cb[:, 1] -= dy
        cb[:, 2] -= dx
        cb[:, 3] -= dy
        ci, cc, gx, gy = bin_instances(
            seg_ids, cb, (ax * TILE_W, ay * TILE_H),
            (nxc * TILE_W, nyc * TILE_H),
            opaque=self.metas.opaque[seg_ids] -
            np.array([dx, dy, dx, dy], np.float32),
            opaque_mask=self.metas.opaque_mask[seg_ids])
        p.slice_key = ("slice", run_idx, sr)
        p.slice_delta = (dx, dy)
        p.cache_insts = ci
        p.cache_counts = cc
        p.cache_nx = gx
        p.cache_ny = gy
        p.cache_anchor = (ax, ay)
        # fixed-clip crops: their tiles get offset-mixed hashes later; the
        # composite itself needs no crop beyond the viewport because the
        # clips stay in the rastered content
        p.cache_crop = (0, 0, w, h)

    def _fixed_clip_rects(self, p: RenderPass,
                          instances: np.ndarray) -> List[Tuple]:
        out = []
        sr = p.slice_key[2]
        for e in p.inst_order:
            rec = instances[int(e)]
            if rec[4] == 0:
                continue
            meta = self._clip_meta.get(int(rec[3]))
            if meta is None:
                continue
            for (node, kind, mode, db) in meta[0]:
                if db is not None and not self._is_descendant(node, sr):
                    out.append(db)
        return out

    def _emit_target_passes(self, insts: List, target: int,
                            region: Tuple[int, int, int, int],
                            origin: Tuple[float, float],
                            clear, step: float = 1.0) -> None:
        """Bin instances into raster passes over one target, splitting at
        backdrop-filter markers (the Readback / BackdropCapture role of
        render_task.rs re-designed: the backdrop is just the target array)."""
        segments: List[List[int]] = [[]]
        markers: List = []
        for e in insts:
            if isinstance(e, tuple) and e[0] == "backdrop":
                markers.append(e[1])
                segments.append([])
            else:
                segments[-1].append(e)
        x, y, w, h = region
        ox, oy = origin
        for i, seg in enumerate(segments):
            if i > 0:
                inst = self._emit_backdrop_instance(markers[i - 1], target,
                                                    region, origin)
                if inst is not None:
                    seg.insert(0, inst)
            if seg or i == 0:
                seg_ids = np.asarray(seg, np.int64)
                tile_insts, tile_counts, nx, ny = bin_instances(
                    seg_ids, self.metas.bbox[seg_ids], (ox, oy), (w, h),
                    step=step,
                    opaque=self.metas.opaque[seg_ids],
                    opaque_mask=self.metas.opaque_mask[seg_ids])
                self.passes.append(RenderPass(
                    PASS_RASTER, target, region, (float(ox), float(oy)),
                    clear=clear if i == 0 else None,
                    tile_insts=tile_insts, tile_counts=tile_counts,
                    nx=nx, ny=ny, raster_step=step,
                    inst_order=np.asarray(seg, np.int32)))

    def _emit_backdrop_instance(self, prim, target: int,
                                region: Tuple[int, int, int, int],
                                origin: Tuple[float, float]) -> Optional[int]:
        """Copy the backdrop region out of the target, filter it, and return
        a PICTURE instance that composites the result back."""
        c = prim.common
        # the filtered region is bounded by the prim's rect in the prim's
        # OWN space: under a transformed stacking context the visible
        # filtered area is the projected rect (a rotated diamond), not its
        # device AABB (backdrop-filter-transformed-filter.yaml) — append a
        # rect clip record in the prim's spatial space
        rec = [0.0] * CLIP_STRIDE
        rec[96:108] = [float(v) for v in self._pal(c.spatial_node)]
        rr = self._snap_rect(c.clip_rect, c.spatial_node)
        rec[0:4] = [rr.x0, rr.y0, rr.x1, rr.y1]
        rec[13] = float(self._row(c.spatial_node))
        clip_addr, clip_count, clip_bbox = self._serialize_clips(
            c.clip_chain, c.spatial_node, extra_records=[rec])
        db = device_bounds_of_rect(self._H(c.spatial_node),
                                   c.clip_rect.x0, c.clip_rect.y0,
                                   c.clip_rect.x1, c.clip_rect.y1)
        bbox = list(db)
        if clip_bbox is not None:
            bbox = [max(bbox[0], clip_bbox[0]), max(bbox[1], clip_bbox[1]),
                    min(bbox[2], clip_bbox[2]), min(bbox[3], clip_bbox[3])]
        x, y, w, h = region
        ox, oy = origin
        bbox = [max(bbox[0], ox), max(bbox[1], oy),
                min(bbox[2], ox + w), min(bbox[3], oy + h)]
        if bbox[2] <= bbox[0] or bbox[3] <= bbox[1]:
            for r in self._region_scopes.pop():
                self.surface_atlas.free(r)
            return None
        bx0 = int(math.floor(bbox[0]))
        by0 = int(math.floor(bbox[1]))
        bw = int(math.ceil(bbox[2])) - bx0
        bh = int(math.ceil(bbox[3])) - by0
        dst = self.surface_atlas.alloc(bw, bh)
        # src coords: device → target-array coords
        sx = x + int(bx0 - ox)
        sy = y + int(by0 - oy)
        self.passes.append(RenderPass(
            PASS_COPY, TARGET_SURFACE, (dst.x, dst.y, bw, bh),
            src_region=(sx, sy, bw, bh), src_target=target))
        dst = AtlasRegion(dst.x, dst.y, bw, bh)

        fs = self._accumulate_filters(prim.filters, prim.filter_datas,
                                      c.spatial_node)
        if fs["channel_lut"] is not None:
            lut_dst = self.surface_atlas.alloc(bw, bh)
            self.passes.append(RenderPass(
                PASS_CHANNEL_LUT, TARGET_SURFACE,
                (lut_dst.x, lut_dst.y, bw, bh),
                src_region=(dst.x, dst.y, bw, bh), lut=fs["channel_lut"]))
            dst = AtlasRegion(lut_dst.x, lut_dst.y, bw, bh)
        if fs["color_matrix"] is not None:
            # the filtered backdrop is drawn into the wrapping picture's
            # RGBA8 surface (brush_blend → render target), so the matrix
            # result quantizes to u8 BEFORE the wrapping stacking context's
            # opacity composite — structural (+1 color target) and
            # bit-exactness parity (invert(128)·0.5: 127·0.5 → 63.5 → 64,
            # not 63.4999 → 63 through a folded f32 chain)
            m_dst = self.surface_atlas.alloc(bw, bh)
            self.passes.append(RenderPass(
                PASS_COLOR_MATRIX, TARGET_SURFACE,
                (m_dst.x, m_dst.y, bw, bh),
                src_region=(dst.x, dst.y, bw, bh),
                color_matrix=np.asarray(fs["color_matrix"],
                                        np.float32).reshape(-1)))
            dst = AtlasRegion(m_dst.x, m_dst.y, bw, bh)
        scale = 1
        blur_sx, blur_sy = fs["blur"]
        if blur_sx > 0 or blur_sy > 0:
            dst, scale = self._push_blur(dst, blur_sx, blur_sy)

        rect = [float(bx0), float(by0), float(bx0 + bw), float(by0 + bh)]
        payload = rect + rect
        payload += [dst.x, dst.y, dst.x + bw / scale, dst.y + bh / scale]
        op = fs["opacity"]
        payload += [op, op, op, op]
        payload += list(identity_color_matrix().reshape(-1)) + [0.0]
        addr = self.gb.push_f32(payload)
        idx = self.gb.push_instance(KIND_PICTURE, self.device_spatial, addr,
                                    clip_addr, clip_count, BLEND_NORMAL,
                                    edge_aa=0)
        self.metas.push(tuple(bbox))
        return idx

    def _accumulate_filters(self, filters, filter_datas, spatial: int):
        """Fold a CSS filter chain into blur sigmas (device px), a color
        matrix, a channel LUT, opacity, and drop shadows
        (picture.rs PictureCompositeMode::Filter handling).  Scale factors
        come from the ACTIVE raster space (_pal): inside a raster-root
        context σ is in ctx units — the reference computes blur std dev
        against the surface's raster spatial node (picture.rs:5890)."""
        pal = self._pal(spatial)
        dev_sx, dev_sy = float(pal[9]), float(pal[10])
        blur_sx = blur_sy = 0.0
        color_matrix: Optional[np.ndarray] = None
        opacity = 1.0
        drop_shadows: List = []
        channel_lut: Optional[np.ndarray] = None
        # the ordered per-filter stages (the reference gives EACH chain
        # filter its own surface pass — scene_building.rs PictureChain —
        # so intermediates clamp AND quantize to u8 between stages;
        # filter-long-chain.yaml: brightness(2) must saturate before
        # contrast() sees it, which a folded matrix cannot reproduce)
        stages: List = []
        n_color = 0
        saw_blur = False
        shadow_after_blur = False
        fd_iter = iter(filter_datas)
        for f in filters:
            k = f.kind
            if k == FilterOpKind.OPACITY:
                opacity *= f.value
                if f.value < 1.0:
                    m = np.zeros((4, 5), np.float32)
                    m[0, 0] = m[1, 1] = m[2, 2] = 1.0
                    m[3, 3] = f.value
                    stages.append(("cm", m))
                    opacity_staged = True
            elif k == FilterOpKind.BLUR:
                # picture.rs MAX_BLUR_RADIUS (=100) clamps scaled blur radii
                blur_sx = min(blur_sx + f.value * dev_sx, 100.0)
                blur_sy = min(blur_sy + f.value2 * dev_sy, 100.0)
                saw_blur = True
            elif k == FilterOpKind.DROP_SHADOW:
                drop_shadows.append(f.shadow)
                if saw_blur:
                    shadow_after_blur = True
            elif k == FilterOpKind.IDENTITY:
                pass
            elif k == FilterOpKind.COMPONENT_TRANSFER:
                fd = next(fd_iter, None)
                if fd is not None:
                    lut = _component_transfer_lut(fd)
                    channel_lut = lut if channel_lut is None else \
                        _compose_channel_lut(lut, channel_lut)
                    stages.append(("lut", lut))
                    n_color += 1
            elif k == FilterOpKind.SRGB_TO_LINEAR:
                lut = _srgb_lut(to_linear=True)
                channel_lut = lut if channel_lut is None else \
                    _compose_channel_lut(lut, channel_lut)
                stages.append(("lut", lut))
                n_color += 1
            elif k == FilterOpKind.LINEAR_TO_SRGB:
                lut = _srgb_lut(to_linear=False)
                channel_lut = lut if channel_lut is None else \
                    _compose_channel_lut(lut, channel_lut)
                stages.append(("lut", lut))
                n_color += 1
            elif k == FilterOpKind.FLOOD:
                c = f.shadow.color if f.shadow else ColorF.BLACK
                color_matrix = np.zeros((4, 5), np.float32)
                color_matrix[0, 4] = c.r
                color_matrix[1, 4] = c.g
                color_matrix[2, 4] = c.b
                color_matrix[3, 4] = c.a
                stages.append(("cm", color_matrix))
                n_color += 1
            else:
                m = _filter_color_matrix(k, f)
                if m is not None:
                    color_matrix = m if color_matrix is None \
                        else _compose_color_matrix(m, color_matrix)
                    stages.append(("cm", m))
                    n_color += 1
        # stage per-filter only where folding is observably different:
        # >=2 color stages (intermediate clamp/quantize), or color stages
        # feeding a drop shadow (the shadow tints the POST-filter content)
        staged = n_color >= 2 or (n_color >= 1 and drop_shadows)
        if staged:
            # opacity stages run in-chain; keep only the ones folded for
            # the non-staged path out of the composite opacity
            stages = [(k_, v_) if k_ != "op" else ("cm", v_)
                      for k_, v_ in stages]
            opacity = 1.0
        else:
            stages = None
        return {"blur": (blur_sx, blur_sy),
                "color_matrix": None if staged else color_matrix,
                "opacity": opacity, "drop_shadows": drop_shadows,
                "channel_lut": None if staged else channel_lut,
                "dev_scale": (dev_sx, dev_sy),
                "pre_stages": stages,
                "shadow_after_blur": shadow_after_blur}

    def _build_surface(self, pic: PicturePrim, out: List[int],
                       plane: bool = False) -> None:
        """Render `pic` into a surface-atlas region, then emit composite
        instance(s) into the parent (`picture.rs` PictureCompositeMode).
        `plane`: the surface is a preserve-3d plane — its composite is the
        ps_split_composite role, drawn WITHOUT edge AA (the reference's 3D
        plane edges are aliased; AA would bleed content past the seam)."""
        if self._sc_backface_culled(pic.common.backface_cull_spatial):
            return
        # a preserve-3d BSP fragment clip applies to the COMPOSITE instance
        # only — the surface content rasters unclipped (blurs must see
        # content beyond the fragment seam)
        frag_poly = self._poly_clip
        self._poly_clip = None

        # raster-root clamping (picture.rs MAX_SURFACE_SIZE=4096): a surface
        # under a non-axis-aligned transform whose LOCAL content exceeds the
        # max rasterizes in its own local space at a clamped scale and is
        # sampled through the projective transform at composite
        # (raster_root_*_8192.yaml)
        use_ctx = False
        ctx_s = 1.0
        lr0 = None
        ctx_cm = None
        if pic.shadow is None and self._rctx is None and \
                not self.resolved[pic.common.spatial_node].is_2d_axis_aligned:
            # Non-axis-aligned surfaces establish a raster root
            # (picture.rs:6775-6807): the content rasterizes in the
            # surface's OWN local space at device_pixel_scale =
            # max(world scale factors) — forced to (1,1) when the
            # transform has perspective (picture.rs:6675) — and the
            # composite samples it through the projective transform.
            # Simple filter chains (opacity / color matrix / identity)
            # fold into the composite; blur / shadows / SVGFE / LUT
            # chains still raster in device space for now.
            svgfe_any = any(f.svgfe is not None
                            for f in pic.composite.filters)
            fs_pre = self._accumulate_filters(
                tuple(f for f in pic.composite.filters if f.svgfe is None),
                pic.composite.filter_datas, pic.common.spatial_node)
            # Every non-axis-aligned filtered surface rasters in its own
            # local raster space (picture.rs:3754 post_update raster-root
            # selection): blur/drop-shadow σ then applies PRE-projection
            # (screen-space-blur.yaml shows the anisotropic smear), and
            # only the composite goes through the projective transform.
            # SVGFE graphs still raster in device space for now.
            simple = not svgfe_any
            if simple:
                lr0 = self._local_content_rect(pic, pic.common.spatial_node)
            if lr0 is not None:
                # widen the visible window by the filters' LOCAL reach so
                # off-screen source content still rasters (blur taps,
                # drop-shadow back-translation)
                marg_l = 0.0
                for f in pic.composite.filters:
                    if f.kind == FilterOpKind.BLUR:
                        marg_l += math.ceil(
                            min(max(f.value, f.value2), 100.0)) * 3.0
                    elif f.kind == FilterOpKind.DROP_SHADOW and f.shadow:
                        marg_l += 3.0 * min(f.shadow.blur_radius, 100.0) \
                            + max(abs(f.shadow.offset.x),
                                  abs(f.shadow.offset.y))
                lr0 = self._clip_local_to_viewport(lr0,
                                                   pic.common.spatial_node,
                                                   margin=marg_l)
            if lr0 is not None and lr0[2] > lr0[0] and lr0[3] > lr0[1]:
                use_ctx = True
                ctx_cm = fs_pre["color_matrix"]
                H = self._H(pic.common.spatial_node)
                # row-vector homography: perspective terms live in the
                # third column (w = x*H02 + y*H12 + H22)
                persp = abs(float(H[0, 2])) > 1e-9 or \
                    abs(float(H[1, 2])) > 1e-9
                if persp:
                    s = 1.0
                else:
                    s = max(math.hypot(float(H[0, 0]), float(H[0, 1])),
                            math.hypot(float(H[1, 0]), float(H[1, 1])))
                    s = max(s, 1e-3)
                lsize = max(lr0[2] - lr0[0], lr0[3] - lr0[1])
                # keep the ctx raster rect (content + blur margins + the
                # viewport margin and ceil rounding) within MAX_SURFACE_SIZE
                sigma_l = 0.0
                for f in pic.composite.filters:
                    if f.kind == FilterOpKind.BLUR:
                        sigma_l += max(f.value, f.value2)
                    elif f.kind == FilterOpKind.DROP_SHADOW and f.shadow:
                        sigma_l += f.shadow.blur_radius + max(
                            abs(f.shadow.offset.x), abs(f.shadow.offset.y))
                ctx_s = min(s, (4096.0 - 24.0) / (lsize + 6.0 * sigma_l))
        saved_vp = self.viewport
        if use_ctx:
            self._rctx = (pic.common.spatial_node, ctx_s)
            # blur/drop-shadow filters read content beyond the composite
            # clip: widen the ctx raster window by the blur margin in ctx
            # units (picture.rs get_coverage inflation, local space)
            ctx_margin = 4.0
            for f in pic.composite.filters:
                if f.kind == FilterOpKind.BLUR:
                    ctx_margin += math.ceil(
                        min(max(f.value, f.value2) * ctx_s, 100.0)) * 3.0
                elif f.kind == FilterOpKind.DROP_SHADOW and f.shadow:
                    ctx_margin += 3.0 * min(
                        f.shadow.blur_radius * ctx_s, 100.0) + max(
                        abs(f.shadow.offset.x), abs(f.shadow.offset.y)) * ctx_s
            self.viewport = Rect.from_bounds(
                lr0[0] * ctx_s - ctx_margin, lr0[1] * ctx_s - ctx_margin,
                lr0[2] * ctx_s + ctx_margin, lr0[3] * ctx_s + ctx_margin)

        if not use_ctx:
            # the surface's filters read content beyond the visible
            # viewport (a drop shadow pulls content from -offset, blurs
            # from ±3σ): inflate the cull window for the children so
            # off-screen source pixels still rasterize
            # (picture.rs get_coverage — filter-drop-shadow-clip-3.yaml
            # checks the inflation happens in the right space)
            margin = 0.0
            fs_m = self._accumulate_filters(
                tuple(f for f in pic.composite.filters if f.svgfe is None),
                pic.composite.filter_datas, pic.common.spatial_node)
            mb = max(fs_m["blur"])
            if pic.shadow is not None:
                mb += pic.shadow.blur_radius * 0.5 * max(fs_m["dev_scale"])
                odx, ody = self._dev_vec(pic.common.spatial_node,
                                         pic.shadow.offset.x,
                                         pic.shadow.offset.y)
                margin += max(abs(odx), abs(ody))
            margin += math.ceil(min(mb, 100.0)) * 3.0
            for sh in fs_m["drop_shadows"]:
                odx, ody = self._dev_vec(pic.common.spatial_node,
                                         sh.offset.x, sh.offset.y)
                margin += 3.0 * min(sh.blur_radius
                                    * max(fs_m["dev_scale"]), 100.0) \
                    + max(abs(odx), abs(ody))
            for f in pic.composite.filters:
                if f.svgfe is not None:
                    node = f.svgfe
                    margin += math.ceil(
                        3.0 * min(max(node["std_x"], node["std_y"])
                                  * max(fs_m["dev_scale"]), 100.0)
                        + max(abs(node["dx"]), abs(node["dy"]))
                        * max(fs_m["dev_scale"]))
            if margin > 0.0:
                self.viewport = saved_vp.inflate(margin, margin)
        child_insts: List[int] = []
        self._surface_depth += 1
        self._region_scopes.append([])
        self._process_picture(pic, child_insts)
        self._surface_depth -= 1
        self._poly_clip = frag_poly
        self.viewport = saved_vp
        if not child_insts:
            self._rctx = None if use_ctx else self._rctx
            for r in self._region_scopes.pop():
                self.surface_atlas.free(r)
            return

        svgfe_ops = [f for f in pic.composite.filters
                     if f.svgfe is not None]
        fs = self._accumulate_filters(
            tuple(f for f in pic.composite.filters if f.svgfe is None),
            pic.composite.filter_datas, pic.common.spatial_node)
        blur_sx, blur_sy = fs["blur"]
        color_matrix = fs["color_matrix"]
        opacity = fs["opacity"]
        drop_shadows = fs["drop_shadows"]
        channel_lut = fs["channel_lut"]
        dev_sx, dev_sy = fs["dev_scale"]
        if pic.shadow is not None:
            # text/box shadow picture: std dev = blur_radius / 2
            # (scene_building.rs push_shadow semantics)
            blur_sx = min(blur_sx + pic.shadow.blur_radius * 0.5 * dev_sx, 100.0)
            blur_sy = min(blur_sy + pic.shadow.blur_radius * 0.5 * dev_sy, 100.0)

        # per-axis blur inflation (picture.rs get_coverage/get_rect:
        # Filter::Blur inflates by clamped(σ_local).ceil() * 3 per axis)
        lsx = blur_sx / dev_sx if dev_sx > 1e-6 else 0.0
        lsy = blur_sy / dev_sy if dev_sy > 1e-6 else 0.0
        infl_x = math.ceil(lsx) * 3.0 * dev_sx
        infl_y = math.ceil(lsy) * 3.0 * dev_sy
        # CSS drop-shadow(): σ = blur_radius, NOT halved — picture.rs
        # :5976 passes the full radius to new_blur (the *0.5 at
        # scene_building.rs:2923 is only for push_shadow text shadows);
        # device σ per axis, clamped (picture.rs clamp_blur_radius)
        shadow_params = []
        for sh in drop_shadows:
            sdx = min(sh.blur_radius * dev_sx, 100.0)
            sdy = min(sh.blur_radius * dev_sy, 100.0)
            odx, ody = self._dev_vec(pic.common.spatial_node,
                                     sh.offset.x, sh.offset.y)
            shadow_params.append((sdx, sdy, odx, ody))
        svgfe_inflate = 0.0
        for f in svgfe_ops:
            # offset/blur/shadow nodes pull offscreen source pixels into
            # view: keep that margin of the source rendered
            # (svgfe-dropshadow-offscreen-source)
            node = f.svgfe
            svgfe_inflate += math.ceil(
                3.0 * min(max(node["std_x"], node["std_y"])
                          * max(dev_sx, dev_sy), 100.0)
                + max(abs(node["dx"] * dev_sx), abs(node["dy"] * dev_sy)))
        inflate = int(math.ceil(max(infl_x, infl_y)
                                + sum(3.0 * max(sdx, sdy) +
                                      max(abs(ox), abs(oy))
                                      for sdx, sdy, ox, oy in shadow_params)
                                + svgfe_inflate))

        bbox = None
        for i in child_insts:
            if isinstance(i, tuple):
                continue
            b = self.metas.bbox[i]
            bbox = b if bbox is None else (
                min(bbox[0], b[0]), min(bbox[1], b[1]),
                max(bbox[2], b[2]), max(bbox[3], b[3]))
        if bbox is None:
            for r in self._region_scopes.pop():
                self.surface_atlas.free(r)
            return
        # SVGFE nodes (e.g. flood) can emit beyond the content bbox: the
        # filter region covers every node subregion (svgfe-subregion-bigger)
        for f in svgfe_ops:
            sr = f.svgfe["subregion"]
            if sr is None:
                continue
            db = device_bounds_of_rect(self._H(pic.common.spatial_node),
                                       sr.x0, sr.y0, sr.x1, sr.y1)
            db = (max(db[0], self.viewport.x0), max(db[1], self.viewport.y0),
                  min(db[2], self.viewport.x1), min(db[3], self.viewport.y1))
            if db[2] > db[0] and db[3] > db[1]:
                bbox = (min(bbox[0], db[0]), min(bbox[1], db[1]),
                        max(bbox[2], db[2]), max(bbox[3], db[3]))
        # the picture's clips restrict what we must rasterize — but only up
        # to the blur inflation: blurs must see the unclipped content near
        # the clip edge (text/shadow-clip.yaml), the clip itself applies at
        # composite time only
        if use_ctx:
            self._rctx = None  # composite-level clips are device-space
        clip_addr, clip_count, clip_bbox = self._serialize_clips(
            pic.common.clip_chain, pic.common.spatial_node)
        blur_task = (blur_sx > 0 or blur_sy > 0 or shadow_params) \
            and not svgfe_ops and not use_ctx
        if blur_task:
            # get_surface_rects (picture.rs:7686) rect algebra, device
            # space (axis-aligned surfaces; dev scale folded into σ):
            #   A = unclipped = content.inflate(ceil(σ)*3) ∪ shadow extents
            #   B = A ∩ clip
            #   C = clipped = (B re-inflated / shadow-required) ∩ A
            ax0, ay0 = bbox[0] - infl_x, bbox[1] - infl_y
            ax1, ay1 = bbox[2] + infl_x, bbox[3] + infl_y
            if shadow_params:
                # get_rect (picture.rs:4254, DropShadows): the prim rect
                # inflated by 3·maxσ on ALL sides, NOT translated by the
                # shadow offset — the picture task must cover the blur
                # spill above/left of the content (the composite places
                # the whole blurred task at +offset)
                msx = max(s[0] for s in shadow_params) * 3.0
                msy = max(s[1] for s in shadow_params) * 3.0
                ax0 = min(ax0, bbox[0] - msx)
                ay0 = min(ay0, bbox[1] - msy)
                ax1 = max(ax1, bbox[2] + msx)
                ay1 = max(ay1, bbox[3] + msy)
            kx0, ky0 = self.viewport.x0, self.viewport.y0
            kx1, ky1 = self.viewport.x1, self.viewport.y1
            if clip_bbox is not None:
                kx0, ky0 = max(kx0, clip_bbox[0]), max(ky0, clip_bbox[1])
                kx1, ky1 = min(kx1, clip_bbox[2]), min(ky1, clip_bbox[3])
            bx0, by0 = max(ax0, kx0), max(ay0, ky0)
            bx1, by1 = min(ax1, kx1), min(ay1, ky1)
            if bx1 <= bx0 or by1 <= by0:
                for r in self._region_scopes.pop():
                    self.surface_atlas.free(r)
                return
            if shadow_params:
                # DropShadows branch of get_surface_rects: required =
                # (prim ∩ clip) ∪ per-shadow back-translated inflated clips
                cx0 = max(bbox[0], kx0)
                cy0 = max(bbox[1], ky0)
                cx1 = min(bbox[2], kx1)
                cy1 = min(bbox[3], ky1)
                for sdx, sdy, odx, ody in shadow_params:
                    ix = 3.0 * sdx
                    iy = 3.0 * sdy
                    r1x0 = max(bbox[0] + odx - ix, kx0)
                    r1y0 = max(bbox[1] + ody - iy, ky0)
                    r1x1 = min(bbox[2] + odx + ix, kx1)
                    r1y1 = min(bbox[3] + ody + iy, ky1)
                    if r1x1 <= r1x0 or r1y1 <= r1y0:
                        continue
                    cx0 = min(cx0, r1x0 - ix - odx)
                    cy0 = min(cy0, r1y0 - iy - ody)
                    cx1 = max(cx1, r1x1 + ix - odx)
                    cy1 = max(cy1, r1y1 + iy - ody)
                if blur_sx > 0 or blur_sy > 0:
                    cx0 = min(cx0, bx0 - infl_x)
                    cy0 = min(cy0, by0 - infl_y)
                    cx1 = max(cx1, bx1 + infl_x)
                    cy1 = max(cy1, by1 + infl_y)
            else:
                cx0, cy0 = bx0 - infl_x, by0 - infl_y
                cx1, cy1 = bx1 + infl_x, by1 + infl_y
            cx0, cy0 = max(cx0, ax0), max(cy0, ay0)
            cx1, cy1 = min(cx1, ax1), min(cy1, ay1)
            if cx1 <= cx0 or cy1 <= cy0:
                for r in self._region_scopes.pop():
                    self.surface_atlas.free(r)
                return
            x0 = math.floor(cx0)
            y0 = math.floor(cy0)
            sw = int(math.ceil(cx1) - x0)
            sh_ = int(math.ceil(cy1) - y0)
        else:
            if clip_bbox is not None and not use_ctx:
                bbox = (max(bbox[0], clip_bbox[0] - inflate),
                        max(bbox[1], clip_bbox[1] - inflate),
                        min(bbox[2], clip_bbox[2] + inflate),
                        min(bbox[3], clip_bbox[3] + inflate))
            if not use_ctx:
                vp = self.viewport.inflate(inflate + 2, inflate + 2)
                bbox = (max(bbox[0], vp.x0), max(bbox[1], vp.y0),
                        min(bbox[2], vp.x1), min(bbox[3], vp.y1))
            if use_ctx and inflate == 0 and lr0 is not None:
                # the reference's raster-root surface rect is the content
                # rect round_out'ed in raster space (picture.rs
                # get_surface_rects) — it never includes the 1px AA ring
                # the child metas carry.  Including the ring makes the
                # composite bilinear-sample across a transparent margin and
                # soften edges that the reference draws hard (preserve-3d
                # planes, ps_split_composite) or AA's at composite time
                # (brush_picture edge AA over the local rect).
                bbox = (max(bbox[0], math.floor(lr0[0] * ctx_s)),
                        max(bbox[1], math.floor(lr0[1] * ctx_s)),
                        min(bbox[2], math.ceil(lr0[2] * ctx_s)),
                        min(bbox[3], math.ceil(lr0[3] * ctx_s)))
            if bbox[2] <= bbox[0] or bbox[3] <= bbox[1]:
                for r in self._region_scopes.pop():
                    self.surface_atlas.free(r)
                return
            x0 = math.floor(bbox[0]) - inflate
            y0 = math.floor(bbox[1]) - inflate
            sw = int(math.ceil(bbox[2]) - x0) + inflate
            sh_ = int(math.ceil(bbox[3]) - y0) + inflate

        # axis-aligned oversized surfaces: raster the device region at a
        # reduced resolution and upsample at composite (MAX_SURFACE_SIZE)
        step = 1
        if not use_ctx and not svgfe_ops and not drop_shadows and \
                channel_lut is None and \
                blur_sx == 0 and blur_sy == 0 and pic.shadow is None and \
                self.resolved[pic.common.spatial_node].is_2d_axis_aligned \
                and not any(isinstance(i, tuple) for i in child_insts):
            dsize = max(sw, sh_)
            if dsize > 4096:
                step = 2 ** int(math.ceil(math.log2(dsize / 4096.0)))
        # blur sources render at a size adjusted so every downscale pass
        # samples an even multiple (render_task.rs adjusted_blur_source_size
        # — picture.rs:5890 Filter::Blur task sizing)
        tw, th = sw, sh_
        if (blur_task or use_ctx) and (blur_sx > 0 or blur_sy > 0):
            tw, th = self.adjusted_blur_source_size(sw, sh_,
                                                    blur_sx, blur_sy)
        rw = int(math.ceil(tw / step))
        rh = int(math.ceil(th / step))
        region = self.surface_atlas.alloc(rw, rh)
        region = AtlasRegion(region.x, region.y, rw, rh)
        # content size (the atlas allocator rounds regions up to its
        # alignment; compositing must hug the content or filters would
        # process the transparent padding)
        cw, ch = sw, sh_

        self._emit_target_passes(
            child_insts, TARGET_SURFACE,
            (region.x, region.y, region.w, region.h), (x0, y0),
            (0.0, 0.0, 0.0, 0.0), step=float(step))
        # the children's composite regions were consumed by the passes
        # just emitted — release them for aliasing
        for r in self._region_scopes.pop():
            self.surface_atlas.free(r)

        if use_ctx:
            # the full CSS filter chain runs in the surface's LOCAL raster
            # space (σ already in ctx units via _accumulate_filters), then
            # ONE projective composite per output (picture.rs raster roots)
            ctx_region = region
            ctx_scale = 1
            if fs["pre_stages"]:
                ctx_region = self._run_filter_stages(fs["pre_stages"],
                                                     ctx_region, sw, sh_)
            elif channel_lut is not None:
                dst = self.surface_atlas.alloc(region.w, region.h)
                self.passes.append(RenderPass(
                    PASS_CHANNEL_LUT, TARGET_SURFACE,
                    (dst.x, dst.y, region.w, region.h),
                    src_region=(region.x, region.y, region.w, region.h),
                    lut=channel_lut))
                ctx_region = AtlasRegion(dst.x, dst.y, region.w, region.h)
            base_region = ctx_region
            if blur_sx > 0 or blur_sy > 0:
                ctx_region, ctx_scale = self._push_blur(
                    ctx_region, blur_sx, blur_sy, blur_w=sw, blur_h=sh_)
            base_scale = 1
            if fs["shadow_after_blur"]:
                # the chain lists drop-shadow AFTER blur: the shadow's
                # input is the blurred output (filter-long-chain.yaml)
                base_region, base_scale = ctx_region, ctx_scale
            lrect = [lr0[0], lr0[1], lr0[2], lr0[3]]
            blur_cache_ctx: Dict = {}
            ctx_regions = [region, base_region]
            for (sh, (sdx, sdy, odx, ody)) in zip(drop_shadows,
                                                  shadow_params):
                if sdx > 0 or sdy > 0:
                    sh_region, sh_scale = self._push_blur(
                        base_region, sdx / base_scale, sdy / base_scale,
                        blur_w=sw // base_scale, blur_h=sh_ // base_scale,
                        cache=blur_cache_ctx)
                    sh_scale *= base_scale
                    ctx_regions.append(sh_region)
                else:
                    sh_region, sh_scale = base_region, base_scale
                m = np.zeros((4, 5), np.float32)
                m[0, 4], m[1, 4], m[2, 4] = (sh.color.r, sh.color.g,
                                             sh.color.b)
                m[3, 3] = sh.color.a
                lrect_sh = [lrect[0] + sh.offset.x, lrect[1] + sh.offset.y,
                            lrect[2] + sh.offset.x, lrect[3] + sh.offset.y]
                self._emit_ctx_composite(
                    sh_region, sw, sh_, x0 + odx, y0 + ody, ctx_s, sh_scale,
                    lrect_sh, pic, 1.0, m, clip_addr, clip_count, clip_bbox,
                    out, edge_aa=0 if plane else 0xF)
            self._emit_ctx_composite(
                ctx_region, sw, sh_, x0, y0, ctx_s, ctx_scale, lrect, pic,
                opacity, color_matrix, clip_addr, clip_count, clip_bbox,
                out, edge_aa=0 if plane else 0xF)
            # release every ctx-chain region exactly once for aliasing
            ctx_regions.append(ctx_region)
            seen = set()
            for r in ctx_regions:
                key = (r.x, r.y, r.w, r.h)
                if key not in seen:
                    seen.add(key)
                    self._region_scopes[-1].append(r)
            return

        content_region = region
        content_scale = step
        if svgfe_ops:
            content_region = self._run_svgfe_graph(
                svgfe_ops, region, (x0, y0), (cw, ch),
                pic.common.spatial_node, bbox)
        if fs["pre_stages"]:
            content_region = self._run_filter_stages(
                fs["pre_stages"], content_region, region.w, region.h)
        elif channel_lut is not None:
            dst = self.surface_atlas.alloc(region.w, region.h)
            self.passes.append(RenderPass(
                PASS_CHANNEL_LUT, TARGET_SURFACE,
                (dst.x, dst.y, region.w, region.h),
                src_region=(region.x, region.y, region.w, region.h),
                lut=channel_lut))
            content_region = AtlasRegion(dst.x, dst.y, region.w, region.h)
        shadow_base = content_region
        shadow_base_scale = 1
        if blur_sx > 0 or blur_sy > 0:
            if not fs["shadow_after_blur"]:
                shadow_base = content_region
            content_region, content_scale = self._push_blur(
                content_region, blur_sx, blur_sy,
                blur_w=cw if blur_task else None,
                blur_h=ch if blur_task else None)

        # drop shadows: blurred+tinted copies behind the content; identical
        # σ chains share tasks (render_task.rs BlurTaskCache at
        # picture.rs:5966)
        blur_cache: Dict = {}
        if fs["shadow_after_blur"]:
            shadow_base, shadow_base_scale = content_region, content_scale
        elif fs["pre_stages"]:
            shadow_base, shadow_base_scale = shadow_base, 1
        else:
            shadow_base, shadow_base_scale = region, 1
        for (sh, (sdx, sdy, odx, ody)) in zip(drop_shadows, shadow_params):
            if sdx > 0 or sdy > 0:
                shadow_region, shadow_scale = self._push_blur(
                    shadow_base, sdx / shadow_base_scale,
                    sdy / shadow_base_scale,
                    blur_w=cw // shadow_base_scale,
                    blur_h=ch // shadow_base_scale, cache=blur_cache)
                shadow_scale *= shadow_base_scale
            else:
                shadow_region, shadow_scale = shadow_base, shadow_base_scale
            m = np.zeros((4, 5), np.float32)
            m[0, 4], m[1, 4], m[2, 4] = sh.color.r, sh.color.g, sh.color.b
            m[3, 3] = sh.color.a
            self._emit_composite(shadow_region,
                                 (x0 + odx, y0 + ody),
                                 (cw, ch), pic, 1.0, m,
                                 clip_addr, clip_count, clip_bbox, out,
                                 scale=shadow_scale)

        # NOTE: shadow pictures are NOT tinted here — the scene builder
        # already substituted the shadow color into the copied prims
        # (_shadow_copy), tinting again would square the alpha
        cm = color_matrix
        self._emit_composite(content_region, (x0, y0), (cw, ch),
                             pic, opacity, cm, clip_addr, clip_count,
                             clip_bbox, out, scale=content_scale)

    # ------------------------------------------------------------------
    # SVGFE filter graph (display_item.rs FilterOp::SVGFE*, render_task.rs
    # SVGFENode, cs_svg_filter_node.glsl) — each node is one raster / blur /
    # LUT pass over a (cw,ch) surface-atlas buffer; buffers are recycled as
    # soon as the last reader has been emitted (passes execute in order).
    # linearRGB nodes convert inside the kernel (color-matrix flag=2 /
    # blend op +BLEND_LINEAR_BASE), matching the reference's _CONVERTSRGB
    # shader variants: intermediates stay sRGB-encoded RGBA8.
    # ------------------------------------------------------------------
    def _run_svgfe_graph(self, ops, src: AtlasRegion, origin, size,
                         spatial: int, content_bounds=None) -> AtlasRegion:
        x0, y0 = origin
        cw, ch = size
        H = self._H(spatial)
        pal = self.palette[spatial]
        dev_sx, dev_sy = float(pal[9]), float(pal[10])
        n = len(ops)

        blend_names = {
            "blendnormal": 0, "blendmultiply": 1, "blendscreen": 2,
            "blendoverlay": 3, "blenddarken": 4, "blendlighten": 5,
            "blendcolordodge": 6, "blendcolorburn": 7, "blendhardlight": 8,
            "blendsoftlight": 9, "blenddifference": 10, "blendexclusion": 11,
            "blendhue": 12, "blendsaturation": 13, "blendcolor": 14,
            "blendluminosity": 15,
        }
        composite_names = {
            "compositeover": BLEND_NORMAL, "compositein": BLEND_PD_IN,
            "compositeout": BLEND_PD_OUT, "compositeatop": BLEND_PD_ATOP,
            "compositexor": BLEND_PD_XOR,
            "compositelighter": BLEND_PD_LIGHTER,
            # arithmetic(k1..k4) is approximated by `over` (not exercised by
            # the reference reftest corpus)
            "compositearithmetic": BLEND_NORMAL,
        }
        two_input = set(blend_names) | set(composite_names)

        # --- buffer lifetimes: last node index that reads each output ------
        def resolved_refs(j, node):
            op = node["op"]
            if op in ("sourcegraphic", "sourcealpha", "flood"):
                return []
            refs = []
            r1 = node.get("in1")
            refs.append(int(r1) if r1 is not None else j - 1)
            if op in two_input and node.get("in2") is not None:
                refs.append(int(node["in2"]))
            return [r for r in refs if 0 <= r < j]

        last_use: Dict[int, int] = {}
        for j, f in enumerate(ops):
            for r in resolved_refs(j, f.svgfe):
                last_use[r] = j

        pool: List[AtlasRegion] = []
        buffers: List[Optional[AtlasRegion]] = []
        # per-node output color space (legacy FilterPrimitive graphs keep
        # node outputs in their own space and convert only on mismatched
        # inputs + a final LinearToSrgb — render_task.rs get_task_input:1310)
        spaces: List[bool] = []
        conv_cache: Dict[Tuple[int, bool], AtlasRegion] = {}
        released = set()

        def sweep(j):
            for i in range(len(buffers)):
                if i in released or i == n - 1 or last_use.get(i, i) > j:
                    continue
                released.add(i)
                reg = buffers[i]
                if reg is None or (reg.x, reg.y) == (src.x, src.y):
                    continue
                shared = any(
                    k not in released and k != i and buffers[k] is not None
                    and (buffers[k].x, buffers[k].y) == (reg.x, reg.y)
                    for k in range(len(buffers)))
                if not shared:
                    pool.append(reg)

        def new_buffer() -> AtlasRegion:
            if pool:
                return pool.pop()
            r = self.surface_atlas.alloc(cw, ch)
            return AtlasRegion(r.x, r.y, cw, ch)

        def sub_dev(f):
            sr = f.svgfe["subregion"]
            if sr is None:
                # legacy FilterPrimitive (no subregion): flood fills the
                # tight filter region; other nodes are unclipped
                # (svg-filter-composite.yaml expected geometry)
                if f.svgfe["op"] == "flood" and content_bounds is not None:
                    return Rect.from_bounds(*content_bounds)
                return Rect(-1e9, -1e9, 2e9, 2e9)
            db = device_bounds_of_rect(H, sr.x0, sr.y0, sr.x1, sr.y1)
            return Rect.from_bounds(*db)

        # --- pass emitters -------------------------------------------------
        def sample_pass(dst: AtlasRegion, clip_dev: Rect, entries,
                        clear=(0, 0, 0, 0)):
            """One raster pass into `dst`; each entry is a dict:
            src (region), mod (rgba multiplier), cm (4x5), cm_flag,
            blend, shift (device px), scale (src downscale factor)."""
            insts = []
            for e in entries:
                sr_reg = e["src"]
                shift = e.get("shift", (0.0, 0.0))
                scale = e.get("scale", 1)
                rect = [x0 + shift[0], y0 + shift[1],
                        x0 + cw + shift[0], y0 + ch + shift[1]]
                cov = [max(rect[0], clip_dev.x0), max(rect[1], clip_dev.y0),
                       min(rect[2], clip_dev.x1), min(rect[3], clip_dev.y1)]
                if cov[2] <= cov[0] or cov[3] <= cov[1]:
                    continue
                payload = rect + cov
                payload += [sr_reg.x, sr_reg.y,
                            sr_reg.x + cw / scale, sr_reg.y + ch / scale]
                payload += list(e.get("mod", (1.0, 1.0, 1.0, 1.0)))
                cm = e.get("cm")
                if cm is None:
                    payload += list(identity_color_matrix().reshape(-1)) \
                        + [0.0]
                else:
                    payload += list(np.asarray(cm, np.float32).reshape(-1)) \
                        + [float(e.get("cm_flag", 1.0))]
                addr = self.gb.push_f32(payload)
                idx = self.gb.push_instance(
                    KIND_PICTURE, self.device_spatial, addr, 0, 0,
                    e.get("blend", BLEND_NORMAL), edge_aa=0)
                self.metas.push(tuple(cov))
                insts.append(idx)
            ins_ids = np.asarray(insts, np.int64)
            tile_insts, tile_counts, nx, ny = bin_instances(
                ins_ids, self.metas.bbox[ins_ids], (x0, y0), (cw, ch))
            self.passes.append(RenderPass(
                PASS_RASTER, TARGET_SURFACE, (dst.x, dst.y, cw, ch),
                (float(x0), float(y0)), clear=clear, tile_insts=tile_insts,
                tile_counts=tile_counts, nx=nx, ny=ny))

        def solid_pass(dst: AtlasRegion, color, clip_dev: Rect):
            cov = [max(x0, clip_dev.x0), max(y0, clip_dev.y0),
                   min(x0 + cw, clip_dev.x1), min(y0 + ch, clip_dev.y1)]
            insts = []
            if cov[2] > cov[0] and cov[3] > cov[1]:
                payload = [x0, y0, x0 + cw, y0 + ch] + cov + \
                    list(color.premultiplied())
                addr = self.gb.push_f32(payload)
                idx = self.gb.push_instance(KIND_SOLID, self.device_spatial,
                                            addr, 0, 0, BLEND_NORMAL, 0)
                self.metas.push(tuple(cov))
                insts.append(idx)
            ins_ids = np.asarray(insts, np.int64)
            tile_insts, tile_counts, nx, ny = bin_instances(
                ins_ids, self.metas.bbox[ins_ids], (x0, y0), (cw, ch))
            self.passes.append(RenderPass(
                PASS_RASTER, TARGET_SURFACE, (dst.x, dst.y, cw, ch),
                (float(x0), float(y0)), clear=(0, 0, 0, 0),
                tile_insts=tile_insts, tile_counts=tile_counts, nx=nx, ny=ny))

        def lut_pass(src_reg: AtlasRegion, lut) -> AtlasRegion:
            dst = new_buffer()
            self.passes.append(RenderPass(
                PASS_CHANNEL_LUT, TARGET_SURFACE, (dst.x, dst.y, cw, ch),
                src_region=(src_reg.x, src_reg.y, cw, ch), lut=lut))
            return dst

        def srgb_pass(src_reg: AtlasRegion, to_linear: bool) -> AtlasRegion:
            dst = new_buffer()
            self.passes.append(RenderPass(
                PASS_SRGB, TARGET_SURFACE, (dst.x, dst.y, cw, ch),
                src_region=(src_reg.x, src_reg.y, cw, ch),
                srgb_to_linear=to_linear))
            return dst

        ALPHA_ONLY = np.zeros((4, 5), np.float32)
        ALPHA_ONLY[3, 3] = 1.0

        # --- evaluate ------------------------------------------------------
        for j, f in enumerate(ops):
            node = f.svgfe
            op = node["op"]
            linear = bool(node["linear"])
            legacy = bool(node.get("legacy"))
            # legacy graphs convert via explicit passes; svgfe graphs convert
            # inside the kernel (_CONVERTSRGB variants)
            lin_blend = BLEND_LINEAR_BASE if (linear and not legacy) else 0
            clip_dev = sub_dev(f)

            def resolve(which, default_prev=True):
                ref = node.get(which)
                if ref is None:
                    idx = len(buffers) - 1 \
                        if (default_prev and buffers) else -1
                else:
                    idx = int(ref) if 0 <= int(ref) < len(buffers) else -1
                if idx >= 0 and buffers[idx] is None:
                    idx = -1
                return idx

            def inp(which="in1", default_prev=True):
                idx = resolve(which, default_prev)
                reg = src if idx < 0 else buffers[idx]
                if legacy:
                    in_space = False if idx < 0 else spaces[idx]
                    if in_space != linear:
                        key = (idx, linear)
                        if key not in conv_cache:
                            conv_cache[key] = srgb_pass(reg,
                                                        to_linear=linear)
                        reg = conv_cache[key]
                return reg

            out: Optional[AtlasRegion] = None
            if op == "sourcegraphic":
                out = src
            elif op in ("sourcealpha", "toalpha"):
                base = src if op == "sourcealpha" else inp()
                out = new_buffer()
                sample_pass(out, clip_dev, [{"src": base, "cm": ALPHA_ONLY}])
            elif op == "identity":
                out = new_buffer()
                sample_pass(out, clip_dev, [{"src": inp()}])
            elif op == "flood":
                out = new_buffer()
                solid_pass(out, node["color"] or ColorF.BLACK, clip_dev)
            elif op == "opacity":
                # uniform premultiplied scale: straight rgb is unchanged, so
                # the linearRGB variant is identical
                v = node["value"] if node["value"] is not None else 1.0
                out = new_buffer()
                sample_pass(out, clip_dev, [{"src": inp(),
                                             "mod": (v, v, v, v)}])
            elif op == "colormatrix":
                m = np.asarray(node["matrix"], np.float32).reshape(5, 4).T
                out = new_buffer()
                sample_pass(out, clip_dev, [{
                    "src": inp(), "cm": m,
                    "cm_flag": 2.0 if (linear and not legacy) else 1.0}])
            elif op == "compositearithmetic" and node.get("k_values"):
                a_reg = inp("in1")
                b_reg = inp("in2", default_prev=False)
                out = new_buffer()
                k = tuple(node["k_values"]) + (0.0,) * 4
                self.passes.append(RenderPass(
                    PASS_ARITH, TARGET_SURFACE, (out.x, out.y, cw, ch),
                    src_region=(a_reg.x, a_reg.y, cw, ch),
                    src_region2=(b_reg.x, b_reg.y, cw, ch),
                    kvals=k[:4], arith_linear=linear and not legacy))
            elif op in two_input:
                base = blend_names.get(op)
                if base is not None:
                    # float-domain mix (cs_svg_filter semantics)
                    blend_op = (BLEND_SVGFE_MIX_BASE + base) if base else \
                        BLEND_NORMAL
                else:
                    blend_op = composite_names[op]
                out = new_buffer()
                sample_pass(out, clip_dev, [
                    {"src": inp("in2", default_prev=False)},
                    {"src": inp("in1"), "blend": blend_op + lin_blend},
                ])
            elif op == "offset":
                out = new_buffer()
                sample_pass(out, clip_dev, [{
                    "src": inp(),
                    "shift": self._dev_vec(spatial,
                                           node["dx"], node["dy"])}])
            elif op == "gaussianblur":
                base = inp()
                tmp = None
                if linear and not legacy:
                    base = tmp = srgb_pass(base, to_linear=True)
                ssx = (node["std_x"] or 0.0) * dev_sx
                ssy = (node["std_y"] or 0.0) * dev_sy
                base = self._svgfe_blur_input(base, cw, ch, ssx, ssy)
                blurred, scale = self._push_blur(base, ssx, ssy)
                if tmp is not None:
                    pool.append(tmp)
                pre = new_buffer()
                sample_pass(pre, clip_dev, [{"src": blurred,
                                             "scale": scale}])
                if linear and not legacy:
                    out = srgb_pass(pre, to_linear=False)
                    pool.append(pre)
                else:
                    out = pre
            elif op == "dropshadow":
                base = inp()
                ssx = (node["std_x"] or 0.0) * dev_sx
                ssy = (node["std_y"] or 0.0) * dev_sy
                if max(ssx, ssy) > 0.01:
                    bsrc = self._svgfe_blur_input(base, cw, ch, ssx, ssy)
                    blurred, scale = self._push_blur(bsrc, ssx, ssy)
                else:
                    blurred, scale = base, 1
                c = node["color"] or ColorF.BLACK
                tint = np.zeros((4, 5), np.float32)
                tint[0, 4], tint[1, 4], tint[2, 4] = c.r, c.g, c.b
                tint[3, 3] = c.a
                out = new_buffer()
                sample_pass(out, clip_dev, [
                    {"src": blurred, "cm": tint, "scale": scale,
                     "shift": self._dev_vec(spatial,
                                            node["dx"], node["dy"])},
                    {"src": base, "blend": BLEND_NORMAL + lin_blend},
                ])
            elif op == "componenttransfer":
                fd = node.get("filter_data")
                lut = _component_transfer_lut(fd) if fd is not None else None
                out = lut_pass(inp(), lut) if lut is not None else inp()
            else:
                # unsupported node (lighting/turbulence/morphology/...):
                # pass the input through so the scene still renders
                out = inp()
            buffers.append(out)
            spaces.append(linear if legacy else False)
            sweep(j)
        final = buffers[-1] if buffers and buffers[-1] is not None else src
        if spaces and spaces[-1]:
            final = srgb_pass(final, to_linear=False)
        return final

    @staticmethod
    def adjusted_blur_source_size(w: int, h: int, sx: float, sy: float
                                  ) -> Tuple[int, int]:
        """`render_task.rs:264` BlurTask::adjusted_blur_source_size —
        inflate the blur source so each downscale pass samples a multiple
        of two."""
        adj_w, adj_h = float(w), float(h)
        scale = 1.0
        stdw, stdh = sx, sy
        while stdw > MAX_BLUR_SIGMA and stdh > MAX_BLUR_SIGMA:
            if adj_w < MIN_DOWNSCALING_RT_SIZE or \
                    adj_h < MIN_DOWNSCALING_RT_SIZE:
                break
            stdw *= 0.5
            stdh *= 0.5
            scale *= 2.0
            adj_w = math.ceil(w / scale)
            adj_h = math.ceil(h / scale)
        return int(round(adj_w * scale)), int(round(adj_h * scale))

    def _svgfe_blur_input(self, src: AtlasRegion, cw: int, ch: int,
                          sx: float, sy: float) -> AtlasRegion:
        """SVGFE blur inputs are copied into a transparent-padded task of
        adjusted_blur_source_size so the downscale chain samples even
        multiples (render_task.rs:2280-2330)."""
        tw, th = self.adjusted_blur_source_size(cw, ch, sx, sy)
        if (tw, th) == (src.w, src.h):
            return src
        padded = self.surface_atlas.alloc(tw, th)
        self.passes.append(RenderPass(
            PASS_COPY, TARGET_SURFACE, (padded.x, padded.y, tw, th),
            src_region=(src.x, src.y, min(cw, tw), min(ch, th))))
        return AtlasRegion(padded.x, padded.y, tw, th)

    def _push_blur(self, src: AtlasRegion, sx: float, sy: float,
                   blur_w: Optional[int] = None,
                   blur_h: Optional[int] = None,
                   cache: Optional[Dict] = None
                   ) -> Tuple[AtlasRegion, int]:
        """`render_task.rs:1168` RenderTask::new_blur — downscale chain
        while BOTH std devs exceed 4.0 (cs_scale bilinear passes with
        truncated target sizes), then a VERTICAL blur followed by a
        HORIZONTAL blur, each sampling clamped into the blur region
        (cs_blur.glsl vUvRect).  `blur_w/h` is the content (clipped) size
        within the task; `cache` de-dupes chains shared between drop
        shadows (BlurTaskCache).  Returns (region, scale): the result is
        1/scale the source size."""
        task_w, task_h = src.w, src.h
        if blur_w is None:
            blur_w, blur_h = task_w, task_h
        scale = 1
        cur = src
        cw, ch = task_w, task_h
        asx, asy = sx, sy
        n_down = 0
        while asx > MAX_BLUR_SIGMA and asy > MAX_BLUR_SIGMA:
            if cw < MIN_DOWNSCALING_RT_SIZE or ch < MIN_DOWNSCALING_RT_SIZE:
                break
            asx *= 0.5
            asy *= 0.5
            scale *= 2
            n_down += 1
            nw = max(1, int(task_w / scale))   # to_i32 truncation
            nh = max(1, int(task_h / scale))
            if cache is not None and ("down", n_down) in cache:
                cur = cache[("down", n_down)]
                cw, ch = cur.w, cur.h
                continue
            half = self.surface_atlas.alloc(nw, nh)
            self.passes.append(RenderPass(
                PASS_DOWNSCALE, TARGET_SURFACE, (half.x, half.y, nw, nh),
                src_region=(cur.x, cur.y, cw, ch)))
            if cur is not src and cache is None:
                self.surface_atlas.free(cur)  # chain intermediate, read once
            cur = AtlasRegion(half.x, half.y, nw, nh)
            cw, ch = nw, nh
            if cache is not None:
                cache[("down", n_down)] = cur
        bw = max(1, blur_w // scale)
        bh = max(1, blur_h // scale)
        blur_key = ("blur", n_down, round(asx * 1024), round(asy * 1024))
        if cache is not None and blur_key in cache:
            return cache[blur_key], scale
        tmp = self.surface_atlas.alloc(cw, ch)
        dst = self.surface_atlas.alloc(cw, ch)
        self.passes.append(RenderPass(
            PASS_BLUR_V, TARGET_SURFACE,
            (tmp.x, tmp.y, cw, ch),
            src_region=(cur.x, cur.y, cw, ch), sigma=asy,
            blur_region=(bw, bh)))
        self.passes.append(RenderPass(
            PASS_BLUR_H, TARGET_SURFACE,
            (dst.x, dst.y, cw, ch),
            src_region=(tmp.x, tmp.y, cw, ch), sigma=asx,
            blur_region=(bw, bh)))
        if cur is not src and cache is None:
            self.surface_atlas.free(cur)  # last downscale level, read once
        self.surface_atlas.free(tmp)
        out = AtlasRegion(dst.x, dst.y, cw, ch)
        if cache is not None:
            cache[blur_key] = out
        return out, scale

    def _run_filter_stages(self, stages, region: AtlasRegion,
                           w: int, h: int) -> AtlasRegion:
        """Run an ordered CSS filter chain as one surface pass per stage
        (scene_building.rs PictureChain: each Filter gets its own surface,
        so intermediates CLAMP and quantize to u8 between stages)."""
        cur = region
        for kind_, val in stages:
            dst = self.surface_atlas.alloc(cur.w, cur.h)
            if kind_ == "lut":
                self.passes.append(RenderPass(
                    PASS_CHANNEL_LUT, TARGET_SURFACE,
                    (dst.x, dst.y, cur.w, cur.h),
                    src_region=(cur.x, cur.y, cur.w, cur.h), lut=val))
            else:
                self.passes.append(RenderPass(
                    PASS_COLOR_MATRIX, TARGET_SURFACE,
                    (dst.x, dst.y, cur.w, cur.h),
                    src_region=(cur.x, cur.y, cur.w, cur.h),
                    color_matrix=np.asarray(val, np.float32).reshape(-1)))
            if cur is not region:
                self.surface_atlas.free(cur)
            cur = AtlasRegion(dst.x, dst.y, cur.w, cur.h)
        return cur

    def _emit_ctx_composite(self, region: AtlasRegion, sw: int, sh_: int,
                            ox: float, oy: float, ctx_s: float, scale: int,
                            lrect, pic: PicturePrim, opacity: float,
                            color_matrix: Optional[np.ndarray],
                            clip_addr: int, clip_count: int, clip_bbox,
                            out: List[int], edge_aa: int = 0xF) -> None:
        """Composite a raster-root (local-space) surface through the
        projective transform: pattern_picture raster-root mode (p[37..40]).
        `scale` is the blur downscale factor of `region` (the region holds
        the ctx content at 1/scale resolution); `ox, oy` the ctx-space
        coords of the region's (0,0) texel at full ctx resolution."""
        payload = list(lrect) + list(lrect)
        payload += [region.x, region.y,
                    region.x + sw / scale, region.y + sh_ / scale]
        payload += [opacity, opacity, opacity, opacity]
        if color_matrix is None:
            payload += list(identity_color_matrix().reshape(-1)) + [0.0]
        else:
            payload += list(np.asarray(color_matrix, np.float32)
                            .reshape(-1)) + [1.0]
        payload += [1.0, float(ox) / scale, float(oy) / scale,
                    float(ctx_s) / scale]
        addr = self.gb.push_f32(payload)
        blend = BLEND_NORMAL
        if pic.composite.mix_blend_mode != MixBlendMode.NORMAL:
            blend = BLEND_MIX_BASE + pic.composite.mix_blend_mode.value
        idx = self.gb.push_instance(
            KIND_PICTURE, pic.common.spatial_node, addr, clip_addr,
            clip_count, blend, edge_aa=edge_aa)
        db = device_bounds_of_rect(self.H_dev[pic.common.spatial_node],
                                   lrect[0], lrect[1], lrect[2], lrect[3])
        dbb = (max(db[0], self.viewport.x0), max(db[1], self.viewport.y0),
               min(db[2], self.viewport.x1), min(db[3], self.viewport.y1))
        if clip_bbox is not None:
            dbb = (max(dbb[0], clip_bbox[0]), max(dbb[1], clip_bbox[1]),
                   min(dbb[2], clip_bbox[2]), min(dbb[3], clip_bbox[3]))
        self.metas.push(dbb)
        out.append(idx)

    def _emit_composite(self, region: AtlasRegion, origin: Tuple[float, float],
                        size: Tuple[int, int], pic: PicturePrim,
                        opacity: float, color_matrix: Optional[np.ndarray],
                        clip_addr: int, clip_count: int,
                        clip_bbox, out: List[int], scale: int = 1) -> None:
        x0, y0 = origin
        w, h = size
        rect = [x0, y0, x0 + w, y0 + h]
        payload = list(rect) + list(rect)
        payload += [region.x, region.y,
                    region.x + w / scale, region.y + h / scale]
        payload += [opacity, opacity, opacity, opacity]  # premult color mod
        if color_matrix is None:
            payload += list(identity_color_matrix().reshape(-1)) + [0.0]
        else:
            payload += list(np.asarray(color_matrix, np.float32).reshape(-1)) + [1.0]
        addr = self.gb.push_f32(payload)
        blend = BLEND_NORMAL
        if pic.composite.mix_blend_mode != MixBlendMode.NORMAL:
            blend = BLEND_MIX_BASE + pic.composite.mix_blend_mode.value
        idx = self.gb.push_instance(KIND_PICTURE, self.device_spatial, addr,
                                    clip_addr, clip_count, blend, edge_aa=0)
        self._region_scopes[-1].append(region)
        bbox = (x0, y0, x0 + w, y0 + h)
        if clip_bbox is not None:
            bbox = (max(bbox[0], clip_bbox[0]), max(bbox[1], clip_bbox[1]),
                    min(bbox[2], clip_bbox[2]), min(bbox[3], clip_bbox[3]))
        self.metas.push(bbox)
        out.append(idx)

    # ------------------------------------------------------------------
    # snapping (spatial_node.rs snapping_transform / util.rs snap:
    # axis-aligned rects snap to whole device pixels)
    # ------------------------------------------------------------------
    def _snap_rect(self, rect: Rect, spatial: int) -> Rect:
        if self._rctx is not None or \
                not self.resolved[spatial].is_2d_axis_aligned:
            return rect
        H = self._H(spatial)
        sx, sy = H[0, 0], H[1, 1]
        tx, ty = H[2, 0], H[2, 1]
        if abs(sx) < 1e-9 or abs(sy) < 1e-9:
            return rect
        if not all(math.isfinite(v) for v in (rect.x0, rect.y0, rect.x1,
                                              rect.y1, sx, sy, tx, ty)):
            return rect
        # util.rs snap: floor(v + 0.5) — half-up, matching GL's fill
        # convention at exact-half edges (a rect ending at 26.5 covers
        # pixel-center 26; banker's rounding would drop it — snap.yaml)
        dx0 = math.floor(rect.x0 * sx + tx + 0.5)
        dy0 = math.floor(rect.y0 * sy + ty + 0.5)
        dx1 = math.floor(rect.x1 * sx + tx + 0.5)
        dy1 = math.floor(rect.y1 * sy + ty + 0.5)
        return Rect.from_bounds((dx0 - tx) / sx, (dy0 - ty) / sy,
                                (dx1 - tx) / sx, (dy1 - ty) / sy)

    # ------------------------------------------------------------------
    # clips
    # ------------------------------------------------------------------
    def _serialize_clips(self, chain: Tuple[int, ...], prim_spatial: int,
                         extra_records: Optional[List[List[float]]] = None
                         ) -> Tuple[int, int, Optional[Tuple]]:
        """Write clip records; returns (addr, count, device clip AABB).
        `extra_records` appends pre-built records (box-shadow nine-patch
        masks) after the chain's — those combinations are per-prim, so
        they bypass the chain cache.

        Note: scroll frames do NOT implicitly clip their content — the
        embedder defines explicit clips (wrench's `clip-to-frame` creates a
        rect clip; Gecko emits its own clip nodes)."""
        poly = self._poly_clip
        key = (chain, prim_spatial, poly, self._rctx)
        cached = None if extra_records else self._clip_cache.get(key)
        if cached is not None:
            return cached
        nodes = [self.scene.clip_store.nodes[i] for i in chain]
        records: List[List[float]] = []
        bbox = None
        count = 0
        for node in nodes:
            rec = [0.0] * CLIP_STRIDE
            # palette row inlined for the dense pallas path ([96:108])
            rec[96:108] = [float(v) for v in self._pal(node.spatial_node)]
            nrect = node.rect
            if node.kind in (ClipKind.RECT, ClipKind.ROUNDED_RECT):
                nrect = self._snap_rect(nrect, node.spatial_node)
            rec[0:4] = [nrect.x0, nrect.y0, nrect.x1, nrect.y1]
            r = node.radii
            radii = [r.top_left.width, r.top_left.height,
                     r.top_right.width, r.top_right.height,
                     r.bottom_right.width, r.bottom_right.height,
                     r.bottom_left.width, r.bottom_left.height]
            # adjacent corner ellipses must not overlap (border.rs
            # ensure_no_corner_overlap applied to clip radii —
            # clip/clip-ellipse.yaml's oversized radii)
            ratio = 1.0
            if nrect.w > 0:
                for s_ in (radii[0] + radii[2], radii[6] + radii[4]):
                    if s_ > nrect.w:
                        ratio = min(ratio, nrect.w / s_)
            if nrect.h > 0:
                for s_ in (radii[1] + radii[7], radii[3] + radii[5]):
                    if s_ > nrect.h:
                        ratio = min(ratio, nrect.h / s_)
            if ratio < 1.0:
                radii = [v * ratio for v in radii]
            rec[4:12] = radii
            if node.kind == ClipKind.ROUNDED_RECT and \
                    all(v == radii[0] for v in radii[1:]):
                # BorderRadius::is_uniform (exact equality, post overlap
                # clamp like clip.rs:1655) → cs_clip_rectangle
                # WR_FEATURE_FAST_PATH (render_target.rs:1215)
                rec[15] = 1.0
            rec[12] = 1.0 if node.mode == ClipMode.CLIP_OUT else 0.0
            rec[13] = float(self._row(node.spatial_node))
            if node.kind == ClipKind.RECT:
                rec[14] = 0.0
            elif node.kind == ClipKind.ROUNDED_RECT:
                rec[14] = 1.0
            elif node.kind == ClipKind.IMAGE_MASK:
                req = self.resources.request_image(node.image_key)
                if req is not None:
                    rec[14] = 2.0
                    reg, desc = req
                    rec[16:20] = [reg.x, reg.y, reg.x + desc.width,
                                  reg.y + desc.height]
                else:
                    # invalid image key: mask degrades to its placement rect
                    # (mask/missing-mask.yaml behavior)
                    rec[14] = 0.0
            elif node.kind == ClipKind.BOX_SHADOW:
                rec[14] = 1.0
            records.append(rec)
            count += 1
            if node.mode == ClipMode.CLIP and node.kind != ClipKind.IMAGE_MASK:
                db = device_bounds_of_rect(self._H(node.spatial_node),
                                           nrect.x0, nrect.y0,
                                           nrect.x1, nrect.y1)
                bbox = db if bbox is None else (
                    max(bbox[0], db[0]), max(bbox[1], db[1]),
                    min(bbox[2], db[2]), min(bbox[3], db[3]))
            elif node.kind == ClipKind.IMAGE_MASK:
                db = device_bounds_of_rect(self._H(node.spatial_node),
                                           node.rect.x0, node.rect.y0,
                                           node.rect.x1, node.rect.y1)
                bbox = db if bbox is None else (
                    max(bbox[0], db[0]), max(bbox[1], db[1]),
                    min(bbox[2], db[2]), min(bbox[3], db[3]))
        if poly is not None:
            rec = self._polygon_clip_record(poly)
            if rec is not None:
                records.append(rec)
                count += 1
                xs = [p[0] for p in poly]
                ys = [p[1] for p in poly]
                db = (min(xs), min(ys), max(xs), max(ys))
                bbox = db if bbox is None else (
                    max(bbox[0], db[0]), max(bbox[1], db[1]),
                    min(bbox[2], db[2]), min(bbox[3], db[3]))
        if extra_records:
            for rec in extra_records:
                records.append(rec)
                count += 1
        flat: List[float] = []
        for rec in records:
            flat.extend(rec)
        addr = self.gb.push_f32(flat) if flat else 0
        self._clip_rows += count
        # slice assigner metadata: which spatial nodes / kinds / device
        # rects this serialized chain references (picture-cache slices need
        # to classify clips as scrolling-with-content vs fixed)
        meta = []
        for node in nodes:
            db = None
            if node.kind == ClipKind.RECT and node.mode == ClipMode.CLIP \
                    and self.resolved[node.spatial_node].is_2d_axis_aligned:
                db = device_bounds_of_rect(
                    self._H(node.spatial_node), node.rect.x0, node.rect.y0,
                    node.rect.x1, node.rect.y1)
            meta.append((node.spatial_node, node.kind, node.mode, db))
        self._clip_meta[addr] = (tuple(meta), poly is not None)
        result = (addr, count, bbox)
        if not extra_records:
            self._clip_cache[key] = result
        return result

    def _polygon_clip_record(self, poly) -> Optional[List[float]]:
        """Kind-3 clip record: device-space convex polygon as up to 8
        inward unit half-planes at [24 + 3i] (preserve-3d BSP fragments;
        the ps_split_composite geometry)."""
        n = len(poly)
        if n < 3 or n > 8:
            return None
        cx = sum(p[0] for p in poly) / n
        cy = sum(p[1] for p in poly) / n
        rec = [0.0] * CLIP_STRIDE
        rec[96:108] = [float(v) for v in self.palette[0]]
        rec[13] = 0.0
        rec[14] = 3.0
        for i in range(8):
            if i < n:
                x0, y0 = poly[i]
                x1, y1 = poly[(i + 1) % n]
                a, b = y0 - y1, x1 - x0   # left normal of the edge
                ln = math.hypot(a, b)
                if ln < 1e-9:
                    a, b, c = 0.0, 0.0, 1e9
                else:
                    a, b = a / ln, b / ln
                    c = -(a * x0 + b * y0)
                    if a * cx + b * cy + c < 0:
                        a, b, c = -a, -b, -c
            else:
                a, b, c = 0.0, 0.0, 1e9
            rec[24 + 3 * i] = a
            rec[25 + 3 * i] = b
            rec[26 + 3 * i] = c
        return rec

    # ------------------------------------------------------------------
    # prepare (per-prim payloads) — prepare.rs prepare_primitives analog
    # ------------------------------------------------------------------
    def _prepare_prim(self, prim, out: List[int]) -> None:
        c: PrimCommon = prim.common
        pal = self._pal(c.spatial_node)
        flags = pal[11]
        if int(flags) & 1:
            return  # non-invertible transform
        if not c.is_backface_visible and self._prim_backfacing(c):
            return  # backface culled (preserve-3d context)
        if self._sc_backface_culled(c.backface_cull_spatial):
            return  # enclosing SC declared backface-visible: false
        axis_aligned = self.resolved[c.spatial_node].is_2d_axis_aligned \
            and self._rctx is None

        if isinstance(prim, RectanglePrim):
            self._emit_rect_like(prim, c, axis_aligned, out,
                                 KIND_SOLID, list(_premult(prim.color)),
                                 BLEND_NORMAL)
            return
        if isinstance(prim, ClearPrim):
            self._emit_rect_like(prim, c, axis_aligned, out,
                                 KIND_CLEAR, [0.0, 0.0, 0.0, 0.0], BLEND_CLEAR)
            return
        if isinstance(prim, (LinearGradientPrim, RadialGradientPrim,
                             ConicGradientPrim)):
            self._prepare_gradient(prim, c, axis_aligned, out)
            return
        if isinstance(prim, ImagePrim):
            self._prepare_image(prim, c, axis_aligned, out)
            return
        if isinstance(prim, YuvImagePrim):
            self._prepare_yuv(prim, c, axis_aligned, out)
            return
        if isinstance(prim, TextRunPrim):
            self._prepare_text(prim, c, out)
            return
        if isinstance(prim, BoxShadowPrim):
            self._prepare_box_shadow(prim, c, out)
            return
        if isinstance(prim, LineDecorationPrim):
            from ..api.display_item import LineOrientation
            if prim.style == LineStyle.SOLID:
                self._emit_rect_like(prim, c, axis_aligned, out,
                                     KIND_SOLID, list(_premult(prim.color)),
                                     BLEND_NORMAL)
                return
            axis = 0.0 if prim.orientation == LineOrientation.HORIZONTAL \
                else 1.0
            tail = list(_premult(prim.color)) + [
                float(prim.style.value), axis,
                float(prim.wavy_line_thickness)]
            self._emit_rect_like(prim, c, axis_aligned, out,
                                 KIND_LINE_DEC, tail, BLEND_NORMAL)
            return
        if isinstance(prim, NormalBorderPrim):
            self._prepare_border(prim, c, axis_aligned, out)
            return
        if isinstance(prim, NinePatchBorderPrim):
            self._prepare_nine_patch(prim, c, axis_aligned, out)
            return
        if isinstance(prim, BackdropFilterPrim):
            # pass break: the target content so far becomes this prim's input
            out.append(("backdrop", prim))
            return
        raise NotImplementedError(type(prim).__name__)

    # --- helpers -----------------------------------------------------------
    def _emit_common(self, c: PrimCommon, axis_aligned: bool,
                     pattern_rect: Rect, draw_rect: Rect, snap: bool = True,
                     extra_clips: Optional[List[List[float]]] = None,
                     ) -> Optional[Tuple[List[float], int, int, int, Tuple]]:
        """Shared geometry prep: coverage rect, edge AA mask, clips, culling.
        Returns (payload_prefix, edge_aa, clip_addr, clip_count, bbox)."""
        if snap and axis_aligned:
            snapped = self._snap_rect(draw_rect, c.spatial_node)
            if pattern_rect == draw_rect:
                pattern_rect = snapped
            else:
                pattern_rect = self._snap_rect(pattern_rect, c.spatial_node)
            draw_rect = snapped
        cov = draw_rect.intersection(c.clip_rect)
        if cov is None:
            return None
        edge_aa = 0
        if axis_aligned:
            if cov.x0 <= draw_rect.x0:
                edge_aa |= 1
            if cov.y0 <= draw_rect.y0:
                edge_aa |= 2
            if cov.x1 >= draw_rect.x1:
                edge_aa |= 4
            if cov.y1 >= draw_rect.y1:
                edge_aa |= 8
        else:
            edge_aa = 0xF
        clip_addr, clip_count, clip_bbox = self._serialize_clips(
            c.clip_chain, c.spatial_node, extra_records=extra_clips)
        db = device_bounds_of_rect(self._H(c.spatial_node),
                                   cov.x0, cov.y0, cov.x1, cov.y1)
        # tight bbox: AA spill (±1) is added at binning / span evaluation,
        # NOT here — surface regions must hug the content or filters would
        # process the transparent border (filter-component-transfer)
        bbox = db
        if clip_bbox is not None:
            bbox = (max(bbox[0], clip_bbox[0]),
                    max(bbox[1], clip_bbox[1]),
                    min(bbox[2], clip_bbox[2]),
                    min(bbox[3], clip_bbox[3]))
        vp = self.viewport
        bbox = (max(bbox[0], vp.x0 - 4096), max(bbox[1], vp.y0 - 4096),
                min(bbox[2], vp.x1 + 4096), min(bbox[3], vp.y1 + 4096))
        if not all(math.isfinite(v) for v in bbox):
            return None  # NaN geometry: cull (crash-safety, gradient/linear-nan)
        if bbox[2] <= bbox[0] or bbox[3] <= bbox[1]:
            return None
        prefix = [pattern_rect.x0, pattern_rect.y0,
                  pattern_rect.x1, pattern_rect.y1,
                  cov.x0, cov.y0, cov.x1, cov.y1]
        return prefix, edge_aa, clip_addr, clip_count, bbox

    def _emit_rect_like(self, prim, c: PrimCommon, axis_aligned: bool,
                        out: List[int], kind: int, payload_tail: List[float],
                        blend: int, pattern_rect: Optional[Rect] = None,
                        snap: bool = True, edge_mask: int = 0xF) -> None:
        r = c.local_rect
        res = self._emit_common(c, axis_aligned, pattern_rect or r, r,
                                snap=snap)
        if res is None:
            return
        prefix, edge_aa, clip_addr, clip_count, bbox = res
        # EdgeAaSegmentMask role (segment.rs): brush segments AA only
        # their outer edges; inner segment boundaries use pixel-center
        # coverage so adjacent segments tile seamlessly
        edge_aa &= edge_mask
        addr = self.gb.push_f32(prefix + payload_tail)
        idx = self.gb.push_instance(kind, self._row(c.spatial_node),
                                    addr, clip_addr,
                                    clip_count, blend, edge_aa)
        opaque = None
        if kind == KIND_SOLID and blend == BLEND_NORMAL and \
                clip_count == 0 and axis_aligned and \
                len(payload_tail) >= 4 and payload_tail[3] >= 1.0:
            # interior of an opaque axis-aligned solid (1px AA margin)
            opaque = (bbox[0] + 1.0, bbox[1] + 1.0,
                      bbox[2] - 1.0, bbox[3] - 1.0)
        self.metas.push(bbox, opaque)
        out.append(idx)

    def _gradient_stops_addr(self, stops) -> Tuple[int, int]:
        key = tuple((s.offset, s.color.r, s.color.g, s.color.b, s.color.a)
                    for s in stops)
        hit = self._lut_cache.get(key)
        if hit is None:
            recs = gradient_stops_records(stops)
            # NaN stop offsets/colors must not reach the kernels (see the
            # gradient payload sanitization) — linear-nan.yaml
            np.nan_to_num(recs, copy=False, nan=0.0, posinf=3.4e38,
                          neginf=-3.4e38)
            hit = (self.gb.push_f32(recs.reshape(-1)), recs.shape[0])
            self._lut_cache[key] = hit
        return hit

    def _gradient_gl_quant(self, prim, tw: float, th: float) -> float:
        """1.0 when the GL CI would render this gradient through a cached
        u8 render task (scene_building.rs:3395: cached unless hard stops
        at > LINEAR_MAX_CACHED_SIZE would artifact); the swgl CI draws
        non-tiled gradients direct.  Only meaningful under gl_flavor."""
        if not self.gl_flavor:
            return 0.0
        stops = prim.stops
        has_hard = any(abs(stops[i + 1].offset - stops[i].offset) < 1e-9
                       for i in range(len(stops) - 1))
        if has_hard and (tw > 1024.0 or th > 1024.0):
            return 0.0
        return 1.0

    def _prepare_gradient(self, prim, c: PrimCommon, axis_aligned: bool,
                          out: List[int]) -> None:
        """Payload layouts (see frame/gpu.py):
        LINEAR [8:12] p0,p1  RADIAL [8:10] c [10:12] r  CONIC [8:10] c [10] angle
        then [12] stops_addr [13] extend [14] nstops [15] pad
        [16/18] start/end offsets (radial/conic) and tile size + spacing."""
        addr, n = self._gradient_stops_addr(prim.stops)
        ts = prim.tile_size
        sp = prim.tile_spacing
        tw = ts.width or c.local_rect.w
        th = ts.height or c.local_rect.h
        # gradient.rs optimize/adjust: a single tile covering the rect
        # renders exactly like an untiled gradient — normalize the tile
        # size to the rect so float noise in the authored size can't flip
        # a hard-stop tie (gradient/linear-adjust-tile-size.yaml)
        if sp.width == 0 and sp.height == 0 and \
                tw >= c.local_rect.w - 0.5 and \
                th >= c.local_rect.h - 0.5:
            tw, th = c.local_rect.w, c.local_rect.h
        tile = [tw, th, sp.width, sp.height]
        ext = float(prim.gradient.extend_mode.value)
        g = prim.gradient
        glq = self._gradient_gl_quant(prim, tw, th)
        if isinstance(prim, LinearGradientPrim):
            tail = [g.start_point.x, g.start_point.y, g.end_point.x,
                    g.end_point.y, float(addr), ext, float(n), glq] + tile
            kind = KIND_LINEAR_GRAD
        elif isinstance(prim, RadialGradientPrim):
            tail = [g.center.x, g.center.y, g.radius.width, g.radius.height,
                    float(addr), ext, float(n), glq,
                    g.start_offset, g.end_offset] + tile
            kind = KIND_RADIAL_GRAD
        else:
            tail = [g.center.x, g.center.y, g.angle, 0.0,
                    float(addr), ext, float(n), glq,
                    g.start_offset, g.end_offset] + tile
            kind = KIND_CONIC_GRAD
        self._emit_rect_like(prim, c, axis_aligned, out, kind, tail,
                             BLEND_NORMAL)

    def _prepare_image(self, prim: ImagePrim, c: PrimCommon,
                       axis_aligned: bool, out: List[int]) -> None:
        tpl = self.resources.images.get(prim.image_key)
        if tpl is None:
            return
        desc = tpl.descriptor
        stretch_w = prim.stretch_size.width or c.local_rect.w
        stretch_h = prim.stretch_size.height or c.local_rect.h
        lim = self.resources.MAX_DIRECT_DIM
        if desc.width <= lim and desc.height <= lim:
            req = self.resources.request_image(prim.image_key)
            if req is None:
                return
            region, desc = req
            self._emit_image_instance(
                prim, c, axis_aligned, out, region.x, region.y,
                desc.width, desc.height, stretch_w, stretch_h,
                prim.tile_spacing.width, prim.tile_spacing.height,
                prim.image_rendering, prim.color)
            return
        # huge image: upload only the visible sub-rect (image_tiling.rs role)
        r = c.local_rect
        vis = r.intersection(c.clip_rect) or r
        # map the device viewport into local space to bound the crop
        H = self._H(c.spatial_node)
        try:
            Hinv = np.linalg.inv(H)
            corners = [np.array([x, y, 1.0]) @ Hinv
                       for (x, y) in ((0, 0), (self.viewport.x1, 0),
                                      (0, self.viewport.y1),
                                      (self.viewport.x1, self.viewport.y1))]
            pts = [(p[0] / p[2], p[1] / p[2]) for p in corners]
            lx0 = min(p[0] for p in pts)
            lx1 = max(p[0] for p in pts)
            ly0 = min(p[1] for p in pts)
            ly1 = max(p[1] for p in pts)
            vis = vis.intersection(Rect.from_bounds(lx0, ly0, lx1, ly1)) or vis
        except np.linalg.LinAlgError:
            pass
        ox0 = max(0.0, vis.x0 - r.x0)
        oy0 = max(0.0, vis.y0 - r.y0)
        ox1 = max(ox0, vis.x1 - r.x0)
        oy1 = max(oy0, vis.y1 - r.y0)
        period_x = stretch_w + prim.tile_spacing.width
        period_y = stretch_h + prim.tile_spacing.height
        # axis-aligned scale+translate mapping of a non-repeating huge
        # image whose needed texels exceed the direct-residency cap:
        # pre-resample the visible region at device resolution on the
        # host with the same bilinear math (exact), sample 1:1 on device
        sx_, sy_ = H[0, 0], H[1, 1]
        aligned = axis_aligned and sx_ > 1e-9 and sy_ > 1e-9 and \
            abs(H[0, 1]) < 1e-12 and abs(H[1, 0]) < 1e-12 and \
            abs(H[0, 2]) < 1e-12 and abs(H[1, 2]) < 1e-12
        if ox1 <= period_x and oy1 <= period_y and aligned and \
                tpl.data.pixels is not None and \
                ((ox1 - ox0) / stretch_w * desc.width > lim or
                 (oy1 - oy0) / stretch_h * desc.height > lim):
            tx_, ty_ = H[2, 0], H[2, 1]
            dx0 = int(math.floor(vis.x0 * sx_ + tx_)) - 1
            dy0 = int(math.floor(vis.y0 * sy_ + ty_)) - 1
            dx1 = int(math.ceil(vis.x1 * sx_ + tx_)) + 1
            dy1 = int(math.ceil(vis.y1 * sy_ + ty_)) + 1
            dw, dh = dx1 - dx0, dy1 - dy0
            if 0 < dw <= lim and 0 < dh <= lim:
                nearest = prim.image_rendering in (
                    ImageRendering.PIXELATED, ImageRendering.CROSP_EDGES)
                rkey = (dx0, dy0, dw, dh, round(sx_, 6), round(sy_, 6),
                        round(tx_, 4), round(ty_, 4), round(r.x0, 4),
                        round(r.y0, 4), round(stretch_w, 4),
                        round(stretch_h, 4), nearest)
                req = self.resources.request_image_resampled(
                    prim.image_key, rkey, dw, dh,
                    lambda: _resample_image_device(
                        tpl, desc, r, stretch_w, stretch_h, dx0, dy0,
                        dw, dh, sx_, sy_, tx_, ty_, nearest))
                if req is not None:
                    region = req[0]
                    p0x = (dx0 - tx_) / sx_
                    p0y = (dy0 - ty_) / sy_
                    p1x = (dx1 - tx_) / sx_
                    p1y = (dy1 - ty_) / sy_
                    self._emit_image_instance(
                        prim, c, axis_aligned, out, region.x, region.y,
                        dw, dh, p1x - p0x, p1y - p0y, 0.0, 0.0,
                        ImageRendering.AUTO, prim.color,
                        img_scale=(sx_, sy_), crop_origin=(0.0, 0.0),
                        pattern_rect=Rect.from_bounds(p0x, p0y, p1x, p1y),
                        snap=False)
                    return
        if ox1 <= period_x and oy1 <= period_y:
            img_rect = (ox0 / stretch_w * desc.width,
                        oy0 / stretch_h * desc.height,
                        ox1 / stretch_w * desc.width,
                        oy1 / stretch_h * desc.height)
        else:
            img_rect = (0, 0, desc.width, desc.height)  # repeating: best effort
        req = self.resources.request_image_sub(prim.image_key, img_rect)
        if req is None:
            return
        region, desc, crop_origin = req
        self._emit_image_instance(
            prim, c, axis_aligned, out, region.x, region.y,
            region.w, region.h, stretch_w, stretch_h,
            prim.tile_spacing.width, prim.tile_spacing.height,
            prim.image_rendering, prim.color,
            img_scale=(desc.width / stretch_w, desc.height / stretch_h),
            crop_origin=crop_origin)

    def _prepare_yuv(self, prim: YuvImagePrim, c: PrimCommon,
                     axis_aligned: bool, out: List[int]) -> None:
        """YUV images convert IN-KERNEL (yuv.glsl sample_yuv +
        rgb_from_debiased_ycbcr, res/yuv.glsl:82-150): the raw planes live
        in the alpha atlas and every frame of a video costs only the plane
        upload, not a host color conversion.  >8-bit sources fall back to
        the host-converted RGBA path."""
        from ..api.display_item import ColorDepth, ColorRange, YuvColorSpace
        planes = None
        if prim.color_depth == ColorDepth.COLOR8 and axis_aligned:
            planes = self.resources.request_yuv_planes(prim.yuv_keys,
                                                       prim.format)
        if planes is None:
            req = self.resources.request_yuv_image(
                prim.yuv_keys, prim.format, prim.color_space,
                prim.color_range, prim.color_depth)
            if req is None:
                return
            region, w, h = req
            self._emit_image_instance(prim, c, axis_aligned, out, region.x,
                                      region.y, w, h, c.local_rect.w,
                                      c.local_rect.h, 0.0, 0.0,
                                      prim.image_rendering, ColorF.WHITE)
            return
        (ry, yw, yh), (ru, uw_, uh_), (rv, vw_, vh_) = planes
        # zero/one per range (yuv.glsl yuv_channel_zero_one_*, 8-bit)
        if prim.color_space == YuvColorSpace.IDENTITY:
            zero = (0.0, 0.0)
            one = (1.0, 1.0)
        elif prim.color_range == ColorRange.LIMITED:
            zero = (16.0 / 255.0, 128.0 / 255.0)
            one = (235.0 / 255.0, 240.0 / 255.0)
        else:
            zero = (0.0, 128.0 / 255.0)
            one = (1.0, 1.0)
        sy_ = 1.0 / (one[0] - zero[0])
        sc_ = 1.0 / (one[1] - zero[1])
        # RgbFromYuv_* (yuv.glsl:36-59, column-major there) row-major,
        # post-multiplied by diag(scale.x, scale.y, scale.y)
        m = {
            YuvColorSpace.REC601: [1.0, 0.0, 0.70100,
                                   1.0, -0.17207, -0.35707,
                                   1.0, 0.88600, 0.0],
            YuvColorSpace.REC709: [1.0, 0.0, 0.78740,
                                   1.0, -0.09366, -0.23406,
                                   1.0, 0.92780, 0.0],
            YuvColorSpace.REC2020: [1.0, 0.0, 0.73730,
                                    1.0, -0.08228, -0.28568,
                                    1.0, 0.94070, 0.0],
            YuvColorSpace.IDENTITY: [0.0, 0.0, 1.0,
                                     1.0, 0.0, 0.0,
                                     0.0, 1.0, 0.0],
        }[prim.color_space]
        mat = [m[0] * sy_, m[1] * sc_, m[2] * sc_,
               m[3] * sy_, m[4] * sc_, m[5] * sc_,
               m[6] * sy_, m[7] * sc_, m[8] * sc_]
        rect = c.local_rect
        sw = max(rect.w, 1e-6)
        sh = max(rect.h, 1e-6)
        res = self._emit_common(c, axis_aligned, rect, rect)
        if res is None:
            return
        prefix, edge_aa, clip_addr, clip_count, bbox = res
        nearest = 1.0 if prim.image_rendering in (
            ImageRendering.PIXELATED, ImageRendering.CROSP_EDGES) else 0.0
        payload = prefix + [
            float(ry.x), float(ry.y), float(ry.x + yw), float(ry.y + yh),
            float(ru.x), float(ru.y), float(ru.x + uw_), float(ru.y + uh_),
            float(rv.x), float(rv.y), float(rv.x + vw_), float(rv.y + vh_),
            sw, sh, yw / sw, yh / sh, uw_ / sw, uh_ / sh,
            nearest] + mat + [zero[0], zero[1], zero[1]]
        addr = self.gb.push_f32(payload)
        idx = self.gb.push_instance(KIND_YUV, self._row(c.spatial_node),
                                    addr, clip_addr, clip_count,
                                    BLEND_NORMAL, edge_aa)
        # video frames are always alpha-1 (yuv.glsl) -> occluders
        opaque = None
        if clip_count == 0 and axis_aligned:
            opaque = (bbox[0] + 1.0, bbox[1] + 1.0,
                      bbox[2] - 1.0, bbox[3] - 1.0)
        self.metas.push(bbox, opaque)
        out.append(idx)

    def _emit_image_instance(self, prim, c, axis_aligned, out, ux, uy, uw, uh,
                             stretch_w, stretch_h, spacing_w, spacing_h,
                             rendering, color, img_scale=None,
                             crop_origin=(0.0, 0.0), pattern_rect=None,
                             snap=True, edge_mask=0xF) -> None:
        nearest = 1.0 if rendering in (ImageRendering.PIXELATED,
                                       ImageRendering.CROSP_EDGES) else 0.0
        if img_scale is None:
            img_scale = (uw / max(stretch_w, 1e-6), uh / max(stretch_h, 1e-6))
        tail = [ux, uy, ux + uw, uy + uh] + list(_premult(color)) + \
            [nearest, 0.0, stretch_w, stretch_h, spacing_w, spacing_h,
             img_scale[0], img_scale[1], crop_origin[0], crop_origin[1]]
        self._emit_rect_like(prim, c, axis_aligned, out, KIND_IMAGE, tail,
                             BLEND_NORMAL, pattern_rect=pattern_rect,
                             snap=snap, edge_mask=edge_mask)

    def _prepare_text(self, prim: TextRunPrim, c: PrimCommon,
                      out: List[int]) -> None:
        self._prepare_text_runs([prim], c, out)

    def _prepare_text_runs(self, prims: List[TextRunPrim], c: PrimCommon,
                           out: List[int]) -> None:
        """One GLYPH instance per glyph (ps_text_run instances), prepared
        VECTORIZED over every glyph of every run in `prims` — consecutive
        text runs sharing (spatial, clip chain, font instance) batch into
        one numpy block (the prepare.rs hot path without per-run Python;
        painter order is preserved because instances stay in glyph
        order)."""
        # glyphs raster at the device scale so magnified text stays sharp
        # (FontTransform / raster-space role; text/mix-blend-layers.yaml);
        # bitmap metrics come back in raster px
        pal = self._pal(c.spatial_node)
        gscale = max(1.0, round(max(float(pal[9]), float(pal[10])) * 64.0)
                     / 64.0)
        fi_key = prims[0].font_instance_key
        fi0 = self.resources.font_instance(fi_key)
        mode_override = None
        subpx = fi0 is not None and \
            fi0[2].render_mode == FontRenderMode.SUBPIXEL
        if subpx and self._surface_depth > 0:
            # intermediate surfaces are transparent: demote to grayscale
            # (text/allow-subpixel.yaml)
            subpx = False
            mode_override = FontRenderMode.ALPHA
        is_mono0 = fi0 is not None and \
            fi0[2].render_mode == FontRenderMode.MONO
        inv = 1.0 / gscale
        clip_addr, clip_count, clip_bbox = self._serialize_clips(
            c.clip_chain, c.spatial_node)
        H = self._H(c.spatial_node)
        axis_aligned = self.resolved[c.spatial_node].is_2d_axis_aligned
        sx_, sy_ = H[0, 0], H[1, 1]
        tx_, ty_ = H[2, 0], H[2, 1]
        snap_dev = axis_aligned and abs(sx_) > 1e-9 and abs(sy_) > 1e-9
        mono = is_mono0
        clip_rect = c.clip_rect

        # quantized subpixel X positioning (wr_glyph_rasterizer
        # SubpixelOffset::quantize): 8ths bucketed to quarters; mono text
        # snaps whole pixels. Glyph bitmaps raster per offset bucket.
        _OFF8 = np.array((0.0, 0.25, 0.25, 0.5, 0.5, 0.75, 0.75, 1.0))

        counts = [len(p_.glyphs) for p_ in prims]
        G = sum(counts)
        if G == 0:
            return
        gis = np.empty(G, np.int64)
        gxs = np.empty(G, np.float64)
        gys = np.empty(G, np.float64)
        pos0 = 0
        for p_, n_ in zip(prims, counts):
            for j, g in enumerate(p_.glyphs):
                gis[pos0 + j] = g[0]
                gxs[pos0 + j] = g[1]
                gys[pos0 + j] = g[2]
            pos0 += n_
        # per-glyph premultiplied color (runs in a batch may differ)
        run_cols = np.array([_premult(p_.color) for p_ in prims],
                            np.float32)
        col_g = np.repeat(run_cols, counts, axis=0)
        # the accumulated frame offset — the stacking-context origins
        # folded into the glyph coords plus the transform translation —
        # snaps to whole device px BEFORE glyph layout (text_run.rs:321
        # snapped_reference_frame_relative_offset, util.rs snap =
        # floor(v+0.5)): fractional SC origins and fractional transforms
        # then land glyphs identically (snap/fractional-filter.yaml,
        # text/snap-text-offset.yaml)
        fox, foy = prims[0].frame_offset
        if snap_dev:
            ox_s = math.floor(fox * sx_ + tx_ + 0.5)
            oy_s = math.floor(foy * sy_ + ty_ + 0.5)
        else:
            ox_s = fox * sx_ + tx_
            oy_s = foy * sy_ + ty_
        v = (gxs - fox) * sx_ + ox_s if snap_dev else gxs
        if mono or not snap_dev:
            dev_x = np.round(v)
            off = np.zeros(G)
        else:
            base = np.floor(v)
            # +1e-4 absorbs fp noise from composed transforms sitting just
            # under an 8th boundary (rotate-snap-clip: two exact 180-deg
            # rotations must quantize like the identity)
            o = _OFF8[((v - base) * 8.0 + 1e-4).astype(np.int64) & 7]
            dev_x = np.where(o == 1.0, base + 1.0, base)
            off = np.where(o == 1.0, 0.0, o)

        # rasterize per offset bucket; per-bucket metric tables indexed by
        # unique glyph id (searchsorted gather, no per-glyph dict walk;
        # repeat frames hit the resource cache's metric-table cache)
        metrics = np.zeros((G, 6), np.float64)  # left top w h rx ry
        present = np.zeros(G, bool)
        is_subpx = False
        for o in np.unique(off):
            sel = off == o
            ids = np.unique(gis[sel])
            table, ok, subpx = self.resources.request_glyph_metrics(
                fi_key, tuple(ids.tolist()), gscale,
                mode_override, float(o))
            is_subpx = is_subpx or subpx
            pos = np.searchsorted(ids, gis[sel])
            metrics[sel] = table[pos]
            present[sel] = ok[pos]

        inv64 = float(inv)
        left, top = metrics[:, 0], metrics[:, 1]
        bw = metrics[:, 2] + 2.0
        bh = metrics[:, 3] + 2.0
        if snap_dev:
            # pen snapped to whole device pixels *after* the transform
            # (glyph raster is grid-fitted; text/snap-text-offset.yaml);
            # the subpixel fraction lives in the bitmap raster
            pxg = (dev_x - tx_) / sx_ + left * inv64
            pyg = (np.round((gys - foy) * sy_ + oy_s) - ty_) / sy_ \
                - top * inv64
        else:
            pxg = dev_x + left * inv64
            pyg = np.round(gys) - top * inv64
        # the uv rect is the 1-texel-inset ring of the padded upload:
        # a transparent frame around the content so bilinear taps never
        # touch atlas neighbours (resource_cache glyph border)
        rx0 = pxg - inv64
        ry0 = pyg - inv64
        rx1 = rx0 + bw * inv64
        ry1 = ry0 + bh * inv64
        cx0 = np.maximum(rx0, clip_rect.x0)
        cy0 = np.maximum(ry0, clip_rect.y0)
        cx1 = np.minimum(rx1, clip_rect.x1)
        cy1 = np.minimum(ry1, clip_rect.y1)
        keep = present & (cx1 > cx0) & (cy1 > cy0)
        if snap_dev and mono:
            # mono (grid-fitted, no AA) glyphs are not cut mid-raster
            # by the run's local clip: partially-visible glyphs draw
            # whole (text/snap-clip.yaml vs its unclipped ref);
            # AA text clips pixel-exact (shadow-partial-glyph.yaml)
            cx0, cy0, cx1, cy1 = rx0, ry0, rx1, ry1
        db = device_bounds_of_rects(
            self._H(c.spatial_node), np.stack([cx0, cy0, cx1, cy1], 1))
        if clip_bbox is not None:
            db[:, 0] = np.maximum(db[:, 0], clip_bbox[0])
            db[:, 1] = np.maximum(db[:, 1], clip_bbox[1])
            db[:, 2] = np.minimum(db[:, 2], clip_bbox[2])
            db[:, 3] = np.minimum(db[:, 3], clip_bbox[3])
        keep &= (db[:, 2] > db[:, 0]) & (db[:, 3] > db[:, 1])
        if not keep.any():
            return
        k = int(keep.sum())
        geom = np.empty((k, 16), np.float32)
        geom[:, 0] = rx0[keep]
        geom[:, 1] = ry0[keep]
        geom[:, 2] = rx1[keep]
        geom[:, 3] = ry1[keep]
        geom[:, 4] = cx0[keep]
        geom[:, 5] = cy0[keep]
        geom[:, 6] = cx1[keep]
        geom[:, 7] = cy1[keep]
        geom[:, 8] = metrics[keep, 4] + 1.0
        geom[:, 9] = metrics[keep, 5] + 1.0
        geom[:, 10] = metrics[keep, 4] + 1.0 + bw[keep]
        geom[:, 11] = metrics[keep, 5] + 1.0 + bh[keep]
        col_k = col_g[keep]
        row = self._row(c.spatial_node)
        if is_subpx:
            # dual-source pair per glyph: punch dst per channel by mask*a,
            # then add color*mask*a (ps_text_run dual-source blending)
            a_k = col_k[:, 3]
            pay = np.empty((2 * k, 16), np.float32)
            pay[0::2] = geom
            pay[1::2] = geom
            pay[0::2, 12:16] = a_k[:, None]
            pay[1::2, 12:16] = col_k
            addrs = self.gb.push_f32_block(pay)
            inst = np.empty((2 * k, 8), np.int64)
            inst[:, 0] = KIND_SUBPX_GLYPH
            inst[:, 1] = row
            inst[:, 2] = addrs
            inst[:, 3] = clip_addr
            inst[:, 4] = clip_count
            inst[0::2, 5] = BLEND_CH_CLEAR
            inst[1::2, 5] = BLEND_ADD
            inst[:, 6] = 0
            inst[:, 7] = 0
            idxs = self.gb.push_instance_block(inst)
            bb2 = np.repeat(db[keep], 2, axis=0)
            self.metas.push_block(bb2.astype(np.float32))
            out.extend(idxs.tolist())
            return
        geom[:, 12:16] = col_k
        addrs = self.gb.push_f32_block(geom)
        inst = np.empty((k, 8), np.int64)
        inst[:, 0] = KIND_GLYPH
        inst[:, 1] = row
        inst[:, 2] = addrs
        inst[:, 3] = clip_addr
        inst[:, 4] = clip_count
        inst[:, 5] = BLEND_NORMAL
        inst[:, 6] = 0
        inst[:, 7] = 0
        idxs = self.gb.push_instance_block(inst)
        self.metas.push_block(db[keep].astype(np.float32))
        out.extend(idxs.tolist())

    @staticmethod
    def _clamp_to_scale_factor(val: float) -> float:
        """util.rs:1526 clamp_to_scale_factor(val, round_down=false):
        clamp a scale to a power of two."""
        val = abs(val)
        if val < 1e-9:
            return 1.0
        inverse = val < 1.0
        v = 1.0 / val if inverse else val
        power = math.log2(v)
        if abs(power - round(power)) < 1e-5:
            power = round(power)
        elif inverse:
            power = math.floor(power)
        else:
            power = math.ceil(power)
        scale = 2.0 ** power
        return 1.0 / scale if inverse else scale

    @staticmethod
    def _corner_overlap_clamp(radii: List[float], w: float, h: float
                              ) -> List[float]:
        """border.rs ensure_no_corner_overlap: scale radii so adjacent
        corner ellipses never overlap."""
        ratio = 1.0
        if w > 0:
            for s_ in (radii[0] + radii[2], radii[6] + radii[4]):
                if s_ > w:
                    ratio = min(ratio, w / s_)
        if h > 0:
            for s_ in (radii[1] + radii[7], radii[3] + radii[5]):
                if s_ > h:
                    ratio = min(ratio, h / s_)
        return [v * ratio for v in radii] if ratio < 1.0 else radii

    def _prepare_box_shadow_task(self, prim: BoxShadowPrim, c: PrimCommon,
                                 blur_radius: float, shadow_rect: Rect,
                                 shadow_radii: List[float],
                                 radii: List[float],
                                 out: List[int], down: float = 1.0,
                                 orig_alloc=None) -> None:
        """Task-based box shadow for blur_radius > 0: a solid rect clipped
        by (a) the rounded prim box and (b) a nine-patch-stretched cached
        blurred rounded-rect mask — the reference pipeline exactly
        (box_shadow.rs add_box_shadow normal path, clip.rs
        compute_box_shadow_parameters:1765, render_task.rs new_mask:652,
        cs_clip_box_shadow.glsl)."""
        outset = prim.clip_mode == BoxShadowClipMode.OUTSET
        blur_offset = math.ceil(3.0 * blur_radius)  # BLUR_SAMPLE_SCALE
        dest_rect = shadow_rect.inflate(blur_offset, blur_offset)
        if outset:
            if shadow_rect.w <= 0 or shadow_rect.h <= 0:
                return
            draw_rect = dest_rect
        else:
            # inset fully-covered early-out (box_shadow.rs:530)
            if all(v == 0.0 for v in radii):
                inner = shadow_rect.inflate(-blur_radius, -blur_radius)
                bb = prim.box_bounds
                if inner.x0 <= bb.x0 and inner.y0 <= bb.y0 and \
                        inner.x1 >= bb.x1 and inner.y1 >= bb.y1:
                    return
            draw_rect = prim.box_bounds
        # compute_box_shadow_parameters (clip.rs:1765, local units; at
        # `down` < 1 every geometric input is pre-scaled — the
        # new_box_shadow MAX_SIZE=2048 reduced-resolution path)
        sw_ = shadow_rect.w * down
        sh2 = shadow_rect.h * down
        sradii = self._corner_overlap_clamp(
            [v * down for v in shadow_radii], sw_, sh2)
        br_d = blur_radius * down
        # fract offsets come from the UNSCALED rect, then scale
        # (clip.rs new_box_shadow: shadow_rect_fract_offset * downscale)
        fract_x = abs(shadow_rect.x0 - math.trunc(shadow_rect.x0)) * down
        fract_y = abs(shadow_rect.y0 - math.trunc(shadow_rect.y0)) * down
        fract_w = abs(sw_ - math.trunc(sw_))
        fract_h = abs(sh2 - math.trunc(sh2))
        max_cw = max(sradii[0], sradii[2], sradii[4], sradii[6])
        max_ch = max(sradii[1], sradii[3], sradii[5], sradii[7])
        blur_region = math.ceil(3.0 * br_d)
        used_cw = max(max_cw, blur_region)
        used_ch = max(max_ch, blur_region)
        min_w = 2.0 * used_cw + blur_region + fract_w
        min_h = 2.0 * used_ch + blur_region + fract_h
        min_x = blur_region + fract_x
        min_y = blur_region + fract_y
        stretch_x = 1.0
        if sw_ < min_w:
            min_w = sw_
            stretch_x = 0.0  # Simple
        stretch_y = 1.0
        if sh2 < min_h:
            min_h = sh2
            stretch_y = 0.0
        alloc_w = 2.0 * blur_region + math.ceil(min_w)
        alloc_h = 2.0 * blur_region + math.ceil(min_h)
        # clip.rs new_box_shadow MAX_SIZE=2048: recompute at reduced scale
        max_dim = max(alloc_w, alloc_h)
        if down == 1.0 and max_dim > 2048.0:
            return self._prepare_box_shadow_task(
                prim, c, blur_radius, shadow_rect, shadow_radii, radii,
                out, down=2048.0 / max_dim,
                orig_alloc=(alloc_w, alloc_h))
        cs = self._clamp_to_scale_factor(self.dpr)
        # rust .round() = half away from zero (not Python's half-even)
        cache_w = max(1, int(math.floor(alloc_w * cs + 0.5)))
        cache_h = max(1, int(math.floor(alloc_h * cs + 0.5)))
        sigma_i = int(math.floor(br_d * 0.5 * cs + 0.5))
        bs_key = ("bs_mask", sigma_i, outset, cache_w, cache_h,
                  round(min_x * cs * 16), round(min_y * cs * 16),
                  round(min_w * cs * 16), round(min_h * cs * 16),
                  tuple(round(v * cs * 16) for v in sradii))
        mask_rect = (min_x, min_y, min_x + min_w, min_y + min_h)
        render = self._render_box_shadow_mask(
            mask_rect, sradii, float(sigma_i), cache_w, cache_h, cs)
        # the stored mask is at the blur chain's downscaled resolution
        # (new_blur's scale factor) — compute the final dims up front
        sig_f = float(sigma_i)
        dscale = 1
        fin_w, fin_h = cache_w, cache_h
        while sig_f > MAX_BLUR_SIGMA:
            if fin_w < MIN_DOWNSCALING_RT_SIZE or \
                    fin_h < MIN_DOWNSCALING_RT_SIZE:
                break
            sig_f *= 0.5
            dscale *= 2
            fin_w = max(1, cache_w // dscale)
            fin_h = max(1, cache_h // dscale)
        key = self.resources.get_or_render_source(bs_key, fin_w, fin_h,
                                                  render)
        req = self.resources.request_image(key)
        if req is None:
            return
        reg, desc = req
        # extra clip records: rounded prim box (out for outset, in for
        # inset) + the nine-patch mask clip (kind 4)
        row = float(self._row(c.spatial_node))
        pal = [float(v) for v in self._pal(c.spatial_node)]
        rec_a = [0.0] * CLIP_STRIDE
        rec_a[96:108] = pal
        bb = prim.box_bounds
        rec_a[0:4] = [bb.x0, bb.y0, bb.x1, bb.y1]
        rec_a[4:12] = self._corner_overlap_clamp(list(radii), bb.w, bb.h)
        rec_a[12] = 1.0 if outset else 0.0
        rec_a[13] = row
        rec_a[14] = 1.0
        rec_b = [0.0] * CLIP_STRIDE
        rec_b[96:108] = pal
        rec_b[0:4] = [dest_rect.x0, dest_rect.y0, dest_rect.x1, dest_rect.y1]
        # the nine-patch maps local space over the ORIGINAL (unscaled)
        # alloc size (batch.rs src_rect_size = original_alloc_size)
        oa_w, oa_h = orig_alloc if orig_alloc is not None \
            else (alloc_w, alloc_h)
        rec_b[4] = oa_w
        rec_b[5] = oa_h
        rec_b[6] = stretch_x
        rec_b[7] = stretch_y
        rec_b[13] = row
        rec_b[14] = 4.0
        rec_b[15] = 0.0 if outset else 1.0
        rec_b[16:20] = [reg.x, reg.y, reg.x + desc.width,
                        reg.y + desc.height]
        res = self._emit_common(c, True, draw_rect, draw_rect,
                                extra_clips=[rec_a, rec_b])
        if res is None:
            return
        prefix, edge_aa, clip_addr, clip_count, bbox = res
        payload = prefix + list(_premult(prim.color))
        addr = self.gb.push_f32(payload)
        idx = self.gb.push_instance(KIND_SOLID,
                                    self._row(c.spatial_node), addr,
                                    clip_addr, clip_count, BLEND_NORMAL,
                                    edge_aa)
        self.metas.push(bbox)
        out.append(idx)

    def _render_box_shadow_mask(self, mask_rect, sradii, sigma: float,
                                cache_w: int, cache_h: int, cs: float):
        """Host raster of the cached blurred mask (the render_task the
        reference caches in the texture cache): rounded-rect AA coverage
        (cs_clip_rectangle math = patterns.rounded_rect_coverage), R8
        quantized, then the blur chain (downscale while σ>4, V then H).
        Under gl_flavor the blur/downscale run the GPU float math of
        cs_blur.glsl / cs_scale.glsl (the PNG refs are GL CI renders);
        otherwise the 16-bit fixed-point chain keeps all backends
        bit-equal."""
        from ..ops import patterns as _pk
        from ..ops.raster import (blur_plane_gpu, gaussian_weights as _gw,
                                  resample_bilinear as _rs,
                                  resample_bilinear_gpu as _rs_gpu)
        gl = self.gl_flavor

        def render():
            xs = (np.arange(cache_w, dtype=np.float32) + 0.5) / cs
            ys = (np.arange(cache_h, dtype=np.float32) + 0.5) / cs
            lx = np.broadcast_to(xs[None, :], (cache_h, cache_w))
            ly = np.broadcast_to(ys[:, None], (cache_h, cache_w))
            ur = _pk.uniform_radius(sradii)
            if ur is not None:
                # uniform radii take the fast-path Euclidean SDF
                # (render_target.rs:1215 picks WR_FEATURE_FAST_PATH)
                cov = _pk.rounded_rect_fast_coverage(
                    np, np.asarray(mask_rect, np.float32),
                    np.float32(ur), lx, ly, np.float32(cs))
            else:
                cov = _pk.rounded_rect_sdf_coverage(
                    np, np.asarray(mask_rect, np.float32),
                    np.asarray(sradii, np.float32), lx, ly, np.float32(cs))
            mask = np.rint(cov * np.float32(255.0)) * np.float32(1 / 255.0)
            plane = mask[None]  # [1, h, w] for the resample helper
            sig = sigma
            tw_, th_ = cache_w, cache_h
            scale = 1
            while sig > MAX_BLUR_SIGMA:
                if tw_ < MIN_DOWNSCALING_RT_SIZE or \
                        th_ < MIN_DOWNSCALING_RT_SIZE:
                    break
                sig *= 0.5
                scale *= 2
                nw = max(1, cache_w // scale)
                nh = max(1, cache_h // scale)
                rs = _rs_gpu if gl else _rs
                plane = rs(np, plane, nw, nh).astype(np.float32)
                tw_, th_ = nw, nh
            if sig > 0 and gl:
                plane = blur_plane_gpu(np, plane[0],
                                       sig)[None].astype(np.float32)
            elif sig > 0:
                radius = max(1, int(np.ceil(1.5 * sig)) * 2)
                w = _gw(sig, radius)
                for axis in (1, 2):  # V then H
                    n = plane.shape[axis]
                    content = np.floor(plane * np.float32(255.0) + 0.5)
                    pad = [(0, 0), (0, 0), (0, 0)]
                    pad[axis] = (radius, radius)
                    x = np.pad(content, pad, mode="edge")
                    acc = np.zeros_like(content)
                    for k in range(2 * radius + 1):
                        sl = [slice(None)] * 3
                        sl[axis] = slice(k, k + n)
                        acc += w[k] * x[tuple(sl)]
                    plane = (np.floor(acc * np.float32(1.0 / 65536.0)
                                      + 0.5)
                             * np.float32(1.0 / 255.0)).astype(np.float32)
            m8 = np.clip(np.floor(plane[0] * 255.0 + 0.5), 0,
                         255).astype(np.uint8)
            texels = np.stack([m8, m8, m8, m8], axis=-1)
            return texels
        return render

    def _prepare_box_shadow(self, prim: BoxShadowPrim, c: PrimCommon,
                            out: List[int]) -> None:
        """Box shadows (box_shadow.rs add_box_shadow): blur_radius > 0 goes
        through the cached-blurred-mask nine-patch task path; zero blur
        keeps the analytic sharp path (the reference's no-blur fast path
        uses plain rounded clips)."""
        # box_shadow.rs:283/329 — MAX_BLUR_RADIUS = 300 clamp before halving
        blur_radius_c = min(prim.blur_radius, 300.0)
        if blur_radius_c > 0.0:
            spread = prim.spread_radius
            outset = prim.clip_mode == BoxShadowClipMode.OUTSET
            amt = spread if outset else -spread
            shadow_rect = prim.box_bounds.inflate(amt, amt).translate(
                prim.offset.x, prim.offset.y)
            r = prim.border_radius
            radii = [r.top_left.width, r.top_left.height,
                     r.top_right.width, r.top_right.height,
                     r.bottom_right.width, r.bottom_right.height,
                     r.bottom_left.width, r.bottom_left.height]
            shadow_radii = [max(v + amt, 0.0) if v > 0.0 else 0.0
                            for v in radii]
            self._prepare_box_shadow_task(prim, c, blur_radius_c,
                                          shadow_rect, shadow_radii, radii,
                                          out)
            return
        # trivial reject (box_shadow.rs:344-346): zero blur + offset +
        # spread is completely hidden behind the box's own punch-out —
        # drawing it would leave mask·(1−mask) residue on the corner AA
        if prim.offset.x == 0.0 and prim.offset.y == 0.0 and \
                prim.spread_radius == 0.0:
            return
        sigma = blur_radius_c * 0.5
        spread = prim.spread_radius
        if prim.clip_mode == BoxShadowClipMode.OUTSET:
            shadow_rect = prim.box_bounds.inflate(spread, spread).translate(
                prim.offset.x, prim.offset.y)
            inflate = 3.0 * sigma
            draw_rect = shadow_rect.inflate(inflate, inflate)
        else:
            shadow_rect = prim.box_bounds.inflate(-spread, -spread).translate(
                prim.offset.x, prim.offset.y)
            if shadow_rect.x1 <= shadow_rect.x0 or \
                    shadow_rect.y1 <= shadow_rect.y0:
                # spread larger than the box: the inner (unshadowed) region
                # vanishes and the inset shadow fills the whole box
                # (inset-spread-large.yaml)
                cx = (shadow_rect.x0 + shadow_rect.x1) * 0.5
                cy = (shadow_rect.y0 + shadow_rect.y1) * 0.5
                shadow_rect = Rect(cx, cy, 0.0, 0.0)
            draw_rect = prim.box_bounds
        r = prim.border_radius
        radii = [r.top_left.width, r.top_left.height,
                 r.top_right.width, r.top_right.height,
                 r.bottom_right.width, r.bottom_right.height,
                 r.bottom_left.width, r.bottom_left.height]
        # shadow radii grow/shrink with spread (adjust_border_radius_for_
        # box_shadow, box_shadow.rs:561-583): only non-zero radii adjust
        amt = spread if prim.clip_mode == BoxShadowClipMode.OUTSET \
            else -spread
        shadow_radii = [max(v + amt, 0.0) if v > 0.0 else 0.0
                        for v in radii]
        # clamp so adjacent shadow corners never overlap (border.rs
        # ensure_no_corner_overlap applied to the shadow rect)
        sratio = 1.0
        if shadow_rect.w > 0:
            for s_ in (shadow_radii[0] + shadow_radii[2],
                       shadow_radii[6] + shadow_radii[4]):
                if s_ > shadow_rect.w:
                    sratio = min(sratio, shadow_rect.w / s_)
        if shadow_rect.h > 0:
            for s_ in (shadow_radii[1] + shadow_radii[7],
                       shadow_radii[3] + shadow_radii[5]):
                if s_ > shadow_rect.h:
                    sratio = min(sratio, shadow_rect.h / s_)
        shadow_radii = [v * sratio for v in shadow_radii]
        res = self._emit_common(c, True, draw_rect, draw_rect)
        if res is None:
            return
        prefix, edge_aa, clip_addr, clip_count, bbox = res
        bb = prim.box_bounds
        payload = prefix + \
            [shadow_rect.x0, shadow_rect.y0, shadow_rect.x1, shadow_rect.y1] + \
            shadow_radii + \
            [sigma,
             0.0 if prim.clip_mode == BoxShadowClipMode.OUTSET else 1.0] + \
            [bb.x0, bb.y0, bb.x1, bb.y1] + radii + list(_premult(prim.color))
        addr = self.gb.push_f32(payload)
        idx = self.gb.push_instance(KIND_BOX_SHADOW,
                                    self._row(c.spatial_node), addr,
                                    clip_addr, clip_count, BLEND_NORMAL, 0)
        self.metas.push(bbox)
        out.append(idx)

    def _prepare_border(self, prim: NormalBorderPrim, c: PrimCommon,
                        axis_aligned: bool, out: List[int]) -> None:
        """Normal borders, the reference pipeline exactly: the border is
        carved into corner + edge segments (border.rs
        create_border_segments:654), each segment rasterized ONCE into a
        content-keyed cached task with the cs_border_segment.glsl fragment
        program (frame/border_raster.py), then drawn as image segments
        with per-edge repeat (brush SEGMENT_REPEAT_X/Y) — so dot/dash
        placement and corner curve AA match the reference per-texel."""
        import dataclasses as dc

        from . import border_raster as br
        b = prim.border
        w = prim.widths
        r = prim.border.radius
        if w.top <= 0 and w.right <= 0 and w.bottom <= 0 and w.left <= 0:
            return
        rect = self._snap_rect(c.local_rect, c.spatial_node) \
            if axis_aligned else c.local_rect
        W, Hh = rect.w, rect.h
        if W <= 0 or Hh <= 0:
            return
        radii = br.ensure_no_corner_overlap(
            [r.top_left.width, r.top_left.height,
             r.top_right.width, r.top_right.height,
             r.bottom_right.width, r.bottom_right.height,
             r.bottom_left.width, r.bottom_left.height], W, Hh)
        border_desc = {
            "top": (b.top.style.value,
                    (b.top.color.r, b.top.color.g, b.top.color.b,
                     b.top.color.a)),
            "right": (b.right.style.value,
                      (b.right.color.r, b.right.color.g, b.right.color.b,
                       b.right.color.a)),
            "bottom": (b.bottom.style.value,
                       (b.bottom.color.r, b.bottom.color.g,
                        b.bottom.color.b, b.bottom.color.a)),
            "left": (b.left.style.value,
                     (b.left.color.r, b.left.color.g, b.left.color.b,
                      b.left.color.a)),
            "radius": radii,
        }
        do_aa = getattr(b, "do_aa", True)
        brush, segs = br.create_border_segments(
            (W, Hh), border_desc,
            (w.top, w.right, w.bottom, w.left), do_aa)
        if not brush:
            return
        # raster scale: pow2-clamped world scale factors × dpr, capped so
        # no task exceeds MAX_BORDER_RESOLUTION (prepare.rs:529-548)
        H = self._H(c.spatial_node)
        major = math.hypot(float(H[0, 0]), float(H[1, 0])) / self.dpr
        det = abs(float(H[0, 0]) * float(H[1, 1])
                  - float(H[0, 1]) * float(H[1, 0])) / (self.dpr * self.dpr)
        minor = det / major if major > 0 else 0.0
        sw_ = self._clamp_to_scale_factor(major or 1.0)
        sh_ = self._clamp_to_scale_factor(minor or 1.0)
        scale = max(sw_, sh_) * self.dpr
        max_dim = 1.0
        for seg in segs:
            max_dim = max(max_dim, seg["local_task_size"][0],
                          seg["local_task_size"][1])
        scale = min(scale, br.MAX_BORDER_RESOLUTION / max_dim)

        task_keys = {}
        for ti, seg in enumerate(segs):
            lw, lh = seg["local_task_size"]
            cw = max(1, int(math.floor(lw * scale + 0.5)))
            ch = max(1, int(math.floor(lh * scale + 0.5)))
            content_key = ("border_seg", seg["key"], cw, ch,
                           round(scale * 4096))

            def render(seg=seg, cw=cw, ch=ch):
                insts = br.build_border_instances(seg, (cw, ch),
                                                  border_desc, scale)
                texels = br.raster_border_segment(insts, cw, ch)
                return np.clip(np.rint(texels * 255.0), 0,
                               255).astype(np.uint8)
            key = self.resources.get_or_render_source(content_key, cw, ch,
                                                      render)
            task_keys[ti] = (key, cw, ch)
        for bs in brush:
            key, cw, ch = task_keys[bs["task_index"]]
            req = self.resources.request_image(key)
            if req is None:
                continue
            region, desc = req
            bx0, by0, bx1, by1 = bs["rect"]
            dx0, dy0 = rect.x0 + bx0, rect.y0 + by0
            dx1, dy1 = rect.x0 + bx1, rect.y0 + by1
            seg = segs[bs["task_index"]]
            if bs["repeat"] is None:
                t0x, t0y, t1x, t1y = bs["texel"]
                ux = region.x + t0x * cw
                uy = region.y + t0y * ch
                uw = (t1x - t0x) * cw
                uh = (t1y - t0y) * ch
                stretch_w, stretch_h = dx1 - dx0, dy1 - dy0
            else:
                ux, uy = float(region.x), float(region.y)
                uw, uh = float(cw), float(ch)
                stretch_w, stretch_h = seg["local_task_size"]
            if uw <= 0 or uh <= 0 or dx1 <= dx0 or dy1 <= dy0:
                continue
            c2 = dc.replace(c, local_rect=Rect.from_bounds(dx0, dy0,
                                                           dx1, dy1))
            # EdgeAaSegmentMask per segment (border.rs add_corner_segment /
            # add_edge_segment edge_flags): AA only the border's outer
            # edges; interior segment boundaries are hard so degenerate
            # slivers (degenerate-curve.yaml) cover no pixel centers
            emask = {br.SEG_TL: 3, br.SEG_TR: 6, br.SEG_BR: 12,
                     br.SEG_BL: 9, br.SEG_LEFT: 1, br.SEG_TOP: 2,
                     br.SEG_RIGHT: 4, br.SEG_BOTTOM: 8}[seg["segment"]]
            self._emit_image_instance(
                prim, c2, axis_aligned, out, ux, uy, uw, uh,
                stretch_w, stretch_h, 0.0, 0.0, ImageRendering.AUTO,
                ColorF.WHITE,
                img_scale=(uw / max(stretch_w, 1e-6),
                           uh / max(stretch_h, 1e-6)),
                crop_origin=(0.0, 0.0),
                pattern_rect=Rect.from_bounds(dx0, dy0, dx1, dy1),
                snap=False, edge_mask=emask)

    def _nine_patch_source(self, b) -> Optional[Tuple[int, float, float]]:
        """Resolve a nine-patch source to (image key, texture w, texture h).
        Gradient sources rasterize once into a content-keyed texture — the
        render_task_cache.rs role (the reference renders gradient nine-patch
        sources into a cached render task and samples it as an image)."""
        if b.source_kind == "image":
            tpl = self.resources.images.get(b.image_key)
            if tpl is None:
                return None
            return b.image_key, float(tpl.descriptor.width), \
                float(tpl.descriptor.height)
        w, h = int(round(b.width)), int(round(b.height))
        if w <= 0 or h <= 0 or not b.stops:
            return None
        stop_key = tuple((s.offset, s.color.r, s.color.g, s.color.b,
                          s.color.a) for s in b.stops)
        if b.source_kind == "gradient" and b.gradient is not None:
            g = b.gradient
            par = ("lin", g.start_point.x, g.start_point.y, g.end_point.x,
                   g.end_point.y, g.extend_mode.value)
        elif b.source_kind == "radial-gradient" and b.radial_gradient is not None:
            g = b.radial_gradient
            par = ("rad", g.center.x, g.center.y, g.radius.width,
                   g.radius.height, g.start_offset, g.end_offset,
                   g.extend_mode.value)
        elif b.source_kind == "conic-gradient" and b.conic_gradient is not None:
            g = b.conic_gradient
            par = ("con", g.center.x, g.center.y, g.angle, g.start_offset,
                   g.end_offset, g.extend_mode.value)
        else:
            return None
        content_key = ("ninepatch", w, h, par, stop_key)
        key = self.resources.get_or_render_source(
            content_key, w, h,
            lambda: _raster_gradient_source(b.source_kind, g, b.stops, w, h))
        return key, float(w), float(h)

    def _prepare_nine_patch(self, prim: NinePatchBorderPrim, c: PrimCommon,
                            axis_aligned: bool, out: List[int]) -> None:
        """Nine-patch borders (border.rs NinePatchDescriptor::create_segments
        :1307): the source texture is sliced into 4 corners, 4 edges and an
        optional middle; each patch becomes one image instance with the
        brush_image.glsl SEGMENT_REPEAT_*/ROUND/CENTERED stretch math
        evaluated at prepare time."""
        b = prim.border
        w = prim.widths
        src = self._nine_patch_source(b)
        if src is None:
            return
        key, tex_w, tex_h = src
        W = max(float(b.width), 1e-6)
        Hh = max(float(b.height), 1e-6)
        sl = b.slice
        pxf = [0.0, sl.left / W, (W - sl.right) / W, 1.0]
        pyf = [0.0, sl.top / Hh, (Hh - sl.bottom) / Hh, 1.0]
        # snap the outer rect once so patch seams stay aligned; patches
        # then emit snap=False (fractional repeat phases must not re-snap)
        rect = self._snap_rect(c.local_rect, c.spatial_node) \
            if axis_aligned else c.local_rect
        x0, y0, x1, y1 = rect.x0, rect.y0, rect.x1, rect.y1
        ix0, iy0 = x0 + w.left, y0 + w.top
        ix1, iy1 = x1 - w.right, y1 - w.bottom
        ST = RepeatMode.STRETCH
        RE = RepeatMode.REPEAT
        RO = RepeatMode.ROUND
        rh = b.repeat_horizontal
        rv = b.repeat_vertical
        # (dest bounds, uv fractions, repeat_h, repeat_v, is_middle)
        patches = [
            ((x0, y0, ix0, iy0), (pxf[0], pyf[0], pxf[1], pyf[1]), ST, ST, 0),
            ((ix1, y0, x1, iy0), (pxf[2], pyf[0], pxf[3], pyf[1]), ST, ST, 0),
            ((ix1, iy1, x1, y1), (pxf[2], pyf[2], pxf[3], pyf[3]), ST, ST, 0),
            ((x0, iy1, ix0, y1), (pxf[0], pyf[2], pxf[1], pyf[3]), ST, ST, 0),
            ((ix0, y0, ix1, iy0), (pxf[1], pyf[0], pxf[2], pyf[1]), rh, ST, 0),
            ((ix0, iy1, ix1, y1), (pxf[1], pyf[2], pxf[2], pyf[3]), rh, ST, 0),
            ((x0, iy0, ix0, iy1), (pxf[0], pyf[1], pxf[1], pyf[2]), ST, rv, 0),
            ((ix1, iy0, x1, iy1), (pxf[2], pyf[1], pxf[3], pyf[2]), ST, rv, 0),
        ]
        if b.fill:
            patches.append(((ix0, iy0, ix1, iy1),
                            (pxf[1], pyf[1], pxf[2], pyf[2]), rh, rv, 1))
        import dataclasses as dc
        for (dx0, dy0, dx1, dy1), (u0f, v0f, u1f, v1f), mh, mv, mid \
                in patches:
            if u1f <= u0f or v1f <= v0f or dx1 <= dx0 or dy1 <= dy0:
                continue
            seg_w, seg_h = dx1 - dx0, dy1 - dy0
            uvpx_w = (u1f - u0f) * tex_w
            uvpx_h = (v1f - v0f) * tex_h
            stretch_w, stretch_h = seg_w, seg_h
            if mid:
                # brush_image.glsl NINEPATCH_MIDDLE: repeats scale by the
                # corner sizes (top/left, falling back to bottom/right)
                rss = [w.left, w.top]
                h_uv = [uvpx_w, pyf[1] * tex_h]
                if h_uv[1] < 1e-3 or rss[1] < 1e-3:
                    h_uv[1] = (1.0 - pyf[2]) * tex_h
                    rss[1] = w.bottom
                v_uv = [pxf[1] * tex_w, uvpx_h]
                if v_uv[0] < 1e-3 or rss[0] < 1e-3:
                    v_uv[0] = (1.0 - pxf[2]) * tex_w
                    rss[0] = w.right
            else:
                rss = [seg_w, seg_h]
                h_uv = [uvpx_w, uvpx_h]
                v_uv = [uvpx_w, uvpx_h]
            if mh in (RE, RO):
                stretch_w = rss[1] * (h_uv[0] / max(h_uv[1], 1e-6))
            if mv in (RE, RO):
                stretch_h = rss[0] * (v_uv[1] / max(v_uv[0], 1e-6))
            if mh == RO:
                stretch_w = seg_w / max(1.0, round(seg_w /
                                                   max(stretch_w, 1e-6)))
            if mv == RO:
                stretch_h = seg_h / max(1.0, round(seg_h /
                                                   max(stretch_h, 1e-6)))
            # centered repeat: shift the pattern origin so the first tile
            # is centered (brush_image.glsl normalized_offset derivation)
            pox, poy = dx0, dy0
            if mh == RE:
                rep = seg_w / max(stretch_w, 1e-6)
                pox = dx0 - (1.0 - ((rep * 0.5 + 0.5) % 1.0)) * stretch_w
            if mv == RE:
                rep = seg_h / max(stretch_h, 1e-6)
                poy = dy0 - (1.0 - ((rep * 0.5 + 0.5) % 1.0)) * stretch_h
            # source slice rect in texture px → resident atlas crop
            sx0, sy0 = u0f * tex_w, v0f * tex_h
            sx1, sy1 = u1f * tex_w, v1f * tex_h
            req = self.resources.request_image_sub(key, (sx0, sy0, sx1, sy1))
            if req is None:
                continue
            region, _desc, crop_origin = req
            # tight uv rect = the slice rect in atlas coords: the sample
            # clamp must not cross slice boundaries (the crop carries a
            # 1px margin of neighbouring texels)
            ax0 = region.x + (sx0 - crop_origin[0])
            ay0 = region.y + (sy0 - crop_origin[1])
            c2 = dc.replace(c, local_rect=Rect.from_bounds(dx0, dy0,
                                                           dx1, dy1))
            self._emit_image_instance(
                prim, c2, axis_aligned, out, ax0, ay0, uvpx_w, uvpx_h,
                stretch_w, stretch_h, 0.0, 0.0, ImageRendering.AUTO,
                ColorF.WHITE,
                img_scale=(uvpx_w / max(stretch_w, 1e-6),
                           uvpx_h / max(stretch_h, 1e-6)),
                crop_origin=(0.0, 0.0),
                pattern_rect=Rect.from_bounds(pox, poy, dx1, dy1),
                snap=False)


def _resample_image_device(tpl, desc, r, stretch_w, stretch_h, dx0, dy0,
                           dw, dh, sx, sy, tx, ty, nearest) -> np.ndarray:
    """Bilinear/nearest resample of a huge image's visible region at exact
    device pixel centers (the same texel math brush_image/sample_rgba
    would run had the full image been resident).  Returns premultiplied
    (dh, dw, 4) f32."""
    from ..api.image import ImageFormat
    xs = (np.arange(dw, dtype=np.float64) + 0.5 + dx0 - tx) / sx
    ys = (np.arange(dh, dtype=np.float64) + 0.5 + dy0 - ty) / sy
    u = (xs - r.x0) / stretch_w * desc.width
    v = (ys - r.y0) / stretch_h * desc.height
    W, Hh = desc.width, desc.height
    px = tpl.data.pixels
    if desc.format == ImageFormat.R8:
        arr = px.reshape(Hh, W, 1)
    else:
        arr = px.reshape(Hh, W, -1)

    def gather(vi, ui):
        g = arr[np.ix_(vi, ui)].astype(np.float32)
        if desc.format == ImageFormat.BGRA8:
            g = g[..., [2, 1, 0, 3]]
        elif desc.format == ImageFormat.R8:
            a = g[..., 0]
            g = np.stack([a, a, a, np.full_like(a, 255.0)], -1)
        return g

    if nearest:
        ui = np.clip(np.floor(u).astype(np.int64), 0, W - 1)
        vi = np.clip(np.floor(v).astype(np.int64), 0, Hh - 1)
        out = gather(vi, ui)
    else:
        # swgl fixed-point bilinear (patterns.swgl_bilinear_coords):
        # the device kernel samples with 7-bit fracs and truncating
        # lerps, so the host pre-resample must too
        from ..ops.patterns import swgl_bilinear_coords
        uu = np.clip(u, 0.5, max(W - 0.5, 0.5))
        vv = np.clip(v, 0.5, max(Hh - 0.5, 0.5))
        x0i, _, _, fx1, _ = swgl_bilinear_coords(
            np, uu.astype(np.float32), np.zeros_like(uu, np.float32), W, Hh)
        _, y0i, row1, _, fy1 = swgl_bilinear_coords(
            np, np.zeros_like(vv, np.float32), vv.astype(np.float32), W, Hh)
        fx = fx1.astype(np.float32)[None, :, None]
        fy = fy1.astype(np.float32)[:, None, None]
        x0i = x0i.astype(np.int64)
        y0i = y0i.astype(np.int64)
        x1i = np.clip(x0i + 1, 0, W - 1)
        y1i = y0i + row1.astype(np.int64)
        t00 = gather(y0i, x0i)
        t10 = gather(y0i, x1i)
        t01 = gather(y1i, x0i)
        t11 = gather(y1i, x1i)
        a_ = t00 + np.floor((t01 - t00) * fy * np.float32(1.0 / 128.0))
        b_ = t10 + np.floor((t11 - t10) * fy * np.float32(1.0 / 128.0))
        out = a_ + np.floor((b_ - a_) * fx * np.float32(1.0 / 128.0))
    scale = np.float32(1.0 / 255.0)
    if desc.format == ImageFormat.RGBAF32:
        scale = np.float32(1.0)
    return (out * scale).astype(np.float32)


def _raster_gradient_source(kind: str, g, stops, w: int, h: int) -> np.ndarray:
    """Rasterize a gradient to a premultiplied (h, w, 4) u8 texture using
    the shared pattern math (the reference renders nine-patch gradient
    sources into an RGBA8 render task — render_task_cache.rs; u8
    quantization deliberately matches that task format)."""
    from ..ops.raster import _py_fori
    from ..ops import patterns as pk
    recs = gradient_stops_records(stops)
    f32 = np.ascontiguousarray(recs.reshape(-1), np.float32)
    n = recs.shape[0]
    yy, xx = np.mgrid[0:h, 0:w]
    lx = (xx + 0.5).astype(np.float32)
    ly = (yy + 0.5).astype(np.float32)
    p = np.zeros(26, np.float32)
    p[0:4] = (0.0, 0.0, w, h)
    p[12] = 0.0
    p[13] = float(g.extend_mode.value)
    p[14] = float(n)
    if kind == "gradient":
        p[8:12] = (g.start_point.x, g.start_point.y,
                   g.end_point.x, g.end_point.y)
        p[16:18] = (w, h)
        col = pk.pattern_linear_gradient(np, _py_fori, p, lx, ly, f32)
    elif kind == "radial-gradient":
        p[8:12] = (g.center.x, g.center.y, g.radius.width, g.radius.height)
        p[16:18] = (g.start_offset, g.end_offset)
        p[18:20] = (w, h)
        col = pk.pattern_radial_gradient(np, _py_fori, p, lx, ly, f32)
    else:
        p[8:11] = (g.center.x, g.center.y, g.angle)
        p[16:18] = (g.start_offset, g.end_offset)
        p[18:20] = (w, h)
        col = pk.pattern_conic_gradient(np, _py_fori, p, lx, ly, f32)
    return np.clip(np.round(col.transpose(1, 2, 0) * 255.0),
                   0, 255).astype(np.uint8)


def _premult(color: ColorF) -> Tuple[float, float, float, float]:
    """Premultiplied color quantized to the u8 grid — the reference's
    vertex colors live in RGBA8 (0.5·black premultiplies to 128/255, not
    127.5/255; text/transparent-no-aa.yaml) while our framebuffer is f32."""
    r, g, b, a = color.premultiplied()
    q = 1.0 / 255.0
    return (round(r * 255.0) * q, round(g * 255.0) * q,
            round(b * 255.0) * q, round(a * 255.0) * q)


# --- color matrices for CSS filters (straight-alpha 4x5, row major) --------

def _filter_color_matrix(kind: FilterOpKind, f) -> Optional[np.ndarray]:
    v = f.value
    m = np.zeros((4, 5), np.float32)
    if kind == FilterOpKind.GRAYSCALE:
        a = 1.0 - min(v, 1.0)
        m[0, 0:3] = [0.2126 + 0.7874 * a, 0.7152 - 0.7152 * a, 0.0722 - 0.0722 * a]
        m[1, 0:3] = [0.2126 - 0.2126 * a, 0.7152 + 0.2848 * a, 0.0722 - 0.0722 * a]
        m[2, 0:3] = [0.2126 - 0.2126 * a, 0.7152 - 0.7152 * a, 0.0722 + 0.9278 * a]
        m[3, 3] = 1.0
    elif kind == FilterOpKind.SEPIA:
        a = 1.0 - min(v, 1.0)
        m[0, 0:3] = [0.393 + 0.607 * a, 0.769 - 0.769 * a, 0.189 - 0.189 * a]
        m[1, 0:3] = [0.349 - 0.349 * a, 0.686 + 0.314 * a, 0.168 - 0.168 * a]
        m[2, 0:3] = [0.272 - 0.272 * a, 0.534 - 0.534 * a, 0.131 + 0.869 * a]
        m[3, 3] = 1.0
    elif kind == FilterOpKind.SATURATE:
        s = v
        m[0, 0:3] = [0.213 + 0.787 * s, 0.715 - 0.715 * s, 0.072 - 0.072 * s]
        m[1, 0:3] = [0.213 - 0.213 * s, 0.715 + 0.285 * s, 0.072 - 0.072 * s]
        m[2, 0:3] = [0.213 - 0.213 * s, 0.715 - 0.715 * s, 0.072 + 0.928 * s]
        m[3, 3] = 1.0
    elif kind == FilterOpKind.HUE_ROTATE:
        rad = math.radians(v)
        cos, sin = math.cos(rad), math.sin(rad)
        m[0, 0:3] = [0.213 + cos * 0.787 - sin * 0.213,
                     0.715 - cos * 0.715 - sin * 0.715,
                     0.072 - cos * 0.072 + sin * 0.928]
        m[1, 0:3] = [0.213 - cos * 0.213 + sin * 0.143,
                     0.715 + cos * 0.285 + sin * 0.140,
                     0.072 - cos * 0.072 - sin * 0.283]
        m[2, 0:3] = [0.213 - cos * 0.213 - sin * 0.787,
                     0.715 - cos * 0.715 + sin * 0.715,
                     0.072 + cos * 0.928 + sin * 0.072]
        m[3, 3] = 1.0
    elif kind == FilterOpKind.INVERT:
        i = min(v, 1.0)
        m[0, 0] = m[1, 1] = m[2, 2] = 1.0 - 2.0 * i
        m[0, 4] = m[1, 4] = m[2, 4] = i
        m[3, 3] = 1.0
    elif kind == FilterOpKind.BRIGHTNESS:
        m[0, 0] = m[1, 1] = m[2, 2] = v
        m[3, 3] = 1.0
    elif kind == FilterOpKind.CONTRAST:
        m[0, 0] = m[1, 1] = m[2, 2] = v
        m[0, 4] = m[1, 4] = m[2, 4] = 0.5 - 0.5 * v
        m[3, 3] = 1.0
    elif kind == FilterOpKind.COLOR_MATRIX:
        # FilterOp::ColorMatrix is column-major 5x4: groups of 4 are the
        # output coefficients of inputs (r, g, b, a, offset)
        # (filter-color-matrix.yaml expectations)
        m = np.asarray(f.matrix, np.float32).reshape(5, 4).T
    else:
        return None
    return m


def _component_transfer_lut(fd) -> np.ndarray:
    """Bake SVG feComponentTransfer functions into a [4, 256] LUT
    (display_item.rs FilterData / cs_svg_filter ComponentTransfer)."""
    from ..api.display_item import ComponentTransferFuncType as F
    x = np.linspace(0.0, 1.0, 256, dtype=np.float64)
    out = np.zeros((4, 256), np.float32)
    chans = [(fd.func_r, fd.values_r), (fd.func_g, fd.values_g),
             (fd.func_b, fd.values_b), (fd.func_a, fd.values_a)]
    for i, (func, vals) in enumerate(chans):
        v = [float(t) for t in vals]
        if func == F.IDENTITY or (func in (F.TABLE, F.DISCRETE) and not v):
            y = x
        elif func == F.TABLE:
            if len(v) == 1:
                y = np.full_like(x, v[0])
            else:
                n = len(v) - 1
                k = np.clip(np.floor(x * n).astype(int), 0, n - 1)
                y = np.array(v)[k] + (x * n - k) * (np.array(v)[k + 1] -
                                                    np.array(v)[k])
        elif func == F.DISCRETE:
            n = len(v)
            k = np.clip(np.floor(x * n).astype(int), 0, n - 1)
            y = np.array(v)[k]
        elif func == F.LINEAR:
            slope = v[0] if len(v) > 0 else 1.0
            intercept = v[1] if len(v) > 1 else 0.0
            y = slope * x + intercept
        elif func == F.GAMMA:
            amp = v[0] if len(v) > 0 else 1.0
            exp = v[1] if len(v) > 1 else 1.0
            off = v[2] if len(v) > 2 else 0.0
            y = amp * np.power(x, exp) + off
        else:
            y = x
        out[i] = np.clip(y, 0.0, 1.0).astype(np.float32)
    return out


def _srgb_lut(to_linear: bool) -> np.ndarray:
    """srgb-to-linear / linear-to-srgb filters as channel LUTs."""
    x = np.linspace(0.0, 1.0, 256, dtype=np.float64)
    if to_linear:
        y = np.where(x <= 0.04045, x / 12.92,
                     np.power((x + 0.055) / 1.055, 2.4))
    else:
        y = np.where(x <= 0.0031308, x * 12.92,
                     1.055 * np.power(x, 1.0 / 2.4) - 0.055)
    lut = np.zeros((4, 256), np.float32)
    lut[:3] = np.clip(y, 0.0, 1.0)
    lut[3] = x
    return lut


def _compose_channel_lut(l2: np.ndarray, l1: np.ndarray) -> np.ndarray:
    """Apply l1 then l2."""
    idx = np.clip(np.rint(l1 * 255.0).astype(int), 0, 255)
    out = np.zeros_like(l1)
    for c in range(4):
        out[c] = l2[c][idx[c]]
    return out


def _compose_color_matrix(m2: np.ndarray, m1: np.ndarray) -> np.ndarray:
    """Apply m1 first, then m2 (both 4x5 affine color transforms)."""
    a1 = np.eye(5, dtype=np.float32)
    a1[:4, :] = m1
    a2 = np.eye(5, dtype=np.float32)
    a2[:4, :] = m2
    return (a2 @ a1)[:4, :]
