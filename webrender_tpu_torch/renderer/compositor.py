"""Compositor abstraction — `composite.rs` CompositorKind / Compositor
trait (:357/:1152) + the SWGL `compositor/sw_compositor.rs` role.

The reference hands picture-cache tiles either to its own draw pass
("Draw" compositing) or to an OS compositor through the `Compositor`
trait (DirectComposition / CoreAnimation / Wayland in example-compositor).
Here the same seam exists so an embedder can take over final composition:
the renderer's tile grid maps onto `CompositorSurface` tiles; the default
`DrawCompositor` assembles them exactly like the internal path, and
`SwCompositor` composites on the host with band parallelism (the
sw_compositor.rs thread-pool design collapsed onto a ThreadPoolExecutor).

Partial present (composite.rs:1195-1294 tile protocol +
PartialPresentCompositor :1366): tiles are created/destroyed/invalidated
explicitly; `start_compositing` receives the frame's dirty rects, the
compositor re-composites ONLY the damaged region into its retained
buffer, and the union damage is exposed via `buffer_damage_region` (what
the reference hands to eglSwapBuffersWithDamage / set_buffer_damage_region).
"""
from __future__ import annotations

import concurrent.futures
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Tuple

import numpy as np

Rect4 = Tuple[int, int, int, int]          # x0, y0, x1, y1 (exclusive)


@dataclass
class CompositorSurface:
    """composite.rs NativeSurface: an id + tile grid of premultiplied
    RGBA8 tiles."""
    surface_id: int
    tile_size: Tuple[int, int]
    is_opaque: bool = True
    tiles: Dict[Tuple[int, int], np.ndarray] = field(default_factory=dict)


class Compositor(Protocol):
    """composite.rs Compositor trait (:1152) — the subset that matters for
    a single-window software embedder, including the partial-present
    tile invalidation protocol."""

    def create_surface(self, surface_id: int, tile_size: Tuple[int, int],
                       is_opaque: bool) -> None: ...

    def destroy_surface(self, surface_id: int) -> None: ...

    def create_tile(self, surface_id: int, x: int, y: int) -> None: ...

    def destroy_tile(self, surface_id: int, x: int, y: int) -> None: ...

    def invalidate_tile(self, surface_id: int, x: int, y: int,
                        valid_rect: Optional[Rect4] = None) -> None: ...

    def set_tile(self, surface_id: int, x: int, y: int,
                 texels: np.ndarray) -> None: ...

    def add_surface(self, surface_id: int,
                    offset: Tuple[int, int]) -> None: ...

    def begin_frame(self) -> None: ...

    def start_compositing(self, dirty_rects: Optional[List[Rect4]]
                          ) -> None: ...

    def composite(self, output_size: Tuple[int, int]) -> np.ndarray: ...

    def end_frame(self) -> None: ...


class DrawCompositor:
    """CompositorKind::Draw — tiles assemble into one framebuffer, the
    renderer's own composition path, with partial present: an explicit
    dirty-rect list (or accumulated tile invalidations) limits the
    recomposite to the damaged region of the retained buffer."""

    def __init__(self):
        self.surfaces: Dict[int, CompositorSurface] = {}
        self.order: List[Tuple[int, Tuple[int, int]]] = []
        self._retained: Optional[np.ndarray] = None
        self._prev_order: Optional[List] = None
        # damage accumulated since the last composite: None = unknown →
        # full composite (the draw_previous_partial_present_regions=False
        # startup state, composite.rs:301)
        self._damage: Optional[List[Rect4]] = None
        self._explicit_dirty: Optional[List[Rect4]] = None
        # what end_frame would hand to set_buffer_damage_region
        # (PartialPresentCompositor, composite.rs:1366-1371)
        self.buffer_damage_region: Optional[List[Rect4]] = None

    # -- surface / tile lifecycle (composite.rs:1195-1223) ----------------
    def create_surface(self, surface_id, tile_size, is_opaque=True):
        self.surfaces[surface_id] = CompositorSurface(surface_id, tile_size,
                                                      is_opaque)
        self._damage = None

    def destroy_surface(self, surface_id):
        self.surfaces.pop(surface_id, None)
        self._damage = None

    def create_tile(self, surface_id, x, y):
        surf = self.surfaces[surface_id]
        tw, th = surf.tile_size
        surf.tiles.setdefault((x, y), np.zeros((th, tw, 4), np.uint8))
        self._note_tile_damage(surface_id, x, y)

    def destroy_tile(self, surface_id, x, y):
        self.surfaces[surface_id].tiles.pop((x, y), None)
        self._note_tile_damage(surface_id, x, y)

    def invalidate_tile(self, surface_id, x, y, valid_rect=None):
        """composite.rs:1223 — mark a tile's content stale; valid_rect
        (tile-local) bounds the damage when given."""
        surf = self.surfaces.get(surface_id)
        if surf is None:
            return
        tw, th = surf.tile_size
        if valid_rect is None:
            valid_rect = (0, 0, tw, th)
        self._note_tile_damage(surface_id, x, y, valid_rect)

    def _note_tile_damage(self, surface_id, x, y, local: Rect4 = None):
        surf = self.surfaces.get(surface_id)
        if surf is None or self._damage is None and self._retained is None:
            return
        tw, th = surf.tile_size
        lx0, ly0, lx1, ly1 = local or (0, 0, tw, th)
        # device position is only known once add_surface supplies the
        # offset — record tile-space damage, resolved in composite()
        if self._damage is None:
            self._damage = []
        self._damage.append(("tile", surface_id, x, y,
                             (lx0, ly0, lx1, ly1)))

    def set_tile(self, surface_id, x, y, texels):
        self.surfaces[surface_id].tiles[(x, y)] = texels
        # damage must cover the composited extent: composition uses
        # texels.shape, which may exceed the surface's nominal tile_size
        self._note_tile_damage(surface_id, x, y,
                               (0, 0, texels.shape[1], texels.shape[0]))

    def add_surface(self, surface_id, offset=(0, 0)):
        self.order.append((surface_id, offset))

    # -- frame protocol (composite.rs:1257-1294) ---------------------------
    def begin_frame(self):
        self._explicit_dirty = None

    def start_compositing(self, dirty_rects=None):
        """composite.rs:1283 — the renderer announces this frame's damage
        (device-space rects); None means unknown → full composite."""
        self._explicit_dirty = (list(dirty_rects)
                                if dirty_rects is not None else None)

    def end_frame(self):
        pass

    # -- composition --------------------------------------------------------
    def _resolve_damage(self, order, w, h) -> Optional[List[Rect4]]:
        if self._explicit_dirty is not None:
            return [(max(0, x0), max(0, y0), min(w, x1), min(h, y1))
                    for (x0, y0, x1, y1) in self._explicit_dirty]
        if self._damage is None:
            return None
        offs = {}
        for sid, off in order:
            offs[sid] = off
        out = []
        for kind, sid, x, y, (lx0, ly0, lx1, ly1) in self._damage:
            surf = self.surfaces.get(sid)
            if surf is None or sid not in offs:
                return None           # damage on an unplaced surface
            ox, oy = offs[sid]
            tw, th = surf.tile_size
            x0 = ox + x * tw + lx0
            y0 = oy + y * th + ly0
            out.append((max(0, x0), max(0, y0),
                        min(w, ox + x * tw + lx1),
                        min(h, oy + y * th + ly1)))
        return out

    def _composite_region(self, out, order, rx0, ry0, rx1, ry1):
        for sid, (ox, oy) in order:
            surf = self.surfaces[sid]
            tw, th = surf.tile_size
            for (tx, ty), texels in surf.tiles.items():
                x0 = max(ox + tx * tw, rx0)
                y0 = max(oy + ty * th, ry0)
                x1 = min(ox + tx * tw + texels.shape[1], rx1)
                y1 = min(oy + ty * th + texels.shape[0], ry1)
                if x1 <= x0 or y1 <= y0:
                    continue
                src = texels[y0 - (oy + ty * th): y1 - (oy + ty * th),
                             x0 - (ox + tx * tw): x1 - (ox + tx * tw)]
                if surf.is_opaque:
                    out[y0:y1, x0:x1] = src
                else:
                    a = src[..., 3:4].astype(np.uint16)
                    dst = out[y0:y1, x0:x1].astype(np.uint16)
                    out[y0:y1, x0:x1] = (
                        src + (dst * (255 - a) + 127) // 255
                    ).astype(np.uint8)

    def composite(self, output_size):
        w, h = output_size
        order = list(self.order)
        self.order.clear()
        damage = self._resolve_damage(order, w, h)
        partial_ok = (self._retained is not None
                      and self._retained.shape == (h, w, 4)
                      and self._prev_order == order
                      and damage is not None)
        if partial_ok:
            out = self._retained
            for (x0, y0, x1, y1) in damage:
                if x1 > x0 and y1 > y0:
                    # opaque root: clear then re-draw the damaged region
                    out[y0:y1, x0:x1] = 0
                    self._composite_region(out, order, x0, y0, x1, y1)
            self.buffer_damage_region = [
                d for d in damage if d[2] > d[0] and d[3] > d[1]]
        else:
            out = np.zeros((h, w, 4), np.uint8)
            self._composite_region(out, order, 0, 0, w, h)
            self.buffer_damage_region = [(0, 0, w, h)]
        self._retained = out
        self._prev_order = order
        self._damage = []
        self._explicit_dirty = None
        # callers get a snapshot: the retained buffer is mutated in place
        # by the next partial composite (frame N's result must not change
        # under a double-buffering/diffing embedder)
        return out.copy()


class SwCompositor(DrawCompositor):
    """sw_compositor.rs: composite independent horizontal bands on worker
    threads (the tile-band parallelism of slice §2.7.6)."""

    def __init__(self, workers: int = 4):
        super().__init__()
        self._pool = concurrent.futures.ThreadPoolExecutor(workers)
        self.workers = workers

    def composite(self, output_size):
        w, h = output_size
        order = list(self.order)
        self.order.clear()
        damage = self._resolve_damage(order, w, h)
        partial_ok = (self._retained is not None
                      and self._retained.shape == (h, w, 4)
                      and self._prev_order == order
                      and damage is not None)
        if partial_ok:
            out = self._retained
            for (x0, y0, x1, y1) in damage:
                if x1 > x0 and y1 > y0:
                    out[y0:y1, x0:x1] = 0
                    self._composite_region(out, order, x0, y0, x1, y1)
            self.buffer_damage_region = [
                d for d in damage if d[2] > d[0] and d[3] > d[1]]
            self._retained = out
            self._prev_order = order
            self._damage = []
            self._explicit_dirty = None
            return out.copy()
        out = np.zeros((h, w, 4), np.uint8)
        band_h = max(1, -(-h // self.workers))

        def run_band(b):
            y_lo = b * band_h
            y_hi = min(y_lo + band_h, h)
            if y_hi > y_lo:
                self._composite_region(out, order, 0, y_lo, w, y_hi)

        list(self._pool.map(run_band, range(self.workers)))
        self.buffer_damage_region = [(0, 0, w, h)]
        self._retained = out
        self._prev_order = order
        self._damage = []
        self._explicit_dirty = None
        return out.copy()
