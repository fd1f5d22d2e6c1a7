"""Texture atlas allocators.

Mirrors `webrender/src/texture_pack/` (etagere shelf allocation re-exported at
mod.rs:19-21): a shelf allocator with per-region free for persistent caches
(images, glyphs — the texture_cache.rs eviction flow needs individual
deallocation), and a growable row packer for per-frame surface allocation.
Allocation is host-side only; the actual texels live in HBM-resident arrays
owned by the renderer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class AtlasRegion:
    x: int
    y: int
    w: int
    h: int


class AtlasFullError(RuntimeError):
    """Raised when an allocation cannot be satisfied even after eviction —
    the RendererError::OutOfMemory analog (renderer/init.rs:908); the
    backend responds by clearing caches and rebuilding the frame
    (renderer/mod.rs:1289)."""


class SurfaceAtlasFullError(AtlasFullError):
    """The per-frame surface atlas (render targets) is exhausted.  Unlike
    texture-cache OOM, clearing resource caches cannot shrink per-frame
    surface demand — the backend instead grows the atlas cap and enables
    emergency region aliasing, then rebuilds the frame
    (render_task_graph.rs target allocation is effectively unbounded;
    renderer/mod.rs:1289 retries rather than crashing)."""


class _Shelf:
    __slots__ = ("y", "h", "cursor", "live", "free_spans")

    def __init__(self, y: int, h: int):
        self.y = y
        self.h = h
        self.cursor = 0
        self.live = 0
        self.free_spans: List[Tuple[int, int]] = []  # (x, w), sorted by x


class ShelfAllocator:
    """Shelf (strip) packer in the spirit of etagere's ShelfAllocator:
    allocations grouped into horizontal shelves by height bucket.  Regions
    can be freed individually (`free`); freed spans coalesce with neighbors
    and are reused by later allocations — the eviction mechanism of
    `texture_cache.rs:562` depends on this."""

    def __init__(self, width: int, height: int, align: int = 8):
        self.width = width
        self.height = height
        self.align = align
        self.shelves: List[_Shelf] = []
        self.next_y = 0

    def _round(self, v: int) -> int:
        a = self.align
        return (v + a - 1) // a * a

    def alloc(self, w: int, h: int) -> Optional[AtlasRegion]:
        w = self._round(max(1, w))
        h_r = self._round(max(1, h))
        best = None
        best_span = None
        for shelf in self.shelves:
            if not (h_r <= shelf.h <= h_r * 2):
                continue
            # prefer reusing a freed span (best fit), then the cursor
            for i, (sx, sw) in enumerate(shelf.free_spans):
                if sw >= w and (best_span is None or sw < best_span[2]):
                    best, best_span = shelf, (i, sx, sw)
            if best_span is None and shelf.cursor + w <= self.width:
                if best is None or shelf.h < best.h:
                    best = shelf
        if best is None:
            if self.next_y + h_r > self.height:
                return None
            best = _Shelf(self.next_y, h_r)
            self.shelves.append(best)
            self.next_y += h_r
        if best_span is not None:
            i, sx, sw = best_span
            if sw == w:
                best.free_spans.pop(i)
            else:
                best.free_spans[i] = (sx + w, sw - w)
            best.live += 1
            return AtlasRegion(sx, best.y, w, h)
        region = AtlasRegion(best.cursor, best.y, w, h)
        best.cursor += w
        best.live += 1
        return region

    def free(self, region: AtlasRegion) -> None:
        """Return a region's span to its shelf; coalesces with adjacent
        free spans, resets the shelf when it empties."""
        w = self._round(max(1, region.w))
        for shelf in self.shelves:
            if shelf.y == region.y or \
                    (shelf.y <= region.y < shelf.y + shelf.h):
                shelf.live -= 1
                if shelf.live <= 0:
                    shelf.cursor = 0
                    shelf.live = 0
                    shelf.free_spans = []
                    self._pop_empty_tail()
                    return
                if region.x + w >= shelf.cursor:
                    shelf.cursor = region.x
                    # the cursor retreat may expose trailing free spans
                    while shelf.free_spans and \
                            shelf.free_spans[-1][0] + \
                            shelf.free_spans[-1][1] >= shelf.cursor:
                        sx, _ = shelf.free_spans.pop()
                        shelf.cursor = sx
                    return
                spans = shelf.free_spans
                spans.append((region.x, w))
                spans.sort()
                merged: List[Tuple[int, int]] = []
                for sx, sw in spans:
                    if merged and merged[-1][0] + merged[-1][1] >= sx:
                        px, pw = merged[-1]
                        merged[-1] = (px, max(pw, sx + sw - px))
                    else:
                        merged.append((sx, sw))
                shelf.free_spans = merged
                return

    def _pop_empty_tail(self) -> None:
        while self.shelves and self.shelves[-1].live == 0:
            shelf = self.shelves.pop()
            self.next_y = shelf.y

    def clear(self):
        self.shelves = []
        self.next_y = 0


class FrameAtlas:
    """Per-frame transient allocator (surface atlas): reset every frame,
    rows packed greedily.  The height is soft — allocations may extend past
    the renderer's current surface-array height up to `max_height`; the
    renderer grows the HBM array to `used_height` before executing passes
    (the target-reuse role of `render_task_graph.rs:800`, traded for HBM
    headroom: surfaces live only within a frame and the array is bucketed
    to powers of two)."""

    MAX_HEIGHT = 16384
    # absolute emergency ceiling for the OOM-recovery ladder (4096-wide f32
    # RGBA → 4 GiB; only reachable via repeated SurfaceAtlasFullError
    # recovery on pathological content)
    ABS_MAX_HEIGHT = 65536

    def __init__(self, width: int, height: int, align: int = 8,
                 max_height: Optional[int] = None):
        self.width = width
        self.height = height          # soft target (initial array height)
        self.max_height = max_height or self.MAX_HEIGHT
        # emergency aliasing: reuse any released region that fits, with no
        # waste bound (set by the backend's surface-OOM recovery)
        self.emergency = False
        self.align = align
        self.clear()

    def clear(self):
        self.cur_x = 0
        self.cur_y = 0
        self.row_h = 0
        # region aliasing (render_task_graph.rs:800 assign_free_pass role):
        # regions whose READERS' passes have all been emitted are released
        # and reused by later allocations — any reuser's write pass is
        # emitted (and therefore executes) after every released reader
        self._live = {}
        self._free = []

    @property
    def used_height(self) -> int:
        return self.cur_y + self.row_h

    def alloc(self, w: int, h: int) -> Optional[AtlasRegion]:
        a = self.align
        w = min((max(1, w) + a - 1) // a * a, self.width)
        h = (max(1, h) + a - 1) // a * a
        # best-fit reuse of a released region (bounded waste)
        best = -1
        best_area = None
        for i, (fx, fy, fw, fh) in enumerate(self._free):
            if fw >= w and fh >= h and \
                    (self.emergency or fw * fh <= 4 * w * h):
                if best_area is None or fw * fh < best_area:
                    best, best_area = i, fw * fh
        if best >= 0:
            fx, fy, fw, fh = self._free.pop(best)
            self._live[(fx, fy)] = (fw, fh)
            return AtlasRegion(fx, fy, w, h)
        if self.cur_x + w > self.width:
            self.cur_y += self.row_h
            self.cur_x = 0
            self.row_h = 0
        if self.cur_y + h > self.max_height:
            raise SurfaceAtlasFullError(
                f"surface atlas exhausted ({self.cur_y + h} rows needed, "
                f"cap {self.max_height})")
        region = AtlasRegion(self.cur_x, self.cur_y, w, h)
        self._live[(region.x, region.y)] = (w, h)
        self.cur_x += w
        self.row_h = max(self.row_h, h)
        return region

    def free(self, region: AtlasRegion) -> None:
        """Release a region once every pass reading it has been emitted
        (idempotent; unknown regions are ignored)."""
        rect = self._live.pop((region.x, region.y), None)
        if rect is not None:
            self._free.append((region.x, region.y, rect[0], rect[1]))
