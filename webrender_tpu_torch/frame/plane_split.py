"""BSP plane splitting for preserve-3d contexts.

The role of the reference's `plane-split` crate (used by `picture.rs`
PlaneSplitter; fragments drawn by `ps_split_composite`): intersecting 3D
planes are cut against each other and emitted as painter-ordered convex
fragments.  Polygons live in device space — x, y in device pixels after
projection, z the interpolated depth — so the resulting 2D fragments can be
applied directly as device-space convex-polygon clips on the plane's
instances (frame_builder._split_planes).

The viewer looks along +z after projection (smaller z is nearer): the BSP
traversal emits back-to-front for a view ray of (0, 0, 1).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# distances are in device pixels; fragments thinner than this are dropped
EPS = 1e-4


class Polygon:
    __slots__ = ("pts", "anchor", "was_split")

    def __init__(self, pts: np.ndarray, anchor: int, was_split: bool = False):
        self.pts = np.asarray(pts, np.float64)   # [n, 3] convex, wound
        self.anchor = anchor                      # caller tag (child index)
        self.was_split = was_split


def plane_of(pts: np.ndarray) -> Optional[Tuple[np.ndarray, float]]:
    """Unit plane (normal, d) with n·p + d = 0, via Newell's method.
    None for degenerate (zero-area) polygons."""
    n = np.zeros(3, np.float64)
    m = len(pts)
    for i in range(m):
        a = pts[i]
        b = pts[(i + 1) % m]
        n[0] += (a[1] - b[1]) * (a[2] + b[2])
        n[1] += (a[2] - b[2]) * (a[0] + b[0])
        n[2] += (a[0] - b[0]) * (a[1] + b[1])
    ln = float(np.linalg.norm(n))
    if ln < EPS:
        return None
    n /= ln
    return n, -float(np.dot(n, pts[0]))


def _clip_side(pts: np.ndarray, dist: np.ndarray, keep_positive: bool
               ) -> Optional[np.ndarray]:
    """Keep the side of the polygon where dist >= 0 (or <= 0)."""
    s = dist if keep_positive else -dist
    out: List[np.ndarray] = []
    m = len(pts)
    for i in range(m):
        j = (i + 1) % m
        if s[i] >= -EPS:
            out.append(pts[i])
        if (s[i] > EPS and s[j] < -EPS) or (s[i] < -EPS and s[j] > EPS):
            t = s[i] / (s[i] - s[j])
            out.append(pts[i] + (pts[j] - pts[i]) * t)
    if len(out) < 3:
        return None
    arr = np.asarray(out)
    # drop slivers
    if plane_of(arr) is None:
        return None
    return arr


def split_polygon(poly: Polygon, normal: np.ndarray, d: float
                  ) -> Tuple[Optional[Polygon], Optional[Polygon], bool]:
    """→ (front piece, back piece, is_coplanar)."""
    dist = poly.pts @ normal + d
    if np.all(np.abs(dist) <= EPS):
        return None, None, True
    if np.all(dist >= -EPS):
        return poly, None, False
    if np.all(dist <= EPS):
        return None, poly, False
    f = _clip_side(poly.pts, dist, True)
    b = _clip_side(poly.pts, dist, False)
    front = Polygon(f, poly.anchor, True) if f is not None else None
    back = Polygon(b, poly.anchor, True) if b is not None else None
    return front, back, False


class BspNode:
    __slots__ = ("normal", "d", "polys", "front", "back")

    def __init__(self):
        self.normal: Optional[np.ndarray] = None
        self.d = 0.0
        self.polys: List[Polygon] = []
        self.front: Optional[BspNode] = None
        self.back: Optional[BspNode] = None

    def insert(self, poly: Polygon) -> None:
        if self.normal is None:
            pl = plane_of(poly.pts)
            if pl is None:
                return
            self.normal, self.d = pl
            self.polys.append(poly)
            return
        front, back, coplanar = split_polygon(poly, self.normal, self.d)
        if coplanar:
            self.polys.append(poly)
            return
        if front is not None:
            if self.front is None:
                self.front = BspNode()
            self.front.insert(front)
        if back is not None:
            if self.back is None:
                self.back = BspNode()
            self.back.insert(back)

    def order(self, view_z: float, out: List[Polygon]) -> None:
        """Painter (back-to-front) traversal for a viewer looking along
        (0, 0, view_z); the viewer sits on the side where n·p + d has the
        sign of -n_z·view_z."""
        if self.normal is None:
            return
        viewer_positive = (self.normal[2] * view_z) > 0
        first, second = (self.back, self.front) if viewer_positive \
            else (self.front, self.back)
        if first is not None:
            first.order(view_z, out)
        out.extend(self.polys)
        if second is not None:
            second.order(view_z, out)


def split_planes(polys: List[Polygon], view_z: float = 1.0) -> List[Polygon]:
    """Insert polygons in paint order and return painter-ordered convex
    fragments (back-to-front for the given view direction)."""
    root = BspNode()
    for p in polys:
        root.insert(p)
    out: List[Polygon] = []
    root.order(view_z, out)
    return out
