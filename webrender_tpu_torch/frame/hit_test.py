"""Hit testing — mirrors `webrender/src/hit_test.rs` (HitTester :281).

The hit tester is rebuilt whenever a scene is built, from the display list's
HitTest items: each carries a local rect, spatial node, clip chain, and a
(u64, u16) tag. `hit_test(point)` walks items front-to-back, inverse-maps
the world point into each item's local space, and tests rect + clip
containment.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api.display_item import ClipMode
from ..api.units import Point2D, Rect, Transform
from ..scene.clip import ClipKind
from ..scene.scene import BuiltScene


@dataclass(frozen=True)
class HitTestResultItem:
    """hit_test.rs HitTestItem."""
    tag: Tuple[int, int]
    point_in_viewport: Point2D
    point_relative_to_item: Point2D


class HitTester:
    """Built per scene (hit_test.rs HitTester::new), shared with the API
    thread in the reference (SharedHitTester); here plain and immutable."""

    def __init__(self, scene: BuiltScene,
                 scroll_offsets: Optional[Dict] = None,
                 properties: Optional[Dict] = None):
        self.scene = scene
        self.resolved = scene.spatial_tree.resolve(
            scroll_offsets=scroll_offsets,
            transform_properties=properties)
        self._inverses: Dict[int, Optional[np.ndarray]] = {}

    def _inverse(self, spatial: int) -> Optional[np.ndarray]:
        inv = self._inverses.get(spatial, False)
        if inv is not False:
            return inv
        m = np.array(self.resolved[spatial].world.m,
                     dtype=np.float64).reshape(4, 4)
        H = np.array([[m[0, 0], m[0, 1], m[0, 3]],
                      [m[1, 0], m[1, 1], m[1, 3]],
                      [m[3, 0], m[3, 1], m[3, 3]]])
        try:
            inv = np.linalg.inv(H)
        except np.linalg.LinAlgError:
            inv = None
        self._inverses[spatial] = inv
        return inv

    def _to_local(self, spatial: int, p: Point2D) -> Optional[Point2D]:
        inv = self._inverse(spatial)
        if inv is None:
            return None
        v = np.array([p.x, p.y, 1.0]) @ inv
        if abs(v[2]) < 1e-9:
            return None
        return Point2D(v[0] / v[2], v[1] / v[2])

    def _clip_contains(self, clip_chain: Tuple[int, ...], p: Point2D) -> bool:
        for idx in clip_chain:
            node = self.scene.clip_store.nodes[idx]
            lp = self._to_local(node.spatial_node, p)
            if lp is None:
                return False
            inside = node.rect.contains(lp)
            if inside and node.kind == ClipKind.ROUNDED_RECT:
                inside = self._rounded_contains(node, lp)
            if node.mode == ClipMode.CLIP_OUT:
                if inside:
                    return False
            elif not inside:
                return False
        return True

    @staticmethod
    def _rounded_contains(node, p: Point2D) -> bool:
        r = node.rect
        rad = node.radii
        corners = [
            (r.x0 + rad.top_left.width, r.y0 + rad.top_left.height,
             rad.top_left, -1, -1),
            (r.x1 - rad.top_right.width, r.y0 + rad.top_right.height,
             rad.top_right, 1, -1),
            (r.x1 - rad.bottom_right.width, r.y1 - rad.bottom_right.height,
             rad.bottom_right, 1, 1),
            (r.x0 + rad.bottom_left.width, r.y1 - rad.bottom_left.height,
             rad.bottom_left, -1, 1),
        ]
        for cx, cy, rr, sx, sy in corners:
            if rr.width <= 0 or rr.height <= 0:
                continue
            dx = (p.x - cx) * sx
            dy = (p.y - cy) * sy
            if dx > 0 and dy > 0:
                if (dx / rr.width) ** 2 + (dy / rr.height) ** 2 > 1.0:
                    return False
        return True

    def hit_test(self, point: Point2D) -> List[HitTestResultItem]:
        """hit_test.rs HitTester::hit_test — items returned front-to-back."""
        out: List[HitTestResultItem] = []
        for entry in reversed(self.scene.hit_test_items):
            c = entry.common
            lp = self._to_local(c.spatial_node, point)
            if lp is None:
                continue
            if not c.local_rect.contains(lp):
                continue
            if not c.clip_rect.contains(lp):
                continue
            if not self._clip_contains(c.clip_chain, point):
                continue
            out.append(HitTestResultItem(
                entry.tag, point,
                Point2D(lp.x - c.local_rect.x0, lp.y - c.local_rect.y0)))
        return out
