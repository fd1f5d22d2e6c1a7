"""Spatial tree — transform hierarchy of reference frames, scroll frames and
sticky frames. Mirrors the semantics of `webrender/src/spatial_tree.rs:210`
(SceneSpatialTree) and `spatial_node.rs:114` (SpatialNodeType), collapsed
into one structure: the scene side defines nodes, the frame side resolves
world transforms given current scroll offsets / animated properties.

TPU-first note: rather than the reference's CoordinateSystem partitioning,
every node gets an explicit 4x4 local→world matrix at frame-build time, with
a 2D-affine fast path recorded in the transform palette consumed by the
raster kernels (`gpu_types.rs` TransformPalette analog).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api.units import Point2D, Rect, Transform
from ..api.display_item import SpatialId, StickyFrameItem


class SpatialNodeKind(enum.Enum):
    REFERENCE_FRAME = 0
    SCROLL_FRAME = 1
    STICKY_FRAME = 2


@dataclass
class SpatialNode:
    index: int
    parent: Optional[int]
    kind: SpatialNodeKind
    # reference frame:
    origin: Point2D = field(default_factory=Point2D)
    transform: Transform = field(default_factory=Transform.identity)
    transform_binding: Optional[int] = None   # animated property key
    is_perspective: bool = False
    preserves_3d: bool = False
    # scroll frame:
    frame_rect: Rect = field(default_factory=Rect)
    content_rect: Rect = field(default_factory=Rect)
    external_id: int = 0
    external_scroll_offset: Point2D = field(default_factory=Point2D)
    scroll_generation: int = 0
    has_scroll_linked_effect: bool = False
    # sticky frame:
    sticky: Optional[StickyFrameItem] = None


@dataclass
class ResolvedSpatialNode:
    """Frame-time resolution of one node (spatial_tree.rs SpatialNode)."""
    world: Transform                 # local → world (layout px)
    is_2d_axis_aligned: bool
    is_invertible: bool
    # Backface within the node's preserve-3d context (None when the node is
    # not in a 3D rendering context — flat transforms never cull backfaces;
    # see backface/backface-leaf.yaml).
    backface: bool = False


class SceneSpatialTree:
    """Built during scene building; index 0 = root reference frame, 1 = root
    scroll node (matching SpatialId convention in display_item.py)."""

    def __init__(self):
        self.nodes: List[SpatialNode] = []
        root = SpatialNode(0, None, SpatialNodeKind.REFERENCE_FRAME)
        self.nodes.append(root)
        root_scroll = SpatialNode(1, 0, SpatialNodeKind.SCROLL_FRAME,
                                  frame_rect=Rect(-1e9, -1e9, 2e9, 2e9),
                                  content_rect=Rect(-1e9, -1e9, 2e9, 2e9))
        self.nodes.append(root_scroll)

    def add_reference_frame(self, index: int, parent: int, origin: Point2D,
                            transform: Transform,
                            transform_binding: Optional[int] = None,
                            is_perspective: bool = False,
                            preserves_3d: bool = False) -> None:
        self._insert(SpatialNode(index, parent, SpatialNodeKind.REFERENCE_FRAME,
                                 origin=origin, transform=transform,
                                 transform_binding=transform_binding,
                                 is_perspective=is_perspective,
                                 preserves_3d=preserves_3d))

    def add_scroll_frame(self, index: int, parent: int, frame_rect: Rect,
                         content_rect: Rect, external_id: int,
                         external_scroll_offset: Point2D,
                         scroll_generation: int = 0,
                         has_scroll_linked_effect: bool = False) -> None:
        self._insert(SpatialNode(index, parent, SpatialNodeKind.SCROLL_FRAME,
                                 frame_rect=frame_rect,
                                 content_rect=content_rect,
                                 external_id=external_id,
                                 external_scroll_offset=external_scroll_offset,
                                 scroll_generation=scroll_generation,
                                 has_scroll_linked_effect=has_scroll_linked_effect))

    def add_sticky_frame(self, index: int, parent: int,
                         item: StickyFrameItem) -> None:
        self._insert(SpatialNode(index, parent, SpatialNodeKind.STICKY_FRAME,
                                 sticky=item))

    def _insert(self, node: SpatialNode) -> None:
        while len(self.nodes) <= node.index:
            self.nodes.append(None)  # type: ignore
        self.nodes[node.index] = node

    def __len__(self):
        return len(self.nodes)

    # -----------------------------------------------------------------------
    def resolve(self,
                scroll_offsets: Optional[Dict[int, Point2D]] = None,
                transform_properties: Optional[Dict[int, Transform]] = None,
                viewport: Optional[Rect] = None,
                ) -> List[ResolvedSpatialNode]:
        """Compute local→world transforms for every node
        (spatial_tree.rs update_tree analog).

        scroll_offsets: external_scroll_id → current offset.
        transform_properties: animated property key → transform value.
        """
        scroll_offsets = scroll_offsets or {}
        transform_properties = transform_properties or {}
        resolved: List[Optional[ResolvedSpatialNode]] = [None] * len(self.nodes)
        # transform-style: flat projects descendant 3D onto the frame's
        # plane: a reference frame attaching under a flat (non-perspective)
        # transform frame has its local transform's z OUTPUT zeroed
        # (spatial_node.rs:492 flatten_z_output — m13/m23/m43 := 0,
        # m33 := 1; the root coordinate system never flattens)
        flatten_children: List[bool] = [False] * len(self.nodes)
        # per-node sticky state: (viewport_rect, viewport_scroll_offset)
        # mirrors TransformUpdateState.nearest_scrolling_ancestor_*
        # (spatial_node.rs:538-541, :710-721)
        scroll_state: List[Tuple[Optional[Rect], Point2D]] = \
            [(None, Point2D(0, 0))] * len(self.nodes)

        for node in self.nodes:
            if node is None:
                continue
            if node.parent is None:
                parent_world = Transform.identity()
                parent_state = (viewport, Point2D(0, 0))
            else:
                parent_res = resolved[node.parent]
                assert parent_res is not None, "parent resolved before child"
                parent_world = parent_res.world
                parent_state = scroll_state[node.parent]
            state = parent_state

            if node.kind == SpatialNodeKind.REFERENCE_FRAME:
                t = node.transform
                if node.transform_binding is not None:
                    t = transform_properties.get(node.transform_binding, t)
                # local content point → parent: apply transform, then origin
                # translation (scene_building.rs push_reference_frame: the
                # frame's content is positioned at `origin` in the parent).
                if node.parent is not None and \
                        flatten_children[node.parent]:
                    m = list(t.m)
                    m[2] = m[6] = m[14] = 0.0
                    m[10] = 1.0
                    t = Transform(m)
                local = t.post_translate(node.origin.x, node.origin.y)
                # translate the sticky viewport into this frame's space
                # (spatial_node.rs:728 — origin only, not the transform)
                if state[0] is not None:
                    state = (state[0].translate(-node.origin.x, -node.origin.y),
                             state[1])
            elif node.kind == SpatialNodeKind.SCROLL_FRAME:
                stored = self._stored_scroll_offset(node, scroll_offsets)
                # content translation = stored + external (spatial_node.rs:
                # the sampled offsets are -(position) - external, and the DL
                # coordinates already include the external offset)
                dx = stored.x + node.external_scroll_offset.x
                dy = stored.y + node.external_scroll_offset.y
                local = Transform.translation(dx, dy)
                state = (node.frame_rect, stored)
            else:  # STICKY_FRAME
                off = self._sticky_offset(node, state[0], state[1])
                local = Transform.translation(off.x, off.y)
                st0 = state[1]
                state = (state[0], Point2D(st0.x + off.x, st0.y + off.y))

            world = local.then(parent_world)
            resolved[node.index] = ResolvedSpatialNode(
                world=world,
                is_2d_axis_aligned=world.is_2d_axis_aligned,
                is_invertible=_homography_invertible(world),
                backface=self._backface_in_3d_context(node.index,
                                                      transform_properties),
            )
            if node.kind == SpatialNodeKind.REFERENCE_FRAME:
                flatten_children[node.index] = (
                    node.index != 0 and not node.preserves_3d
                    and not node.is_perspective)
            else:
                flatten_children[node.index] = \
                    flatten_children[node.parent] \
                    if node.parent is not None else False
            scroll_state[node.index] = state
        # Fill gaps (defensive) with identity
        for i, r in enumerate(resolved):
            if r is None:
                resolved[i] = ResolvedSpatialNode(Transform.identity(), True, True)
        return resolved  # type: ignore

    def _nearest_rf(self, index: Optional[int]) -> Optional[int]:
        idx = index
        while idx is not None and idx < len(self.nodes):
            node = self.nodes[idx]
            if node is None:
                return None
            if node.kind == SpatialNodeKind.REFERENCE_FRAME:
                return idx
            idx = node.parent
        return None

    def orientation_normal_z(self, index: int, transform_properties) -> float:
        """Normal-z of the plane orientation of a node's reference frame:
        the product of its transform with ancestors *while the parent frame
        is preserve-3d* (CSS 3D rendering context; backface-both-sides)."""
        rf = self._nearest_rf(index)
        if rf is None:
            return 1.0
        combined = Transform.identity()
        while rf is not None:
            node = self.nodes[rf]
            t = node.transform
            if node.transform_binding is not None:
                t = transform_properties.get(node.transform_binding, t)
            combined = combined.then(t)
            parent_rf = self._nearest_rf(node.parent)
            if parent_rf is None:
                break
            pnode = self.nodes[parent_rf]
            # transforms paired with a perspective ancestor evaluate facing
            # THROUGH the perspective (backface-perspective.yaml; WR
            # composes across coordinate systems in
            # get_relative_transform_with_face, spatial_tree.rs:1020)
            if not (pnode.preserves_3d or pnode.is_perspective):
                break
            rf = parent_rf
        m = np.asarray(combined.m, np.float64).reshape(4, 4)
        # facing = winding of the projected plane quad (perspective terms
        # can flip the visible face relative to the plain 2D determinant)
        pts = np.array([[0, 0, 0, 1], [100, 0, 0, 1], [0, 100, 0, 1]],
                       np.float64) @ m
        w = pts[:, 3]
        if np.any(w <= 1e-9):
            return m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
        p = pts[:, :2] / w[:, None]
        e1 = p[1] - p[0]
        e2 = p[2] - p[0]
        return float(e1[0] * e2[1] - e1[1] * e2[0])

    def in_3d_context(self, index: int) -> bool:
        """A node is in a 3D rendering context when its reference frame is
        preserve-3d or its parent frame is (backface-leaf vs vis-3d)."""
        rf = self._nearest_rf(index)
        if rf is None:
            return False
        node = self.nodes[rf]
        if node.preserves_3d:
            return True
        parent_rf = self._nearest_rf(node.parent)
        return parent_rf is not None and self.nodes[parent_rf].preserves_3d

    def _backface_in_3d_context(self, index: int,
                                transform_properties) -> bool:
        """Prim-level backface culling: only inside a 3D context."""
        if not self.in_3d_context(index):
            return False
        return self.orientation_normal_z(index, transform_properties) < 0

    @staticmethod
    def _stored_scroll_offset(node: SpatialNode, scroll_offsets) -> Point2D:
        """ScrollFrameInfo::offset (spatial_node.rs:861): sampled offsets are
        stored as -(position) - external; default sample = -external."""
        e = node.external_scroll_offset
        samples = scroll_offsets.get(node.external_id)
        if not samples:
            return Point2D(-e.x, -e.y)
        if isinstance(samples, Point2D):  # plain API offset
            samples = [(samples, node.scroll_generation)]
        stored = [(Point2D(-o.x - e.x, -o.y - e.y), gen) for (o, gen) in samples]
        if not node.has_scroll_linked_effect:
            return stored[0][0]
        for off, gen in stored:
            if gen == node.scroll_generation:
                return off
        return stored[0][0]

    def _sticky_offset(self, node: SpatialNode, viewport: Optional[Rect],
                       viewport_scroll_offset: Point2D) -> Point2D:
        """spatial_node.rs calculate_sticky_offset (:581-691), exact port."""
        st = node.sticky
        if st is None or viewport is None:
            return Point2D(0, 0)
        top, right, bottom, left = st.margins
        if top is None and bottom is None and left is None and right is None:
            return Point2D(0, 0)
        prev = st.previously_applied_offset
        sx0 = st.bounds.x0 + viewport_scroll_offset.x
        sy0 = st.bounds.y0 + viewport_scroll_offset.y
        sx1 = st.bounds.x1 + viewport_scroll_offset.x
        sy1 = st.bounds.y1 + viewport_scroll_offset.y
        ox = oy = 0.0

        if top is not None:
            edge = viewport.y0 + top
            if sy0 < edge:
                oy = edge - sy0
            elif prev.y > 0.0 and sy0 > edge:
                oy = max(edge - sy0, -prev.y)
        if oy + prev.y <= 0.0 and bottom is not None:
            sy0 += oy
            sy1 += oy
            edge = viewport.y1 - bottom
            if sy1 > edge:
                oy += edge - sy1
            elif prev.y < 0.0 and sy1 < edge:
                oy += edge - sy1
                oy = min(oy, -prev.y)

        if left is not None:
            edge = viewport.x0 + left
            if sx0 < edge:
                ox = edge - sx0
            elif prev.x > 0.0 and sx0 > edge:
                ox = max(edge - sx0, -prev.x)
        if ox + prev.x <= 0.0 and right is not None:
            sx0 += ox
            sx1 += ox
            edge = viewport.x1 - right
            if sx1 > edge:
                ox += edge - sx1
            elif prev.x < 0.0 and sx1 < edge:
                ox += edge - sx1
                ox = min(ox, -prev.x)

        lo_y, hi_y = st.vertical_offset_bounds
        lo_x, hi_x = st.horizontal_offset_bounds
        oy = min(max(oy + prev.y, lo_y), hi_y) - prev.y
        ox = min(max(ox + prev.x, lo_x), hi_x) - prev.x
        return Point2D(ox, oy)


def _homography_invertible(world: Transform) -> bool:
    """Invertibility of the 2D screen mapping (x,y,w rows/cols) — the 4x4
    is intentionally singular under flattened ancestors."""
    m = world.m
    det = (m[0] * (m[5] * m[15] - m[7] * m[13])
           - m[1] * (m[4] * m[15] - m[7] * m[12])
           + m[3] * (m[4] * m[13] - m[5] * m[12]))
    return abs(det) > 1e-12
