"""Clip store — mirrors the role of `webrender/src/clip.rs` (ClipItem →
ClipNode → clip chains), without the interning machinery: clip nodes are
appended to a flat store during scene building and referenced by index;
an item's resolved clip chain is a tuple of node indices.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..api.display_item import BorderRadius, ClipMode
from ..api.units import Point2D, Rect


class ClipKind(enum.Enum):
    RECT = 0
    ROUNDED_RECT = 1
    IMAGE_MASK = 2
    BOX_SHADOW = 3  # used internally for box-shadow clips


@dataclass(frozen=True)
class ClipNode:
    """clip.rs ClipItemKind (:1737) analog."""
    kind: ClipKind
    spatial_node: int
    rect: Rect
    radii: BorderRadius = field(default_factory=BorderRadius)
    mode: ClipMode = ClipMode.CLIP
    image_key: int = 0
    points: Tuple[Point2D, ...] = ()
    fill_rule: str = "nonzero"


class ClipStore:
    """Flat clip node storage + chain resolution (clip.rs ClipStore :1237)."""

    def __init__(self):
        self.nodes: List[ClipNode] = []
        # ClipId index (per pipeline namespace flattened by scene builder)
        self._by_clip_id: Dict[Tuple[int, int], int] = {}
        # chain id → (parent chain id or None, tuple of node indices)
        self._chains: Dict[Tuple[int, int], Tuple[Optional[Tuple[int, int]], Tuple[int, ...]]] = {}

    def add_node(self, node: ClipNode) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    def register_clip_id(self, pipeline_ns: int, clip_index: int,
                         node_index: int) -> None:
        self._by_clip_id[(pipeline_ns, clip_index)] = node_index

    def node_for_clip_id(self, pipeline_ns: int, clip_index: int) -> int:
        return self._by_clip_id[(pipeline_ns, clip_index)]

    def define_chain(self, pipeline_ns: int, chain_index: int,
                     parent: Optional[Tuple[int, int]],
                     node_indices: Tuple[int, ...]) -> None:
        self._chains[(pipeline_ns, chain_index)] = (parent, node_indices)

    def resolve_chain(self, pipeline_ns: int, chain_index: int) -> Tuple[int, ...]:
        """Flatten a chain plus its parents into node indices
        (clip.rs ClipChain walking semantics)."""
        out: List[int] = []
        key: Optional[Tuple[int, int]] = (pipeline_ns, chain_index)
        seen = set()
        while key is not None and key in self._chains and key not in seen:
            seen.add(key)
            parent, nodes = self._chains[key]
            out.extend(nodes)
            key = parent
        return tuple(out)

    def __len__(self):
        return len(self.nodes)
