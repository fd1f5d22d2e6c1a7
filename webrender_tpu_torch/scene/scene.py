"""Scene containers — `webrender/src/scene.rs` (Scene :184, BuiltScene :273)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from ..api.color import ColorF
from ..api.display_item import PipelineId
from ..api.display_list import BuiltDisplayList
from ..api.transaction import Epoch
from .clip import ClipStore
from .prims import PicturePrim
from .spatial_tree import SceneSpatialTree


@dataclass
class Scene:
    """Pending scene: pipelines and the root pipeline id (scene.rs:184)."""
    pipelines: Dict[Tuple[int, int], BuiltDisplayList] = field(default_factory=dict)
    epochs: Dict[Tuple[int, int], Epoch] = field(default_factory=dict)
    root_pipeline_id: Optional[PipelineId] = None
    # display-item cache (display_item_cache.rs DisplayItemCache): retained
    # item groups persist across display lists per pipeline; a later epoch
    # splices them back with ReuseItems without re-serializing the items
    item_caches: Dict[Tuple[int, int], Dict[int, tuple]] = \
        field(default_factory=dict)

    def set_display_list(self, pipeline_id: PipelineId, epoch: Epoch,
                         dl: BuiltDisplayList) -> None:
        key = (pipeline_id.namespace, pipeline_id.id)
        self.pipelines[key] = dl
        self.epochs[key] = epoch
        # display_item_cache.rs update(): retained groups replace cache
        # entries by key; entries survive until overwritten or the
        # pipeline is removed
        cache = self.item_caches.setdefault(key, {})
        for retained in getattr(dl, "cache_data", ()):
            cache[retained.key] = tuple(retained.items)

    def remove_pipeline(self, pipeline_id: PipelineId) -> None:
        key = (pipeline_id.namespace, pipeline_id.id)
        self.pipelines.pop(key, None)
        self.epochs.pop(key, None)
        self.item_caches.pop(key, None)

    @property
    def has_root_pipeline(self) -> bool:
        if self.root_pipeline_id is None:
            return False
        key = (self.root_pipeline_id.namespace, self.root_pipeline_id.id)
        return key in self.pipelines


@dataclass
class BuiltScene:
    """Flattened, render-ready scene (scene.rs BuiltScene :273)."""
    root: PicturePrim
    spatial_tree: SceneSpatialTree
    clip_store: ClipStore
    background_color: Optional[ColorF] = None
    hit_test_items: list = field(default_factory=list)
    pipeline_epochs: Dict[Tuple[int, int], Epoch] = field(default_factory=dict)
