"""Transactions — mirrors `webrender/src/render_api.rs:148` (Transaction) and
its resource-update / frame-generation surface. A transaction accumulates
scene changes (display lists), resource updates (images/fonts), and frame
operations (scrolls, dynamic properties), and is sent atomically to the
render backend.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .color import ColorF
from .display_item import PipelineId
from .display_list import BuiltDisplayList
from .font import FontInstanceKey, FontInstanceOptions, FontKey
from .image import DirtyRect, ImageData, ImageDescriptor
from .units import Point2D, Rect, Transform


@dataclass(frozen=True)
class Epoch:
    value: int = 0


@dataclass(frozen=True)
class DocumentId:
    namespace: int = 0
    id: int = 0


class RenderReasons(enum.IntFlag):
    """webrender_api/src/lib.rs:610-645 RenderReasons (full set, same
    bit positions; profiled per-frame via Profiler.note_render_reasons)."""
    NONE = 0
    SCENE = 1 << 0
    ANIMATED_PROPERTY = 1 << 1
    RESOURCE_UPDATE = 1 << 2
    ASYNC_IMAGE = 1 << 3
    CLEAR_RESOURCES = 1 << 4
    APZ = 1 << 5
    RESIZE = 1 << 6
    WIDGET = 1 << 7
    TEXTURE_CACHE_FLUSH = 1 << 8
    SNAPSHOT = 1 << 9
    POST_RESOURCE_UPDATES_HOOK = 1 << 10
    CONFIG_CHANGE = 1 << 11
    CONTENT_SYNC = 1 << 12
    FLUSH = 1 << 13
    TESTING = 1 << 14
    OTHER = 1 << 15
    VSYNC = 1 << 16
    SKIPPED_COMPOSITE = 1 << 17
    START_OBSERVING_VSYNC = 1 << 18
    ASYNC_IMAGE_COMPOSITE_UNTIL = 1 << 19


# --- resource updates (render_api.rs ResourceUpdate) ------------------------


@dataclass
class AddImage:
    key: int
    descriptor: ImageDescriptor
    data: ImageData
    tiling: Optional[int] = None


@dataclass
class UpdateImage:
    key: int
    descriptor: ImageDescriptor
    data: ImageData
    dirty_rect: DirtyRect = field(default_factory=DirtyRect)


@dataclass
class SetBlobImageVisibleArea:
    """render_api.rs ResourceUpdate::SetBlobImageVisibleArea."""
    key: int
    area: tuple  # (x0, y0, x1, y1) image px


@dataclass
class DeleteImage:
    key: int


@dataclass
class AddFont:
    key: FontKey
    data: Optional[bytes] = None         # raw font bytes
    path: Optional[str] = None           # native font path
    index: int = 0


@dataclass
class DeleteFont:
    key: FontKey


@dataclass
class AddFontInstance:
    key: FontInstanceKey
    font_key: FontKey
    size: float
    options: FontInstanceOptions = field(default_factory=FontInstanceOptions)


@dataclass
class DeleteFontInstance:
    key: FontInstanceKey


# --- frame ops --------------------------------------------------------------


@dataclass
class ScrollOffset:
    """render_api.rs SetScrollOffsets: target a scroll node by external id;
    offset is a list of (Point2D, generation) samples."""
    external_scroll_id: int
    offset: object


@dataclass
class PropertyValue:
    """Animated property binding value (webrender_api PropertyValue)."""
    key: int
    value: Any  # Transform | float | ColorF


@dataclass
class DynamicProperties:
    transforms: List[PropertyValue] = field(default_factory=list)
    floats: List[PropertyValue] = field(default_factory=list)
    colors: List[PropertyValue] = field(default_factory=list)


# --- the transaction --------------------------------------------------------


@dataclass
class Transaction:
    """render_api.rs:148. Accumulate, then RenderApi.send_transaction."""
    scene_ops: List[Tuple[str, Any]] = field(default_factory=list)
    resource_updates: List[Any] = field(default_factory=list)
    frame_ops: List[Tuple[str, Any]] = field(default_factory=list)
    generate_frame_flag: bool = False
    render_reasons: RenderReasons = RenderReasons.NONE
    invalidate_rendered_frame: bool = False
    use_scene_builder_thread: bool = True
    # route through the low-priority scene builder (render_api.rs
    # Transaction::set_low_priority)
    low_priority: bool = False

    # --- scene --------------------------------------------------------------
    def set_display_list(self, epoch: Epoch,
                         display_list: BuiltDisplayList) -> None:
        """render_api.rs:279"""
        self.scene_ops.append(("set_display_list", (epoch, display_list)))

    def set_root_pipeline(self, pipeline_id: PipelineId) -> None:
        self.scene_ops.append(("set_root_pipeline", pipeline_id))

    def remove_pipeline(self, pipeline_id: PipelineId) -> None:
        self.scene_ops.append(("remove_pipeline", pipeline_id))

    # --- resources ----------------------------------------------------------
    def add_image(self, key: int, descriptor: ImageDescriptor,
                  data: ImageData, tiling: Optional[int] = None) -> None:
        self.resource_updates.append(AddImage(key, descriptor, data, tiling))

    def update_image(self, key: int, descriptor: ImageDescriptor,
                     data: ImageData,
                     dirty_rect: DirtyRect = DirtyRect()) -> None:
        self.resource_updates.append(UpdateImage(key, descriptor, data, dirty_rect))

    def delete_image(self, key: int) -> None:
        self.resource_updates.append(DeleteImage(key))

    def set_blob_image_visible_area(self, key: int, area) -> None:
        """render_api.rs set_blob_image_visible_area: (x0, y0, x1, y1)
        image-px window the blob rasterizes within."""
        self.resource_updates.append(SetBlobImageVisibleArea(key,
                                                            tuple(area)))

    def add_blob_image(self, key: int, descriptor: ImageDescriptor,
                       blob: bytes, visible_rect=None,
                       tiling: Optional[int] = None) -> None:
        """render_api.rs add_blob_image: commands rasterized by the
        embedder's BlobImageHandler."""
        self.resource_updates.append(
            AddImage(key, descriptor, ImageData(blob=blob), tiling))

    def add_raw_font(self, key: FontKey, data: bytes, index: int = 0) -> None:
        self.resource_updates.append(AddFont(key, data=data, index=index))

    def add_native_font(self, key: FontKey, path: str, index: int = 0) -> None:
        self.resource_updates.append(AddFont(key, path=path, index=index))

    def delete_font(self, key: FontKey) -> None:
        self.resource_updates.append(DeleteFont(key))

    def add_font_instance(self, key: FontInstanceKey, font_key: FontKey,
                          size: float,
                          options: FontInstanceOptions = FontInstanceOptions(),
                          ) -> None:
        self.resource_updates.append(AddFontInstance(key, font_key, size, options))

    def delete_font_instance(self, key: FontInstanceKey) -> None:
        self.resource_updates.append(DeleteFontInstance(key))

    # --- frame --------------------------------------------------------------
    def set_scroll_offsets(self, external_scroll_id: int,
                           offsets: Sequence) -> None:
        """render_api.rs set_scroll_offsets: sampled offsets, each either a
        Point2D or a (Point2D, generation) pair."""
        samples = []
        for off in offsets:
            if isinstance(off, tuple):
                samples.append(off)
            else:
                samples.append((off, 0))
        self.frame_ops.append(("scroll",
                               ScrollOffset(external_scroll_id, samples)))

    def update_dynamic_properties(self, properties: DynamicProperties) -> None:
        self.frame_ops.append(("dynamic_properties", properties))

    def append_dynamic_transform_properties(
            self, transforms: Sequence[PropertyValue]) -> None:
        self.frame_ops.append(
            ("dynamic_properties", DynamicProperties(transforms=list(transforms))))

    def generate_frame(self, _id: int = 0,
                       reasons: RenderReasons = RenderReasons.NONE) -> None:
        """render_api.rs:360"""
        self.generate_frame_flag = True
        self.render_reasons |= reasons

    # -----------------------------------------------------------------------
    @property
    def is_empty(self) -> bool:
        return not (self.scene_ops or self.resource_updates or self.frame_ops
                    or self.generate_frame_flag)
