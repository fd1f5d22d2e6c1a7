"""DisplayListBuilder — mirrors `webrender_api/src/display_list.rs:1041`.

The reference serializes items with peek-poke into a byte stream; here a
built display list is simply the list of item records (the serialization
fidelity is not needed, the API shape is — see SURVEY.md §7.1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from .color import ColorF
from .display_item import (
    AlphaType, BackdropFilterItem, BorderItem, BorderRadius, BoxShadowClipMode,
    BoxShadowItem, ClearRectangleItem, ClipChainId, ClipChainItem, ClipId,
    ClipMode, ColorDepth, ColorRange, CommonItemProperties, ComputedTransform,
    ConicGradient, ExtendMode,
    ConicGradientItem, FilterData, FilterOp, Gradient, GradientItem,
    GradientStop, HitTestItem, IframeItem, ImageItem, ImageMaskClipItem,
    ImageRendering, LineItem, LineOrientation, LineStyle, MixBlendMode,
    NinePatchBorder, NormalBorder, PipelineId, PopAllShadowsItem,
    PopReferenceFrameItem, PopStackingContextItem, PrimitiveFlags,
    PushReferenceFrameItem, PushShadowItem, PushStackingContextItem,
    RadialGradient, RadialGradientItem, RasterSpace, RectangleItem,
    RectClipItem, ReferenceFrameKind, RepeatingImageItem,
    RetainedItemsItem, ReuseItemsItem, RoundedRectClipItem,
    ScrollFrameItem, Shadow, SpatialId, StackingContextFlags, StickyFrameItem,
    TextItem, TransformStyle, YuvImageItem, ROOT_CLIP_CHAIN,
)
from .units import Point2D, Rect, SideOffsets, Size2D, Transform


@dataclass
class BuiltDisplayList:
    """The product of DisplayListBuilder.end() (display_list.rs BuiltDisplayList)."""
    pipeline_id: PipelineId
    items: List[object] = field(default_factory=list)
    # display_item_cache.rs: retained item groups shipped alongside the list
    cache_data: List[object] = field(default_factory=list)
    cache_size: int = 0

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)


class DisplayListBuilder:
    """Builds a retained display list (display_list.rs:1041).

    Spatial and clip IDs are allocated by the builder, exactly as in the
    reference: index 0 is the root reference frame, index 1 the root scroll
    node (display_item.rs SpatialId convention).
    """

    def __init__(self, pipeline_id: PipelineId = PipelineId.dummy()):
        self.pipeline_id = pipeline_id
        self.items: List[object] = []
        # 0 = root reference frame, 1 = root scroll node
        self._next_spatial_index = 2
        self._next_clip_index = 0
        self._next_clip_chain_index = 0
        self._save_state: Optional[int] = None
        # display-item cache state (display_item_cache.rs builder side)
        self._cache_data: List[object] = []
        self._next_cache_key = 0
        self._group_start: Optional[int] = None

    # --- lifecycle (display_list.rs begin :2196 / end :2203) ---------------
    def begin(self) -> None:
        self.items = []
        self._next_spatial_index = 2
        self._next_clip_index = 0
        self._next_clip_chain_index = 0

    def end(self) -> Tuple[PipelineId, BuiltDisplayList]:
        return self.pipeline_id, BuiltDisplayList(
            self.pipeline_id, list(self.items), list(self._cache_data),
            self._next_cache_key)

    # save/restore (display_list.rs save/restore/clear_save) — used by
    # rawtests to speculatively build and roll back.
    def save(self) -> None:
        assert self._save_state is None, "no nested saves"
        self._save_state = len(self.items)

    def restore(self) -> None:
        assert self._save_state is not None
        del self.items[self._save_state:]
        self._save_state = None

    # --- display-item cache (display_item_cache.rs builder side) ----------
    def start_item_group(self) -> None:
        """Begin capturing items for retention (display_list.rs
        start_item_group)."""
        assert self._group_start is None, "nested item groups"
        self._group_start = len(self.items)

    def finish_item_group(self) -> Optional[int]:
        """End the capture: items since start move into the list\'s
        cache_data under a fresh key and a ReuseItems marker replaces them.
        Returns the key (None if the group was empty)."""
        assert self._group_start is not None
        group = tuple(self.items[self._group_start:])
        del self.items[self._group_start:]
        self._group_start = None
        if not group:
            return None
        key = self._next_cache_key
        self._next_cache_key += 1
        self._cache_data.append(RetainedItemsItem(key, group))
        self.items.append(ReuseItemsItem(key))
        return key

    def push_reuse_items(self, key: int) -> None:
        """Splice a previously retained group (display_list.rs
        push_reuse_items)."""
        self.items.append(ReuseItemsItem(key))

    def clear_save(self) -> None:
        self._save_state = None

    # --- id allocation ------------------------------------------------------
    def _alloc_spatial(self) -> SpatialId:
        sid = SpatialId(self._next_spatial_index, self.pipeline_id)
        self._next_spatial_index += 1
        return sid

    def _alloc_clip(self) -> ClipId:
        cid = ClipId(self._next_clip_index, self.pipeline_id)
        self._next_clip_index += 1
        return cid

    def _alloc_clip_chain(self) -> ClipChainId:
        cid = ClipChainId(self._next_clip_chain_index, self.pipeline_id)
        self._next_clip_chain_index += 1
        return cid

    # --- gradient creation (gradient_builder.rs normalization) --------------
    @staticmethod
    def _normalize_stops(stops: List[GradientStop],
                         extend_mode: ExtendMode) -> Tuple[List[GradientStop], float, float]:
        """gradient_builder.rs normalize (:127): map stops into [0,1] and
        return (start_offset, end_offset) adjustments for the gradient line."""
        assert len(stops) >= 2, "gradient needs at least two stops"
        first, last = stops[0], stops[-1]
        delta = last.offset - first.offset
        if delta != delta:  # NaN
            return ([GradientStop(0.0, last.color),
                     GradientStop(1.0, last.color)], 0.0, 1.0)
        if delta > 1e-6:
            out = [GradientStop((s.offset - first.offset) / delta, s.color)
                   for s in stops]
            return out, first.offset, last.offset
        if extend_mode == ExtendMode.CLAMP:
            out = [GradientStop(0.0, first.color),
                   GradientStop(0.5, first.color),
                   GradientStop(0.5, last.color),
                   GradientStop(1.0, last.color)]
            return out, last.offset - 0.5, last.offset + 0.5
        return ([GradientStop(0.0, last.color),
                 GradientStop(1.0, last.color)], 0.0, 1.0)

    def create_gradient(self, start: Point2D, end: Point2D,
                        stops: List[GradientStop],
                        extend_mode: ExtendMode) -> Tuple[Gradient, List[GradientStop]]:
        """display_list.rs create_gradient → GradientBuilder::gradient."""
        stops, s_off, e_off = self._normalize_stops(list(stops), extend_mode)
        dx, dy = end.x - start.x, end.y - start.y
        g = Gradient(Point2D(start.x + dx * s_off, start.y + dy * s_off),
                     Point2D(start.x + dx * e_off, start.y + dy * e_off),
                     extend_mode)
        return g, stops

    def create_radial_gradient(self, center: Point2D, radius: Size2D,
                               stops: List[GradientStop],
                               extend_mode: ExtendMode):
        """GradientBuilder::radial_gradient (:63): non-positive radius →
        solid last color."""
        if radius.width <= 0.0 or radius.height <= 0.0:
            last = stops[-1].color
            g = RadialGradient(center, Size2D(1.0, 1.0), 0.0, 1.0, extend_mode)
            return g, [GradientStop(0.0, last), GradientStop(1.0, last)]
        stops, s_off, e_off = self._normalize_stops(list(stops), extend_mode)
        return RadialGradient(center, radius, s_off, e_off, extend_mode), stops

    def create_conic_gradient(self, center: Point2D, angle: float,
                              stops: List[GradientStop],
                              extend_mode: ExtendMode):
        stops, s_off, e_off = self._normalize_stops(list(stops), extend_mode)
        return ConicGradient(center, angle, s_off, e_off, extend_mode), stops

    # --- primitives ---------------------------------------------------------
    def push_rect(self, common: CommonItemProperties, bounds: Rect, color: ColorF) -> None:
        """display_list.rs:1333"""
        self.items.append(RectangleItem(common, bounds, color))

    def push_clear_rect(self, common: CommonItemProperties, bounds: Rect) -> None:
        self.items.append(ClearRectangleItem(common, bounds))

    def push_hit_test(self, rect: Rect, clip_chain_id: ClipChainId,
                      spatial_id: SpatialId, flags: PrimitiveFlags,
                      tag: Tuple[int, int]) -> None:
        common = CommonItemProperties(rect, spatial_id, clip_chain_id, flags)
        self.items.append(HitTestItem(common, rect, tag))

    def push_line(self, common: CommonItemProperties, area: Rect,
                  wavy_line_thickness: float, orientation: LineOrientation,
                  color: ColorF, style: LineStyle) -> None:
        self.items.append(LineItem(common, area, orientation,
                                   wavy_line_thickness, color, style))

    def push_image(self, common: CommonItemProperties, bounds: Rect,
                   image_rendering: ImageRendering, alpha_type: AlphaType,
                   key: int, color: ColorF = ColorF.WHITE) -> None:
        """display_list.rs:1422"""
        self.items.append(ImageItem(common, bounds, key, image_rendering,
                                    alpha_type, color))

    def push_repeating_image(self, common: CommonItemProperties, bounds: Rect,
                             stretch_size: Size2D, tile_spacing: Size2D,
                             image_rendering: ImageRendering,
                             alpha_type: AlphaType, key: int,
                             color: ColorF = ColorF.WHITE) -> None:
        self.items.append(RepeatingImageItem(common, bounds, key, stretch_size,
                                             tile_spacing, image_rendering,
                                             alpha_type, color))

    def push_yuv_image(self, common: CommonItemProperties, bounds: Rect,
                       yuv_keys: Sequence[int], format: str,
                       color_depth: ColorDepth, color_space,
                       color_range, image_rendering: ImageRendering) -> None:
        self.items.append(YuvImageItem(common, bounds, tuple(yuv_keys), format,
                                       color_depth, color_space, color_range,
                                       image_rendering))

    def push_text(self, common: CommonItemProperties, bounds: Rect,
                  glyphs: Sequence[Tuple[int, float, float]],
                  font_instance_key: int, color: ColorF) -> None:
        """display_list.rs:1497"""
        self.items.append(TextItem(common, bounds, font_instance_key,
                                   tuple(glyphs), color))

    def push_border(self, common: CommonItemProperties, bounds: Rect,
                    widths: SideOffsets,
                    details_normal: Optional[NormalBorder] = None,
                    details_nine_patch: Optional[NinePatchBorder] = None) -> None:
        self.items.append(BorderItem(common, bounds, widths, details_normal,
                                     details_nine_patch))

    def push_box_shadow(self, common: CommonItemProperties, box_bounds: Rect,
                        offset: Point2D, color: ColorF, blur_radius: float,
                        spread_radius: float, border_radius: BorderRadius,
                        clip_mode: BoxShadowClipMode) -> None:
        self.items.append(BoxShadowItem(common, box_bounds, offset, color,
                                        blur_radius, spread_radius,
                                        border_radius, clip_mode))

    def push_gradient(self, common: CommonItemProperties, bounds: Rect,
                      gradient: Gradient, stops: Sequence[GradientStop],
                      tile_size: Optional[Size2D] = None,
                      tile_spacing: Size2D = Size2D()) -> None:
        if tile_size is None:
            tile_size = bounds.size
        self.items.append(GradientItem(common, bounds, gradient, tuple(stops),
                                       tile_size, tile_spacing))

    def push_radial_gradient(self, common: CommonItemProperties, bounds: Rect,
                             gradient: RadialGradient,
                             stops: Sequence[GradientStop],
                             tile_size: Optional[Size2D] = None,
                             tile_spacing: Size2D = Size2D()) -> None:
        if tile_size is None:
            tile_size = bounds.size
        self.items.append(RadialGradientItem(common, bounds, gradient,
                                             tuple(stops), tile_size, tile_spacing))

    def push_conic_gradient(self, common: CommonItemProperties, bounds: Rect,
                            gradient: ConicGradient,
                            stops: Sequence[GradientStop],
                            tile_size: Optional[Size2D] = None,
                            tile_spacing: Size2D = Size2D()) -> None:
        if tile_size is None:
            tile_size = bounds.size
        self.items.append(ConicGradientItem(common, bounds, gradient,
                                            tuple(stops), tile_size, tile_spacing))

    def push_backdrop_filter(self, common: CommonItemProperties,
                             filters: Sequence[FilterOp],
                             filter_datas: Sequence[FilterData] = ()) -> None:
        self.items.append(BackdropFilterItem(common, tuple(filters),
                                             tuple(filter_datas)))

    # --- shadows ------------------------------------------------------------
    def push_shadow(self, spatial_id: SpatialId, clip_chain_id: ClipChainId,
                    shadow: Shadow, should_inflate: bool = True) -> None:
        common = CommonItemProperties(Rect(-1e9, -1e9, 2e9, 2e9), spatial_id,
                                      clip_chain_id)
        self.items.append(PushShadowItem(common, Shadow(
            shadow.offset, shadow.color, shadow.blur_radius, should_inflate)))

    def pop_all_shadows(self) -> None:
        self.items.append(PopAllShadowsItem())

    # --- clips --------------------------------------------------------------
    def define_clip_rect(self, spatial_id: SpatialId, clip_rect: Rect) -> ClipId:
        """display_list.rs:1970"""
        cid = self._alloc_clip()
        self.items.append(RectClipItem(cid, spatial_id, clip_rect))
        return cid

    def define_clip_rounded_rect(self, spatial_id: SpatialId, rect: Rect,
                                 radii: BorderRadius,
                                 mode: ClipMode = ClipMode.CLIP) -> ClipId:
        cid = self._alloc_clip()
        self.items.append(RoundedRectClipItem(cid, spatial_id, rect, radii, mode))
        return cid

    def define_clip_image_mask(self, spatial_id: SpatialId, rect: Rect,
                               image_key: int, points: Sequence[Point2D] = (),
                               fill_rule: str = "nonzero") -> ClipId:
        cid = self._alloc_clip()
        self.items.append(ImageMaskClipItem(cid, spatial_id, rect, image_key,
                                            fill_rule, tuple(points)))
        return cid

    def define_clip_chain(self, parent: Optional[ClipChainId],
                          clips: Sequence[ClipId]) -> ClipChainId:
        """display_list.rs:2030"""
        cid = self._alloc_clip_chain()
        self.items.append(ClipChainItem(cid, parent, tuple(clips)))
        return cid

    # --- spatial nodes ------------------------------------------------------
    def push_reference_frame(self, origin: Point2D,
                             parent_spatial_id: SpatialId,
                             transform_style: TransformStyle,
                             transform: Transform,
                             kind: ReferenceFrameKind = ReferenceFrameKind.TRANSFORM,
                             ) -> SpatialId:
        sid = self._alloc_spatial()
        self.items.append(PushReferenceFrameItem(origin, parent_spatial_id,
                                                 transform_style, transform,
                                                 kind, sid))
        return sid

    def push_computed_frame(self, origin: Point2D,
                            parent_spatial_id: SpatialId,
                            scale_from, vertical_flip: bool,
                            rotation) -> SpatialId:
        """display_list.rs push_computed_frame: a reference frame whose
        transform is computed at scene-build time from the enclosing
        iframe's content size (ReferenceTransformBinding::Computed)."""
        sid = self._alloc_spatial()
        self.items.append(PushReferenceFrameItem(
            origin, parent_spatial_id, TransformStyle.FLAT,
            Transform.identity(), ReferenceFrameKind.TRANSFORM, sid,
            computed=ComputedTransform(scale_from, vertical_flip, rotation)))
        return sid

    def pop_reference_frame(self) -> None:
        self.items.append(PopReferenceFrameItem())

    def define_scroll_frame(self, parent_spatial_id: SpatialId,
                            external_id: int, content_rect: Rect,
                            frame_rect: Rect,
                            external_scroll_offset: Point2D = Point2D(),
                            scroll_generation: int = 0,
                            has_scroll_linked_effect: bool = False,
                            ) -> SpatialId:
        """display_list.rs:2040"""
        sid = self._alloc_spatial()
        self.items.append(ScrollFrameItem(parent_spatial_id, sid, frame_rect,
                                          content_rect, external_id,
                                          external_scroll_offset,
                                          scroll_generation,
                                          has_scroll_linked_effect))
        return sid

    def define_sticky_frame(self, parent_spatial_id: SpatialId, bounds: Rect,
                            margins=(None, None, None, None),
                            vertical_offset_bounds=(-1e9, 1e9),
                            horizontal_offset_bounds=(-1e9, 1e9),
                            previously_applied_offset: Point2D = Point2D(),
                            ) -> SpatialId:
        sid = self._alloc_spatial()
        self.items.append(StickyFrameItem(parent_spatial_id, sid, bounds,
                                          margins, vertical_offset_bounds,
                                          horizontal_offset_bounds,
                                          previously_applied_offset))
        return sid

    # --- stacking contexts --------------------------------------------------
    def push_stacking_context(self, origin: Point2D, spatial_id: SpatialId,
                              prim_flags: PrimitiveFlags = PrimitiveFlags.IS_BACKFACE_VISIBLE,
                              clip_chain_id: Optional[ClipChainId] = None,
                              transform_style: TransformStyle = TransformStyle.FLAT,
                              mix_blend_mode: MixBlendMode = MixBlendMode.NORMAL,
                              filters: Sequence[FilterOp] = (),
                              filter_datas: Sequence[FilterData] = (),
                              raster_space: RasterSpace = RasterSpace.SCREEN,
                              flags: StackingContextFlags = StackingContextFlags.NONE,
                              ) -> None:
        """display_list.rs:1785"""
        self.items.append(PushStackingContextItem(
            origin, spatial_id, prim_flags, clip_chain_id, transform_style,
            mix_blend_mode, flags, raster_space, tuple(filters),
            tuple(filter_datas)))

    def pop_stacking_context(self) -> None:
        self.items.append(PopStackingContextItem())

    def push_iframe(self, bounds: Rect, clip_rect: Rect,
                    spatial_id: SpatialId, pipeline_id: PipelineId,
                    ignore_missing_pipeline: bool = True) -> None:
        """display_list.rs:2096"""
        self.items.append(IframeItem(bounds, clip_rect, spatial_id,
                                     pipeline_id, ignore_missing_pipeline))
