"""Scene building: display lists → BuiltScene.

Mirrors `webrender/src/scene_building.rs` (SceneBuilder::build :536,
build_all :872, build_item :1370): a single linear traversal of each
pipeline's display list, maintaining a stacking-context stack, a lexical
offset (the reference's `rf_mapper` offset), shadow stack, and defining
spatial/clip nodes as they appear. Output is a tree of PicturePrims whose
leaves are scene primitives.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..api.color import ColorF
from ..api.display_item import (
    BackdropFilterItem, BorderItem, BoxShadowItem, ClearRectangleItem,
    ClipChainItem, ClipMode, CommonItemProperties, ConicGradientItem,
    FilterOp, FilterOpKind, GradientItem, HitTestItem, IframeItem, ImageItem,
    ImageMaskClipItem, LineItem, MixBlendMode, PipelineId, PopAllShadowsItem,
    PopReferenceFrameItem, PopStackingContextItem, PrimitiveFlags,
    PushReferenceFrameItem, PushShadowItem, PushStackingContextItem,
    RadialGradientItem, RectangleItem, RectClipItem, ReferenceFrameKind,
    RepeatingImageItem, RetainedItemsItem, ReuseItemsItem,
    RoundedRectClipItem, ScrollFrameItem, Shadow,
    SpatialId, StackingContextFlags, StickyFrameItem, TextItem,
    TransformStyle, YuvImageItem, ROOT_CLIP_CHAIN,
)
from ..api.units import Point2D, Rect, Size2D, Transform
from .clip import ClipKind, ClipNode, ClipStore
from .prims import (
    BackdropFilterPrim, BoxShadowPrim, ClearPrim, CompositeOps,
    ConicGradientPrim, ImagePrim, LineDecorationPrim, LinearGradientPrim,
    NinePatchBorderPrim, NormalBorderPrim, PicturePrim, PrimCommon,
    RadialGradientPrim, RectanglePrim, TextRunPrim, YuvImagePrim,
)
from .scene import BuiltScene, Scene
from .spatial_tree import SceneSpatialTree


@dataclass
class HitTestEntry:
    common: PrimCommon
    tag: Tuple[int, int]


@dataclass
class _StackingContext:
    picture: PicturePrim
    offset: Point2D              # lexical offset inherited by children
    extra_clips: Tuple[int, ...]  # pass-through SC clips pushed onto children
    backface_cull_spatial: Optional[int] = None  # SC backface-visible: false
    # filters of enclosing WRAPS_BACKDROP_FILTER stacking contexts: applied
    # to contained backdrop-filter prims instead of creating a surface
    # (scene_building.rs:3753 hoists the backdrop chain past wrapping SCs)
    wrap_filters: Tuple = ()
    # backface-visibility containing block (scene_building.rs:2214): the
    # spatial node of the nearest non-3d-participating ancestor SC — prim
    # backface orientation is evaluated RELATIVE to it
    containing_block: int = 0
    # does this SC establish a 3D context for its direct children
    is_3d: bool = False


@dataclass
class _ShadowState:
    shadows: List[Shadow] = field(default_factory=list)
    shadow_pics: List[PicturePrim] = field(default_factory=list)
    originals: List[object] = field(default_factory=list)


class SceneBuilder:
    """One-shot builder: SceneBuilder(scene).build() → BuiltScene."""

    SHADOWABLE = (TextRunPrim, LineDecorationPrim, RectanglePrim, ImagePrim,
                  NormalBorderPrim)

    def __init__(self, scene: Scene,
                 background_color: Optional[ColorF] = None):
        self.scene = scene
        self.background_color = background_color
        self.spatial_tree = SceneSpatialTree()
        self.clip_store = ClipStore()
        self.hit_test_items: List[HitTestEntry] = []
        # (pipeline_ns_key, local spatial index) -> global node index
        self.spatial_map: Dict[Tuple[Tuple[int, int], int], int] = {}
        self._next_spatial = 2
        # scene_building.rs:484 iframe_size — content size of each
        # enclosing iframe, consumed by computed reference frames
        self.iframe_size: List[Size2D] = []

    # ------------------------------------------------------------------
    def build(self) -> BuiltScene:
        """scene_building.rs build (:536): traverse the root pipeline."""
        assert self.scene.has_root_pipeline, "no root pipeline set"
        rp = self.scene.root_pipeline_id
        ns = (rp.namespace, rp.id)
        self.spatial_map[(ns, 0)] = 0
        self.spatial_map[(ns, 1)] = 1

        root_pic = PicturePrim(
            common=PrimCommon(Rect(-1e9, -1e9, 2e9, 2e9),
                              Rect(-1e9, -1e9, 2e9, 2e9), 0),
        )
        dl = self.scene.pipelines[ns]
        self._build_pipeline(dl, ns, root_pic, Point2D(0, 0), ())
        return BuiltScene(
            root=root_pic,
            spatial_tree=self.spatial_tree,
            clip_store=self.clip_store,
            background_color=self.background_color,
            hit_test_items=self.hit_test_items,
            pipeline_epochs=dict(self.scene.epochs),
        )

    def _expand_cached(self, dl, ns):
        """Expand ReuseItems markers from the pipeline's display-item
        cache (display_item_cache.rs get_items + scene_building.rs cache
        expansion): retained groups splice back inline, so the rest of the
        traversal never sees the cache machinery."""
        cache = self.scene.item_caches.get(ns, {})
        for item in dl.items:
            if isinstance(item, ReuseItemsItem):
                group = cache.get(item.key)
                assert group is not None, \
                    f"ReuseItems({item.key}) with no retained group"
                yield from group
            elif isinstance(item, RetainedItemsItem):
                continue  # cache payload, not drawn in place
            else:
                yield item

    def _alloc_spatial_index(self) -> int:
        idx = len(self.spatial_tree.nodes)
        return idx

    # ------------------------------------------------------------------
    def _build_pipeline(self, dl, ns: Tuple[int, int], target: PicturePrim,
                        offset: Point2D, extra_clips: Tuple[int, ...]) -> None:
        """Traverse one pipeline's display list (build_all :872)."""
        sc_stack: List[_StackingContext] = [
            _StackingContext(target, offset, extra_clips)]
        rf_stack: List[int] = []  # global indices of pushed reference frames
        shadow: Optional[_ShadowState] = None
        items = iter(self._expand_cached(dl, ns))

        for item in items:
            top = sc_stack[-1]

            # --- structure ------------------------------------------------
            if isinstance(item, PushStackingContextItem):
                spatial = self._spatial(ns, item.spatial_id)
                chain = self._resolve_chain(ns, item.clip_chain_id)
                new_offset = Point2D(top.offset.x + item.origin.x,
                                     top.offset.y + item.origin.y)
                composite = self._composite_ops(item, new_offset)
                if any(self.clip_store.nodes[i].kind != ClipKind.RECT
                       for i in chain):
                    # clip_chain_has_complex_clips → BlitReason::CLIP
                    composite = dataclasses.replace(composite,
                                                    has_complex_clip=True)
                pic = PicturePrim(
                    common=PrimCommon(Rect(-1e9, -1e9, 2e9, 2e9),
                                      Rect(-1e9, -1e9, 2e9, 2e9),
                                      spatial,
                                      clip_chain=chain + top.extra_clips,
                                      is_backface_visible=bool(
                                          item.prim_flags
                                          & PrimitiveFlags.IS_BACKFACE_VISIBLE)),
                    composite=composite,
                    raster_space=item.raster_space,
                )
                sc_backface = top.backface_cull_spatial
                if not (item.prim_flags & PrimitiveFlags.IS_BACKFACE_VISIBLE):
                    sc_backface = spatial
                participating = composite.preserve_3d or \
                    (top.is_3d and not composite.needs_surface)
                new_cb = top.containing_block if participating else spatial
                new_is3d = composite.preserve_3d
                if item.flags & StackingContextFlags.WRAPS_BACKDROP_FILTER:
                    # the SC only wraps a backdrop-filter so CSS filters can
                    # apply to its output: stay pass-through and fold the
                    # filters into the backdrop prim (scene_building.rs:3753)
                    sc_stack.append(_StackingContext(
                        top.picture, new_offset, top.extra_clips + chain,
                        sc_backface,
                        top.wrap_filters + tuple(item.filters),
                        new_cb, new_is3d))
                    continue
                # direct children of a preserve-3d context stay grouped so
                # flat subtrees sort as single planes (split/order-2.yaml)
                if composite.needs_grouping or \
                        top.picture.composite.preserve_3d:
                    pic.common.backface_cull_spatial = sc_backface
                    pic.common.containing_block = top.containing_block
                    top.picture.children.append(pic)
                    sc_stack.append(_StackingContext(pic, new_offset, (),
                                                     sc_backface, (),
                                                     new_cb, new_is3d))
                else:
                    # pass-through: children flatten into parent picture with
                    # SC clips applied to each (scene_building.rs collapses
                    # no-op stacking contexts the same way).
                    sc_stack.append(_StackingContext(
                        top.picture, new_offset,
                        top.extra_clips + chain, sc_backface,
                        top.wrap_filters, new_cb, new_is3d))
                continue

            if isinstance(item, PopStackingContextItem):
                assert len(sc_stack) > 1, "unbalanced pop_stacking_context"
                sc_stack.pop()
                continue

            if isinstance(item, PushReferenceFrameItem):
                parent = self._spatial(ns, item.parent_spatial_id)
                origin = Point2D(item.origin.x + top.offset.x,
                                 item.origin.y + top.offset.y)
                gidx = self._alloc_spatial_index()
                transform = item.transform
                if item.computed is not None:
                    transform = self._resolve_computed(item.computed)
                binding = getattr(transform, "binding_key", None)
                self.spatial_tree.add_reference_frame(
                    gidx, parent, origin, transform,
                    transform_binding=binding,
                    is_perspective=item.kind == ReferenceFrameKind.PERSPECTIVE,
                    preserves_3d=item.transform_style == TransformStyle.PRESERVE_3D)
                self.spatial_map[(ns, item.id.index)] = gidx
                rf_stack.append(gidx)
                # Inside the new reference frame the lexical offset restarts:
                # it was consumed by the frame origin (rf_mapper semantics).
                sc_stack.append(_StackingContext(top.picture, Point2D(0, 0),
                                                 top.extra_clips,
                                                 top.backface_cull_spatial))
                continue

            if isinstance(item, PopReferenceFrameItem):
                sc_stack.pop()
                rf_stack.pop()
                continue

            if isinstance(item, ScrollFrameItem):
                parent = self._spatial(ns, item.parent_spatial_id)
                gidx = self._alloc_spatial_index()
                self.spatial_tree.add_scroll_frame(
                    gidx, parent,
                    frame_rect=item.frame_rect.translate(top.offset.x, top.offset.y),
                    content_rect=item.content_rect.translate(top.offset.x, top.offset.y),
                    external_id=item.external_id,
                    external_scroll_offset=item.external_scroll_offset,
                    scroll_generation=item.scroll_generation,
                    has_scroll_linked_effect=item.has_scroll_linked_effect)
                self.spatial_map[(ns, item.id.index)] = gidx
                continue

            if isinstance(item, StickyFrameItem):
                parent = self._spatial(ns, item.parent_spatial_id)
                gidx = self._alloc_spatial_index()
                moved = dataclasses.replace(
                    item, bounds=item.bounds.translate(top.offset.x, top.offset.y))
                self.spatial_tree.add_sticky_frame(gidx, parent, moved)
                self.spatial_map[(ns, item.id.index)] = gidx
                continue

            # --- clips ----------------------------------------------------
            if isinstance(item, RectClipItem):
                node = ClipNode(ClipKind.RECT,
                                self._spatial(ns, item.spatial_id),
                                item.clip_rect.translate(top.offset.x, top.offset.y))
                idx = self.clip_store.add_node(node)
                self.clip_store.register_clip_id(hash(ns), item.id.index, idx)
                continue

            if isinstance(item, RoundedRectClipItem):
                node = ClipNode(ClipKind.ROUNDED_RECT,
                                self._spatial(ns, item.spatial_id),
                                item.rect.translate(top.offset.x, top.offset.y),
                                radii=item.radii, mode=item.mode)
                idx = self.clip_store.add_node(node)
                self.clip_store.register_clip_id(hash(ns), item.id.index, idx)
                continue

            if isinstance(item, ImageMaskClipItem):
                node = ClipNode(ClipKind.IMAGE_MASK,
                                self._spatial(ns, item.spatial_id),
                                item.rect.translate(top.offset.x, top.offset.y),
                                image_key=item.image_key,
                                points=item.points, fill_rule=item.fill_rule)
                idx = self.clip_store.add_node(node)
                self.clip_store.register_clip_id(hash(ns), item.id.index, idx)
                continue

            if isinstance(item, ClipChainItem):
                nodes = tuple(self.clip_store.node_for_clip_id(hash(ns), c.index)
                              for c in item.clips)
                parent = None
                if item.parent is not None and item.parent.index >= 0:
                    parent = (hash(ns), item.parent.index)
                self.clip_store.define_chain(hash(ns), item.id.index, parent, nodes)
                continue

            # --- shadows --------------------------------------------------
            if isinstance(item, PushShadowItem):
                if shadow is None:
                    shadow = _ShadowState()
                sh = item.shadow
                shadow.shadows.append(sh)
                spatial = self._spatial(ns, item.common.spatial_id)
                chain = self._resolve_chain(ns, item.common.clip_chain_id)
                # each shadow gets its own picture, blurred at composite time
                pic = PicturePrim(
                    common=PrimCommon(Rect(-1e9, -1e9, 2e9, 2e9),
                                      Rect(-1e9, -1e9, 2e9, 2e9), spatial,
                                      clip_chain=chain + top.extra_clips),
                    composite=CompositeOps(),
                    shadow=sh,
                )
                shadow.shadow_pics.append(pic)
                continue

            if isinstance(item, PopAllShadowsItem):
                if shadow is not None:
                    for pic in shadow.shadow_pics:
                        if not pic.children:
                            continue
                        if pic.shadow.blur_radius <= 0:
                            # fast path (scene_building.rs push_shadow
                            # should_inflate/fast shadows): blur-0 shadows
                            # draw directly — no surface, so root text keeps
                            # subpixel AA (text/shadow-fast-clip.yaml)
                            top.picture.children.extend(pic.children)
                        else:
                            top.picture.children.append(pic)
                    top.picture.children.extend(shadow.originals)
                    shadow = None
                continue

            # --- iframe ---------------------------------------------------
            if isinstance(item, IframeItem):
                self._build_iframe(item, ns, top)
                continue

            # --- primitives -----------------------------------------------
            prim = self._build_prim(item, ns, top)
            if prim is None:
                continue
            if shadow is not None and shadow.shadows:
                if isinstance(prim, self.SHADOWABLE):
                    for sh, pic in zip(shadow.shadows, shadow.shadow_pics):
                        pic.children.append(self._shadow_copy(prim, sh))
                shadow.originals.append(prim)
            else:
                top.picture.children.append(prim)

    # ------------------------------------------------------------------
    def _build_iframe(self, item: IframeItem, ns: Tuple[int, int],
                      top: _StackingContext) -> None:
        """scene_building.rs build_iframe: nested pipeline becomes a child
        reference frame + scroll frame, clipped to the iframe rect."""
        key = (item.pipeline_id.namespace, item.pipeline_id.id)
        dl = self.scene.pipelines.get(key)
        if dl is None:
            assert item.ignore_missing_pipeline, f"missing pipeline {key}"
            return
        parent = self._spatial(ns, item.spatial_id)
        bounds = item.bounds.translate(top.offset.x, top.offset.y)
        clip_rect = item.clip_rect.translate(top.offset.x, top.offset.y)

        rf = self._alloc_spatial_index()
        self.spatial_tree.add_reference_frame(
            rf, parent, bounds.origin, Transform.identity())
        scroll = self._alloc_spatial_index()
        self.spatial_tree.add_scroll_frame(
            scroll, rf, frame_rect=Rect(0, 0, bounds.w, bounds.h),
            content_rect=Rect(0, 0, bounds.w, bounds.h),
            external_id=0, external_scroll_offset=Point2D(0, 0))
        self.spatial_map[(key, 0)] = rf
        self.spatial_map[(key, 1)] = scroll

        # the iframe clips by the item's clip_rect ONLY — bounds position
        # the pipeline but do not clip it (push_iframe :1215 uses
        # info.clip_rect; crash/iframe-dup.yaml draws outside bounds)
        clip = self.clip_store.add_node(ClipNode(
            ClipKind.RECT, parent, clip_rect))
        self.iframe_size.append(Size2D(bounds.w, bounds.h))
        self._build_pipeline(dl, key, top.picture, Point2D(0, 0),
                             top.extra_clips + (clip,))
        self.iframe_size.pop()

    # ------------------------------------------------------------------
    def _resolve_computed(self, computed) -> Transform:
        """ReferenceTransformBinding::Computed → matrix, from the content
        size of the enclosing iframe (scene_building.rs:1091-1137)."""
        from ..api.display_item import Rotation
        cs = self.iframe_size[-1] if self.iframe_size else \
            Size2D(*getattr(self.scene, "viewport_size", (1024, 768)))
        quarter = computed.rotation in (Rotation.DEGREE_90,
                                        Rotation.DEGREE_270)
        if computed.scale_from is not None:
            sf = computed.scale_from
            if quarter:
                # 90/270: scale_from and content size live in swapped axes
                t = Transform.scale(cs.height / sf.width, cs.width / sf.height)
            else:
                t = Transform.scale(cs.width / sf.width, cs.height / sf.height)
        else:
            t = Transform.identity()
        if computed.vertical_flip:
            content_h = cs.width if quarter else cs.height
            t = Transform.scale(1.0, -1.0).then(t) \
                .then(Transform.translation(0.0, content_h))
        # Rotation::to_matrix (display_item.rs:811-837): shift the (possibly
        # axis-swapped) content box's center to the origin, rotate, shift
        # back to the box center in the rotated space.
        deg = computed.rotation.value
        if deg:
            if quarter:
                shift = Transform.translation(-cs.height / 2.0, -cs.width / 2.0)
            else:
                shift = Transform.translation(-cs.width / 2.0, -cs.height / 2.0)
            rot = shift.then(Transform.rotation_z(float(deg))) \
                .then(Transform.translation(cs.width / 2.0, cs.height / 2.0))
            t = t.then(rot)
        return t

    # ------------------------------------------------------------------
    def _composite_ops(self, item: PushStackingContextItem,
                       offset: Point2D = Point2D()) -> CompositeOps:
        filters = item.filters
        if any(f.svgfe is not None for f in filters):
            moved = []
            for f in filters:
                if f.svgfe is not None:
                    node = dict(f.svgfe)
                    if node["subregion"] is not None:
                        node["subregion"] = node["subregion"].translate(
                            offset.x, offset.y)
                    moved.append(dataclasses.replace(f, svgfe=node))
                else:
                    moved.append(f)
            filters = tuple(moved)
        # composite ops force the used transform-style to flat: an SC with
        # filters/mix-blend does not participate in (or establish) a 3D
        # rendering context (scene_building.rs:2207
        # participating_in_3d_context requires composite_ops.is_empty())
        nontrivial = [f for f in filters
                      if not (f.kind.name == "OPACITY" and f.value >= 1.0)]
        ops_empty = not nontrivial and \
            item.mix_blend_mode == MixBlendMode.NORMAL
        return CompositeOps(
            filters=filters,
            filter_datas=item.filter_datas,
            mix_blend_mode=item.mix_blend_mode,
            is_blend_container=bool(
                item.flags & StackingContextFlags.IS_BLEND_CONTAINER),
            preserve_3d=(item.transform_style == TransformStyle.PRESERVE_3D
                         and ops_empty),
        )

    def _spatial(self, ns: Tuple[int, int], sid: SpatialId) -> int:
        return self.spatial_map[(ns, sid.index)]

    def _resolve_chain(self, ns: Tuple[int, int], chain_id) -> Tuple[int, ...]:
        if chain_id is None or chain_id.index < 0:
            return ()
        return self.clip_store.resolve_chain(hash(ns), chain_id.index)

    def _common(self, item_common: CommonItemProperties, ns: Tuple[int, int],
                top: _StackingContext, bounds: Rect) -> PrimCommon:
        return PrimCommon(
            local_rect=bounds.translate(top.offset.x, top.offset.y),
            clip_rect=item_common.clip_rect.translate(top.offset.x, top.offset.y),
            spatial_node=self._spatial(ns, item_common.spatial_id),
            clip_chain=self._resolve_chain(ns, item_common.clip_chain_id)
            + top.extra_clips,
            is_backface_visible=bool(item_common.flags
                                     & PrimitiveFlags.IS_BACKFACE_VISIBLE),
            backface_cull_spatial=top.backface_cull_spatial,
            containing_block=top.containing_block,
        )

    def _shadow_copy(self, prim, sh: Shadow):
        """Tinted, offset copy of a prim for a shadow pass
        (scene_building.rs push_shadow :2879 semantics)."""
        c = prim.common
        moved = dataclasses.replace(
            c, local_rect=c.local_rect.translate(sh.offset.x, sh.offset.y),
            clip_rect=c.clip_rect.translate(sh.offset.x, sh.offset.y))
        copy = dataclasses.replace(prim, common=moved)
        if isinstance(copy, TextRunPrim):
            copy = dataclasses.replace(
                copy, color=sh.color, shadow=True,
                glyphs=tuple((g, x + sh.offset.x, y + sh.offset.y)
                             for (g, x, y) in prim.glyphs))
        elif isinstance(copy, NormalBorderPrim):
            from ..api.display_item import BorderSide, NormalBorder
            b = copy.border
            def tint(side):
                return BorderSide(sh.color, side.style)
            copy = dataclasses.replace(copy, border=NormalBorder(
                tint(b.left), tint(b.right), tint(b.top), tint(b.bottom),
                b.radius, b.do_aa))
        elif hasattr(copy, "color"):
            copy = dataclasses.replace(copy, color=sh.color)
        return copy

    # ------------------------------------------------------------------
    def _build_prim(self, item, ns: Tuple[int, int], top: _StackingContext):
        """build_item (:1370): one display item → one scene primitive."""
        if isinstance(item, RectangleItem):
            return RectanglePrim(self._common(item.common, ns, top, item.bounds),
                                 item.color)
        if isinstance(item, ClearRectangleItem):
            return ClearPrim(self._common(item.common, ns, top, item.bounds))
        if isinstance(item, HitTestItem):
            self.hit_test_items.append(HitTestEntry(
                self._common(item.common, ns, top, item.bounds), item.tag))
            return None
        if isinstance(item, LineItem):
            return LineDecorationPrim(
                self._common(item.common, ns, top, item.area),
                item.orientation, item.style, item.color,
                item.wavy_line_thickness)
        if isinstance(item, TextItem):
            common = self._common(item.common, ns, top, item.bounds)
            glyphs = tuple((g, x + top.offset.x, y + top.offset.y)
                           for (g, x, y) in item.glyphs)
            return TextRunPrim(common, item.font_instance_key, glyphs,
                               item.color,
                               frame_offset=(top.offset.x, top.offset.y))
        if isinstance(item, ImageItem):
            common = self._common(item.common, ns, top, item.bounds)
            return ImagePrim(common, item.image_key,
                             stretch_size=item.bounds.size,
                             image_rendering=item.image_rendering,
                             alpha_type=item.alpha_type, color=item.color)
        if isinstance(item, RepeatingImageItem):
            common = self._common(item.common, ns, top, item.bounds)
            return ImagePrim(common, item.image_key,
                             stretch_size=item.stretch_size,
                             tile_spacing=item.tile_spacing,
                             image_rendering=item.image_rendering,
                             alpha_type=item.alpha_type, color=item.color)
        if isinstance(item, YuvImageItem):
            common = self._common(item.common, ns, top, item.bounds)
            return YuvImagePrim(common, item.yuv_keys, item.format,
                                item.color_depth, item.color_space,
                                item.color_range, item.image_rendering)
        if isinstance(item, GradientItem):
            common = self._common(item.common, ns, top, item.bounds)
            return LinearGradientPrim(common, item.gradient, item.stops,
                                      item.tile_size, item.tile_spacing)
        if isinstance(item, RadialGradientItem):
            common = self._common(item.common, ns, top, item.bounds)
            return RadialGradientPrim(common, item.gradient, item.stops,
                                      item.tile_size, item.tile_spacing)
        if isinstance(item, ConicGradientItem):
            common = self._common(item.common, ns, top, item.bounds)
            return ConicGradientPrim(common, item.gradient, item.stops,
                                     item.tile_size, item.tile_spacing)
        if isinstance(item, BorderItem):
            common = self._common(item.common, ns, top, item.bounds)
            if item.details_normal is not None:
                return NormalBorderPrim(common, item.details_normal, item.widths)
            return NinePatchBorderPrim(common, item.details_nine_patch,
                                       item.widths)
        if isinstance(item, BoxShadowItem):
            common = self._common(item.common, ns, top, item.box_bounds)
            return BoxShadowPrim(common, common.local_rect, item.offset,
                                 item.color, item.blur_radius,
                                 item.spread_radius, item.border_radius,
                                 item.clip_mode)
        if isinstance(item, BackdropFilterItem):
            common = self._common(item.common, ns, top, item.common.clip_rect)
            filters = tuple(item.filters) + tuple(top.wrap_filters)
            return BackdropFilterPrim(common, filters, item.filter_datas)
        raise NotImplementedError(f"display item {type(item).__name__}")


def build_scene(scene: Scene,
                background_color: Optional[ColorF] = None) -> BuiltScene:
    return SceneBuilder(scene, background_color).build()
