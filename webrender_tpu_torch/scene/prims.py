"""Scene-level primitives — the output vocabulary of scene building.

Mirrors `webrender/src/prim_store/mod.rs:994` (PrimitiveInstanceKind):
Rectangle, Clear, Image, YuvImage, TextRun, Linear/Radial/Conic gradient,
NormalBorder, ImageBorder, LineDecoration, BoxShadow, Picture. The
reference splits interned templates from instances; here each instance
carries its resolved template data (interning is a host-memory optimization
we apply later only where profiling demands it).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

from ..api.color import ColorF
from ..api.display_item import (
    AlphaType, BorderRadius, BoxShadowClipMode, ClipMode, ColorDepth,
    ColorRange, ConicGradient, ExtendMode, FilterData, FilterOp, Gradient,
    GradientStop, ImageRendering, LineOrientation, LineStyle, MixBlendMode,
    NinePatchBorder, NormalBorder, RadialGradient, RasterSpace, Shadow,
    SideOffsets, TransformStyle, YuvColorSpace,
)
from ..api.units import Point2D, Rect, Size2D


@dataclass
class PrimCommon:
    """Per-instance placement: local rect + spatial node + resolved clips."""
    local_rect: Rect
    clip_rect: Rect              # CommonItemProperties.clip_rect (same space)
    spatial_node: int
    clip_chain: Tuple[int, ...] = ()   # clip node indices into ClipStore
    is_backface_visible: bool = True
    # Set when an enclosing stacking context has backface-visible: false —
    # the SC's own transform orientation culls its children
    # (backface/backface-sc.yaml vs backface-leaf.yaml)
    backface_cull_spatial: Optional[int] = None
    # backface-visibility containing block (scene_building.rs:2214): the
    # nearest non-3d-participating ancestor SC's spatial node — backface
    # orientation is evaluated relative to it, so composite-op-flattened
    # subtrees are never culled by ancestor 3D rotations (split/filter.yaml)
    containing_block: int = 0


@dataclass
class RectanglePrim:
    common: PrimCommon
    color: ColorF


@dataclass
class ClearPrim:
    common: PrimCommon


@dataclass
class ImagePrim:
    common: PrimCommon
    image_key: int
    stretch_size: Size2D            # size of one image tile in local space
    tile_spacing: Size2D = field(default_factory=Size2D)
    image_rendering: ImageRendering = ImageRendering.AUTO
    alpha_type: AlphaType = AlphaType.PREMULTIPLIED_ALPHA
    color: ColorF = ColorF.WHITE


@dataclass
class YuvImagePrim:
    common: PrimCommon
    yuv_keys: Tuple[int, ...]
    format: str
    color_depth: ColorDepth
    color_space: YuvColorSpace
    color_range: ColorRange
    image_rendering: ImageRendering = ImageRendering.AUTO


@dataclass
class TextRunPrim:
    common: PrimCommon
    font_instance_key: int
    glyphs: Tuple[Tuple[int, float, float], ...]
    color: ColorF
    shadow: bool = False        # rendered as part of a shadow pass
    # accumulated stacking-context origin folded into the glyph coords —
    # the snappable part of text_run.rs reference_frame_relative_offset
    # (SC origins in WR accumulate there, not into coordinates)
    frame_offset: Tuple[float, float] = (0.0, 0.0)


@dataclass
class LinearGradientPrim:
    common: PrimCommon
    gradient: Gradient
    stops: Tuple[GradientStop, ...]
    tile_size: Size2D
    tile_spacing: Size2D = field(default_factory=Size2D)


@dataclass
class RadialGradientPrim:
    common: PrimCommon
    gradient: RadialGradient
    stops: Tuple[GradientStop, ...]
    tile_size: Size2D
    tile_spacing: Size2D = field(default_factory=Size2D)


@dataclass
class ConicGradientPrim:
    common: PrimCommon
    gradient: ConicGradient
    stops: Tuple[GradientStop, ...]
    tile_size: Size2D
    tile_spacing: Size2D = field(default_factory=Size2D)


@dataclass
class NormalBorderPrim:
    common: PrimCommon
    border: NormalBorder
    widths: SideOffsets


@dataclass
class NinePatchBorderPrim:
    common: PrimCommon
    border: NinePatchBorder
    widths: SideOffsets


@dataclass
class LineDecorationPrim:
    common: PrimCommon
    orientation: LineOrientation
    style: LineStyle
    color: ColorF
    wavy_line_thickness: float = 0.0


@dataclass
class BoxShadowPrim:
    common: PrimCommon
    box_bounds: Rect             # the shadowed box, local space
    offset: Point2D
    color: ColorF
    blur_radius: float
    spread_radius: float
    border_radius: BorderRadius
    clip_mode: BoxShadowClipMode


@dataclass
class BackdropFilterPrim:
    common: PrimCommon
    filters: Tuple[FilterOp, ...]
    filter_datas: Tuple[FilterData, ...] = ()


@dataclass
class CompositeOps:
    """Why a picture needs an offscreen surface (picture.rs PictureCompositeMode)."""
    filters: Tuple[FilterOp, ...] = ()
    filter_datas: Tuple[FilterData, ...] = ()
    mix_blend_mode: MixBlendMode = MixBlendMode.NORMAL
    is_blend_container: bool = False
    preserve_3d: bool = False
    # BlitReason::CLIP (scene_building.rs:2248): an SC with complex clips
    # on its own chain draws to an off-screen surface so the mask applies
    # ATOMICALLY to the composited group (mask/mask-atomicity.yaml)
    has_complex_clip: bool = False

    @property
    def needs_surface(self) -> bool:
        # Filter::is_noop (internal_types.rs:822): Identity intentionally
        # ISOLATES (forces a surface); opacity(>=1) is a noop
        nontrivial = [f for f in self.filters
                      if not (f.kind.name == "OPACITY" and f.value >= 1.0)]
        return bool(nontrivial) or \
            self.mix_blend_mode != MixBlendMode.NORMAL or \
            self.is_blend_container or self.has_complex_clip

    @property
    def needs_grouping(self) -> bool:
        """Preserve-3d pictures stay grouped for depth sorting even when no
        offscreen surface is required (plane_split / ps_split_composite)."""
        return self.needs_surface or self.preserve_3d


@dataclass
class PicturePrim:
    """A picture: ordered children rendered (maybe) into a surface, then
    composited with CompositeOps (picture.rs PicturePrimitive analog)."""
    common: PrimCommon
    children: List[object] = field(default_factory=list)  # prims + pictures
    composite: CompositeOps = field(default_factory=CompositeOps)
    raster_space: RasterSpace = RasterSpace.SCREEN
    # For shadow pictures: blur + color tint applied at composite
    shadow: Optional[Shadow] = None


Primitive = Union[
    RectanglePrim, ClearPrim, ImagePrim, YuvImagePrim, TextRunPrim,
    LinearGradientPrim, RadialGradientPrim, ConicGradientPrim,
    NormalBorderPrim, NinePatchBorderPrim, LineDecorationPrim, BoxShadowPrim,
    BackdropFilterPrim, PicturePrim,
]
