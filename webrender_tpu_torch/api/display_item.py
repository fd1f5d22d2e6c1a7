"""Display item types — the retained drawing commands.

Mirrors the `DisplayItem` enum of `webrender_api/src/display_item.rs:164`:
Rectangle, ClearRectangle, HitTest, Text, Line, Border, BoxShadow, PushShadow,
Gradient/RadialGradient/ConicGradient, Image, RepeatingImage, YuvImage,
BackdropFilter, clips (RectClip, RoundedRectClip, ImageMaskClip, ClipChain),
Iframe, Push/PopReferenceFrame, Push/PopStackingContext, PopAllShadows.

Represented as Python dataclasses; a display list is a list of these records.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from .color import ColorF
from .units import Point2D, Rect, SideOffsets, Size2D, Transform

# ---------------------------------------------------------------------------
# IDs


@dataclass(frozen=True)
class PipelineId:
    namespace: int = 0
    id: int = 0

    @staticmethod
    def dummy() -> "PipelineId":
        return PipelineId(0, 0)


@dataclass(frozen=True)
class SpatialId:
    """Index into the spatial tree (`display_item.rs` SpatialId)."""
    index: int
    pipeline: PipelineId = PipelineId.dummy()

    @staticmethod
    def root_reference_frame(pipeline: PipelineId = PipelineId.dummy()) -> "SpatialId":
        return SpatialId(0, pipeline)

    @staticmethod
    def root_scroll_node(pipeline: PipelineId = PipelineId.dummy()) -> "SpatialId":
        return SpatialId(1, pipeline)


@dataclass(frozen=True)
class ClipId:
    """Index of a clip node defined in the display list."""
    index: int
    pipeline: PipelineId = PipelineId.dummy()

    @staticmethod
    def invalid() -> "ClipId":
        return ClipId(-1)


@dataclass(frozen=True)
class ClipChainId:
    """A defined clip chain (`display_item.rs` ClipChainId)."""
    index: int
    pipeline: PipelineId = PipelineId.dummy()

    @staticmethod
    def invalid() -> "ClipChainId":
        return ClipChainId(-1)


ROOT_CLIP_CHAIN = ClipChainId(-2)  # "no extra clips" sentinel


# ---------------------------------------------------------------------------
# Enums


class ClipMode(enum.Enum):
    CLIP = 0       # pixels inside the shape are kept
    CLIP_OUT = 1   # pixels inside the shape are removed


class BorderStyle(enum.Enum):
    NONE = 0
    SOLID = 1
    DOUBLE = 2
    DOTTED = 3
    DASHED = 4
    HIDDEN = 5
    GROOVE = 6
    RIDGE = 7
    INSET = 8
    OUTSET = 9


class LineOrientation(enum.Enum):
    VERTICAL = 0
    HORIZONTAL = 1


class LineStyle(enum.Enum):
    SOLID = 0
    DOTTED = 1
    DASHED = 2
    WAVY = 3


class ExtendMode(enum.Enum):
    CLAMP = 0
    REPEAT = 1


class MixBlendMode(enum.Enum):
    NORMAL = 0
    MULTIPLY = 1
    SCREEN = 2
    OVERLAY = 3
    DARKEN = 4
    LIGHTEN = 5
    COLOR_DODGE = 6
    COLOR_BURN = 7
    HARD_LIGHT = 8
    SOFT_LIGHT = 9
    DIFFERENCE = 10
    EXCLUSION = 11
    HUE = 12
    SATURATION = 13
    COLOR = 14
    LUMINOSITY = 15
    PLUS_LIGHTER = 16


class TransformStyle(enum.Enum):
    FLAT = 0
    PRESERVE_3D = 1


class RasterSpace(enum.Enum):
    SCREEN = 0
    LOCAL = 1


class BoxShadowClipMode(enum.Enum):
    OUTSET = 0
    INSET = 1


class ImageRendering(enum.Enum):
    AUTO = 0
    CROSP_EDGES = 1
    PIXELATED = 2


class AlphaType(enum.Enum):
    ALPHA = 0
    PREMULTIPLIED_ALPHA = 1


class YuvColorSpace(enum.Enum):
    REC601 = 0
    REC709 = 1
    REC2020 = 2
    IDENTITY = 3


class ColorRange(enum.Enum):
    LIMITED = 0
    FULL = 1


class ColorDepth(enum.Enum):
    COLOR8 = 0
    COLOR10 = 1
    COLOR12 = 2
    COLOR16 = 3


class PrimitiveFlags(enum.IntFlag):
    """`webrender_api/src/lib.rs` PrimitiveFlags."""
    NONE = 0
    IS_BACKFACE_VISIBLE = 1 << 0
    IS_SCROLLBAR_CONTAINER = 1 << 1
    PREFER_COMPOSITOR_SURFACE = 1 << 2
    SUPPORTS_EXTERNAL_COMPOSITOR_SURFACE = 1 << 3
    ANTIALISED = 1 << 4
    CHECKERBOARD_BACKGROUND = 1 << 5


# ---------------------------------------------------------------------------
# Filters (stacking-context filter chain; display_item.rs FilterOp :1254)


class FilterOpKind(enum.Enum):
    IDENTITY = 0
    BLUR = 1
    BRIGHTNESS = 2
    CONTRAST = 3
    GRAYSCALE = 4
    HUE_ROTATE = 5
    INVERT = 6
    OPACITY = 7
    SATURATE = 8
    SEPIA = 9
    DROP_SHADOW = 10
    COLOR_MATRIX = 11
    SRGB_TO_LINEAR = 12
    LINEAR_TO_SRGB = 13
    COMPONENT_TRANSFER = 14
    FLOOD = 15
    SVG_GRAPH = 16


@dataclass(frozen=True)
class Shadow:
    offset: Point2D = field(default_factory=Point2D)
    color: ColorF = ColorF.BLACK
    blur_radius: float = 0.0
    should_inflate: bool = True


@dataclass(frozen=True)
class FilterOp:
    kind: FilterOpKind
    # BLUR: (value, value2) = (std_dev_x, std_dev_y); scalar filters use value;
    # DROP_SHADOW uses shadow; COLOR_MATRIX uses matrix (20 floats, row major
    # 4x5 as in display_item.rs).
    value: float = 0.0
    value2: float = 0.0
    shadow: Optional[Shadow] = None
    matrix: Optional[Tuple[float, ...]] = None
    # SVGFE graph node payload (display_item.rs FilterOpGraphNode):
    # {op, linear, subregion, in1, in2, value, color, matrix, dx, dy,
    #  std_x, std_y, filter_data}
    svgfe: Optional[dict] = None

    @staticmethod
    def opacity(a: float) -> "FilterOp":
        return FilterOp(FilterOpKind.OPACITY, a)

    @staticmethod
    def blur(sx: float, sy: float) -> "FilterOp":
        return FilterOp(FilterOpKind.BLUR, sx, sy)


class ComponentTransferFuncType(enum.Enum):
    IDENTITY = 0
    TABLE = 1
    DISCRETE = 2
    LINEAR = 3
    GAMMA = 4


@dataclass(frozen=True)
class FilterData:
    """Per-channel component transfer functions (display_item.rs FilterData)."""
    func_r: ComponentTransferFuncType = ComponentTransferFuncType.IDENTITY
    func_g: ComponentTransferFuncType = ComponentTransferFuncType.IDENTITY
    func_b: ComponentTransferFuncType = ComponentTransferFuncType.IDENTITY
    func_a: ComponentTransferFuncType = ComponentTransferFuncType.IDENTITY
    values_r: Tuple[float, ...] = ()
    values_g: Tuple[float, ...] = ()
    values_b: Tuple[float, ...] = ()
    values_a: Tuple[float, ...] = ()


# ---------------------------------------------------------------------------
# Gradients


@dataclass(frozen=True)
class GradientStop:
    offset: float
    color: ColorF


@dataclass(frozen=True)
class Gradient:
    start_point: Point2D
    end_point: Point2D
    extend_mode: ExtendMode = ExtendMode.CLAMP


@dataclass(frozen=True)
class RadialGradient:
    center: Point2D
    radius: Size2D
    start_offset: float = 0.0
    end_offset: float = 1.0
    extend_mode: ExtendMode = ExtendMode.CLAMP


@dataclass(frozen=True)
class ConicGradient:
    center: Point2D
    angle: float = 0.0  # radians
    start_offset: float = 0.0
    end_offset: float = 1.0
    extend_mode: ExtendMode = ExtendMode.CLAMP


# ---------------------------------------------------------------------------
# Common per-item properties


@dataclass(frozen=True)
class CommonItemProperties:
    """display_item.rs CommonItemProperties: clip rect + chain + spatial node."""
    clip_rect: Rect
    spatial_id: SpatialId
    clip_chain_id: ClipChainId = ROOT_CLIP_CHAIN
    flags: PrimitiveFlags = PrimitiveFlags.IS_BACKFACE_VISIBLE


# ---------------------------------------------------------------------------
# Items


@dataclass(frozen=True)
class RectangleItem:
    common: CommonItemProperties
    bounds: Rect
    color: ColorF


@dataclass(frozen=True)
class ClearRectangleItem:
    common: CommonItemProperties
    bounds: Rect


@dataclass(frozen=True)
class HitTestItem:
    common: CommonItemProperties
    bounds: Rect
    tag: Tuple[int, int] = (0, 0)


@dataclass(frozen=True)
class LineItem:
    common: CommonItemProperties
    area: Rect
    orientation: LineOrientation = LineOrientation.HORIZONTAL
    wavy_line_thickness: float = 0.0
    color: ColorF = ColorF.BLACK
    style: LineStyle = LineStyle.SOLID


@dataclass(frozen=True)
class TextItem:
    common: CommonItemProperties
    bounds: Rect
    font_instance_key: int = 0
    glyphs: Tuple[Tuple[int, float, float], ...] = ()  # (index, x, y)
    color: ColorF = ColorF.BLACK


@dataclass(frozen=True)
class BorderSide:
    color: ColorF = ColorF.BLACK
    style: BorderStyle = BorderStyle.NONE


@dataclass(frozen=True)
class BorderRadius:
    top_left: Size2D = field(default_factory=Size2D)
    top_right: Size2D = field(default_factory=Size2D)
    bottom_left: Size2D = field(default_factory=Size2D)
    bottom_right: Size2D = field(default_factory=Size2D)

    @staticmethod
    def uniform(r: float) -> "BorderRadius":
        s = Size2D(r, r)
        return BorderRadius(s, s, s, s)

    @property
    def is_zero(self) -> bool:
        return all(
            s.width == 0 and s.height == 0
            for s in (self.top_left, self.top_right, self.bottom_left, self.bottom_right)
        )


@dataclass(frozen=True)
class NormalBorder:
    left: BorderSide = field(default_factory=BorderSide)
    right: BorderSide = field(default_factory=BorderSide)
    top: BorderSide = field(default_factory=BorderSide)
    bottom: BorderSide = field(default_factory=BorderSide)
    radius: BorderRadius = field(default_factory=BorderRadius)
    do_aa: bool = True


class RepeatMode(enum.Enum):
    STRETCH = 0
    REPEAT = 1
    ROUND = 2
    SPACE = 3


@dataclass(frozen=True)
class NinePatchBorder:
    """Image/gradient nine-patch border (display_item.rs NinePatchBorder)."""
    source_kind: str = "image"  # image | gradient | radial-gradient | conic-gradient
    image_key: int = 0
    gradient: Optional[Gradient] = None
    radial_gradient: Optional[RadialGradient] = None
    conic_gradient: Optional[ConicGradient] = None
    stops: Tuple[GradientStop, ...] = ()
    width: int = 0
    height: int = 0
    slice: SideOffsets = field(default_factory=SideOffsets)
    fill: bool = False
    repeat_horizontal: RepeatMode = RepeatMode.STRETCH
    repeat_vertical: RepeatMode = RepeatMode.STRETCH


@dataclass(frozen=True)
class BorderItem:
    common: CommonItemProperties
    bounds: Rect
    widths: SideOffsets = field(default_factory=SideOffsets)
    details_normal: Optional[NormalBorder] = None
    details_nine_patch: Optional[NinePatchBorder] = None


@dataclass(frozen=True)
class BoxShadowItem:
    common: CommonItemProperties
    box_bounds: Rect
    offset: Point2D = field(default_factory=Point2D)
    color: ColorF = ColorF.BLACK
    blur_radius: float = 0.0
    spread_radius: float = 0.0
    border_radius: BorderRadius = field(default_factory=BorderRadius)
    clip_mode: BoxShadowClipMode = BoxShadowClipMode.OUTSET


@dataclass(frozen=True)
class GradientItem:
    common: CommonItemProperties
    bounds: Rect
    gradient: Gradient = None
    stops: Tuple[GradientStop, ...] = ()
    tile_size: Size2D = field(default_factory=Size2D)
    tile_spacing: Size2D = field(default_factory=Size2D)


@dataclass(frozen=True)
class RadialGradientItem:
    common: CommonItemProperties
    bounds: Rect
    gradient: RadialGradient = None
    stops: Tuple[GradientStop, ...] = ()
    tile_size: Size2D = field(default_factory=Size2D)
    tile_spacing: Size2D = field(default_factory=Size2D)


@dataclass(frozen=True)
class ConicGradientItem:
    common: CommonItemProperties
    bounds: Rect
    gradient: ConicGradient = None
    stops: Tuple[GradientStop, ...] = ()
    tile_size: Size2D = field(default_factory=Size2D)
    tile_spacing: Size2D = field(default_factory=Size2D)


@dataclass(frozen=True)
class ImageItem:
    common: CommonItemProperties
    bounds: Rect
    image_key: int = 0
    image_rendering: ImageRendering = ImageRendering.AUTO
    alpha_type: AlphaType = AlphaType.PREMULTIPLIED_ALPHA
    color: ColorF = ColorF.WHITE


@dataclass(frozen=True)
class RepeatingImageItem:
    common: CommonItemProperties
    bounds: Rect
    image_key: int = 0
    stretch_size: Size2D = field(default_factory=Size2D)
    tile_spacing: Size2D = field(default_factory=Size2D)
    image_rendering: ImageRendering = ImageRendering.AUTO
    alpha_type: AlphaType = AlphaType.PREMULTIPLIED_ALPHA
    color: ColorF = ColorF.WHITE


@dataclass(frozen=True)
class YuvImageItem:
    common: CommonItemProperties
    bounds: Rect
    yuv_keys: Tuple[int, ...] = ()          # 1 (interleaved), 2 (NV12), or 3 (planar)
    format: str = "planar"                   # planar | nv12 | interleaved
    color_depth: ColorDepth = ColorDepth.COLOR8
    color_space: YuvColorSpace = YuvColorSpace.REC601
    color_range: ColorRange = ColorRange.LIMITED
    image_rendering: ImageRendering = ImageRendering.AUTO


@dataclass(frozen=True)
class BackdropFilterItem:
    common: CommonItemProperties
    filters: Tuple[FilterOp, ...] = ()
    filter_datas: Tuple[FilterData, ...] = ()


@dataclass(frozen=True)
class PushShadowItem:
    common: CommonItemProperties
    shadow: Shadow = field(default_factory=Shadow)


@dataclass(frozen=True)
class PopAllShadowsItem:
    pass


# --- clips -----------------------------------------------------------------


@dataclass(frozen=True)
class RectClipItem:
    id: ClipId
    spatial_id: SpatialId
    clip_rect: Rect


@dataclass(frozen=True)
class RoundedRectClipItem:
    id: ClipId
    spatial_id: SpatialId
    rect: Rect
    radii: BorderRadius = field(default_factory=BorderRadius)
    mode: ClipMode = ClipMode.CLIP


@dataclass(frozen=True)
class ImageMaskClipItem:
    id: ClipId
    spatial_id: SpatialId
    rect: Rect          # mask placement rect
    image_key: int = 0
    fill_rule: str = "nonzero"
    points: Tuple[Point2D, ...] = ()  # polygon points (SetPoints companion)


@dataclass(frozen=True)
class ClipChainItem:
    id: ClipChainId
    parent: Optional[ClipChainId] = None
    clips: Tuple[ClipId, ...] = ()


# --- structure -------------------------------------------------------------


class ReferenceFrameKind(enum.Enum):
    TRANSFORM = 0
    PERSPECTIVE = 1


class Rotation(enum.Enum):
    """display_item.rs:804 Rotation — quarter-turn applied by a computed
    reference frame (content rendered sideways, e.g. video in a rotated
    iframe)."""
    DEGREE_0 = 0
    DEGREE_90 = 90
    DEGREE_180 = 180
    DEGREE_270 = 270


@dataclass(frozen=True)
class ComputedTransform:
    """ReferenceTransformBinding::Computed (display_item.rs:846-858): the
    transform is derived at scene-build time from the content size of the
    enclosing iframe, so that snapping-induced size changes cannot seam.
    scale_from=None means no scale component."""
    scale_from: Optional[Size2D] = None
    vertical_flip: bool = False
    rotation: Rotation = Rotation.DEGREE_0


@dataclass(frozen=True)
class PushReferenceFrameItem:
    origin: Point2D
    parent_spatial_id: SpatialId
    transform_style: TransformStyle = TransformStyle.FLAT
    transform: Transform = field(default_factory=Transform.identity)
    kind: ReferenceFrameKind = ReferenceFrameKind.TRANSFORM
    id: Optional[SpatialId] = None  # assigned by builder
    computed: Optional[ComputedTransform] = None  # overrides `transform`


@dataclass(frozen=True)
class PopReferenceFrameItem:
    pass


class StackingContextFlags(enum.IntFlag):
    NONE = 0
    IS_BLEND_CONTAINER = 1 << 0
    WRAPS_BACKDROP_FILTER = 1 << 1


@dataclass(frozen=True)
class PushStackingContextItem:
    origin: Point2D
    spatial_id: SpatialId
    prim_flags: PrimitiveFlags = PrimitiveFlags.IS_BACKFACE_VISIBLE
    clip_chain_id: Optional[ClipChainId] = None
    transform_style: TransformStyle = TransformStyle.FLAT
    mix_blend_mode: MixBlendMode = MixBlendMode.NORMAL
    flags: StackingContextFlags = StackingContextFlags.NONE
    raster_space: RasterSpace = RasterSpace.SCREEN
    filters: Tuple[FilterOp, ...] = ()
    filter_datas: Tuple[FilterData, ...] = ()


@dataclass(frozen=True)
class PopStackingContextItem:
    pass


@dataclass(frozen=True)
class IframeItem:
    bounds: Rect
    clip_rect: Rect
    spatial_id: SpatialId
    pipeline_id: PipelineId = PipelineId.dummy()
    ignore_missing_pipeline: bool = True


# --- spatial nodes defined inline in the DL --------------------------------


@dataclass(frozen=True)
class ScrollFrameItem:
    """define_scroll_frame (display_list.rs:2040-2090)."""
    parent_spatial_id: SpatialId
    id: SpatialId
    frame_rect: Rect                   # the viewport
    content_rect: Rect                 # scrollable content bounds
    external_id: int = 0
    external_scroll_offset: Point2D = field(default_factory=Point2D)
    scroll_generation: int = 0
    has_scroll_linked_effect: bool = False


@dataclass(frozen=True)
class StickyFrameItem:
    parent_spatial_id: SpatialId
    id: SpatialId
    bounds: Rect
    margins: Tuple[Optional[float], Optional[float], Optional[float], Optional[float]] = (
        None, None, None, None)  # top, right, bottom, left
    vertical_offset_bounds: Tuple[float, float] = (-1e9, 1e9)
    horizontal_offset_bounds: Tuple[float, float] = (-1e9, 1e9)
    previously_applied_offset: Point2D = field(default_factory=Point2D)


DisplayItem = object  # union of the dataclasses above


@dataclass(frozen=True)
class RetainedItemsItem:
    """display_item.rs DisplayItem::RetainedItems — an item group captured by
    the builder for reuse in later display lists (display_item_cache.rs)."""
    key: int
    items: tuple = ()


@dataclass(frozen=True)
class ReuseItemsItem:
    """display_item.rs DisplayItem::ReuseItems(ItemKey) — splice the cached
    item group `key` here during scene building."""
    key: int
