"""Public API layer — the `webrender_api` crate equivalent (SURVEY.md §2.1)."""
from .color import ColorF, NAMED_COLORS, parse_color
from .display_item import (
    AlphaType, BorderRadius, BorderSide, BorderStyle, BoxShadowClipMode,
    ClipChainId, ClipId, ClipMode, ColorDepth, ColorRange,
    CommonItemProperties, ConicGradient, ExtendMode, FilterData, FilterOp,
    FilterOpKind, Gradient, GradientStop, ImageRendering, LineOrientation,
    LineStyle, MixBlendMode, NinePatchBorder, NormalBorder, PipelineId,
    PrimitiveFlags, RadialGradient, RasterSpace, ReferenceFrameKind,
    RepeatMode, Shadow, SpatialId, StackingContextFlags, TransformStyle,
    YuvColorSpace, ROOT_CLIP_CHAIN,
)
from .display_list import BuiltDisplayList, DisplayListBuilder
from .font import (FontInstanceFlags, FontInstanceKey, FontInstanceOptions,
                   FontKey, FontRenderMode, GlyphInstance)
from .image import (DirtyRect, ImageData, ImageDescriptor,
                    ImageDescriptorFlags, ImageFormat)
from .transaction import (DocumentId, DynamicProperties, Epoch, PropertyValue,
                          RenderReasons, Transaction)
from .units import (Point2D, Rect, ScaleOffset, SideOffsets, Size2D,
                    Transform, MAX_RECT)
