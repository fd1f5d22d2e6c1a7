"""Font API — mirrors `webrender_api/src/font.rs`."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Tuple


class FontRenderMode(enum.Enum):
    """font.rs FontRenderMode: mono (1-bit), alpha (grayscale AA),
    subpixel (per-channel AA / dual-source blending)."""
    MONO = 0
    ALPHA = 1
    SUBPIXEL = 2


class SubpixelDirection(enum.Enum):
    NONE = 0
    HORIZONTAL = 1
    VERTICAL = 2


@dataclass(frozen=True)
class FontKey:
    namespace: int = 0
    key: int = 0


@dataclass(frozen=True)
class FontVariation:
    tag: int = 0
    value: float = 0.0


@dataclass(frozen=True)
class SyntheticItalics:
    angle_deg: float = 0.0


class FontInstanceFlags(enum.IntFlag):
    NONE = 0
    SYNTHETIC_BOLD = 1 << 1
    EMBEDDED_BITMAPS = 1 << 2
    SUBPIXEL_BGR = 1 << 3
    TRANSPOSE = 1 << 4
    FLIP_X = 1 << 5
    FLIP_Y = 1 << 6
    FORCE_GDI = 1 << 16
    FONT_SMOOTHING = 1 << 16


@dataclass(frozen=True)
class FontInstanceOptions:
    render_mode: FontRenderMode = FontRenderMode.SUBPIXEL
    flags: FontInstanceFlags = FontInstanceFlags.NONE
    bg_color: Tuple[int, int, int, int] = (0, 0, 0, 0)
    synthetic_italics: SyntheticItalics = SyntheticItalics()


@dataclass(frozen=True)
class FontInstanceKey:
    namespace: int = 0
    key: int = 0


@dataclass(frozen=True)
class GlyphInstance:
    """font.rs GlyphInstance: glyph index + layout-space point."""
    index: int
    x: float
    y: float


@dataclass(frozen=True)
class GlyphDimensions:
    left: int
    top: int
    width: int
    height: int
    advance: float
