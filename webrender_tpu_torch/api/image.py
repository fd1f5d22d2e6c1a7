"""Image resources — mirrors `webrender_api/src/image.rs`."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class ImageFormat(enum.Enum):
    """image.rs ImageFormat."""
    R8 = 1
    R16 = 2
    BGRA8 = 3
    RGBAF32 = 4
    RG8 = 5
    RGBAI32 = 6
    RGBA8 = 7

    @property
    def bytes_per_pixel(self) -> int:
        return {
            ImageFormat.R8: 1, ImageFormat.R16: 2, ImageFormat.BGRA8: 4,
            ImageFormat.RGBAF32: 16, ImageFormat.RG8: 2,
            ImageFormat.RGBAI32: 16, ImageFormat.RGBA8: 4,
        }[self]


class ImageDescriptorFlags(enum.IntFlag):
    NONE = 0
    IS_OPAQUE = 1 << 0
    ALLOW_MIPMAPS = 1 << 1


@dataclass(frozen=True)
class ImageDescriptor:
    """image.rs ImageDescriptor."""
    format: ImageFormat
    width: int
    height: int
    stride: Optional[int] = None
    offset: int = 0
    flags: ImageDescriptorFlags = ImageDescriptorFlags.NONE

    @property
    def is_opaque(self) -> bool:
        return bool(self.flags & ImageDescriptorFlags.IS_OPAQUE)


@dataclass
class ImageData:
    """Raw image bytes, a generator callback (blob analog), or an
    external-image reference (image.rs ImageData::External :374).

    `pixels` is an (h, w, c) uint8/uint16/float32 numpy array in the channel
    order implied by the format (BGRA8 stays byte-order BGRA like the
    reference; internally the renderer converts to RGBA float).
    `solid` stores a single texel for constant images (huge solid-color
    test images are not materialized).
    `external` defers the texel source to the renderer's registered
    ExternalImageHandler, locked per frame.
    """
    pixels: Optional[np.ndarray] = None
    blob: Optional[bytes] = None  # serialized blob commands (BlobImageData)
    solid: Optional[tuple] = None  # single texel, same channel order
    external: Optional["ExternalImageData"] = None


@dataclass(frozen=True)
class DirtyRect:
    """Partial update rect for update_image; None = whole image."""
    x: int = 0
    y: int = 0
    w: int = 0
    h: int = 0
    all: bool = True


@dataclass(frozen=True)
class ExternalImageId:
    id: int


class ExternalImageType(enum.Enum):
    TEXTURE_HANDLE = 0
    BUFFER = 1


@dataclass(frozen=True)
class ExternalImageData:
    """image.rs ExternalImageData: the texel source lives outside the
    resource cache and is locked/unlocked around each frame by the
    registered ExternalImageHandler."""
    id: ExternalImageId
    channel_index: int = 0
    image_type: ExternalImageType = ExternalImageType.BUFFER


@dataclass
class ExternalImage:
    """renderer ExternalImage lock result: texels (device or host array)
    + the uv sub-rect to sample (uv defaults to the full image)."""
    pixels: np.ndarray
    uv: Optional[tuple] = None
    generation: Optional[int] = None  # unchanged generation skips re-upload


class ExternalImageHandler:
    """renderer::ExternalImageHandler protocol (renderer/mod.rs): lock
    returns the current texels for (id, channel); unlock releases them
    after the frame's uploads are consumed."""

    def lock(self, id: ExternalImageId, channel_index: int) -> ExternalImage:
        raise NotImplementedError

    def unlock(self, id: ExternalImageId, channel_index: int) -> None:
        pass
