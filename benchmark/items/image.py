"""An image drawn at its own size on whole pixels: each pixel takes the
one texel under its centre (premultiplied RGBA8)."""
import numpy as np

OPS = 24 + 4 * 28    # the translation path: the uv and four texel planes


def push(A, b, common, item):
    x0, y0, x1, y1 = item.rect
    b.push_image(common, A.Rect(x0, y0, x1 - x0, y1 - y0),
                 A.ImageRendering.AUTO, A.AlphaType.PREMULTIPLIED_ALPHA,
                 item.key)


def source(item, state, quantize):
    x0, y0, x1, y1 = item.rect
    px = state.images[item.key]
    if px.shape[:2] != (y1 - y0, x1 - x0):
        raise ValueError(f"image {item.key} is {px.shape[1]}x{px.shape[0]}"
                         f" but drawn at {x1 - x0}x{y1 - y0}: the reference"
                         " draws images at their own size only")
    return np.asarray(quantize(px), np.int32)
