"""A solid rectangle of one colour, on whole pixels."""
import numpy as np

OPS = 0      # beyond the coverage and the compose


def push(A, b, common, item):
    x0, y0, x1, y1 = item.rect
    b.push_rect(common, A.Rect(x0, y0, x1 - x0, y1 - y0),
                A.ColorF(*item.color))


def source(item, state, quantize):
    """The colour premultiplied in float32 and packed to RGBA8 as swgl
    packs a shader's output (round half to even of v * 255), over the
    rect."""
    x0, y0, x1, y1 = item.rect
    c = np.asarray(quantize(np.asarray(item.color, np.float32)), np.float32)
    premul = np.concatenate([c[:3] * c[3], c[3:]]).astype(np.float32)
    px = np.clip(np.rint(premul * np.float32(255.0)), 0, 255)
    return np.broadcast_to(px.astype(np.int32), (y1 - y0, x1 - x0, 4))
