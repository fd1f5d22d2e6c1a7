"""The plain reference: the page's state composed directly, item by item
in paint order, in NumPy.

It reads only the benchmark's own description of the page (`scene.State`:
the items, their rects and colours, and the texels of each image key) and
composes each item's premultiplied RGBA8 source (`items/<kind>.py`) over
the image as swgl's framebuffer blend does for `src-over`:
`d' = s + d - ((d * sa + d) >> 8)` on 8-bit integers, saturated.  No
scene, frame, atlas, tile or pass of the program takes part.

`quantize` is applied to every colour and texel an item hands in: the
identity for the reference, 4 bits a channel for the control
(`control_quantize`).
"""
from __future__ import annotations

import numpy as np

import scene


def identity(x):
    return x


def control_quantize(x):
    """8-bit values (or [0, 1] floats) kept to 4 bits a channel, the
    precision below the 8 bits the configuration states."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return ((x.astype(np.int32) + 8) // 17 * 17).clip(0, 255).astype(
            np.uint8)
    return np.rint(np.asarray(x, np.float32) * 15.0) / np.float32(15.0)


def compose(state: scene.State, quantize=identity,
            home=scene.HERE) -> np.ndarray:
    """The RGBA8 image (h, w, 4) of `state`, from transparent black."""
    w, h = state.window
    img = np.zeros((h, w, 4), np.int32)
    for item in state.items:
        x0, y0, x1, y1 = item.rect
        src = scene.plugin("items", item.kind, home).source(item, state,
                                                             quantize)
        cx0, cy0 = max(x0, 0), max(y0, 0)
        cx1, cy1 = min(x1, w), min(y1, h)
        if cx1 <= cx0 or cy1 <= cy0:
            continue
        s = src[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0]
        d = img[cy0:cy1, cx0:cx1]
        sa = s[..., 3:4]
        img[cy0:cy1, cx0:cx1] = np.clip(s + d - ((d * sa + d) >> 8), 0, 255)
    return img.astype(np.uint8)
