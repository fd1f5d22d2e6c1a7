"""The least work of a frame, reckoned from the benchmark's own page and
what the frame's operations changed, and the least time one H100 needs
for it.

It never reads the program's records, tile size or pass layout, so that
no change to those can move it.  A frame's work has three parts:

* each item is rasterized over the pixels of the region the frame
  changed (`scene.Change.damage`: for a canvas that was put back, its
  rect; for one that moved, the rects it left and took), as far as it
  covers them: its rect's overlap with the damage, times the share of
  its rect that it covers (its kind's `area` over the rect's area; 1 for
  a kind without `area`);
* the texels the frame's updates send are written once;
* the window is composited once: read and written.

Where the least work is open to choice the count charges less: pixels
and texels as RGBA8 (4 bytes), an item only where it meets the damage.
So an honest change cannot read above 100% of it.

The operations per pixel are a frozen copy of the table in the
program's `ops/roofline.py` as it stood when the benchmark was defined
(one add, multiply, divide, floor, compare, min, max or select is one
operation): the coverage and swgl's compose for every item, and each
kind's own work (`items/<kind>.py`'s `OPS`).  The peaks are the
published ones of an H100 SXM at 700 W.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

import scene

PEAK_FP32_FLOPS = 67e12      # H100 SXM, FP32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PIXEL_BYTES = 4              # RGBA8
COVERAGE_OPS = 48
COMPOSE_OPS = 102


def disjoint(rects) -> np.ndarray:
    """[m, 4]: disjoint rects whose union is the union of `rects`."""
    rects = [r for r in rects if r[2] > r[0] and r[3] > r[1]]
    if not rects:
        return np.zeros((0, 4))
    xs = np.unique([v for r in rects for v in (r[0], r[2])])
    ys = np.unique([v for r in rects for v in (r[1], r[3])])
    box = np.asarray(rects, np.float64)
    cx = (xs[:-1] + xs[1:]) / 2
    cy = (ys[:-1] + ys[1:]) / 2
    inside = np.zeros((len(cx), len(cy)), bool)
    for r in box:
        inside |= ((r[0] <= cx) & (cx < r[2]))[:, None] & \
            ((r[1] <= cy) & (cy < r[3]))[None, :]
    i, j = np.nonzero(inside)
    return np.stack([xs[i], ys[j], xs[i + 1], ys[j + 1]], 1)


def covered(items: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """[n]: the area of each item rect ([n, 4]) inside the cells' union."""
    if len(cells) == 0 or len(items) == 0:
        return np.zeros(len(items))
    w = np.minimum(items[:, None, 2], cells[None, :, 2]) - \
        np.maximum(items[:, None, 0], cells[None, :, 0])
    h = np.minimum(items[:, None, 3], cells[None, :, 3]) - \
        np.maximum(items[:, None, 1], cells[None, :, 1])
    return (np.clip(w, 0, None) * np.clip(h, 0, None)).sum(1)


def cover_share(item: scene.Item, home=scene.HERE) -> float:
    """The share of `item`'s rect that it covers: its kind's `area(item)`
    over the rect's area, or 1 where the kind defines no `area` or the
    rect is empty."""
    area = getattr(scene.plugin("items", item.kind, home), "area", None)
    x0, y0, x1, y1 = item.rect
    box = (x1 - x0) * (y1 - y0)
    if area is None or box <= 0:
        return 1.0
    return area(item) / box


def frame_work(state: scene.State, change: scene.Change,
               home=scene.HERE) -> Tuple[float, float]:
    """(operations, bytes) of a frame that left `state` after `change`."""
    w, h = state.window
    win = (0, 0, w, h)
    damage = [(max(r[0], win[0]), max(r[1], win[1]), min(r[2], win[2]),
               min(r[3], win[3])) for r in change.damage]
    cells = disjoint(damage)
    boxes = np.asarray([it.rect for it in state.items],
                       np.float64).reshape(-1, 4)
    per = np.asarray([(COVERAGE_OPS + COMPOSE_OPS +
                       scene.plugin("items", it.kind, home).OPS) *
                      cover_share(it, home) for it in state.items],
                     np.float64)
    ops = float((covered(boxes, cells) * per).sum())
    nbytes = 2.0 * w * h * PIXEL_BYTES
    nbytes += sum(float(state.images[k].size) for k in change.images)
    return ops, nbytes


def least_seconds(frames: Sequence[Tuple[scene.State, scene.Change]],
                  home=scene.HERE) -> float:
    """The least time one H100 needs for `frames` ((state, change) each):
    per frame the larger of its operations over the FP32 peak and its
    bytes over the memory peak."""
    total = 0.0
    for state, change in frames:
        ops, nbytes = frame_work(state, change, home)
        total += max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)
    return total
