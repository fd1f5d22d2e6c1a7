"""Transform palette — frame-time device-facing transforms.

Re-designs `gpu_types.rs` TransformPalette for TPU raster kernels: instead of
forward matrices consumed by a vertex shader, each spatial node gets the
*screen→local inverse homography* (raster kernels inverse-map pixel centers
into primitive local space), plus local→device AA scale factors and a
backface flag.

For a row-vector 4x4 world matrix M (local (x,y,0,1) ↦ clip), the plane
restriction is the 3x3 homography H = rows/cols {0,1,3} of M; device pixels
add the device-pixel-ratio scale. We store Hinv row-major, so kernels compute
  u = px*h00 + py*h10 + h20,  v = px*h01 + py*h11 + h21,
  w = px*h02 + py*h12 + h22,  local = (u/w, v/w).
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..api.units import Transform
from ..scene.spatial_tree import ResolvedSpatialNode

PALETTE_WIDTH = 12
# row: [h00..h22 (9), sx, sy, flags]; flags bit0 = invalid, bit1 = backface


def node_homography(world: Transform, dpr: float) -> np.ndarray:
    """3x3 device homography of a node (local → device px), row-vector."""
    m = world.m
    H = np.array([
        [m[0] * dpr, m[1] * dpr, m[3]],
        [m[4] * dpr, m[5] * dpr, m[7]],
        [m[12] * dpr, m[13] * dpr, m[15]],
    ], dtype=np.float64)
    return H


def build_transform_palette(resolved: List[ResolvedSpatialNode],
                            dpr: float) -> np.ndarray:
    """[T, 12] float32 palette (spatial_tree.rs build_transform_palette)."""
    out = np.zeros((max(1, len(resolved)), PALETTE_WIDTH), np.float32)
    for i, node in enumerate(resolved):
        H = node_homography(node.world, dpr)
        flags = 0.0
        try:
            Hinv = np.linalg.inv(H)
        except np.linalg.LinAlgError:
            Hinv = np.eye(3)
            flags = 1.0
        m = node.world.m
        # AA scale: norms of the forward 2D jacobian columns at the origin
        sx = float(np.hypot(m[0], m[1]) * dpr)
        sy = float(np.hypot(m[4], m[5]) * dpr)
        # backface only within a preserve-3d context (spatial_tree.resolve)
        if node.backface:
            flags += 2.0
        # bit 2: transformed (not 2d-axis-aligned) — kernels switch to the
        # fwidth-based AA of transform.glsl/cs_clip (rotations/perspective)
        if not node.is_2d_axis_aligned:
            flags += 4.0
        out[i, 0:9] = Hinv.reshape(-1).astype(np.float32)
        out[i, 9] = sx if sx > 1e-9 else 1.0
        out[i, 10] = sy if sy > 1e-9 else 1.0
        out[i, 11] = flags
    return out


def forward_point(H: np.ndarray, x: float, y: float):
    p = np.array([x, y, 1.0]) @ H
    w = p[2] if abs(p[2]) > 1e-9 else 1e-9
    return p[0] / w, p[1] / w


def device_bounds_of_rect(H: np.ndarray, x0, y0, x1, y1):
    """AABB in device space of a local rect under homography H.  A rect
    crossing the w=0 plane projects to an UNBOUNDED region (its corners
    flip through the horizon): return a huge bbox and let the caller's
    viewport clamp bound it (split/near-plane.yaml)."""
    ws = []
    pts = []
    for (px, py) in ((x0, y0), (x1, y0), (x0, y1), (x1, y1)):
        p = np.array([px, py, 1.0]) @ H
        ws.append(p[2])
        w = p[2] if abs(p[2]) > 1e-9 else 1e-9
        pts.append((p[0] / w, p[1] / w))
    if min(ws) <= 1e-6 < max(ws):
        return -1e7, -1e7, 1e7, 1e7
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    return min(xs), min(ys), max(xs), max(ys)


def device_bounds_of_rects(H: np.ndarray, rects: np.ndarray) -> np.ndarray:
    """Vectorized device_bounds_of_rect: rects [G, 4] (x0,y0,x1,y1) →
    device AABBs [G, 4] under one homography (same math, batched)."""
    g = rects.shape[0]
    corners = np.empty((g, 4, 3), np.float64)
    corners[..., 2] = 1.0
    corners[:, 0, 0] = rects[:, 0]
    corners[:, 0, 1] = rects[:, 1]
    corners[:, 1, 0] = rects[:, 2]
    corners[:, 1, 1] = rects[:, 1]
    corners[:, 2, 0] = rects[:, 0]
    corners[:, 2, 1] = rects[:, 3]
    corners[:, 3, 0] = rects[:, 2]
    corners[:, 3, 1] = rects[:, 3]
    p = corners @ H
    w_raw = p[..., 2]
    w = np.where(np.abs(w_raw) > 1e-9, w_raw, 1e-9)
    xs = p[..., 0] / w
    ys = p[..., 1] / w
    out = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], axis=1)
    # rects crossing w=0 project unbounded (see device_bounds_of_rect)
    crossing = (w_raw.min(1) <= 1e-6) & (w_raw.max(1) > 1e-6)
    out[crossing] = (-1e7, -1e7, 1e7, 1e7)
    return out
