"""Tile binning: assign instances to the tiles of a render-target grid.

This is the TPU-native replacement for WebRender's batching + per-tile
command buffers (`batch.rs` AlphaBatchBuilder + `command_buffer.rs`): instead
of instanced GL draw calls per batch, every render target is a grid of
TILE_H×TILE_W pixel tiles and each tile gets a fixed-shape (padded) list of
instance indices, executed back-to-front by the raster kernel. Painter's
order inside the list preserves the display-list z order.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# Tile size: last dim 128 to match the VPU lane width, 64 sublanes for f32.
TILE_W = 128
TILE_H = 64


def _tile_pairs(x0, y0, x1, y1, nx, ny):
    """Expand per-instance tile rects [M] into (pair_tile, pair_inst) —
    fully vectorized CSR-style expansion (no per-instance Python loop)."""
    wdt = np.maximum(x1 - x0, 0)
    hgt = np.maximum(y1 - y0, 0)
    counts = (wdt * hgt).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    starts = np.zeros_like(counts)
    np.cumsum(counts[:-1], out=starts[1:])
    inst_of = np.repeat(np.arange(counts.shape[0]), counts)
    e = np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
    wrep = np.repeat(np.maximum(wdt, 1), counts)
    ky = e // wrep
    kx = e - ky * wrep
    tile = (np.repeat(y0, counts) + ky) * nx + np.repeat(x0, counts) + kx
    return tile, inst_of


def bin_instances(inst_indices: Sequence[int],
                  bboxes,
                  origin: Tuple[float, float],
                  size: Tuple[int, int],
                  min_slots: int = 8,
                  step: float = 1.0,
                  opaque=None,
                  opaque_mask=None,
                  ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Bin instances into the tile grid of one render target (vectorized —
    the batching hot path of `batch.rs` runs as numpy array ops).

    inst_indices: global instance ids, painter order.
    bboxes: matching device-space AABBs [M, 4], already AA-inflated.
    opaque/opaque_mask: [M, 4] opaque interior rects + validity — the
    rectangle_occlusion.rs role: per tile, everything binned before the
    last instance whose opaque rect covers the whole tile is dropped.

    Returns (tile_insts [nt, slots] i32 padded with -1, tile_counts [nt]
    i32, nx, ny).
    """
    w, h = size
    ox, oy = origin
    nx = max(1, -(-w // TILE_W))
    ny = max(1, -(-h // TILE_H))
    nt = nx * ny
    tw = TILE_W * step
    th = TILE_H * step
    ids = np.asarray(inst_indices, np.int64).reshape(-1)
    M = ids.shape[0]
    if M == 0:
        tile_insts = np.full((nt, min_slots), -1, np.int32)
        return tile_insts, np.zeros(nt, np.int32), nx, ny
    bb = np.asarray(bboxes, np.float32).reshape(M, 4)
    # ±1 covers anti-aliasing spill beyond the tight bbox
    tx0 = np.clip(np.floor((bb[:, 0] - 1 - ox) / tw), 0, nx).astype(np.int64)
    ty0 = np.clip(np.floor((bb[:, 1] - 1 - oy) / th), 0, ny).astype(np.int64)
    tx1 = np.clip(np.ceil((bb[:, 2] + 1 - ox) / tw), 0, nx).astype(np.int64)
    ty1 = np.clip(np.ceil((bb[:, 3] + 1 - oy) / th), 0, ny).astype(np.int64)
    tile, inst_of = _tile_pairs(tx0, ty0, tx1, ty1, nx, ny)

    if opaque is not None and opaque_mask is not None and opaque_mask.any():
        op = np.asarray(opaque, np.float32).reshape(M, 4)
        fx0 = np.ceil((op[:, 0] - ox) / tw).astype(np.int64)
        fy0 = np.ceil((op[:, 1] - oy) / th).astype(np.int64)
        fx1 = np.floor((op[:, 2] - ox) / tw).astype(np.int64)
        fy1 = np.floor((op[:, 3] - oy) / th).astype(np.int64)
        mask = np.asarray(opaque_mask, bool)
        fx0 = np.clip(np.where(mask, fx0, 0), 0, nx)
        fy0 = np.clip(np.where(mask, fy0, 0), 0, ny)
        fx1 = np.clip(np.where(mask, fx1, 0), 0, nx)
        fy1 = np.clip(np.where(mask, fy1, 0), 0, ny)
        ctile, cinst = _tile_pairs(fx0, fy0, fx1, fy1, nx, ny)
        occl = np.full(nt, -1, np.int64)
        np.maximum.at(occl, ctile, cinst)
        keep = inst_of >= occl[tile]
        tile = tile[keep]
        inst_of = inst_of[keep]

    order = np.lexsort((inst_of, tile))
    tile_s = tile[order]
    inst_s = ids[inst_of[order]]
    tile_counts = np.bincount(tile_s, minlength=nt).astype(np.int32)
    max_count = int(tile_counts.max()) if tile_s.size else 0
    slots = max(min_slots, 1 << max(0, (max_count - 1)).bit_length())
    tile_insts = np.full((nt, slots), -1, np.int32)
    tstarts = np.zeros(nt, np.int64)
    np.cumsum(tile_counts[:-1], out=tstarts[1:])
    pos = np.arange(tile_s.size, dtype=np.int64) - \
        np.repeat(tstarts, tile_counts)
    tile_insts[tile_s, pos] = inst_s
    return tile_insts, tile_counts, nx, ny
