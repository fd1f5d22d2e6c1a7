"""The least time one tile-raster dispatch could take on an H100.

`tile_raster_bound` counts what a dispatch's inputs need and divides by
the card's published peaks (NVIDIA's data sheet, H100 SXM at 700 W): the
larger of the FP32 operations over 67 TFLOP/s and the bytes over
3.35 TB/s is the bound.

Operations, at the cost per (pixel, record) below, counted from
`csrc/tile_raster.cu` (one add, multiply, divide, floor, compare, min,
max or select is one operation).  The kernel computes a record's
coverage over all 8192 pixels of its tile and skips the rest of the
record where it is not above zero, so the rest is counted only over the
pixels this dispatch's records cover (`covered_pixels`, from the plain
version's coverage on the same inputs):

* every pixel of every record: the inverse map (18), the rect coverage
  (28), the mask product and the coverage test (2): 48, plus its clips;
* each clip record: 50 (rect), 75 (rounded, uniform radius) or 125
  (rounded, per-corner radii);
* each covered pixel: the swgl compose on the u8 grid (102), plus the
  kind's work:
  * `KIND_LINEAR_GRAD`: 36, plus 19 per stop after the first;
  * the translation fast path: 24, plus 28 per atlas plane (four u8
    taps and the 7-bit lerp), plus the tint: `KIND_GLYPH` 4 (one
    plane), `KIND_SUBPX_GLYPH` 7 (three), `KIND_PICTURE` 4 (four);
  * `K_SEP_IMAGE`: 82 plus the separable sampler (40, plus 28 per
    plane, four planes); `K_SEP_PICTURE`: 19 plus the sampler;
  * the color matrix of the picture kinds: 52 with flag 1, 1 with
    flag 0.

Bytes: each valid record once (512 bytes), each f32 row a record reads
(its clips and gradient stops) once, the atlas texels of each sampled
record's uv rect once per plane, the starting tiles of a continuation
pass once, and the output tiles once.
"""
from __future__ import annotations

import torch

from ..frame.gpu import (KIND_GLYPH, KIND_LINEAR_GRAD, KIND_PICTURE,
                         KIND_SOLID, KIND_SUBPX_GLYPH)
from ..frame.tiles import TILE_H, TILE_W
from .dense import (K_SEP_IMAGE, K_SEP_PICTURE, REC_CLIP_COUNT, REC_CLIP_ROW,
                    REC_KIND)
from .tile_raster import _cols, record_coverage, tile_pixels

PEAK_FP32_FLOPS = 67e12      # H100 SXM, FP32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PIXELS = TILE_H * TILE_W
REC_BYTES = 128 * 4

COVERAGE_OPS = 48
COMPOSE_OPS = 102
SEP_SAMPLER_OPS = 40 + 4 * 28
KIND_OPS = {KIND_SOLID: 0,
            KIND_LINEAR_GRAD: 36,
            KIND_GLYPH: 24 + 28 + 4,
            KIND_SUBPX_GLYPH: 24 + 3 * 28 + 7,
            KIND_PICTURE: 24 + 4 * 28 + 4,
            K_SEP_IMAGE: 82 + SEP_SAMPLER_OPS,
            K_SEP_PICTURE: 19 + SEP_SAMPLER_OPS}
GRAD_STOP_OPS = 19
COLOR_MATRIX_OPS = {0: 1, 1: 52}
CLIP_OPS = {"rect": 50, "rounded_fast": 75, "rounded_sdf": 125}
# atlas planes a sampled kind reads
PLANES = {KIND_GLYPH: 1, KIND_SUBPX_GLYPH: 3, KIND_PICTURE: 4,
          K_SEP_IMAGE: 4, K_SEP_PICTURE: 4}


def _valid(dense, tile_counts):
    slot = torch.arange(dense.shape[1], device=dense.device)
    return slot[None, :] < tile_counts.long()[:, None]


def covered_pixels(dense, tile_counts, tile_origins, f32_rows):
    """[nt, slots] float64: the pixels of each valid record where its
    coverage is above zero (the plain version's coverage: the record's
    rect and edge AA with its rect clips joined); 0 for empty slots."""
    nt, slots, _ = dense.shape
    out = torch.zeros((nt, slots), dtype=torch.float64, device=dense.device)
    if nt == 0:
        return out
    px, py = tile_pixels(tile_origins)
    counts = tile_counts.long()
    for s in range(int(counts.max())):
        live = torch.nonzero(counts > s).reshape(-1)
        _, _, cov, _ = record_coverage(_cols(dense[live, s]), px[live],
                                       py[live], f32_rows)
        out[live, s] = (cov > 0.0).sum((1, 2)).double()
    return out


def dispatch_work(dense, tile_counts, tile_origins, f32_rows,
                  init_tiles=None):
    """(FP32 operations, bytes) that one dispatch's inputs need."""
    valid = _valid(dense, tile_counts)
    covered = covered_pixels(dense, tile_counts, tile_origins,
                             f32_rows)[valid]
    rec = dense[valid].double()
    kind = rec[:, REC_KIND].long()
    # per covered pixel
    per_covered = torch.full_like(rec[:, 0], float(COMPOSE_OPS))
    for k, ops in KIND_OPS.items():
        per_covered += (kind == k).double() * ops
    grad = kind == KIND_LINEAR_GRAD
    per_covered += grad.double() * (rec[:, 14] - 1).clamp(min=0) * \
        GRAD_STOP_OPS
    pic = (kind == KIND_PICTURE) | (kind == K_SEP_PICTURE)
    flag1 = pic & (rec[:, 36] > 0.5)
    per_covered += (pic & ~flag1).double() * COLOR_MATRIX_OPS[0] + \
        flag1.double() * COLOR_MATRIX_OPS[1]
    # per pixel of the tile: the coverage and each record's clip rows
    per_pixel = torch.full_like(rec[:, 0], float(COVERAGE_OPS))
    n_clip = rec[:, REC_CLIP_COUNT].long()
    rows = []
    if rec.shape[0] and int(n_clip.max()) > 0:
        n_rows = f32_rows.shape[0]
        for j in range(int(n_clip.max())):
            live = n_clip > j
            r = (rec[:, REC_CLIP_ROW].long() + j).clamp(0, n_rows - 1)
            crow = f32_rows[r].double()
            ckind = crow[:, 14]
            fast = crow[:, 15] > 0.5
            ops = torch.where(ckind < 0.5, float(CLIP_OPS["rect"]),
                              torch.where(fast,
                                          float(CLIP_OPS["rounded_fast"]),
                                          float(CLIP_OPS["rounded_sdf"])))
            per_pixel += live.double() * ops
            rows.append(r[live])
    ops = float(per_pixel.sum()) * PIXELS + float((per_covered *
                                                   covered).sum())
    # bytes: records, referenced f32 rows, atlas texels, tiles
    rows.append((rec[grad, 12].long() // 128))
    n_f32_rows = int(torch.unique(torch.cat(rows)).numel()) if rows else 0
    texels = 0.0
    for k, planes in PLANES.items():
        sel = rec[kind == k]
        if sel.shape[0]:
            uv = torch.unique(sel[:, 8:12], dim=0)
            area = ((uv[:, 2] - uv[:, 0]).abs() + 1) * \
                ((uv[:, 3] - uv[:, 1]).abs() + 1)
            texels += float(area.sum()) * planes
    nt = dense.shape[0]
    tiles = nt * 4 * PIXELS * 4
    nbytes = rec.shape[0] * REC_BYTES + n_f32_rows * REC_BYTES + \
        texels * 4 + tiles * (2 if init_tiles is not None else 1)
    return ops, float(nbytes)


def tile_raster_bound(dense, tile_counts, tile_origins, f32_rows,
                      init_tiles=None):
    """(bound in ms, "operations" or "bytes", operations, bytes)."""
    ops, nbytes = dispatch_work(dense, tile_counts, tile_origins, f32_rows,
                                init_tiles)
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", ops, nbytes
    return t_bytes, "bytes", ops, nbytes
