"""The least time one tile-raster dispatch could take on an H100.

`tile_raster_bound` counts what a dispatch's inputs need and divides by
the card's published peaks (NVIDIA's data sheet, H100 SXM at 700 W): the
larger of the FP32 operations over 67 TFLOP/s and the bytes over
3.35 TB/s is the bound.

Operations, at the cost per (pixel, record) below, counted from
`csrc/tile_raster.cu` (one add, multiply, divide, floor, compare, min,
max or select is one operation).  The count charges a record's coverage
and clip chain over all 8192 pixels of its tile, and the rest of the
record only over the pixels this dispatch's records cover
(`covered_pixels`, from the plain version's coverage on the same
inputs).  That count is kept as it was when the kernel evaluated every
record at every pixel, so that the kernel's times before and after its
redesign read against the same bound: the kernel now skips a record for
each run of 32 pixels of a row that the record cannot cover
(`tile_raster.run_may_draw`) and maps a pixel without its divisions
where `w` is 1, so the count over-charges what that kernel computes.  Whether the bound should charge
only the runs a record may reach is left to the benchmark's definition.

* every pixel of every record: the inverse map (18), the rect coverage
  (28), the mask product and the coverage test (2): 48, plus its clips;
* each clip record: 50 (rect), 75 (rounded, uniform radius), 125
  (rounded, per-corner radii), 173 (image mask: the rect coverage, the
  tile-row and tile-column inverse maps, the mask uv and a one-plane
  separable sample) or 211 (box-shadow nine-patch: the same with the
  nine-patch mapping and the inset mode); in a general tile the mask is
  sampled at the pixel's own position, without the two extra inverse maps
  (137), and the nine-patch also takes the plain rect coverage (203); 86
  for a polygon (kind 3, and kinds 2 and 4 in a tile that is not general
  of a dispatch without `mask_clips`: the clip's inverse map, 18, which
  the kernel computes before it picks the branch; 8 half-planes of 8, the
  two products, three sums, the clamp's two bounds and the minimum; the
  u8 mask chain, 4);
* each covered pixel: the swgl compose on the u8 grid (102), plus the
  blend op's work beyond the normal blend's (`MIX_BLEND_OPS`), plus the
  kind's work:
  * gradients: the gradient parameter, 36 (linear), 43 (radial) or 68
    (conic: the polynomial atan2), plus 19 per stop after the first;
  * `KIND_BOX_SHADOW`: 438 in the sharp arm (two rounded-rect
    coverages of 213: the rect, four corners' ellipse distances), 341
    (no radii) or 2966 (radii) in the blurred arm (erf of 25 each, eight
    quadrature points a corner);
  * `KIND_LINE_DEC`: 38 (dotted), 28 (dashed) or 66 (wavy);
  * the translation fast path: 24, plus 28 per atlas plane (four u8
    taps and the 7-bit lerp), plus the tint: `KIND_GLYPH` 4 (one
    plane), `KIND_SUBPX_GLYPH` 7 (three), `KIND_PICTURE` 4 (four);
  * `K_SEP_IMAGE`: 82 plus the separable sampler (40, plus 28 per
    plane, four planes); `K_SEP_PICTURE`: 19 plus the sampler;
  * scaled text: the tile-row and tile-column inverse maps and the uv
    (50), the sampler and the tint: `K_SEP_GLYPH` 4 (one plane),
    `K_SEP_SUBPX` 7 (three);
  * `K_SEP_YUV`: the two inverse maps and the three planes' uv (50),
    three one-plane samplers, the zero points, the 3x3 matrix and the
    clip (24);
  * the general kinds of a general tile, which map the pixel's own local
    position (already in the body) and sample in two dimensions: the
    general image 40 (the repeat tiling and the uv) plus the sampler; the
    general glyph and subpixel glyph the uv (14), the sampler and the
    tint; the general picture 19 plus the sampler; the general video the
    three planes' uv (14), three one-plane samplers and the matrix (24);
  * `KIND_CLEAR`: none (ones); blend op 1 costs what the normal blend
    costs;
  * the color matrix of the picture kinds: 52 with flag 1, 1 with
    flag 0, 277 with flag 2 (flag 1's, and the three channels converted
    to linearRGB and back);
* a record whose blend op is in the float domain (`dense.FLOAT_BLENDS`)
  has no zero-coverage skip: its kind's work and its compose are counted
  over every pixel of its tile.  The float compose: 25 (the coverage
  product, the source, the pack), plus the op (`float_blend_ops`: 4 to 14
  for the Porter-Duff composites, 9 for the normal blend, 33 plus the
  mode's for a mix), plus, from op 64, 360 for the three conversions
  between sRGB and linearRGB (two operands in, the result out).  One
  conversion of a channel is 7 operations and an `expf` and a `logf`,
  counted as `EXP_OPS` and `LOG_OPS` (a range reduction, a polynomial
  and one special-function instruction each: an estimate, not a count of
  the compiled code).

A pass with a raster step (`step`) has its pixels that far apart; its
counts are the same per pixel.

A dispatch in the GL flavour (`gl`, the gl build) composes blend ops 0,
1, 7 and 8 as `blend.compose_gl`: 62 operations per covered pixel in place
of the swgl compose's 102 (the coverage product; per channel the source's
two products, the round and the clamp, the destination's unpack, the
factor's product, scale, round and sum, the clamp and the scale).  Its
mask chain (`gl_mask_combine`: two products and a round) is one operation
shorter than swgl's, per clip record that goes through it.  Its llvm mask
sampler takes 35 operations for the coordinates (the clamps into the uv
rect, the first texel's floor and clamp, the two 8-bit fractions, the
second texel) and 33 for the plane (four u8 taps, three rounded integer
lerps, the scale): the 68 of the swgl one-plane sampler it replaces, so
the clip counts stand.

Bytes: each valid record once (512 bytes), each f32 row a record reads
(its clips and every row of its gradient stops) once, the atlas texels
of each sampled record's uv rect once per plane (a video's three uv rects once each)
and of each mask clip's uv rect once,
the starting tiles of a continuation pass once, and the output tiles
once.
"""
from __future__ import annotations

import torch

from ..frame.gpu import (KIND_BOX_SHADOW, KIND_CLEAR, KIND_CONIC_GRAD,
                         KIND_GLYPH, KIND_LINE_DEC, KIND_LINEAR_GRAD,
                         KIND_PICTURE, KIND_RADIAL_GRAD, KIND_SOLID,
                         KIND_SUBPX_GLYPH)
from ..frame.tiles import TILE_H, TILE_W
from .dense import (FLOAT_BLENDS, K_GEN_GLYPH, K_GEN_IMAGE, K_GEN_PICTURE,
                    K_GEN_SUBPX, K_GEN_YUV, K_SEP_GLYPH, K_SEP_IMAGE,
                    K_SEP_PICTURE, K_SEP_SUBPX, K_SEP_YUV, REC_BLEND,
                    REC_CLIP_COUNT, REC_CLIP_ROW, REC_GENERAL, REC_KIND)
from .tile_raster import GRADIENT_KINDS, _cols, record_coverage, tile_pixels

PEAK_FP32_FLOPS = 67e12      # H100 SXM, FP32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PIXELS = TILE_H * TILE_W
REC_BYTES = 128 * 4

COVERAGE_OPS = 48
COMPOSE_OPS = 102
GL_COMPOSE_OPS = 62
GL_COMPOSE_BLENDS = (0, 1, 7, 8)
GL_MASK_CHAIN_SAVING = 1
SEP_PLANE_OPS = 28
SEP_SAMPLER_OPS = 40 + 4 * SEP_PLANE_OPS
KIND_OPS = {KIND_SOLID: 0,
            KIND_CLEAR: 0,
            KIND_LINEAR_GRAD: 36,
            KIND_RADIAL_GRAD: 43,
            KIND_CONIC_GRAD: 68,
            KIND_GLYPH: 24 + 28 + 4,
            KIND_SUBPX_GLYPH: 24 + 3 * 28 + 7,
            KIND_PICTURE: 24 + 4 * 28 + 4,
            K_SEP_IMAGE: 82 + SEP_SAMPLER_OPS,
            K_SEP_PICTURE: 19 + SEP_SAMPLER_OPS,
            K_SEP_GLYPH: 50 + 40 + SEP_PLANE_OPS + 4,
            K_SEP_SUBPX: 50 + 40 + 3 * SEP_PLANE_OPS + 7,
            K_SEP_YUV: 50 + 3 * (40 + SEP_PLANE_OPS) + 24,
            K_GEN_IMAGE: 40 + SEP_SAMPLER_OPS,
            K_GEN_PICTURE: 19 + SEP_SAMPLER_OPS,
            K_GEN_GLYPH: 14 + 40 + SEP_PLANE_OPS + 4,
            K_GEN_SUBPX: 14 + 40 + 3 * SEP_PLANE_OPS + 7,
            K_GEN_YUV: 14 + 3 * (40 + SEP_PLANE_OPS) + 24}
GRAD_STOP_OPS = 19
ROUNDED_RECT_OPS = 213
# KIND_BOX_SHADOW by arm: the sharp one, the blurred one without and with
# radii (each with the box's rounded coverage and the u8 snap: 12)
BOX_SHADOW_OPS = {"sharp": 2 * ROUNDED_RECT_OPS + 12,
                  "blurred": 116 + ROUNDED_RECT_OPS + 12,
                  "blurred_radii": 2741 + ROUNDED_RECT_OPS + 12}
# KIND_LINE_DEC by style ([12]: 1 dotted, 2 dashed, 3 wavy)
LINE_DEC_OPS = {1: 38, 2: 28, 3: 66}
# one expf and one logf (estimates, see above)
EXP_OPS = 10
LOG_OPS = 20
# one channel from sRGB to linearRGB and back (blend.srgb_to_linear,
# linear_to_srgb: the selects, the division or product, the power)
SRGB_TO_LINEAR_OPS = 7 + EXP_OPS + LOG_OPS
LINEAR_TO_SRGB_OPS = 8 + EXP_OPS + LOG_OPS
COLOR_MATRIX_OPS = {0: 1, 1: 52,
                    2: 52 + 3 * (SRGB_TO_LINEAR_OPS + LINEAR_TO_SRGB_OPS)}
# the float compose (`compose_float` in the .cu): the coverage product, the
# source and the pack; and the premultiplied conversions of an op from 64
FLOAT_COMPOSE_OPS = 25
LINEAR_OPS = 2 * (2 + 3 * (2 + SRGB_TO_LINEAR_OPS)) + \
    (2 + 3 * (2 + LINEAR_TO_SRGB_OPS))
# blend_float below op 64 (Porter-Duff 2-6, the clear, the channel clear
# and add, the normal blend, plus-lighter) and the float mix modes' work
# per pixel (mix_channel_f three times, or the HSL helpers once), on top of
# the 33 of the premultiplied W3C composite
FLOAT_PD_OPS = {1: 5, 2: 4, 3: 5, 4: 13, 5: 14, 6: 8, 7: 8, 8: 8}
FLOAT_NORMAL_OPS = 9
FLOAT_MIX_OPS = {1: 3, 2: 9, 3: 18, 4: 3, 5: 3, 6: 18, 7: 21, 8: 18,
                 9: 60, 10: 6, 11: 12, 12: 44, 13: 44, 14: 28, 15: 28}
CLIP_OPS = {"rect": 50, "rounded_fast": 75, "rounded_sdf": 125,
            "image_mask": 173, "box_shadow": 211,
            "general_image_mask": 137, "general_box_shadow": 203,
            "polygon": 86}
# the mix-blend ops' work beyond the normal blend's 24 (blend op: ops):
# multiply, screen, overlay, darken, lighten, color-dodge, color-burn,
# hard-light, soft-light, difference, exclusion, hue, saturation, color,
# luminosity; the clear blend (1), like the channel clear (7) and add (8),
# costs no more than the normal blend
MIX_BLEND_OPS = {1: 0, 17: 12, 18: 0, 19: 44, 20: 20, 21: 20, 22: 48, 23: 48,
                 24: 44, 25: 84, 26: 24, 27: 4, 28: 78, 29: 78, 30: 53,
                 31: 53}
# atlas planes a sampled kind reads at its uv rect [8:12]; a video reads
# one plane at each of its three uv rects
PLANES = {KIND_GLYPH: 1, KIND_SUBPX_GLYPH: 3, KIND_PICTURE: 4,
          K_SEP_IMAGE: 4, K_SEP_PICTURE: 4, K_SEP_GLYPH: 1, K_SEP_SUBPX: 3,
          K_SEP_YUV: 1, K_GEN_IMAGE: 4, K_GEN_PICTURE: 4, K_GEN_GLYPH: 1,
          K_GEN_SUBPX: 3, K_GEN_YUV: 1}
YUV_CHROMA_UV = (slice(12, 16), slice(16, 20))


def float_blend_ops(op: int) -> int:
    """The operations of float-domain blend op `op` per pixel, beyond the
    kind's: the float compose, the op and, from 64, the conversions."""
    ops = FLOAT_COMPOSE_OPS
    if op >= 64:
        ops += LINEAR_OPS
        op -= 64
    if op >= 40:
        op = 16 + (op - 40)
    if op in FLOAT_PD_OPS:
        return ops + FLOAT_PD_OPS[op]
    mode = op - 16
    if op < 16 or mode == 0:
        return ops + FLOAT_NORMAL_OPS
    if mode == 16:
        return ops + FLOAT_PD_OPS[6]
    return ops + 33 + FLOAT_MIX_OPS.get(mode, 0)


def _valid(dense, tile_counts):
    slot = torch.arange(dense.shape[1], device=dense.device)
    return slot[None, :] < tile_counts.long()[:, None]


def covered_pixels(dense, tile_counts, tile_origins, f32_rows, step=1.0):
    """[nt, slots] float64: the pixels of each valid record where its
    coverage is above zero (the plain version's coverage: the record's
    rect and edge AA with its rect clips joined); 0 for empty slots."""
    nt, slots, _ = dense.shape
    out = torch.zeros((nt, slots), dtype=torch.float64, device=dense.device)
    if nt == 0:
        return out
    px, py = tile_pixels(tile_origins, step)
    counts = tile_counts.long()
    for s in range(int(counts.max())):
        live = torch.nonzero(counts > s).reshape(-1)
        _, _, cov, _ = record_coverage(_cols(dense[live, s]), px[live],
                                       py[live], f32_rows)
        out[live, s] = (cov > 0.0).sum((1, 2)).double()
    return out


def dispatch_work(dense, tile_counts, tile_origins, f32_rows,
                  init_tiles=None, step=1.0, mask_clips=True, gl=False):
    """(FP32 operations, bytes) that one dispatch's inputs need; without
    `mask_clips` the image-mask and nine-patch clips of the tiles that are
    not general are polygons, as the kernel reads them; `gl`: in the GL
    flavour."""
    valid = _valid(dense, tile_counts)
    covered = covered_pixels(dense, tile_counts, tile_origins, f32_rows,
                             step)[valid]
    rec = dense[valid].double()
    kind = rec[:, REC_KIND].long()
    op = rec[:, REC_BLEND].long()
    # per covered pixel: every pixel of the tile in the float domain
    per_covered = torch.full_like(rec[:, 0], float(COMPOSE_OPS))
    if gl:
        per_covered[torch.isin(op, torch.tensor(
            GL_COMPOSE_BLENDS, device=op.device))] = float(GL_COMPOSE_OPS)
    for b in FLOAT_BLENDS:
        floating = op == b
        if bool(floating.any()):
            per_covered[floating] = float(float_blend_ops(b))
            covered[floating] = float(PIXELS)
    for k, ops in KIND_OPS.items():
        per_covered += (kind == k).double() * ops
    grad = torch.isin(kind, torch.tensor(GRADIENT_KINDS, device=kind.device))
    per_covered += grad.double() * (rec[:, 14] - 1).clamp(min=0) * \
        GRAD_STOP_OPS
    shadow = kind == KIND_BOX_SHADOW
    sharp = rec[:, 20] <= 1e-3
    radii = rec[:, 12:20].sum(1) > 1e-6
    per_covered += shadow.double() * torch.where(
        sharp, float(BOX_SHADOW_OPS["sharp"]),
        torch.where(radii, float(BOX_SHADOW_OPS["blurred_radii"]),
                    float(BOX_SHADOW_OPS["blurred"])))
    for style, ops in LINE_DEC_OPS.items():
        per_covered += ((kind == KIND_LINE_DEC) &
                        ((rec[:, 12] - style).abs() < 0.5)).double() * ops
    for b, ops in MIX_BLEND_OPS.items():
        per_covered += (op == b).double() * ops
    pic = (kind == KIND_PICTURE) | (kind == K_SEP_PICTURE) | \
        (kind == K_GEN_PICTURE)
    flag = torch.where(rec[:, 36] > 1.5, 2, (rec[:, 36] > 0.5).long())
    for f, ops in COLOR_MATRIX_OPS.items():
        per_covered += (pic & (flag == f)).double() * ops
    # per pixel of the tile: the coverage and each record's clip rows
    per_pixel = torch.full_like(rec[:, 0], float(COVERAGE_OPS))
    n_clip = rec[:, REC_CLIP_COUNT].long()
    general = rec[:, REC_GENERAL] > 0.5
    rows = []
    mask_uv = []
    if rec.shape[0] and int(n_clip.max()) > 0:
        n_rows = f32_rows.shape[0]
        for j in range(int(n_clip.max())):
            live = n_clip > j
            r = (rec[:, REC_CLIP_ROW].long() + j).clamp(0, n_rows - 1)
            crow = f32_rows[r].double()
            ckind = crow[:, 14]
            fast = crow[:, 15] > 0.5
            polygon = ((ckind >= 2.5) & (ckind < 3.5)) | \
                ((ckind >= 1.5) & ~general & (not mask_clips))
            masked = live & (ckind >= 1.5) & ~polygon
            ops = torch.where(
                ckind < 0.5, float(CLIP_OPS["rect"]),
                torch.where(ckind >= 3.5, torch.where(
                    general, float(CLIP_OPS["general_box_shadow"]),
                    float(CLIP_OPS["box_shadow"])),
                            torch.where(ckind >= 1.5, torch.where(
                                general,
                                float(CLIP_OPS["general_image_mask"]),
                                float(CLIP_OPS["image_mask"])),
                                        torch.where(
                                            fast,
                                            float(CLIP_OPS["rounded_fast"]),
                                            float(CLIP_OPS["rounded_sdf"])))))
            ops = torch.where(polygon, float(CLIP_OPS["polygon"]), ops)
            if gl:
                ops = ops - ((ckind >= 0.5) | (crow[:, 12] > 0.5)).double() \
                    * GL_MASK_CHAIN_SAVING
            per_pixel += live.double() * ops
            rows.append(r[live])
            mask_uv.append(crow[masked, 16:20])
    ops = float(per_pixel.sum()) * PIXELS + float((per_covered *
                                                   covered).sum())
    # bytes: records, referenced f32 rows, atlas texels, tiles
    first = rec[grad, 12].long() // 128
    last = (rec[grad, 12] + 8 * rec[grad, 14]).long().sub(1).clamp(min=0) \
        // 128
    rows += [first, last]
    rows += [torch.arange(int(a) + 1, int(b), device=rec.device)
             for a, b in zip(first.tolist(), last.tolist()) if b > a + 1]
    n_f32_rows = int(torch.unique(torch.cat(rows)).numel()) if rows else 0
    def area(uv):
        uv = torch.unique(uv, dim=0)
        return float((((uv[:, 2] - uv[:, 0]).abs() + 1) *
                      ((uv[:, 3] - uv[:, 1]).abs() + 1)).sum())
    texels = 0.0
    for k, planes in PLANES.items():
        sel = rec[kind == k]
        if sel.shape[0]:
            texels += area(sel[:, 8:12]) * planes
    video = rec[(kind == K_SEP_YUV) | (kind == K_GEN_YUV)]
    if video.shape[0]:
        texels += sum(area(video[:, uv]) for uv in YUV_CHROMA_UV)
    if mask_uv and sum(m.shape[0] for m in mask_uv):
        texels += area(torch.cat(mask_uv))  # the color atlas's red plane
    nt = dense.shape[0]
    tiles = nt * 4 * PIXELS * 4
    nbytes = rec.shape[0] * REC_BYTES + n_f32_rows * REC_BYTES + \
        texels * 4 + tiles * (2 if init_tiles is not None else 1)
    return ops, float(nbytes)


def tile_raster_bound(dense, tile_counts, tile_origins, f32_rows,
                      init_tiles=None, step=1.0, mask_clips=True, gl=False):
    """(bound in ms, "operations" or "bytes", operations, bytes)."""
    return _bound(*dispatch_work(dense, tile_counts, tile_origins, f32_rows,
                                 init_tiles, step, mask_clips, gl))


def _bound(ops, nbytes):
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", ops, nbytes
    return t_bytes, "bytes", ops, nbytes


def tile_raster_sharded_bound(dense, tile_counts, tile_origins, f32_rows,
                              gathered_tiles: int, init_tiles=None,
                              step=1.0, mask_clips=True, gl=False):
    """(bound in ms, "operations" or "bytes", operations, bytes) of one
    rank's part of a dispatch sharded by tiles
    (`parallel/mesh.py::render_tiles_pallas_sharded`): the operations and
    input bytes of its shard (`dense`, `tile_counts`, `tile_origins` and
    `init_tiles` are the shard's), and the whole gathered output of
    `gathered_tiles` tiles written once in place of the shard's own.  What
    crosses between cards is not counted (no NVLink rate in the table)."""
    ops, nbytes = dispatch_work(dense, tile_counts, tile_origins, f32_rows,
                                init_tiles, step, mask_clips, gl)
    return _bound(ops, nbytes + (gathered_tiles - dense.shape[0]) * 4 *
                  PIXELS * 4)
