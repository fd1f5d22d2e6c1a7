"""The tile-raster kernel: wrapper, launch counts and the plain version.

Replaces `webrender_tpu/ops/pallas/tile_raster.py::render_tiles_pallas_dense`
(its `pl.pallas_call` at :1175) for the branches that the uncached 4K
browsing frame reaches:

* the body: accumulator from `clear`, or from `init_tiles` (the tiles'
  current pixels, for continuation passes), inverse map, edge-AA rect
  coverage, swgl integer compose for blend ops 0 (normal), 7 (channel
  clear) and 8 (add);
* `KIND_SOLID`, `KIND_LINEAR_GRAD` (stops from the f32 buffer),
  `KIND_SUBPX_GLYPH` on the translation fast path, and `K_SEP_IMAGE`
  (axis-aligned scaled images, swgl 7-bit bilinear, stretch and spacing
  repeat, nearest);
* the clip chain for rect and rounded-rect clips.

`render_tiles_dense` launches `csrc/tile_raster.cu` on CUDA tensors and
runs `render_tiles_dense_plain` on CPU tensors; it raises on any other
device and for anything outside the ported set.  The plain version loops
over slots, is vectorised over tiles, and computes the Pallas body through
the shared pattern and blend math (`ops/xp.py`).  Texture taps are direct
loads of the atlas texels the TPU kernel gathers from its DMA windows; a
tap outside the atlas reads 0.
"""
from __future__ import annotations

import ctypes

import torch

from webrender_tpu.frame.gpu import (KIND_LINEAR_GRAD, KIND_SOLID,
                                     KIND_SUBPX_GLYPH)
from webrender_tpu.frame.tiles import TILE_H, TILE_W
from webrender_tpu.ops import blend as blend_mod
from webrender_tpu.ops import patterns as pk

from . import xp
from .dense import (K_SEP_IMAGE, PORTED_BLENDS, PORTED_KINDS, REC_BLEND,
                    REC_CLIP_COUNT, REC_CLIP_ROW, REC_EDGE, REC_KIND,
                    REC_TROW, check_clip_kinds)


class LaunchCounts:
    """`launches`: CUDA kernel launches; `plain_calls`: plain-version runs
    through the wrapper (CPU tensors)."""
    launches = 0
    plain_calls = 0

    @classmethod
    def reset(cls):
        cls.launches = 0
        cls.plain_calls = 0


def _check_supported(kinds, blends, mask_clips, gl):
    for k in kinds:
        if k not in PORTED_KINDS:
            raise NotImplementedError(f"dense kind {k} is not ported")
    for b in blends:
        if b not in PORTED_BLENDS:
            raise NotImplementedError(f"blend op {b} is not ported")
    if gl:
        raise NotImplementedError("gl=True (llvmpipe compose) is not ported")
    if mask_clips:
        raise NotImplementedError("mask_clips (image-mask and box-shadow "
                                  "clips) is not ported")


def render_tiles_dense(dense, tile_counts, tile_origins, clear_color,
                       f32_rows, alpha_atlas, surface_atlas, color_atlas,
                       init_tiles=None, *, kinds, blends,
                       mask_clips: bool = False, gl: bool = False):
    """Dense-record raster → [nt, 4, TILE_H, TILE_W] f32 premultiplied
    tiles on the u8 grid; the signature of `render_tiles_pallas_dense`.
    With `init_tiles` ([nt, 4, TILE_H, TILE_W]) each tile starts from
    those pixels and `clear_color` is not read."""
    _check_supported(kinds, blends, mask_clips, gl)
    check_clip_kinds(dense, tile_counts, f32_rows)
    if dense.device.type == "cpu":
        LaunchCounts.plain_calls += 1
        return render_tiles_dense_plain(
            dense, tile_counts, tile_origins, clear_color, f32_rows,
            alpha_atlas, surface_atlas, color_atlas, init_tiles,
            kinds=kinds, blends=blends)
    if dense.device.type != "cuda":
        raise ValueError(f"no tile-raster kernel for {dense.device}")
    return _launch(dense, tile_counts, tile_origins, clear_color, f32_rows,
                   color_atlas, init_tiles)


def _launch(dense, tile_counts, tile_origins, clear_color, f32_rows,
            color_atlas, init_tiles=None):
    from ._build import error_string, load
    nt, slots, _ = dense.shape
    dev = dense.device
    checks = [(dense, torch.float32, (nt, slots, 128)),
              (tile_counts, torch.int32, (nt,)),
              (tile_origins, torch.float32, (nt, 2)),
              (clear_color, torch.float32, (4,)),
              (f32_rows, torch.float32, (f32_rows.shape[0], 128)),
              (color_atlas, torch.float32,
               (4,) + tuple(color_atlas.shape[1:]))]
    if init_tiles is not None:
        checks.append((init_tiles, torch.float32, (nt, 4, TILE_H, TILE_W)))
    for t, dtype, shape in checks:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"tile raster wants a contiguous {dtype} "
                             f"{shape} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    out = torch.empty((nt, 4, TILE_H, TILE_W), dtype=torch.float32,
                      device=dev)
    if nt == 0:
        return out
    lib = load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.wr_tile_raster(
        dense.data_ptr(), tile_counts.data_ptr(), tile_origins.data_ptr(),
        clear_color.data_ptr(),
        None if init_tiles is None else init_tiles.data_ptr(),
        f32_rows.data_ptr(),
        ctypes.c_longlong(f32_rows.numel()), color_atlas.data_ptr(),
        color_atlas.shape[1], color_atlas.shape[2], out.data_ptr(), nt, slots,
        stream)
    if rc != 0:
        raise RuntimeError(f"tile raster launch failed: {error_string(rc)}")
    LaunchCounts.launches += 1
    return out


# --- the plain version ------------------------------------------------------

def _cols(rows):
    """[m, K] records → [K, m, 1, 1], so that `p[k]` broadcasts per tile."""
    return rows.t()[:, :, None, None]


def _gather_taps(plane_flat, H, W, yi, xi):
    """Atlas texels at integer (yi, xi) (broadcast shapes), 0 outside."""
    inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
    idx = torch.where(inb, yi * W + xi, torch.zeros_like(yi))
    return torch.where(inb, plane_flat[idx], 0.0)


def _fixed_bilinear(t00, t10, t01, t11, frx, fry):
    """swgl's truncating 7-bit lerp (y first, then x) on u8-valued taps."""
    a = t00 + xp.floor((t01 - t00) * fry * (1.0 / 128.0))
    b = t10 + xp.floor((t11 - t10) * fry * (1.0 / 128.0))
    return (a + xp.floor((b - a) * frx * (1.0 / 128.0))) * (1.0 / 255.0)


def _u8(v):
    return xp.floor(v * 255.0 + 0.5)


def _subpx_glyph(p, trow, ox, oy, color_atlas):
    """Translation fast path of `sampled_branch` (tile_raster.py:865) for
    KIND_SUBPX_GLYPH: the 7-bit fraction is constant over the tile."""
    fx = ox + trow[6] + (p[8] - p[0])
    fy = oy + trow[7] + (p[9] - p[1])
    qx = xp.floor(fx * 128.0 + 0.5)
    qy = xp.floor(fy * 128.0 + 0.5)
    x0f = xp.floor(qx * (1.0 / 128.0))
    y0f = xp.floor(qy * (1.0 / 128.0))
    frx = qx - x0f * 128.0
    fry = qy - y0f * 128.0
    _, H, W = color_atlas.shape
    dev = color_atlas.device
    lim = float(1 << 30)
    x0 = x0f.clamp(-lim, lim).long() + \
        torch.arange(TILE_W, device=dev)[None, None, :]
    y0 = y0f.clamp(-lim, lim).long() + \
        torch.arange(TILE_H, device=dev)[None, :, None]
    texel = []
    for c in range(3):
        flat = color_atlas[c].reshape(-1)
        t00 = _u8(_gather_taps(flat, H, W, y0, x0))
        t10 = _u8(_gather_taps(flat, H, W, y0, x0 + 1))
        t01 = _u8(_gather_taps(flat, H, W, y0 + 1, x0))
        t11 = _u8(_gather_taps(flat, H, W, y0 + 1, x0 + 1))
        texel.append(_fixed_bilinear(t00, t10, t01, t11, frx, fry))
    m_avg = (texel[0] + texel[1] + texel[2]) * (1.0 / 3.0)
    return xp.stack([texel[0] * p[12], texel[1] * p[13], texel[2] * p[14],
                     m_avg * p[15]], 0)


def _sep_sample(u1d, v1d, u0, v0, u1, v1, nearest, atlas):
    """`_sep_sample` (tile_raster.py:640) in its default swgl mode: the
    four taps at the texel indices the one-hot contractions select."""
    lo_u = u0 + 0.5
    hi_u = xp.maximum(u1 - 0.5, lo_u)
    lo_v = v0 + 0.5
    hi_v = xp.maximum(v1 - 0.5, lo_v)
    u = xp.clip(u1d, lo_u, hi_u)
    v = xp.clip(v1d, lo_v, hi_v)
    u = xp.where(nearest > 0.5, xp.floor(u) + 0.5, u)
    v = xp.where(nearest > 0.5, xp.floor(v) + 0.5, v)
    _, H, W = atlas.shape
    qu = xp.floor(u * 128.0 - 63.5)
    qv = xp.floor(v * 128.0 - 63.5)
    ixf = xp.floor(qu * (1.0 / 128.0))
    iyf = xp.floor(qv * (1.0 / 128.0))
    fx = qu - ixf * 128.0
    fy = qv - iyf * 128.0
    over = ixf > (W - 2)
    fx = xp.where(ixf < 0.0, 0.0, fx)
    fx = xp.where(over, 128.0, fx)
    x0 = xp.clip(ixf, 0.0, W - 2).long()
    y0 = xp.clip(iyf, 0.0, H - 1).long()
    y1 = y0 + ((iyf >= 0.0) & (iyf < H - 1)).long()
    x1 = (x0 + 1).clamp(max=W - 1)
    out = []
    for c in range(4):
        flat = atlas[c].reshape(-1)
        t00 = _u8(flat[y0 * W + x0])
        t10 = _u8(flat[y0 * W + x1])
        t01 = _u8(flat[y1 * W + x0])
        t11 = _u8(flat[y1 * W + x1])
        out.append(_fixed_bilinear(t00, t10, t01, t11, fx, fy))
    return out


def _sep_image(p, lx, ly, color_atlas):
    """`sep_branch` for K_SEP_IMAGE (tile_raster.py:1005): u from the
    tile's first row of lx, v from its first column of ly."""
    lx_row = lx[:, 0:1, :]
    ly_col = ly[:, :, 0:1]
    stretch_w = xp.maximum(p[18], 1e-6)
    stretch_h = xp.maximum(p[19], 1e-6)
    oxl = xp.clip(lx_row - p[0], 0.0, xp.maximum(p[2] - p[0] - 1e-3, 0.0))
    oyl = xp.clip(ly_col - p[1], 0.0, xp.maximum(p[3] - p[1] - 1e-3, 0.0))
    period_x = stretch_w + p[20]
    period_y = stretch_h + p[21]
    period_x = xp.where(period_x > 1e-6, period_x, 1e6)
    period_y = xp.where(period_y > 1e-6, period_y, 1e6)
    tx = oxl - xp.floor(oxl / period_x) * period_x
    ty = oyl - xp.floor(oyl / period_y) * period_y
    in_x = (tx < stretch_w + 1e-4).to(torch.float32)
    in_y = (ty < stretch_h + 1e-4).to(torch.float32)
    u = p[8] + tx * p[22] - p[24]
    v = p[9] + ty * p[23] - p[25]
    texel = _sep_sample(u, v, p[8], p[9], p[10], p[11], p[16], color_atlas)
    in_tile = in_x * in_y
    return xp.stack([texel[0] * p[12], texel[1] * p[13], texel[2] * p[14],
                     texel[3] * p[15]], 0) * in_tile[None]


def _linear_grad(p, lx, ly, f32_flat):
    """`grad_branch` + `_eval_stops_row` (tile_raster.py:981, :329) for a
    linear gradient; the stops loop runs to the record's stop count."""
    t, in_tile = pk.gradient_t_linear(xp, p, lx, ly)
    base = (p[12].to(torch.int32) // 128).long() * 128
    n = p[14].to(torch.int32)
    nf = f32_flat.shape[0]

    def stop(off):
        return f32_flat[(base + off).clamp(0, nf - 1)]

    t = xp.where(p[13] > 0.5, t - xp.floor(t), t)
    out = xp.stack([xp.broadcast_to(stop(1 + c), t.shape) for c in range(4)],
                   0)
    for i in range(1, max(int(n.max()), 1)):
        o0 = stop((i - 1) * 8)
        o1 = stop(i * 8)
        denom = o1 - o0
        w = xp.where(denom > 1e-9,
                     xp.clip((t - o0) / xp.where(denom > 1e-9, denom, 1.0),
                             0.0, 1.0),
                     xp.where(t >= o1, 1.0, 0.0))
        w = xp.where(i < n, w, 0.0)
        c1 = xp.stack([stop(i * 8 + 1 + c) for c in range(4)], 0)
        out = out + (c1 - out) * w[None]
    q = xp.clip(xp.rint(out * 255.0), 0.0, 255.0) * (1.0 / 255.0)
    out = xp.where(p[15] > 0.5, q, out)
    return out * in_tile[None]


def _clip_chain(rec, px, py, f32_rows, cov):
    """`clip_body` (tile_raster.py:763) for rect and rounded clips: rect
    clips join the span coverage, the rest the u8 clip-mask chain."""
    n = rec[REC_CLIP_COUNT].to(torch.int32)
    row = rec[REC_CLIP_ROW].to(torch.int32).long()
    m8 = torch.full_like(cov, 255.0)
    for j in range(int(n.max())):
        r = (row + j).clamp(0, f32_rows.shape[0] - 1)
        crec = f32_rows[r.reshape(-1)].t()[:, :, None, None]
        ct = crec[96:108]
        clx, cly = pk.inverse_map(xp, ct, px, py)
        rect_cov = pk.rect_coverage_auto(xp, ct, crec[0], crec[1], crec[2],
                                         crec[3], clx, cly, px, py, 0xF)
        rounded = pk.rounded_rect_coverage_auto(
            xp, ct, crec[0:4], crec[4:12], clx, cly, px, py,
            fast_flag=crec[15])
        ccov = xp.where(crec[14] < 0.5, rect_cov, rounded)
        ccov = xp.where(crec[12] > 0.5, 1.0 - ccov, ccov)
        is_geom = (crec[14] < 0.5) & (crec[12] < 0.5)
        c8 = blend_mod.quantize_cov(xp, ccov, 255.0)
        m8n = xp.floor((c8 * m8 + c8) * (1.0 / 256.0))
        on = j < n
        cov = xp.where(on & is_geom, cov * ccov, cov)
        m8 = xp.where(on & ~is_geom, m8n, m8)
    return cov, m8 * (1.0 / 255.0)


def _raster_group(kind, rec, px, py, ox, oy, dst, f32_rows, color_atlas,
                  blends):
    """One slot of one kind for a group of tiles: the Pallas `body`."""
    p = rec[0:64]
    trow = rec[REC_TROW:REC_TROW + 12]
    lx, ly = pk.inverse_map(xp, trow, px, py)
    edge_aa = rec[REC_EDGE].to(torch.int32)
    cov = pk.rect_coverage_auto(xp, trow, p[4], p[5], p[6], p[7], lx, ly,
                                px, py, edge_aa)
    cov, mcov = _clip_chain(rec, px, py, f32_rows, cov)
    if kind == KIND_SOLID:
        color = pk.pattern_solid(xp, p, lx, ly)
    elif kind == KIND_LINEAR_GRAD:
        color = _linear_grad(p, lx, ly, f32_rows.reshape(-1))
    elif kind == KIND_SUBPX_GLYPH:
        color = _subpx_glyph(p, trow, ox, oy, color_atlas)
    elif kind == K_SEP_IMAGE:
        color = _sep_image(p, lx, ly, color_atlas)
    else:
        raise NotImplementedError(f"dense kind {kind} is not ported")
    if len(blends) == 1:
        return blend_mod.compose_swgl(xp, blends[0], color, cov, mcov, dst)
    op = rec[REC_BLEND].to(torch.int32)[None]
    out = dst
    for b in blends:
        out = xp.where(op == b, blend_mod.compose_swgl(xp, b, color, cov,
                                                       mcov, dst), out)
    return out


def render_tiles_dense_plain(dense, tile_counts, tile_origins, clear_color,
                             f32_rows, alpha_atlas, surface_atlas,
                             color_atlas, init_tiles=None, *, kinds, blends):
    """The plain PyTorch version of the kernel, on any device."""
    nt, slots, _ = dense.shape
    dev = dense.device
    col = torch.arange(TILE_W, dtype=torch.float32, device=dev)
    row = torch.arange(TILE_H, dtype=torch.float32, device=dev)
    ox = tile_origins[:, 0][:, None, None]
    oy = tile_origins[:, 1][:, None, None]
    px = (ox + col[None, None, :] + 0.5).expand(nt, TILE_H, TILE_W)
    py = (oy + row[None, :, None] + 0.5).expand(nt, TILE_H, TILE_W)
    if init_tiles is not None:
        acc = init_tiles.permute(1, 0, 2, 3).contiguous()
    else:
        acc = clear_color[:, None, None, None].expand(
            4, nt, TILE_H, TILE_W).contiguous()
    counts = tile_counts.long()
    n_slots = int(counts.max()) if nt else 0
    for s in range(n_slots):
        live = torch.nonzero(counts > s).reshape(-1)
        kind_s = dense[live, s, REC_KIND].to(torch.int32)
        for k in kinds:
            ii = live[kind_s == k]
            if ii.numel() == 0:
                continue
            acc[:, ii] = _raster_group(
                k, _cols(dense[ii, s]), px[ii], py[ii], ox[ii], oy[ii],
                acc[:, ii], f32_rows, color_atlas, tuple(blends))
    return acc.permute(1, 0, 2, 3).contiguous()
