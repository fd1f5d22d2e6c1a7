"""CPU fidelity oracle — the SWGL role (SURVEY.md §2.5, §4.7).

A numpy software renderer that executes the *same* Frame the TPU renderer
executes, using the *same* single-source kernels (`ops/patterns.py`,
`ops/blend.py`) with ``xp = numpy``. It is the deterministic reference the
TPU output is compared against (`--software` reftest runs in the reference
CI). Per-instance evaluation is restricted to the instance's device bbox —
the span-rasterization spirit of `swgl/src/rasterize.h` without the SIMD.

The port's copy of `webrender_tpu/oracle/sw.py` on the port's own host
layers, numpy only.  The native span rasterizer (`oracle/native.py`,
`use_native`) is not ported: its branches are left out.

numpy promotes `where` of two Python floats to float64, so some of the
shared pattern math (the gradient-stop weights, the nine-patch clip, the
rect coverage) runs here in float64 where the device (the kernel, its
plain version, jax.numpy) runs it in float32; on the u8 grid the two can
land on either side of an exact half.  `float32_where()` runs the oracle
with those `where`s held in float32, as the device computes them.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np

from ..frame.frame_builder import (Frame, PASS_BLUR_H, PASS_BLUR_V,
                                   PASS_CHANNEL_LUT, PASS_COLOR_MATRIX,
                                   PASS_COPY,
                                   PASS_ARITH, PASS_DOWNSCALE, PASS_RASTER,
                                   PASS_SRGB, TARGET_ROOT)
from ..frame.gpu import (CLIP_STRIDE, INST_BLEND, INST_CLIP_ADDR,
                         INST_CLIP_COUNT, INST_EDGE_AA, INST_KIND,
                         INST_PRIM_ADDR, INST_SPATIAL, KIND_BOX_SHADOW,
                         KIND_CLEAR, KIND_CONIC_GRAD, KIND_GLYPH, KIND_IMAGE,
                         KIND_LINEAR_GRAD, KIND_LINE_DEC, KIND_PICTURE,
                         KIND_RADIAL_GRAD, KIND_SOLID, KIND_BORDER,
                         KIND_SUBPX_GLYPH, KIND_YUV)
from ..ops import blend as blend_mod
from ..ops import patterns as pk
from ..ops.raster import gaussian_weights


class Float32Where:
    """numpy, with `where` of two Python floats (float64 in numpy) kept in
    float32, as jax.numpy and torch keep it."""

    def __getattr__(self, name):
        return getattr(_numpy, name)

    @staticmethod
    def where(cond, a, b):
        out = _numpy.where(cond, a, b)
        return out.astype(_numpy.float32) if out.dtype == _numpy.float64 \
            else out


_numpy = np


@contextlib.contextmanager
def float32_where():
    """The oracle (this module's numpy, handed to the pattern and blend
    math) with float32 `where`s, within the block."""
    global np
    np = Float32Where()
    try:
        yield
    finally:
        np = _numpy


def _quantize_unorm8(img):
    """RGBA8 offscreen target quantization — tie-nudged round (see
    renderer._quantize_unorm8 / ops/blend.py quantize_cov: backends must
    round exact-half ties identically despite TPU transcendental ULPs)."""
    return np.clip(np.rint(img * np.float32(255.0)),
                   0.0, 255.0).astype(np.float32) * np.float32(1.0 / 255.0)


def _py_fori(lo, hi, body, init):
    val = init
    for i in range(int(lo), int(hi)):
        val = body(i, val)
    return val


class SoftwareRenderer:
    """Executes a Frame on the host. The atlases are the renderer's, read
    back from its device (`Renderer.host_atlases`), or owned standalone."""

    def __init__(self, color_atlas: np.ndarray, alpha_atlas: np.ndarray,
                 surface_atlas_size=(2048, 4096)):
        self.color_atlas = np.ascontiguousarray(color_atlas)
        self.alpha_atlas = np.ascontiguousarray(alpha_atlas)
        self.surface_atlas = np.zeros((4,) + surface_atlas_size, np.float32)

    def render(self, frame: Frame) -> np.ndarray:
        if frame.surface_rows > self.surface_atlas.shape[1]:
            self.surface_atlas = np.zeros(
                (4, frame.surface_rows, self.surface_atlas.shape[2]),
                np.float32)
        fb: Optional[np.ndarray] = None
        for p in frame.passes:
            if p.kind == PASS_RASTER:
                x, y, rw, rh = p.region
                if p.target == TARGET_ROOT and p.slice_key is not None \
                        and p.cache_insts is not None:
                    # picture-cache slice: the device rasters the slice's
                    # CONTENT grid onto transparent and integer-src-overs
                    # it at the scroll offset (renderer _run_slice_cached
                    # + _slice_composite).  The oracle must execute the
                    # same two-step compose — rastering the instances
                    # directly onto the framebuffer differs by the
                    # intermediate quantization on AA pixels.
                    fb = self._slice_raster(frame, p, fb)
                    continue
                if p.clear is not None:
                    target = np.empty((4, rh, rw), np.float32)
                    target[:] = np.asarray(p.clear,
                                           np.float32).reshape(4, 1, 1)
                elif p.target == TARGET_ROOT:
                    target = fb
                else:
                    target = self.surface_atlas[:, y:y + rh, x:x + rw].copy()
                self._raster(frame, p, target)
                if p.target == TARGET_ROOT:
                    fb = target
                else:
                    # offscreen targets are RGBA8 in the reference
                    self.surface_atlas[:, y:y + rh, x:x + rw] = \
                        _quantize_unorm8(target)
            elif p.kind in (PASS_BLUR_H, PASS_BLUR_V):
                # NOTE: gl-flavoring this chain (llvmpipe blur + scale,
                # both probe-verified bit-exact per stage) measured
                # FARTHER from the CI PNGs than the swgl fixed-point
                # chain (filters r5: max_diff 3 -> 5) — kept available in
                # _blur(gl=True) for future chain-level calibration
                self._blur(p)
            elif p.kind == PASS_COPY:
                sx, sy, sw, sh = p.src_region
                dx, dy, dw, dh = p.region
                src_arr = fb if p.src_target == TARGET_ROOT \
                    else self.surface_atlas
                src = src_arr[:, sy:sy + sh, sx:sx + sw]
                if dw > sw or dh > sh:
                    # transparent-padded copy (SVGFE blur input padding)
                    src = np.pad(src, ((0, 0), (0, max(0, dh - sh)),
                                       (0, max(0, dw - sw))))
                    self.surface_atlas[:, dy:dy + dh, dx:dx + dw] = \
                        _quantize_unorm8(src)
                else:
                    self.surface_atlas[:, dy:dy + sh, dx:dx + sw] = \
                        _quantize_unorm8(src)
            elif p.kind == PASS_CHANNEL_LUT:
                sx, sy, sw, sh = p.src_region
                dx, dy, _, _ = p.region
                src = self.surface_atlas[:, sy:sy + sh, sx:sx + sw]
                a = src[3]
                safe = np.where(a > 1e-6, a, 1.0)
                straight = np.stack([src[0] / safe, src[1] / safe,
                                     src[2] / safe, a], 0)
                idx = np.clip(np.rint(straight * np.float32(255.0))
                              .astype(np.int32), 0, 255)
                out = np.stack([p.lut[c][idx[c]] for c in range(4)], 0)
                na = out[3]
                out = np.stack([out[0] * na, out[1] * na, out[2] * na, na], 0)
                self.surface_atlas[:, dy:dy + sh, dx:dx + sw] = \
                    _quantize_unorm8(out.astype(np.float32))
            elif p.kind == PASS_COLOR_MATRIX:
                sx, sy, sw, sh = p.src_region
                dx, dy, _, _ = p.region
                src = self.surface_atlas[:, sy:sy + sh, sx:sx + sw]
                from ..ops import patterns as pk
                out = pk.apply_color_matrix(
                    np, src.astype(np.float32),
                    np.asarray(p.color_matrix, np.float32),
                    np.float32(1.0))
                self.surface_atlas[:, dy:dy + sh, dx:dx + sw] = \
                    _quantize_unorm8(out.astype(np.float32))
            elif p.kind == PASS_ARITH:
                ax, ay, sw, sh = p.src_region
                bx, by, _, _ = p.src_region2
                dx, dy, _, _ = p.region
                a = self.surface_atlas[:, ay:ay + sh, ax:ax + sw]
                b = self.surface_atlas[:, by:by + sh, bx:bx + sw]
                if p.arith_linear:
                    a = blend_mod.premult_srgb_to_linear(np, a)
                    b = blend_mod.premult_srgb_to_linear(np, b)
                # cs_svg_filter.glsl:503 — unpremultiplied inputs, result
                # stored as premultiplied
                def _unp(c):
                    safe = np.where(c[3] > 1e-6, c[3], 1.0)
                    return np.stack([c[0] / safe, c[1] / safe, c[2] / safe,
                                     c[3]], 0)
                a, b = _unp(a), _unp(b)
                k = p.kvals
                out = np.clip(k[0] * a * b + k[1] * a + k[2] * b + k[3],
                              0.0, 1.0)
                if p.arith_linear:
                    out = blend_mod.premult_linear_to_srgb(np, out)
                self.surface_atlas[:, dy:dy + sh, dx:dx + sw] = \
                    _quantize_unorm8(out.astype(np.float32))
            elif p.kind == PASS_SRGB:
                sx, sy, sw, sh = p.src_region
                dx, dy, _, _ = p.region
                src = self.surface_atlas[:, sy:sy + sh, sx:sx + sw]
                out = blend_mod.premult_srgb_to_linear(np, src) \
                    if p.srgb_to_linear \
                    else blend_mod.premult_linear_to_srgb(np, src)
                self.surface_atlas[:, dy:dy + sh, dx:dx + sw] = \
                    _quantize_unorm8(out.astype(np.float32))
            elif p.kind == PASS_DOWNSCALE:
                sx, sy, sw, sh = p.src_region
                dx, dy, dw, dh = p.region
                src = self.surface_atlas[:, sy:sy + sh, sx:sx + sw]
                # gl_flavor: cs_scale runs llvmpipe's bilinear (probe-
                # verified bit-exact); swgl's fixed-point otherwise
                from ..ops.raster import (resample_bilinear,
                                          resample_bilinear_gpu)
                out = resample_bilinear(np, src, dw, dh)
                del resample_bilinear_gpu  # see the PASS_BLUR note
                self.surface_atlas[:, dy:dy + dh, dx:dx + dw] = \
                    out.astype(np.float32)
        rgba = np.transpose(fb, (1, 2, 0))
        # unorm8 conversion in f64: GL's float->u8 rounds the exact product,
        # not an f32 intermediate (f32*255 can round 229.49999 up to 229.5);
        # ties round half-up like GL unorm conversion
        v = rgba.astype(np.float64) * 255.0
        return np.clip(np.floor(np.nan_to_num(v) + 0.5), 0,
                       255).astype(np.uint8)

    # ------------------------------------------------------------------
    def _slice_raster(self, frame: Frame, p, fb):
        """One picture-cache slice, device-exact (renderer
        _run_slice_cached): raster the content grid at its content-space
        origins onto transparent, then integer src-over the cropped window
        at the slice's device offset (_slice_composite math)."""
        from ..frame.tiles import TILE_H, TILE_W
        x, y, rw, rh = p.region
        if fb is None:
            clear = np.asarray(p.clear if p.clear is not None
                               else (0.0, 0.0, 0.0, 0.0), np.float32)
            fb = np.empty((4, rh, rw), np.float32)
            fb[:] = clear.reshape(4, 1, 1)
        nxc, nyc = p.cache_nx, p.cache_ny
        anchor = p.cache_anchor
        dx, dy = p.slice_delta
        img_w, img_h = nxc * TILE_W, nyc * TILE_H
        gx0 = anchor[0] * TILE_W + dx
        gy0 = anchor[1] * TILE_H + dy

        class _Shim:
            tile_insts = p.cache_insts
            origin = (float(gx0), float(gy0))
            inst_order = p.inst_order
            raster_step = 1.0
        content = np.zeros((4, img_h, img_w), np.float32)
        self._raster(frame, _Shim, content)
        crop = p.cache_crop or (0, 0, rw, rh)
        cx0 = max(0, gx0, crop[0])
        cy0 = max(0, gy0, crop[1])
        cx1 = min(rw, gx0 + img_w, crop[2])
        cy1 = min(rh, gy0 + img_h, crop[3])
        if cx1 <= cx0 or cy1 <= cy0:
            return fb
        src = content[:, cy0 - gy0:cy1 - gy0, cx0 - gx0:cx1 - gx0]
        dst = fb[:, cy0:cy1, cx0:cx1]
        # swgl integer src-over on u8-quantized operands (_slice_composite)
        s8 = np.floor(src * np.float32(255.0) + np.float32(0.5))
        d8 = np.floor(dst * np.float32(255.0) + np.float32(0.5))
        a8 = np.broadcast_to(s8[3:4], s8.shape)
        out8 = s8 + d8 - np.floor((d8 * a8 + d8) * np.float32(1.0 / 256.0))
        fb[:, cy0:cy1, cx0:cx1] = \
            np.clip(out8, 0.0, 255.0) * np.float32(1.0 / 255.0)
        return fb

    # ------------------------------------------------------------------
    def _raster(self, frame: Frame, p, target: np.ndarray) -> None:
        ids = p.tile_insts[p.tile_insts >= 0]
        if ids.size == 0:
            return
        if p.inst_order is not None:
            present = set(int(i) for i in np.unique(ids))
            order = np.asarray([i for i in p.inst_order if int(i) in present],
                               np.int64)
        else:
            order = np.unique(ids)  # ascending id == painter order
        ox, oy = p.origin
        step = getattr(p, "raster_step", 1.0)
        rh, rw = target.shape[1], target.shape[2]
        f32 = frame.f32_buf
        gl = getattr(frame, "gl_flavor", False)
        blend_flag = blend_mod.GL_FLAVOR_FLAG if gl else 0
        from ..frame.tiles import TILE_H, TILE_W
        for iid in order:
            rec = frame.instances[iid]
            bbox = frame.inst_bboxes[iid]
            trow_w = frame.transforms[int(rec[INST_SPATIAL])]
            projective = abs(float(trow_w[2])) > 1e-12 or \
                abs(float(trow_w[5])) > 1e-12 or \
                abs(float(trow_w[8]) - 1.0) > 1e-6
            if projective:
                # PROJECTIVE prims evaluate over WHOLE TILES, exactly like
                # the device: near-degenerate perspective bboxes can
                # under-estimate the region the inverse map reaches
                # (backface-perspective), so a bbox-tight window would
                # miss pixels the device kernel shades.  Affine bboxes
                # are exact — they keep the tight (fast) window.
                tx0 = max(0, int(math.floor((bbox[0] - 1 - ox)
                                            / (TILE_W * step))))
                ty0 = max(0, int(math.floor((bbox[1] - 1 - oy)
                                            / (TILE_H * step))))
                tx1 = int(math.ceil((bbox[2] + 1 - ox) / (TILE_W * step)))
                ty1 = int(math.ceil((bbox[3] + 1 - oy) / (TILE_H * step)))
                x0 = min(rw, tx0 * TILE_W)
                y0 = min(rh, ty0 * TILE_H)
                x1 = min(rw, tx1 * TILE_W)
                y1 = min(rh, ty1 * TILE_H)
            else:
                x0 = max(0, int(math.floor((bbox[0] - 1 - ox) / step)))
                y0 = max(0, int(math.floor((bbox[1] - 1 - oy) / step)))
                x1 = min(rw, int(math.ceil((bbox[2] + 1 - ox) / step)))
                y1 = min(rh, int(math.ceil((bbox[3] + 1 - oy) / step)))
            if x1 <= x0 or y1 <= y0:
                continue
            px = ox + (np.arange(x0, x1, dtype=np.float32)[None, :] + 0.5) \
                * step
            py = oy + (np.arange(y0, y1, dtype=np.float32)[:, None] + 0.5) \
                * step
            px, py = np.broadcast_arrays(px, py)
            px = px.astype(np.float32)
            py = py.astype(np.float32)

            addr = int(rec[INST_PRIM_ADDR])
            pl = f32[addr:addr + pk.PAYLOAD_LEN]
            if pl.shape[0] < pk.PAYLOAD_LEN:
                pl = np.pad(pl, (0, pk.PAYLOAD_LEN - pl.shape[0]))
            trow = frame.transforms[int(rec[INST_SPATIAL])]
            lx, ly = pk.inverse_map(np, trow, px, py)
            sx, sy = trow[9], trow[10]
            cov = pk.rect_coverage_auto(np, trow, pl[4], pl[5], pl[6],
                                        pl[7], lx, ly, px, py,
                                        int(rec[INST_EDGE_AA]))
            m8 = np.full(cov.shape, 255.0, np.float32)
            for j in range(int(rec[INST_CLIP_COUNT])):
                ca = int(rec[INST_CLIP_ADDR]) + j * CLIP_STRIDE
                crec = f32[ca:ca + CLIP_STRIDE]
                ccov = pk.clip_coverage(np, crec, frame.transforms,
                                        px, py, self.color_atlas[0],
                                        lambda t, idx: t[int(idx)], gl=gl)
                # rect clips join the span geometry; the rest go through
                # the u8 clip-mask chain (render_task.rs new_mask)
                if crec[14] < 0.5 and crec[12] < 0.5:
                    cov = cov * ccov
                else:
                    c8 = blend_mod.quantize_cov(
                        np, ccov, np.float32(255.0))
                    if gl:
                        m8 = blend_mod.gl_mask_combine(np, c8, m8)
                    else:
                        m8 = np.floor((c8 * m8 + c8) *
                                      np.float32(1.0 / 256.0))
            kind = int(rec[INST_KIND])
            if kind == KIND_SOLID:
                color = pk.pattern_solid(np, pl, lx, ly)
            elif kind == KIND_IMAGE:
                color = pk.pattern_image(np, pl, lx, ly, self.color_atlas,
                                         gl=gl)
            elif kind == KIND_LINEAR_GRAD:
                color = pk.pattern_linear_gradient(np, _py_fori, pl, lx, ly, f32)
            elif kind == KIND_RADIAL_GRAD:
                color = pk.pattern_radial_gradient(np, _py_fori, pl, lx, ly, f32)
            elif kind == KIND_CONIC_GRAD:
                color = pk.pattern_conic_gradient(np, _py_fori, pl, lx, ly, f32)
            elif kind == KIND_GLYPH:
                color = pk.pattern_glyph(np, pl, lx, ly, self.alpha_atlas)
            elif kind == KIND_SUBPX_GLYPH:
                color = pk.pattern_subpx_glyph(np, pl, lx, ly,
                                               self.color_atlas)
            elif kind == KIND_PICTURE:
                color = pk.pattern_picture(np, pl, lx, ly, px, py,
                                           self.surface_atlas, gl=gl)
            elif kind == KIND_CLEAR:
                color = np.ones((4,) + lx.shape, np.float32)
            elif kind == KIND_BOX_SHADOW:
                color = pk.pattern_box_shadow(np, pl, lx, ly, sx, sy)
            elif kind == KIND_BORDER:
                color = pk.pattern_border(np, pl, lx, ly, sx, sy)
            elif kind == KIND_LINE_DEC:
                color = pk.pattern_line_dec(np, pl, lx, ly, sx, sy)
            elif kind == KIND_YUV:
                color = pk.pattern_yuv(np, pl, lx, ly, self.alpha_atlas)
            else:
                continue
            dst = target[:, y0:y1, x0:x1]
            target[:, y0:y1, x0:x1] = blend_mod.compose_swgl(
                np, int(rec[INST_BLEND]) | blend_flag,
                color.astype(np.float32), cov,
                m8 * np.float32(1.0 / 255.0), dst).astype(np.float32)

    # ------------------------------------------------------------------
    def _blur(self, p, gl: bool = False) -> None:
        sx_, sy_, sw, sh = p.src_region
        dx, dy, _, _ = p.region
        src = self.surface_atlas[:, sy_:sy_ + sh, sx_:sx_ + sw]
        if p.sigma <= 0:
            self.surface_atlas[:, dy:dy + sh, dx:dx + sw] = src
            return
        if gl:
            # gl_flavor: cs_blur's llvmpipe execution (integer-lerp taps,
            # glblur_check-verified bit-exact) instead of swgl's
            # fixed-point separable chain
            from ..ops.raster import blur_region_gpu
            axis = 1 if p.kind == PASS_BLUR_H else 0
            bw, bh = p.blur_region if p.blur_region is not None \
                else (sw, sh)
            out = blur_region_gpu(np, src, p.sigma, axis, bw, bh)
            self.surface_atlas[:, dy:dy + sh, dx:dx + sw] = \
                out.astype(np.float32)
            return
        radius = max(1, int(np.ceil(1.5 * p.sigma)) * 2)
        w = gaussian_weights(p.sigma, radius)
        axis = 2 if p.kind == PASS_BLUR_H else 1
        bw, bh = p.blur_region if p.blur_region is not None else (sw, sh)
        # swgl gaussianBlur*: u8 texels × integer weights, u16-saturating
        # accumulate, truncating >>8; sampling clamps into the blur region
        # (cs_blur.glsl vUvRect) = edge-replicate padding of the content,
        # edge-replicated output across the task margin
        content = np.floor(src[:, :bh, :bw] * np.float32(255.0) + 0.5)
        pad = [(0, 0), (0, 0), (0, 0)]
        pad[axis] = (radius, radius)
        x = np.pad(content, pad, mode="edge")
        out = np.zeros_like(content)
        for k in range(2 * radius + 1):
            if axis == 1:
                out += w[k] * x[:, k:k + bh, :]
            else:
                out += w[k] * x[:, :, k:k + bw]
        out = np.floor(out * np.float32(1.0 / 65536.0) + 0.5) \
            * np.float32(1.0 / 255.0)
        out = np.pad(out, ((0, 0), (0, sh - bh), (0, sw - bw)), mode="edge")
        self.surface_atlas[:, dy:dy + sh, dx:dx + sw] = \
            out.astype(np.float32)
