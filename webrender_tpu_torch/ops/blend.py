"""Blend math — premultiplied `over`, PDF/CSS mix-blend-modes.

One implementation parameterized by the array module ``xp`` (numpy for the
CPU fidelity oracle, jax.numpy for the TPU path) so both backends share
bit-identical f32 semantics — the glsl-to-cxx role re-imagined
(SURVEY.md §2.5). Formulas follow the CSS compositing spec, matching the
reference's mix-blend shader (`brush_mix_blend.glsl`).

Color layout: channel-planar arrays `[4, ...]` premultiplied RGBA.
"""
from __future__ import annotations

# Blend op ids (must match frame/gpu.py)
BLEND_NORMAL = 0
BLEND_CLEAR = 1
# Porter-Duff composite ops for the SVGFE feComposite node
# (cs_svg_filter_node.glsl FILTER_COMPOSITE_*):
BLEND_PD_IN = 2        # src·a_dst
BLEND_PD_OUT = 3       # src·(1−a_dst)
BLEND_PD_ATOP = 4      # src·a_dst + dst·(1−a_src)
BLEND_PD_XOR = 5       # src·(1−a_dst) + dst·(1−a_src)
BLEND_PD_LIGHTER = 6   # min(src+dst, 1)
# subpixel text dual-source pair (ps_text_run dual-source blending): the
# punch multiplies dst by (1−mask·a) per channel, the add accumulates
# color·mask·a
BLEND_CH_CLEAR = 7
BLEND_ADD = 8
BLEND_MIX_BASE = 16
# SVGFE feBlend nodes run the float mix formulas inside the filter shader
# (cs_svg_filter_node.glsl), NOT the framebuffer's integer KHR blend cases:
# ops 40..56 = float-domain mix blend of (40 + MixBlendMode)
BLEND_SVGFE_MIX_BASE = 40
# +64 on any op = perform the blend in linearRGB: both operands are
# converted sRGB→linear (straight-alpha), blended, and the result converted
# back (the _CONVERTSRGB shader variants of cs_svg_filter_node.glsl:105-118)
BLEND_LINEAR_BASE = 64
# highest constructible op: BLEND_LINEAR_BASE + BLEND_SVGFE_MIX_BASE +
# mode(<=16) = 120 (a linearRGB SVGFE mix-blend).  The old bound
# (BLEND_LINEAR_BASE + BLEND_MIX_BASE + 17 = 97) made the device blend
# LUTs index out of bounds for exactly those ops
# (svgfe-blend*-linear reftests crashed the device engine).
N_BLEND_OPS = BLEND_LINEAR_BASE + BLEND_SVGFE_MIX_BASE + 17


def _pow(xp, x, y):
    """pow via exp/log — GPU pow lowers the same way, and Mosaic (Pallas
    TPU) supports exp/log where a generic power op breaks layout
    inference."""
    return xp.exp(y * xp.log(xp.maximum(x, 1e-12)))


def srgb_to_linear(xp, c):
    """Exact sRGB EOTF on straight-alpha channels (blend.glsl:110-114).
    `xp.divide`: on CUDA tensors torch turns `c / 12.92` into a product
    with the reciprocal, which rounds twice."""
    return xp.where(c <= 0.04045, xp.divide(c, 12.92),
                    _pow(xp, xp.maximum(xp.divide(c, 1.055) + 0.055 / 1.055,
                                        0.0), 2.4))


def linear_to_srgb(xp, c):
    """Inverse sRGB EOTF (blend.glsl:117-120)."""
    return xp.where(c <= 0.0031308, c * 12.92,
                    1.055 * _pow(xp, xp.maximum(c, 0.0), 1.0 / 2.4) - 0.055)


def premult_srgb_to_linear(xp, col):
    rgb, a = _unpremult(xp, col)
    lin = srgb_to_linear(xp, rgb)
    return xp.stack([lin[0] * a, lin[1] * a, lin[2] * a, a], 0)


def premult_linear_to_srgb(xp, col):
    rgb, a = _unpremult(xp, col)
    s = linear_to_srgb(xp, rgb)
    return xp.stack([s[0] * a, s[1] * a, s[2] * a, a], 0)


def _unpremult(xp, c):
    a = c[3]
    safe = xp.where(a > 1e-6, a, 1.0)
    return xp.stack([c[0] / safe, c[1] / safe, c[2] / safe], 0), a


def _lum(xp, c):
    return 0.3 * c[0] + 0.59 * c[1] + 0.11 * c[2]


def _clip_color(xp, c):
    l = _lum(xp, c)
    n = xp.minimum(xp.minimum(c[0], c[1]), c[2])
    x = xp.maximum(xp.maximum(c[0], c[1]), c[2])
    # if n < 0: c = l + (c - l) * l / (l - n)
    denom_n = xp.where(xp.abs(l - n) > 1e-6, l - n, 1e-6)
    c_lo = l + (c - l) * (l / denom_n)
    c = xp.where(n < 0.0, c_lo, c)
    # recompute bounds after first clip
    x = xp.maximum(xp.maximum(c[0], c[1]), c[2])
    denom_x = xp.where(xp.abs(x - l) > 1e-6, x - l, 1e-6)
    c_hi = l + (c - l) * ((1.0 - l) / denom_x)
    c = xp.where(x > 1.0, c_hi, c)
    return c


def _set_lum(xp, c, l):
    return _clip_color(xp, c + (l - _lum(xp, c)))


def _sat(xp, c):
    return xp.maximum(xp.maximum(c[0], c[1]), c[2]) - \
        xp.minimum(xp.minimum(c[0], c[1]), c[2])


def _set_sat(xp, c, s):
    cmin = xp.minimum(xp.minimum(c[0], c[1]), c[2])
    cmax = xp.maximum(xp.maximum(c[0], c[1]), c[2])
    d = cmax - cmin
    safe = xp.where(d > 1e-6, d, 1.0)
    out = xp.where(d > 1e-6, (c - cmin) * (s / safe), 0.0)
    return out


def mix_blend_rgb(xp, mode: int, cb, cs):
    """Non-premultiplied blend B(Cb, Cs) for one MixBlendMode (int id,
    MixBlendMode.value). cb/cs: [3, ...] backdrop/source."""
    if mode == 1:  # multiply
        return cb * cs
    if mode == 2:  # screen
        return cb + cs - cb * cs
    if mode == 3:  # overlay = hard-light(cs, cb) swapped
        return mix_blend_rgb(xp, 8, cs, cb)
    if mode == 4:  # darken
        return xp.minimum(cb, cs)
    if mode == 5:  # lighten
        return xp.maximum(cb, cs)
    if mode == 6:  # color-dodge
        safe = xp.where(cs < 1.0, 1.0 - cs, 1e-6)
        out = xp.minimum(1.0, cb / safe)
        out = xp.where(cb <= 0.0, 0.0, xp.where(cs >= 1.0, 1.0, out))
        return out
    if mode == 7:  # color-burn
        safe = xp.where(cs > 0.0, cs, 1e-6)
        out = 1.0 - xp.minimum(1.0, (1.0 - cb) / safe)
        out = xp.where(cb >= 1.0, 1.0, xp.where(cs <= 0.0, 0.0, out))
        return out
    if mode == 8:  # hard-light
        lo = cb * (2.0 * cs)
        hi = cb + (2.0 * cs - 1.0) - cb * (2.0 * cs - 1.0)
        return xp.where(cs <= 0.5, lo, hi)
    if mode == 9:  # soft-light
        d_lo = ((16.0 * cb - 12.0) * cb + 4.0) * cb
        d_hi = xp.sqrt(xp.maximum(cb, 0.0))
        d = xp.where(cb <= 0.25, d_lo, d_hi)
        lo = cb - (1.0 - 2.0 * cs) * cb * (1.0 - cb)
        hi = cb + (2.0 * cs - 1.0) * (d - cb)
        return xp.where(cs <= 0.5, lo, hi)
    if mode == 10:  # difference
        return xp.abs(cb - cs)
    if mode == 11:  # exclusion
        return cb + cs - 2.0 * cb * cs
    if mode == 12:  # hue
        return _set_lum(xp, _set_sat(xp, cs, _sat(xp, cb)), _lum(xp, cb))
    if mode == 13:  # saturation
        return _set_lum(xp, _set_sat(xp, cb, _sat(xp, cs)), _lum(xp, cb))
    if mode == 14:  # color
        return _set_lum(xp, cs, _lum(xp, cb))
    if mode == 15:  # luminosity
        return _set_lum(xp, cb, _lum(xp, cs))
    if mode == 16:  # plus-lighter (additive, handled premult outside)
        return cs
    return cs  # normal


def _mul255(xp, x, y):
    """swgl muldiv255 (blend.h:126): (x*y + x) >> 8 on u8-domain integers
    held exactly in f32."""
    return xp.floor((x * y + x) * (1.0 / 256.0))


def _alphas(xp, c):
    """Broadcast the alpha lane across all four channels (blend.h alphas)."""
    return xp.stack([c[3], c[3], c[3], c[3]], 0)


def _rgb_only(xp, c):
    """Zero the alpha lane (blend.h RGB_MASK)."""
    z = c[3] * 0.0
    return xp.stack([c[0], c[1], c[2], z], 0)


def _pack_float(xp, v):
    """swgl pack_pixels_RGBA8 round: roundfast = SSE2 cvtps round-half-even
    of v*255, saturating (glsl.h:732).  NOT tie-nudged: a nudged color
    pack breaks YAML<->YAML equivalences where two display-list routes
    produce x.5 vs x.5-delta (r5: gradient/radial-optimized) — the nudge
    applies only to coverage/mask quantization (quantize_cov)."""
    return xp.clip(xp.rint(v * 255.0), 0.0, 255.0)


def _blend_case_int(xp, op: int, s, d):
    """swgl blend_pixels (blend.h:416-698) integer blend cases on
    u8-domain [4, ...] premultiplied values (exact integers in f32).
    Returns the unpacked (possibly >255) result; caller saturates."""
    if op == BLEND_CLEAR:
        # GL_ZERO, GL_ONE_MINUS_SRC_ALPHA (ps_clear)
        return d - _mul255(xp, d, _alphas(xp, s))
    if op == BLEND_CH_CLEAR:
        # GL_ZERO, GL_ONE_MINUS_SRC_COLOR (subpixel text punch)
        return d - _mul255(xp, d, s)
    if op == BLEND_ADD:
        return s + d
    if op == BLEND_NORMAL or op < BLEND_MIX_BASE:
        return s + d - _mul255(xp, d, _alphas(xp, s))
    mode = op - BLEND_MIX_BASE
    if mode == 0:
        return s + d - _mul255(xp, d, _alphas(xp, s))
    if mode == 16:  # plus-lighter: GL_ONE, GL_ONE
        return s + d
    sA = _alphas(xp, s)
    dA = _alphas(xp, d)
    if mode == 1:  # multiply (GL_MULTIPLY_KHR)
        diff = _mul255(xp, sA - _rgb_only(xp, s), dA - _rgb_only(xp, d))
        return s + d + _rgb_only(xp, diff) - _alphas(xp, diff)
    if mode == 2:  # screen
        return s + d - _mul255(xp, s, d)
    if mode in (3, 8):  # overlay / hard-light
        diff = _mul255(xp, s, d) + _mul255(xp, sA - s, dA - d)
        sel = d * 2.0 <= dA if mode == 3 else s * 2.0 <= sA
        return s + d + xp.where(sel,
                                _rgb_only(xp, diff) - _alphas(xp, diff),
                                -diff)
    if mode == 4:  # darken
        return s + d - xp.maximum(_mul255(xp, s, dA), _mul255(xp, d, sA))
    if mode == 5:  # lighten
        return s + d - xp.minimum(_mul255(xp, s, dA), _mul255(xp, d, sA))
    if mode == 6:  # color-dodge (FP path, blend.h:587)
        # recip_or(sA - s, 255): 1/(sA-s), or 255 when the divisor is zero
        recip = xp.where(sA - s != 0.0,
                         1.0 / xp.where(sA - s != 0.0, sA - s, 1.0), 255.0)
        t = xp.minimum(dA, d * sA * recip)
        term = sA * _set_alpha_lane(xp, t, d)
        v = (term + s * (255.0 - dA) + d * (255.0 - sA)) * (1.0 / 255.0)
        return xp.floor(v + 0.5)
    if mode == 7:  # color-burn (blend.h:601)
        recip = xp.where(s != 0.0, 1.0 / xp.where(s != 0.0, s, 1.0), 255.0)
        t = dA - xp.minimum(dA, (dA - d) * sA * recip)
        term = sA * _set_alpha_lane(xp, t, d)
        v = (term + s * (255.0 - dA) + d * (255.0 - sA)) * (1.0 / 255.0)
        return xp.floor(v + 0.5)
    if mode == 9:  # soft-light (blend.h:622, FP)
        dU = xp.where(dA > 0.0, d / xp.where(dA > 0.0, dA, 1.0), 0.0)
        scale = s + s - sA
        inv_sqrt = xp.where(dU > 0.0, 1.0 / xp.sqrt(xp.where(dU > 0.0, dU,
                                                             1.0)), 1e6)
        inner = xp.where(scale < 0.0, 1.0 - dU,
                         xp.minimum((16.0 * dU - 12.0) * dU + 3.0,
                                    inv_sqrt - 1.0))
        v = (d * (255.0 + _set_alpha_lane(xp, scale * inner, inner * 0.0))
             + s * (255.0 - dA)) * (1.0 / 255.0)
        return xp.floor(v + 0.5)
    if mode == 10:  # difference
        diff = xp.minimum(_mul255(xp, d, sA), _mul255(xp, s, dA))
        return s + d - diff - _rgb_only(xp, diff)
    if mode == 11:  # exclusion
        diff = _mul255(xp, s, d)
        return s + d - diff - _rgb_only(xp, diff)
    # HSL modes (blend.h DO_HSL, FP at 0..255 scale)
    srcA = s[3] * (1.0 / 255.0)
    dstA = d[3] * (1.0 / 255.0)
    srcDstA = s[3] * dstA
    srcC = s[:3] * dstA
    dstC = d[:3] * srcA
    if mode == 12:    # hue
        rgb = _set_lum_sat255(xp, srcC, dstC, dstC, srcDstA)
    elif mode == 13:  # saturation
        rgb = _set_lum_sat255(xp, dstC, srcC, dstC, srcDstA)
    elif mode == 14:  # color
        rgb = _set_lum255(xp, srcC, dstC, srcDstA)
    else:             # luminosity
        rgb = _set_lum255(xp, dstC, srcC, srcDstA)
    out_rgb = rgb + s[:3] - srcC + d[:3] - dstC
    out_a = s[3] + d[3] - srcDstA
    v = xp.stack([out_rgb[0], out_rgb[1], out_rgb[2], out_a], 0)
    return xp.floor(v + 0.5)


def _set_alpha_lane(xp, c, a):
    """set_alphas: rgb lanes from c, alpha lane from a."""
    return xp.stack([c[0], c[1], c[2], a[3]], 0)


def _lum255(xp, c):
    """swgl lum_coeffs dot (blend.h HSL helpers) at 0..255 scale."""
    return 0.3 * c[0] + 0.59 * c[1] + 0.11 * c[2]


def _set_lum255(xp, base, ref, alpha):
    """swgl set_lum (blend.h:~660): offset base to ref's luminance and clip
    into [0, alpha] preserving luminance; 0..255-scale floats."""
    lum = _lum255(xp, base)
    diff = _lum255(xp, ref) - lum
    c = base + diff
    l = lum + diff
    cmin = xp.minimum(xp.minimum(c[0], c[1]), c[2])
    cmax = xp.maximum(xp.maximum(c[0], c[1]), c[2])
    lo_safe = xp.where(xp.abs(l - cmin) > 1e-6, l - cmin, 1e-6)
    hi_safe = xp.where(xp.abs(cmax - l) > 1e-6, cmax - l, 1e-6)
    c = xp.where(cmin < 0.0, l + (c - l) * (l / lo_safe), c)
    cmax = xp.maximum(xp.maximum(c[0], c[1]), c[2])
    hi_safe = xp.where(xp.abs(cmax - l) > 1e-6, cmax - l, 1e-6)
    c = xp.where(cmax > alpha, l + (c - l) * ((alpha - l) / hi_safe), c)
    return c


def _set_lum_sat255(xp, base, sref, lref, alpha):
    cmin = xp.minimum(xp.minimum(base[0], base[1]), base[2])
    cmax = xp.maximum(xp.maximum(base[0], base[1]), base[2])
    d = cmax - cmin
    smax = xp.maximum(xp.maximum(sref[0], sref[1]), sref[2]) - \
        xp.minimum(xp.minimum(sref[0], sref[1]), sref[2])
    safe = xp.where(d > 1e-6, d, 1.0)
    scaled = xp.where(d > 1e-6, (base - cmin) * (smax / safe), 0.0)
    return _set_lum255(xp, scaled, lref, alpha)


# gl_flavor: reftest lines gated to platform(linux/mac) compare against
# PNGs rendered by the linux CI's llvmpipe (Mesa software GL).  Each
# backend ORs the flag into the blend op at render/trace time from
# frame.gl_flavor: the numpy oracle per instance (oracle/sw.py _raster),
# the XLA and Pallas engines via their static `gl` parameter (the renderer
# threads frame.gl_flavor into every dispatch, compiling distinct kernel
# variants).  The flag is never stored in instance records, so device
# blend LUTs stay sized to N_BLEND_OPS.
GL_FLAVOR_FLAG = 0x1000


# Tie-nudged u8 quantization for COVERAGE-derived values.  TPU div / sqrt
# / exp are not correctly rounded (multi-ULP vs the host — measured
# directly), so coverage values that land mathematically on an exact
# half-step (x.5, common on half-pixel AA boundaries) arrive as x.5 on the
# numpy oracle but x.5±ulp on the chip, flipping rint ties and breaking
# the device==oracle contract one u8 step at a time.  Nudging the round
# point DOWN by far-above-ULP-but-far-below-visible epsilon makes every
# backend round such values identically (up), while exact integers are
# untouched.  Colors keep swgl's round-half-even pack — the nudge applies
# only to coverage/mask quantization.
# 1/1024 of a u8 step: absorbs exact-half ties (values the analytic math
# produces as x.5 exactly, where TPU transcendental ULP noise would flip
# backends to different sides) while leaving the swgl round-half-even pack
# behavior unchanged for everything visibly off the tie.  Larger nudges
# measurably regress PNG fidelity (r5: 1/64 cost ~12 oracle cases).
COV_TIE_EPS = 1.0 / 1024.0


def quantize_cov(xp, cov, scale):
    return xp.floor(cov * scale + (0.5 + COV_TIE_EPS))


def gl_mask_combine(xp, c8, m8):
    """llvmpipe clip-mask accumulation: each mask renders into the shared
    R8 clip task with multiply blending — dst*src in 8-bit fixed point,
    round-to-nearest (Mesa lp_build_mul_norm; calibrated by glprobe)."""
    return xp.rint(c8 * m8 * (1.0 / 255.0))


def compose_gl(xp, op: int, color, cov, mcov, dst):
    """llvmpipe fixed-function compose (the linux CI renderer behind
    platform(linux,mac) PNG refs — calibrated by tools/glprobe.py):
    the fragment shader's premultiplied float color (AA coverage and the
    sampled u8 clip mask multiply in shader float) converts to u8 with
    ROUND-HALF-EVEN at the blend input; blend factors compute in 8-bit
    fixed point (`dst*(255-a8)` rounded /255); saturating add at the
    unorm8 target write."""
    src = color * (cov * mcov)[None]
    if op == BLEND_NORMAL:
        s = _pack_float(xp, src)
        d = xp.floor(dst * 255.0 + 0.5)
        out = s + xp.rint(d * (255.0 - _alphas(xp, s)) * (1.0 / 255.0))
    elif op == BLEND_ADD:
        s = _pack_float(xp, src)
        d = xp.floor(dst * 255.0 + 0.5)
        out = s + d
    elif op == BLEND_CLEAR:
        s = _pack_float(xp, src)
        d = xp.floor(dst * 255.0 + 0.5)
        out = xp.rint(d * (255.0 - _alphas(xp, s)) * (1.0 / 255.0))
    elif op == BLEND_CH_CLEAR:
        s = _pack_float(xp, src)
        d = xp.floor(dst * 255.0 + 0.5)
        out = xp.rint(d * (255.0 - s) * (1.0 / 255.0))
    else:
        # mix-blend / PD / linear ops run through shader float math in GL
        # too — keep the existing float path, quantized half-even
        return compose_swgl(xp, op, color, cov, mcov, dst)
    out = xp.clip(out, 0.0, 255.0) * (1.0 / 255.0)
    return xp.where(xp.broadcast_to(cov[None] > 0.0, out.shape), out, dst)


def compose_swgl(xp, op: int, color, cov, mcov, dst):
    """The full swgl per-fragment compose (rasterize.h + blend.h):
    pack the shader's premultiplied f32 color to u8 (round_pixel:
    trunc(v*255+0.5)), scale by the span-AA weight 0..256 (DO_AA
    muldiv256), multiply by the u8 clip mask (muldiv255), run the
    integer blend case, saturate.  `cov` is geometric/edge-AA coverage,
    `mcov` the clip-mask chain value (both [H, W] f32 in [0,1]);
    `dst` is premultiplied f32 on the u8 grid.  Exact in f32: every
    intermediate is an integer below 2^24."""
    if op & GL_FLAVOR_FLAG:
        return compose_gl(xp, op & ~GL_FLAVOR_FLAG, color, cov, mcov, dst)
    if op >= BLEND_LINEAR_BASE or op in (BLEND_PD_IN, BLEND_PD_OUT,
                                         BLEND_PD_ATOP, BLEND_PD_XOR,
                                         BLEND_PD_LIGHTER) or \
            BLEND_SVGFE_MIX_BASE <= op < BLEND_LINEAR_BASE:
        # SVGFE composite/blend ops run in the filter shader's float
        # domain (cs_svg_filter_node.glsl), not the framebuffer blender
        if BLEND_SVGFE_MIX_BASE <= op < BLEND_LINEAR_BASE:
            op = BLEND_MIX_BASE + (op - BLEND_SVGFE_MIX_BASE)
        src = color * (cov * mcov)[None]
        out = blend_src_over_dst(xp, op, src, dst)
        return _pack_float(xp, out) * (1.0 / 255.0)
    s = _pack_float(xp, color)
    aa = quantize_cov(xp, xp.clip(cov, 0.0, 1.0), 256.0)[None]
    s = xp.floor(s * aa * (1.0 / 256.0))
    m = quantize_cov(xp, xp.clip(mcov, 0.0, 1.0), 255.0)[None]
    s = xp.floor((s * m + s) * (1.0 / 256.0))
    d = xp.floor(dst * 255.0 + 0.5)
    out = _blend_case_int(xp, op, s, d)
    out = xp.clip(out, 0.0, 255.0) * (1.0 / 255.0)
    # fragments with zero geometric coverage are never rasterized (the
    # span doesn't reach them) — also keeps NaN pattern values from
    # stale sampling windows out of the accumulator
    return xp.where(xp.broadcast_to(cov[None] > 0.0, out.shape), out, dst)


def blend_src_over_dst(xp, op: int, src, dst):
    """Full blend of premultiplied src [4,...] over premultiplied dst [4,...]
    for a *static* blend op id. Coverage must already be folded into src."""
    if op >= BLEND_LINEAR_BASE:
        s = premult_srgb_to_linear(xp, src)
        d = premult_srgb_to_linear(xp, dst)
        out = blend_src_over_dst(xp, op - BLEND_LINEAR_BASE, s, d)
        return premult_linear_to_srgb(xp, out)
    if op == BLEND_CLEAR:
        # clear: punch out dst by src alpha (ps_clear semantics — the clear
        # rect writes transparent; here src.a carries the coverage)
        return dst * (1.0 - src[3])
    if op == BLEND_PD_IN:
        return src * dst[3]
    if op == BLEND_PD_OUT:
        return src * (1.0 - dst[3])
    if op == BLEND_PD_ATOP:
        return src * dst[3] + dst * (1.0 - src[3])
    if op == BLEND_PD_XOR:
        return src * (1.0 - dst[3]) + dst * (1.0 - src[3])
    if op == BLEND_PD_LIGHTER:
        return xp.minimum(src + dst, 1.0)
    if op == BLEND_CH_CLEAR:
        return dst * (1.0 - src)
    if op == BLEND_ADD:
        return xp.minimum(dst + src, 1.0)
    if op == BLEND_NORMAL or op < BLEND_MIX_BASE:
        return src + dst * (1.0 - src[3])
    if op >= BLEND_SVGFE_MIX_BASE:
        op = BLEND_MIX_BASE + (op - BLEND_SVGFE_MIX_BASE)
    mode = op - BLEND_MIX_BASE
    if mode == 0:
        return src + dst * (1.0 - src[3])
    if mode == 16:  # plus-lighter
        return xp.minimum(src + dst, 1.0)
    cs, a_s = _unpremult(xp, src)
    cb, a_b = _unpremult(xp, dst)
    b = mix_blend_rgb(xp, mode, cb, cs)
    # W3C compositing in premultiplied form:
    #   Co = (1-ab)·(as·Cs) + ab·as·B(Cb,Cs) + (1-as)·(ab·Cb)
    # using src_rgb = as·Cs and dst_rgb = ab·Cb directly keeps the
    # ab == 0 case bit-exact (no unpremultiply round-trip), matching the
    # reference's invalid-backdrop fallback to normal blending.
    a_out = a_s + a_b * (1.0 - a_s)
    rgb = (1.0 - a_b) * src[:3] + a_b * a_s * b + (1.0 - a_s) * dst[:3]
    return xp.stack([rgb[0], rgb[1], rgb[2], a_out], 0)
