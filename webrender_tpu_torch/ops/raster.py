"""Raster helpers of the port: the host (numpy / `xp`) blur and resample
math that the frame builder runs, and the torch offscreen passes.

The first part is `webrender_tpu/ops/raster.py`'s host helpers
(`gauss_pair_taps` :270, `blur_gpu_1d` :310, `swgl_blur_weights` :372,
`gaussian_weights` :441, `blur_plane_gpu` :479, `_rint` :493,
`resample_bilinear_gpu` :498, `resample_bilinear` :538), and
`oracle/sw.py`'s `_py_fori` (:42): the frame builder rasters box-shadow
masks and nine-patch gradient sources with them on the host.  They are
unchanged but for `resample_bilinear`, which also takes the torch array
module (`ops/xp.py`) and a tensor: the renderer's downscale passes
(`_downscale2x`, renderer/renderer.py:335) run it on the surface atlas's
device.

The second part is the renderer's other offscreen-pass math as torch ops:
`blur_region` (the separable blur of `ops/raster.py:235`) and
`quantize_unorm8` (`_quantize_unorm8`, renderer.py:262).  The blur
multiplies u8 texels by 16-bit integer weights and every sum stays below
2^24, so these torch ops give the JAX functions' bits.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import patterns as pk


def gauss_pair_taps(sigma: float, support: int):
    """cs_blur.glsl fragment-shader tap schedule (:141-170): the f32
    incremental-gaussian recurrence evaluated exactly as the shader does,
    two adjacent texels per iteration folded into ONE bilinear fetch at
    offset i + ratio with combined weight `subtotal`.  Returns
    (w0, [(offset, subtotal), ...]) — all f32 scalars."""
    f = np.float32
    s = f(sigma)
    x = f(f(1.0) / f(np.sqrt(f(2.0) * f(3.14159265)) * s))
    y = f(np.exp(f(-0.5) / (s * s)))
    z = f(y * y)
    gx, gy = x, y
    total = gx
    i = 1
    while i <= support:
        gx = f(gx * gy)
        gy = f(gy * z)
        sub = gx
        gx = f(gx * gy)
        gy = f(gy * z)
        sub = f(sub + gx)
        total = f(total + f(f(2.0) * sub))
        i += 2
    w0 = f(x / total)
    gx, gy = w0, y
    taps = []
    i = 1
    while i <= support:
        gx = f(gx * gy)
        gy = f(gy * z)
        sub = gx
        gx = f(gx * gy)
        gy = f(gy * z)
        sub = f(sub + gx)
        ratio = f(gx / sub)
        taps.append((f(f(i) + ratio), sub))
        i += 2
    return w0, taps


def blur_gpu_1d(xp, src, sigma: float, axis: int, blur_len: int):
    """One direction of the llvmpipe-flavored GPU blur (cs_blur.glsl
    fragment path as the linux CI's Mesa software GL executes it): paired
    taps at fractional offsets, each tap fetched with llvmpipe's 8-bit
    INTEGER bilinear lerp (`(a·(256−w)+b·w+128)>>8`, glprobe-calibrated —
    NOT the float lerp a hardware GPU would return), accumulated in f32
    in shader order; sampling clamps into [0.5, blur_len - 0.5] (vUvRect).
    `src` is [4, h, w] of u8-quantized values; the caller packs the result
    to u8 (render-target write).  Bit-deterministic across numpy and XLA
    (sequential f32 ops only).  blur_region_gpu inherits this flavor."""
    support = int(np.ceil(1.5 * sigma)) * 2
    if support <= 0:
        return src
    w0, taps = gauss_pair_taps(sigma, support)
    n = src.shape[1 + axis]
    L = min(blur_len, n)
    uv = xp.arange(n).astype("float32") + np.float32(0.5)
    lo = np.float32(0.5)
    hi = np.float32(max(L - 0.5, 0.5))
    avg = src * w0
    for off, sub in taps:
        for sign in (np.float32(-1.0), np.float32(1.0)):
            p = xp.clip(uv + sign * off, lo, hi)
            t = p - np.float32(0.5)
            i0 = xp.floor(t)
            # llvmpipe bilinear (glprobe-calibrated): 8-bit ROUNDED
            # weight, integer lerp (a·(256−w)+b·w+128)>>8 — the tap the
            # blur shader's texture() call actually returns on the CI
            # rasterizer (u8-grid value)
            fr = xp.floor((t - i0) * np.float32(256.0) + np.float32(0.5))
            i0 = i0.astype("int32")
            a = xp.take(src, xp.clip(i0, 0, n - 1), axis=1 + axis)
            b = xp.take(src, xp.clip(i0 + 1, 0, n - 1), axis=1 + axis)
            shape = [1, 1, 1]
            shape[1 + axis] = n
            frb = fr.reshape(shape)
            texel = xp.floor((a * (np.float32(256.0) - frb) + b * frb
                              + np.float32(128.0)) * np.float32(1.0 / 256.0))
            avg = avg + texel * sub
    return avg


def swgl_blur_weights(sigma: float, radius: int) -> np.ndarray:
    """swgl gaussianBlurHorizontal/Vertical weights (swgl/src/texture.h):
    the f32 incremental-gaussian recurrence of cs_blur.glsl, pre-scaled by
    8 bits of fractional precision and truncated per offset with
    `uint16_t(coeff + 0.5f)`.  Returns [radius+1] integer-valued f32
    (center first)."""
    f = np.float32
    s = f(sigma)
    x = f(f(1.0) / f(np.sqrt(f(2.0) * f(3.14159265)) * s))
    y = f(np.exp(f(-0.5) / (s * s)))
    z = f(y * y)
    # vertex-shader normalization (calculate_gauss_coefficients)
    gx, gy = x, y
    total = gx
    i = 1
    while i <= radius:
        gx = f(gx * gy)
        gy = f(gy * z)
        sub = gx
        gx = f(gx * gy)
        gy = f(gy * z)
        sub = f(sub + gx)
        total = f(total + f(f(2.0) * sub))
        i += 2
    coeff = f(f(x / total) * f(256.0))
    step = y
    step2 = z
    w = np.zeros(radius + 1, np.float32)
    w[0] = np.trunc(f(coeff + f(0.5)))
    for k in range(1, radius + 1):
        coeff = f(coeff * step)
        step = f(step * step2)
        w[k] = np.trunc(f(coeff + f(0.5)))
    return w


def gaussian_weights(sigma: float, radius: int) -> np.ndarray:
    """Blur tap weights matching the GPU float path of cs_blur.glsl
    (calculate_gauss_coefficients :47-70: f32 incremental-gaussian
    recurrence, normalized by the paired-tap total), quantized to 16-bit
    fixed point (x65536).  The quantization keeps every blur product and
    tap sum an exact integer < 2^24, so all backends agree bit-for-bit
    while staying within ~0.1 u8 step of the exact GPU result.  Returns
    the symmetric [2*radius+1] tap array (f32 integer values)."""
    f = np.float32
    s = f(sigma)
    x = f(1.0) / f(np.sqrt(f(2.0) * f(3.14159265)) * s)
    y = f(np.exp(f(-0.5) / (s * s)))
    z = f(y * y)
    gx, gy = x, y
    total = gx
    i = 1
    while i <= radius:
        gx = f(gx * gy)
        gy = f(gy * z)
        sub = gx
        gx = f(gx * gy)
        gy = f(gy * z)
        sub = f(sub + gx)
        total = f(total + f(f(2.0) * sub))
        i += 2
    coeff = f(f(x / total) * f(65536.0))
    step = y
    step2 = f(y * y)
    w = np.zeros(2 * radius + 1, np.float32)
    w[radius] = np.trunc(f(coeff + f(0.5)))
    for k in range(1, radius + 1):
        coeff = f(coeff * step)
        step = f(step * step2)
        wk = np.trunc(f(coeff + f(0.5)))
        w[radius + k] = wk
        w[radius - k] = wk
    return w


def blur_plane_gpu(xp, plane, sigma: float):
    """GPU float blur of one [h, w] plane, V then H, with R8 render-target
    quantization between the two directions (the alpha-target blur chain
    of box-shadow masks: render_task.rs new_blur + cs_blur.glsl float
    fragment math).  `plane` holds u8-quantized values in [0, 1]."""
    src = plane[None]
    for axis in (0, 1):
        content = xp.floor(src * np.float32(255.0) + np.float32(0.5))
        L = content.shape[1 + axis]
        out = blur_gpu_1d(xp, content, sigma, axis, L)
        src = xp.clip(_rint(xp, out), 0.0, 255.0) * np.float32(1.0 / 255.0)
    return src[0]


def _rint(xp, v):
    """Round half to even (GL unorm8 render-target conversion)."""
    return xp.round(v) if not hasattr(xp, "rint") else xp.rint(v)


def resample_bilinear_gpu(xp, src, dw: int, dh: int):
    """cs_scale.glsl resample with llvmpipe's exact bilinear filtering
    (glprobe-calibrated: 8-bit rounded weights, per-axis integer lerp
    `(a·(256−w)+b·w+128)>>8`, X then Y), u8 quantization at the
    render-target write.  `src` is planar [c, h, w] u8-quantized."""
    c, h, w = src.shape
    u = (xp.arange(dw).astype("float32") + np.float32(0.5)) * \
        np.float32(w / dw)
    v = (xp.arange(dh).astype("float32") + np.float32(0.5)) * \
        np.float32(h / dh)
    u = xp.clip(u, 0.5, max(w - 0.5, 0.5))
    v = xp.clip(v, 0.5, max(h - 0.5, 0.5))
    tu = u - np.float32(0.5)
    tv = v - np.float32(0.5)
    x0 = xp.clip(xp.floor(tu), 0, max(w - 2, 0))
    y0 = xp.clip(xp.floor(tv), 0, max(h - 2, 0))
    fx = xp.floor((tu - x0) * np.float32(256.0)
                  + np.float32(0.5))[None, None, :]
    fy = xp.floor((tv - y0) * np.float32(256.0)
                  + np.float32(0.5))[None, :, None]
    x0 = x0.astype("int32")
    y0 = y0.astype("int32")
    texels = xp.floor(src * np.float32(255.0) + np.float32(0.5))
    x1 = xp.clip(x0 + 1, 0, w - 1)
    y1 = xp.clip(y0 + 1, 0, h - 1)
    r0 = xp.take(texels, y0, axis=1)
    r1 = xp.take(texels, y1, axis=1)
    t00 = xp.take(r0, x0, axis=2)
    t10 = xp.take(r0, x1, axis=2)
    t01 = xp.take(r1, x0, axis=2)
    t11 = xp.take(r1, x1, axis=2)
    a = xp.floor((t00 * (np.float32(256.0) - fx) + t10 * fx
                  + np.float32(128.0)) * np.float32(1.0 / 256.0))
    b = xp.floor((t01 * (np.float32(256.0) - fx) + t11 * fx
                  + np.float32(128.0)) * np.float32(1.0 / 256.0))
    out = xp.floor((a * (np.float32(256.0) - fy) + b * fy
                    + np.float32(128.0)) * np.float32(1.0 / 256.0))
    return xp.clip(out, 0.0, 255.0) * np.float32(1.0 / 255.0)


@functools.lru_cache(maxsize=64)
def _resample_taps(w: int, h: int, dw: int, dh: int):
    """`resample_bilinear`'s addressing, on the host: the flat indices of
    each target texel's taps (x0, y0), (x1, y0), (x0, y1), (x1, y1) and
    its 7-bit fractions fx, fy, [dh, dw] each."""
    u = (np.arange(dw).astype("float32") + 0.5) * (w / dw)
    v = (np.arange(dh).astype("float32") + 0.5) * (h / dh)
    u = np.clip(u, 0.5, max(w - 0.5, 0.5))
    v = np.clip(v, 0.5, max(h - 0.5, 0.5))
    ug, vg = np.meshgrid(u, v)
    x0, y0, row1, fx, fy = pk.swgl_bilinear_coords(np, ug, vg, w, h)
    y1 = y0 + row1
    x1 = np.clip(x0 + 1, 0, w - 1)
    taps = tuple((y * w + x).astype(np.int64)
                 for y, x in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)))
    return taps, fx, fy


@functools.lru_cache(maxsize=64)
def _resample_taps_on(w: int, h: int, dw: int, dh: int, device):
    taps, fx, fy = _resample_taps(w, h, dw, dh)
    return (tuple(torch.from_numpy(t).to(device) for t in taps),
            torch.from_numpy(fx).to(device), torch.from_numpy(fy).to(device))


def resample_bilinear(xp, src, dw: int, dh: int):
    """cs_scale.glsl resample with swgl's fixed-point bilinear filtering
    (texture.h textureLinearPlanarRGBA8): each target texel samples the
    source at `src_size * (i + 0.5) / dst_size`, clamped half a texel
    inside, with 7-bit fractions and truncating int16 lerps.  `src` is a
    planar [4, h, w] array of u8-quantized values (a numpy array, or a
    tensor with `xp` the torch array module); returns the same."""
    c, h, w = src.shape
    if isinstance(src, torch.Tensor):
        taps, fx, fy = _resample_taps_on(w, h, dw, dh, src.device)
    else:
        taps, fx, fy = _resample_taps(w, h, dw, dh)
    flat = src.reshape(c, -1)
    t00, t10, t01, t11 = (xp.floor(flat[:, i] * 255.0 + 0.5) for i in taps)
    a = pk._fixed_lerp(xp, t00, t01, fy[None])
    b = pk._fixed_lerp(xp, t10, t11, fy[None])
    return pk._fixed_lerp(xp, a, b, fx[None]) * (1.0 / 255.0)


def _py_fori(lo, hi, body, init):
    val = init
    for i in range(int(lo), int(hi)):
        val = body(i, val)
    return val


# --- the offscreen passes on tensors ----------------------------------------

def quantize_unorm8(img):
    """An RGBA8 render-target write: round half to even on the u8 grid."""
    return torch.clamp(torch.round(img * 255.0), 0.0, 255.0) * (1.0 / 255.0)


def _edge_pad(x, dim: int, before: int, after: int):
    """x padded along `dim` by replicating its edge entries
    (`jnp.pad(mode="edge")`)."""
    n = x.shape[dim]
    idx = torch.arange(-before, n + after, device=x.device).clamp(0, n - 1)
    return x.index_select(dim, idx)


def blur_region(src, weights, *, radius: int, axis: int, bw: int = 0,
                bh: int = 0):
    """Separable gaussian blur of a planar [4, h, w] region along `axis`
    (0 = vertical), taps clamped into the blur region [0, bw) x [0, bh)
    and the output beyond it replicated from the region's edge
    (`blur_region`, ops/raster.py:235).  `weights` is the [2r+1] integer
    array of `gaussian_weights`; the taps add in the order k = 0..2r."""
    h, w = src.shape[1], src.shape[2]
    bw = w if bw <= 0 else bw
    bh = h if bh <= 0 else bh
    content = torch.floor(src[:, :bh, :bw] * 255.0 + 0.5)
    n = bh if axis == 0 else bw
    x = _edge_pad(content, 1 + axis, radius, radius)
    out = torch.zeros_like(content)
    for k in range(2 * radius + 1):
        out = out + float(weights[k]) * x.narrow(1 + axis, k, n)
    out = torch.floor(out * (1.0 / 65536.0) + 0.5) * (1.0 / 255.0)
    return _edge_pad(_edge_pad(out, 1, 0, h - bh), 2, 0, w - bw)

