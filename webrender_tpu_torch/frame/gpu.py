"""Device-facing frame data: the flat GPU buffer, instance records, and the
transform palette.

This is the TPU-native re-design of WebRender's GPU data model
(`res/brush.glsl:5-50`: instance ivec4 → PrimitiveHeaders → GpuCache texels →
transform palette): everything a raster kernel needs is laid out in

  * ``f32_buf``    — one flat float32 array (the GpuCache analog,
                     `gpu_cache.rs`), gathered by address inside kernels;
  * ``instances``  — ``[N, 8] int32`` instance records (gpu_types.rs
                     instance layouts);
  * ``transforms`` — ``[T, 12] float32`` palette: screen→local inverse
                     homography + AA scale + backface flag
                     (`gpu_types.rs` TransformPalette, VECS_PER_TRANSFORM=8).

Layouts (addresses in f32_buf, per instance ``prim_addr``):
  common   [0:4] local rect (x0,y0,x1,y1)  [4:8] local coverage/clip rect
  SOLID    [8:12] premultiplied RGBA
  IMAGE    [8:12] atlas uv rect  [12:16] premult color modulation
           [16] sampling (0=bilinear,1=nearest)  [17] atlas id (0 color,1 alpha)
           [18:20] stretch size  [20:22] tile spacing  [22:24] pad
  LINEAR   [8:12] p0,p1  [12] lut_addr  [13] extend  [14:16] pad
  RADIAL   [8:10] center [10:12] radius  [12] lut_addr [13] extend
           [14] start_offset [15] end_offset
  CONIC    [8:10] center [10] angle [11] pad [12] lut_addr [13] extend
           [14] start_offset [15] end_offset
  GLYPH    [8:12] atlas uv rect  [12:16] premult text color
  PICTURE  [8:12] atlas uv rect  [12:16] premult color mod (opacity)
           [16:36] color matrix (4x5, row major; identity when unused)
           [36] has_color_matrix
  BOX_SHADOW [8:12] shadow box rect [12:20] radii  [20] sigma
           [20:?]: [20] sigma [21] clip_mode(0 outset,1 inset) [22:26] clip
           box rect (the unshadowed box to exclude/include) [26:34] clip radii
           [34:38] premult color

Clip records, CLIP_STRIDE floats each at instance ``clip_addr``:
  [0:4] rect  [4:12] radii (tl.x,tl.y,tr,br,bl)  [12] mode (0 in / 1 out)
  [13] spatial node  [14] kind (0 rect, 1 rounded, 2 image mask,
  3 device polygon, 4 box-shadow nine-patch)
  [16:20] mask uv rect  [20:24] pad
  kind 4 (cs_clip_box_shadow): [0:4] dest rect, [4:6] original alloc size
  (local units), [6:8] stretch modes (1 Stretch / 0 Simple), [15] clip
  mode (0 outset / 1 inset), [16:20] cached blurred-mask uv rect
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# Instance kinds (device-side enum)
KIND_SOLID = 0
KIND_IMAGE = 1
KIND_LINEAR_GRAD = 2
KIND_RADIAL_GRAD = 3
KIND_CONIC_GRAD = 4
KIND_GLYPH = 5
KIND_PICTURE = 6
KIND_CLEAR = 7
KIND_BOX_SHADOW = 8
KIND_BORDER = 9
KIND_SUBPX_GLYPH = 10   # subpixel-AA glyph: rgb per-channel masks
KIND_LINE_DEC = 11      # dotted/dashed/wavy line decorations
KIND_YUV = 12           # 3-plane YCbCr sampled + converted in-kernel

N_KINDS = 13

# instance record fields
INST_KIND = 0
INST_SPATIAL = 1
INST_PRIM_ADDR = 2
INST_CLIP_ADDR = 3
INST_CLIP_COUNT = 4
INST_BLEND = 5          # blend op (mix-blend modes for PICTURE composites)
INST_EDGE_AA = 6        # bit 0..3: left/top/right/bottom edge AA enabled
INST_FLAGS = 7
INST_FIELDS = 8

CLIP_STRIDE = 128  # one 128-float row per record (TPU lane-aligned reads)

# blend ops (MixBlendMode values are offset by BLEND_MIX_BASE)
BLEND_NORMAL = 0
BLEND_CLEAR = 1
BLEND_PD_IN = 2          # SVGFE feComposite Porter-Duff ops (ops/blend.py)
BLEND_PD_OUT = 3
BLEND_PD_ATOP = 4
BLEND_PD_XOR = 5
BLEND_PD_LIGHTER = 6
BLEND_CH_CLEAR = 7       # dst·(1−src) per channel (subpixel text punch)
BLEND_ADD = 8            # dst + src, clamped (subpixel text add)
BLEND_MIX_BASE = 16
BLEND_SVGFE_MIX_BASE = 40      # BLEND_MIX_BASE + MixBlendMode.value
BLEND_LINEAR_BASE = 64   # +64 = blend in linearRGB (SVGFE _CONVERTSRGB)

GRAD_LUT_SIZE = 256      # gradient LUT entries (gpu_cache.rs stores 128; we
                         # use 256 texels for tighter hard-stop fidelity)

MAX_CLIPS_PER_PRIM = 8


class GpuBufferBuilder:
    """Accumulates f32 data + instance records for one frame
    (render target agnostic; shared by all passes of the frame)."""

    def __init__(self):
        self._f32: List[np.ndarray] = []
        self._f32_len = 0
        # instance chunks: plain lists (scalar pushes) interleaved with
        # numpy blocks (batch pushes); concatenated once at finish()
        self._inst_chunks: List = []
        self._inst_tail: List[List[int]] = []
        self._inst_len = 0

    # --- f32 buffer --------------------------------------------------------
    ALIGN = 128  # lane-aligned addresses let Pallas read payload rows

    def push_f32(self, values) -> int:
        arr = np.asarray(values, dtype=np.float32).reshape(-1)
        pad = (-arr.size) % self.ALIGN
        if pad:
            arr = np.concatenate([arr, np.zeros(pad, np.float32)])
        addr = self._f32_len
        self._f32.append(arr)
        self._f32_len += arr.size
        return addr

    def push_f32_block(self, rows: np.ndarray) -> np.ndarray:
        """Batch push: rows [N, K] (K padded to ALIGN) → per-row addresses
        [N] (the vectorized prepare paths write whole payload blocks)."""
        n, k = rows.shape
        pad = (-k) % self.ALIGN
        if pad:
            rows = np.concatenate(
                [rows, np.zeros((n, pad), np.float32)], axis=1)
            k += pad
        addr = self._f32_len
        self._f32.append(np.ascontiguousarray(rows, np.float32).reshape(-1))
        self._f32_len += n * k
        return addr + np.arange(n, dtype=np.int64) * k

    # --- instances ---------------------------------------------------------
    def push_instance(self, kind: int, spatial: int, prim_addr: int,
                      clip_addr: int = 0, clip_count: int = 0,
                      blend: int = BLEND_NORMAL, edge_aa: int = 0xF,
                      flags: int = 0) -> int:
        idx = self._inst_len
        self._inst_tail.append([kind, spatial, prim_addr, clip_addr,
                                clip_count, blend, edge_aa, flags])
        self._inst_len += 1
        return idx

    def push_instance_block(self, rows: np.ndarray) -> np.ndarray:
        """Batch push of [N, INST_FIELDS] int records → instance ids [N]."""
        if self._inst_tail:
            self._inst_chunks.append(
                np.asarray(self._inst_tail, np.int32))
            self._inst_tail = []
        base = self._inst_len
        self._inst_chunks.append(rows.astype(np.int32))
        self._inst_len += rows.shape[0]
        return base + np.arange(rows.shape[0], dtype=np.int64)

    @property
    def num_instances(self) -> int:
        return self._inst_len

    def snapshot_instances(self) -> np.ndarray:
        """Current instance table [n, INST_FIELDS] (consolidates chunks;
        used by the slice assigner before finish())."""
        if self._inst_tail:
            self._inst_chunks.append(np.asarray(self._inst_tail, np.int32))
            self._inst_tail = []
        if not self._inst_chunks:
            return np.zeros((0, INST_FIELDS), np.int32)
        if len(self._inst_chunks) > 1:
            self._inst_chunks = [np.concatenate(self._inst_chunks, axis=0)]
        return self._inst_chunks[0]

    # --- finalize ----------------------------------------------------------
    def finish(self) -> Tuple[np.ndarray, np.ndarray]:
        # single-allocation assembly: chunks write straight into the
        # pow2-bucketed output (three full-buffer copies — concat, tail
        # pad, pow2 pad — were ~25% of warm frame-build time at 2 MB)
        total = sum(int(c.shape[0]) for c in self._f32)
        n = max(128, total + 64)  # +64 tail: payload reads never run off
        size = 1 << (n - 1).bit_length()
        f32 = np.zeros(size, np.float32)
        off = 0
        for c in self._f32:
            f32[off:off + c.shape[0]] = c
            off += c.shape[0]
        # NaN/inf payloads (NaN-laced display lists are a reference crash
        # suite: gradient/linear-nan.yaml) must never reach the kernels:
        # NaN propagation differs between numpy, XLA and Mosaic, so any
        # NaN in the GPU buffer breaks the device==oracle contract.  One
        # sanitize at the single choke point all backends read from.
        if not np.isfinite(f32[:off]).all():
            np.nan_to_num(f32, copy=False, nan=0.0, posinf=3.4e38,
                          neginf=-3.4e38)
        if self._inst_tail:
            self._inst_chunks.append(np.asarray(self._inst_tail, np.int32))
            self._inst_tail = []
        ni = sum(int(c.shape[0]) for c in self._inst_chunks)
        rows = 1 << (max(8, max(ni, 1)) - 1).bit_length()
        inst = np.zeros((rows, INST_FIELDS), np.int32)
        off = 0
        for c in self._inst_chunks:
            inst[off:off + c.shape[0]] = c
            off += c.shape[0]
        return f32, inst


def pad_pow2(a: np.ndarray, min_size: int = 64) -> np.ndarray:
    n = max(min_size, int(a.shape[0]))
    size = 1 << (n - 1).bit_length()
    if a.shape[0] == size:
        return a
    out = np.zeros((size,) + a.shape[1:], a.dtype)
    out[: a.shape[0]] = a
    return out


def pad_pow2_rows(a: np.ndarray, min_rows: int = 8) -> np.ndarray:
    n = max(min_rows, int(a.shape[0]))
    rows = 1 << (n - 1).bit_length()
    if a.shape[0] == rows:
        return a
    out = np.zeros((rows,) + a.shape[1:], a.dtype)
    out[: a.shape[0]] = a
    return out


def _snap_gradient_offset(offset: float) -> float:
    """The reference evaluates every gradient through a 128-entry LUT
    (prim_store/gradient/mod.rs GradientGpuBlockBuilder::get_index:
    round(clamp(o,0,1)·128 + 1) picks the entry a stop lands on, and
    fill_colors ramps linearly between entry boundaries).  The LUT is
    therefore EXACTLY the piecewise-linear interpolation of the stops
    with offsets snapped to idx/128 — stops quantize to the table's
    resolution (the color-wheel ramps stretch ~1.6% vs unsnapped stops).
    Evaluating the original lerp on snapped offsets reproduces the LUT
    without a per-pixel 130-entry gather."""
    o = min(max(offset, 0.0), 1.0)
    idx = np.float32(np.floor(np.float32(o) * np.float32(128.0)
                              + np.float32(1.5)))  # round half-up like Rust
    return float((idx - np.float32(1.0)) * np.float32(1.0 / 128.0))


def gradient_stops_records(stops) -> np.ndarray:
    """Serialize normalized gradient stops as 8-float records
    [offset, r·a, g·a, b·a, a, 0, 0, 0] — PREMULTIPLIED, because the
    reference interpolates gradients in premultiplied space
    (prim_store/gradient/mod.rs GradientGpuBlockBuilder uses
    PremultipliedColorF; gradient/premultiplied-*.yaml).  Offsets snap to
    the 128-entry LUT grid (see _snap_gradient_offset)."""
    n = len(stops)
    out = np.zeros((max(n, 2), 8), np.float32)
    for i, s in enumerate(stops):
        out[i, 0] = _snap_gradient_offset(s.offset)
        a = s.color.a
        out[i, 1:5] = [s.color.r * a, s.color.g * a, s.color.b * a, a]
    if n == 0:
        out[1, 0] = 1.0
    elif n == 1:
        out[1] = out[0]
        out[1, 0] = 1.0
    # enforce non-decreasing offsets (gradient_builder.rs guarantees this
    # post-normalization; guard anyway)
    for i in range(1, out.shape[0]):
        out[i, 0] = max(out[i, 0], out[i - 1, 0])
    return out


def build_gradient_lut(stops, extend_mode) -> np.ndarray:
    """Evaluate gradient stops into a GRAD_LUT_SIZE premultiplied-RGBA LUT.

    Matches the reference's cached gradient semantics
    (`prim_store/gradient/mod.rs` GradientCacheKey → gradient task): linear
    interpolation in non-premultiplied space between stops, then
    premultiplied for blending.
    """
    lut = np.zeros((GRAD_LUT_SIZE, 4), np.float32)
    if not stops:
        return lut
    offs = np.array([max(0.0, min(1.0, s.offset)) for s in stops], np.float32)
    cols = np.array([[s.color.r, s.color.g, s.color.b, s.color.a]
                     for s in stops], np.float32)
    # normalize: ensure increasing offsets (gradient_builder.rs semantics)
    for i in range(1, len(offs)):
        offs[i] = max(offs[i], offs[i - 1])
    t = (np.arange(GRAD_LUT_SIZE, dtype=np.float32) + 0.5) / GRAD_LUT_SIZE
    out = np.zeros((GRAD_LUT_SIZE, 4), np.float32)
    out[:] = cols[0]
    for i in range(len(offs) - 1):
        o0, o1 = offs[i], offs[i + 1]
        c0, c1 = cols[i], cols[i + 1]
        if o1 > o0:
            w = np.clip((t - o0) / (o1 - o0), 0.0, 1.0)[:, None]
            seg = c0 * (1 - w) + c1 * w
            mask = ((t >= o0) & (t < o1))[:, None]
            out = np.where(mask, seg, out)
        else:
            # hard stop exactly at o0
            pass
    out = np.where((t >= offs[-1])[:, None], cols[-1], out)
    out = np.where((t < offs[0])[:, None], cols[0], out)
    # premultiply
    lut[:, :3] = out[:, :3] * out[:, 3:4]
    lut[:, 3] = out[:, 3]
    return lut


def identity_color_matrix() -> np.ndarray:
    m = np.zeros((4, 5), np.float32)
    m[0, 0] = m[1, 1] = m[2, 2] = m[3, 3] = 1.0
    return m
