"""The tile-raster kernel: wrapper, launch counts and the plain version.

Replaces `webrender_tpu/ops/pallas/tile_raster.py::render_tiles_pallas_dense`
(its `pl.pallas_call` at :1175) for the branches that the 4K browsing,
effects, content and zoomed frames reach:

* the body: accumulator from `clear`, or from `init_tiles` (the tiles'
  current pixels, for continuation passes), inverse map, edge-AA rect
  coverage, swgl integer compose for blend ops 0 (normal), 1 (clear), 7
  (channel clear), 8 (add) and the mix-blend modes 16-32
  (`_blend_case_int`), and `compose_swgl`'s float domain for the SVG
  filter ops: the Porter-Duff composites 2-6, the SVGFE mixes 40-56 and
  every op from 64 (the same in linearRGB; `dense.FLOAT_BLENDS`);
* `KIND_SOLID`; `grad_branch` (:981) for linear, radial and conic
  gradients (stops from the f32 buffer); `_pattern_math` (:365) for
  `KIND_CLEAR`, `KIND_BOX_SHADOW` and `KIND_LINE_DEC`;
* the translation fast path of `sampled_branch` (:865) for `KIND_GLYPH`
  (alpha atlas), `KIND_PICTURE` (surface atlas, then the color matrix)
  and `KIND_SUBPX_GLYPH` (color atlas);
* `sep_branch` (:1000) for `K_SEP_IMAGE` (axis-aligned scaled images,
  swgl 7-bit bilinear, stretch and spacing repeat, nearest),
  `K_SEP_PICTURE` (the surface region by device position or in the
  raster-root local mode, then the color matrix), `K_SEP_GLYPH` and
  `K_SEP_SUBPX` (scaled text: the glyph's uv rect over its local rect,
  from the alpha or the color atlas) and `K_SEP_YUV` (three planes of
  the alpha atlas, then the color-space matrix);
* the pictures' color matrix for flags 0 (none), 1 (sRGB) and 2
  (linearRGB);
* the GL flavour (`gl`, the static `gl` of the TPU kernel, :570-578): for a
  frame built with `gl_flavor`, blend ops 0, 1, 7 and 8 compose as
  `blend.compose_gl` (`compose_swgl` with `GL_FLAVOR_FLAG`, :1116-1127;
  every other op as without it), the clip-mask chain is
  `blend.gl_mask_combine` (:854-855) and the image-mask and nine-patch
  clips sample in `_sep_sample`'s llvm mode (:653-673, :728-734;
  `patterns.sample_alpha_llvm`), in both clip chains;
* the clip chain for rect and rounded-rect clips, the polygon
  (`patterns.polygon_coverage`: the device-space convex fragment of a
  preserve-3d plane) and, with `mask_clips`, the image-mask and box-shadow
  nine-patch clips (`_mask_cov`, `_bs_cov`, :787-829); without
  `mask_clips` those two kinds are read as polygons (:844-847);
* the general tiles (`ops/dense.py`: the tiles that the JAX renderer
  draws on its XLA engine, `ops/raster.py::render_tiles`): every record
  of such a tile carries REC_GENERAL, its sampled records the general
  kinds, which sample per pixel in two dimensions with no window
  (`patterns.pattern_image`, `pattern_glyph`, `pattern_subpx_glyph`,
  `pattern_picture`, `pattern_yuv`); its clip chain is
  `patterns.clip_coverage` (the mask sampled per pixel, mask clips always
  on); its gradients read their stops at the payload's own address, any
  number of them; and `step` scales the pixel grid of a pass
  (`px = origin.x + (col + 0.5) * step`; every tile of such a pass is
  general).

`render_tiles_dense` launches `csrc/tile_raster.cu` on CUDA tensors and
runs `render_tiles_dense_plain` on CPU tensors; it raises on any other
device and for anything outside the ported set.  The kernel skips a
record for a warp's run of 32 pixels that the record cannot cover;
`run_may_draw` is that test's plain twin, in the kernel's float32
operations (`tests/test_torch_cull.py` holds it against the coverage).
The kernel is built in seven instantiations (`instantiation`): browsing,
surface (with `KIND_GLYPH`, `KIND_PICTURE` and `K_SEP_PICTURE`), content
(with the content kinds, mask clips and mix-blend modes), media (scaled
text, video and clear rects too), general (general tiles, raster steps and
polygon clips too), filter (any ported dispatch: the float-domain blend ops and
color-matrix flag 2 too) and gl (the filter build in the GL flavour: every
dispatch of a frame with `gl_flavor`).  The plain version
loops over slots, is vectorised
over tiles, and computes the Pallas body through the shared pattern and
blend math (`ops/xp.py`), in numpy's order of operations.  Texture taps
are direct loads of the atlas texels the TPU kernel gathers from its DMA
windows; a tap outside the atlas reads 0.
"""
from __future__ import annotations

import ctypes

import torch

from ..frame.gpu import (KIND_BOX_SHADOW, KIND_CLEAR, KIND_CONIC_GRAD,
                         KIND_GLYPH, KIND_LINE_DEC, KIND_LINEAR_GRAD,
                         KIND_PICTURE, KIND_RADIAL_GRAD, KIND_SOLID,
                         KIND_SUBPX_GLYPH)
from ..frame.tiles import TILE_H, TILE_W
from . import blend as blend_mod
from . import patterns as pk
from .blend import BLEND_CLEAR, BLEND_MIX_BASE, GL_FLAVOR_FLAG

from . import xp
from .dense import (FLOAT_BLENDS, GENERAL_KINDS, K_GEN_GLYPH, K_GEN_IMAGE,
                    K_GEN_PICTURE, K_GEN_SUBPX, K_GEN_YUV, K_SEP_GLYPH,
                    K_SEP_IMAGE, K_SEP_PICTURE, K_SEP_SUBPX, K_SEP_YUV,
                    PORTED_BLENDS, PORTED_KINDS, REC_BLEND, REC_CLIP_COUNT,
                    REC_CLIP_ROW, REC_EDGE, REC_GENERAL, REC_KIND, REC_TROW,
                    check_clip_kinds, check_color_matrix_flags,
                    check_general_flags)

# the kernel's instantiations: their template flags (kSurfaceKinds,
# kContent, kMedia, kGeneral, kFilter, kGl)
INSTANTIATIONS = {"browsing": (0, 0, 0, 0, 0, 0),
                  "surface": (1, 0, 0, 0, 0, 0),
                  "content": (1, 1, 0, 0, 0, 0),
                  "media": (1, 1, 1, 0, 0, 0),
                  "general": (1, 1, 1, 1, 0, 0),
                  "filter": (1, 1, 1, 1, 1, 0),
                  "gl": (1, 1, 1, 1, 1, 1)}


# the bit of the slot count that tells the general and filter builds that a
# dispatch was made without mask_clips (kNoMaskClips in the .cu)
NO_MASK_CLIPS = 1 << 30


class LaunchCounts:
    """`launches`: CUDA kernel launches, and `by_instantiation` the same by
    the kernel's instantiation; `plain_calls`: plain-version runs through
    the wrapper (CPU tensors)."""
    launches = 0
    by_instantiation = dict.fromkeys(INSTANTIATIONS, 0)
    plain_calls = 0

    @classmethod
    def reset(cls):
        cls.launches = 0
        cls.by_instantiation = dict.fromkeys(cls.by_instantiation, 0)
        cls.plain_calls = 0


def _check_supported(kinds, blends):
    for k in kinds:
        if k not in PORTED_KINDS:
            raise NotImplementedError(f"dense kind {k} is not ported")
    for b in blends:
        if b not in PORTED_BLENDS:
            raise NotImplementedError(f"blend op {b} is not ported")


def render_tiles_dense(dense, tile_counts, tile_origins, clear_color,
                       f32_rows, alpha_atlas, surface_atlas, color_atlas,
                       init_tiles=None, *, kinds, blends,
                       mask_clips: bool = False, general: bool = False,
                       step: float = 1.0, linear_cm: bool = False,
                       polygon_clips: bool = False, gl: bool = False,
                       host_checked: bool = False):
    """Dense-record raster → [nt, 4, TILE_H, TILE_W] f32 premultiplied
    tiles on the u8 grid; the signature of `render_tiles_pallas_dense`.
    With `init_tiles` ([nt, 4, TILE_H, TILE_W]) each tile starts from
    those pixels and `clear_color` is not read.  `mask_clips`, as in the
    TPU kernel, turns on the image-mask and box-shadow clips (kinds 2 and
    4; without it a record of a tile that is not general reads them as
    polygons, as the TPU kernel does; a general tile's always reads them
    as such).  `general` says that some record carries
    REC_GENERAL (a general tile, `ops/dense.py`); `step` is the device
    pixels between two pixels of the tiles (`render_tiles(step=)`,
    ops/raster.py:135; every tile of a pass with another step than 1 must
    be general); `linear_cm` says that some picture record asks for its
    color matrix in linearRGB (flag 2); `polygon_clips` that some record
    holds a clip read as a polygon (kind 3, or kinds 2 and 4 without
    `mask_clips`); `gl` asks for the GL flavour (the frame's
    `gl_flavor`).  The records' clip kinds and color-matrix flags are
    checked here, which waits for the device, unless `host_checked` says
    the caller checked them on the frame's host arrays
    (`dense.check_pass_records`)."""
    _check_supported(kinds, blends)
    if not host_checked:
        check_clip_kinds(dense, tile_counts, f32_rows, mask_clips,
                         polygon_clips)
        check_color_matrix_flags(dense, tile_counts, linear_cm)
        check_general_flags(dense, tile_counts, general, step)
    if dense.device.type == "cpu":
        LaunchCounts.plain_calls += 1
        return render_tiles_dense_plain(
            dense, tile_counts, tile_origins, clear_color, f32_rows,
            alpha_atlas, surface_atlas, color_atlas, init_tiles,
            kinds=kinds, blends=blends, mask_clips=mask_clips, step=step,
            gl=gl)
    if dense.device.type != "cuda":
        raise ValueError(f"no tile-raster kernel for {dense.device}")
    return _launch(dense, tile_counts, tile_origins, clear_color, f32_rows,
                   alpha_atlas, surface_atlas, color_atlas, init_tiles,
                   kinds=kinds, blends=blends, mask_clips=mask_clips,
                   general=general, step=step, linear_cm=linear_cm,
                   polygon_clips=polygon_clips, gl=gl)


# the kinds that need the kernel's instantiation with the alpha and
# surface atlases' samplers and the color matrix
SURFACE_KINDS = (KIND_GLYPH, KIND_PICTURE, K_SEP_PICTURE)
# the kinds that need its content instantiation, which also holds the
# image-mask and box-shadow clips and the mix-blend modes
CONTENT_KINDS = (KIND_RADIAL_GRAD, KIND_CONIC_GRAD, KIND_BOX_SHADOW,
                 KIND_LINE_DEC)
# the kinds that need its media instantiation (scaled text, video and
# clear rects, with BLEND_CLEAR)
MEDIA_KINDS = (KIND_CLEAR, K_SEP_GLYPH, K_SEP_SUBPX, K_SEP_YUV)
GRADIENT_KINDS = (KIND_LINEAR_GRAD, KIND_RADIAL_GRAD, KIND_CONIC_GRAD)


def instantiation(kinds, blends, mask_clips, general=False,
                  step=1.0, linear_cm=False, polygon_clips=False,
                  gl=False) -> str:
    """The kernel instantiation that serves a dispatch, as the TPU kernel
    compiles its static kind and blend LUTs into each build: "gl", the
    filter build in the GL flavour, for any dispatch with `gl`, else
    "filter", which holds every ported branch, for a dispatch with a
    float-domain blend op (`dense.FLOAT_BLENDS`) or a linearRGB color
    matrix (`linear_cm`), else "general" for a general tile (or a general
    kind), a raster step other than 1 or a polygon clip (`polygon_clips`),
    else "media" for any media kind or the clear blend, else "content" for
    any content kind, mix-blend op or mask clip, else "surface" for any
    surface kind, else "browsing"."""
    if gl:
        return "gl"
    if linear_cm or any(b in FLOAT_BLENDS for b in blends):
        return "filter"
    if general or step != 1.0 or polygon_clips or \
            any(k in GENERAL_KINDS for k in kinds):
        return "general"
    if BLEND_CLEAR in blends or any(k in MEDIA_KINDS for k in kinds):
        return "media"
    if mask_clips or any(k in CONTENT_KINDS for k in kinds) or \
            any(b >= BLEND_MIX_BASE for b in blends):
        return "content"
    return "surface" if any(k in SURFACE_KINDS for k in kinds) \
        else "browsing"


def _launch(dense, tile_counts, tile_origins, clear_color, f32_rows,
            alpha_atlas, surface_atlas, color_atlas, init_tiles=None, *,
            kinds, blends, mask_clips, general=False, step=1.0,
            linear_cm=False, polygon_clips=False, gl=False):
    """The kernel launch alone; the dispatch's dense kinds, blends,
    mask-clip, general, linearRGB color-matrix, polygon and gl flags and
    its step pick its instantiation (`instantiation`).  The general, filter
    and gl builds, which hold the polygon, read `mask_clips` from the slot
    count (`NO_MASK_CLIPS`); the older builds always read mask clips as
    such."""
    from ._build import error_string, load
    nt, slots, _ = dense.shape
    dev = dense.device
    checks = [(dense, torch.float32, (nt, slots, 128)),
              (tile_counts, torch.int32, (nt,)),
              (tile_origins, torch.float32, (nt, 2)),
              (clear_color, torch.float32, (4,)),
              (f32_rows, torch.float32, (f32_rows.shape[0], 128)),
              (alpha_atlas, torch.float32, tuple(alpha_atlas.shape[-2:])),
              (surface_atlas, torch.float32,
               (4,) + tuple(surface_atlas.shape[1:])),
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
    # the kernel copies records and clip rows in 16-byte pieces
    for name, t in (("dense", dense), ("f32_rows", f32_rows)):
        if t.data_ptr() % 16:
            raise ValueError(f"tile raster wants {name} 16-byte aligned")
    out = torch.empty((nt, 4, TILE_H, TILE_W), dtype=torch.float32,
                      device=dev)
    if nt == 0:
        return out
    variant = instantiation(kinds, blends, mask_clips, general, step,
                            linear_cm, polygon_clips, gl)
    flags = INSTANTIATIONS[variant]
    slot_word = slots
    if flags[3] and not mask_clips:
        slot_word |= NO_MASK_CLIPS
    lib = load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.wr_tile_raster(
        dense.data_ptr(), tile_counts.data_ptr(), tile_origins.data_ptr(),
        clear_color.data_ptr(),
        None if init_tiles is None else init_tiles.data_ptr(),
        f32_rows.data_ptr(),
        ctypes.c_longlong(f32_rows.numel()), alpha_atlas.data_ptr(),
        alpha_atlas.shape[0], alpha_atlas.shape[1], surface_atlas.data_ptr(),
        surface_atlas.shape[1], surface_atlas.shape[2], color_atlas.data_ptr(),
        color_atlas.shape[1], color_atlas.shape[2], out.data_ptr(), nt,
        slot_word, *flags, ctypes.c_float(step), stream)
    if rc != 0:
        raise RuntimeError(f"tile raster launch failed: {error_string(rc)}")
    LaunchCounts.launches += 1
    LaunchCounts.by_instantiation[variant] += 1
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


# the TPU kernel's sampling window of the translation fast path
SAMP_H = TILE_H + 8
SAMP_W = TILE_W + 128


def _window_taps(x0f, y0f, H, W):
    """tap(di, dj) -> (y, x, valid): where the translation fast path reads
    the tap (row + di, col + dj) of a tile whose first texel is (y0f, x0f),
    as the TPU kernel reads it from its DMA window (tile_raster.py:933-960).
    The window starts at the (128, 8)-aligned (x0c, y0c), clamped inside
    the atlas; columns wrap around its SAMP_W lanes, rows shift by at most
    7, and rows above the atlas read zero.  Inside the atlas these are the
    texels themselves; a tile whose window the clamp moves reads what the
    TPU kernel reads.  Scratch rows the DMA leaves unwritten (an instance
    more than 7 rows above the atlas) read zero here."""
    dev = x0f.device
    lim = float(1 << 30)
    x0i = x0f.clamp(-lim, lim).long()
    y0i = y0f.clamp(-lim, lim).long()
    x0c = torch.div(x0i.clamp(0, W - SAMP_W), 128, rounding_mode="floor") * 128
    y0c = torch.div(y0i.clamp(0, H - SAMP_H), 8, rounding_mode="floor") * 8
    dsty = torch.div((y0c - y0i).clamp(0, 72), 8, rounding_mode="floor") * 8
    shift = (y0i - y0c + dsty).clamp(-8, 7)
    rows = torch.arange(TILE_H, device=dev)[None, :, None]
    cols = torch.arange(TILE_W, device=dev)[None, None, :]

    def tap(di, dj):
        r = shift + rows + di
        y = y0c - dsty + r
        x = x0c + torch.remainder(cols + dj + x0i - x0c, SAMP_W)
        return y, x, r >= dsty
    return tap


def _sampled_translation(kind, p, trow, ox, oy, atlases):
    """Translation fast path of `sampled_branch` (tile_raster.py:865): the
    7-bit fraction is constant over the tile.  KIND_GLYPH samples the
    alpha atlas, KIND_PICTURE the surface atlas (then its color matrix),
    KIND_SUBPX_GLYPH the color atlas."""
    fx = ox + trow[6] + (p[8] - p[0])
    fy = oy + trow[7] + (p[9] - p[1])
    qx = xp.floor(fx * 128.0 + 0.5)
    qy = xp.floor(fy * 128.0 + 0.5)
    x0f = xp.floor(qx * (1.0 / 128.0))
    y0f = xp.floor(qy * (1.0 / 128.0))
    frx = qx - x0f * 128.0
    fry = qy - y0f * 128.0
    alpha_atlas, surface_atlas, color_atlas = atlases
    if kind == KIND_GLYPH:
        planes = _alpha_planes(alpha_atlas)
    elif kind == KIND_PICTURE:
        planes = surface_atlas
    else:
        planes = color_atlas[:3]
    _, H, W = planes.shape
    window = _window_taps(x0f, y0f, H, W)
    taps = [window(di, dj) for di, dj in ((0, 0), (0, 1), (1, 0), (1, 1))]
    texel = []
    for plane in planes:
        flat = plane.reshape(-1)
        t00, t10, t01, t11 = [
            _u8(torch.where(ok, _gather_taps(flat, H, W, y, x), 0.0))
            for y, x, ok in taps]
        texel.append(_fixed_bilinear(t00, t10, t01, t11, frx, fry))
    if kind == KIND_GLYPH:
        a = texel[0]
        return xp.stack([p[12] * a, p[13] * a, p[14] * a, p[15] * a], 0)
    if kind == KIND_SUBPX_GLYPH:
        m_avg = (texel[0] + texel[1] + texel[2]) * (1.0 / 3.0)
        return xp.stack([texel[0] * p[12], texel[1] * p[13],
                         texel[2] * p[14], m_avg * p[15]], 0)
    texel = xp.stack([texel[0] * p[12], texel[1] * p[13], texel[2] * p[14],
                      texel[3] * p[15]], 0)
    return pk.apply_color_matrix(xp, texel, p[16:36], p[36])


def _sep_sample(u1d, v1d, u0, v0, u1, v1, nearest, atlas, llvm=False):
    """`_sep_sample` (tile_raster.py:640) in its default swgl mode: the
    four taps at the texel indices the one-hot contractions select, for
    each plane of `atlas` ([planes, H, W]).  `llvm`: its llvm mode, the
    gl_flavor mask path (`_llvm_sample`)."""
    lo_u = u0 + 0.5
    hi_u = xp.maximum(u1 - 0.5, lo_u)
    lo_v = v0 + 0.5
    hi_v = xp.maximum(v1 - 0.5, lo_v)
    u = xp.clip(u1d, lo_u, hi_u)
    v = xp.clip(v1d, lo_v, hi_v)
    u = xp.where(nearest > 0.5, xp.floor(u) + 0.5, u)
    v = xp.where(nearest > 0.5, xp.floor(v) + 0.5, v)
    _, H, W = atlas.shape
    if llvm:
        return _llvm_sample(u, v, atlas)
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
    for c in range(atlas.shape[0]):
        flat = atlas[c].reshape(-1)
        t00 = _u8(flat[y0 * W + x0])
        t10 = _u8(flat[y0 * W + x1])
        t01 = _u8(flat[y1 * W + x0])
        t11 = _u8(flat[y1 * W + x1])
        out.append(_fixed_bilinear(t00, t10, t01, t11, fx, fy))
    return out


def _llvm_sample(u, v, atlas):
    """`_sep_sample`'s llvm mode (tile_raster.py:653-673, :728-734;
    `patterns.sample_alpha_llvm`) at clamped (u, v): round8's addressing
    (the first texel at floor(u - 0.5), clamped to [0, W-2] x [0, H-2]),
    8-bit rounded fractions and llvmpipe's per-axis rounded integer lerp,
    x then y, for each plane of `atlas`."""
    _, H, W = atlas.shape
    ixf = xp.clip(xp.floor(u - 0.5), 0.0, max(W - 2, 0))
    iyf = xp.clip(xp.floor(v - 0.5), 0.0, max(H - 2, 0))
    fx = xp.floor((u - 0.5 - ixf) * 256.0 + 0.5)
    fy = xp.floor((v - 0.5 - iyf) * 256.0 + 0.5)
    x0 = ixf.long()
    y0 = iyf.long()
    y1 = y0 + (iyf < H - 1).long()
    x1 = (x0 + 1).clamp(max=W - 1)
    out = []
    for c in range(atlas.shape[0]):
        flat = atlas[c].reshape(-1)
        t00 = _u8(flat[y0 * W + x0])
        t10 = _u8(flat[y0 * W + x1])
        t01 = _u8(flat[y1 * W + x0])
        t11 = _u8(flat[y1 * W + x1])
        a = xp.floor((t00 * (256.0 - fx) + t10 * fx + 128.0) * (1.0 / 256.0))
        b = xp.floor((t01 * (256.0 - fx) + t11 * fx + 128.0) * (1.0 / 256.0))
        o = xp.floor((a * (256.0 - fy) + b * fy + 128.0) * (1.0 / 256.0))
        out.append(o * (1.0 / 255.0))
    return out


def _axes(x, y, per_pixel):
    """Where a sampled branch takes its coordinates: the tile's first row
    of `x` and first column of `y` (the TPU kernel's separable branches),
    or, for a general tile, every pixel's own."""
    return (x, y) if per_pixel else (x[:, 0:1, :], y[:, :, 0:1])


def _tint(texel, p):
    return xp.stack([texel[0] * p[12], texel[1] * p[13], texel[2] * p[14],
                     texel[3] * p[15]], 0)


def _gen_image(p, lx, ly, color_atlas):
    """`patterns.pattern_image` (the general image of a general tile): the
    repeat tiling of every pixel's own local position, no clamp into the
    rect, the two-dimensional sample."""
    tx, ty, in_tile = pk._tile_coords(xp, p, lx, ly,
                                      xp.maximum(p[18], 1e-6),
                                      xp.maximum(p[19], 1e-6), p[20], p[21])
    u = p[8] + tx * p[22] - p[24]
    v = p[9] + ty * p[23] - p[25]
    texel = _sep_sample(u, v, p[8], p[9], p[10], p[11], p[16], color_atlas)
    return _tint(texel, p) * in_tile[None]


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


def _sep_picture(p, px, py, lx, ly, surface_atlas, per_pixel=False):
    """`sep_branch` for K_SEP_PICTURE (tile_raster.py:1077): the surface
    region mapped by device position, or in the raster-root local mode
    (p[37]) by the instance's local position at scale p[40]; then the
    color matrix.  `per_pixel`: `patterns.pattern_picture`."""
    w_ = xp.maximum(p[2] - p[0], 1e-6)
    h_ = xp.maximum(p[3] - p[1], 1e-6)
    su = (p[10] - p[8]) / w_
    sv = (p[11] - p[9]) / h_
    pxa, pya = _axes(px, py, per_pixel)
    lxa, lya = _axes(lx, ly, per_pixel)
    u = p[8] + (pxa - p[0]) * su
    v = p[9] + (pya - p[1]) * sv
    u = xp.where(p[37] > 0.5, p[8] + lxa * p[40] - p[38], u)
    v = xp.where(p[37] > 0.5, p[9] + lya * p[40] - p[39], v)
    texel = _sep_sample(u, v, p[8], p[9], p[10], p[11], 0.0, surface_atlas)
    return pk.apply_color_matrix(xp, _tint(texel, p), p[16:36], p[36])


def _sep_text_uv(p, lx, ly, per_pixel=False):
    """The uv of scaled text (tile_raster.py:1037): the glyph's uv rect
    over its local rect, u from the tile's first row of lx, v from its
    first column of ly (`per_pixel`: from every pixel's own)."""
    su = (p[10] - p[8]) / xp.maximum(p[2] - p[0], 1e-6)
    sv = (p[11] - p[9]) / xp.maximum(p[3] - p[1], 1e-6)
    lxa, lya = _axes(lx, ly, per_pixel)
    u = p[8] + (lxa - p[0]) * su
    v = p[9] + (lya - p[1]) * sv
    return u, v


def _alpha_planes(alpha_atlas):
    """The alpha atlas as one plane, [1, H, W]."""
    return alpha_atlas.reshape((1,) + tuple(alpha_atlas.shape[-2:]))


def _sep_glyph(p, lx, ly, alpha_atlas, per_pixel=False):
    """`sep_branch` for K_SEP_GLYPH (tile_raster.py:1041): scaled
    grayscale text, the alpha atlas's mask times the color.  `per_pixel`:
    `patterns.pattern_glyph`."""
    u, v = _sep_text_uv(p, lx, ly, per_pixel)
    (a,) = _sep_sample(u, v, p[8], p[9], p[10], p[11], 0.0,
                       _alpha_planes(alpha_atlas))
    return xp.stack([p[12] * a, p[13] * a, p[14] * a, p[15] * a], 0)


def _sep_subpx(p, lx, ly, color_atlas, per_pixel=False):
    """`sep_branch` for K_SEP_SUBPX (tile_raster.py:1046): scaled
    subpixel text, the color atlas's three channel masks and their mean
    as alpha.  `per_pixel`: `patterns.pattern_subpx_glyph`."""
    u, v = _sep_text_uv(p, lx, ly, per_pixel)
    m = _sep_sample(u, v, p[8], p[9], p[10], p[11], 0.0, color_atlas[:3])
    m_avg = (m[0] + m[1] + m[2]) * (1.0 / 3.0)
    return xp.stack([m[0] * p[12], m[1] * p[13], m[2] * p[14],
                     m_avg * p[15]], 0)


def _sep_yuv(p, lx, ly, alpha_atlas, per_pixel=False):
    """`sep_branch` for K_SEP_YUV (tile_raster.py:1051; the payload of
    `patterns.pattern_yuv`): the Y, U and V planes of the alpha atlas at
    their own uv rects and scales, always bilinear (the TPU kernel does
    not read the payload's nearest flag, p[26]), less the zero points,
    through the 3x3 matrix (each row summed left to right), clipped;
    alpha 1.  `per_pixel`: `patterns.pattern_yuv`."""
    planes = _alpha_planes(alpha_atlas)
    lxa, lya = _axes(lx, ly, per_pixel)
    oxl = lxa - p[0]
    oyl = lya - p[1]
    (yy,) = _sep_sample(p[8] + oxl * p[22], p[9] + oyl * p[23],
                        p[8], p[9], p[10], p[11], 0.0, planes)
    (uu,) = _sep_sample(p[12] + oxl * p[24], p[13] + oyl * p[25],
                        p[12], p[13], p[14], p[15], 0.0, planes)
    (vv,) = _sep_sample(p[16] + oxl * p[24], p[17] + oyl * p[25],
                        p[16], p[17], p[18], p[19], 0.0, planes)
    sy_ = yy - p[36]
    su_ = uu - p[37]
    sv_ = vv - p[38]
    r_ = p[27] * sy_ + p[28] * su_ + p[29] * sv_
    g_ = p[30] * sy_ + p[31] * su_ + p[32] * sv_
    b_ = p[33] * sy_ + p[34] * su_ + p[35] * sv_
    return xp.clip(xp.stack([r_, g_, b_, xp.ones_like(yy)], 0), 0.0, 1.0)


def _gradient(kind, p, lx, ly, f32_flat, general=False):
    """`grad_branch` + `_eval_stops_row` (tile_raster.py:981, :329) for a
    linear, radial or conic gradient; the stops loop runs to the record's
    stop count.  The stops start at the row of p[12]; in a general tile
    at p[12] itself (`patterns.eval_gradient_stops`)."""
    if kind == KIND_LINEAR_GRAD:
        t, in_tile = pk.gradient_t_linear(xp, p, lx, ly)
    elif kind == KIND_RADIAL_GRAD:
        t, in_tile = pk.gradient_t_radial(xp, p, lx, ly)
    else:
        t, in_tile = pk.gradient_t_conic(xp, p, lx, ly)
    base = p[12].to(torch.int32).long()
    if not general:
        base = base // 128 * 128
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


def _mask_cov(crec, clx, cly, rect_cov, mask_plane, per_pixel=False,
              llvm=False):
    """`_mask_cov` (tile_raster.py:787), the image-mask clip (kind 2): the
    color atlas's red plane at u from the tile's first row of the clip's
    local x and v from its first column of local y; `per_pixel` (a
    general tile): at every pixel's own, `patterns.clip_coverage`.
    `llvm`: sampled in the llvm mode (gl_flavor)."""
    rw = xp.maximum(crec[2] - crec[0], 1e-6)
    rh = xp.maximum(crec[3] - crec[1], 1e-6)
    lxr, lyc = _axes(clx, cly, per_pixel)
    mu = crec[16] + (lxr - crec[0]) / rw * (crec[18] - crec[16])
    mv = crec[17] + (lyc - crec[1]) / rh * (crec[19] - crec[17])
    (m,) = _sep_sample(mu, mv, crec[16], crec[17], crec[18], crec[19], 0.0,
                       mask_plane, llvm)
    return m * rect_cov


def _bs_cov(crec, clx, cly, rect_cov, mask_plane, per_pixel=False,
            llvm=False):
    """`_bs_cov` (tile_raster.py:798), the box-shadow nine-patch clip
    (kind 4): the cached blurred mask, stretched or not per axis, in
    outset (crec[15] 0) or inset (1) mode.  `per_pixel` (a general tile):
    `patterns.box_shadow_ninepatch_coverage`, whose `rect_cov` is the
    plain `rect_coverage` at the clip transform's scales.  `llvm`: sampled
    in the llvm mode (gl_flavor)."""
    dw = xp.maximum(crec[2] - crec[0], 1e-6)
    dh = xp.maximum(crec[3] - crec[1], 1e-6)
    aw = xp.maximum(crec[4], 1e-6)
    ah = xp.maximum(crec[5], 1e-6)
    lxr, lyc = _axes(clx, cly, per_pixel)
    u_lin = xp.where(crec[6] > 0.5, (lxr - crec[0]) / aw,
                     (lxr - crec[0]) / dw)
    v_lin = xp.where(crec[7] > 0.5, (lyc - crec[1]) / ah,
                     (lyc - crec[1]) / dh)
    e0x = xp.where(crec[6] > 0.5, 0.5, 1.0)
    e1x = xp.where(crec[6] > 0.5, dw / aw - 0.5, 1.0)
    e0y = xp.where(crec[7] > 0.5, 0.5, 1.0)
    e1y = xp.where(crec[7] > 0.5, dh / ah - 0.5, 1.0)
    uu = xp.clip(u_lin, 0.0, e0x) + xp.maximum(0.0, u_lin - e1x)
    vv = xp.clip(v_lin, 0.0, e0y) + xp.maximum(0.0, v_lin - e1y)
    mu = crec[16] + uu * (crec[18] - crec[16])
    mv = crec[17] + vv * (crec[19] - crec[17])
    (texel,) = _sep_sample(mu, mv, crec[16], crec[17], crec[18], crec[19],
                           0.0, mask_plane, llvm)
    mode = crec[15]
    alpha = texel * (1.0 - mode) + (1.0 - texel) * mode
    return mode * (1.0 - rect_cov) + alpha * rect_cov


def _clip_chain(rec, px, py, f32_rows, cov, mask_plane=None, general=False,
                gl=False):
    """`clip_body` (tile_raster.py:763) for rect, rounded and polygon clips
    and, given the color atlas's red plane `mask_plane` ([1, H, W], the
    kernel's `mask_clips`), the image-mask and box-shadow clips; without
    it the kernel reads every kind from 2 as a polygon (:844-847).  Rect
    clips join the span coverage, the rest the u8 clip-mask chain.
    `general`: the chain of a general tile, `patterns.clip_coverage`
    (ops/raster.py:151), with the clip's transform row from its record.
    `gl`: the GL flavour's mask chain (`blend.gl_mask_combine`) and mask
    sampling (llvm)."""
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
        if mask_plane is not None:
            is_mask = (crec[14] >= 1.5) & (crec[14] < 2.5)
            if bool(is_mask.any()):
                ccov = xp.where(is_mask, _mask_cov(crec, clx, cly, rect_cov,
                                                   mask_plane, general, gl),
                                ccov)
            is_bs = crec[14] >= 3.5
            if bool(is_bs.any()):
                in_rect = rect_cov if not general else pk.rect_coverage(
                    xp, crec[0], crec[1], crec[2], crec[3], clx, cly, ct[9],
                    ct[10], 0xF)
                ccov = xp.where(is_bs, _bs_cov(crec, clx, cly, in_rect,
                                               mask_plane, general, gl),
                                ccov)
            is_poly = (crec[14] >= 2.5) & (crec[14] < 3.5)
        else:
            is_poly = crec[14] >= 1.5
        if bool(is_poly.any()):
            ccov = xp.where(is_poly, pk.polygon_coverage(xp, crec, px, py),
                            ccov)
        ccov = xp.where(crec[12] > 0.5, 1.0 - ccov, ccov)
        is_geom = (crec[14] < 0.5) & (crec[12] < 0.5)
        c8 = blend_mod.quantize_cov(xp, ccov, 255.0)
        m8n = blend_mod.gl_mask_combine(xp, c8, m8) if gl else \
            xp.floor((c8 * m8 + c8) * (1.0 / 256.0))
        on = j < n
        cov = xp.where(on & is_geom, cov * ccov, cov)
        m8 = xp.where(on & ~is_geom, m8n, m8)
    return cov, m8 * (1.0 / 255.0)


def record_coverage(rec, px, py, f32_rows, mask_plane=None, general=False,
                    gl=False):
    """(lx, ly, cov, mcov) of records `rec` ([128, m, 1, 1]) over their
    tiles' pixels: the local position, the geometric coverage with the rect
    clips joined (the kernel skips a pixel where it is not above zero) and
    the u8 clip-mask coverage (`_clip_chain`; `general`: of a general
    tile; `gl`: in the GL flavour)."""
    p = rec[0:64]
    trow = rec[REC_TROW:REC_TROW + 12]
    lx, ly = pk.inverse_map(xp, trow, px, py)
    edge_aa = rec[REC_EDGE].to(torch.int32)
    cov = pk.rect_coverage_auto(xp, trow, p[4], p[5], p[6], p[7], lx, ly,
                                px, py, edge_aa)
    cov, mcov = _clip_chain(rec, px, py, f32_rows, cov, mask_plane, general,
                            gl)
    return lx, ly, cov, mcov


def tile_pixels(tile_origins, step=1.0):
    """(px, py), [nt, TILE_H, TILE_W] each: the tiles' pixel centres,
    `step` device pixels apart."""
    nt = tile_origins.shape[0]
    dev = tile_origins.device
    col = torch.arange(TILE_W, dtype=torch.float32, device=dev)
    row = torch.arange(TILE_H, dtype=torch.float32, device=dev)
    ox = tile_origins[:, 0][:, None, None]
    oy = tile_origins[:, 1][:, None, None]
    px = (ox + (col[None, None, :] + 0.5) * step).expand(nt, TILE_H, TILE_W)
    py = (oy + (row[None, :, None] + 0.5) * step).expand(nt, TILE_H, TILE_W)
    return px, py


# --- the kernel's culling, its plain twin -----------------------------------

# a warp of the kernel draws a run of RUN_W pixels of one tile row
RUN_W = 32


def pixel_pos(origin, index, step=1.0, general=False):
    """The kernel's pixel centres along one axis, float32: `origin + index
    + 0.5`, or in the builds with general tiles `origin + (index + 0.5) *
    step` (the plain version's `tile_pixels`)."""
    index = index.to(torch.float32)
    if general:
        return origin + (index + 0.5) * step
    return origin + index + 0.5


def run_may_draw(dense, tile_origins, step=1.0, general=False,
                 float_ops=False):
    """[nt, slots, TILE_H, TILE_W // RUN_W] bool: the kernel's
    `run_may_draw` for every record and every run of RUN_W pixels of a
    tile row, in its float32 operations.  False only where no pixel of the
    run can have coverage above zero: with an affine transform row (t[2] =
    t[5] = 0) the local position is monotone along the run, so its extremes
    are those of the run's two end pixels, and an edge's term at or below
    -0.5 (or, under is_tx, the distance past an edge at or above half a
    local pixel, 1/1024 without AA) empties the run.  A projective row, a
    run whose ends are not finite and (with `float_ops`, the builds that
    hold the float-domain blends) a float-domain op always draw.
    `general`: the pixel centres of the builds with general tiles."""
    dev = dense.device
    t = dense[..., REC_TROW:REC_TROW + 12].permute(2, 0, 1)[..., None, None]
    ox = tile_origins[:, 0][:, None, None, None]
    oy = tile_origins[:, 1][:, None, None, None]
    c0 = torch.arange(0, TILE_W, RUN_W, device=dev)[None, None, None, :]
    rows = torch.arange(TILE_H, device=dev)[None, None, :, None]
    pxa = pixel_pos(ox, c0, step, general)
    pxb = pixel_pos(ox, c0 + (RUN_W - 1), step, general)
    py = pixel_pos(oy, rows, step, general)
    lxa, lya = pk.inverse_map(xp, t, pxa, py)
    lxb, lyb = pk.inverse_map(xp, t, pxb, py)
    ends = (pxa <= pxb) & torch.isfinite(pxa) & torch.isfinite(pxb) & \
        torch.isfinite(py) & torch.isfinite(lxa) & torch.isfinite(lya) & \
        torch.isfinite(lxb) & torch.isfinite(lyb)
    lx_lo, lx_hi = torch.minimum(lxa, lxb), torch.maximum(lxa, lxb)
    ly_lo, ly_hi = torch.minimum(lya, lyb), torch.maximum(lya, lyb)
    x0, y0, x1, y1 = (dense[..., k][..., None, None] for k in range(4, 8))
    sx, sy = t[9], t[10]
    cut = ((sx > 0.0) & (((lx_hi - x0) * sx <= -0.5) |
                         ((x1 - lx_lo) * sx <= -0.5))) | \
        ((sy > 0.0) & (((ly_hi - y0) * sy <= -0.5) |
                       ((y1 - ly_lo) * sy <= -0.5)))
    fw = pk.local_fwidth(xp, t, lxa, lya, pxa, py)
    fw = xp.where(fw > 1e-9, fw, 1e-9)
    cut_aa = ((x0 - lx_hi) / fw >= 0.5) | ((lx_lo - x1) / fw >= 0.5) | \
        ((y0 - ly_hi) / fw >= 0.5) | ((ly_lo - y1) / fw >= 0.5)
    lim = 1.0 / 1024.0
    cut_hard = (x0 - lx_hi >= lim) | (lx_lo - x1 >= lim) | \
        (y0 - ly_hi >= lim) | (ly_lo - y1 >= lim)
    edge = dense[..., REC_EDGE].to(torch.int32)[..., None, None]
    is_tx = xp.floor(t[11] * 0.25) % 2.0 >= 1.0
    cut = torch.where(is_tx, torch.where(edge > 0, cut_aa, cut_hard), cut)
    cut = cut & (t[2] == 0.0) & (t[5] == 0.0) & ends
    if float_ops:
        op = dense[..., REC_BLEND].to(torch.int32)
        flt = torch.zeros_like(op, dtype=torch.bool)
        for b in FLOAT_BLENDS:
            flt |= op == b
        cut = cut & ~flt[..., None, None]
    return ~cut


def _raster_group(kind, general, rec, px, py, ox, oy, dst, f32_rows,
                  atlases, blends, mask_clips, gl=False):
    """One slot of one kind for a group of tiles, all general or none: the
    Pallas `body`, or `render_tiles`' (ops/raster.py:138); `gl`: in the GL
    flavour, each blend op with `GL_FLAVOR_FLAG` (:1116-1127)."""
    p = rec[0:64]
    trow = rec[REC_TROW:REC_TROW + 12]
    mask_plane = atlases[2][0:1] if mask_clips or general else None
    lx, ly, cov, mcov = record_coverage(rec, px, py, f32_rows, mask_plane,
                                        general, gl)
    if kind == KIND_SOLID:
        color = pk.pattern_solid(xp, p, lx, ly)
    elif kind in GRADIENT_KINDS:
        color = _gradient(kind, p, lx, ly, f32_rows.reshape(-1), general)
    elif kind == KIND_BOX_SHADOW:
        # the blurred arm makes its sum with xp.zeros, which names no device
        with lx.device:
            color = pk.pattern_box_shadow(xp, p, lx, ly, trow[9], trow[10])
    elif kind == KIND_LINE_DEC:
        color = pk.pattern_line_dec(xp, p, lx, ly, trow[9], trow[10])
    elif kind in (KIND_GLYPH, KIND_PICTURE, KIND_SUBPX_GLYPH):
        color = _sampled_translation(kind, p, trow, ox, oy, atlases)
    elif kind == K_SEP_IMAGE:
        color = _sep_image(p, lx, ly, atlases[2])
    elif kind == K_SEP_PICTURE:
        color = _sep_picture(p, px, py, lx, ly, atlases[1])
    elif kind == K_SEP_GLYPH:
        color = _sep_glyph(p, lx, ly, atlases[0])
    elif kind == K_SEP_SUBPX:
        color = _sep_subpx(p, lx, ly, atlases[2])
    elif kind == K_SEP_YUV:
        color = _sep_yuv(p, lx, ly, atlases[0])
    elif kind == K_GEN_IMAGE:
        color = _gen_image(p, lx, ly, atlases[2])
    elif kind == K_GEN_GLYPH:
        color = _sep_glyph(p, lx, ly, atlases[0], per_pixel=True)
    elif kind == K_GEN_SUBPX:
        color = _sep_subpx(p, lx, ly, atlases[2], per_pixel=True)
    elif kind == K_GEN_PICTURE:
        color = _sep_picture(p, px, py, lx, ly, atlases[1], per_pixel=True)
    elif kind == K_GEN_YUV:
        color = _sep_yuv(p, lx, ly, atlases[0], per_pixel=True)
    elif kind == KIND_CLEAR:
        # _pattern_math (tile_raster.py:377): ones; BLEND_CLEAR punches
        # the destination by the source's alpha
        color = torch.ones((4,) + tuple(lx.shape), dtype=torch.float32,
                           device=lx.device)
    else:
        raise NotImplementedError(f"dense kind {kind} is not ported")
    flag = GL_FLAVOR_FLAG if gl else 0
    if len(blends) == 1:
        return blend_mod.compose_swgl(xp, blends[0] | flag, color, cov, mcov,
                                      dst)
    op = rec[REC_BLEND].to(torch.int32)[None]
    out = dst
    for b in blends:
        out = xp.where(op == b, blend_mod.compose_swgl(xp, b | flag, color,
                                                       cov, mcov, dst), out)
    return out


def render_tiles_dense_plain(dense, tile_counts, tile_origins, clear_color,
                             f32_rows, alpha_atlas, surface_atlas,
                             color_atlas, init_tiles=None, *, kinds, blends,
                             mask_clips=False, step=1.0, gl=False):
    """The plain PyTorch version of the kernel, on any device.  It takes
    no `general` flag: each record says by REC_GENERAL whether its tile is
    general.  `gl`: the GL flavour."""
    nt, slots, _ = dense.shape
    px, py = tile_pixels(tile_origins, step)
    ox = tile_origins[:, 0][:, None, None]
    oy = tile_origins[:, 1][:, None, None]
    if init_tiles is not None:
        # a copy even where the permuted view is contiguous (one tile)
        acc = init_tiles.permute(1, 0, 2, 3).clone(
            memory_format=torch.contiguous_format)
    else:
        acc = clear_color[:, None, None, None].expand(
            4, nt, TILE_H, TILE_W).contiguous()
    counts = tile_counts.long()
    n_slots = int(counts.max()) if nt else 0
    for s in range(n_slots):
        live = torch.nonzero(counts > s).reshape(-1)
        kind_s = dense[live, s, REC_KIND].to(torch.int32)
        general_s = dense[live, s, REC_GENERAL] > 0.5
        for k in kinds:
            for general in (False, True):
                ii = live[(kind_s == k) & (general_s == general)]
                if ii.numel() == 0:
                    continue
                acc[:, ii] = _raster_group(
                    k, general, _cols(dense[ii, s]), px[ii], py[ii], ox[ii],
                    oy[ii], acc[:, ii], f32_rows,
                    (alpha_atlas, surface_atlas, color_atlas), tuple(blends),
                    mask_clips, gl)
    return acc.permute(1, 0, 2, 3).contiguous()
