"""Dense per-tile records for the tile-raster kernel, as torch index ops.

Ports of `webrender_tpu/ops/pallas/tile_raster.py`: `classify_dense_kinds`
(:452), `build_dense_records_device` (:487, its aligned row-gather form),
`update_dense_records_device` (:531) and `dense_dispatch_info` (:545).
A record is one 128-float row: [0:64] payload, [64] kind, [65] blend,
[66] edge_aa, [67] clip count, [68] clip row, [69:81] transform row and,
the port's own, [81] the tile's general flag.

Routing.  `pallas_supported` (the port of `_supported_vec`,
tile_raster.py:196) says which instances have a path in the TPU kernel;
a tile that lists any other instance is a *general* tile
(`general_tiles`, the complement of `pallas_supported_mask`,
tile_raster.py:301).  The JAX renderer draws every instance of such a
tile on its XLA engine (`ops/raster.py::render_tiles`), which samples per
pixel and has none of the TPU kernel's windows.  Here the dense records
route instead: in a general tile every sampled instance gets a general
dense kind (`GENERAL_KINDS`: the per-pixel branches of the one kernel)
and every record carries the flag, which also selects the per-pixel clip
chain; in every other tile the records are what they were.

Host checks raise `NotImplementedError` for what the CUDA kernel does
not port, before any launch:

* `check_clip_kinds` (the kernel's wrapper): every active clip record is
  a rect, a rounded rect, an image mask, a polygon or a box-shadow
  nine-patch, and a dispatch whose records hold a clip that the kernel
  reads as a polygon says `polygon_clips` (a `ValueError`: the
  instantiation that holds it).  As in the TPU kernel, an image-mask or
  nine-patch record of a tile that is not general is read as such only
  with `mask_clips`, and as a polygon without it;
* `check_color_matrix_flags` (the wrapper; a `ValueError`): a picture
  record asks for the color matrix in linearRGB (flag 2) only where the
  dispatch says `linear_cm` (the instantiation that holds it), and for no
  flag past 2;
* `check_general_flags` (the wrapper; a `ValueError`): the dispatch's
  `general` and `step` agree with its records;
* `check_pass_records` (the renderer, when a pass's records change): the
  wrapper's two checks on the frame's host arrays, so that its launches
  need not wait for the device, and unknown instance kinds; it returns
  the dispatch's `linear_cm` and `polygon_clips`.
"""
from __future__ import annotations

import torch

from ..frame.gpu import (CLIP_STRIDE, INST_BLEND, INST_CLIP_ADDR,
                         INST_CLIP_COUNT, INST_EDGE_AA, INST_KIND,
                         INST_PRIM_ADDR, INST_SPATIAL, KIND_BORDER,
                         KIND_BOX_SHADOW, KIND_CLEAR, KIND_CONIC_GRAD,
                         KIND_GLYPH, KIND_IMAGE, KIND_LINE_DEC,
                         KIND_LINEAR_GRAD, KIND_PICTURE, KIND_RADIAL_GRAD,
                         KIND_SOLID, KIND_SUBPX_GLYPH, KIND_YUV)
from ..frame.tiles import TILE_H, TILE_W

REC_KIND = 64
REC_BLEND = 65
REC_EDGE = 66
REC_CLIP_COUNT = 67
REC_CLIP_ROW = 68
REC_TROW = 69
# 1.0 in every record of a general tile (the port's own column)
REC_GENERAL = 81

# separable-sampling pseudo-kinds of the dense records (tile_raster.py:57)
K_SEP_IMAGE = 13
K_SEP_GLYPH = 14
K_SEP_PICTURE = 15
K_SEP_SUBPX = 16
K_SEP_YUV = 17
# the general (per-pixel) sampling kinds of a general tile's records: an
# image and a video keep their instance kinds, which no other dense record
# carries; glyph, picture and subpixel glyph take numbers past K_SEP_YUV
K_GEN_IMAGE = KIND_IMAGE
K_GEN_YUV = KIND_YUV
K_GEN_GLYPH = 18
K_GEN_PICTURE = 19
K_GEN_SUBPX = 20
GENERAL_KINDS = (K_GEN_IMAGE, K_GEN_YUV, K_GEN_GLYPH, K_GEN_PICTURE,
                 K_GEN_SUBPX)
SAMPLED_KINDS = (KIND_GLYPH, KIND_PICTURE, KIND_SUBPX_GLYPH)
# the TPU kernel's arithmetic kinds (tile_raster.py:45)
MATH_KINDS = (KIND_SOLID, KIND_LINEAR_GRAD, KIND_RADIAL_GRAD,
              KIND_CONIC_GRAD, KIND_CLEAR, KIND_BOX_SHADOW, KIND_BORDER,
              KIND_LINE_DEC)
MAX_PALLAS_STOPS = 16
# the separable window's texel spans (tile_raster.py:66-71)
MAX_SEP_SPAN_X = 384 - 128
MAX_SEP_SPAN_Y = 136 - 8

# what csrc/tile_raster.cu implements
PORTED_KINDS = (KIND_SOLID, KIND_LINEAR_GRAD, KIND_RADIAL_GRAD,
                KIND_CONIC_GRAD, KIND_GLYPH, KIND_PICTURE, KIND_CLEAR,
                KIND_BOX_SHADOW, KIND_BORDER, KIND_SUBPX_GLYPH,
                KIND_LINE_DEC, K_SEP_IMAGE, K_SEP_GLYPH, K_SEP_PICTURE,
                K_SEP_SUBPX, K_SEP_YUV) + GENERAL_KINDS
PORTED_COLOR_MATRIX_FLAGS = (0, 1, 2)  # passthrough, sRGB, linearRGB
# the blend ops that `blend.compose_swgl` runs in the float domain: the
# Porter-Duff composites 2-6 (feComposite), the SVGFE mixes 40-56
# (feBlend) and every op from 64 (the same in linearRGB)
FLOAT_BLENDS = tuple(range(2, 7)) + tuple(range(40, 57)) + \
    tuple(range(64, 121))
# BLEND_NORMAL, BLEND_CLEAR, BLEND_CH_CLEAR, BLEND_ADD, the mix-blend modes
# (BLEND_MIX_BASE + MixBlendMode, normal to plus-lighter) and FLOAT_BLENDS
PORTED_BLENDS = tuple(sorted((0, 1, 7, 8) + tuple(range(16, 33)) +
                             FLOAT_BLENDS))
# rect, rounded rect, image mask, polygon, box-shadow nine-patch
PORTED_CLIP_KINDS = (0, 1, 2, 3, 4)
# the kinds the TPU kernel reads as such only with its mask_clips (without
# it, as polygons)
MASK_CLIP_KINDS = (2, 4)
# the device-space convex polygon of a preserve-3d plane fragment
POLYGON_CLIP_KIND = 3

_SEP_MAP = {KIND_IMAGE: K_SEP_IMAGE, KIND_GLYPH: K_SEP_GLYPH,
            KIND_PICTURE: K_SEP_PICTURE, KIND_SUBPX_GLYPH: K_SEP_SUBPX,
            KIND_YUV: K_SEP_YUV}
_GENERAL_MAP = {KIND_IMAGE: K_GEN_IMAGE, KIND_GLYPH: K_GEN_GLYPH,
                KIND_PICTURE: K_GEN_PICTURE, KIND_SUBPX_GLYPH: K_GEN_SUBPX,
                KIND_YUV: K_GEN_YUV}


def _isin(x, values):
    return torch.isin(x, torch.tensor(values, dtype=x.dtype, device=x.device))


def _axis_aligned(t):
    return (t[:, 1].abs() < 1e-9) & (t[:, 3].abs() < 1e-9) & \
        (t[:, 2].abs() < 1e-9) & (t[:, 5].abs() < 1e-9) & \
        ((t[:, 8] - 1).abs() < 1e-6)


def classify_dense_kinds(f32_buf, instances, transforms):
    """Per-instance dense kind [N] int32: sampled instances become the
    separable pseudo-kinds unless the translation fast path applies."""
    kinds = instances[:, INST_KIND].to(torch.int32)
    sampled = _isin(kinds, SAMPLED_KINDS) | (kinds == KIND_IMAGE) | \
        (kinds == KIND_YUV)
    if not bool(sampled.any()):
        return kinds
    t = transforms[instances[:, INST_SPATIAL].long()]
    addr = instances[:, INST_PRIM_ADDR].long()
    offs = torch.tensor([0, 1, 2, 3, 8, 9, 10, 11, 37], device=addr.device)
    offs = (addr[:, None] + offs[None]).clamp(0, f32_buf.shape[0] - 1)
    pay = f32_buf[offs]  # rect(4), uv(4), rr-flag
    translation = ((t[:, 0] - 1).abs() < 1e-6) & \
        ((t[:, 4] - 1).abs() < 1e-6) & _axis_aligned(t)
    one2one = (((pay[:, 6] - pay[:, 4]) -
                (pay[:, 2] - pay[:, 0])).abs() <= 1e-3) & \
              (((pay[:, 7] - pay[:, 5]) -
                (pay[:, 3] - pay[:, 1])).abs() <= 1e-3) & \
              (pay[:, 8] <= 0.5)
    fast = translation & one2one & (kinds != KIND_IMAGE) & \
        (kinds != KIND_YUV)
    sep_map = torch.zeros(16, dtype=torch.int32, device=kinds.device)
    for k, v in _SEP_MAP.items():
        sep_map[k] = v
    return torch.where(sampled & ~fast, sep_map[kinds.clamp(0, 15).long()],
                       kinds)


def general_tiles(tile_insts, supported):
    """Bool [nt]: the tile lists an instance that `supported` ([N] bool,
    `pallas_supported`) rejects; the complement of `pallas_supported_mask`
    (tile_raster.py:301)."""
    ok = supported[tile_insts.clamp(min=0).long()] | (tile_insts < 0)
    return ~ok.all(dim=1)


def _routed_tiles(tile_insts, supported, all_general):
    """Bool [nt]: the tiles whose records are general: all of them, those
    `general_tiles` finds with `supported`, or none without it."""
    if all_general or supported is None:
        return torch.full((tile_insts.shape[0],), bool(all_general),
                          dtype=torch.bool, device=tile_insts.device)
    return general_tiles(tile_insts, supported)


def _general_kinds(instance_kinds, dense_kinds):
    """The dense kinds of instances in a general tile: the general kind of
    a sampled instance, else its dense kind."""
    lut = torch.full((16,), -1, dtype=torch.int32,
                     device=dense_kinds.device)
    for k, v in _GENERAL_MAP.items():
        lut[k] = v
    gen_kind = lut[instance_kinds.clamp(0, 15).long()]
    return torch.where(gen_kind >= 0, gen_kind, dense_kinds.to(torch.int32))


def build_dense_records(f32_buf, instances, transforms, tile_insts,
                        dense_kinds, supported=None, all_general=False):
    """[nt, slots, 128] f32 dense records, gathered from the frame arrays.
    Payloads are fetched as whole 128-float rows, so every primitive
    address must be 128-aligned (GpuBufferBuilder.ALIGN guarantees it).
    With `supported` ([N] bool, `pallas_supported`) the records route: a
    general tile's records carry REC_GENERAL and its sampled instances the
    general kinds.  `all_general` makes every tile general (a pass with a
    raster step other than 1)."""
    nt, slots = tile_insts.shape
    if f32_buf.shape[0] % 128:
        raise ValueError("f32_buf length must be a multiple of 128")
    ids = tile_insts.reshape(-1).long()
    valid = ids >= 0
    safe = ids.clamp(min=0)
    recs = instances[safe]
    addr = recs[:, INST_PRIM_ADDR].long()
    rows = (addr // 128).clamp(0, f32_buf.shape[0] // 128 - 1)
    pay = f32_buf.reshape(-1, 128)[rows][:, :64]
    general = valid & _routed_tiles(tile_insts, supported, all_general)[
        :, None].expand(nt, slots).reshape(-1)
    kind = dense_kinds[safe].to(torch.int32)
    kind = torch.where(general, _general_kinds(recs[:, INST_KIND], kind),
                       kind)
    kind = torch.where(valid, kind, -1)
    cols = torch.stack([
        kind.to(torch.float32),
        recs[:, INST_BLEND].to(torch.float32),
        recs[:, INST_EDGE_AA].to(torch.float32),
        recs[:, INST_CLIP_COUNT].to(torch.float32),
        (recs[:, INST_CLIP_ADDR] // 128).to(torch.float32),
    ], dim=1)
    trows = transforms[recs[:, INST_SPATIAL].long()]
    pad = torch.zeros((ids.shape[0], 128 - 64 - 5 - trows.shape[1] - 1),
                      dtype=torch.float32, device=f32_buf.device)
    zero = torch.zeros((), dtype=torch.float32, device=f32_buf.device)
    dense = torch.cat([torch.where(valid[:, None], pay, zero), cols,
                       torch.where(valid[:, None], trows, zero),
                       general.to(torch.float32)[:, None], pad], dim=1)
    return dense.reshape(nt, slots, 128)


def update_dense_records(dense, f32_buf, instances, transforms, tile_insts,
                         dense_kinds, tiles, supported=None,
                         all_general=False):
    """Re-gather the records of `tiles` (an index tensor without repeats)
    into the persistent mirror `dense`, in place, and return it:
    `update_dense_records_device` (tile_raster.py:531), which returns a new
    array instead."""
    sub = build_dense_records(f32_buf, instances, transforms,
                              tile_insts[tiles], dense_kinds, supported,
                              all_general)
    return dense.index_copy_(0, tiles, sub)


def _pass_instances(tile_insts, n):
    """Sorted ids of the instances that the tile lists name, of `n`: a
    count per instance, not a sort of every slot."""
    uses = torch.bincount(tile_insts.reshape(-1) + 1, minlength=n + 1)
    return torch.nonzero(uses[1:]).reshape(-1)  # [0] counted the empties


def _clip_kinds(f32_rows, first_row, count):
    """Sorted kinds ([14]) of the clip records at rows first_row + j,
    j < count, of the [R, 128] buffer (one record per row)."""
    last = f32_rows.shape[0] - 1
    found = [f32_rows[(first_row[count > j] + j).clamp(0, last), 14]
             for j in range(int(count.max()) if count.numel() else 0)]
    if not found:
        return ()
    return tuple(float(k) for k in torch.unique(torch.cat(found)).tolist())


def dense_dispatch_info(f32_buf, instances, tile_insts, dense_kinds,
                        supported=None, all_general=False):
    """(kinds, blends, mask_clips, general, polygon_clips) of one dense
    pass: the kinds from the per-instance dense kinds (pseudo-kinds
    included) as the tiles route them (`build_dense_records`: an instance
    listed by a general tile and by another one gives both of its kinds),
    whether any tile is general, and whether a record holds a polygon clip
    (with `mask_clips` on whenever a record holds an image-mask or
    nine-patch clip, no other kind is read as a polygon)."""
    n = dense_kinds.shape[0]
    ids = _pass_instances(tile_insts, n)
    if ids.numel() == 0:
        return (KIND_SOLID,), (0,), False, False, False
    gen = _routed_tiles(tile_insts, supported, all_general)
    general = bool(gen.any())
    ids_g = _pass_instances(tile_insts[gen], n)
    found = torch.cat([
        dense_kinds[_pass_instances(tile_insts[~gen], n)].to(torch.int32),
        _general_kinds(instances[ids_g, INST_KIND], dense_kinds[ids_g])])
    kinds = tuple(int(k) for k in torch.unique(found).tolist() if k >= 0)
    blends = tuple(int(b) for b in
                   torch.unique(instances[ids][:, INST_BLEND]).tolist())
    recs = instances[ids]
    kinds_c = _clip_kinds(f32_buf.reshape(-1, CLIP_STRIDE),
                          recs[:, INST_CLIP_ADDR].long() // CLIP_STRIDE,
                          recs[:, INST_CLIP_COUNT].long())
    mask_clips = any((1.5 <= k < 2.5) or k >= 3.5 for k in kinds_c)
    return (kinds or (KIND_SOLID,), blends or (0,), mask_clips, general,
            POLYGON_CLIP_KIND in kinds_c)


def pallas_supported(f32_buf, instances, transforms):
    """Bool [N]: the instance has a path in the TPU kernel, `_supported_vec`
    (tile_raster.py:196): an arithmetic kind (gradients up to 16 stops),
    or a sampled kind on the translation fast path or in the separable
    window, with image-mask and box-shadow clips that fit their windows."""
    n = instances.shape[0]
    if n == 0:
        return torch.ones(0, dtype=torch.bool)
    kinds = instances[:, INST_KIND].to(torch.int32)
    addr = instances[:, INST_PRIM_ADDR].long()
    t = transforms[instances[:, INST_SPATIAL].long()]
    nbuf = f32_buf.shape[0]

    def at(off):
        return f32_buf[(addr + off).clamp(0, nbuf - 1)]

    is_grad = _isin(kinds, (KIND_LINEAR_GRAD, KIND_RADIAL_GRAD,
                            KIND_CONIC_GRAD))
    ok = _isin(kinds, MATH_KINDS) & (~is_grad | (at(14) <= MAX_PALLAS_STOPS))
    sampled = _isin(kinds, SAMPLED_KINDS) | (kinds == KIND_IMAGE) | \
        (kinds == KIND_YUV)
    axis_aligned = _axis_aligned(t)
    translation = axis_aligned & ((t[:, 0] - 1).abs() < 1e-6) & \
        ((t[:, 4] - 1).abs() < 1e-6)
    rect_w = torch.clamp((at(2) - at(0)).abs(), min=1e-6)
    rect_h = torch.clamp((at(3) - at(1)).abs(), min=1e-6)
    uv_w = (at(10) - at(8)).abs()
    uv_h = (at(11) - at(9)).abs()
    has41 = (addr + 41) <= nbuf
    one2one = (((at(10) - at(8)) - (at(2) - at(0))).abs() <= 1e-3) & \
        (((at(11) - at(9)) - (at(3) - at(1))).abs() <= 1e-3) & \
        (at(37) <= 0.5)
    is_img = (kinds == KIND_IMAGE) | (kinds == KIND_YUV)
    fast = translation & has41 & one2one & ~is_img
    local = has41 & (at(37) > 0.5)
    pic = kinds == KIND_PICTURE
    du = torch.where(is_img, t[:, 0] * at(22),
                     torch.where(pic, torch.where(local, t[:, 0] * at(40),
                                                  uv_w / rect_w),
                                 t[:, 0] * uv_w / rect_w))
    dv = torch.where(is_img, t[:, 4] * at(23),
                     torch.where(pic, torch.where(local, t[:, 4] * at(40),
                                                  uv_h / rect_h),
                                 t[:, 4] * uv_h / rect_h))
    span_x = torch.minimum(TILE_W * du.abs(), uv_w) + 2.0
    span_y = torch.minimum(TILE_H * dv.abs(), uv_h) + 2.0
    wrap_x = is_img & ((at(2) - at(0)) > (at(18) + at(20)) - 1e-4)
    wrap_y = is_img & ((at(3) - at(1)) > (at(19) + at(21)) - 1e-4)
    span_x = torch.where(wrap_x, uv_w + 2.0, span_x)
    span_y = torch.where(wrap_y, uv_h + 2.0, span_y)
    sep_ok = axis_aligned & (span_x <= MAX_SEP_SPAN_X) & \
        (span_y <= MAX_SEP_SPAN_Y)
    ok |= sampled & (fast | sep_ok)
    counts = instances[:, INST_CLIP_COUNT].long()
    caddr = instances[:, INST_CLIP_ADDR].long()
    for j in range(int(counts.max())):
        active = counts > j
        base = (caddr + j * CLIP_STRIDE).clamp(0, nbuf - CLIP_STRIDE)

        def cat(off):
            return f32_buf[base + off]

        ckind = cat(14)
        ct_ok = (cat(97).abs() < 1e-9) & (cat(99).abs() < 1e-9) & \
            (cat(98).abs() < 1e-9) & (cat(101).abs() < 1e-9) & \
            ((cat(104) - 1).abs() < 1e-6)
        is_mask = (ckind >= 1.5) & (ckind < 2.5)
        is_bs = ckind >= 3.5
        rw = torch.clamp((cat(2) - cat(0)).abs(), min=1e-6)
        rh = torch.clamp((cat(3) - cat(1)).abs(), min=1e-6)
        cdu = cat(96) * (cat(18) - cat(16)) / rw
        cdv = cat(100) * (cat(19) - cat(17)) / rh
        m_span_x = torch.minimum(TILE_W * cdu.abs(),
                                 (cat(18) - cat(16)).abs()) + 2.0
        m_span_y = torch.minimum(TILE_H * cdv.abs(),
                                 (cat(19) - cat(17)).abs()) + 2.0
        mask_ok = ct_ok & (m_span_x <= MAX_SEP_SPAN_X) & \
            (m_span_y <= MAX_SEP_SPAN_Y)
        bs_ok = ct_ok & \
            ((cat(18) - cat(16)).abs() + 2.0 <= MAX_SEP_SPAN_X) & \
            ((cat(19) - cat(17)).abs() + 2.0 <= MAX_SEP_SPAN_Y)
        ok &= ~(active & ((is_mask & ~mask_ok) | (is_bs & ~bs_ok)))
    return ok


def _refuse_color_matrix_flags(flags):
    for f in flags:
        if f not in PORTED_COLOR_MATRIX_FLAGS:
            raise NotImplementedError(f"color-matrix flag {f:g} is not "
                                      f"ported")


def _refuse_clip_kinds(kinds):
    for ck in kinds:
        if ck not in PORTED_CLIP_KINDS:
            raise NotImplementedError(f"clip kind {ck:g} is not ported")


def check_color_matrix_flags(dense, tile_counts, linear_cm=False):
    """Raise NotImplementedError if a valid picture record asks for a
    color-matrix flag ([36]) other than 0 (none), 1 (sRGB) and 2
    (linearRGB), and ValueError if one asks for flag 2 and the dispatch
    does not say `linear_cm` (the kernel would take a build without it)."""
    slot = torch.arange(dense.shape[1], device=dense.device)
    valid = slot[None, :] < tile_counts[:, None].long()
    kind = dense[..., REC_KIND]
    pic = valid & ((kind == KIND_PICTURE) | (kind == K_SEP_PICTURE) |
                   (kind == K_GEN_PICTURE))
    flags = torch.unique(dense[..., 36][pic]).tolist()
    _refuse_color_matrix_flags(flags)
    if not linear_cm and any(f > 1.5 for f in flags):
        raise ValueError("a picture record asks for color-matrix flag 2, "
                         "the dispatch does not say linear_cm=True")


def check_clip_kinds(dense, tile_counts, f32_rows, mask_clips=True,
                     polygon_clips=False):
    """Raise NotImplementedError naming the first clip kind ([14] of a
    clip record) that a valid dense record uses and the kernel does not
    port, and ValueError if a record holds a clip that the kernel reads as
    a polygon (kind 3; the image-mask and box-shadow kinds in a tile that
    is not general, without `mask_clips`) and the dispatch does not say
    `polygon_clips` (the kernel would take a build without the polygon)."""
    slot = torch.arange(dense.shape[1], device=dense.device)
    valid = slot[None, :] < tile_counts[:, None].long()
    general = dense[..., REC_GENERAL] > 0.5
    polygons = False
    for sel, masks in ((valid & ~general, mask_clips),
                       (valid & general, True)):
        kinds = _clip_kinds(f32_rows, dense[..., REC_CLIP_ROW][sel].long(),
                            dense[..., REC_CLIP_COUNT][sel].long())
        _refuse_clip_kinds(kinds)
        polygons |= any(k == POLYGON_CLIP_KIND or
                        (not masks and k in MASK_CLIP_KINDS) for k in kinds)
    if polygons and not polygon_clips:
        raise ValueError("a record holds a clip read as a polygon, the "
                         "dispatch does not say polygon_clips=True")


def check_general_flags(dense, tile_counts, general, step):
    """Raise ValueError where a dispatch's `general` and `step` contradict
    its records: a record of a general tile without `general` (the kernel
    would take a build without the general branches), or a valid record
    that is not general in a pass with a raster step (the TPU kernel's
    branches assume a step of 1)."""
    slot = torch.arange(dense.shape[1], device=dense.device)
    valid = slot[None, :] < tile_counts[:, None].long()
    flagged = dense[..., REC_GENERAL] > 0.5
    if not general and bool((valid & flagged).any()):
        raise ValueError("a record carries REC_GENERAL, the dispatch does "
                         "not say general=True")
    if step != 1.0 and bool((valid & ~flagged).any()):
        raise ValueError(f"raster step {step}: every record must carry "
                         f"REC_GENERAL")


def check_aligned(f32_buf, instances):
    """Raise `NotImplementedError` unless the GPU buffer is whole 128-float
    rows and every primitive address starts one (the records gather whole
    rows; `GpuBufferBuilder.ALIGN` guarantees it)."""
    if f32_buf.shape[0] % 128 or (
            instances.shape[0] and
            bool((instances[:, INST_PRIM_ADDR] % 128 != 0).any())):
        raise NotImplementedError("unaligned primitive addresses")


def check_pass_records(f32_buf, instances, tile_insts):
    """`check_clip_kinds` and `check_color_matrix_flags` for the records
    of the instances that the tile lists name, read from the frame's host
    arrays (a picture instance's record carries its payload's [36]), and
    unknown instance kinds.  Returns
    (linear_cm, polygon_clips): whether a picture asks for the color
    matrix in linearRGB and whether a record holds a polygon clip (the
    dispatch's flags; its `mask_clips`, `dense_dispatch_info`'s, is on
    wherever another kind could be read as a polygon)."""
    ids = _pass_instances(tile_insts, instances.shape[0])
    recs = instances[ids]
    for k in torch.unique(recs[:, INST_KIND]).tolist():
        if not 0 <= k <= KIND_YUV:
            raise NotImplementedError(f"instance kind {k} is not ported")
    rows = f32_buf.reshape(-1, 128)
    clip_kinds = _clip_kinds(rows, recs[:, INST_CLIP_ADDR].long() // 128,
                             recs[:, INST_CLIP_COUNT].long())
    _refuse_clip_kinds(clip_kinds)
    pic = recs[recs[:, INST_KIND] == KIND_PICTURE]
    row = (pic[:, INST_PRIM_ADDR].long() // 128).clamp(0, rows.shape[0] - 1)
    flags = torch.unique(rows[row, 36]).tolist()
    _refuse_color_matrix_flags(flags)
    return any(f > 1.5 for f in flags), POLYGON_CLIP_KIND in clip_kinds
