"""Dense per-tile records for the tile-raster kernel, as torch index ops.

Ports of `webrender_tpu/ops/pallas/tile_raster.py`: `classify_dense_kinds`
(:452), `build_dense_records_device` (:487, its aligned row-gather form),
`update_dense_records_device` (:531) and `dense_dispatch_info` (:545).
A record is one 128-float row: [0:64] payload, [64] kind, [65] blend,
[66] edge_aa, [67] clip count, [68] clip row, [69:81] transform row.

Two host checks raise `NotImplementedError` for what the CUDA kernel does
not port: `check_clip_kinds` (every active clip record is a rect or a
rounded rect; the kernel's wrapper runs it) and `check_sep_images` (the
pass's scaled images have axis-aligned mappings; the renderer runs it).
"""
from __future__ import annotations

import torch

from webrender_tpu.frame.gpu import (CLIP_STRIDE, INST_BLEND, INST_CLIP_ADDR,
                                     INST_CLIP_COUNT, INST_EDGE_AA, INST_KIND,
                                     INST_PRIM_ADDR, INST_SPATIAL, KIND_GLYPH,
                                     KIND_IMAGE, KIND_LINEAR_GRAD,
                                     KIND_PICTURE, KIND_SOLID,
                                     KIND_SUBPX_GLYPH, KIND_YUV)

REC_KIND = 64
REC_BLEND = 65
REC_EDGE = 66
REC_CLIP_COUNT = 67
REC_CLIP_ROW = 68
REC_TROW = 69

# separable-sampling pseudo-kinds of the dense records (tile_raster.py:57)
K_SEP_IMAGE = 13
K_SEP_GLYPH = 14
K_SEP_PICTURE = 15
K_SEP_SUBPX = 16
K_SEP_YUV = 17
SAMPLED_KINDS = (KIND_GLYPH, KIND_PICTURE, KIND_SUBPX_GLYPH)

# what csrc/tile_raster.cu implements
PORTED_KINDS = (KIND_SOLID, KIND_LINEAR_GRAD, KIND_SUBPX_GLYPH, K_SEP_IMAGE)
PORTED_BLENDS = (0, 7, 8)       # BLEND_NORMAL, BLEND_CH_CLEAR, BLEND_ADD
PORTED_CLIP_KINDS = (0, 1)      # rect, rounded rect

_SEP_MAP = {KIND_IMAGE: K_SEP_IMAGE, KIND_GLYPH: K_SEP_GLYPH,
            KIND_PICTURE: K_SEP_PICTURE, KIND_SUBPX_GLYPH: K_SEP_SUBPX,
            KIND_YUV: K_SEP_YUV}


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


def build_dense_records(f32_buf, instances, transforms, tile_insts,
                        dense_kinds):
    """[nt, slots, 128] f32 dense records, gathered from the frame arrays.
    Payloads are fetched as whole 128-float rows, so every primitive
    address must be 128-aligned (GpuBufferBuilder.ALIGN guarantees it)."""
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
    kind = torch.where(valid, dense_kinds[safe], -1)
    cols = torch.stack([
        kind.to(torch.float32),
        recs[:, INST_BLEND].to(torch.float32),
        recs[:, INST_EDGE_AA].to(torch.float32),
        recs[:, INST_CLIP_COUNT].to(torch.float32),
        (recs[:, INST_CLIP_ADDR] // 128).to(torch.float32),
    ], dim=1)
    trows = transforms[recs[:, INST_SPATIAL].long()]
    pad = torch.zeros((ids.shape[0], 128 - 64 - 5 - trows.shape[1]),
                      dtype=torch.float32, device=f32_buf.device)
    zero = torch.zeros((), dtype=torch.float32, device=f32_buf.device)
    dense = torch.cat([torch.where(valid[:, None], pay, zero), cols,
                       torch.where(valid[:, None], trows, zero), pad], dim=1)
    return dense.reshape(nt, slots, 128)


def update_dense_records(dense, f32_buf, instances, transforms, tile_insts,
                         dense_kinds, tiles):
    """Re-gather the records of `tiles` (an index tensor without repeats)
    into the persistent mirror `dense`, in place, and return it:
    `update_dense_records_device` (tile_raster.py:531), which returns a new
    array instead."""
    sub = build_dense_records(f32_buf, instances, transforms,
                              tile_insts[tiles], dense_kinds)
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


def dense_dispatch_info(f32_buf, instances, tile_insts, dense_kinds):
    """(kinds, blends, mask_clips) of one dense pass — the kinds from the
    per-instance dense kinds (pseudo-kinds included)."""
    ids = _pass_instances(tile_insts, dense_kinds.shape[0])
    if ids.numel() == 0:
        return (KIND_SOLID,), (0,), False
    kinds = tuple(int(k) for k in torch.unique(dense_kinds[ids]).tolist()
                  if k >= 0)
    blends = tuple(int(b) for b in
                   torch.unique(instances[ids][:, INST_BLEND]).tolist())
    recs = instances[ids]
    kinds_c = _clip_kinds(f32_buf.reshape(-1, CLIP_STRIDE),
                          recs[:, INST_CLIP_ADDR].long() // CLIP_STRIDE,
                          recs[:, INST_CLIP_COUNT].long())
    mask_clips = any((1.5 <= k < 2.5) or k >= 3.5 for k in kinds_c)
    return kinds or (KIND_SOLID,), blends or (0,), mask_clips


def check_sep_images(instances, transforms, tile_insts, dense_kinds):
    """Raise NotImplementedError unless every separable image of the pass
    has an axis-aligned mapping: the kernel samples u from the tile's
    first row and v from its first column, as the TPU kernel does for the
    instances it accepts (tile_raster.py:_supported_vec)."""
    ids = _pass_instances(tile_insts, dense_kinds.shape[0])
    sep = ids[dense_kinds[ids] == K_SEP_IMAGE]
    if sep.numel():
        t = transforms[instances[sep][:, INST_SPATIAL].long()]
        if not bool(_axis_aligned(t).all()):
            raise NotImplementedError(
                "separable image sampling needs an axis-aligned mapping")


def check_clip_kinds(dense, tile_counts, f32_rows):
    """Raise NotImplementedError naming the first clip kind ([14] of a
    clip record) that a valid dense record uses and the kernel does not
    port."""
    slot = torch.arange(dense.shape[1], device=dense.device)
    valid = slot[None, :] < tile_counts[:, None].long()
    for ck in _clip_kinds(f32_rows, dense[..., REC_CLIP_ROW][valid].long(),
                          dense[..., REC_CLIP_COUNT][valid].long()):
        if ck not in PORTED_CLIP_KINDS:
            raise NotImplementedError(f"clip kind {ck:g} is not ported")
