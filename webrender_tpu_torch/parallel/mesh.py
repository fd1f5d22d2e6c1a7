"""Multi-device rendering: the frame's tile grid sharded over the ranks of a
`torch.distributed` process group.

The counterpart of `webrender_tpu/parallel/mesh.py`, which runs one
program per device under `shard_map`.  Here the program is SPMD: one
process per device, each running the same `RenderBackend` on the same
transactions, so every rank holds its own copy of what JAX replicates
(`P()`): the atlases, the delta mirrors, the picture cache and the
GPU-buffer rows.  A raster pass is sharded by tiles: rank `r` rasters the
contiguous rows `[r * per, (r + 1) * per)` of the tile axis (padded to a
multiple of the mesh size) with the tile-raster kernel, and an
`all_gather` gives every rank the whole pass, as JAX gathers its sharded
output on read.  Painter-order blending happens inside each tile, so the
pass itself needs no other collective.  A blur shards the rows of its
image; the vertical blur exchanges `radius` halo rows with the neighbour
ranks (point-to-point sends, JAX's `ppermute`), the horizontal one is
local.

Every sharded path equals its unsharded twin bitwise (only placement
changes): `render_tiles_pallas_sharded` equals `render_tiles_dense`, and
`blur_image_sharded` equals JAX's `blur_image_sharded` everywhere and
`ops/raster.py::blur_region` inside the blur region.  Outside it, where
the task is larger than the region, the two differ as they do in the
reference: the sharded blur edge-pads the content out to the task and
blurs that, `blur_region` blurs the region and edge-replicates its output.

Lockstep: every rank must make the same collectives in the same order, so
every decision before one (the route, the padding, the host checks that
raise) is taken on data that all ranks hold alike.  NCCL takes one rank
per GPU; gloo serves the CPU.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..frame.gpu import INST_BLEND, INST_KIND
from ..frame.tiles import TILE_H, TILE_W
from ..ops import dense as dense_mod
from ..ops.raster import _edge_pad
from ..ops.tile_raster import (INSTANTIATIONS, _check_supported,
                               instantiation, render_tiles_dense)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of `size` ranks along the tile axis: this process is
    `rank`, its tensors live on `device`, and `group` (None: the default
    group) runs the collectives over `backend` ("nccl" or "gloo")."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    backend: str

    def global_rank(self, r: int) -> int:
        """The rank of the world that is rank `r` of the mesh."""
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                  r)


class ShardedCounts:
    """`launches`: sharded dispatches whose shard launched the CUDA kernel,
    and `by_instantiation` the same by the kernel's instantiation;
    `blurs`: sharded blurs; `halo_exchanges`: vertical blurs that sent
    rows to another rank."""
    launches = 0
    by_instantiation = dict.fromkeys(INSTANTIATIONS, 0)
    blurs = 0
    halo_exchanges = 0

    @classmethod
    def reset(cls):
        cls.launches = 0
        cls.by_instantiation = dict.fromkeys(cls.by_instantiation, 0)
        cls.blurs = 0
        cls.halo_exchanges = 0


def make_mesh(n: Optional[int] = None, device="cuda",
              group=None) -> Mesh:
    """The mesh of the initialised process group `group` (None: the
    default group), one rank per device.  `device` "cuda" takes the card
    `cuda:{local rank}` (the `LOCAL_RANK` environment variable, else the
    rank: one host) over NCCL and makes it the current device; "cpu" runs
    over gloo.  Raises `RuntimeError` when no process group is
    initialised, when `n` is not the group's size (a mesh never shrinks
    or grows: start the world with `n` ranks, or pass a group of `n`),
    or when a CUDA group has more ranks than the machine has cards."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no torch.distributed process group "
                           "is initialised (one process per device, "
                           "init_process_group first)")
    size = dist.get_world_size(group)
    if n is not None and n != size:
        raise RuntimeError(f"make_mesh(n={n}): the process group has {size} "
                           f"ranks")
    backend = str(dist.get_backend(group))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda'): CUDA is not "
                               "available")
        count = torch.cuda.device_count()
        if size > count:
            raise RuntimeError(f"a CUDA mesh of {size} ranks needs {size} "
                               f"cards, this machine has {count} (NCCL "
                               f"takes one rank per card)")
        if "nccl" not in backend:
            raise RuntimeError(f"a CUDA mesh runs over NCCL, the group's "
                               f"backend is {backend}")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", dist.get_rank())))
        torch.cuda.set_device(device)
    elif device.type == "cpu":
        if "gloo" not in backend:
            raise RuntimeError(f"a CPU mesh runs over gloo, the group's "
                               f"backend is {backend}")
    else:
        raise RuntimeError(f"make_mesh: no mesh on {device}")
    return Mesh(group, dist.get_rank(group), size, device, backend)


def pad_tiles_for_mesh(tile_insts: np.ndarray, tile_origins: np.ndarray,
                       n_shards: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the tile axis to a multiple of the mesh size (padded tiles carry
    empty instance lists and render throwaway pixels)."""
    nt = tile_insts.shape[0]
    padded = -(-nt // n_shards) * n_shards
    if padded != nt:
        ti = np.full((padded, tile_insts.shape[1]), -1, np.int32)
        ti[:nt] = tile_insts
        to = np.zeros((padded, 2), np.float32)
        to[:nt] = tile_origins
        return ti, to
    return tile_insts, tile_origins


def _gather(mesh: Mesh, part):
    """[size * rows, ...]: every rank's `part` ([rows, ...]) in rank
    order."""
    out = part.new_empty((mesh.size * part.shape[0],) + tuple(part.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, part.contiguous(), group=mesh.group)
    return out


def _gather_image_rows(mesh: Mesh, part):
    """[4, size * rows, w]: every rank's rows `part` ([4, rows, w]) in rank
    order."""
    _, rows, w = part.shape
    return _gather(mesh, part).view(mesh.size, 4, rows, w).transpose(0, 1) \
        .reshape(4, mesh.size * rows, w)


def _shard(t, lo: int, hi: int, per: int):
    """Rows [lo, hi) of `t`, zero-padded to `per` rows."""
    part = t[lo:hi]
    if hi - lo == per:
        return part
    return torch.cat([part, part.new_zeros((per - (hi - lo),) +
                                           tuple(t.shape[1:]))])


def render_tiles_pallas_sharded(mesh: Mesh, dense, tile_counts,
                                tile_origins, clear_color, f32_rows,
                                alpha_atlas, surface_atlas, color_atlas,
                                init_tiles=None, *, kinds, blends,
                                mask_clips: bool = False,
                                general: bool = False, step: float = 1.0,
                                linear_cm: bool = False,
                                polygon_clips: bool = False,
                                gl: bool = False,
                                host_checked: bool = False):
    """`render_tiles_dense` with the tile axis sharded over `mesh` (K9,
    `render_tiles_pallas_sharded`, mesh.py:116): the tile axis of `dense`,
    `tile_counts`, `tile_origins` and `init_tiles` is padded to a multiple
    of the mesh size (padded tiles have count 0 and zeros), this rank
    rasters its contiguous shard, and an all-gather returns the whole
    [nt, 4, TILE_H, TILE_W] pass on every rank.  The GPU-buffer rows, the
    atlases and the [4] clear color are replicated (the kernel takes one
    clear color, where JAX's caller also pads a per-tile one; per-tile
    contents go in `init_tiles`).  The host checks run on the whole
    dispatch, before the collective, so that every rank raises or none
    does."""
    _check_supported(kinds, blends)
    if not host_checked:
        dense_mod.check_clip_kinds(dense, tile_counts, f32_rows, mask_clips,
                                   polygon_clips)
        dense_mod.check_color_matrix_flags(dense, tile_counts, linear_cm)
        dense_mod.check_general_flags(dense, tile_counts, general, step)
    nt = dense.shape[0]
    if nt == 0:
        return dense.new_empty((0, 4, TILE_H, TILE_W))
    per = -(-nt // mesh.size)
    lo = min(mesh.rank * per, nt)
    hi = min(lo + per, nt)
    part = render_tiles_dense(
        _shard(dense, lo, hi, per), _shard(tile_counts, lo, hi, per),
        _shard(tile_origins, lo, hi, per), clear_color, f32_rows,
        alpha_atlas, surface_atlas, color_atlas,
        None if init_tiles is None else _shard(init_tiles, lo, hi, per),
        kinds=kinds, blends=blends, mask_clips=mask_clips, general=general,
        step=step, linear_cm=linear_cm, polygon_clips=polygon_clips, gl=gl,
        host_checked=True)
    if dense.device.type == "cuda":
        ShardedCounts.launches += 1
        ShardedCounts.by_instantiation[instantiation(
            kinds, blends, mask_clips, general, step, linear_cm,
            polygon_clips, gl)] += 1
    return _gather(mesh, part)[:nt]


def render_tiles_sharded(mesh: Mesh, f32_buf, instances, transforms,
                         tile_insts, tile_origins, clear_color,
                         color_atlas, alpha_atlas, surface_atlas,
                         *, kinds, blends, step: float = 1.0,
                         gl: bool = False):
    """One raster pass from the frame's host arrays with the tile axis
    sharded over `mesh` (`render_tiles_sharded`, mesh.py:64, the sharded
    caller of JAX's XLA engine, `ops/raster.py::render_tiles`).  The port
    has no second engine: the pass's dense records are built as the
    renderer builds them (`Renderer._kernel_args`), the tiles whose
    instances have no path in the TPU kernel routed to the kernel's
    general branches, every tile general when `step` is not 1, and
    `render_tiles_pallas_sharded` rasters them; as in JAX, the tile lists
    are padded to the mesh first (`pad_tiles_for_mesh`) and the pad is
    stripped from the result.  `kinds` and `blends` are the pass's
    instance kinds and blend ops, as `render_tiles` takes them; a tile
    list that names another one raises `ValueError`, before any
    collective.
    `clear_color` is a [4] clear color or [nt, 4, TILE_H, TILE_W] initial
    tiles; the atlases are tensors on the mesh's device.  Returns [nt, 4,
    TILE_H, TILE_W] on every rank."""
    nt = int(tile_insts.shape[0])
    ti, to = pad_tiles_for_mesh(np.asarray(tile_insts),
                                np.asarray(tile_origins, np.float32),
                                mesh.size)
    f32_h, inst_h, xf_h, ti_h, to_h = (
        torch.from_numpy(np.ascontiguousarray(a)) for a in
        (f32_buf, instances, transforms, ti, to))
    dense_mod.check_aligned(f32_h, inst_h)
    ids = ti_h[ti_h >= 0].unique().long()
    for col, allowed, what in ((INST_KIND, kinds, "kind"),
                               (INST_BLEND, blends, "blend op")):
        extra = set(inst_h[ids, col].tolist()) - set(int(v) for v in allowed)
        if extra:
            raise ValueError(f"the tile lists name instance {what}s "
                             f"{sorted(extra)}, not in {tuple(allowed)}")
    all_general = step != 1.0
    dk = dense_mod.classify_dense_kinds(f32_h, inst_h, xf_h)
    ok = dense_mod.pallas_supported(f32_h, inst_h, xf_h)
    linear_cm, _ = dense_mod.check_pass_records(f32_h, inst_h, ti_h)
    d_kinds, d_blends, mask_clips, general, polygon_clips = \
        dense_mod.dense_dispatch_info(f32_h, inst_h, ti_h, dk, ok,
                                      all_general=all_general)
    dev = mesh.device
    f32_d = f32_h.to(dev)
    dense = dense_mod.build_dense_records(
        f32_d, inst_h.to(dev), xf_h.to(dev), ti_h.to(dev), dk.to(dev),
        ok.to(dev), all_general)
    clear = torch.as_tensor(np.asarray(clear_color, np.float32))
    init = None
    if clear.dim() != 1:
        init = _shard(clear, 0, nt, ti.shape[0]).to(dev)
        clear = torch.zeros(4)
    return render_tiles_pallas_sharded(
        mesh, dense, (ti_h >= 0).sum(1).to(torch.int32).to(dev),
        to_h.to(dev), clear.to(dev), f32_d.reshape(-1, 128), alpha_atlas,
        surface_atlas, color_atlas, init, kinds=d_kinds, blends=d_blends,
        mask_clips=mask_clips, general=general, step=step,
        linear_cm=linear_cm, polygon_clips=polygon_clips, gl=gl,
        host_checked=True)[:nt]


def _taps(ext, weights, radius: int, dim: int, n: int):
    """The blur's taps over `ext` along `dim` in the order k = 0..2r, then
    the 16-bit fixed point back to the u8 grid (JAX's arithmetic)."""
    out = ext.new_zeros(ext.shape[:dim] + (n,) + ext.shape[dim + 1:])
    for k in range(2 * radius + 1):
        out = out + float(weights[k]) * ext.narrow(dim, k, n)
    return torch.floor(out * (1.0 / 65536.0) + 0.5) * (1.0 / 255.0)


def _blur_rows_sharded(mesh: Mesh, x, weights, *, radius: int, axis: int):
    """This rank's rows `x` ([4, rows, w] of the padded image) blurred
    along `axis` (`_blur_rows_sharded`, mesh.py:178): the vertical blur
    takes `radius` halo rows from each neighbour, and the ranks at the ends
    replicate their own edge rows; when the halo is wider than a shard, it
    gathers every row first.  The horizontal blur is local."""
    rows = x.shape[1]
    if axis == 1:
        return _taps(_edge_pad(x, 2, radius, radius), weights, radius, 2,
                     x.shape[2])
    if radius >= rows:
        full = _gather_image_rows(mesh, x)
        out = _taps(_edge_pad(full, 1, radius, radius), weights, radius, 1,
                    full.shape[1])
        return out[:, mesh.rank * rows:(mesh.rank + 1) * rows]
    r, n = mesh.rank, mesh.size
    top = x[:, :1].expand(-1, radius, -1).contiguous()
    bot = x[:, -1:].expand(-1, radius, -1).contiguous()
    ops = []
    if r > 0:  # the rows above are the previous rank's last rows
        ops += [dist.P2POp(dist.isend, x[:, :radius].contiguous(),
                           mesh.global_rank(r - 1), mesh.group),
                dist.P2POp(dist.irecv, top, mesh.global_rank(r - 1),
                           mesh.group)]
    if r < n - 1:  # the rows below are the next rank's first rows
        ops += [dist.P2POp(dist.isend, x[:, -radius:].contiguous(),
                           mesh.global_rank(r + 1), mesh.group),
                dist.P2POp(dist.irecv, bot, mesh.global_rank(r + 1),
                           mesh.group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        ShardedCounts.halo_exchanges += 1
    return _taps(torch.cat([top, x, bot], 1), weights, radius, 1, rows)


def blur_image_sharded(mesh: Mesh, src, weights, *, radius: int, axis: int,
                       bw: int = 0, bh: int = 0):
    """Separable gaussian blur of a planar [4, h, w] image along `axis`
    with its rows sharded over `mesh` (`blur_image_sharded`,
    mesh.py:239): the content of the blur region [0, bw) x [0, bh) on the
    u8 grid, edge-padded out to the task, its rows edge-padded to a
    multiple of the mesh size, each rank's rows blurred, and the rows
    gathered on every rank.  Inside the region this equals
    `ops/raster.py::blur_region`; outside it, it is JAX's sharded blur,
    which blurs the edge-padded content there (see the module's
    docstring)."""
    n = mesh.size
    _, h, w = src.shape
    bw = w if bw <= 0 else bw
    bh = h if bh <= 0 else bh
    x = torch.floor(src[:, :bh, :bw] * 255.0 + 0.5)
    x = _edge_pad(_edge_pad(x, 1, 0, h - bh + (-h) % n), 2, 0, w - bw)
    rows = x.shape[1] // n
    part = _blur_rows_sharded(
        mesh, x[:, mesh.rank * rows:(mesh.rank + 1) * rows], weights,
        radius=radius, axis=axis)
    ShardedCounts.blurs += 1
    return _gather_image_rows(mesh, part)[:, :h]
