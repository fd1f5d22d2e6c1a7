"""The polygon clip (clip kind 3) on hand-built frames
(`torch_twin.HandFrame`).

A preserve-3d context's planes are split against each other on the host
and each fragment is clipped to its device-space convex polygon: a clip
record of up to 8 inward half-planes (a, b, c) at [24 + 3i], unused ones
padded with (0, 0, 1e9) (`_polygon_clip_record`).  Its coverage is the
least over the half-planes of `clip(a * px + b * py + c + 0.5, 0, 1)`
(`patterns.polygon_coverage`).

* Tiles that are not general, against the Pallas kernel in interpret mode
  (`torch_twin.run_pallas`), bitwise, and against the JAX package's numpy
  oracle on the u8 grid: 3 to 8 edges with the rest padded, a polygon
  clip inverted ([12] set), and one in a chain with a rounded and a rect
  clip, over a solid and a linear gradient.  These half-planes have
  coefficients of a few bits, so that `a * px` is exact and XLA's
  contraction of `a * px + b * py` into a multiply-add (which the port,
  like numpy, does not do) cannot move a value.
* The same with the frame builder's unit half-planes (`polygon_edges`):
  bitwise against the numpy oracle, and against the Pallas kernel at most
  `UNIT_FMA_VALUES` values one step apart (where XLA contracts).
* Without `mask_clips` the TPU kernel reads image-mask and nine-patch clip
  records (kinds 2 and 4) in tiles that are not general as polygons; with
  it, as masks: both against the Pallas kernel, bitwise.
* General tiles (`patterns.clip_coverage` per pixel, beside a rotated
  image), at raster steps 1 and 2: bitwise against the numpy oracle, and
  against `render_tiles` on XLA at a stated count.

On the card (`-m cuda`) the kernel equals the plain version on every one
of these inputs.
"""
import math

import numpy as np
import pytest
import torch

import torch_twin as tw
from test_torch_general import (CLEAR, ORIGINS, _image, _solid, _u8_steps,
                                jax_tiles, oracle_tiles, port_inputs)

from webrender_tpu_torch.ops import dense as dm
from webrender_tpu_torch.ops import tile_raster as tr

# every hand frame's f32 rows, padded, so that the interpret kernel
# compiles once for each kind set
ROWS = 24
# values of the unit-half-plane frame one step from the Pallas kernel in
# interpret mode, where XLA contracts a half-plane (measured: 0)
UNIT_FMA_VALUES = 0
# the general frame's values one step from `render_tiles` on XLA, by step
# (measured: 0 at both)
XLA_STEPS = {1.0: 0, 2.0: 0}


def dyadic_edges(n, cx, cy, r, phase=0.0):
    """The 24 floats of a polygon clip record for a regular `n`-gon about
    (cx, cy): inward half-planes whose a and b are sixteenths (not unit
    length), so that their products with a pixel centre are exact."""
    out = []
    for i in range(8):
        if i < n:
            t = phase + 2.0 * math.pi * i / n
            a = -round(16.0 * math.cos(t)) / 16.0
            b = -round(16.0 * math.sin(t)) / 16.0
            out += [a, b, -(a * cx + b * cy) + r]
        else:
            out += [0.0, 0.0, 1e9]
    return out


def regular_polygon(n, cx, cy, r, phase=0.0):
    return [(cx + r * math.cos(phase + 2.0 * math.pi * i / n),
             cy + r * math.sin(phase + 2.0 * math.pi * i / n))
            for i in range(n)]


def _gradient(h, rect, geom):
    p = np.zeros(64, np.float32)
    p[0:4] = rect
    p[4:8] = rect
    p[8:12] = geom
    p[12] = h.stops([(0.0, 0.8, 0.2, 0.2, 1.0), (1.0, 0.1, 0.2, 0.6, 0.8)])
    p[14] = 2
    p[16:18] = (rect[2] - rect[0], rect[3] - rect[1])
    return p


def polygon_frame(n, edges=dyadic_edges):
    """Four tiles (256 x 128 px): a background, a solid under an `n`-gon
    across all four tiles, a gradient under a smaller one, a solid under an
    inverted one, and a solid under an `n`-gon, a rounded clip and a rect
    clip."""
    h = tw.HandFrame(ORIGINS)
    h.prim(0, _solid((0, 0, 256, 128), (0.9, 0.9, 0.8, 1.0)))
    h.prim(0, _solid((40, 8, 216, 120), (0.2, 0.4, 0.8, 1.0)), clips=[
        h.clip(3, (0, 0, 256, 128), edges=edges(n, 128.25, 64.5, 52.0,
                                                 0.3))])
    h.prim(2, _gradient(h, (10, 4, 110, 70), (10, 4, 110, 70)), clips=[
        h.clip(3, (0, 0, 256, 128), edges=edges(n, 60.0, 37.0, 28.0, 0.7))])
    h.prim(0, _solid((150, 10, 250, 60), (0.6, 0.2, 0.4, 0.8)), clips=[
        h.clip(3, (0, 0, 256, 128), invert=1.0,
               edges=edges(n, 199.5, 35.25, 21.0, 0.1))])
    h.prim(0, _solid((120, 70, 250, 126), (0.1, 0.5, 0.3, 1.0)), clips=[
        h.clip(3, (0, 0, 256, 128), edges=edges(n, 185.0, 98.0, 30.0, 1.1)),
        h.clip(1, (130, 72, 240, 124), rest=(10,) * 8, mode=1.0),
        h.clip(0, (125.5, 75.5, 245.5, 121.5))])
    return h


def unit_edges(n, cx, cy, r, phase=0.0):
    return tw.polygon_edges(regular_polygon(n, cx, cy, r, phase))


def _padded(args):
    rows = args["f32_rows"]
    args["f32_rows"] = torch.cat(
        [rows, torch.zeros((ROWS - rows.shape[0], 128))])
    return args


def _port(h, mask_clips=None):
    """The port's plain version on hand frame `h` through its routing (with
    the dispatch's `mask_clips` replaced), and the Pallas kernel's inputs."""
    args, kw, gen = port_inputs(h)
    assert kw["polygon_clips"] and not gen.any()
    args = _padded(args)
    if mask_clips is not None:
        kw["mask_clips"] = mask_clips
    assert tr.instantiation(**kw) == "general"
    before = tr.LaunchCounts.plain_calls
    got = tr.render_tiles_dense(*tw.positional(args), **kw)
    assert tr.LaunchCounts.plain_calls == before + 1
    return got.numpy(), tw.pallas_args(args), kw


@pytest.mark.parametrize("n", range(3, 9))
def test_polygon_clip_equals_the_pallas_kernel(n):
    h = polygon_frame(n)
    got, pargs, kw = _port(h)
    want = tw.run_pallas(pargs, kw["kinds"], kw["blends"], kw["mask_clips"])
    np.testing.assert_array_equal(got, want)
    assert _u8_steps(got, oracle_tiles(h)) == (0, 0.0)
    # each polygon clips: with the clips' kinds made rects (the same rect,
    # the whole target) the tiles differ
    f32 = np.concatenate(h.rows)
    unclipped = h.arrays
    rows = f32.reshape(-1, 128).copy()
    rows[rows[:, 14] == 3.0, 14] = 0.0
    h.arrays = lambda: (rows.reshape(-1),) + unclipped()[1:]
    args, kw0, _ = port_inputs(h)
    plain = tr.render_tiles_dense(*tw.positional(args), **kw0).numpy()
    assert (np.abs(plain - got) > 0).any((1, 2, 3)).all()


def test_unit_half_planes_equal_the_oracle():
    """The frame builder's half-planes (unit normals, rounded from
    float64): bitwise against the numpy oracle, which does not contract;
    the interpret kernel, which does, at most `UNIT_FMA_VALUES` values a
    step apart."""
    h = polygon_frame(7, unit_edges)
    got, pargs, kw = _port(h)
    assert _u8_steps(got, oracle_tiles(h)) == (0, 0.0)
    want = tw.run_pallas(pargs, kw["kinds"], kw["blends"], kw["mask_clips"])
    n, worst = _u8_steps(got, want)
    assert n <= UNIT_FMA_VALUES and worst <= 1.0, (n, worst)


def mask_kinds_frame(polygon_kinds=(2, 4)):
    """An image-mask clip (kind 2) and a box-shadow nine-patch clip (kind
    4), axis-aligned and inside the TPU kernel's windows, whose records
    also hold polygon half-planes, beside a polygon clip; `polygon_kinds`
    says which of the two records carry their own kind (the others say
    3)."""
    h = tw.HandFrame(ORIGINS, atlas_hw=(256, 1024), block=4)
    h.prim(0, _solid((0, 0, 256, 128), (0.9, 0.9, 0.8, 1.0)))
    k2, k4 = (k if k in polygon_kinds else 3 for k in (2, 4))
    h.prim(0, _solid((200, 4, 250, 44), (0.2, 0.2, 0.8, 1.0)), clips=[
        h.clip(k2, (200, 4, 250, 44), uv=(400, 20, 450, 60),
               edges=dyadic_edges(5, 225.0, 24.0, 18.0))])
    h.prim(0, _solid((10, 60, 110, 120), (0.1, 0.3, 0.1, 0.6)), clips=[
        h.clip(k4, (10, 60, 110, 120), rest=(50, 40, 1, 0), mode=1.0,
               uv=(300, 20, 350, 60), edges=dyadic_edges(6, 60.0, 90.0,
                                                         28.0))])
    h.prim(0, _solid((100, 10, 180, 110), (0.7, 0.3, 0.2, 1.0)), clips=[
        h.clip(3, (0, 0, 256, 128), edges=dyadic_edges(8, 140.0, 60.0,
                                                        45.0))])
    return h


@pytest.mark.parametrize("mask_clips", [False, True],
                         ids=["polygons", "masks"])
def test_mask_kinds_without_mask_clips_read_as_polygons(mask_clips):
    """Without `mask_clips` the kinds 2 and 4 draw their records' polygons
    (as if the records said 3); with it their masks.  Both equal the
    Pallas kernel with the same flag, bitwise."""
    h = mask_kinds_frame()
    got, pargs, kw = _port(h, mask_clips)
    want = tw.run_pallas(pargs, kw["kinds"], kw["blends"], mask_clips)
    np.testing.assert_array_equal(got, want)
    as_polygons, _, kw3 = _port(mask_kinds_frame(()))
    assert not kw3["mask_clips"]
    assert np.array_equal(got, as_polygons) == (not mask_clips)


def general_frame():
    """A rotated image in every tile (all four general) beside polygon
    clips with the frame builder's half-planes: a solid under a pentagon,
    an inverted hexagon, a rotated image under a triangle, and an
    axis-aligned image-mask clip, which a general tile reads as a mask."""
    h = tw.HandFrame(ORIGINS, atlas_hw=(256, 1024), block=4)
    r30 = h.transform(tw.rotation_row(30.0, 90.3, 20.6))
    h.prim(0, _solid((0, 0, 512, 256), (0.9, 0.9, 0.8, 1.0)))
    h.prim(1, _image((0, 0, 80, 60), (260, 20, 340, 80)), r30, clips=[
        h.clip(3, (0, 0, 512, 256), edges=unit_edges(3, 80.0, 50.0, 45.0,
                                                     0.2))])
    h.prim(0, _solid((100, 10, 250, 120), (0.2, 0.4, 0.8, 1.0)), clips=[
        h.clip(3, (0, 0, 512, 256), edges=unit_edges(5, 170.0, 62.0, 50.0,
                                                     0.4))])
    h.prim(0, _solid((20, 70, 120, 126), (0.6, 0.2, 0.4, 0.8)), clips=[
        h.clip(3, (0, 0, 512, 256), invert=1.0,
               edges=unit_edges(6, 70.0, 98.0, 22.0))])
    h.prim(0, _solid((200, 4, 250, 44), (0.1, 0.5, 0.3, 1.0)), clips=[
        h.clip(2, (200, 4, 250, 44), uv=(400, 20, 450, 60))])
    return h


@pytest.mark.parametrize("step", [1.0, 2.0])
def test_general_tile_polygons_equal_the_oracle(step):
    """The per-pixel clip chain of general tiles (`clip_coverage`), at raster
    steps 1 and 2: the numpy oracle's values bitwise, `render_tiles` on
    XLA within `XLA_STEPS[step]` values of one step."""
    h = general_frame()
    h.origins = np.asarray(ORIGINS, np.float32) * step
    args, kw, gen = port_inputs(h, step)
    assert gen.all() and kw["general"] and kw["polygon_clips"]
    assert kw["mask_clips"] and tr.instantiation(**kw) == "general"
    got = tr.render_tiles_dense(*tw.positional(args), **kw).numpy()
    assert _u8_steps(got, oracle_tiles(h, step)) == (0, 0.0)
    n, worst = _u8_steps(got, jax_tiles(h, kw["kinds"], kw["blends"], step))
    assert n <= XLA_STEPS[step] and worst <= 1.0, (n, worst)
    # the triangle clips the rotated image: it draws less than unclipped
    assert (np.abs(got - CLEAR[None, :, None, None]) > 0).any((1, 2, 3)).all()


def test_polygon_records_carry_the_frame_builders_half_planes():
    """`polygon_edges` (the hand frames' half-planes) is the frame
    builder's `_polygon_clip_record`: the same 24 values, in float64, for
    polygons of 3 to 8 points; a polygon of more than 8 points has no
    record (the fragment is drawn unclipped)."""
    from webrender_tpu_torch.frame.frame_builder import FrameBuilder
    builder = FrameBuilder.__new__(FrameBuilder)
    builder.palette = [tw.IDENTITY_TROW]
    for n in range(3, 9):
        poly = regular_polygon(n, 300.5, 200.25, 90.0, 0.1 * n)
        rec = builder._polygon_clip_record(poly)
        assert rec[14] == 3.0 and rec[24:48] == tw.polygon_edges(poly)
    assert builder._polygon_clip_record(regular_polygon(9, 0, 0, 5)) is None


# --- on the card -------------------------------------------------------------

def _cuda_case(name):
    if name == "general-step2":
        h = general_frame()
        h.origins = np.asarray(ORIGINS, np.float32) * 2.0
        return h, None, 2.0
    if name.startswith("mask"):
        return mask_kinds_frame(), name == "mask-kinds-masks", 1.0
    if name == "general":
        return general_frame(), None, 1.0
    return polygon_frame(int(name[-1]),
                         unit_edges if "unit" in name else dyadic_edges), \
        None, 1.0


CUDA_CASES = ["edges-3", "edges-8", "unit-edges-7", "mask-kinds-polygons",
              "mask-kinds-masks", "general", "general-step2"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CUDA_CASES)
def test_cuda_polygon_kernel_equals_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h, mask_clips, step = _cuda_case(name)
    args, kw, _ = port_inputs(h, step, device="cuda")
    if mask_clips is not None:
        kw["mask_clips"] = mask_clips
    before = tr.LaunchCounts.launches
    got = tr.render_tiles_dense(*tw.positional(args), host_checked=True,
                                **kw)
    assert tr.LaunchCounts.launches == before + 1
    assert tr.LaunchCounts.by_instantiation["general"] >= 1
    want = tr.render_tiles_dense_plain(
        *tw.positional(args), kinds=kw["kinds"], blends=kw["blends"],
        mask_clips=kw["mask_clips"], step=step)
    assert float((got - want).abs().max()) == 0.0
