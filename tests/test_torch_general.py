"""The general tiles' branches on hand-built frames (`torch_twin.HandFrame`).

A tile that lists an instance without a path in the TPU kernel is a
general tile: the JAX renderer draws all of it with `render_tiles`
(`webrender_tpu/ops/raster.py`), the port with the per-pixel branches of
its one kernel, chosen through the dense records (`ops/dense.py`).  Each
case goes through the port's routing (`pallas_supported`,
`build_dense_records`, `dense_dispatch_info`) and its plain version, and
is held

* against the JAX package's numpy oracle
  (`oracle/sw.py::SoftwareRenderer._raster`: the package's `patterns` and
  `blend` math run by numpy) at 0 u8 steps, on every value, and
* against `render_tiles` jitted for the CPU, where XLA contracts
  multiply-adds and rewrites divisions: at most `XLA_STEPS[case]` values
  may differ, each by one u8 step, in a video by `XLA_WORST` (the
  measured counts are in the table: the most over the cases that share
  an entry).

One branch group per case, so that `render_tiles` compiles a small kind
set each time.  On the card (`-m cuda`) the kernel equals the plain
version on every one of these inputs.
"""
import numpy as np
import pytest
import torch

import torch_twin as tw

from webrender_tpu_torch.ops import dense as dm
from webrender_tpu_torch.ops import tile_raster as tr

CLEAR = np.array([0.2, 0.4, 0.6, 1.0], np.float32)
ORIGINS = ((0.0, 0.0), (128.0, 0.0), (0.0, 64.0), (128.0, 64.0))


def _image(rect, uv, tint=(1, 1, 1, 1), nearest=0.0, stretch=None,
           spacing=(0, 0), crop=(0, 0), cover=None):
    p = np.zeros(64, np.float32)
    p[0:4] = rect
    p[4:8] = cover or rect
    p[8:12] = uv
    p[12:16] = tint
    p[16] = nearest
    w, h = rect[2] - rect[0], rect[3] - rect[1]
    sw, sh = stretch or (w, h)
    p[18:20] = (sw, sh)
    p[20:22] = spacing
    p[22:24] = ((uv[2] - uv[0]) / sw, (uv[3] - uv[1]) / sh)
    p[24:26] = crop
    return p


def _solid(rect, color):
    p = np.zeros(64, np.float32)
    p[0:4] = rect
    p[4:8] = rect
    p[8:12] = color
    return p


def _glyph(rect, uv, color):
    p = np.zeros(64, np.float32)
    p[0:4] = rect
    p[4:8] = rect
    p[8:12] = uv
    p[12:16] = color
    return p


# --- the cases ---------------------------------------------------------------

def rotated_images():
    """Images under a 30 degree rotation and a -4 degree one with a skew:
    plain, tinted, a repeat with spacing, nearest, a crop origin; and an
    axis-aligned image in the same tiles (general by its neighbours)."""
    h = tw.HandFrame(ORIGINS)
    r30 = h.transform(tw.rotation_row(30.0, 90.3, 20.6))
    r4 = h.transform(tw.rotation_row(-4.0, 40.5, 70.25, skew=0.1))
    h.prim(0, _solid((0, 0, 512, 256), (0.9, 0.9, 0.8, 1.0)))
    h.prim(1, _image((0, 0, 80, 60), (260, 20, 340, 80)), r30)
    h.prim(1, _image((20, 10, 100, 40), (300, 100, 340, 115),
                     tint=(0.8, 0.6, 0.4, 0.8)), r4)
    h.prim(1, _image((-30, 40, 120, 90), (400, 30, 432, 62),
                     stretch=(32, 32), spacing=(6, 4)), r30)
    h.prim(1, _image((100, -20, 160, 10), (270, 120, 290, 130), nearest=1.0),
           r4)
    h.prim(1, _image((10, 5, 74, 37), (280, 40, 344, 72), crop=(8, 4)), r4,
           blend=0, edge_aa=0)
    h.prim(1, _image((150.5, 70.25, 230.5, 110.25), (20, 20, 60, 40)))
    return h, (0, 1), (0,)


def thumbnails_and_repeats():
    """Axis-aligned, and still outside the TPU kernel's window: a
    thumbnail at 4.27 texels a pixel, a 320-texel pattern repeated 1:1 and
    one repeat with spacing."""
    h = tw.HandFrame(ORIGINS, atlas_hw=(256, 1024), block=4)
    h.prim(1, _image((4.5, 3.25, 184.5, 50.25), (100, 20, 868, 220.5)))
    h.prim(1, _image((0, 60, 256, 128), (520, 10, 840, 110),
                     stretch=(320, 100)))
    h.prim(1, _image((190, 0, 256, 58), (600, 120, 900, 150),
                     stretch=(30, 10), spacing=(4, 3),
                     tint=(0.6, 0.6, 0.6, 0.6)))
    return h, (1,), (0,)


def rotated_text():
    """Grayscale and subpixel glyphs under rotations, the subpixel ones as
    the blend 7 and 8 pair; 1:1 translated glyphs beside them (on the
    translation fast path in any other tile), one with its uv rect at the
    atlas origin, one at its far corner.  Tints are fifths (no exact half
    in `texel * tint`)."""
    h = tw.HandFrame(ORIGINS)
    r = h.transform(tw.rotation_row(12.0, 30.3, 10.6))
    r2 = h.transform(tw.rotation_row(-20.0, 150.5, 90.25, scale=1.5))
    t1 = h.transform(tw.rotation_row(0.0, 3.3, 66.6))
    t2 = h.transform(tw.rotation_row(0.0, 200.7, 20.2))
    h.prim(5, _glyph((0, 0, 40, 30), (131, 57, 171, 87),
                     (0.2, 0.6, 0.4, 0.8)), r)
    h.prim(10, _glyph((50, 0, 90, 30), (300, 57, 340, 87),
                      (0.8, 0.8, 0.8, 0.8)), r, blend=7)
    h.prim(10, _glyph((50, 0, 90, 30), (300, 57, 340, 87),
                      (0.2, 0.2, 0.4, 0.8)), r, blend=8)
    h.prim(5, _glyph((0, 0, 20, 15), (131, 57, 171, 87),
                     (0.6, 0.4, 0.2, 1.0)), r2)
    h.prim(10, _glyph((-30, 0, -10, 15), (300, 57, 340, 87),
                      (0.4, 0.2, 0.6, 1.0)), r2)
    h.prim(5, _glyph((0, 0, 40, 30), (0, 0, 40, 30),
                     (0.2, 0.6, 0.4, 0.8)), t1)
    h.prim(10, _glyph((0, 0, 40, 30), (472, 162, 512, 192),
                      (0.6, 0.4, 0.2, 1.0)), t2)
    return h, (5, 10), (0, 7, 8)


GRAY = (0.2, 0.7, 0.1, 0, 0.0,  0.2, 0.7, 0.1, 0, 0.0,
        0.2, 0.7, 0.1, 0, 0.0,  0, 0, 0, 0.8, 0.1)


def rotated_pictures():
    """Picture composites under rotations: by device position and in the
    raster-root local mode, with the color matrix off and on (flag 1)."""
    h = tw.HandFrame(ORIGINS)
    r = h.transform(tw.rotation_row(15.0, 60.3, 10.6))
    r2 = h.transform(tw.rotation_row(-8.0, 20.5, 70.25, scale=0.8))

    def pic(rect, uv, flag=0.0, local=None, tint=(0.6, 0.6, 0.6, 0.6)):
        p = np.zeros(64, np.float32)
        p[0:4] = rect
        p[4:8] = rect
        p[8:12] = uv
        p[12:16] = tint
        p[16:36] = GRAY
        p[36] = flag
        if local is not None:
            p[37:41] = (1.0,) + local
        return p
    h.prim(0, _solid((0, 0, 256, 128), (0.9, 0.9, 0.8, 1.0)))
    # device mode: the rect [0:4] is in device space
    h.prim(6, pic((40, 10, 160, 70), (20, 30, 140, 90)), r)
    h.prim(6, pic((100, 60, 220, 120), (150, 40, 270, 100), flag=1.0), r2)
    # local mode: u = u0 + lx * scale - origin
    h.prim(6, pic((0, 0, 90, 40), (300, 20, 435, 80), local=(3.0, 2.0, 1.5),
                  tint=(1, 1, 1, 1)), r)
    h.prim(6, pic((10, 10, 70, 50), (310, 100, 370, 140), flag=1.0,
                  local=(10.0, 10.0, 1.0)), r2)
    return h, (0, 6), (0,)


def rotated_video(space="rec709", full_range=False):
    """A planar video under a rotation, its chroma planes at half size
    (the frame builder's payload, `test_torch_zoom.yuv_payload`), and an
    axis-aligned one beside it."""
    from test_torch_zoom import yuv_payload
    h = tw.HandFrame(ORIGINS, block=2)
    r = h.transform(tw.rotation_row(-6.0, 20.3, 30.6))
    h.prim(12, yuv_payload(space, full_range, (0, 0, 200, 80)), r)
    h.prim(12, yuv_payload(space, full_range,
                           (180.5, 90.25, 250.5, 125.25), nearest=1.0))
    return h, (12,), (0,)


def _rainbow(n):
    stops = []
    for i in range(n):
        a = 1.0 if i % 5 else 0.6
        c = (0.5 + 0.5 * np.cos(i * 1.3), 0.5 + 0.5 * np.cos(i * 2.1 + 1),
             0.5 + 0.5 * np.cos(i * 0.7 + 2))
        stops.append((i / (n - 1.0), c[0] * a, c[1] * a, c[2] * a, a))
    return stops


def long_gradients():
    """20- and 24-stop gradients, linear, radial and conic, clamped and
    repeating (one repeating with a hard stop), axis-aligned and rotated;
    and a 3-stop one beside them."""
    h = tw.HandFrame(ORIGINS)
    r = h.transform(tw.rotation_row(10.0, 130.3, 5.6))

    def grad(rect, geom, n, repeat, stretch=None, offsets=None, hard=False):
        st = _rainbow(n)
        if hard:
            st[7] = (st[6][0],) + st[7][1:]
        p = np.zeros(64, np.float32)
        p[0:4] = rect
        p[4:8] = rect
        p[8:8 + len(geom)] = geom
        p[12] = h.stops(st)
        p[13] = repeat
        p[14] = n
        w, hh = rect[2] - rect[0], rect[3] - rect[1]
        if offsets is None:          # linear: stretch [16:18], spacing [18:20]
            p[16:18] = stretch or (w, hh)
        else:
            p[16:18] = offsets
            p[18:20] = stretch or (w, hh)
        return p
    h.prim(2, grad((4, 4, 124, 34), (0, 0, 120, 10), 24, 0.0))
    h.prim(2, grad((0, 0, 100, 30), (0, 0, 30, 8), 20, 1.0, hard=True), r)
    h.prim(3, grad((4, 40, 124, 120), (60, 40, 50, 30), 20, 0.0,
                   offsets=(0.0, 1.0)))
    h.prim(3, grad((0, 40, 100, 100), (50, 30, 12, 12), 24, 1.0,
                   offsets=(0.1, 0.9)), r)
    h.prim(4, grad((132, 70, 192, 124), (30, 27, 0.3), 20, 0.0,
                   offsets=(0.0, 1.0)))
    h.prim(4, grad((196, 70, 252, 124), (28, 27, 1.1), 24, 1.0,
                   offsets=(0.0, 0.5), hard=True))
    h.prim(2, grad((132, 40, 252, 66), (0, 0, 120, 0), 3, 0.0))
    return h, (2, 3, 4), (0,)


def mask_clips():
    """Solids under an image-mask clip and box-shadow nine-patch clips
    (outset, inset with both stretch modes) whose own transform is a
    rotation; an axis-aligned mask whose source passes the window; a
    rounded clip under the rotation; and an axis-aligned mask clip on a
    neighbour (sampled per pixel in a general tile)."""
    h = tw.HandFrame(ORIGINS, atlas_hw=(256, 1024), block=4)
    r = h.transform(tw.rotation_row(8.0, 20.3, 10.6))
    r2 = h.transform(tw.rotation_row(-5.0, 140.5, 60.25))
    red = (0.8, 0.2, 0.1, 1.0)
    h.prim(0, _solid((0, 0, 256, 128), (0.9, 0.9, 0.8, 1.0)))
    h.prim(0, _solid((0, 0, 96, 96), red), r, clips=[
        h.clip(2, (0, 0, 96, 96), r, uv=(20, 20, 116, 116))])
    h.prim(0, _solid((-20, -20, 120, 80), (0.1, 0.1, 0.3, 0.5)), r2, clips=[
        h.clip(4, (-20, -20, 120, 80), r2, rest=(60, 60, 1, 1), mode=0.0,
               uv=(200, 20, 260, 80)),
        h.clip(1, (-10, -10, 110, 70), r2, rest=(12,) * 8, mode=1.0)])
    h.prim(0, _solid((0, 0, 100, 60), (0.1, 0.3, 0.1, 0.6)), r2, clips=[
        h.clip(4, (0, 0, 100, 60), r2, rest=(50, 40, 1, 0), mode=1.0,
               uv=(300, 20, 350, 60))])
    # axis-aligned, 900 texels over 180 px: passes the window
    h.prim(0, _solid((60.5, 100.25, 240.5, 126.25), red), clips=[
        h.clip(2, (60.5, 100.25, 240.5, 126.25), 0, uv=(40, 130, 940, 250))])
    # axis-aligned and inside the window: supported, a neighbour here
    h.prim(0, _solid((200, 4, 250, 44), (0.2, 0.2, 0.8, 1.0)), clips=[
        h.clip(2, (200, 4, 250, 44), 0, uv=(400, 20, 450, 60))])
    return h, (0,), (0,)


CASES = {"rotated_images": rotated_images,
         "thumbnails_and_repeats": thumbnails_and_repeats,
         "rotated_text": rotated_text,
         "rotated_pictures": rotated_pictures,
         "rotated_video": rotated_video,
         "long_gradients": long_gradients,
         "mask_clips": mask_clips}
# values of one dispatch that may differ from `render_tiles` on XLA's CPU
# build, each by one u8 step (measured: the comment beside each)
XLA_STEPS = {"rotated_images": 0, "thumbnails_and_repeats": 0,
             "rotated_text": 3, "rotated_pictures": 2, "rotated_video": 8,
             "long_gradients": 7, "mask_clips": 9}
# a video's `u = u0 + lx * scale` is a multiply-add: contracted, u moves by
# an ulp and may cross a 7-bit fraction step, which the matrix's gain
# turns into up to 4 u8 steps (never a shifted texel); 1 elsewhere
XLA_WORST = {"rotated_video": 4.0}
# the same against the numpy oracle: its nine-patch clip runs in float64
# (numpy's `where` of two Python floats), so the inset nine-patch of
# `mask_clips` differs in 10 values of one step;
# `test_general_clip_chain_equals_clip_coverage` holds that chain bitwise
# against the JAX package's `clip_coverage` kept in float32
ORACLE_STEPS = {"mask_clips": 10}


# --- the three renders -------------------------------------------------------

def port_inputs(h, step=1.0, device="cpu"):
    """The port's routing of a hand frame: (kernel arguments as tensors,
    dispatch keywords, general tiles)."""
    f32, inst, xf, ti = [torch.from_numpy(a) for a in h.arrays()]
    ok = dm.pallas_supported(f32, inst, xf)
    dk = dm.classify_dense_kinds(f32, inst, xf)
    all_general = step != 1.0
    dense = dm.build_dense_records(f32, inst, xf, ti, dk, ok, all_general)
    kinds, blends, mask_clips, general, polygons = dm.dense_dispatch_info(
        f32, inst, ti, dk, ok, all_general)
    assert dm.check_pass_records(f32, inst, ti)[1] == polygons
    args = dict(dense=dense, counts=(ti >= 0).sum(1).to(torch.int32),
                origins=torch.from_numpy(h.origins),
                clear=torch.from_numpy(CLEAR), f32_rows=f32.reshape(-1, 128),
                alpha_atlas=torch.from_numpy(h.alpha_atlas),
                surface_atlas=torch.from_numpy(h.surface_atlas),
                color_atlas=torch.from_numpy(h.color_atlas))
    args = {k: v.to(device) for k, v in args.items()}
    kw = dict(kinds=kinds, blends=blends, mask_clips=mask_clips,
              general=general, step=step, polygon_clips=polygons)
    return args, kw, dm.general_tiles(ti, ok) | all_general


def port_tiles(h, step=1.0, init=None):
    args, kw, gen = port_inputs(h, step)
    before = tr.LaunchCounts.plain_calls
    out = tr.render_tiles_dense(
        *tw.positional(args), None if init is None else
        torch.from_numpy(init), host_checked=True, **kw)
    assert tr.LaunchCounts.plain_calls == before + 1
    return out.numpy(), gen.numpy()


def jax_tiles(h, kinds, blends, step=1.0, init=None):
    """`render_tiles` on the hand frame, jitted for the CPU."""
    import jax.numpy as jnp
    from webrender_tpu.ops.raster import render_tiles
    f32, inst, xf, ti = h.arrays()
    clear = CLEAR if init is None else init
    return np.asarray(render_tiles(
        jnp.asarray(f32), jnp.asarray(inst), jnp.asarray(xf),
        jnp.asarray(ti), jnp.asarray(h.origins), jnp.asarray(clear),
        jnp.asarray(h.color_atlas), jnp.asarray(h.alpha_atlas),
        jnp.asarray(h.surface_atlas), kinds=kinds, blends=blends,
        step=step))


def oracle_tiles(h, step=1.0, init=None):
    return tw.oracle_tiles(h, CLEAR, step, init)


def _u8_steps(a, b):
    """(values that differ on the u8 grid, the largest difference in u8
    steps)."""
    d = np.abs(np.rint(a * 255.0) - np.rint(b * 255.0))
    return int((d > 0).sum()), float(d.max())


def _hold(h, kinds, blends, name, step=1.0, init=None):
    got, gen = port_tiles(h, step, init)
    # the oracle's numpy math passes through float64 here and there: its
    # tiles are held on the u8 grid, where both lie
    want = oracle_tiles(h, step, init)
    n, worst = _u8_steps(got, want)
    assert n <= ORACLE_STEPS.get(name, 0) and worst <= 1.0, (n, worst)
    xla = jax_tiles(h, kinds, blends, step, init)
    n, worst = _u8_steps(got, xla)
    assert n <= XLA_STEPS[name] and worst <= XLA_WORST.get(name, 1.0), \
        (n, worst)
    assert gen.all()        # every tile lists an unsupported instance
    # the instances drew
    assert (np.abs(got - CLEAR[None, :, None, None]) > 0).any((1, 2, 3)).all()
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_general_branch_equals_oracle_and_render_tiles(name):
    h, kinds, blends = CASES[name]()
    _hold(h, kinds, blends, name)


@pytest.mark.parametrize("space,full_range", [
    ("rec601", False), ("rec601", True), ("rec709", True),
    ("identity", False), ("identity", True)])
def test_rotated_video_color_spaces(space, full_range):
    h, kinds, blends = rotated_video(space, full_range)
    _hold(h, kinds, blends, "rotated_video")


_Numpy32 = tw.Numpy32


def test_general_clip_chain_equals_clip_coverage():
    """Each clip record of `mask_clips` alone: the general clip chain's u8
    mask (or, for a rect clip, its coverage) equals
    `patterns.clip_coverage` of the JAX package run by numpy in float32,
    bitwise, on every pixel of the four tiles."""
    import webrender_tpu.ops.blend as jbl
    import webrender_tpu.ops.patterns as jpk
    h, _, _ = mask_clips()
    f32, inst, xf, ti = h.arrays()
    rows = torch.from_numpy(f32.reshape(-1, 128))
    px, py = tr.tile_pixels(torch.from_numpy(h.origins))
    n32 = _Numpy32()
    seen = 0
    for rec in inst:
        for j in range(rec[4]):
            crow = rec[3] // 128 + j
            drec = torch.zeros(128, 4, 1, 1)
            drec[dm.REC_CLIP_COUNT] = 1.0
            drec[dm.REC_CLIP_ROW] = float(crow)
            cov, mcov = tr._clip_chain(
                drec, px, py, rows, torch.ones_like(px),
                torch.from_numpy(h.color_atlas[0:1]), general=True)
            crec = f32[crow * 128:(crow + 1) * 128]
            want = jpk.clip_coverage(n32, crec, xf, px.numpy(), py.numpy(),
                                     h.color_atlas[0],
                                     lambda t, idx: t[int(idx)])
            assert want.dtype == np.float32
            c8 = jbl.quantize_cov(np, want, np.float32(255.0))
            assert np.array_equal(np.rint(mcov.numpy() * 255.0), c8)
            assert float(cov.min()) == 1.0
            seen += 1
    assert seen == 6


def test_general_kinds_are_routed_per_tile():
    """The same instances in a frame with a fifth, far tile that lists only
    supported ones: that tile keeps the TPU kernel's kinds and equals the
    Pallas kernel in interpret mode; the other four stay general."""
    h, kinds, blends = rotated_text()
    h.origins = np.concatenate([h.origins, [[1024.0, 0.0]]]).astype(np.float32)
    f32, inst, xf, ti = h.arrays()
    ti[4] = -1
    ti[4, :2] = (5, 6)         # the two translated glyphs
    h.arrays = lambda: (f32, inst, xf, ti)
    args, kw, gen = port_inputs(h)
    assert gen.tolist() == [True] * 4 + [False]
    kind = args["dense"][..., dm.REC_KIND]
    assert set(kind[:4][kind[:4] >= 0].tolist()) == {18.0, 20.0}
    assert kind[4, :2].tolist() == [5.0, 10.0]
    assert args["dense"][:4, :7, dm.REC_GENERAL].min() == 1.0
    assert args["dense"][4, :, dm.REC_GENERAL].max() == 0.0
    assert kw["kinds"] == (5, 10, 18, 20) and kw["general"]
    assert tr.instantiation(**kw) == "general"
    got = tr.render_tiles_dense(*tw.positional(args), host_checked=True,
                                **kw).numpy()
    # the supported tile alone, on the TPU kernel
    sub = {k: (v[4:5].numpy() if k in ("dense", "counts", "origins")
               else v.numpy()) for k, v in args.items()}
    want = tw.run_pallas(sub, (5, 10), blends, False)
    assert np.array_equal(got[4:5], want)


def test_a_supported_dispatch_keeps_its_instantiation():
    assert tr.instantiation((0, 2, 10, 13), (0, 7, 8), False) == "browsing"
    assert tr.instantiation((0, 7, 16), (0, 1), False) == "media"
    assert tr.instantiation((0,), (0,), False, general=True) == "general"
    assert tr.instantiation((0,), (0,), False, step=2.0) == "general"
    assert tr.instantiation((0, 19), (0,), False) == "general"


def test_wrapper_refuses_flags_that_contradict_the_records():
    """Records of a general tile need `general=True` (another build would
    not hold their branches), and a raster step needs every record
    general: the wrapper raises before any work."""
    h, _, _ = rotated_text()
    args, kw, _ = port_inputs(h)
    before = tr.LaunchCounts.plain_calls
    with pytest.raises(ValueError, match="REC_GENERAL"):
        tr.render_tiles_dense(*tw.positional(args),
                              **dict(kw, general=False))
    plain = dict(args, dense=args["dense"].clone())
    plain["dense"][..., dm.REC_GENERAL] = 0.0
    with pytest.raises(ValueError, match="raster step 2.0"):
        tr.render_tiles_dense(*tw.positional(plain),
                              **dict(kw, general=True, step=2.0))
    assert tr.LaunchCounts.plain_calls == before


# --- raster step -------------------------------------------------------------

@pytest.mark.parametrize("with_init", [False, True], ids=["clear", "init"])
def test_raster_step_two(with_init):
    """`render_tiles(step=2.0)`: a pass whose tiles cover 256x128 device
    pixels each; every tile is general, with `init_tiles` and without."""
    h, kinds, blends = rotated_images()
    h.origins = np.asarray(ORIGINS, np.float32) * 2.0
    init = None
    if with_init:
        init = tw.u8_planes(np.random.RandomState(9), (4, 64, 128)) \
            .transpose(1, 0, 2, 3).copy()
    _hold(h, kinds, blends, "rotated_images", step=2.0, init=init)


# --- on the card -------------------------------------------------------------

CUDA_CASES = sorted(CASES) + ["step2", "step2-init"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CUDA_CASES)
def test_cuda_general_kernel_equals_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    step, init = 1.0, None
    if name.startswith("step2"):
        h, _, _ = rotated_images()
        h.origins = np.asarray(ORIGINS, np.float32) * 2.0
        step = 2.0
        if name.endswith("init"):
            init = torch.from_numpy(tw.u8_planes(
                np.random.RandomState(9), (4, 64, 128))
                .transpose(1, 0, 2, 3).copy()).cuda()
    else:
        h, _, _ = CASES[name]()
    args, kw, _ = port_inputs(h, step, device="cuda")
    before = tr.LaunchCounts.launches
    got = tr.render_tiles_dense(*tw.positional(args), init,
                                host_checked=True, **kw)
    assert tr.LaunchCounts.launches == before + 1
    assert tr.LaunchCounts.by_instantiation["general"] >= 1
    want = tr.render_tiles_dense_plain(
        *tw.positional(args), init, kinds=kw["kinds"], blends=kw["blends"],
        mask_clips=kw["mask_clips"], step=step)
    assert float((got - want).abs().max()) == 0.0
