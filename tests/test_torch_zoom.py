"""The zoomed page's kernel branches against the Pallas kernel in
interpret mode, on hand-built dense records (`torch_twin.record`): the
port's plain version gives max diff 0 in each, except the video's matrix.

* Scaled text, `K_SEP_SUBPX` (the color atlas, drawn as the blend 7 and
  8 pair) and `K_SEP_GLYPH` (the alpha atlas): at page zooms 0.5 (a 2x
  minify), 0.8, 1.25 and 2.0, at fractional device offsets, with the uv
  rect in the atlas, at its origin and at its far corner, and under a
  transform whose off-diagonals are 5e-10.
* Video, `K_SEP_YUV`: REC601, REC709 and identity, limited and full
  range, with the payload's nearest flag set (which changes nothing: the
  TPU kernel does not read it).  The matrix rows are three-product sums,
  which XLA's CPU build of the interpret kernel may contract; the port
  keeps numpy's order, so it is held bitwise against the JAX package's
  `patterns.pattern_yuv` run by numpy, and against the interpret kernel
  at `YUV_TIES` values of one u8 step.
* Clear rects, `KIND_CLEAR` with blend op 1: alone, with fractional
  edges, under a rounded clip, over a seeded u8-grid backdrop (through
  `init_tiles`).
* On the card (`-m cuda`): the kernel equals the plain version on every
  one of these inputs.
"""
import numpy as np
import pytest
import torch

import torch_twin as tw

from webrender_tpu_torch.ops import patterns as pk
from webrender_tpu_torch.ops import tile_raster as tr
from webrender_tpu_torch.ops import xp

H, W = 192, 512     # the atlases: at least the TPU kernel's 136x384 window
ZOOMS = (0.5, 0.8, 1.25, 2.0)
# u8 values of one YUV dispatch (2 tiles) that may differ from the
# interpret kernel by one step (measured: 0 in every case here; a small
# zoomed frame at zoom 2.0 showed 2, tests/test_torch_zoom_frame.py)
YUV_TIES = 8


def _trow(zoom, tx, ty, shear=0.0):
    """The screen-to-local row of a page zoom and a device translation."""
    inv = 1.0 / zoom
    return (inv, shear, 0, shear, inv, 0, -tx * inv, -ty * inv, 1, zoom,
            zoom, 0)


def _atlases(seed):
    rng = np.random.RandomState(seed)

    def u8(shape):
        return (rng.randint(0, 256, shape) / 255.0).astype(np.float32)
    return dict(alpha_atlas=u8((H, W)), surface_atlas=u8((4, H, W)),
                color_atlas=u8((4, H, W)))


def _args(recs_by_tile, origins, seed=5, f32_rows=None):
    slots = max(len(r) for r in recs_by_tile)
    dense = np.zeros((len(recs_by_tile), slots, 128), np.float32)
    for t, recs in enumerate(recs_by_tile):
        for i, r in enumerate(recs):
            dense[t, i] = r
    rows = np.zeros((1, 128), np.float32) if f32_rows is None else f32_rows
    return dict(dense=dense,
                counts=np.array([len(r) for r in recs_by_tile], np.int32),
                origins=np.asarray(origins, np.float32),
                clear=np.array([0.2, 0.4, 0.6, 1.0], np.float32),
                f32_rows=rows, **_atlases(seed))


def _plain(args, kinds, blends, init=None):
    t = tw.to_torch(args)
    if init is not None:
        init = torch.from_numpy(init)
    before = tr.LaunchCounts.plain_calls
    out = tr.render_tiles_dense(*tw.positional(t), init, kinds=kinds,
                                blends=blends)
    assert tr.LaunchCounts.plain_calls == before + 1
    return out.numpy()


# --- scaled text -------------------------------------------------------------

def text_inputs(zoom, place="inside", shear=0.0):
    """Two tiles of scaled text at page zoom `zoom`: glyphs rastered at
    gscale = max(1, zoom), so a 40x30-texel uv rect is 40/gscale local
    px wide.  Each tile holds a subpixel glyph as its blend 7 and 8 pair,
    a grayscale glyph and a tinted subpixel glyph drawn with blend 0.
    The tints are fifths: a u8 texel times one never lands on an exact
    half, where XLA's CPU build of the interpret kernel may round the
    other way than numpy's order does (`ROADMAP.md` C)."""
    g = max(1.0, zoom)
    uw, uh = 40.0, 30.0
    u0, v0 = {"inside": (131.0, 57.0), "origin": (0.0, 0.0),
              "corner": (W - uw, H - uh)}[place]
    lw, lh = uw / g, uh / g
    tiles, origins = [], []
    for t, (ox, oy, tx, ty) in enumerate(((0.0, 0.0, 3.3, 2.6),
                                          (256.0, 64.0, 300.7, 70.2))):
        def rec(kind, blend, lx, ly, color, uv=(u0, v0)):
            pay = np.zeros(16, np.float32)
            pay[0:4] = (lx, ly, lx + lw, ly + lh)
            pay[4:8] = pay[0:4]
            pay[8:12] = (uv[0], uv[1], uv[0] + uw, uv[1] + uh)
            pay[12:16] = color
            return tw.record(kind, pay, blend=blend,
                             trow=_trow(zoom, tx, ty, shear))
        step = (uw + 6.0) / g
        tiles.append([
            rec(16, 7, 1.25, 0.5, (0.8, 0.8, 0.8, 0.8)),
            rec(16, 8, 1.25, 0.5, (0.08, 0.08, 0.12, 0.8)),
            rec(14, 0, 1.25 + step, 0.75, (0.2, 0.6, 0.4, 0.8)),
            rec(16, 0, 1.25 + 2 * step, 1.0, (0.6, 0.4, 0.2, 1.0)),
        ])
        origins.append((ox, oy))
    return _args(tiles, origins), (14, 16), (0, 7, 8)


TEXT_CASES = [(z, "inside", 0.0) for z in ZOOMS] + \
    [(z, p, 0.0) for z in (0.8, 2.0) for p in ("origin", "corner")] + \
    [(1.25, "inside", 5e-10), (2.0, "corner", 5e-10)]


def _case_id(case):
    return "-".join(str(c) for c in case)


@pytest.mark.parametrize("case", TEXT_CASES, ids=_case_id)
def test_scaled_text_equals_pallas(case):
    args, kinds, blends = text_inputs(*case)
    want = tw.run_pallas(args, kinds, blends, False)
    got = _plain(args, kinds, blends)
    assert np.abs(got - want).max() == 0.0
    # the glyphs drew: the tiles differ from the clear color
    assert (np.abs(got - args["clear"][None, :, None, None]) > 0).any((1, 2, 3)
                                                                      ).all()


def test_scaled_text_reads_the_tile_row_and_column():
    """u comes from the tile's first row of lx and v from its first column
    of ly: with a shear the TPU kernel admits (5e-10) the result equals the
    kernel's, and it is what an unsheared transform gives at these sizes
    (the first-row and per-row positions round to the same texels)."""
    sheared, kinds, blends = text_inputs(1.25, "inside", 5e-10)
    straight, _, _ = text_inputs(1.25, "inside", 0.0)
    a = _plain(sheared, kinds, blends)
    b = _plain(straight, kinds, blends)
    assert np.abs(a - b).max() <= 1.0 / 255.0 + 1e-7


# --- video -------------------------------------------------------------------

YUV_MATRICES = {"rec601": [1.0, 0.0, 0.70100, 1.0, -0.17207, -0.35707,
                           1.0, 0.88600, 0.0],
                "rec709": [1.0, 0.0, 0.78740, 1.0, -0.09366, -0.23406,
                           1.0, 0.92780, 0.0],
                "identity": [0.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0]}


def yuv_payload(space, full_range, rect, nearest=0.0):
    """The frame builder's `KIND_YUV` payload (`_prepare_yuv`) for a
    160x96 Y plane and 80x48 U and V planes at fixed atlas places, drawn
    over the local `rect`."""
    if space == "identity":
        zero, one = (0.0, 0.0), (1.0, 1.0)
    elif not full_range:
        zero = (16.0 / 255.0, 128.0 / 255.0)
        one = (235.0 / 255.0, 240.0 / 255.0)
    else:
        zero, one = (0.0, 128.0 / 255.0), (1.0, 1.0)
    sy = 1.0 / (one[0] - zero[0])
    sc = 1.0 / (one[1] - zero[1])
    m = YUV_MATRICES[space]
    mat = [m[i] * (sy if i % 3 == 0 else sc) for i in range(9)]
    x0, y0, x1, y1 = rect
    sw, sh = x1 - x0, y1 - y0
    yw, yh, cw, ch = 160.0, 96.0, 80.0, 48.0
    pay = np.zeros(39, np.float32)
    pay[0:4] = rect
    pay[4:8] = rect
    pay[8:12] = (7.0, 5.0, 7.0 + yw, 5.0 + yh)
    pay[12:16] = (200.0, 9.0, 200.0 + cw, 9.0 + ch)
    pay[16:20] = (300.0, 100.0, 300.0 + cw, 100.0 + ch)
    pay[20:26] = (sw, sh, yw / sw, yh / sh, cw / sw, ch / sh)
    pay[26] = nearest
    pay[27:36] = mat
    pay[36:39] = (zero[0], zero[1], zero[1])
    return pay


def yuv_inputs(space, full_range, nearest=0.0, zoom=1.25):
    """Two tiles crossed by one video drawn at 120x72 local px under a page
    zoom, at a fractional device offset."""
    pay = yuv_payload(space, full_range, (2.5, 1.25, 122.5, 73.25), nearest)
    rec = tw.record(17, pay, trow=_trow(zoom, 20.3, 6.6))
    return _args([[rec], [rec]], [(0.0, 0.0), (128.0, 0.0)], seed=9), \
        (17,), (0,)


YUV_CASES = [(s, f) for s in sorted(YUV_MATRICES) for f in (False, True)]


@pytest.mark.parametrize("case", YUV_CASES, ids=_case_id)
def test_yuv_equals_pallas_but_for_matrix_ties(case):
    args, kinds, blends = yuv_inputs(*case)
    want = tw.run_pallas(args, kinds, blends, False)
    got = _plain(args, kinds, blends)
    steps = np.rint(np.abs(got - want) * 255.0)
    assert steps.max() <= 1
    assert int((steps > 0).sum()) <= YUV_TIES
    assert (got[:, 3] == 1.0).any()  # the video drew, opaque
    # the payload's nearest flag changes nothing, in either package
    flagged, _, _ = yuv_inputs(*case, nearest=1.0)
    np.testing.assert_array_equal(_plain(flagged, kinds, blends), got)
    np.testing.assert_array_equal(tw.run_pallas(flagged, kinds, blends,
                                                False), want)


@pytest.mark.parametrize("case", YUV_CASES, ids=_case_id)
def test_yuv_pattern_equals_numpy(case):
    """The plain version's video color against the JAX package's
    `patterns.pattern_yuv` run by numpy (its order of operations, no
    contraction): bitwise."""
    from webrender_tpu.ops import patterns as jp
    args, _, _ = yuv_inputs(*case)
    t = tw.to_torch(args)
    rec = tr._cols(t["dense"][:, 0])
    px, py = tr.tile_pixels(t["origins"])
    lx, ly = pk.inverse_map(xp, rec[69:81], px, py)
    got = tr._sep_yuv(rec[0:64], lx, ly, t["alpha_atlas"]).numpy()
    for tile in range(2):
        want = jp.pattern_yuv(np, args["dense"][tile, 0, :64],
                              lx[tile].numpy(), ly[tile].numpy(),
                              args["alpha_atlas"])
        assert want.dtype == np.float32
        np.testing.assert_array_equal(got[:, tile], want)


# --- clear rects -------------------------------------------------------------

def clear_inputs(case):
    """One tile: a backdrop rect, then a clear rect (`KIND_CLEAR`, blend
    op 1): "plain" on whole pixels, "fractional" with fractional edges
    under a page zoom, "rounded" under a rounded-rect clip."""
    solid = np.zeros(12, np.float32)
    solid[0:4] = solid[4:8] = (0, 0, 128, 64)
    solid[8:12] = (0.6, 0.3, 0.1, 0.8)
    rect = {"plain": (20, 10, 90, 50), "fractional": (10.3, 5.6, 60.45, 33.2),
            "rounded": (16, 8, 100, 56)}[case]
    pay = np.zeros(12, np.float32)
    pay[0:4] = pay[4:8] = rect
    zoom = 1.25 if case == "fractional" else 1.0
    rows = np.zeros((2, 128), np.float32)
    kw = {}
    if case == "rounded":
        rows[1, 0:4] = rect
        rows[1, 4:12] = 14.0
        rows[1, 14] = 1.0   # rounded rect
        rows[1, 15] = 1.0   # uniform radii
        rows[1, 96:108] = tw.IDENTITY_TROW
        kw = dict(clip_row=1, clip_count=1)
    recs = [tw.record(0, solid),
            tw.record(7, pay, blend=1, trow=_trow(zoom, 0.0, 0.0), **kw)]
    return _args([recs], [(0.0, 0.0)], f32_rows=rows), (0, 7), (0, 1)


@pytest.mark.parametrize("case", ["plain", "fractional", "rounded"])
def test_clear_rect_equals_pallas(case):
    args, kinds, blends = clear_inputs(case)
    want = tw.run_pallas(args, kinds, blends, False)
    got = _plain(args, kinds, blends)
    assert np.abs(got - want).max() == 0.0
    assert (got[0, 3] == 0.0).any()          # punched through
    assert (got[0, 3] > 0.7).any()           # the backdrop around it
    if case != "plain":
        part = (got[0, 3] > 0.0) & (got[0, 3] < 0.7)
        assert part.any()                    # an edge scales the punch


def test_clear_rect_over_a_u8_backdrop_equals_pallas():
    """The clear rect alone over seeded premultiplied u8 pixels
    (`init_tiles`): `d - mul255(d, alpha(s))` on every value."""
    import jax.numpy as jnp
    from webrender_tpu.ops.pallas import tile_raster as jt
    args, _, _ = clear_inputs("fractional")
    args["dense"] = args["dense"][:, 1:]
    args["counts"][:] = 1
    init = tw.u8_planes(np.random.RandomState(11), (1, 64, 128)) \
        .transpose(1, 0, 2, 3).copy()
    a = {k: jnp.asarray(v) for k, v in args.items()}
    want = np.asarray(jt.render_tiles_pallas_dense(
        a["dense"], a["counts"], a["origins"], a["clear"], a["f32_rows"],
        a["alpha_atlas"], a["surface_atlas"], a["color_atlas"],
        jnp.asarray(init), kinds=(7,), blends=(1,), interpret=True))
    got = _plain(args, (7,), (1,), init)
    assert np.abs(got - want).max() == 0.0
    assert (got != init).any() and (got == init).any()


# --- on the card -------------------------------------------------------------

CUDA_CASES = [("text",) + c for c in TEXT_CASES] + \
    [("yuv",) + c for c in YUV_CASES] + \
    [("clear", c) for c in ("plain", "fractional", "rounded")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=_case_id)
def test_kernel_equals_plain_on_the_card(cuda_device, case):
    make = {"text": text_inputs, "yuv": yuv_inputs, "clear": clear_inputs}
    args, kinds, blends = make[case[0]](*case[1:])
    t = tw.to_torch(args, cuda_device)
    before = tr.LaunchCounts.launches
    out = tr.render_tiles_dense(*tw.positional(t), kinds=kinds,
                                blends=blends)
    assert tr.LaunchCounts.launches == before + 1
    assert tr.instantiation(kinds, blends, False) == "media"
    ref = tr.render_tiles_dense_plain(*tw.positional(t), kinds=kinds,
                                      blends=blends)
    assert float((out - ref).abs().max()) == 0.0
    cpu = tr.render_tiles_dense_plain(*tw.positional(tw.to_torch(args)),
                                      kinds=kinds, blends=blends)
    assert float((out.cpu() - cpu).abs().max()) == 0.0


# --- NV12: the host-side plane split ----------------------------------------

def test_nv12_video_matches_planar():
    """The port twin of `tests/test_yuv.py::test_yuv_nv12_matches_planar`:
    an NV12 video (a Y plane and one interleaved RG8 chroma plane, split
    into planar U and V at upload by `resources/resource_cache.py`)
    renders what the same planes render as three R8 images, through the
    port's kernel branch for `K_SEP_YUV`; and both equal the JAX package's
    numpy oracle of the NV12 scene."""
    from test_yuv import _build_yuv_scene
    from webrender_tpu.api.display_item import ColorRange, YuvColorSpace
    from webrender_tpu.api.image import ImageDescriptor, ImageFormat
    from webrender_tpu.render_backend import RenderBackend as JaxBackend
    from webrender_tpu_torch.render_backend import RenderBackend
    size, half = 32, 16
    rng = np.random.RandomState(7)
    y = rng.randint(0, 256, (size, size)).astype(np.uint8)
    u = rng.randint(0, 256, (half, half)).astype(np.uint8)
    v = rng.randint(0, 256, (half, half)).astype(np.uint8)
    planar = {1: (ImageDescriptor(ImageFormat.R8, size, size), y),
              2: (ImageDescriptor(ImageFormat.R8, half, half), u),
              3: (ImageDescriptor(ImageFormat.R8, half, half), v)}
    nv12 = {1: (ImageDescriptor(ImageFormat.R8, size, size), y),
            2: (ImageDescriptor(ImageFormat.RG8, half, half),
                np.stack([u, v], -1))}
    images = {}
    for fmt, keys in (("planar", planar), ("nv12", nv12)):
        port = RenderBackend((64, 64), device="cpu")
        _build_yuv_scene(tw.PortFeed(port), fmt, keys, YuvColorSpace.REC709,
                         ColorRange.LIMITED)
        port.renderer.dispatch_log = log = []
        images[fmt] = port.render()
        assert 17 in log[-1]["kinds"]
    assert np.array_equal(images["planar"], images["nv12"])
    assert images["nv12"][:size, :size, :3].std() > 0
    ref = JaxBackend((64, 64))
    _build_yuv_scene(ref, "nv12", nv12, YuvColorSpace.REC709,
                     ColorRange.LIMITED)
    assert np.array_equal(images["nv12"], ref.render_software())
