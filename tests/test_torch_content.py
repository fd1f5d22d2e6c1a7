"""The tile kernel's content-page branches against the JAX package, on the
CPU: the plain version (`ops/tile_raster.py`) against
`render_tiles_pallas_dense(interpret=True)` with the dispatch's own
`mask_clips`.

* One frame per branch group, built by the JAX package's frame builder:
  radial gradients (clamp; repeat with tile spacing), conic gradients
  (hard stops at exact angles; repeat), sharp box shadows (outset and
  inset, with and without radii), the three line styles in both
  orientations, and an image-mask clip with outset and inset box-shadow
  nine-patch clips under a transform whose off-diagonals are 5e-10.
  Max diff 0.
* The analytic box shadow's blurred arm (sigma > 0), which the frame
  builder never emits (it draws blurred shadows through the nine-patch
  clip): hand-made records, held at the tolerance `BLUR_TOLERANCE`.
* The 17 mix-blend modes over a random u8-grid backdrop, with partial
  coverage and a clip mask, in one dispatch: max diff 0 for the 13
  separable and float modes.  XLA's CPU build of the interpret kernel
  contracts multiply-adds in the four HSL modes (hue, saturation, color,
  luminosity), which turns exact-half ties the other way: those are held
  at one u8 step, at `HSL_TIES` values at most, and every mode is held
  bitwise against the JAX package's blend math run by numpy (the
  single-source `ops/blend.py`, as its numpy oracle runs it).
* On a card (marker `cuda`): the CUDA kernel against the plain version on
  the same inputs, max diff 0, the blurred box-shadow arm included.
"""
import numpy as np
import pytest
import torch

from torch_twin import (jax_kernel_inputs, jax_scene, positional, record,
                        run_pallas, to_torch, u8_planes)

from webrender_tpu_torch import scenes
from webrender_tpu_torch.ops import tile_raster as tr


def _page(A, backend, size, draw):
    """A page of `size` with a light background, then `draw(A, b, root,
    txn)`."""
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    root = A.SpatialId.root_scroll_node(pid)
    w, h = size
    b.push_rect(A.CommonItemProperties(A.Rect(0, 0, w, h), root),
                A.Rect(0, 0, w, h), A.ColorF(0.95, 0.95, 0.97, 1.0))
    txn = A.Transaction()
    draw(A, b, root, txn)
    return scenes._finish(A, backend, pid, b, txn)


def _common(A, root, x, y, w, h):
    return A.CommonItemProperties(A.Rect(x, y, w, h), root)


def _stops(A, offsets, colors):
    return [A.GradientStop(o, A.ColorF(*c)) for o, c in zip(offsets, colors)]


def radial_scene(backend, *, api):
    def draw(A, b, root, txn):
        g, stops = b.create_radial_gradient(
            A.Point2D(60, 40), A.Size2D(70, 30),
            _stops(A, (0.0, 0.4, 1.0), ((1, 0.9, 0.3, 1), (0.8, 0.2, 0.4, 0.7),
                                        (0.1, 0.2, 0.6, 1))),
            A.ExtendMode.CLAMP)
        b.push_radial_gradient(_common(A, root, 0, 0, 256, 128),
                               A.Rect(4, 4, 120, 90), g, stops)
        g, stops = b.create_radial_gradient(
            A.Point2D(20, 18), A.Size2D(15, 11),
            _stops(A, (0.0, 0.5, 1.0), ((0.1, 0.5, 0.9, 1), (1, 1, 1, 1),
                                        (0.1, 0.5, 0.9, 1))),
            A.ExtendMode.REPEAT)
        b.push_radial_gradient(_common(A, root, 0, 0, 256, 128),
                               A.Rect(130.5, 10, 120, 100), g, stops,
                               tile_size=A.Size2D(50, 40),
                               tile_spacing=A.Size2D(6, 4))
    return _page(api, backend, (256, 128), draw)


def conic_scene(backend, *, api):
    quarters = (0.0, 0.25, 0.25, 0.5, 0.5, 0.75, 0.75, 1.0)
    colors = ((0.9, 0.2, 0.2, 1), (0.9, 0.2, 0.2, 1), (0.2, 0.8, 0.3, 1),
              (0.2, 0.8, 0.3, 1), (0.2, 0.3, 0.9, 1), (0.2, 0.3, 0.9, 1),
              (0.9, 0.8, 0.1, 0.6), (0.9, 0.8, 0.1, 0.6))

    def draw(A, b, root, txn):
        # the center on a pixel center: whole columns and rows of pixels
        # lie exactly on the hard stops' angles
        g, stops = b.create_conic_gradient(
            A.Point2D(60.5, 50.5), 0.0, _stops(A, quarters, colors),
            A.ExtendMode.CLAMP)
        b.push_conic_gradient(_common(A, root, 0, 0, 256, 128),
                              A.Rect(0, 0, 124, 100), g, stops)
        g, stops = b.create_conic_gradient(
            A.Point2D(30, 25), 0.5,
            _stops(A, (0.0, 0.3, 0.6), ((1, 0, 0, 1), (0, 1, 0, 1),
                                        (0, 0, 1, 1))),
            A.ExtendMode.REPEAT)
        b.push_conic_gradient(_common(A, root, 0, 0, 256, 128),
                              A.Rect(130, 8, 120, 110), g, stops,
                              tile_size=A.Size2D(60, 50),
                              tile_spacing=A.Size2D(2, 3))
    return _page(api, backend, (256, 128), draw)


def shadow_scene(backend, *, api):
    def draw(A, b, root, txn):
        out, ins = A.BoxShadowClipMode.OUTSET, A.BoxShadowClipMode.INSET
        for rect, off, spread, radius, mode in (
                ((20, 14, 80, 40), (6, 5), 3.0, 10.0, out),
                ((150, 14, 60, 30), (4, 4), 0.0, 0.0, out),
                ((20, 74, 90, 44), (5, 4), 2.0, 12.0, ins),
                ((146, 70, 90, 45), (-3, 3), 0.0, 0.0, ins)):
            b.push_box_shadow(_common(A, root, 0, 0, 256, 128),
                              A.Rect(*rect), A.Point2D(*off),
                              A.ColorF(0.1, 0.1, 0.3, 0.6), 0.0, spread,
                              A.BorderRadius.uniform(radius), mode)
    return _page(api, backend, (256, 128), draw)


def line_scene(backend, *, api):
    def draw(A, b, root, txn):
        h_, v_ = A.LineOrientation.HORIZONTAL, A.LineOrientation.VERTICAL
        color = A.ColorF(0.8, 0.1, 0.2, 1.0)
        for i, (style, thick, wavy) in enumerate((
                ("DOTTED", 2.0, 0.0), ("DOTTED", 5.0, 0.0),
                ("DASHED", 2.0, 0.0), ("DASHED", 3.0, 0.0),
                ("WAVY", 6.0, 2.0), ("WAVY", 9.0, 3.0))):
            s = getattr(A.LineStyle, style)
            b.push_line(_common(A, root, 0, 0, 256, 128),
                        A.Rect(6.0, 6.0 + 14 * i, 110.5, thick), wavy, h_,
                        color, s)
            b.push_line(_common(A, root, 0, 0, 256, 128),
                        A.Rect(140.0 + 18 * i, 4.0, thick, 117.5), wavy, v_,
                        color, s)
    return _page(api, backend, (256, 128), draw)


def mask_scene(backend, *, api):
    """An image under an image-mask clip, and blurred outset and inset box
    shadows, in a reference frame whose off-diagonals are 5e-10."""
    def draw(A, b, root, txn):
        rng = np.random.RandomState(11)
        px = (rng.rand(96, 96, 4) * 255).astype(np.uint8)
        px[..., 3] = 255
        txn.add_image(100, A.ImageDescriptor(
            A.ImageFormat.RGBA8, 96, 96,
            flags=A.ImageDescriptorFlags.IS_OPAQUE), A.ImageData(pixels=px))
        yy, xx = np.mgrid[0:96, 0:96] + 0.5
        cov = np.clip(46.0 - np.hypot(xx - 48.0, yy - 48.0), 0.0, 1.0)
        mask = np.repeat((cov * 255.0 + 0.5).astype(np.uint8)[..., None],
                         4, 2)
        txn.add_image(101, A.ImageDescriptor(A.ImageFormat.RGBA8, 96, 96),
                      A.ImageData(pixels=mask))
        m = [1.0, 5e-10, 0.0, 0.0, 5e-10, 1.0, 0.0, 0.0,
             0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]
        ref = b.push_reference_frame(A.Point2D(3, 2), root, None,
                                     A.Transform(m), None)
        clip = b.define_clip_image_mask(ref, A.Rect(17, 9, 96, 96), 101)
        common = A.CommonItemProperties(
            A.Rect(0, 0, 380, 190), ref,
            clip_chain_id=b.define_clip_chain(None, [clip]))
        b.push_image(common, A.Rect(17, 9, 96, 96), A.ImageRendering.AUTO,
                     A.AlphaType.PREMULTIPLIED_ALPHA, 100)
        plain = A.CommonItemProperties(A.Rect(-20, -20, 420, 230), ref)
        # fractional edges: the nine-patch's rect coverage is partial there
        b.push_box_shadow(plain, A.Rect(150.5, 24.25, 90, 60),
                          A.Point2D(0, 2),
                          A.ColorF(0, 0, 0, 0.25), 8.0, 0.0,
                          A.BorderRadius.uniform(12.0),
                          A.BoxShadowClipMode.OUTSET)
        b.push_rect(plain, A.Rect(150, 120, 200, 40), A.ColorF(1, 1, 1, 1))
        b.push_box_shadow(plain, A.Rect(150, 120, 200, 40), A.Point2D(0, 1),
                          A.ColorF(0, 0, 0, 0.3), 3.0, 0.0,
                          A.BorderRadius.uniform(4.0),
                          A.BoxShadowClipMode.INSET)
        b.pop_reference_frame()
    return _page(api, backend, (384, 192), draw)


# name: (scene, device size, dense kinds it must hold, clip kinds it must
# hold, mask_clips)
BRANCHES = {"radial": (radial_scene, (256, 128), {3}, set(), False),
            "conic": (conic_scene, (256, 128), {4}, set(), False),
            "box_shadow": (shadow_scene, (256, 128), {8}, set(), False),
            "line_dec": (line_scene, (256, 128), {11}, set(), False),
            "mask_clips": (mask_scene, (384, 192), {0, 13}, {1.0, 2.0, 4.0},
                           True)}


def _clip_kinds(args):
    dense, rows = args["dense"], args["f32_rows"]
    valid = np.arange(dense.shape[1])[None, :] < args["counts"][:, None]
    found = set()
    for rec in dense[valid]:
        for j in range(int(rec[67])):
            found.add(float(rows[int(rec[68]) + j, 14]))
    return found


@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_branch_matches_pallas_interpret(name):
    from webrender_tpu.ops.pallas import tile_raster as jt
    make, size, kinds_in, clips_in, masked = BRANCHES[name]
    frame, _, _, (kinds, blends, mask_clips), args = jax_kernel_inputs(
        jax_scene(make, size))
    assert jt._supported_vec(frame.instances, frame.transforms,
                             frame.f32_buf).all()
    assert kinds_in <= set(kinds) and clips_in <= _clip_kinds(args)
    assert mask_clips == masked
    ref = run_pallas(args, kinds, blends, mask_clips)
    got = tr.render_tiles_dense(*positional(to_torch(args)), kinds=kinds,
                                blends=blends, mask_clips=mask_clips).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() == 0.0
    # the branch drew: not every tile is its background
    assert len(np.unique(np.round(got * 255).reshape(-1, 4), axis=0)) > 8


# --- the analytic box shadow's blurred arm ------------------------------------

# (max |diff| in u8 steps, values that differ) against the interpret kernel:
# its exp is XLA's, the plain version's torch's, so the erf / gaussian
# coverage can differ in the last ulp before the u8 snap
BLUR_TOLERANCE = (1, 16)


def blurred_shadow_inputs():
    """Kernel inputs (numpy) of two tiles of analytic box-shadow records
    with sigma 2.5 and 6: outset and inset, with and without radii."""
    recs = []
    for sigma, inset, radius in ((2.5, 0.0, 0.0), (6.0, 0.0, 9.0),
                                 (2.5, 1.0, 7.0), (6.0, 1.0, 0.0)):
        shadow = (14.0, 10.0, 100.0, 50.0)
        box = (10.0, 6.0, 96.0, 46.0)
        pay = [0, 0, 128, 64, 0, 0, 128, 64, *shadow, *([radius] * 8),
               sigma, inset, *box, *([radius * 0.5] * 8),
               0.1 * 0.6, 0.1 * 0.6, 0.3 * 0.6, 0.6]
        recs.append(record(8, pay, edge_aa=0))
    dense = np.zeros((2, 2, 128), np.float32)
    dense[0, 0], dense[0, 1], dense[1, 0], dense[1, 1] = recs
    return dict(dense=dense, counts=np.array([2, 2], np.int32),
                origins=np.array([[0, 0], [0, 0]], np.float32),
                clear=np.array([0.95, 0.95, 0.97, 1.0], np.float32),
                f32_rows=np.zeros((1, 128), np.float32),
                alpha_atlas=np.zeros((72, 256), np.float32),
                surface_atlas=np.zeros((4, 72, 256), np.float32),
                color_atlas=np.zeros((4, 72, 256), np.float32))


def test_blurred_box_shadow_within_tolerance_of_pallas_interpret():
    args = blurred_shadow_inputs()
    ref = run_pallas(args, (8,), (0,), False)
    got = tr.render_tiles_dense(*positional(to_torch(args)), kinds=(8,),
                                blends=(0,)).numpy()
    diff = np.abs(np.round(got * 255) - np.round(ref * 255))
    assert diff.max() <= BLUR_TOLERANCE[0]
    assert int((diff > 0).sum()) <= BLUR_TOLERANCE[1]
    # the shadow is blurred: many coverage levels
    assert len(np.unique(np.round(got[:, 0] * 255))) > 20


# --- the mix-blend modes ------------------------------------------------------

MIX_OPS = tuple(range(16, 33))
HSL_OPS = (28, 29, 30, 31)
# values (u8, over 17 x 8192 pixels x 4 channels) at which the HSL modes may
# differ from the interpret kernel, by one step
HSL_TIES = 8


def mix_inputs(full=False, seed=7):
    """Kernel inputs (numpy) of one tile per mix-blend op: a random
    u8-grid backdrop (a picture record, blend 0), then a random source
    picture of the tile's op.  The source covers a rect with fractional
    edges under a rounded clip unless `full`."""
    rng = np.random.RandomState(seed)
    H, W = 448, 1024
    atlas = u8_planes(rng, (H, W))
    n = len(MIX_OPS)
    dense = np.zeros((n, 2, 128), np.float32)
    clip = np.zeros(128, np.float32)
    clip[0:4] = (10, 4, 118, 60)
    clip[4:12] = 26.0
    clip[14:16] = (1.0, 1.0)  # rounded, uniform radius
    clip[96:108] = (1, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0)
    for i, op in enumerate(MIX_OPS):
        bx, by = 128 * (i % 8), 64 * (i // 8)
        sx, sy = 128 * ((i + 3) % 8), 64 * ((i // 8) + 3)
        dense[i, 0] = record(6, [0, 0, 128, 64, 0, 0, 128, 64,
                                 bx, by, bx + 128, by + 64, 1, 1, 1, 1])
        cov = (0, 0, 128, 64) if full else (0.5, 0.25, 127.3, 63.6)
        dense[i, 1] = record(6, [0, 0, 128, 64, *cov,
                                 sx, sy, sx + 128, sy + 64, 1, 1, 1, 1],
                             blend=op, clip_row=1,
                             clip_count=0 if full else 1)
    rows = np.zeros((2, 128), np.float32)
    rows[1] = clip
    return dict(dense=dense, counts=np.full(n, 2, np.int32),
                origins=np.zeros((n, 2), np.float32),
                clear=np.zeros(4, np.float32), f32_rows=rows,
                alpha_atlas=np.zeros((H, W), np.float32),
                surface_atlas=atlas,
                color_atlas=np.zeros((4, H, W), np.float32))


@pytest.fixture(scope="module")
def mix_tiles():
    """(plain version, interpret kernel) tiles of `mix_inputs()`."""
    args = mix_inputs()
    blends = (0,) + MIX_OPS
    ref = run_pallas(args, (6,), blends, False)
    got = tr.render_tiles_dense(*positional(to_torch(args)), kinds=(6,),
                                blends=blends).numpy()
    return got, ref


@pytest.mark.parametrize("op", MIX_OPS)
def test_mix_blend_matches_pallas_interpret(op, mix_tiles):
    got, ref = (t[MIX_OPS.index(op)] for t in mix_tiles)
    assert np.isfinite(got).all()
    diff = np.abs(np.round(got * 255) - np.round(ref * 255))
    if op in HSL_OPS:
        assert diff.max() <= 1 and int((diff > 0).sum()) <= HSL_TIES
    else:
        assert diff.max() == 0
    # the source drew over a backdrop of many values
    assert len(np.unique(np.round(got * 255))) > 200


@pytest.mark.parametrize("op", MIX_OPS)
def test_mix_blend_matches_jax_blend_math_in_numpy(op):
    """Full coverage and no clip: the source's u8 texels reach the blend
    unchanged, so each tile is the JAX package's `_blend_case_int` on the
    two pictures' texels, run by numpy."""
    from webrender_tpu.ops import blend as jax_blend
    args = mix_inputs(full=True, seed=op)
    got = tr.render_tiles_dense(*positional(to_torch(args)), kinds=(6,),
                                blends=(0,) + MIX_OPS).numpy()
    i = MIX_OPS.index(op)
    atlas = args["surface_atlas"]

    def texels(rec):
        x0, y0 = int(rec[8]), int(rec[9])
        return np.floor(atlas[:, y0:y0 + 64, x0:x0 + 128] * 255.0 + 0.5)
    d, s = texels(args["dense"][i, 0]), texels(args["dense"][i, 1])
    want = np.clip(jax_blend._blend_case_int(np, op, s, d), 0.0, 255.0) * \
        np.float32(1.0 / 255.0)
    np.testing.assert_array_equal(got[i], want.astype(np.float32))


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _kernel_vs_plain(args, **kw):
    before = tr.LaunchCounts.launches
    out = tr.render_tiles_dense(*positional(args), **kw)
    torch.cuda.synchronize()
    assert tr.LaunchCounts.launches == before + 1
    plain = {k: v for k, v in kw.items() if k != "gl"}
    ref = tr.render_tiles_dense_plain(*positional(args), **plain)
    assert torch.isfinite(out).all()
    return float((out - ref).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_cuda_branch_matches_plain(cuda_device, name):
    from webrender_tpu_torch.render_backend import RenderBackend
    make, size, kinds_in, _, masked = BRANCHES[name]
    inp = scenes.kernel_inputs(make(RenderBackend(
        size, device=cuda_device, resources=scenes.resource_cache()),
        api=scenes.port_api))
    assert kinds_in <= set(inp["kinds"])
    assert _kernel_vs_plain(inp, kinds=inp["kinds"], blends=inp["blends"],
                            mask_clips=inp["mask_clips"]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["blurred_shadow", "mix", "mix_full"])
def test_cuda_hand_records_match_plain(cuda_device, case):
    if case == "blurred_shadow":
        args, kw = blurred_shadow_inputs(), dict(kinds=(8,), blends=(0,))
    else:
        args = mix_inputs(full=case == "mix_full")
        kw = dict(kinds=(6,), blends=(0,) + MIX_OPS)
    assert _kernel_vs_plain(to_torch(args, cuda_device), mask_clips=False,
                            **kw) == 0.0
