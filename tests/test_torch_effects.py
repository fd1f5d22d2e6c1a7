"""The filter-effects path of the port against the JAX package, on the CPU.

* The small effects frame (`scenes.effects_scene`, 1024x512: a blurred
  hero, drop-shadow cards, a grayscale drop-shadow avatar, an opacity
  toast, a grayscale strip) through both packages' `RenderBackend`s, the
  JAX renderer on its Pallas kernel in interpret mode: the RGBA8 image and
  the whole surface atlas bitwise, with picture caching off and on; then
  an edit inside the blurred group on the default path.
* Each offscreen pass (blur, downscale, color matrix, copy) against the
  JAX renderer's code for it, on seeded u8-grid atlases: odd sizes, blur
  regions below the pass region, sigma 0, 0.5, 3 and 4, overlapping
  source and destination regions.
* The plain version's picture branches (`KIND_PICTURE`, `K_SEP_PICTURE`)
  against the Pallas kernel in interpret mode on the frame's root pass,
  as built (color-matrix flags 0 and 1), with every flag 0, and with the
  separable pictures in the raster-root local mode; and the sampled kinds
  at the atlas's corners, where their taps leave the atlas.
"""
import numpy as np
import pytest
import torch

from torch_twin import (edge_inputs, jax_effects_backend, jax_pass_inputs,
                        picture_variant, polygon_clip, polygon_inside,
                        positional, run_pallas, to_port, to_torch)

from webrender_tpu_torch import scenes
from webrender_tpu_torch.frame import frame_builder as port_fb
from webrender_tpu_torch.ops import tile_raster as tr
from webrender_tpu_torch.ops.dense import K_SEP_PICTURE
from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.renderer import Renderer
from webrender_tpu_torch.renderer.renderer import PASS_NAMES

# the trial frame's passes: 8 surface rasters, 7 downscales, 6 + 6 blurs,
# one color matrix and the root raster
EXPECT_PASSES = {("raster", False): 8, ("downscale", False): 7,
                 ("blur_v", False): 6, ("blur_h", False): 6,
                 ("color_matrix", False): 1, ("raster", True): 1}


def _port_backend(caching, **kw):
    backend = scenes.effects_scene(RenderBackend((1024, 512), device="cpu"),
                                   **kw)
    backend.renderer.picture_caching = caching
    return backend


@pytest.fixture(scope="module")
def jax_uncached():
    """The JAX backend after rendering the small effects frame uncached:
    (backend, frame, RGBA8)."""
    backend = jax_effects_backend(caching=False)
    frame = backend.build_frame()
    img = backend.renderer.render(frame, backend.resources)
    return backend, frame, img


def _pass_counts(frame):
    from collections import Counter
    return dict(Counter((PASS_NAMES[p.kind], p.target == port_fb.TARGET_ROOT)
                        for p in frame.passes))


@pytest.mark.parametrize("caching", [False, True])
def test_effects_frame_equals_jax(caching, jax_uncached):
    if caching:
        ref = jax_effects_backend(caching=True)
        want = ref.render()
    else:
        ref, _, want = jax_uncached
        assert ref.renderer.engine_counts == {"pallas": 9}
        np.testing.assert_array_equal(
            np.load(scenes.GOLDENS)[scenes.EFFECTS_FRAME[0]], want)
    port = _port_backend(caching)
    frame = port.build_frame()
    assert _pass_counts(frame) == EXPECT_PASSES
    before = tr.LaunchCounts.plain_calls
    got = port.renderer.render(frame, port.resources)
    assert tr.LaunchCounts.plain_calls - before == 9
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.renderer.surface_atlas.numpy(),
                                  np.asarray(ref.renderer.surface_atlas))
    # the root pass composites through both picture kinds
    root = frame.passes[-1]
    ids = np.unique(root.tile_insts[root.tile_insts >= 0])
    assert {6, K_SEP_PICTURE} <= set(frame._torch_dense_kinds[ids].tolist())


def test_edit_inside_the_blurred_group_on_the_default_path():
    """Picture caching on: the first frame and the same frame again equal
    JAX's images; then a frame whose only change is a rect inside the
    blurred hero.  Its root tile hashes equal the last frame's (they
    cover the picture composites, not the surface they sample): JAX
    re-rasters no tile and presents the old hero, while the port
    re-rasters the tiles that hold a picture, and its image equals an
    uncached render of the edited frame."""
    import webrender_tpu.api as jax_api
    from webrender_tpu_torch import api as port_api
    ref = jax_effects_backend(caching=True)
    port = _port_backend(True)
    images = []
    for _ in range(2):
        want = ref.render()
        images.append(port.render())
        np.testing.assert_array_equal(images[-1], want)
    assert port.renderer.last_dirty_tiles == 0
    bar = (0.9, 0.2, 0.1, 1.0)
    scenes.effects_scene(ref, api=jax_api, hero_bar=bar)
    scenes.effects_scene(port, api=port_api, hero_bar=bar)
    stale = ref.render()
    np.testing.assert_array_equal(stale, images[1])
    assert ref.renderer.last_dirty_tiles == 0
    edited = port.render()
    assert 0 < port.renderer.last_dirty_tiles < 64
    fresh = _port_backend(False, hero_bar=bar).render()
    np.testing.assert_array_equal(edited, fresh)
    x, y, w, h = scenes.EFFECTS_SMALL["hero"]
    changed = np.argwhere((edited != images[1]).any(2))
    assert changed.size
    # the blur spreads the edit a few pixels beyond the hero, no further
    assert changed[:, 0].min() >= y - 16 and changed[:, 0].max() < y + h + 16
    assert changed[:, 1].min() >= x - 16 and changed[:, 1].max() < x + w + 16


# --- one offscreen pass ------------------------------------------------------

ATLAS = (96, 160)


def _atlas(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (4,) + ATLAS) / 255.0).astype(np.float32)


def _jax_pass(kind, atlas, framebuffer, **kw):
    """The JAX renderer's code for one offscreen pass (renderer.py:578-635,
    `_run_blur` :1354) on a renderer holding `atlas`."""
    import jax
    import jax.numpy as jnp
    from webrender_tpu.frame import frame_builder as jfb
    from webrender_tpu.renderer import renderer as jr
    r = jr.Renderer(color_atlas_size=(8, 8), alpha_atlas_size=(8, 8),
                    surface_atlas_size=ATLAS, use_pallas=False)
    r.surface_atlas = jnp.asarray(atlas)
    p = jfb.RenderPass(kind, target=jfb.TARGET_SURFACE, **kw)
    sx, sy, sw, sh = p.src_region
    dx, dy, dw, dh = p.region
    if kind in (jfb.PASS_BLUR_H, jfb.PASS_BLUR_V):
        r._run_blur(p)
        return np.asarray(r.surface_atlas)
    src_arr = jnp.asarray(framebuffer) if p.src_target == jfb.TARGET_ROOT \
        else r.surface_atlas
    src = jax.lax.dynamic_slice(src_arr, (0, sy, sx), (4, sh, sw))
    if kind == jfb.PASS_COPY:
        if dw > sw or dh > sh:
            src = jnp.pad(src, ((0, 0), (0, max(0, dh - sh)),
                                (0, max(0, dw - sw))))
        out = src
    elif kind == jfb.PASS_DOWNSCALE:
        out = jr._downscale2x(src, dw, dh)
    else:
        out = jr._apply_color_matrix_pass(
            src, jnp.asarray(p.color_matrix, jnp.float32))
    return np.asarray(jr._copy_region(r.surface_atlas, out, dx, dy))


def _port_pass(kind, atlas, framebuffer, **kw):
    r = Renderer("cpu", color_atlas_size=(8, 8), alpha_atlas_size=(8, 8),
                 surface_atlas_size=ATLAS)
    r.surface_atlas = torch.from_numpy(atlas.copy())
    p = port_fb.RenderPass(kind, target=port_fb.TARGET_SURFACE, **kw)
    r._run_offscreen(p, None if framebuffer is None
                     else torch.from_numpy(framebuffer))
    return r.surface_atlas.numpy()


GRAY = [0.2126, 0.7152, 0.0722, 0, 0, 0.2126, 0.7152, 0.0722, 0, 0,
        0.2126, 0.7152, 0.0722, 0, 0, 0, 0, 0, 1, 0]
SEPIA = [0.393, 0.769, 0.189, 0, 0, 0.349, 0.686, 0.168, 0, 0,
         0.272, 0.534, 0.131, 0, 0, 0, 0, 0, 1, 0]
ODD = (3, 5, 37, 23)
PASSES = {}
for _sigma in (0.0, 0.5, 3.0, 4.0):
    for _axis in ("blur_h", "blur_v"):
        for _region in (None, (31, 19)):
            PASSES[f"{_axis}-s{_sigma:g}-{'clamp' if _region else 'full'}"] = (
                _axis, dict(src_region=ODD, region=(60, 40, 37, 23),
                            sigma=_sigma, blur_region=_region))
PASSES["blur_h-s3-overlap"] = ("blur_h", dict(
    src_region=ODD, region=(20, 15, 37, 23), sigma=3.0))
PASSES["blur_v-s0-overlap"] = ("blur_v", dict(
    src_region=ODD, region=(10, 9, 37, 23), sigma=0.0))
PASSES["downscale-odd"] = ("downscale", dict(src_region=ODD,
                                             region=(60, 40, 18, 11)))
PASSES["downscale-odd-up"] = ("downscale", dict(src_region=ODD,
                                                region=(60, 40, 19, 12)))
PASSES["downscale-even"] = ("downscale", dict(src_region=(8, 8, 40, 24),
                                              region=(100, 50, 20, 12)))
PASSES["downscale-overlap"] = ("downscale", dict(src_region=(8, 8, 40, 24),
                                                 region=(20, 12, 20, 12)))
PASSES["color_matrix-gray"] = ("color_matrix", dict(
    src_region=ODD, region=(60, 40, 37, 23),
    color_matrix=np.asarray(GRAY, np.float32)))
PASSES["color_matrix-sepia"] = ("color_matrix", dict(
    src_region=ODD, region=(60, 40, 37, 23),
    color_matrix=np.asarray(SEPIA, np.float32)))
PASSES["copy-padded"] = ("copy", dict(src_region=ODD,
                                      region=(60, 40, 45, 30)))
PASSES["copy-overlap"] = ("copy", dict(src_region=ODD,
                                       region=(9, 8, 37, 23)))
PASSES["copy-from-root"] = ("copy", dict(src_region=(30, 20, 37, 23),
                                         region=(60, 40, 37, 23),
                                         src_target=port_fb.TARGET_ROOT))
KINDS = {"blur_h": port_fb.PASS_BLUR_H, "blur_v": port_fb.PASS_BLUR_V,
         "downscale": port_fb.PASS_DOWNSCALE, "copy": port_fb.PASS_COPY,
         "color_matrix": port_fb.PASS_COLOR_MATRIX}


@pytest.mark.parametrize("case", sorted(PASSES))
def test_offscreen_pass_matches_jax(case):
    name, kw = PASSES[case]
    atlas = _atlas(sum(map(ord, case)))
    # premultiplied texels: color at most alpha
    atlas[:3] = np.minimum(atlas[:3], atlas[3:])
    fb = _atlas(5)[:, :64, :128] if kw.get("src_target") is not None \
        else None
    want = _jax_pass(KINDS[name], atlas, fb, **kw)
    got = _port_pass(KINDS[name], atlas, fb, **kw)
    assert not np.array_equal(want, atlas)
    np.testing.assert_array_equal(got, want)


# --- the kernel's picture branches -----------------------------------------

def _picture_tiles(args):
    """The root pass reduced to the tiles that hold a picture record."""
    dense, counts = args["dense"], args["counts"]
    valid = np.arange(dense.shape[1])[None, :] < counts[:, None]
    kind = dense[..., 64]
    keep = (valid & ((kind == 6) | (kind == K_SEP_PICTURE))).any(1)
    out = dict(args)
    for k in ("dense", "counts", "origins"):
        out[k] = args[k][keep]
    return out


@pytest.mark.parametrize("variant", ["built", "flag0", "flag1", "local"])
def test_picture_branches_match_pallas_interpret(variant, jax_uncached):
    backend, frame, _ = jax_uncached
    r = backend.renderer
    (p,) = [q for q in r._merged_root_passes(frame)
            if q.target == port_fb.TARGET_ROOT]
    _, (kinds, blends, mask_clips), args = jax_pass_inputs(r, frame, p)
    assert {6, K_SEP_PICTURE} <= set(kinds)
    args = _picture_tiles(args)
    t = to_torch(args)
    if variant != "built":
        t["dense"] = picture_variant(t["dense"], t["counts"], variant, GRAY)
        args["dense"] = t["dense"].numpy()
    flags = set(t["dense"][..., 36][
        (t["dense"][..., 64] == 6) | (t["dense"][..., 64] == 15)].tolist())
    assert flags == {"built": {0.0, 1.0}, "flag0": {0.0}, "flag1": {1.0},
                     "local": {0.0, 1.0}}[variant]
    ref = run_pallas(args, kinds, blends, mask_clips)
    got = tr.render_tiles_dense(*positional(t), kinds=kinds, blends=blends,
                                mask_clips=mask_clips).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() == 0.0


@pytest.mark.parametrize("kind", [5, 6, 10, 15])
@pytest.mark.parametrize("corner", ["origin", "far"])
def test_sampled_kinds_at_atlas_edges_match_pallas_interpret(kind, corner):
    args = edge_inputs(kind, corner == "far")
    ref = run_pallas(args, (0, kind), (0,), False)
    got = tr.render_tiles_dense(*positional(to_torch(args)), kinds=(0, kind),
                                blends=(0,)).numpy()
    assert np.abs(got - ref).max() == 0.0


def test_picture_color_matrix_flag_2_is_refused():
    """Refused until the SVG filter path was ported: color-matrix flag 2
    (the matrix in linearRGB) now renders, equal to the Pallas kernel in
    interpret mode but for values one step apart where XLA's exp or log
    rounds otherwise than torch's; a dispatch that does not say
    `linear_cm` is refused, lest it take a build without the flag."""
    raw = edge_inputs(6, False)
    raw["dense"][0, 0, 16:36] = SEPIA
    raw["dense"][0, 0, 36] = 2.0
    args = to_torch(raw)
    with pytest.raises(ValueError, match="linear_cm"):
        tr.render_tiles_dense(*positional(args), kinds=(0, 6), blends=(0,))
    before = tr.LaunchCounts.plain_calls
    got = tr.render_tiles_dense(*positional(args), kinds=(0, 6),
                                blends=(0,), linear_cm=True).numpy()
    assert tr.LaunchCounts.plain_calls == before + 1
    steps = np.abs(got - run_pallas(raw, (0, 6), (0,), False)) * 255.0
    assert steps.max() < 1.0 + 1e-3 and (steps > 0).sum() <= 16


# values of the edited effects frame one step from the JAX renderer's,
# where XLA contracts a polygon half-plane (measured: 4)
POLYGON_FMA_VALUES = 4


@pytest.mark.parametrize("edit", ["none", "flag-2", "clip-kind-3"])
def test_renderer_checks_records_on_the_host(edit, monkeypatch):
    """The renderer checks a pass's clip kinds and color-matrix flags on
    the frame's host arrays, so the wrapper's device-side checks never
    run on its dispatches: a picture's flag 2 renders, and a clip record
    turned into a triangle (clip kind 3; refused until polygon clips were
    ported) renders, its dispatch flagged `polygon_clips` by the host
    check, equal to the JAX renderer's image of the same edited frame but
    for `POLYGON_FMA_VALUES` values one step apart: XLA's CPU build of the
    interpret kernel contracts the half-planes' `a * px + b * py` into a
    multiply-add, and the port rounds the product first, as numpy does
    (`tests/test_torch_preserve3d.py` holds the port bitwise against the
    numpy oracle)."""
    from webrender_tpu_torch.frame.gpu import (INST_CLIP_ADDR,
                                               INST_CLIP_COUNT, INST_KIND,
                                               INST_PRIM_ADDR, KIND_PICTURE)

    def device_check(*_):
        raise AssertionError("the wrapper checked the records on the device")
    monkeypatch.setattr(tr, "check_clip_kinds", device_check)
    monkeypatch.setattr(tr, "check_color_matrix_flags", device_check)
    port = _port_backend(False)
    frame = port.build_frame()
    root = frame.passes[-1]
    inst = frame.instances[np.unique(root.tile_insts[root.tile_insts >= 0])]
    if edit == "flag-2":
        pic = inst[inst[:, INST_KIND] == KIND_PICTURE]
        frame.f32_buf[pic[0, INST_PRIM_ADDR] + 36] = 2.0
    elif edit == "clip-kind-3":
        # the clipped instances (the cards' text) are drawn in surfaces
        jax_backend = jax_effects_backend(caching=False)
        jax_frame = jax_backend.build_frame()
        for f in (frame, jax_frame):
            i = np.nonzero(f.instances[:, INST_CLIP_COUNT] > 0)[0][0]
            polygon_clip(f.f32_buf.reshape(-1, 128),
                         f.instances[i, INST_CLIP_ADDR] // 128,
                         polygon_inside(f.inst_bboxes[i]))
        np.testing.assert_array_equal(frame.f32_buf, jax_frame.f32_buf)
    before = tr.LaunchCounts.plain_calls
    # flag 2 renders since the SVG filter path was ported: the host check
    # tells the root dispatch to take the filter instantiation
    port.renderer.dispatch_log = log = []
    got = port.renderer.render(frame, port.resources)
    assert tr.LaunchCounts.plain_calls - before == 9
    assert log[-1]["linear_cm"] == (edit == "flag-2")
    assert any(e["polygon_clips"] for e in log) == (edit == "clip-kind-3")
    if edit == "clip-kind-3":
        want = jax_backend.renderer.render(jax_frame, jax_backend.resources)
        steps = np.abs(got.astype(int) - want.astype(int))
        assert steps.max() <= 1 and (steps > 0).sum() <= POLYGON_FMA_VALUES
        assert not np.array_equal(got, _port_backend(False).render())


def test_port_feed_carries_jax_transactions():
    """`to_port` gives the port's classes, so that the scenes of the JAX
    tests drive the port's host layers."""
    import webrender_tpu.api as jax_api
    from webrender_tpu_torch import api as port_api
    txn = jax_api.Transaction()
    txn.set_root_pipeline(jax_api.PipelineId(0, 1))
    moved = to_port(txn)
    assert type(moved) is port_api.Transaction
    ((name, pid),) = moved.scene_ops
    assert name == "set_root_pipeline" and type(pid) is port_api.PipelineId
    assert pid == port_api.PipelineId(0, 1)
