"""The transformed page of the port against the JAX package, on the CPU.

The small transformed frame (`scenes.transformed_scene`, 1024x512: cards
under rotations inside a scroll frame, a skewed banner, thumbnails below
half size, wide repeats, 20- and 24-stop gradients, rotated and over-window
mask and nine-patch clips, a tilted video and its minified preview, a toast
in a rotated opacity group) holds instances that the TPU kernel has no path
for.  The JAX renderer (Pallas kernel in interpret mode) splits their tiles
off to `render_tiles` on its XLA engine (`pallas+xla-split`); the port
routes them to the general branches of its one kernel.

* The port's RGBA8 equals the JAX package's numpy oracle
  (`render_software`: its `patterns` and `blend` math run by numpy)
  bitwise, caching off and on, and the stored golden.  XLA's CPU build of
  `render_tiles` contracts multiply-adds and rewrites divisions, so JAX's
  own device render differs from its oracle, and from the port, in
  `XLA_PIXELS` pixels of at most `XLA_STEPS` u8 steps (measured: 29 and 2).
  The surface atlas is bitwise equal.
* The port's general tiles are the tiles JAX hands to XLA, pass by pass.
* Caching on equals caching off; an unchanged frame launches nothing.
* A scroll of the cards and a card's rotation animated to 0 and back go
  through the delta mirrors: every frame equals the frame of a backend
  that gathers every record from scratch, the tiles whose routing changed
  are re-gathered, and at 0 degrees fewer tiles are general.
* The 4K transformed page builds and routes with every reason present.

The video tick, the twin of `tests/test_pallas_split.py` and the oversized
group are in `tests/test_torch_transformed_tick.py` (a file of its own, so
that the JAX compiles of the two files run on two workers).
"""
import numpy as np
import pytest
import torch

import torch_twin as tw

from webrender_tpu_torch import scenes
from webrender_tpu_torch.api import Point2D
from webrender_tpu_torch.ops import dense as dm
from webrender_tpu_torch.ops import tile_raster as tr
from webrender_tpu_torch.render_backend import RenderBackend

NAME, _, SIZE = scenes.TRANSFORMED_FRAME
VIDEO_SIZE = scenes.TRANSFORMED_SMALL["video_size"]
XLA_PIXELS = 32
XLA_STEPS = 2
REASONS = {"rotated_image", "rotated_subpx_glyph", "rotated_glyph",
           "rotated_picture", "thumbnail", "wide_repeat", "linear_stops",
           "conic_stops", "radial_stops", "rotated_mask_clip",
           "rotated_nine_patch_clip", "wide_mask_clip", "minified_video"}


def _port(caching, tilt=None):
    backend = scenes.transformed_scene(RenderBackend(SIZE, device="cpu"),
                                       tilt=tilt)
    backend.renderer.picture_caching = caching
    return backend


def _assert_close_to_xla(got, want, pixels=XLA_PIXELS):
    diff = np.abs(got.astype(int) - want.astype(int)).max(2)
    assert int((diff > 0).sum()) <= pixels and diff.max() <= XLA_STEPS, \
        (int((diff > 0).sum()), int(diff.max()))


@pytest.fixture(scope="module")
def jax_uncached():
    """(backend, device RGBA8, oracle RGBA8) of the JAX package."""
    backend = tw.jax_transformed_backend()
    return backend, backend.render(), backend.render_software()


def _jax_tile_masks(renderer, frame, passes):
    from webrender_tpu.ops.pallas import tile_raster as jt
    ok = jt._supported_vec(frame.instances, frame.transforms, frame.f32_buf)
    return [jt.pallas_supported_mask(frame.instances, p.tile_insts,
                                     frame.transforms, frame.f32_buf,
                                     inst_ok=ok) for p in passes]


@pytest.mark.parametrize("caching", [False, True])
def test_transformed_frame_equals_jax(caching, jax_uncached):
    ref, want, oracle = jax_uncached
    if caching:
        ref = tw.jax_transformed_backend(caching=True)
        want = ref.render()
    else:
        np.testing.assert_array_equal(np.load(scenes.GOLDENS)[NAME], oracle)
    assert ref.renderer.engine_counts["pallas+xla-split"] > 0
    port = _port(caching)
    port.renderer.dispatch_log = log = []
    before = tr.LaunchCounts.plain_calls
    got = port.render()
    assert tr.LaunchCounts.plain_calls - before == len(log) >= 3
    np.testing.assert_array_equal(got, oracle)
    _assert_close_to_xla(got, want)
    np.testing.assert_array_equal(port.renderer.surface_atlas.numpy(),
                                  np.asarray(ref.renderer.surface_atlas))
    # the port's general tiles are JAX's XLA tiles, dispatch by dispatch
    frame = ref.build_frame()
    passes = [p for p in (frame.passes if caching else
                          ref.renderer._merged_root_passes(frame))
              if p.tile_insts is not None]
    masks = _jax_tile_masks(ref.renderer, frame, passes)
    assert len(masks) == len(log)
    for e, mask, counts in zip(log, masks, port.renderer.last_general_tiles):
        general = (e["dense"][..., dm.REC_GENERAL] > 0.5).any(1).numpy()
        np.testing.assert_array_equal(general, ~mask)
        assert counts == (int((~mask).sum()), mask.size)
        assert e["general"] == bool((~mask).any())
        build = tr.instantiation(e["kinds"], e["blends"], e["mask_clips"],
                                 e["general"], e["step"])
        assert (build == "general") == e["general"]
    root = log[-1]
    assert 0 < port.renderer.last_general_tiles[-1][0] < 64
    assert set(dm.GENERAL_KINDS) <= set(root["kinds"])
    # a supported tile keeps the TPU kernel's kinds
    assert {13, 10} <= set(root["kinds"])


def test_transformed_frame_holds_every_reason():
    frame = _port(False).build_frame()
    assert set(scenes.general_reasons(frame)) == REASONS


def test_transformed_frame_cached_equals_uncached_then_retained():
    uncached = _port(False).render()
    port = _port(True)
    first = port.render()
    np.testing.assert_array_equal(first, uncached)
    before = tr.LaunchCounts.plain_calls
    again = port.render()
    assert tr.LaunchCounts.plain_calls == before
    assert port.renderer.last_dirty_tiles == 0
    np.testing.assert_array_equal(again, first)


def _forget_mirrors(renderer):
    """Drop the renderer's delta mirrors, dense-record mirrors and cached
    dense kinds: its next render gathers every record from scratch."""
    from webrender_tpu_torch.renderer.renderer import _DeltaStore
    renderer._delta = _DeltaStore(renderer.device)
    renderer._dense_mirrors = {}
    renderer._dk_cache = None
    renderer._last_put_frame = None


@pytest.mark.parametrize("caching", [False, True])
def test_scroll_and_animated_rotation_through_the_delta_mirrors(caching):
    """The cards scrolled by 7 px, then the first card's rotation at 0
    degrees, then back at -4.  A second, uncached backend takes the same
    transactions (so that its atlases are laid out the same) and forgets
    its mirrors before every render: each frame of the first equals its
    frame.  At 0 degrees the card's caption and frame are back on the TPU
    kernel's paths, so fewer tiles are general; the tiles whose routing
    changed are re-gathered (not all of them), and the last frame equals
    the first."""
    port, twin = _port(caching), _port(False)
    r = port.renderer

    def both(change):
        for b in (port, twin):
            change(b)
        port.renderer.picture_caching = caching
        twin.renderer.picture_caching = False
        _forget_mirrors(twin.renderer)
        got = port.render()
        np.testing.assert_array_equal(got, twin.render())
        assert twin.renderer.regathered_tiles[-1] == 64
        return got

    def scroll(y):
        def change(b):
            b.scroll_offsets[scenes.CARDS_SCROLL_ID] = [(Point2D(0.0, y), 0)]
        return change

    first = both(lambda b: None)
    general0 = r.last_general_tiles[-1][0]
    scrolled = both(scroll(7.0))
    assert (scrolled != first).any()
    assert sum(r.regathered_tiles) < 64
    both(scroll(0.0))
    flat = both(lambda b: scenes.transformed_scene(b, tilt=0.0))
    assert (flat != first).any()
    if not caching:
        # one merged root pass: its general tiles, and an in-place update
        assert r.last_general_tiles[-1][0] < general0
        assert 0 < r.regathered_tiles[-1] < 64
    back = both(lambda b: scenes.transformed_scene(b, tilt=None))
    if not caching:
        assert r.last_general_tiles[-1][0] == general0
        assert 0 < r.regathered_tiles[-1] < 64
    # the images were added again at other places in the atlas: the frame
    # equals the first but for a few samples' rounding
    diff = np.abs(back.astype(int) - first.astype(int))
    assert diff.max() <= 1 and int((diff > 0).sum()) <= 16


def test_stale_routing_would_show():
    """The frame at 0 degrees differs from the frame at -4 where the card
    is, and the dense records of the tiles whose routing changed differ in
    their kinds: a mirror that kept the old records would draw another
    branch."""
    a, b = _port(False), _port(False, tilt=0.0)
    a.renderer.dispatch_log, b.renderer.dispatch_log = la, lb = [], []
    ia, ib = a.render(), b.render()
    assert (ia != ib).any()
    ga = (la[-1]["dense"][..., dm.REC_GENERAL] > 0.5).any(1)
    gb = (lb[-1]["dense"][..., dm.REC_GENERAL] > 0.5).any(1)
    flipped = ga & ~gb
    assert bool(flipped.any()) and not bool((gb & ~ga).any())
    kinds_a = la[-1]["dense"][flipped][..., dm.REC_KIND]
    kinds_b = lb[-1]["dense"][flipped][..., dm.REC_KIND]
    assert bool(torch.isin(kinds_a, torch.tensor([18.0, 20.0])).any())
    assert not bool(torch.isin(kinds_b, torch.tensor(
        [float(k) for k in dm.GENERAL_KINDS])).any())


def test_4k_transformed_scene_builds_and_routes():
    """The 4K page: bench's page, counts unchanged, plus the transformed
    groups; every reason present; a good share of the root pass's tiles
    stays on the TPU kernel's paths; the host checks pass."""
    backend = scenes.build_4k_transformed_scene(
        RenderBackend((3840, 2160), device="cpu"))
    frame = backend.build_frame()
    reasons = scenes.general_reasons(frame)
    assert set(reasons) == REASONS
    kind = frame.instances[:, 0]
    assert (kind == 2).sum() == 101 and (kind == 12).sum() == 1
    f32, inst, xf = [torch.from_numpy(a) for a in
                     (frame.f32_buf, frame.instances, frame.transforms)]
    ok = dm.pallas_supported(f32, inst, xf)
    assert int((~ok).sum()) == sum(reasons.values())
    dk = dm.classify_dense_kinds(f32, inst, xf)
    from webrender_tpu_torch.renderer.renderer import merged_root_passes
    root = merged_root_passes(frame)[-1]
    ti = torch.from_numpy(root.tile_insts)
    assert tuple(ti.shape) == (1020, 128)
    general = dm.general_tiles(ti, ok)
    assert 0.3 < float(general.float().mean()) < 0.7
    dm.check_pass_records(f32, inst, ti)
    kinds, blends, mask_clips, gen, polygons = dm.dense_dispatch_info(
        f32, inst, ti, dk, ok)
    assert not polygons
    assert gen and set(dm.GENERAL_KINDS) <= set(kinds)
    assert {0, 2, 3, 4, 10, 13} <= set(kinds) and mask_clips
    tr._check_supported(kinds, blends)
    assert tr.instantiation(kinds, blends, mask_clips, gen) == "general"
