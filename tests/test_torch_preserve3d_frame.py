"""The CSS-3D page of the port against the JAX package, on the CPU.

The small CSS-3D frame (`scenes.preserve3d_scene`, 1024x512) holds each
group of the 4K CSS-3D page once or twice under `perspective: 1000px`: a
cover-flow row of images, two flip cards (plane surfaces whose turned-away
faces are culled), a cube, crossing solid planes that the frame builder's
BSP splits into fragments clipped to their device polygons (clip kind 3,
on tiles the TPU kernel draws), crossing picture planes (their polygon
clips on plane-surface composites in general tiles) and a tilted text
panel, with a scroll feed at its foot.

* The port's RGBA8 equals the JAX package's numpy oracle
  (`render_software`) bitwise, caching off and on, and the stored golden;
  JAX's own render (uncached: the Pallas kernel in interpret mode, the
  general tiles on XLA; its compiles take most of this file's time, so it
  runs once) is at most `XLA_VALUES` values of one step away.
* The root dispatch holds polygon clips on general records and on the
  others, and says so (`polygon_clips`); it runs the general build.
* The flip animation (`scenes.FLIP_FRAMES`: the first card from 60 to
  120 degrees, across the angle where the frame builder culls its front
  face and draws its back face) on the default path: each frame equals
  the frame of an uncached backend that took the same transactions and
  gathers every record from scratch, the culled faces change once, and
  the 120 degree frame equals the numpy oracle's.  The reference's
  orientation test turns the face between 105 and 120 degrees, not at
  90: it projects a triangle at the card's local origin without the
  reference frame's origin offset (`ROADMAP.md` C).
* A scroll step of the feed: the frame builder's scroll fast path declines
  (the page has plane surfaces and polygon clips) and the frame is built
  in full; it equals the from-scratch twin's and the oracle's.
"""
import numpy as np
import pytest

import torch_twin as tw
from test_torch_transformed_frame import _forget_mirrors
from webrender_tpu.frame.frame_builder import FrameBuilder as JaxFrameBuilder

from webrender_tpu_torch import scenes
from webrender_tpu_torch.api import Point2D
from webrender_tpu_torch.frame.frame_builder import FrameBuilder
from webrender_tpu_torch.ops import tile_raster as tr
from webrender_tpu_torch.render_backend import RenderBackend

NAME, MAKE, SIZE = scenes.PRESERVE3D_FRAME
# values of the small frame one step from JAX's own render, where XLA
# contracts a polygon half-plane (measured: 4, caching off and on)
XLA_VALUES = 4


def _port(caching, flip=None):
    backend = MAKE(RenderBackend(SIZE, device="cpu"), flip=flip)
    backend.renderer.picture_caching = caching
    return backend


@pytest.fixture(scope="module")
def jax_uncached():
    """(backend, device RGBA8, oracle RGBA8) of the JAX package."""
    backend = tw.jax_scene(MAKE, SIZE)
    backend.renderer.picture_caching = False
    return backend, backend.render(), backend.render_software()


def _steps(a, b):
    d = np.abs(a.astype(int) - b.astype(int))
    return int((d > 0).sum()), int(d.max())


@pytest.mark.parametrize("caching", [False, True])
def test_css3d_frame_equals_jax(caching, jax_uncached):
    _, want, oracle = jax_uncached
    np.testing.assert_array_equal(np.load(scenes.GOLDENS)[NAME], oracle)
    port = _port(caching)
    port.renderer.dispatch_log = log = []
    before = tr.LaunchCounts.plain_calls
    got = port.render()
    assert tr.LaunchCounts.plain_calls - before == len(log) >= 2
    np.testing.assert_array_equal(got, oracle)
    n, worst = _steps(got, want)
    assert n <= XLA_VALUES and worst <= 1, (n, worst)
    # the polygon clips reach the kernel's general build
    counts = scenes.css3d_counts(port.build_frame())
    assert counts["polygon_records"] > 0
    assert counts["polygon_records_general"] > 0
    polygon = [e for e in log if e["polygon_clips"]]
    assert polygon and all(
        tr.instantiation(e["kinds"], e["blends"], e["mask_clips"],
                         e["general"], e["step"], e["linear_cm"],
                         e["polygon_clips"]) == "general" for e in polygon)


def test_css3d_frame_cached_equals_uncached_then_retained():
    uncached = _port(False).render()
    port = _port(True)
    np.testing.assert_array_equal(port.render(), uncached)
    before = tr.LaunchCounts.plain_calls
    np.testing.assert_array_equal(port.render(), uncached)
    assert tr.LaunchCounts.plain_calls == before
    assert port.renderer.last_dirty_tiles == 0


def _twins(caching):
    """The backend under test and an uncached twin that takes the same
    transactions and forgets its mirrors before every render."""
    port, twin = _port(caching), _port(False)

    def both(change):
        for b in (port, twin):
            change(b)
        port.renderer.picture_caching = caching
        twin.renderer.picture_caching = False
        _forget_mirrors(twin.renderer)
        got = port.render()
        np.testing.assert_array_equal(got, twin.render())
        return got
    return port, both


def test_flip_animation_through_the_delta_mirrors():
    """The first card's angle stepped from 60 to 120 degrees, caching on:
    each frame equals the from-scratch twin's; the culled faces change
    once, where the JAX package's frame builder changes them; the last
    frame equals the numpy oracle's."""
    port, both = _twins(True)
    first = both(lambda b: None)
    culled = []
    images = []
    for angle in scenes.FLIP_FRAMES:
        with scenes.CulledFaces() as faces:
            images.append(both(lambda b, a=angle: MAKE(b, flip=a)))
        culled.append(frozenset(faces.nodes))
        assert (images[-1] != first).any()
    turn = [i for i in range(1, len(culled)) if culled[i] != culled[i - 1]]
    assert turn == [scenes.FLIP_FRAMES.index(120.0)]
    with scenes.CulledFaces(JaxFrameBuilder) as jax_faces:
        jb = tw.jax_scene(MAKE, SIZE, flip=120.0)
        oracle = jb.render_software()
    assert frozenset(jax_faces.nodes) == culled[-1]
    # the images were added again at other places in the atlas: the frame
    # equals the oracle's but for a few samples' rounding
    n, worst = _steps(images[-1], oracle)
    assert worst <= 1 and n <= 16, (n, worst)
    np.testing.assert_array_equal(_port(False, flip=120.0).render(), oracle)


@pytest.mark.parametrize("caching", [False, True])
def test_scroll_step_builds_the_whole_frame(caching, monkeypatch):
    """The feed scrolled by 7 px: the scroll fast path declines (the page
    has plane surfaces and polygon clips), the frame equals the
    from-scratch twin's and the numpy oracle's, and the feed moved."""
    declined = []
    fast = FrameBuilder._try_scroll_fast_path

    def watch(self, *a, **kw):
        out = fast(self, *a, **kw)
        declined.append(out is None)
        return out
    monkeypatch.setattr(FrameBuilder, "_try_scroll_fast_path", watch)
    port, both = _twins(caching)
    first = both(lambda b: None)

    def scroll(b):
        b.scroll_offsets[scenes.PRESERVE3D_FEED_ID] = [(Point2D(0.0, 7.0),
                                                        0)]
    del declined[:]
    scrolled = both(scroll)
    assert declined and all(declined)
    assert (scrolled != first).any()
    jb = tw.jax_scene(MAKE, SIZE)
    scroll(jb)
    np.testing.assert_array_equal(scrolled, jb.render_software())
