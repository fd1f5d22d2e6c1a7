"""The transformed page of the port against the JAX package, on the CPU:
the tests that need JAX compiles of their own (see
`tests/test_torch_transformed_frame.py` for the frame itself).

* A video tick on the small transformed frame dirties exactly JAX's tiles.
* The twin of `tests/test_pallas_split.py`'s scene.
* A group whose surface passes 4096 px (`scenes.oversized_group_scene`):
  its surface pass has raster step 2, which JAX draws on XLA whole and the
  port with every tile general; the images are equal.
"""
import numpy as np

import webrender_tpu.api as jax_api
import torch_twin as tw
from test_torch_transformed_frame import (VIDEO_SIZE, _assert_close_to_xla,
                                          _port)

from webrender_tpu_torch import scenes
from webrender_tpu_torch.ops import tile_raster as tr
from webrender_tpu_torch.render_backend import RenderBackend

XLA_PIXELS_AFTER_TICK = 40   # the next video frame (measured: 36)


def test_video_tick_dirties_jax_tiles():
    """Picture caching on, then a frame whose only change is the video's
    three planes: the tilted video (an image converted on the host, at a
    new place in the atlas) and its minified preview change; the port
    re-rasters exactly the tiles JAX re-rasters, and the image equals the
    port's uncached render through the same transactions and, but for the
    XLA tiles' contractions, JAX's."""
    ref = tw.jax_transformed_backend(caching=True)
    ref.render()
    scenes.video_tick(ref, 1, VIDEO_SIZE, api=jax_api)
    want = ref.render()
    port = _port(True)
    first = port.render()
    scenes.video_tick(port, 1, VIDEO_SIZE)
    got = port.render()
    assert 0 < port.renderer.last_dirty_tiles < 64
    assert port.renderer.last_dirty_tiles == ref.renderer.last_dirty_tiles
    uncached = _port(False)
    uncached.render()
    scenes.video_tick(uncached, 1, VIDEO_SIZE)
    np.testing.assert_array_equal(got, uncached.render())
    _assert_close_to_xla(got, want, XLA_PIXELS_AFTER_TICK)
    assert (got != first).any()


def test_pallas_split_scene_twin():
    """`tests/test_pallas_split.py`'s scene (solid rects and one rotated
    image on 512x64) through both packages: the JAX renderer splits, the
    port routes two of its four tiles, and the images are equal."""
    from test_pallas_split import _build_scene
    from webrender_tpu.render_backend import RenderBackend as JaxBackend
    ref = JaxBackend((512, 64))
    ref.renderer.use_pallas = True
    ref.renderer.pallas_interpret = True
    _build_scene(ref)
    want = ref.render()
    assert ref.renderer.engine_counts.get("pallas+xla-split", 0) > 0
    np.testing.assert_array_equal(want, ref.render_software())
    port = RenderBackend((512, 64), device="cpu")
    _build_scene(tw.PortFeed(port))
    got = port.render()
    np.testing.assert_array_equal(got, want)
    (general, tiles), = port.renderer.last_general_tiles
    assert tiles == 4 and 0 < general < 4


def test_oversized_surface_rasters_at_step_two():
    """The frame builder rasters an axis-aligned surface wider than 4096
    device pixels at half resolution: a surface pass with `raster_step`
    2.  JAX draws such a pass with `render_tiles(step=2.0)`; the port with
    `step` as a kernel argument and every tile general.  RGBA8 and the
    surface atlas are equal to JAX's, bitwise, and to its numpy oracle."""
    ref = tw.jax_scene(scenes.oversized_group_scene, scenes.OVERSIZED_SIZE)
    want = ref.render()
    assert ref.renderer.engine_counts.get("xla", 0) == 1
    port = scenes.oversized_group_scene(
        RenderBackend(scenes.OVERSIZED_SIZE, device="cpu"))
    frame = port.build_frame()
    steps = [p.raster_step for p in frame.passes]
    assert steps == [2.0, 1.0]
    for caching in (False, True):
        port.renderer.picture_caching = caching
        port.renderer._fb_sig = None
        port.renderer.dispatch_log = log = []
        got = port.render()
        np.testing.assert_array_equal(got, want)
        assert [e["step"] for e in log] == steps
        assert log[0]["general"] and not log[1]["general"]
        nt = frame.passes[0].tile_insts.shape[0]
        assert port.renderer.last_general_tiles[0] == (nt, nt)
        assert tr.instantiation(log[0]["kinds"], log[0]["blends"],
                                log[0]["mask_clips"], log[0]["general"],
                                log[0]["step"]) == "general"
    np.testing.assert_array_equal(got, ref.render_software())
    np.testing.assert_array_equal(port.renderer.surface_atlas.numpy(),
                                  np.asarray(ref.renderer.surface_atlas))
