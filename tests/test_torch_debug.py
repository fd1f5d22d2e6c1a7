"""The renderer's debug flags on the port, against the JAX package.

* `PROFILER_DBG`: `Renderer.render` draws the profiler overlay
  (`util/debug_overlay.py`) on the RGBA8 image; on
  `tests/test_components.py::test_debug_overlay`'s scene, with the timer
  counters pinned to the same values on both sides, the port's image
  equals the JAX package's bitwise.  Without the flag the image is the
  plain render.
* `GPU_TIME_QUERIES`: `render_device` records one (pass label, ms) per
  pass in `gpu_timers`, with the JAX renderer's labels on
  `::test_per_pass_gpu_timers`' blur scene, and sets the profiler's
  `gpu_time` to their sum.
* `::test_options_and_memory_report`'s assertions on the port.
"""
import numpy as np
import pytest

import webrender_tpu.api as jax_api
from torch_twin import PortFeed
from webrender_tpu.render_backend import RenderBackend as JaxBackend
from webrender_tpu.util import options as jax_options
from webrender_tpu.util.profiler import Profiler as JaxProfiler

from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.util import options as port_options
from webrender_tpu_torch.util.profiler import Profiler

# the timer counters the overlay lists, pinned so that both images show
# the same numbers (each with its budget bar)
PINNED = {"frame_build_time": 1.25, "renderer_time": 10.5,
          "scene_build_time": 0.75}


def _simple_scene(backend, api=jax_api):
    """`test_components.build_simple(with_hit_test=False)`: one green rect."""
    pid = api.PipelineId(0, 1)
    b = api.DisplayListBuilder(pid)
    b.begin()
    root = api.SpatialId.root_scroll_node(pid)
    common = api.CommonItemProperties(api.Rect(0, 0, 1000, 1000), root)
    b.push_rect(common, api.Rect(10, 10, 100, 50), api.ColorF(0, 1, 0, 1))
    _, dl = b.end()
    txn = api.Transaction()
    txn.set_root_pipeline(pid)
    txn.set_display_list(api.Epoch(0), dl)
    txn.generate_frame()
    backend.send_transaction(txn)


def _blur_scene(backend, api=jax_api):
    """`test_components.test_per_pass_gpu_timers`' scene: a rect in a blurred
    stacking context."""
    from webrender_tpu.api.display_item import FilterOp
    pid = api.PipelineId(0, 1)
    b = api.DisplayListBuilder(pid)
    b.begin()
    root = api.SpatialId.root_scroll_node(pid)
    common = api.CommonItemProperties(api.Rect(0, 0, 128, 96), root)
    b.push_stacking_context(api.Point2D(0, 0), root,
                            filters=[FilterOp.blur(2.0, 2.0)])
    b.push_rect(common, api.Rect(8, 8, 60, 40), api.ColorF(1, 0, 0, 1))
    b.pop_stacking_context()
    _, dl = b.end()
    txn = api.Transaction()
    txn.set_root_pipeline(pid)
    txn.set_display_list(api.Epoch(0), dl)
    txn.generate_frame()
    backend.send_transaction(txn)


def _pin(profiler):
    """Make the profiler report the PINNED timer values."""
    get = profiler.get
    profiler.get = lambda name: PINNED[name] if name in PINNED else get(name)


def _jax_render(flags, pin=True):
    backend = JaxBackend((256, 128))
    jax_options.apply_options(backend, jax_options.WebRenderOptions(
        debug_flags=flags, use_pallas_kernels=False))
    if pin:
        _pin(backend.profiler)
    _simple_scene(backend)
    return backend.render()


def _port_render(flags, pin=True):
    backend = RenderBackend((256, 128), device="cpu")
    port_options.apply_options(backend, port_options.WebRenderOptions(
        debug_flags=port_options.DebugFlags(int(flags))))
    if pin:
        _pin(backend.profiler)
    _simple_scene(PortFeed(backend))
    return backend, backend.render()


@pytest.mark.parametrize("pin", [True, False], ids=["pinned", "timed"])
def test_profiler_overlay_equals_jax(pin):
    """Under PROFILER_DBG the port draws the overlay JAX draws: bitwise
    with the timer counters pinned; with real timers, the overlay is there
    (`test_debug_overlay`'s assertion) and the pixels outside the counter
    lines' text and bars equal JAX's."""
    flags = jax_options.DebugFlags.PROFILER_DBG
    backend, img = _port_render(flags, pin)
    assert img.dtype == np.uint8 and img.shape == (128, 256, 4)
    assert (img[:40, :250, 1] > 200).any()
    ref = _jax_render(flags, pin)
    if pin:
        np.testing.assert_array_equal(img, ref)
    else:
        # the timers differ; the passes / instances / dirty-tile lines and
        # everything below the overlay do not
        np.testing.assert_array_equal(img[44:], ref[44:])
    plain = _port_render(jax_options.DebugFlags.NONE, pin)[1]
    assert not np.array_equal(img, plain)


def test_no_flag_renders_the_plain_image():
    """Without PROFILER_DBG the image is the renderer's own, equal to
    JAX's, and no pass is timed."""
    backend, img = _port_render(jax_options.DebugFlags.NONE)
    np.testing.assert_array_equal(
        img, _jax_render(jax_options.DebugFlags.NONE))
    assert backend.renderer.debug_flags == 0
    assert backend.renderer.gpu_timers == []
    assert backend.profiler.get("gpu_time") is None


def test_gpu_timers_equal_jax_labels():
    """Under GPU_TIME_QUERIES each pass records (label, ms) with JAX's
    labels, and the profiler's gpu_time is their sum."""
    ref = JaxBackend((128, 96))
    ref.renderer.debug_flags |= jax_options.DebugFlags.GPU_TIME_QUERIES
    ref.renderer.profiler = JaxProfiler()
    _blur_scene(ref)
    ref.render()
    backend = RenderBackend((128, 96), device="cpu")
    r = backend.renderer
    r.debug_flags |= port_options.DebugFlags.GPU_TIME_QUERIES
    r.profiler = Profiler()
    _blur_scene(PortFeed(backend))
    backend.render()
    labels = [n for n, _ in r.gpu_timers]
    assert labels == [n for n, _ in ref.renderer.gpu_timers]
    assert "raster" in labels and "blur_h" in labels and "blur_v" in labels
    assert all(ms >= 0.0 for _, ms in r.gpu_timers)
    assert r.profiler.get("gpu_time") == sum(ms for _, ms in r.gpu_timers)
    assert r.profiler.get("gpu_time") > 0.0
    # an unchanged frame presents the retained buffer: no pass, the last
    # frame's samples stay
    timers = list(r.gpu_timers)
    backend.renderer.render_device(backend.build_frame())
    assert r.gpu_timers == timers


def test_options_and_memory_report_on_the_port():
    """`test_components.test_options_and_memory_report` on the port."""
    backend = RenderBackend((64, 64), device="cpu")
    port_options.apply_options(backend, port_options.WebRenderOptions(
        debug_flags=port_options.DebugFlags.DISABLE_PICTURE_CACHING))
    assert backend.renderer.picture_caching is False
    report = backend.resources.memory_report()
    assert report["color_atlas"] > 0
