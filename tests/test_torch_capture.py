"""Capture replay on the port (`util/capture.py`), on the CPU.

A capture pickles the package's own classes, so a capture that the JAX
package saved names that package's classes and cannot be loaded by the
port without importing JAX.  The twins hold the port's own save, load
and render round trip against the JAX package's own round trip on the
same display list:

* `tests/test_components.py::test_capture_replay` and
  `tests/test_rawtest.py::test_capture_roundtrip` with
  `load_capture(device="cpu")`: the replay's oracle image equals the
  original's and the JAX package's replay, and its device render (the
  kernel's plain version here) equals the JAX package's render;
* `load_capture` and `show` make their backend on the device they are
  given (before, `load_capture` always made it on the card), and `show`
  imports PIL only to write a PNG.
"""
import sys

import numpy as np

import webrender_tpu.api as jax_api
from torch_twin import PortFeed
from webrender_tpu.render_backend import RenderBackend as JaxBackend
from webrender_tpu.util import capture as jax_capture

from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.util.capture import load_capture, save_capture, show


def _build_simple(backend, api=jax_api):
    """`test_components.build_simple(with_hit_test=False)`."""
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


def _two_rects(backend, api=jax_api, image=False):
    """`test_rawtest.test_capture_roundtrip`'s display list, with a
    gradient beside it; `image`: and an image."""
    pid = api.PipelineId(0, 1)
    b = api.DisplayListBuilder(pid)
    b.begin()
    root = api.SpatialId.root_scroll_node(pid)
    c = api.CommonItemProperties(api.Rect(0, 0, 4096, 4096), root)
    b.push_rect(c, api.Rect(4, 4, 64, 40), api.ColorF(0.2, 0.5, 0.8, 1.0))
    b.push_rect(c, api.Rect(30, 30, 64, 40), api.ColorF(0.9, 0.4, 0.1, 0.7))
    g, stops = b.create_gradient(
        api.Point2D(0, 0), api.Point2D(40, 0),
        [api.GradientStop(0.0, api.ColorF(1, 0.2, 0.1, 1)),
         api.GradientStop(1.0, api.ColorF(0.1, 0.3, 1, 1))],
        api.ExtendMode.CLAMP)
    b.push_gradient(c, api.Rect(80, 50, 40, 30), g, stops)
    txn = api.Transaction()
    if image:
        b.push_image(c, api.Rect(70, 8, 32, 24), api.ImageRendering.AUTO,
                     api.AlphaType.PREMULTIPLIED_ALPHA, 5)
        px = (np.random.RandomState(2).rand(24, 32, 4) * 255).astype(
            np.uint8)
        px[..., 3] = 255
        txn.add_image(5, api.ImageDescriptor(api.ImageFormat.RGBA8, 32, 24),
                      api.ImageData(pixels=px))
    _, dl = b.end()
    txn.set_root_pipeline(pid)
    txn.set_display_list(api.Epoch(0), dl)
    txn.generate_frame()
    backend.send_transaction(txn)


def test_capture_replay(tmp_path):
    backend = RenderBackend((256, 128), device="cpu")
    _build_simple(PortFeed(backend))
    img1 = backend.render_software()
    backend.save_capture(str(tmp_path / "cap"))
    restored = load_capture(str(tmp_path / "cap"), device="cpu")
    assert restored.renderer.device.type == "cpu"
    img2 = restored.render_software()
    assert np.array_equal(img1, img2)
    # the JAX package's own round trip
    jax_b = JaxBackend((256, 128))
    _build_simple(jax_b)
    jax_b.save_capture(str(tmp_path / "jax"))
    jax_img = jax_capture.load_capture(str(tmp_path / "jax")) \
        .render_software()
    np.testing.assert_array_equal(img2, jax_img)
    np.testing.assert_array_equal(restored.render(), img1)


def test_capture_roundtrip(tmp_path):
    backend = RenderBackend((128, 96), device="cpu")
    _two_rects(PortFeed(backend))
    img1 = backend.render_software()
    device_img = backend.render()
    root = str(tmp_path / "capture")
    save_capture(backend, root)
    loaded = load_capture(root, device="cpu")
    img2 = loaded.render_software()
    assert np.array_equal(img1, img2)
    np.testing.assert_array_equal(loaded.render(), device_img)
    # the JAX package's own round trip on the same display list
    jax_b = JaxBackend((128, 96))
    _two_rects(jax_b)
    jax_b.render()
    jax_capture.save_capture(jax_b, str(tmp_path / "jax"))
    jax_loaded = jax_capture.load_capture(str(tmp_path / "jax"))
    np.testing.assert_array_equal(img2, jax_loaded.render_software())
    np.testing.assert_array_equal(device_img, jax_loaded.render())


def test_capture_of_an_image_replays_as_jax_does(tmp_path):
    """A replay draws an image of the captured frame as the JAX package's
    replay does: not at all (the capture pickles each image template with
    its atlas region and `uploaded_generation`, so the replay's resource
    cache takes the texels as uploaded into an atlas that is empty)."""
    backend = RenderBackend((128, 96), device="cpu")
    _two_rects(PortFeed(backend), image=True)
    with_image = backend.render()
    backend.save_capture(str(tmp_path / "cap"))
    replay = load_capture(str(tmp_path / "cap"), device="cpu")
    jax_b = JaxBackend((128, 96))
    _two_rects(jax_b, image=True)
    np.testing.assert_array_equal(with_image, jax_b.render())
    jax_b.save_capture(str(tmp_path / "jax"))
    jax_replay = jax_capture.load_capture(str(tmp_path / "jax"))
    got = replay.render()
    np.testing.assert_array_equal(got, jax_replay.render())
    np.testing.assert_array_equal(replay.render_software(),
                                  jax_replay.render_software())
    assert not np.array_equal(got, with_image)


def test_show_renders_on_the_device_given(tmp_path, monkeypatch):
    backend = RenderBackend((128, 96), device="cpu")
    _two_rects(PortFeed(backend))
    want = backend.render()
    backend.save_capture(str(tmp_path / "cap"))
    # no PIL without a PNG to write (the card's machine has none)
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = show(str(tmp_path / "cap"), device="cpu")
    np.testing.assert_array_equal(img, want)
