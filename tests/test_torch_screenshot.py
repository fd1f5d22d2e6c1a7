"""Screenshots on the port (`Renderer.get_screenshot`, `request_screenshot`,
`map_screenshot`; `ops/resize.py`) against the JAX package, on the CPU.

* `ops/resize.py`'s weight matrices equal `jax.image.resize`'s
  (`compute_weight_mat`) bitwise.  Its resize of u8-grid images equals
  `jax.image.resize(..., "linear")` on the RGBA8 grid but at exact ties,
  one step apart, at most `RESIZE_CASES`' counts: XLA sums the column
  contraction in an order of its own (the rows' equals the port's chain
  of multiply-adds here).
* Twins of `tests/test_components.py::test_multi_document_and_screenshot`
  and `tests/test_rawtest.py::test_async_screenshot_grabber`, and the
  screenshots of one frame against the JAX renderer's.
* A requested screenshot outlives later frames (the port updates its
  framebuffers in place; the request copies its crop on the device).
* Two documents of one size, rendered in turn with picture caching on,
  scroll slices included, equal fresh backends: the JAX package clears
  the renderer's root tiles on a document switch
  (`webrender_tpu/render_backend.py:397-403`); the port does not, and
  needs not (its tile hashes and shape key decide).
"""
import numpy as np
import pytest
import torch

import webrender_tpu.api as jax_api
from torch_twin import PortFeed

from webrender_tpu_torch import api as port_api
from webrender_tpu_torch.api.transaction import DocumentId
from webrender_tpu_torch.ops import resize
from webrender_tpu_torch.render_backend import (MultiDocumentBackend,
                                                RenderBackend)

# (C, H, W) -> (out_h, out_w): (max u8 steps, values at most) against
# jax.image.resize on seeded u8-grid images
RESIZE_CASES = {((4, 48, 64), (24, 32)): (1, 3),     # 2x down
                ((4, 48, 64), (48, 32)): (1, 151),   # columns only, 2x
                ((4, 48, 64), (96, 64)): (0, 0),     # rows only, up
                ((4, 33, 57), (17, 80)): (0, 0),     # odd sizes
                ((4, 64, 64), (16, 16)): (0, 0),     # 4x down
                ((4, 100, 70), (130, 33)): (1, 1),   # up and down
                ((4, 37, 53), (37, 53)): (0, 0)}     # unchanged


def _u8(v):
    v = np.asarray(v, np.float64) * 255.0
    return np.clip(np.floor(v + 0.5), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("m,n", [(64, 16), (100, 37), (37, 100), (255, 256),
                                 (3840, 1920), (2160, 1080), (7, 3)])
def test_resize_weights_equal_jax(m, n):
    from jax._src.image.scale import (_fill_triangle_kernel,
                                      compute_weight_mat)
    want = np.asarray(compute_weight_mat(m, n, n / m, 0.0,
                                         _fill_triangle_kernel, True))
    np.testing.assert_array_equal(resize._weights_host(m, n), want)


@pytest.mark.parametrize("shape,out", list(RESIZE_CASES))
def test_resize_against_jax_image_resize(shape, out):
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(sum(shape) + sum(out))
    x = (rng.integers(0, 256, shape) / 255.0).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (4,) + out,
                                       "linear"))
    got = resize.resize(torch.from_numpy(x), *out).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    # XLA's sums are the farther from the exact ones (2.2e-6 in the
    # up-and-down case, the port's 1e-7)
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-6)
    diff = np.abs(_u8(got).astype(int) - _u8(want))
    steps, count = RESIZE_CASES[(shape, out)]
    assert diff.max() <= steps
    assert int((diff > 0).sum()) <= count


def _rects(backend, api, size, colors, epoch=0):
    """Two overlapping rects over a backdrop on `backend`."""
    pid = api.PipelineId(0, 1)
    b = api.DisplayListBuilder(pid)
    b.begin()
    root = api.SpatialId.root_scroll_node(pid)
    common = api.CommonItemProperties(api.Rect(0, 0, 4096, 4096), root)
    w, h = size
    b.push_rect(common, api.Rect(0, 0, w, h), api.ColorF(*colors[0]))
    b.push_rect(common, api.Rect(5, 7, w * 0.6, h * 0.5),
                api.ColorF(*colors[1]))
    b.push_rect(common, api.Rect(w * 0.3, h * 0.35, w * 0.6, h * 0.55),
                api.ColorF(*colors[2]))
    _, dl = b.end()
    txn = api.Transaction()
    txn.set_root_pipeline(pid)
    txn.set_display_list(api.Epoch(epoch), dl)
    txn.generate_frame()
    backend.send_transaction(txn)


COLORS = ((0.95, 0.95, 0.97, 1.0), (0.2, 0.5, 0.8, 1.0),
          (0.9, 0.4, 0.1, 0.7))
OTHER = ((0.1, 0.1, 0.1, 1.0), (0.7, 0.7, 0.2, 1.0), (0.3, 0.9, 0.6, 0.6))


# (rect, size) of a screenshot of `test_screenshots_against_jax_renderer`'s
# frame: the values at most one step from the JAX renderer's (exact ties of
# the column contraction)
SHOTS = {((0, 0, 150, 100), None): 0, ((10, 5, 64, 48), None): 0,
         ((140, 90, 20, 20), None): 0,  # moved inside, as dynamic_slice
         ((10, 5, 64, 48), (32, 24)): 0, (None, (75, 50)): 28,
         ((3, 9, 101, 67), (40, 90)): 0, (None, (150, 41)): 0,
         (None, (301, 100)): 0}


def test_screenshots_against_jax_renderer():
    from webrender_tpu.render_backend import RenderBackend as JaxBackend
    size = (150, 100)
    jax_b = JaxBackend(size)
    port_b = RenderBackend(size, device="cpu")
    _rects(jax_b, jax_api, size, COLORS)
    _rects(PortFeed(port_b), jax_api, size, COLORS)
    np.testing.assert_array_equal(port_b.render(), jax_b.render())
    for (rect, shot), ties in SHOTS.items():
        want = jax_b.renderer.get_screenshot(rect, shot)
        got = port_b.renderer.get_screenshot(rect, shot)
        assert got.shape == want.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want)
        assert diff.max() <= 1 and int((diff > 0).sum()) <= ties, (rect, shot)


def test_multi_document_and_screenshot():
    host = MultiDocumentBackend(device="cpu")
    did = DocumentId(0, 7)
    host.add_document(did, (64, 64))
    A = port_api
    pid = A.PipelineId(0, 9)
    b = A.DisplayListBuilder(pid)
    b.begin()
    root = A.SpatialId.root_scroll_node(pid)
    b.push_rect(A.CommonItemProperties(A.Rect(0, 0, 64, 64), root),
                A.Rect(0, 0, 64, 64), A.ColorF(1, 0, 0, 1))
    _, dl = b.end()
    txn = A.Transaction()
    txn.set_root_pipeline(pid)
    txn.set_display_list(A.Epoch(0), dl)
    txn.generate_frame()
    host.send_transaction(did, txn)
    img = host.render(did)
    assert tuple(img[32, 32]) == (255, 0, 0, 255)
    shot = host.renderer.get_screenshot((0, 0, 64, 64), (16, 16))
    assert shot.shape == (16, 16, 4)
    assert tuple(shot[8, 8]) == (255, 0, 0, 255)


def test_async_screenshot_grabber():
    from webrender_tpu.render_backend import RenderBackend as JaxBackend
    size = (64, 48)
    colors = ((0.2, 0.5, 0.8, 1.0),) * 3
    backend = RenderBackend(size, device="cpu")
    r = backend.renderer
    assert r.request_screenshot() == -1 and r.get_screenshot() is None
    _rects(backend, port_api, size, colors)
    backend.render()  # populates last_framebuffer
    h1 = r.request_screenshot(rect=(8, 8, 32, 16))
    h2 = r.request_screenshot(rect=(0, 0, 64, 48), size=(32, 24))
    a = r.map_screenshot(h1)
    assert a is not None and a.shape == (16, 32, 4)
    sync = r.get_screenshot(rect=(8, 8, 32, 16))
    assert (a == sync).all()
    b2 = r.map_screenshot(h2)
    assert b2 is not None and b2.shape == (24, 32, 4)
    assert r.map_screenshot(h1) is None  # handle recycled
    # the JAX renderer's on the same frame
    jax_b = JaxBackend(size)
    _rects(jax_b, jax_api, size, colors)
    jax_b.render()
    jr = jax_b.renderer
    np.testing.assert_array_equal(
        a, jr.map_screenshot(jr.request_screenshot(rect=(8, 8, 32, 16))))
    np.testing.assert_array_equal(b2, jr.map_screenshot(
        jr.request_screenshot(rect=(0, 0, 64, 48), size=(32, 24))))


@pytest.mark.parametrize("caching", [True, False])
def test_request_outlives_later_frames(caching):
    """A request taken on one frame maps to that frame's pixels after two
    later frames (the second unchanged, which returns the retained
    framebuffer) have been rendered, unscaled and scaled."""
    size = (300, 140)
    backend = RenderBackend(size, device="cpu")
    r = backend.renderer
    r.picture_caching = caching
    _rects(backend, port_api, size, COLORS)
    first = backend.render()
    fb_first = r.last_framebuffer
    kept = fb_first.clone()
    crops = [((20, 10, 200, 100), None), ((0, 0, 300, 140), (150, 70)),
             (None, None)]
    handles = [r.request_screenshot(rect, shot) for rect, shot in crops]
    want = [r.get_screenshot(rect, shot) for rect, shot in crops]
    _rects(backend, port_api, size, OTHER, epoch=1)
    second = backend.render()
    again = backend.render()
    assert not np.array_equal(first, second)
    np.testing.assert_array_equal(again, second)
    for h, w in zip(handles, want):
        np.testing.assert_array_equal(r.map_screenshot(h), w)
    # no later frame wrote into the first frame's framebuffer
    assert torch.equal(fb_first, kept)
    np.testing.assert_array_equal(r.get_screenshot(), second)


def _document(backend, shade, feed_scroll=0.0):
    """A small page with a scroll frame (picture-cache slices), its colours
    from `shade`; the left column is the same in every document."""
    A = port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    root = A.SpatialId.root_scroll_node(pid)
    common = A.CommonItemProperties(A.Rect(0, 0, 512, 256), root)
    b.push_rect(common, A.Rect(0, 0, 512, 256), A.ColorF(0.9, 0.9, 0.92, 1))
    b.push_rect(common, A.Rect(8, 8, 100, 240), A.ColorF(0.3, 0.3, 0.3, 1))
    feed = b.define_scroll_frame(root, external_id=777,
                                 content_rect=A.Rect(200, 0, 300, 2000),
                                 frame_rect=A.Rect(200, 0, 300, 256))
    fc = A.CommonItemProperties(A.Rect(0, 0, 512, 2000), feed)
    for i in range(12):
        b.push_rect(fc, A.Rect(210, 10 + 150 * i, 280, 130),
                    A.ColorF(shade, 0.4 + 0.04 * i, 1 - shade, 1))
    b.push_rect(common, A.Rect(130, 40 + 60 * shade, 50, 50),
                A.ColorF(1 - shade, shade, 0.5, 0.8))
    _, dl = b.end()
    txn = A.Transaction()
    txn.set_root_pipeline(pid)
    txn.set_display_list(A.Epoch(0), dl)
    txn.generate_frame()
    backend.send_transaction(txn)
    if feed_scroll:
        backend.scroll_offsets[777] = [(A.Point2D(0.0, feed_scroll), 0)]


def test_two_documents_in_turn_equal_fresh_backends():
    size = (512, 256)
    host = MultiDocumentBackend(device="cpu")
    docs = {DocumentId(0, 1): 0.2, DocumentId(0, 2): 0.8}
    for did, shade in docs.items():
        host.add_document(did, size)
        _document(host.documents[did], shade)
    assert host.renderer.picture_caching
    dirty = []
    for step, scroll in enumerate((0.0, 0.0, 37.0, 37.0, 150.0)):
        for did, shade in docs.items():
            if scroll:
                host.documents[did].scroll_offsets[777] = [
                    (port_api.Point2D(0.0, scroll), 0)]
            img = host.render(did)
            fresh = RenderBackend(size, device="cpu")
            _document(fresh, shade, scroll)
            np.testing.assert_array_equal(img, fresh.render(),
                                          err_msg=f"step {step} {did}")
            dirty.append(host.renderer.last_dirty_tiles)
    # a switch re-rasters fewer tiles than the first frame: the tiles the
    # documents share stay cached across the switch
    assert 0 <= min(dirty[1:]) < dirty[0]
