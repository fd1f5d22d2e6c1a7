"""Twins of tests/test_rawtest.py (wrench's rawtest.rs suite) on the port,
on the CPU.

Each twin runs the JAX test's API flow on the JAX package's backend and
on two of the port's (`torch_twin.Trio`): the port's default path
(picture caching on, the kernel's plain version) and the same with
caching off.  Where the JAX test renders through `render_software`, the
port's cached image equals it bitwise (tolerance 0 throughout), and
equals the port's uncached render and its `render_software` with
float32 `where`s, bitwise; the JAX test's own pixel assertions are made
on the port's image.  Where the JAX test is about state (a hit test, a
handler's lock counts, a refusal), the port's state equals JAX's.

`test_async_screenshot_grabber` and `test_capture_roundtrip` were twinned
before (`tests/test_torch_screenshot.py`, `tests/test_torch_capture.py`).
"""
import struct

import numpy as np
import pytest

import webrender_tpu.api as jax_api
from torch_twin import Trio, side

import webrender_tpu_torch.api as port_api
from webrender_tpu_torch.scenes import image_rect, tiles_sampling
from webrender_tpu_torch.render_backend import RenderBackend


def _pid(A):
    return A.PipelineId(0, 1)


def _flow(fill, epoch=0, pre=None):
    """The JAX test's `_render_dl`: `pre(A, txn, backend)` adds resources,
    `fill(A, b, common, root)` the items of one display list."""
    def flow(A, backend):
        pid = _pid(A)
        b = A.DisplayListBuilder(pid)
        b.begin()
        root = A.SpatialId.root_scroll_node(pid)
        common = A.CommonItemProperties(A.Rect(0, 0, 4096, 4096), root)
        fill(A, b, common, root)
        _, dl = b.end()
        txn = A.Transaction()
        if pre is not None:
            pre(A, txn, backend)
        txn.set_root_pipeline(pid)
        txn.set_display_list(A.Epoch(epoch), dl)
        txn.generate_frame()
        backend.send_transaction(txn)
    return flow


def _render(trio, fill, epoch=0, pre=None):
    trio.send(_flow(fill, epoch, pre))
    return trio.render()


def _solid_px(w, h, rgba):
    img = np.zeros((h, w, 4), np.uint8)
    img[:] = rgba
    return img


def _image(key, x, y, w, h):
    return lambda A, b, c, r: b.push_image(
        c, A.Rect(x, y, w, h), A.ImageRendering.AUTO,
        A.AlphaType.PREMULTIPLIED_ALPHA, key)


def test_resize_image():
    trio = Trio((128, 128))
    red = _solid_px(64, 64, (255, 0, 0, 255))
    img1 = _render(trio, _image(1, 0, 0, 64, 64), pre=lambda A, t, _: (
        t.add_image(1, A.ImageDescriptor(A.ImageFormat.RGBA8, 64, 64),
                    A.ImageData(pixels=red))))
    assert tuple(img1[10, 10][:3]) == (255, 0, 0)
    img2 = _render(trio, _image(1, 0, 0, 128, 128), 1, lambda A, t, _: (
        t.update_image(1, A.ImageDescriptor(A.ImageFormat.RGBA8, 128, 128),
                       A.ImageData(pixels=_solid_px(128, 128,
                                                    (0, 255, 0, 255))))))
    assert tuple(img2[10, 10][:3]) == (0, 255, 0)
    assert tuple(img2[120, 120][:3]) == (0, 255, 0)


def test_very_large_image_sub_rect():
    w = h = 5000
    px = np.zeros((h, w, 4), np.uint8)
    px[..., 1] = 200
    px[..., 3] = 255
    px[:100, :100, 0] = 255
    trio = Trio((256, 128))
    img = _render(trio, _image(2, 0, 0, w, h), pre=lambda A, t, _: (
        t.add_image(2, A.ImageDescriptor(A.ImageFormat.RGBA8, w, h),
                    A.ImageData(pixels=px))))
    assert tuple(img[60, 60][:3]) == (255, 200, 0)
    assert tuple(img[120, 200][:3]) == (0, 200, 0)


def _checker(backend):
    rc = side(backend, "resources.resource_cache")
    backend.resources.set_blob_image_handler(rc.CheckerboardBlobHandler())


def test_blob_rasterization_and_update():
    trio = Trio((96, 96))
    for backend in trio.backends:
        _checker(backend)
    img = _render(trio, _image(7, 0, 0, 64, 64), pre=lambda A, t, _: (
        t.add_blob_image(7, A.ImageDescriptor(A.ImageFormat.RGBA8, 64, 64),
                         struct.pack("<iBBB", 16, 255, 0, 0))))
    assert tuple(img[8, 8][:3]) == (255, 255, 255)
    assert tuple(img[8, 24][:3]) == (255, 0, 0)
    blue = struct.pack("<iBBB", 16, 0, 0, 255)
    img2 = _render(trio, _image(7, 0, 0, 64, 64), 1, lambda A, t, _: (
        t.update_image(7, A.ImageDescriptor(A.ImageFormat.RGBA8, 64, 64),
                       A.ImageData(blob=blue))))
    assert tuple(img2[8, 24][:3]) == (0, 0, 255)


def test_zero_height_window():
    """The degenerate framebuffer builds a frame equal to JAX's, and the
    port renders it (an empty image) on its default path and uncached."""
    trio = Trio((128, 0))
    trio.send(_flow(lambda A, b, c, r: b.push_rect(
        A.CommonItemProperties(A.Rect(0, 0, 128, 0), r),
        A.Rect(0, 0, 100, 100), A.ColorF(1, 0, 0, 1))))
    frames = [backend.build_frame() for backend in trio.backends]
    assert all(f is not None for f in frames)
    want, got = frames[0], frames[1]
    np.testing.assert_array_equal(got.instances, want.instances)
    np.testing.assert_array_equal(got.f32_buf, want.f32_buf)
    assert len(got.passes) == len(want.passes)
    img = trio.port.render()
    assert img.shape == (0, 128, 4)
    np.testing.assert_array_equal(img, trio.flat.render())


def test_clear_caches_and_rerender():
    trio = Trio((96, 96))
    fill = _image(3, 8, 8, 48, 48)
    img1 = _render(trio, fill, pre=lambda A, t, _: (
        t.add_image(3, A.ImageDescriptor(A.ImageFormat.RGBA8, 48, 48),
                    A.ImageData(pixels=_solid_px(48, 48,
                                                 (10, 20, 200, 255))))))
    for backend in trio.backends:
        backend.resources.memory_pressure()
    img2 = _render(trio, fill, epoch=1)
    assert np.array_equal(img1, img2)


def test_hit_test_through_stack():
    """The port's hits equal JAX's at each point, and the JAX test's."""
    trio = Trio((256, 256))

    def fill(A, b, c, root):
        flags = A.PrimitiveFlags.IS_BACKFACE_VISIBLE
        b.push_hit_test(A.Rect(10, 10, 100, 100), None, root, flags, (1, 1))
        b.push_hit_test(A.Rect(50, 50, 100, 100), None, root, flags, (2, 2))
    trio.send(_flow(fill))
    for (x, y), tags in (((60, 60), [(2, 2), (1, 1)]),
                         ((20, 20), [(1, 1)]), ((200, 200), [])):
        want = trio.jax.hit_test(jax_api.Point2D(x, y))
        got = trio.port.hit_test(port_api.Point2D(x, y))
        assert [h.tag for h in got] == [h.tag for h in want] == tags
        assert [(h.point_relative_to_item.x, h.point_relative_to_item.y)
                for h in got] == \
            [(h.point_relative_to_item.x, h.point_relative_to_item.y)
             for h in want]


def test_blur_stability_across_frames():
    trio = Trio((128, 128))

    def fill(A, b, c, r):
        b.push_stacking_context(A.Point2D(0, 0), r,
                                filters=[A.FilterOp.blur(3.0, 3.0)])
        b.push_rect(c, A.Rect(30, 30, 60, 60), A.ColorF(0.8, 0.1, 0.2, 1.0))
        b.pop_stacking_context()
    img1 = _render(trio, fill)
    img2 = _render(trio, fill, epoch=1)
    assert np.array_equal(img1, img2)


def test_tile_decomposition_repeating_image():
    trio = Trio((200, 120))
    img = _render(trio, lambda A, b, c, r: b.push_repeating_image(
        c, A.Rect(0, 0, 200, 120), A.Size2D(16, 16), A.Size2D(16, 16),
        A.ImageRendering.AUTO, A.AlphaType.PREMULTIPLIED_ALPHA, 9),
        pre=lambda A, t, _: t.add_image(
            9, A.ImageDescriptor(A.ImageFormat.RGBA8, 16, 16),
            A.ImageData(pixels=_solid_px(16, 16, (200, 30, 30, 255)))))
    assert tuple(img[8, 8][:3]) == (200, 30, 30)
    assert tuple(img[8, 24][:3]) == (255, 255, 255)
    assert tuple(img[8, 40][:3]) == (200, 30, 30)


def test_save_restore_display_list():
    trio = Trio((96, 96))

    def fill(A, b, c, r):
        b.push_rect(c, A.Rect(0, 0, 96, 96), A.ColorF(1, 1, 1, 1))
        b.save()
        b.push_rect(c, A.Rect(0, 0, 50, 50), A.ColorF(1, 0, 0, 1))
        b.restore()
        b.push_rect(c, A.Rect(60, 60, 20, 20), A.ColorF(0, 0, 1, 1))
    img = _render(trio, fill)
    assert tuple(img[10, 10][:3]) == (255, 255, 255)
    assert tuple(img[65, 65][:3]) == (0, 0, 255)


def test_external_image_lock_unlock_and_refresh():
    """The handler's lock and unlock counts on the port's default path
    and uncached equal JAX's after each frame; the refresh is a
    resource-only frame (C2 on the port: its tile hashes are unchanged)."""
    trio = Trio((64, 64))
    handlers = []

    def first(A, backend):
        img_mod = side(backend, "api.image")

        class Handler(img_mod.ExternalImageHandler):
            def __init__(self):
                self.pixels = _solid_px(8, 8, (255, 0, 0, 255))
                self.gen = 1
                self.locks = 0
                self.unlocks = 0

            def lock(self, id, channel_index):
                self.locks += 1
                return img_mod.ExternalImage(pixels=self.pixels,
                                             generation=self.gen)

            def unlock(self, id, channel_index):
                self.unlocks += 1

        handlers.append(Handler())
        backend.resources.set_external_image_handler(handlers[-1])
        _flow(_image(7, 0, 0, 64, 64), pre=lambda A, t, _: t.add_image(
            7, A.ImageDescriptor(A.ImageFormat.RGBA8, 8, 8),
            A.ImageData(external=img_mod.ExternalImageData(
                img_mod.ExternalImageId(42)))))(A, backend)
    trio.send(first)
    jax_h, port_h, flat_h = handlers
    for frame in (1, 2):
        if frame == 2:
            for h in handlers:
                h.pixels = _solid_px(8, 8, (0, 255, 0, 255))
                h.gen = 2

            def refresh(A, backend):
                txn = A.Transaction()
                txn.generate_frame()
                backend.send_transaction(txn)
            trio.send(refresh)
        want = trio.jax.render_software()
        got = trio.port.render()
        assert (port_h.locks, port_h.unlocks) == \
            (jax_h.locks, jax_h.unlocks) == (frame, frame)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, trio.flat.render())
        assert (flat_h.locks, flat_h.unlocks) == (frame, frame)
        assert (got[32, 32] == ([255, 0, 0, 255] if frame == 1
                                else [0, 255, 0, 255])).all()
    assert trio.port.renderer.last_dirty_tiles == tiles_sampling(
        trio.port.last_frame, image_rect(trio.port, 7)) == 1
    # last: the oracle's frame build locks the handler once more
    np.testing.assert_array_equal(
        got, trio.port.render_software(float32=True))


def test_reuse_items_across_epochs():
    trio = Trio((96, 64))
    keys = {}

    def fill0(A, b, common, root):
        b.push_rect(common, A.Rect(0, 0, 96, 64), A.ColorF(1, 1, 1, 1))
        b.start_item_group()
        b.push_rect(common, A.Rect(8, 8, 40, 24), A.ColorF(1, 0, 0, 1))
        b.push_rect(common, A.Rect(20, 20, 40, 24), A.ColorF(0, 0, 1, 0.5))
        keys[A.__name__] = b.finish_item_group()
    img0 = _render(trio, fill0)
    assert keys[jax_api.__name__] is not None
    assert keys[port_api.__name__] == keys[jax_api.__name__]

    def fill1(A, b, common, root):
        b.push_rect(common, A.Rect(0, 0, 96, 64), A.ColorF(1, 1, 1, 1))
        b.push_reuse_items(keys[A.__name__])
    img1 = _render(trio, fill1, epoch=1)
    assert (img0 == img1).all()
    for backend in (trio.port, trio.jax):
        assert not backend.scene.pipelines[(0, 1)].cache_data


def test_reuse_items_missing_group_fails_loudly():
    """Both packages refuse a ReuseItems key with no retained group, with
    the same exception type."""
    raised = []
    for A, backend in ((jax_api, Trio((32, 32)).jax),
                       (port_api, RenderBackend((32, 32), device="cpu"))):
        with pytest.raises(Exception) as info:
            _flow(lambda A, b, c, r: b.push_reuse_items(12345))(A, backend)
            backend.render()
        raised.append(type(info.value).__name__)
    assert raised[0] == raised[1]


def test_blob_visible_area():
    trio = Trio((96, 96))
    for backend in trio.backends:
        _checker(backend)

    def pre(A, t, _):
        t.add_blob_image(9, A.ImageDescriptor(A.ImageFormat.RGBA8, 96, 96),
                         struct.pack("<iBBB", 16, 255, 0, 0))
        t.set_blob_image_visible_area(9, (16, 16, 80, 80))
    img = _render(trio, _image(9, 0, 0, 96, 96), pre=pre)
    assert tuple(img[24, 24][:3]) == (255, 255, 255)
    assert tuple(img[24, 40][:3]) == (255, 0, 0)
    assert tuple(img[8, 24][:3]) == (255, 255, 255)
    assert tuple(img[90, 90][:3]) == (255, 255, 255)


def test_blob_set_visible_area():
    """The move re-sends the display list; on the port's default path the
    blob's tiles re-raster though their hashes are equal (C2)."""
    trio = Trio((96, 96))
    for backend in trio.backends:
        _checker(backend)

    def pre(A, t, _):
        t.add_blob_image(9, A.ImageDescriptor(A.ImageFormat.RGBA8, 96, 96),
                         struct.pack("<iBBB", 16, 0, 200, 0))
        t.set_blob_image_visible_area(9, (0, 0, 48, 48))
    img = _render(trio, _image(9, 0, 0, 96, 96), pre=pre)
    assert tuple(img[8, 8][:3]) == (255, 255, 255)
    assert tuple(img[8, 24][:3]) == (0, 200, 0)
    assert tuple(img[80, 72][:3]) == (255, 255, 255)
    img2 = _render(trio, _image(9, 0, 0, 96, 96), 1,
                   lambda A, t, _: t.set_blob_image_visible_area(
                       9, (48, 48, 96, 96)))
    assert tuple(img2[8, 24][:3]) == (255, 255, 255)
    assert tuple(img2[80, 72][:3]) == (0, 200, 0)
    assert trio.port.renderer.last_dirty_tiles == 2


def test_retained_blob_update_without_new_display_list():
    """The resource-only blob update on the port's default path (C2)."""
    trio = Trio((64, 64))
    for backend in trio.backends:
        _checker(backend)
    img = _render(trio, _image(4, 0, 0, 64, 64), pre=lambda A, t, _: (
        t.add_blob_image(4, A.ImageDescriptor(A.ImageFormat.RGBA8, 64, 64),
                         struct.pack("<iBBB", 16, 255, 0, 0))))
    assert tuple(img[8, 24][:3]) == (255, 0, 0)

    def update(A, backend):
        txn = A.Transaction()
        txn.update_image(4, A.ImageDescriptor(A.ImageFormat.RGBA8, 64, 64),
                         A.ImageData(blob=struct.pack("<iBBB", 16, 0, 0,
                                                      255)))
        txn.generate_frame()
        backend.send_transaction(txn)
    trio.send(update)
    img2 = trio.render()
    assert tuple(img2[8, 24][:3]) == (0, 0, 255)
    assert trio.port.renderer.last_dirty_tiles == 1
