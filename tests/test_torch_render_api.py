"""The port's threaded `RenderApi` (`render_api.py`) on the CPU, against the
JAX package: twins of `tests/test_render_api.py`, and a low-priority
transaction flushed before a hit test.

`create_webrender_instance(device="cpu")` runs the scene builder and the
backend on their own threads and the render on the caller's, as the JAX
package does; its images equal the JAX instance's on the same
transactions, bitwise.
"""
import threading

import numpy as np

import webrender_tpu.api as jax_api
from torch_twin import to_port
from webrender_tpu.render_api import (
    create_webrender_instance as jax_create_webrender_instance)

from webrender_tpu_torch.api import (CommonItemProperties,
                                     DisplayListBuilder, Epoch, PipelineId,
                                     Point2D, Rect, SpatialId, Transaction)
from webrender_tpu_torch.render_api import (RenderNotifier,
                                            WebRenderInstance,
                                            create_webrender_instance)


def _rect_txn(A, color=(1, 0, 0, 1), hit_tag=None):
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    root = A.SpatialId.root_scroll_node(pid)
    b.push_rect(A.CommonItemProperties(A.Rect(0, 0, 1000, 1000), root),
                A.Rect(0, 0, 64, 64), A.ColorF(*color))
    if hit_tag is not None:
        b.push_hit_test(A.Rect(0, 0, 64, 64), None, root,
                        A.PrimitiveFlags.IS_BACKFACE_VISIBLE, hit_tag)
    _, dl = b.end()
    txn = A.Transaction()
    txn.set_root_pipeline(pid)
    txn.set_display_list(A.Epoch(0), dl)
    txn.generate_frame()
    return txn


def test_threaded_pipeline():
    ready = threading.Event()
    notifier = RenderNotifier(new_frame_ready=ready.set)
    instance, api = create_webrender_instance((128, 64), notifier=notifier,
                                              device="cpu")
    try:
        assert instance.backend.renderer.device.type == "cpu"
        txn = _rect_txn(jax_api)
        api.send_transaction(to_port(txn))
        img = instance.render()
        assert ready.is_set()
        assert tuple(img[10, 10]) == (255, 0, 0, 255)
        assert tuple(img[10, 100]) == (255, 255, 255, 255)
        # the JAX package's instance on the same transaction
        jax_instance, jax_rapi = jax_create_webrender_instance((128, 64))
        try:
            jax_rapi.send_transaction(txn)
            np.testing.assert_array_equal(img, jax_instance.render())
        finally:
            jax_rapi.shut_down()
    finally:
        api.shut_down()


def test_async_blob_rasterization_on_scene_thread():
    """Blob commands sent through the threaded RenderApi rasterize on the
    SceneBuilder thread, not at prepare time."""
    from webrender_tpu_torch.api.display_item import (AlphaType,
                                                      ImageRendering)
    from webrender_tpu_torch.api.image import ImageDescriptor, ImageFormat
    from webrender_tpu_torch.resources.resource_cache import BlobImageHandler

    raster_threads = []

    class Handler(BlobImageHandler):
        def rasterize(self, descriptor, blob, tile_offset=None):
            raster_threads.append(threading.current_thread().name)
            px = np.zeros((descriptor.height, descriptor.width, 4), np.uint8)
            px[..., 2] = blob[0]
            px[..., 3] = 255
            return px

    ready = threading.Event()
    notifier = RenderNotifier(new_frame_ready=ready.set)
    instance, api = create_webrender_instance((64, 64), notifier=notifier,
                                              device="cpu")
    try:
        instance.backend.resources.set_blob_image_handler(Handler())
        pid = PipelineId(0, 1)
        b = DisplayListBuilder(pid)
        b.begin()
        root = SpatialId.root_scroll_node(pid)
        common = CommonItemProperties(Rect(0, 0, 64, 64), root)
        b.push_image(common, Rect(0, 0, 64, 64), ImageRendering.AUTO,
                     AlphaType.PREMULTIPLIED_ALPHA, 9)
        _, dl = b.end()
        txn = Transaction()
        txn.set_root_pipeline(pid)
        txn.add_blob_image(9, ImageDescriptor(ImageFormat.RGBA8, 16, 16),
                           bytes([200]))
        txn.set_display_list(Epoch(0), dl)
        txn.generate_frame()
        api.send_transaction(txn)
        img = instance.render()
        assert tuple(img[32, 32]) == (0, 0, 200, 255)
        assert raster_threads and all(
            "SceneBuilder" in t for t in raster_threads), raster_threads
    finally:
        api.shut_down()


def test_low_priority_transaction_flushed_before_hit_test():
    """A transaction sent on the low-priority scene builder is built and
    installed before `hit_test` answers (the flush waits for the
    low-priority queue), and its frame renders."""
    instance = WebRenderInstance(
        (96, 96), support_low_priority_transactions=True, device="cpu")
    api = instance.api()
    try:
        assert api.hit_test(Point2D(10, 10)) == []
        txn = _rect_txn(jax_api, (0, 0.5, 1, 1), hit_tag=(4, 2))
        txn.low_priority = True
        api.send_transaction(to_port(txn))
        hits = api.hit_test(Point2D(10, 10))
        assert [h.tag for h in hits] == [(4, 2)]
        assert api.hit_test(Point2D(80, 80)) == []
        img = instance.render()
        assert tuple(img[10, 10]) == (0, 128, 255, 255)
        assert instance._low_pending == 0
        assert instance._low_prio_thread.name == "LowPrioritySceneBuilder"
    finally:
        api.shut_down()
    assert not instance._scene_thread.is_alive()
    assert not instance._backend_thread.is_alive()
