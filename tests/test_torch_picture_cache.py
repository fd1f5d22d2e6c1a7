"""Picture caching on the port against the JAX package: twins of
tests/test_invalidation.py.  Both packages render the same frames with
picture caching on (the default of both), frame by frame; the RGBA8
images must be bitwise equal, and the dirty-tile counts, the dirty rect,
`slice_debug` and the profiler's picture counters equal."""
import numpy as np
import pytest
import torch

from webrender_tpu.api import (ColorF, CommonItemProperties,
                               DisplayListBuilder, Epoch, PipelineId, Point2D,
                               Rect, SpatialId, Transaction)
from webrender_tpu.util.profiler import Profiler
from torch_twin import to_port

from webrender_tpu_torch.ops.tile_raster import LaunchCounts
from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.util.profiler import Profiler as PortProfiler

PID = PipelineId(0, 1)
SIZE = (512, 256)
COUNTERS = ("rendered_picture_tiles", "rendered_picture_px", "picture_tiles")


def _pair():
    from webrender_tpu.render_backend import RenderBackend as JaxBackend
    ref, port = JaxBackend(SIZE), RenderBackend(SIZE, device="cpu")
    ref.renderer.profiler = Profiler()
    port.renderer.profiler = PortProfiler()
    return ref, port


def _send(backends, dl, root=False, scroll=None):
    for backend in backends:
        txn = Transaction()
        if root:
            txn.set_root_pipeline(PID)
        if dl is not None:
            txn.set_display_list(Epoch(0), dl)
        if scroll is not None:
            txn.set_scroll_offsets(*scroll)
        txn.generate_frame()
        if isinstance(backend, RenderBackend):
            txn = to_port(txn)
        backend.send_transaction(txn)


def _scroll_scene():
    """tests/test_invalidation.py's setup_backend: a red rect in a scroll
    frame, a static blue one after it."""
    b = DisplayListBuilder(PID)
    b.begin()
    root = SpatialId.root_scroll_node(PID)
    sf = b.define_scroll_frame(root, external_id=7,
                               content_rect=Rect(0, 0, 512, 2000),
                               frame_rect=Rect(0, 0, 512, 256))
    common = CommonItemProperties(Rect(0, 0, 2000, 2000), sf)
    b.push_rect(common, Rect(10, 10, 50, 50), ColorF(1, 0, 0, 1))
    static_common = CommonItemProperties(Rect(0, 0, 2000, 2000), root)
    b.push_rect(static_common, Rect(400, 200, 50, 50), ColorF(0, 0, 1, 1))
    return b.end()[1]


def _step(ref, port):
    """Render one frame on both and hold every picture-cache output
    equal; returns the port's image and its dispatch count."""
    want = ref.render()
    before = LaunchCounts.plain_calls
    got = port.render()
    np.testing.assert_array_equal(got, want)
    r, q = ref.renderer, port.renderer
    assert q.last_dirty_tiles == r.last_dirty_tiles
    assert q.last_dirty_rect == r.last_dirty_rect
    assert q.slice_debug == r.slice_debug
    for name in COUNTERS:
        assert q.profiler.get(name) == r.profiler.get(name), name
    return got, LaunchCounts.plain_calls - before


def test_composite_nop_zero_dirty():
    ref, port = _pair()
    _send((ref, port), _scroll_scene(), root=True)
    img1, n1 = _step(ref, port)
    assert port.renderer.last_dirty_tiles > 0 and n1 == 2
    img2, n2 = _step(ref, port)
    assert port.renderer.last_dirty_tiles == 0 and n2 == 0
    np.testing.assert_array_equal(img1, img2)


def test_scroll_rerasters_zero_tiles():
    ref, port = _pair()
    _send((ref, port), _scroll_scene(), root=True)
    _step(ref, port)
    assert port.renderer.slice_debug
    _send((ref, port), None, scroll=(7, [Point2D(0, 30)]))
    img, n = _step(ref, port)
    slices = [d for d in port.renderer.slice_debug if d["key"][2] is not None]
    assert slices and all(d["dirty"] == 0 for d in slices)
    assert n == 1  # the continuation pass only
    assert tuple(img[15, 30]) == (255, 0, 0, 255)
    assert tuple(img[45, 30]) == (255, 255, 255, 255)
    assert tuple(img[220, 420]) == (0, 0, 255, 255)


def test_color_change_invalidates():
    ref, port = _pair()
    _send((ref, port), _scroll_scene(), root=True)
    _step(ref, port)
    b = DisplayListBuilder(PID)
    b.begin()
    root = SpatialId.root_scroll_node(PID)
    common = CommonItemProperties(Rect(0, 0, 2000, 2000), root)
    b.push_rect(common, Rect(10, 10, 50, 50), ColorF(0, 1, 0, 1))
    b.push_rect(common, Rect(400, 200, 50, 50), ColorF(0, 0, 1, 1))
    _send((ref, port), b.end()[1])
    img, _ = _step(ref, port)
    assert tuple(img[30, 30]) == (0, 255, 0, 255)
    assert port.renderer.last_dirty_tiles > 0


def _move_scene(x, w=512, h=256):
    """A white page, a green bar and a small red rect at `x`."""
    b = DisplayListBuilder(PID)
    b.begin()
    root = SpatialId.root_scroll_node(PID)
    common = CommonItemProperties(Rect(0, 0, w, h), root)
    b.push_rect(common, Rect(0, 0, w, h), ColorF(1, 1, 1, 1))
    b.push_rect(common, Rect(30, 100, 300, 40), ColorF(0, 0.5, 0, 1))
    b.push_rect(common, Rect(x, 30, 10, 10), ColorF(1, 0, 0, 1))
    return b.end()[1]


def test_small_prim_move_rerasters_one_tile():
    ref, port = _pair()
    _send((ref, port), _move_scene(40.0), root=True)
    _, n = _step(ref, port)
    assert port.renderer.last_dirty_tiles == 16 and n == 1
    _send((ref, port), _move_scene(44.0), root=True)
    port.renderer.dispatch_log = log = []
    img, n = _step(ref, port)
    assert 1 <= port.renderer.last_dirty_tiles <= 2
    # exactly the dirty tiles are launched (JAX pads them to 8)
    assert n == 1 and log[0]["dense"].shape[0] == \
        port.renderer.last_dirty_tiles
    assert port.renderer.profiler.get("rendered_picture_px") <= 2 * 128 * 64
    assert (img[33, 46] == (255, 0, 0, 255)).all()
    assert (img[33, 41] == (255, 255, 255, 255)).all()


@pytest.mark.parametrize("size", [(128, 64), (512, 256)])
def test_returned_framebuffers_stay_as_rendered(size):
    """JAX's framebuffers are values.  The port updates its root tile
    grid in place, and a framebuffer it returned earlier must not change
    with it (on a one-tile grid an assembled image could alias the grid)."""
    port = RenderBackend(size, device="cpu")
    held = []
    for x in (20.0, 24.0, 60.0, 20.0):
        _send((port,), _move_scene(x, *size), root=True)
        fb = port.renderer.render_device(port.build_frame(), port.resources)
        assert port.renderer.last_dirty_tiles >= 1
        held.append((fb, fb.clone()))
    for fb, snapshot in held:
        assert torch.equal(fb, snapshot)
    assert torch.equal(held[0][0], held[3][0])
