"""Twins of tests/test_components.py on the port, on the CPU: hit testing,
the profiler, scrolling, frame retention, blob images, occlusion culling,
display-list serialization, the huge-image resample and the near-plane
bounds.

Where the JAX test renders (through `render_software`), the twin runs the
same API flow on the JAX package's backend and on two of the port's
(`torch_twin.Trio`): the port's default path (picture caching on, the
kernel's plain version) equals JAX's `render_software` bitwise, its
uncached render and its `render_software` with float32 `where`s bitwise,
and the JAX test's pixel assertions hold on it.  Where the JAX test is
about state (hits, counters, retained frames, culled tile lists, bytes,
bounds), the port's state equals JAX's on the same inputs.

Twinned before: `test_capture_replay` (`tests/test_torch_capture.py`),
`test_options_and_memory_report`, `test_debug_overlay` and
`test_per_pass_gpu_timers` (`tests/test_torch_debug.py`),
`test_multi_document_and_screenshot` (`tests/test_torch_screenshot.py`),
`test_compositor_trait`,
`test_compositor_partial_present` and
`test_print_tree_and_crash_annotator` (`tests/test_torch_compositor.py`).
Left out: `test_text_frame_offset_snapping_equivalence`, which needs a
font file that is not in the repository.
"""
import struct

import numpy as np
import pytest

import webrender_tpu.api as jax_api
from torch_twin import Trio, side

import webrender_tpu_torch.api as port_api


def _simple(with_hit_test=True):
    """test_components.py's `build_simple` as a flow."""
    def flow(A, backend):
        pid = A.PipelineId(0, 1)
        b = A.DisplayListBuilder(pid)
        b.begin()
        root = A.SpatialId.root_scroll_node(pid)
        common = A.CommonItemProperties(A.Rect(0, 0, 1000, 1000), root)
        b.push_rect(common, A.Rect(10, 10, 100, 50), A.ColorF(0, 1, 0, 1))
        if with_hit_test:
            flags = A.PrimitiveFlags.IS_BACKFACE_VISIBLE
            b.push_hit_test(A.Rect(10, 10, 100, 50), A.ROOT_CLIP_CHAIN,
                            root, flags, (7, 3))
            b.push_hit_test(A.Rect(50, 20, 100, 50), A.ROOT_CLIP_CHAIN,
                            root, flags, (9, 1))
        _, dl = b.end()
        txn = A.Transaction()
        txn.set_root_pipeline(pid)
        txn.set_display_list(A.Epoch(0), dl)
        txn.generate_frame()
        backend.send_transaction(txn)
    return flow


def _hits(backend, A, x, y):
    return [(h.tag, h.point_relative_to_item.x, h.point_relative_to_item.y)
            for h in backend.hit_test(A.Point2D(x, y))]


def test_hit_test():
    trio = Trio((256, 128))
    trio.send(_simple())
    for (x, y) in ((60, 30), (5, 5), (20, 15)):
        assert _hits(trio.port, port_api, x, y) == \
            _hits(trio.jax, jax_api, x, y)
    assert [h[0] for h in _hits(trio.port, port_api, 60, 30)] == \
        [(9, 1), (7, 3)]
    assert _hits(trio.port, port_api, 5, 5) == []
    only_first = _hits(trio.port, port_api, 20, 15)
    assert [h[0] for h in only_first] == [(7, 3)]
    assert only_first[0][1] == pytest.approx(10.0)


def test_profiler_counters():
    trio = Trio((256, 128))
    trio.send(_simple(with_hit_test=False))
    trio.render()
    for backend in (trio.jax, trio.port):
        prof = backend.profiler
        assert prof.stats("scene_build_time") is not None
        assert prof.stats("frame_build_time") is not None
        assert "frame_build_time" in prof.report()


FRAME_STATS = ("color_passes", "visible_primitives", "gpu_buffer_mem",
               "image_templates", "atlas_textures_mem", "raster_passes",
               "instances", "alpha_passes", "used_targets")


def test_profiler_breadth_presets_and_reasons():
    """The counter registry, the presets and their expansion, the
    frame-stat counters fed from the built frame and the render reasons:
    the port's equal JAX's."""
    from webrender_tpu.util import profiler as jax_prof
    from webrender_tpu_torch.util import profiler as port_prof
    assert len(port_prof.COUNTERS) == len(jax_prof.COUNTERS) >= 130
    assert port_prof.PROFILER_PRESETS == jax_prof.PROFILER_PRESETS
    assert port_prof.Profiler.expand_preset(
        port_prof.PROFILER_PRESETS["Default"]) == \
        jax_prof.Profiler.expand_preset(jax_prof.PROFILER_PRESETS["Default"])
    trio = Trio((256, 128))
    trio.send(_simple(with_hit_test=False))
    trio.render()
    for A, backend in ((jax_api, trio.jax), (port_api, trio.port)):
        backend.profiler.note_render_reasons(
            int(A.RenderReasons.SCENE | A.RenderReasons.APZ))
    for key in FRAME_STATS + ("render_reason_scene", "render_reason_apz"):
        assert trio.port.profiler.get(key) == trio.jax.profiler.get(key), key
    assert trio.port.profiler.get("render_reason_apz") == 1.0
    items = port_prof.Profiler.expand_preset(
        port_prof.PROFILER_PRESETS["Default"])
    labels = [name for style, name in items]
    assert "Frame building" in labels and "GPU" in labels
    rep = trio.port.profiler.preset_report("Frame stats")
    assert "Color passes" in rep
    assert rep == trio.jax.profiler.preset_report("Frame stats")


def _scroll_page(A, backend):
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    root = A.SpatialId.root_scroll_node(pid)
    sf = b.define_scroll_frame(root, external_id=42,
                               content_rect=A.Rect(0, 0, 128, 1000),
                               frame_rect=A.Rect(0, 0, 128, 128))
    common = A.CommonItemProperties(A.Rect(0, 0, 1000, 1000), sf)
    b.push_rect(common, A.Rect(0, 100, 128, 28), A.ColorF(1, 0, 0, 1))
    _, dl = b.end()
    txn = A.Transaction()
    txn.set_root_pipeline(pid)
    txn.set_display_list(A.Epoch(0), dl)
    txn.generate_frame()
    backend.send_transaction(txn)


def test_scroll_and_rerender():
    trio = Trio((128, 128))
    trio.send(_scroll_page)
    img = trio.render()
    assert tuple(img[110, 64]) == (255, 0, 0, 255)

    def scroll(A, backend):
        txn = A.Transaction()
        txn.set_scroll_offsets(42, [A.Point2D(0, 100)])
        txn.generate_frame()
        backend.send_transaction(txn)
    trio.send(scroll)
    img = trio.render()
    assert tuple(img[5, 64]) == (255, 0, 0, 255)
    assert tuple(img[110, 64]) == (255, 255, 255, 255)


def test_resolved_identity_frame_retention():
    """Retention answers equal JAX's at each step; the rebuilt frame's
    image is JAX's."""
    trio = Trio((128, 128))
    trio.send(_scroll_page)
    seen = {}
    for A, backend in ((jax_api, trio.jax), (port_api, trio.port)):
        f0 = backend.build_frame()
        backend.scroll_offsets[999999] = A.Point2D(0.0, 123.0)
        f1 = backend.build_frame()
        skipped = backend.profiler.get("frame_builds_skipped")
        backend.scroll_offsets[42] = [(A.Point2D(0, 50.0), 0)]
        f2 = backend.build_frame()
        seen[A.__name__] = (f1 is f0, skipped, f2 is not f0)
    assert seen[port_api.__name__] == seen[jax_api.__name__] == \
        (True, 1.0, True)
    trio.flat.scroll_offsets[42] = [(port_api.Point2D(0, 50.0), 0)]
    img = trio.render()
    assert tuple(img[55, 64]) == (255, 0, 0, 255)


def test_blob_image():
    trio = Trio((128, 128))

    def flow(A, backend):
        rc = side(backend, "resources.resource_cache")
        backend.resources.set_blob_image_handler(rc.CheckerboardBlobHandler())
        pid = A.PipelineId(0, 1)
        b = A.DisplayListBuilder(pid)
        b.begin()
        root = A.SpatialId.root_scroll_node(pid)
        common = A.CommonItemProperties(A.Rect(0, 0, 1000, 1000), root)
        txn = A.Transaction()
        txn.add_blob_image(55, A.ImageDescriptor(A.ImageFormat.RGBA8, 64, 64),
                           struct.pack("<iBBB", 8, 20, 40, 60))
        b.push_image(common, A.Rect(0, 0, 64, 64), A.ImageRendering.AUTO,
                     A.AlphaType.PREMULTIPLIED_ALPHA, 55)
        _, dl = b.end()
        txn.set_root_pipeline(pid)
        txn.set_display_list(A.Epoch(0), dl)
        txn.generate_frame()
        backend.send_transaction(txn)
    trio.send(flow)
    img = trio.render()
    assert tuple(img[4, 4]) == (255, 255, 255, 255)
    assert tuple(img[4, 12]) == (20, 40, 60, 255)


def test_occlusion_culling():
    """The culled tile lists equal JAX's, and the image is JAX's."""
    trio = Trio((400, 300))

    def flow(A, backend):
        pid = A.PipelineId(0, 1)
        b = A.DisplayListBuilder(pid)
        b.begin()
        root = A.SpatialId.root_scroll_node(pid)
        common = A.CommonItemProperties(A.Rect(0, 0, 1000, 1000), root)
        for _ in range(10):
            b.push_rect(common, A.Rect(0, 0, 400, 300), A.ColorF(1, 0, 0, 1))
        b.push_rect(common, A.Rect(0, 0, 400, 300), A.ColorF(0, 0, 1, 1))
        _, dl = b.end()
        txn = A.Transaction()
        txn.set_root_pipeline(pid)
        txn.set_display_list(A.Epoch(0), dl)
        txn.generate_frame()
        backend.send_transaction(txn)
    trio.send(flow)
    want = trio.jax.build_frame().passes[-1].tile_insts
    got = trio.port.build_frame().passes[-1].tile_insts
    np.testing.assert_array_equal(got, want)
    counts = (got >= 0).sum(1)
    assert counts.min() == 1 and (counts == 1).sum() >= 4, counts
    img = trio.render()
    assert tuple(img[150, 200]) == (0, 0, 255, 255)


def test_display_list_serialization():
    """The port's bytes equal JAX's, and round-trip bit-exactly."""
    blobs = []
    for A in (jax_api, port_api):
        ser = __import__(A.__name__ + ".serialize", fromlist=["x"])
        pid = A.PipelineId(0, 1)
        b = A.DisplayListBuilder(pid)
        b.begin()
        root = A.SpatialId.root_scroll_node(pid)
        common = A.CommonItemProperties(A.Rect(0, 0, 1000, 1000), root)
        b.push_rect(common, A.Rect(10, 10, 100, 50), A.ColorF(0, 1, 0, 0.5))
        b.push_hit_test(A.Rect(10, 10, 100, 50), A.ROOT_CLIP_CHAIN, root,
                        A.PrimitiveFlags.IS_BACKFACE_VISIBLE, (7, 3))
        _, dl = b.end()
        blob = ser.serialize_display_list(dl)
        dl2 = ser.deserialize_display_list(blob)
        assert len(dl2.items) == len(dl.items)
        assert dl2.items[0] == dl.items[0]
        blobs.append(blob)
    assert blobs[0] == blobs[1]


def test_huge_image_resample_matches_direct():
    """Fully resident and host-resampled, each on the port's default path
    against JAX's oracle; the two within the JAX test's one step, at the
    count JAX's own pair shows."""
    rng = np.random.RandomState(11)
    px = (rng.rand(600, 700, 4) * 255).astype(np.uint8)
    px[..., 3] = 255

    def render(limit):
        trio = Trio((256, 200))

        def flow(A, backend):
            backend.resources.MAX_DIRECT_DIM = limit
            pid = A.PipelineId(0, 1)
            b = A.DisplayListBuilder(pid)
            b.begin()
            root = A.SpatialId.root_scroll_node(pid)
            common = A.CommonItemProperties(A.Rect(0, 0, 256, 200), root)
            b.push_image(common, A.Rect(5, 3, 240, 190),
                         A.ImageRendering.AUTO,
                         A.AlphaType.PREMULTIPLIED_ALPHA, 5)
            _, dl = b.end()
            txn = A.Transaction()
            txn.set_root_pipeline(pid)
            txn.add_image(5, A.ImageDescriptor(A.ImageFormat.RGBA8, 700, 600),
                          A.ImageData(pixels=px))
            txn.set_display_list(A.Epoch(0), dl)
            txn.generate_frame()
            backend.send_transaction(txn)
        trio.send(flow)
        return trio.render(), trio.jax.render_software()

    direct, jax_direct = render(2048)
    resampled, jax_resampled = render(256)
    diff = np.abs(direct.astype(int) - resampled.astype(int))
    assert diff.max() <= 1
    jdiff = np.abs(jax_direct.astype(int) - jax_resampled.astype(int))
    assert int((diff > 0).sum()) == int((jdiff > 0).sum())


def test_near_plane_crossing_rect_bounds():
    """The port's `device_bounds_of_rect(s)` equal JAX's on the crossing
    and the finite rects."""
    from webrender_tpu.frame import transforms as jt
    from webrender_tpu_torch.frame import transforms as pt
    H = np.array([[1.0, 0.0, 0.0],
                  [0.0, 1.0, -0.01],
                  [0.0, 0.0, 1.0]])
    rects = np.array([[0, 0, 10, 200], [0, 0, 10, 50.0]])
    bb = pt.device_bounds_of_rect(H, 0, 0, 10, 200)
    assert tuple(bb) == tuple(jt.device_bounds_of_rect(H, 0, 0, 10, 200))
    assert bb[0] <= -1e6 and bb[3] >= 1e6
    bbs = pt.device_bounds_of_rects(H, rects)
    np.testing.assert_array_equal(bbs, jt.device_bounds_of_rects(H, rects))
    assert bbs[0, 2] >= 1e6
    assert abs(bbs[1, 2]) < 1e4


def test_frame_retention_epochs():
    """Reuse and rebuild at each step equal JAX's."""
    trio = Trio((256, 128))
    trio.send(_simple(with_hit_test=False))
    seen = {}
    for A, backend in ((jax_api, trio.jax), (port_api, trio.port)):
        steps = []
        f1 = backend.build_frame()
        steps.append(backend.build_frame() is f1)
        steps.append((backend.profiler.get("frame_builds_skipped") or 0) >= 1)
        backend.scroll_offsets[12345] = A.Point2D(0, 10)
        f3 = backend.build_frame()
        steps.append(f3 is f1)
        backend.properties[7] = A.Transform.translation(1, 2)
        f4 = backend.build_frame()
        steps.append(f4 is not f3)
        steps.append(backend.build_frame() is f4)
        backend.resources.add_image_template(
            99, A.ImageDescriptor(A.ImageFormat.RGBA8, 2, 2),
            A.ImageData(pixels=np.zeros((2, 2, 4), np.uint8)))
        f5 = backend.build_frame()
        steps.append(f5 is not f4)
        _simple(with_hit_test=False)(A, backend)
        steps.append(backend.build_frame() is not f5)
        seen[A.__name__] = steps
    assert seen[port_api.__name__] == seen[jax_api.__name__] == [True] * 7
