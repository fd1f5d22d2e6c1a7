"""Dynamic frames on the port's persistent device mirrors, against the JAX
package.

* Scroll frames of tests/test_scroll_fast_path.py's scene, with picture
  caching off and on: each framebuffer equals JAX's `render_device`
  bitwise, the f32/instance/transform mirrors change the rows JAX's change,
  and the changed-instance masks are JAX's.
* Every dispatch's dense records, gathered incrementally, equal a full
  gather from the frame's own arrays.
* Rendering an older frame again equals its first render.
* The row sets of every put (tile lists, dense kinds and counts included)
  equal those of JAX's `_DeltaStore` fed the same arrays.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_scroll_fast_path import _build_scene as _jax_build_scene
from torch_twin import PortFeed, to_port

from webrender_tpu.api import (ColorF, CommonItemProperties,
                               DisplayListBuilder, Epoch, PipelineId, Point2D,
                               Rect, SpatialId, Transaction)
from webrender_tpu.frame.gpu import (INST_KIND, INST_PRIM_ADDR, KIND_SOLID,
                                     KIND_SUBPX_GLYPH)

from webrender_tpu_torch import scenes
from webrender_tpu_torch.ops import dense as dm
from webrender_tpu_torch.render_backend import RenderBackend

SCROLLS = (0.0, 9.0, 18.0, 27.0)


def _build_scene(backend):
    """tests/test_scroll_fast_path.py's scene, on either package."""
    if isinstance(backend, RenderBackend):
        backend = PortFeed(backend)
    _jax_build_scene(backend)


def _full_rebuild(backend):
    """tests/test_scroll_fast_path.py's ground truth on the port: a fresh
    builder (no fast-path state) over the same inputs, the spatial tree
    resolved here as the backend resolves it."""
    from webrender_tpu_torch.api import Rect as PortRect
    from webrender_tpu_torch.frame.frame_builder import FrameBuilder
    fb = FrameBuilder(surface_atlas_size=backend.frame_builder
                      .surface_atlas_size)
    fb.gl_flavor = backend.frame_builder.gl_flavor
    w, h = backend.device_size
    resolved = backend.built_scene.spatial_tree.resolve(
        scroll_offsets=backend.scroll_offsets,
        transform_properties=backend.properties,
        viewport=PortRect(0, 0, w / backend.dpr, h / backend.dpr))
    return fb.build(backend.built_scene, backend.resources,
                    backend.device_size, backend.dpr,
                    properties=backend.properties, resolved=resolved)


def _scroll(backends, step):
    for b in backends:
        off = [(Point2D(0.0, step), 0)]
        b.scroll_offsets[777] = to_port(off) \
            if isinstance(b, RenderBackend) else off


def _move_scene(backend, x):
    """One small rect moving over a static page (512x256)."""
    pid = PipelineId(0, 1)
    b = DisplayListBuilder(pid)
    b.begin()
    root = SpatialId.root_scroll_node(pid)
    common = CommonItemProperties(Rect(0, 0, 512, 256), root)
    b.push_rect(common, Rect(0, 0, 512, 256), ColorF(1, 1, 1, 1))
    b.push_rect(common, Rect(30, 100, 300, 40), ColorF(0, 0.5, 0, 1))
    b.push_rect(common, Rect(x, 30, 10, 10), ColorF(1, 0, 0, 1))
    txn = Transaction()
    txn.set_root_pipeline(pid)
    txn.set_display_list(Epoch(0), b.end()[1])
    txn.generate_frame()
    backend.send_transaction(to_port(txn))


def _check_dense_log(frame, log):
    """Each logged dispatch's records equal a full gather of the frame."""
    arrays = [torch.from_numpy(a) for a in
              (frame.f32_buf, frame.instances, frame.transforms)]
    np.testing.assert_array_equal(
        frame._torch_dense_kinds, dm.classify_dense_kinds(*arrays).numpy())
    for entry in log:
        full = dm.build_dense_records(
            *arrays, torch.from_numpy(entry["tile_insts"]),
            torch.from_numpy(frame._torch_dense_kinds))
        assert torch.equal(entry["dense"], full)


def _same_rows(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("caching", [False, True])
def test_scroll_frames_match_jax(caching):
    from webrender_tpu.render_backend import RenderBackend as JaxBackend
    ref = JaxBackend((640, 480))
    port = RenderBackend((640, 480), device="cpu")
    for b in (ref, port):
        b.renderer.picture_caching = caching
        _build_scene(b)
    incremental = 0
    for step in SCROLLS:
        _scroll((ref, port), step)
        fr, fp = ref.build_frame(), port.build_frame()
        want = np.asarray(ref.renderer.render_device(fr, ref.resources))
        port.renderer.dispatch_log = log = []
        got = port.renderer.render_device(fp, port.resources)
        np.testing.assert_array_equal(got.numpy(), want)
        for key in ("f32", "inst", "xf"):
            _same_rows(port.renderer._delta.last_changed(key),
                       ref.renderer._delta.last_changed(key))
        _same_rows(port.renderer._changed_inst, fr._changed_inst_mask)
        _check_dense_log(fp, log)
        incremental += sum(n < e["dense"].shape[0] for n, e in
                           zip(port.renderer.regathered_tiles, log))
        if caching:
            assert port.renderer.slice_debug == ref.renderer.slice_debug
    if caching:
        # the pre-slice pass reused its mirror on every scroll frame; the
        # merged uncached pass re-gathers all: a scroll of this full-width
        # feed changes most tiles' lists
        assert incremental == len(SCROLLS) - 1


@pytest.mark.parametrize("caching", [False, True])
def test_older_frame_renders_as_first(caching):
    """Frames A, B, C, then A and B again: the mirrors roll back, and no
    retained tensor changed under a later frame's in-place updates."""
    port = RenderBackend((512, 256), device="cpu")
    r = port.renderer
    r.picture_caching = caching
    frames, first = [], []
    for x in (40.0, 44.0, 300.0):
        _move_scene(port, x)
        frames.append(port.build_frame())
        r.dispatch_log = log = []
        first.append(r.render(frames[-1], port.resources))
        _check_dense_log(frames[-1], log)
    # the small moves re-gathered only the tiles they touch
    if not caching:
        assert 0 < r.regathered_tiles[0] <= 2
    for i in (0, 1):
        r.dispatch_log = log = []
        np.testing.assert_array_equal(r.render(frames[i]), first[i])
        _check_dense_log(frames[i], log)


@pytest.mark.parametrize("caching", [False, True])
def test_same_frame_again_gathers_nothing(caching):
    """A frame rendered again (the benchmark's full re-render loop, or a
    render after a signature change of the atlases) re-gathers no dense
    record: the mirrors hold it already."""
    port = RenderBackend((512, 256), device="cpu")
    r = port.renderer
    r.picture_caching = caching
    _move_scene(port, 40.0)
    frame = port.build_frame()
    first = r.render(frame, port.resources)
    for _ in range(2):
        r._fb_sig = None  # no retained framebuffer: render the passes
        r.dispatch_log = log = []
        np.testing.assert_array_equal(r.render(frame), first)
        _check_dense_log(frame, log)
        assert r.regathered_tiles == [0] * len(log)
    if not caching:
        assert len(log) == 1


def test_put_rows_match_jax_delta_store():
    """Every put of a scroll sequence (frame arrays, tile lists, dense
    kinds, counts) reports the changed rows JAX's store reports for the
    same arrays."""
    from webrender_tpu.renderer.renderer import _DeltaStore
    port = RenderBackend((640, 480), device="cpu")
    port.renderer.picture_caching = False
    _build_scene(port)
    store = port.renderer._delta
    puts = []
    put = store.put

    def logged(key, host):
        out = put(key, host)
        puts.append((key, host.copy(), store.last_changed(key)))
        return out

    store.put = logged
    for step in SCROLLS + (9.0,):
        _scroll((port,), step)
        port.renderer.render_device(port.build_frame(), port.resources)
    keys = {k for k, _, _ in puts}
    assert {"f32", "inst", "xf", ("dk",)} <= keys
    assert any(k[0] == "ti" for k in keys if isinstance(k, tuple))
    assert sum(rows is not None and rows.size > 0 for _, _, rows in puts) >= 4
    ref = _DeltaStore()
    for key, host, rows in puts:
        ref.put(key, host)
        _same_rows(rows, ref.last_changed(key))


def test_a_skipped_render_leaves_no_stale_records():
    """A (uncached, scroll 0), B (cached, scroll 9), then C, a new frame
    equal to B, uncached.  The merged pass's dense mirror is from A, two
    renders back, while the puts' changed rows are relative to B: the
    mirror must not be patched from them (the freshness rule of
    renderer.py:1120), or the feed tiles whose lists did not change keep
    A's transform rows."""
    port = RenderBackend((640, 480), device="cpu")
    _build_scene(port)
    r = port.renderer
    frames = {}
    for step, caching in ((0.0, False), (9.0, True)):
        _scroll((port,), step)
        r.picture_caching = caching
        frames[step] = port.build_frame()
        r.render_device(frames[step], port.resources)
    r.picture_caching = False
    c = _full_rebuild(port)
    assert c is not frames[9.0]
    r.dispatch_log = log = []
    got = r.render_device(c)
    _check_dense_log(c, log)
    want = RenderBackend((640, 480), device="cpu").renderer
    want.picture_caching = False
    assert torch.equal(got, want.render_device(c))


def test_dense_kinds_follow_the_mirrors_back():
    """Frames A, B (glyphs scaled: the separable subpixel kind), A again,
    then C (A with one background payload changed).  C's dense kinds and
    support flags are re-evaluated only where C differs from the mirrors'
    content, A, and must equal a full evaluation of C."""
    port = scenes.text_run_scene(RenderBackend(
        (256, 64), device="cpu", resources=scenes.resource_cache()))
    a = port.build_frame()
    xf = a.transforms.copy()
    xf[:, 0] = 1.5
    b = dataclasses.replace(a, transforms=xf)
    f32 = a.f32_buf.copy()
    solid = a.instances[a.instances[:, INST_KIND] == KIND_SOLID][0]
    f32[solid[INST_PRIM_ADDR] + 8] = 0.5  # the background's red
    c = dataclasses.replace(a, f32_buf=f32)
    r = port.renderer
    for frame in (a, b, a, c):
        r._put_frame(frame)
    glyphs = a.instances[:, INST_KIND] == KIND_SUBPX_GLYPH
    assert glyphs.any() and r._changed_inst is not None
    assert not r._changed_inst[glyphs].any()
    for frame in (a, b, c):
        arrays = [torch.from_numpy(x) for x in
                  (frame.f32_buf, frame.instances, frame.transforms)]
        np.testing.assert_array_equal(
            frame._torch_dense_kinds,
            dm.classify_dense_kinds(*arrays).numpy())
        # the support flags of the pass check follow the same rows
        np.testing.assert_array_equal(
            frame._torch_supported, dm.pallas_supported(*arrays).numpy())
    assert not np.array_equal(a._torch_dense_kinds, b._torch_dense_kinds)
