"""The port's frame recorder (`webrender_tpu_torch/util/profiler.py`): the
spans and counters inside the frame path, on the CPU.

* A small page on `RenderBackend(device="cpu")` with picture caching on,
  one image updated and moved every frame: each span of the frame path is
  recorded with its parent, one frame ends per `render_device`, children
  fit in their parents, and every span lies between `perf_counter_ns`
  readings taken around the frame's calls (the recorder's clock is the
  caller's).
* The counters equal what the frame did: the uploads pushed and their
  float32 texel bytes, the dirty tiles the renderer reports, and the rows
  the delta mirrors copied.
* A retained frame and a frame that raises each end their frame; the
  ring keeps its bound; switched off, the recorder records nothing and the
  framebuffer is bitwise the one it renders on; the overlay's build timers
  are the spans' own readings; spans and counts made on many threads are
  all kept.
* `ResourceCache.memory_report` keeps running totals that equal a walk
  over the templates.
* The benchmark's readers of the recorder's metrics
  (`benchmark/metrics/`, `benchmark/program_trace.py`) return a number
  after the benchmark's `harness.Program` ran a few frames of its cell at
  300x150, and nothing when the recorder holds none of the window.
"""
import importlib.util
import json
import pathlib
import sys
import threading
import time
import types

import numpy as np
import pytest

from webrender_tpu_torch import api as A
from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.util import profiler as P
from webrender_tpu_torch.util.options import DebugFlags

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
SIZE = (256, 128)
IMAGE = 7
FRAMES = 4

# each span of the frame path and the spans it runs inside (the backend
# resolves the spatial tree in `frame.resolve`, the frame build makes the
# palette and the homographies in another)
PARENTS = {
    "txn": None,
    "txn.resource_updates": "txn",
    "txn.scene_build": "txn",
    "frame": None,
    "frame.retention": "frame",
    "frame.build": "frame",
    "frame.resolve": ("frame", "frame.build"),
    "frame.prepare": "frame.build",
    "frame.passes": "frame.build",
    "frame.tile_hashes": "frame.build",
    "render": None,
    "render.uploads": "render",
    "render.picture_cache": "render",
    "render.put_frame": "render",
    "render.dispatch": "render",
}
# a host wait runs wherever the renderer waits
WAIT_PARENTS = {"render", "render.put_frame", "render.dispatch"}


def _pixels(seed, w=32, h=32):
    rng = np.random.RandomState(seed)
    px = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
    px[..., 3] = 255
    return px


def _txn(step):
    """Frame `step`'s transaction: the image added (step 0) or updated,
    and a new display list with the image moved."""
    txn = A.Transaction()
    desc = A.ImageDescriptor(A.ImageFormat.RGBA8, 32, 32)
    data = A.ImageData(pixels=_pixels(step))
    if step == 0:
        txn.add_image(IMAGE, desc, data)
    else:
        txn.update_image(IMAGE, desc, data)
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    root = A.SpatialId.root_scroll_node(pid)
    common = A.CommonItemProperties(A.Rect(0, 0, 4096, 4096), root)
    b.push_rect(common, A.Rect(0, 0, *SIZE), A.ColorF(0.9, 0.92, 0.95, 1))
    b.push_rect(common, A.Rect(150, 60, 80, 40), A.ColorF(0.2, 0.5, 0.8, 1))
    b.push_image(common, A.Rect(10 + 8 * step, 20, 32, 32),
                 A.ImageRendering.AUTO, A.AlphaType.PREMULTIPLIED_ALPHA,
                 IMAGE)
    _, dl = b.end()
    txn.set_root_pipeline(pid)
    txn.set_display_list(A.Epoch(step), dl)
    txn.generate_frame()
    return txn


def _drive(backend, steps, before_render=None):
    """Sends, builds and renders frames `steps`; per frame the clock
    readings around its calls, the uploads it took and its framebuffer."""
    out = []
    for step in steps:
        t0 = time.perf_counter_ns()
        backend.send_transaction(_txn(step))
        frame = backend.build_frame()
        uploads = list(backend.resources.pending_uploads)
        if before_render is not None:
            before_render()
        fb = backend.renderer.render_device(frame, backend.resources)
        t1 = time.perf_counter_ns()
        out.append({"t0": t0, "t1": t1, "uploads": uploads, "fb": fb,
                    "dirty": backend.renderer.last_dirty_tiles,
                    "recorded": len(P.frames())})
    return out


@pytest.fixture(scope="module")
def traced():
    """The small page's frames with the recorder on and GPU time queries
    on (their device waits are host waits too); per frame what was
    recorded and the rows each delta-mirror put copied."""
    P.set_enabled(True)
    P.reset()
    backend = RenderBackend(SIZE, device="cpu")
    renderer = backend.renderer
    renderer.debug_flags = DebugFlags.GPU_TIME_QUERIES
    delta = renderer._delta
    put = delta.put
    copied = []

    def spy(key, host):
        out = put(key, host)
        ent = delta._entries[key]
        changed = ent["last_changed"]
        whole = changed is None or changed.size > ent["cap"] // 2
        copied[-1].append((ent["cap"] if whole else int(changed.size),
                           whole))
        return out

    delta.put = spy
    steps = _drive(backend, range(FRAMES),
                   before_render=lambda: copied.append([]))
    frames = P.frames()
    return types.SimpleNamespace(backend=backend, steps=steps,
                                 frames=frames, copied=copied)


def test_each_span_is_recorded_with_its_parent(traced):
    assert [s["recorded"] for s in traced.steps] == list(
        range(1, FRAMES + 1))
    assert [f.index for f in traced.frames] == list(range(FRAMES))
    for f in traced.frames:
        names = {s.name for s in f.spans}
        assert set(PARENTS) | {"render.wait"} <= names, f.index
        for s in f.spans:
            if s.name == "render.wait":
                assert s.parent in WAIT_PARENTS
            elif isinstance(PARENTS.get(s.name), tuple):
                assert s.parent in PARENTS[s.name], s
            elif s.name in PARENTS:
                assert s.parent == PARENTS[s.name], s
            assert s.thread == threading.get_ident()
        assert {s.parent for s in f.spans if s.name == "frame.resolve"} \
            == set(PARENTS["frame.resolve"]), f.index


def test_children_fit_in_their_parents(traced):
    for f in traced.frames:
        for parent in f.spans:
            kids = [c for c in f.spans
                    if c.parent == parent.name and c is not parent and
                    parent.start_ns <= c.start_ns and
                    c.end_ns <= parent.end_ns]
            assert sum(c.end_ns - c.start_ns for c in kids) <= \
                parent.end_ns - parent.start_ns
        # every child lies inside a span of its parent's name
        for c in f.spans:
            if c.parent is not None:
                assert any(p.name == c.parent and
                           p.start_ns <= c.start_ns and
                           c.end_ns <= p.end_ns for p in f.spans), c


def test_spans_lie_on_the_callers_clock(traced):
    for f, step in zip(traced.frames, traced.steps):
        for s in f.spans:
            assert step["t0"] <= s.start_ns <= s.end_ns <= step["t1"]
        assert f.start_ns >= step["t0"]
        assert f.spans[-1].end_ns <= f.end_ns <= step["t1"]


def test_counters_equal_known_quantities(traced):
    for f, step, copied in zip(traced.frames, traced.steps, traced.copied):
        ups = step["uploads"]
        assert len(ups) > 0
        assert f.counts["uploads"] == len(ups)
        assert f.counts["upload_bytes"] == sum(
            4 * np.asarray(u.texels).size for u in ups)
        assert f.counts["tiles_dirty"] == step["dirty"] > 0
        assert f.counts["tiles_held"] >= step["dirty"]
        assert f.counts.get("mirror_rows", 0) == sum(n for n, _ in copied)
    # after the first frames the mirrors copy the changed rows alone,
    # which their `last_changed` lists
    steady = traced.copied[-1]
    assert steady and not any(whole for _, whole in steady)
    assert traced.frames[-1].counts["mirror_rows"] > 0


def test_overlay_timers_are_the_spans(traced):
    prof = traced.backend.profiler
    last = traced.frames[-1]
    assert prof.get("frame_build_time") == last.ms("frame.build")
    assert prof.get("scene_build_time") == last.ms("txn.scene_build")


def test_retained_frame_ends_its_frame(traced):
    backend = traced.backend
    P.reset()
    fb = backend.renderer.render_device(backend.last_frame,
                                        backend.resources)
    assert fb is traced.steps[-1]["fb"]
    assert backend.renderer.last_dirty_tiles == 0
    (f,) = P.frames()
    names = [s.name for s in f.spans]
    assert "render" in names and "render.picture_cache" in names
    assert "render.dispatch" not in names and "uploads" not in f.counts


def test_raising_frame_ends_its_frame(traced, monkeypatch):
    backend = traced.backend
    P.reset()
    backend.send_transaction(_txn(FRAMES))
    frame = backend.build_frame()

    def fail(*args, **kwargs):
        raise RuntimeError("dispatch failed")

    monkeypatch.setattr(backend.renderer, "_run_raster", fail)
    with pytest.raises(RuntimeError, match="dispatch failed"):
        backend.renderer.render_device(frame, backend.resources)
    (f,) = P.frames()
    render = [s for s in f.spans if s.name == "render"]
    assert len(render) == 1 and render[0].parent is None
    assert {"txn", "frame"} <= {s.name for s in f.spans}
    # the next frame starts with no span left open
    with P.span("after"):
        pass
    P.end_frame()
    assert P.frames()[-1].spans[0].parent is None


def test_ring_keeps_its_bound():
    P.reset(ring_frames=4)
    try:
        for i in range(10):
            P.count("n", i)
            P.end_frame()
        got = P.frames()
        assert [f.index for f in got] == [6, 7, 8, 9]
        assert [f.counts["n"] for f in got] == [6, 7, 8, 9]
    finally:
        P.reset()


def test_switched_off_records_nothing_and_renders_the_same():
    on = RenderBackend(SIZE, device="cpu")
    P.reset()
    want = _drive(on, range(3))
    assert len(P.frames()) == 3
    del on
    off = RenderBackend(SIZE, device="cpu")
    P.reset()
    P.set_enabled(False)
    try:
        got = _drive(off, range(3))
        assert P.span("x") is P.span("y")
        P.count("n")
        P.end_frame()
        assert P.frames() == []
        # the overlay's timers still time
        assert off.profiler.get("frame_build_time") is not None
    finally:
        P.set_enabled(True)
    for a, b in zip(want, got):
        assert a["fb"].dtype == b["fb"].dtype
        assert np.array_equal(a["fb"].numpy().view(np.uint32),
                              b["fb"].numpy().view(np.uint32))


def test_spans_and_counts_from_many_threads_are_all_kept():
    P.reset(ring_frames=1 << 20)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n, per = 12, 300

    def work():
        for _ in range(per):
            with P.span("t.outer"):
                with P.span("t.inner"):
                    P.count("t")

    threads = [threading.Thread(target=work) for _ in range(n)]
    try:
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            P.end_frame()
            time.sleep(0.0005)
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        P.end_frame()
    finally:
        sys.setswitchinterval(old)
    frames = P.frames()
    P.reset()
    spans = [s for f in frames for s in f.spans]
    assert len(spans) == 2 * n * per
    assert all(s.parent == "t.outer" for s in spans if s.name == "t.inner")
    assert all(s.parent is None for s in spans if s.name == "t.outer")
    assert sum(f.counts.get("t", 0) for f in frames) == n * per


def test_memory_report_keeps_running_totals():
    from webrender_tpu_torch.resources import ResourceCache

    def walked(rc):
        return sum(t.data.pixels.nbytes for t in rc.images.values()
                   if t.data.pixels is not None)

    rc = ResourceCache()
    rng = np.random.RandomState(3)
    for i in range(60):
        key = int(rng.randint(0, 8))
        w, h = (int(v) for v in rng.randint(1, 40, 2))
        desc = A.ImageDescriptor(A.ImageFormat.RGBA8, w, h)
        data = A.ImageData(pixels=np.zeros((h, w, 4), np.uint8))
        op = rng.randint(0, 3)
        if op == 0:
            rc.add_image_template(key, desc, data)
        elif op == 1:
            rc.update_image_template(key, desc, data)
        else:
            rc.delete_image_template(key)
        assert rc.memory_report()["image_templates"] == walked(rc)
    images = dict(rc.images)
    fresh = ResourceCache()
    fresh.replace_images(images)
    assert fresh.memory_report()["image_templates"] == walked(rc) > 0
    assert rc.memory_report()["glyph_cache"] == 0


# --- the benchmark's readers -------------------------------------------------
def _bench_modules():
    if str(BENCH) not in sys.path:
        sys.path.append(str(BENCH))
    import harness
    spec = importlib.util.spec_from_file_location(
        "_bench_tests_conftest", BENCH / "tests" / "conftest.py")
    conf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conf)
    return harness, conf


def _recorder_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [m["name"] for m in bench["per_layer"]
            if (BENCH / "metrics" / f"{m['name']}.py").read_text().count(
                "program_trace")]


@pytest.fixture(scope="module")
def bench_run():
    """The images cell at 300x150: a few frames of its `harness.Program`
    on the CPU, then a `harness.Run` of the last three frames of which the
    last is a traced frame."""
    harness, conf = _bench_modules()
    cell = conf.cut(harness.resolve("motionmark_images.putimagedata"))
    prog = harness.Program(cell, 2 ** 33 + 17, "cpu")
    P.reset()
    for _, txn, *_ in prog.make_frames(4):
        prog.frame(txn)
    frames = P.frames()
    run = harness.Run(frames=2, trace=types.SimpleNamespace(frames=1))
    return types.SimpleNamespace(harness=harness, cell=cell, run=run,
                                 frames=frames)


def test_sixteen_recorder_metrics():
    # the sixteen spans and counters of the frame path, and the frame
    # build's three counters of its spatial nodes, clip rows and
    # transformed instances
    assert len(_recorder_metrics()) == 16 + 3


@pytest.mark.parametrize("name", _recorder_metrics())
def test_metric_reader_returns_a_number(bench_run, name, monkeypatch):
    monkeypatch.setattr(P, "frames", lambda: list(bench_run.frames))
    read = bench_run.harness.load_reader(name, bench_run.cell.home)
    value = read(bench_run.run)
    assert isinstance(value, float) and np.isfinite(value), value
    assert value >= 0
    # nothing, and no error, where the recorder holds none of the window
    monkeypatch.setattr(P, "frames", lambda: [])
    assert read(bench_run.run) is None


def test_readers_read_the_window_frames(bench_run, monkeypatch):
    monkeypatch.setattr(P, "frames", lambda: list(bench_run.frames))
    home = bench_run.cell.home
    window = bench_run.frames[-3:-1]
    read = bench_run.harness.load_reader
    assert read("uploads_per_frame", home)(bench_run.run) == \
        sum(f.counts["uploads"] for f in window) / 2
    assert read("upload_ms", home)(bench_run.run) == \
        sum(f.ms("render.uploads") for f in window) / 2
    # a window longer than the ring holds reads the frames it still holds
    run = bench_run.harness.Run(frames=100,
                                trace=types.SimpleNamespace(frames=1))
    assert read("put_frame_ms", home)(run) == sum(
        f.ms("render.put_frame") for f in bench_run.frames[:-1]) / 3
