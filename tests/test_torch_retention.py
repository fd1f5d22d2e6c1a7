"""The frame retention rule and the one resolve of a frame's spatial tree,
on the port, against the JAX package's `RenderBackend` on the CPU.

A small page with a scroll frame and an animated transform takes a
scripted sequence of transactions: the first frame, an unchanged frame, a
scroll that moves a node, a scroll of an id no node has, a property
change, a new display list, a display list whose blurs overflow a small
surface-atlas cap (the build is retried, as
`test_torch_eviction.py::test_surface_atlas_oom_recovery_ladder` forces
it) and an unchanged frame again.  Each step is one case: the port
builds or retains where the JAX package does, its frame equals JAX's
field by field, `frame_builds_skipped` is JAX's, the spatial tree's `resolve`
ran once in the step's `build_frame`, or not at all where the epoch key
matched, and `FrameBuilder.build` resolved nothing itself.
"""
import types

import pytest

from test_torch_frames import _assert_same
from torch_twin import jax_api_of

from webrender_tpu.render_backend import RenderBackend as JaxBackend
from webrender_tpu_torch.frame.frame_builder import FrameBuilder
from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.scene.spatial_tree import SceneSpatialTree

SIZE = (320, 240)
SCROLL_ID = 777
ANIMATED = 9


def _page(epoch, blurs=0, cap=None):
    """The page's display list at `epoch`: a fixed bar, a scroll frame
    over a taller feed, a box under the animated transform `ANIMATED`,
    and (`blurs`) a rect under that many nested blurs; `cap`: the frame
    builder's surface-atlas cap."""
    def flow(A, backend):
        if cap is not None:
            backend.frame_builder.surface_max_height = cap
        pid = A.PipelineId(0, 1)
        b = A.DisplayListBuilder(pid)
        b.begin()
        root = A.SpatialId.root_scroll_node(pid)
        common = A.CommonItemProperties(A.Rect(0, 0, *SIZE), root)
        b.push_rect(common, A.Rect(0, 0, *SIZE), A.ColorF(1, 1, 1, 1))
        b.push_rect(common, A.Rect(10, 10, 300, 30),
                    A.ColorF(0.1 * epoch, 0.3, 0.8, 1.0))
        sf = b.define_scroll_frame(root, SCROLL_ID, A.Rect(0, 40, 200, 1000),
                                   A.Rect(0, 40, 200, 240))
        sc = A.CommonItemProperties(A.Rect(0, 40, 200, 1000), sf)
        for i in range(12):
            y = 50 + i * 50
            b.push_rect(sc, A.Rect(10, y, 190, y + 30),
                        A.ColorF(0.9, 0.9 - 0.05 * i, 0.2, 1.0))
        # a transform the scene binds to the animated property `ANIMATED`
        bound = type("Bound", (A.Transform,), {"binding_key": ANIMATED})(
            A.Transform.identity().m)
        rf = b.push_reference_frame(A.Point2D(240, 120), root,
                                    A.TransformStyle.FLAT, bound)
        b.push_rect(A.CommonItemProperties(A.Rect(-30, -30, 30, 30), rf),
                    A.Rect(-30, -30, 30, 30), A.ColorF(0.2, 0.6, 0.3, 1.0))
        b.pop_reference_frame()
        for _ in range(blurs):
            b.push_stacking_context(A.Point2D(0, 0), root,
                                    filters=[A.FilterOp.blur(2.0, 2.0)])
        if blurs:
            b.push_rect(common, A.Rect(20, 20, 280, 200),
                        A.ColorF(0.8, 0.3, 0.1, 1.0))
        for _ in range(blurs):
            b.pop_stacking_context()
        _, dl = b.end()
        txn = A.Transaction()
        txn.set_root_pipeline(pid)
        txn.set_display_list(A.Epoch(epoch), dl)
        txn.generate_frame()
        backend.send_transaction(txn)
    return flow


def _scroll(ident, y):
    def flow(A, backend):
        txn = A.Transaction()
        txn.set_scroll_offsets(ident, [A.Point2D(0.0, y)])
        txn.generate_frame()
        backend.send_transaction(txn)
    return flow


def _rotate(degrees):
    def flow(A, backend):
        txn = A.Transaction()
        txn.append_dynamic_transform_properties(
            [A.PropertyValue(ANIMATED, A.Transform.rotation_z(degrees))])
        txn.generate_frame()
        backend.send_transaction(txn)
    return flow


def _unchanged(A, backend):
    pass


# (step, its flow, whether the frame is retained, resolves in build_frame)
STEPS = (
    ("first", _page(0), False, 1),
    ("unchanged", _unchanged, True, 0),
    ("scroll", _scroll(SCROLL_ID, 50.0), False, 1),
    ("scroll_unknown_id", _scroll(4242, 30.0), True, 1),
    ("property", _rotate(30.0), False, 1),
    ("display_list", _page(1), False, 1),
    ("surface_overflow", _page(2, blurs=6, cap=96), False, 1),
    ("unchanged_again", _unchanged, True, 0),
)


def _fast_builds(backend):
    """Frames the backend's scroll fast path has patched since its last
    full build."""
    st = backend.frame_builder._fast_state
    return None if st is None else st["builds"]


@pytest.fixture(scope="module")
def steps():
    """Each step's frames, retain decisions, skip counters and the port's
    resolve and build counts."""
    jax = JaxBackend(SIZE)
    port = RenderBackend(SIZE, device="cpu")
    calls = types.SimpleNamespace(resolves=0, builds=0, build_resolves=0)
    resolve, build = SceneSpatialTree.resolve, FrameBuilder.build

    def counted_resolve(tree, *args, **kwargs):
        calls.resolves += 1
        return resolve(tree, *args, **kwargs)

    def counted_build(builder, *args, **kwargs):
        before = calls.resolves
        calls.builds += 1
        try:
            return build(builder, *args, **kwargs)
        finally:
            calls.build_resolves += calls.resolves - before

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SceneSpatialTree, "resolve", counted_resolve)
        mp.setattr(FrameBuilder, "build", counted_build)
        for name, flow, _, _ in STEPS:
            got = {}
            for backend in (jax, port):
                flow(jax_api_of(backend), backend)
                last = backend.last_frame
                calls.resolves = calls.builds = calls.build_resolves = 0
                frame = backend.build_frame()
                got[backend is port] = types.SimpleNamespace(
                    frame=frame, retained=last is not None and frame is last,
                    skipped=backend.profiler.get("frame_builds_skipped"),
                    recoveries=backend.profiler.get(
                        "surface_atlas_recoveries"),
                    resolves=calls.resolves, builds=calls.builds,
                    build_resolves=calls.build_resolves,
                    fast_builds=_fast_builds(backend))
            out[name] = types.SimpleNamespace(jax=got[False], port=got[True])
    return out


@pytest.mark.parametrize("step", range(len(STEPS)),
                         ids=[name for name, *_ in STEPS])
def test_retention_and_one_resolve_match_jax(steps, step):
    name, _, retained, resolves = STEPS[step]
    got = steps[name]
    port, jax = got.port, got.jax
    assert port.retained == jax.retained == retained
    _assert_same(port.frame, jax.frame, "frame")
    assert port.skipped == jax.skipped
    assert port.recoveries == jax.recoveries
    # the step's one resolve, in the backend; none in the frame builder
    assert port.resolves == resolves
    assert port.build_resolves == 0
    if retained:
        assert port.builds == 0
    elif name == "surface_overflow":
        # the retries build again over the same resolve
        assert jax.recoveries and port.builds > 1
    else:
        assert port.builds == 1
    if name == "scroll":
        # the moved feed was patched over the last build
        assert port.fast_builds == 1
