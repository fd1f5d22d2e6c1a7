"""MotionMark's Multiply on the port: the benchmark's page (`spiral_stage`),
item kind (`rounded_turned_rect`) and kind of operation (`rotate`), loaded
by path from `benchmark/`, drawn through `RenderBackend` on the CPU at the
page's small size (96x96, the spiral's 5x5 square) and held frame by frame
to the benchmark's plain reference (`benchmark/reference.py`) at the
limits of the cell `motionmark_multiply.rotate`.  The control (the
reference at 4 bits a channel) fails those limits; tiles within
WebRender's tolerance of axis-aligned are drawn as the reference's
snapped rule says, and the turned rule alone would not hold them; and the
frame build's counters (`spatial_nodes`, `clip_rows`,
`transformed_instances`) count what the page holds."""
import json
import pathlib
import sys

import numpy as np
import pytest

from webrender_tpu_torch import api as A
from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.resources import ResourceCache
from webrender_tpu_torch.util import profiler as P

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
CELL = "motionmark_multiply.rotate"
FRAMES = 4


def _bench():
    """The benchmark's modules, its folder on the import path (appended:
    the plug-ins import `scene` by its top-level name)."""
    if str(BENCH) not in sys.path:
        sys.path.append(str(BENCH))
    import reference
    import refcheck
    import scene
    import traffic
    return scene, reference, refcheck, traffic


def _cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in bench["workloads"] if w["name"] == CELL)
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / cfg["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                     .read_text())
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    return config, mix, limits


def _rgba8(fb):
    """The presented framebuffer as RGBA8 (h, w, 4), as the harness reads
    it: v * 255 rounded half up."""
    v = fb.detach().float().cpu().numpy().transpose(1, 2, 0)
    return np.clip(np.floor(v.astype(np.float64) * 255.0 + 0.5), 0,
                   255).astype(np.uint8)


def _backend(config):
    be = RenderBackend(tuple(config["window"]), device="cpu",
                       resources=ResourceCache())
    be.renderer.picture_caching = bool(config["picture_caching"])
    return be


def _draw(be, txn):
    be.send_transaction(txn)
    return _rgba8(be.renderer.render_device(be.build_frame(), be.resources))


@pytest.fixture(scope="module")
def small():
    scene, reference, refcheck, traffic = _bench()
    config, mix, limits = _cell()
    page = scene.plugin("pages", "spiral_stage", BENCH)
    return page.small(config), mix, limits


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 21, 2 ** 40 + 2121])
def test_frames_hold_to_the_reference_at_the_cells_limits(small, seed):
    scene, reference, refcheck, traffic = _bench()
    config, mix, limits = small
    t = traffic.Traffic(config, mix, seed, BENCH)
    be = _backend(config)
    shown = _draw(be, t.first_transaction(A))
    for k in range(FRAMES + 1):
        if k:
            k, change = t.step()
            assert change.display_list and len(change.damage) == 2 * 25
            shown = _draw(be, t.transaction(A, k, change))
        ref = reference.compose(t.state, reference.identity, BENCH)
        got = refcheck.measure(shown, ref)
        assert all(got[n] <= limits[n] for n in refcheck.NAMES), (k, got)
        ctl = refcheck.measure(reference.compose(
            t.state, reference.control_quantize, BENCH), ref)
        assert any(ctl[n] > limits[n] for n in refcheck.NAMES), (k, ctl)


def test_nearly_axis_aligned_tiles_are_drawn_snapped():
    """Tiles turned within 1/4096 (of sin) of 0 or 180 degrees, low on a
    tall window where the snap moves an edge most, against the reference;
    the turned rule alone misses them by far more than the limits."""
    scene, reference, refcheck, traffic = _bench()
    _, _, limits = _cell()
    kind = scene.plugin("items", "rounded_turned_rect", BENCH)
    radii = ([12, 0, 0, 0], [0, 12, 12, 0], [6, 6, 0, 0], [0, 0, 0, 12])
    rng = np.random.default_rng(2121)
    w, h = 64, 640
    items = [scene.Item("rect", (0, 0, w, h), (1.0, 1.0, 1.0, 1.0))]
    for i in range(24):
        base = (0.0, 180.0, 360.0)[i % 3]
        item = scene.Item(
            "rounded_turned_rect", (0, 0, 0, 0),
            (float(rng.random()), float(rng.random()), float(rng.random()),
             float(rng.uniform(0.2, 1.0))),
            params={"centre": [10.0 + 22 * (i % 3), 420.0 + 9 * i],
                    "size": 12,
                    "angle": base + float(rng.uniform(-0.0139, 0.0139)),
                    "radii": [float(r) for r in radii[i % 4]]})
        kind.place(item)
        assert kind.axis_aligned(item.params)
        items.append(item)
    state = scene.State((w, h), items, {})
    be = _backend({"window": [w, h], "picture_caching": True})
    shown = _draw(be, scene.transaction(A, state, scene.Change(), 0,
                                        first=True, home=BENCH))
    got = refcheck.measure(shown, reference.compose(state, home=BENCH))
    assert all(got[n] <= limits[n] for n in refcheck.NAMES), got
    turned_only = kind.axis_aligned
    try:
        kind.axis_aligned = lambda params: False
        miss = refcheck.measure(shown, reference.compose(state, home=BENCH))
    finally:
        kind.axis_aligned = turned_only
    assert miss["max_step"] > limits["max_step"], miss


def test_counters_count_what_the_page_holds(small):
    scene, reference, refcheck, traffic = _bench()
    config, mix, _ = small
    kind = scene.plugin("items", "rounded_turned_rect", BENCH)
    t = traffic.Traffic(config, mix, 2 ** 33 + 21, BENCH)
    be = _backend(config)
    P.reset()
    _draw(be, t.first_transaction(A))
    turned = []
    for _ in range(FRAMES):
        turned.append(sum(not kind.axis_aligned(it.params)
                          for it in t.state.items[1:]))
        k, change = t.step()
        _draw(be, t.transaction(A, k, change))
    turned.append(sum(not kind.axis_aligned(it.params)
                      for it in t.state.items[1:]))
    frames = P.frames()
    assert len(frames) == FRAMES + 1
    tiles = len(t.state.items) - 1
    assert tiles == 25
    for f, n in zip(frames, turned):
        # the root reference frame, the root scroll node, a frame a tile
        assert f.counts["spatial_nodes"] == 2 + tiles
        # one rounded clip record a tile: each class rounds a corner
        assert f.counts["clip_rows"] == tiles
        # every tile not within 1/4096 of axis-aligned; the ground is not
        assert f.counts["transformed_instances"] == n
