"""MotionMark's Multiply in the benchmark: the reference's anti-aliasing
rule worked by hand at chosen pixels (a tile at 0 and 90 degrees is
exact, one at 45 degrees and a rounded corner follow the stated
formulas), the spiral and the `rotate` law as the test's source sets
them, the covered area and the work count of one tile by hand, and the
cell's three readers, which read nothing from a program without their
counters."""
import colorsys
import math
import types

import numpy as np
import pytest

import harness
import scene
import traffic
import workcount
from conftest import BENCH

CELL = "motionmark_multiply.rotate"
RED = (1.0, 0.0, 0.0, 1.0)


def _kind():
    return scene.plugin("items", "rounded_turned_rect")


def _tile(angle, radii=(0.0, 0.0, 0.0, 0.0), colour=RED, centre=(20, 20)):
    item = scene.Item("rounded_turned_rect", (0, 0, 0, 0), colour, params={
        "centre": [float(v) for v in centre], "size": 12,
        "angle": float(angle), "radii": [float(r) for r in radii]})
    _kind().place(item)
    return item


def _pixel(item, x, y):
    """The reference's source of `item` at window pixel (x, y)."""
    src = _kind().source(item, None, lambda v: v)
    x0, y0 = item.rect[:2]
    return src[y - y0, x - x0].tolist()


def _scaled(s, a, m):
    """swgl's scaling of a packed colour `s` by coverages a and m."""
    big_a = math.floor(256 * a + 0.5 + 1 / 1024)
    big_m = math.floor(255 * m + 0.5 + 1 / 1024)
    s = [v * big_a // 256 for v in s]
    return [(v * big_m + v) // 256 for v in s]


@pytest.mark.parametrize("angle", [0.0, 90.0])
def test_quarter_turns_are_exact(angle):
    item = _tile(angle, colour=(0.2, 0.4, 0.6, 0.5))
    src = _kind().source(item, None, lambda v: v)
    x0, y0, x1, y1 = item.rect
    inside = np.zeros(src.shape[:2], bool)
    inside[14 - y0:26 - y0, 14 - x0:26 - x0] = True
    # (0.1, 0.2, 0.3, 0.5) premultiplied, rounded half to even: 25.5 -> 26
    assert (src[inside] == [26, 51, 76, 128]).all()
    assert (src[~inside] == 0).all()


def test_a_tile_at_45_degrees_follows_the_rule():
    item = _tile(45.0)
    fw = math.sqrt(2.0)
    # pixel (20, 11): centre (20.5, 11.5), (0.5, -8.5) from the tile's
    # centre, turned back by 45 degrees
    qx = (0.5 - 8.5) / fw
    qy = (-8.5 - 0.5) / fw
    d = max(-6 - qx, qx - 6, -6 - qy, qy - 6)
    a = min(max(0.5 - d / fw, 0.0), 1.0)
    assert 0.0 < a < 1.0
    assert _pixel(item, 20, 11) == _scaled([255, 0, 0, 255], a, a)
    # the centre is covered, a corner of the box is not
    assert _pixel(item, 20, 20) == [255, 0, 0, 255]
    assert _pixel(item, item.rect[0], item.rect[1]) == [0, 0, 0, 0]


def test_a_rounded_corner_follows_the_rule():
    item = _tile(0.0, radii=(12.0, 0.0, 0.0, 0.0))
    # the top-left corner's circle is about (26, 26), radius 12
    for (x, y) in ((17, 17), (16, 19), (14, 25), (20, 20), (14, 14)):
        n = math.hypot(x + 0.5 - 26, y + 0.5 - 26)
        e = (n * n - 144) / (2 * n)
        d = max(14 - (x + 0.5), (x + 0.5) - 26, 14 - (y + 0.5),
                (y + 0.5) - 26)
        m = min(max(0.5 - max(e, d), 0.0), 1.0)
        assert _pixel(item, x, y) == _scaled([255, 0, 0, 255], 1.0, m), \
            (x, y)
    assert _pixel(item, 14, 14) == [0, 0, 0, 0]
    assert _pixel(item, 20, 20) == [255, 0, 0, 255]


def test_classes_scale_overlapping_radii():
    page = scene.plugin("pages", "spiral_stage")
    assert page.class_radii(["top_left"], 12) == [12.0, 0.0, 0.0, 0.0]
    assert page.class_radii(["top_right", "bottom_left"], 12) == \
        [0.0, 12.0, 0.0, 12.0]
    # two 100% radii on one side: both scaled by 12 / 24
    assert page.class_radii(["top_left", "top_right"], 12) == \
        [6.0, 6.0, 0.0, 0.0]


def test_area_and_work_of_one_tile():
    kind = _kind()
    quarter = _tile(30.0, radii=(12.0, 0.0, 0.0, 0.0))
    assert kind.area(quarter) == pytest.approx(144 * math.pi / 4)
    two = _tile(30.0, radii=(6.0, 6.0, 0.0, 0.0))
    assert kind.area(two) == pytest.approx(144 - 2 * 36 * (1 - math.pi / 4))
    x0, y0, x1, y1 = two.rect
    box = (x1 - x0) * (y1 - y0)
    state = scene.State((40, 40), [two], {})
    change = scene.Change(display_list=True, damage=[two.rect])
    ops, nbytes = workcount.frame_work(state, change)
    per_px = workcount.COVERAGE_OPS + workcount.COMPOSE_OPS + 125
    assert ops == pytest.approx(box * per_px * kind.area(two) / box)
    assert nbytes == 2 * 40 * 40 * 4


def _traffic(seed, config=None):
    cell = harness.resolve(CELL)
    return cell, traffic.Traffic(config or cell.config, cell.mix, seed)


def test_the_spiral_fills_its_square():
    cell, t = _traffic(2 ** 35 + 1)
    items = t.state.items[1:]
    assert len(items) == 1089
    corners = {(it.params["centre"][0] - 6, it.params["centre"][1] - 6)
               for it in items}
    assert corners == {(602 + 12 * i, 202 + 12 * j)
                       for i in range(33) for j in range(33)}
    assert items[0].params["centre"] == [800.0, 400.0]
    d = np.asarray(t.state.extra["distances"])
    steps = np.asarray(t.state.extra["steps"])
    assert d.min() == 0 and d.max() == pytest.approx(16 * math.sqrt(2))
    assert steps.min() == 3.0 and steps.max() == pytest.approx(
        16 * math.sqrt(2) / 1.5)
    alphas = [it.color[3] for it in items]
    assert min(alphas) == 0.01 and alphas.count(0.01) == 12
    angles = {it.params["angle"] for it in items}
    assert angles <= set(map(float, range(360))) and len(angles) > 300


def test_rotate_steps_angles_and_colours():
    cell, t = _traffic(2 ** 36 + 3)
    items = t.state.items[1:]
    before = [it.params["angle"] for it in items]
    factor = 1.5 / math.sqrt(1089)
    for frame in (1, 2, 3):
        _, change = t.step()
        assert change.display_list and not change.images
        assert len(change.damage) == 2 * 1089
    p = (3 * 1000 / 60 % 10000) / 10000
    light = 20 + 30 * math.sin(2 * abs(0.5 - p))
    for it, a0, d in zip(items, before, t.state.extra["distances"]):
        assert it.params["angle"] == pytest.approx(a0 + 3 * max(3, d / 1.5))
        influence = max(0.01, 1 - d * factor)
        r, g, b = colorsys.hls_to_rgb(
            p, min(light * math.tan(influence / 1.25) / 100, 1.0), 1.0)
        assert it.color == pytest.approx((r, g, b, influence), abs=1e-12)
        x0, y0, x1, y1 = it.rect
        cx, cy = it.params["centre"]
        assert x0 < cx - 6 and x1 > cx + 6 and y0 < cy - 6 and y1 > cy + 6


def test_same_seed_same_frames():
    runs = [_traffic(s)[1] for s in (2 ** 40 + 9, 2 ** 40 + 9, 2 ** 40 + 10)]
    for _ in range(2):
        for t in runs:
            t.step()
    a, b, c = ([(it.rect, it.color, it.params) for it in t.state.items]
               for t in runs)
    assert a == b and a != c


@pytest.mark.parametrize("name,counter", [
    ("spatial_nodes_per_frame", "spatial_nodes"),
    ("clip_rows_per_frame", "clip_rows"),
    ("transformed_instances_per_frame", "transformed_instances")])
def test_readers_read_nothing_without_their_counters(monkeypatch, name,
                                                     counter):
    from webrender_tpu_torch.util import profiler
    read = harness.load_reader(name, BENCH)
    run = harness.Run(frames=2, trace=types.SimpleNamespace(frames=1))
    frames = [types.SimpleNamespace(counts={counter: n, "uploads": 1})
              for n in (10, 20, 30)]
    monkeypatch.setattr(profiler, "frames", lambda: frames)
    assert read(run) == 15.0            # the window's two frames
    older = [types.SimpleNamespace(counts={"uploads": 1}) for _ in range(3)]
    monkeypatch.setattr(profiler, "frames", lambda: older)
    assert read(run) is None
