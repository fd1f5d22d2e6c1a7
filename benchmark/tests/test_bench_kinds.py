"""The page and the kinds of operation do what their sources do: the
canvases sit on the grid inside the stage, `putimagedata` moves colours
between neighbours as MotionMark's Images test does and moves about 3%
of the canvases; the same seed gives the same frames; the page's cut is
the one the tests always took; and a snapshot of the page owns its
items' parameters."""

import json

import numpy as np

import harness
import scene
import traffic
from conftest import BENCH, small_config

IMAGES = "motionmark_images.putimagedata"


def _traffic(workload, seed):
    cell = harness.resolve(workload)
    return cell, traffic.Traffic(cell.config, cell.mix, seed)


def test_canvases_on_the_grid_inside_the_stage():
    cell, t = _traffic(IMAGES, 11)
    cv = cell.config["canvases"]
    sx, sy, sw, sh = cell.config["stage"]
    for _ in range(3):
        t.step()
    rects = [it.rect for it in t.state.items if it.kind == "image"]
    assert len(rects) == cv["count"]
    for x0, y0, x1, y1 in rects:
        assert (x0 - sx) % cv["width"] == 0 and (y0 - sy) % cv["height"] == 0
        assert sx <= x0 and x1 <= sx + sw and sy <= y0 and y1 <= sy + sh


def test_putimagedata_moves_colours_between_neighbours():
    cell, t = _traffic(IMAGES, 12)
    before = t.state.copy()
    k, change = t.step()
    after = t.state
    moved = {it.key for a, it in zip(before.items, after.items)
             if a.rect != it.rect}
    assert change.images == sorted(after.images)
    assert change.display_list == bool(moved)
    # about 3% of the canvases move (512 canvases: 15 on average)
    assert 2 <= len(moved) <= 40
    for key, old in before.images.items():
        if key in moved:
            continue
        new = after.images[key]
        # a transparent pixel stays as it was
        clear = old[..., 3] == 0
        assert (new[clear] == old[clear]).all()
        # every colour came from the canvas before the step, or is 0
        olds = {tuple(v) for v in old.reshape(-1, 4)} | {(0, 0, 0, 0)}
        assert {tuple(v) for v in new.reshape(-1, 4)} <= olds


def test_putimagedata_neighbour_law():
    """dx and dy are each -1 with chance 0.04, 1 with chance 0.04, else
    0: a pixel takes another's colour with chance 1 - 0.92**2."""
    cell, t = _traffic(IMAGES, 13)
    px = t.state.extra["canvas_px"]
    n, h, w, _ = px.shape
    # every pixel drawn and distinct: the changed share is the law's
    ids = np.arange(n * h * w, dtype=np.uint32)
    px.reshape(-1, 4).view(np.uint32)[:, 0] = ids | np.uint32(0xFF000000)
    before = px.copy()
    rects = [it.rect for it in t.state.extra["canvas_items"]]
    t.step()
    # the canvases that moved had an icon drawn over them: leave them out
    kept = [i for i, it in enumerate(t.state.extra["canvas_items"])
            if it.rect == rects[i]]
    changed = (px[kept] != before[kept]).any(-1).mean()
    assert abs(changed - (1 - 0.92 ** 2)) < 0.003, changed


def test_same_seed_same_frames():
    for workload in (IMAGES,):
        _, a = _traffic(workload, 2 ** 40 + 5)
        _, b = _traffic(workload, 2 ** 40 + 5)
        _, c = _traffic(workload, 2 ** 40 + 6)
        for _ in range(3):
            a.step(), b.step(), c.step()
        assert all((a.state.images[k] == b.state.images[k]).all()
                   for k in a.state.images)
        assert [i.rect for i in a.state.items] == \
            [i.rect for i in b.state.items]
        assert any((a.state.images[k] != c.state.images[k]).any()
                   for k in a.state.images)


def test_canvas_stage_small_is_the_old_cut():
    """`canvas_stage.small` cuts the images configuration as the tests'
    own rule did before pages brought their cuts."""
    config = json.loads((BENCH / "configs" /
                         "motionmark_images.json").read_text())
    before = json.dumps(config)
    expected = dict(config, window=[300, 150], stage=[0, 0, 300, 150],
                    canvases={"count": 24, "width": 50, "height": 50,
                              "first_key": 1000},
                    icons={"count": 13, "width": 50, "height": 50})
    page = scene.plugin("pages", "canvas_stage")
    assert page.small(config) == expected
    assert small_config(config) == expected
    assert json.dumps(config) == before


def test_snapshots_own_their_params():
    """A kind that changes an item's `params` in place reaches neither
    `State.copy` nor `State.layout`."""
    item = scene.Item("rect", (0, 0, 4, 4), (1, 1, 1, 1),
                      params={"angle": 10.0, "radii": [1.0, 2.0]})
    state = scene.State((8, 8), [item], {})
    snaps = (state.copy(), state.layout())
    item.params["angle"] = 20.0
    item.params["radii"][0] = 3.0
    for snap in snaps:
        assert snap.items[0].params == {"angle": 10.0, "radii": [1.0, 2.0]}
        assert snap.items[0] is not item
    assert scene.Item("rect", (0, 0, 1, 1)).params == {}
