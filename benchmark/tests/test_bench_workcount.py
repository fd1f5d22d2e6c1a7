"""The work count on a tiny page counted by hand, an item charged for
the share of its rect it covers, and the images cell's count as it stood
before items could say what they cover."""
import numpy as np
import pytest

import harness
import scene
import traffic
import workcount
from conftest import ADDED


def test_work_by_hand():
    px = np.zeros((10, 10, 4), np.uint8)
    state = scene.State((40, 20), [
        scene.Item("rect", (0, 0, 40, 20), (1, 1, 1, 1)),
        scene.Item("image", (5, 5, 15, 15), key=3)], {3: px})
    # the image was put back and moved 10 px right: it left (5..15) and
    # took (15..25)
    state.items[1].rect = (15, 5, 25, 15)
    change = scene.Change(display_list=True, images=[3],
                          damage=[(5, 5, 15, 15), (15, 5, 25, 15)])
    ops, nbytes = workcount.frame_work(state, change)
    per_px = workcount.COVERAGE_OPS + workcount.COMPOSE_OPS
    # the ground over the 200 damaged pixels, the image over its 100
    assert ops == 200 * per_px + 100 * (per_px + 24 + 4 * 28)
    # the window composited (read and written) and the texels once
    assert nbytes == 2 * 40 * 20 * 4 + 10 * 10 * 4
    least = workcount.least_seconds([(state, change)])
    assert least == pytest.approx(max(ops / workcount.PEAK_FP32_FLOPS,
                                      nbytes / workcount.PEAK_BYTES_PER_S))


def test_damage_is_counted_once():
    rects = [(0, 0, 10, 10), (5, 5, 15, 15), (0, 0, 10, 10)]
    cells = workcount.disjoint(rects)
    area = ((cells[:, 2] - cells[:, 0]) * (cells[:, 3] - cells[:, 1])).sum()
    assert area == 100 + 100 - 25


def test_item_covering_half_its_rect_is_charged_half(added_root):
    """An item whose kind's `area` is half its rect is charged over half
    of the rect's overlap with the damage; a kind without `area` over
    all of it."""
    home = harness.resolve(ADDED, root=added_root).home
    tile = scene.Item("turned_rect", (0, 0, 20, 10), params={
        "centre": [10, 5], "size": [10, 10], "turns": 0})
    plain = scene.Item("rect", (0, 0, 20, 10), (1, 1, 1, 1))
    assert workcount.cover_share(tile, home) == 0.5
    assert workcount.cover_share(plain, home) == 1.0
    change = scene.Change(display_list=True, damage=[(0, 0, 20, 10)])
    per_px = workcount.COVERAGE_OPS + workcount.COMPOSE_OPS
    for item, pixels in ((tile, 100), (plain, 200)):
        ops, _ = workcount.frame_work(scene.State((40, 20), [item], {}),
                                      change, home)
        assert ops == pixels * per_px


# (seed, frame): (operations, bytes) of the images cell's frames, at its
# full size, as the count read before `area` and `params` existed
IMAGES_WORK = {
    (5, 1): (491705000.0, 15360000.0),
    (5, 2): (492080000.0, 15360000.0),
    (5, 3): (491330000.0, 15360000.0),
    (2 ** 40 + 77, 1): (486830000.0, 15360000.0),
    (2 ** 40 + 77, 2): (486455000.0, 15360000.0),
    (2 ** 40 + 77, 3): (485705000.0, 15360000.0),
}
IMAGES_LEAST = {5: 2.2016641791044775e-05, 2 ** 40 + 77: 2.177597014925373e-05}


@pytest.mark.parametrize("seed", sorted(IMAGES_LEAST))
def test_images_cell_work_is_unchanged(seed):
    cell = harness.resolve("motionmark_images.putimagedata")
    t = traffic.Traffic(cell.config, cell.mix, seed)
    frames = []
    for _ in range(3):
        k, change = t.step()
        frames.append((t.state.layout(), change))
        assert workcount.frame_work(t.state, change) == IMAGES_WORK[seed, k]
    assert workcount.least_seconds(frames) == IMAGES_LEAST[seed]
