"""The work count on a tiny page counted by hand."""
import numpy as np
import pytest

import scene
import workcount


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
