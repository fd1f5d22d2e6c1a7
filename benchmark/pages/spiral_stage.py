"""A square spiral of small tiles from the stage's centre, as MotionMark's
Multiply test lays them out (`multiply.js`, `initialize` and `_addTile`).

The configuration gives the window (the stage), the background colour,
`tiles` (how many, their size in px and the stage's rows, which set the
size in the test: round(stage height / rows)) and `classes`: for each
class (`div-0` ...) the corners it rounds at 100% of the tile.

The first tile's top-left corner is round((stage - size) / 2) on each
axis; each next tile is one stride (the size) to the right, up, left or
down, the direction turning a quarter after tiles 1, 2, 4, 6, 9, 12, 16,
... as the test's `spiralCounter` and `nextIndex` turn it, so that the
first n² tiles (n odd) fill an n x n square about the centre.  Each tile
is a `rounded_turned_rect` item with a class and a start angle (whole
degrees 0-359) drawn from the seed; its distance from the stage's centre
in tiles sets its angle step (`max(3, distance / 1.5)` degrees a frame)
and its alpha (`kinds/rotate.py`).  The tiles are painted in the order
they were made, over the background.
"""
import copy
import math
import pathlib

import scene
from scene import Item, State

HOME = pathlib.Path(__file__).resolve().parent.parent

CORNERS = ("top_left", "top_right", "bottom_right", "bottom_left")


def small(config):
    """`config` on a 96x96 window with the spiral's 5x5 square."""
    c = copy.deepcopy(config)
    c["window"] = [96, 96]
    c["tiles"]["count"] = min(c["tiles"]["count"], 25)
    return c


def js_round(v):
    """JavaScript's Math.round: halves round up."""
    return math.floor(v + 0.5)


def spiral(config):
    """The top-left corners (x, y) of the first `tiles.count` tiles."""
    w, h = config["window"]
    size = config["tiles"]["size"]
    x, y = js_round((w - size) / 2), js_round((h - size) / 2)
    direction, counter, next_index = 0, 2, 1
    out = []
    for i in range(config["tiles"]["count"]):
        out.append((x, y))
        if i == next_index:
            direction = (direction + 1) % 4
            counter += 1
            next_index += counter >> 1
        dx, dy = ((1, 0), (0, -1), (-1, 0), (0, 1))[direction]
        x, y = x + dx * size, y + dy * size
    return out


def class_radii(corners, size):
    """[top-left, top-right, bottom-right, bottom-left] radii of a class
    that rounds `corners` at 100% of a `size` tile, after CSS's overlap
    scaling: every radius times the least of side / (the sum of the two
    radii on that side), where that is below 1."""
    r = [float(size) if name in corners else 0.0 for name in CORNERS]
    sums = (r[0] + r[1], r[3] + r[2], r[0] + r[3], r[1] + r[2])
    f = min([1.0] + [size / s for s in sums if s > size])
    return [v * f for v in r]


def init(config, rng) -> State:
    w, h = config["window"]
    t = config["tiles"]
    size = t["size"]
    n = t["count"]
    classes = [class_radii(c, size) for c in config["classes"]]
    items = [Item("rect", (0, 0, w, h), tuple(config["background"]))]
    distances = []
    kind = scene.plugin("items", "rounded_turned_rect", HOME)
    for x, y in spiral(config):
        cx, cy = x + size / 2, y + size / 2
        distances.append(math.hypot(w / 2 - cx, h / 2 - cy) / size)
        item = Item("rounded_turned_rect", (0, 0, 0, 0), params={
            "centre": [cx, cy], "size": size,
            "angle": float(rng.integers(0, 360)),
            "radii": list(classes[int(rng.integers(0, len(classes)))])})
        kind.place(item)
        items.append(item)
    state = State((w, h), items, {}, {
        "place": kind.place, "distances": distances,
        "steps": [max(3.0, d / 1.5) for d in distances],
        "distance_factor": 1.5 / math.sqrt(n), "frame": 0})
    scene.plugin("kinds", "rotate", HOME).paint(state)
    return state
