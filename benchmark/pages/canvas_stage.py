"""A stage of canvas elements over a plain background, as MotionMark's
canvas tests lay them out (`Images`: `image-data.js`).

The configuration gives the window, the background colour, the stage's
rect and `canvases`: how many, their size, and the grid they sit on.
Each canvas is an image key of its own, drawn at its own size at a
random cell of the grid (`randomInt(0, floor((stage - size) / size)) *
size` on each axis, both ends included) with one of the page's icons
drawn into it.  The icons (`icons`) are made from the seed: soft-edged
discs and bars on a transparent ground, as the test's SVG icons are
drawn into a canvas.  The canvases are painted in the order they were
made, over the background.
"""
import copy

import numpy as np

from scene import Item, State


def small(config):
    """`config` on a 300x150 window and stage: the same page, kinds and
    grid, at most 24 canvases, none larger than the stage, icons at the
    canvas size."""
    c = copy.deepcopy(config)
    w, h = 300, 150
    c["window"] = [w, h]
    c["stage"] = [0, 0, w, h]
    cv = c["canvases"]
    cv["count"] = min(cv["count"], 24)
    cv["width"], cv["height"] = min(cv["width"], w), min(cv["height"], h)
    c["icons"].update(width=cv["width"], height=cv["height"])
    return c


def icons(spec, rng):
    """`spec["count"]` icons (n, h, w, 4) uint8, premultiplied: a disc
    with a one-pixel soft edge and a bar across it, in seeded colours."""
    n, w, h = spec["count"], spec["width"], spec["height"]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) + np.float32(0.5)
    out = np.zeros((n, h, w, 4), np.uint8)
    for i in range(n):
        cx, cy = rng.uniform(0.4, 0.6, 2) * (w, h)
        r = rng.uniform(0.28, 0.45) * min(w, h)
        disc = np.clip(r + 0.5 - np.hypot(xx - cx, yy - cy), 0.0, 1.0)
        bar_h = rng.uniform(0.12, 0.3) * h
        bar = np.clip(np.minimum(yy - (cy - bar_h / 2) + 0.5,
                                 (cy + bar_h / 2) - yy + 0.5), 0.0, 1.0)
        bar = bar * disc
        a = np.stack([disc, bar], 0)                  # two layers
        cols = rng.random((2, 3)).astype(np.float32)
        opacity = np.asarray([1.0, rng.uniform(0.6, 1.0)], np.float32)
        acc = np.zeros((h, w, 4), np.float32)
        for layer in range(2):
            la = a[layer] * opacity[layer]
            src = np.concatenate([cols[layer] * la[..., None],
                                  la[..., None]], -1)
            acc = src + acc * (1.0 - la[..., None])
        out[i] = np.clip(np.rint(acc * 255.0), 0, 255).astype(np.uint8)
    return out


def cell(config, rng):
    """A random grid position (x, y) for a canvas, inside the stage."""
    sx, sy, sw, sh = config["stage"]
    c = config["canvases"]
    w, h = c["width"], c["height"]
    top = int(rng.integers(0, (sh - h) // h + 1)) * h
    left = int(rng.integers(0, (sw - w) // w + 1)) * w
    return sx + left, sy + top


def draw_over(dst, src):
    """`src` drawn over `dst` (premultiplied uint8), as a canvas's
    `drawImage` composes: src + dst (255 - src alpha) / 255, rounded."""
    d = dst.astype(np.int32)
    s = src.astype(np.int32)
    out = s + (d * (255 - s[..., 3:4]) + 127) // 255
    return np.clip(out, 0, 255).astype(np.uint8)


def place(state, i, rng, config):
    """Canvas `i` to a new cell with a random icon drawn into it."""
    c = config["canvases"]
    x, y = cell(config, rng)
    item = state.extra["canvas_items"][i]
    item.rect = (x, y, x + c["width"], y + c["height"])
    px = state.extra["canvas_px"]
    icon = state.extra["icons"][int(rng.integers(0, len(
        state.extra["icons"])))]
    px[i] = draw_over(px[i], icon)


def init(config, rng) -> State:
    w, h = config["window"]
    c = config["canvases"]
    n = c["count"]
    items = [Item("rect", (0, 0, w, h), tuple(config["background"]))]
    px = np.zeros((n, c["height"], c["width"], 4), np.uint8)
    state = State((w, h), items, {}, {
        "icons": icons(config["icons"], rng), "canvas_px": px,
        "canvas_items": [], "keys": [], "place": place})
    for i in range(n):
        key = c["first_key"] + i
        item = Item("image", (0, 0, 0, 0), key=key)
        items.append(item)
        state.extra["canvas_items"].append(item)
        state.extra["keys"].append(key)
        state.images[key] = px[i]
        place(state, i, rng, config)
    return state
