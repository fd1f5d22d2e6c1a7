"""MotionMark's `Images` step (`image-data.js`, `animate`) on every canvas
of a `canvas_stage` page: each pixel whose alpha is not 0 takes the
colour of a random neighbour, then the canvas is put back
(`putImageData`); a canvas none of whose pixels was drawn, or one in
`refresh_above` of the draws, moves to a new cell of the grid with a new
icon drawn over it.

The neighbour is `x + dx, y + dy` with each of dx, dy
`floor((r - lo) / (hi - lo))` for a uniform r (lo and hi are the test's
weight thresholds): -1 below lo, 1 from hi on, else 0; indexed as the test indexes the canvas's
bytes: a flat index that wraps at the end, and below 0 reads nothing,
which a typed array stores as 0.  All pixels read the canvas as it was
before the step (the test reads pixels it has already updated in this
step; the renderer gets the same amount of new texels either way).

Operation parameters: `weight_negative_threshold`,
`weight_positive_threshold`, `refresh_above`.
"""
import numpy as np

from scene import Change


def step(state, op, config, rng) -> Change:
    px = state.extra["canvas_px"]
    n, h, w, _ = px.shape
    flat = px.reshape(n, h * w, 4).view(np.uint32)[..., 0]   # (n, h*w)
    # one draw a pixel and axis, as the test draws, on 32 bits
    r = rng.integers(0, 1 << 32, size=(2, n * h * w), dtype=np.uint32)
    neg = r < np.uint32(round(op["weight_negative_threshold"] * 2 ** 32))
    pos = r >= np.uint32(round(op["weight_positive_threshold"] * 2 ** 32))
    # only the pixels whose neighbour is another pixel can change
    moving = neg | pos
    at = np.flatnonzero(moving[0] | moving[1])
    dx = pos[0, at].astype(np.int32) - neg[0, at]
    dy = pos[1, at].astype(np.int32) - neg[1, at]
    p = at % (h * w)
    idx = p + dx + w * dy
    flat = flat.reshape(-1)
    neighbour = flat[at - p + np.maximum(idx, 0) % (h * w)]
    neighbour[idx < 0] = 0
    take = (flat[at] >> np.uint32(24)) != 0
    flat[at[take]] = neighbour[take]
    drawn = (flat.reshape(n, h * w) >> np.uint32(24)) != 0
    before = [it.rect for it in state.extra["canvas_items"]]
    refresh = ~drawn.any(1) | (rng.random(n) > op["refresh_above"])
    for i in np.flatnonzero(refresh):
        state.extra["place"](state, int(i), rng, config)
    after = [it.rect for it in state.extra["canvas_items"]]
    moved = [i for i in range(n) if before[i] != after[i]]
    return Change(display_list=bool(moved), images=list(state.extra["keys"]),
                  damage=before + [after[i] for i in moved])
