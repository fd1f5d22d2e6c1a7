"""MotionMark's Multiply step (`multiply.js`, `animate`) on every tile of a
`spiral_stage` page: each tile turns by its step, max(3, distance / 1.5)
degrees (distance: from the stage's centre to the tile's, in tiles), and
takes the colour

    hsla(360 p, 100%, l tan(influence / 1.25) %, influence)

with p = (t mod 10000) / 10000 for the test's time t in ms,
l = lerp(sin(2 |0.5 - p|), 20, 50) and influence = max(0.01, 1 -
distance * 1.5 / sqrt(tiles)).  The time is the frame's, as a 60 Hz
display steps it (frame k at k * 1000 / 60 ms), not the wall clock, so
the same seed gives the same frames.  The display list is sent again
every frame, and each tile's device box before and after is damaged.
"""
import math

from scene import Change

FRAME_MS = 1000.0 / 60.0     # a 60 Hz display's frame


def hsl_to_rgb(h, s, lightness):
    """CSS's hsl(h deg, s, lightness) as straight RGB in [0, 1] (s and
    lightness in [0, 1], clamped)."""
    s = min(max(s, 0.0), 1.0)
    lightness = min(max(lightness, 0.0), 1.0)
    h = (h % 360.0) / 30.0
    a = s * min(lightness, 1.0 - lightness)

    def f(n):
        k = (n + h) % 12.0
        return lightness - a * max(-1.0, min(k - 3.0, 9.0 - k, 1.0))
    return f(0.0), f(8.0), f(4.0)


def colour(distance, distance_factor, t_ms):
    """The straight RGBA colour of a tile `distance` tiles from the centre
    at the test's time `t_ms`."""
    p = (t_ms % 10000.0) / 10000.0
    bounce = math.sin(2.0 * abs(0.5 - p))
    light = 20.0 + (50.0 - 20.0) * bounce
    influence = max(0.01, 1.0 - distance * distance_factor)
    r, g, b = hsl_to_rgb(360.0 * p, 1.0,
                         light * math.tan(influence / 1.25) / 100.0)
    return (r, g, b, influence)


def paint(state):
    """Colours every tile for the page's frame (`extra["frame"]`)."""
    x = state.extra
    t = x["frame"] * FRAME_MS
    for item, d in zip(state.items[1:], x["distances"]):
        item.color = colour(d, x["distance_factor"], t)


def step(state, op, config, rng) -> Change:
    tiles = state.items[1:]
    before = [it.rect for it in tiles]
    turn = state.extra["place"]
    for item, step_deg in zip(tiles, state.extra["steps"]):
        item.params["angle"] += step_deg
        turn(item)
    state.extra["frame"] += 1
    paint(state)
    return Change(display_list=True,
                  damage=before + [it.rect for it in tiles])
