"""A page of tiles that turn by quarter turns about their centres, over a
plain background: a page that a test adds to the benchmark as files
alone.

The configuration gives the window, the background colour and `tiles`:
how many, and their width and height (both even, so that a tile's
centre and its edges, turned or not, lie on whole pixels).  Each tile
is a `turned_rect` item with a seeded colour, centre and number of
quarter turns, placed so that it stays inside the window however it is
turned.
"""
import copy

from scene import Item, State


def small(config):
    """`config` on a 48x32 window, with at most 5 tiles."""
    c = copy.deepcopy(config)
    c["window"] = [48, 32]
    c["tiles"]["count"] = min(c["tiles"]["count"], 5)
    return c


def colour(rng):
    """A straight RGBA colour, at least half opaque."""
    r, g, b = rng.random(3)
    return (float(r), float(g), float(b), float(rng.uniform(0.5, 1.0)))


def turn(item, quarter_turns):
    """Turns `item` (in place, its `params` too) and sets its rect to the
    device box it covers."""
    p = item.params
    p["turns"] = (p["turns"] + quarter_turns) % 4
    w, h = p["size"] if p["turns"] % 2 == 0 else p["size"][::-1]
    cx, cy = p["centre"]
    item.rect = (cx - w // 2, cy - h // 2, cx + w // 2, cy + h // 2)


def init(config, rng) -> State:
    w, h = config["window"]
    t = config["tiles"]
    reach = max(t["width"], t["height"]) // 2
    items = [Item("rect", (0, 0, w, h), tuple(config["background"]))]
    for _ in range(t["count"]):
        centre = [int(rng.integers(reach, w - reach + 1)),
                  int(rng.integers(reach, h - reach + 1))]
        item = Item("turned_rect", (0, 0, 0, 0), colour(rng), params={
            "centre": centre, "size": [t["width"], t["height"]],
            "turns": int(rng.integers(0, 4))})
        turn(item, 0)
        items.append(item)
    return State((w, h), items, {}, {"turn": turn, "colour": colour})
