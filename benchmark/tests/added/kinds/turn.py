"""Every tile of a `tile_stage` page turns by `quarter_turns` (its
`params` changed in place) and takes a new colour; the display list is
sent again.

Operation parameters: `quarter_turns`.
"""
from scene import Change


def step(state, op, config, rng) -> Change:
    tiles = state.items[1:]
    before = [it.rect for it in tiles]
    for it in tiles:
        state.extra["turn"](it, op["quarter_turns"])
        it.color = state.extra["colour"](rng)
    return Change(display_list=True,
                  damage=before + [it.rect for it in tiles])
