"""The one traffic generator: the page a configuration names
(`pages/<page>.py`), moved frame by frame by the operations of a mix
(`traffic/<name>.json`).

A mix is data: `ops`, a list of operations, each with its `kind`
(`kinds/<kind>.py`), the frames it fires on (`every`: frame k fires
where k % every == 0; frames count from 1, the warm-up frames first) and
its kind's parameters; `warmup_frames`, `trace_frames` and
`batch_frames` (how many frames the client makes ahead, outside the
window's clock).  Every random draw comes from the seed, the frame and
the operation's place in the mix, so the same seed gives the same frames
however they are batched.
"""
from __future__ import annotations

import json
import pathlib
from typing import Tuple

import scene

HERE = pathlib.Path(__file__).resolve().parent


def load_mix(name: str, home=HERE) -> dict:
    """The mix `traffic/<name>.json` under `home`."""
    return json.loads((pathlib.Path(home) / "traffic" /
                       f"{name}.json").read_text())


class Traffic:
    """The frames of mix `mix` on the page of `config` for `seed`; `state`
    is the page as the last frame made left it."""

    def __init__(self, config: dict, mix: dict, seed: int, home=HERE):
        self.config = config
        self.mix = mix
        self.seed = seed
        self.home = home
        page = scene.plugin("pages", config["page"], home)
        self.state = page.init(config, scene.seed_rng(seed, 1))
        self.kinds = [scene.plugin("kinds", op["kind"], home)
                      for op in mix["ops"]]
        self.k = 0

    def step(self) -> Tuple[int, scene.Change]:
        """Moves the page to the next frame: (its number, what changed)."""
        self.k += 1
        change = scene.Change()
        for i, (op, kind) in enumerate(zip(self.mix["ops"], self.kinds)):
            if self.k % op.get("every", 1):
                continue
            rng = scene.seed_rng(self.seed, 2, i, self.k)
            change = change.merge(kind.step(self.state, op, self.config,
                                            rng))
        return self.k, change

    def first_transaction(self, A):
        """The transaction that sets up the page: images and display list."""
        return scene.transaction(A, self.state, scene.Change(), 0,
                                 first=True, home=self.home)

    def transaction(self, A, k: int, change: scene.Change):
        """Frame k's transaction, from the state as frame k left it."""
        return scene.transaction(A, self.state, change, k, home=self.home)
