"""The benchmark's own description of a page, as plain data, and the
plug-ins that give it meaning.

A page's state (`State`) is a window, a list of drawn items in paint
order and the texels of each image key.  Both sides start from it: the
program gets it as `api` transactions (`transaction`), the reference
composes it directly (`reference.py`).  Everything that belongs to one
kind of thing is a file of its own, found by name:

* `pages/<name>.py`: `init(config, rng) -> State`, the page a
  configuration names under `"page"`, and `small(config) -> config`, the
  same page at a size a test on the CPU holds;
* `kinds/<name>.py`: `step(state, op, config, rng) -> Change`, one kind
  of traffic operation, which a mix names under `"kind"`;
* `items/<name>.py`: one kind of drawn item: `push(A, builder, common,
  item)` for the program's display list, `source(item, state,
  quantize)` for the reference, and `OPS`, its operations a pixel for the
  work count.

What an item kind may rely on, and must keep:

* `item.rect` is the item's bounding box in device (window) pixels,
  whatever the item's own transform;
* `source` returns the premultiplied RGBA8 (h, w, 4) over that box,
  transparent outside the item's shape; the reference composes it there;
* `push` draws under `common`'s spatial node and clip; it may push its
  own reference frame, stacking context and clip chain under that node,
  and pops what it pushed;
* `item.params` holds the kind's own parameters (an angle, radii); only
  the kind's file reads it, and a kind may change it in place: each
  snapshot (`State.copy`, `State.layout`) holds copies of its own;
* `area(item)`, where a kind defines it, is the pixels the item covers
  (the work count's; without it, the rect's area).
"""
from __future__ import annotations

import copy
import dataclasses
import importlib.util
import pathlib
from typing import Dict, List, Tuple

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent

Rect = Tuple[int, int, int, int]          # x0, y0, x1, y1 in window pixels


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for `seed` (any whole number) and a stream label."""
    return np.random.default_rng([seed % (1 << 64), *stream])


@dataclasses.dataclass
class Item:
    """One drawn item: its kind (`items/<kind>.py`), its rect, its paint:
    a straight (not premultiplied) RGBA colour in [0, 1] (`color`) or an
    image key (`key`), and its kind's own parameters (`params`)."""
    kind: str
    rect: Rect
    color: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    key: int = -1
    params: dict = dataclasses.field(default_factory=dict)

    def snapshot(self) -> "Item":
        """A copy that shares nothing the page may change in place."""
        return dataclasses.replace(self, params=copy.deepcopy(self.params))


@dataclasses.dataclass
class State:
    """A page as it stands: the window (w, h), the items in paint order
    and each image key's texels (h, w, 4) uint8, premultiplied RGBA.
    `extra` holds what a page's operations keep between frames (the
    reference never reads it)."""
    window: Tuple[int, int]
    items: List[Item]
    images: Dict[int, np.ndarray]
    extra: dict = dataclasses.field(default_factory=dict)

    def copy(self) -> "State":
        """The items and texels as they stand now (for the reference)."""
        return State(self.window, [i.snapshot() for i in self.items],
                     {k: v.copy() for k, v in self.images.items()})

    def layout(self) -> "State":
        """The items as they stand now, over the same texels (for the work
        count, which reads only the texels' sizes)."""
        return State(self.window, [i.snapshot() for i in self.items],
                     self.images)


@dataclasses.dataclass
class Change:
    """What one frame's operations changed: whether the display list is
    sent again, which image keys get new texels, and the window rects
    whose pixels may differ from the last frame's (`damage`)."""
    display_list: bool = False
    images: List[int] = dataclasses.field(default_factory=list)
    damage: List[Rect] = dataclasses.field(default_factory=list)

    def merge(self, other: "Change") -> "Change":
        return Change(self.display_list or other.display_list,
                      sorted(set(self.images) | set(other.images)),
                      self.damage + other.damage)


_PLUGINS: Dict[Tuple[str, str, str], object] = {}


def plugin(folder: str, name: str, home=HERE):
    """The module `<home>/<folder>/<name>.py`."""
    key = (folder, name, str(home))
    mod = _PLUGINS.get(key)
    if mod is not None:
        return mod
    path = pathlib.Path(home) / folder / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no {folder[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"_bench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _PLUGINS[key] = mod
    return mod


def transaction(A, state: State, change: Change, epoch: int,
                first: bool = False, home=HERE):
    """The `api` transaction (namespace `A`) that brings the program from
    the last frame's state to `state`: on the first frame every image is
    added and the display list set; later the changed images are updated
    and the display list is sent again where it changed.  The texels are
    copied, so the state may move on."""
    txn = A.Transaction()
    keys = sorted(state.images) if first else change.images
    for key in keys:
        px = np.ascontiguousarray(state.images[key]).copy()
        desc = A.ImageDescriptor(A.ImageFormat.RGBA8, px.shape[1],
                                 px.shape[0])
        data = A.ImageData(pixels=px)
        if first:
            txn.add_image(key, desc, data)
        else:
            txn.update_image(key, desc, data)
    if first or change.display_list:
        pid = A.PipelineId(0, 1)
        b = A.DisplayListBuilder(pid)
        b.begin()
        w, h = state.window
        root = A.SpatialId.root_scroll_node(pid)
        common = A.CommonItemProperties(A.Rect(0, 0, w, h), root)
        for item in state.items:
            plugin("items", item.kind, home).push(A, b, common, item)
        _, dl = b.end()
        if first:
            txn.set_root_pipeline(pid)
        txn.set_display_list(A.Epoch(epoch), dl)
    txn.generate_frame()
    return txn
