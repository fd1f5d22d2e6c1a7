"""Whether the frames the timed path presented are right: each compared
frame against the plain reference's composition of the state that frame
should show (`reference.py`).

The numbers compared, over all compared frames:

* `pixels_off`: the pixels of the RGBA8 image where any channel differs;
* `max_step`: the largest difference of a channel, in u8 steps.

Their limits are in `limits/<workload>.json`.  A compared frame whose
image or state is missing counts as every pixel off.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

import reference

NAMES = ("pixels_off", "max_step")


def measure(image: np.ndarray, ref: np.ndarray) -> Dict[str, int]:
    if image is None or image.shape != ref.shape:
        return {"pixels_off": int(ref.shape[0] * ref.shape[1]),
                "max_step": 255}
    diff = np.abs(image.astype(np.int16) - ref.astype(np.int16))
    return {"pixels_off": int((diff.max(-1) > 0).sum()),
            "max_step": int(diff.max())}


def compare(cell, shown: Dict[int, np.ndarray], states: Dict[int, object],
            log=None, quantize=reference.identity) -> Dict[str, dict]:
    """{name: {"value", "limit"}} over the compared frames: `shown` maps a
    frame number to the RGBA8 image presented, `states` to the state
    (`scene.State`) it should show."""
    log = log or (lambda msg: None)
    worst = dict.fromkeys(NAMES, 0)
    for k in sorted(states):
        ref = reference.compose(states[k], quantize, cell.home)
        got = measure(shown.get(k), ref)
        log(f"frame {k}: " + ", ".join(f"{n} {v}" for n, v in got.items()))
        for n in NAMES:
            worst[n] = max(worst[n], got[n])
    if not states:
        w, h = cell.config["window"]
        worst = {"pixels_off": w * h, "max_step": 255}
    return {n: {"value": worst[n], "limit": cell.limits[n]} for n in NAMES}
