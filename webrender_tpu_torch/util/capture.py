"""Capture / replay — the reference's checkpoint-resume subsystem
(`webrender/src/capture.rs` CaptureConfig :20, SURVEY.md §5.4).

The reference serializes nearly every pipeline struct to RON + raw payloads
(CaptureBits::{SCENE,FRAME,TILE_CACHE,EXTERNAL_RESOURCES}); wrench `show`
replays them. Here captures are a directory of pickles + npz payloads:

  capture/
    scene.pkl        — the Scene (display lists per pipeline) + doc params
    resources.pkl    — image templates / fonts / font instances
    frame.npz        — the built Frame's device arrays + pass descriptors

`save_capture` / `load_capture` round-trip a RenderBackend; `show` renders a
capture to a PNG (the wrench `show` subcommand).

The port's copy of `webrender_tpu/util/capture.py`: a capture pickles the
port's own classes, so it loads in the port (a capture of the JAX package
names that package's classes).  `load_capture` and `show` take the
`device` of the backend they make, the card by default.
"""
from __future__ import annotations

import enum
import pickle
from pathlib import Path
from typing import Optional

import numpy as np


class CaptureBits(enum.IntFlag):
    """render_api.rs CaptureBits."""
    SCENE = 1 << 0
    FRAME = 1 << 1
    TILE_CACHE = 1 << 2
    EXTERNAL_RESOURCES = 1 << 3


def save_capture(backend, root: str,
                 bits: CaptureBits = CaptureBits.SCENE | CaptureBits.FRAME
                 ) -> None:
    """RenderBackend::save_capture (render_backend.rs:1626) equivalent."""
    path = Path(root)
    path.mkdir(parents=True, exist_ok=True)
    if bits & CaptureBits.SCENE:
        with open(path / "scene.pkl", "wb") as f:
            pickle.dump({
                "scene": backend.scene,
                "device_size": backend.device_size,
                "dpr": backend.dpr,
                "background_color": backend.background_color,
                "scroll_offsets": backend.scroll_offsets,
                "properties": backend.properties,
            }, f)
        with open(path / "resources.pkl", "wb") as f:
            pickle.dump({
                "images": backend.resources.images,
                "font_instances": backend.resources.font_instances,
                # font faces are native handles; persist source paths
                "fonts": {},
            }, f)
    if bits & CaptureBits.FRAME and backend.last_frame is not None:
        fr = backend.last_frame
        np.savez_compressed(
            path / "frame.npz",
            f32_buf=fr.f32_buf, instances=fr.instances,
            transforms=fr.transforms, inst_bboxes=fr.inst_bboxes,
            fb_size=np.asarray(fr.fb_size),
            clear=np.asarray(fr.clear_color, np.float32))
        with open(path / "passes.pkl", "wb") as f:
            pickle.dump(fr.passes, f)


def load_capture(root: str, device="cuda"):
    """RenderBackend::load_capture equivalent: returns a ready backend on
    `device`."""
    from ..render_backend import RenderBackend
    path = Path(root)
    with open(path / "scene.pkl", "rb") as f:
        doc = pickle.load(f)
    backend = RenderBackend(tuple(doc["device_size"]), doc["dpr"],
                            doc["background_color"], device=device)
    backend.scene = doc["scene"]
    backend.scroll_offsets = doc["scroll_offsets"]
    backend.properties = doc["properties"]
    res_path = path / "resources.pkl"
    if res_path.exists():
        with open(res_path, "rb") as f:
            res = pickle.load(f)
        backend.resources.replace_images(res["images"])
        backend.resources.font_instances = res["font_instances"]
    if backend.scene.has_root_pipeline:
        from ..scene.scene_builder import build_scene
        backend.built_scene = build_scene(backend.scene,
                                          backend.background_color)
    return backend


def show(root: str, out_png: Optional[str] = None,
         device="cuda") -> np.ndarray:
    """wrench `show <capture>`: replay and render a capture on `device`
    (PIL is imported only to write `out_png`)."""
    backend = load_capture(root, device)
    img = backend.render()
    if out_png:
        from PIL import Image
        Image.fromarray(img).save(out_png)
    return img
