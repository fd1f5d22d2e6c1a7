"""Example boilerplate for the PyTorch/CUDA port (`webrender_tpu_torch`):
set up a backend, run the example's display-list builder once per frame,
render, and save the image.

The counterpart of `examples/common.py`.  A script renders through the
port's `RenderBackend` on the card by default; `--cpu` renders on the CPU
(the tile kernel's plain version), `--oracle` through the port's numpy
oracle (`render_software`).  The image is written as a PNG where PIL
imports, else as an `.npy` array, into `--out DIR` (the temporary
directory by default)."""
import pathlib
import sys
import tempfile

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from webrender_tpu_torch.api import (DisplayListBuilder, Epoch,
                                     PipelineId, Transaction)
from webrender_tpu_torch.render_backend import RenderBackend


def device_from_argv(argv=None) -> str:
    """"cpu" under `--cpu`, else "cuda"."""
    return "cpu" if "--cpu" in (sys.argv if argv is None else argv) \
        else "cuda"


def render(backend, argv=None):
    """The backend's frame as RGBA8: its `render_software` under
    `--oracle`, else its `render`."""
    argv = sys.argv if argv is None else argv
    return backend.render_software() if "--oracle" in argv \
        else backend.render()


def save(img, name: str, out=None, argv=None):
    """Writes `img` as `<name>.png` (PIL) or `<name>.npy` (no PIL) into
    `out`, `--out DIR` or the temporary directory; returns the path."""
    argv = sys.argv if argv is None else argv
    if out is None:
        out = argv[argv.index("--out") + 1] if "--out" in argv \
            else tempfile.gettempdir()
    base = pathlib.Path(out) / name
    base.parent.mkdir(parents=True, exist_ok=True)
    try:
        from PIL import Image
    except ImportError:
        path = base.with_suffix(".npy")
        np.save(path, img)
    else:
        path = base.with_suffix(".png")
        Image.fromarray(img).save(path)
    print(f"wrote {path}")
    return path


def main_wrapper(example, size=(512, 384), frames=1, out=None, device=None,
                 argv=None):
    """Runs `example(builder, txn, backend, frame_idx, size)` once per
    frame, renders each frame and saves the last; returns its RGBA8."""
    argv = sys.argv if argv is None else argv
    backend = RenderBackend(size, device=device or device_from_argv(argv))
    pid = PipelineId(0, 1)
    img = None
    for frame_idx in range(frames):
        b = DisplayListBuilder(pid)
        b.begin()
        txn = Transaction()
        example(b, txn, backend, frame_idx, size)
        _, dl = b.end()
        txn.set_root_pipeline(pid)
        txn.set_display_list(Epoch(frame_idx), dl)
        txn.generate_frame()
        backend.send_transaction(txn)
        img = render(backend, argv)
    save(img, example.__name__, out, argv)
    return img
