"""examples/multiwindow.rs equivalent: several independent "windows", each
its own RenderBackend (scene + frame state), rendered side by side.  The
reference spawns one WebRender instance per window; here each backend owns
its renderer the same way.  The windows render on the card (`--cpu`: on
the CPU, `--oracle`: the numpy oracle).  Without a font stack (no
matplotlib or libfreetype) the text replays the port's recorded glyphs
(`webrender_tpu_torch.scenes.resource_cache`)."""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from common import device_from_argv, render, save

from webrender_tpu_torch import scenes
from webrender_tpu_torch.api import (ColorF, CommonItemProperties,
                                     DisplayListBuilder, Epoch, PipelineId,
                                     Rect, SpatialId, Transaction)
from webrender_tpu_torch.api.font import (FontInstanceKey,
                                          FontInstanceOptions, FontKey)
from webrender_tpu_torch.render_backend import RenderBackend


def build_window(idx, size, device="cuda", argv=None):
    backend = RenderBackend(size, resources=scenes.resource_cache(),
                            device=device)
    pid = PipelineId(0, 1)
    fk = FontKey(0, 1)
    fik = FontInstanceKey(0, 1)
    pre = Transaction()
    pre.add_native_font(fk, scenes.dejavu_path())
    pre.add_font_instance(fik, fk, 18.0, FontInstanceOptions())
    backend.send_transaction(pre)

    b = DisplayListBuilder(pid)
    b.begin()
    root = SpatialId.root_scroll_node(pid)
    common = CommonItemProperties(Rect(0, 0, *size), root)
    hue = [ColorF(0.9, 0.4, 0.3, 1), ColorF(0.3, 0.7, 0.4, 1),
           ColorF(0.3, 0.4, 0.9, 1)][idx % 3]
    b.push_rect(common, Rect(0, 0, *size), ColorF(0.95, 0.95, 0.95, 1))
    b.push_rect(common, Rect(16, 16, size[0] - 32, 48), hue)
    glyphs = []
    x = 24.0
    text = f"window {idx}"
    for ch in text:
        gi = backend.resources.fonts.glyph_index(fk, ch)
        glyphs.append((gi, x, 48.0))
        x += backend.resources.fonts.linear_advance(fk, 18.0, gi)
    b.push_text(common, Rect(20, 28, 200, 28), glyphs, fik.key,
                ColorF(0, 0, 0, 1))
    _, dl = b.end()
    txn = Transaction()
    txn.set_root_pipeline(pid)
    txn.set_display_list(Epoch(0), dl)
    txn.generate_frame()
    backend.send_transaction(txn)
    return render(backend, argv)


def main(device=None, out=None, argv=None):
    argv = sys.argv if argv is None else argv
    size = (220, 160)
    imgs = [build_window(i, size, device or device_from_argv(argv), argv)
            for i in range(3)]
    img = np.concatenate(imgs, axis=1)
    save(img, "multiwindow", out, argv)
    return img


if __name__ == "__main__":
    main()
