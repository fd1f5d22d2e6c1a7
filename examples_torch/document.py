"""examples/document.rs equivalent: multiple documents with distinct
viewports sharing one renderer (render_backend.rs Documents map).  The
four documents render on the card (`--cpu`: on the CPU, `--oracle`: the
numpy oracle) and are saved side by side."""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from common import device_from_argv, save

from webrender_tpu_torch.api import (ColorF, CommonItemProperties,
                                     DisplayListBuilder, Epoch, PipelineId,
                                     Rect, SpatialId, Transaction)
from webrender_tpu_torch.render_backend import MultiDocumentBackend


def build_doc(mdb, doc_id, pid, color, size):
    b = DisplayListBuilder(pid)
    b.begin()
    root = SpatialId.root_scroll_node(pid)
    common = CommonItemProperties(Rect(0, 0, *size), root)
    b.push_rect(common, Rect(0, 0, *size), color)
    b.push_rect(common, Rect(10, 10, size[0] // 2, size[1] // 2),
                ColorF(1, 1, 1, 0.6))
    _, dl = b.end()
    txn = Transaction()
    txn.set_root_pipeline(pid)
    txn.set_display_list(Epoch(0), dl)
    txn.generate_frame()
    mdb.send_transaction(doc_id, txn)


def main(device=None, out=None, argv=None):
    argv = sys.argv if argv is None else argv
    mdb = MultiDocumentBackend(device or device_from_argv(argv))
    # four quadrant documents like the reference example's sub-windows
    colors = [ColorF(0.8, 0.2, 0.2, 1), ColorF(0.2, 0.8, 0.2, 1),
              ColorF(0.2, 0.2, 0.8, 1), ColorF(0.8, 0.8, 0.2, 1)]
    size = (256, 192)
    tiles = []
    for i, col in enumerate(colors):
        mdb.add_document(i, size)
        build_doc(mdb, i, PipelineId(0, i + 1), col, size)
        doc = mdb.documents[i]
        tiles.append(doc.render_software() if "--oracle" in argv
                     else mdb.render(i))
    top = np.concatenate(tiles[:2], axis=1)
    bot = np.concatenate(tiles[2:], axis=1)
    img = np.concatenate([top, bot], axis=0)
    save(img, "document", out, argv)
    return img


if __name__ == "__main__":
    main()
