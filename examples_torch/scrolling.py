"""examples/scrolling.rs equivalent: nested scroll frames + scroll offsets."""
from common import main_wrapper

from webrender_tpu_torch.api import (ColorF, CommonItemProperties, Point2D,
                                     Rect, SpatialId)


def scrolling(b, txn, backend, frame_idx, size):
    pid = b.pipeline_id
    root = SpatialId.root_scroll_node(pid)
    clip = b.define_clip_rect(root, Rect(50, 50, 300, 200))
    chain = b.define_clip_chain(None, [clip])
    sf = b.define_scroll_frame(root, external_id=1,
                               content_rect=Rect(50, 50, 300, 1000),
                               frame_rect=Rect(50, 50, 300, 200))
    import dataclasses
    common = dataclasses.replace(
        CommonItemProperties(Rect(0, 0, 2000, 2000), sf), clip_chain_id=chain)
    for i in range(12):
        c = ColorF(0.2 + 0.06 * i, 0.3, 0.9 - 0.06 * i, 1.0)
        b.push_rect(common, Rect(60, 60 + i * 80, 280, 60), c)
    backend.scroll_offsets[1] = [(Point2D(0, frame_idx * 40.0), 0)]


if __name__ == "__main__":
    main_wrapper(scrolling, frames=3)
