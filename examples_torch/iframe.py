"""examples/iframe.rs equivalent: nested pipeline via iframe."""
from common import main_wrapper

from webrender_tpu_torch.api import (ColorF, CommonItemProperties,
                                     DisplayListBuilder, Epoch, PipelineId,
                                     Rect, SpatialId)


def iframe(b, txn, backend, frame_idx, size):
    pid = b.pipeline_id
    sub_pid = PipelineId(0, 2)
    sub = DisplayListBuilder(sub_pid)
    sub.begin()
    sub_root = SpatialId.root_scroll_node(sub_pid)
    sub.push_rect(CommonItemProperties(Rect(0, 0, 1000, 1000), sub_root),
                  Rect(0, 0, 100, 100), ColorF(0.8, 0.2, 0.6, 1.0))
    _, sub_dl = sub.end()
    txn.set_display_list(Epoch(0), sub_dl)

    root = SpatialId.root_scroll_node(pid)
    common = CommonItemProperties(Rect(0, 0, *size), root)
    b.push_rect(common, Rect(10, 10, 400, 300), ColorF(0.9, 0.9, 0.9, 1.0))
    b.push_iframe(Rect(50, 50, 100, 100), Rect(50, 50, 100, 100), root,
                  sub_pid)


if __name__ == "__main__":
    main_wrapper(iframe)
