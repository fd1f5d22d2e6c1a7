"""examples/animation.rs equivalent: animated transform property driving a
rotating rect across frames without scene rebuilds."""
from common import main_wrapper

from webrender_tpu_torch.api import (ColorF, CommonItemProperties, Point2D,
                                     Rect, SpatialId, Transform,
                                     TransformStyle)


def animation(b, txn, backend, frame_idx, size):
    pid = b.pipeline_id
    root = SpatialId.root_scroll_node(pid)
    angle = frame_idx * 15.0
    t = Transform.translation(-64, -48).then(
        Transform.rotation_z(angle)).then(Transform.translation(64, 48))
    rf = b.push_reference_frame(Point2D(128, 96), root, TransformStyle.FLAT,
                                t)
    common = CommonItemProperties(Rect(-1000, -1000, 4000, 4000), rf)
    b.push_rect(common, Rect(0, 0, 128, 96), ColorF(0.9, 0.4, 0.1, 1.0))
    b.pop_reference_frame()


if __name__ == "__main__":
    main_wrapper(animation, frames=6)
