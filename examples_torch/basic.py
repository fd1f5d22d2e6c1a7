"""examples/basic.rs equivalent: rects, clips, gradients, borders."""
from common import main_wrapper

from webrender_tpu_torch.api import (BorderRadius, BorderSide, BorderStyle,
                                     ColorF, CommonItemProperties, ExtendMode,
                                     GradientStop, NormalBorder, Point2D, Rect,
                                     SideOffsets, SpatialId)


def basic(b, txn, backend, frame_idx, size):
    pid = b.pipeline_id
    root = SpatialId.root_scroll_node(pid)
    common = CommonItemProperties(Rect(0, 0, *size), root)
    b.push_rect(common, Rect(20, 20, 200, 120), ColorF(0.2, 0.5, 0.9, 1.0))
    g, stops = b.create_gradient(
        Point2D(0, 0), Point2D(160, 0),
        [GradientStop(0.0, ColorF(1, 0, 0, 1)),
         GradientStop(1.0, ColorF(1, 1, 0, 1))], ExtendMode.CLAMP)
    b.push_gradient(common, Rect(250, 20, 160, 120), g, stops)
    clip = b.define_clip_rounded_rect(root, Rect(20, 170, 200, 120),
                                      BorderRadius.uniform(24.0))
    chain = b.define_clip_chain(None, [clip])
    import dataclasses
    b.push_rect(dataclasses.replace(common, clip_chain_id=chain),
                Rect(20, 170, 200, 120), ColorF(0.1, 0.7, 0.3, 1.0))
    side = BorderSide(ColorF(0.6, 0.1, 0.4, 1.0), BorderStyle.SOLID)
    b.push_border(common, Rect(250, 170, 160, 120),
                  SideOffsets(8, 8, 8, 8),
                  details_normal=NormalBorder(side, side, side, side,
                                              BorderRadius.uniform(12.0)))


if __name__ == "__main__":
    main_wrapper(basic)
