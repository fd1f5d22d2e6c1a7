"""examples/yuv.rs equivalent: planar + NV12 YUV images."""
import numpy as np

from common import main_wrapper

from webrender_tpu_torch.api import (ColorDepth, ColorRange,
                                     CommonItemProperties, ImageData,
                                     ImageDescriptor, ImageFormat,
                                     ImageRendering, Rect, SpatialId,
                                     YuvColorSpace)


def yuv(b, txn, backend, frame_idx, size):
    pid = b.pipeline_id
    root = SpatialId.root_scroll_node(pid)
    common = CommonItemProperties(Rect(0, 0, *size), root)
    w = h = 64
    y = np.full((h, w), 120, np.uint8)
    u = np.full((h // 2, w // 2), 200, np.uint8)
    v = np.full((h // 2, w // 2), 80, np.uint8)
    txn.add_image(101, ImageDescriptor(ImageFormat.R8, w, h),
                  ImageData(pixels=y))
    txn.add_image(102, ImageDescriptor(ImageFormat.R8, w // 2, h // 2),
                  ImageData(pixels=u))
    txn.add_image(103, ImageDescriptor(ImageFormat.R8, w // 2, h // 2),
                  ImageData(pixels=v))
    b.push_yuv_image(common, Rect(30, 30, 200, 200), [101, 102, 103],
                     "planar", ColorDepth.COLOR8, YuvColorSpace.REC709,
                     ColorRange.LIMITED, ImageRendering.AUTO)


if __name__ == "__main__":
    main_wrapper(yuv)
