"""examples/texture_cache_stress.rs equivalent: many small unique images."""
import numpy as np

from common import main_wrapper

from webrender_tpu_torch.api import (AlphaType, CommonItemProperties,
                                     ImageData, ImageDescriptor, ImageFormat,
                                     ImageRendering, Rect, SpatialId)


def texture_cache_stress(b, txn, backend, frame_idx, size):
    pid = b.pipeline_id
    root = SpatialId.root_scroll_node(pid)
    common = CommonItemProperties(Rect(0, 0, *size), root)
    rng = np.random.RandomState(3)
    key = 1000
    for gy in range(8):
        for gx in range(12):
            px = (rng.rand(16, 16, 4) * 255).astype(np.uint8)
            px[..., 3] = 255
            txn.add_image(key, ImageDescriptor(ImageFormat.RGBA8, 16, 16),
                          ImageData(pixels=px))
            b.push_image(common, Rect(10 + gx * 40, 10 + gy * 44, 32, 32),
                         ImageRendering.AUTO, AlphaType.PREMULTIPLIED_ALPHA,
                         key)
            key += 1


if __name__ == "__main__":
    main_wrapper(texture_cache_stress)
