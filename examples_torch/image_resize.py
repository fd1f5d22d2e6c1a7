"""examples/image_resize.rs equivalent: update an image template with new
pixels/size between frames; the cache re-uploads and the prim follows
(resource_cache.rs update_image_template)."""
import numpy as np

from common import main_wrapper

from webrender_tpu_torch.api import (AlphaType, CommonItemProperties,
                                     ImageData, ImageDescriptor, ImageFormat,
                                     ImageRendering, Rect, SpatialId)


def _checker(n, on, off):
    ys, xs = np.mgrid[0:n, 0:n]
    sel = ((xs // 8) ^ (ys // 8)) & 1
    img = np.zeros((n, n, 4), np.uint8)
    img[..., :3] = np.where(sel[..., None], on, off)
    img[..., 3] = 255
    return img


def image_resize(b, txn, backend, frame_idx, size):
    pid = b.pipeline_id
    root = SpatialId.root_scroll_node(pid)
    common = CommonItemProperties(Rect(0, 0, *size), root)
    if frame_idx == 0:
        txn.add_image(42, ImageDescriptor(ImageFormat.RGBA8, 64, 64),
                      ImageData(pixels=_checker(64, 50, 200)))
    else:
        # the resize: new descriptor + texels under the same key
        txn.update_image(42, ImageDescriptor(ImageFormat.RGBA8, 128, 128),
                         ImageData(pixels=_checker(128, 220, 30)))
    b.push_image(common, Rect(20, 20, 256, 256), ImageRendering.AUTO,
                 AlphaType.PREMULTIPLIED_ALPHA, 42)


if __name__ == "__main__":
    main_wrapper(image_resize, frames=2)
