"""examples/blob.rs equivalent: blob images rasterized by an embedder
callback (image.rs BlobImageHandler :374; wrench/src/blob.rs
CheckerboardRenderer)."""
import struct

import numpy as np

from common import main_wrapper

from webrender_tpu_torch.api import (AlphaType, CommonItemProperties,
                                     ImageData, ImageDescriptor, ImageFormat,
                                     ImageRendering, Rect, SpatialId)
from webrender_tpu_torch.resources.resource_cache import \
    CheckerboardBlobHandler


def blob(b, txn, backend, frame_idx, size):
    backend.resources.set_blob_image_handler(CheckerboardBlobHandler())
    pid = b.pipeline_id
    root = SpatialId.root_scroll_node(pid)
    common = CommonItemProperties(Rect(0, 0, *size), root)
    rng = np.random.RandomState(42)
    key = 500
    for i in range(6):
        ts = int(rng.choice([8, 16, 24]))
        r, g, bl = (int(v) for v in rng.randint(0, 255, 3))
        blob_cmds = struct.pack("<iBBB", ts, r, g, bl)
        w = int(rng.uniform(64, 160))
        h = int(rng.uniform(48, 128))
        txn.add_blob_image(key, ImageDescriptor(ImageFormat.RGBA8, w, h),
                           blob_cmds)
        x = 20 + (i % 3) * 170
        y = 20 + (i // 3) * 160
        b.push_image(common, Rect(x, y, w, h), ImageRendering.AUTO,
                     AlphaType.PREMULTIPLIED_ALPHA, key)
        key += 1


if __name__ == "__main__":
    main_wrapper(blob)
