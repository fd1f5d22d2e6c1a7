"""Images updated without a new display list, on the port's default path
(picture caching on), against the JAX package on the CPU (C2).

The tile hashes of a cached root grid or scroll slice cover each
instance's record and payload, which holds an image's uv rect, not its
texels; a same-size update keeps its atlas region, so the hashes stay
equal.  The port's renderer keeps the upload epoch each cached tile was
rastered at and re-rasters a tile one of whose instances samples a texel
uploaded since (`Renderer._texel_dirty`).  The JAX package's cached
renderer presents the old texels here; each case is held against its
`render_software` (the numpy oracle, uncached), bitwise, and against the
port's uncached render and its `render_software` (float32 `where`s),
bitwise (`torch_twin.Trio`).

* A same-size `update_image` at the root and inside a scroll-frame slice,
  an external image whose generation moves, a blob update and a blob's
  visible area moved: each a resource-only transaction; `last_dirty_tiles`
  is the number of tiles listing an instance that samples the region
  (`scenes.tiles_sampling`), and the unchanged frame after it
  re-rasters none and runs no texel-epoch check.
* The alpha atlas goes through the same check: an upload into a video
  plane's region (no frame builder path re-uploads a plane in place: a
  video tick takes new regions) re-rasters exactly the tiles of the video.
* A frame with no upload since the last render (unchanged, or scrolled)
  runs no texel-epoch check (`Renderer.texel_checks`).
"""
import struct

import numpy as np
import pytest

from torch_twin import Trio, side

from webrender_tpu_torch.resources.resource_cache import (ATLAS_ALPHA,
                                                          PendingUpload)
from webrender_tpu_torch.scenes import image_rect, tiles_sampling

SIZE = (384, 192)


def _pixels(seed, w, h):
    """Seeded opaque RGBA8 texels, blocky (8x8 cells)."""
    rng = np.random.RandomState(seed)
    cells = rng.randint(0, 256, ((h + 7) // 8, (w + 7) // 8, 4))
    px = np.kron(cells, np.ones((8, 8, 1), int))[:h, :w].astype(np.uint8)
    px[..., 3] = 255
    return px


def _page(A, backend, key, items, scroll=False, txn=None, epoch=0):
    """A backdrop, a rect and image `key` drawn at each of `items` (rects
    x, y, w, h; a 4-tuple with a fifth value repeats the image at that
    stride), at the root or (`scroll`) inside a scroll frame."""
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    root = A.SpatialId.root_scroll_node(pid)
    common = A.CommonItemProperties(A.Rect(0, 0, 4096, 4096), root)
    b.push_rect(common, A.Rect(0, 0, *SIZE), A.ColorF(0.95, 0.95, 0.97, 1))
    b.push_rect(common, A.Rect(200, 20, 90, 40), A.ColorF(0.2, 0.5, 0.8, 1))
    node = root
    if scroll:
        node = b.define_scroll_frame(root, external_id=5,
                                     content_rect=A.Rect(0, 0, 384, 2000),
                                     frame_rect=A.Rect(0, 0, 384, 192))
    inner = A.CommonItemProperties(A.Rect(0, 0, 4096, 4096), node)
    for item in items:
        rect = A.Rect(*item[:4])
        if len(item) == 5:
            s = item[4]
            b.push_repeating_image(inner, rect, A.Size2D(s, s),
                                   A.Size2D(0, 0), A.ImageRendering.AUTO,
                                   A.AlphaType.PREMULTIPLIED_ALPHA, key)
        else:
            b.push_image(inner, rect, A.ImageRendering.AUTO,
                         A.AlphaType.PREMULTIPLIED_ALPHA, key)
    _, dl = b.end()
    txn = txn or A.Transaction()
    txn.set_root_pipeline(pid)
    txn.set_display_list(A.Epoch(epoch), dl)
    txn.generate_frame()
    backend.send_transaction(txn)


def _resource_only(fill):
    """A flow sending one transaction of resource updates (`fill(A, txn,
    backend)`) and no display list."""
    def flow(A, backend):
        txn = A.Transaction()
        fill(A, txn, backend)
        txn.generate_frame()
        backend.send_transaction(txn)
    return flow


def _held(trio, key, old):
    """Render the trio after an update of image `key`; the image changed,
    the port re-rastered exactly the tiles sampling its region, and the
    unchanged frame after re-rasters none and checks nothing."""
    r = trio.port.renderer
    checks = r.texel_checks
    img = trio.render()
    assert not np.array_equal(img, old)
    want = tiles_sampling(trio.port.last_frame,
                                image_rect(trio.port, key))
    assert want > 0
    assert r.last_dirty_tiles == want
    assert r.texel_checks > checks
    checks = r.texel_checks
    np.testing.assert_array_equal(trio.port.render(), img)
    assert r.last_dirty_tiles == 0
    assert r.texel_checks == checks
    return img


# (items, scroll): image key 1 drawn at the root, twice and repeated, or
# inside a scroll-frame slice
PLACEMENTS = {
    "root": ([(10, 10, 64, 64), (150, 70, 96, 96), (20, 100, 170, 60, 20)],
             False),
    "slice": ([(10, 30, 64, 64), (250, 100, 48, 48)], True),
}


@pytest.mark.parametrize("where", sorted(PLACEMENTS))
def test_same_size_update_image(where):
    """Three same-size `update_image`s of a 32x32 image, each alone in a
    transaction; in the slice the cached content tiles re-raster."""
    items, scroll = PLACEMENTS[where]
    trio = Trio(SIZE)

    def first(A, backend):
        txn = A.Transaction()
        txn.add_image(1, A.ImageDescriptor(A.ImageFormat.RGBA8, 32, 32),
                      A.ImageData(pixels=_pixels(0, 32, 32)))
        _page(A, backend, 1, items, scroll, txn)
    trio.send(first)
    img = trio.render()
    for step in range(1, 4):
        trio.send(_resource_only(lambda A, txn, backend: txn.update_image(
            1, A.ImageDescriptor(A.ImageFormat.RGBA8, 32, 32),
            A.ImageData(pixels=_pixels(step, 32, 32)))))
        img = _held(trio, 1, img)
    if scroll:
        debug = trio.port.renderer.slice_debug
        assert [d["dirty"] for d in debug if d["key"][2] is not None] == [0]


def test_external_image_generation_bump():
    """An external image whose handler bumps its generation re-uploads in
    place every frame with no transaction but `generate_frame`."""
    trio = Trio(SIZE)
    handlers = {}

    def first(A, backend):
        img_mod = side(backend, "api.image")

        class Handler(img_mod.ExternalImageHandler):
            gen = 1
            pixels = _pixels(10, 40, 24)

            def lock(self, id, channel_index):
                return img_mod.ExternalImage(pixels=self.pixels,
                                             generation=self.gen)

            def unlock(self, id, channel_index):
                pass

        handlers[id(backend)] = Handler()
        backend.resources.set_external_image_handler(handlers[id(backend)])
        txn = A.Transaction()
        txn.add_image(1, A.ImageDescriptor(A.ImageFormat.RGBA8, 40, 24),
                      A.ImageData(external=img_mod.ExternalImageData(
                          img_mod.ExternalImageId(42))))
        _page(A, backend, 1, [(30, 20, 120, 72), (250, 120, 40, 24)],
              txn=txn)
    trio.send(first)
    img = trio.render()
    for gen in (2, 3):
        for h in handlers.values():
            h.gen = gen
            h.pixels = _pixels(10 + gen, 40, 24)
        trio.send(_resource_only(lambda A, txn, backend: None))
        img = _held(trio, 1, img)


def _blob(A, backend, area=None):
    rc = side(backend, "resources.resource_cache")
    backend.resources.set_blob_image_handler(rc.CheckerboardBlobHandler())
    txn = A.Transaction()
    txn.add_blob_image(4, A.ImageDescriptor(A.ImageFormat.RGBA8, 96, 96),
                       struct.pack("<iBBB", 16, 255, 0, 0))
    if area is not None:
        txn.set_blob_image_visible_area(4, area)
    _page(A, backend, 4, [(10, 10, 96, 96), (200, 90, 96, 96)], txn=txn)


def test_blob_update_without_new_display_list():
    """rawtest.rs test_blob_update_epoch_test on the default path: the
    blob's bytes change in a resource-only transaction."""
    trio = Trio(SIZE)
    trio.send(_blob)
    img = trio.render()
    for color in ((0, 0, 255), (30, 200, 60)):
        trio.send(_resource_only(lambda A, txn, backend: txn.update_image(
            4, A.ImageDescriptor(A.ImageFormat.RGBA8, 96, 96),
            A.ImageData(blob=struct.pack("<iBBB", 16, *color)))))
        img = _held(trio, 4, img)


def test_blob_visible_area_moved():
    """rawtest.rs test_blob_set_visible_area on the default path: the
    visible area moves, the same display list sent again (its frame's
    arrays, and so its tile hashes, are those of the last frame).  A move
    sent alone shows in neither package, uncached or not: the resource
    cache bumps the template's generation but not its content epoch, so
    the backend keeps its last frame (`ROADMAP.md` C)."""
    trio = Trio(SIZE)
    trio.send(lambda A, backend: _blob(A, backend, (0, 0, 48, 48)))
    img = trio.render()
    for epoch, area in enumerate(((48, 48, 96, 96), (16, 0, 80, 64)), 1):
        def move(A, backend):
            txn = A.Transaction()
            txn.set_blob_image_visible_area(4, area)
            _page(A, backend, 4, [(10, 10, 96, 96), (200, 90, 96, 96)],
                  txn=txn, epoch=epoch)
        trio.send(move)
        img = _held(trio, 4, img)


def _video(A, backend):
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    root = A.SpatialId.root_scroll_node(pid)
    common = A.CommonItemProperties(A.Rect(0, 0, 4096, 4096), root)
    b.push_rect(common, A.Rect(0, 0, *SIZE), A.ColorF(0.95, 0.95, 0.97, 1))
    txn = A.Transaction()
    rng = np.random.RandomState(5)
    for key, n in ((101, 64), (102, 32), (103, 32)):
        txn.add_image(key, A.ImageDescriptor(A.ImageFormat.R8, n, n),
                      A.ImageData(pixels=rng.randint(
                          16, 236, (n, n)).astype(np.uint8)))
    b.push_yuv_image(common, A.Rect(140, 40, 128, 128), [101, 102, 103],
                     "planar", A.ColorDepth.COLOR8, A.YuvColorSpace.REC709,
                     A.ColorRange.LIMITED, A.ImageRendering.AUTO)
    _, dl = b.end()
    txn.set_root_pipeline(pid)
    txn.set_display_list(A.Epoch(0), dl)
    txn.generate_frame()
    backend.send_transaction(txn)


def test_alpha_atlas_uploads_are_counted():
    """An upload into the luma plane's alpha-atlas region (as a plane
    re-uploaded in place would make) re-rasters exactly the video's tiles;
    the image equals an uncached render of the same atlases."""
    trio = Trio(SIZE)
    trio.send(_video)
    img = trio.render()
    frame = trio.port.last_frame
    (planes,) = trio.port.resources._yuvp_cache.values()
    region = planes[0][0]
    rect = (region.x, region.y, region.x + 64, region.y + 64)
    texels = np.random.RandomState(6).randint(
        16, 236, (64, 64)).astype(np.float32) / 255.0
    for backend in (trio.port, trio.flat):
        backend.renderer.apply_uploads([PendingUpload(
            ATLAS_ALPHA, region, texels)])
    got = trio.port.render()
    np.testing.assert_array_equal(got, trio.flat.render())
    assert not np.array_equal(got, img)
    want = tiles_sampling(frame, rect, alpha=True)
    assert want > 0 and trio.port.renderer.last_dirty_tiles == want


def test_no_upload_runs_no_texel_check():
    """An unchanged frame and a scrolled frame with no upload since the last
    render run no texel-epoch check; an update then runs one per cached
    grid (here the slice: this page's root pass has no tile hashes)."""
    items, _ = PLACEMENTS["slice"]
    trio = Trio(SIZE)

    def first(A, backend):
        txn = A.Transaction()
        txn.add_image(1, A.ImageDescriptor(A.ImageFormat.RGBA8, 32, 32),
                      A.ImageData(pixels=_pixels(0, 32, 32)))
        _page(A, backend, 1, items, True, txn)
    trio.send(first)
    trio.render()
    r = trio.port.renderer
    assert r.texel_checks == 0
    trio.render()
    for y in (20.0, 45.0):
        trio.send(_resource_only(
            lambda A, txn, backend: txn.set_scroll_offsets(
                5, [A.Point2D(0, y)])))
        trio.render()
        assert r.texel_checks == 0
    trio.send(_resource_only(lambda A, txn, backend: txn.update_image(
        1, A.ImageDescriptor(A.ImageFormat.RGBA8, 32, 32),
        A.ImageData(pixels=_pixels(9, 32, 32)))))
    trio.render()
    assert r.texel_checks == 1
    assert r.last_dirty_tiles == tiles_sampling(
        trio.port.last_frame, image_rect(trio.port, 1))
