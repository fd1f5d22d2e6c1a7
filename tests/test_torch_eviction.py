"""Twins of tests/test_eviction.py (texture-cache eviction and the atlas
OOM recoveries) on the port, on the CPU.

* The allocator and resource-cache cases (`ShelfAllocator`, `FrameAtlas`,
  `ResourceCache`: free and reuse, exhaustion, eviction of stale glyphs
  and images, deletion, generations, the crop cache) are cases of one
  test: each runs the JAX test's steps on both packages' copies and
  records what they answer (regions, counts, refusals); the records are
  equal, and the JAX test's assertions hold on the port's.
* The renderer cases: 80 blurred surfaces (region aliasing keeps them in
  the frame atlas) and the surface-atlas OOM ladder (a tiny cap recovers
  by emergency aliasing and growth) render on the port's default path
  (picture caching on, the kernel's plain version), bitwise equal to the
  JAX package's `render_software`, to the port's uncached render and to
  its `render_software` with float32 `where`s (`torch_twin.Trio`); the
  port's device surface atlas grows to the frame's `surface_rows`.
"""
import numpy as np
import pytest

from torch_twin import Trio


def _regions(regions):
    return [None if r is None else (r.x, r.y, r.w, r.h) for r in regions]


def _overlaps(a, b):
    return not (a[0] + a[2] <= b[0] or b[0] + b[2] <= a[0] or
                a[1] + a[3] <= b[1] or b[1] + b[3] <= a[1])


def shelf_free_and_reuse(pkg):
    atlas = _mod(pkg, "resources.atlas")
    al = atlas.ShelfAllocator(256, 64, align=8)
    regions = [al.alloc(32, 16) for _ in range(8)]
    assert all(r is not None for r in regions)
    al.free(regions[2])
    al.free(regions[3])
    r = al.alloc(32, 16)
    assert r.y == regions[2].y and r.x in (regions[2].x, regions[3].x)
    for reg in [regions[i] for i in range(8) if i not in (2, 3)] + [r]:
        al.free(reg)
    assert al.next_y == 0 or all(s.live == 0 for s in al.shelves)
    return _regions(regions + [r]), al.next_y


def shelf_exhaustion(pkg):
    atlas = _mod(pkg, "resources.atlas")
    al = atlas.ShelfAllocator(64, 32, align=8)
    got = []
    while True:
        r = al.alloc(32, 16)
        if r is None:
            break
        got.append(r)
    assert len(got) == 4
    al.free(got[0])
    again = al.alloc(32, 16)
    assert again is not None
    return _regions(got + [again])


def glyph_eviction(pkg):
    rc_mod = _mod(pkg, "resources.resource_cache")
    font = _mod(pkg, "api.font")
    import matplotlib
    rc = rc_mod.ResourceCache(alpha_atlas_size=(128, 128))
    fk = font.FontKey(0, 1)
    rc.add_font(fk, path=matplotlib.get_data_path() +
                "/fonts/ttf/DejaVuSans.ttf")
    rc.add_font_instance(font.FontInstanceKey(0, 1), fk, 20.0,
                         font.FontInstanceOptions())
    face = rc.fonts.faces[(0, 1)]
    gids = [face.get_char_index(ord(c))
            for c in "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"]
    rc.begin_frame()
    rc.request_glyphs(1, gids[:20])
    rc.begin_frame()
    out = rc.request_glyphs(1, gids[20:])
    regions = _regions([g.region for g in out.values()
                        if g.region is not None])
    assert regions
    for i in range(len(regions)):
        for j in range(i + 1, len(regions)):
            assert not _overlaps(regions[i], regions[j]), (i, j)
    return sorted(out), regions


def image_oom_clear_and_retry(pkg):
    rc_mod = _mod(pkg, "resources.resource_cache")
    A = _mod(pkg, "api")
    rc = rc_mod.ResourceCache(color_atlas_size=(128, 128))
    px = np.zeros((100, 100, 4), np.uint8)
    for key in range(4):
        rc.add_image_template(
            key, A.ImageDescriptor(A.ImageFormat.RGBA8, 100, 100),
            A.ImageData(pixels=px))
    rc.begin_frame()
    got = [rc.request_image(0)[0]]
    rc.begin_frame()
    got.append(rc.request_image(1)[0])
    rc.begin_frame()
    got.append(rc.request_image(2)[0])
    atlas = _mod(pkg, "resources.atlas")
    with pytest.raises(atlas.AtlasFullError):
        rc.request_image(3)
    return _regions(got)


def delete_frees_region(pkg):
    rc_mod = _mod(pkg, "resources.resource_cache")
    A = _mod(pkg, "api")
    rc = rc_mod.ResourceCache(color_atlas_size=(256, 256))
    px = np.zeros((64, 64, 4), np.uint8)
    rc.add_image_template(7, A.ImageDescriptor(A.ImageFormat.RGBA8, 64, 64),
                          A.ImageData(pixels=px))
    rc.begin_frame()
    r1, _ = rc.request_image(7)
    rc.delete_image_template(7)
    rc.add_image_template(8, A.ImageDescriptor(A.ImageFormat.RGBA8, 64, 64),
                          A.ImageData(pixels=px))
    r2, _ = rc.request_image(8)
    assert (r2.x, r2.y) == (r1.x, r1.y)
    return _regions([r1, r2])


def readd_bumps_generation(pkg):
    rc_mod = _mod(pkg, "resources.resource_cache")
    A = _mod(pkg, "api")
    rc = rc_mod.ResourceCache()
    px = np.zeros((16, 16, 4), np.uint8)
    desc = A.ImageDescriptor(A.ImageFormat.RGBA8, 16, 16)
    rc.add_image_template(3, desc, A.ImageData(pixels=px))
    g1 = rc.images[3].generation
    rc.delete_image_template(3)
    rc.add_image_template(3, desc, A.ImageData(pixels=px))
    assert rc.images[3].generation > g1
    return g1, rc.images[3].generation


def frame_atlas_grows(pkg):
    atlas = _mod(pkg, "resources.atlas")
    fa = atlas.FrameAtlas(512, 256)
    regions = [fa.alloc(512, 128) for _ in range(4)]
    assert fa.used_height == 512
    assert all(r is not None for r in regions)
    grown = []
    with pytest.raises(atlas.AtlasFullError):
        while True:
            grown.append(fa.alloc(512, 512))
    return _regions(regions + grown), fa.used_height


def crop_cache_bounded(pkg):
    rc_mod = _mod(pkg, "resources.resource_cache")
    A = _mod(pkg, "api")
    rc = rc_mod.ResourceCache(color_atlas_size=(2048, 2048))
    w = h = 4000
    rc.add_image_template(1, A.ImageDescriptor(A.ImageFormat.RGBA8, w, h),
                          A.ImageData(pixels=np.zeros((h, w, 4), np.uint8)))
    got = []
    for frame in range(12):
        rc.begin_frame()
        y = frame * 300
        sub = rc.request_image_sub(1, (0, y, 600, y + 400))
        assert sub is not None
        got.append(repr(sub))
    mine = sorted(k for k in rc._crop_cache if k[0] == 1)
    assert len(mine) <= 5
    return got, [repr(k) for k in mine]


def frame_atlas_aliasing(pkg):
    atlas = _mod(pkg, "resources.atlas")
    fa = atlas.FrameAtlas(2048, 2048)
    a = fa.alloc(512, 512)
    b = fa.alloc(512, 512)
    fa.free(a)
    c = fa.alloc(512, 512)
    assert (c.x, c.y) == (a.x, a.y)
    fa.free(c)
    fa.free(c)
    d = fa.alloc(500, 500)
    assert (d.x, d.y) == (a.x, a.y)
    return _regions([a, b, c, d])


def _mod(pkg, name):
    import importlib
    return importlib.import_module(f"{pkg}.{name}")


# the JAX test each case twins: its steps on either package
CASES = {"test_shelf_allocator_free_and_reuse": shelf_free_and_reuse,
         "test_shelf_allocator_exhaustion_returns_none": shelf_exhaustion,
         "test_glyph_eviction_keeps_current_frame_regions_valid":
             glyph_eviction,
         "test_image_oom_clear_and_retry": image_oom_clear_and_retry,
         "test_delete_image_frees_region_and_derived_caches":
             delete_frees_region,
         "test_readd_image_bumps_generation": readd_bumps_generation,
         "test_frame_atlas_grows_past_soft_height": frame_atlas_grows,
         "test_crop_cache_bounded_per_key": crop_cache_bounded,
         "test_frame_atlas_aliasing_reuses_released_regions":
             frame_atlas_aliasing}


@pytest.mark.parametrize("case", sorted(CASES))
def test_allocator_and_cache_cases(case):
    """One JAX test's steps on both packages: what each answers is equal
    (and its assertions hold on both)."""
    want = CASES[case]("webrender_tpu")
    got = CASES[case]("webrender_tpu_torch")
    assert got == want


def _blurred(n, size, nested=False, cap=None):
    """The JAX tests' scenes: `n` blurred rects side by side, or
    (`nested`) a rect under `n` nested blurs; `cap`: the frame builder's
    surface-atlas cap."""
    def flow(A, backend):
        if cap is not None:
            backend.frame_builder.surface_max_height = cap
        pid = A.PipelineId(0, 1)
        b = A.DisplayListBuilder(pid)
        b.begin()
        root = A.SpatialId.root_scroll_node(pid)
        common = A.CommonItemProperties(A.Rect(0, 0, *size), root)
        if nested:
            for _ in range(n):
                b.push_stacking_context(A.Point2D(0, 0), root,
                                        filters=[A.FilterOp.blur(2.0, 2.0)])
            b.push_rect(common, A.Rect(20, 20, 280, 200),
                        A.ColorF(0.8, 0.3, 0.1, 1.0))
            for _ in range(n):
                b.pop_stacking_context()
        else:
            for i in range(n):
                b.push_stacking_context(A.Point2D(0, 0), root,
                                        filters=[A.FilterOp.blur(3.0, 3.0)])
                b.push_rect(common, A.Rect(10 + (i % 8) * 70,
                                           10 + (i // 8) * 40, 600, 400),
                            A.ColorF(0.2, 0.5, 0.8, 0.5))
                b.pop_stacking_context()
        _, dl = b.end()
        txn = A.Transaction()
        txn.set_root_pipeline(pid)
        txn.set_display_list(A.Epoch(0), dl)
        txn.generate_frame()
        backend.send_transaction(txn)
    return flow


def test_many_blurred_surfaces_stay_within_atlas():
    """80 blurred ~600x400 surfaces: the port's frame equals JAX's in its
    passes and surface rows, its device surface atlas holds them, and the
    image is JAX's."""
    trio = Trio((640, 480))
    trio.send(_blurred(80, (640, 480)))
    want = trio.jax.build_frame()
    got = trio.port.build_frame()
    assert got.surface_rows == want.surface_rows
    assert len(got.passes) == len(want.passes)
    img = trio.render()
    assert img.shape == (480, 640, 4)
    r = trio.port.renderer
    assert r.surface_atlas.shape[1] >= got.surface_rows


def test_surface_atlas_oom_recovery_ladder():
    """A cap of 96 rows takes the ladder (emergency aliasing, then growth)
    on both packages with equal recovery counts; the recovered frame
    renders equal to one built with an ample cap, on the port's default
    path and against JAX."""
    ref = Trio((320, 240))
    ref.send(_blurred(6, (320, 240), nested=True))
    small = Trio((320, 240))
    small.send(_blurred(6, (320, 240), nested=True, cap=96))
    for trio in (ref, small):
        for backend in trio.backends:
            assert backend.build_frame() is not None
    want = small.jax.profiler.get("surface_atlas_recoveries")
    assert want and want > 0
    for backend in small.backends[1:]:
        assert backend.profiler.get("surface_atlas_recoveries") == want
        assert backend.frame_builder.surface_max_height == \
            small.jax.frame_builder.surface_max_height
    assert ref.port.profiler.get("surface_atlas_recoveries") is None
    img_ref = ref.render()
    img_small = small.render()
    assert np.array_equal(img_ref, img_small)
    assert small.port.renderer.surface_atlas.shape[1] >= \
        small.port.last_frame.surface_rows

