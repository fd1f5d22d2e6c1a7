"""The zoomed page with video of the port against the JAX package, on the
CPU.

* The small zoomed frame (`scenes.zoomed_scene`, 1024x512 device pixels:
  a few items of the browsing page under a page zoom, a planar video,
  three clear rects, a toast and chips in `opacity(0.6)` groups) at zoom
  1.25, 2.0 and 0.8 through both packages' `RenderBackend`s, the JAX
  renderer on its Pallas kernel in interpret mode, picture caching off
  and on: the RGBA8 image bitwise, except inside the video, where XLA's
  CPU build of the interpret kernel may contract the color-space matrix's
  three-product sums and turn an exact-half tie (`VIDEO_TIES` values of
  one step; measured: 0 at the three zooms with these planes, 2 at zoom
  2.0 with an earlier, noisier video); the surface atlas bitwise.  The stored goldens (`testdata/goldens.npz`) equal a
  fresh JAX render.
* Caching on equals caching off, and an unchanged second frame launches
  nothing.
* A video tick (`update_image` of the three planes) with caching on: the
  image equals the port's uncached render of the same state and the JAX
  package's, and exactly JAX's count of tiles is re-rastered.
* The toast's and chips' surface passes run scaled grayscale text
  (`K_SEP_GLYPH`), the root pass scaled subpixel text, the video and the
  clear rects, on the kernel's media instantiation.
* The zoomed scenes, the 4K ones included, hold only instances that the
  JAX renderer draws on its Pallas kernel at the three zooms.
* A dispatch with blend op 2 or color-matrix flag 2 renders, since the
  SVG filter path was ported; one with clip kind 3 since polygon clips
  were; one with `KIND_BORDER` records since the border was, equal to
  the Pallas kernel in interpret mode.
"""
import numpy as np
import pytest
import torch

import webrender_tpu.api as jax_api
from torch_twin import (hold_border_dispatch, hold_polygon_dispatch,
                        jax_scene, jax_zoomed_backend)

from webrender_tpu_torch import scenes
from webrender_tpu_torch.ops import dense as dm
from webrender_tpu_torch.ops import tile_raster as tr
from webrender_tpu_torch.render_backend import RenderBackend

SIZE = scenes.ZOOMED_SIZE
ZOOMED = dict(scenes.ZOOMED_FRAMES)
VIDEO_SIZE = scenes.MEDIA_SMALL["video_size"]
# values inside the video that may differ from the interpret kernel by one
# u8 step (the contracted color-space matrix at exact-half ties)
VIDEO_TIES = 8


def _port(zoom, caching):
    backend = scenes.zoomed_scene(RenderBackend(SIZE, device="cpu"), zoom)
    backend.renderer.picture_caching = caching
    return backend


def _assert_equal_but_video_ties(got, want, zoom):
    diff = np.abs(got.astype(int) - want.astype(int))
    x, y, w, h = (v * zoom for v in scenes.MEDIA_SMALL["video"])
    inside = np.zeros(diff.shape[:2], bool)
    inside[int(y):int(y + h) + 1, int(x):int(x + w) + 1] = True
    assert diff[~inside].max() == 0
    assert diff[inside].max() <= 1
    assert int((diff > 0).sum()) <= VIDEO_TIES


@pytest.fixture(scope="module")
def jax_uncached():
    """{zoom: (backend, RGBA8)} of the JAX backends after rendering the
    small zoomed frame uncached."""
    out = {}
    for zoom in scenes.ZOOMS:
        backend = jax_zoomed_backend(zoom)
        out[zoom] = (backend, backend.render())
    return out


@pytest.mark.parametrize("caching", [False, True])
@pytest.mark.parametrize("name", sorted(ZOOMED))
def test_zoomed_frame_equals_jax(name, caching, jax_uncached):
    zoom = ZOOMED[name]
    if caching:
        ref = jax_zoomed_backend(zoom, caching=True)
        want = ref.render()
    else:
        ref, want = jax_uncached[zoom]
        np.testing.assert_array_equal(np.load(scenes.GOLDENS)[name], want)
    assert set(ref.renderer.engine_counts) == {"pallas"}
    port = _port(zoom, caching)
    port.renderer.dispatch_log = log = []
    before = tr.LaunchCounts.plain_calls
    got = port.render()
    # three surface rasters (the toast and two chips), the root passes
    assert tr.LaunchCounts.plain_calls - before == len(log) >= 4
    _assert_equal_but_video_ties(got, want, zoom)
    np.testing.assert_array_equal(port.renderer.surface_atlas.numpy(),
                                  np.asarray(ref.renderer.surface_atlas))
    # scaled grayscale text on the surfaces; scaled subpixel text, the
    # video and the clear rects on the root
    surfaces = [e for e in log if 14 in e["kinds"]]
    assert len(surfaces) == 3
    seen = set().union(*(e["kinds"] for e in log))
    assert {7, 14, 16, 17} <= seen
    assert 1 in set().union(*(e["blends"] for e in log))
    for e in log:
        want_build = "media" if set(e["kinds"]) & {7, 14, 16, 17} else None
        got_build = tr.instantiation(e["kinds"], e["blends"],
                                     e["mask_clips"])
        assert want_build in (None, got_build)


@pytest.mark.parametrize("name", sorted(ZOOMED))
def test_zoomed_frame_cached_equals_uncached_then_retained(name):
    zoom = ZOOMED[name]
    uncached = _port(zoom, False).render()
    port = _port(zoom, True)
    first = port.render()
    np.testing.assert_array_equal(first, uncached)
    before = tr.LaunchCounts.plain_calls
    again = port.render()
    assert tr.LaunchCounts.plain_calls == before
    assert port.renderer.last_dirty_tiles == 0
    np.testing.assert_array_equal(again, first)


@pytest.mark.parametrize("name", sorted(ZOOMED))
def test_video_tick_on_the_default_path(name):
    """Picture caching on, then a frame whose only change is the video's
    three planes: the port re-rasters exactly the tiles JAX re-rasters,
    and the image equals its own uncached render of the same state and
    JAX's."""
    zoom = ZOOMED[name]
    ref = jax_zoomed_backend(zoom, caching=True)
    ref.render()
    scenes.video_tick(ref, 1, VIDEO_SIZE, api=jax_api)
    want = ref.render()
    assert set(ref.renderer.engine_counts) == {"pallas"}
    port = _port(zoom, True)
    first = port.render()
    scenes.video_tick(port, 1, VIDEO_SIZE)
    got = port.render()
    assert 0 < port.renderer.last_dirty_tiles < 64
    assert port.renderer.last_dirty_tiles == ref.renderer.last_dirty_tiles
    fresh = scenes.video_tick(_port(zoom, False), 1, VIDEO_SIZE)
    np.testing.assert_array_equal(got, fresh.render())
    _assert_equal_but_video_ties(got, want, zoom)
    # only the video changed
    x, y, w, h = (v * zoom for v in scenes.MEDIA_SMALL["video"])
    changed = np.argwhere((got != first).any(2))
    assert changed.size
    assert changed[:, 0].min() >= int(y) and changed[:, 0].max() <= y + h
    assert changed[:, 1].min() >= int(x) and changed[:, 1].max() <= x + w
    # the same planes again: a new frame that changes no pixel
    scenes.video_tick(port, 1, VIDEO_SIZE)
    np.testing.assert_array_equal(port.render(), got)


def _raster_passes(renderer, frame):
    """The raster passes of `frame` as the JAX renderer dispatches them,
    uncached (root passes merged) and cached."""
    merged = renderer._merged_root_passes(frame)
    return [p for p in list(frame.passes) + list(merged)
            if p.tile_insts is not None]


GUARD = [(f"{name}{suffix}", zoom) for name, zoom in scenes.ZOOMED_FRAMES
         for suffix in ("", "_4k")]


@pytest.mark.parametrize("name,zoom", GUARD, ids=[g[0] for g in GUARD])
def test_zoomed_scenes_run_on_the_pallas_kernel(name, zoom):
    """Every instance has a path in the TPU kernel and no raster pass
    splits tiles off to the XLA engine (which the port does not have); the
    port's host checks pass and its dispatch sets are JAX's."""
    from webrender_tpu.ops.pallas import tile_raster as jt
    if name.endswith("_4k"):
        backend = jax_scene(scenes.build_4k_zoomed_scene, (3840, 2160),
                            3840, 2160, zoom)
    else:
        backend = jax_zoomed_backend(zoom)
    frame = backend.build_frame()
    ok = jt._supported_vec(frame.instances, frame.transforms, frame.f32_buf)
    assert ok.all()
    arrays = [torch.from_numpy(a) for a in
              (frame.f32_buf, frame.instances, frame.transforms)]
    dk = jt.classify_dense_kinds(frame.f32_buf, frame.instances,
                                 frame.transforms)
    infos = []
    for p in _raster_passes(backend.renderer, frame):
        assert jt.pallas_supported_mask(frame.instances, p.tile_insts,
                                        frame.transforms, frame.f32_buf,
                                        inst_ok=ok).all()
        ti = torch.from_numpy(p.tile_insts)
        assert not dm.general_tiles(ti, torch.from_numpy(ok)).any()
        dm.check_pass_records(arrays[0], arrays[1], ti)
        info = dm.dense_dispatch_info(arrays[0], arrays[1], ti,
                                      torch.from_numpy(dk),
                                      torch.from_numpy(ok))
        assert not info[3]
        info = info[:3]
        assert info == tuple(
            tuple(v) if isinstance(v, tuple) else v for v in
            jt.dense_dispatch_info(frame.f32_buf, frame.instances,
                                   p.tile_insts, dk))
        tr._check_supported(info[0], info[1])
        infos.append(info)
    kinds, blends, mask_clips = infos[-1]   # the merged root pass
    assert {0, 2, 6, 7, 13, 16, 17} <= set(kinds)
    assert set(blends) == {0, 1, 7, 8} and not mask_clips
    assert tr.instantiation(kinds, blends, mask_clips) == "media"
    assert any(14 in k for k, _, _ in infos[:-1])
    if name.endswith("_4k"):
        # the browsing page's counts under the zoom, and the media groups
        kind = frame.instances[:, 0]
        assert (kind == 12).sum() == 1 and (kind == 7).sum() == 3
        assert (kind == 2).sum() == 100 and (kind == 6).sum() == 5


# blend op 2 and color-matrix flag 2 were refused until the SVG filter
# path was ported, a polygon clip until polygon clips were, KIND_BORDER
# until the border was: they render
NOW_RENDERED = ("blend-op-2", "clip-kind-3", "color-matrix-flag-2",
                "kind-border")


@pytest.mark.parametrize("case", NOW_RENDERED)
def test_unported_branches_are_still_refused(case):
    """The small zoomed frame's root dispatch with the solid records'
    blend changed to `BLEND_PD_IN`, or the picture records' color matrix
    to linearRGB: it renders on the filter instantiation; with one clip
    record changed to a polygon, on the general one, and with solid
    records changed to `KIND_BORDER` (refused until the border was
    ported), on the border one, equal to the Pallas kernel
    (`torch_twin.hold_polygon_dispatch`, `hold_border_dispatch`)."""
    backend = _port(1.25, False)
    backend.render()    # the surfaces, so that the root's inputs are whole
    inp = scenes.kernel_inputs(backend)
    dense, rows = inp["dense"].clone(), inp["f32_rows"].clone()
    kinds, blends = inp["kinds"], inp["blends"]
    valid = torch.arange(dense.shape[1])[None, :] < inp["counts"][:, None]
    if case == "blend-op-2":
        dense[..., 65][valid & (dense[..., 64] == 0)] = 2.0
        blends = tuple(sorted(set(blends) | {2}))
    elif case == "clip-kind-3":
        hold_polygon_dispatch(inp, kinds, blends)
        return
    elif case == "color-matrix-flag-2":
        pic = valid & (dense[..., 64] == 6)
        assert bool(pic.any())
        dense[..., 36][pic] = 2.0
    else:
        hold_border_dispatch(inp, kinds, blends, inp["mask_clips"])
        return
    before = tr.LaunchCounts.plain_calls
    args = (dense, inp["counts"], inp["origins"], inp["clear"], rows,
            inp["alpha_atlas"], inp["surface_atlas"], inp["color_atlas"])
    linear_cm = case == "color-matrix-flag-2"
    assert tr.instantiation(kinds, blends, inp["mask_clips"],
                            linear_cm=linear_cm) == "filter"
    out = tr.render_tiles_dense(*args, kinds=kinds, blends=blends,
                                mask_clips=inp["mask_clips"],
                                linear_cm=linear_cm)
    assert torch.isfinite(out).all()
    assert tr.LaunchCounts.plain_calls == before + 1


def _image_in_a_group(backend, seed):
    """A 256x128 page: a background, and an image inside an `opacity(0.6)`
    group (an offscreen surface); `seed` makes the image's pixels."""
    from webrender_tpu_torch import api as A
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    root = A.SpatialId.root_scroll_node(pid)
    common = A.CommonItemProperties(A.Rect(0, 0, 256, 128), root)
    b.push_rect(common, A.Rect(0, 0, 256, 128), A.ColorF(1, 1, 1, 1))
    b.push_stacking_context(A.Point2D(0, 0), root,
                            filters=[A.FilterOp.opacity(0.6)])
    b.push_image(common, A.Rect(150, 20, 64, 64), A.ImageRendering.AUTO,
                 A.AlphaType.PREMULTIPLIED_ALPHA, 7)
    b.pop_stacking_context()
    _, dl = b.end()
    txn = A.Transaction()
    txn.add_image(7, _image_descriptor(A), _image_data(A, seed))
    txn.set_root_pipeline(pid)
    txn.set_display_list(A.Epoch(0), dl)
    txn.generate_frame()
    backend.send_transaction(txn)
    return backend


def _image_descriptor(A):
    return A.ImageDescriptor(A.ImageFormat.RGBA8, 64, 64,
                             flags=A.ImageDescriptorFlags.IS_OPAQUE)


def _image_data(A, seed):
    px = (np.random.RandomState(seed).rand(64, 64, 4) * 255).astype(np.uint8)
    px[..., 3] = 255
    return A.ImageData(pixels=px)


def test_image_update_inside_a_surface_re_rasters_its_pictures():
    """The surface signature follows the texels the offscreen passes
    sample: `update_image` of an image inside an opacity group leaves the
    root tile hashes equal, and the port still re-rasters the tiles that
    hold the group's picture; an upload elsewhere in the atlas does not."""
    from webrender_tpu_torch import api as A
    port = _image_in_a_group(RenderBackend((256, 128), device="cpu"), 1)
    assert port.renderer.picture_caching
    first = port.render()
    txn = A.Transaction()
    txn.update_image(7, _image_descriptor(A), _image_data(A, 2))
    txn.generate_frame()
    port.send_transaction(txn)
    got = port.render()
    assert port.renderer.last_dirty_tiles > 0
    fresh = _image_in_a_group(RenderBackend((256, 128), device="cpu"), 2)
    fresh.renderer.picture_caching = False
    np.testing.assert_array_equal(got, fresh.render())
    assert (got != first).any()
    # an image nothing draws, uploaded beside it: no picture tile is dirty
    txn = A.Transaction()
    txn.add_image(8, _image_descriptor(A), _image_data(A, 3))
    txn.generate_frame()
    port.send_transaction(txn)
    sig = port.renderer._surface_sig
    np.testing.assert_array_equal(port.render(), got)
    assert port.renderer._surface_sig == sig
