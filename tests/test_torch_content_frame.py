"""The content-page path of the port against the JAX package, on the CPU.

* The small content frame (`scenes.content_scene`, 1024x512: blurred,
  inset and sharp box shadows, radial and conic gradients, dotted, dashed
  and wavy underlines, image-mask avatars and four mix-blend groups)
  through both packages' `RenderBackend`s, the JAX renderer on its Pallas
  kernel in interpret mode, with picture caching off and on: the RGBA8
  image, bitwise, except where XLA's CPU build of the interpret kernel
  rounds the LUMINOSITY group's exact-half ties the other way
  (`test_torch_content.py`); the surface atlas bitwise.  The stored golden
  (`testdata/goldens.npz`) equals a fresh JAX render.
* Caching on equals caching off, and an unchanged second frame launches
  nothing; an edit inside a mix-blend group (an offscreen surface) on the
  default path re-rasters the tiles holding a picture and equals an
  uncached render.
* Both content scenes, the 4K one included, hold only instances that
  the JAX renderer draws on its Pallas kernel (`_supported_vec`, and its
  per-tile engine split empty on every raster pass); the port's host
  checks pass on every pass of the 4K frame.
* A dispatch holding clip kind 3 is refused without `polygon_clips`; one
  with blend op 2 (`BLEND_PD_IN`) renders, since the SVG filter path was
  ported, and one holding `KIND_CLEAR` under `gl=True`, since the GL
  flavour was (equal to the Pallas kernel in interpret mode with gl).
"""
import numpy as np
import pytest
import torch

from torch_twin import hold_polygon_dispatch, jax_scene, pallas_args

from webrender_tpu_torch import scenes
from webrender_tpu_torch.ops import dense as dm
from webrender_tpu_torch.ops import tile_raster as tr
from webrender_tpu_torch.render_backend import RenderBackend

SIZE = (1024, 512)
# values of the small frame that may differ from the interpret kernel by
# one u8 step, all inside the LUMINOSITY group (XLA's contracted
# multiply-adds at exact-half ties)
LUMINOSITY_TIES = 12


def _port(caching):
    backend = scenes.content_scene(RenderBackend(SIZE, device="cpu"))
    backend.renderer.picture_caching = caching
    return backend


@pytest.fixture(scope="module")
def jax_uncached():
    """The JAX backend after rendering the small content frame uncached:
    (backend, RGBA8)."""
    backend = jax_scene(scenes.content_scene, SIZE)
    img = backend.render()
    return backend, img


def _assert_equal_but_luminosity_ties(got, want):
    diff = np.abs(got.astype(int) - want.astype(int))
    x, y, w, h = dict(scenes.CONTENT_SMALL["blends"])["LUMINOSITY"]
    inside = np.zeros(diff.shape[:2], bool)
    inside[y:y + h, x:x + w] = True
    assert diff[~inside].max() == 0
    assert diff[inside].max() <= 1
    assert int((diff > 0).sum()) <= LUMINOSITY_TIES


@pytest.mark.parametrize("caching", [False, True])
def test_content_frame_equals_jax(caching, jax_uncached):
    if caching:
        ref = jax_scene(scenes.content_scene, SIZE)
        ref.renderer.picture_caching = True
        want = ref.render()
    else:
        ref, want = jax_uncached
        np.testing.assert_array_equal(
            np.load(scenes.GOLDENS)[scenes.CONTENT_FRAME[0]], want)
    assert set(ref.renderer.engine_counts) == {"pallas"}
    port = _port(caching)
    before = tr.LaunchCounts.plain_calls
    got = port.render()
    assert tr.LaunchCounts.plain_calls - before == 5
    _assert_equal_but_luminosity_ties(got, want)
    np.testing.assert_array_equal(port.renderer.surface_atlas.numpy(),
                                  np.asarray(ref.renderer.surface_atlas))


def test_content_frame_cached_equals_uncached_then_retained():
    uncached = _port(False).render()
    port = _port(True)
    first = port.render()
    np.testing.assert_array_equal(first, uncached)
    before = tr.LaunchCounts.plain_calls
    again = port.render()
    assert tr.LaunchCounts.plain_calls == before
    assert port.renderer.last_dirty_tiles == 0
    np.testing.assert_array_equal(again, first)


def test_edit_inside_a_blend_group_on_the_default_path():
    """Picture caching on, then a frame whose only change is the rect
    inside the DIFFERENCE group (an offscreen surface composited with
    blend op 26): the port re-rasters the tiles that hold a picture, and
    the image equals an uncached render of the edited frame."""
    from webrender_tpu_torch import api as port_api
    port = _port(True)
    first = port.render()
    edited_color = (0.2, 0.5, 0.9, 1.0)
    scenes.content_scene(port, api=port_api, difference=edited_color)
    edited = port.render()
    assert 0 < port.renderer.last_dirty_tiles < 32
    fresh = scenes.content_scene(RenderBackend(SIZE, device="cpu"),
                                 difference=edited_color)
    fresh.renderer.picture_caching = False
    np.testing.assert_array_equal(edited, fresh.render())
    x, y, w, h = dict(scenes.CONTENT_SMALL["blends"])["DIFFERENCE"]
    changed = np.argwhere((edited != first).any(2))
    assert changed.size
    assert changed[:, 0].min() >= y and changed[:, 0].max() < y + h
    assert changed[:, 1].min() >= x and changed[:, 1].max() < x + w


def _raster_passes(renderer, frame):
    """The raster passes of `frame` as the JAX renderer dispatches them,
    uncached (root passes merged) and cached."""
    merged = renderer._merged_root_passes(frame)
    return [p for p in list(frame.passes) + list(merged)
            if p.tile_insts is not None]


@pytest.mark.parametrize("name", ["content", "content_4k"])
def test_content_scenes_run_on_the_pallas_kernel(name, jax_uncached):
    """Every instance has a path in the TPU kernel and no raster pass
    splits tiles off to the XLA engine; the port's host checks pass and
    its dispatch sets are JAX's."""
    from webrender_tpu.ops.pallas import tile_raster as jt
    if name == "content":
        backend, _ = jax_uncached
        frame = backend.build_frame()
    else:
        backend = jax_scene(scenes.build_4k_content_scene, (3840, 2160))
        frame = backend.build_frame()
    ok = jt._supported_vec(frame.instances, frame.transforms, frame.f32_buf)
    assert ok.all()
    arrays = [torch.from_numpy(a) for a in
              (frame.f32_buf, frame.instances, frame.transforms)]
    dk = jt.classify_dense_kinds(frame.f32_buf, frame.instances,
                                 frame.transforms)
    roots = []
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
        roots.append(info)
    # the content root pass: the content kinds, mix blends and mask clips
    kinds, blends, mask_clips = roots[-1]
    assert {3, 4, 6, 8, 10, 11, 13} <= set(kinds)
    assert {17, 18, 26, 31} <= set(blends) and mask_clips
    assert tr.instantiation(kinds, blends, mask_clips) == "content"


# blend op 2 was refused until the SVG filter path was ported, a polygon
# clip until polygon clips were, a clear rect under gl=True until the GL
# flavour was: they render (a polygon clip with `polygon_clips` only)
REFUSED = ("kind-clear", "clip-kind-3", "blend-op-2")


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_branches_are_refused(case):
    """The small content frame's root dispatch with its solid records
    changed to `KIND_CLEAR` and drawn by the llvmpipe compose (`gl=True`)
    renders on the gl instantiation, equal to the Pallas kernel in
    interpret mode with gl; with one clip record changed to a polygon the
    wrapper raises without `polygon_clips`, naming it, before any work.
    The solid records' blend changed to `BLEND_PD_IN` renders."""
    backend = _port(False)
    inp = scenes.kernel_inputs(backend)
    dense, rows = inp["dense"].clone(), inp["f32_rows"].clone()
    kinds, blends = inp["kinds"], inp["blends"]
    valid = torch.arange(dense.shape[1])[None, :] < inp["counts"][:, None]
    if case == "kind-clear":
        solid = valid & (dense[..., 64] == 0)
        dense[..., 64][solid] = 7.0
        dense[..., 65][solid] = 1.0
        kinds = tuple(sorted(set(kinds) | {7}))
        blends = tuple(sorted(set(blends) | {1}))
        inp = dict(inp, dense=dense)
        before = tr.LaunchCounts.plain_calls
        out = tr.render_tiles_dense(
            dense, inp["counts"], inp["origins"], inp["clear"], rows,
            inp["alpha_atlas"], inp["surface_atlas"], inp["color_atlas"],
            kinds=kinds, blends=blends, mask_clips=inp["mask_clips"],
            gl=True)
        assert tr.LaunchCounts.plain_calls == before + 1
        assert tr.instantiation(kinds, blends, inp["mask_clips"],
                                gl=True) == "gl"
        import jax.numpy as jnp
        from webrender_tpu.ops.pallas import tile_raster as jt
        a = {k: jnp.asarray(v) for k, v in pallas_args(inp).items()}
        want = np.asarray(jt.render_tiles_pallas_dense(
            a["dense"], a["counts"], a["origins"], a["clear"],
            a["f32_rows"], a["alpha_atlas"], a["surface_atlas"],
            a["color_atlas"], kinds=kinds, blends=blends,
            mask_clips=inp["mask_clips"], interpret=True, gl=True))
        assert np.abs(out.numpy() - want).max() == 0.0
        return
    if case == "clip-kind-3":
        hold_polygon_dispatch(inp, kinds, blends)
        return
    # ported since: the record now draws, on the filter instantiation
    dense[..., 65][valid & (dense[..., 64] == 0)] = 2.0
    blends = tuple(sorted(set(blends) | {2}))
    assert tr.instantiation(kinds, blends, inp["mask_clips"]) == "filter"
    before = tr.LaunchCounts.plain_calls
    out = tr.render_tiles_dense(
        dense, inp["counts"], inp["origins"], inp["clear"], rows,
        inp["alpha_atlas"], inp["surface_atlas"], inp["color_atlas"],
        kinds=kinds, blends=blends, mask_clips=inp["mask_clips"])
    assert tr.LaunchCounts.plain_calls == before + 1
    assert torch.isfinite(out).all()
