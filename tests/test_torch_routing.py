"""The port's routing against the JAX package's engine split.

`ops/dense.py::pallas_supported` is the port of `_supported_vec`
(`webrender_tpu/ops/pallas/tile_raster.py:197`) and `general_tiles` the
complement of `pallas_supported_mask` (`:301`).  Where the JAX renderer
sends a tile to its XLA engine, the port's dense records carry the general
kinds and flag, per (tile, slot).

* On instance arrays made by hypothesis (the frames of
  `tests/test_support_mask.py`) and on the small transformed frame, the
  flags and the tile mask equal JAX's, instance for instance.
* The per-(tile, slot) kinds: the same instance has its TPU-kernel kind
  in a supported tile and its general kind in a general one; arithmetic
  kinds keep theirs; empty slots stay -1.
* What is still refused raises `NotImplementedError` naming itself, from
  the wrapper: blends outside the ported set.  What was refused until the
  SVG filter path was ported (color-matrix flag 2, the float-domain blend
  ops 2 and 41) renders through the filter instantiation, a polygon clip
  (clip kind 3) through the general one, equal to the numpy oracle, a
  frame with `gl_flavor` (`gl=True`, refused until the GL flavour was
  ported) through the gl one, and `KIND_BORDER` (refused by the first host
  check until it was ported) through the border one, equal to the numpy
  oracle.
* `util.options.apply_options` against the port's renderer.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_support_mask import _random_frame
from torch_twin import (border_payload, jax_scene, polygon_clip,
                        polygon_inside)
from webrender_tpu.oracle.sw import SoftwareRenderer
from webrender_tpu.ops.pallas import tile_raster as jt

from webrender_tpu_torch import scenes
from webrender_tpu_torch.ops import dense as dm
from webrender_tpu_torch.ops import tile_raster as tr
from webrender_tpu_torch.render_backend import RenderBackend


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n_inst=st.integers(1, 96),
       nt=st.integers(1, 9), slots=st.integers(1, 8))
def test_support_flags_and_tile_mask_equal_jax(seed, n_inst, nt, slots):
    rng = np.random.RandomState(seed)
    f32, transforms, inst = _random_frame(rng, n_inst=n_inst)
    # plausible payloads for the span tests: some 1:1, some wide, some long
    for rec in inst:
        a = rec[2]
        if rng.rand() < 0.5:
            f32[a:a + 4] = (0, 0, 40, 30)
            f32[a + 8:a + 12] = rng.choice([40.0, 300.0]), 0, 0, 0
            f32[a + 8:a + 12] = (0, 0, f32[a + 8], 30)
            f32[a + 14] = rng.choice([3.0, 16.0, 17.0, 24.0])
            f32[a + 18:a + 24] = (40, 30, 0, 0, 1, 1)
            f32[a + 37] = rng.choice([0.0, 1.0])
    want = jt._supported_vec(inst, transforms, f32)
    got = dm.pallas_supported(*_torch(f32, inst, transforms))
    np.testing.assert_array_equal(got.numpy(), want)
    tiles = rng.randint(-1, n_inst, (nt, slots)).astype(np.int32)
    mask = jt.pallas_supported_mask(inst, tiles, transforms, f32)
    general = dm.general_tiles(torch.from_numpy(tiles), got)
    np.testing.assert_array_equal(general.numpy(), ~mask)
    # the per-(tile, slot) kinds
    f, i, x = _torch(f32, inst, transforms)
    dk = dm.classify_dense_kinds(f, i, x)
    aligned = np.zeros(len(f32) + 128 - len(f32) % 128, np.float32)
    aligned[:len(f32)] = f32
    i2 = i.clone()
    i2[:, 2] = i2[:, 2] // 128 * 128
    dense = dm.build_dense_records(torch.from_numpy(aligned), i2, x,
                                   torch.from_numpy(tiles), dk, got)
    kind = dense[..., dm.REC_KIND].numpy()
    raw = inst[np.maximum(tiles, 0), 0]
    lut = dict(dm._GENERAL_MAP)
    for t in range(nt):
        for s in range(slots):
            if tiles[t, s] < 0:
                assert kind[t, s] == -1 and dense[t, s, dm.REC_GENERAL] == 0
            elif general[t] and int(raw[t, s]) in lut:
                assert kind[t, s] == lut[int(raw[t, s])]
            else:
                assert kind[t, s] == int(dk[tiles[t, s]])
    flag = dense[..., dm.REC_GENERAL].numpy()
    np.testing.assert_array_equal(flag > 0.5,
                                  general.numpy()[:, None] & (tiles >= 0))


@pytest.fixture(scope="module")
def frame():
    return scenes.transformed_scene(
        RenderBackend((1024, 512), device="cpu")).build_frame()


def test_transformed_frame_flags_equal_jax(frame):
    want = jt._supported_vec(frame.instances, frame.transforms,
                             frame.f32_buf)
    got = dm.pallas_supported(*_torch(frame.f32_buf, frame.instances,
                                      frame.transforms)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (~got).sum() < got.size
    for p in frame.passes:
        mask = jt.pallas_supported_mask(frame.instances, p.tile_insts,
                                        frame.transforms, frame.f32_buf)
        general = dm.general_tiles(torch.from_numpy(p.tile_insts),
                                   torch.from_numpy(got))
        np.testing.assert_array_equal(general.numpy(), ~mask)


def test_an_instance_has_both_kinds_across_tiles(frame):
    """The root pass of the small transformed frame: a supported glyph of
    the `plain` column is on the translation fast path (kind 10) there;
    the note's glyphs beside the first card are general (kind 20) where
    they share a tile with it.  Solids, gradients keep their kinds in both
    kinds of tile, and the dispatch sets list every kind per routing."""
    from webrender_tpu_torch.renderer.renderer import merged_root_passes
    f32, inst, xf = _torch(frame.f32_buf, frame.instances, frame.transforms)
    ok = dm.pallas_supported(f32, inst, xf)
    dk = dm.classify_dense_kinds(f32, inst, xf)
    root = merged_root_passes(frame)[-1]
    ti = torch.from_numpy(root.tile_insts)
    general = dm.general_tiles(ti, ok)
    dense = dm.build_dense_records(f32, inst, xf, ti, dk, ok)
    kind = dense[..., dm.REC_KIND]
    valid = ti >= 0
    # supported subpixel glyphs: kind 10 outside, 20 inside general tiles
    glyph = valid & (inst[ti.clamp(min=0).long(), 0] == 10) & \
        ok[ti.clamp(min=0).long()]
    assert set(kind[glyph & ~general[:, None]].tolist()) == {10.0}
    assert set(kind[glyph & general[:, None]].tolist()) == {20.0}
    # images: K_SEP_IMAGE in a supported tile, the general image elsewhere
    image = valid & (inst[ti.clamp(min=0).long(), 0] == 1)
    assert set(kind[image & ~general[:, None]].tolist()) == {13.0}
    assert set(kind[image & general[:, None]].tolist()) == {1.0}
    solid = valid & (inst[ti.clamp(min=0).long(), 0] == 0)
    assert set(kind[solid].tolist()) == {0.0}
    kinds, blends, mask_clips, gen, polygons = dm.dense_dispatch_info(
        f32, inst, ti, dk, ok)
    assert gen and mask_clips and not polygons
    assert set(kinds) == set(int(k) for k in kind[valid].unique().tolist())
    assert {10, 13, 1, 12, 18, 19, 20} <= set(kinds)
    # without the flags the records and sets are the TPU kernel's
    plain = dm.build_dense_records(f32, inst, xf, ti, dk)
    assert float(plain[..., dm.REC_GENERAL].max()) == 0.0
    assert not set(dm.GENERAL_KINDS) & set(
        dm.dense_dispatch_info(f32, inst, ti, dk)[0])
    # a pass with a raster step: every tile general
    stepped = dm.build_dense_records(f32, inst, xf, ti, dk, ok, True)
    np.testing.assert_array_equal(
        (stepped[..., dm.REC_GENERAL] > 0.5).numpy(), valid.numpy())
    assert dm.dense_dispatch_info(f32, inst, ti, dk, ok, True)[3]


STILL_REFUSED = {
    "blend-op-57": "blend op 57",
}
# refused until the SVG filter path was ported, a polygon clip until
# polygon clips were, gl=True until the GL flavour was and KIND_BORDER
# until it was; now they render
NOW_RENDERED = ("color-matrix-flag-2", "blend-op-2", "blend-op-41",
                "clip-kind-3", "gl", "kind-border")


@pytest.mark.parametrize("case", sorted(STILL_REFUSED) + list(NOW_RENDERED))
def test_what_is_still_refused_names_itself(case, frame):
    """Each refusal comes before any tile is drawn, from the wrapper for a
    dispatch's blends.  The cases that are ported now render: through the
    filter instantiation, a polygon clip through the general one, gl=True
    (the llvmpipe compose) through the gl one and `KIND_BORDER` through
    the border one."""
    if case in NOW_RENDERED:
        _now_rendered(case)
        return
    match = STILL_REFUSED[case]
    before = (tr.LaunchCounts.launches, tr.LaunchCounts.plain_calls)
    kw = dict(kinds=(0,), blends=(0, int(case.rsplit("-", 1)[1])))
    z = torch.zeros
    with pytest.raises(NotImplementedError, match=match):
        tr.render_tiles_dense(z(1, 8, 128), z(1, dtype=torch.int32),
                              z(1, 2), z(4), z(1, 128), z(8, 8),
                              z(4, 8, 8), z(4, 8, 8), **kw)
    assert (tr.LaunchCounts.launches, tr.LaunchCounts.plain_calls) == before


def _now_rendered(case):
    """Color-matrix flag 2 on a picture of the small transformed frame's
    root pass, through the renderer; blend op 2 or 41 in a dispatch's set,
    through the wrapper: each renders, on the filter instantiation.  A
    clip record of the root pass turned into a triangle (clip kind 3)
    renders on the general instantiation, equal to the JAX package's numpy
    oracle on the same edited frame.  gl=True renders through the wrapper,
    on the gl instantiation, with blend op 0 composed as `compose_gl`."""
    before = tr.LaunchCounts.plain_calls
    if case == "gl":
        images = {}
        for gl in (False, True):
            backend = scenes.clip_gradient_scene(
                RenderBackend((256, 128), device="cpu"))
            backend.frame_builder.gl_flavor = gl
            backend.renderer.dispatch_log = log = []
            images[gl] = backend.render()
            assert [e["gl"] for e in log] == [gl] * len(log) and log
        e = log[-1]
        assert tr.instantiation(e["kinds"], e["blends"], e["mask_clips"],
                                e["general"], e["step"], e["linear_cm"],
                                e["polygon_clips"], e["gl"]) == "gl"
        assert tr.LaunchCounts.plain_calls > before
        assert (images[True] != images[False]).any()
        return
    if case == "clip-kind-3":
        _polygon_rendered()
        assert tr.LaunchCounts.plain_calls > before
        return
    if case == "kind-border":
        _border_rendered()
        assert tr.LaunchCounts.plain_calls > before
        return
    if case == "color-matrix-flag-2":
        backend = scenes.transformed_scene(
            RenderBackend((1024, 512), device="cpu"))
        f = backend.build_frame()
        root = f.passes[-1]
        ids = np.unique(root.tile_insts[root.tile_insts >= 0])
        pic = f.instances[ids][f.instances[ids, 0] == 6]
        f.f32_buf[pic[0, 2] + 36] = 2.0
        r = backend.renderer
        r.picture_caching = False
        r.dispatch_log = log = []
        img = r.render(f, backend.resources)
        assert img.shape == (512, 1024, 4) and log[-1]["linear_cm"]
        e = log[-1]
        assert tr.instantiation(e["kinds"], e["blends"], e["mask_clips"],
                                e["general"], e["step"],
                                e["linear_cm"]) == "filter"
        assert tr.LaunchCounts.plain_calls > before
        return
    op = int(case.rsplit("-", 1)[1])
    z = torch.zeros
    out = tr.render_tiles_dense(z(1, 8, 128), z(1, dtype=torch.int32),
                                z(1, 2), z(4), z(1, 128), z(8, 8),
                                z(4, 8, 8), z(4, 8, 8), kinds=(0,),
                                blends=(0, op))
    assert out.shape == (1, 4, 64, 128)
    assert tr.LaunchCounts.plain_calls == before + 1
    assert tr.instantiation((0,), (0, op), False) == "filter"


def _polygon_rendered():
    backend = scenes.transformed_scene(RenderBackend((1024, 512),
                                                     device="cpu"))
    jb = jax_scene(scenes.transformed_scene, (1024, 512))
    r = backend.renderer
    r.picture_caching = False
    frames = []
    for b in (backend, jb):
        f = b.build_frame()
        if b is backend:
            unedited = r.render(f, backend.resources)
        f = dataclasses.replace(f, f32_buf=f.f32_buf.copy())
        root = f.passes[-1]
        ids = np.unique(root.tile_insts[root.tile_insts >= 0])
        i = ids[f.instances[ids, 4] > 0][0]
        polygon_clip(f.f32_buf.reshape(-1, 128), f.instances[i, 3] // 128,
                     polygon_inside(f.inst_bboxes[i]))
        frames.append(f)
    np.testing.assert_array_equal(frames[0].f32_buf, frames[1].f32_buf)
    r.dispatch_log = log = []
    img = r.render(frames[0], backend.resources)
    e = log[-1]
    assert e["polygon_clips"] and not any(x["polygon_clips"]
                                          for x in log[:-1])
    assert tr.instantiation(e["kinds"], e["blends"], e["mask_clips"],
                            e["general"], e["step"], e["linear_cm"],
                            e["polygon_clips"]) == "general"
    jb.renderer.apply_uploads(jb.resources.take_uploads())
    want = SoftwareRenderer(jb.renderer.color_atlas_host,
                            jb.renderer.alpha_atlas_host).render(frames[1])
    np.testing.assert_array_equal(img, want)
    assert not np.array_equal(img, unedited)


def test_check_pass_records_names_kind_border():
    """The first host check refused `KIND_BORDER` by name until it was
    ported; it passes it now, and still names an unknown kind."""
    inst = torch.zeros((2, 8), dtype=torch.int32)
    inst[1, 0] = 9
    ti = torch.tensor([[0, 1, -1, -1]], dtype=torch.int32)
    assert dm.check_pass_records(torch.zeros(256), inst, ti) == (False,
                                                                False)
    assert 9 in dm.PORTED_KINDS
    dm.check_pass_records(torch.zeros(256), inst, ti[:, :1])
    inst[1, 0] = 13
    with pytest.raises(NotImplementedError, match="instance kind 13"):
        dm.check_pass_records(torch.zeros(256), inst, ti)


def _border_rendered():
    """No frame-builder path emits `KIND_BORDER` (borders are cached image
    segments): the clip-gradient frame's last drawn solid instance turned
    into a border (every side a different style, rounded corners) renders
    on the border instantiation, equal to the JAX package's numpy oracle
    on the same edited frame."""
    backend = scenes.clip_gradient_scene(RenderBackend((256, 128),
                                                       device="cpu"))
    jb = jax_scene(scenes.clip_gradient_scene, (256, 128))
    r = backend.renderer
    r.picture_caching = False
    frames = []
    for b in (backend, jb):
        f = b.build_frame()
        if b is backend:
            unedited = r.render(f, backend.resources)
        f = dataclasses.replace(f, f32_buf=f.f32_buf.copy(),
                                instances=f.instances.copy())
        drawn = np.unique(np.concatenate(
            [q.tile_insts[q.tile_insts >= 0] for q in f.passes]))
        i = drawn[f.instances[drawn, 0] == 0][-1]
        f.instances[i, 0] = 9
        addr = f.instances[i, 2]
        rect = f.f32_buf[addr:addr + 4]
        f.f32_buf[addr:addr + 64] = border_payload(
            rect, (6.0, 3.0, 9.0, 4.5), (12.0, 8.0) * 4, (3, 4, 2, 6), 21)
        frames.append(f)
    np.testing.assert_array_equal(frames[0].f32_buf, frames[1].f32_buf)
    r.dispatch_log = log = []
    img = r.render(frames[0], backend.resources)
    assert [tr.instantiation(e["kinds"], e["blends"], e["mask_clips"],
                             e["general"], e["step"], e["linear_cm"],
                             e["polygon_clips"]) for e in log] == ["border"]
    jb.renderer.apply_uploads(jb.resources.take_uploads())
    want = SoftwareRenderer(jb.renderer.color_atlas_host,
                            jb.renderer.alpha_atlas_host).render(frames[1])
    np.testing.assert_array_equal(img, want)
    assert not np.array_equal(img, unedited)


def test_apply_options_on_the_ports_renderer():
    """`apply_options` sets what the port's renderer reads
    (`picture_caching`, `debug_flags`, `profiler`) and adds no attribute:
    the renderer owns each of them from `__init__`, as JAX's does, and the
    JAX package's `use_pallas` has no counterpart."""
    from webrender_tpu_torch.util.options import (DebugFlags,
                                                  WebRenderOptions,
                                                  apply_options)
    backend = RenderBackend((256, 128), device="cpu")
    r = backend.renderer
    assert r.picture_caching and r.profiler is None
    before = set(vars(r))
    apply_options(backend, WebRenderOptions(
        device_pixel_ratio=2.0, enable_picture_caching=False,
        debug_flags=DebugFlags.PROFILER_DBG))
    assert backend.dpr == 2.0
    assert r.picture_caching is False
    assert r.debug_flags == int(DebugFlags.PROFILER_DBG)
    assert r.profiler is backend.profiler
    assert set(vars(r)) - before == set()
    assert not hasattr(r, "use_pallas")
    assert not hasattr(WebRenderOptions(), "use_pallas_kernels")
    apply_options(backend, WebRenderOptions(
        debug_flags=DebugFlags.DISABLE_PICTURE_CACHING))
    assert r.picture_caching is False
    apply_options(backend, WebRenderOptions())
    assert r.picture_caching is True
    # the profiler the options set receives the picture-cache counters
    scenes.clip_gradient_scene(backend)
    backend.dpr = 1.0
    backend.render()
    assert backend.profiler.get("picture_tiles") > 0
