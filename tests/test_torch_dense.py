"""`webrender_tpu_torch.ops.dense` against the JAX package's dense-record
functions on the same frames: bitwise."""
import numpy as np
import pytest
import torch

from torch_twin import SMALL_FRAMES, jax_kernel_inputs, jax_scene

from webrender_tpu_torch import scenes
from webrender_tpu_torch.ops import dense as dm


def _slice_backend():
    return jax_scene(scenes.build_4k_scene, (640, 384), 640, 384, 12, 4, 8,
                     4)


FRAMES = dict(SMALL_FRAMES)
FRAMES["slice"] = (None, None)
FRAMES["effects"] = (scenes.effects_scene, (1024, 512))
FRAMES["content"] = (scenes.content_scene, (1024, 512))
ZOOMED = {name: zoom for name, zoom in scenes.ZOOMED_FRAMES}
FRAMES.update({name: (scenes.zoomed_scene, scenes.ZOOMED_SIZE)
               for name in ZOOMED})


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_dense_records_match_jax(name):
    make, size = FRAMES[name]
    extra = (ZOOMED[name],) if name in ZOOMED else ()
    backend = _slice_backend() if make is None else \
        jax_scene(make, size, *extra)
    frame, p, dk, (kinds, blends, mask_clips), args = \
        jax_kernel_inputs(backend)
    f32 = torch.from_numpy(frame.f32_buf)
    inst = torch.from_numpy(frame.instances)
    xf = torch.from_numpy(frame.transforms)
    ti = torch.from_numpy(p.tile_insts)
    tdk = dm.classify_dense_kinds(f32, inst, xf)
    assert tdk.dtype == torch.int32
    np.testing.assert_array_equal(tdk.numpy(), dk)
    dense = dm.build_dense_records(f32, inst, xf, ti, tdk)
    assert dense.dtype == torch.float32
    np.testing.assert_array_equal(dense.numpy(), args["dense"])
    assert dm.dense_dispatch_info(f32, inst, ti, tdk) == \
        (tuple(kinds), tuple(blends), mask_clips)
    dm.check_pallas_paths(f32, inst, xf, ti)
    if name == "slice":
        # the slice dispatches what the 4K bench frame dispatches
        assert kinds == (0, 2, 10, 13) and blends == (0, 7, 8)
        assert not mask_clips
    if name == "effects":
        # the root pass composites its surfaces through both picture kinds
        assert kinds == (0, 6, 15) and blends == (0,)
    if name == "content":
        # the content kinds, the mix-blend composites and the mask clips
        assert kinds == (0, 3, 4, 6, 8, 10, 11, 13)
        assert blends == (0, 7, 8, 17, 18, 26, 31) and mask_clips
    if name in ZOOMED:
        # scaled subpixel text, video, clear rects, the opacity groups
        assert kinds == (0, 2, 6, 7, 13, 16, 17)
        assert blends == (0, 1, 7, 8) and not mask_clips


SUPPORT_FRAMES = {"effects": (scenes.effects_scene, (1024, 512), ()),
                  "content": (scenes.content_scene, (1024, 512), ()),
                  "effects_4k": (scenes.build_4k_effects_scene, (3840, 2160),
                                 ()),
                  "slice": (scenes.build_4k_scene, (640, 384),
                            (640, 384, 12, 4, 8, 4)),
                  "branches": (scenes.branches_scene, (384, 192), ())}
SUPPORT_FRAMES.update({name: (scenes.zoomed_scene, scenes.ZOOMED_SIZE,
                              (zoom,)) for name, zoom in ZOOMED.items()})
SUPPORT_FRAMES.update({f"{name}_4k": (scenes.build_4k_zoomed_scene,
                                      (3840, 2160), (3840, 2160, zoom))
                       for name, zoom in ZOOMED.items()})


@pytest.mark.parametrize("name", sorted(SUPPORT_FRAMES))
def test_classification_and_support_match_jax(name):
    """Every instance of the frame (surface passes' included) gets JAX's
    dense kind (`classify_dense_kinds`) and JAX's verdict on whether the
    Pallas kernel draws it (`_supported_vec`); the port raises where JAX
    would hand a tile to its XLA engine, and these frames have none."""
    from webrender_tpu.ops.pallas import tile_raster as jt
    make, size, extra = SUPPORT_FRAMES[name]
    frame = jax_scene(make, size, *extra).build_frame()
    arrays = [torch.from_numpy(a) for a in
              (frame.f32_buf, frame.instances, frame.transforms)]
    np.testing.assert_array_equal(
        dm.classify_dense_kinds(*arrays).numpy(),
        jt.classify_dense_kinds(frame.f32_buf, frame.instances,
                                frame.transforms))
    want = jt._supported_vec(frame.instances, frame.transforms,
                             frame.f32_buf)
    got = dm.pallas_supported(arrays[0], arrays[1], arrays[2]).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.all()
    if name.startswith("zoomed"):
        # the scaled glyphs (grayscale in the opacity groups) and the video
        assert {14, 16, 17} <= set(
            dm.classify_dense_kinds(*arrays).tolist())
    for p in frame.passes:
        if p.tile_insts is not None:
            dm.check_pallas_paths(arrays[0], arrays[1], arrays[2],
                                  torch.from_numpy(p.tile_insts))


def test_rotated_images_are_refused():
    """A scaled image whose mapping is not axis-aligned (the TPU kernel
    hands such tiles to XLA) raises instead of rendering wrong."""
    backend = jax_scene(SMALL_FRAMES["images"][0], (384, 256))
    frame, p, dk, _, _ = jax_kernel_inputs(backend)
    f32 = torch.from_numpy(frame.f32_buf)
    inst = torch.from_numpy(frame.instances)
    xf = torch.from_numpy(frame.transforms.copy())
    ti = torch.from_numpy(p.tile_insts)
    tdk = torch.from_numpy(dk)
    dm.check_pallas_paths(f32, inst, xf, ti)
    node = int(inst[tdk == dm.K_SEP_IMAGE][0, 1])
    xf[node, 1] = 0.25  # a shear term
    with pytest.raises(NotImplementedError, match="no path in the tile"):
        dm.check_pallas_paths(f32, inst, xf, ti)
