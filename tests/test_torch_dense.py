"""`webrender_tpu_torch.ops.dense` against the JAX package's dense-record
functions on the same frames: bitwise."""
import numpy as np
import pytest
import torch

from torch_twin import (SMALL_FRAMES, jax_kernel_inputs, jax_scene,
                        to_torch)

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
    ok = dm.pallas_supported(f32, inst, xf)
    assert dm.dense_dispatch_info(f32, inst, ti, tdk, ok) == \
        (tuple(kinds), tuple(blends), mask_clips, False, False)
    # no general tile: the routed records are the TPU kernel's
    assert not dm.general_tiles(ti, ok).any()
    np.testing.assert_array_equal(
        dm.build_dense_records(f32, inst, xf, ti, tdk, ok).numpy(),
        args["dense"])
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
            assert not dm.general_tiles(torch.from_numpy(p.tile_insts),
                                        torch.from_numpy(got)).any()


def test_rotated_images_are_refused():
    """A scaled image whose mapping is not axis-aligned: the TPU kernel
    hands its tiles to XLA.  The port refused them once (hence the name);
    now their records route to the general image kind (here every tile
    lists an image of the sheared node), and the pass renders what the JAX
    package's `render_tiles` renders on the same arrays."""
    import jax.numpy as jnp
    from webrender_tpu.ops.raster import render_tiles
    from webrender_tpu_torch.ops import tile_raster as tr
    backend = jax_scene(SMALL_FRAMES["images"][0], (384, 256))
    frame, p, dk, _, args = jax_kernel_inputs(backend)
    f32 = torch.from_numpy(frame.f32_buf)
    inst = torch.from_numpy(frame.instances)
    xf = torch.from_numpy(frame.transforms.copy())
    ti = torch.from_numpy(p.tile_insts)
    tdk = torch.from_numpy(dk)
    assert not dm.general_tiles(ti, dm.pallas_supported(f32, inst, xf)).any()
    node = int(inst[tdk == dm.K_SEP_IMAGE][0, 1])
    xf[node, 1] = 0.25  # a shear term
    xf[node, 11] = 4.0  # a transformed node
    ok = dm.pallas_supported(f32, inst, xf)
    images = torch.nonzero(inst[:, 0] == 1).reshape(-1)
    assert not ok[images].any() and ok.sum() == ok.numel() - images.numel()
    gen = dm.general_tiles(ti, ok)
    assert gen.tolist() == torch.isin(ti, images).any(1).tolist()
    assert gen.any()
    dense = dm.build_dense_records(f32, inst, xf, ti, tdk, ok)
    kind = dense[..., dm.REC_KIND]
    assert (kind[gen] == dm.K_SEP_IMAGE).sum() == 0
    assert (kind[gen] == dm.K_GEN_IMAGE).sum() > 0
    assert (kind[~gen] == dm.K_GEN_IMAGE).sum() == 0
    assert (dense[..., dm.REC_GENERAL] > 0.5).any(1).tolist() == gen.tolist()
    kinds, blends, mask_clips, general, polygons = dm.dense_dispatch_info(
        f32, inst, ti, tdk, ok)
    assert not polygons
    assert dm.K_GEN_IMAGE in kinds and general
    t = to_torch(args)
    got = tr.render_tiles_dense(
        dense, t["counts"], t["origins"], t["clear"], t["f32_rows"],
        t["alpha_atlas"], t["surface_atlas"], t["color_atlas"], kinds=kinds,
        blends=blends, mask_clips=mask_clips, general=general).numpy()
    raw = tuple(int(k) for k in np.unique(frame.instances[:, 0]))
    want = np.asarray(render_tiles(
        jnp.asarray(frame.f32_buf), jnp.asarray(frame.instances),
        jnp.asarray(xf.numpy()), jnp.asarray(p.tile_insts),
        jnp.asarray(args["origins"]), jnp.asarray(args["clear"]),
        jnp.asarray(args["color_atlas"]), jnp.asarray(args["alpha_atlas"]),
        jnp.asarray(args["surface_atlas"]), kinds=raw, blends=blends))
    sel = gen.numpy()
    assert np.array_equal(got[sel], want[sel])
