"""Continuation passes on the port against the JAX package.

* The scene of tests/test_continuation_pass.py with picture caching on:
  the root target renders as a pre-slice pass, a slice pass and a
  continuation pass, unmerged, and the RGBA8 image and the f32
  framebuffer equal JAX's bitwise.
* The kernel's plain version with `init_tiles` against
  `render_tiles_pallas_dense(..., init_tiles, interpret=True)`.
* `disassemble_tiles` and the slice composite against JAX's.
"""
import numpy as np
import pytest
import torch

from test_continuation_pass import _scene_with_scroll_slice
from torch_twin import (SMALL_FRAMES, PortFeed, jax_kernel_inputs, jax_scene,
                        to_torch)

from webrender_tpu_torch.ops import tile_raster as tr
from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.renderer import renderer as rmod


def _jax_cached_backend(size):
    """A JAX RenderBackend with picture caching on (its default), on the
    XLA engine, which tests/test_kernel_variants.py holds bit-equal to the
    Pallas kernel."""
    from webrender_tpu.render_backend import RenderBackend as JaxBackend
    backend = JaxBackend(size)
    assert backend.renderer.picture_caching
    return backend


def test_unmerged_three_pass_frame_equals_jax():
    ref = _jax_cached_backend((512, 256))
    port = RenderBackend((512, 256), device="cpu")
    assert port.renderer.picture_caching
    _scene_with_scroll_slice(ref)
    _scene_with_scroll_slice(PortFeed(port))
    frame = port.build_frame()
    assert [(p.clear is None, p.slice_key is not None)
            for p in frame.passes] == [(False, False), (True, True),
                                       (True, False)]
    want = ref.render()
    want_fb = np.asarray(ref.renderer.last_framebuffer)
    before = tr.LaunchCounts.plain_calls
    port.renderer.dispatch_log = log = []
    got_fb = port.renderer.render_device(frame, port.resources)
    # three dispatches: the pre-slice pass, the slice's 49 cache tiles
    # (all dirty on the first frame), the continuation from init tiles
    assert tr.LaunchCounts.plain_calls == before + 3
    assert [a["init_tiles"] is not None for a in log] == [False, False, True]
    assert log[1]["dense"].shape[0] == 49
    np.testing.assert_array_equal(got_fb.numpy(), want_fb)
    assert port.renderer.slice_debug == ref.renderer.slice_debug
    assert port.renderer.last_dirty_tiles == ref.renderer.last_dirty_tiles
    # the same frame again: the retained framebuffer, no dispatch
    np.testing.assert_array_equal(port.renderer.render(frame), want)
    assert tr.LaunchCounts.plain_calls == before + 3 and len(log) == 3
    assert port.renderer.last_dirty_tiles == 0
    # the same frame uncached (one merged pass) gives the same image
    uncached = RenderBackend((512, 256), device="cpu")
    uncached.renderer.picture_caching = False
    _scene_with_scroll_slice(PortFeed(uncached))
    np.testing.assert_array_equal(uncached.render(), want)


def test_continuation_leaves_the_root_grid_image_alone():
    """A continuation pass after a root pass with tile hashes draws into
    the framebuffer that the root grid assembled.  The grid's retained
    image must not take those pixels: the next frame with the same root
    tiles and no continuation renders as a frame that never had one."""
    import dataclasses
    from webrender_tpu_torch import scenes
    port = scenes.clip_gradient_scene(RenderBackend((256, 128),
                                                    device="cpu"))
    base = port.build_frame()
    (root,) = base.passes
    assert root.tile_hashes is not None and root.clear is not None
    # the same records less each tile's first, the opaque background
    ti = np.full_like(root.tile_insts, -1)
    ti[:, :-1] = root.tile_insts[:, 1:]
    again = dataclasses.replace(root, clear=None, tile_hashes=None,
                                tile_insts=ti)
    twice = dataclasses.replace(base, passes=[root, again])
    once = dataclasses.replace(base, passes=[root])
    r = port.renderer
    r.apply_uploads(port.resources.take_uploads())
    drawn_twice = r.render(twice)
    got = r.render(once)
    assert r.last_dirty_tiles == 0  # the grid was reused as it stood
    fresh = scenes.clip_gradient_scene(RenderBackend((256, 128),
                                                     device="cpu"))
    want = fresh.render()
    assert not np.array_equal(drawn_twice, want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["clip_gradient", "text_run"])
def test_plain_with_init_tiles_matches_pallas_interpret(name):
    import jax.numpy as jnp
    from webrender_tpu.ops.pallas import tile_raster as jt
    make, size = SMALL_FRAMES[name]
    _, _, _, (kinds, blends, _), args = jax_kernel_inputs(
        jax_scene(make, size))
    rng = np.random.RandomState(11)
    # starting pixels on the u8 grid, as a framebuffer holds them; alpha
    # below 1 so that the records blend over them
    init = (rng.randint(0, 256, (args["dense"].shape[0], 4, 64, 128))
            / 255.0).astype(np.float32)
    init[:, 3] = np.minimum(init[:, 3], 0.5)
    a = {k: jnp.asarray(v) for k, v in args.items()}
    ref = np.asarray(jt.render_tiles_pallas_dense(
        a["dense"], a["counts"], a["origins"], jnp.zeros(4, jnp.float32),
        a["f32_rows"], a["alpha_atlas"], a["surface_atlas"],
        a["color_atlas"], jnp.asarray(init), kinds=kinds, blends=blends,
        mask_clips=False, interpret=True))
    t = to_torch(args)
    got = tr.render_tiles_dense(
        t["dense"], t["counts"], t["origins"], torch.zeros(4),
        t["f32_rows"], t["alpha_atlas"], t["surface_atlas"],
        t["color_atlas"], torch.from_numpy(init), kinds=kinds,
        blends=blends).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() == 0.0
    # the records drew over the starting pixels and did not replace them
    assert not np.array_equal(got, init)


@pytest.mark.parametrize("shape", [(64, 128), (100, 300), (128, 384)])
def test_disassemble_tiles_matches_jax(shape):
    from webrender_tpu.ops.raster import assemble_tiles, disassemble_tiles
    h, w = shape
    nx, ny = -(-w // 128), -(-h // 64)
    img = np.random.RandomState(h + w).rand(4, h, w).astype(np.float32)
    want = np.asarray(disassemble_tiles(img, nx, ny))
    got = rmod.disassemble_tiles(torch.from_numpy(img), nx, ny)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        rmod.assemble_tiles(got, nx, ny, w, h).numpy(),
        np.asarray(assemble_tiles(want, nx, ny, w, h)))


def test_slice_composite_matches_jax():
    from webrender_tpu.renderer.renderer import _slice_composite
    rng = np.random.RandomState(3)
    fb = (rng.randint(0, 256, (4, 96, 160)) / 255.0).astype(np.float32)
    img = (rng.randint(0, 256, (4, 128, 256)) / 255.0).astype(np.float32)
    img[:, ::3] *= 0.5  # values off the u8 grid, as tiles may hold
    place = (17, 9, 40, 23)  # dst_x, dst_y, src_x, src_y
    w, h = 101, 70
    want = np.asarray(_slice_composite(fb.copy(), img, *place, w=w, h=h))
    target = torch.from_numpy(fb.copy())
    got = rmod.slice_composite(target, torch.from_numpy(img), *place, w, h)
    assert got is target  # in place
    np.testing.assert_array_equal(got.numpy(), want)
