"""The port's native span rasterizer binding (`oracle/native.py`) against
the numpy oracle and the JAX package, on the CPU: twins of
`tests/test_native_oracle.py`.

The JAX package's twins skip where the library does not load, and its
binding falls back to numpy silently, which would hold numpy against
numpy.  Here the library must load (`native/libspanraster.so` is in the
repository), so `available()` is asserted, not skipped on.
"""
import numpy as np
import pytest

from torch_twin import jax_scene

from webrender_tpu_torch import scenes
from webrender_tpu_torch.oracle import native
from webrender_tpu_torch.oracle.sw import SoftwareRenderer
from webrender_tpu_torch.render_backend import RenderBackend

# bench.build_4k_scene's mixed page, small: solids (opaque and translucent
# spans), gradients, images (scaled and repeating), text, the rounded clip,
# the scroll frame
PAGE = (640, 400, 60, 16, 12, 8)


def test_native_library_loads():
    assert native.available()
    assert native.LIBRARY.parts[-2:] == ("native", "libspanraster.so")


def test_native_matches_numpy_oracle():
    backend = scenes.build_4k_scene(
        RenderBackend(PAGE[:2], device="cpu",
                      resources=scenes.resource_cache()), *PAGE)
    frame = backend.build_frame()
    backend.renderer.apply_uploads(backend.resources.take_uploads())
    atlases = backend.renderer.host_atlases()
    a = SoftwareRenderer(*atlases).render(frame)
    b = SoftwareRenderer(*atlases, use_native=True).render(frame)
    diff = np.abs(a.astype(int) - b.astype(int))
    assert diff.max() == 0, f"native diverges: max {diff.max()}"
    # the JAX package's numpy oracle on the same page
    jax_b = jax_scene(scenes.build_4k_scene, PAGE[:2], *PAGE)
    np.testing.assert_array_equal(b, jax_b.render_software())
    # and through the backend
    np.testing.assert_array_equal(backend.render_software(use_native=True),
                                  a)


def test_native_pack_rgba8_matches_numpy():
    rng = np.random.RandomState(0)
    fb = rng.rand(4, 33, 57).astype(np.float32) * 1.2 - 0.1
    fb[0, 0, 0] = np.nan
    got = native.pack_rgba8(fb)
    v = np.transpose(fb, (1, 2, 0)).astype(np.float64) * 255.0
    want = np.clip(np.floor(np.nan_to_num(v) + 0.5), 0, 255).astype(np.uint8)
    assert (got == want).all()
    from webrender_tpu.oracle import native as jax_native
    np.testing.assert_array_equal(got, jax_native.pack_rgba8(fb))


def test_use_native_needs_the_library(monkeypatch):
    """Without the library `use_native` raises: it never runs numpy in its
    place."""
    monkeypatch.setattr(native, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="does not load"):
        SoftwareRenderer(np.zeros((4, 8, 8), np.float32),
                         np.zeros((8, 8), np.float32), use_native=True)
    with pytest.raises(RuntimeError, match="does not load"):
        native.pack_rgba8(np.zeros((4, 2, 2), np.float32))
