"""The slice end to end: `bench.py`'s browsing scene, cut to 640x384,
built through the port and rendered by both packages."""
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_twin import jax_backend

from webrender_tpu_torch import convert, scenes
from webrender_tpu_torch.ops.tile_raster import LaunchCounts
from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.renderer.renderer import merged_root_passes
from webrender_tpu_torch.resources import ResourceCache

SLICE = (640, 384, 12, 4, 8, 4)  # w, h, rects, gradients, images, text runs


@pytest.fixture(scope="module")
def slice_backends():
    from bench import build_4k_scene
    ref = build_4k_scene(*SLICE)
    # bench builds on a default renderer; render on the Pallas kernel in
    # interpret mode instead (uploads are still pending, so nothing is lost)
    ref.renderer = jax_backend(ref.device_size).renderer
    port = scenes.build_4k_scene(RenderBackend(SLICE[:2], device="cpu"),
                                 *SLICE)
    return ref, port


def test_slice_frame_equals_bench(slice_backends):
    ref, port = slice_backends
    a, b = ref.build_frame(), port.build_frame()
    for name in ("f32_buf", "instances", "transforms"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert len(a.passes) == len(b.passes)
    for pa, pb in zip(a.passes, b.passes):
        assert (pa.kind, pa.target, pa.region, pa.clear) == \
            (pb.kind, pb.target, pb.region, pb.clear)
        np.testing.assert_array_equal(pa.tile_insts, pb.tile_insts)


def test_slice_renders_as_jax(slice_backends):
    ref, port = slice_backends
    want = ref.render()
    assert ref.renderer.last_engine == "pallas"
    convert.copy_atlases(ref.renderer, port.renderer)
    before = LaunchCounts.plain_calls
    got = port.render()
    assert LaunchCounts.plain_calls == before + 1
    (p,) = merged_root_passes(port.build_frame())
    assert p.tile_insts.shape == (30, 64)
    assert got.shape == want.shape == (384, 640, 4)
    np.testing.assert_array_equal(got, want)


def test_port_runs_without_jax():
    """A fresh interpreter with JAX blocked builds and renders a scene
    through the port on the CPU, and loads no JAX module."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "from webrender_tpu_torch import scenes\n"
        "from webrender_tpu_torch.render_backend import RenderBackend\n"
        "b = scenes.image_scene(RenderBackend((384, 256), device='cpu'))\n"
        "img = b.render()\n"
        "assert img.shape == (256, 384, 4) and img.any()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_resource_cache_defers_fonts():
    from webrender_tpu.resources.resource_cache import \
        ResourceCache as JaxCache
    ours, theirs = ResourceCache(), JaxCache()
    # the port's cache adds the running totals of `memory_report`
    assert set(vars(ours)) == set(vars(theirs)) | {"_image_bytes",
                                                   "_glyph_bytes"}
    assert ours.fonts._ctx is None and ours.memory_report()["fonts"] == 0
    if scenes.font_stack_available():
        from webrender_tpu.api.font import FontKey
        ours.add_font(FontKey(0, 1), None, scenes.dejavu_path())
        assert ours.fonts._ctx is not None and ours.fonts.faces
