"""`KIND_BORDER` in the port's tile kernel, on the CPU, against the JAX
package (`patterns.pattern_border`, drawn by its Pallas kernel's
`_pattern_math`, its XLA engine and its numpy oracle).

No frame builder emits the kind: borders become cached image segments.
So the frame is made by hand (`scenes.border_frame`: borders in every
style code, with and without radii, translucent, under a rounded clip,
in a scaled reference frame, over a linear gradient) and reaches both
renderers through their entry, `Renderer.render`.

* The port's render (the kernel's plain version on the CPU) equals, on
  the RGBA8 grid and bitwise: the JAX package's numpy oracle with its
  float64 `where`s held in float32, and as it is; the port's own numpy
  oracle (`oracle/sw.py`) likewise; JAX's
  `Renderer(use_pallas=True, pallas_interpret=True)`; and its XLA engine
  (`ops/raster.py::render_tiles`).  XLA's CPU build contracts
  multiply-adds (`ROADMAP.md` C), which turns no value of this frame.
* `pattern_border` of the port (torch) equals the JAX package's run by
  numpy in float32, bitwise, on every border of the frame.
* On a card (marker `cuda`): the 4K frame's dispatch in the border build,
  and the same dispatch in the gl build, against the plain version.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_twin as tw

from webrender_tpu_torch import scenes
from webrender_tpu_torch.frame.gpu import INST_KIND, KIND_BORDER
from webrender_tpu_torch.ops import patterns as pk
from webrender_tpu_torch.ops import tile_raster as tr
from webrender_tpu_torch.ops import xp
from webrender_tpu_torch.oracle import sw as port_sw
from webrender_tpu_torch.renderer.renderer import Renderer, tile_origins

SIZE = (512, 256)
CELL = (128, 96)


@pytest.fixture(scope="module")
def frame():
    return scenes.border_frame(SIZE, cell=CELL)


@pytest.fixture(scope="module")
def port_image(frame):
    r = Renderer("cpu")
    r.picture_caching = False
    r.dispatch_log = log = []
    img = r.render(frame)
    (e,) = log
    assert tr.instantiation(e["kinds"], e["blends"], e["mask_clips"],
                            e["general"], e["step"], e["linear_cm"],
                            e["polygon_clips"], e["gl"]) == "border"
    return img


def _jax_frame(frame):
    """The same arrays and pass in the JAX package's dataclasses."""
    from webrender_tpu.frame import frame_builder as jfb

    def copy(obj, cls):
        return cls(**{f.name: getattr(obj, f.name)
                      for f in dataclasses.fields(cls)})
    jf = copy(frame, jfb.Frame)
    jf.passes = [copy(p, jfb.RenderPass) for p in frame.passes]
    return jf


def test_the_frame_holds_every_style(frame):
    f32 = frame.f32_buf.reshape(-1, 128)
    borders = frame.instances[frame.instances[:, INST_KIND] == KIND_BORDER]
    pay = f32[borders[:, 2] // 128]
    assert set(pay[:, 52:56].ravel().astype(int)) == set(
        scenes.BORDER_STYLES)
    assert (pay[:, 12:20].sum(1) > 0).any() and \
        (pay[:, 12:20].sum(1) == 0).any()
    assert (pay[:, 23] < 1).any() and (borders[:, 4] > 0).any()
    assert (borders[:, 1] == 1).any()   # the scaled reference frame


def test_render_equals_numpy_oracles(frame, port_image):
    from webrender_tpu.oracle.sw import SoftwareRenderer as JaxOracle
    color = np.zeros((4, 64, 64), np.float32)
    alpha = np.zeros((64, 64), np.float32)
    jf = _jax_frame(frame)
    with tw.jax_oracle_float32():
        want32 = JaxOracle(color, alpha).render(jf)
    np.testing.assert_array_equal(port_image, want32)
    with port_sw.float32_where():
        port32 = port_sw.SoftwareRenderer(color, alpha).render(frame)
    np.testing.assert_array_equal(port32, want32)
    as_is = port_sw.SoftwareRenderer(color, alpha).render(frame)
    np.testing.assert_array_equal(as_is, JaxOracle(color, alpha).render(jf))
    np.testing.assert_array_equal(port_image, as_is)
    # the borders drew: many colours
    assert len(np.unique(port_image.reshape(-1, 4), axis=0)) > 500


def test_pattern_border_equals_numpy_float32(frame):
    """Each border of the frame over a grid of local positions around it,
    at its transform's scales: torch against the JAX package's math run
    by numpy with float32 `where`s."""
    import webrender_tpu.ops.patterns as jpk
    f32 = frame.f32_buf.reshape(-1, 128)
    borders = frame.instances[frame.instances[:, INST_KIND] == KIND_BORDER]
    for inst in borders:
        p = f32[inst[2] // 128, :64]
        t = frame.transforms[inst[1]]
        x0, y0, x1, y1 = p[0:4]
        lx, ly = np.meshgrid(
            np.linspace(x0 - 2, x1 + 2, 97, dtype=np.float32),
            np.linspace(y0 - 2, y1 + 2, 61, dtype=np.float32))
        want = jpk.pattern_border(tw.Numpy32(), p, lx, ly, t[9], t[10])
        tp = torch.from_numpy(p)
        got = pk.pattern_border(xp, tp, torch.from_numpy(lx),
                                torch.from_numpy(ly),
                                torch.tensor(t[9]), torch.tensor(t[10]))
        assert want.dtype == np.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_render_against_pallas_interpret(frame, port_image):
    from webrender_tpu.renderer.renderer import Renderer as JaxRenderer
    jr = JaxRenderer(use_pallas=True, pallas_interpret=True)
    jr.picture_caching = False
    want = jr.render(_jax_frame(frame))
    assert jr.engine_counts.get("pallas", 0) >= 1
    np.testing.assert_array_equal(port_image, want)


def test_tiles_against_render_tiles(frame, port_image):
    import jax.numpy as jnp
    from webrender_tpu.ops.raster import render_tiles
    p = frame.passes[0]
    tiles = render_tiles(
        jnp.asarray(frame.f32_buf), jnp.asarray(frame.instances),
        jnp.asarray(frame.transforms), jnp.asarray(p.tile_insts),
        jnp.asarray(tile_origins(p)), jnp.asarray(np.asarray(p.clear,
                                                             np.float32)),
        jnp.zeros((4, 64, 64)), jnp.zeros((64, 64)), jnp.zeros((4, 64, 64)),
        kinds=(0, 2, 9), blends=(0,))
    want = tw.rgba8(np.asarray(tiles), p.nx, p.ny, *SIZE)
    np.testing.assert_array_equal(port_image, want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("gl", [False, True])
def test_cuda_border_frame_matches_plain(cuda_device, gl):
    frame = scenes.border_frame()
    r = Renderer(cuda_device)
    r.picture_caching = False
    a = r.kernel_args(frame, frame.passes[0])
    a["gl"] = gl
    build = "gl" if gl else "border"
    before = tr.LaunchCounts.by_instantiation[build]
    out = tr.render_tiles_dense(**a)
    torch.cuda.synchronize()
    assert tr.LaunchCounts.by_instantiation[build] == before + 1
    plain = {k: v for k, v in a.items()
             if k not in ("general", "linear_cm", "polygon_clips")}
    ref = tr.render_tiles_dense_plain(**plain)
    assert float((out - ref).abs().max()) == 0.0
