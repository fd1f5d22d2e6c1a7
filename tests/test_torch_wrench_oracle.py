"""The port's numpy oracle (`oracle/sw.py`, `RenderBackend.render_software`)
and the harness's cross mode, on the CPU, on the port's small reftest
documents (`webrender_tpu_torch/testdata/wrench/`).

* The oracle: the port's `render_software` equals the JAX package's
  bitwise on each small document, with `gl_flavor` on and off, as it is and
  with its float64 `where`s held in float32 (`float32=True` against
  `torch_twin.jax_oracle_float32`).  The port reads its atlases back from
  the device; they equal the JAX renderer's host mirrors after the same
  transactions.
* The cross mode (`ReftestHarness.run_case_cross`: the device image,
  here the kernel's plain version, against the oracle's, bitwise, no
  fuzz): every case of the manifest passes against the oracle with
  float32 `where`s.  Against the oracle as it is, the cases of
  `CROSS_DIFFERENCES` differ by one u8 step at the stated count: the
  oracle's gradient-stop weights are float64 (numpy's `where` of two
  Python floats), and one quantised ramp value of each of those documents
  lies on an exact half, which float32 rounds the other way.  The JAX
  package's own device image differs from its oracle there too (on
  `gl-gradients.json` at the same pixel).

The documents' images against the JAX package's goldens are in
`tests/test_torch_wrench_goldens.py`.
"""
import numpy as np
import pytest

import torch_twin as tw

from webrender_tpu_torch import scenes
from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.wrench import reftest as port_reftest
from webrender_tpu_torch.wrench.yaml_reader import YamlFrameReader

# (max diff, pixels) of the cross mode against the oracle as it is, by the
# manifest line's first document; every other line is bitwise
CROSS_DIFFERENCES = {"gl-gradients.json": (1, 1), "gl-masks.json": (1, 1)}


def _backends(name, gl):
    from webrender_tpu.render_backend import RenderBackend as JaxBackend
    from webrender_tpu.wrench.yaml_reader import YamlFrameReader as JaxReader
    jax_b = JaxBackend(scenes.GL_SMALL_SIZE)
    port_b = RenderBackend(scenes.GL_SMALL_SIZE, device="cpu")
    for b, reader in ((jax_b, JaxReader), (port_b, YamlFrameReader)):
        b.frame_builder.gl_flavor = gl
        reader(scenes.WRENCH / name, scenes.GL_SMALL_SIZE).build(b)
    return jax_b, port_b


@pytest.mark.parametrize("gl", [True, False])
@pytest.mark.parametrize("name", scenes.GL_DOCUMENTS)
def test_render_software_equals_jax(name, gl):
    jax_b, port_b = _backends(name, gl)
    want = jax_b.render_software()
    got = port_b.render_software()
    np.testing.assert_array_equal(got, want)
    with tw.jax_oracle_float32():
        want32 = jax_b.render_software()
    np.testing.assert_array_equal(port_b.render_software(float32=True),
                                  want32)
    color, alpha = port_b.renderer.host_atlases()
    np.testing.assert_array_equal(color, jax_b.renderer.color_atlas_host)
    np.testing.assert_array_equal(alpha, jax_b.renderer.alpha_atlas_host)
    assert color.dtype == np.float32
    # images, masks, box-shadow masks and subpixel glyphs live in the
    # color atlas
    assert color.any() == (name in ("gl-images.json", "gl-masks.json",
                                    "gl-shadows.json", "gl-text.json"))
    # the native span rasterizer (oracle/native.py) on both packages
    np.testing.assert_array_equal(port_b.render_software(use_native=True),
                                  jax_b.render_software(use_native=True))


def test_cross_mode_on_every_case():
    cases = port_reftest.parse_reftest_manifest(scenes.GL_MANIFEST)
    assert len(cases) == 10
    for float32 in (True, False):
        harness = port_reftest.ReftestHarness(
            scenes.GL_SMALL_SIZE, device="cpu", oracle_float32=float32)
        for case in cases:
            r = harness.run_case_cross(case)
            assert not r.skipped, case.line
            diff = (0, 0) if float32 else max(
                CROSS_DIFFERENCES.get(p.name, (0, 0))
                for p in case.tests + [case.reference])
            assert r.detail.startswith(
                f"dev_vs_oracle max_diff={diff[0]} count={diff[1]}"), \
                (case.line, float32, r.detail)
            assert r.passed == (diff == (0, 0))
        assert harness.engine_counts["plain"] >= 2 * len(cases)


def test_jax_device_differs_from_its_oracle_at_the_same_pixel():
    """The JAX package's renderer on `gl-gradients.json` under gl differs
    from its own numpy oracle where the port's device image does."""
    from webrender_tpu.wrench.yaml_reader import YamlFrameReader as JaxReader
    jax_b = tw.jax_backend(scenes.GL_SMALL_SIZE)
    jax_b.frame_builder.gl_flavor = True
    JaxReader(scenes.WRENCH / "gl-gradients.json",
              scenes.GL_SMALL_SIZE).build(jax_b)
    jax_dev = jax_b.render()
    jax_orc = jax_b.render_software()
    _, port_b = _backends("gl-gradients.json", True)
    port_dev = port_b.render()
    np.testing.assert_array_equal(port_dev, jax_dev)
    assert np.array_equal(np.argwhere((jax_dev != jax_orc).any(2)),
                          np.argwhere((port_dev != port_b.render_software())
                                      .any(2)))
    assert int((jax_dev != jax_orc).any(2).sum()) == \
        CROSS_DIFFERENCES["gl-gradients.json"][1]
