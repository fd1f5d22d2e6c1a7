"""The port's small reftest documents (`webrender_tpu_torch/testdata/
wrench/`) against the JAX package's images, on the CPU.

Each small document through the port's harness (`device="cpu"`, the GL
flavour: every dispatch on the kernel's plain version with `gl=True`)
equals the JAX package's image stored in `testdata/goldens.npz`
(`torch_twin.jax_document_golden`: its Pallas kernel in interpret mode
with `gl=True`, or for the documents with general tiles,
`scenes.GL_GENERAL_DOCUMENTS`, which XLA draws with multiply-adds
contracted, its numpy oracle with float32 `where`s), bitwise; each golden
equals a fresh JAX render, and the documents with general tiles are the
ones `GL_GENERAL_DOCUMENTS` names.
"""
import numpy as np
import pytest

import torch_twin as tw

from webrender_tpu_torch import scenes
from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.wrench import reftest as port_reftest
from webrender_tpu_torch.wrench.yaml_reader import YamlFrameReader


@pytest.mark.parametrize("name", scenes.GL_DOCUMENTS)
def test_documents_equal_jax_goldens(name):
    golden = np.load(scenes.GOLDENS)[scenes.gl_golden_name(name)]
    harness = port_reftest.ReftestHarness(scenes.GL_SMALL_SIZE, device="cpu")
    img, stats = harness.render_yaml(scenes.WRENCH / name, gl_flavor=True)
    np.testing.assert_array_equal(img, golden)
    assert stats["draw_calls"] >= 1
    np.testing.assert_array_equal(golden, tw.jax_document_golden(name))
    # the documents with general tiles are the ones that say so
    backend = RenderBackend(scenes.GL_SMALL_SIZE, device="cpu")
    backend.frame_builder.gl_flavor = True
    YamlFrameReader(scenes.WRENCH / name, scenes.GL_SMALL_SIZE).build(
        backend)
    backend.renderer.picture_caching = False
    backend.render()
    general = sum(g for g, _ in backend.renderer.last_general_tiles)
    assert (general > 0) == (name in scenes.GL_GENERAL_DOCUMENTS)
