"""The port's wrench reader and reftest harness against the JAX package's, on
the CPU, on the port's own documents (`webrender_tpu_torch/testdata/
wrench/`, written by `scenes.write_gl_documents`).

* The readers: each small document read by the JAX package's
  `YamlFrameReader` (which reads the JSON as YAML) and by the port's (which
  reads it with `json`) builds equal frames, field by field, with
  `gl_flavor` on and off.
* The manifest: the port's `parse_reftest_manifest` equals the JAX
  package's case by case (op, paths, fuzziness, `gl_only`, `skipped`,
  `skip_reason`, the rest) under each of `PLATFORM_SETS`.
* The imports: a fresh interpreter in which PyYAML, PIL and matplotlib
  cannot be imported reads a JSON document and builds its frame; the text
  document fails naming matplotlib, a YAML document naming yaml; neither
  JAX nor the JAX package is loaded.
* The path as a whole: the port's `ReftestHarness(device="cpu")` on the
  manifest gives the pass/fail and the `max_diff`/`count` details of the
  JAX package's harness with `engine="oracle"`.
* The documents exist as `write_gl_documents` writes them.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from test_torch_frames import _assert_same

from webrender_tpu_torch import scenes
from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.wrench import reftest as port_reftest
from webrender_tpu_torch.wrench.yaml_reader import YamlFrameReader

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_frame(name, gl):
    from webrender_tpu.render_backend import RenderBackend as JaxBackend
    from webrender_tpu.wrench.yaml_reader import YamlFrameReader as JaxReader
    backend = JaxBackend(scenes.GL_SMALL_SIZE)
    backend.frame_builder.gl_flavor = gl
    JaxReader(scenes.WRENCH / name, scenes.GL_SMALL_SIZE).build(backend)
    return backend.build_frame()


def _port_frame(name, gl):
    backend = RenderBackend(scenes.GL_SMALL_SIZE, device="cpu")
    backend.frame_builder.gl_flavor = gl
    YamlFrameReader(scenes.WRENCH / name, scenes.GL_SMALL_SIZE).build(
        backend)
    return backend.build_frame()


@pytest.mark.parametrize("gl", [True, False])
@pytest.mark.parametrize("name", scenes.GL_DOCUMENTS)
def test_readers_build_equal_frames(name, gl):
    want = _jax_frame(name, gl)
    got = _port_frame(name, gl)
    assert len(got.passes) == len(want.passes) > 0
    _assert_same(got, want, "frame")
    assert got.gl_flavor == gl
    kinds = set(got.instances[:, 0].tolist())
    if name == "gl-gradients.json":
        assert {2, 3, 4} <= kinds
        # the gradient task's u8 quantisation (p[15]) only under gl
        grads = got.instances[np.isin(got.instances[:, 0], (2, 3, 4))]
        assert set(got.f32_buf[grads[:, 2] + 15].tolist()) == \
            ({1.0} if gl else {0.0})
    if name == "gl-rects.json":
        assert 7 in kinds and 1 in set(got.instances[:, 5].tolist())
    if name == "gl-text.json":
        assert 10 in kinds


def _case_fields(case):
    """A case's fields as plain values (the two packages' classes differ)."""
    out = dict(vars(case), reference=str(case.reference),
               tests=[str(p) for p in case.tests])
    out["fuzziness"] = [(f.max_difference, f.num_differences)
                        for f in case.fuzziness]
    return out


@pytest.mark.parametrize("platform", sorted(port_reftest.PLATFORM_SETS))
def test_manifest_cases_equal_jax(platform):
    from webrender_tpu.wrench import reftest as jax_reftest
    tokens = port_reftest.PLATFORM_SETS[platform]
    for manifest in (scenes.GL_MANIFEST, scenes.GL_PAGE_MANIFEST):
        got = port_reftest.parse_reftest_manifest(manifest, tokens)
        want = jax_reftest.parse_reftest_manifest(
            manifest, jax_reftest.PLATFORM_SETS[platform])
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert _case_fields(g) == _case_fields(w), g.line
    cases = port_reftest.parse_reftest_manifest(scenes.GL_MANIFEST, tokens)
    ops = [c.op for c in cases]
    assert ops.count("!=") == 2 and ops.count("==") == 8
    # under the swgl set the platform(linux) lines are skipped; under the
    # others they run in the GL flavour and the plain line does not
    gl_only = [c.gl_only for c in cases if not c.skipped]
    if platform == "swgl":
        assert sum(c.skipped for c in cases) == 9 and gl_only == [False]
    else:
        assert gl_only.count(False) == 1 and gl_only.count(True) == 9
        masks = [c for c in cases if c.line.startswith("platform(linux) "
                                                       "fuzzy-if")][0]
        assert [(f.max_difference, f.num_differences)
                for f in masks.fuzziness] == ([(2, 40)] if platform ==
                                              "union" else [])


NO_EXTRAS = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("yaml", "PIL", "matplotlib"):
            raise ImportError(f"No module named {name!r}", name=name)
sys.meta_path.insert(0, Block())
from webrender_tpu_torch import scenes
from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.wrench.yaml_reader import YamlFrameReader
out = []
for name in ("gl-rects.json", "gl-images.json", "gl-masks.json"):
    b = RenderBackend(scenes.GL_SMALL_SIZE, device="cpu")
    b.frame_builder.gl_flavor = True
    YamlFrameReader(scenes.WRENCH / name, scenes.GL_SMALL_SIZE).build(b)
    out.append(int(b.build_frame().instances.shape[0]))
errors = []
for path in (scenes.WRENCH / "gl-text.json", sys.argv[1]):
    try:
        YamlFrameReader(path, scenes.GL_SMALL_SIZE).build(
            RenderBackend(scenes.GL_SMALL_SIZE, device="cpu"))
        errors.append("read")
    except ModuleNotFoundError as e:
        errors.append(str(e))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "webrender_tpu", "yaml", "PIL",
                 "matplotlib"))
print(repr((out, errors, loaded)))
"""


def test_json_documents_read_without_yaml_pil_or_matplotlib(tmp_path):
    yaml_doc = tmp_path / "rects.yaml"
    yaml_doc.write_text((scenes.WRENCH / "gl-rects.json").read_text())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", NO_EXTRAS, str(yaml_doc)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    counts, errors, loaded = eval(out.stdout.strip().splitlines()[-1])
    assert all(n > 0 for n in counts), counts
    assert "gl-text.json" in errors[0] and "matplotlib" in errors[0]
    assert "rects.yaml" in errors[1] and "package yaml" in errors[1]
    assert loaded == [], loaded


def _results(results):
    return [(r.case.line, r.passed, r.skipped, r.detail) for r in results]


def test_harness_equals_jax_oracle_harness():
    from webrender_tpu.wrench import reftest as jax_reftest
    port = port_reftest.ReftestHarness(scenes.GL_SMALL_SIZE, device="cpu")
    got = port.run_manifest(scenes.GL_MANIFEST)
    want = jax_reftest.ReftestHarness(scenes.GL_SMALL_SIZE,
                                      engine="oracle").run_manifest(
        scenes.GL_MANIFEST)
    assert _results(got) == _results(want)
    assert all(r.passed for r in got)
    # every document rendered on the plain version of the kernel: the GL
    # lines' dispatches are counted as plain-version calls
    assert port.engine_counts["plain"] >= 2 * len(scenes.GL_DOCUMENTS)
    unequal = [r for r in got if r.case.op == "!="]
    assert len(unequal) == 2 and all(
        "count=0" not in r.detail for r in unequal)


def test_documents_are_as_written(tmp_path):
    scenes.write_gl_documents(tmp_path)
    for path in sorted(tmp_path.iterdir()):
        assert path.read_text() == (scenes.WRENCH / path.name).read_text(), \
            path.name
    assert {p.name for p in tmp_path.iterdir()} == {
        p.name for p in scenes.WRENCH.iterdir()}
    page = json.loads((scenes.WRENCH / scenes.GL_PAGE).read_text())
    items = page["root"]["items"]
    assert len(items) > 400
    assert not any("text" in it for it in items)
