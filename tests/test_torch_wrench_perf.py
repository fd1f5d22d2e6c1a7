"""The port's wrench perf harness (`wrench/perf.py`) on the CPU, against
the JAX package's (`webrender_tpu/wrench/perf.py`).

* `run_benchmarks` reads a manifest as the JAX harness does: comments and
  blank lines dropped, documents relative to the manifest, missing ones
  skipped, a failing one recorded with its error; each result has the JAX
  harness's keys.
* `compare_perf` prints the JAX harness's table, character for character,
  on the same two result files.
* The port's manifest (`testdata/wrench/perf-4k.list`) lists the 4K GL
  page and the small GL documents, and is what `scenes.write_gl_documents`
  writes.
"""
import json

import pytest

from webrender_tpu.wrench import perf as jax_perf

from webrender_tpu_torch import scenes
from webrender_tpu_torch.wrench import perf

KEYS = {"scene", "min_ms", "p50_ms", "max_ms", "frame_build_ms",
        "scene_build_ms", "passes", "instances"}


def test_manifest_and_results(tmp_path, monkeypatch):
    src = scenes.WRENCH / "gl-rects.json"
    (tmp_path / "a.json").write_text(src.read_text())
    (tmp_path / "bad.json").write_text("{not json")
    manifest = tmp_path / "bench.list"
    manifest.write_text("# a comment\n\na.json   # trailing comment\n"
                        "missing.json\nbad.json\n")
    monkeypatch.setattr(perf, "SAMPLE_FRAMES", 2)
    seen = []
    real = perf.run_scene

    def run_scene(path, window_size, engine, samples=2, device="cuda"):
        seen.append((path.name, window_size, engine, device))
        return real(path, window_size, engine, samples=2, device=device)
    monkeypatch.setattr(perf, "run_scene", run_scene)
    out = tmp_path / "results.json"
    results = perf.run_benchmarks(manifest, str(out), engine="device",
                                  window_size=(256, 128), device="cpu")
    assert [s[0] for s in seen] == ["a.json", "bad.json"]
    assert all(s[1:] == ((256, 128), "device", "cpu") for s in seen)
    assert len(results) == 2
    assert set(results[0]) == KEYS and results[0]["scene"] == "a.json"
    assert results[0]["instances"] > 0 and results[0]["passes"] >= 1
    assert 0 < results[0]["min_ms"] <= results[0]["p50_ms"] <= \
        results[0]["max_ms"]
    assert set(results[1]) == {"scene", "error"}
    assert json.loads(out.read_text()) == results


def test_run_scene_engines():
    """Both engines on one document, on the CPU: the device engine (the
    kernel's plain version here) and the numpy oracle."""
    for engine in ("device", "oracle"):
        r = perf.run_scene(scenes.WRENCH / "gl-masks.json", (256, 128),
                           engine, samples=2, device="cpu")
        assert set(r) == KEYS and r["p50_ms"] > 0


@pytest.mark.parametrize("same", [True, False])
def test_compare_perf_equals_jax(tmp_path, same):
    a = [{"scene": "x.yaml", "p50_ms": 2.0}, {"scene": "y.yaml",
                                               "p50_ms": 10.125},
         {"scene": "gone.yaml", "p50_ms": 1.0},
         {"scene": "err.yaml", "error": "RuntimeError('x')"}]
    b = [{"scene": "x.yaml", "p50_ms": 3.5}, {"scene": "y.yaml",
                                              "p50_ms": 5.0},
         {"scene": "new.yaml", "p50_ms": 7.0},
         {"scene": "err.yaml", "error": "RuntimeError('x')"}]
    if same:
        b = a
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(a))
    pb.write_text(json.dumps(b))
    got = perf.compare_perf(str(pa), str(pb))
    assert got == jax_perf.compare_perf(str(pa), str(pb))
    assert got.splitlines()[0].split() == ["scene", "A", "p50", "B", "p50",
                                           "ratio"]


def test_the_ports_manifest(tmp_path):
    assert perf.PERF_MANIFEST == scenes.GL_PERF_MANIFEST
    assert perf.PERF_WINDOW == scenes.GL_PAGE_SIZE
    names = [line.split("#")[0].strip() for line in
             perf.PERF_MANIFEST.read_text().splitlines()]
    names = [n for n in names if n]
    assert names == [scenes.GL_PAGE] + list(scenes.GL_DOCUMENTS)
    assert all((scenes.WRENCH / n).exists() for n in names)
