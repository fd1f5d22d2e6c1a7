"""The port's reftest runners (`wrench/run_reftests.py`, `wrench/run_case.py`)
against the harness they drive and the JAX package's runners, on the CPU.

* `run_reftests --manifest` on the port's GL manifest: its printed lines
  and JSON totals equal `ReftestHarness` run directly on the same cases,
  and the JAX package's harness on them (`--engine oracle`, each platform
  set; `--engine device` on a manifest of one line), and its JSON has the
  keys `run_reftests.py` writes.
* With no `--engine` both runners render on the renderer (the plain
  version's calls are counted on the CPU), not the numpy oracle.
* A `--manifest` that does not exist fails the run.
* `run_case` selects the cases whose line holds a substring, as
  `tools/run_case.py` does, prints one line a case and exits 1 on a
  failure.
* Both exit 2, running nothing, when the card is asked for (the default)
  on a machine without CUDA.
"""
import ast
import json
import pathlib

import pytest
import torch

from webrender_tpu_torch import scenes
from webrender_tpu_torch.ops.tile_raster import LaunchCounts
from webrender_tpu_torch.wrench import run_case, run_reftests
from webrender_tpu_torch.wrench.reftest import (PLATFORM_SETS,
                                                ReftestHarness,
                                                parse_reftest_manifest,
                                                summarize)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WINDOW = "x".join(map(str, scenes.GL_SMALL_SIZE))
CPU = ["--device", "cpu", "--window-size", WINDOW]


def _harness_totals(manifest, platform="union", engine="oracle"):
    harness = ReftestHarness(scenes.GL_SMALL_SIZE, engine=engine,
                             device="cpu")
    results = [harness.run_case(c) for c in
               parse_reftest_manifest(manifest, PLATFORM_SETS[platform])]
    return summarize(results), harness.engine_counts


def _run(tmp_path, capsys, *argv):
    out = tmp_path / "reftests.json"
    assert run_reftests.main([*argv, *CPU, "--json", str(out)]) == 0
    return json.loads(out.read_text()), capsys.readouterr().out


@pytest.mark.parametrize("platform", sorted(PLATFORM_SETS))
def test_runner_totals_equal_the_harness(tmp_path, capsys, platform):
    from webrender_tpu.wrench import reftest as jax_reftest
    report, printed = _run(tmp_path, capsys, "--engine", "oracle",
                           "--manifest", str(scenes.GL_MANIFEST),
                           "--platform", platform)
    (p, f, s), _ = _harness_totals(scenes.GL_MANIFEST, platform)
    jax_harness = jax_reftest.ReftestHarness(scenes.GL_SMALL_SIZE,
                                             engine="oracle")
    jax_totals = jax_reftest.summarize(
        [jax_harness.run_case(c) for c in jax_reftest.parse_reftest_manifest(
            scenes.GL_MANIFEST, jax_reftest.PLATFORM_SETS[platform])])
    assert (p, f, s) == jax_totals
    assert report["total"] == {"pass": p, "fail": f, "skip": s}
    assert p + s == 10 and f == 0
    (suite,) = report["suites"]
    assert suite["suite"] == "wrench" and suite["failures"] == []
    assert sum(suite["skip_reasons"].values()) == s
    assert printed.splitlines()[-1].split() == [
        "TOTAL", f"pass={p}", f"fail={f}", f"skip={s}"]


def _json_keys_of(path):
    """The string keys of the dict literals in `path`'s main()."""
    tree = ast.parse(path.read_text())
    (main,) = [n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == "main"]
    return {k.value for n in ast.walk(main) if isinstance(n, ast.Dict)
            for k in n.keys if isinstance(k, ast.Constant)}


def _keys_of(value):
    if isinstance(value, dict):
        return set(value).union(*(_keys_of(v) for k, v in value.items()
                                  if k not in ("skip_reasons",
                                               "engine_mix")))
    if isinstance(value, list):
        return set().union(*(_keys_of(v) for v in value))
    return set()


def test_runner_json_has_the_keys_of_run_reftests_py(tmp_path, capsys):
    manifest = tmp_path / "reftest.list"
    manifest.write_text(
        f"!= {scenes.WRENCH / 'gl-rects.json'} "
        f"{scenes.WRENCH / 'gl-rects.json'}\n"
        f"platform(mac) == {scenes.WRENCH / 'gl-rects.json'} "
        f"{scenes.WRENCH / 'gl-rects.json'}\n")
    report, printed = _run(tmp_path, capsys, "--engine", "oracle",
                           "--manifest", str(manifest), "-v")
    assert _keys_of(report) == _json_keys_of(ROOT / "run_reftests.py")
    assert report["total"] == {"pass": 0, "fail": 1, "skip": 1}
    (suite,) = report["suites"]
    assert suite["skip_reasons"] == {"platform(mac)": 1}
    assert suite["failures"][0]["line"].startswith("!= ")
    assert "   FAIL != " in printed


def test_runner_device_engine_counts_the_plain_version(tmp_path, capsys):
    manifest = tmp_path / "reftest.list"
    doc = scenes.WRENCH / "gl-rects.json"
    manifest.write_text(f"platform(linux) == {doc} {doc}\n")
    report, printed = _run(tmp_path, capsys, "--engine", "device",
                           "--manifest", str(manifest))
    (p, f, s), counts = _harness_totals(manifest, engine="device")
    assert report["total"] == {"pass": p, "fail": f, "skip": s} == \
        {"pass": 1, "fail": 0, "skip": 0}
    assert report["engine_mix"] == counts == {"plain": 2}
    assert "engine mix: {'plain': 2}" in printed


def test_runners_default_to_the_device_engine(tmp_path, capsys):
    """With no --engine each runner renders through the renderer: on the
    CPU every dispatch is a counted call of the kernel's plain version."""
    manifest = tmp_path / "reftest.list"
    doc = scenes.WRENCH / "gl-rects.json"
    manifest.write_text(f"platform(linux) == {doc} {doc}\n")
    before = LaunchCounts.plain_calls
    report, printed = _run(tmp_path, capsys, "--manifest", str(manifest))
    assert report["engine"] == "device"
    assert report["total"] == {"pass": 1, "fail": 0, "skip": 0}
    assert report["engine_mix"] == {"plain": 2}
    assert LaunchCounts.plain_calls - before == 2
    before = LaunchCounts.plain_calls
    assert run_case.main([f"--manifest={manifest}", "--device=cpu",
                          f"--window-size={WINDOW}"]) == 0
    assert capsys.readouterr().out.startswith("PASS ")
    assert LaunchCounts.plain_calls - before == 2


def test_runners_refuse_a_missing_manifest(tmp_path, capsys):
    missing = tmp_path / "no-such" / "reftest.list"
    out = tmp_path / "reftests.json"
    with pytest.raises(SystemExit) as exc:
        run_reftests.main(["--manifest", str(missing), *CPU,
                           "--json", str(out)])
    assert exc.value.code == 2
    with pytest.raises(SystemExit) as exc:
        run_case.main([f"--manifest={missing}", "--device=cpu"])
    assert exc.value.code == 2
    with pytest.raises(SystemExit) as exc:
        run_case.main(["no-such", f"--base={tmp_path}", "--device=cpu"])
    assert exc.value.code == 2
    captured = capsys.readouterr()
    assert captured.err.count("no manifest at") == 3
    assert "TOTAL" not in captured.out and not out.exists()


def _selected(subs):
    """tools/run_case.py's selection over the port's manifest."""
    return [c.line for c in parse_reftest_manifest(scenes.GL_MANIFEST)
            if not subs or any(s in c.line for s in subs)]


@pytest.mark.parametrize("subs", [["gl-masks"], ["!=", "gl-filters"]])
def test_run_case_selects_by_substring(capsys, subs):
    rc = run_case.main([f"--manifest={scenes.GL_MANIFEST}", *subs,
                        "--engine=oracle", "--device=cpu",
                        f"--window-size={WINDOW}"])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert [ln.split(" | ")[0] for ln in lines] == \
        [f"PASS {line[:100]}" for line in _selected(subs)]
    assert len(lines) >= 2


def test_run_case_exits_1_on_a_failure(tmp_path, capsys):
    (tmp_path / "shadows").mkdir()
    a, b = scenes.WRENCH / "gl-rects.json", scenes.WRENCH / "gl-shadows.json"
    (tmp_path / "shadows" / "reftest.list").write_text(
        f"== {a} {b}\n== {b} {b}\n")
    rc = run_case.main(["shadows", "--engine=oracle", "--device=cpu",
                        f"--base={tmp_path}", f"--window-size={WINDOW}"])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 1
    assert [ln.split()[0] for ln in lines] == ["FAIL", "PASS"]


def test_runners_without_cuda_fail(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal is not reachable")
    out = tmp_path / "reftests.json"
    assert run_reftests.main(["--manifest", str(scenes.GL_MANIFEST),
                              "--json", str(out)]) == 2
    assert run_case.main([f"--manifest={scenes.GL_MANIFEST}"]) == 2
    assert not out.exists()
    assert "CUDA is not available" in capsys.readouterr().err
