"""The harness finds a cell added as files alone (a configuration, a
page, a mix with a new kind of operation, a new kind of item, a metric
and its limits) and runs it, its page's cut and its control; each cell
reports the per-layer metrics `BENCHMARK.json` assigns it; its result
line has the keys its readers expect; and it prints no result without a
card or without the program."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import harness
from conftest import (ADDED, ADDED_METRIC, ADDED_REPORTS, BENCH, ROOT,
                      cells, cut, small_config, workloads)

NEW_PAGE = '''
import numpy as np
from scene import Item, State

def init(config, rng):
    w, h = config["window"]
    px = np.zeros((8, 8, 4), np.uint8)
    px[..., 1] = px[..., 3] = 200
    return State((w, h), [Item("rect", (0, 0, w, h), (1, 1, 1, 1)),
                          Item("frame", (4, 4, 20, 12), (0.2, 0.4, 0.6, 1)),
                          Item("image", (30, 10, 38, 18), key=5)],
                 {5: px}, {"x": 4})
'''
NEW_KIND = '''
from scene import Change

def step(state, op, config, rng):
    frame = state.items[1]
    x0, y0, x1, y1 = frame.rect
    before = frame.rect
    dx = op["step"]
    frame.rect = (x0 + dx, y0, x1 + dx, y1)
    state.images[5][..., 0] = (state.images[5][..., 0].astype(int) + 7) % 200
    return Change(display_list=True, images=[5], damage=[before, frame.rect])
'''
NEW_ITEM = '''
import numpy as np
OPS = 75

def push(A, b, common, item):
    x0, y0, x1, y1 = item.rect
    b.push_rect(common, A.Rect(x0, y0, x1 - x0, y1 - y0), A.ColorF(*item.color))

def source(item, state, quantize):
    x0, y0, x1, y1 = item.rect
    c = np.asarray(quantize(np.asarray(item.color, np.float32)), np.float32)
    premul = np.concatenate([c[:3] * c[3], c[3:]]).astype(np.float32)
    px = np.clip(np.rint(premul * np.float32(255.0)), 0, 255)
    return np.broadcast_to(px.astype(np.int32), (y1 - y0, x1 - x0, 4))
'''


def test_cell_added_as_files_is_found_and_runs(tmp_path):
    home = tmp_path / "benchmark"
    shutil.copytree(BENCH, home, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (home / "configs" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "page": "two_things", "window": [64, 32],
         "picture_caching": True}))
    (home / "pages" / "two_things.py").write_text(NEW_PAGE)
    (home / "kinds" / "slide.py").write_text(NEW_KIND)
    (home / "items" / "frame.py").write_text(NEW_ITEM)
    (home / "traffic" / "slide.json").write_text(json.dumps(
        {"ops": [{"kind": "slide", "every": 2, "step": 1}],
         "warmup_frames": 1, "trace_frames": 1, "batch_frames": 2}))
    (home / "metrics" / "frames_seen.py").write_text(
        "def read(run):\n    return float(run.frames)\n")
    (home / "limits" / "tiny.slide.json").write_text(
        json.dumps({"pixels_off": 0, "max_step": 0}))
    bench["configs"].append({"name": "tiny", "source": "https://example.org",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.slide", "config": "tiny",
                               "traffic": "slide", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "frame build",
                               "moves": "frame_ms_p95",
                               "workloads": ["tiny.slide"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.resolve("tiny.slide", root=tmp_path)
    assert cell.home == home
    assert cell.config["page"] == "two_things"
    assert "frames_seen" in [m["name"] for m in cell.per_layer]
    read = harness.load_reader("frames_seen", cell.home)
    assert read(harness.Run(frames=3)) == 3.0
    # a metric with a `workloads` key is not asked of other cells
    other = harness.resolve(workloads()[0])
    assert "frames_seen" not in [m["name"] for m in other.per_layer]
    # the new cell runs end to end on the program and the reference
    res = harness.run_cell(cell, 2 ** 33 + 1, 0.05, False, device="cpu")
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 2


def assigned(bench: dict, workload: str) -> set:
    """The per-layer metrics that `bench` assigns `workload`: those whose
    `workloads` list names it, and those without a list whose `moves` is
    one of its end-to-end metrics."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]}
    return {m["name"] for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)}


def test_every_cell_resolves_with_its_metrics():
    bench = harness.load_benchmark()
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"frame_ms_p95", "peak_mem_mib", "setup_s"} <= e2e
    assert "window_frame_ms" in {m["name"] for m in bench["per_layer"]}
    for w in bench["workloads"]:
        cell = harness.resolve(w["name"])
        names = {m["name"] for m in cell.per_layer}
        assert names == assigned(bench, w["name"])
        for m in cell.per_layer:
            assert callable(harness.load_reader(m["name"], cell.home))
        assert set(cell.limits) == {"pixels_off", "max_step"}


def test_page_added_as_files_is_cut_run_and_controlled(added_root):
    """A page with `small`, an item kind with `params` and `area` under a
    reference frame of its own, and a metric for its cell alone: the cut,
    a run on the CPU at limits 0, and the control all work on it."""
    import control
    bench = harness.load_benchmark(added_root)
    cell = harness.resolve(ADDED, root=added_root)
    assert cell.home == added_root / "benchmark"
    assert {m["name"] for m in cell.per_layer} == \
        assigned(bench, ADDED) == {ADDED_METRIC, *ADDED_REPORTS}
    for other in workloads():
        for root in (ROOT, added_root):
            names = {m["name"] for m in harness.resolve(other, root).per_layer}
            assert ADDED_METRIC not in names
            assert names == assigned(harness.load_benchmark(root), other)
    full = cell.config
    cut(cell)
    assert cell.config["window"] == [48, 32] != full["window"]
    assert full["tiles"]["count"] == 12     # the cut copies, never edits
    seed = 2 ** 31 + 4321
    res = harness.run_cell(cell, seed, 0.05, False, device="cpu")
    assert res["correct"] is True, res["checks"]
    assert {c["value"] for c in res["checks"].values()} == {0}
    assert {c["limit"] for c in res["checks"].values()} == {0}
    assert res["attempted"] >= 3 and res["failed"] == 0
    for _, got in control.readings(cell, seed, 1):
        assert all(v > cell.limits[n] for n, v in got.items()), got


def test_a_page_without_small_is_named(tmp_path):
    (tmp_path / "pages").mkdir()
    (tmp_path / "pages" / "bare.py").write_text(
        "def init(config, rng):\n    raise NotImplementedError\n")
    with pytest.raises(pytest.fail.Exception, match="'bare'"):
        small_config({"page": "bare", "window": [8, 8]}, tmp_path)


@pytest.mark.parametrize("workload", cells())
def test_result_line_keys(small_cell, workload):
    cell = small_cell(workload)
    res = harness.run_cell(cell, 2 ** 31 + 12345, 0.05, False, device="cpu")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert {"frame_ms_p95", "setup_s"} <= set(res["metrics"])
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_window_clock_counts_time_between_frames(monkeypatch):
    """`window_frame_ms` is the window's clock over the frames: time the
    program spends after one frame's present and before the next counts,
    the client's making of the frames does not."""
    import time
    cell = cut(harness.resolve(workloads()[0]))
    frame, make = harness.Program.frame, harness.Program.make_frames
    latencies = []
    runs = []

    class KeptRun(harness.Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runs.append(self)

    def slow_between(self, txn, spans=None):
        out = frame(self, txn, spans)
        if spans is not None:
            latencies.append(out[0])
        time.sleep(0.05)         # after the present: outside the latency
        return out

    def slow_client(self, n, *args, **kwargs):
        time.sleep(0.3)
        return make(self, n, *args, **kwargs)
    monkeypatch.setattr(harness.Program, "frame", slow_between)
    monkeypatch.setattr(harness.Program, "make_frames", slow_client)
    monkeypatch.setattr(harness, "Run", KeptRun)
    res = harness.run_cell(cell, 5, 0.3, False, device="cpu")
    assert res["correct"] is True
    mean_ms = 1e3 * sum(latencies) / len(latencies)
    frame_ms = harness.load_reader("window_frame_ms", cell.home)(runs[0])
    assert runs[0].frames == len(latencies)
    assert mean_ms + 45 <= frame_ms <= mean_ms + 80


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workloads()[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **(env or {})))


def test_no_card_no_result():
    res = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert res.stdout == ""


def test_no_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0
    assert res.stdout == ""
