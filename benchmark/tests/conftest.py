"""Shared set-up of the benchmark's own tests: the benchmark's folder and
the repository root on the import path, the `cuda` marker, and the cells
cut to a window that a CPU run can hold.

Run from the repository root: `python -m pytest benchmark/tests -q`.
"""
import copy
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")


def small_config(cfg: dict) -> dict:
    """`cfg` on a 300x150 window: the same page, kinds and grid, at most
    24 canvases, none larger than the stage."""
    c = copy.deepcopy(cfg)
    w, h = 300, 150
    c["window"] = [w, h]
    c["stage"] = [0, 0, w, h]
    cv = c["canvases"]
    cv["count"] = min(cv["count"], 24)
    cv["width"], cv["height"] = min(cv["width"], w), min(cv["height"], h)
    c["icons"].update(width=cv["width"], height=cv["height"])
    return c


def cut(cell):
    """`cell` at `small_config`'s size, with two warm-up frames."""
    cell.config = small_config(cell.config)
    cell.mix = dict(cell.mix, warmup_frames=2, trace_frames=2,
                    batch_frames=3)
    return cell


@pytest.fixture
def small_cell():
    """A workload of `BENCHMARK.json` cut to `small_config`."""
    import harness
    return lambda workload: cut(harness.resolve(workload))


def workloads():
    import harness
    return [w["name"] for w in harness.load_benchmark()["workloads"]]
