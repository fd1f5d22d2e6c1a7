"""Shared set-up of the benchmark's own tests: the benchmark's folder and
the repository root on the import path, the `cuda` marker, the cells cut
by their pages to a size that a CPU run can hold, and a checkout whose
benchmark holds one cell more, added as files alone (`added/`).

Run from the repository root: `python -m pytest benchmark/tests -q`.
"""
import json
import pathlib
import shutil
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# The cell that `add_as_files` adds: a page of tiles turned under
# reference frames of their own (`added/`), and the metric it alone
# reports.
ADDED = "quarter_tiles.turn"
ADDED_METRIC = "turned_frames"
# the per-layer metrics of `BENCHMARK.json` that the added cell reports too
ADDED_REPORTS = ("txn_ms", "frame_build_ms", "render_host_ms",
                 "launches_per_frame", "tile_raster_roofline",
                 "device_idle_pct")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")


def small_config(cfg: dict, home=BENCH) -> dict:
    """`cfg` cut by its page's `small(config)` (`pages/<page>.py` under
    `home`) to a size a CPU run can hold."""
    import scene
    page = scene.plugin("pages", cfg["page"], home)
    if not hasattr(page, "small"):
        pytest.fail(f"page {cfg['page']!r} defines no small(config), so "
                    "its cells cannot be cut for a test on the CPU",
                    pytrace=False)
    return page.small(cfg)


def cut(cell):
    """`cell` at its page's small size, with two warm-up frames."""
    cell.config = small_config(cell.config, cell.home)
    cell.mix = dict(cell.mix, warmup_frames=2, trace_frames=2,
                    batch_frames=3)
    return cell


def add_as_files(root) -> pathlib.Path:
    """A checkout at `root` of this benchmark with the cell `ADDED` added
    as files alone: the files under `added/` (a configuration, a page
    with `small`, an item kind with `params` and `area`, a kind of
    operation, a mix, a metric and limits) and, in `BENCHMARK.json`, the
    configuration, the cell, its metric and the cell in the `workloads`
    lists of the metrics it reports."""
    root = pathlib.Path(root)
    home = root / "benchmark"
    skip = shutil.ignore_patterns("__pycache__", "tests")
    shutil.copytree(BENCH, home, ignore=skip)
    shutil.copytree(HERE / "added", home, ignore=skip, dirs_exist_ok=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "quarter_tiles", "source": "https://example.org/tiles",
        "file": "benchmark/configs/quarter_tiles.json", "reduced": [],
        "why": "tiles turned under reference frames of their own"})
    bench["workloads"].append({
        "name": ADDED, "config": "quarter_tiles", "traffic": "turn",
        "chips": 1, "why": "every tile turned and recoloured each frame"})
    for m in bench["per_layer"]:
        if m["name"] in ADDED_REPORTS:
            m["workloads"].append(ADDED)
    bench["per_layer"].append({
        "name": ADDED_METRIC, "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "frame build",
        "moves": "frame_ms_p95", "workloads": [ADDED]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="session")
def added_root(tmp_path_factory):
    """A checkout whose benchmark holds the cell `ADDED` (`add_as_files`)."""
    return add_as_files(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def root_of(added_root):
    """The checkout whose `BENCHMARK.json` names a workload of `cells()`."""
    return lambda workload: added_root if workload == ADDED else ROOT


@pytest.fixture
def small_cell(root_of):
    """A workload of `cells()` cut to its page's small size."""
    import harness
    return lambda workload: cut(harness.resolve(workload,
                                                root=root_of(workload)))


def workloads():
    import harness
    return [w["name"] for w in harness.load_benchmark()["workloads"]]


def cells():
    """The workloads of `BENCHMARK.json` and the cell `ADDED`."""
    return workloads() + [ADDED]
