"""Runs one cell: the program drives closed-loop frames for the window,
then the harness reads the per-layer metrics and checks the frames it
presented against the plain reference (`reference.py`).

The entry that the window drives is the one a render thread drives: for
each frame the client's transaction goes to
`RenderBackend.send_transaction`, then `RenderBackend.build_frame()`,
then `renderer.render_device(frame, resources)`, then
`torch.cuda.synchronize` (the present).  One frame is in flight.  A
frame's latency runs from the start of its transaction to the present.

The client makes its frames (the page's next state and its transaction)
`batch_frames` at a time, with the window's clock stopped, as a content
process makes them apart from the renderer.  The window's clock runs
through each batch's frames back to back, so whatever the renderer does
between two frames of a batch (freeing, collecting) counts.  The window
closes at the end of the batch that takes its clock past `--seconds`.
`frame_ms_p95` is the 95th percentile of the window's frame latencies;
the per-layer `window_frame_ms` is the window's clock over the frames
presented.

Everything that belongs to one configuration, page, traffic mix, kind
of operation, kind of item or per-layer metric is a file of its own
(`configs/`, `pages/`, `traffic/`, `kinds/`, `items/`, `metrics/`),
found by the names in `BENCHMARK.json` and in those files.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time
from typing import Dict, List, Optional

import numpy as np

import scene
import traffic as traffic_mod

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "webrender_tpu")
COMPARED_SPAN = 8
SPANS = ("txn", "frame_build", "render_host", "present")


@dataclasses.dataclass
class Cell:
    """A workload of `BENCHMARK.json` with its configuration, mix, metrics
    and limits resolved from their files under `home` (the benchmark's
    folder)."""
    name: str
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict
    home: pathlib.Path = HERE


def load_benchmark(root=ROOT) -> dict:
    return json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())


def _reports(metric: dict, workload: str, end_to_end_names) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric["moves"] in end_to_end_names


def resolve(workload: str, root=ROOT) -> Cell:
    """The cell named `workload` in `root`'s `BENCHMARK.json`, from the
    files its names point to: the configuration's `file`,
    `traffic/<traffic>.json`, `metrics/<metric>.py` and
    `limits/<workload>.json`, in the folder of the command's script."""
    root = pathlib.Path(root)
    bench = load_benchmark(root)
    home = (root / bench["command"][-1]).parent
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / cfg["file"]).read_text())
    mix = traffic_mod.load_mix(w["traffic"], home)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    limits = json.loads((home / "limits" / f"{workload}.json").read_text())
    return Cell(workload, config, mix, e2e, layer, limits, home)


def load_reader(name: str, home=HERE):
    """The `read(run)` of metric `name` (`metrics/<name>.py` under
    `home`)."""
    return scene.plugin("metrics", name, home).read


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers: the window's frames
    and its clock (s), per window frame the host spans (ms), the kernel
    launches of the window, and for a traced run the trace summary
    (`devtrace.Summary`) and the least time one H100 needs for the traced
    frames' work (`workcount.py`)."""
    frames: int = 0
    clock: float = 0.0
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    launches: int = 0
    trace: object = None
    least_s: Optional[float] = None


class Program:
    """The program under test: its backend, fed by the client's frames."""

    def __init__(self, cell: Cell, seed: int, device: str):
        import torch
        from webrender_tpu_torch import api as A
        from webrender_tpu_torch.ops.tile_raster import LaunchCounts
        from webrender_tpu_torch.render_backend import RenderBackend
        from webrender_tpu_torch.resources import ResourceCache
        self.torch = torch
        self.A = A
        self.launch_counts = LaunchCounts
        cfg = cell.config
        self.device = torch.device(device)
        self.backend = RenderBackend(tuple(cfg["window"]), device=device,
                                     resources=ResourceCache())
        self.backend.renderer.picture_caching = bool(cfg["picture_caching"])
        self.traffic = traffic_mod.Traffic(cfg, cell.mix, seed, cell.home)
        self.batch = max(1, int(cell.mix.get("batch_frames", 1)))
        self.backend.send_transaction(self.traffic.first_transaction(A))

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def make_frames(self, n: int, keep=(), layouts: bool = False):
        """The client's next `n` frames: (k, transaction, change, state,
        layout), the state copied only for the frame numbers in `keep`,
        the layout (`scene.State.layout`) only with `layouts`."""
        out = []
        for _ in range(n):
            k, change = self.traffic.step()
            txn = self.traffic.transaction(self.A, k, change)
            state = self.traffic.state
            out.append((k, txn, change,
                        state.copy() if k in keep else None,
                        state.layout() if layouts else None))
        return out

    def frame(self, txn, spans=None):
        """One frame: returns (latency s, framebuffer).  `spans`: a dict of
        lists that gets each layer's host ms."""
        be = self.backend
        t0 = time.perf_counter()
        be.send_transaction(txn)
        t1 = time.perf_counter()
        frame = be.build_frame()
        t2 = time.perf_counter()
        fb = be.renderer.render_device(frame, be.resources)
        t3 = time.perf_counter()
        self.sync()
        t4 = time.perf_counter()
        if spans is not None:
            spans["txn"].append((t1 - t0) * 1e3)
            spans["frame_build"].append((t2 - t1) * 1e3)
            spans["render_host"].append((t3 - t2) * 1e3)
            spans["present"].append((t4 - t3) * 1e3)
        return t4 - t0, fb

    def launches(self) -> int:
        return int(sum(self.launch_counts.by_instantiation.values()))


def rgba8(fb) -> np.ndarray:
    """The presented framebuffer [4, h, w] (premultiplied float on the u8
    grid) as the RGBA8 image a present shows (h, w, 4): copied to the
    host, then v * 255 rounded half up."""
    v = fb.detach().float().cpu().numpy().transpose(1, 2, 0)
    v = v.astype(np.float64) * 255.0
    return np.clip(np.floor(np.nan_to_num(v) + 0.5), 0, 255).astype(np.uint8)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def compared_frame(cell: Cell, seed: int) -> int:
    """The frame drawn from the seed among the window's first
    `COMPARED_SPAN` frames that a run compares, besides its last."""
    return cell.mix["warmup_frames"] + 1 + \
        int(scene.seed_rng(seed, 9).integers(0, COMPARED_SPAN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             faults=None, log=None) -> dict:
    """Runs `cell` and returns the result line's object.  `faults`: a
    callable that wraps the program (the fault tests); `log`: a callable
    for progress lines."""
    log = log or (lambda msg: None)
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    prog = Program(cell, seed, device)
    if faults is not None:
        faults(prog)
    warm = cell.mix["warmup_frames"]
    log(f"warming up: {warm} frames")
    for w in prog.make_frames(warm):
        prog.frame(w[1])
    launches0 = prog.launches()

    sampled = compared_frame(cell, seed)
    states = {}         # frame number -> the state it should show
    shown = {}          # frame number -> the RGBA8 image it showed
    spans = {k: [] for k in SPANS}
    latencies: List[float] = []
    attempted = failed = 0
    clock = 0.0
    setup_s = None
    last = None
    log(f"window: {seconds} s, the client's frames {prog.batch} at a time")
    while clock < seconds or attempted == 0:
        batch = prog.make_frames(prog.batch, keep={sampled})
        if setup_s is None:
            setup_s = time.perf_counter() - t_start
        t_batch = time.perf_counter()
        for k, txn, _, snap, _ in batch:
            attempted += 1
            try:
                dt, fb = prog.frame(txn, spans)
            except Exception as exc:  # noqa: BLE001 - counted, then reported
                failed += 1
                log(f"frame {k} raised {type(exc).__name__}: {exc}")
                continue
            latencies.append(dt)
            last = (k, fb)
            if k == sampled:
                shown[k], states[k] = rgba8(fb), snap
        clock += time.perf_counter() - t_batch
        del batch
    # the window ends with a whole batch, so the client's state is the
    # last frame's
    if last is not None and last[0] == prog.traffic.k:
        shown[last[0]] = rgba8(last[1])
        states[last[0]] = prog.traffic.state.copy()
    frames = len(latencies)
    run = Run(frames=frames, clock=clock, spans=spans,
              launches=prog.launches() - launches0)
    e2e = {
        "frame_ms_p95": float(np.percentile(np.asarray(latencies), 95))
        * 1e3 if latencies else None,
        "setup_s": setup_s,
    }
    peak_bytes = int(torch.cuda.max_memory_allocated(prog.device)) \
        if prog.device.type == "cuda" else None
    e2e["peak_mem_mib"] = None if peak_bytes is None else \
        peak_bytes / 2.0 ** 20
    log(f"window: {frames} frames in {clock:.3f} s, {failed} failed, "
        f"{clock / max(frames, 1) * 1e3:.3f} ms a frame")

    device_info = _device_info(prog, peak_bytes)
    breakdown = None
    if trace:
        import devtrace
        import workcount
        n = cell.mix["trace_frames"]
        log(f"traced frames: {n}")
        work = prog.make_frames(n, layouts=True)
        summary = devtrace.profile_frames(prog, [w[1] for w in work])
        run.trace = summary
        log(f"trace: {summary.events} device events, busy "
            f"{summary.busy_s:.6f} s of {summary.window_s:.6f} s, host "
            f"spans {'on' if summary.aligned else 'not on'} its clock; "
            f"events by category {summary.categories}")
        run.least_s = workcount.least_seconds(
            [(w[4], w[2]) for w in work], cell.home)
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        breakdown = summary.breakdown()
        k_last = work[-1][0]
        shown[k_last] = rgba8(summary.last_fb)
        states[k_last] = prog.traffic.state.copy()
        summary.last_fb = None
        del work

    # the program's state goes before the reference runs
    del prog, last
    if device != "cpu":
        torch.cuda.empty_cache()

    import refcheck
    checks = refcheck.compare(cell, shown, states, log=log)
    correct = failed == 0 and frames > 0 and \
        all(c["value"] <= c["limit"] for c in checks.values())

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"], cell.home)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end
                   if e2e.get(m["name"]) is not None}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _device_info(prog, peak_bytes) -> dict:
    torch = prog.torch
    if prog.device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(prog.device),
                "count": 1, "memory_peak_bytes": peak_bytes}
    return {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": peak_bytes}
