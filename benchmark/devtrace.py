"""The device trace of a run's traced frames: torch.profiler over CUDA
activity alone (host ops are not recorded, so the host runs at its own
pace), written as a Chrome trace under TMPDIR, read back and deleted.

From it: the seconds in which any kernel, copy or memset ran (their
union), the traced window's wall seconds, the device time by operation,
and the idle time by what the host was doing.  The host's spans are the
harness's own, placed on the trace's clock by one marker kernel launched
before the frames (`torch.cuda._sleep`), whose launch the trace records
on its host clock.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import tempfile
import time
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_FILE = "benchmark_device_trace.json"
NAME_CHARS = 160


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    frames: int
    ops: Dict[str, float]
    idle_by_span: Dict[str, float]
    events: int = 0
    aligned: bool = False
    categories: Dict[str, int] = dataclasses.field(default_factory=dict)
    last_fb: object = None

    def breakdown(self) -> dict:
        """The ten operations that took the most device time and the idle
        time by host span; an operation's name cut to `NAME_CHARS`."""
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1])[:10]
        ops = [(n if len(n) <= NAME_CHARS else n[:NAME_CHARS - 3] + "...",
                s) for n, s in ops]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals (any unit)."""
    total = 0.0
    end = None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def idle_intervals(busy: List[Tuple[float, float]], lo: float, hi: float):
    """The gaps in [lo, hi] that no busy interval covers."""
    gaps = []
    t = lo
    for s, e in sorted(busy):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]


def attribute(gaps, spans) -> Dict[str, float]:
    """Seconds of each gap that fall into each named host span ((name,
    start, end), on the gaps' clock); the rest is "between spans"."""
    out: Dict[str, float] = {}
    for gs, ge in gaps:
        covered = 0.0
        for name, ss, se in spans:
            ov = min(ge, se) - max(gs, ss)
            if ov > 0:
                out[name] = out.get(name, 0.0) + ov
                covered += ov
        rest = (ge - gs) - covered
        if rest > 1e-9:
            out["between spans"] = out.get("between spans", 0.0) + rest
    return out


def read_trace(path) -> dict:
    return json.loads(pathlib.Path(path).read_text())


def device_events(trace: dict):
    """(name, start us, end us) of every kernel, copy and memset."""
    out = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES:
            ts = float(ev["ts"])
            out.append((ev.get("name", "?"), ts, ts + float(ev["dur"])))
    return out


def is_marker(name: str) -> bool:
    """Whether a kernel is `torch.cuda._sleep`'s (ATen's spin kernel)."""
    return "spin" in name or "sleep" in name


def marker_launch_us(trace: dict) -> Optional[float]:
    """The trace-clock time of the host call that launched the marker
    kernel, or None where the trace does not show it."""
    marker = None
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") == "kernel" and is_marker(ev.get("name", "")):
            marker = ev.get("args", {}).get("correlation")
            break
    if marker is None:
        return None
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") == "cuda_runtime" and \
                ev.get("args", {}).get("correlation") == marker:
            return float(ev["ts"])
    return None


def profile_frames(prog, txns):
    """Profiles the frames of `txns` (transactions the client made ahead).
    Returns the `Summary`, with the last framebuffer."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    n = len(txns)
    path = pathlib.Path(tempfile.gettempdir()) / TRACE_FILE
    host: List[Tuple[str, float, float]] = []
    fb = None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prog.sync()
        t_mark = time.perf_counter()
        torch.cuda._sleep(1000)
        prog.sync()
        t0 = time.perf_counter()
        for txn in txns:
            spans = {s: [] for s in ("txn", "frame_build", "render_host",
                                     "present")}
            ts = time.perf_counter()
            _, fb = prog.frame(txn, spans)
            for name in ("txn", "frame_build", "render_host", "present"):
                te = ts + spans[name][0] / 1e3
                host.append((name, ts, te))
                ts = te
    t1 = time.perf_counter()
    prof.export_chrome_trace(str(path))
    try:
        trace = read_trace(path)
    finally:
        os.unlink(path)
    categories: Dict[str, int] = {}
    for ev in trace.get("traceEvents", []):
        categories[ev.get("cat", "?")] = categories.get(ev.get("cat", "?"),
                                                        0) + 1
    events = device_events(trace)
    marker_us = marker_launch_us(trace)
    events = [e for e in events if not is_marker(e[0])]
    busy_us = [(s, e) for _, s, e in events]
    ops: Dict[str, float] = {}
    for name, s, e in events:
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
    busy_s = union_seconds(busy_us) / 1e6
    window_s = t1 - t0
    idle: Dict[str, float] = {}
    if marker_us is not None:
        # host spans on the trace's clock (us)
        off = marker_us - t_mark * 1e6
        spans_us = [(nm, s * 1e6 + off, e * 1e6 + off) for nm, s, e in host]
        gaps = idle_intervals(busy_us, t0 * 1e6 + off, t1 * 1e6 + off)
        idle = {k: v / 1e6 for k, v in attribute(gaps, spans_us).items()}
    else:
        idle = {"unattributed (no marker in the trace)":
                max(window_s - busy_s, 0.0)}
    summary = Summary(busy_s=busy_s, window_s=window_s, frames=n, ops=ops,
                      idle_by_span=idle, events=len(events),
                      aligned=marker_us is not None, categories=categories,
                      last_fb=fb)
    return summary
