"""Perf harness — `wrench perf` / `compare_perf` (wrench/src/perf.rs:162-283).

Renders each scene from a benchmark manifest N times, collects profiler
counters + wall-clock, writes JSON; `compare_perf` diffs two result files.
Works against the reference's own `wrench/benchmarks/benchmarks.list`.

The port's copy of `webrender_tpu/wrench/perf.py`, over the port's
`RenderBackend` on `device` (the card by default).  A device render is
timed with CUDA events around it, read after the device is synchronised
(the host clock on the CPU).  `python -m webrender_tpu_torch.wrench.perf`
runs the port's own manifest (`testdata/wrench/perf-4k.list`: the
3840x2160 GL page and the small GL documents) at 3840x2160.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..render_backend import RenderBackend
from .yaml_reader import YamlFrameReader

WARMUP_FRAMES = 2
SAMPLE_FRAMES = 10


def run_scene(path: Path, window_size=(1024, 768), engine="device",
              samples: int = SAMPLE_FRAMES, device="cuda") -> Dict:
    backend = RenderBackend(window_size, device=device)
    reader = YamlFrameReader(path, window_size)
    reader.build(backend)
    frame = backend.build_frame()
    cuda = backend.renderer.device.type == "cuda" and engine == "device"

    def render_once():
        if engine == "device":
            backend.renderer.render_device(frame, backend.resources)
        else:
            backend.render_software()

    def timed_ms():
        if not cuda:
            t0 = time.perf_counter()
            render_once()
            return (time.perf_counter() - t0) * 1000.0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        render_once()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    for _ in range(WARMUP_FRAMES):
        render_once()
    if cuda:
        torch.cuda.synchronize(backend.renderer.device)
    times = [timed_ms() for _ in range(samples)]
    times.sort()
    stats = backend.profiler
    return {
        "scene": path.name,
        "min_ms": round(times[0], 3),
        "p50_ms": round(times[len(times) // 2], 3),
        "max_ms": round(times[-1], 3),
        "frame_build_ms": round(
            (stats.stats("frame_build_time") or (0, 0, 0))[1], 3),
        "scene_build_ms": round(
            (stats.stats("scene_build_time") or (0, 0, 0))[1], 3),
        "passes": int((stats.stats("raster_passes") or (0, 0, 0))[1]),
        "instances": int((stats.stats("instances") or (0, 0, 0))[1]),
    }


def run_benchmarks(manifest: Path, out_json: Optional[str] = None,
                   engine: str = "device", window_size=(1024, 768),
                   device="cuda") -> List[Dict]:
    """perf.rs:162 — manifest lists scene yamls relative to its directory."""
    base = manifest.parent
    results = []
    for line in manifest.read_text().splitlines():
        line = line.split("#")[0].strip()
        if not line:
            continue
        scene = base / line
        if not scene.exists():
            continue
        try:
            results.append(run_scene(scene, window_size, engine,
                                     device=device))
        except Exception as e:  # noqa: BLE001
            results.append({"scene": scene.name, "error": repr(e)})
        print(json.dumps(results[-1]), flush=True)
    if out_json:
        Path(out_json).write_text(json.dumps(results, indent=1))
    return results


def compare_perf(a_json: str, b_json: str) -> str:
    """perf.rs:283 compare_perf: per-scene ratio table."""
    a = {r["scene"]: r for r in json.loads(Path(a_json).read_text())}
    b = {r["scene"]: r for r in json.loads(Path(b_json).read_text())}
    lines = [f"{'scene':32s} {'A p50':>9s} {'B p50':>9s} {'ratio':>7s}"]
    for name in sorted(set(a) | set(b)):
        pa = a.get(name, {}).get("p50_ms")
        pb = b.get(name, {}).get("p50_ms")
        if pa and pb:
            lines.append(f"{name:32s} {pa:9.3f} {pb:9.3f} {pb / pa:7.2f}")
        else:
            lines.append(f"{name:32s} {'-':>9s} {'-':>9s}")
    return "\n".join(lines)


# the port's own manifest, and the window it is rendered at
PERF_MANIFEST = Path(__file__).resolve().parents[1] / "testdata" / \
    "wrench" / "perf-4k.list"
PERF_WINDOW = (3840, 2160)


if __name__ == "__main__":
    import sys
    manifest = Path(sys.argv[1]) if len(sys.argv) > 1 else PERF_MANIFEST
    out = sys.argv[2] if len(sys.argv) > 2 else "perf_results.json"
    run_benchmarks(manifest, out, window_size=PERF_WINDOW)
