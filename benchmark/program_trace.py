"""The program's own frame records, for the per-layer metrics read from
inside the port: `webrender_tpu_torch.util.profiler.frames()`, the spans
and counters of each frame `Renderer.render_device` ended.

The window's frames are the `run.frames` frames before the last
`run.trace.frames` (the traced frames, none without a trace).  The
recorder keeps only its last frames (`RING_FRAMES`); where it holds fewer
than the window had, the window frames it still holds are read.  Nothing
where the program has no recorder or the ring holds none of the window's
frames.
"""
from __future__ import annotations

from typing import List, Optional


def window_frames(run) -> Optional[List]:
    """The window's frames the program recorded, oldest first, or None."""
    try:
        from webrender_tpu_torch.util import profiler
    except ImportError:
        return None
    read = getattr(profiler, "frames", None)
    if read is None or run.frames <= 0:
        return None
    frames = read()
    traced = run.trace.frames if run.trace is not None else 0
    end = len(frames) - traced
    window = frames[max(0, end - run.frames):max(0, end)]
    return window or None


def span_ms(run, name: str) -> Optional[float]:
    """Milliseconds a frame in the spans named `name`, the mean over the
    window's frames; a frame without such a span counts 0."""
    frames = window_frames(run)
    if frames is None:
        return None
    return sum(f.ms(name) for f in frames) / len(frames)


def count_mean(run, name: str) -> Optional[float]:
    """The counter `name` a frame, the mean over the window's frames."""
    frames = window_frames(run)
    if frames is None:
        return None
    return sum(f.counts.get(name, 0) for f in frames) / len(frames)


def count_ratio(run, num: str, den: str) -> Optional[float]:
    """Counter `num` over counter `den`, each summed over the window's
    frames; nothing where `den` sums to 0."""
    frames = window_frames(run)
    if frames is None:
        return None
    d = sum(f.counts.get(den, 0) for f in frames)
    return sum(f.counts.get(num, 0) for f in frames) / d if d else None
