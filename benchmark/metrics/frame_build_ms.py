"""Host ms a frame in `RenderBackend.build_frame` (the frame build, or its
retention): the mean over the window's frames of the harness's span
around the call."""


def read(run):
    spans = run.spans.get("frame_build") or []
    return sum(spans) / len(spans) if spans else None
