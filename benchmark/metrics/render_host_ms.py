"""Host ms a frame in `Renderer.render_device` until it returns (uploads,
the picture cache and texel check, the delta mirrors, the dense records,
the launches): the mean over the window's frames of the harness's span
around the call."""


def read(run):
    spans = run.spans.get("render_host") or []
    return sum(spans) / len(spans) if spans else None
