"""Host ms a frame that the renderer waits for the device inside
`render_device` (the delta mirrors' staging event, the per-pass
synchronise of GPU time queries): the program's `render.wait` spans, the
mean over the window's frames (`program_trace.py`)."""
import program_trace


def read(run):
    return program_trace.span_ms(run, "render.wait")
