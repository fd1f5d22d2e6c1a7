"""Host ms a frame in the renderer's kernel dispatches (`_dispatch`: the
kernel's arguments, the dense records and the launch): the program's
`render.dispatch` spans, the mean over the window's frames
(`program_trace.py`)."""
import program_trace


def read(run):
    return program_trace.span_ms(run, "render.dispatch")
