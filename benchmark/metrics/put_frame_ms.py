"""Host ms a frame in `Renderer._put_frame` (the frame's arrays into the
delta mirrors, the changed-instance mask, the dense kinds): the program's
`render.put_frame` span, the mean over the window's frames
(`program_trace.py`)."""
import program_trace


def read(run):
    return program_trace.span_ms(run, "render.put_frame")
