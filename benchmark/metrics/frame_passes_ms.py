"""Host ms a frame in the frame build's root passes, GPU buffer finish and
bounding boxes: the program's `frame.passes` span, the mean over the
window's frames (`program_trace.py`)."""
import program_trace


def read(run):
    return program_trace.span_ms(run, "frame.passes")
