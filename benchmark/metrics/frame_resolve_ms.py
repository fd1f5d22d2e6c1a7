"""Host ms a frame in the frame build's spatial-tree resolve, transform
palette and homographies: the program's `frame.resolve` span, the mean
over the window's frames (`program_trace.py`)."""
import program_trace


def read(run):
    return program_trace.span_ms(run, "frame.resolve")
