"""Host ms a frame in the frame build's retention checks
(`_frame_inputs_key`, `_resolved_signature`, before the build and in the
snapshot after it): the program's `frame.retention` spans, the mean over
the window's frames (`program_trace.py`)."""
import program_trace


def read(run):
    return program_trace.span_ms(run, "frame.retention")
