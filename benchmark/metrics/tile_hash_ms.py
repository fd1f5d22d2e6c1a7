"""Host ms a frame in the frame build's per-tile content hashes
(`_compute_tile_hashes`): the program's `frame.tile_hashes` span, the
mean over the window's frames (`program_trace.py`)."""
import program_trace


def read(run):
    return program_trace.span_ms(run, "frame.tile_hashes")
