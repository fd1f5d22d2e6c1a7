"""Host ms a frame in the picture cache's checks: the frame and surface
signatures and each cached grid's or slice's dirty test (hashes, picture
tiles, the texel check): the program's `render.picture_cache` spans, the
mean over the window's frames (`program_trace.py`)."""
import program_trace


def read(run):
    return program_trace.span_ms(run, "render.picture_cache")
