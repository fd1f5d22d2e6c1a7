"""MiB a frame that `Renderer.apply_uploads`'s texel copies send to the
device (float32 texels): the program's `upload_bytes` counter, the mean
over the window's frames (`program_trace.py`)."""
import program_trace


def read(run):
    n = program_trace.count_mean(run, "upload_bytes")
    return None if n is None else n / 2.0 ** 20
