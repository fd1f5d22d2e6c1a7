"""Host-to-device texel copies `Renderer.apply_uploads` makes a frame:
the program's `uploads` counter, the mean over the window's frames
(`program_trace.py`)."""
import program_trace


def read(run):
    return program_trace.count_mean(run, "uploads")
