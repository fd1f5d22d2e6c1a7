"""Host ms a frame in `Renderer.apply_uploads` (each pending texel
upload's conversion, copy to the device and upload-log entry): the
program's `render.uploads` span, the mean over the window's frames
(`program_trace.py`)."""
import program_trace


def read(run):
    return program_trace.span_ms(run, "render.uploads")
