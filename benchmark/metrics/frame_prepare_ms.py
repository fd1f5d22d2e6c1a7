"""Host ms a frame in the frame build's walk of the root picture
(visibility, clips, primitive prepare, image requests): the program's
`frame.prepare` span, the mean over the window's frames
(`program_trace.py`)."""
import program_trace


def read(run):
    return program_trace.span_ms(run, "frame.prepare")
