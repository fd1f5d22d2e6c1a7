"""Host ms a frame in `RenderBackend.apply_resource_updates` (the
transaction's image and font updates): the program's `txn.resource_updates`
span, the mean over the window's frames (`program_trace.py`)."""
import program_trace


def read(run):
    return program_trace.span_ms(run, "txn.resource_updates")
