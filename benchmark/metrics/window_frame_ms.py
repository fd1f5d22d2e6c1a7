"""Host ms a frame over the whole window: the window's clock (each batch
of the client's frames timed back to back, so the program's time between
two frames counts) over the frames presented."""


def read(run):
    return run.clock / run.frames * 1e3 if run.frames else None
