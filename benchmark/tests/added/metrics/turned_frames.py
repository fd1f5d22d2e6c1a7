"""The frames the window presented, for the test cell alone."""


def read(run):
    return float(run.frames) if run.frames else None
