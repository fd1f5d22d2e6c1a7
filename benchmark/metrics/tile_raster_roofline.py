"""The least time one H100 needs for the traced frames' work
(`workcount.py`, from the benchmark's own page and what each frame
changed) over the device's busy time in those frames (every kernel, copy
and memset the trace shows, as their union), in percent.  Nothing where
the trace shows no device work."""


def read(run):
    t = run.trace
    if t is None or run.least_s is None or t.busy_s <= 0:
        return None
    return 100.0 * run.least_s / t.busy_s
