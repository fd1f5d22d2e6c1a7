"""The share of the traced frames' wall time in which no kernel, copy or
memset ran on the device (torch.profiler's trace): 100 (1 - busy / wall)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
