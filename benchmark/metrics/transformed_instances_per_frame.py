"""Instances the frame build emitted a frame under a spatial node that is
not 2D axis-aligned (palette flag 4, the kernel's transformed path): the
program's `transformed_instances` counter, the mean over the window's
frames (`program_trace.py`); nothing where the program records no such
counter."""
import program_trace

NAME = "transformed_instances"


def read(run):
    frames = program_trace.window_frames(run)
    if frames is None or not any(NAME in f.counts for f in frames):
        return None
    return program_trace.count_mean(run, NAME)
