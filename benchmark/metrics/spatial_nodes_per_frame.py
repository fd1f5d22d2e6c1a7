"""Spatial nodes the frame build resolved a frame (the root reference
frame, the root scroll node and every frame and scroll node the list
defined): the program's `spatial_nodes` counter, the mean over the
window's frames (`program_trace.py`); nothing where the program records
no such counter."""
import program_trace

NAME = "spatial_nodes"


def read(run):
    frames = program_trace.window_frames(run)
    if frames is None or not any(NAME in f.counts for f in frames):
        return None
    return program_trace.count_mean(run, NAME)
