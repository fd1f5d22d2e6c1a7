"""Clip records the frame build wrote a frame (`_serialize_clips`, on a
miss of its cache of chains): the program's `clip_rows` counter, the
mean over the window's frames (`program_trace.py`); nothing where the
program records no such counter."""
import program_trace

NAME = "clip_rows"


def read(run):
    frames = program_trace.window_frames(run)
    if frames is None or not any(NAME in f.counts for f in frames):
        return None
    return program_trace.count_mean(run, NAME)
