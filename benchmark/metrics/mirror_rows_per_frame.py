"""Rows the renderer's delta mirrors copy to the device a frame (changed
rows, or every row of a mirror copied whole): the program's `mirror_rows`
counter, the mean over the window's frames (`program_trace.py`)."""
import program_trace


def read(run):
    return program_trace.count_mean(run, "mirror_rows")
