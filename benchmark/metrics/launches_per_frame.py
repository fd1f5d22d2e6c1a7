"""Tile-raster kernel launches a frame: the program's `LaunchCounts`,
summed over the kernel's instantiations, over the window's frames."""


def read(run):
    return run.launches / run.frames if run.frames else None
