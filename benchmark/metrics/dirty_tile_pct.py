"""The share of the cached grids' and slices' tiles that the renderer
rasters again: 100 times the program's `tiles_dirty` over its
`tiles_held`, each summed over the window's frames (`program_trace.py`);
nothing where no frame held a cached tile."""
import program_trace


def read(run):
    r = program_trace.count_ratio(run, "tiles_dirty", "tiles_held")
    return None if r is None else 100.0 * r
