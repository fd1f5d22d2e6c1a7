"""Host ms a frame in the scene build of a new display list
(`build_scene` in `RenderBackend.rebuild_scene`): the program's
`txn.scene_build` span, the mean over the window's frames
(`program_trace.py`)."""
import program_trace


def read(run):
    return program_trace.span_ms(run, "txn.scene_build")
