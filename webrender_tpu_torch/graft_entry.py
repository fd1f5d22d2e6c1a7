"""Driver entries of the port: the production raster step and the
multi-device dry run.

The counterpart of the JAX package's `__graft_entry__.py`.  `entry()`
(`__graft_entry__.py:82-119` there) returns the tile-raster kernel and its
arguments on the graft test frame: 64 overlapping solid and gradient rects
and a rounded clip at 512x256 (`scenes.graft_test_scene`, the display list
of `_build_test_frame`), built through the port's display list, scene and
frame builders and put on `device` by the renderer, as a render puts them
(`scenes.kernel_inputs`, `Renderer.kernel_args`).  On the card
`fn(*example_args)` launches the hand-written CUDA kernel
(`csrc/tile_raster.cu`); on the CPU it runs the kernel's plain PyTorch
version.  The records' clip kinds, color-matrix flags and general flags
are checked once, in `entry()`, as the renderer checks a pass's records
when they change; `fn` is bound with `host_checked=True`, so a call is
the launch the renderer makes, with no read-back.  `dryrun_multichip` is
the multi-device dry run of `parallel/dryrun.py`.

From the repository root:

    python -c "from webrender_tpu_torch.graft_entry import entry; \\
        fn, args = entry(); print(fn(*args).shape)"
"""
from __future__ import annotations

import functools

from . import scenes
from .ops.dense import (check_clip_kinds, check_color_matrix_flags,
                        check_general_flags)
from .ops.tile_raster import render_tiles_dense
from .parallel.dryrun import dryrun_multichip  # noqa: F401  (an entry)
from .render_backend import RenderBackend

GRAFT_SIZE = (512, 256)
GRAFT_RECTS = 64


def entry(device="cuda"):
    """(fn, example_args): the dense-record tile raster over the graft test
    frame's tile grid.  `example_args` are the dense records, the per-tile
    record counts, the tile origins, the clear color, the frame's f32 rows
    and the alpha, surface and color atlases, on `device`, in the order of
    `render_tiles_dense`; `fn` holds the dispatch's kinds, blends and
    mask-clip flag, and `host_checked=True`: the records are checked here,
    once, with the flags `fn` passes.  Without CUDA, `device="cuda"`
    raises."""
    backend = scenes.graft_test_scene(
        RenderBackend(GRAFT_SIZE, device=device), GRAFT_SIZE, GRAFT_RECTS)
    inp = scenes.kernel_inputs(backend)
    # the renderer's f32 mirror is padded to a power of two of rows; the
    # kernel reads the frame's own
    n_rows = backend.last_frame.f32_buf.size // 128
    dense, counts = inp["dense"], inp["counts"]
    f32_rows = inp["f32_rows"][:n_rows]
    check_clip_kinds(dense, counts, f32_rows, inp["mask_clips"])
    check_color_matrix_flags(dense, counts)
    check_general_flags(dense, counts, False, 1.0)
    fn = functools.partial(render_tiles_dense, kinds=inp["kinds"],
                           blends=inp["blends"],
                           mask_clips=inp["mask_clips"], host_checked=True)
    example_args = (dense, counts, inp["origins"], inp["clear"], f32_rows,
                    inp["alpha_atlas"], inp["surface_atlas"],
                    inp["color_atlas"])
    return fn, example_args
