"""examples/alpha_perf.rs equivalent: N full-screen 5%-alpha white rects
stacked on each other — a fill-rate / alpha-blend stress test.  Pass
`--rects N` to change the stack depth (the reference adjusts it with the
arrow keys).  It renders on the card (`--cpu`: on the CPU) and reports
the end-to-end ms, the kernel's build included.
"""
import sys
import time

from common import main_wrapper

from webrender_tpu_torch.api import (ColorF, CommonItemProperties, Rect,
                                     SpatialId)


def _rect_count() -> int:
    argv = sys.argv
    if "--rects" in argv:
        return int(argv[argv.index("--rects") + 1])
    return 64


def alpha_perf(b, txn, backend, frame_idx, size):
    pid = b.pipeline_id
    root = SpatialId.root_scroll_node(pid)
    bounds = Rect(0, 0, *size)
    common = CommonItemProperties(bounds, root)
    for _ in range(_rect_count()):
        b.push_rect(common, bounds, ColorF(1.0, 1.0, 1.0, 0.05))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main_wrapper(alpha_perf)
    print(f"alpha_perf: {_rect_count()} blended fullscreen rects in "
          f"{(time.perf_counter() - t0) * 1000.0:.1f} ms (end-to-end, "
          f"the kernel's build included)")
