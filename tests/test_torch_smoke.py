"""Twins of tests/test_smoke.py (display list -> scene -> frame -> raster
-> pixels) on the port, on the CPU.

The JAX test renders through its device path, `render()`; each twin
renders the same transactions on the JAX package's `render()` and on the
port's default path (picture caching on, the kernel's plain version) and
holds the port's image bitwise against its uncached render and its
`render_software` with float32 `where`s.  Against JAX's `render()` the
tolerance is the JAX test's own, one u8 step, at the counts `STEPS` states
(measured: none), and against JAX's `render_software` bitwise.
"""
import numpy as np

from torch_twin import Trio

# values one u8 step from JAX's render(), by test (none: every image is
# bitwise JAX's)
STEPS = {"solid_rect": 0, "alpha_blend": 0, "oracle_matches_device": 0}


def _dl(color, bounds, under=None):
    """test_smoke.py's `simple_dl` (`under`: a rect drawn first)."""
    def flow(A, backend):
        pid = A.PipelineId(0, 1)
        b = A.DisplayListBuilder(pid)
        b.begin()
        root = A.SpatialId.root_scroll_node(pid)
        common = A.CommonItemProperties(A.Rect(0, 0, 1000, 1000), root)
        if under is not None:
            b.push_rect(common, A.Rect(*under[0]), A.ColorF(*under[1]))
        b.push_rect(common, A.Rect(*bounds), A.ColorF(*color))
        _, dl = b.end()
        txn = A.Transaction()
        txn.set_root_pipeline(pid)
        txn.set_display_list(A.Epoch(0), dl)
        txn.generate_frame()
        backend.send_transaction(txn)
    return flow


def _both(flow, name, keep=False):
    """`flow`'s image on the port, held against JAX's render() at the
    test's stated count (`keep`: with the trio)."""
    trio = Trio((256, 128))
    trio.send(flow)
    img = trio.render()
    want = trio.jax.render()
    diff = np.abs(img.astype(int) - want.astype(int))
    assert diff.max(initial=0) <= 1
    assert int((diff > 0).sum()) == STEPS[name]
    return (trio, img) if keep else img


def test_solid_rect_end_to_end():
    img = _both(_dl((0, 1, 0, 1), (10, 10, 100, 50)), "solid_rect")
    assert img.shape == (128, 256, 4)
    assert tuple(img[35, 60]) == (0, 255, 0, 255)
    assert tuple(img[5, 5]) == (255, 255, 255, 255)
    assert tuple(img[10, 10]) == (0, 255, 0, 255)
    assert tuple(img[9, 10]) == (255, 255, 255, 255)


def test_alpha_blend():
    img = _both(_dl((0, 0, 1, 0.5), (0, 0, 100, 100),
                    under=((0, 0, 100, 100), (1, 0, 0, 1))), "alpha_blend")
    assert tuple(img[50, 50]) == (127, 0, 128, 255)


def test_oracle_matches_device():
    """A fractional rect: the port's device image against its own oracle
    as it is, within the JAX test's one step (bitwise under float32
    `where`s, in `Trio.render`), and against JAX's `render()`."""
    trio, dev = _both(_dl((0.2, 0.4, 0.8, 0.9), (7.5, 3.25, 90.5, 40)),
                      "oracle_matches_device", keep=True)
    sw = trio.port.render_software()
    diff = np.abs(dev.astype(int) - sw.astype(int))
    assert diff.max() <= 1, f"max diff {diff.max()}"
