"""The tile-raster kernel's culling, held on the CPU.

The kernel skips a record for a warp (a run of `RUN_W` pixels of one tile
row) where `ops/tile_raster.py::run_may_draw`, the plain twin of its
`run_may_draw`, says that no pixel of the run can have coverage above
zero.  That skip changes no output bit only if every pixel where the plain
version's `record_coverage` (the record's geometric coverage with its rect
clips joined) is above zero lies in a run that draws.  This holds:

* on every dispatch of the port's small frames: the browsing twins, the
  effects, content, transformed and SVG-filter frames, the zoomed frame at
  0.8, 1.25 and 2.0, the CSS-3D frame with its flip frames, and a GL
  document of `testdata/wrench/` (the dispatches collected with the raster
  stubbed: the records do not depend on what earlier passes drew);
* on adversarial records: sub-pixel rects, edges at exact halves and on the
  runs' borders, AA off and on per edge, rotations, mirrors and scales,
  fractional tile origins, general tiles at `step` 0.5 and 2, clip chains
  of 1, 2, 16 and 18 clips, a projective row (never culled), a row with
  every pixel behind the projection plane, and a float-domain op at zero
  coverage (never culled in the builds that hold it).

The kernel itself is held against the plain version on the adversarial
records in all seven builds by `tests/test_torch_kernel.py`'s `cuda` case.
"""
import pytest
import torch

from torch_twin import adversarial_dispatch

from webrender_tpu_torch import scenes
from webrender_tpu_torch.frame.tiles import TILE_H, TILE_W
from webrender_tpu_torch.ops import tile_raster as tr
from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.renderer import renderer as renderer_mod

GENERAL_BUILDS = ("general", "filter", "gl")
FILTER_BUILDS = ("filter", "gl")


def _build(e):
    return tr.instantiation(e["kinds"], e["blends"], e["mask_clips"],
                            e["general"], e["step"], e["linear_cm"],
                            e["polygon_clips"], e["gl"])


def _hold(dense, counts, origins, f32_rows, step, general, float_ops):
    """Every pixel with coverage above zero lies in a run that draws; the
    share of (pixel, record) pairs in runs that draw."""
    may = tr.run_may_draw(dense, origins, step, general, float_ops)
    nt, slots, _ = dense.shape
    col = torch.arange(TILE_W)
    row = torch.arange(TILE_H)
    ox = origins[:, 0][:, None, None]
    oy = origins[:, 1][:, None, None]
    px = tr.pixel_pos(ox, col[None, None, :], step, general).expand(
        nt, TILE_H, TILE_W)
    py = tr.pixel_pos(oy, row[None, :, None], step, general).expand(
        nt, TILE_H, TILE_W)
    counts = counts.long()
    drawn = total = 0
    for s in range(int(counts.max()) if nt else 0):
        live = torch.nonzero(counts > s).reshape(-1)
        rec = tr._cols(dense[live, s])
        _, _, cov, _ = tr.record_coverage(rec, px[live], py[live], f32_rows)
        covered = (cov > 0.0)[0] if cov.dim() == 4 else cov > 0.0
        runs = may[live, s].repeat_interleave(tr.RUN_W, dim=-1)
        bad = covered & ~runs
        assert not bool(bad.any()), (
            f"slot {s}: {int(bad.sum())} covered pixels in skipped runs, "
            f"first at {torch.nonzero(bad)[0].tolist()}")
        drawn += int(runs.sum())
        total += runs.numel()
    return drawn / max(total, 1)


def _dispatches(make, size, *extra, gl=False, **kw):
    """Every dispatch of the frame's uncached render, the raster stubbed."""
    backend = RenderBackend(size, device="cpu")
    backend.frame_builder.gl_flavor = gl
    make(backend, *extra, **kw)
    backend.renderer.picture_caching = False
    backend.renderer.dispatch_log = log = []
    stub = renderer_mod.render_tiles_dense
    renderer_mod.render_tiles_dense = lambda **a: torch.zeros(
        (a["dense"].shape[0], 4, TILE_H, TILE_W))
    try:
        backend.render()
    finally:
        renderer_mod.render_tiles_dense = stub
    return log


def _gl_document(backend, name):
    from webrender_tpu_torch.wrench.yaml_reader import YamlFrameReader
    YamlFrameReader(scenes.WRENCH / name, scenes.GL_SMALL_SIZE).build(backend)
    return backend


FRAMES = {
    **{name: (make, size, (), {}) for name, (make, size) in
       scenes.SMALL_FRAMES.items()},
    "effects": (scenes.effects_scene, (1024, 512), (), {}),
    "content": (scenes.content_scene, (1024, 512), (), {}),
    **{f"zoomed_{z:g}": (scenes.zoomed_scene, scenes.ZOOMED_SIZE, (z,), {})
       for z in scenes.ZOOMS},
    "transformed": (scenes.transformed_scene, (1024, 512), (), {}),
    "svg_filter": (scenes.svg_filter_scene, (1024, 512), (), {}),
    "preserve3d": (scenes.preserve3d_scene, (1024, 512), (), {}),
    **{f"preserve3d_flip_{f:g}": (scenes.preserve3d_scene, (1024, 512), (),
                                  {"flip": f})
       for f in scenes.FLIP_FRAMES},
    "gl_masks": (_gl_document, scenes.GL_SMALL_SIZE, ("gl-masks.json",),
                 {"gl": True}),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_covered_pixels_lie_in_drawn_runs(name):
    make, size, extra, kw = FRAMES[name]
    log = _dispatches(make, size, *extra, **kw)
    assert log
    shares = []
    for e in log:
        build = _build(e)
        shares.append(_hold(e["dense"], e["tile_counts"], e["tile_origins"],
                            e["f32_rows"], e["step"],
                            build in GENERAL_BUILDS, build in FILTER_BUILDS))
    # the culling is live: some runs of the frame skip records
    assert min(shares) < 1.0, shares


@pytest.mark.parametrize("general,step", [(False, 1.0), (True, 1.0),
                                          (True, 0.5), (True, 2.0)])
@pytest.mark.parametrize("float_ops", [False, True])
def test_adversarial_records(general, step, float_ops):
    d = {k: torch.from_numpy(v) for k, v in
         adversarial_dispatch(general or step != 1.0).items()}
    share = _hold(d["dense"], d["counts"], d["origins"], d["f32_rows"], step,
                  general, float_ops)
    assert 0.0 < share < 1.0
    may = tr.run_may_draw(d["dense"], d["origins"], step, general, float_ops)
    names = adversarial_dispatch.NAMES
    # the projective row draws everywhere; the float-domain op wherever the
    # build holds the float domain, though it covers nothing
    assert bool(may[:, names.index("projective")].all())
    assert bool(may[:, names.index("float_op_outside")].all()) == float_ops
    assert not bool(may[:, names.index("behind")].any())
