"""The tile-raster kernel's bound (`webrender_tpu_torch/ops/roofline.py`).

* `covered_pixels` finds the pixels past the kernel's zero-coverage
  test: a record moved off the page has none, and dropping every record
  with none from a dispatch leaves the plain version's tiles as they
  were.
* The operation count lies between the coverage work alone and the
  whole work charged to every pixel of every record's tile, and on the
  small content frame each of the content branches adds to it; on the
  small zoomed frame the scaled text, the video and the clear rects do,
  and the video's three planes are counted in the bytes.
* A record under a float-domain blend op (the SVG filter ops) is counted
  over every pixel of its tile, with its op's work and, from op 64, the
  conversions to linearRGB and back.
* A polygon clip (kind 3) costs its own count per pixel of the tile, and
  so do the image-mask and nine-patch kinds where the kernel reads them as
  polygons (a tile that is not general, without `mask_clips`); on the
  small CSS-3D frame's root pass the polygon clips add to the count.
"""
import pytest
import torch

from webrender_tpu_torch import scenes
from webrender_tpu_torch.frame.tiles import TILE_H, TILE_W
from webrender_tpu_torch.ops import roofline
from webrender_tpu_torch.ops import tile_raster as tr
from webrender_tpu_torch.render_backend import RenderBackend


def _inputs(name):
    make, size = scenes.SMALL_FRAMES[name]
    return scenes.kernel_inputs(make(RenderBackend(
        size, device="cpu", resources=scenes.resource_cache())))


def _plain(inp, dense, counts):
    return tr.render_tiles_dense_plain(
        dense, counts, inp["origins"], inp["clear"], inp["f32_rows"],
        inp["alpha_atlas"], inp["surface_atlas"], inp["color_atlas"],
        kinds=inp["kinds"], blends=inp["blends"])


@pytest.mark.parametrize("name", sorted(scenes.SMALL_FRAMES))
def test_uncovered_records_change_no_tile(name):
    inp = _inputs(name)
    dense, counts = inp["dense"], inp["counts"]
    # each drawn tile gains a copy of its first record moved off the page
    nt = dense.shape[0]
    drawn = torch.nonzero(counts > 0).reshape(-1)
    off = dense[drawn, 0].clone()
    off[:, 4:8] += 1.0e4
    dense = torch.cat([dense, torch.zeros_like(dense[:, :1])], 1)
    dense[drawn, counts[drawn].long()] = off
    counts = counts + (counts > 0).to(counts.dtype)
    covered = roofline.covered_pixels(dense, counts, inp["origins"],
                                      inp["f32_rows"])
    valid = roofline._valid(dense, counts)
    assert covered.shape == valid.shape
    assert bool((covered[~valid] == 0).all())
    assert bool((covered <= TILE_H * TILE_W).all())
    assert bool((covered[drawn, counts[drawn].long() - 1] == 0).all())
    partial = valid & (covered > 0) & (covered < TILE_H * TILE_W)
    assert bool(partial.any())
    # the records with covered pixels, in painter order, alone
    keep = valid & (covered > 0)
    kept = torch.zeros_like(dense)
    for t in range(nt):
        rows = dense[t][keep[t]]
        kept[t, :rows.shape[0]] = rows
    kept_counts = keep.sum(1).to(torch.int32)
    assert torch.equal(_plain(inp, kept, kept_counts),
                       _plain(inp, dense, counts))


def test_operations_lie_between_coverage_and_whole_tiles(monkeypatch):
    inp = _inputs("images")
    args = (inp["dense"], inp["counts"], inp["origins"], inp["f32_rows"])
    ops, nbytes = roofline.dispatch_work(*args)
    ms, by, b_ops, b_bytes = roofline.tile_raster_bound(*args)
    assert (b_ops, b_bytes) == (ops, nbytes)
    assert by in ("operations", "bytes") and ms > 0
    valid = roofline._valid(inp["dense"], inp["counts"])
    covered = roofline.covered_pixels(*args)
    assert float(covered[valid].sum()) < valid.sum() * TILE_H * TILE_W
    assert ops > int(valid.sum()) * roofline.COVERAGE_OPS * TILE_H * TILE_W
    # every pixel of every record's tile covered: the whole work
    monkeypatch.setattr(roofline, "covered_pixels",
                        lambda d, *a: torch.full(d.shape[:2],
                                                 float(TILE_H * TILE_W),
                                                 dtype=torch.float64))
    whole, whole_bytes = roofline.dispatch_work(*args)
    assert ops < whole and nbytes == whole_bytes


def test_content_frame_counts_its_branches(monkeypatch):
    """The small content frame's root pass: the gradients, box shadows,
    line decorations, mask clips and mix blends each add to the count,
    which stays between the coverage work and whole tiles."""
    inp = scenes.kernel_inputs(scenes.content_scene(RenderBackend(
        (1024, 512), device="cpu", resources=scenes.resource_cache())))
    args = (inp["dense"], inp["counts"], inp["origins"], inp["f32_rows"])
    ops, nbytes = roofline.dispatch_work(*args)
    valid = roofline._valid(inp["dense"], inp["counts"])
    assert ops > int(valid.sum()) * roofline.COVERAGE_OPS * TILE_H * TILE_W
    cuts = {"KIND_OPS": {**roofline.KIND_OPS, 3: 0, 4: 0},
            "BOX_SHADOW_OPS": dict.fromkeys(roofline.BOX_SHADOW_OPS, 0),
            "LINE_DEC_OPS": dict.fromkeys(roofline.LINE_DEC_OPS, 0),
            "MIX_BLEND_OPS": dict.fromkeys(roofline.MIX_BLEND_OPS, 0),
            "CLIP_OPS": {**roofline.CLIP_OPS, "image_mask": 0,
                         "box_shadow": 0}}
    for name, table in cuts.items():
        monkeypatch.setattr(roofline, name, table)
        less, same_bytes = roofline.dispatch_work(*args)
        assert less < ops and same_bytes == nbytes, name
        monkeypatch.undo()
    monkeypatch.setattr(roofline, "covered_pixels",
                        lambda d, *a: torch.full(d.shape[:2],
                                                 float(TILE_H * TILE_W),
                                                 dtype=torch.float64))
    whole, _ = roofline.dispatch_work(*args)
    assert ops < whole


def test_zoomed_frame_counts_its_branches(monkeypatch):
    """The small zoomed frame's root pass (zoom 1.25): scaled subpixel
    text, the video and the clear rects have covered pixels, the first two
    add operations (a clear rect's pattern costs none) and texel bytes;
    the surface pass of the toast counts its scaled grayscale text."""
    backend = scenes.zoomed_scene(RenderBackend(
        scenes.ZOOMED_SIZE, device="cpu", resources=scenes.resource_cache()))
    inp = scenes.kernel_inputs(backend)
    assert {7, 16, 17} <= set(inp["kinds"]) and 1 in inp["blends"]
    args = (inp["dense"], inp["counts"], inp["origins"], inp["f32_rows"])
    ops, nbytes = roofline.dispatch_work(*args)
    valid = roofline._valid(inp["dense"], inp["counts"])
    covered = roofline.covered_pixels(*args)
    kind = inp["dense"][..., 64]
    for k in (7, 16, 17):
        assert float(covered[valid & (kind == k)].sum()) > 0, k
    assert roofline.KIND_OPS[7] == 0 and roofline.MIX_BLEND_OPS[1] == 0
    for k in (16, 17):
        monkeypatch.setattr(roofline, "KIND_OPS", {**roofline.KIND_OPS, k: 0})
        less, same_bytes = roofline.dispatch_work(*args)
        assert less < ops and same_bytes == nbytes, k
        monkeypatch.undo()
        monkeypatch.setattr(roofline, "PLANES", {**roofline.PLANES, k: 0})
        same_ops, fewer = roofline.dispatch_work(*args)
        assert same_ops == ops and fewer < nbytes, k
        monkeypatch.undo()
    monkeypatch.setattr(roofline, "YUV_CHROMA_UV", ())
    _, luma_only = roofline.dispatch_work(*args)
    # the 160x90 chroma planes, one texel more each way
    assert nbytes - luma_only == 2 * 161 * 91 * 4
    monkeypatch.undo()
    # the toast's surface pass: solid and scaled grayscale text
    r = backend.renderer
    r.picture_caching = False
    r.dispatch_log = log = []
    backend.render()
    (e,) = [e for e in log if 14 in e["kinds"]][:1]
    s_args = (e["dense"], e["tile_counts"], e["tile_origins"], e["f32_rows"])
    s_ops, _ = roofline.dispatch_work(*s_args)
    monkeypatch.setattr(roofline, "KIND_OPS", {**roofline.KIND_OPS, 14: 0})
    assert roofline.dispatch_work(*s_args)[0] < s_ops


def test_transformed_frame_counts_its_branches(monkeypatch):
    """The small transformed frame's root pass: each general kind has
    covered pixels and adds operations and texel bytes; the general mask
    and nine-patch clips add operations; a 24-stop gradient's stops span
    two f32 rows, both counted in the bytes; a raster step moves the
    pixels a record covers."""
    backend = scenes.transformed_scene(RenderBackend(
        (1024, 512), device="cpu", resources=scenes.resource_cache()))
    backend.renderer.render(backend.build_frame(), backend.resources)
    inp = scenes.kernel_inputs(backend)
    assert inp["general"] and {1, 12, 18, 19, 20} <= set(inp["kinds"])
    args = (inp["dense"], inp["counts"], inp["origins"], inp["f32_rows"])
    ops, nbytes = roofline.dispatch_work(*args)
    valid = roofline._valid(inp["dense"], inp["counts"])
    covered = roofline.covered_pixels(*args)
    kind = inp["dense"][..., 64]
    for k in (1, 12, 18, 19, 20):
        assert float(covered[valid & (kind == k)].sum()) > 0, k
        monkeypatch.setattr(roofline, "KIND_OPS", {**roofline.KIND_OPS, k: 0})
        less, same_bytes = roofline.dispatch_work(*args)
        assert less < ops and same_bytes == nbytes, k
        monkeypatch.undo()
        monkeypatch.setattr(roofline, "PLANES", {**roofline.PLANES, k: 0})
        same_ops, fewer = roofline.dispatch_work(*args)
        assert same_ops == ops and fewer < nbytes, k
        monkeypatch.undo()
    for clip in ("general_image_mask", "general_box_shadow"):
        monkeypatch.setattr(roofline, "CLIP_OPS",
                            {**roofline.CLIP_OPS, clip: 0})
        assert roofline.dispatch_work(*args)[0] < ops, clip
        monkeypatch.undo()
    # the legend's 24 stops: 192 floats, two rows
    legend = valid & (kind == 2) & (inp["dense"][..., 14] == 24)
    assert bool(legend.any())
    short = inp["dense"].clone()
    short[..., 14][legend] = 16.0
    assert nbytes - roofline.dispatch_work(short, *args[1:])[1] == 512
    stepped = roofline.covered_pixels(*args, step=2.0)
    assert float((stepped != covered).sum()) > 0



@pytest.mark.parametrize("op", [0, 2, 41, 66, 119])
def test_float_ops_count_every_pixel_of_the_tile(op):
    """A solid 10 x 10 record: under a u8-grid blend op its compose is
    counted over the 100 pixels it covers; under a float-domain op, which
    has no zero-coverage skip, over all 8192 of its tile (and from op 64
    with the conversions to linearRGB and back)."""
    rec = torch.zeros((1, 1, 128))
    rec[0, 0, 0:8] = torch.tensor([10.0, 10.0, 20.0, 20.0] * 2)
    rec[0, 0, 8:12] = torch.tensor([0.2, 0.3, 0.4, 0.5])
    rec[0, 0, 64:67] = torch.tensor([0.0, float(op), 15.0])
    rec[0, 0, 69:81] = torch.tensor([1, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0.0])
    ops, nbytes = roofline.dispatch_work(
        rec, torch.ones(1, dtype=torch.int32), torch.zeros((1, 2)),
        torch.zeros((1, 128)))
    pixels = TILE_H * TILE_W
    compose = roofline.float_blend_ops(op) * pixels if op else \
        roofline.COMPOSE_OPS * 100
    assert ops == roofline.COVERAGE_OPS * pixels + compose
    assert nbytes == 512 + 4 * pixels * 4
    if op >= 64:
        assert roofline.float_blend_ops(op) == roofline.float_blend_ops(
            op - 64) + roofline.LINEAR_OPS


def _clipped_solid(clip_kind, general=False):
    """A solid 10 x 10 record with one clip record of `clip_kind` at row 1
    (its uv rect 4 x 3 texels), in a general tile or not."""
    rec = torch.zeros((1, 1, 128))
    rec[0, 0, 0:8] = torch.tensor([10.0, 10.0, 20.0, 20.0] * 2)
    rec[0, 0, 8:12] = torch.tensor([0.2, 0.3, 0.4, 0.5])
    rec[0, 0, 64:69] = torch.tensor([0.0, 0.0, 15.0, 1.0, 1.0])
    rec[0, 0, 69:81] = torch.tensor([1, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0.0])
    rec[0, 0, 81] = float(general)
    rows = torch.zeros((2, 128))
    rows[1, 0:4] = torch.tensor([0.0, 0.0, 30.0, 30.0])
    rows[1, 14] = float(clip_kind)
    rows[1, 16:20] = torch.tensor([4.0, 4.0, 7.0, 6.0])
    rows[1, 96:108] = rec[0, 0, 69:81]
    return rec, torch.ones(1, dtype=torch.int32), torch.zeros((1, 2)), rows


@pytest.mark.parametrize("clip_kind,general,mask_clips,counted", [
    (3, False, True, "polygon"), (3, True, True, "polygon"),
    (2, False, False, "polygon"), (4, False, False, "polygon"),
    (2, False, True, "image_mask"), (4, False, True, "box_shadow"),
    (2, True, False, "general_image_mask"),
    (4, True, False, "general_box_shadow")])
def test_polygon_clips_are_counted(clip_kind, general, mask_clips, counted):
    """One clip record: its count per pixel of the tile is the branch the
    kernel takes for it, a polygon for kind 3 and, in a tile that is not
    general of a dispatch without `mask_clips`, for kinds 2 and 4; only a
    clip read as a mask adds its uv rect's texels."""
    args = _clipped_solid(clip_kind, general)
    ops, nbytes = roofline.dispatch_work(*args, mask_clips=mask_clips)
    pixels = TILE_H * TILE_W
    assert ops == (roofline.COVERAGE_OPS + roofline.CLIP_OPS[counted]) * \
        pixels + roofline.COMPOSE_OPS * 100
    texels = 0 if counted == "polygon" else 4 * 3 * 4
    assert nbytes == 512 + 512 + texels + 4 * pixels * 4
    assert roofline.tile_raster_bound(*args, mask_clips=mask_clips)[2:] == \
        (ops, nbytes)


def test_css3d_frame_counts_its_polygons(monkeypatch):
    """The small CSS-3D frame's root pass holds polygon clips on general
    records and on the others; each adds to the count."""
    backend = scenes.preserve3d_scene(RenderBackend(
        (1024, 512), device="cpu", resources=scenes.resource_cache()))
    backend.renderer.picture_caching = False
    backend.renderer.render(backend.build_frame(), backend.resources)
    inp = scenes.kernel_inputs(backend)
    assert inp["polygon_clips"] and inp["general"]
    args = (inp["dense"], inp["counts"], inp["origins"], inp["f32_rows"])
    ops, nbytes = roofline.dispatch_work(*args,
                                         mask_clips=inp["mask_clips"])
    monkeypatch.setattr(roofline, "CLIP_OPS",
                        {**roofline.CLIP_OPS, "polygon": 0})
    less, same_bytes = roofline.dispatch_work(*args,
                                              mask_clips=inp["mask_clips"])
    assert less < ops and same_bytes == nbytes
    # polygons on general records and on the others
    dense, rows = inp["dense"], inp["f32_rows"]
    valid = roofline._valid(dense, inp["counts"])
    polygon = torch.zeros_like(valid)
    for j in range(int(dense[..., 67].max())):
        row = (dense[..., 68].long() + j).clamp(0, rows.shape[0] - 1)
        polygon |= valid & (dense[..., 67] > j) & (rows[row, 14] == 3.0)
    general = dense[..., 81] > 0.5
    assert bool((polygon & general).any()) and bool((polygon & ~general).any())
