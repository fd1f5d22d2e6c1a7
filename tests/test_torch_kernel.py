"""The tile-raster kernel of the port.

* Its plain version against `render_tiles_pallas_dense(interpret=True)`
  on four small frames: f32 tiles with max diff 0.
* The wrapper raises for everything outside the ported set, and never
  falls back.  What it refused until later slices ported it renders: the
  float-domain blends, clips read as polygons, and the dispatch sets with
  `gl=True` (scaled text, video, clear rects and the clear blend among
  them), each held against the Pallas kernel in interpret mode.
* On a card (marker `cuda`): the CUDA kernel against the plain version,
  on the small frames, from seeded starting tiles, on the small effects
  frame's root pass (the picture kinds 6 and 15, with color-matrix flags
  0 and 1 and the raster-root local mode), with the sampled kinds'
  taps leaving the atlas at its corners, and on the records made to test
  the kernel's culling (`torch_twin.adversarial_dispatch`) in all seven
  builds, general tiles at steps 1 and 2 among them.
"""
import numpy as np
import pytest
import torch

from torch_twin import (SMALL_FRAMES, adversarial_dispatch, edge_inputs,
                        jax_kernel_inputs, jax_scene, pallas_args,
                        picture_variant, polygon_clip, positional, rgba8,
                        run_pallas, to_torch)

from webrender_tpu_torch import scenes
from webrender_tpu_torch.ops import tile_raster as tr
from webrender_tpu_torch.render_backend import RenderBackend


@pytest.mark.parametrize("name", sorted(SMALL_FRAMES))
def test_plain_matches_pallas_interpret(name):
    make, size = SMALL_FRAMES[name]
    _, p, _, (kinds, blends, mask_clips), args = jax_kernel_inputs(
        jax_scene(make, size))
    ref = run_pallas(args, kinds, blends, mask_clips)
    before = tr.LaunchCounts.plain_calls
    got = tr.render_tiles_dense(*positional(to_torch(args)), kinds=kinds,
                                blends=blends, mask_clips=mask_clips).numpy()
    assert tr.LaunchCounts.plain_calls == before + 1
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() == 0.0
    w, h = size
    want = rgba8(ref, p.nx, p.ny, w, h)
    np.testing.assert_array_equal(rgba8(got, p.nx, p.ny, w, h), want)
    # testdata/goldens.npz, which chip_smoke.py holds the card against
    np.testing.assert_array_equal(np.load(scenes.GOLDENS)[name], want)
    if name == "text_run":
        assert 10 in kinds and set(blends) == {0, 7, 8}
    if name == "images":
        assert 13 in kinds


def test_glyph_recording_is_current(tmp_path):
    """testdata/glyphs.npz (the glyphs of the text scenes where no font
    stack exists) equals a fresh recording, and replaying it builds the
    same frames and uploads as the font stack does."""
    if not scenes.font_stack_available():
        pytest.skip("needs matplotlib's ft2font and libfreetype")
    fresh = tmp_path / "glyphs.npz"
    scenes.record_glyphs(fresh)
    a, b = np.load(fresh), np.load(scenes.GLYPHS)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    from webrender_tpu_torch.resources import (ReplayFontContext,
                                               ResourceCache)
    for make, size, extra in scenes.TEXT_SCENES:
        real = make(RenderBackend(size, device="cpu"), *extra)
        replay = make(RenderBackend(size, device="cpu", resources=(
            ResourceCache(fonts=ReplayFontContext(scenes.GLYPHS)))), *extra)
        fa, fb = real.build_frame(), replay.build_frame()
        for name in ("f32_buf", "instances", "transforms"):
            np.testing.assert_array_equal(getattr(fa, name),
                                          getattr(fb, name))
        ua = real.resources.take_uploads()
        ub = replay.resources.take_uploads()
        assert len(ua) == len(ub)
        for x, y in zip(ua, ub):
            assert (x.atlas, x.region) == (y.atlas, y.region)
            np.testing.assert_array_equal(x.texels, y.texels)


def _inputs():
    return scenes.kernel_inputs(
        scenes.clip_gradient_scene(RenderBackend((256, 128), device="cpu")))


def _args(inp):
    return (inp["dense"], inp["counts"], inp["origins"], inp["clear"],
            inp["f32_rows"], inp["alpha_atlas"], inp["surface_atlas"],
            inp["color_atlas"])


UNPORTED = {
    "kind-border": (dict(kinds=(9,)), "kind 9"),
}
# refused with gl=True until the GL flavour was ported: dispatch sets
# holding scaled text, video, clear rects or the clear blend, and the
# frame's own, with gl=True; now drawn by the gl instantiation (the kinds
# are added to the frame's own, so that every record has its branch)
NOW_PORTED_GL = {
    "kind-glyph": dict(kinds=(14,)), "kind-clear": dict(kinds=(7,)),
    "kind-sep-subpx": dict(kinds=(16,)), "kind-sep-yuv": dict(kinds=(17,)),
    "blend-clear": dict(blends=(1,)), "gl": {}}


def _gl_case(case):
    """The clip-gradient frame's dispatch with `NOW_PORTED_GL[case]` and
    gl=True: the plain version against the Pallas kernel in interpret mode
    with gl=True, bitwise, on the gl instantiation."""
    import jax.numpy as jnp
    from webrender_tpu.ops.pallas import tile_raster as jt
    inp = _inputs()
    kw = NOW_PORTED_GL[case]
    kinds = tuple(sorted(set(inp["kinds"]) | set(kw.get("kinds", ()))))
    blends = kw.get("blends", inp["blends"])
    before = tr.LaunchCounts.plain_calls
    got = tr.render_tiles_dense(*_args(inp), kinds=kinds, blends=blends,
                                gl=True)
    assert tr.LaunchCounts.plain_calls == before + 1
    assert tr.instantiation(kinds, blends, False, gl=True) == "gl"
    a = {k: jnp.asarray(v) for k, v in pallas_args(inp).items()}
    want = np.asarray(jt.render_tiles_pallas_dense(
        a["dense"], a["counts"], a["origins"], a["clear"], a["f32_rows"],
        a["alpha_atlas"], a["surface_atlas"], a["color_atlas"],
        kinds=kinds, blends=blends, mask_clips=False, interpret=True,
        gl=True))
    assert np.abs(got.numpy() - want).max() == 0.0
    swgl = tr.render_tiles_dense(*_args(inp), kinds=kinds, blends=blends)
    # the clear blend on every record punches both flavours to zero
    assert torch.equal(got, swgl) == (case == "blend-clear")


# refused until the SVG filter path was ported: a Porter-Duff composite
# and an SVGFE mix, now drawn in the compose's float domain (the filter
# instantiation) by the record whose blend they become
NOW_PORTED = {"blend-pd-in": 2, "blend-svgfe-mix": 41}
# refused until polygon clips were ported: a clip record turned into a
# polygon (kind 3), and an image-mask record (kind 2) in a dispatch without
# mask_clips, which the TPU kernel reads as a polygon too
NOW_PORTED_CLIPS = {"clip-polygon": 3.0, "clip-mask-without-mask-clips": 2.0}
# a triangle over the clipped rect of the clip-gradient frame
TRIANGLE = ((30.0, 25.5), (215.25, 60.0), (70.0, 120.75))


def _polygon_clip_case(case):
    """The clip-gradient frame's clipped record with its clip record turned
    into `NOW_PORTED_CLIPS[case]` over `TRIANGLE`: refused without
    `polygon_clips`, rendered with it, equal to the Pallas kernel in
    interpret mode."""
    inp = _inputs()
    assert not inp["mask_clips"] and not inp["polygon_clips"]
    rows = inp["f32_rows"].clone()
    dense = inp["dense"]
    row = dense[..., 68][dense[..., 67] > 0][0].long()
    polygon_clip(rows, row, TRIANGLE)
    rows[row, 14] = NOW_PORTED_CLIPS[case]
    inp["f32_rows"] = rows
    call = dict(kinds=inp["kinds"], blends=inp["blends"])
    with pytest.raises(ValueError, match="polygon_clips"):
        tr.render_tiles_dense(*_args(inp), **call)
    assert tr.instantiation(**call, mask_clips=False,
                            polygon_clips=True) == "general"
    before = tr.LaunchCounts.plain_calls
    got = tr.render_tiles_dense(*_args(inp), **call, polygon_clips=True)
    assert tr.LaunchCounts.plain_calls == before + 1
    want = run_pallas(pallas_args(inp), inp["kinds"], inp["blends"], False)
    assert np.abs(got.numpy() - want).max() == 0.0
    # the triangle clips: the record draws less than under its rounded clip
    unclipped = tr.render_tiles_dense(*_args(_inputs()), **call)
    assert not torch.equal(got, unclipped)


@pytest.mark.parametrize("case", sorted(UNPORTED) + sorted(NOW_PORTED) +
                         sorted(NOW_PORTED_CLIPS) + sorted(NOW_PORTED_GL))
def test_wrapper_raises_outside_the_ported_set(case):
    if case in NOW_PORTED_GL:
        _gl_case(case)
        return
    if case in NOW_PORTED_CLIPS:
        _polygon_clip_case(case)
        return
    if case in NOW_PORTED:
        inp = _inputs()
        op = NOW_PORTED[case]
        dense = inp["dense"].clone()
        valid = torch.arange(dense.shape[1])[None, :] < inp["counts"][:, None]
        dense[..., 65][valid & (dense[..., 64] == 0)] = float(op)
        blends = tuple(sorted(set(inp["blends"]) | {op}))
        before = tr.LaunchCounts.plain_calls
        args = (dense,) + _args(inp)[1:]
        out = tr.render_tiles_dense(*args, kinds=inp["kinds"], blends=blends)
        assert tr.LaunchCounts.plain_calls == before + 1
        assert tr.instantiation(inp["kinds"], blends, False) == "filter"
        normal = tr.render_tiles_dense(*_args(inp), kinds=inp["kinds"],
                                       blends=inp["blends"])
        assert torch.isfinite(out).all() and not torch.equal(out, normal)
        return
    kw, match = UNPORTED[case]
    inp = _inputs()
    call = dict(kinds=inp["kinds"], blends=inp["blends"])
    call.update(kw)
    before = (tr.LaunchCounts.launches, tr.LaunchCounts.plain_calls)
    with pytest.raises(NotImplementedError, match=match):
        tr.render_tiles_dense(*_args(inp), **call)
    assert (tr.LaunchCounts.launches, tr.LaunchCounts.plain_calls) == before


def test_renderer_raises_outside_the_ported_path():
    """A polygon clip (clip kind 3) raised here until polygon clips were
    ported: the clip-gradient frame with its clipped record's clip turned
    into a triangle now renders, with picture caching on and off, equal to
    the JAX renderer's image (Pallas, interpret) of the same edited frame,
    the dispatch that holds it flagged `polygon_clips` by the host check.
    A scaled raster step raised here once; now such a pass renders, every
    tile general, with the step as a kernel argument."""
    from webrender_tpu_torch.frame.gpu import INST_CLIP_ADDR, INST_CLIP_COUNT
    backend = scenes.clip_gradient_scene(
        RenderBackend((256, 128), device="cpu"))
    frame = backend.build_frame()
    r = backend.renderer
    assert r.picture_caching
    import dataclasses
    scaled = dataclasses.replace(frame.passes[0], raster_step=2.0)

    def with_polygon(f):
        out = dataclasses.replace(f, f32_buf=f.f32_buf.copy())
        clipped = f.instances[f.instances[:, INST_CLIP_COUNT] > 0]
        polygon_clip(out.f32_buf.reshape(-1, 128),
                     clipped[0, INST_CLIP_ADDR] // 128, TRIANGLE)
        return out
    polygon = with_polygon(frame)
    jb = jax_scene(scenes.clip_gradient_scene, (256, 128))
    jb.renderer.picture_caching = True
    jf = jb.build_frame()
    want = jb.renderer.render(with_polygon(jf), jb.resources)
    for caching in (True, False):
        r.picture_caching = caching
        r.dispatch_log = log = []
        got = r.render(polygon, backend.resources)
        np.testing.assert_array_equal(got, want)
        assert any(e["polygon_clips"] for e in log)
        assert all(tr.instantiation(e["kinds"], e["blends"],
                                    e["mask_clips"], e["general"], e["step"],
                                    e["linear_cm"], e["polygon_clips"]) ==
                   "general" for e in log if e["polygon_clips"])
    assert not np.array_equal(want, backend.render())
    before = tr.LaunchCounts.plain_calls
    r.picture_caching = False
    r.dispatch_log = log = []
    frame.passes = [scaled]
    frame._torch_merged_passes = [scaled]
    img = r.render(frame, backend.resources)
    assert tr.LaunchCounts.plain_calls == before + 1
    assert log[0]["step"] == 2.0 and log[0]["general"]
    assert r.last_general_tiles == [(4, 4)]
    # the page at half size in the top left quarter: pixel (x, y) shows
    # device position (2x + 1, 2y + 1)
    whole = scenes.clip_gradient_scene(
        RenderBackend((256, 128), device="cpu")).render()
    assert img.shape == whole.shape
    assert (img[10, 100] == whole[21, 201]).all()


def test_no_cuda_means_no_cuda_renderer():
    if torch.cuda.is_available():
        pytest.skip("a card is present: Renderer('cuda') is valid here")
    from webrender_tpu_torch.renderer import Renderer
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RenderBackend((64, 64))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL_FRAMES))
def test_cuda_kernel_matches_plain(cuda_device, name):
    make, size = SMALL_FRAMES[name]
    inp = scenes.kernel_inputs(make(RenderBackend(
        size, device=cuda_device, resources=scenes.resource_cache())))
    before = tr.LaunchCounts.launches
    out = tr.render_tiles_dense(*_args(inp), kinds=inp["kinds"],
                                blends=inp["blends"])
    torch.cuda.synchronize()
    assert tr.LaunchCounts.launches == before + 1
    ref = tr.render_tiles_dense_plain(*_args(inp), kinds=inp["kinds"],
                                      blends=inp["blends"])
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL_FRAMES))
def test_cuda_kernel_with_init_tiles_matches_plain(cuda_device, name):
    """Continuation tiles: the kernel starts from seeded u8-grid pixels."""
    make, size = SMALL_FRAMES[name]
    inp = scenes.kernel_inputs(make(RenderBackend(
        size, device=cuda_device, resources=scenes.resource_cache())))
    rng = np.random.RandomState(5)
    init = torch.from_numpy((rng.randint(0, 256, (
        inp["dense"].shape[0], 4, 64, 128)) / 255.0).astype(np.float32)) \
        .to(cuda_device)
    before = tr.LaunchCounts.launches
    out = tr.render_tiles_dense(*_args(inp), init, kinds=inp["kinds"],
                                blends=inp["blends"])
    torch.cuda.synchronize()
    assert tr.LaunchCounts.launches == before + 1
    ref = tr.render_tiles_dense_plain(*_args(inp), init, kinds=inp["kinds"],
                                      blends=inp["blends"])
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) == 0.0
    # a tile with no records keeps its starting pixels
    inp["counts"] = torch.zeros_like(inp["counts"])
    empty = tr.render_tiles_dense(*_args(inp), init, kinds=inp["kinds"],
                                  blends=inp["blends"])
    assert torch.equal(empty, init)


def _effects_root(device):
    """The kernel arguments of the small effects frame's root pass, as the
    uncached render dispatched it on `device` (the surface atlas holds
    what the frame's offscreen passes drew)."""
    backend = scenes.effects_scene(RenderBackend(
        (1024, 512), device=device, resources=scenes.resource_cache()))
    r = backend.renderer
    r.picture_caching = False
    r.dispatch_log = log = []
    backend.render()
    r.dispatch_log = None
    return {k: v for k, v in log[-1].items()
            if k not in ("tile_insts", "init_tiles")}


@pytest.fixture(scope="module")
def cuda_effects_root():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return _effects_root("cuda")


SEPIA = [0.393, 0.769, 0.189, 0, 0, 0.349, 0.686, 0.168, 0, 0,
         0.272, 0.534, 0.131, 0, 0, 0, 0, 0, 1, 0]


def _kernel_vs_plain(args):
    before = tr.LaunchCounts.launches
    out = tr.render_tiles_dense(**args)
    torch.cuda.synchronize()
    assert tr.LaunchCounts.launches == before + 1
    plain = {k: v for k, v in args.items()
             if k not in ("mask_clips", "gl", "general", "linear_cm",
                          "polygon_clips")}
    ref = tr.render_tiles_dense_plain(**plain)
    assert torch.isfinite(out).all()
    return float((out - ref).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["built", "flag0", "flag1", "local"])
def test_cuda_picture_kinds_match_plain(cuda_effects_root, variant):
    args = dict(cuda_effects_root)
    assert {6, 15} <= set(args["kinds"])
    if variant != "built":
        args["dense"] = picture_variant(args["dense"], args["tile_counts"],
                                        variant, SEPIA)
    assert _kernel_vs_plain(args) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [5, 6, 10, 15])
@pytest.mark.parametrize("corner", ["origin", "far"])
def test_cuda_sampled_kinds_at_atlas_edges_match_plain(cuda_device, kind,
                                                       corner):
    t = to_torch(edge_inputs(kind, corner == "far"), cuda_device)
    args = dict(zip(("dense", "tile_counts", "tile_origins", "clear_color",
                     "f32_rows", "alpha_atlas", "surface_atlas",
                     "color_atlas"), positional(t)))
    args.update(kinds=(0, kind), blends=(0,))
    assert _kernel_vs_plain(args) == 0.0


# what sends the culling records to each build: extra kinds, flags, and
# whether the records hold a float-domain op (blend 2)
CULL_BUILDS = {"browsing": dict(), "surface": dict(kinds=(0, 6)),
               "content": dict(mask_clips=True), "media": dict(kinds=(0, 7)),
               "general": dict(general=True), "filter": dict(float_op=True),
               "gl": dict(gl=True, float_op=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("build,step", [(b, 1.0) for b in CULL_BUILDS] + [
    (b, 2.0) for b in ("general", "filter", "gl")])
def test_cuda_culling_records_match_plain(cuda_device, build, step):
    """The records of the culling test (sub-pixel and half-pixel edges, AA
    per edge, is_tx, rotations, mirrors, scales, projective, behind the
    plane, clips, a float-domain op outside its tile) in each build: the
    kernel skips runs and equals the plain version bitwise."""
    f = CULL_BUILDS[build]
    general = build in ("general", "filter", "gl")
    t = to_torch(adversarial_dispatch(general, f.get("float_op", False)),
                 cuda_device)
    kw = dict(kinds=f.get("kinds", (0,)),
              blends=(0, 2) if f.get("float_op") else (0,),
              mask_clips=f.get("mask_clips", False), step=step,
              gl=f.get("gl", False))
    before = dict(tr.LaunchCounts.by_instantiation)
    out = tr.render_tiles_dense(*positional(t), **kw, general=general,
                                host_checked=True)
    torch.cuda.synchronize()
    assert tr.LaunchCounts.by_instantiation[build] == before[build] + 1
    ref = tr.render_tiles_dense_plain(*positional(t), **kw)
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_wrapper_refuses_unaligned_records(cuda_device):
    """The kernel copies records and clip rows in 16-byte pieces: a dense
    or f32 tensor that starts off a 16-byte boundary is refused."""
    t = to_torch(adversarial_dispatch(), cuda_device)
    args = dict(zip(("dense", "tile_counts", "tile_origins", "clear_color",
                     "f32_rows", "alpha_atlas", "surface_atlas",
                     "color_atlas"), positional(t)))
    for name in ("dense", "f32_rows"):
        shifted = dict(args)
        buf = torch.empty(args[name].numel() + 1, device=cuda_device)
        shifted[name] = buf[1:].view(args[name].shape).copy_(args[name])
        with pytest.raises(ValueError, match="16-byte aligned"):
            tr._launch(*shifted.values(), kinds=(0,), blends=(0, 2),
                       mask_clips=False)
