"""The port's host layers against the JAX package's: the same scene, built
through each package's own API and backend, gives equal `Frame`s.

Every field of the frame and of each of its passes is compared, arrays
bitwise with their dtypes: `f32_buf`, `instances`, `transforms`,
`surface_rows`, and each pass's kind, target, region, `src_region`,
`sigma`, `blur_region`, `color_matrix`, `clear`, `tile_insts`, tile and
cache hashes and the rest.  One case per scene: the small kernel frames,
the 640x384 slice of the 4K browsing page, the effects and content
frames at 1024x512 and at 4K, and the zoomed frame with video at 1024x512
at zoom 1.25, 2.0 and 0.8 and at 4K at zoom 1.25, the transformed frames
and the SVG-filter frames at 1024x512 and at 4K (their passes' LUTs, `k`
values, sRGB directions, blend ops and color-matrix flags), and the CSS-3D
frames at 1024x512 (also with the first card flipped past 90 degrees) and
at 4K (their polygon clips' half-planes, rounded from float64 on the host,
bitwise; the faces each culls).  The zoomed, transformed and CSS-3D frames
built from the recorded glyphs (`testdata/glyphs.npz`) equal the frames
built with the font stack.
"""
import dataclasses
import functools

import numpy as np
import pytest

from torch_twin import SMALL_FRAMES, jax_scene

from webrender_tpu_torch import scenes
from webrender_tpu_torch.render_backend import RenderBackend

FRAMES = {name: (make, size, ()) for name, (make, size)
          in SMALL_FRAMES.items()}
FRAMES["slice"] = (scenes.build_4k_scene, (640, 384),
                   (640, 384, 12, 4, 8, 4))
FRAMES["effects"] = (scenes.effects_scene, (1024, 512), ())
FRAMES["effects_4k"] = (scenes.build_4k_effects_scene, (3840, 2160), ())
FRAMES["content"] = (scenes.content_scene, (1024, 512), ())
FRAMES["content_4k"] = (scenes.build_4k_content_scene, (3840, 2160), ())
for _name, _zoom in scenes.ZOOMED_FRAMES:
    FRAMES[_name] = (scenes.zoomed_scene, scenes.ZOOMED_SIZE, (_zoom,))
FRAMES["zoomed_4k"] = (scenes.build_4k_zoomed_scene, (3840, 2160), ())
FRAMES["transformed"] = (scenes.transformed_scene, (1024, 512), ())
FRAMES["transformed_4k"] = (scenes.build_4k_transformed_scene, (3840, 2160),
                            ())
FRAMES["oversized"] = (scenes.oversized_group_scene, scenes.OVERSIZED_SIZE,
                       ())
FRAMES["svg_filter"] = (scenes.svg_filter_scene, (1024, 512), ())
FRAMES["svg_filter_4k"] = (scenes.build_4k_svg_scene, (3840, 2160), ())
FRAMES["preserve3d"] = (scenes.preserve3d_scene, (1024, 512), ())
FRAMES["preserve3d_flip"] = (functools.partial(scenes.preserve3d_scene,
                                               flip=95.0), (1024, 512), ())
FRAMES["preserve3d_4k"] = (scenes.build_4k_3d_scene, (3840, 2160), ())


def _assert_same(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}")
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frame_equals_jax(name):
    make, size, extra = FRAMES[name]
    from webrender_tpu.frame.frame_builder import FrameBuilder
    with scenes.CulledFaces(FrameBuilder) as culled_jax:
        want = jax_scene(make, size, *extra).build_frame()
    with scenes.CulledFaces() as culled:
        got = make(RenderBackend(size, device="cpu"), *extra).build_frame()
    assert len(got.passes) == len(want.passes) > 0
    _assert_same(got, want, "frame")
    if name.startswith("effects"):
        # the filter-effects path: offscreen passes of every ported kind
        kinds = {p.kind for p in got.passes}
        assert len(kinds) >= 5, kinds
    if name.startswith("content"):
        # the content page: box shadows, gradients, lines, mix blends
        assert {3, 4, 8, 11} <= set(got.instances[:, 0].tolist())
        assert {17, 18, 26, 31} <= set(got.instances[:, 5].tolist())
    if name.startswith("zoomed"):
        # scaled text (subpixel and grayscale), video, clear rects
        assert {1, 5, 7, 10, 12} <= set(got.instances[:, 0].tolist())
        assert {0, 1, 7, 8} <= set(got.instances[:, 5].tolist())
        # the page zoom: no glyph is on the translation fast path
        text = np.isin(got.instances[:, 0], (5, 10))
        scale = got.transforms[got.instances[text, 1], 0]
        assert text.any() and (np.abs(scale - 1.0) > 0.1).all()
    if name.startswith("transformed"):
        # rotated nodes, every sampled kind, mask and nine-patch clips, a
        # gradient of 24 stops
        assert {1, 2, 3, 4, 5, 6, 10, 12} <= set(got.instances[:, 0].tolist())
        assert (got.transforms[:, 11] >= 4).sum() >= 8
        grads = got.instances[np.isin(got.instances[:, 0], (2, 3, 4))]
        assert got.f32_buf[grads[:, 2] + 14].max() == 24
    if name.startswith("preserve3d"):
        # polygon clips on records of general tiles and of the others, and
        # the turned-away faces culled, the same by both builders
        counts = scenes.css3d_counts(got)
        assert counts == scenes.css3d_counts(want)
        assert counts["polygon_records"] > 0
        assert counts["polygon_records_general"] > 0
        assert len(culled.nodes) == (11 if name.endswith("4k") else 5)
        assert culled_jax.nodes == culled.nodes
    if name == "oversized":
        assert [p.raster_step for p in got.passes] == [2.0, 1.0]
    if name.startswith("svg"):
        # the SVG filter path: every new pass kind with its LUTs, k values
        # and directions, the float-domain blend ops and color-matrix flag 2
        counts = scenes.svg_counts(got)
        assert counts == scenes.svg_counts(want)
        assert {"channel_lut surface", "srgb surface",
                "arith surface"} <= set(counts["passes"])
        assert {2, 3, 4, 5, 6, 41, 55, 64, 66, 68, 105, 119} <= \
            set(counts["blends"])
        assert counts["cm_flags"] == [0.0, 1.0, 2.0]
        assert (0.0, 1.0, -1.0, 0.0) in counts["kvals"]
        assert set(counts["srgb_to_linear"]) == {True, False}
        luts = [p.lut for p in got.passes if p.lut is not None]
        assert len(luts) == 4 and all(t.shape == (4, 256) for t in luts)


@pytest.mark.parametrize("name", sorted(
    n for n in FRAMES if n.startswith(("zoomed", "transformed",
                                       "preserve3d"))))
def test_replayed_glyphs_build_the_zoomed_frame(name):
    """The recorded glyph answers (20 and 32 px rasters, the zoomed
    subpixel offsets) give the frame the font stack gives."""
    from webrender_tpu_torch.resources import (ReplayFontContext,
                                               ResourceCache)
    make, size, extra = FRAMES[name]
    assert scenes.font_stack_available()
    want = make(RenderBackend(size, device="cpu"), *extra).build_frame()
    replay = ResourceCache(fonts=ReplayFontContext(scenes.GLYPHS))
    got = make(RenderBackend(size, device="cpu", resources=replay),
               *extra).build_frame()
    _assert_same(got, want, "frame")
