"""Scenes for the port: the 4K browsing frame of `bench.py` and the small
frames its kernel is checked on.

`build_4k_scene` makes the display list of `bench.py:22-143` with the
same `RandomState(42)` draws in the same order, on a backend the caller
gives.  The small frames (`SMALL_FRAMES`) cover the ported kernel
branches: solid, gradient and a rounded clip; a subpixel text run (blends
7 and 8); images at several scales, repeating and pixelated; and the less
common coverage, clip and gradient branches.

Text needs a font stack (matplotlib's ft2font, the system libfreetype and
matplotlib's DejaVu Sans).  Where it is missing, `resource_cache()` gives
a cache that replays `testdata/glyphs.npz`: the glyph indices, advances
and rasters that the text scenes here needed, recorded with the font stack
(`python -m webrender_tpu_torch.scenes` rewrites it; a test holds it equal
to a fresh recording).
"""
from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

import webrender_tpu_torch  # noqa: F401  (imports the host package)
from webrender_tpu.api import (AlphaType, BorderRadius, ClipMode, ColorF,
                               CommonItemProperties, DisplayListBuilder,
                               Epoch, ExtendMode, GradientStop, ImageData,
                               ImageDescriptor, ImageDescriptorFlags,
                               ImageFormat, ImageRendering, PipelineId,
                               Point2D, Rect, Size2D, SpatialId, Transaction,
                               Transform)
from webrender_tpu.api.font import (FontInstanceKey, FontInstanceOptions,
                                    FontKey)

TESTDATA = pathlib.Path(__file__).resolve().parent / "testdata"
GLYPHS = TESTDATA / "glyphs.npz"
# the JAX package's RGBA8 of the small frames (tests/torch_twin.py writes
# it; test_torch_kernel.py holds it equal to a fresh JAX render)
GOLDENS = TESTDATA / "goldens.npz"


def font_stack_available() -> bool:
    """matplotlib's ft2font and the system libfreetype both load."""
    import ctypes
    try:
        from matplotlib import ft2font  # noqa: F401
        ctypes.CDLL("libfreetype.so.6")
    except (ImportError, OSError):
        return False
    return True


def dejavu_path() -> str:
    """matplotlib's DejaVu Sans; without matplotlib only the file name,
    which a ReplayFontContext accepts and never opens."""
    try:
        import matplotlib
    except ImportError:
        return "DejaVuSans.ttf"
    return matplotlib.get_data_path() + "/fonts/ttf/DejaVuSans.ttf"


def _finish(backend, pid, b, txn=None):
    _, dl = b.end()
    txn = txn or Transaction()
    txn.set_root_pipeline(pid)
    txn.set_display_list(Epoch(0), dl)
    txn.generate_frame()
    backend.send_transaction(txn)
    return backend


def build_4k_scene(backend, w=3840, h=2160, n_rects=400, n_grads=100,
                   n_images=80, n_text=60):
    """`bench.build_4k_scene` on `backend`: background, a scroll feed,
    solid rects (half at alpha 0.85), three-stop gradients, images at
    0.75-2x and repeats, text runs and one rounded-rect clip.  The fonts
    are registered only when `n_text` > 0."""
    pid = PipelineId(0, 1)
    b = DisplayListBuilder(pid)
    b.begin()
    root = SpatialId.root_scroll_node(pid)
    common = CommonItemProperties(Rect(0, 0, w, h), root)
    rng = np.random.RandomState(42)
    txn = Transaction()

    b.push_rect(common, Rect(0, 0, w, h), ColorF(0.95, 0.95, 0.97, 1.0))
    feed = b.define_scroll_frame(root, external_id=777,
                                 content_rect=Rect(3300, 80, 480, 6000),
                                 frame_rect=Rect(3300, 80, 480, 1900))
    feed_common = CommonItemProperties(Rect(0, 0, w, 6000), feed)
    for i in range(40):
        b.push_rect(feed_common, Rect(3310, 90 + i * 150, 460, 130),
                    ColorF(0.85, 0.88, 0.93, 1.0))
        b.push_rect(feed_common, Rect(3320, 100 + i * 150, 200, 24),
                    ColorF(float(rng.rand()), 0.3, 0.6, 1.0))
    for i in range(n_rects):
        x = float(rng.uniform(0, w - 200))
        y = float(rng.uniform(0, h - 120))
        rw = float(rng.uniform(40, 200))
        rh = float(rng.uniform(30, 120))
        alpha = 1.0 if i % 2 else 0.85
        b.push_rect(common, Rect(x, y, rw, rh),
                    ColorF(float(rng.rand()), float(rng.rand()),
                           float(rng.rand()), alpha))
    for i in range(n_grads):
        x = float(rng.uniform(0, w - 256))
        y = float(rng.uniform(0, h - 128))
        g, stops = b.create_gradient(
            Point2D(0, 0), Point2D(256, 0),
            [GradientStop(0.0, ColorF(1, 0.2, 0.1, 1)),
             GradientStop(0.5, ColorF(0.2, 0.6, 1, 1)),
             GradientStop(1.0, ColorF(0.1, 1, 0.4, 1))],
            ExtendMode.CLAMP)
        b.push_gradient(common, Rect(x, y, 256, 96), g, stops)
    for k in range(8):
        px = (rng.rand(96, 96, 4) * 255).astype(np.uint8)
        px[..., 3] = 255
        txn.add_image(100 + k,
                      ImageDescriptor(ImageFormat.RGBA8, 96, 96,
                                      flags=ImageDescriptorFlags.IS_OPAQUE),
                      ImageData(pixels=px))
    for i in range(n_images):
        key = 100 + (i % 8)
        x = float(rng.uniform(0, w - 220))
        y = float(rng.uniform(0, h - 220))
        scale = (0.75, 1.0, 1.5, 2.0)[i % 4]
        s = 96 * scale
        if i % 10 == 0:
            b.push_repeating_image(
                common, Rect(x, y, 280, 180), Size2D(64, 64), Size2D(8, 8),
                ImageRendering.AUTO, AlphaType.PREMULTIPLIED_ALPHA, key)
        else:
            b.push_image(common, Rect(x, y, s, s), ImageRendering.AUTO,
                         AlphaType.PREMULTIPLIED_ALPHA, key)

    if n_text > 0:
        fk = FontKey(0, 1)
        fik = FontInstanceKey(0, 9)
        pre = Transaction()
        pre.add_native_font(fk, dejavu_path())
        pre.add_font_instance(fik, fk, 16.0, FontInstanceOptions())
        backend.send_transaction(pre)

        def layout(text, x, y):
            glyphs = []
            for ch in text:
                gi = backend.resources.fonts.glyph_index(fk, ch)
                glyphs.append((gi, x, y))
                x += backend.resources.fonts.linear_advance(fk, 16.0, gi)
            return glyphs

        words = ("the quick brown fox jumps over the lazy dog "
                 "pack my box with five dozen liquor jugs").split()
        for i in range(n_text):
            x = float(rng.uniform(0, w - 600))
            y = float(rng.uniform(20, h - 20))
            text = " ".join(words[(i * 3 + j) % len(words)]
                            for j in range(6))
            b.push_text(common, Rect(x, y - 16, 600, 24), layout(text, x, y),
                        fik.key, ColorF(0.1, 0.1, 0.15, 1.0))

    clip = b.define_clip_rounded_rect(root, Rect(100, 100, 600, 400),
                                      BorderRadius.uniform(40.0))
    chain = b.define_clip_chain(None, [clip])
    b.push_rect(dataclasses.replace(common, clip_chain_id=chain),
                Rect(0, 0, 800, 600), ColorF(0.1, 0.1, 0.4, 0.6))
    return _finish(backend, pid, b, txn)


def clip_gradient_scene(backend):
    """Solid, linear gradient and a rounded-rect clip on 256x128 (the
    scene of tests/test_kernel_variants.py)."""
    pid = PipelineId(0, 1)
    b = DisplayListBuilder(pid)
    b.begin()
    root = SpatialId.root_scroll_node(pid)
    common = CommonItemProperties(Rect(0, 0, 256, 128), root)
    b.push_rect(common, Rect(0, 0, 256, 128), ColorF(1, 1, 1, 1))
    g, stops = b.create_gradient(
        Point2D(0, 0), Point2D(128, 0),
        [GradientStop(0.0, ColorF(1, 0, 0, 1)),
         GradientStop(1.0, ColorF(0, 0, 1, 1))], ExtendMode.CLAMP)
    b.push_gradient(common, Rect(10, 10, 120, 40), g, stops)
    clip = b.define_clip_rounded_rect(root, Rect(40, 20, 160, 90),
                                      BorderRadius.uniform(20.0))
    chain = b.define_clip_chain(None, [clip])
    b.push_rect(dataclasses.replace(common, clip_chain_id=chain),
                Rect(30, 30, 180, 80), ColorF(0.2, 0.6, 0.3, 0.8))
    return _finish(backend, pid, b)


def text_run_scene(backend):
    """A short DejaVu Sans run on 256x64: subpixel glyphs drawn as the
    channel-clear / add pair (blend ops 7 and 8)."""
    pid = PipelineId(0, 1)
    b = DisplayListBuilder(pid)
    b.begin()
    root = SpatialId.root_scroll_node(pid)
    common = CommonItemProperties(Rect(0, 0, 256, 64), root)
    b.push_rect(common, Rect(0, 0, 256, 64), ColorF(0.95, 0.95, 0.97, 1.0))
    fk = FontKey(0, 1)
    fik = FontInstanceKey(0, 9)
    pre = Transaction()
    pre.add_native_font(fk, dejavu_path())
    pre.add_font_instance(fik, fk, 16.0, FontInstanceOptions())
    backend.send_transaction(pre)
    glyphs = []
    x = 7.0
    for ch in "pack my box with jugs":
        gi = backend.resources.fonts.glyph_index(fk, ch)
        glyphs.append((gi, x, 38.0))
        x += backend.resources.fonts.linear_advance(fk, 16.0, gi)
    b.push_text(common, Rect(0, 20, 256, 24), glyphs, fik.key,
                ColorF(0.1, 0.1, 0.15, 1.0))
    return _finish(backend, pid, b)


def image_scene(backend):
    """One 96x96 image at scales 0.75, 1.5 and 2, a repeating image and a
    stretched nearest-sampled (pixelated) one, on 384x256."""
    pid = PipelineId(0, 1)
    b = DisplayListBuilder(pid)
    b.begin()
    root = SpatialId.root_scroll_node(pid)
    common = CommonItemProperties(Rect(0, 0, 384, 256), root)
    rng = np.random.RandomState(7)
    txn = Transaction()
    px = (rng.rand(96, 96, 4) * 255).astype(np.uint8)
    px[..., 3] = 255
    txn.add_image(100, ImageDescriptor(ImageFormat.RGBA8, 96, 96,
                                       flags=ImageDescriptorFlags.IS_OPAQUE),
                  ImageData(pixels=px))
    b.push_rect(common, Rect(0, 0, 384, 256), ColorF(1, 1, 1, 1))
    for x, y, scale in ((5.5, 3.0, 0.75), (90.0, 10.25, 1.5),
                        (230.0, 60.0, 2.0)):
        s = 96 * scale
        b.push_image(common, Rect(x, y, s, s), ImageRendering.AUTO,
                     AlphaType.PREMULTIPLIED_ALPHA, 100)
    b.push_repeating_image(common, Rect(10, 150, 200, 100), Size2D(64, 64),
                           Size2D(8, 8), ImageRendering.AUTO,
                           AlphaType.PREMULTIPLIED_ALPHA, 100)
    b.push_image(common, Rect(250.5, 200.0, 120, 48),
                 ImageRendering.PIXELATED, AlphaType.PREMULTIPLIED_ALPHA, 100)
    return _finish(backend, pid, b, txn)


def branches_scene(backend):
    """The kernel's less common branches on 384x192: a repeating
    gradient with tile spacing and hard stops; a rotated rect (the
    transformed-prim coverage path) under a rotated rounded clip; and a
    chain of a non-uniform rounded clip (the SDF path), a fractional rect
    clip (joins the span) and a clip-out circle (inverted)."""
    pid = PipelineId(0, 1)
    b = DisplayListBuilder(pid)
    b.begin()
    root = SpatialId.root_scroll_node(pid)
    common = CommonItemProperties(Rect(0, 0, 384, 192), root)
    b.push_rect(common, Rect(0, 0, 384, 192), ColorF(0.9, 0.92, 0.95, 1))
    g, stops = b.create_gradient(
        Point2D(0, 0), Point2D(40, 10),
        [GradientStop(0.0, ColorF(1, 0, 0, 1)),
         GradientStop(0.3, ColorF(1, 1, 0, 0.5)),
         GradientStop(0.3, ColorF(0, 1, 0, 1)),
         GradientStop(0.7, ColorF(0, 0, 1, 0.8)),
         GradientStop(1.0, ColorF(1, 0, 1, 1))], ExtendMode.REPEAT)
    b.push_gradient(common, Rect(8, 8, 170, 70), g, stops,
                    tile_size=Size2D(60, 30), tile_spacing=Size2D(6, 4))
    rot = b.push_reference_frame(Point2D(260, 60), root, None,
                                 Transform.rotation_z(23.0), None)
    rot_common = CommonItemProperties(Rect(-100, -100, 200, 200), rot)
    b.push_rect(rot_common, Rect(-50, -30, 100, 60),
                ColorF(0.2, 0.5, 0.9, 0.9))
    rclip = b.define_clip_rounded_rect(rot, Rect(-40, -40, 80, 80),
                                       BorderRadius.uniform(12.0))
    b.push_rect(dataclasses.replace(
        rot_common, clip_chain_id=b.define_clip_chain(None, [rclip])),
        Rect(-45, -20, 90, 40), ColorF(0.9, 0.3, 0.1, 0.7))
    b.pop_reference_frame()
    radii = BorderRadius(Size2D(20, 10), Size2D(5, 5), Size2D(30, 15),
                         Size2D(0, 0))
    chain = b.define_clip_chain(None, [
        b.define_clip_rounded_rect(root, Rect(20, 90, 150, 90), radii),
        b.define_clip_rect(root, Rect(30.5, 95.25, 120, 70)),
        b.define_clip_rounded_rect(root, Rect(60, 110, 40, 40),
                                   BorderRadius.uniform(20.0),
                                   ClipMode.CLIP_OUT)])
    b.push_rect(dataclasses.replace(common, clip_chain_id=chain),
                Rect(0, 80, 200, 112), ColorF(0.1, 0.6, 0.3, 0.85))
    return _finish(backend, pid, b)


SMALL_FRAMES = {"clip_gradient": (clip_gradient_scene, (256, 128)),
                "text_run": (text_run_scene, (256, 64)),
                "images": (image_scene, (384, 256)),
                "branches": (branches_scene, (384, 192))}


# --- kernel inputs of one frame --------------------------------------------

def kernel_inputs(backend) -> dict:
    """The tile-raster kernel's arguments for the backend's frame (its one
    merged root pass), on the renderer's device."""
    r = backend.renderer
    frame = backend.build_frame()
    r.apply_uploads(backend.resources.take_uploads())
    from .renderer.renderer import merged_root_passes
    (p,) = merged_root_passes(frame)
    a = r.kernel_args(frame, p)
    return dict(dense=a["dense"], counts=a["tile_counts"],
                origins=a["tile_origins"], clear=a["clear_color"],
                f32_rows=a["f32_rows"], alpha_atlas=r.alpha_atlas,
                surface_atlas=r.surface_atlas, color_atlas=r.color_atlas,
                kinds=a["kinds"], blends=a["blends"], nx=p.nx, ny=p.ny,
                region=p.region)


# --- glyphs without a font stack --------------------------------------------

# (scene, device size, extra arguments) of every text scene the recording
# covers: the 4K bench frame, its 640x384 slice and the short text run
TEXT_SCENES = ((build_4k_scene, (3840, 2160), ()),
               (build_4k_scene, (640, 384), (640, 384, 12, 4, 8, 4)),
               (text_run_scene, (256, 64), ()))


def record_glyphs(path) -> None:
    """Builds the frames of TEXT_SCENES with the real font stack and saves
    every glyph answer they needed."""
    from .render_backend import RenderBackend
    from .resources import RecordingFontContext, ResourceCache
    from webrender_tpu.resources.resource_cache import FontContext
    rec = RecordingFontContext(FontContext())
    for make, size, extra in TEXT_SCENES:
        backend = RenderBackend(size, device="cpu",
                                resources=ResourceCache(fonts=rec))
        make(backend, *extra).build_frame()
    rec.save(path)


def resource_cache():
    """A port ResourceCache: the font stack where it exists, else the
    recorded glyphs (which serve only TEXT_SCENES)."""
    from .resources import ReplayFontContext, ResourceCache
    if font_stack_available():
        return ResourceCache()
    return ResourceCache(fonts=ReplayFontContext(GLYPHS))


if __name__ == "__main__":
    GLYPHS.parent.mkdir(exist_ok=True)
    record_glyphs(GLYPHS)
    print(f"wrote {GLYPHS}")
