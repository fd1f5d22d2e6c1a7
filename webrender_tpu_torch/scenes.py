"""Scenes for the port: the 4K browsing frame of `bench.py`, the 4K
effects, content, zoomed and transformed frames, and the small frames its
kernel is checked on.

Every builder takes the backend to send its transaction to and, as the
keyword `api`, the API namespace to build with: the port's
(`webrender_tpu_torch.api`) by default.  A test hands the JAX package's
`api` to build the same display list for that package's backend.

`build_4k_scene` makes the display list of `bench.py:22-143` with the
same `RandomState(42)` draws in the same order.  `build_4k_effects_scene`
is that page with the effect groups of a content page on top: a blurred
hero header, drop-shadow cards, a grayscale drop-shadow avatar, an
opacity toast and a grayscale image strip (`effects_scene` is the same
groups on a 1024x512 page).  `build_4k_content_scene` is the same page
with the building blocks of a content page on top: box shadows, radial
and conic gradients, underlines, image-mask avatars and mix-blend groups
(`content_scene` on a 1024x512 page).  `build_4k_zoomed_scene` is the
browsing page under a page zoom (one scale reference frame around
everything, so every glyph is scaled text), with a planar YUV video,
clear rects and opacity groups on top (`zoomed_scene` on a 1024x512
device page); `video_tick` replaces the video's planes, as a playing
video does every frame.  `build_4k_transformed_scene` is the browsing
page with what CSS transforms and a gallery bring on top: rotated cards,
a skewed banner, thumbnails, tiled backgrounds, long gradients, rotated
mask and shadow clips, a tilted video (`transformed_scene` on a 1024x512
page; `general_reasons` says why each such instance has no path in the
TPU kernel); `oversized_group_scene` is a group whose surface passes 4096
px.  The small frames (`SMALL_FRAMES`)
cover the kernel's branches: solid, gradient and a rounded clip; a
subpixel text run (blends 7 and 8); images at several scales, repeating
and pixelated; and the less common coverage, clip and gradient branches.
`write_gl_documents` writes the port's wrench reftest documents and
manifests (`testdata/wrench/`, JSON, from a seed): seven small documents,
one group of features each, and a 3840x2160 page, all read in the GL
flavour on `platform(linux)` lines.

Text needs a font stack (matplotlib's ft2font, the system libfreetype and
matplotlib's DejaVu Sans).  Where it is missing, `resource_cache()` gives
a cache that replays `testdata/glyphs.npz`: the glyph indices, advances
and rasters that the text scenes here needed, recorded with the font stack
(`python -m webrender_tpu_torch.scenes` rewrites it; a test holds it equal
to a fresh recording).
"""
from __future__ import annotations

import dataclasses
import math
import pathlib
import sys

import numpy as np

from . import api as port_api

TESTDATA = pathlib.Path(__file__).resolve().parent / "testdata"
GLYPHS = TESTDATA / "glyphs.npz"
# the JAX package's RGBA8 of the small frames, the small effects,
# content, zoomed, transformed, SVG-filter and CSS-3D frames and the small
# GL reftest documents (tests/torch_twin.py writes it; tests hold it equal
# to a fresh JAX render)
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


def _finish(A, backend, pid, b, txn=None):
    _, dl = b.end()
    txn = txn or A.Transaction()
    txn.set_root_pipeline(pid)
    txn.set_display_list(A.Epoch(0), dl)
    txn.generate_frame()
    backend.send_transaction(txn)
    return backend


def _add_font(A, backend):
    """Registers DejaVu Sans 16 px; returns a layout(text, x, y) that
    places its glyphs on one baseline."""
    fk = A.FontKey(0, 1)
    fik = A.FontInstanceKey(0, 9)
    pre = A.Transaction()
    pre.add_native_font(fk, dejavu_path())
    pre.add_font_instance(fik, fk, 16.0, A.FontInstanceOptions())
    backend.send_transaction(pre)

    def layout(text, x, y):
        glyphs = []
        for ch in text:
            gi = backend.resources.fonts.glyph_index(fk, ch)
            glyphs.append((gi, x, y))
            x += backend.resources.fonts.linear_advance(fk, 16.0, gi)
        return glyphs
    return fik.key, layout


def _browsing_page(A, backend, b, txn, w, h, n_rects, n_grads, n_images,
                   n_text, parent=None, feed_x=3300):
    """bench.py's page items onto builder `b` (images into `txn`), under
    the spatial node `parent` (the root scroll node by default), the
    scroll feed at `feed_x`; returns `_add_font`'s (font, layout) when the
    page has text, else None."""
    root = parent if parent is not None else \
        A.SpatialId.root_scroll_node(b.pipeline_id)
    common = A.CommonItemProperties(A.Rect(0, 0, w, h), root)
    rng = np.random.RandomState(42)

    b.push_rect(common, A.Rect(0, 0, w, h), A.ColorF(0.95, 0.95, 0.97, 1.0))
    feed = b.define_scroll_frame(root, external_id=777,
                                 content_rect=A.Rect(feed_x, 80, 480, 6000),
                                 frame_rect=A.Rect(feed_x, 80, 480, 1900))
    feed_common = A.CommonItemProperties(A.Rect(0, 0, w, 6000), feed)
    for i in range(40):
        b.push_rect(feed_common, A.Rect(feed_x + 10, 90 + i * 150, 460, 130),
                    A.ColorF(0.85, 0.88, 0.93, 1.0))
        b.push_rect(feed_common, A.Rect(feed_x + 20, 100 + i * 150, 200, 24),
                    A.ColorF(float(rng.rand()), 0.3, 0.6, 1.0))
    for i in range(n_rects):
        x = float(rng.uniform(0, w - 200))
        y = float(rng.uniform(0, h - 120))
        rw = float(rng.uniform(40, 200))
        rh = float(rng.uniform(30, 120))
        alpha = 1.0 if i % 2 else 0.85
        b.push_rect(common, A.Rect(x, y, rw, rh),
                    A.ColorF(float(rng.rand()), float(rng.rand()),
                             float(rng.rand()), alpha))
    for i in range(n_grads):
        x = float(rng.uniform(0, w - 256))
        y = float(rng.uniform(0, h - 128))
        g, stops = b.create_gradient(
            A.Point2D(0, 0), A.Point2D(256, 0),
            [A.GradientStop(0.0, A.ColorF(1, 0.2, 0.1, 1)),
             A.GradientStop(0.5, A.ColorF(0.2, 0.6, 1, 1)),
             A.GradientStop(1.0, A.ColorF(0.1, 1, 0.4, 1))],
            A.ExtendMode.CLAMP)
        b.push_gradient(common, A.Rect(x, y, 256, 96), g, stops)
    for k in range(8):
        px = (rng.rand(96, 96, 4) * 255).astype(np.uint8)
        px[..., 3] = 255
        txn.add_image(100 + k,
                      A.ImageDescriptor(
                          A.ImageFormat.RGBA8, 96, 96,
                          flags=A.ImageDescriptorFlags.IS_OPAQUE),
                      A.ImageData(pixels=px))
    for i in range(n_images):
        key = 100 + (i % 8)
        x = float(rng.uniform(0, w - 220))
        y = float(rng.uniform(0, h - 220))
        scale = (0.75, 1.0, 1.5, 2.0)[i % 4]
        s = 96 * scale
        if i % 10 == 0:
            b.push_repeating_image(
                common, A.Rect(x, y, 280, 180), A.Size2D(64, 64),
                A.Size2D(8, 8), A.ImageRendering.AUTO,
                A.AlphaType.PREMULTIPLIED_ALPHA, key)
        else:
            b.push_image(common, A.Rect(x, y, s, s), A.ImageRendering.AUTO,
                         A.AlphaType.PREMULTIPLIED_ALPHA, key)

    fonts = None
    if n_text > 0:
        fonts = font, layout = _add_font(A, backend)
        words = ("the quick brown fox jumps over the lazy dog "
                 "pack my box with five dozen liquor jugs").split()
        for i in range(n_text):
            x = float(rng.uniform(0, w - 600))
            y = float(rng.uniform(20, h - 20))
            text = " ".join(words[(i * 3 + j) % len(words)]
                            for j in range(6))
            b.push_text(common, A.Rect(x, y - 16, 600, 24),
                        layout(text, x, y), font,
                        A.ColorF(0.1, 0.1, 0.15, 1.0))

    clip = b.define_clip_rounded_rect(root, A.Rect(100, 100, 600, 400),
                                      A.BorderRadius.uniform(40.0))
    chain = b.define_clip_chain(None, [clip])
    b.push_rect(dataclasses.replace(common, clip_chain_id=chain),
                A.Rect(0, 0, 800, 600), A.ColorF(0.1, 0.1, 0.4, 0.6))
    return fonts


def build_4k_scene(backend, w=3840, h=2160, n_rects=400, n_grads=100,
                   n_images=80, n_text=60, *, api=None):
    """`bench.build_4k_scene` on `backend`: background, a scroll feed,
    solid rects (half at alpha 0.85), three-stop gradients, images at
    0.75-2x and repeats, text runs and one rounded-rect clip.  The fonts
    are registered only when `n_text` > 0."""
    A = api or port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    txn = A.Transaction()
    _browsing_page(A, backend, b, txn, w, h, n_rects, n_grads, n_images,
                   n_text)
    return _finish(A, backend, pid, b, txn)


# --- the effect groups of a content page ------------------------------------

# (x, y, w, h) of each group, on the 4K page and on the 1024x512 page
EFFECTS_4K = dict(
    hero=(80, 80, 1280, 480),
    cards=[(1440 + 400 * (i % 4), 120 + 260 * (i // 4), 360, 200)
           for i in range(12)],
    avatar=(120, 640, 96, 96),
    toast=(400, 680, 480, 64),
    strip=[(80 + 200 * i, 1880, 160, 120) for i in range(6)])
EFFECTS_SMALL = dict(
    hero=(16, 16, 320, 160),
    cards=[(368 + 224 * (i % 2), 16 + 136 * (i // 2), 200, 112)
           for i in range(4)],
    avatar=(848, 24, 96, 96),
    toast=(368, 312, 300, 56),
    strip=[(16 + 112 * i, 400, 96, 72) for i in range(6)])


def _effect_groups(A, b, txn, layout, font, places,
                   hero_bar=(0.1, 0.1, 0.2, 0.8)):
    """The filtered stacking contexts of a content page, painted last:

    * hero: `blur(12, 12)` over a gradient, an image and two rects (the
      second of color `hero_bar`);
    * cards: each a white rect in a rounded clip with one text run, under
      `drop-shadow(0 6px 8px rgba(0, 0, 0, .35))`;
    * avatar: an image under `grayscale(1) drop-shadow(0 4px 6px
      rgba(0, 0, 0, .4))`;
    * toast: two rects under `opacity(0.6)`;
    * strip: images under `grayscale(1)`."""
    root = A.SpatialId.root_scroll_node(b.pipeline_id)
    origin = A.Point2D(0, 0)
    rng = np.random.RandomState(21)
    px = (rng.rand(64, 64, 4) * 255).astype(np.uint8)
    px[..., 3] = 255
    txn.add_image(200, A.ImageDescriptor(
        A.ImageFormat.RGBA8, 64, 64,
        flags=A.ImageDescriptorFlags.IS_OPAQUE), A.ImageData(pixels=px))

    def common(x, y, w, h):
        return A.CommonItemProperties(A.Rect(x, y, w, h), root)

    x, y, w, h = places["hero"]
    b.push_stacking_context(origin, root, filters=[A.FilterOp.blur(12, 12)])
    g, stops = b.create_gradient(
        A.Point2D(0, 0), A.Point2D(w, h),
        [A.GradientStop(0.0, A.ColorF(0.2, 0.3, 0.8, 1)),
         A.GradientStop(1.0, A.ColorF(0.9, 0.4, 0.5, 1))],
        A.ExtendMode.CLAMP)
    b.push_gradient(common(x, y, w, h), A.Rect(x, y, w, h), g, stops)
    b.push_image(common(x, y, w, h),
                 A.Rect(x + w * 0.55, y + h * 0.15, h * 0.7, h * 0.7),
                 A.ImageRendering.AUTO, A.AlphaType.PREMULTIPLIED_ALPHA,
                 200)
    b.push_rect(common(x, y, w, h),
                A.Rect(x + w * 0.06, y + h * 0.2, w * 0.4, h * 0.18),
                A.ColorF(1, 1, 1, 0.9))
    b.push_rect(common(x, y, w, h),
                A.Rect(x + w * 0.06, y + h * 0.5, w * 0.3, h * 0.1),
                A.ColorF(*hero_bar))
    b.pop_stacking_context()

    card_shadow = A.Shadow(A.Point2D(0, 6), A.ColorF(0, 0, 0, 0.35), 8.0)
    for i, (x, y, w, h) in enumerate(places["cards"]):
        b.push_stacking_context(origin, root, filters=[A.FilterOp(
            A.FilterOpKind.DROP_SHADOW, shadow=card_shadow)])
        clip = b.define_clip_rounded_rect(root, A.Rect(x, y, w, h),
                                          A.BorderRadius.uniform(12.0))
        chain = b.define_clip_chain(None, [clip])
        b.push_rect(dataclasses.replace(common(x, y, w, h),
                                        clip_chain_id=chain),
                    A.Rect(x, y, w, h), A.ColorF(1, 1, 1, 1))
        if layout is not None:
            b.push_text(common(x, y, w, h), A.Rect(x + 16, y + 16, w - 32, 24),
                        layout(f"card {i + 1} pack my box", x + 16.0,
                               y + 34.0),
                        font, A.ColorF(0.1, 0.1, 0.15, 1.0))
        b.pop_stacking_context()

    x, y, w, h = places["avatar"]
    b.push_stacking_context(origin, root, filters=[
        A.FilterOp(A.FilterOpKind.GRAYSCALE, 1.0),
        A.FilterOp(A.FilterOpKind.DROP_SHADOW, shadow=A.Shadow(
            A.Point2D(0, 4), A.ColorF(0, 0, 0, 0.4), 6.0))])
    b.push_image(common(x, y, w, h), A.Rect(x, y, w, h),
                 A.ImageRendering.AUTO, A.AlphaType.PREMULTIPLIED_ALPHA, 200)
    b.pop_stacking_context()

    x, y, w, h = places["toast"]
    b.push_stacking_context(origin, root, filters=[A.FilterOp.opacity(0.6)])
    b.push_rect(common(x, y, w, h), A.Rect(x, y, w, h),
                A.ColorF(0.15, 0.15, 0.18, 1))
    b.push_rect(common(x, y, w, h), A.Rect(x + 12, y + 12, h - 24, h - 24),
                A.ColorF(0.3, 0.8, 0.4, 1))
    b.pop_stacking_context()

    b.push_stacking_context(origin, root, filters=[
        A.FilterOp(A.FilterOpKind.GRAYSCALE, 1.0)])
    for i, (x, y, w, h) in enumerate(places["strip"]):
        b.push_image(common(x, y, w, h), A.Rect(x, y, w, h),
                     A.ImageRendering.AUTO, A.AlphaType.PREMULTIPLIED_ALPHA,
                     200 if i % 2 else 100)
    b.pop_stacking_context()


def build_4k_effects_scene(backend, w=3840, h=2160, *, api=None):
    """The 4K browsing page (`build_4k_scene`, counts unchanged) with the
    effect groups of a content page on top (`_effect_groups`)."""
    A = api or port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    txn = A.Transaction()
    font, layout = _browsing_page(A, backend, b, txn, w, h, 400, 100, 80,
                                  60)
    _effect_groups(A, b, txn, layout, font, EFFECTS_4K)
    return _finish(A, backend, pid, b, txn)


# --- the building blocks of a content page ----------------------------------

# (x, y, w, h) of each group, on the 4K page and on the 1024x512 page; the
# blend groups are (mode name, rect)
CONTENT_4K = dict(
    hero=(80, 80, 1280, 480),
    badge=(1400, 100, 160, 160),
    cards=[(1440 + 400 * (i % 4), 300 + 240 * (i // 4), 360, 200)
           for i in range(16)],
    fields=[(120, 640, 480, 40), (120, 700, 480, 40)],
    buttons=[(120 + 200 * i, 780, 160, 48) for i in range(4)],
    pies=[(80 + 260 * i, 1300, 200, 200) for i in range(4)],
    avatars=[(1440 + 130 * i, 1300, 96, 96) for i in range(6)],
    blends=[("MULTIPLY", (200, 200, 320, 120)),
            ("SCREEN", (700, 300, 420, 160)),
            ("DIFFERENCE", (3340, 300, 400, 200)),
            ("LUMINOSITY", (3340, 700, 300, 200))])
CONTENT_SMALL = dict(
    hero=(16, 16, 400, 150),
    badge=(432, 16, 96, 96),
    cards=[(544 + 240 * (i % 2), 16 + 136 * (i // 2), 220, 112)
           for i in range(4)],
    fields=[(16, 184, 300, 32), (16, 228, 300, 32)],
    buttons=[(340 + 120 * i, 190, 100, 36) for i in range(2)],
    pies=[(16 + 140 * i, 300, 120, 120) for i in range(2)],
    avatars=[(300 + 110 * i, 300, 96, 96) for i in range(2)],
    blends=[("MULTIPLY", (40, 40, 200, 80)),
            ("SCREEN", (240, 70, 160, 80)),
            ("DIFFERENCE", (600, 60, 200, 100)),
            ("LUMINOSITY", (40, 320, 150, 90))])
# the underline of each card's title, by card: dotted, dashed or wavy
UNDERLINES = ("DOTTED", "DOTTED", "DASHED", "WAVY")


def _seeded_images(A, txn, rng):
    """The content page's images: an avatar photo (300), a circular RGBA8
    mask (301) with a seeded rim, a logo (302) and a thumbnail (303)."""
    def rgba(n):
        px = (rng.rand(n, n, 4) * 255).astype(np.uint8)
        px[..., 3] = 255
        return px
    yy, xx = np.mgrid[0:96, 0:96] + 0.5
    dist = np.hypot(xx - 48.0, yy - 48.0)
    cov = np.clip(46.0 - dist + rng.uniform(-0.5, 0.5, (96, 96)), 0.0, 1.0)
    mask = np.repeat((cov * 255.0 + 0.5).astype(np.uint8)[..., None], 4, 2)
    for key, px, opaque in ((300, rgba(96), True), (301, mask, False),
                            (302, rgba(64), True), (303, rgba(96), True)):
        flags = A.ImageDescriptorFlags.IS_OPAQUE if opaque else \
            A.ImageDescriptorFlags.NONE
        txn.add_image(key, A.ImageDescriptor(
            A.ImageFormat.RGBA8, px.shape[1], px.shape[0], flags=flags),
            A.ImageData(pixels=px))


def _content_groups(A, b, txn, layout, font, places,
                    difference=(0.95, 0.9, 0.3, 1.0)):
    """The building blocks of a content page, painted last:

    * cards: `box-shadow: 0 2px 8px 0 rgba(0, 0, 0, .25)` (blurred outset:
      a solid rect under a rounded clip and a box-shadow nine-patch clip),
      a white rect in a rounded clip, a title and a dotted, dashed or 2 px
      wavy underline under its first word (`UNDERLINES`, in turn);
    * input fields: `box-shadow: inset 0 1px 3px rgba(0, 0, 0, .3)`;
    * buttons: a sharp `4px 4px 0 0` shadow (`KIND_BOX_SHADOW`, sigma 0);
    * a hero banner with an elliptical three-stop radial gradient and a
      badge with a repeating radial gradient;
    * pie charts: five-segment hard-stop conic gradients in circular
      clips;
    * avatars: an image under a 96x96 circular image-mask clip;
    * blend groups: stacking contexts with `mix-blend-mode` MULTIPLY (a
      logo image and text), SCREEN (a rect and a gradient), DIFFERENCE (a
      rect of color `difference`) and LUMINOSITY (a thumbnail image)."""
    root = A.SpatialId.root_scroll_node(b.pipeline_id)
    origin = A.Point2D(0, 0)
    _seeded_images(A, txn, np.random.RandomState(31))
    auto, premul = A.ImageRendering.AUTO, A.AlphaType.PREMULTIPLIED_ALPHA

    def common(x, y, w, h, pad=0, clip=None):
        c = A.CommonItemProperties(
            A.Rect(x - pad, y - pad, w + 2 * pad, h + 2 * pad), root)
        if clip is not None:
            c = dataclasses.replace(c, clip_chain_id=b.define_clip_chain(
                None, [clip]))
        return c

    def rounded(x, y, w, h, r):
        return b.define_clip_rounded_rect(root, A.Rect(x, y, w, h),
                                          A.BorderRadius.uniform(float(r)))

    x, y, w, h = places["hero"]
    g, stops = b.create_radial_gradient(
        A.Point2D(w * 0.5, h * 0.45), A.Size2D(w * 0.55, h * 0.7),
        [A.GradientStop(0.0, A.ColorF(1.0, 0.85, 0.4, 1)),
         A.GradientStop(0.55, A.ColorF(0.9, 0.3, 0.5, 1)),
         A.GradientStop(1.0, A.ColorF(0.2, 0.1, 0.5, 1))],
        A.ExtendMode.CLAMP)
    b.push_radial_gradient(common(x, y, w, h), A.Rect(x, y, w, h), g, stops)
    x, y, w, h = places["badge"]
    g, stops = b.create_radial_gradient(
        A.Point2D(w * 0.5, h * 0.5), A.Size2D(14, 14),
        [A.GradientStop(0.0, A.ColorF(0.1, 0.5, 0.9, 1)),
         A.GradientStop(0.6, A.ColorF(0.95, 0.95, 1.0, 1)),
         A.GradientStop(1.0, A.ColorF(0.1, 0.5, 0.9, 1))],
        A.ExtendMode.REPEAT)
    b.push_radial_gradient(common(x, y, w, h, clip=rounded(x, y, w, h, 24)),
                           A.Rect(x, y, w, h), g, stops)

    ink = A.ColorF(0.1, 0.1, 0.15, 1.0)
    for i, (x, y, w, h) in enumerate(places["cards"]):
        b.push_box_shadow(common(x, y, w, h, pad=40), A.Rect(x, y, w, h),
                          A.Point2D(0, 2), A.ColorF(0, 0, 0, 0.25), 8.0, 0.0,
                          A.BorderRadius.uniform(12.0),
                          A.BoxShadowClipMode.OUTSET)
        b.push_rect(common(x, y, w, h, clip=rounded(x, y, w, h, 12)),
                    A.Rect(x, y, w, h), A.ColorF(1, 1, 1, 1))
        tx, ty = x + 16.0, y + 34.0
        word = layout("card ", tx, ty)
        b.push_text(common(x, y, w, h), A.Rect(x + 16, y + 16, w - 32, 24),
                    layout(f"card {i + 1} pack my box", tx, ty), font, ink)
        style = getattr(A.LineStyle, UNDERLINES[i % len(UNDERLINES)])
        wavy = style == A.LineStyle.WAVY
        lw = word[-1][1] - tx  # the first word, up to the space
        lh = 6.0 if wavy else 2.0
        b.push_line(common(tx, ty + 3, lw, lh), A.Rect(tx, ty + 3, lw, lh),
                    2.0 if wavy else 0.0, A.LineOrientation.HORIZONTAL,
                    A.ColorF(0.85, 0.2, 0.2, 1.0), style)

    for x, y, w, h in places["fields"]:
        b.push_rect(common(x, y, w, h, clip=rounded(x, y, w, h, 4)),
                    A.Rect(x, y, w, h), A.ColorF(1, 1, 1, 1))
        b.push_box_shadow(common(x, y, w, h), A.Rect(x, y, w, h),
                          A.Point2D(0, 1), A.ColorF(0, 0, 0, 0.3), 3.0, 0.0,
                          A.BorderRadius.uniform(4.0),
                          A.BoxShadowClipMode.INSET)

    for x, y, w, h in places["buttons"]:
        b.push_box_shadow(common(x, y, w, h, pad=8), A.Rect(x, y, w, h),
                          A.Point2D(4, 4), A.ColorF(0.1, 0.1, 0.25, 0.6),
                          0.0, 0.0, A.BorderRadius.uniform(6.0),
                          A.BoxShadowClipMode.OUTSET)
        b.push_rect(common(x, y, w, h, clip=rounded(x, y, w, h, 6)),
                    A.Rect(x, y, w, h), A.ColorF(0.2, 0.45, 0.9, 1))

    colors = [A.ColorF(0.9, 0.3, 0.3, 1), A.ColorF(0.95, 0.7, 0.2, 1),
              A.ColorF(0.3, 0.75, 0.4, 1), A.ColorF(0.25, 0.5, 0.9, 1),
              A.ColorF(0.6, 0.35, 0.8, 1)]
    edges = (0.0, 0.25, 0.45, 0.6, 0.8, 1.0)
    for x, y, w, h in places["pies"]:
        pie = []
        for k, c in enumerate(colors):
            pie += [A.GradientStop(edges[k], c),
                    A.GradientStop(edges[k + 1], c)]
        g, stops = b.create_conic_gradient(A.Point2D(w * 0.5, h * 0.5), 0.0,
                                           pie, A.ExtendMode.CLAMP)
        b.push_conic_gradient(
            common(x, y, w, h, clip=rounded(x, y, w, h, w // 2)),
            A.Rect(x, y, w, h), g, stops)

    for x, y, w, h in places["avatars"]:
        mask = b.define_clip_image_mask(root, A.Rect(x, y, w, h), 301)
        b.push_image(common(x, y, w, h, clip=mask), A.Rect(x, y, w, h),
                     auto, premul, 300)

    for mode, (x, y, w, h) in places["blends"]:
        b.push_stacking_context(origin, root,
                                mix_blend_mode=getattr(A.MixBlendMode, mode))
        if mode == "MULTIPLY":
            b.push_image(common(x, y, w, h), A.Rect(x, y, h, h), auto,
                         premul, 302)
            b.push_text(common(x, y, w, h), A.Rect(x + h, y, w - h, 24),
                        layout("pack my box", x + h + 8.0, y + 30.0), font,
                        A.ColorF(0.2, 0.1, 0.4, 1.0))
        elif mode == "SCREEN":
            b.push_rect(common(x, y, w, h), A.Rect(x, y, w, h * 0.5),
                        A.ColorF(0.2, 0.3, 0.6, 1))
            g, stops = b.create_gradient(
                A.Point2D(0, 0), A.Point2D(w, 0),
                [A.GradientStop(0.0, A.ColorF(0.9, 0.2, 0.1, 1)),
                 A.GradientStop(1.0, A.ColorF(0.1, 0.8, 0.3, 1))],
                A.ExtendMode.CLAMP)
            b.push_gradient(common(x, y, w, h),
                            A.Rect(x, y + h * 0.5, w, h * 0.5), g, stops)
        elif mode == "DIFFERENCE":
            b.push_rect(common(x, y, w, h), A.Rect(x, y, w, h),
                        A.ColorF(*difference))
        else:
            b.push_image(common(x, y, w, h), A.Rect(x, y, w, h), auto,
                         premul, 303)
        b.pop_stacking_context()


def build_4k_content_scene(backend, w=3840, h=2160, *, api=None):
    """The 4K browsing page (`build_4k_scene`, counts unchanged) with the
    building blocks of a content page on top (`_content_groups`)."""
    A = api or port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    txn = A.Transaction()
    font, layout = _browsing_page(A, backend, b, txn, w, h, 400, 100, 80,
                                  60)
    _content_groups(A, b, txn, layout, font, CONTENT_4K)
    return _finish(A, backend, pid, b, txn)


def content_scene(backend, *, api=None, difference=(0.95, 0.9, 0.3, 1.0)):
    """The content-page groups alone on a 1024x512 page (fewer of each);
    `difference` colors the rect of the DIFFERENCE group."""
    A = api or port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    txn = A.Transaction()
    root = A.SpatialId.root_scroll_node(pid)
    b.push_rect(A.CommonItemProperties(A.Rect(0, 0, 1024, 512), root),
                A.Rect(0, 0, 1024, 512), A.ColorF(0.95, 0.95, 0.97, 1.0))
    font, layout = _add_font(A, backend)
    _content_groups(A, b, txn, layout, font, CONTENT_SMALL, difference)
    return _finish(A, backend, pid, b, txn)


# --- the zoomed page with video ---------------------------------------------

# the video's three R8 planes (Y, U, V)
VIDEO_KEYS = (400, 401, 402)
# (x, y, w, h) of each group in the page's local (unzoomed) space, on the
# 4K page and on the 1024x512 page; both fit the local page of zoom 2.0.
# `video` is the drawn rect and `video_size` the Y plane's size (U and V
# are half of it each way); a clear is (rect, radius of its rounded clip
# or None); `text` is the run that the last clear crosses
MEDIA_4K = dict(
    video=(80, 80, 1280, 720), video_size=(1280, 720),
    clears=[((1000, 560, 320, 180), None), ((1420, 120, 300, 200), 24),
            ((1500, 396, 200, 40), None)],
    text=(1420, 420),
    toast=(80, 840, 480, 64),
    chips=[(600 + 200 * i, 848, 160, 48) for i in range(4)])
MEDIA_SMALL = dict(
    video=(8, 8, 240, 135), video_size=(320, 180),
    clears=[((150, 80, 60, 40), None), ((260, 100, 100, 60), 12),
            ((300, 184, 60, 24), None)],
    text=(264, 202),
    toast=(260, 8, 200, 40),
    chips=[(260 + 100 * i, 56, 90, 32) for i in range(2)])


def video_planes(seed, size):
    """The Y, U and V planes (uint8; U and V at half size each way) of one
    video frame, in 4x4 blocks: ramps that move with `seed`, and seeded
    noise."""
    rng = np.random.RandomState(seed)
    w, h = size
    planes = []
    for k, (pw, ph) in enumerate(((w, h), (w // 2, h // 2),
                                  (w // 2, h // 2))):
        yy, xx = np.mgrid[0:-(-ph // 4), 0:-(-pw // 4)]
        ramp = (xx * (8 + 4 * k) + yy * (12 - 4 * k) + 37 * seed) % 256
        blocks = np.clip(ramp + rng.randint(-24, 25, ramp.shape), 0, 255)
        planes.append(np.kron(blocks, np.ones((4, 4), int))[:ph, :pw]
                      .astype(np.uint8))
    return planes


def _plane_descriptor(A, plane):
    return A.ImageDescriptor(A.ImageFormat.R8, plane.shape[1],
                             plane.shape[0])


def video_tick(backend, seed=0, size=(1280, 720), *, api=None, planes=None):
    """A video tick: `update_image` of the three planes (`planes`, or
    `video_planes` of `seed`) and a new frame."""
    A = api or port_api
    txn = A.Transaction()
    if planes is None:
        planes = video_planes(seed, size)
    for key, plane in zip(VIDEO_KEYS, planes):
        txn.update_image(key, _plane_descriptor(A, plane),
                         A.ImageData(pixels=plane))
    txn.generate_frame()
    backend.send_transaction(txn)
    return backend


def _media_groups(A, b, txn, layout, font, places, parent):
    """A video and what an embedder and a page put around it, painted
    last, under the spatial node `parent`:

    * a planar REC709 limited-range video (three R8 planes, `VIDEO_KEYS`);
    * clear rects: a punch-through hole inside the video, one under a
      rounded-rect clip, one crossing a text run;
    * a toast and chips, each a rect with a text run in an `opacity(0.6)`
      stacking context (the text is grayscale inside the surface)."""
    origin = A.Point2D(0, 0)

    def common(x, y, w, h, clip=None):
        c = A.CommonItemProperties(A.Rect(x, y, w, h), parent)
        if clip is not None:
            c = dataclasses.replace(c, clip_chain_id=b.define_clip_chain(
                None, [clip]))
        return c

    for key, plane in zip(VIDEO_KEYS, video_planes(0, places["video_size"])):
        txn.add_image(key, _plane_descriptor(A, plane),
                      A.ImageData(pixels=plane))
    x, y, w, h = places["video"]
    b.push_yuv_image(common(x, y, w, h), A.Rect(x, y, w, h), VIDEO_KEYS,
                     "planar", A.ColorDepth.COLOR8, A.YuvColorSpace.REC709,
                     A.ColorRange.LIMITED, A.ImageRendering.AUTO)

    ink = A.ColorF(0.1, 0.1, 0.15, 1.0)
    tx, ty = places["text"]
    b.push_text(common(tx, ty - 18, 400, 28), A.Rect(tx, ty - 18, 400, 28),
                layout("pack my box with five jugs", float(tx), float(ty)),
                font, ink)
    for (x, y, w, h), radius in places["clears"]:
        clip = None if radius is None else b.define_clip_rounded_rect(
            parent, A.Rect(x, y, w, h), A.BorderRadius.uniform(float(radius)))
        b.push_clear_rect(common(x, y, w, h, clip), A.Rect(x, y, w, h))

    for i, (x, y, w, h) in enumerate([places["toast"]] + places["chips"]):
        b.push_stacking_context(origin, parent,
                                filters=[A.FilterOp.opacity(0.6)])
        b.push_rect(common(x, y, w, h), A.Rect(x, y, w, h),
                    A.ColorF(0.15, 0.15, 0.18, 1) if i == 0 else
                    A.ColorF(0.2, 0.45, 0.9, 1))
        b.push_text(common(x, y, w, h), A.Rect(x, y, w, h),
                    layout("saved to box" if i == 0 else f"tag {i}",
                           x + 10.0, y + h * 0.5 + 6.0),
                    font, A.ColorF(1, 1, 1, 1))
        b.pop_stacking_context()


def _zoom_frame(A, b, zoom):
    """The page zoom: one scale reference frame under the root."""
    root = A.SpatialId.root_scroll_node(b.pipeline_id)
    return b.push_reference_frame(A.Point2D(0, 0), root,
                                  A.TransformStyle.FLAT,
                                  A.Transform.scale(zoom, zoom))


def build_4k_zoomed_scene(backend, w=3840, h=2160, zoom=1.25, *, api=None):
    """The 4K browsing page (`build_4k_scene`, counts unchanged) laid out
    on a local page of w/zoom x h/zoom under a page zoom, with a video,
    clear rects and opacity groups on top (`_media_groups`)."""
    A = api or port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    txn = A.Transaction()
    page = _zoom_frame(A, b, zoom)
    lw, lh = w / zoom, h / zoom
    font, layout = _browsing_page(A, backend, b, txn, lw, lh, 400, 100, 80,
                                  60, parent=page, feed_x=lw - 540)
    _media_groups(A, b, txn, layout, font, MEDIA_4K, page)
    b.pop_reference_frame()
    return _finish(A, backend, pid, b, txn)


def zoomed_scene(backend, zoom=1.25, *, api=None):
    """A few items of the browsing page and the media groups on a 1024x512
    device page under a page zoom (a 320x180 video drawn at 240x135)."""
    A = api or port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    txn = A.Transaction()
    page = _zoom_frame(A, b, zoom)
    lw, lh = 1024 / zoom, 512 / zoom
    common = A.CommonItemProperties(A.Rect(0, 0, lw, lh), page)
    b.push_rect(common, A.Rect(0, 0, lw, lh), A.ColorF(0.95, 0.95, 0.97, 1.0))
    rng = np.random.RandomState(42)
    px = np.kron((rng.rand(12, 12, 4) * 255).astype(np.uint8),
                 np.ones((8, 8, 1), np.uint8))  # 8x8 blocks
    px[..., 3] = 255
    txn.add_image(100, A.ImageDescriptor(
        A.ImageFormat.RGBA8, 96, 96,
        flags=A.ImageDescriptorFlags.IS_OPAQUE), A.ImageData(pixels=px))
    for i, (x, y, rw, rh) in enumerate(((20.5, 150.25, 90, 40),
                                        (70, 170, 120, 50),
                                        (400, 140, 100, 90))):
        b.push_rect(common, A.Rect(x, y, rw, rh),
                    A.ColorF(0.2 + 0.3 * i, 0.5, 0.8 - 0.3 * i,
                             1.0 if i % 2 else 0.85))
    g, stops = b.create_gradient(
        A.Point2D(0, 0), A.Point2D(128, 0),
        [A.GradientStop(0.0, A.ColorF(1, 0.2, 0.1, 1)),
         A.GradientStop(0.5, A.ColorF(0.2, 0.6, 1, 1)),
         A.GradientStop(1.0, A.ColorF(0.1, 1, 0.4, 1))], A.ExtendMode.CLAMP)
    b.push_gradient(common, A.Rect(130, 150, 128, 48), g, stops)
    auto, premul = A.ImageRendering.AUTO, A.AlphaType.PREMULTIPLIED_ALPHA
    b.push_image(common, A.Rect(20, 200, 72, 72), auto, premul, 100)
    b.push_image(common, A.Rect(110.5, 205.25, 144, 48), auto, premul, 100)
    b.push_repeating_image(common, A.Rect(380, 60, 120, 70), A.Size2D(64, 64),
                           A.Size2D(8, 8), auto, premul, 100)
    font, layout = _add_font(A, backend)
    b.push_text(common, A.Rect(8, 224, 400, 28),
                layout("the quick brown fox jumps over", 8.0, 244.0), font,
                A.ColorF(0.1, 0.1, 0.15, 1.0))
    clip = b.define_clip_rounded_rect(page, A.Rect(390, 150, 110, 90),
                                      A.BorderRadius.uniform(16.0))
    b.push_rect(dataclasses.replace(
        common, clip_chain_id=b.define_clip_chain(None, [clip])),
        A.Rect(380, 140, 130, 110), A.ColorF(0.1, 0.1, 0.4, 0.6))
    _media_groups(A, b, txn, layout, font, MEDIA_SMALL, page)
    b.pop_reference_frame()
    return _finish(A, backend, pid, b, txn)


ZOOMS = (1.25, 2.0, 0.8)


# --- the transformed page ----------------------------------------------------

# (x, y, w, h) of each group on the 4K page and on the 1024x512 page.
# `cards` are (rect, degrees); `photo` is the size of the cards' and
# thumbnails' seeded sources and `thumb` the size a thumbnail is shown at
# (4.27 source texels a pixel); `pattern` is the tiled background's source
# size, `tiled` its 1:1 repeat and `spaced` its repeat with spacing;
# `mask` is the size of the mask image of `big_mask`, an axis-aligned
# avatar; `video` is (rect, degrees), `preview` the same video's small
# axis-aligned preview and `video_size` the Y plane's size
TRANSFORMED_4K = dict(
    cards=[((1440 + 400 * (i % 4), 120 + 300 * (i // 4), 300, 220),
            -4.0 + 8.0 * i / 11.0) for i in range(12)],
    banner=(1440, 1040, 900, 96),
    photo=(1024, 768), thumb=(240, 180),
    thumbs=[(80 + 260 * (i % 6), 1020 + 200 * (i // 6)) for i in range(24)],
    pattern=(320, 320), tiled=(80, 200, 1280, 640),
    spaced=(1700, 1200, 700, 360),
    legend=(80, 1840, 960, 48), wheel=(1100, 1780, 240, 240),
    rings=(1400, 1780, 240, 240),
    avatar=((2500, 1200, 192, 192), 10.0),
    inset=((2760, 1200, 260, 180), -6.0),
    outset=((3080, 1200, 260, 180), 5.0),
    mask=(512, 512), big_mask=(2500, 1460, 96, 96),
    video=((2500, 1620, 480, 270), 3.0), video_size=(640, 360),
    preview=(3060, 1760, 224, 126),
    toast=((3060, 1640, 420, 64), -3.0),
    note=(1440, 100), plain=(3500, 1300))
TRANSFORMED_SMALL = dict(
    cards=[((20, 24, 200, 140), -4.0), ((250, 24, 200, 140), 2.5),
           ((480, 24, 200, 140), 4.0)],
    banner=(720, 20, 280, 48),
    photo=(512, 384), thumb=(120, 90),
    thumbs=[(20 + 130 * i, 196) for i in range(4)],
    pattern=(288, 144), tiled=(548, 196, 340, 100),
    spaced=(548, 300, 340, 96),
    legend=(20, 300, 480, 24), wheel=(20, 340, 110, 110),
    rings=(150, 340, 110, 110),
    avatar=((290, 345, 96, 96), 10.0),
    inset=((410, 350, 120, 80), -6.0),
    outset=((560, 350, 110, 80), 5.0),
    mask=(512, 512), big_mask=(20, 460, 48, 48),
    video=((730, 84, 240, 135), 3.0), video_size=(640, 360),
    preview=(560, 446, 96, 54),
    toast=((690, 420, 180, 40), -3.0),
    note=(20, 16), plain=(904, 280))
CARDS_SCROLL_ID = 778
PHOTO_KEYS = (500, 501, 502, 503)
PATTERN_KEY, BIG_MASK_KEY, ROUND_MASK_KEY, ICON_KEY = 510, 511, 512, 513


def _blocky(rng, w, h, block, opaque=True):
    """A seeded RGBA8 image of `block`-sized squares (it compresses well
    in the goldens); premultiplied when not opaque."""
    cells = rng.randint(0, 256, (-(-h // block), -(-w // block), 4))
    px = np.kron(cells, np.ones((block, block, 1), int))[:h, :w]
    if opaque:
        px[..., 3] = 255
    else:
        px[..., :3] = px[..., :3] * px[..., 3:4] // 255
    return px.astype(np.uint8)


def _rainbow(A, n):
    """`n` stops around the color wheel, every fifth translucent."""
    stops = []
    for i in range(n):
        t = i / (n - 1.0)
        stops.append(A.GradientStop(t, A.ColorF(
            0.5 + 0.5 * math.cos(6.283 * t),
            0.5 + 0.5 * math.cos(6.283 * t + 2.1),
            0.5 + 0.5 * math.cos(6.283 * t + 4.2),
            0.7 if i % 5 == 4 else 1.0)))
    return stops


def _transformed_groups(A, backend, b, txn, layout, font, places, tilt=None,
                        card_parent=None):
    """What a page with CSS transforms and a gallery holds, painted last.
    Each item is one that the TPU kernel has no path for (its tiles are
    the JAX renderer's XLA tiles, the port's general tiles):

    * cards under `rotate()` reference frames (`tilt` replaces the first
      card's angle; `card_parent` is their spatial parent, the root scroll
      node by default), each a white rect in a rounded clip, a photo and a
      subpixel caption (the last card's in a grayscale font instance); a
      banner under a skew: an `opacity(0.8)` group of
      a rect and a text run (grayscale inside the surface);
    * a gallery of axis-aligned thumbnails below half their sources' size;
    * a tiled background: a pattern wider than 254 texels repeated 1:1,
      and a repeat with spacing;
    * a 24-stop linear gradient (a colour-scale legend), a 20-stop conic
      one in a circular clip (a colour wheel), a repeating 20-stop radial;
    * an avatar under an image-mask clip and a rotation; cards with an
      inset and an outset blurred box shadow under rotations; an
      axis-aligned avatar whose mask image is far larger than it is drawn;
    * a tilted planar REC709 video (the frame builder converts a video
      that is not axis-aligned to RGBA on the host and draws an image), the
      same video's small axis-aligned preview (its planes sampled at 2.9
      texels a pixel), and a toast in an `opacity(0.6)` group inside a
      rotated frame;
    * a text run on the root beside the first card (supported, drawn by the
      general branches where it shares a tile with the card), and at
      `plain` a text run, a 1:1 icon and a rect away from all of the above
      (their tiles stay on the TPU kernel's paths)."""
    root = A.SpatialId.root_scroll_node(b.pipeline_id)
    origin = A.Point2D(0, 0)
    rng = np.random.RandomState(61)
    auto, premul = A.ImageRendering.AUTO, A.AlphaType.PREMULTIPLIED_ALPHA
    opaque = A.ImageDescriptorFlags.IS_OPAQUE

    def add(key, px, flags=opaque):
        txn.add_image(key, A.ImageDescriptor(
            A.ImageFormat.RGBA8, px.shape[1], px.shape[0], flags=flags),
            A.ImageData(pixels=px))

    pw, ph = places["photo"]
    n_photos = 4 if len(places["thumbs"]) > 4 else 2
    for key in PHOTO_KEYS[:n_photos]:
        add(key, _blocky(rng, pw, ph, 32))
    add(PATTERN_KEY, _blocky(rng, *places["pattern"], 16))
    add(ICON_KEY, _blocky(rng, 96, 96, 8))
    mw, mh = places["mask"]
    yy, xx = np.mgrid[0:mh, 0:mw] + 0.5
    for key, soft in ((BIG_MASK_KEY, mw / 64.0), (ROUND_MASK_KEY, 1.0)):
        cov = np.clip((mw * 0.48 - np.hypot(xx - mw / 2, yy - mh / 2)) / soft,
                      0.0, 1.0)
        add(key, np.repeat((cov * 255.0 + 0.5).astype(np.uint8)[..., None],
                           4, 2), A.ImageDescriptorFlags.NONE)

    def common(node, x, y, w, h, pad=0, clip=None):
        c = A.CommonItemProperties(
            A.Rect(x - pad, y - pad, w + 2 * pad, h + 2 * pad), node)
        if clip is not None:
            c = dataclasses.replace(c, clip_chain_id=b.define_clip_chain(
                None, [clip]))
        return c

    def rotated(rect, degrees, parent=root):
        """A reference frame about the rect's centre; the rect in it."""
        x, y, w, h = rect
        node = b.push_reference_frame(
            A.Point2D(x + w / 2, y + h / 2), parent, A.TransformStyle.FLAT,
            degrees if isinstance(degrees, A.Transform)
            else A.Transform.rotation_z(degrees))
        return node, (-w / 2, -h / 2, w, h)

    gray = A.FontInstanceKey(0, 10)
    pre = A.Transaction()
    pre.add_font_instance(gray, A.FontKey(0, 1), 16.0, A.FontInstanceOptions(
        render_mode=A.FontRenderMode.ALPHA))
    backend.send_transaction(pre)
    ink = A.ColorF(0.1, 0.1, 0.15, 1.0)
    nx, ny = places["note"]
    b.push_text(common(root, nx, ny - 18, 400, 28),
                A.Rect(nx, ny - 18, 400, 28),
                layout("pack my box with five jugs", float(nx), float(ny)),
                font, ink)

    x, y = places["plain"]
    b.push_text(common(root, x, y, 120, 28), A.Rect(x, y, 120, 28),
                layout("lazy dog", x + 2.0, y + 20.0), font, ink)
    b.push_image(common(root, x, y + 40, 96, 96), A.Rect(x, y + 40, 96, 96),
                 auto, premul, ICON_KEY)
    b.push_rect(common(root, x, y + 150, 100, 60),
                A.Rect(x + 0.5, y + 150.25, 100, 60),
                A.ColorF(0.3, 0.5, 0.8, 0.85))

    for i, (rect, degrees) in enumerate(places["cards"]):
        if i == 0 and tilt is not None:
            degrees = tilt
        node, (x, y, w, h) = rotated(rect, degrees, card_parent or root)
        clip = b.define_clip_rounded_rect(node, A.Rect(x, y, w, h),
                                          A.BorderRadius.uniform(12.0))
        b.push_rect(common(node, x, y, w, h, clip=clip), A.Rect(x, y, w, h),
                    A.ColorF(1, 1, 1, 1))
        b.push_image(common(node, x, y, w, h),
                     A.Rect(x + 12, y + 12, w - 24, h - 60), auto, premul,
                     PHOTO_KEYS[i % n_photos])
        b.push_text(common(node, x, y, w, h),
                    A.Rect(x + 12, y + h - 40, w - 24, 24),
                    layout(f"card {i + 1} lazy dog", x + 12.0, y + h - 20.0),
                    gray.key if i == len(places["cards"]) - 1 else font, ink)
        b.pop_reference_frame()

    node, (x, y, w, h) = rotated(places["banner"], A.Transform.skew(-8.0, 0.0))
    b.push_stacking_context(origin, node, filters=[A.FilterOp.opacity(0.8)])
    b.push_rect(common(node, x, y, w, h), A.Rect(x, y, w, h),
                A.ColorF(0.2, 0.3, 0.6, 1))
    b.push_text(common(node, x, y, w, h), A.Rect(x, y, w, h),
                layout("the quick brown fox", x + 16.0, y + h * 0.5 + 6.0),
                font, A.ColorF(1, 1, 1, 1))
    b.pop_stacking_context()
    b.pop_reference_frame()

    tw_, th_ = places["thumb"]
    for i, (x, y) in enumerate(places["thumbs"]):
        b.push_image(common(root, x, y, tw_, th_), A.Rect(x, y, tw_, th_),
                     auto, premul, PHOTO_KEYS[i % n_photos])

    x, y, w, h = places["tiled"]
    pat = A.Size2D(*places["pattern"])
    b.push_repeating_image(common(root, x, y, w, h), A.Rect(x, y, w, h), pat,
                           A.Size2D(0, 0), auto, premul, PATTERN_KEY)
    x, y, w, h = places["spaced"]
    b.push_repeating_image(common(root, x, y, w, h), A.Rect(x, y, w, h), pat,
                           A.Size2D(16, 8), auto, premul, PATTERN_KEY)

    x, y, w, h = places["legend"]
    g, stops = b.create_gradient(A.Point2D(0, 0), A.Point2D(w, 0),
                                 _rainbow(A, 24), A.ExtendMode.CLAMP)
    b.push_gradient(common(root, x, y, w, h), A.Rect(x, y, w, h), g, stops)
    x, y, w, h = places["wheel"]
    g, stops = b.create_conic_gradient(A.Point2D(w * 0.5, h * 0.5), 0.0,
                                       _rainbow(A, 20), A.ExtendMode.CLAMP)
    circle = b.define_clip_rounded_rect(root, A.Rect(x, y, w, h),
                                        A.BorderRadius.uniform(w / 2.0))
    b.push_conic_gradient(common(root, x, y, w, h, clip=circle),
                          A.Rect(x, y, w, h), g, stops)
    x, y, w, h = places["rings"]
    g, stops = b.create_radial_gradient(
        A.Point2D(w * 0.5, h * 0.5), A.Size2D(w * 0.2, h * 0.2),
        _rainbow(A, 20), A.ExtendMode.REPEAT)
    b.push_radial_gradient(common(root, x, y, w, h), A.Rect(x, y, w, h), g,
                           stops)

    node, (x, y, w, h) = rotated(*places["avatar"])
    mask = b.define_clip_image_mask(node, A.Rect(x, y, w, h), ROUND_MASK_KEY)
    b.push_rect(common(node, x, y, w, h, clip=mask), A.Rect(x, y, w, h),
                A.ColorF(0.85, 0.35, 0.2, 1))
    b.pop_reference_frame()
    for name, mode in (("inset", A.BoxShadowClipMode.INSET),
                       ("outset", A.BoxShadowClipMode.OUTSET)):
        node, (x, y, w, h) = rotated(*places[name])
        pad = 0 if name == "inset" else 30
        if name == "inset":
            b.push_rect(common(node, x, y, w, h), A.Rect(x, y, w, h),
                        A.ColorF(1, 1, 1, 1))
        b.push_box_shadow(common(node, x, y, w, h, pad=pad),
                          A.Rect(x, y, w, h), A.Point2D(0, 2),
                          A.ColorF(0, 0, 0, 0.4), 8.0, 0.0,
                          A.BorderRadius.uniform(8.0), mode)
        b.pop_reference_frame()
    x, y, w, h = places["big_mask"]
    mask = b.define_clip_image_mask(root, A.Rect(x, y, w, h), BIG_MASK_KEY)
    b.push_rect(common(root, x, y, w, h, clip=mask), A.Rect(x, y, w, h),
                A.ColorF(0.2, 0.6, 0.4, 1))

    for key, plane in zip(VIDEO_KEYS, video_planes(0, places["video_size"])):
        txn.add_image(key, _plane_descriptor(A, plane),
                      A.ImageData(pixels=plane))
    node, (x, y, w, h) = rotated(*places["video"])
    b.push_yuv_image(common(node, x, y, w, h), A.Rect(x, y, w, h), VIDEO_KEYS,
                     "planar", A.ColorDepth.COLOR8, A.YuvColorSpace.REC709,
                     A.ColorRange.LIMITED, auto)
    b.pop_reference_frame()
    x, y, w, h = places["preview"]
    b.push_yuv_image(common(root, x, y, w, h), A.Rect(x, y, w, h), VIDEO_KEYS,
                     "planar", A.ColorDepth.COLOR8, A.YuvColorSpace.REC709,
                     A.ColorRange.LIMITED, auto)
    node, (x, y, w, h) = rotated(*places["toast"])
    b.push_stacking_context(origin, node, filters=[A.FilterOp.opacity(0.6)])
    b.push_rect(common(node, x, y, w, h), A.Rect(x, y, w, h),
                A.ColorF(0.15, 0.15, 0.18, 1))
    b.push_text(common(node, x, y, w, h), A.Rect(x, y, w, h),
                layout("saved to box", x + 10.0, y + h * 0.5 + 6.0), font,
                A.ColorF(1, 1, 1, 1))
    b.pop_stacking_context()
    b.pop_reference_frame()


def build_4k_transformed_scene(backend, w=3840, h=2160, *, api=None,
                               tilt=None):
    """The 4K browsing page (`build_4k_scene`, counts unchanged) with what
    a page with CSS transforms and a gallery holds on top
    (`_transformed_groups`)."""
    A = api or port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    txn = A.Transaction()
    font, layout = _browsing_page(A, backend, b, txn, w, h, 400, 100, 80,
                                  60)
    _transformed_groups(A, backend, b, txn, layout, font, TRANSFORMED_4K,
                        tilt)
    return _finish(A, backend, pid, b, txn)


def transformed_scene(backend, *, api=None, tilt=None):
    """The transformed-page groups on a 1024x512 page (fewer of each), the
    cards inside a scroll frame (`CARDS_SCROLL_ID`); `tilt` is the first
    card's angle in degrees (0 puts its caption and frame back on the TPU
    kernel's paths)."""
    A = api or port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    txn = A.Transaction()
    root = A.SpatialId.root_scroll_node(pid)
    b.push_rect(A.CommonItemProperties(A.Rect(0, 0, 1024, 512), root),
                A.Rect(0, 0, 1024, 512), A.ColorF(0.95, 0.95, 0.97, 1.0))
    font, layout = _add_font(A, backend)
    cards = b.define_scroll_frame(root, external_id=CARDS_SCROLL_ID,
                                  content_rect=A.Rect(0, 0, 700, 600),
                                  frame_rect=A.Rect(0, 0, 700, 188))
    _transformed_groups(A, backend, b, txn, layout, font, TRANSFORMED_SMALL,
                        tilt, cards)
    return _finish(A, backend, pid, b, txn)


OVERSIZED_SIZE = (4352, 64)


def oversized_group_scene(backend, *, api=None):
    """An `opacity(0.6)` group of 17 rects across a 4352x64 page: its
    surface passes 4096 device pixels, so the frame builder rasters it at
    half resolution (a surface pass with raster step 2) and the composite
    samples it back up."""
    A = api or port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    root = A.SpatialId.root_scroll_node(pid)
    w, h = OVERSIZED_SIZE
    common = A.CommonItemProperties(A.Rect(0, 0, w, h), root)
    b.push_rect(common, A.Rect(0, 0, w, h), A.ColorF(0.95, 0.95, 0.97, 1))
    b.push_stacking_context(A.Point2D(0, 0), root,
                            filters=[A.FilterOp.opacity(0.6)])
    for i in range(17):
        b.push_rect(common, A.Rect(4.5 + 256 * i, 6.25, 200, 50),
                    A.ColorF(0.2 + 0.04 * i, 0.5, 0.8 - 0.04 * i,
                             1.0 if i % 2 else 0.8))
    b.pop_stacking_context()
    return _finish(A, backend, pid, b)


# --- the SVG-filter page -----------------------------------------------------

# (x, y, w, h) of each group, on the 4K page and on the 1024x512 page: the
# duotone hero, the gooey nav, the drop-shadow cards, the knocked-out
# banner (and the part of it its `in` composite keeps), the inner-shadow
# avatars (the first half in linearRGB), one row of blend swatches per
# color space, the legacy filter-primitive graph and the CSS chain strip
SVG_4K = dict(
    hero=(80, 80, 1280, 720), nav=(1440, 80, 800, 120),
    cards=[(1440 + 400 * (i % 4), 280 + 300 * (i // 4), 360, 240)
           for i in range(12)],
    banner=(80, 860, 1200, 160), banner_kept=(80, 860, 700, 120),
    avatars=[(80 + 200 * i, 1080, 160, 160) for i in range(6)],
    swatches=[[(80 + 176 * m, y, 160, 160) for m in range(15)]
              for y in (1300, 1480)],
    legacy=(2800, 1300, 400, 300), strip=(80, 1700, 1280, 160))
SVG_SMALL = dict(
    hero=(8, 8, 320, 180), nav=(340, 8, 300, 48),
    cards=[(660 + 140 * i, 12, 120, 80) for i in range(2)],
    banner=(340, 76, 300, 48), banner_kept=(340, 76, 170, 36),
    avatars=[(660 + 64 * i, 116, 48, 48) for i in range(2)],
    swatches=[[(8 + 44 * m, y, 40, 40) for m in range(15)]
              for y in (200, 244)],
    legacy=(680, 200, 160, 100), strip=(8, 300, 320, 48))
SVG_IMAGE_KEYS = (600, 601, 602, 603)
BLEND_MODES = ("multiply", "screen", "overlay", "darken", "lighten",
               "colordodge", "colorburn", "hardlight", "softlight",
               "difference", "exclusion", "hue", "saturation", "color",
               "luminosity")
# feColorMatrix values (SVG's order: 4 rows of 5) of the hero's duotone
# (luminance to grey) and of the gooey nav's alpha contrast
DUOTONE = (0.2126, 0.7152, 0.0722, 0, 0, 0.2126, 0.7152, 0.0722, 0, 0,
           0.2126, 0.7152, 0.0722, 0, 0, 0, 0, 0, 1, 0)
GOO = (1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 18, -7)


def _svg_node(A, op, sub, *, linear=True, in1=None, in2=None, legacy=False,
              **values):
    """One SVG filter graph node as the display item carries it
    (api/display_item.py FilterOp.svgfe): `sub` its subregion (x, y, w, h);
    `in1`/`in2` an earlier node's index, -1 the source graphic, None the
    previous node; `values` any of value, color, matrix (SVG's 4x5 rows),
    dx, dy, std (both deviations), filter_data, k_values."""
    matrix = values.get("matrix", ())
    if matrix:  # the node carries the matrix column by column
        matrix = tuple(float(v) for v in
                       np.asarray(matrix, np.float64).reshape(4, 5).T.ravel())
    std = float(values.get("std", 0.0))
    node = {"op": op, "linear": linear, "subregion": A.Rect(*sub),
            "in1": in1, "in2": in2, "value": values.get("value"),
            "color": values.get("color"), "matrix": matrix,
            "dx": float(values.get("dx", 0.0)),
            "dy": float(values.get("dy", 0.0)), "std_x": std, "std_y": std,
            "filter_data": values.get("filter_data"),
            "k_values": values.get("k_values")}
    if legacy:
        node["legacy"] = True
    return A.FilterOp(A.FilterOpKind.SVG_GRAPH, svgfe=node)


def _svg_groups(A, b, txn, places, arith=(0.0, 1.0, -1.0, 0.0),
                table=(0.1, 0.9, 0.6)):
    """The SVG-filter groups of a page, painted last, each a stacking
    context whose filter is one SVG filter graph (or, for the strip, a CSS
    filter chain) over rects, gradients and seeded images:

    * hero: a photo and a gradient wash under a duotone: feColorMatrix to
      grey in linearRGB (color-matrix flag 2), then feComponentTransfer
      with the values `table` on red and a gamma on green
      (`PASS_CHANNEL_LUT`);
    * nav: pills under a "gooey" filter: feGaussianBlur sigma 10 in
      linearRGB (`PASS_SRGB` around the blur), an alpha-contrast
      feColorMatrix (flag 2), then feComposite atop the source (op 68);
    * cards: each under an SVG drop shadow in linearRGB: the source alpha
      blurred (sigma 4), offset, flooded and composited `in` (op 66), then
      merged under the source (feBlend normal, op 64);
    * banner: a flood knocked out of the source in sRGB by the Porter-Duff
      composites `in` (over only part of the banner: the rest of its
      tiles holds pixels that no record covers), `out`, `atop`, `xor` and
      `lighter` (ops 2-6);
    * avatars: an inner shadow, the source alpha less its blurred offset
      copy by feComposite arithmetic k = `arith` (`PASS_ARITH`),
      flooded `in` and composited over the source; the first half in
      linearRGB;
    * swatches: a translucent flood under the source blended by feBlend
      multiply ... luminosity, one row in sRGB (ops 41-55) and one in
      linearRGB (ops 105-119);
    * legacy: a filter-primitive graph in linearRGB (explicit `PASS_SRGB`
      conversions of its inputs and of its result): a blur, an opacity and
      an arithmetic composite with the source;
    * strip: images under the CSS chain `srgb-to-linear`,
      `component-transfer`, `linear-to-srgb` (three staged
      `PASS_CHANNEL_LUT`s)."""
    root = A.SpatialId.root_scroll_node(b.pipeline_id)
    origin = A.Point2D(0, 0)
    rng = np.random.RandomState(71)
    auto, premul = A.ImageRendering.AUTO, A.AlphaType.PREMULTIPLIED_ALPHA
    for key, block in zip(SVG_IMAGE_KEYS, (16, 8, 8, 8)):
        opaque = key != SVG_IMAGE_KEYS[-1]  # the avatars' is translucent
        px = _blocky(rng, 128, 96, block, opaque=opaque)
        flags = A.ImageDescriptorFlags.IS_OPAQUE if opaque else \
            A.ImageDescriptorFlags.NONE
        txn.add_image(key, A.ImageDescriptor(A.ImageFormat.RGBA8, 128, 96,
                                             flags=flags),
                      A.ImageData(pixels=px))
    # the api packages do not export it: it lives beside FilterData
    F = sys.modules[A.FilterData.__module__].ComponentTransferFuncType

    def common(x, y, w, h):
        return A.CommonItemProperties(A.Rect(x, y, w, h), root)

    def group(filters, filter_datas=()):
        b.push_stacking_context(origin, root, filters=filters,
                                filter_datas=filter_datas)

    def wash(x, y, w, h, c0, c1):
        g, stops = b.create_gradient(
            A.Point2D(0, 0), A.Point2D(w, h),
            [A.GradientStop(0.0, A.ColorF(*c0)),
             A.GradientStop(1.0, A.ColorF(*c1))], A.ExtendMode.CLAMP)
        b.push_gradient(common(x, y, w, h), A.Rect(x, y, w, h), g, stops)

    def image(x, y, w, h, key):
        b.push_image(common(x, y, w, h), A.Rect(x, y, w, h), auto, premul,
                     key)

    x, y, w, h = places["hero"]
    sub = (x, y, w, h)
    group([_svg_node(A, "colormatrix", sub, matrix=DUOTONE),
           _svg_node(A, "componenttransfer", sub, filter_data=A.FilterData(
               func_r=F.TABLE, values_r=tuple(table),
               func_g=F.GAMMA, values_g=(1.0, 0.6, 0.05)))])
    image(x, y, w, h, SVG_IMAGE_KEYS[0])
    wash(x, y + h * 0.6, w, h * 0.4, (0.1, 0.1, 0.3, 0.2),
         (0.9, 0.5, 0.1, 0.7))
    b.pop_stacking_context()

    x, y, w, h = places["nav"]
    sub = (x, y, w, h)
    group([_svg_node(A, "gaussianblur", sub, std=10.0),
           _svg_node(A, "colormatrix", sub, matrix=GOO),
           _svg_node(A, "compositeatop", sub, in1=1, in2=-1)])
    for i in range(5):
        pw = w * 0.16
        b.push_rect(common(x, y, w, h),
                    A.Rect(x + w * 0.04 + i * w * 0.19, y + h * 0.3, pw,
                           h * 0.4), A.ColorF(0.2 + 0.15 * i, 0.4, 0.9, 1.0))
    b.pop_stacking_context()

    for i, (x, y, w, h) in enumerate(places["cards"]):
        sub = (x - 16, y - 16, w + 32, h + 40)
        group([_svg_node(A, "sourcealpha", sub),
               _svg_node(A, "gaussianblur", sub, in1=0, std=4.0),
               _svg_node(A, "offset", sub, dx=0.0, dy=4.0),
               _svg_node(A, "flood", sub, color=A.ColorF(0.1, 0.1, 0.3, 0.5)),
               _svg_node(A, "compositein", sub, in1=3, in2=2),
               _svg_node(A, "blendnormal", sub, in1=-1, in2=4)])
        b.push_rect(common(x, y, w, h), A.Rect(x, y, w, h),
                    A.ColorF(1, 1, 1, 1))
        image(x + 8, y + 8, w - 16, h * 0.6, SVG_IMAGE_KEYS[1 + i % 2])
        wash(x + 8, y + h * 0.75, w * 0.6, h * 0.1, (0.2, 0.3, 0.8, 1.0),
             (0.8, 0.3, 0.5, 1.0))
        b.pop_stacking_context()

    x, y, w, h = places["banner"]
    kept = places["banner_kept"]
    sub = (x, y, w, h)
    group([_svg_node(A, "flood", sub, linear=False,
                     color=A.ColorF(0.15, 0.2, 0.55, 0.9)),
           _svg_node(A, "compositein", kept, linear=False, in1=0, in2=-1),
           _svg_node(A, "compositeout", sub, linear=False, in1=0, in2=-1),
           _svg_node(A, "compositeatop", sub, linear=False, in1=1, in2=2),
           _svg_node(A, "compositexor", sub, linear=False, in1=3, in2=-1),
           _svg_node(A, "compositelighter", sub, linear=False, in1=4, in2=0)])
    wash(x, y, w, h, (0.9, 0.8, 0.2, 0.6), (0.2, 0.7, 0.9, 1.0))
    for i in range(6):
        b.push_rect(common(x, y, w, h),
                    A.Rect(x + w * (0.05 + 0.15 * i), y + h * 0.25,
                           w * 0.1, h * 0.5), A.ColorF(0.1, 0.1, 0.1, 1.0))
    b.pop_stacking_context()

    half = len(places["avatars"]) // 2
    for i, (x, y, w, h) in enumerate(places["avatars"]):
        lin = i < half
        sub = (x, y, w, h)
        group([_svg_node(A, "sourcealpha", sub, linear=lin),
               _svg_node(A, "gaussianblur", sub, linear=lin, in1=0, std=3.0),
               _svg_node(A, "offset", sub, linear=lin, dx=3.0, dy=3.0),
               _svg_node(A, "compositearithmetic", sub, linear=lin, in1=0,
                         in2=2, k_values=tuple(arith)),
               _svg_node(A, "flood", sub, linear=lin,
                         color=A.ColorF(0.3, 0.05, 0.2, 0.8)),
               _svg_node(A, "compositein", sub, linear=lin, in1=4, in2=3),
               _svg_node(A, "compositeover", sub, linear=lin, in1=5,
                         in2=-1)])
        image(x, y, w, h, SVG_IMAGE_KEYS[3])
        b.pop_stacking_context()

    for row, lin in zip(places["swatches"], (False, True)):
        for m, (x, y, w, h) in enumerate(row):
            sub = (x, y, w, h)
            group([_svg_node(A, "flood", sub, linear=lin,
                             color=A.ColorF(0.95, 0.55, 0.15, 0.75)),
                   _svg_node(A, "blend" + BLEND_MODES[m], sub, linear=lin,
                             in1=-1, in2=0)])
            wash(x, y, w, h, (0.1, 0.4 + 0.03 * m, 0.9, 0.6),
                 (0.9, 0.9, 0.2, 1.0))
            image(x + w * 0.25, y + h * 0.25, w * 0.5, h * 0.5,
                  SVG_IMAGE_KEYS[2])
            b.pop_stacking_context()

    x, y, w, h = places["legacy"]
    sub = (x, y, w, h)
    group([_svg_node(A, "gaussianblur", sub, legacy=True, std=2.0),
           _svg_node(A, "opacity", sub, legacy=True, value=0.8),
           _svg_node(A, "compositearithmetic", sub, legacy=True, in1=1,
                     in2=-1, k_values=(0.0, 0.5, 0.5, 0.0))])
    image(x, y, w * 0.6, h, SVG_IMAGE_KEYS[0])
    b.push_rect(common(x, y, w, h), A.Rect(x + w * 0.5, y + h * 0.2,
                                           w * 0.4, h * 0.5),
                A.ColorF(0.9, 0.2, 0.3, 0.8))
    b.pop_stacking_context()

    x, y, w, h = places["strip"]
    group([A.FilterOp(A.FilterOpKind.SRGB_TO_LINEAR),
           A.FilterOp(A.FilterOpKind.COMPONENT_TRANSFER),
           A.FilterOp(A.FilterOpKind.LINEAR_TO_SRGB)],
          [A.FilterData(func_r=F.LINEAR, values_r=(0.8, 0.1),
                        func_b=F.DISCRETE, values_b=(0.1, 0.5, 0.9),
                        func_a=F.TABLE, values_a=(0.0, 1.0))])
    n = 4
    for i in range(n):
        image(x + i * w / n, y, w / n, h, SVG_IMAGE_KEYS[i])
    b.pop_stacking_context()


def build_4k_svg_scene(backend, w=3840, h=2160, *, api=None):
    """The 4K browsing page (`build_4k_scene`, counts unchanged) with the
    SVG-filter groups on top (`_svg_groups`)."""
    A = api or port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    txn = A.Transaction()
    _browsing_page(A, backend, b, txn, w, h, 400, 100, 80, 60)
    _svg_groups(A, b, txn, SVG_4K)
    return _finish(A, backend, pid, b, txn)


def svg_filter_scene(backend, *, api=None, **edits):
    """The SVG-filter groups alone on a 1024x512 page (fewer cards and
    avatars, smaller swatches); `edits` are `_svg_groups`' `arith` and
    `table`."""
    A = api or port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    txn = A.Transaction()
    root = A.SpatialId.root_scroll_node(pid)
    b.push_rect(A.CommonItemProperties(A.Rect(0, 0, 1024, 512), root),
                A.Rect(0, 0, 1024, 512), A.ColorF(0.95, 0.95, 0.97, 1.0))
    _svg_groups(A, b, txn, SVG_SMALL, **edits)
    return _finish(A, backend, pid, b, txn)


# --- the CSS-3D page ---------------------------------------------------------

# each group under its own `perspective: 1000px` container, on the 4K page
# and on the 1024x512 page: the cover-flow row (centre x, y, cover size,
# covers on each side of the flat one), the flip cards (x, y, w, h) and
# their angles, the cube (centre x, y, edge), the crossing solid planes and
# the crossing picture planes (centre x, y, w, h), the text panel (x, y, w,
# h, lines)
CSS3D_4K = dict(
    covers=(1920, 300, 360, 4),
    cards=[(200 + 420 * i, 580, 320, 200) for i in range(8)],
    flips=tuple(25.0 * i for i in range(8)),
    cube=(400, 1150, 240),
    solid_planes=(1200, 1150, 600, 320),
    picture_planes=(2100, 1150, 480, 300),
    panel=(2450, 1000, 900, 300, 8))
CSS3D_SMALL = dict(
    covers=(190, 90, 110, 1),
    cards=[(420, 40, 160, 100), (620, 40, 160, 100)],
    flips=(25.0, 150.0),
    cube=(880, 100, 110),
    solid_planes=(180, 350, 280, 150),
    picture_planes=(510, 350, 240, 150),
    panel=(690, 270, 300, 120, 3))
PERSPECTIVE = 1000.0
# the scroll feed at the foot of the 1024x512 CSS-3D page
PRESERVE3D_FEED_ID = 779
COVER_KEYS = (700, 701, 702)
PLANE_KEY = 703
# the flip animation of chip_smoke.py: the first card's angle from 60 to
# 120 degrees, across the angle where the frame builder culls its front
# face and draws its back face (between 105 and 120 degrees: its
# orientation test projects a triangle at the card's local origin without
# the reference frame's origin offset)
FLIP_FRAMES = (60.0, 75.0, 85.0, 95.0, 105.0, 120.0)


def _css3d_groups(A, b, txn, layout, font, places, flip=None):
    """What a page with CSS 3D transforms holds, painted last, each group in
    a `perspective` container (a perspective reference frame about the
    group's centre, built as wrench's `make_perspective` builds it) holding
    a `transform-style: preserve-3d` context:

    * a cover-flow row: a flat cover between covers at `rotateY(+-55deg)`,
      stepped back in depth; bare image prims, so planes of the context;
    * flip cards, each a preserve-3d context at `rotateY(angle)` holding a
      front face (a solid, a gradient and a caption) and a back face at
      `rotateY(180deg)` with `backface-visibility: hidden`; both faces are
      stacking contexts, so plane surfaces, and the face that turns away
      is culled (`flip` replaces the first card's angle);
    * a cube at `rotateX(-25deg) rotateY(35deg)`: five solid or gradient
      faces and an image face, `backface-visibility: hidden`;
    * crossing solid planes: a solid and a gradient at `rotateY(+-30deg)`
      and a third plane at `rotateX(40deg)` through both: the splitter cuts
      them into fragments, each clipped to its device polygon;
    * crossing picture planes: two stacking contexts at `rotateY(+-40deg)`,
      each an image and a caption, which cross;
    * a text panel at `rotateX(20deg)`: a rect and lines of text."""
    root = A.SpatialId.root_scroll_node(b.pipeline_id)
    origin = A.Point2D(0, 0)
    rng = np.random.RandomState(83)
    auto, premul = A.ImageRendering.AUTO, A.AlphaType.PREMULTIPLIED_ALPHA
    preserve, flat = A.TransformStyle.PRESERVE_3D, A.TransformStyle.FLAT
    hidden = A.PrimitiveFlags.NONE
    ink = A.ColorF(0.1, 0.1, 0.15, 1.0)
    cs = places["covers"][2]
    for key in COVER_KEYS:
        txn.add_image(key, A.ImageDescriptor(
            A.ImageFormat.RGBA8, 128, 128,
            flags=A.ImageDescriptorFlags.IS_OPAQUE),
            A.ImageData(pixels=_blocky(rng, 128, 128, 16)))
    txn.add_image(PLANE_KEY, A.ImageDescriptor(
        A.ImageFormat.RGBA8, 192, 128, flags=A.ImageDescriptorFlags.IS_OPAQUE),
        A.ImageData(pixels=_blocky(rng, 192, 128, 16)))

    def stage(cx, cy):
        """The perspective container about (cx, cy), and a preserve-3d
        context in it."""
        c = A.Point2D(cx, cy)
        node = b.push_reference_frame(
            origin, root, flat,
            A.Transform.translation(-c.x, -c.y).then(
                A.Transform.perspective(PERSPECTIVE)).then(
                A.Transform.translation(c.x, c.y)),
            A.ReferenceFrameKind.PERSPECTIVE)
        b.push_stacking_context(origin, node, transform_style=preserve)
        return node

    def unstage():
        b.pop_stacking_context()
        b.pop_reference_frame()

    def frame(parent, x, y, transform):
        return b.push_reference_frame(A.Point2D(x, y), parent, preserve,
                                      transform)

    def common(node, w, h, flags=A.PrimitiveFlags.IS_BACKFACE_VISIBLE):
        return A.CommonItemProperties(A.Rect(-w / 2, -h / 2, w, h), node,
                                      flags=flags)

    def gradient(node, w, h, c0, c1,
                 flags=A.PrimitiveFlags.IS_BACKFACE_VISIBLE):
        g, stops = b.create_gradient(
            A.Point2D(0, 0), A.Point2D(w, h),
            [A.GradientStop(0.0, c0), A.GradientStop(1.0, c1)],
            A.ExtendMode.CLAMP)
        b.push_gradient(common(node, w, h, flags),
                        A.Rect(-w / 2, -h / 2, w, h), g, stops)

    # the cover-flow row
    cx, cy, s, side = places["covers"]
    node = stage(cx, cy)
    for k in range(-side, side + 1):
        d = abs(k) - 1
        if k == 0:
            t = A.Transform.identity()
            x = cx
        else:
            t = A.Transform.rotation_y(-55.0 if k > 0 else 55.0).then(
                A.Transform.translation(0, 0, -s * (0.35 + 0.1 * d)))
            x = cx + (1 if k > 0 else -1) * s * (0.9 + 0.55 * d)
        f = frame(node, x, cy, t)
        b.push_image(common(f, s, s), A.Rect(-s / 2, -s / 2, s, s), auto,
                     premul, COVER_KEYS[(k + side) % len(COVER_KEYS)])
        b.pop_reference_frame()
    unstage()

    # the flip cards
    for i, ((x, y, w, h), angle) in enumerate(zip(places["cards"],
                                                 places["flips"])):
        if i == 0 and flip is not None:
            angle = flip
        node = stage(x + w / 2, y + h / 2)
        card = frame(node, x + w / 2, y + h / 2, A.Transform.rotation_y(angle))
        b.push_stacking_context(origin, card, transform_style=preserve)
        b.push_stacking_context(origin, card, prim_flags=hidden)
        b.push_rect(common(card, w, h, hidden), A.Rect(-w / 2, -h / 2, w, h),
                    A.ColorF(1, 1, 1, 1))
        gradient(card, w - 16, h * 0.5, A.ColorF(0.9, 0.4, 0.2, 1),
                 A.ColorF(0.3, 0.2, 0.8, 1), hidden)
        b.push_text(common(card, w, h, hidden),
                    A.Rect(-w / 2 + 8, h / 2 - 36, w - 16, 28),
                    layout(f"card {i + 1} front", -w / 2 + 10.0, h / 2 - 16.0),
                    font, ink)
        b.pop_stacking_context()
        back = frame(card, 0, 0, A.Transform.rotation_y(180.0))
        b.push_stacking_context(origin, back, prim_flags=hidden)
        b.push_rect(common(back, w, h, hidden), A.Rect(-w / 2, -h / 2, w, h),
                    A.ColorF(0.2, 0.3, 0.45, 1))
        b.push_text(common(back, w, h, hidden),
                    A.Rect(-w / 2 + 8, -14, w - 16, 28),
                    layout(f"back {i + 1}", -w / 2 + 10.0, 6.0), font,
                    A.ColorF(1, 1, 1, 1))
        b.pop_stacking_context()
        b.pop_reference_frame()
        b.pop_stacking_context()
        b.pop_reference_frame()
        unstage()

    # the cube
    cx, cy, e = places["cube"]
    node = stage(cx, cy)
    cube = frame(node, cx, cy, A.Transform.rotation_y(35.0).then(
        A.Transform.rotation_x(-25.0)))
    half = A.Transform.translation(0, 0, e / 2)
    faces = (A.Transform.identity(), A.Transform.rotation_y(90.0),
             A.Transform.rotation_y(180.0), A.Transform.rotation_y(-90.0),
             A.Transform.rotation_x(90.0), A.Transform.rotation_x(-90.0))
    for j, rot in enumerate(faces):
        f = frame(cube, 0, 0, half.then(rot))
        if j == 0:
            b.push_image(common(f, e, e, hidden), A.Rect(-e / 2, -e / 2, e, e),
                         auto, premul, COVER_KEYS[0])
        elif j % 2:
            gradient(f, e, e, A.ColorF(0.2, 0.7, 0.5, 1),
                     A.ColorF(0.1, 0.3, 0.6, 1), hidden)
        else:
            b.push_rect(common(f, e, e, hidden), A.Rect(-e / 2, -e / 2, e, e),
                        A.ColorF(0.15 * j, 0.5, 0.9 - 0.1 * j, 1))
        b.pop_reference_frame()
    b.pop_reference_frame()
    unstage()

    # the crossing solid planes
    cx, cy, w, h = places["solid_planes"]
    node = stage(cx, cy)
    for j, t in enumerate((A.Transform.rotation_y(30.0),
                           A.Transform.rotation_y(-30.0),
                           A.Transform.rotation_x(40.0))):
        f = frame(node, cx, cy, t)
        if j == 1:
            gradient(f, w, h, A.ColorF(1, 0.8, 0.1, 1),
                     A.ColorF(0.9, 0.1, 0.5, 0.9))
        else:
            b.push_rect(common(f, w, h), A.Rect(-w / 2, -h / 2, w, h),
                        A.ColorF(0.2, 0.45 + 0.3 * j, 0.85, 0.9))
        b.pop_reference_frame()
    unstage()

    # the crossing picture planes
    cx, cy, w, h = places["picture_planes"]
    node = stage(cx, cy)
    for j, angle in enumerate((40.0, -40.0)):
        f = frame(node, cx, cy, A.Transform.rotation_y(angle))
        b.push_stacking_context(origin, f)
        b.push_image(common(f, w, h), A.Rect(-w / 2, -h / 2, w, h), auto,
                     premul, PLANE_KEY)
        b.push_text(common(f, w, h),
                    A.Rect(-w / 2 + 8, h / 2 - 36, w - 16, 28),
                    layout(f"plane {j + 1}", -w / 2 + 12.0, h / 2 - 14.0),
                    font, A.ColorF(1, 1, 1, 1))
        b.pop_stacking_context()
        b.pop_reference_frame()
    unstage()

    # the text panel
    x, y, w, h, lines = places["panel"]
    node = stage(x + w / 2, y + h / 2)
    f = frame(node, x + w / 2, y + h / 2, A.Transform.rotation_x(20.0))
    b.push_rect(common(f, w, h), A.Rect(-w / 2, -h / 2, w, h),
                A.ColorF(0.97, 0.96, 0.9, 1))
    words = ("the quick brown fox jumps over the lazy dog "
             "pack my box with five dozen liquor jugs").split()
    step = h / (lines + 1)
    for i in range(lines):
        ty = -h / 2 + step * (i + 1)
        text = " ".join(words[(i * 5 + j) % len(words)] for j in range(7))
        b.push_text(common(f, w, h), A.Rect(-w / 2 + 12, ty - 16, w - 24, 24),
                    layout(text, -w / 2 + 16.0, ty + 4.0), font, ink)
    b.pop_reference_frame()
    unstage()


def build_4k_3d_scene(backend, w=3840, h=2160, *, api=None, flip=None):
    """The 4K browsing page (`build_4k_scene`, counts unchanged) with the
    CSS-3D groups on top (`_css3d_groups`); `flip` is the first flip card's
    angle in degrees."""
    A = api or port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    txn = A.Transaction()
    font, layout = _browsing_page(A, backend, b, txn, w, h, 400, 100, 80,
                                  60)
    _css3d_groups(A, b, txn, layout, font, CSS3D_4K, flip)
    return _finish(A, backend, pid, b, txn)


def preserve3d_scene(backend, *, api=None, flip=None):
    """The CSS-3D groups on a 1024x512 page (fewer of each) with a scroll
    feed (`PRESERVE3D_FEED_ID`) at its right edge."""
    A = api or port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    txn = A.Transaction()
    root = A.SpatialId.root_scroll_node(pid)
    b.push_rect(A.CommonItemProperties(A.Rect(0, 0, 1024, 512), root),
                A.Rect(0, 0, 1024, 512), A.ColorF(0.95, 0.95, 0.97, 1.0))
    feed = b.define_scroll_frame(root, external_id=PRESERVE3D_FEED_ID,
                                 content_rect=A.Rect(0, 440, 1024, 400),
                                 frame_rect=A.Rect(0, 440, 1024, 72))
    for i in range(6):
        b.push_rect(A.CommonItemProperties(A.Rect(0, 440, 1024, 400), feed),
                    A.Rect(8 + 170 * i, 448, 160, 56),
                    A.ColorF(0.85, 0.88 - 0.05 * i, 0.93, 1.0))
    font, layout = _add_font(A, backend)
    _css3d_groups(A, b, txn, layout, font, CSS3D_SMALL, flip)
    return _finish(A, backend, pid, b, txn)


def svg_counts(frame) -> dict:
    """What a frame holds of the SVG-filter path: its passes by name and
    target ("raster root", "srgb surface", ...), the blend ops of the
    instances its surface passes draw, the color-matrix flags of their
    pictures, and the `kvals`, `arith_linear` and `srgb_to_linear` of its
    arithmetic and sRGB passes."""
    from collections import Counter
    from .frame.frame_builder import TARGET_ROOT
    from .frame.gpu import INST_BLEND, INST_KIND, INST_PRIM_ADDR, KIND_PICTURE
    from .renderer.renderer import PASS_NAMES
    passes = Counter(PASS_NAMES[p.kind] + (
        " root" if p.target == TARGET_ROOT else " surface")
        for p in frame.passes)
    surf = [p for p in frame.passes
            if p.target != TARGET_ROOT and p.tile_insts is not None]
    ids = np.unique(np.concatenate([p.tile_insts[p.tile_insts >= 0]
                                    for p in surf])) if surf else \
        np.zeros(0, np.int64)
    inst = frame.instances[ids]
    pics = inst[inst[:, INST_KIND] == KIND_PICTURE]
    flags = frame.f32_buf[pics[:, INST_PRIM_ADDR] + 36]
    return dict(passes=dict(passes),
                blends=sorted(set(inst[:, INST_BLEND].tolist())),
                cm_flags=sorted(set(flags.tolist())),
                kvals=[tuple(p.kvals) for p in frame.passes
                       if PASS_NAMES[p.kind] == "arith"],
                arith_linear=[p.arith_linear for p in frame.passes
                              if PASS_NAMES[p.kind] == "arith"],
                srgb_to_linear=[p.srgb_to_linear for p in frame.passes
                                if PASS_NAMES[p.kind] == "srgb"])


def general_reasons(frame) -> dict:
    """How many instances of `frame` the TPU kernel has no path for, by
    reason (`ops/dense.py::pallas_supported`): a sampled kind under a
    transform that is not axis-aligned, an axis-aligned image outside the
    sampling window (a repeat whose uv rect passes it, or a thumbnail),
    a video whose planes pass it, a gradient of more than 16 stops, or an
    image-mask (kind 2) or nine-patch (kind 4) clip, under a transform or
    outside the window."""
    import torch
    from .frame.gpu import (INST_CLIP_ADDR, INST_CLIP_COUNT, INST_KIND,
                            INST_PRIM_ADDR, INST_SPATIAL)
    from .ops import dense
    f32, inst, xf = frame.f32_buf, frame.instances, frame.transforms
    ok = dense.pallas_supported(*[torch.from_numpy(a) for a in
                                  (f32, inst, xf)]).numpy()
    aligned = dense._axis_aligned(torch.from_numpy(xf)).numpy()
    names = {1: "image", 5: "glyph", 6: "picture", 10: "subpx_glyph",
             12: "video"}
    out: dict = {}
    for rec in inst[~ok]:
        kind, addr = int(rec[INST_KIND]), int(rec[INST_PRIM_ADDR])
        p = f32[addr:addr + 64]
        if kind in names and not aligned[rec[INST_SPATIAL]]:
            reason = "rotated_" + names[kind]
        elif kind == 1:
            repeats = p[2] - p[0] > p[18] + p[20] + 1e-3 or \
                p[3] - p[1] > p[19] + p[21] + 1e-3
            reason = "wide_repeat" if repeats else "thumbnail"
        elif kind == 12:
            reason = "minified_video"
        elif kind in (2, 3, 4) and p[14] > dense.MAX_PALLAS_STOPS:
            reason = {2: "linear", 3: "radial", 4: "conic"}[kind] + \
                "_stops"
        else:
            reason = "other"
            for j in range(int(rec[INST_CLIP_COUNT])):
                c = f32[int(rec[INST_CLIP_ADDR]) + 128 * j:][:128]
                if c[14] >= 1.5:
                    tilted = not dense._axis_aligned(
                        torch.from_numpy(c[None, 96:108]))[0]
                    reason = ("rotated_" if tilted else "wide_") + \
                        ("mask_clip" if c[14] < 2.5 else "nine_patch_clip")
        out[reason] = out.get(reason, 0) + 1
    return out


def css3d_counts(frame) -> dict:
    """What a frame holds of the CSS-3D path: its instances (the rows
    drawn, of all rows) and passes; over its root raster passes, the dense
    records (tile, slot) whose instance holds a polygon clip (kind 3), in
    general tiles and in the others, and general tiles / tiles."""
    import torch
    from .frame.frame_builder import TARGET_ROOT
    from .frame.gpu import INST_CLIP_ADDR, INST_CLIP_COUNT
    from .ops import dense
    f32, inst = frame.f32_buf, frame.instances
    poly = np.zeros(len(inst), bool)
    for i, rec in enumerate(inst):
        rows = f32[int(rec[INST_CLIP_ADDR]):][:128 * int(rec[INST_CLIP_COUNT])]
        poly[i] = bool((rows.reshape(-1, 128)[:, 14] ==
                        dense.POLYGON_CLIP_KIND).any())
    ok = dense.pallas_supported(*[torch.from_numpy(a) for a in
                                  (f32, inst, frame.transforms)])
    out = dict(instances=int((inst != 0).any(1).sum()), rows=len(inst),
               passes=len(frame.passes),
               polygon_records=0, polygon_records_general=0,
               general_tiles=0, tiles=0)
    for p in frame.passes:
        if p.target != TARGET_ROOT or p.tile_insts is None:
            continue
        ti = p.tile_insts
        gen = dense.general_tiles(torch.from_numpy(ti), ok).numpy()
        hit = (ti >= 0) & poly[np.maximum(ti, 0)]
        out["polygon_records"] += int(hit[~gen].sum())
        out["polygon_records_general"] += int(hit[gen].sum())
        out["general_tiles"] += int(gen.sum())
        out["tiles"] += len(ti)
    return out


class CulledFaces:
    """A context in which every frame build records the spatial nodes whose
    faces it culls (`backface-visibility: hidden` turned away: the frame
    builder's `_prim_backfacing` and `_sc_backface_culled`) in `nodes`.
    `builder` is the frame-builder class to watch, the port's by
    default."""

    def __init__(self, builder=None):
        if builder is None:
            from .frame.frame_builder import FrameBuilder as builder
        self.builder = builder
        self.nodes = set()

    def __enter__(self):
        cls = self.builder
        self._saved = prim, sc = (cls._prim_backfacing,
                                  cls._sc_backface_culled)

        def prim_backfacing(builder, c):
            culled = prim(builder, c)
            if culled:
                self.nodes.add(c.spatial_node)
            return culled

        def sc_backface_culled(builder, spatial):
            culled = sc(builder, spatial)
            if culled:
                self.nodes.add(spatial)
            return culled
        cls._prim_backfacing = prim_backfacing
        cls._sc_backface_culled = sc_backface_culled
        return self

    def __exit__(self, *exc):
        cls = self.builder
        cls._prim_backfacing, cls._sc_backface_culled = self._saved
        return False


def effects_scene(backend, *, api=None, hero_bar=(0.1, 0.1, 0.2, 0.8)):
    """The effect groups alone on a 1024x512 page (one image of the
    browsing page's set in the strip); `hero_bar` colors a rect inside
    the blurred hero."""
    A = api or port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    txn = A.Transaction()
    root = A.SpatialId.root_scroll_node(pid)
    b.push_rect(A.CommonItemProperties(A.Rect(0, 0, 1024, 512), root),
                A.Rect(0, 0, 1024, 512), A.ColorF(0.95, 0.95, 0.97, 1.0))
    px = (np.random.RandomState(42).rand(96, 96, 4) * 255).astype(np.uint8)
    px[..., 3] = 255
    txn.add_image(100, A.ImageDescriptor(
        A.ImageFormat.RGBA8, 96, 96,
        flags=A.ImageDescriptorFlags.IS_OPAQUE), A.ImageData(pixels=px))
    font, layout = _add_font(A, backend)
    _effect_groups(A, b, txn, layout, font, EFFECTS_SMALL, hero_bar)
    return _finish(A, backend, pid, b, txn)


# --- the small frames of the kernel checks ----------------------------------

def clip_gradient_scene(backend, *, api=None):
    """Solid, linear gradient and a rounded-rect clip on 256x128 (the
    scene of tests/test_kernel_variants.py)."""
    A = api or port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    root = A.SpatialId.root_scroll_node(pid)
    common = A.CommonItemProperties(A.Rect(0, 0, 256, 128), root)
    b.push_rect(common, A.Rect(0, 0, 256, 128), A.ColorF(1, 1, 1, 1))
    g, stops = b.create_gradient(
        A.Point2D(0, 0), A.Point2D(128, 0),
        [A.GradientStop(0.0, A.ColorF(1, 0, 0, 1)),
         A.GradientStop(1.0, A.ColorF(0, 0, 1, 1))], A.ExtendMode.CLAMP)
    b.push_gradient(common, A.Rect(10, 10, 120, 40), g, stops)
    clip = b.define_clip_rounded_rect(root, A.Rect(40, 20, 160, 90),
                                      A.BorderRadius.uniform(20.0))
    chain = b.define_clip_chain(None, [clip])
    b.push_rect(dataclasses.replace(common, clip_chain_id=chain),
                A.Rect(30, 30, 180, 80), A.ColorF(0.2, 0.6, 0.3, 0.8))
    return _finish(A, backend, pid, b)


def text_run_scene(backend, *, api=None):
    """A short DejaVu Sans run on 256x64: subpixel glyphs drawn as the
    channel-clear / add pair (blend ops 7 and 8)."""
    A = api or port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    root = A.SpatialId.root_scroll_node(pid)
    common = A.CommonItemProperties(A.Rect(0, 0, 256, 64), root)
    b.push_rect(common, A.Rect(0, 0, 256, 64),
                A.ColorF(0.95, 0.95, 0.97, 1.0))
    font, layout = _add_font(A, backend)
    b.push_text(common, A.Rect(0, 20, 256, 24),
                layout("pack my box with jugs", 7.0, 38.0), font,
                A.ColorF(0.1, 0.1, 0.15, 1.0))
    return _finish(A, backend, pid, b)


def image_scene(backend, *, api=None):
    """One 96x96 image at scales 0.75, 1.5 and 2, a repeating image and a
    stretched nearest-sampled (pixelated) one, on 384x256."""
    A = api or port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    root = A.SpatialId.root_scroll_node(pid)
    common = A.CommonItemProperties(A.Rect(0, 0, 384, 256), root)
    rng = np.random.RandomState(7)
    txn = A.Transaction()
    px = (rng.rand(96, 96, 4) * 255).astype(np.uint8)
    px[..., 3] = 255
    txn.add_image(100, A.ImageDescriptor(
        A.ImageFormat.RGBA8, 96, 96,
        flags=A.ImageDescriptorFlags.IS_OPAQUE), A.ImageData(pixels=px))
    b.push_rect(common, A.Rect(0, 0, 384, 256), A.ColorF(1, 1, 1, 1))
    for x, y, scale in ((5.5, 3.0, 0.75), (90.0, 10.25, 1.5),
                        (230.0, 60.0, 2.0)):
        s = 96 * scale
        b.push_image(common, A.Rect(x, y, s, s), A.ImageRendering.AUTO,
                     A.AlphaType.PREMULTIPLIED_ALPHA, 100)
    b.push_repeating_image(common, A.Rect(10, 150, 200, 100),
                           A.Size2D(64, 64), A.Size2D(8, 8),
                           A.ImageRendering.AUTO,
                           A.AlphaType.PREMULTIPLIED_ALPHA, 100)
    b.push_image(common, A.Rect(250.5, 200.0, 120, 48),
                 A.ImageRendering.PIXELATED, A.AlphaType.PREMULTIPLIED_ALPHA,
                 100)
    return _finish(A, backend, pid, b, txn)


def branches_scene(backend, *, api=None):
    """The kernel's less common branches on 384x192: a repeating
    gradient with tile spacing and hard stops; a rotated rect (the
    transformed-prim coverage path) under a rotated rounded clip; and a
    chain of a non-uniform rounded clip (the SDF path), a fractional rect
    clip (joins the span) and a clip-out circle (inverted)."""
    A = api or port_api
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    root = A.SpatialId.root_scroll_node(pid)
    common = A.CommonItemProperties(A.Rect(0, 0, 384, 192), root)
    b.push_rect(common, A.Rect(0, 0, 384, 192), A.ColorF(0.9, 0.92, 0.95, 1))
    g, stops = b.create_gradient(
        A.Point2D(0, 0), A.Point2D(40, 10),
        [A.GradientStop(0.0, A.ColorF(1, 0, 0, 1)),
         A.GradientStop(0.3, A.ColorF(1, 1, 0, 0.5)),
         A.GradientStop(0.3, A.ColorF(0, 1, 0, 1)),
         A.GradientStop(0.7, A.ColorF(0, 0, 1, 0.8)),
         A.GradientStop(1.0, A.ColorF(1, 0, 1, 1))], A.ExtendMode.REPEAT)
    b.push_gradient(common, A.Rect(8, 8, 170, 70), g, stops,
                    tile_size=A.Size2D(60, 30), tile_spacing=A.Size2D(6, 4))
    rot = b.push_reference_frame(A.Point2D(260, 60), root, None,
                                 A.Transform.rotation_z(23.0), None)
    rot_common = A.CommonItemProperties(A.Rect(-100, -100, 200, 200), rot)
    b.push_rect(rot_common, A.Rect(-50, -30, 100, 60),
                A.ColorF(0.2, 0.5, 0.9, 0.9))
    rclip = b.define_clip_rounded_rect(rot, A.Rect(-40, -40, 80, 80),
                                       A.BorderRadius.uniform(12.0))
    b.push_rect(dataclasses.replace(
        rot_common, clip_chain_id=b.define_clip_chain(None, [rclip])),
        A.Rect(-45, -20, 90, 40), A.ColorF(0.9, 0.3, 0.1, 0.7))
    b.pop_reference_frame()
    radii = A.BorderRadius(A.Size2D(20, 10), A.Size2D(5, 5),
                           A.Size2D(30, 15), A.Size2D(0, 0))
    chain = b.define_clip_chain(None, [
        b.define_clip_rounded_rect(root, A.Rect(20, 90, 150, 90), radii),
        b.define_clip_rect(root, A.Rect(30.5, 95.25, 120, 70)),
        b.define_clip_rounded_rect(root, A.Rect(60, 110, 40, 40),
                                   A.BorderRadius.uniform(20.0),
                                   A.ClipMode.CLIP_OUT)])
    b.push_rect(dataclasses.replace(common, clip_chain_id=chain),
                A.Rect(0, 80, 200, 112), A.ColorF(0.1, 0.6, 0.3, 0.85))
    return _finish(A, backend, pid, b)


SMALL_FRAMES = {"clip_gradient": (clip_gradient_scene, (256, 128)),
                "text_run": (text_run_scene, (256, 64)),
                "images": (image_scene, (384, 256)),
                "branches": (branches_scene, (384, 192))}
# the small effects and content frames: their RGBA8 goldens are the JAX
# renderer's whole render() (offscreen passes included), not one kernel pass
EFFECTS_FRAME = ("effects", effects_scene, (1024, 512))
CONTENT_FRAME = ("content", content_scene, (1024, 512))
TRANSFORMED_FRAME = ("transformed", transformed_scene, (1024, 512))
SVG_FRAME = ("svg_filter", svg_filter_scene, (1024, 512))
PRESERVE3D_FRAME = ("preserve3d", preserve3d_scene, (1024, 512))
# the small zoomed frames, one golden per zoom: (name, zoom)
ZOOMED_FRAMES = tuple((f"zoomed_{z:g}", z) for z in ZOOMS)
ZOOMED_SIZE = (1024, 512)


# --- kernel inputs of one frame --------------------------------------------

def kernel_inputs(backend) -> dict:
    """The tile-raster kernel's arguments for the backend's frame (its one
    merged root pass; offscreen passes are not run), on the renderer's
    device."""
    r = backend.renderer
    frame = backend.build_frame()
    r.apply_uploads(backend.resources.take_uploads())
    from .frame.frame_builder import TARGET_ROOT
    from .renderer.renderer import merged_root_passes
    (p,) = [q for q in merged_root_passes(frame) if q.target == TARGET_ROOT]
    a = r.kernel_args(frame, p)
    return dict(dense=a["dense"], counts=a["tile_counts"],
                origins=a["tile_origins"], clear=a["clear_color"],
                f32_rows=a["f32_rows"], alpha_atlas=r.alpha_atlas,
                surface_atlas=r.surface_atlas, color_atlas=r.color_atlas,
                kinds=a["kinds"], blends=a["blends"],
                mask_clips=a["mask_clips"], general=a["general"],
                step=a["step"], polygon_clips=a["polygon_clips"], nx=p.nx,
                ny=p.ny,
                region=p.region)


# --- the GL-flavoured reftest documents -------------------------------------

# wrench reftest documents of the port's own, written by
# `write_gl_documents` from GL_SEED: JSON, which the JAX package's reader
# also reads (as YAML).  The manifest holds each small document on a
# `platform(linux)` line (gl_flavor), one on a plain line (swgl), a `!=`
# line and `fuzzy-if` / `skip_on` tokens; `GL_PAGE_MANIFEST` holds the
# 3840x2160 page.
WRENCH = TESTDATA / "wrench"
GL_MANIFEST = WRENCH / "reftest.list"
GL_PAGE_MANIFEST = WRENCH / "reftest-4k.list"
GL_PAGE = "gl-page-4k.json"
GL_SEED = 9
GL_SMALL_SIZE = (512, 256)
GL_PAGE_SIZE = (3840, 2160)
# the small documents, one group of features each
GL_DOCUMENTS = ("gl-rects.json", "gl-gradients.json", "gl-images.json",
                "gl-masks.json", "gl-shadows.json", "gl-filters.json",
                "gl-text.json")
# the small documents with general tiles (a rotated group)
GL_GENERAL_DOCUMENTS = ("gl-images.json", "gl-masks.json", "gl-shadows.json")


def gl_golden_name(document: str) -> str:
    """The key of a small document's JAX image in GOLDENS."""
    return "wrench_" + document.rsplit(".", 1)[0].replace("-", "_")


# the 4K page's items by feature
GL_PAGE_COUNTS = dict(rects=300, linear=60, radial=12, conic=8, images=60,
                      rotated_images=6, rounded_clips=24, image_masks=8,
                      box_shadows=24, clear_rects=6, blurs=4, mix_blends=4)
# procedural images (the reader's `checkerboard(border, size, count)`)
GL_IMAGES = ("checkerboard(2,16,8)", "checkerboard(4,8,12)",
             "checkerboard(2,32,4)", "checkerboard(1,6,16)",
             "transparent-checkerboard(2,12,8)", "checkerboard(3,20,5)")
GL_MIX_MODES = ("multiply", "screen", "difference", "overlay")


class _Doc:
    """Items of one wrench document drawn from a seeded generator; every
    number rounded to a quarter, so that JSON and YAML read it alike."""

    def __init__(self, seed, size):
        self.rng = np.random.RandomState(seed)
        self.w, self.h = size
        self.next_id = 2

    def num(self, lo, hi):
        return float(np.round(self.rng.uniform(lo, hi) * 4.0) / 4.0)

    def color(self, alpha=1.0):
        r, g, b = (int(c) for c in self.rng.randint(0, 256, 3))
        return f"{r} {g} {b} {alpha:g}"

    def box(self, wmin, wmax, hmin, hmax):
        w = self.num(wmin, wmax)
        h = self.num(hmin, hmax)
        return [self.num(0, self.w - w), self.num(0, self.h - h), w, h]

    def rect(self, bounds=None, alpha=1.0):
        return {"type": "rect", "bounds": bounds or self.box(16, 120, 12, 80),
                "color": self.color(alpha)}

    def stops(self, n=None):
        n = n or int(self.rng.randint(2, 5))
        offs = np.sort(np.round(self.rng.uniform(0, 1, n) * 100) / 100)
        offs[0], offs[-1] = 0.0, 1.0
        out = []
        for o in offs:
            out += [float(o), self.color(float(self.rng.choice((1.0, 0.6))))]
        return out

    def linear(self, bounds=None):
        b = bounds or self.box(60, 240, 30, 120)
        item = {"type": "gradient", "bounds": b,
                "start": [0, 0], "end": [self.num(8, b[2]), self.num(0, b[3])],
                "stops": self.stops()}
        if self.rng.rand() < 0.25:
            item.update(repeat=True, **{"tile-size": [b[2] / 2, b[3] / 2],
                                        "tile-spacing": [4, 4]})
        return item

    def radial(self):
        b = self.box(60, 200, 40, 140)
        return {"type": "radial-gradient", "bounds": b,
                "center": [b[2] / 2, b[3] / 2],
                "radius": [self.num(10, b[2]), self.num(10, b[3])],
                "stops": self.stops(), "repeat": bool(self.rng.rand() < 0.3)}

    def conic(self):
        b = self.box(60, 200, 60, 200)
        return {"type": "conic-gradient", "bounds": b,
                "center": [b[2] / 2, b[3] / 2], "angle": self.num(0, 90),
                "stops": self.stops(), "repeat": bool(self.rng.rand() < 0.3)}

    def image(self, scale=None, at=None):
        src = GL_IMAGES[int(self.rng.randint(len(GL_IMAGES)))]
        args = [int(a) for a in src[src.index("(") + 1:-1].split(",")]
        size = 2 * args[0] + args[1] * args[2]
        scale = scale or float(self.rng.choice((0.75, 1.0, 1.25, 1.5, 2.0)))
        side = size * scale
        x, y = at or (self.num(0, max(self.w - side, 1)),
                      self.num(0, max(self.h - side, 1)))
        return {"type": "image", "bounds": [x, y, side, side], "src": src}

    def clip_id(self):
        self.next_id += 1
        return self.next_id

    def rounded_clip(self, bounds, items, mode="clip"):
        cid = self.clip_id()
        clip = {"type": "clip", "id": cid, "complex": [
            {"rect": bounds, "radius": self.num(4, 24), "clip-mode": mode}]}
        for it in items:
            it["clip-chain"] = [cid]
        return [clip] + items

    def mask_clip(self, bounds, items):
        cid = self.clip_id()
        src = GL_IMAGES[int(self.rng.randint(len(GL_IMAGES)))]
        clip = {"type": "clip", "id": cid,
                "image-mask": {"image": src, "rect": bounds}}
        for it in items:
            it["clip-chain"] = [cid]
        return [clip] + items

    def shadow(self, inset):
        b = self.box(40, 160, 30, 110)
        return {"type": "box-shadow", "bounds": b,
                "offset": [self.num(-6, 6), self.num(-6, 6)],
                "color": self.color(0.6),
                "blur-radius": float(self.rng.choice((0, 2, 5, 8, 12))),
                "spread-radius": float(self.rng.choice((0, 2, 4))),
                "border-radius": float(self.rng.choice((0, 6, 12))),
                "clip-mode": "inset" if inset else "outset"}

    def rotated(self, items, bounds, angle):
        return {"type": "stacking-context", "bounds": bounds,
                "transform": f"rotate({angle:g})", "items": items}


def _local(items, dx, dy):
    """Items (and their clips' rects) moved by (-dx, -dy): into a stacking
    context at (dx, dy)."""
    def move(r):
        return [r[0] - dx, r[1] - dy] + list(r[2:])
    for it in items:
        if "bounds" in it:
            it["bounds"] = move(it["bounds"])
        if "image-mask" in it:
            it["image-mask"]["rect"] = move(it["image-mask"]["rect"])
        for c in it.get("complex", ()):
            c["rect"] = move(c["rect"])
    return items


def _gl_small_documents(seed):
    """{name: document} of the small documents, 512x256 each."""
    w, h = GL_SMALL_SIZE
    background = {"type": "rect", "bounds": [0, 0, w, h],
                  "color": "250 248 240 1"}
    docs = {}
    d = _Doc(seed, GL_SMALL_SIZE)
    items = [background] + [d.rect(alpha=0.85 if i % 2 else 1.0)
                            for i in range(24)]
    items += d.rounded_clip([40, 30, 200, 120], [d.rect([30, 20, 220, 140],
                                                        0.85)])
    items += d.rounded_clip([300, 100, 150, 120],
                            [d.rect([280, 80, 200, 160])], mode="clip-out")
    items += [{"type": "clear-rect", "bounds": [60.5, 180, 80, 40]},
              {"type": "clear-rect", "bounds": [400, 20.25, 60, 50]}]
    items += [d.rect(alpha=0.85) for _ in range(4)]
    docs["gl-rects.json"] = items
    d = _Doc(seed + 1, GL_SMALL_SIZE)
    docs["gl-gradients.json"] = [background] + \
        [d.linear() for _ in range(6)] + [d.radial() for _ in range(3)] + \
        [d.conic() for _ in range(2)]
    d = _Doc(seed + 2, GL_SMALL_SIZE)
    items = [background] + [d.image() for _ in range(6)]
    items += d.rounded_clip([20, 20, 160, 120], [d.image(1.0, (30, 30))])
    items.append(d.rotated(_local([d.image(1.0, (330, 80)), d.rect(
        [320, 70, 40, 30], 0.85)], 300, 60), [300, 60, 200, 180], 17))
    docs["gl-images.json"] = items
    d = _Doc(seed + 3, GL_SMALL_SIZE)
    items = [background]
    items += d.mask_clip([20, 20, 132, 132], [d.rect([10, 10, 160, 150])])
    items += d.mask_clip([180.5, 40.25, 100, 100],
                         [d.linear([170, 30, 130, 130])])
    items += d.rounded_clip([320, 20, 160, 100],
                            [d.rect([310, 10, 180, 130], 0.85)])
    inner = d.mask_clip([20, 20, 96, 96], [d.rect([0, 0, 140, 140])])
    items.append(d.rotated(inner, [340, 120, 140, 130], 12))
    docs["gl-masks.json"] = items
    d = _Doc(seed + 4, GL_SMALL_SIZE)
    items = [background] + [d.shadow(i % 2 == 1) for i in range(6)]
    items.append(d.rotated([{"type": "box-shadow", "bounds": [20, 20, 80, 50],
                             "offset": [3, 3], "color": "0 0 0 0.5",
                             "blur-radius": 6, "border-radius": 8}],
                           [360, 140, 140, 100], -9))
    docs["gl-shadows.json"] = items
    d = _Doc(seed + 5, GL_SMALL_SIZE)
    items = [background] + [d.rect(alpha=0.85) for _ in range(6)]
    items.append({"type": "stacking-context", "bounds": [20, 20, 200, 120],
                  "filters": ["blur(4,4)"],
                  "items": _local([d.rect([30, 30, 80, 60]),
                                   d.linear([90, 60, 100, 60])], 20, 20)})
    for k, mode in enumerate(("multiply", "screen")):
        items.append({"type": "stacking-context",
                      "bounds": [260 + 120 * k, 60, 110, 140],
                      "mix-blend-mode": mode,
                      "items": [d.rect([0, 0, 110, 140], 0.85),
                                d.rect([20, 20, 60, 60])]})
    docs["gl-filters.json"] = items
    d = _Doc(seed + 6, GL_SMALL_SIZE)
    items = [background] + [d.rect([0, 60 * k, w, 60]) for k in range(4)]
    for k in range(4):
        items.append({"type": "text", "text": "Sphinx of black quartz",
                      "origin": [12 + 40 * k, 36 + 60 * k], "size": 12 + 2 * k,
                      "color": d.color()})
    docs["gl-text.json"] = items
    return {name: {"root": {"items": items}} for name, items in docs.items()}


def _gl_page(seed):
    """The 3840x2160 GL page: GL_PAGE_COUNTS' items at random places (no
    text: the GPU machine has no font stack)."""
    w, h = GL_PAGE_SIZE
    n = GL_PAGE_COUNTS
    d = _Doc(seed, GL_PAGE_SIZE)
    items = [{"type": "rect", "bounds": [0, 0, w, h],
              "color": "250 248 240 1"}]
    items += [d.rect(d.box(20, 200, 20, 120), 0.85 if i % 2 else 1.0)
              for i in range(n["rects"] - 2 * n["rounded_clips"] -
                             n["image_masks"])]
    items += [d.linear() for _ in range(n["linear"])]
    items += [d.radial() for _ in range(n["radial"])]
    items += [d.conic() for _ in range(n["conic"])]
    items += [d.image() for _ in range(n["images"] - n["rotated_images"])]
    for _ in range(n["rotated_images"]):
        x, y = d.num(100, w - 300), d.num(100, h - 300)
        items.append(d.rotated([d.image(1.0, (20, 20))], [x, y, 220, 220],
                               d.num(-30, 30)))
    for _ in range(n["rounded_clips"]):
        b = d.box(80, 240, 60, 160)
        items += d.rounded_clip(b, [d.rect([b[0] - 8, b[1] - 8, b[2] + 16,
                                            b[3] + 16], 0.85),
                                    d.rect([b[0] + 10, b[1] + 10, b[2] / 2,
                                            b[3] / 2])])
    for k in range(n["image_masks"]):
        b = d.box(100, 140, 100, 140)
        masked = d.mask_clip([b[0] + 4, b[1] + 4, b[2] - 8, b[3] - 8],
                             [d.rect(b) if k % 2 else d.linear(b)])
        if k == 0:
            # one mask in a rotated group: a mask clip of general tiles
            items.append(d.rotated(_local(masked, b[0], b[1]),
                                   [b[0], b[1], b[2], b[3]], 11))
        else:
            items += masked
    items += [d.shadow(i % 2 == 1) for i in range(n["box_shadows"])]
    items += [{"type": "clear-rect", "bounds": d.box(40, 160, 30, 90)}
              for _ in range(n["clear_rects"])]
    for k in range(n["blurs"]):
        b = d.box(200, 360, 120, 240)
        items.append({"type": "stacking-context", "bounds": b,
                      "filters": [f"blur({2 + 2 * k},{2 + 2 * k})"],
                      "items": [d.rect([10, 10, b[2] / 2, b[3] / 2]),
                                d.linear([b[2] / 3, b[3] / 3, b[2] / 2,
                                          b[3] / 2])]})
    for mode in GL_MIX_MODES:
        b = d.box(200, 320, 140, 220)
        items.append({"type": "stacking-context", "bounds": b,
                      "mix-blend-mode": mode,
                      "items": [d.rect([0, 0, b[2], b[3]], 0.85),
                                d.rect([20, 20, b[2] / 2, b[3] / 2])]})
    return {"root": {"items": items}}


GL_MANIFEST_TEXT = """\
# GL-flavoured reftests of the port, written by
# webrender_tpu_torch.scenes.write_gl_documents (seed {seed}).  A
# platform(linux) line without swgl renders under gl_flavor.
platform(linux) == gl-rects.json gl-rects.json
platform(linux) == gl-gradients.json gl-gradients.json
platform(linux) == gl-images.json gl-images.json
platform(linux) fuzzy-if(platform(swgl),2,40) == gl-masks.json gl-masks.json
platform(linux) == gl-shadows.json gl-shadows.json
platform(linux) == gl-filters.json gl-filters.json
platform(linux) skip_on(android) == gl-text.json gl-text.json
== gl-masks.json gl-masks.json
platform(linux) != gl-rects.json gl-shadows.json
platform(linux) != gl-gradients.json gl-images.json
"""
GL_PAGE_MANIFEST_TEXT = """\
# the port's 3840x2160 GL page (webrender_tpu_torch.scenes
# .write_gl_documents, seed {seed}), read at 3840x2160
platform(linux) == gl-page-4k.json gl-page-4k.json
"""


def write_gl_documents(directory=WRENCH, seed=GL_SEED) -> None:
    """Writes the small documents, the 4K page and both manifests."""
    import json
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    docs = _gl_small_documents(seed)
    docs[GL_PAGE] = _gl_page(seed + 100)
    for name, doc in docs.items():
        (directory / name).write_text(json.dumps(doc, indent=1) + "\n")
    (directory / GL_MANIFEST.name).write_text(
        GL_MANIFEST_TEXT.format(seed=seed))
    (directory / GL_PAGE_MANIFEST.name).write_text(
        GL_PAGE_MANIFEST_TEXT.format(seed=seed))


# --- glyphs without a font stack --------------------------------------------

# (scene, device size, extra arguments) of every text scene the recording
# covers: the 4K bench frame, its 640x384 slice, the short text run, the
# 4K effects and content frames, the small effects and content frames, and
# the 4K and small zoomed frames at each zoom (glyphs at 20 and 32 px)
TEXT_SCENES = ((build_4k_scene, (3840, 2160), ()),
               (build_4k_scene, (640, 384), (640, 384, 12, 4, 8, 4)),
               (text_run_scene, (256, 64), ()),
               (build_4k_effects_scene, (3840, 2160), ()),
               (effects_scene, (1024, 512), ()),
               (build_4k_content_scene, (3840, 2160), ()),
               (content_scene, (1024, 512), ())) + \
    tuple((build_4k_zoomed_scene, (3840, 2160), (3840, 2160, z))
          for z in ZOOMS) + \
    tuple((zoomed_scene, ZOOMED_SIZE, (z,)) for z in ZOOMS) + \
    ((build_4k_transformed_scene, (3840, 2160), ()),
     (transformed_scene, (1024, 512), ()),
     (build_4k_3d_scene, (3840, 2160), ()),
     (preserve3d_scene, (1024, 512), ()))


def record_glyphs(path) -> None:
    """Builds the frames of TEXT_SCENES with the real font stack and saves
    every glyph answer they needed."""
    from .render_backend import RenderBackend
    from .resources import (FontContext, RecordingFontContext,
                            ResourceCache)
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
