"""The port's compositors (`renderer/compositor.py`) and tree printer
(`util/print_tree.py`) and the renderer's crash annotations, against the
JAX package, on the CPU.

* Twins of `tests/test_components.py::test_compositor_trait`,
  `::test_compositor_partial_present` and
  `::test_print_tree_and_crash_annotator`: the same assertions on the port,
  and the port's composites, damage regions, printed trees and the
  annotations of a render equal to the JAX package's.
* Both compositors fed a rendered image as tiles of opaque and translucent
  surfaces, with partial presents, equal to the JAX package's on the same
  calls.
"""
import numpy as np
import pytest

import webrender_tpu.api as jax_api
from torch_twin import PortFeed
from webrender_tpu.renderer import compositor as jax_compositor

from webrender_tpu_torch.api.crash_annotator import (CrashAnnotation,
                                                     CrashAnnotator)
from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.renderer import compositor
from webrender_tpu_torch.util.print_tree import (PrintTree, print_scene,
                                                 print_spatial_tree)


@pytest.mark.parametrize("name", ["DrawCompositor", "SwCompositor"])
def test_compositor_trait(name):
    outs = []
    for mod in (compositor, jax_compositor):
        c = getattr(mod, name)()
        c.create_surface(1, (32, 32), is_opaque=True)
        tile = np.zeros((32, 32, 4), np.uint8)
        tile[..., 1] = 255
        tile[..., 3] = 255
        c.set_tile(1, 0, 0, tile)
        c.set_tile(1, 1, 0, tile)
        c.add_surface(1, (0, 0))
        out = c.composite((64, 32))
        assert tuple(out[16, 48]) == (0, 255, 0, 255)
        outs.append(out)
    np.testing.assert_array_equal(*outs)


def test_compositor_partial_present():
    """The tile invalidation protocol and partial present: after the first
    full composite only invalidated tiles re-composite and the damage
    region is reported, as in the JAX package."""
    green = np.zeros((32, 32, 4), np.uint8)
    green[..., 1] = 255
    green[..., 3] = 255
    red = np.zeros((32, 32, 4), np.uint8)
    red[..., 0] = 255
    red[..., 3] = 255
    frames = []
    for mod in (compositor, jax_compositor):
        c = mod.DrawCompositor()
        log = []
        c.create_surface(1, (32, 32), is_opaque=True)
        c.set_tile(1, 0, 0, green)
        c.set_tile(1, 1, 0, green)
        c.begin_frame()
        c.add_surface(1, (0, 0))
        c.start_compositing(None)
        out1 = c.composite((64, 32))
        c.end_frame()
        assert c.buffer_damage_region == [(0, 0, 64, 32)]
        log.append((out1, c.buffer_damage_region))
        # frame 2: only tile (1, 0) changes
        c.invalidate_tile(1, 1, 0)
        c.set_tile(1, 1, 0, red)
        c.begin_frame()
        c.add_surface(1, (0, 0))
        out2 = c.composite((64, 32))
        c.end_frame()
        assert tuple(out2[16, 16]) == (0, 255, 0, 255)
        assert tuple(out2[16, 48]) == (255, 0, 0, 255)
        assert all(x0 >= 32 for (x0, _, _, _) in c.buffer_damage_region)
        log.append((out2, c.buffer_damage_region))
        # frame 3: explicit dirty rects
        c.set_tile(1, 0, 0, red)
        c.begin_frame()
        c.add_surface(1, (0, 0))
        c.start_compositing([(0, 0, 32, 32)])
        out3 = c.composite((64, 32))
        assert tuple(out3[16, 16]) == (255, 0, 0, 255)
        assert c.buffer_damage_region == [(0, 0, 32, 32)]
        log.append((out3, c.buffer_damage_region))
        # unchanged frame: empty damage, the retained buffer comes back
        c.begin_frame()
        c.add_surface(1, (0, 0))
        out4 = c.composite((64, 32))
        assert c.buffer_damage_region == []
        assert np.array_equal(out3, out4)
        log.append((out4, c.buffer_damage_region))
        frames.append(log)
    for (a, da), (b, db) in zip(*frames):
        np.testing.assert_array_equal(a, b)
        assert da == db


def _as_tiles(img, tile):
    th, tw = tile
    h, w, _ = img.shape
    return {(x, y): img[y * th:(y + 1) * th, x * tw:(x + 1) * tw].copy()
            for y in range(-(-h // th)) for x in range(-(-w // tw))}


@pytest.mark.parametrize("name", ["DrawCompositor", "SwCompositor"])
def test_compositors_assemble_a_rendered_image(name):
    """A frame of the port's renderer as 48x32 tiles of an opaque surface,
    under a translucent surface at an offset; an invalidated tile, then an
    unchanged frame: each composite equal to the JAX package's, and the
    opaque surface alone equal to the image."""
    size = (200, 120)
    backend = RenderBackend(size, device="cpu")
    rng = np.random.RandomState(3)
    _scene(PortFeed(backend), jax_api)
    img = backend.render()
    over = (rng.rand(64, 96, 4) * 200).astype(np.uint8)
    over[..., :3] = np.minimum(over[..., :3], over[..., 3:])
    results = []
    for mod in (compositor, jax_compositor):
        c = getattr(mod, name)()
        c.create_surface(1, (48, 32), is_opaque=True)
        for (x, y), t in _as_tiles(img, (32, 48)).items():
            c.set_tile(1, x, y, t)
        c.add_surface(1, (0, 0))
        alone = c.composite(size)
        np.testing.assert_array_equal(alone, img)
        c.create_surface(2, (32, 32), is_opaque=False)
        for (x, y), t in _as_tiles(over, (32, 32)).items():
            c.set_tile(2, x, y, t)
        out = []
        for step in range(3):
            if step == 1:
                c.invalidate_tile(1, 2, 1)
                c.set_tile(1, 2, 1, np.full((32, 48, 4), 90, np.uint8))
            c.begin_frame()
            c.add_surface(1, (0, 0))
            c.add_surface(2, (37, 21))
            out.append((c.composite(size), c.buffer_damage_region))
            c.end_frame()
        results.append(out)
    for (a, da), (b, db) in zip(*results):
        np.testing.assert_array_equal(a, b)
        assert da == db


def _scene(backend, api):
    """`test_print_tree_and_crash_annotator`'s scene: a rect in an opacity
    group."""
    from webrender_tpu.api.display_item import FilterOp
    pid = api.PipelineId(0, 1)
    b = api.DisplayListBuilder(pid)
    b.begin()
    root = api.SpatialId.root_scroll_node(pid)
    common = api.CommonItemProperties(api.Rect(0, 0, 64, 64), root)
    b.push_stacking_context(api.Point2D(0, 0), root,
                            filters=[FilterOp.opacity(0.5)])
    b.push_rect(common, api.Rect(0, 0, 32, 32), api.ColorF(1, 0, 0, 1))
    b.pop_stacking_context()
    _, dl = b.end()
    txn = api.Transaction()
    txn.set_root_pipeline(pid)
    txn.set_display_list(api.Epoch(0), dl)
    txn.generate_frame()
    backend.send_transaction(txn)


def test_print_tree_and_crash_annotator():
    from webrender_tpu.api.crash_annotator import CrashAnnotator as JaxAnnot
    from webrender_tpu.render_backend import RenderBackend as JaxBackend
    from webrender_tpu.util import print_tree as jax_print_tree

    pt = PrintTree("demo")
    pt.new_level("root")
    pt.add_item("leaf a")
    pt.add_item("leaf b")
    pt.end_level()
    txt = pt.text()
    assert "demo" in txt and "leaf a" in txt and "└─ leaf b" in txt
    jpt = jax_print_tree.PrintTree("demo")
    jpt.new_level("root")
    jpt.add_item("leaf a")
    jpt.add_item("leaf b")
    jpt.end_level()
    assert txt == jpt.text()

    def annotator(base, events):
        class Annot(base):
            def set(self, annotation, value):
                events.append(("set", annotation.name, value))

            def clear(self, annotation):
                events.append(("clear", annotation.name))
        return Annot()

    backend = RenderBackend((64, 64), device="cpu")
    _scene(PortFeed(backend), jax_api)
    events = []
    backend.renderer.crash_annotator = annotator(CrashAnnotator, events)
    backend.render_software()  # oracle path: no annotations
    assert events == []
    backend.render()
    assert any(e[0] == "set" and e[1] == CrashAnnotation.DRAW_SHADER.name
               for e in events)
    assert any(e[0] == "clear" for e in events)
    st = print_spatial_tree(backend.built_scene.spatial_tree)
    assert "spatial tree" in st
    sc = print_scene(backend.built_scene)
    assert "picture" in sc and "RectanglePrim" in sc

    # the JAX package's on the same transaction
    jax_b = JaxBackend((64, 64))
    _scene(jax_b, jax_api)
    jax_events = []
    jax_b.renderer.crash_annotator = annotator(JaxAnnot, jax_events)
    jax_b.render_software()
    jax_b.render()
    assert events == jax_events
    assert st == jax_print_tree.print_spatial_tree(
        jax_b.built_scene.spatial_tree)
    assert sc == jax_print_tree.print_scene(jax_b.built_scene)
