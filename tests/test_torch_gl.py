"""The tile kernel's GL flavour (`gl=True`) against the JAX package, on the
CPU.

A frame built with `gl_flavor` (a reftest line whose reference image comes
from the GL renderer) composes blend ops 0, 1, 7 and 8 as
`blend.compose_gl`, chains its clip masks with `blend.gl_mask_combine` and
samples its image-mask and nine-patch clips in `_sep_sample`'s llvm mode.

* The plain version with `gl=True` against
  `render_tiles_pallas_dense(..., gl=True, interpret=True)` on the same
  kernel inputs, with both `mask_clips` values: the frame of
  `tests/test_kernel_variants.py` and the merged root pass of four of the
  port's small reftest documents, built by the JAX package's reader and
  frame builder under `gl_flavor` (rects with clear rects and rounded
  clips; image-mask clips over a solid and a gradient; outset and inset
  box shadows; subpixel text, blends 7 and 8).  Bitwise but for
  `PALLAS_STEPS`: XLA's CPU build contracts the gradient-stop lerp
  `out + (c1 - out) * w` into a multiply-add, which moves one quantized
  ramp value of `gl-masks.json` across an exact half.  Each case also
  differs from the swgl flavour, so the flag did something.
* The llvm sampler (`_sep_sample(..., llvm=True)`) against
  `patterns.sample_alpha_llvm` run by numpy, at mask rects of odd size,
  at the atlas's last column and row and past the rect: bitwise.
* General tiles under gl (the hand-built frame of
  `tests/test_torch_general.py::mask_clips`: rotated image-mask and
  nine-patch clips, a rounded clip under the rotation, axis-aligned masks
  sampled per pixel) against the JAX numpy oracle with gl, its float64
  `where`s held in float32 (`torch_twin.jax_oracle_float32`): bitwise; and
  against `render_tiles(gl=True)` on XLA at `XLA_STEPS` values.
* The renderer: every dispatch of a `gl_flavor` frame asks for the gl
  build; a backend whose frames change flavour with picture caching on
  renders what a fresh backend renders in each flavour.
* The bound (`ops/roofline.py`) of a gl dispatch counts `compose_gl`.
* On a card (marker `cuda`): the gl build against the plain version on
  the same inputs, max diff 0.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_twin as tw
from test_torch_general import CLEAR as GENERAL_CLEAR
from test_torch_general import mask_clips as general_mask_clips
from test_torch_general import port_inputs

from webrender_tpu_torch import scenes
from webrender_tpu_torch.ops import tile_raster as tr
from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.wrench.yaml_reader import YamlFrameReader

# the reftest documents whose merged root pass is held against Pallas
DOCUMENTS = ("gl-rects.json", "gl-masks.json", "gl-shadows.json",
             "gl-text.json")
# values that may differ from the Pallas kernel in interpret mode, by one
# u8 step: XLA contracts the stop lerp of a quantized gradient ramp
PALLAS_STEPS = {"gl-masks.json": 1}
# the general tiles under gl: values one u8 step from render_tiles(gl=True)
# on XLA (multiply-adds contracted)
XLA_STEPS = 9


def _variant_scene(A, backend):
    """tests/test_kernel_variants.py's scene: a gradient and a rect under a
    rounded clip over a white page."""
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
    return scenes._finish(A, backend, pid, b)


def _jax_gl_backend(case):
    """A JAX backend (Pallas in interpret mode) holding `case` under
    gl_flavor."""
    from webrender_tpu.wrench.yaml_reader import YamlFrameReader as JaxReader
    if case == "variants":
        backend = tw.jax_backend((256, 128))
        backend.frame_builder.gl_flavor = True
        return _variant_scene(tw.jax_api, backend)
    backend = tw.jax_backend(scenes.GL_SMALL_SIZE)
    backend.frame_builder.gl_flavor = True
    JaxReader(scenes.WRENCH / case, scenes.GL_SMALL_SIZE).build(backend)
    return backend


def _pallas_gl(args, kinds, blends, mask_clips):
    import jax.numpy as jnp
    from webrender_tpu.ops.pallas import tile_raster as jt
    a = {k: jnp.asarray(v) for k, v in args.items()}
    return np.asarray(jt.render_tiles_pallas_dense(
        a["dense"], a["counts"], a["origins"], a["clear"], a["f32_rows"],
        a["alpha_atlas"], a["surface_atlas"], a["color_atlas"],
        kinds=kinds, blends=blends, mask_clips=mask_clips, interpret=True,
        gl=True))


@pytest.fixture(scope="module")
def gl_inputs():
    """{case: (kinds, blends, numpy kernel inputs)}, built once."""
    out = {}
    for case in ("variants",) + DOCUMENTS:
        frame, _, _, (kinds, blends, _), args = tw.jax_kernel_inputs(
            _jax_gl_backend(case))
        assert frame.gl_flavor
        out[case] = (kinds, blends, args)
    return out


@pytest.mark.parametrize("mask_clips", [False, True])
@pytest.mark.parametrize("case", ("variants",) + DOCUMENTS)
def test_gl_dispatch_equals_pallas_interpret(gl_inputs, case, mask_clips):
    kinds, blends, args = gl_inputs[case]
    want = _pallas_gl(args, kinds, blends, mask_clips)
    t = tw.to_torch(args)
    before = tr.LaunchCounts.plain_calls
    got = tr.render_tiles_dense(*tw.positional(t), kinds=kinds,
                                blends=blends, mask_clips=mask_clips,
                                gl=True, host_checked=True).numpy()
    assert tr.LaunchCounts.plain_calls == before + 1
    d = np.abs(np.rint(got * 255.0) - np.rint(want * 255.0))
    assert int((d > 0).sum()) <= PALLAS_STEPS.get(case, 0) and \
        float(d.max()) <= 1.0, (int((d > 0).sum()), float(d.max()))
    swgl = tr.render_tiles_dense_plain(*tw.positional(t), kinds=kinds,
                                       blends=blends, mask_clips=mask_clips)
    assert (swgl.numpy() != got).any()
    if case == "gl-text.json":
        assert {7, 8} <= set(blends)
    if case == "gl-rects.json":
        assert 1 in blends
    if case in ("gl-masks.json", "gl-shadows.json"):
        clip_kinds = set(args["f32_rows"][:, 14][
            args["f32_rows"][:, 14] > 0].tolist())
        assert (2.0 if case == "gl-masks.json" else 4.0) in clip_kinds


# --- the llvm sampler --------------------------------------------------------

ATLAS_HW = (37, 53)
# (u0, v0, u1, v1) mask rects: odd sizes inside, at the last column, at the
# last row, at the far corner, and one texel wide
MASK_RECTS = {"inside": (3, 4, 20, 15), "last_column": (40, 2, 53, 11),
              "last_row": (5, 28, 18, 37), "far_corner": (44, 30, 53, 37),
              "one_texel": (10, 10, 11, 11)}


@pytest.mark.parametrize("rect", sorted(MASK_RECTS))
def test_llvm_sample_equals_sample_alpha_llvm(rect):
    from webrender_tpu.ops import patterns as jpk
    rng = np.random.RandomState(11)
    plane = (rng.randint(0, 256, ATLAS_HW) / 255.0).astype(np.float32)
    u0, v0, u1, v1 = (np.float32(c) for c in MASK_RECTS[rect])
    # the rect and a texel and a half past it, at fractions of 1/97 texel
    u = np.linspace(u0 - 1.5, u1 + 1.5, 389, dtype=np.float32)
    v = np.linspace(v0 - 1.5, v1 + 1.5, 211, dtype=np.float32)
    uu, vv = np.meshgrid(u, v)
    want = jpk.sample_alpha_llvm(np, plane, uu, vv, u0, v0, u1, v1)
    scalars = [torch.tensor(c) for c in (u0, v0, u1, v1)]
    (got,) = tr._sep_sample(torch.from_numpy(uu), torch.from_numpy(vv),
                            *scalars, 0.0, torch.from_numpy(plane)[None],
                            llvm=True)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    # the swgl mode differs: 7-bit truncated against 8-bit rounded
    (swgl,) = tr._sep_sample(torch.from_numpy(uu), torch.from_numpy(vv),
                             *scalars, 0.0, torch.from_numpy(plane)[None])
    assert rect == "one_texel" or (swgl.numpy() != want).any()


# --- general tiles -----------------------------------------------------------

def test_general_tiles_under_gl():
    h, kinds, blends = general_mask_clips()
    args, kw, gen = port_inputs(h)
    assert gen.all() and kw["mask_clips"]
    got = tr.render_tiles_dense(*tw.positional(args), host_checked=True,
                                gl=True, **kw).numpy()
    with tw.jax_oracle_float32():
        oracle = tw.oracle_tiles(h, GENERAL_CLEAR, gl=True)
    np.testing.assert_array_equal(got, oracle)
    import jax.numpy as jnp
    from webrender_tpu.ops.raster import render_tiles
    f32, inst, xf, ti = h.arrays()
    xla = np.asarray(render_tiles(
        jnp.asarray(f32), jnp.asarray(inst), jnp.asarray(xf),
        jnp.asarray(ti), jnp.asarray(h.origins),
        jnp.asarray(GENERAL_CLEAR), jnp.asarray(h.color_atlas),
        jnp.asarray(h.alpha_atlas), jnp.asarray(h.surface_atlas),
        kinds=kinds, blends=blends, gl=True))
    d = np.abs(np.rint(got * 255.0) - np.rint(xla * 255.0))
    assert int((d > 0).sum()) <= XLA_STEPS and float(d.max()) <= 1.0, \
        (int((d > 0).sum()), float(d.max()))
    swgl = tr.render_tiles_dense(*tw.positional(args), host_checked=True,
                                 **kw).numpy()
    assert (swgl != got).any()


# --- the renderer ------------------------------------------------------------

def _port_document(name, gl, backend=None):
    backend = backend or RenderBackend(scenes.GL_SMALL_SIZE, device="cpu")
    backend.frame_builder.gl_flavor = gl
    YamlFrameReader(scenes.WRENCH / name, scenes.GL_SMALL_SIZE).build(
        backend)
    return backend


def test_gl_frames_take_the_gl_build():
    backend = _port_document("gl-masks.json", True)
    backend.renderer.dispatch_log = log = []
    backend.render()
    assert log and all(e["gl"] for e in log)
    assert {tr.instantiation(e["kinds"], e["blends"], e["mask_clips"],
                             e["general"], e["step"], e["linear_cm"],
                             e["polygon_clips"], e["gl"])
            for e in log} == {"gl"}
    assert tr.instantiation((0,), (0,), False, gl=True) == "gl"
    assert tr.INSTANTIATIONS["gl"] == (1, 1, 1, 1, 1, 1)
    assert all(v[5] == 0 for k, v in tr.INSTANTIATIONS.items() if k != "gl")


@pytest.mark.parametrize("name", ["gl-rects.json", "gl-gradients.json"])
def test_flavour_change_with_picture_caching(name):
    """One backend, caching on, its frames gl, swgl, gl, swgl: each image
    equals a fresh backend's in the same flavour.  The rects' frame arrays
    are the same in both flavours (only gradients carry the flavour, in
    their u8 quantisation), so nothing but the flavour tells the retained
    framebuffer and the cached tiles apart."""
    fresh = {gl: _port_document(name, gl).render() for gl in (True, False)}
    assert (fresh[True] != fresh[False]).any()
    backend = _port_document(name, True)
    assert backend.renderer.picture_caching
    for gl in (True, False, True, False):
        backend.frame_builder.gl_flavor = gl
        np.testing.assert_array_equal(backend.render(), fresh[gl])


def test_gl_bound_counts_compose_gl():
    from webrender_tpu_torch.ops import roofline
    backend = _port_document("gl-rects.json", True)
    backend.renderer.picture_caching = False
    backend.renderer.dispatch_log = log = []
    backend.render()
    (e,) = log
    args = (e["dense"], e["tile_counts"], e["tile_origins"], e["f32_rows"])
    ops_gl, bytes_gl = roofline.dispatch_work(*args, gl=True)
    ops, nbytes = roofline.dispatch_work(*args)
    assert bytes_gl == nbytes and ops_gl < ops
    ms, by, _, _ = roofline.tile_raster_bound(*args, gl=True)
    assert ms > 0 and by in ("operations", "bytes")


# --- on the card -------------------------------------------------------------

# the documents the card can read (it has no font stack for gl-text)
CUDA_CASES = ("variants",) + tuple(d for d in DOCUMENTS if d != "gl-text.json")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_gl_kernel_equals_plain(case):
    """The merged root pass of the case, built by the port on the card
    under gl_flavor, through the gl build and the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from webrender_tpu_torch import api as port_api
    if case == "variants":
        backend = RenderBackend((256, 128), device="cuda")
        backend.frame_builder.gl_flavor = True
        _variant_scene(port_api, backend)
    else:
        backend = _port_document(case, True, RenderBackend(
            scenes.GL_SMALL_SIZE, device="cuda"))
    inp = scenes.kernel_inputs(backend)
    args = (inp["dense"], inp["counts"], inp["origins"], inp["clear"],
            inp["f32_rows"], inp["alpha_atlas"], inp["surface_atlas"],
            inp["color_atlas"])
    for mask_clips in (False, True):
        before = tr.LaunchCounts.by_instantiation["gl"]
        got = tr.render_tiles_dense(
            *args, kinds=inp["kinds"], blends=inp["blends"],
            mask_clips=mask_clips, general=inp["general"],
            polygon_clips=inp["polygon_clips"] or not mask_clips, gl=True,
            host_checked=True)
        assert tr.LaunchCounts.by_instantiation["gl"] == before + 1
        want = tr.render_tiles_dense_plain(
            *args, kinds=inp["kinds"], blends=inp["blends"],
            mask_clips=mask_clips, gl=True)
        assert float((got - want).abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_conic_angle_divides_once():
    """`patterns.gradient_t_conic` on the card equals it on the CPU, bitwise:
    the angle's division by 2pi goes through `xp.divide` (torch on CUDA
    turns a division by a Python float into a product with the reciprocal,
    which moved 9 quantised conic ramp values of the 4K GL page)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from webrender_tpu_torch.ops import patterns as pk
    from webrender_tpu_torch.ops import xp
    rng = np.random.RandomState(4)
    p = torch.zeros(64)
    p[8:11] = torch.tensor([40.0, 30.0, 0.7])
    p[16:22] = torch.tensor([0.0, 1.0, 300.0, 300.0, 0.0, 0.0])
    lx = torch.from_numpy(rng.uniform(-50, 150, (256, 256)).astype(np.float32))
    ly = torch.from_numpy(rng.uniform(-50, 150, (256, 256)).astype(np.float32))
    want, _ = pk.gradient_t_conic(xp, p, lx, ly)
    got, _ = pk.gradient_t_conic(xp, p.cuda(), lx.cuda(), ly.cuda())
    assert torch.equal(got.cpu(), want)
