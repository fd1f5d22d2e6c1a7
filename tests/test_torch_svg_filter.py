"""The SVG-filter path of the port against the JAX package, on the CPU.

* The small SVG-filter frame (`scenes.svg_filter_scene`, 1024x512: a
  duotone hero, a gooey nav, drop-shadow cards, a knocked-out banner,
  inner-shadow avatars, 15 blend swatches in sRGB and 15 in linearRGB, a
  legacy filter-primitive graph and a CSS `srgb-to-linear`,
  `component-transfer`, `linear-to-srgb` strip) through the port's
  `RenderBackend` with picture caching off and on, against the JAX
  package's numpy oracle (`render_software`): the RGBA8 image and the
  whole surface atlas.  Every sRGB group is bitwise equal.  The groups in
  linearRGB convert through `exp(y * log(x))`, which torch and numpy do not
  round alike: there the port may differ by one u8 step, at a stated
  count.  Each of the frame's kernel dispatches is also held against the
  Pallas kernel in interpret mode on the same inputs.  An edit of a `k`
  value or of a LUT re-renders with caching on.
* Each new offscreen pass (`PASS_CHANNEL_LUT`, `PASS_SRGB` both ways,
  `PASS_ARITH` in sRGB and in linearRGB) against the JAX renderer's
  `_apply_*` and `_copy_region` (its `_quantize_unorm8`), on seeded u8-grid
  regions of odd sizes, overlapping source and destination, `k` values
  that push the result past [0, 1], and alpha 0.
* The plain version's compose (`blend.compose_swgl` under the torch array
  module) for every float-domain op, 2-6, 40-56 and 64-120, against the
  JAX package's `compose_swgl` run by numpy, with `cov == 0` pixels and
  `mcov < 1`; the linearRGB color matrix (flag 2) against
  `patterns.apply_color_matrix(np, ..., 2.0)`, and the picture branches
  with flag 2 against the Pallas kernel in interpret mode.
* Hand-built records of every float-domain op over seeded destination
  tiles (`init_tiles`), so that records composite over pixels they do not
  cover, through the plain version and the Pallas kernel in interpret
  mode; the same records and the linearRGB color matrix, kernel against
  plain version, on the card (`-m cuda`).
"""
import numpy as np
import pytest
import torch

from torch_twin import (IDENTITY_TROW, jax_scene, picture_variant,
                        positional, record, run_pallas, to_torch, u8_planes)

from webrender_tpu_torch import scenes
from webrender_tpu_torch.api.display_item import (
    ComponentTransferFuncType as Func, FilterData)
from webrender_tpu_torch.frame import frame_builder as port_fb
from webrender_tpu_torch.ops import blend as port_blend
from webrender_tpu_torch.ops import dense as dm
from webrender_tpu_torch.ops import patterns as port_pk
from webrender_tpu_torch.ops import tile_raster as tr
from webrender_tpu_torch.ops import xp
from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.renderer import Renderer

SIZE = (1024, 512)
# the small frame's passes (caching on), by name and target
EXPECT_PASSES = {"raster surface": 135, "channel_lut surface": 4,
                 "srgb surface": 10, "downscale surface": 2,
                 "blur_v surface": 6, "blur_h surface": 6,
                 "arith surface": 3, "raster root": 1}
EXPECT_BLENDS = [0] + list(range(2, 7)) + list(range(41, 56)) + \
    [64, 66, 68] + list(range(105, 120))
# the RGBA8 values in which the port differs from the numpy oracle, all
# by one step and inside the linearRGB groups: 10 measured (the nav and
# one linearRGB swatch), where torch's exp or log rounds otherwise than
# numpy's; and in the whole surface atlas
LINEAR_STEPS = 16
ATLAS_STEPS = 256


def _linear_rects():
    """The device rects of the small frame's groups that run in linearRGB
    (the hero's flag-2 matrix, the nav, the cards and their shadows, the
    first avatar, the second row of swatches, the legacy graph), with the
    reach of their shadows and blurs."""
    s = scenes.SVG_SMALL
    rects = [s["hero"], s["nav"], s["avatars"][0], s["legacy"]]
    rects += s["swatches"][1]
    rects += [(x - 16, y - 16, w + 32, h + 40) for x, y, w, h in s["cards"]]
    return [(x - 8, y - 8, w + 16, h + 16) for x, y, w, h in rects]


def _oracle(backend):
    """(RGBA8, surface atlas) of the JAX package's numpy oracle on the
    backend's frame (`RenderBackend.render_software`, keeping the
    oracle's surface atlas)."""
    from webrender_tpu.oracle.sw import SoftwareRenderer
    frame = backend.build_frame()
    backend.renderer.apply_uploads(backend.resources.take_uploads())
    sw = SoftwareRenderer(backend.renderer.color_atlas_host,
                          backend.renderer.alpha_atlas_host)
    return sw.render(frame), sw.surface_atlas


@pytest.fixture(scope="module")
def oracle():
    """(JAX backend, frame, RGBA8, surface atlas) of the numpy oracle."""
    backend = jax_scene(scenes.svg_filter_scene, SIZE)
    frame = backend.build_frame()
    img, atlas = _oracle(backend)
    return backend, frame, img, atlas


def _port(caching, **edits):
    backend = scenes.svg_filter_scene(RenderBackend(SIZE, device="cpu"),
                                      **edits)
    backend.renderer.picture_caching = caching
    return backend


def _assert_linear_steps(got, want):
    """Equal outside the linearRGB groups; inside, at most one u8 step in
    at most LINEAR_STEPS values."""
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    inside = np.zeros(diff.shape[:2], bool)
    for x, y, w, h in _linear_rects():
        inside[max(y, 0):y + h, max(x, 0):x + w] = True
    assert not diff[~inside].any()
    assert (diff > 0).sum() <= LINEAR_STEPS


@pytest.mark.parametrize("caching", [False, True])
def test_svg_frame_equals_the_numpy_oracle(caching, oracle):
    _, _, want, want_atlas = oracle
    np.testing.assert_array_equal(
        np.load(scenes.GOLDENS)[scenes.SVG_FRAME[0]], want)
    port = _port(caching)
    frame = port.build_frame()
    counts = scenes.svg_counts(frame)
    assert counts["passes"] == EXPECT_PASSES
    assert counts["blends"] == EXPECT_BLENDS
    assert counts["cm_flags"] == [0.0, 1.0, 2.0]
    assert counts["arith_linear"] == [True, False, False]
    before = tr.LaunchCounts.plain_calls
    got = port.renderer.render(frame, port.resources)
    assert tr.LaunchCounts.plain_calls - before == 136
    _assert_linear_steps(got, want)
    atlas = port.renderer.surface_atlas.numpy()
    assert atlas.shape == want_atlas.shape
    steps = np.abs(atlas - want_atlas) * 255.0
    assert steps.max() < 1.0 + 1e-3
    assert (steps > 0).sum() <= ATLAS_STEPS


def test_svg_frame_cached_equals_uncached_then_edits_rerender():
    """Caching on (the first frame is held against the oracle above): the
    same frame again launches nothing; a frame whose only change is a `k`
    value of the avatars' arithmetic composite, then one whose only change
    is the hero's LUT, each re-renders and equals an uncached render of
    itself."""
    port = _port(True)
    first = port.render()
    before = tr.LaunchCounts.plain_calls
    np.testing.assert_array_equal(port.render(), first)
    assert tr.LaunchCounts.plain_calls == before
    prev = first
    for edits in (dict(arith=(0.0, 1.0, -0.5, 0.0)),
                  dict(arith=(0.0, 1.0, -0.5, 0.0), table=(0.9, 0.1, 0.4))):
        scenes.svg_filter_scene(port, **edits)
        edited = port.render()
        assert (edited != prev).any()
        np.testing.assert_array_equal(edited, _port(False, **edits).render())
        prev = edited


def _pad(a, nt, slots):
    """Dispatch `a`'s records, counts and origins padded to [nt, slots]."""
    d = a["dense"].numpy()
    dense = np.zeros((nt, slots, 128), np.float32)
    dense[:d.shape[0], :d.shape[1]] = d
    counts = np.zeros(nt, np.int32)
    counts[:d.shape[0]] = a["tile_counts"].numpy()
    origins = np.zeros((nt, 2), np.float32)
    origins[:d.shape[0]] = a["tile_origins"].numpy()
    return dense, counts, origins


def test_svg_dispatches_equal_pallas_interpret(monkeypatch, oracle):
    """Every surface-pass dispatch of the uncached small frame (135 of its
    136; the root pass composites its pictures with blend 0, as the
    effects frame's does, which `test_torch_effects.py` holds against
    Pallas), on the inputs it read, through the Pallas kernel in interpret
    mode with the union of the frame's kinds and blends, padded to one
    shape so that it compiles once: equal to the plain version's output in
    every value (0 measured; the linearRGB ops may differ by a step where
    XLA's exp or log rounds otherwise)."""
    import jax.numpy as jnp
    from webrender_tpu.ops.pallas import tile_raster as jt
    import webrender_tpu_torch.renderer.renderer as rmod
    frame = oracle[1]
    kinds = (0, 2, 6, dm.K_SEP_IMAGE, dm.K_SEP_PICTURE)
    blends = tuple(sorted(set(frame.instances[:, 5].tolist())))
    assert set(dm.FLOAT_BLENDS) & set(blends)
    dispatch = rmod.render_tiles_dense
    held = []

    def hold(**a):
        out = dispatch(**a)
        assert set(a["kinds"]) <= set(kinds)
        if a["dense"].shape[0] <= 16:  # not the root pass
            held.append((a["linear_cm"], a["blends"],
                         _pallas_steps(jt, jnp, a, out, kinds, blends)))
        return out
    monkeypatch.setattr(rmod, "render_tiles_dense", hold)
    _port(False).render()
    assert len(held) == 135 and any(lin for lin, _, _ in held)
    for lin, ops, steps in held:
        assert steps.max() < 1.0 + 1e-3
        if not set(ops) & set(range(64, 121)) and not lin:
            assert steps.max() == 0.0
    assert sum(int((s > 0).sum()) for _, _, s in held) <= LINEAR_STEPS


def _pallas_steps(jt, jnp, a, out, kinds, blends):
    """|Pallas interpret - `out`| in u8 steps, for dispatch `a` (its tiles
    padded to 16 x 8, so that every such dispatch shares one compile)."""
    nt = a["dense"].shape[0]
    dense, counts, origins = _pad(a, 16, 8)
    ref = jt.render_tiles_pallas_dense(
        jnp.asarray(dense), jnp.asarray(counts), jnp.asarray(origins),
        *(jnp.asarray(a[k].numpy()) for k in (
            "clear_color", "f32_rows", "alpha_atlas", "surface_atlas",
            "color_atlas")),
        kinds=kinds, blends=blends, mask_clips=False, interpret=True)
    return np.abs(np.asarray(ref)[:nt] - out.numpy()) * 255.0


def test_4k_svg_scene_builds_its_groups():
    """The 4K page: bench's browsing page, counts unchanged, and the SVG
    groups at their published sizes: every pass kind of the path, the
    float-domain blend ops and color-matrix flag 2, on a frame the
    recorded glyphs build."""
    backend = scenes.build_4k_svg_scene(RenderBackend(
        (3840, 2160), device="cpu", resources=scenes.resource_cache()))
    frame = backend.build_frame()
    counts = scenes.svg_counts(frame)
    assert counts["passes"] == {
        "raster surface": 233, "channel_lut surface": 4,
        "srgb surface": 34, "downscale surface": 2, "blur_v surface": 20,
        "blur_h surface": 20, "arith surface": 7, "raster root": 3}
    assert counts["blends"] == EXPECT_BLENDS
    assert counts["cm_flags"] == [0.0, 1.0, 2.0]
    assert counts["arith_linear"] == [True] * 3 + [False] * 4
    kind = frame.instances[:, 0]
    assert (kind == 2).sum() >= 100 and (kind == 10).sum() > 1000


# --- one offscreen pass ------------------------------------------------------

ATLAS = (96, 160)


def _atlas(seed):
    return u8_planes(np.random.RandomState(seed), ATLAS)


def _jax_pass(kind, atlas, **kw):
    """The JAX renderer's code for one SVG filter pass
    (renderer.py:591-630) on a surface atlas holding `atlas`."""
    import jax
    import jax.numpy as jnp
    from webrender_tpu.frame import frame_builder as jfb
    from webrender_tpu.renderer import renderer as jr
    surface = jnp.asarray(atlas)
    p = jfb.RenderPass(kind, target=jfb.TARGET_SURFACE, **kw)
    sx, sy, sw, sh = p.src_region
    dx, dy, _, _ = p.region
    src = jax.lax.dynamic_slice(surface, (0, sy, sx), (4, sh, sw))
    if kind == jfb.PASS_CHANNEL_LUT:
        out = jr._apply_channel_lut(src, jnp.asarray(p.lut))
    elif kind == jfb.PASS_SRGB:
        out = jr._apply_srgb(src, to_linear=p.srgb_to_linear)
    else:
        bx, by, _, _ = p.src_region2
        b = jax.lax.dynamic_slice(surface, (0, by, bx), (4, sh, sw))
        out = jr._apply_arith(src, b, jnp.asarray(p.kvals, jnp.float32),
                              linear=p.arith_linear)
    return np.asarray(jr._copy_region(surface, out, dx, dy))


def _port_pass(kind, atlas, **kw):
    r = Renderer("cpu", color_atlas_size=(8, 8), alpha_atlas_size=(8, 8),
                 surface_atlas_size=ATLAS)
    r.surface_atlas = torch.from_numpy(atlas.copy())
    r._run_offscreen(port_fb.RenderPass(kind, target=port_fb.TARGET_SURFACE,
                                        **kw), None)
    return r.surface_atlas.numpy()


ODD = (3, 5, 37, 23)
TABLE = port_fb._component_transfer_lut(FilterData(
    func_r=Func.TABLE, values_r=(0.1, 0.9, 0.6), func_g=Func.GAMMA,
    values_g=(1.0, 0.6, 0.05), func_a=Func.DISCRETE,
    values_a=(0.2, 0.7, 1.0)))
PASSES = {
    "lut-table": (port_fb.PASS_CHANNEL_LUT, dict(
        src_region=ODD, region=(60, 40, 37, 23), lut=TABLE)),
    "lut-srgb-overlap": (port_fb.PASS_CHANNEL_LUT, dict(
        src_region=ODD, region=(9, 8, 37, 23),
        lut=port_fb._srgb_lut(True))),
    "srgb-to-linear": (port_fb.PASS_SRGB, dict(
        src_region=ODD, region=(60, 40, 37, 23), srgb_to_linear=True)),
    "srgb-to-srgb-overlap": (port_fb.PASS_SRGB, dict(
        src_region=ODD, region=(9, 8, 37, 23), srgb_to_linear=False)),
    "arith-inner-shadow": (port_fb.PASS_ARITH, dict(
        src_region=ODD, src_region2=(40, 30, 37, 23),
        region=(60, 40, 37, 23), kvals=(0.0, 1.0, -1.0, 0.0))),
    "arith-past-one-overlap": (port_fb.PASS_ARITH, dict(
        src_region=ODD, src_region2=(20, 12, 37, 23),
        region=(10, 9, 37, 23), kvals=(0.9, 0.7, 0.6, 0.2))),
    "arith-below-zero": (port_fb.PASS_ARITH, dict(
        src_region=ODD, src_region2=(40, 30, 37, 23),
        region=(60, 40, 37, 23), kvals=(-1.5, 0.3, 0.2, -0.1))),
    "arith-linear": (port_fb.PASS_ARITH, dict(
        src_region=ODD, src_region2=(40, 30, 37, 23),
        region=(60, 40, 37, 23), kvals=(0.9, 0.7, 0.6, 0.2),
        arith_linear=True)),
}
# values one u8 step apart from the JAX renderer's, per case (XLA's exp
# and log round otherwise than torch's, and it contracts `k1·a·b + k2·a`
# into a fused multiply-add): the measured counts are stated beside
PASS_STEPS = {"srgb-to-linear": 8, "srgb-to-srgb-overlap": 8,
              "arith-linear": 8, "arith-inner-shadow": 0,
              "arith-past-one-overlap": 8, "arith-below-zero": 8}


@pytest.mark.parametrize("case", sorted(PASSES))
def test_svg_pass_matches_jax(case):
    kind, kw = PASSES[case]
    atlas = _atlas(sum(map(ord, case)))
    assert (atlas[3] == 0).any()
    want = _jax_pass(kind, atlas, **kw)
    got = _port_pass(kind, atlas, **kw)
    assert not np.array_equal(want, atlas)
    steps = np.abs(got - want) * 255.0
    assert steps.max() < 1.0 + 1e-3
    assert (steps > 0).sum() <= PASS_STEPS.get(case, 0), case


# --- the float domain of the compose ----------------------------------------

OP_GROUPS = {"porter-duff": tuple(range(2, 7)),
             "svgfe-mix": tuple(range(40, 57)),
             "linear": tuple(range(64, 104)),
             "linear-svgfe-mix": tuple(range(104, 121))}
# values that may be one u8 step apart from numpy per op from 64 (torch's
# exp and log): 0-6 of 800 000 measured per op
LINEAR_OP_STEPS = 16


def _compose_inputs(seed, n=40000):
    """color (premultiplied, u8 grid), cov (a quarter 0, some 1, the rest
    anywhere in [0, 1]), mcov (u8 grid, some 0 and 1) and dst
    (premultiplied u8 grid) over n pixels, [4, n] and [n]."""
    rng = np.random.RandomState(seed)
    color = u8_planes(rng, (n,))
    dst = u8_planes(rng, (n,))
    cov = rng.rand(n).astype(np.float32)
    cov[rng.rand(n) < 0.25] = 0.0
    cov[rng.rand(n) < 0.2] = 1.0
    mcov = (rng.randint(0, 256, n) / 255.0).astype(np.float32)
    mcov[rng.rand(n) < 0.3] = 1.0
    return color, cov, mcov, dst


@pytest.mark.parametrize("group", sorted(OP_GROUPS))
def test_plain_compose_matches_numpy(group):
    from webrender_tpu.ops import blend as jax_blend
    color, cov, mcov, dst = _compose_inputs(sum(map(ord, group)))
    assert (cov == 0).any() and (mcov < 1).any()
    t = [torch.from_numpy(a) for a in (color, cov, mcov, dst)]
    for op in OP_GROUPS[group]:
        want = jax_blend.compose_swgl(np, op, color, cov, mcov, dst)
        got = port_blend.compose_swgl(xp, op, *t).numpy()
        assert want.dtype == got.dtype == np.float32
        steps = np.abs(got - want) * 255.0
        if op < 64:
            np.testing.assert_array_equal(got, want, err_msg=str(op))
        else:
            assert steps.max() < 1.0 + 1e-3, op
            assert (steps > 0).sum() <= LINEAR_OP_STEPS, op
        # uncovered pixels are composited too: `in` clears them
        if op == 2:
            assert (got[:, cov == 0] == 0).all()


def test_linear_color_matrix_matches_numpy():
    """Flag 2 (linearRGB) of `apply_color_matrix`, torch against numpy, on
    the u8 grid its result is packed to (values 1 step apart: torch's exp
    and log), and flags 0 and 1 bitwise."""
    from webrender_tpu.ops import patterns as jax_pk
    rng = np.random.RandomState(11)
    color = u8_planes(rng, (40000,))
    m = np.asarray(scenes.DUOTONE, np.float32) * 1.1
    m[19] = -0.05
    for flag in (0.0, 1.0, 2.0):
        want = jax_pk.apply_color_matrix(np, color, m, np.float32(flag))
        got = port_pk.apply_color_matrix(
            xp, torch.from_numpy(color), torch.from_numpy(m),
            torch.tensor(flag)).numpy()
        if flag < 1.5:
            np.testing.assert_array_equal(got, want)
        else:
            q = np.abs(np.rint(got * 255.0) - np.rint(want * 255.0))
            assert q.max() <= 1.0 and (q > 0).sum() <= LINEAR_OP_STEPS


@pytest.fixture(scope="module")
def effects_root():
    """The small effects frame's root dispatch as the port's uncached
    render made it, the surfaces drawn (its pictures: `KIND_PICTURE` and
    `K_SEP_PICTURE`): the dispatch's sets and its inputs as numpy."""
    backend = scenes.effects_scene(RenderBackend(SIZE, device="cpu"))
    r = backend.renderer
    r.picture_caching = False
    r.dispatch_log = log = []
    backend.render()
    e = log[-1]
    names = dict(dense="dense", counts="tile_counts",
                 origins="tile_origins", clear="clear_color",
                 f32_rows="f32_rows", alpha_atlas="alpha_atlas",
                 surface_atlas="surface_atlas", color_atlas="color_atlas")
    args = {k: e[v].numpy().copy() for k, v in names.items()}
    return (e["kinds"], e["blends"], e["mask_clips"]), args


def test_picture_branches_with_flag_2_match_pallas_interpret(effects_root):
    (kinds, blends, mask_clips), args = effects_root
    assert {6, dm.K_SEP_PICTURE} <= set(kinds)
    t = to_torch(args)
    t["dense"] = picture_variant(t["dense"], t["counts"], "flag1",
                                 scenes.DUOTONE)
    pic = (t["dense"][..., 64] == 6) | (t["dense"][..., 64] == 15)
    t["dense"][..., 36][pic & (t["dense"][..., 36] > 0.5)] = 2.0
    args = dict(args, dense=t["dense"].numpy())
    ref = run_pallas(args, kinds, blends, mask_clips)
    got = tr.render_tiles_dense(*positional(t), kinds=kinds, blends=blends,
                                mask_clips=mask_clips, linear_cm=True)
    steps = np.abs(got.numpy() - ref) * 255.0
    assert steps.max() < 1.0 + 1e-3
    assert (steps > 0).sum() <= LINEAR_OP_STEPS
    assert tr.instantiation(kinds, blends, mask_clips,
                            linear_cm=True) == "filter"


# --- hand-built records over seeded destinations ----------------------------

def float_op_inputs(ops, flag=0.0, seed=9):
    """Kernel inputs (numpy) of one tile per op, each starting from seeded
    u8-grid pixels (`init`): a translucent solid and a picture of the
    surface atlas (its color matrix at `flag`), both drawn with the op over
    fractional rects under a rounded clip, so that the tile holds pixels
    they do not cover, partly covered ones and `mcov < 1`."""
    rng = np.random.RandomState(seed)
    H, W = 192, 512
    n = len(ops)
    origins = np.array([[128.0 * (i % 4), 64.0 * (i // 4)]
                        for i in range(n)], np.float32)
    clip = np.zeros(128, np.float32)
    rows = [np.zeros(128, np.float32)]
    dense = np.zeros((n, 2, 128), np.float32)
    matrix = np.asarray(scenes.GOO, np.float32)
    matrix[15:20] = (0.1, 0.2, 0.3, 0.9, 0.05)
    for i, op in enumerate(ops):
        ox, oy = origins[i]
        crec = clip.copy()
        crec[0:4] = (ox + 6.5, oy + 3.25, ox + 120.5, oy + 60.75)
        crec[4:12] = (18, 14, 6, 6, 24, 20, 9, 4)
        crec[14] = 1.0
        crec[96:108] = IDENTITY_TROW
        rows.append(crec)
        rect = (ox + 9.3, oy + 4.6, ox + 101.3, oy + 47.6)
        solid = record(0, list(rect) * 2 + [0.3, 0.15, 0.05, 0.45],
                       blend=op, clip_row=len(rows) - 1, clip_count=1)
        u0, v0 = 40.0 + 3 * i, 20.0 + 2 * i
        prect = (ox + 30.4, oy + 12.7, ox + 122.4, oy + 61.7)
        pic = record(6, list(prect) * 2 + [u0, v0, u0 + 92.0, v0 + 49.0,
                                           0.8, 0.9, 1.0, 0.95]
                     + list(matrix) + [flag], blend=op,
                     clip_row=len(rows) - 1, clip_count=1)
        dense[i] = (solid, pic)
    return dict(dense=dense, counts=np.full(n, 2, np.int32),
                origins=origins,
                clear=np.array([0.0, 0.0, 0.0, 0.0], np.float32),
                f32_rows=np.stack(rows), alpha_atlas=u8_planes(rng, (H, W))[3],
                surface_atlas=u8_planes(rng, (H, W)),
                color_atlas=u8_planes(rng, (H, W)),
                init=u8_planes(rng, (n, 64, 128)).transpose(1, 0, 2, 3)
                .copy())


HAND_CASES = dict(OP_GROUPS, **{"color-matrix-flag-2": (0, 64)})


def _hand_call(case):
    ops = HAND_CASES[case]
    flag = 2.0 if case == "color-matrix-flag-2" else 0.0
    args = float_op_inputs(ops, flag)
    kw = dict(kinds=(0, 6), blends=tuple(sorted(set(ops))),
              linear_cm=flag > 1.5)
    return args, kw


# values of a tile (of 32 768) one step apart from numpy per op from 64:
# both operands convert at every pixel (38 measured at most, op 67)
HAND_STEPS = 64


@pytest.mark.parametrize("case", sorted(HAND_CASES))
def test_float_ops_over_seeded_tiles_match_numpy(case):
    """The plain version of the hand-built records against the JAX
    package's `compose_swgl` run by numpy, record after record over the
    seeded tiles, on the colors and coverages the plain version's own
    pattern and coverage functions give: equal below op 64, at most a step
    apart in a stated count from 64 and with flag 2 (torch's exp and
    log)."""
    from webrender_tpu.ops import blend as jax_blend
    from webrender_tpu_torch.ops.dense import REC_TROW
    args, kw = _hand_call(case)
    t = to_torch(args)
    got = tr.render_tiles_dense(*positional(t), t["init"], **kw).numpy()
    ops = HAND_CASES[case]
    px, py = tr.tile_pixels(t["origins"])
    ox, oy = t["origins"][:, 0, None, None], t["origins"][:, 1, None, None]
    want = args["init"].transpose(1, 0, 2, 3).copy()
    for slot in range(args["dense"].shape[1]):
        rec = tr._cols(t["dense"][:, slot])
        _, _, cov, mcov = tr.record_coverage(rec, px, py, t["f32_rows"])
        if int(args["dense"][0, slot, 64]) == 0:
            color = rec[8:12].expand(4, *cov.shape)
        else:
            color = tr._sampled_translation(
                6, rec[:64], rec[REC_TROW:REC_TROW + 12], ox, oy,
                (t["alpha_atlas"], t["surface_atlas"], t["color_atlas"]))
        color, cov, mcov = (v.numpy() for v in (color, cov, mcov))
        assert (cov == 0).any() and ((mcov > 0) & (mcov < 1)).any()
        for i, op in enumerate(ops):
            want[:, i] = jax_blend.compose_swgl(np, op, color[:, i], cov[i],
                                                mcov[i], want[:, i])
    steps = np.abs(got - want.transpose(1, 0, 2, 3)) * 255.0
    for i, op in enumerate(ops):
        if op < 64 and case != "color-matrix-flag-2":
            np.testing.assert_array_equal(steps[i], 0.0, err_msg=str(op))
        assert steps[i].max() < 1.0 + 1e-3, op
        assert (steps[i] > 0).sum() <= HAND_STEPS, op
    # the records changed pixels they do not cover: `in` clears them
    if 2 in ops:
        i = ops.index(2)
        assert (got[i] == 0).all(0).sum() > (args["init"][i] == 0).all(0).sum()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(HAND_CASES))
def test_cuda_float_ops_match_plain(cuda_device, case):
    """The kernel's filter build against the plain version on the card, on
    the hand-built records over seeded tiles: equal in every value (the
    plain version's torch.exp and torch.log on the card are the kernel's
    expf and logf)."""
    args, kw = _hand_call(case)
    t = to_torch(args, cuda_device)
    before = tr.LaunchCounts.by_instantiation["filter"]
    out = tr.render_tiles_dense(*positional(t), t["init"], **kw)
    torch.cuda.synchronize()
    assert tr.LaunchCounts.by_instantiation["filter"] == before + 1
    ref = tr.render_tiles_dense_plain(*positional(t), t["init"],
                                      kinds=kw["kinds"], blends=kw["blends"])
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_svg_frame_matches_plain(cuda_device):
    """Every dispatch of the small frame, kernel against plain version on
    the card, and the image within one step of the numpy oracle's."""
    import webrender_tpu_torch.renderer.renderer as rmod
    dispatch = rmod.render_tiles_dense
    diffs = []

    def hold(**a):
        out = dispatch(**a)
        plain = {k: v for k, v in a.items()
                 if k not in ("gl", "general", "linear_cm", "polygon_clips",
                              "host_checked")}
        diffs.append(float((out - tr.render_tiles_dense_plain(**plain))
                           .abs().max()))
        return out
    rmod.render_tiles_dense = hold
    try:
        backend = scenes.svg_filter_scene(RenderBackend(
            SIZE, device=cuda_device, resources=scenes.resource_cache()))
        backend.renderer.picture_caching = False
        img = backend.render()
    finally:
        rmod.render_tiles_dense = dispatch
    assert len(diffs) == 136 and max(diffs) == 0.0
    want = np.load(scenes.GOLDENS)[scenes.SVG_FRAME[0]]
    assert np.abs(img.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.cuda
def test_cuda_division_by_a_python_float_rounds_once(cuda_device):
    """torch on CUDA divides a tensor by a Python float as a product with
    its reciprocal, which rounds twice: `blend.srgb_to_linear`'s
    `c / 12.92` made the plain version differ from the kernel by a step.
    `xp.divide` puts the divisor on the card as a tensor: its quotients
    equal numpy's (IEEE, rounded once) in every value, where `/` does
    not."""
    x = np.arange(1 << 20, dtype=np.float32) / np.float32(1 << 20)
    t = torch.from_numpy(x).to(cuda_device)
    for c in (12.92, 1.055):
        want = x / np.float32(c)
        np.testing.assert_array_equal(xp.divide(t, c).cpu().numpy(), want)
        assert not np.array_equal((t / c).cpu().numpy(), want)
