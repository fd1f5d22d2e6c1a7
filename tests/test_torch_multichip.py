"""Twins of tests/test_multichip.py for the port's multi-device path
(`webrender_tpu_torch/parallel/`, SPMD over `torch.distributed`), on the
CPU over gloo.  Tolerance 0 throughout: every comparison is bitwise.

The ranks are spawned processes (`parallel.dryrun.run_ranks`): one world of
8 ranks makes every check of that size in one go (`_world`), one world of
2 the frame; they run in a thread of this process while the JAX side is
computed here, on conftest.py's 8-device virtual mesh.  This module is
imported by the ranks too, so it imports neither JAX nor the JAX package
at its top: the JAX side imports them where it runs, and the ranks report
that they loaded neither.

* The blurred 1024x256 frame of `tests/test_multichip.py` (`_scene`, a copy
  of its `_scene_backend`) rendered over the mesh at world sizes 2 and 8
  equals the port's unsharded render and JAX's render over its mesh;
  the routes follow JAX's rules (a dispatch of fewer tiles than ranks and
  a blur of fewer than two rows per rank stay unsharded) and are counted.
* One raster pass with its last tile dropped (8 does not divide its tile
  count) through `render_tiles_sharded` equals the port's unsharded
  dispatch and JAX's `render_tiles_sharded`.
* The row-sharded blur at radii 2, 8 and 16 (16 is more than the 12 rows
  of a shard: the gather-all branch) along both axes equals the port's
  `blur_region` and JAX's `blur_image_sharded`; with a blur region smaller
  than the task it equals JAX's sharded blur everywhere, `blur_region`
  inside the region, and differs from it outside at JAX's own counts.
* The 512x128 test frame of `__graft_entry__` (16 rects, a blurred
  group) through `render_tiles_pallas_sharded` equals JAX's
  `render_tiles_pallas_sharded` (the Pallas kernel in interpret mode)
  dispatch by dispatch, and the images are equal.
* `make_mesh` and `Renderer(mesh=)` refuse impossible meshes;
  `dryrun_multichip(2, device="cpu")` passes and prints its line; on a
  card (marker `cuda`) a world of one rank over NCCL renders the frame
  through the CUDA kernel, equal to the unsharded render.
"""
import concurrent.futures
import dataclasses
import hashlib
import sys

import numpy as np
import pytest
import torch

import webrender_tpu_torch.api as port_api
from webrender_tpu_torch import scenes
from webrender_tpu_torch.frame.gpu import INST_BLEND, INST_KIND
from webrender_tpu_torch.frame.tiles import TILE_H, TILE_W
from webrender_tpu_torch.ops import raster as raster_ops
from webrender_tpu_torch.parallel import dryrun
from webrender_tpu_torch.parallel import mesh as mesh_mod
from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.renderer import Renderer
from webrender_tpu_torch.renderer import renderer as renderer_mod

FRAME_SIZE = (1024, 256)
GRAFT_SIZE = (512, 128)
BLUR_SHAPE = (4, 96, 256)
RADII = (2, 8, 16)
# a blur region smaller than its task: [0, 80) x [0, 200) of the image
REGION = (200, 80)
REGION_RADII = (2, 8)
# values outside the region where JAX's sharded blur differs from its
# blur_region, by (radius, axis): the reference's own counts
MARGIN_DIFFS = {(2, 0): 16208, (2, 1): 21168, (8, 0): 16297, (8, 1): 21425}
WORLD_TIMEOUT = 240.0


def _scene(A, backend, size=FRAME_SIZE, with_blur=True):
    """`tests/test_multichip.py::_scene_backend`'s display list, built with
    the API namespace `A`, sent to `backend`."""
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    root = A.SpatialId.root_scroll_node(pid)
    common = A.CommonItemProperties(A.Rect(0, 0, 4096, 4096), root)
    rng = np.random.RandomState(11)
    for i in range(40):
        x = float(rng.uniform(0, size[0] - 80))
        y = float(rng.uniform(0, size[1] - 60))
        if i % 4 == 0:
            g, stops = b.create_gradient(
                A.Point2D(0, 0), A.Point2D(80, 40),
                [A.GradientStop(0.0, A.ColorF(1, 0, 0, 1)),
                 A.GradientStop(1.0, A.ColorF(0, 0, 1, 0.7))],
                A.ExtendMode.CLAMP)
            b.push_gradient(common, A.Rect(x, y, 80, 50), g, stops)
        else:
            b.push_rect(common, A.Rect(x, y, 80, 50),
                        A.ColorF(float(rng.rand()), float(rng.rand()),
                                 float(rng.rand()), 0.9))
    clip = b.define_clip_rounded_rect(root, A.Rect(16, 16, 300, 180),
                                      A.BorderRadius.uniform(30.0))
    chain = b.define_clip_chain(None, [clip])
    b.push_rect(dataclasses.replace(common, clip_chain_id=chain),
                A.Rect(0, 0, 400, 220), A.ColorF(0, 1, 0, 0.5))
    if with_blur:
        b.push_stacking_context(A.Point2D(0, 0), root,
                                filters=[A.FilterOp.blur(5.0, 5.0)])
        b.push_rect(common, A.Rect(60, 40, 200, 120),
                    A.ColorF(0.9, 0.4, 0.1, 1))
        b.pop_stacking_context()
    _, dl = b.end()
    txn = A.Transaction()
    txn.set_root_pipeline(pid)
    txn.set_display_list(A.Epoch(0), dl)
    txn.generate_frame()
    backend.send_transaction(txn)
    return backend


def _blur_image():
    return np.random.RandomState(3).rand(*BLUR_SHAPE).astype(np.float32)


def _blur_cases():
    """(radius, axis, bw, bh) of every blur the twins compare."""
    return [(r, a, 0, 0) for r in RADII for a in (0, 1)] + \
        [(r, a) + REGION for r in REGION_RADII for a in (0, 1)]


# --- the ranks' side ---------------------------------------------------------

def _last_raster_pass(frame):
    return [q for q in frame.passes if q.tile_insts is not None][-1]


def _frame_checks(mesh):
    """The blurred frame unsharded and over the mesh, the routes taken and
    the routes JAX's rules give for the frame's passes."""
    ref = _scene(port_api, RenderBackend(FRAME_SIZE, device="cpu")).render()
    backend = _scene(port_api, RenderBackend(
        FRAME_SIZE, renderer=Renderer("cpu", mesh=mesh)))
    out = backend.render()
    frame = backend.last_frame
    rule = {"kernel": 0, "kernel-sharded": 0, "blur": 0, "blur-sharded": 0}
    for p in frame.passes:
        if p.tile_insts is not None:
            rule["kernel-sharded" if p.tile_insts.shape[0] >= mesh.size
                 else "kernel"] += 1
        elif p.sigma is not None and p.sigma > 0:
            bh = p.blur_region[1] if p.blur_region is not None \
                else p.src_region[3]
            rule["blur-sharded" if bh >= 2 * mesh.size else "blur"] += 1
    return {"ref": ref, "out": out,
            "counts": dict(backend.renderer.engine_counts), "rule": rule}


def _texel_page(backend, seed, first):
    """A 512x128 page tiled with image 3 (16x16, seeded texels) and a
    scroll frame holding it too; `first`: the display list and the image,
    else a same-size update of the image alone (C2)."""
    A = port_api
    px = np.random.RandomState(seed).randint(0, 256, (16, 16, 4))
    px = px.astype(np.uint8)
    px[..., 3] = 255
    txn = A.Transaction()
    desc = A.ImageDescriptor(A.ImageFormat.RGBA8, 16, 16)
    if not first:
        txn.update_image(3, desc, A.ImageData(pixels=px))
        txn.generate_frame()
        backend.send_transaction(txn)
        return backend
    txn.add_image(3, desc, A.ImageData(pixels=px))
    pid = A.PipelineId(0, 1)
    b = A.DisplayListBuilder(pid)
    b.begin()
    root = A.SpatialId.root_scroll_node(pid)
    common = A.CommonItemProperties(A.Rect(0, 0, 4096, 4096), root)
    b.push_repeating_image(common, A.Rect(0, 0, 512, 128), A.Size2D(24, 24),
                           A.Size2D(8, 8), A.ImageRendering.AUTO,
                           A.AlphaType.PREMULTIPLIED_ALPHA, 3)
    sf = b.define_scroll_frame(root, external_id=9,
                               content_rect=A.Rect(0, 0, 512, 1000),
                               frame_rect=A.Rect(0, 0, 512, 128))
    inner = A.CommonItemProperties(A.Rect(0, 0, 4096, 4096), sf)
    b.push_image(inner, A.Rect(40, 30, 400, 90), A.ImageRendering.AUTO,
                 A.AlphaType.PREMULTIPLIED_ALPHA, 3)
    _, dl = b.end()
    txn.set_root_pipeline(pid)
    txn.set_display_list(A.Epoch(0), dl)
    txn.generate_frame()
    backend.send_transaction(txn)
    return backend


def _texel_checks(mesh):
    """The page over the mesh with picture caching on and unsharded with it
    off, then three same-size updates of its image: each frame's images,
    dirty tiles and sharded launches."""
    ref = _texel_page(RenderBackend(GRAFT_SIZE, device="cpu"), 0, True)
    ref.renderer.picture_caching = False
    backend = _texel_page(RenderBackend(
        GRAFT_SIZE, renderer=Renderer("cpu", mesh=mesh)), 0, True)
    frames = []
    for seed in range(4):
        if seed:
            _texel_page(ref, seed, False)
            _texel_page(backend, seed, False)
        before = backend.renderer.engine_counts["kernel-sharded"]
        frames.append({"ref": ref.render(), "out": backend.render(),
                       "dirty": backend.renderer.last_dirty_tiles,
                       "sharded": backend.renderer.engine_counts[
                           "kernel-sharded"] - before})
    return frames


def _pass_checks(mesh):
    """`render_tiles_sharded` on the frame's last raster pass with its last
    tile dropped, and the port's unsharded dispatch of the whole pass."""
    backend = _scene(port_api, RenderBackend(FRAME_SIZE, device="cpu"),
                     with_blur=False)
    frame = backend.build_frame()
    r = backend.renderer
    r.apply_uploads(backend.resources.take_uploads())
    p = _last_raster_pass(frame)
    ids = np.unique(p.tile_insts[p.tile_insts >= 0])
    kinds = tuple(sorted(set(frame.instances[ids, INST_KIND].tolist())))
    blends = tuple(sorted(set(frame.instances[ids, INST_BLEND].tolist())))
    origins = renderer_mod.tile_origins(p)
    out = mesh_mod.render_tiles_sharded(
        mesh, frame.f32_buf, frame.instances, frame.transforms,
        p.tile_insts[:-1], origins[:-1], np.asarray(p.clear, np.float32),
        r.color_atlas, r.alpha_atlas, r.surface_atlas, kinds=kinds,
        blends=blends)
    ref = renderer_mod.render_tiles_dense(**r.kernel_args(frame, p),
                                          host_checked=True)
    return {"out": out.numpy(), "ref": ref.numpy(), "nt": p.nx * p.ny}


def _blur_checks(mesh):
    """Every blur case sharded and unsharded, with the halo exchanges each
    sharded blur made."""
    img = torch.from_numpy(_blur_image())
    out = {}
    for radius, axis, bw, bh in _blur_cases():
        w = raster_ops.gaussian_weights(radius / 3.0, radius)
        before = mesh_mod.ShardedCounts.halo_exchanges
        sharded = mesh_mod.blur_image_sharded(mesh, img, w, radius=radius,
                                              axis=axis, bw=bw, bh=bh)
        plain = raster_ops.blur_region(img, w, radius=radius, axis=axis,
                                       bw=bw, bh=bh)
        out[radius, axis, bw, bh] = (
            sharded.numpy(), plain.numpy(),
            mesh_mod.ShardedCounts.halo_exchanges - before)
    return out


def _graft_checks(mesh):
    """The 512x128 `__graft_entry__` test frame over the mesh, its sharded
    dispatches' outputs, and the unsharded render."""
    ref = scenes.graft_test_scene(
        RenderBackend(GRAFT_SIZE, device="cpu"), GRAFT_SIZE, 16,
        with_blur=True).render()
    inner = renderer_mod.render_tiles_pallas_sharded
    outs = []

    def capture(*args, **kw):
        out = inner(*args, **kw)
        outs.append(out.numpy().copy())
        return out
    renderer_mod.render_tiles_pallas_sharded = capture
    try:
        out = scenes.graft_test_scene(RenderBackend(
            GRAFT_SIZE, renderer=Renderer("cpu", mesh=mesh)), GRAFT_SIZE, 16,
            with_blur=True).render()
    finally:
        renderer_mod.render_tiles_pallas_sharded = inner
    return {"ref": ref, "out": out, "tiles": outs}


def _refusals(mesh):
    """What make_mesh raises for a mesh larger than the world and for CUDA
    on a machine without it."""
    found = {}
    for name, kw in (("n", dict(n=mesh.size + 1, device="cpu")),
                     ("cuda", dict(device="cuda"))):
        try:
            mesh_mod.make_mesh(**kw)
        except RuntimeError as e:
            found[name] = str(e)
    return found


def _loaded_jax():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "webrender_tpu"))


def _world(mesh, full):
    """One rank's checks; rank 0 returns them, every rank the digest of
    what it gathered (the ranks must all hold the same images)."""
    res = {"frame": _frame_checks(mesh), "texel": _texel_checks(mesh)}
    if full:
        res.update(passes=_pass_checks(mesh), blur=_blur_checks(mesh),
                   graft=_graft_checks(mesh), refusals=_refusals(mesh))
    res["loaded"] = _loaded_jax()
    res["digest"] = hashlib.sha256(res["frame"]["out"].tobytes()).hexdigest()
    if mesh.rank == 0:
        return res
    return {"digest": res["digest"], "loaded": res["loaded"]}


def _cuda_world(mesh):
    ref = _scene(port_api, RenderBackend(FRAME_SIZE, device=mesh.device))
    backend = _scene(port_api, RenderBackend(
        FRAME_SIZE, renderer=Renderer(mesh.device, mesh=mesh)))
    return {"ref": ref.render(), "out": backend.render(),
            "counts": dict(backend.renderer.engine_counts),
            "launches": mesh_mod.ShardedCounts.launches,
            "backend": mesh.backend}


# --- the test process's side -------------------------------------------------

@pytest.fixture(scope="module")
def worlds():
    """The worlds of 8 and 2 ranks, started together in threads; their
    futures, read by the tests (each rank's results list)."""
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {8: pool.submit(dryrun.run_ranks, _world, 8, "cpu", (True,),
                              WORLD_TIMEOUT),
               2: pool.submit(dryrun.run_ranks, _world, 2, "cpu", (False,),
                              WORLD_TIMEOUT)}
    yield futures
    pool.shutdown(wait=True)


def _rank0(worlds, size):
    return worlds[size].result(timeout=WORLD_TIMEOUT + 60)[0]


@pytest.fixture(scope="module")
def jax_mesh():
    from webrender_tpu.parallel.mesh import make_mesh
    return make_mesh(n=8)


@pytest.fixture(scope="module")
def jax_frame_image(jax_mesh, worlds):
    """JAX's render of the blurred frame over its 8-device mesh (its XLA
    engine, as `test_sharded_frame_bit_equal` renders it)."""
    import webrender_tpu.api as jax_api
    from webrender_tpu.render_backend import RenderBackend as JaxBackend
    from webrender_tpu.renderer.renderer import Renderer as JaxRenderer
    backend = _scene(jax_api, JaxBackend(FRAME_SIZE, renderer=JaxRenderer(
        mesh=jax_mesh, use_pallas=False)))
    img = backend.render()
    assert backend.renderer.engine_counts.get("sharded", 0) > 0
    return img


@pytest.mark.parametrize("size", [2, 8])
def test_sharded_frame_equals_unsharded_and_jax(worlds, jax_frame_image,
                                                size):
    """The frame (surface raster, downscale, blur, picture composite, root
    raster) rendered over `size` ranks equals the unsharded render and
    JAX's, and every rank gathered the same image."""
    results = worlds[size].result(timeout=WORLD_TIMEOUT + 60)
    frame = results[0]["frame"]
    assert frame["counts"]["kernel-sharded"] > 0, frame["counts"]
    assert np.array_equal(frame["out"], frame["ref"])
    assert np.array_equal(frame["out"], jax_frame_image)
    assert len({r["digest"] for r in results}) == 1


@pytest.mark.parametrize("size", [2, 8])
def test_sharded_cached_frames_see_image_updates(worlds, size):
    """C2 on the mesh routes: a same-size image update with no new display
    list re-rasters the cached root and slice tiles that sample it, over
    the mesh (sharded launches), and every frame equals the unsharded
    uncached render of the same state."""
    frames = _rank0(worlds, size)["texel"]
    for i, f in enumerate(frames):
        assert np.array_equal(f["out"], f["ref"]), i
        assert f["sharded"] > 0, (i, f["sharded"])
    assert len({f["dirty"] for f in frames[1:]}) == 1
    assert 0 < frames[1]["dirty"] <= frames[0]["dirty"]
    assert len({f["out"].tobytes() for f in frames}) == len(frames)


def test_routes_follow_jax_rules(worlds):
    """At 8 ranks the frame's 6-tile surface raster stays unsharded, its
    32-tile root pass and both blurs (75 rows) are sharded, as JAX's rules
    (`nt >= size`, `bh >= 2 * size`) say, and every route is counted."""
    frame = _rank0(worlds, 8)["frame"]
    assert frame["counts"] == frame["rule"]
    assert frame["counts"] == {"kernel": 1, "kernel-sharded": 1, "blur": 0,
                               "blur-sharded": 2}


def test_ranks_load_no_jax(worlds):
    """The ranks import the port and this module, and neither JAX nor the
    JAX package."""
    for size in (2, 8):
        for res in worlds[size].result(timeout=WORLD_TIMEOUT + 60):
            assert res["loaded"] == [], res["loaded"]


def test_sharded_raster_pass_with_padding(worlds, jax_mesh):
    """`render_tiles_sharded` on a pass whose tile count 8 does not divide
    equals the unsharded dispatch and JAX's `render_tiles_sharded`."""
    import webrender_tpu.api as jax_api
    from webrender_tpu.parallel.mesh import render_tiles_sharded
    from webrender_tpu.render_backend import RenderBackend as JaxBackend
    res = _rank0(worlds, 8)["passes"]
    assert (res["nt"] - 1) % 8 != 0
    assert res["out"].shape[0] == res["nt"] - 1
    assert np.array_equal(res["out"], res["ref"][:-1])

    backend = _scene(jax_api, JaxBackend(FRAME_SIZE), with_blur=False)
    frame = backend.build_frame()
    r = backend.renderer
    r.apply_uploads(backend.resources.take_uploads())
    p = _last_raster_pass(frame)
    ids = np.unique(p.tile_insts[p.tile_insts >= 0])
    kinds = tuple(sorted(set(frame.instances[ids, INST_KIND].tolist())))
    blends = tuple(sorted(set(frame.instances[ids, INST_BLEND].tolist())))
    origins = r._tile_origins(p)
    want = np.asarray(render_tiles_sharded(
        jax_mesh, frame.f32_buf, frame.instances, frame.transforms,
        p.tile_insts[:-1], origins[:-1], np.asarray(p.clear, np.float32),
        r.color_atlas, r.alpha_atlas, r.surface_atlas, kinds=kinds,
        blends=blends))
    assert want.shape == res["out"].shape
    assert np.array_equal(res["out"], want)


def _jax_blurs(jax_mesh, radius, bw=0, bh=0):
    """(JAX's sharded blur, JAX's blur_region) along axes 0 and 1."""
    import jax.numpy as jnp
    from webrender_tpu.ops.raster import blur_region, gaussian_weights
    from webrender_tpu.parallel.mesh import blur_image_sharded
    w = jnp.asarray(gaussian_weights(radius / 3.0, radius))
    out = {}
    for axis in (0, 1):
        # a new array for each call: blur_region donates its input
        out[axis] = (
            np.asarray(blur_image_sharded(
                jax_mesh, jnp.asarray(_blur_image()), w, radius=radius,
                axis=axis, bw=bw, bh=bh)),
            np.asarray(blur_region(jnp.asarray(_blur_image()), w,
                                   radius=radius, axis=axis, bw=bw, bh=bh)))
    return out


@pytest.mark.parametrize("radius", RADII)
def test_sharded_blur_halo_exchange(worlds, jax_mesh, radius):
    """The row-sharded blur over 8 ranks equals `blur_region` and JAX's
    sharded blur along both axes; the vertical blur exchanged halo rows
    unless its radius exceeds a shard's 12 rows (then it gathered every
    row), the horizontal one never did."""
    blur = _rank0(worlds, 8)["blur"]
    jax_out = _jax_blurs(jax_mesh, radius)
    for axis in (0, 1):
        sharded, plain, halos = blur[radius, axis, 0, 0]
        assert np.array_equal(sharded, plain), (radius, axis)
        assert np.array_equal(sharded, jax_out[axis][0]), (radius, axis)
        assert np.array_equal(plain, jax_out[axis][1]), (radius, axis)
        assert halos == (1 if axis == 0 and radius < BLUR_SHAPE[1] // 8
                         else 0), (radius, axis, halos)


@pytest.mark.parametrize("radius", REGION_RADII)
def test_sharded_blur_region_margin(worlds, jax_mesh, radius):
    """With a blur region smaller than its task the sharded blur equals
    JAX's sharded blur everywhere and `blur_region` inside the region;
    outside it the two differ where JAX's differ, at JAX's counts (the
    sharded blur edge-pads the content to the task and blurs it,
    `blur_region` edge-replicates its output)."""
    bw, bh = REGION
    blur = _rank0(worlds, 8)["blur"]
    jax_out = _jax_blurs(jax_mesh, radius, bw, bh)
    for axis in (0, 1):
        sharded, plain, _ = blur[radius, axis, bw, bh]
        jax_sharded, jax_plain = jax_out[axis]
        assert np.array_equal(sharded, jax_sharded), (radius, axis)
        assert np.array_equal(plain, jax_plain), (radius, axis)
        assert np.array_equal(sharded[:, :bh, :bw], plain[:, :bh, :bw])
        differ = sharded != plain
        assert not differ[:, :bh, :bw].any()
        assert np.array_equal(differ, jax_sharded != jax_plain)
        assert int(differ.sum()) == MARGIN_DIFFS[radius, axis]


def test_sharded_pallas_graft_frame(worlds, jax_mesh, monkeypatch):
    """The `__graft_entry__` test frame at 512x128 (16 rects, a blurred
    group) over 8 ranks: each sharded dispatch equals JAX's
    `render_tiles_pallas_sharded` (the Pallas kernel in interpret mode on
    its 8-device mesh), and the image equals the unsharded render and
    JAX's."""
    import __graft_entry__ as g
    import webrender_tpu.parallel.mesh as jax_mesh_mod
    graft = _rank0(worlds, 8)["graft"]
    jax_tiles = []
    inner = jax_mesh_mod.render_tiles_pallas_sharded

    def capture(*args, **kw):
        out = inner(*args, **kw)
        jax_tiles.append(np.asarray(out))
        return out
    monkeypatch.setattr(jax_mesh_mod, "render_tiles_pallas_sharded", capture)
    backend, frame = g._build_test_frame(size=GRAFT_SIZE, n_rects=16,
                                         with_blur=True, mesh=jax_mesh)
    want = backend.renderer.render(frame, backend.resources)
    assert len(graft["tiles"]) == len(jax_tiles) >= 1
    for ours, theirs in zip(graft["tiles"], jax_tiles):
        assert np.array_equal(ours, theirs)
    assert np.array_equal(graft["out"], graft["ref"])
    assert np.array_equal(graft["out"], np.asarray(want))


def test_mesh_device_count_enforced(worlds):
    """A mesh larger than the process group, or on CUDA without a card,
    fails loudly; it never shrinks."""
    found = _rank0(worlds, 8)["refusals"]
    assert "9" in found["n"] and "8" in found["n"], found
    assert "CUDA" in found["cuda"], found


def test_make_mesh_needs_a_process_group():
    """Outside a process group there is no mesh (this process never
    initialises one)."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        mesh_mod.make_mesh(device="cpu")


def test_renderer_refuses_a_mesh_on_another_device():
    """A renderer's mesh must be on its device."""
    other = mesh_mod.Mesh(None, 1, 2, torch.device("cuda", 1), "nccl")
    with pytest.raises(ValueError, match="cuda:1"):
        Renderer("cpu", mesh=other)


def test_sharded_bound_counts_the_shard_and_the_gathered_output():
    """The bound of a rank's part (`roofline.tile_raster_sharded_bound`):
    the shards' operations add up to the dispatch's, a world of one is
    the unsharded bound, and each rank writes the whole gathered output."""
    from webrender_tpu_torch.ops import roofline
    backend = scenes.graft_test_scene(RenderBackend(GRAFT_SIZE,
                                                    device="cpu"))
    frame = backend.build_frame()
    r = backend.renderer
    r.picture_caching = False
    (p,) = renderer_mod.merged_root_passes(frame)
    a = r.kernel_args(frame, p)
    nt = a["dense"].shape[0]
    full = roofline.tile_raster_bound(a["dense"], a["tile_counts"],
                                      a["tile_origins"], a["f32_rows"])
    assert roofline.tile_raster_sharded_bound(
        a["dense"], a["tile_counts"], a["tile_origins"], a["f32_rows"],
        nt) == full
    half = nt // 2
    parts = [roofline.tile_raster_sharded_bound(
        a["dense"][s], a["tile_counts"][s], a["tile_origins"][s],
        a["f32_rows"], nt) for s in (slice(0, half), slice(half, nt))]
    assert parts[0][2] + parts[1][2] == full[2]
    tile_bytes = 4 * TILE_H * TILE_W * 4
    for s, part in zip((slice(0, half), slice(half, nt)), parts):
        alone = roofline.dispatch_work(a["dense"][s], a["tile_counts"][s],
                                       a["tile_origins"][s], a["f32_rows"])
        assert part[3] == alone[1] + (nt - (s.stop - s.start)) * tile_bytes


def test_render_tiles_sharded_refuses_unlisted_kinds():
    """`render_tiles_sharded` takes the pass's instance kinds and blend ops,
    as JAX's `render_tiles` does, and refuses tile lists that name others
    before any collective (this mesh of one rank has no process group)."""
    backend = _scene(port_api, RenderBackend(FRAME_SIZE, device="cpu"),
                     with_blur=False)
    frame = backend.build_frame()
    r = backend.renderer
    p = _last_raster_pass(frame)
    one = mesh_mod.Mesh(None, 0, 1, torch.device("cpu"), "gloo")
    for kinds, blends, what in (((0,), (0, 1, 2, 3, 4, 5, 6, 7, 8), "kind"),
                                (tuple(range(20)), (), "blend op")):
        with pytest.raises(ValueError, match=f"instance {what}s"):
            mesh_mod.render_tiles_sharded(
                one, frame.f32_buf, frame.instances, frame.transforms,
                p.tile_insts, renderer_mod.tile_origins(p),
                np.asarray(p.clear, np.float32), r.color_atlas,
                r.alpha_atlas, r.surface_atlas, kinds=kinds, blends=blends)


def test_dryrun_multichip_cpu(capfd):
    """The port's dry run at two ranks over gloo passes, and rank 0 prints
    its line."""
    out = dryrun.dryrun_multichip(2, device="cpu", timeout=WORLD_TIMEOUT)
    assert out["engine_counts"]["kernel-sharded"] > 0, out
    assert out["engine_counts"]["blur-sharded"] > 0, out
    printed = capfd.readouterr().out
    assert printed.count("dryrun_multichip:") == 1, printed
    assert "across 2 ranks (gloo on cpu); sharded == unsharded bit-exact" \
        in printed


def test_dryrun_refuses_more_ranks_than_cards():
    """On CUDA the dry run asks for one card per rank before it spawns."""
    n = (torch.cuda.device_count() if torch.cuda.is_available() else 0) + 1
    with pytest.raises(RuntimeError, match="cards"):
        dryrun.dryrun_multichip(n, device="cuda")


@pytest.mark.cuda
def test_cuda_world_of_one_over_nccl():
    """On a card: a world of one rank over NCCL renders the frame through
    the CUDA kernel (sharded dispatches, the sharded blur, the gather),
    equal to the unsharded render."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    (res,) = dryrun.run_ranks(_cuda_world, 1, "cuda", timeout=WORLD_TIMEOUT)
    assert res["backend"] == "nccl"
    assert res["counts"]["kernel-sharded"] > 0, res["counts"]
    assert res["counts"]["blur-sharded"] > 0, res["counts"]
    assert res["launches"] == res["counts"]["kernel-sharded"]
    assert np.array_equal(res["out"], res["ref"])
