#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (webrender_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA tile-raster kernel into build/ and runs thirteen phases,
each printing its own lines:

1. toolchain and card: nvidia-smi's name and power limit, the torch, CUDA,
   Triton and nvcc versions, and whether the font stack loads;
2. the kernel build and its time;
3. the kernel against its plain PyTorch version, and the RGBA8 image
   against the JAX package's (testdata/goldens.npz), on four small
   frames;
4. the uncached path: bench.py's 4K browsing frame through the port's
   RenderBackend on the card with picture caching off, with the launch
   counts, the kernel against the plain version at 4K, times and peak
   memory;
5. the default path, picture caching on: the first frame's three passes
   (the continuation through init_tiles, held against its plain
   version), an unchanged frame, 8 scroll frames (bench.py's dirty())
   held against uncached renders, 8 dynamic uncached frames whose
   incremental dense records are held against a full gather, and their
   times;
6. the filter-effects path: the small effects frame against the JAX
   renderer's image (testdata/goldens.npz) with caching off and on; the
   4K effects frame (scenes.build_4k_effects_scene) uncached, with its
   pass counts, every kernel dispatch held against its plain version and
   the launches holding the picture kinds 6 and 15; the same frame with
   picture caching on, held against the uncached image, then unchanged;
   the root pass's kernel, plain and bound times, render_device time,
   frame build time and peak memory;
7. the content-page path: the small content frame against the plain
   version's image on the CPU and against the JAX renderer's image (equal
   but for the LUMINOSITY group's exact-half ties, which XLA's CPU build
   rounds the other way), caching off and on; the 4K content frame
   (scenes.build_4k_content_scene) uncached, with its instances, passes,
   dense kinds, blends and mask-clip dispatches, every kernel dispatch
   held against its plain version; the same frame with picture caching
   on, held against the uncached image, then unchanged; the root pass's
   kernel, plain and bound times, registers per instantiation,
   render_device uncached and cached, frame build time and peak memory;
8. the zoomed page with video: the small zoomed frames (zoom 1.25, 2.0
   and 0.8) against the plain version's image on the CPU and against the
   JAX renderer's images (equal but for exact-half ties of the video's
   color-space matrix), caching off and on; the 4K zoomed frame
   (scenes.build_4k_zoomed_scene) at the three zooms uncached, with its
   instances, passes, dense kinds and blends, every kernel dispatch held
   against its plain version; at zoom 1.25 the same frame with picture
   caching on, held against the uncached image, then unchanged, then a
   video tick (the launches, the dirty tiles, cached against uncached);
   the root pass's kernel, plain and bound times, registers per
   instantiation, render_device uncached, cached unchanged and per video
   tick, the host time of a tick and peak memory;
9. the transformed page: the small transformed frame against the plain
   version's image on the CPU and against the JAX package's numpy oracle
   (testdata/goldens.npz), caching off and on; the 4K transformed page
   (scenes.build_4k_transformed_scene) uncached, with its instances,
   passes, dense kinds, blends, the reasons its instances have no path in
   the TPU kernel and its general tiles (the tiles the JAX renderer hands
   to its XLA engine), every kernel dispatch held against its plain
   version; the same page with picture caching on, every dispatch held
   again and the image against the uncached one, then unchanged, then a
   scroll step and a video tick against uncached renders of the same
   states; the root pass's kernel, plain and bound times, registers per
   instantiation, render_device uncached and cached, frame build time
   and peak memory;
10. the SVG-filter page: the small SVG-filter frame against the plain
   version's image on the CPU and the JAX package's numpy oracle
   (testdata/goldens.npz), caching off and on, one step apart at most
   (its linearRGB groups round through exp and log); the 4K SVG-filter
   page (scenes.build_4k_svg_scene) uncached, with its passes, blend ops,
   color-matrix flags and arithmetic k values, every kernel dispatch held
   against its plain version; the heaviest filter dispatch over seeded
   tiles against the plain version, then its kernel, plain and bound
   times; the host time of each pass kind (the channel-LUT, sRGB and
   arithmetic passes among them); the same page with picture caching on,
   every dispatch held again and the image against the uncached one,
   then unchanged; render_device uncached and cached, frame build time and
   peak memory;
11. the CSS-3D page: the small CSS-3D frame against the plain version's
   image on the CPU and the JAX package's numpy oracle
   (testdata/goldens.npz), caching off and on; the 4K CSS-3D page
   (scenes.build_4k_3d_scene: perspective, preserve-3d plane splitting,
   backface culling, plane surfaces) uncached, with its instances,
   passes, polygon clips (clip kind 3) on records of general tiles and of
   the others, culled faces and general tiles, every kernel dispatch held
   against its plain version; the same page with picture caching on,
   every dispatch held again and the image against the uncached one, then
   unchanged; a flip animation of six frames (the first card from 60 to
   120 degrees, across the angle where its front face is culled and its
   back face drawn) and a scroll step of the feed, each against an uncached
   render of the same state that gathers every record from scratch; the
   root pass's kernel, plain and bound times, registers per
   instantiation, render_device uncached and cached, the host time of
   each pass kind, the host time of a flip frame (display list, frame
   build, render_device), frame build time and peak memory;
12. the GL-flavoured reftest path (the wrench harness, its reader, the
   renderer's dispatches on the kernel's gl instantiation, the numpy
   oracle): each small document of webrender_tpu_torch/testdata/wrench
   through ReftestHarness(device="cuda") on its manifest, every dispatch
   held against the plain version, the image against the JAX package's
   (testdata/goldens.npz), each case in the harness's cross mode against
   the oracle (its float64 `where`s held in float32) and its own run; the
   text document, which needs a font stack, read or refused by name; the
   3840x2160 GL page uncached with its instances, passes, blend ops,
   mask-clip dispatches and general tiles, every dispatch held, the image
   against the oracle as the cross mode holds it (and against the oracle
   as it is, at a stated count), then with picture caching on and
   unchanged; bench's 4K browsing page and the 4K content page built with
   gl_flavor, every dispatch held; the gl root passes' kernel time beside
   the same records on their swgl builds, plain and bound times,
   registers of the seven instantiations, render_device uncached and
   cached, the host time of each pass kind, frame build time and peak
   memory;
13. the multi-device path (webrender_tpu_torch/parallel/mesh.py): a mesh
   of every card of the machine, one spawned rank each over NCCL (on a
   one-card machine a world of one: the sharded routes, the sharded blur
   and the gather run, but nothing crosses between cards); bench's 4K
   browsing page and the 4K effects page rendered over the mesh and
   unsharded, uncached, then with picture caching on, a scroll step and
   an unchanged frame, every dispatch of the mesh renderer held against
   the unsharded kernel and the plain version on the same records and
   each image against the unsharded render; the sharded launches by
   instantiation, the sharded blurs and halo exchanges; the browsing root
   pass sharded, its rank's kernel, the gather and the unsharded kernel
   in the same call, the plain version and the bound of the rank's part;
   render_device over the mesh and unsharded, the blur passes' host time
   and peak memory.

The kernels line lists each of the kernel's seven instantiations with
its launches on the main paths, and the sharded dispatch (K9) with its
world size.  The line before the last is
nvidia-smi's name and power limit; the last line is {"ok": true,
"device": {...}}.  Any failure exits non-zero with
no such line, as does a machine without CUDA.
"""
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# the main path's frame at 4K (bench.py defaults): instances, merged pass
EXPECT_INSTANCES = 4096
EXPECT_PASS = (1020, 128)
EXPECT_KINDS = (0, 2, 10, 13)
EXPECT_BLENDS = (0, 7, 8)
# the 4K effects frame's passes with picture caching on, by kind and target
EFFECTS_PASSES = {"blur_h surface": 14, "blur_v surface": 14,
                  "color_matrix surface": 1, "downscale surface": 15,
                  "raster root": 3, "raster surface": 16}
# the 4K content frame's passes with picture caching on, by kind and target
CONTENT_PASSES = {"raster root": 3, "raster surface": 4}
CONTENT_KINDS = {3, 4, 8, 11}  # radial, conic, box shadow, line decoration
CONTENT_BLENDS = {17, 18, 26, 31}  # multiply, screen, difference, luminosity
# values of the small content frame that may differ from the JAX image by
# one step, inside the LUMINOSITY group (tests/test_torch_content_frame.py)
LUMINOSITY_TIES = 12
# the 4K zoomed frame's passes, by kind and target (under the page zoom's
# reference frame the scroll feed makes no picture-cache slice)
ZOOMED_PASSES = {"raster root": 1, "raster surface": 5}
ZOOMED_KINDS = {7, 16, 17}  # clear rects, scaled subpixel text, video
ZOOMED_BLENDS = {0, 1, 7, 8}
# values of a small zoomed frame that may differ from the JAX image by one
# step, inside the video (tests/test_torch_zoom_frame.py)
VIDEO_TIES = 8
TIMED_FRAMES = 20
# the kernel's template flags (kSurfaceKinds, kContent, kMedia, kGeneral,
# kFilter, kGl), as ptxas names them
INSTANTIATIONS = {("0", "0", "0", "0", "0", "0"): "browsing",
                  ("1", "0", "0", "0", "0", "0"): "surface",
                  ("1", "1", "0", "0", "0", "0"): "content",
                  ("1", "1", "1", "0", "0", "0"): "media",
                  ("1", "1", "1", "1", "0", "0"): "general",
                  ("1", "1", "1", "1", "1", "0"): "filter",
                  ("1", "1", "1", "1", "1", "1"): "gl"}
# the reasons an instance of the transformed page has no path in the TPU
# kernel (scenes.general_reasons)
# the 4K SVG-filter page's passes by kind and target, and the float-domain
# blend ops its surface passes hold
SVG_PASSES = {"raster surface": 233, "channel_lut surface": 4,
              "srgb surface": 34, "downscale surface": 2,
              "blur_v surface": 20, "blur_h surface": 20,
              "arith surface": 7, "raster root": 3}
SVG_BLENDS = tuple(range(2, 7)) + tuple(range(41, 56)) + (64, 66, 68) + \
    tuple(range(105, 120))
# the 4K CSS-3D page (scenes.css3d_counts over its root passes, picture
# caching on) and the faces its frame build culls
CSS3D_COUNTS = {"instances": 4086, "rows": 4096, "passes": 13,
                "polygon_records": 93, "polygon_records_general": 58,
                "general_tiles": 266, "tiles": 3060}
CSS3D_CULLED = 11
# the 3840x2160 GL reftest page (testdata/wrench/gl-page-4k.json): its
# instances and passes by kind and target, uncached; the pixels where its
# image differs by one step from the oracle as it is (float64 `where`s on
# exact halves: 16, between the two oracles on the CPU and against the
# device image on the card)
GL_PAGE_INSTANCES = 495
GL_PAGE_PASSES = {"blur_h surface": 4, "blur_v surface": 4,
                  "downscale surface": 2, "raster root": 1,
                  "raster surface": 8}
GL_PAGE_ORACLE_PIXELS = 16
TRANSFORMED_REASONS = {
    "rotated_image", "rotated_subpx_glyph", "rotated_glyph",
    "rotated_picture", "thumbnail", "wide_repeat", "linear_stops",
    "conic_stops", "radial_stops", "rotated_mask_clip",
    "rotated_nine_patch_clip", "wide_mask_clip", "minified_video"}


class SmokeFailure(RuntimeError):
    pass


def _check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _events_ms(fn, n, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _rgba8(tiles, nx, ny, w, h):
    """Tiles → RGBA8 as Renderer.render converts them."""
    import numpy as np
    from webrender_tpu_torch.renderer.renderer import assemble_tiles
    img = assemble_tiles(tiles, nx, ny, w, h).cpu().numpy()
    v = np.transpose(img, (1, 2, 0)).astype(np.float64) * 255.0
    return np.clip(np.floor(np.nan_to_num(v) + 0.5), 0, 255).astype(np.uint8)


def _args(inp):
    return (inp["dense"], inp["counts"], inp["origins"], inp["clear"],
            inp["f32_rows"], inp["alpha_atlas"], inp["surface_atlas"],
            inp["color_atlas"])


def phase1_toolchain():
    import torch
    smi = _smi()
    print(f"[1] card: {smi}")
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    from webrender_tpu_torch.ops import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"triton {triton_v} nvcc {nvcc.strip().splitlines()[-1]}")
    from webrender_tpu_torch import scenes
    fonts = scenes.font_stack_available()
    print(f"[1] font stack (matplotlib ft2font + libfreetype): "
          f"{'loads' if fonts else 'missing'}")
    if not fonts:
        print("[1] text glyphs come from webrender_tpu_torch/testdata/"
              "glyphs.npz (DejaVu Sans answers recorded with the font "
              "stack); no font is read from outside the repository")
    return smi


def phase2_build():
    from webrender_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    # ptxas's registers and spill bytes (stores and loads) per
    # instantiation
    regs, spills = {}, {}
    for m in re.findall(
            r"Compiling entry function '[^']*tile_raster_kernelILb([01])E"
            r"Lb([01])ELb([01])ELb([01])ELb([01])ELb([01])E.*?"
            r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
            r"Used (\d+) registers", _build.build_log, re.S):
        variant = INSTANTIATIONS[m[:6]]
        regs[variant] = int(m[8])
        spills[variant] = int(m[6]) + int(m[7])
    print(f"[2] kernel built in {build_s:.3f} s ({_build.library_path().name})"
          + "".join(f"; {v} instantiation: {n} registers, "
                    f"{spills[v]} spill bytes" for v, n in regs.items()))
    _check(set(regs) == set(INSTANTIATIONS.values()),
           f"ptxas reported the instantiations {sorted(regs)}")
    _check(not any(spills.values()), f"a build spills registers: {spills}")
    return regs, spills


def phase3_small_frames():
    import numpy as np
    import torch
    from webrender_tpu_torch import scenes
    from webrender_tpu_torch.ops.tile_raster import (
        render_tiles_dense, render_tiles_dense_plain)
    from webrender_tpu_torch.render_backend import RenderBackend
    goldens = np.load(scenes.GOLDENS)
    for name, (make, size) in scenes.SMALL_FRAMES.items():
        backend = make(RenderBackend(size, device="cuda",
                                     resources=scenes.resource_cache()))
        inp = scenes.kernel_inputs(backend)
        out = render_tiles_dense(*_args(inp), kinds=inp["kinds"],
                                 blends=inp["blends"])
        ref = render_tiles_dense_plain(*_args(inp), kinds=inp["kinds"],
                                       blends=inp["blends"])
        torch.cuda.synchronize()
        d_f32 = float((out - ref).abs().max())
        w, h = size
        a = _rgba8(out, inp["nx"], inp["ny"], w, h)
        b = _rgba8(ref, inp["nx"], inp["ny"], w, h)
        d_u8 = int(np.abs(a.astype(int) - b.astype(int)).max())
        img = backend.render()
        d_jax = int(np.abs(img.astype(int) - goldens[name].astype(int)).max())
        print(f"[3] {name}: kinds {inp['kinds']} blends {inp['blends']} "
              f"kernel-vs-plain max diff f32 {d_f32} rgba8 {d_u8}; "
              f"render() vs JAX rgba8 {d_jax} (tolerance 0)")
        _check(bool(torch.isfinite(out).all()), f"{name}: non-finite tiles")
        _check(d_f32 == 0.0 and d_u8 == 0 and d_jax == 0,
               f"{name}: the kernel disagrees")


def phase4_main_path(smi):
    import numpy as np
    import torch
    from webrender_tpu_torch import scenes
    from webrender_tpu_torch.ops.tile_raster import (
        LaunchCounts, _launch, render_tiles_dense, render_tiles_dense_plain)
    from webrender_tpu_torch.render_backend import RenderBackend
    from webrender_tpu_torch.renderer.renderer import merged_root_passes

    t0 = time.perf_counter()
    backend = scenes.build_4k_scene(RenderBackend(
        (3840, 2160), device="cuda", resources=scenes.resource_cache()))
    r = backend.renderer
    r.picture_caching = False  # this phase is the uncached path
    scene_ms = (time.perf_counter() - t0) * 1000.0
    t0 = time.perf_counter()
    frame = backend.build_frame()
    frame_build_ms = (time.perf_counter() - t0) * 1000.0
    (p,) = merged_root_passes(frame)
    n_inst = frame.instances.shape[0]
    print(f"[4] 4K frame: {n_inst} instances, {len(frame.passes)} root "
          f"passes merged into one of {tuple(p.tile_insts.shape)}; scene "
          f"build {scene_ms:.1f} ms, frame build {frame_build_ms:.1f} ms")
    _check(n_inst == EXPECT_INSTANCES, f"{n_inst} instances")
    _check(tuple(p.tile_insts.shape) == EXPECT_PASS,
           f"merged pass {p.tile_insts.shape}")

    # the main path, counted: RenderBackend.render() per frame
    frames = 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r.dispatch_log = log = []
    LaunchCounts.reset()
    for _ in range(frames):
        img = backend.render()
    torch.cuda.synchronize()
    launches, plain_calls = LaunchCounts.launches, LaunchCounts.plain_calls
    by_variant = dict(LaunchCounts.by_instantiation)
    r.dispatch_log = None
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    inp = {k: log[-1][k] for k in ("kinds", "blends", "mask_clips",
                                   "alpha_atlas", "surface_atlas",
                                   "color_atlas")}
    inp.update(dense=log[-1]["dense"], counts=log[-1]["tile_counts"],
               origins=log[-1]["tile_origins"], clear=log[-1]["clear_color"],
               f32_rows=log[-1]["f32_rows"])
    print(f"[4] main path: {frames} frames, kernel launches {launches}, "
          f"plain-version calls {plain_calls}; dense kinds {inp['kinds']} "
          f"blends {inp['blends']}; image {img.shape} {img.dtype}")
    _check(launches == frames and plain_calls == 0,
           "the main path did not run the kernel once per frame")
    _check(inp["kinds"] == EXPECT_KINDS and inp["blends"] == EXPECT_BLENDS,
           "unexpected dense kinds or blends")

    # the kernel against its plain version at the main path's shapes
    kw = dict(kinds=inp["kinds"], blends=inp["blends"],
              mask_clips=inp["mask_clips"])
    out = render_tiles_dense(*_args(inp), **kw)
    ref = render_tiles_dense_plain(*_args(inp), **kw)
    torch.cuda.synchronize()
    _check(bool(torch.isfinite(out).all()), "4K: non-finite tiles")
    max_abs_err = float((out - ref).abs().max())
    plain_img = _rgba8(ref, p.nx, p.ny, p.region[2], p.region[3])
    d_u8 = int(np.abs(img.astype(int) - plain_img.astype(int)).max())
    print(f"[4] 4K kernel vs plain: max diff f32 {max_abs_err}, "
          f"render() rgba8 vs plain {d_u8} (tolerance 0)")
    _check(max_abs_err == 0.0 and d_u8 == 0, "4K: the kernel disagrees")
    _check(img.shape == (2160, 3840, 4) and bool(img.any()),
           f"4K: image {img.shape} is wrong or empty")

    # the kernel launch alone (the wrapper's host-side checks excluded)
    launch_args = _args(inp)
    kernel_ms = _events_ms(lambda: _launch(*launch_args, **kw), TIMED_FRAMES)
    plain_ms = _events_ms(lambda: render_tiles_dense_plain(*_args(inp), **kw),
                          TIMED_FRAMES, warmup=1)
    device_ms = _events_ms(lambda: r.render_device(frame), TIMED_FRAMES)
    t0 = time.perf_counter()
    for _ in range(5):
        backend.render()
    render_ms = (time.perf_counter() - t0) * 1000.0 / 5
    bound = _bound(inp)
    print(f"[4] times over {TIMED_FRAMES} frames after warm-up: kernel "
          f"{kernel_ms:.3f} ms, plain version {plain_ms:.3f} ms, "
          f"render_device {device_ms:.3f} ms, render() with readback "
          f"{render_ms:.3f} ms; peak memory {peak_mib:.0f} MiB; "
          f"card {smi}")
    print(f"[4] bound of the merged pass: {bound['bound_ms']:.4f} ms, set by "
          f"{bound['bound_by']} ({bound['ops']:.4g} FP32 operations, "
          f"{bound['bytes']:.4g} bytes; H100 SXM peaks at 700 W); kernel at "
          f"{bound['bound_ms'] / kernel_ms:.3f} of it")
    return img, dict(launches=launches, by_variant=by_variant,
                     err=max_abs_err, ms=kernel_ms, plain_ms=plain_ms,
                     bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])


def _bound(inp, init=None, mask_clips=True, gl=False):
    """The dispatch's least time on the card (ops/roofline.py)."""
    from webrender_tpu_torch.ops.roofline import tile_raster_bound
    ms, by, ops, nbytes = tile_raster_bound(inp["dense"], inp["counts"],
                                            inp["origins"], inp["f32_rows"],
                                            init, mask_clips=mask_clips,
                                            gl=gl)
    return dict(bound_ms=ms, bound_by=by, ops=ops, bytes=nbytes)


def _scroll_to(backend, tick):
    """bench.py's dirty(): the feed (scroll id 777) at 7 px per tick."""
    from webrender_tpu_torch.api import Point2D
    backend.scroll_offsets[777] = [(Point2D(0.0, 7.0 * tick), 0)]


def _diff_u8(a, b):
    import numpy as np
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _host_ms(fn, n):
    """Mean host time of fn() over n calls, synchronised at the end."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0 / n


def phase5_default_path(smi, uncached_img):
    """The renderer's default path: picture caching on, the slice pass,
    the continuation pass through init_tiles, dynamic frames on the
    persistent mirrors."""
    import statistics

    import torch
    from webrender_tpu_torch import scenes
    from webrender_tpu_torch.ops import dense as dm
    from webrender_tpu_torch.ops.tile_raster import (
        LaunchCounts, _launch, render_tiles_dense, render_tiles_dense_plain)
    from webrender_tpu_torch.render_backend import RenderBackend
    from webrender_tpu_torch.renderer import Renderer

    backend = scenes.build_4k_scene(RenderBackend(
        (3840, 2160), device="cuda", resources=scenes.resource_cache()))
    r = backend.renderer
    _check(r.picture_caching, "picture caching is not the default")
    frame = backend.build_frame()
    shape = [(q.clear is None, q.slice_key is not None)
             for q in frame.passes]
    _check(shape == [(False, False), (True, True), (True, False)],
           f"4K passes {shape}")

    # the main path, counted: the first frame through render()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r.dispatch_log = log = []
    LaunchCounts.reset()
    img = backend.render()
    torch.cuda.synchronize()
    launches, plain_calls = LaunchCounts.launches, LaunchCounts.plain_calls
    by_variant = dict(LaunchCounts.by_instantiation)
    r.dispatch_log = None
    init_launches = sum(e["init_tiles"] is not None for e in log)
    d_first = _diff_u8(img, uncached_img)
    print(f"[5] first frame: {len(frame.passes)} root passes, kernel "
          f"launches {launches} ({init_launches} with init_tiles), "
          f"plain-version calls {plain_calls}; dispatched tiles "
          f"{[tuple(e['dense'].shape[:2]) for e in log]}; slices "
          f"{r.slice_debug}; rgba8 vs the uncached image {d_first} "
          f"(tolerance 0)")
    _check(launches == 3 and plain_calls == 0 and init_launches == 1,
           "the first cached frame did not run three kernel launches")
    _check(d_first == 0, "the cached image differs from the uncached one")

    # the continuation pass: kernel with init_tiles against the plain one
    cont = {k: v for k, v in log[2].items() if k != "tile_insts"}
    plain_kw = {k: v for k, v in cont.items()
                if k not in ("general", "linear_cm", "polygon_clips")}
    out = render_tiles_dense(**cont)
    t0 = time.perf_counter()
    ref = render_tiles_dense_plain(**plain_kw)
    torch.cuda.synchronize()
    init_plain_ms = (time.perf_counter() - t0) * 1000.0
    init_err = float((out - ref).abs().max())
    nt = cont["dense"].shape[0]
    nx = -(-3840 // 128)
    d_u8 = _diff_u8(_rgba8(out, nx, nt // nx, 3840, 2160),
                    _rgba8(ref, nx, nt // nx, 3840, 2160))
    _check(bool(torch.isfinite(out).all()), "init_tiles: non-finite tiles")
    launch_args = (cont["dense"], cont["tile_counts"], cont["tile_origins"],
                   cont["clear_color"], cont["f32_rows"], cont["alpha_atlas"],
                   cont["surface_atlas"], cont["color_atlas"],
                   cont["init_tiles"])
    init_ms = _events_ms(lambda: _launch(
        *launch_args, kinds=cont["kinds"], blends=cont["blends"],
        mask_clips=cont["mask_clips"]), TIMED_FRAMES)
    init_bound = _bound(dict(dense=cont["dense"], counts=cont["tile_counts"],
                             origins=cont["tile_origins"],
                             f32_rows=cont["f32_rows"]), cont["init_tiles"])
    print(f"[5] continuation pass {tuple(cont['dense'].shape[:2])}: kernel "
          f"with init_tiles vs plain max diff f32 {init_err} rgba8 {d_u8} "
          f"(tolerance 0); kernel {init_ms:.3f} ms (CUDA events, "
          f"{TIMED_FRAMES} launches), plain version {init_plain_ms:.1f} ms "
          f"(one run); bound {init_bound['bound_ms']:.4f} ms set by "
          f"{init_bound['bound_by']} ({init_bound['ops']:.4g} operations, "
          f"{init_bound['bytes']:.4g} bytes); card {smi}")
    _check(init_err == 0.0 and d_u8 == 0, "init_tiles: the kernel disagrees")
    del out, ref

    # the unchanged frame: the retained framebuffer, no launch
    LaunchCounts.reset()
    again = backend.render()
    print(f"[5] unchanged frame: launches {LaunchCounts.launches}, dirty "
          f"tiles {r.last_dirty_tiles}, rgba8 diff {_diff_u8(again, img)}")
    _check(LaunchCounts.launches == 0 and r.last_dirty_tiles == 0 and
           _diff_u8(again, img) == 0, "the unchanged frame did work")

    # an uncached renderer on the same atlases renders each frame again
    plain_r = Renderer("cuda")
    plain_r.picture_caching = False
    for name in ("color_atlas", "alpha_atlas", "surface_atlas"):
        setattr(plain_r, name, getattr(r, name))

    # scroll: bench.py's dirty() with picture caching on
    tick = 0
    scroll = []
    for _ in range(8):
        tick += 1
        _scroll_to(backend, tick)
        f = backend.build_frame()
        LaunchCounts.reset()
        got = backend.render()
        n = LaunchCounts.launches
        slice_dirty = [d["dirty"] for d in r.slice_debug]
        d = _diff_u8(got, plain_r.render(f))
        scroll.append((n, slice_dirty, d))
        _check(slice_dirty == [0], f"scroll re-rastered slice tiles "
               f"{slice_dirty}")
        _check(d == 0, f"scroll frame {tick} differs from uncached")
    print(f"[5] scroll, 8 frames of 7 px (launches, slice dirty tiles, "
          f"rgba8 diff vs uncached): {scroll}")

    # the dynamic uncached loop (bench's end-to-end shape) on the mirrors
    rows = []
    for _ in range(8):
        tick += 1
        _scroll_to(backend, tick)
        f = backend.build_frame()
        plain_r.dispatch_log = plog = []
        plain_r.render_device(f)
        plain_r.dispatch_log = None
        (e,) = plog
        host = [torch.from_numpy(a).cuda() for a in
                (f.f32_buf, f.instances, f.transforms, e["tile_insts"],
                 f._torch_dense_kinds)]
        full = dm.build_dense_records(*host)
        err = float((full - e["dense"]).abs().max())
        _check(err == 0.0, "the incremental dense mirror differs")
        store = plain_r._delta
        up = {str(k): len(store.last_changed(k)) for k in store._entries
              if store.last_changed(k) is not None}
        rows.append((plain_r.regathered_tiles[0], err, up))
    print(f"[5] dynamic uncached loop, 8 frames (tiles re-gathered of "
          f"{EXPECT_PASS[0]}, incremental vs full dense max diff, rows "
          f"uploaded per mirror): {rows}")
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    # times
    r.render_device(frame)  # the first frame again, then unchanged
    cached_ms = _host_ms(lambda: r.render_device(frame), TIMED_FRAMES)

    def timed_loop(b, ren):
        nonlocal tick
        build, dev = [], []
        for _ in range(8):
            tick += 1
            _scroll_to(b, tick)
            t0 = time.perf_counter()
            f = b.build_frame()
            t1 = time.perf_counter()
            ren.render_device(f)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            build.append((t1 - t0) * 1000.0)
            dev.append((t2 - t1) * 1000.0)
        return statistics.median(build), statistics.median(dev)

    scroll_build, scroll_dev = timed_loop(backend, r)
    # the uncached renderer draws the frames the cached backend builds
    dyn_build, dyn_dev = timed_loop(backend, plain_r)
    print(f"[5] cached unchanged frame: render_device {cached_ms:.3f} ms "
          f"(mean of {TIMED_FRAMES}, host clock with sync); card {smi}")
    print(f"[5] scroll with caching on, per frame: frame build "
          f"{scroll_build:.3f} ms, render_device {scroll_dev:.3f} ms "
          f"(medians of 8, host clock with sync); card {smi}")
    print(f"[5] dynamic uncached frame: frame build {dyn_build:.3f} ms, "
          f"upload, dense records and raster {dyn_dev:.3f} ms (medians of "
          f"8, host clock with sync); card {smi}")
    print(f"[5] peak memory {peak_mib:.0f} MiB; card {smi}")
    return dict(launches=launches, by_variant=by_variant,
                init_launches=init_launches,
                init_err=init_err, init_ms=init_ms,
                init_plain_ms=init_plain_ms,
                init_bound_ms=init_bound["bound_ms"],
                init_bound_by=init_bound["bound_by"])


def _pass_counts(passes):
    from collections import Counter

    from webrender_tpu_torch.frame.frame_builder import TARGET_ROOT
    from webrender_tpu_torch.renderer.renderer import PASS_NAMES
    c = Counter((PASS_NAMES[q.kind],
                 "root" if q.target == TARGET_ROOT else "surface")
                for q in passes)
    return {f"{k} {t}": n for (k, t), n in sorted(c.items())}


def _picture_launches(log):
    """Kernel launches whose dispatch holds each picture kind."""
    return {str(k): sum(k in e["kinds"] for e in log) for k in (6, 15)}


def _holding(dispatch, log, held):
    """The renderer's `dispatch`, each launch's output held against the
    plain version right after it, on the inputs it read (later passes
    rewrite the surface atlas and the mirrors in place): (max abs diff,
    kernel output, plain output, instantiation) per launch into `held`.
    `log` is the renderer's dispatch log, which holds each launch's
    arguments."""
    import torch
    from webrender_tpu_torch.ops.tile_raster import (instantiation,
                                                     render_tiles_dense_plain)

    def run(*args, **kw):
        out = dispatch(*args, **kw)
        e = log[-1]
        plain = {k: v for k, v in e.items()
                 if k not in ("tile_insts", "general", "linear_cm",
                              "polygon_clips")}
        ref = render_tiles_dense_plain(**plain)
        torch.cuda.synchronize()
        _check(bool(torch.isfinite(out).all()), "non-finite tiles")
        held.append((float((out - ref).abs().max()), out, ref,
                     instantiation(e["kinds"], e["blends"], e["mask_clips"],
                                   e["general"], e["step"], e["linear_cm"],
                                   e["polygon_clips"], e["gl"])))
        return out
    return run


def _errors_by_variant(held):
    """{instantiation: max abs diff} of held dispatches."""
    errs = {}
    for err, _, _, variant in held:
        errs[variant] = max(errs.get(variant, 0.0), err)
    return errs


def _pass_times(r, frame):
    """{pass name: (ms, count)} of one uncached render_device of `frame`,
    each pass timed on the host clock between synchronisations."""
    import torch
    from webrender_tpu_torch.frame.frame_builder import TARGET_ROOT
    from webrender_tpu_torch.renderer.renderer import PASS_NAMES
    times = {}

    def timed(fn, name_of):
        def run(p, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(p, *args)
            torch.cuda.synchronize()
            ms, n = times.get(name_of(p), (0.0, 0))
            times[name_of(p)] = (ms + (time.perf_counter() - t0) * 1e3, n + 1)
            return out
        return run
    r._run_raster = timed(r._run_raster, lambda p: "raster " + (
        "root" if p.target == TARGET_ROOT else "surface"))
    r._run_offscreen = timed(r._run_offscreen, lambda p: PASS_NAMES[p.kind])
    try:
        r.render_device(frame)
    finally:
        del r._run_raster, r._run_offscreen
    return times


def _device_busy(fn):
    """(device busy ms, wall ms, top 5 kernels by device time) of one
    call of fn under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.key,
             e.count) for e in prof.key_averages()]
    busy = sum(ms for ms, _, _ in rows)
    top = [f"{k[:40]} {ms:.3f} ms x{n}" for ms, k, n in
           sorted(rows, reverse=True)[:5] if ms > 0]
    return busy, wall_ms, top


def phase6_effects_path(smi):
    """The 4K filter-effects path: surface raster passes, downscale, blur,
    color matrix, and the root pass's picture composites (kinds 6, 15)."""
    import numpy as np
    import torch
    from webrender_tpu_torch import scenes
    from webrender_tpu_torch.frame.frame_builder import TARGET_ROOT
    from webrender_tpu_torch.ops.tile_raster import (
        LaunchCounts, _launch, render_tiles_dense_plain)
    from webrender_tpu_torch.render_backend import RenderBackend
    from webrender_tpu_torch.renderer.renderer import merged_root_passes

    # the small effects frame against the JAX renderer's image
    goldens = np.load(scenes.GOLDENS)
    name, make, size = scenes.EFFECTS_FRAME
    for caching in (False, True):
        small = make(RenderBackend(size, device="cuda",
                                   resources=scenes.resource_cache()))
        small.renderer.picture_caching = caching
        d = _diff_u8(small.render(), goldens[name])
        print(f"[6] small effects frame {size}, picture caching "
              f"{'on' if caching else 'off'}: rgba8 vs JAX {d} (tolerance 0)")
        _check(d == 0, "the small effects frame differs from JAX")

    # the 4K effects frame, uncached
    backend = scenes.build_4k_effects_scene(RenderBackend(
        (3840, 2160), device="cuda", resources=scenes.resource_cache()))
    r = backend.renderer
    r.picture_caching = False
    t0 = time.perf_counter()
    frame = backend.build_frame()
    build_ms = (time.perf_counter() - t0) * 1000.0
    counts = _pass_counts(frame.passes)
    merged = _pass_counts(merged_root_passes(frame))
    print(f"[6] 4K effects frame: {frame.instances.shape[0]} instances, "
          f"{len(frame.passes)} passes {counts}; uncached (root passes "
          f"merged) {merged}; surface rows {frame.surface_rows}; frame "
          f"build {build_ms:.1f} ms")
    _check(counts == EFFECTS_PASSES, f"4K effects passes {counts}")
    n_raster = merged["raster root"] + merged["raster surface"]

    # the main path, counted; every dispatch held against the plain version
    r.dispatch_log = log = []
    held = []
    r._dispatch = _holding(r._dispatch, log, held)
    LaunchCounts.reset()
    try:
        img = backend.render()
    finally:
        del r._dispatch
    torch.cuda.synchronize()
    launches, plain_calls = LaunchCounts.launches, LaunchCounts.plain_calls
    by_variant = dict(LaunchCounts.by_instantiation)
    r.dispatch_log = None
    pictures = _picture_launches(log)
    print(f"[6] main path, uncached: kernel launches {launches}, plain-"
          f"version calls {plain_calls}; launches holding kind 6 / 15: "
          f"{pictures}; image {img.shape} {img.dtype}")
    _check(launches == n_raster and plain_calls == 0,
           "the effects path did not run the kernel once per raster pass")
    _check(pictures["6"] >= 1 and pictures["15"] >= 1,
           "no picture composite went through the kernel")
    _check(img.shape == (2160, 3840, 4) and bool(img.any()),
           "4K effects: the image is wrong or empty")

    # the root pass is the last dispatch
    surface_err = max(err for err, _, _, _ in held[:-1])
    errs = _errors_by_variant(held)
    root = log[-1]
    root_err, out, ref, _ = held[-1]
    (p,) = [q for q in merged_root_passes(frame) if q.target == TARGET_ROOT]
    d_u8 = _diff_u8(img, _rgba8(ref, p.nx, p.ny, 3840, 2160))
    print(f"[6] kernel vs plain: surface passes max diff f32 {surface_err}; "
          f"root pass {tuple(root['dense'].shape[:2])} kinds "
          f"{root['kinds']} max diff f32 {root_err}, render() rgba8 vs plain "
          f"{d_u8} (tolerance 0)")
    _check(6 in root["kinds"] and 15 in root["kinds"],
           f"root pass kinds {root['kinds']}")
    _check(surface_err == 0.0 and root_err == 0.0 and d_u8 == 0,
           "4K effects: the kernel disagrees")
    del out, ref, held
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.render()
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    # times on the card
    launch_args = (root["dense"], root["tile_counts"], root["tile_origins"],
                   root["clear_color"], root["f32_rows"], root["alpha_atlas"],
                   root["surface_atlas"], root["color_atlas"])
    plain_kw = dict(kinds=root["kinds"], blends=root["blends"],
                    mask_clips=root["mask_clips"])
    root_ms = _events_ms(lambda: _launch(*launch_args, **plain_kw),
                         TIMED_FRAMES)
    root_plain_ms = _events_ms(
        lambda: render_tiles_dense_plain(*launch_args, **plain_kw), 3,
        warmup=1)
    bound = _bound(dict(dense=root["dense"], counts=root["tile_counts"],
                        origins=root["tile_origins"],
                        f32_rows=root["f32_rows"]))
    device_ms = _events_ms(lambda: r.render_device(frame), TIMED_FRAMES)
    print(f"[6] root pass: kernel {root_ms:.3f} ms (CUDA events, "
          f"{TIMED_FRAMES} launches), plain version {root_plain_ms:.1f} ms; "
          f"bound {bound['bound_ms']:.4f} ms set by {bound['bound_by']} "
          f"({bound['ops']:.4g} operations, {bound['bytes']:.4g} bytes); "
          f"card {smi}")
    print(f"[6] uncached frame: render_device {device_ms:.3f} ms (CUDA "
          f"events, mean of {TIMED_FRAMES}), frame build {build_ms:.1f} ms "
          f"(host), peak memory {peak_mib:.0f} MiB (one uncached frame after "
          f"the first); card {smi}")
    by_pass = _pass_times(r, frame)
    print("[6] where the uncached frame's time goes, by pass (host clock, "
          "synchronised around each pass, ms, count): " +
          ", ".join(f"{k} {v[0]:.3f} ({v[1]})" for k, v in
                    sorted(by_pass.items(), key=lambda kv: -kv[1][0])) +
          f"; card {smi}")
    busy_ms, wall_ms, top = _device_busy(lambda: r.render_device(frame))
    if busy_ms > 0:
        print(f"[6] torch.profiler over one uncached render_device: device "
              f"busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall (idle share "
              f"{1 - busy_ms / wall_ms:.3f}); top kernels by device time: "
              f"{top}; card {smi}")
    else:
        print("[6] torch.profiler recorded no device time: idle share not "
              "measured")

    # the default path: picture caching on, then the unchanged frame
    cached = scenes.build_4k_effects_scene(RenderBackend(
        (3840, 2160), device="cuda", resources=scenes.resource_cache()))
    rc = cached.renderer
    _check(rc.picture_caching, "picture caching is not the default")
    rc.dispatch_log = clog = []
    LaunchCounts.reset()
    cimg = cached.render()
    torch.cuda.synchronize()
    c_launches = LaunchCounts.launches
    c_by_variant = dict(LaunchCounts.by_instantiation)
    c_plain = LaunchCounts.plain_calls
    rc.dispatch_log = None
    c_pictures = _picture_launches(clog)
    d_cached = _diff_u8(cimg, img)
    LaunchCounts.reset()
    again = cached.render()
    print(f"[6] main path, picture caching on: kernel launches {c_launches}, "
          f"plain-version calls {c_plain}, launches holding kind 6 / 15 "
          f"{c_pictures}; rgba8 vs uncached {d_cached} (tolerance 0); "
          f"unchanged frame: launches {LaunchCounts.launches}, rgba8 diff "
          f"{_diff_u8(again, cimg)}")
    _check(c_plain == 0 and c_launches >= n_raster and
           c_pictures["6"] >= 1 and c_pictures["15"] >= 1,
           "the cached effects path did not run the kernel")
    _check(d_cached == 0, "the cached effects image differs from uncached")
    _check(LaunchCounts.launches == 0 and _diff_u8(again, cimg) == 0,
           "the unchanged effects frame did work")
    return dict(launches=launches, pictures=pictures,
                by_variant=_add_counts(by_variant, c_by_variant), errs=errs,
                cached_launches=c_launches, cached_pictures=c_pictures,
                err=max(surface_err, root_err), root_ms=root_ms,
                root_plain_ms=root_plain_ms,
                root_bound_ms=bound["bound_ms"],
                root_bound_by=bound["bound_by"])


def _add_counts(*counts):
    """The sum of launch counts by instantiation."""
    total = {}
    for c in counts:
        for k, n in c.items():
            total[k] = total.get(k, 0) + n
    return total


def _ties_in_rect(img, want, rect):
    """(max diff outside the device rect (x, y, w, h) of whole pixels, max
    diff inside it, values that differ)."""
    import numpy as np
    diff = np.abs(img.astype(int) - want.astype(int))
    x, y, w, h = rect
    inside = np.zeros(diff.shape[:2], bool)
    inside[y:y + h, x:x + w] = True
    return int(diff[~inside].max()), int(diff[inside].max()), \
        int((diff > 0).sum())


def _luminosity_ties(img, want):
    """`_ties_in_rect` of the small content frame's LUMINOSITY group."""
    from webrender_tpu_torch import scenes
    return _ties_in_rect(
        img, want, dict(scenes.CONTENT_SMALL["blends"])["LUMINOSITY"])


def phase7_content_path(smi, regs):
    """The 4K content page: blurred, inset and sharp box shadows, radial
    and conic gradients, line decorations, image-mask clips and mix-blend
    groups on the browsing page."""
    import numpy as np
    import torch
    from webrender_tpu_torch import scenes
    from webrender_tpu_torch.frame.frame_builder import TARGET_ROOT
    from webrender_tpu_torch.ops.tile_raster import (
        LaunchCounts, _launch, instantiation, render_tiles_dense_plain)
    from webrender_tpu_torch.render_backend import RenderBackend
    from webrender_tpu_torch.renderer.renderer import merged_root_passes

    # the small content frame against the plain version on the CPU and the
    # JAX renderer's image
    goldens = np.load(scenes.GOLDENS)
    name, make, size = scenes.CONTENT_FRAME
    cpu_img = make(RenderBackend(size, device="cpu",
                                 resources=scenes.resource_cache())).render()
    for caching in (False, True):
        small = make(RenderBackend(size, device="cuda",
                                   resources=scenes.resource_cache()))
        small.renderer.picture_caching = caching
        img = small.render()
        d_cpu = _diff_u8(img, cpu_img)
        outside, inside, n = _luminosity_ties(img, goldens[name])
        print(f"[7] small content frame {size}, picture caching "
              f"{'on' if caching else 'off'}: rgba8 vs the plain version on "
              f"the CPU {d_cpu} (tolerance 0); vs JAX {outside} outside the "
              f"LUMINOSITY group (tolerance 0), {inside} inside at {n} "
              f"values (XLA's contracted multiply-adds at exact-half ties; "
              f"tolerance 1 at {LUMINOSITY_TIES})")
        _check(d_cpu == 0 and outside == 0 and inside <= 1 and
               n <= LUMINOSITY_TIES, "the small content frame differs")

    # the 4K content frame, uncached
    backend = scenes.build_4k_content_scene(RenderBackend(
        (3840, 2160), device="cuda", resources=scenes.resource_cache()))
    r = backend.renderer
    r.picture_caching = False
    t0 = time.perf_counter()
    frame = backend.build_frame()
    build_ms = (time.perf_counter() - t0) * 1000.0
    counts = _pass_counts(frame.passes)
    merged = _pass_counts(merged_root_passes(frame))
    drawn = int((frame.instances != 0).any(1).sum())
    print(f"[7] 4K content frame: {drawn} instances ({frame.instances.shape[0]}"
          f" rows), {len(frame.passes)} passes {counts}; uncached (root "
          f"passes merged) {merged}; frame build {build_ms:.1f} ms")
    _check(counts == CONTENT_PASSES, f"4K content passes {counts}")
    n_raster = merged["raster root"] + merged["raster surface"]

    # the main path, counted; every dispatch held against the plain version
    r.dispatch_log = log = []
    held = []
    r._dispatch = _holding(r._dispatch, log, held)
    LaunchCounts.reset()
    try:
        img = backend.render()
    finally:
        del r._dispatch
    torch.cuda.synchronize()
    launches, plain_calls = LaunchCounts.launches, LaunchCounts.plain_calls
    by_variant = dict(LaunchCounts.by_instantiation)
    r.dispatch_log = None
    for e, (err, _, _, variant) in zip(log, held):
        print(f"[7] dispatch {tuple(e['dense'].shape[:2])}: kinds {e['kinds']}"
              f" blends {e['blends']} mask_clips {e['mask_clips']}; "
              f"{variant} instantiation; kernel vs plain max diff f32 {err}")
    print(f"[7] main path, uncached: kernel launches {launches} "
          f"{by_variant}, plain-version calls {plain_calls}; image "
          f"{img.shape} {img.dtype}")
    _check(launches == n_raster and plain_calls == 0,
           "the content path did not run the kernel once per raster pass")
    root = log[-1]
    root_err, out, ref, _ = held[-1]
    (p,) = [q for q in merged_root_passes(frame) if q.target == TARGET_ROOT]
    d_u8 = _diff_u8(img, _rgba8(ref, p.nx, p.ny, 3840, 2160))
    err = max(e for e, _, _, _ in held)
    errs = _errors_by_variant(held)
    print(f"[7] kernel vs plain: every dispatch max diff f32 {err}; root "
          f"render() rgba8 vs plain {d_u8} (tolerance 0)")
    _check(CONTENT_KINDS <= set(root["kinds"]) and
           CONTENT_BLENDS <= set(root["blends"]) and root["mask_clips"],
           f"root pass kinds {root['kinds']} blends {root['blends']}")
    _check(instantiation(root["kinds"], root["blends"], root["mask_clips"])
           == "content" and by_variant["content"] >= 1,
           "the content instantiation did not run")
    _check(err == 0.0 and d_u8 == 0, "4K content: the kernel disagrees")
    _check(img.shape == (2160, 3840, 4) and bool(img.any()),
           "4K content: the image is wrong or empty")
    del out, ref, held
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.render()
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    # times on the card
    launch_args = (root["dense"], root["tile_counts"], root["tile_origins"],
                   root["clear_color"], root["f32_rows"], root["alpha_atlas"],
                   root["surface_atlas"], root["color_atlas"])
    kw = dict(kinds=root["kinds"], blends=root["blends"],
              mask_clips=root["mask_clips"])
    root_ms = _events_ms(lambda: _launch(*launch_args, **kw), TIMED_FRAMES)
    root_plain_ms = _events_ms(
        lambda: render_tiles_dense_plain(*launch_args, **kw), 3, warmup=1)
    bound = _bound(dict(dense=root["dense"], counts=root["tile_counts"],
                        origins=root["tile_origins"],
                        f32_rows=root["f32_rows"]))
    device_ms = _events_ms(lambda: r.render_device(frame), TIMED_FRAMES)
    print(f"[7] root pass {tuple(root['dense'].shape[:2])}: kernel "
          f"{root_ms:.3f} ms (CUDA events, {TIMED_FRAMES} launches), plain "
          f"version {root_plain_ms:.1f} ms; bound {bound['bound_ms']:.4f} ms "
          f"set by {bound['bound_by']} ({bound['ops']:.4g} operations, "
          f"{bound['bytes']:.4g} bytes); registers {regs}; card {smi}")

    # the default path: picture caching on, then the unchanged frame
    cached = scenes.build_4k_content_scene(RenderBackend(
        (3840, 2160), device="cuda", resources=scenes.resource_cache()))
    rc = cached.renderer
    _check(rc.picture_caching, "picture caching is not the default")
    LaunchCounts.reset()
    cimg = cached.render()
    torch.cuda.synchronize()
    c_launches = LaunchCounts.launches
    c_by_variant = dict(LaunchCounts.by_instantiation)
    c_plain = LaunchCounts.plain_calls
    d_cached = _diff_u8(cimg, img)
    LaunchCounts.reset()
    again = cached.render()
    print(f"[7] main path, picture caching on: kernel launches {c_launches} "
          f"{c_by_variant}, plain-version calls {c_plain}; rgba8 vs uncached "
          f"{d_cached} (tolerance 0); unchanged frame: launches "
          f"{LaunchCounts.launches}, rgba8 diff {_diff_u8(again, cimg)}")
    _check(c_plain == 0 and c_launches >= n_raster and
           c_by_variant["content"] >= 1,
           "the cached content path did not run the kernel")
    _check(d_cached == 0, "the cached content image differs from uncached")
    _check(LaunchCounts.launches == 0 and _diff_u8(again, cimg) == 0,
           "the unchanged content frame did work")
    cframe = cached.build_frame()
    cached_ms = _events_ms(lambda: rc.render_device(cframe), TIMED_FRAMES)
    print(f"[7] render_device: uncached {device_ms:.3f} ms, cached unchanged "
          f"frame {cached_ms:.3f} ms (CUDA events, mean of {TIMED_FRAMES}); "
          f"frame build {build_ms:.1f} ms (host); peak memory {peak_mib:.0f} "
          f"MiB (one uncached frame after the first); card {smi}")
    return dict(launches=launches, by_variant=_add_counts(by_variant,
                                                          c_by_variant),
                errs=errs, root_ms=root_ms, root_plain_ms=root_plain_ms,
                root_bound_ms=bound["bound_ms"],
                root_bound_by=bound["bound_by"])


def _video_ties(img, want, zoom):
    """`_ties_in_rect` of the small zoomed frame's video at `zoom` (the
    pixels its device rect touches)."""
    from webrender_tpu_torch import scenes
    x, y, w, h = (v * zoom for v in scenes.MEDIA_SMALL["video"])
    return _ties_in_rect(img, want, (int(x), int(y), int(x + w) + 1 - int(x),
                                     int(y + h) + 1 - int(y)))


def phase8_zoomed_path(smi, regs):
    """The zoomed 4K page with video: scaled text, a planar YUV video,
    clear rects and opacity groups on the browsing page under a page
    zoom."""
    import numpy as np
    import torch
    from webrender_tpu_torch import scenes
    from webrender_tpu_torch.frame.frame_builder import TARGET_ROOT
    from webrender_tpu_torch.ops.tile_raster import (
        LaunchCounts, _launch, instantiation, render_tiles_dense_plain)
    from webrender_tpu_torch.render_backend import RenderBackend
    from webrender_tpu_torch.renderer.renderer import merged_root_passes

    def backend_4k(zoom):
        return scenes.build_4k_zoomed_scene(RenderBackend(
            (3840, 2160), device="cuda", resources=scenes.resource_cache()),
            3840, 2160, zoom)

    # the small zoomed frames against the plain version on the CPU and the
    # JAX renderer's images
    goldens = np.load(scenes.GOLDENS)
    size = scenes.ZOOMED_SIZE
    for name, zoom in scenes.ZOOMED_FRAMES:
        cpu_img = scenes.zoomed_scene(RenderBackend(
            size, device="cpu", resources=scenes.resource_cache()),
            zoom).render()
        for caching in (False, True):
            small = scenes.zoomed_scene(RenderBackend(
                size, device="cuda", resources=scenes.resource_cache()), zoom)
            small.renderer.picture_caching = caching
            img = small.render()
            d_cpu = _diff_u8(img, cpu_img)
            outside, inside, n = _video_ties(img, goldens[name], zoom)
            print(f"[8] small zoomed frame {size} at zoom {zoom}, picture "
                  f"caching {'on' if caching else 'off'}: rgba8 vs the plain "
                  f"version on the CPU {d_cpu} (tolerance 0); vs JAX "
                  f"{outside} outside the video (tolerance 0), {inside} "
                  f"inside at {n} values (XLA's contracted color-space "
                  f"matrix at exact-half ties; tolerance 1 at {VIDEO_TIES})")
            _check(d_cpu == 0 and outside == 0 and inside <= 1 and
                   n <= VIDEO_TIES, "the small zoomed frame differs")

    # the 4K zoomed frame at each zoom, uncached: every dispatch held
    # against the plain version
    launches, by_variant, errs = 0, {}, {}
    main = None
    for zoom in scenes.ZOOMS:
        backend = backend_4k(zoom)
        r = backend.renderer
        r.picture_caching = False
        t0 = time.perf_counter()
        frame = backend.build_frame()
        build_ms = (time.perf_counter() - t0) * 1000.0
        counts = _pass_counts(frame.passes)
        merged = _pass_counts(merged_root_passes(frame))
        drawn = int((frame.instances != 0).any(1).sum())
        print(f"[8] 4K zoomed frame at zoom {zoom}: {drawn} instances "
              f"({frame.instances.shape[0]} rows), {len(frame.passes)} "
              f"passes {counts}; uncached (root passes merged) {merged}; "
              f"frame build {build_ms:.1f} ms")
        _check(counts == ZOOMED_PASSES, f"4K zoomed passes {counts}")
        n_raster = merged["raster root"] + merged["raster surface"]
        r.dispatch_log = log = []
        held = []
        r._dispatch = _holding(r._dispatch, log, held)
        LaunchCounts.reset()
        try:
            img = backend.render()
        finally:
            del r._dispatch
        torch.cuda.synchronize()
        z_launches, z_plain = LaunchCounts.launches, LaunchCounts.plain_calls
        z_by_variant = dict(LaunchCounts.by_instantiation)
        r.dispatch_log = None
        for e, (err, _, _, variant) in zip(log, held):
            print(f"[8] zoom {zoom} dispatch {tuple(e['dense'].shape[:2])}: "
                  f"kinds {e['kinds']} blends {e['blends']}; {variant} "
                  f"instantiation; kernel vs plain max diff f32 {err}")
        root = log[-1]
        (p,) = [q for q in merged_root_passes(frame)
                if q.target == TARGET_ROOT]
        d_u8 = _diff_u8(img, _rgba8(held[-1][2], p.nx, p.ny, 3840, 2160))
        err = max(e for e, _, _, _ in held)
        print(f"[8] zoom {zoom} main path, uncached: kernel launches "
              f"{z_launches} {z_by_variant}, plain-version calls {z_plain}; "
              f"every dispatch max diff f32 {err}; root render() rgba8 vs "
              f"plain {d_u8} (tolerance 0); image {img.shape} {img.dtype}")
        _check(z_launches == n_raster and z_plain == 0,
               "the zoomed path did not run the kernel once per raster pass")
        _check(ZOOMED_KINDS <= set(root["kinds"]) and
               set(root["blends"]) == ZOOMED_BLENDS,
               f"root pass kinds {root['kinds']} blends {root['blends']}")
        _check(sum(14 in e["kinds"] for e in log) == 5,
               "the opacity groups did not run scaled grayscale text")
        _check(instantiation(root["kinds"], root["blends"],
                             root["mask_clips"]) == "media" and
               z_by_variant["media"] == n_raster,
               "the media instantiation did not run")
        _check(err == 0.0 and d_u8 == 0, "4K zoomed: the kernel disagrees")
        _check(img.shape == (2160, 3840, 4) and bool(img.any()),
               "4K zoomed: the image is wrong or empty")
        launches += z_launches
        by_variant = _add_counts(by_variant, z_by_variant)
        for k, v in _errors_by_variant(held).items():
            errs[k] = max(errs.get(k, 0.0), v)
        if main is None:   # zoom 1.25: the slice's full-width path
            main = (backend, frame, root, img, build_ms)
        del held
    backend, frame, root, img, build_ms = main
    r = backend.renderer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.render()
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    # times on the card, at zoom 1.25
    launch_args = (root["dense"], root["tile_counts"], root["tile_origins"],
                   root["clear_color"], root["f32_rows"], root["alpha_atlas"],
                   root["surface_atlas"], root["color_atlas"])
    kw = dict(kinds=root["kinds"], blends=root["blends"],
              mask_clips=root["mask_clips"])
    root_ms = _events_ms(lambda: _launch(*launch_args, **kw), TIMED_FRAMES)
    root_plain_ms = _events_ms(
        lambda: render_tiles_dense_plain(*launch_args, **kw), 3, warmup=1)
    bound = _bound(dict(dense=root["dense"], counts=root["tile_counts"],
                        origins=root["tile_origins"],
                        f32_rows=root["f32_rows"]))
    device_ms = _events_ms(lambda: r.render_device(frame), TIMED_FRAMES)
    print(f"[8] zoom 1.25 root pass {tuple(root['dense'].shape[:2])}: kernel "
          f"{root_ms:.3f} ms (CUDA events, {TIMED_FRAMES} launches), plain "
          f"version {root_plain_ms:.1f} ms; bound {bound['bound_ms']:.4f} ms "
          f"set by {bound['bound_by']} ({bound['ops']:.4g} operations, "
          f"{bound['bytes']:.4g} bytes); registers {regs}; card {smi}")

    # the default path: picture caching on, then the unchanged frame
    cached = backend_4k(1.25)
    rc = cached.renderer
    _check(rc.picture_caching, "picture caching is not the default")
    LaunchCounts.reset()
    cimg = cached.render()
    torch.cuda.synchronize()
    c_launches = LaunchCounts.launches
    c_by_variant = dict(LaunchCounts.by_instantiation)
    c_plain = LaunchCounts.plain_calls
    d_cached = _diff_u8(cimg, img)
    LaunchCounts.reset()
    again = cached.render()
    print(f"[8] main path, picture caching on: kernel launches {c_launches} "
          f"{c_by_variant}, plain-version calls {c_plain}; rgba8 vs uncached "
          f"{d_cached} (tolerance 0); unchanged frame: launches "
          f"{LaunchCounts.launches}, rgba8 diff {_diff_u8(again, cimg)}")
    _check(c_plain == 0 and c_launches >= 6 and c_by_variant["media"] >= 6,
           "the cached zoomed path did not run the kernel")
    _check(d_cached == 0, "the cached zoomed image differs from uncached")
    _check(LaunchCounts.launches == 0 and _diff_u8(again, cimg) == 0,
           "the unchanged zoomed frame did work")
    cframe = cached.build_frame()
    cached_ms = _events_ms(lambda: rc.render_device(cframe), TIMED_FRAMES)

    # a video tick: the three planes replaced, with caching on, against an
    # uncached render of the same state
    scenes.video_tick(cached, 1)
    LaunchCounts.reset()
    timg = cached.render()
    torch.cuda.synchronize()
    t_launches, t_dirty = LaunchCounts.launches, rc.last_dirty_tiles
    t_by_variant = dict(LaunchCounts.by_instantiation)
    scenes.video_tick(backend, 1)
    d_tick = _diff_u8(timg, backend.render())
    changed = int((timg != cimg).any(2).sum())
    print(f"[8] video tick, picture caching on: kernel launches {t_launches} "
          f"{t_by_variant}, dirty tiles {t_dirty} of {EXPECT_PASS[0]}, "
          f"{changed} pixels changed; rgba8 vs an uncached render of the "
          f"same state {d_tick} (tolerance 0)")
    _check(0 < t_dirty < EXPECT_PASS[0] // 2 and t_launches >= 1,
           f"the video tick re-rastered {t_dirty} tiles")
    _check(d_tick == 0 and changed > 0, "the video tick's image is wrong")

    # the tick loop: update_image and frame build on the host clock, the
    # plane upload and render_device by CUDA events
    host_ms, upload_ms, tick_ms = [], [], []
    for i in range(TIMED_FRAMES + 2):
        planes = scenes.video_planes(2 + i, scenes.MEDIA_4K["video_size"])
        t0 = time.perf_counter()
        scenes.video_tick(cached, planes=planes)
        tframe = cached.build_frame()
        uploads = cached.resources.take_uploads()
        host_ms.append((time.perf_counter() - t0) * 1000.0)
        start, mid, end = (torch.cuda.Event(enable_timing=True)
                           for _ in range(3))
        start.record()
        rc.apply_uploads(uploads)
        mid.record()
        rc.render_device(tframe)
        end.record()
        torch.cuda.synchronize()
        upload_ms.append(start.elapsed_time(mid))
        tick_ms.append(mid.elapsed_time(end))

    def mean(v):
        return sum(v[2:]) / len(v[2:])   # after two warm-up ticks
    print(f"[8] render_device: uncached {device_ms:.3f} ms, cached unchanged "
          f"frame {cached_ms:.3f} ms (CUDA events, mean of {TIMED_FRAMES}); "
          f"per video tick, render_device {mean(tick_ms):.3f} ms after a "
          f"plane upload of {mean(upload_ms):.3f} ms (CUDA events, mean of "
          f"{TIMED_FRAMES} ticks, {rc.last_dirty_tiles} dirty tiles), its "
          f"update_image and frame build {mean(host_ms):.3f} ms (host "
          f"clock); frame build {build_ms:.1f} ms (host); peak memory "
          f"{peak_mib:.0f} MiB (one uncached frame after the first); card "
          f"{smi}")
    return dict(launches=launches,
                by_variant=_add_counts(by_variant, c_by_variant,
                                       t_by_variant),
                errs=errs, root_ms=root_ms, root_plain_ms=root_plain_ms,
                root_bound_ms=bound["bound_ms"],
                root_bound_by=bound["bound_by"])


def _held_render(backend, what):
    """backend.render() with every kernel dispatch held against the plain
    version (`_holding`): (image, dispatch log, held, launches by
    instantiation); fails on a plain-version call or a disagreement."""
    import torch
    from webrender_tpu_torch.ops.tile_raster import LaunchCounts
    r = backend.renderer
    r.dispatch_log = log = []
    held = []
    r._dispatch = _holding(r._dispatch, log, held)
    LaunchCounts.reset()
    try:
        img = backend.render()
    finally:
        del r._dispatch
    torch.cuda.synchronize()
    r.dispatch_log = None
    by_variant = dict(LaunchCounts.by_instantiation)
    _check(LaunchCounts.launches == len(held) and
           LaunchCounts.plain_calls == 0,
           f"{what}: {LaunchCounts.launches} launches for {len(held)} "
           f"dispatches, {LaunchCounts.plain_calls} plain-version calls")
    err = max((e for e, _, _, _ in held), default=0.0)
    _check(err == 0.0, f"{what}: the kernel disagrees with its plain version")
    return img, log, held, by_variant


def phase9_transformed_path(smi, regs):
    """The transformed page: the tiles the JAX renderer hands to its XLA
    engine, drawn by the general branches of the one kernel."""
    import numpy as np
    import torch
    from webrender_tpu_torch import scenes
    from webrender_tpu_torch.frame.frame_builder import TARGET_ROOT
    from webrender_tpu_torch.ops.dense import GENERAL_KINDS
    from webrender_tpu_torch.ops.tile_raster import (
        LaunchCounts, _launch, instantiation, render_tiles_dense_plain)
    from webrender_tpu_torch.render_backend import RenderBackend
    from webrender_tpu_torch.renderer.renderer import merged_root_passes

    def backend_4k():
        return scenes.build_4k_transformed_scene(RenderBackend(
            (3840, 2160), device="cuda", resources=scenes.resource_cache()))

    # the small transformed frame against the plain version on the CPU and
    # the JAX package's numpy oracle
    name, make, size = scenes.TRANSFORMED_FRAME
    golden = np.load(scenes.GOLDENS)[name]
    cpu_img = make(RenderBackend(size, device="cpu",
                                 resources=scenes.resource_cache())).render()
    for caching in (False, True):
        small = make(RenderBackend(size, device="cuda",
                                   resources=scenes.resource_cache()))
        small.renderer.picture_caching = caching
        img, log, held, by_variant = _held_render(small, "small frame")
        general = small.renderer.last_general_tiles
        print(f"[9] small transformed frame {size}, picture caching "
              f"{'on' if caching else 'off'}: {len(held)} dispatches "
              f"{by_variant}, each max diff f32 0.0 against the plain "
              f"version; general tiles / tiles {general}; rgba8 vs the plain "
              f"version on the CPU {_diff_u8(img, cpu_img)}, vs the JAX "
              f"package's numpy oracle {_diff_u8(img, golden)} (tolerance 0)")
        _check(_diff_u8(img, cpu_img) == 0 and _diff_u8(img, golden) == 0,
               "the small transformed frame differs")
        _check(0 < general[-1][0] < general[-1][1],
               "the small frame's root pass does not mix general and other "
               "tiles")

    # the 4K transformed page, uncached: every dispatch against the plain
    # version
    backend = backend_4k()
    r = backend.renderer
    r.picture_caching = False
    t0 = time.perf_counter()
    frame = backend.build_frame()
    build_ms = (time.perf_counter() - t0) * 1000.0
    counts = _pass_counts(frame.passes)
    merged = _pass_counts(merged_root_passes(frame))
    drawn = int((frame.instances != 0).any(1).sum())
    reasons = scenes.general_reasons(frame)
    print(f"[9] 4K transformed page: {drawn} instances "
          f"({frame.instances.shape[0]} rows), {len(frame.passes)} passes "
          f"{counts}; uncached (root passes merged) {merged}; frame build "
          f"{build_ms:.1f} ms; instances without a path in the TPU kernel, "
          f"by reason: {reasons}")
    _check(set(reasons) == TRANSFORMED_REASONS,
           f"the page's reasons are {sorted(reasons)}")
    img, log, held, by_variant = _held_render(backend, "4K uncached")
    for e, (err, _, _, variant), (g, nt) in zip(log, held,
                                                r.last_general_tiles):
        print(f"[9] dispatch {tuple(e['dense'].shape[:2])}: kinds "
              f"{e['kinds']} blends {e['blends']} mask_clips "
              f"{e['mask_clips']}; general tiles / tiles {g} / {nt}; "
              f"{variant} instantiation; kernel vs plain max diff f32 {err}")
    root = log[-1]
    g_root, nt_root = r.last_general_tiles[-1]
    (p,) = [q for q in merged_root_passes(frame) if q.target == TARGET_ROOT]
    d_u8 = _diff_u8(img, _rgba8(held[-1][2], p.nx, p.ny, 3840, 2160))
    n_raster = merged["raster root"] + merged["raster surface"]
    print(f"[9] main path, uncached: kernel launches {len(held)} "
          f"{by_variant}, plain-version calls 0; root pass "
          f"{tuple(root['dense'].shape[:2])}, general tiles / tiles "
          f"{g_root} / {nt_root}; root render() rgba8 vs plain {d_u8} "
          f"(tolerance 0); image {img.shape} {img.dtype}")
    _check(len(held) == n_raster, "not one launch per raster pass")
    _check(tuple(root["dense"].shape) == EXPECT_PASS + (128,),
           f"root pass {tuple(root['dense'].shape)}")
    _check(set(GENERAL_KINDS) <= set(root["kinds"]) and root["general"],
           f"root pass kinds {root['kinds']}")
    _check(nt_root * 0.3 < g_root < nt_root * 0.7,
           f"{g_root} of {nt_root} root tiles are general")
    _check(instantiation(root["kinds"], root["blends"], root["mask_clips"],
                         root["general"], root["step"]) == "general" and
           by_variant["general"] >= 1,
           "the general instantiation did not run")
    _check(d_u8 == 0, "4K transformed: the image differs from the plain one")
    _check(img.shape == (2160, 3840, 4) and bool(img.any()),
           "4K transformed: the image is wrong or empty")
    errs = _errors_by_variant(held)
    launches = dict(by_variant)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.render()
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    # times on the card
    launch_args = (root["dense"], root["tile_counts"], root["tile_origins"],
                   root["clear_color"], root["f32_rows"], root["alpha_atlas"],
                   root["surface_atlas"], root["color_atlas"])
    kw = dict(kinds=root["kinds"], blends=root["blends"],
              mask_clips=root["mask_clips"], step=root["step"])
    root_ms = _events_ms(
        lambda: _launch(*launch_args, general=root["general"], **kw),
        TIMED_FRAMES)
    root_plain_ms = _events_ms(
        lambda: render_tiles_dense_plain(*launch_args, **kw), 2, warmup=1)
    bound = _bound(dict(dense=root["dense"], counts=root["tile_counts"],
                        origins=root["tile_origins"],
                        f32_rows=root["f32_rows"]))
    device_ms = _events_ms(lambda: r.render_device(frame), TIMED_FRAMES)
    print(f"[9] root pass {tuple(root['dense'].shape[:2])}: kernel "
          f"{root_ms:.3f} ms (CUDA events, {TIMED_FRAMES} launches), plain "
          f"version {root_plain_ms:.1f} ms; bound {bound['bound_ms']:.4f} ms "
          f"set by {bound['bound_by']} ({bound['ops']:.4g} operations, "
          f"{bound['bytes']:.4g} bytes); registers {regs}; card {smi}")

    # the default path: picture caching on, every dispatch held again; then
    # the unchanged frame
    cached = backend_4k()
    rc = cached.renderer
    _check(rc.picture_caching, "picture caching is not the default")
    cimg, clog, cheld, c_by_variant = _held_render(cached, "4K cached")
    launches = _add_counts(launches, c_by_variant)
    for k, v in _errors_by_variant(cheld).items():
        errs[k] = max(errs.get(k, 0.0), v)
    c_general = rc.last_general_tiles
    LaunchCounts.reset()
    again = cached.render()
    print(f"[9] main path, picture caching on: kernel launches {len(cheld)} "
          f"{c_by_variant}, plain-version calls 0, each max diff f32 0.0 "
          f"against the plain version; general tiles / tiles per dispatch "
          f"{c_general}; rgba8 vs uncached {_diff_u8(cimg, img)} (tolerance "
          f"0); unchanged frame: launches {LaunchCounts.launches}, rgba8 "
          f"diff {_diff_u8(again, cimg)}")
    _check(c_by_variant["general"] >= 1 and _diff_u8(cimg, img) == 0,
           "the cached transformed page differs from uncached")
    _check(LaunchCounts.launches == 0 and _diff_u8(again, cimg) == 0,
           "the unchanged transformed page did work")
    cframe = cached.build_frame()
    cached_ms = _events_ms(lambda: rc.render_device(cframe), TIMED_FRAMES)
    del cheld, clog

    # a scroll step of the feed, then a video tick, with caching on, each
    # against an uncached render of the same state
    for what, change in (("scroll step", lambda b: _scroll_to(b, 1)),
                         ("video tick", lambda b: scenes.video_tick(
                             b, 1, scenes.TRANSFORMED_4K["video_size"]))):
        change(cached)
        simg, slog, sheld, s_by_variant = _held_render(cached, what)
        launches = _add_counts(launches, s_by_variant)
        for k, v in _errors_by_variant(sheld).items():
            errs[k] = max(errs.get(k, 0.0), v)
        change(backend)
        d_state = _diff_u8(simg, backend.render())
        changed = int((simg != cimg).any(2).sum())
        print(f"[9] {what}, picture caching on: kernel launches "
              f"{len(sheld)} {s_by_variant}, each max diff f32 0.0 against "
              f"the plain version; dirty tiles {rc.last_dirty_tiles}, slices "
              f"{[d['dirty'] for d in rc.slice_debug]}; general tiles / "
              f"tiles per dispatch {rc.last_general_tiles}; {changed} "
              f"pixels changed; rgba8 vs an uncached render of the same "
              f"state {d_state} (tolerance 0)")
        _check(d_state == 0 and changed > 0, f"the {what}'s image is wrong")
        cimg = simg
        del sheld, slog
    print(f"[9] render_device: uncached {device_ms:.3f} ms, cached unchanged "
          f"frame {cached_ms:.3f} ms (CUDA events, mean of {TIMED_FRAMES}); "
          f"frame build {build_ms:.1f} ms (host); peak memory {peak_mib:.0f} "
          f"MiB (one uncached frame after the first); card {smi}")
    return dict(by_variant=launches, errs=errs, root_ms=root_ms,
                root_plain_ms=root_plain_ms,
                root_bound_ms=bound["bound_ms"],
                root_bound_by=bound["bound_by"])


def _steps(a, b):
    """(max u8 difference, number of differing values) of two images."""
    import numpy as np
    d = np.abs(a.astype(int) - b.astype(int))
    return int(d.max()), int((d > 0).sum())


def phase10_svg_path(smi, regs):
    """The SVG-filter page: the offscreen channel-LUT, sRGB and arithmetic
    passes, the float-domain blend ops and the linearRGB color matrix in
    the kernel's filter instantiation."""
    import numpy as np
    import torch
    from webrender_tpu_torch import scenes
    from webrender_tpu_torch.ops.tile_raster import (
        LaunchCounts, _launch, instantiation, render_tiles_dense_plain)
    from webrender_tpu_torch.render_backend import RenderBackend
    from webrender_tpu_torch.renderer.renderer import merged_root_passes

    def backend_4k():
        return scenes.build_4k_svg_scene(RenderBackend(
            (3840, 2160), device="cuda", resources=scenes.resource_cache()))

    # the small SVG-filter frame against the plain version on the CPU and
    # the JAX package's numpy oracle: one step apart at most, in the
    # linearRGB groups (exp and log round otherwise on each machine)
    name, make, size = scenes.SVG_FRAME
    golden = np.load(scenes.GOLDENS)[name]
    cpu = make(RenderBackend(size, device="cpu",
                             resources=scenes.resource_cache()))
    cpu.renderer.picture_caching = False
    cpu_img = cpu.render()
    for caching in (False, True):
        small = make(RenderBackend(size, device="cuda",
                                   resources=scenes.resource_cache()))
        small.renderer.picture_caching = caching
        img, _, held, by_variant = _held_render(small, "small svg frame")
        cpu_steps, oracle_steps = _steps(img, cpu_img), _steps(img, golden)
        print(f"[10] small SVG-filter frame {size}, picture caching "
              f"{'on' if caching else 'off'}: {len(held)} dispatches "
              f"{by_variant}, each max diff f32 0.0 against the plain "
              f"version; rgba8 (max step, values apart) vs the plain version "
              f"on the CPU {cpu_steps}, vs the JAX package's numpy oracle "
              f"{oracle_steps} (tolerance: one step)")
        _check(cpu_steps[0] <= 1 and oracle_steps[0] <= 1,
               "the small SVG-filter frame differs by more than a step")
        _check(by_variant["filter"] >= 1, "no filter launch")

    # the 4K SVG-filter page, uncached: every dispatch against the plain
    # version
    backend = backend_4k()
    r = backend.renderer
    r.picture_caching = False
    t0 = time.perf_counter()
    frame = backend.build_frame()
    build_ms = (time.perf_counter() - t0) * 1000.0
    counts = scenes.svg_counts(frame)
    merged = _pass_counts(merged_root_passes(frame))
    drawn = int((frame.instances != 0).any(1).sum())
    print(f"[10] 4K SVG-filter page: {drawn} instances "
          f"({frame.instances.shape[0]} rows), {len(frame.passes)} passes "
          f"{counts['passes']}; uncached (root passes merged) {merged}; "
          f"surface blend ops {counts['blends']}; color-matrix flags "
          f"{counts['cm_flags']}; arithmetic k {sorted(set(counts['kvals']))} "
          f"(linearRGB {counts['arith_linear']}); frame build "
          f"{build_ms:.1f} ms")
    _check(counts["passes"] == SVG_PASSES, f"4K SVG passes {counts}")
    _check(set(SVG_BLENDS) <= set(counts["blends"]) and
           counts["cm_flags"] == [0.0, 1.0, 2.0],
           f"4K SVG blends {counts['blends']}")
    img, log, held, by_variant = _held_render(backend, "4K uncached")
    n_raster = merged["raster root"] + merged["raster surface"]
    filt = [i for i, (_, _, _, v) in enumerate(held) if v == "filter"]
    print(f"[10] main path, uncached: kernel launches {len(held)} "
          f"{by_variant}, plain-version calls 0, each max diff f32 0.0 "
          f"against the plain version ({len(filt)} on the filter "
          f"instantiation); image {img.shape} {img.dtype}")
    _check(len(held) == n_raster, "not one launch per raster pass")
    _check(by_variant["filter"] >= 1, "the filter instantiation did not run")
    _check(img.shape == (2160, 3840, 4) and bool(img.any()),
           "4K SVG: the image is wrong or empty")
    errs = _errors_by_variant(held)
    launches = dict(by_variant)
    # the heaviest filter dispatch: the most records
    e = log[max(filt, key=lambda i: (int(log[i]["tile_counts"].sum()),
                                     log[i]["dense"].shape[0]))]
    del held
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.render()
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    # the heaviest filter dispatch over seeded destination tiles (its
    # records composite over pixels they do not cover), then timed
    launch_args = (e["dense"], e["tile_counts"], e["tile_origins"],
                   e["clear_color"], e["f32_rows"], e["alpha_atlas"],
                   e["surface_atlas"], e["color_atlas"])
    kw = dict(kinds=e["kinds"], blends=e["blends"],
              mask_clips=e["mask_clips"], step=e["step"])
    variant = instantiation(e["kinds"], e["blends"], e["mask_clips"],
                            e["general"], e["step"], e["linear_cm"])
    nt = e["dense"].shape[0]
    rng = np.random.RandomState(10)
    init = torch.from_numpy((rng.randint(0, 256, (nt, 4, 64, 128)) /
                             255.0).astype(np.float32)).cuda()
    out = _launch(*launch_args, init, general=e["general"],
                  linear_cm=e["linear_cm"], **kw)
    ref = render_tiles_dense_plain(*launch_args, init, **kw)
    torch.cuda.synchronize()
    init_err = float((out - ref).abs().max())
    errs["filter"] = max(errs.get("filter", 0.0), init_err)
    _check(variant == "filter" and init_err == 0.0,
           "the filter dispatch over seeded tiles disagrees")
    filt_ms = _events_ms(lambda: _launch(
        *launch_args, general=e["general"], linear_cm=e["linear_cm"], **kw),
        TIMED_FRAMES)
    filt_plain_ms = _events_ms(
        lambda: render_tiles_dense_plain(*launch_args, **kw), 3, warmup=1)
    bound = _bound(dict(dense=e["dense"], counts=e["tile_counts"],
                        origins=e["tile_origins"], f32_rows=e["f32_rows"]))
    print(f"[10] heaviest filter dispatch {tuple(e['dense'].shape[:2])} "
          f"({int(e['tile_counts'].sum())} records; blends {e['blends']}, "
          f"linear_cm {e['linear_cm']}; {variant} instantiation): over "
          f"seeded tiles max diff f32 {init_err} against the plain version; "
          f"kernel {filt_ms:.4f} ms (CUDA events, {TIMED_FRAMES} launches), "
          f"plain version {filt_plain_ms:.1f} ms; bound "
          f"{bound['bound_ms']:.5f} ms set by {bound['bound_by']} "
          f"({bound['ops']:.4g} operations, {bound['bytes']:.4g} bytes); "
          f"registers {regs}; card {smi}")
    device_ms = _events_ms(lambda: r.render_device(frame), TIMED_FRAMES)
    by_pass = _pass_times(r, frame)
    print("[10] where the uncached frame's time goes, by pass (host clock, "
          "synchronised around each pass, ms, count): " +
          ", ".join(f"{k} {v[0]:.3f} ({v[1]})" for k, v in
                    sorted(by_pass.items(), key=lambda kv: -kv[1][0])) +
          f"; card {smi}")
    for k in ("channel_lut", "srgb", "arith"):
        _check(by_pass.get(k, (0, 0))[1] >= 1, f"no {k} pass ran")

    # the default path: picture caching on, every dispatch held again; then
    # the unchanged frame
    cached = backend_4k()
    rc = cached.renderer
    _check(rc.picture_caching, "picture caching is not the default")
    cimg, clog, cheld, c_by_variant = _held_render(cached, "4K cached")
    launches = _add_counts(launches, c_by_variant)
    for k, v in _errors_by_variant(cheld).items():
        errs[k] = max(errs.get(k, 0.0), v)
    LaunchCounts.reset()
    again = cached.render()
    print(f"[10] main path, picture caching on: kernel launches "
          f"{len(cheld)} {c_by_variant}, plain-version calls 0, each max "
          f"diff f32 0.0 against the plain version; rgba8 vs uncached "
          f"{_diff_u8(cimg, img)} (tolerance 0); unchanged frame: launches "
          f"{LaunchCounts.launches}, rgba8 diff {_diff_u8(again, cimg)}")
    _check(c_by_variant["filter"] >= 1 and _diff_u8(cimg, img) == 0,
           "the cached SVG page differs from uncached")
    _check(LaunchCounts.launches == 0 and _diff_u8(again, cimg) == 0,
           "the unchanged SVG page did work")
    cframe = cached.build_frame()
    cached_ms = _events_ms(lambda: rc.render_device(cframe), TIMED_FRAMES)
    del cheld, clog
    print(f"[10] render_device: uncached {device_ms:.3f} ms, cached "
          f"unchanged frame {cached_ms:.3f} ms (CUDA events, mean of "
          f"{TIMED_FRAMES}); frame build {build_ms:.1f} ms (host); peak "
          f"memory {peak_mib:.0f} MiB (one uncached frame after the first); "
          f"card {smi}")
    return dict(by_variant=launches, errs=errs, root_ms=filt_ms,
                root_plain_ms=filt_plain_ms, root_bound_ms=bound["bound_ms"],
                root_bound_by=bound["bound_by"])


def _forget_mirrors(renderer):
    """Drop the renderer's delta mirrors, dense-record mirrors and cached
    dense kinds: its next render gathers every record from scratch."""
    from webrender_tpu_torch.renderer.renderer import _DeltaStore
    renderer._delta = _DeltaStore(renderer.device)
    renderer._dense_mirrors = {}
    renderer._dk_cache = None
    renderer._last_put_frame = None


def phase11_css3d_path(smi, regs):
    """The CSS-3D page: perspective, plane splitting, backface culling and
    plane surfaces on the host, and the polygon clips of the split
    fragments in the kernel's general build."""
    import numpy as np
    import torch
    from webrender_tpu_torch import scenes
    from webrender_tpu_torch.frame.frame_builder import (TARGET_ROOT,
                                                         FrameBuilder)
    from webrender_tpu_torch.ops.tile_raster import (
        LaunchCounts, _launch, instantiation, render_tiles_dense_plain)
    from webrender_tpu_torch.render_backend import RenderBackend
    from webrender_tpu_torch.renderer.renderer import merged_root_passes

    def backend_4k():
        return scenes.build_4k_3d_scene(RenderBackend(
            (3840, 2160), device="cuda", resources=scenes.resource_cache()))

    # the small CSS-3D frame against the plain version on the CPU and the
    # JAX package's numpy oracle
    name, make, size = scenes.PRESERVE3D_FRAME
    golden = np.load(scenes.GOLDENS)[name]
    cpu_img = make(RenderBackend(size, device="cpu",
                                 resources=scenes.resource_cache())).render()
    for caching in (False, True):
        small = make(RenderBackend(size, device="cuda",
                                   resources=scenes.resource_cache()))
        small.renderer.picture_caching = caching
        img, log, held, by_variant = _held_render(small, "small CSS-3D frame")
        polygons = sum(e["polygon_clips"] for e in log)
        print(f"[11] small CSS-3D frame {size}, picture caching "
              f"{'on' if caching else 'off'}: {len(held)} dispatches "
              f"{by_variant} ({polygons} with polygon clips), each max diff "
              f"f32 0.0 against the plain version; rgba8 vs the plain "
              f"version on the CPU {_diff_u8(img, cpu_img)}, vs the JAX "
              f"package's numpy oracle {_diff_u8(img, golden)} (tolerance 0)")
        _check(_diff_u8(img, cpu_img) == 0 and _diff_u8(img, golden) == 0,
               "the small CSS-3D frame differs")
        _check(polygons >= 1, "no dispatch of the small frame held a polygon")

    # the 4K CSS-3D page, uncached: every dispatch against the plain version
    backend = backend_4k()
    r = backend.renderer
    r.picture_caching = False
    t0 = time.perf_counter()
    with scenes.CulledFaces() as culled:
        frame = backend.build_frame()
    build_ms = (time.perf_counter() - t0) * 1000.0
    counts = scenes.css3d_counts(frame)
    merged = _pass_counts(merged_root_passes(frame))
    print(f"[11] 4K CSS-3D page: {counts['instances']} instances "
          f"({counts['rows']} rows), {counts['passes']} passes "
          f"{_pass_counts(frame.passes)}; uncached (root passes merged) "
          f"{merged}; records holding a polygon clip (clip kind 3) in the "
          f"root passes: {counts['polygon_records']} in tiles that are not "
          f"general, {counts['polygon_records_general']} in general tiles; "
          f"general tiles / tiles {counts['general_tiles']} / "
          f"{counts['tiles']}; culled faces {len(culled.nodes)}; frame build "
          f"{build_ms:.1f} ms")
    _check(counts == CSS3D_COUNTS, f"4K CSS-3D counts {counts}")
    _check(len(culled.nodes) == CSS3D_CULLED,
           f"{len(culled.nodes)} culled faces")
    img, log, held, by_variant = _held_render(backend, "4K uncached")
    for e, (err, _, _, variant), (g, nt) in zip(log, held,
                                                r.last_general_tiles):
        print(f"[11] dispatch {tuple(e['dense'].shape[:2])}: kinds "
              f"{e['kinds']} blends {e['blends']} mask_clips "
              f"{e['mask_clips']} polygon_clips {e['polygon_clips']}; "
              f"general tiles / tiles {g} / {nt}; {variant} instantiation; "
              f"kernel vs plain max diff f32 {err}")
    root = log[-1]
    g_root, nt_root = r.last_general_tiles[-1]
    (p,) = [q for q in merged_root_passes(frame) if q.target == TARGET_ROOT]
    d_u8 = _diff_u8(img, _rgba8(held[-1][2], p.nx, p.ny, 3840, 2160))
    n_raster = merged["raster root"] + merged["raster surface"]
    print(f"[11] main path, uncached: kernel launches {len(held)} "
          f"{by_variant}, plain-version calls 0; root pass "
          f"{tuple(root['dense'].shape[:2])}, general tiles / tiles "
          f"{g_root} / {nt_root}; root render() rgba8 vs plain {d_u8} "
          f"(tolerance 0); image {img.shape} {img.dtype}")
    _check(len(held) == n_raster, "not one launch per raster pass")
    _check(tuple(root["dense"].shape) == EXPECT_PASS + (128,),
           f"root pass {tuple(root['dense'].shape)}")
    _check(root["polygon_clips"] and root["general"] and
           held[-1][3] == "general",
           "the root pass did not take the general build with its polygons")
    _check(d_u8 == 0, "4K CSS-3D: the image differs from the plain one")
    _check(img.shape == (2160, 3840, 4) and bool(img.any()),
           "4K CSS-3D: the image is wrong or empty")
    errs = _errors_by_variant(held)
    launches = dict(by_variant)
    del held
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.render()
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    # times on the card
    launch_args = (root["dense"], root["tile_counts"], root["tile_origins"],
                   root["clear_color"], root["f32_rows"], root["alpha_atlas"],
                   root["surface_atlas"], root["color_atlas"])
    kw = dict(kinds=root["kinds"], blends=root["blends"],
              mask_clips=root["mask_clips"], step=root["step"])
    root_ms = _events_ms(
        lambda: _launch(*launch_args, general=root["general"],
                        polygon_clips=root["polygon_clips"], **kw),
        TIMED_FRAMES)
    root_plain_ms = _events_ms(
        lambda: render_tiles_dense_plain(*launch_args, **kw), 2, warmup=1)
    bound = _bound(dict(dense=root["dense"], counts=root["tile_counts"],
                        origins=root["tile_origins"],
                        f32_rows=root["f32_rows"]),
                   mask_clips=root["mask_clips"])
    device_ms = _events_ms(lambda: r.render_device(frame), TIMED_FRAMES)
    by_pass = _pass_times(r, frame)
    print("[11] where the uncached frame's time goes, by pass (host clock, "
          "synchronised around each pass, ms, count): " +
          ", ".join(f"{k} {v[0]:.3f} ({v[1]})" for k, v in
                    sorted(by_pass.items(), key=lambda kv: -kv[1][0])) +
          f"; card {smi}")
    print(f"[11] root pass {tuple(root['dense'].shape[:2])}: kernel "
          f"{root_ms:.3f} ms (CUDA events, {TIMED_FRAMES} launches), plain "
          f"version {root_plain_ms:.1f} ms; bound {bound['bound_ms']:.4f} ms "
          f"set by {bound['bound_by']} ({bound['ops']:.4g} operations, "
          f"{bound['bytes']:.4g} bytes); registers {regs}; card {smi}")

    # the default path: picture caching on, every dispatch held again; then
    # the unchanged frame
    cached = backend_4k()
    rc = cached.renderer
    _check(rc.picture_caching, "picture caching is not the default")
    cimg, clog, cheld, c_by_variant = _held_render(cached, "4K cached")
    launches = _add_counts(launches, c_by_variant)
    for k, v in _errors_by_variant(cheld).items():
        errs[k] = max(errs.get(k, 0.0), v)
    LaunchCounts.reset()
    again = cached.render()
    print(f"[11] main path, picture caching on: kernel launches {len(cheld)} "
          f"{c_by_variant}, plain-version calls 0, each max diff f32 0.0 "
          f"against the plain version; polygon dispatches "
          f"{sum(e['polygon_clips'] for e in clog)}; rgba8 vs uncached "
          f"{_diff_u8(cimg, img)} (tolerance 0); unchanged frame: launches "
          f"{LaunchCounts.launches}, rgba8 diff {_diff_u8(again, cimg)}")
    _check(c_by_variant["general"] >= 1 and _diff_u8(cimg, img) == 0,
           "the cached CSS-3D page differs from uncached")
    _check(LaunchCounts.launches == 0 and _diff_u8(again, cimg) == 0,
           "the unchanged CSS-3D page did work")
    cframe = cached.build_frame()
    cached_ms = _events_ms(lambda: rc.render_device(cframe), TIMED_FRAMES)
    del cheld, clog

    # the flip animation, then a scroll step of the feed, with caching on,
    # each against an uncached render of the same state that gathers every
    # record from scratch
    fast = FrameBuilder._try_scroll_fast_path
    declined = []

    def watch(self, *a, **k):
        out = fast(self, *a, **k)
        declined.append(out is None)
        return out
    steps = [(f"flip {a:g}",
              lambda b, a=a: scenes.build_4k_3d_scene(b, flip=a))
             for a in scenes.FLIP_FRAMES]
    steps.append(("scroll step", lambda b: _scroll_to(b, 1)))
    flip_culled = []
    FrameBuilder._try_scroll_fast_path = watch
    try:
        for what, change in steps:
            change(cached)
            del declined[:]
            with scenes.CulledFaces() as faces:
                simg, slog, sheld, s_by_variant = _held_render(cached, what)
            launches = _add_counts(launches, s_by_variant)
            for k, v in _errors_by_variant(sheld).items():
                errs[k] = max(errs.get(k, 0.0), v)
            change(backend)
            _forget_mirrors(r)
            d_state = _diff_u8(simg, backend.render())
            changed = int((simg != cimg).any(2).sum())
            print(f"[11] {what}, picture caching on: kernel launches "
                  f"{len(sheld)} {s_by_variant}, each max diff f32 0.0 "
                  f"against the plain version; polygon dispatches "
                  f"{sum(e['polygon_clips'] for e in slog)}; tiles rastered "
                  f"{sum(e['dense'].shape[0] for e in slog)}; culled faces "
                  f"{len(faces.nodes)}; "
                  f"scroll fast path declined {all(declined)}; {changed} "
                  f"pixels changed; rgba8 vs an uncached render of the same "
                  f"state from scratch {d_state} (tolerance 0)")
            _check(d_state == 0 and changed > 0,
                   f"the {what}'s image is wrong")
            if what.startswith("flip"):
                flip_culled.append(frozenset(faces.nodes))
            else:
                _check(declined and all(declined),
                       "the scroll fast path took a frame with polygon clips")
            cimg = simg
            del sheld, slog
    finally:
        FrameBuilder._try_scroll_fast_path = fast
    turns = sum(a != b for a, b in zip(flip_culled, flip_culled[1:]))
    _check(turns == 1, f"the culled faces changed {turns} times in the flip")
    # the flip frames again, timed: the display list sent, the frame built
    # and rendered, each on the host clock between synchronisations
    flip_times = []
    for a in scenes.FLIP_FRAMES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scenes.build_4k_3d_scene(cached, flip=a)
        t1 = time.perf_counter()
        fframe = cached.build_frame()
        t2 = time.perf_counter()
        rc.render_device(fframe, cached.resources)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        flip_times.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                           (t3 - t2) * 1e3, (t3 - t0) * 1e3))
    send_ms, fbuild_ms, fdevice_ms, flip_ms = (
        float(np.median(v)) for v in zip(*flip_times))
    print(f"[11] flip frame, picture caching on (host clock with sync, "
          f"median of {len(flip_times)}): display list and transaction "
          f"{send_ms:.1f} ms, frame build {fbuild_ms:.1f} ms, render_device "
          f"{fdevice_ms:.1f} ms; end to end {flip_ms:.1f} ms; card {smi}")
    print(f"[11] render_device: uncached {device_ms:.3f} ms, cached unchanged "
          f"frame {cached_ms:.3f} ms (CUDA events, mean of {TIMED_FRAMES}); "
          f"frame build {build_ms:.1f} ms (host); peak memory {peak_mib:.0f} "
          f"MiB (one uncached frame after the first); card {smi}")
    return dict(by_variant=launches, errs=errs, root_ms=root_ms,
                root_plain_ms=root_plain_ms,
                root_bound_ms=bound["bound_ms"],
                root_bound_by=bound["bound_by"])


def _has_text(path):
    """Whether a wrench document (YAML or JSON) holds a text item."""
    from webrender_tpu_torch.wrench import reftest
    return reftest._yaml_has_text(path) or '"text":' in path.read_text()


def _gl_document_backend(harness, path, size=None):
    """The backend the harness renders `path` on under gl_flavor (its own
    `_backend` and reader), built."""
    from webrender_tpu_torch.wrench.yaml_reader import YamlFrameReader
    backend = harness._backend(size, None, True)
    YamlFrameReader(path, harness.window_size).build(backend)
    return backend


def _gl_root_times(what, root, smi):
    """The root dispatch `root` (a dispatch-log entry of a gl frame): its
    kernel time on the gl build and, on the same records, on the build
    its kinds and blends take without gl, both by CUDA events in this
    call; the plain version's time with gl; both bounds."""
    from webrender_tpu_torch.ops.tile_raster import (
        _launch, instantiation, render_tiles_dense_plain)
    args = (root["dense"], root["tile_counts"], root["tile_origins"],
            root["clear_color"], root["f32_rows"], root["alpha_atlas"],
            root["surface_atlas"], root["color_atlas"])
    kw = dict(kinds=root["kinds"], blends=root["blends"],
              mask_clips=root["mask_clips"], step=root["step"])
    flags = dict(general=root["general"], linear_cm=root["linear_cm"],
                 polygon_clips=root["polygon_clips"])
    swgl = instantiation(root["kinds"], root["blends"], root["mask_clips"],
                         root["general"], root["step"], root["linear_cm"],
                         root["polygon_clips"])
    times = {"gl": [], swgl: []}
    for gl in (True, False, False, True):
        times["gl" if gl else swgl].append(_events_ms(
            lambda: _launch(*args, **kw, **flags, gl=gl), TIMED_FRAMES))
    plain_ms = _events_ms(
        lambda: render_tiles_dense_plain(*args, **kw, gl=True), 2, warmup=1)
    inp = dict(dense=root["dense"], counts=root["tile_counts"],
               origins=root["tile_origins"], f32_rows=root["f32_rows"])
    bound = _bound(inp, mask_clips=root["mask_clips"], gl=True)
    bound_swgl = _bound(inp, mask_clips=root["mask_clips"])
    gl_ms = min(times["gl"])
    print(f"[12] {what} root pass {tuple(root['dense'].shape[:2])}: kernel "
          f"on the gl build {times['gl'][0]:.3f} / {times['gl'][1]:.3f} ms, "
          f"on the {swgl} build (the same records without gl) "
          f"{times[swgl][0]:.3f} / {times[swgl][1]:.3f} ms (CUDA events, "
          f"{TIMED_FRAMES} launches each, in turns gl, {swgl}, {swgl}, gl); "
          f"plain version with gl {plain_ms:.1f} ms; bound with gl "
          f"{bound['bound_ms']:.4f} ms set by {bound['bound_by']} "
          f"({bound['ops']:.4g} operations, {bound['bytes']:.4g} bytes), "
          f"without {bound_swgl['bound_ms']:.4f} ms; card {smi}")
    return dict(ms=gl_ms, swgl_ms=min(times[swgl]), swgl_variant=swgl,
                plain_ms=plain_ms, bound_ms=bound["bound_ms"],
                bound_by=bound["bound_by"])


def phase12_gl_reftests(smi, regs):
    """The GL-flavoured reftest path: the wrench manifest and harness, the
    reader, the renderer's dispatches on the kernel's gl instantiation,
    the numpy oracle; then bench's browsing and the content page built
    with gl_flavor."""
    import numpy as np
    import torch
    from webrender_tpu_torch import scenes
    from webrender_tpu_torch.frame.frame_builder import TARGET_ROOT
    from webrender_tpu_torch.ops.tile_raster import LaunchCounts
    from webrender_tpu_torch.render_backend import RenderBackend
    from webrender_tpu_torch.renderer.renderer import merged_root_passes
    from webrender_tpu_torch.wrench import reftest

    # (a) the small documents on the manifest
    fonts = scenes.font_stack_available()
    goldens = np.load(scenes.GOLDENS)
    harness = reftest.ReftestHarness(scenes.GL_SMALL_SIZE, device="cuda")
    launches, errs = {}, {}
    for name in scenes.GL_DOCUMENTS:
        path = scenes.WRENCH / name
        if _has_text(path) and not fonts:
            try:
                _gl_document_backend(harness, path)
                raise SmokeFailure(f"{name} was read without a font stack")
            except ModuleNotFoundError as e:
                print(f"[12] {name}: not read here, as the machine has no "
                      f"font stack: {e}")
                _check("matplotlib" in str(e), f"{name}: {e}")
            continue
        backend = _gl_document_backend(harness, path)
        img, log, held, by_variant = _held_render(backend, name)
        launches = _add_counts(launches, by_variant)
        for k, v in _errors_by_variant(held).items():
            errs[k] = max(errs.get(k, 0.0), v)
        d_jax = _diff_u8(img, goldens[scenes.gl_golden_name(name)])
        print(f"[12] {name}: {len(held)} dispatches {by_variant}, each max "
              f"diff f32 0.0 against the plain version; general tiles "
              f"{sum(g for g, _ in backend.renderer.last_general_tiles)}; "
              f"rgba8 vs the JAX package's image {d_jax} (tolerance 0)")
        _check(d_jax == 0 and set(k for k, v in by_variant.items() if v)
               == {"gl"}, f"{name}: wrong image or instantiation")
    cross = reftest.ReftestHarness(scenes.GL_SMALL_SIZE, device="cuda",
                                   oracle_float32=True)
    for case in reftest.parse_reftest_manifest(scenes.GL_MANIFEST):
        if not fonts and any(_has_text(p)
                             for p in case.tests + [case.reference]):
            continue
        LaunchCounts.reset()
        r = harness.run_case(case)
        x = cross.run_case_cross(case)
        print(f"[12] {case.line}: {'pass' if r.passed else 'FAIL'} "
              f"({r.detail}); cross mode against the oracle in float32: "
              f"{'pass' if x.passed else 'FAIL'} ({x.detail}); plain-version "
              f"calls {LaunchCounts.plain_calls}")
        _check(r.passed and x.passed and LaunchCounts.plain_calls == 0,
               f"reftest {case.line}")
    print(f"[12] the harness's launches by instantiation: "
          f"{harness.engine_counts} and in cross mode {cross.engine_counts}")

    # (b) the 3840x2160 GL page, uncached
    (case,) = reftest.parse_reftest_manifest(scenes.GL_PAGE_MANIFEST)
    _check(case.gl_only and not case.skipped, f"the 4K GL line {case.line}")
    page = reftest.ReftestHarness(scenes.GL_PAGE_SIZE, device="cuda",
                                  oracle_float32=True)
    backend = _gl_document_backend(page, case.tests[0])
    r = backend.renderer
    r.picture_caching = False
    t0 = time.perf_counter()
    frame = backend.build_frame()
    build_ms = (time.perf_counter() - t0) * 1000.0
    counts = _pass_counts(frame.passes)
    drawn = int((frame.instances != 0).any(1).sum())
    _check(drawn == GL_PAGE_INSTANCES and counts == GL_PAGE_PASSES,
           f"4K GL page: {drawn} instances, passes {counts}")
    img, log, held, by_variant = _held_render(backend, "4K GL page")
    launches = _add_counts(launches, by_variant)
    for k, v in _errors_by_variant(held).items():
        errs[k] = max(errs.get(k, 0.0), v)
    root = log[-1]
    g_root, nt_root = r.last_general_tiles[-1]
    blends = sorted(set().union(*(e["blends"] for e in log)))
    (p,) = [q for q in merged_root_passes(frame) if q.target == TARGET_ROOT]
    d_u8 = _diff_u8(img, _rgba8(held[-1][2], p.nx, p.ny, 3840, 2160))
    print(f"[12] 4K GL page ({case.tests[0].name}): {drawn} instances "
          f"({frame.instances.shape[0]} rows), {len(frame.passes)} passes "
          f"{counts}; frame build {build_ms:.1f} ms; kernel launches "
          f"{len(held)} {by_variant}, each max diff f32 0.0 against the "
          f"plain version; blend ops {blends}; mask-clip dispatches "
          f"{sum(e['mask_clips'] for e in log)}; root pass "
          f"{tuple(root['dense'].shape[:2])} kinds {root['kinds']} blends "
          f"{root['blends']}, general tiles / tiles {g_root} / {nt_root}; "
          f"root rgba8 vs plain {d_u8} (tolerance 0)")
    _check(set(k for k, v in by_variant.items() if v) == {"gl"} and
           len(held) == counts["raster root"] + counts["raster surface"] and
           d_u8 == 0 and g_root > 0 and root["mask_clips"],
           "the 4K GL page did not take the gl build")
    _check(img.shape == (2160, 3840, 4) and bool(img.any()),
           "4K GL page: the image is wrong or empty")
    del held
    # the cross mode: the device image against the oracle in float32,
    # as run_case_cross holds it; then the oracle as it is
    t0 = time.perf_counter()
    x = page.run_case_cross(case)
    cross_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracle = backend.render_software()
    oracle_s = time.perf_counter() - t0
    d_oracle = int((oracle != img).any(2).sum())
    print(f"[12] 4K GL page, cross mode against the oracle in float32: "
          f"{'pass' if x.passed else 'FAIL'} ({x.detail}; {cross_s:.1f} s "
          f"with the render); against the oracle as it is: max diff "
          f"{_diff_u8(oracle, img)} at {d_oracle} pixels (its float64 "
          f"`where`s; {oracle_s:.1f} s on the host)")
    _check(x.passed and _diff_u8(oracle, img) <= 1 and
           d_oracle == GL_PAGE_ORACLE_PIXELS,
           "the 4K GL page differs from its oracle")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.render()
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    device_ms = _events_ms(lambda: r.render_device(frame), TIMED_FRAMES)
    by_pass = _pass_times(r, frame)
    print("[12] where the 4K GL page's uncached frame's time goes, by pass "
          "(host clock, synchronised around each pass, ms, count): " +
          ", ".join(f"{k} {v[0]:.3f} ({v[1]})" for k, v in
                    sorted(by_pass.items(), key=lambda kv: -kv[1][0])) +
          f"; card {smi}")
    page_times = _gl_root_times("4K GL page", root, smi)

    # picture caching on, held against the uncached image, then unchanged
    cached = _gl_document_backend(page, case.tests[0])
    rc = cached.renderer
    cimg, clog, cheld, c_by_variant = _held_render(cached, "4K GL cached")
    launches = _add_counts(launches, c_by_variant)
    LaunchCounts.reset()
    again = cached.render()
    print(f"[12] 4K GL page, picture caching on: kernel launches "
          f"{len(cheld)} {c_by_variant}, each max diff f32 0.0 against the "
          f"plain version; rgba8 vs uncached {_diff_u8(cimg, img)} "
          f"(tolerance 0); unchanged frame: launches "
          f"{LaunchCounts.launches}, rgba8 diff {_diff_u8(again, cimg)}")
    _check(_diff_u8(cimg, img) == 0 and c_by_variant["gl"] >= 1,
           "the cached 4K GL page differs from uncached")
    _check(LaunchCounts.launches == 0 and _diff_u8(again, cimg) == 0,
           "the unchanged 4K GL page did work")
    cframe = cached.build_frame()
    cached_ms = _events_ms(lambda: rc.render_device(cframe), TIMED_FRAMES)
    del cheld, clog
    print(f"[12] 4K GL page render_device: uncached {device_ms:.3f} ms, "
          f"cached unchanged frame {cached_ms:.3f} ms (CUDA events, mean of "
          f"{TIMED_FRAMES}); frame build {build_ms:.1f} ms (host); peak "
          f"memory {peak_mib:.0f} MiB (one uncached frame after the first); "
          f"card {smi}")

    # (c) bench's 4K browsing page and the 4K content page under gl_flavor
    for what, make in (("4K browsing page", scenes.build_4k_scene),
                       ("4K content page", scenes.build_4k_content_scene)):
        b = RenderBackend((3840, 2160), device="cuda",
                          resources=scenes.resource_cache())
        b.frame_builder.gl_flavor = True
        make(b)
        b.renderer.picture_caching = False
        img, log, held, by_variant = _held_render(b, f"{what} under gl")
        launches = _add_counts(launches, by_variant)
        for k, v in _errors_by_variant(held).items():
            errs[k] = max(errs.get(k, 0.0), v)
        root = log[-1]
        print(f"[12] {what} under gl_flavor, uncached: kernel launches "
              f"{len(held)} {by_variant}, each max diff f32 0.0 against the "
              f"plain version; root kinds {root['kinds']} blends "
              f"{root['blends']} mask_clips {root['mask_clips']}")
        _check(set(k for k, v in by_variant.items() if v) == {"gl"} and
               {7, 8} <= set(root["blends"]),
               f"{what}: the gl build did not draw its text")
        del held
        _gl_root_times(what, root, smi)
    print(f"[12] registers per instantiation {regs}; card {smi}")
    _check(len(regs) == 7, f"registers of {sorted(regs)}")
    return dict(by_variant=launches, errs=errs, root_ms=page_times["ms"],
                root_plain_ms=page_times["plain_ms"],
                root_bound_ms=page_times["bound_ms"],
                root_bound_by=page_times["bound_by"])

MESH_TIMEOUT = 480.0
MESH_PAGES = (("4K browsing page", "build_4k_scene"),
              ("4K effects page", "build_4k_effects_scene"))
MESH_STEPS = ("uncached", "cached", "scroll", "unchanged")


def _held_sharded(r, held):
    """Wrap mesh renderer `r`'s `_dispatch`: each dispatch's output held,
    right after it, against the unsharded kernel and the plain version on
    the records it read (later passes rewrite the mirrors and the surface
    atlas in place): (sharded, max diff against the unsharded kernel,
    against the plain version, instantiation) per dispatch into `held`.
    The comparison launches are not the mesh's: `ShardedCounts` does not
    count them."""
    import torch
    from webrender_tpu_torch.ops.tile_raster import (
        instantiation, render_tiles_dense, render_tiles_dense_plain)
    dispatch = r._dispatch
    r.dispatch_log = log = []

    def run(frame, tile_insts, *args, **kw):
        out = dispatch(frame, tile_insts, *args, **kw)
        e = {k: v for k, v in log.pop().items() if k != "tile_insts"}
        ref = render_tiles_dense(**e, host_checked=True)
        plain = render_tiles_dense_plain(**{
            k: v for k, v in e.items()
            if k not in ("general", "linear_cm", "polygon_clips")})
        torch.cuda.synchronize()
        _check(bool(torch.isfinite(out).all()), "non-finite tiles")
        held.append((tile_insts.shape[0] >= r.mesh.size,
                     float((out - ref).abs().max()),
                     float((out - plain).abs().max()),
                     instantiation(e["kinds"], e["blends"], e["mask_clips"],
                                   e["general"], e["step"], e["linear_cm"],
                                   e["polygon_clips"], e["gl"])))
        return out
    r._dispatch = run


def _margin_blurs(frame):
    """Blur passes whose region is smaller than their task: where the
    sharded blur's margin differs from blur_region's."""
    from webrender_tpu_torch.renderer.renderer import PASS_BLUR_H, PASS_BLUR_V
    return sum(1 for p in frame.passes
               if p.kind in (PASS_BLUR_H, PASS_BLUR_V)
               and p.blur_region is not None
               and tuple(p.blur_region) != tuple(p.src_region[2:]))


def _mesh_rank(mesh, smi):
    """Phase 13 on one rank of the mesh.  Every rank runs it in lockstep
    (the collectives are made in the same order on every rank); rank 0
    prints and returns the numbers."""
    import numpy as np
    import torch
    from webrender_tpu_torch import scenes
    from webrender_tpu_torch.ops.roofline import tile_raster_sharded_bound
    from webrender_tpu_torch.ops.tile_raster import (
        _launch, render_tiles_dense, render_tiles_dense_plain)
    from webrender_tpu_torch.parallel import mesh as mesh_mod
    from webrender_tpu_torch.render_backend import RenderBackend
    from webrender_tpu_torch.renderer import Renderer
    from webrender_tpu_torch.renderer.renderer import merged_root_passes
    counts = mesh_mod.ShardedCounts

    def say(msg):
        if mesh.rank == 0:
            print(f"[13] {msg}", flush=True)

    say(f"mesh: world size {mesh.size} over {mesh.backend}, one rank per "
        f"card, rank 0 on {mesh.device}; card {smi}")
    backends = {}
    for name, build in MESH_PAGES:
        pair = []
        for renderer in (Renderer(mesh.device),
                         Renderer(mesh.device, mesh=mesh)):
            b = getattr(scenes, build)(RenderBackend(
                (3840, 2160), renderer=renderer,
                resources=scenes.resource_cache()))
            b.renderer.picture_caching = False
            pair.append(b)
        held = []
        _held_sharded(pair[1].renderer, held)
        backends[name] = pair + [held]

    # the main path, counted: both pages over the mesh, uncached, then with
    # picture caching on: a first frame, a scroll step, an unchanged frame;
    # each against the unsharded render of the same state
    torch.cuda.synchronize()
    counts.reset()
    per_page = {name: dict.fromkeys(("launches", "blurs"), 0)
                for name in backends}
    for step in MESH_STEPS:
        for name, (ref_b, sh_b, held) in backends.items():
            for b in (ref_b, sh_b):
                if step == "cached":
                    b.renderer.picture_caching = True
                elif step == "scroll":
                    _scroll_to(b, 1)
            before = (counts.launches, counts.blurs, len(held))
            img = sh_b.render()
            want = ref_b.render()
            torch.cuda.synchronize()
            per_page[name]["launches"] += counts.launches - before[0]
            per_page[name]["blurs"] += counts.blurs - before[1]
            new = held[before[2]:]
            differ = int((img != want).any(-1).sum())
            margins = _margin_blurs(sh_b.last_frame)
            say(f"{name}, {step}: {len(new)} dispatches ("
                f"{sum(s for s, *_ in new)} sharded, the others below the "
                f"mesh size), max diff f32 against the unsharded kernel "
                f"{max([d for _, d, _, _ in new], default=0.0)} and the "
                f"plain version {max([d for _, _, d, _ in new], default=0.0)}"
                f"; sharded blurs {counts.blurs - before[1]}, blur passes "
                f"with a margin {margins}; rgba8 pixels apart from the "
                f"unsharded render {differ} (tolerance 0)")
            _check(all(d == 0.0 for _, d, _, _ in new) and
                   all(d == 0.0 for _, _, d, _ in new),
                   f"{name}, {step}: a sharded dispatch disagrees")
            _check(differ == 0, f"{name}, {step}: the sharded image "
                                f"differs in {differ} pixels")
            _check(img.shape == (2160, 3840, 4) and bool(img.any()),
                   f"{name}, {step}: the image is wrong or empty")
            if step == "unchanged":
                _check(not new, f"{name}: the unchanged frame launched")
    launches, by_variant = counts.launches, dict(counts.by_instantiation)
    blurs, halos = counts.blurs, counts.halo_exchanges
    held_all = [h for _, _, held in backends.values() for h in held]
    err_kernel = max(d for _, d, _, _ in held_all)
    err_plain = max(d for _, _, d, _ in held_all)
    crossed = "yes" if mesh.size > 1 else \
        "none (one card: the gather stays on it, no halo row crosses)"
    say(f"main path over the mesh: sharded launches {launches} by "
        f"instantiation { {k: v for k, v in by_variant.items() if v} }, "
        f"by page {per_page}; sharded blurs {blurs}, halo exchanges "
        f"{halos}; cross-card exchange: {crossed}")
    for name in backends:
        _check(per_page[name]["launches"] > 0,
               f"{name}: no dispatch ran sharded")
    _check(per_page["4K effects page"]["blurs"] > 0, "no blur ran sharded")
    for name, (ref_b, sh_b, held) in backends.items():
        del sh_b.renderer._dispatch
        sh_b.renderer.dispatch_log = None
        held.clear()

    # times: the browsing page's merged root pass sharded, its shard's
    # kernel, the gather, the unsharded kernel and the plain version
    ref_b, sh_b, _ = backends["4K browsing page"]
    r = sh_b.renderer
    r.picture_caching = ref_b.renderer.picture_caching = False
    frame = sh_b.build_frame()
    (p,) = merged_root_passes(frame)
    args = r.kernel_args(frame, p)
    nt = p.tile_insts.shape[0]
    per = -(-nt // mesh.size)
    lo = min(mesh.rank * per, nt)
    hi = min(lo + per, nt)
    shard = dict(args, **{k: mesh_mod._shard(args[k], lo, hi, per) for k in
                          ("dense", "tile_counts", "tile_origins")})
    kw = {k: args[k] for k in ("kinds", "blends", "mask_clips", "general",
                               "step", "linear_cm", "polygon_clips", "gl")}
    plain_kw = {k: kw[k] for k in ("kinds", "blends", "mask_clips", "step",
                                   "gl")}
    positional = ("dense", "tile_counts", "tile_origins", "clear_color",
                  "f32_rows", "alpha_atlas", "surface_atlas", "color_atlas")
    full_args = [args[k] for k in positional]
    shard_args = [shard[k] for k in positional]
    part = render_tiles_dense(*shard_args, **kw)
    sharded_ms = _events_ms(lambda: mesh_mod.render_tiles_pallas_sharded(
        mesh, **args, host_checked=True), TIMED_FRAMES)
    kernel_ms = _events_ms(lambda: _launch(*shard_args, **kw), TIMED_FRAMES)
    gather_ms = _events_ms(lambda: mesh_mod._gather(mesh, part),
                           TIMED_FRAMES)
    unsharded_ms = _events_ms(lambda: _launch(*full_args, **kw),
                              TIMED_FRAMES)
    plain_ms = _events_ms(lambda: render_tiles_dense_plain(
        *full_args, **plain_kw), 3, warmup=1)
    bound_ms, bound_by, ops, nbytes = tile_raster_sharded_bound(
        shard["dense"], shard["tile_counts"], shard["tile_origins"],
        args["f32_rows"], nt, mask_clips=kw["mask_clips"])
    say(f"browsing root {tuple(p.tile_insts.shape)} over {mesh.size} "
        f"ranks ({per} tiles a rank): sharded dispatch {sharded_ms:.3f} ms; "
        f"alone, this rank's kernel {kernel_ms:.3f} ms and the gather of "
        f"{nt}x4x64x128 f32 {gather_ms:.3f} ms (CUDA events, "
        f"{TIMED_FRAMES} calls each); unsharded kernel {unsharded_ms:.3f} "
        f"ms in the same call; plain version {plain_ms:.1f} ms; bound of "
        f"the rank's part {bound_ms:.4f} ms set by {bound_by} ({ops:.4g} "
        f"operations, {nbytes:.4g} bytes: the shard's inputs and the "
        f"gathered output); card {smi}")

    # each page uncached: render_device sharded and unsharded, the blur
    # passes' host time, peak memory of a sharded frame
    for name, (ref_b, sh_b, _) in backends.items():
        for b in (ref_b, sh_b):
            b.renderer.picture_caching = False
        frame = sh_b.build_frame()
        ref_frame = ref_b.build_frame()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held_mib = torch.cuda.memory_allocated() / 2 ** 20
        sh_b.renderer.render_device(frame)
        torch.cuda.synchronize()
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        dev_sh = _events_ms(lambda: sh_b.renderer.render_device(frame), 5)
        dev_ref = _events_ms(
            lambda: ref_b.renderer.render_device(ref_frame), 5)
        blur = {}
        for what, b, f in (("sharded", sh_b, frame),
                           ("unsharded", ref_b, ref_frame)):
            t = _pass_times(b.renderer, f)
            blur[what] = sum(t.get(k, (0.0, 0))[0]
                             for k in ("blur_h", "blur_v"))
        say(f"{name}, uncached: render_device {dev_sh:.3f} ms over the "
            f"mesh against {dev_ref:.3f} ms unsharded (CUDA events, mean "
            f"of 5); blur passes {blur['sharded']:.3f} against "
            f"{blur['unsharded']:.3f} ms (host clock, synchronised around "
            f"each pass); peak memory {peak_mib:.0f} MiB over one sharded "
            f"frame, of which {held_mib:.0f} MiB held before it (both "
            f"pages' mesh renderers and unsharded twins on this rank's "
            f"card); card {smi}")
    return dict(world=mesh.size, launches=launches, by_variant=by_variant,
                blurs=blurs, halos=halos, err=max(err_kernel, err_plain),
                err_kernel=err_kernel, err_plain=err_plain, ms=sharded_ms,
                kernel_ms=kernel_ms, gather_ms=gather_ms,
                unsharded_ms=unsharded_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                cross_card=mesh.size > 1)


def phase13_mesh_path(smi):
    """The multi-device path: the mesh of every card of the machine (one
    rank each, over NCCL), both 4K pages rendered over it."""
    import torch
    from webrender_tpu_torch.parallel.dryrun import run_ranks
    n = torch.cuda.device_count()
    torch.cuda.empty_cache()
    sys.stdout.flush()
    return run_ranks(_mesh_rank, n, "cuda", args=(smi,),
                     timeout=MESH_TIMEOUT)[0]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import webrender_tpu_torch  # noqa: F401  (fails outside the repo)
    smi = phase1_toolchain()
    regs, spills = phase2_build()
    phase3_small_frames()
    uncached_img, browsing = phase4_main_path(smi)
    default = phase5_default_path(smi, uncached_img)
    effects = phase6_effects_path(smi)
    content = phase7_content_path(smi, regs)
    zoomed = phase8_zoomed_path(smi, regs)
    transformed = phase9_transformed_path(smi, regs)
    svg = phase10_svg_path(smi, regs)
    css3d = phase11_css3d_path(smi, regs)
    gl = phase12_gl_reftests(smi, regs)
    mesh = phase13_mesh_path(smi)
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
    _check(not loaded, f"JAX was imported: {loaded[:5]}")
    launches = _add_counts(browsing["by_variant"], default["by_variant"],
                           effects["by_variant"], content["by_variant"],
                           zoomed["by_variant"], transformed["by_variant"],
                           svg["by_variant"], css3d["by_variant"],
                           gl["by_variant"])
    errs = {}
    for e in (effects["errs"], content["errs"], zoomed["errs"],
              transformed["errs"], svg["errs"], css3d["errs"], gl["errs"],
              {"browsing": max(browsing["err"], default["init_err"])}):
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
    # each instantiation timed on the main path's dispatch it serves: the
    # merged 4K browsing pass, the 4K effects root pass, the 4K content
    # root pass, the 4K zoomed root pass at zoom 1.25, the 4K transformed
    # page's root pass, the 4K SVG-filter page's heaviest filter dispatch,
    # the 4K GL page's root pass
    timed = {"browsing": (browsing["ms"], browsing["plain_ms"],
                          browsing["bound_ms"], browsing["bound_by"]),
             "surface": (effects["root_ms"], effects["root_plain_ms"],
                         effects["root_bound_ms"], effects["root_bound_by"]),
             "content": (content["root_ms"], content["root_plain_ms"],
                         content["root_bound_ms"], content["root_bound_by"]),
             "media": (zoomed["root_ms"], zoomed["root_plain_ms"],
                       zoomed["root_bound_ms"], zoomed["root_bound_by"]),
             "general": (transformed["root_ms"], transformed["root_plain_ms"],
                         transformed["root_bound_ms"],
                         transformed["root_bound_by"]),
             "filter": (svg["root_ms"], svg["root_plain_ms"],
                        svg["root_bound_ms"], svg["root_bound_by"]),
             "gl": (gl["root_ms"], gl["root_plain_ms"], gl["root_bound_ms"],
                    gl["root_bound_by"])}
    kernels = []
    for variant, (ms, plain_ms, bound_ms, bound_by) in timed.items():
        _check(launches.get(variant, 0) >= 1,
               f"the {variant} instantiation was not launched")
        kernels.append(dict(
            name=f"tile_raster[{variant}]", route="cuda",
            source="webrender_tpu_torch/csrc/tile_raster.cu",
            replaces="webrender_tpu/ops/pallas/tile_raster.py:1175",
            launches=launches[variant], max_abs_err=errs.get(variant, 0.0),
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, registers=regs[variant],
            spill_bytes=spills[variant]))
    kernels[0].update(
        init_tiles_launches=default["init_launches"],
        init_tiles_max_abs_err=default["init_err"],
        init_tiles_ms=default["init_ms"],
        init_tiles_plain_ms=default["init_plain_ms"],
        init_tiles_bound_ms=default["init_bound_ms"],
        init_tiles_bound_by=default["init_bound_by"])
    kernels[4].update(
        css3d_launches=css3d["by_variant"].get("general", 0),
        css3d_root_ms=css3d["root_ms"],
        css3d_root_plain_ms=css3d["root_plain_ms"],
        css3d_root_bound_ms=css3d["root_bound_ms"],
        css3d_root_bound_by=css3d["root_bound_by"])
    kernels[1].update(picture_launches_by_path={
        "effects_uncached": effects["pictures"],
        "effects_default": effects["cached_pictures"]})
    # K9: the sharded dispatch (the rank's shard on the kernel, then the
    # gather), timed on the 4K browsing page's merged root pass
    _check(mesh["launches"] >= 1, "no dispatch ran sharded")
    kernels.append(dict(
        name="render_tiles_pallas_sharded", route="cuda",
        source="webrender_tpu_torch/parallel/mesh.py",
        replaces="webrender_tpu/parallel/mesh.py:116",
        launches=mesh["launches"], max_abs_err=mesh["err"], ms=mesh["ms"],
        plain_ms=mesh["plain_ms"], bound_ms=mesh["bound_ms"],
        bound_by=mesh["bound_by"], library_ms=None, world_size=mesh["world"],
        cross_card=mesh["cross_card"],
        launches_by_instantiation={k: v for k, v in
                                   mesh["by_variant"].items() if v},
        max_abs_err_vs_unsharded=mesh["err_kernel"],
        kernel_ms_per_rank=mesh["kernel_ms"], gather_ms=mesh["gather_ms"],
        unsharded_ms=mesh["unsharded_ms"], sharded_blurs=mesh["blurs"],
        halo_exchanges=mesh["halos"]))
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
