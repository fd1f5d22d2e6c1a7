#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (webrender_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA tile-raster kernel into build/ and runs four phases,
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
   times.

The line before the last is nvidia-smi's name and power limit; the last
line is {"ok": true, "device": {...}}.  Any failure exits non-zero with
no such line, as does a machine without CUDA.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# the main path's frame at 4K (bench.py defaults): instances, merged pass
EXPECT_INSTANCES = 4096
EXPECT_PASS = (1020, 128)
EXPECT_KINDS = (0, 2, 10, 13)
EXPECT_BLENDS = (0, 7, 8)
TIMED_FRAMES = 20


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
    regs = [ln.strip() for ln in _build.build_log.splitlines()
            if "registers" in ln]
    print(f"[2] kernel built in {build_s:.3f} s ({_build.library_path().name})"
          + (f": {regs[0]}" if regs else ""))


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
    r.dispatch_log = None
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    inp = {k: log[-1][k] for k in ("kinds", "blends", "alpha_atlas",
                                   "surface_atlas", "color_atlas")}
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
    kw = dict(kinds=inp["kinds"], blends=inp["blends"])
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
    launch_args = _args(inp)[:5] + (inp["color_atlas"],)
    kernel_ms = _events_ms(lambda: _launch(*launch_args), TIMED_FRAMES)
    plain_ms = _events_ms(lambda: render_tiles_dense_plain(*_args(inp), **kw),
                          TIMED_FRAMES, warmup=1)
    device_ms = _events_ms(lambda: r.render_device(frame), TIMED_FRAMES)
    t0 = time.perf_counter()
    for _ in range(5):
        backend.render()
    render_ms = (time.perf_counter() - t0) * 1000.0 / 5
    print(f"[4] times over {TIMED_FRAMES} frames after warm-up: kernel "
          f"{kernel_ms:.3f} ms, plain version {plain_ms:.3f} ms, "
          f"render_device {device_ms:.3f} ms, render() with readback "
          f"{render_ms:.3f} ms; peak memory {peak_mib:.0f} MiB; "
          f"card {smi}")
    return img, dict(name="tile_raster", route="cuda",
                     source="webrender_tpu_torch/csrc/tile_raster.cu",
                     replaces="webrender_tpu/ops/pallas/tile_raster.py:1175",
                     launches=launches, max_abs_err=max_abs_err,
                     ms=kernel_ms, plain_ms=plain_ms)


def _scroll_to(backend, tick):
    """bench.py's dirty(): the feed (scroll id 777) at 7 px per tick."""
    from webrender_tpu.api import Point2D
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
    plain_kw = {k: v for k, v in cont.items() if k not in ("mask_clips",
                                                           "gl")}
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
                   cont["clear_color"], cont["f32_rows"],
                   cont["color_atlas"], cont["init_tiles"])
    init_ms = _events_ms(lambda: _launch(*launch_args), TIMED_FRAMES)
    print(f"[5] continuation pass {tuple(cont['dense'].shape[:2])}: kernel "
          f"with init_tiles vs plain max diff f32 {init_err} rgba8 {d_u8} "
          f"(tolerance 0); kernel {init_ms:.3f} ms (CUDA events, "
          f"{TIMED_FRAMES} launches), plain version {init_plain_ms:.1f} ms "
          f"(one run); card {smi}")
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
    return dict(launches=launches, init_launches=init_launches,
                init_err=init_err, init_ms=init_ms,
                init_plain_ms=init_plain_ms)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import webrender_tpu_torch  # noqa: F401  (fails outside the repo)
    smi = phase1_toolchain()
    phase2_build()
    phase3_small_frames()
    uncached_img, kernel = phase4_main_path(smi)
    default = phase5_default_path(smi, uncached_img)
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
    _check(not loaded, f"JAX was imported: {loaded[:5]}")
    kernel.update(
        launches_by_path={"uncached": kernel["launches"],
                          "default": default["launches"]},
        launches=kernel["launches"] + default["launches"],
        max_abs_err=max(kernel["max_abs_err"], default["init_err"]),
        init_tiles_launches=default["init_launches"],
        init_tiles_max_abs_err=default["init_err"],
        init_tiles_ms=default["init_ms"],
        init_tiles_plain_ms=default["init_plain_ms"])
    print(json.dumps({"kernels": [kernel]}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
