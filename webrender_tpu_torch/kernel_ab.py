"""Kernel times, registers and spills of several source trees, in one process
tree.

    python -m webrender_tpu_torch.kernel_ab TREE [TREE ...]

Each TREE is the root of a checkout that holds `webrender_tpu_torch/` (the
repository root, or an unpacked older commit).  For each, in the order
given, a child process started in that tree builds its CUDA tile-raster
kernel, reads ptxas's registers and spill bytes per instantiation, renders
the 4K pages on the card and times the kernel on one dispatch of every
instantiation with CUDA events (20 launches after 2, three times), and
holds each against the plain version (its max abs diff is printed):

* browsing: bench's page, the merged root pass (uncached), and its
  continuation pass over init tiles (the default path's first frame);
* surface: the effects page's root pass; content: the content page's;
  media: the zoomed page's at zoom 1.25; general: the transformed page's
  and the CSS-3D page's;
* filter: the SVG-filter page's heaviest filter dispatch (the most
  records);
* gl: the 4K GL reftest page's root pass, under gl_flavor.

It prints one JSON line per tree and, last, nvidia-smi's name and power
limit.  Give the trees as parent, change,
change, parent to compare two versions on the same card in one call.
"""
import json
import os
import subprocess
import sys

CHILD = r'''
import json, re, sys
import torch
from webrender_tpu_torch import scenes
from webrender_tpu_torch.ops import _build
from webrender_tpu_torch.ops.tile_raster import (
    _launch, instantiation, render_tiles_dense_plain)
from webrender_tpu_torch.render_backend import RenderBackend

_build.load()
flags = {("0", "0", "0", "0", "0"): "browsing",
         ("1", "0", "0", "0", "0"): "surface",
         ("1", "1", "0", "0", "0"): "content",
         ("1", "1", "1", "0", "0"): "media",
         ("1", "1", "1", "1", "0"): "general",
         ("1", "1", "1", "1", "1"): "filter"}
# the template flags as ptxas names them: five in older trees, six (kGl)
# since the gl build, seven (kBorder last) since the border build; each
# entry's spill bytes and registers
regs, spills = {}, {}
for fl, st, ld, n in re.findall(
        r"Compiling entry function '[^']*tile_raster_kernelI((?:Lb[01]E)+)E"
        r".*?(\d+) bytes spill stores, (\d+) bytes spill loads"
        r".*?Used (\d+) registers", _build.build_log, re.S):
    bits = tuple(re.findall(r"Lb([01])E", fl))
    name = "gl" if bits[5:6] == ("1",) else \
        "border" if bits[6:] == ("1",) else flags[bits[:5]]
    regs[name] = int(n)
    spills[name] = int(st) + int(ld)


def backend(make, **kw):
    b = make(RenderBackend((3840, 2160), device="cuda",
                           resources=scenes.resource_cache()), **kw)
    b.renderer.picture_caching = False
    return b


def logged(b):
    b.renderer.dispatch_log = log = []
    b.render()
    b.renderer.dispatch_log = None
    return log


def timed(e, want):
    args = (e["dense"], e["tile_counts"], e["tile_origins"],
            e["clear_color"], e["f32_rows"], e["alpha_atlas"],
            e["surface_atlas"], e["color_atlas"], e["init_tiles"])
    kw = dict(kinds=e["kinds"], blends=e["blends"],
              mask_clips=e["mask_clips"], step=e["step"])
    extra = {k: e[k] for k in ("general", "linear_cm", "polygon_clips", "gl")
             if k in e}
    got = instantiation(e["kinds"], e["blends"], e["mask_clips"],
                        step=e["step"], **extra)
    assert got == want, (got, want)
    out = []
    for _ in range(3):
        for _ in range(2):
            _launch(*args, **kw, **extra)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            _launch(*args, **kw, **extra)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / 20)
    res = {"ms": out, "shape": list(e["dense"].shape[:2]),
           "records": int(e["tile_counts"].sum())}
    ref = render_tiles_dense_plain(*args, **kw, gl=extra.get("gl", False))
    res["max_abs_err"] = float((_launch(*args, **kw, **extra) - ref)
                               .abs().max())
    return res


def gl_root():
    from webrender_tpu_torch.wrench import reftest
    from webrender_tpu_torch.wrench.yaml_reader import YamlFrameReader
    (case,) = reftest.parse_reftest_manifest(scenes.GL_PAGE_MANIFEST)
    page = reftest.ReftestHarness(scenes.GL_PAGE_SIZE, device="cuda")
    b = page._backend(None, None, True)
    YamlFrameReader(case.tests[0], page.window_size).build(b)
    b.renderer.picture_caching = False
    return logged(b)[-1]


def heaviest_filter(log):
    filt = [e for e in log if instantiation(
        e["kinds"], e["blends"], e["mask_clips"], e["general"], e["step"],
        e["linear_cm"]) == "filter"]
    return max(filt, key=lambda e: (int(e["tile_counts"].sum()),
                                    e["dense"].shape[0]))


def continuation():
    b = scenes.build_4k_scene(RenderBackend(
        (3840, 2160), device="cuda", resources=scenes.resource_cache()))
    e = logged(b)[2]
    assert e["init_tiles"] is not None
    return e


times = {}
for name, want, get in (
        ("browsing_merged", "browsing",
         lambda: logged(backend(scenes.build_4k_scene))[-1]),
        ("browsing_continuation", "browsing", continuation),
        ("effects_root", "surface",
         lambda: logged(backend(scenes.build_4k_effects_scene))[-1]),
        ("content_root", "content",
         lambda: logged(backend(scenes.build_4k_content_scene))[-1]),
        ("zoomed_root", "media",
         lambda: logged(backend(scenes.build_4k_zoomed_scene))[-1]),
        ("transformed_root", "general",
         lambda: logged(backend(scenes.build_4k_transformed_scene))[-1]),
        ("css3d_root", "general",
         lambda: logged(backend(scenes.build_4k_3d_scene))[-1]),
        ("svg_filter_dispatch", "filter",
         lambda: heaviest_filter(logged(backend(scenes.build_4k_svg_scene)))),
        ("gl_page_root", "gl", gl_root)):
    times[name] = timed(get(), want)
    torch.cuda.empty_cache()
print(json.dumps({"tree": sys.argv[1], "registers": regs,
                  "spill_bytes": spills, "times": times}))
'''


def main(trees):
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in trees:
        tree = os.path.abspath(tree)
        out = subprocess.run([sys.executable, "-c", CHILD, tree], cwd=tree,
                             env=dict(os.environ, PYTHONPATH=tree),
                             capture_output=True, text=True, timeout=1200)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
