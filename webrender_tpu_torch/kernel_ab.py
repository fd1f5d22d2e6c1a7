"""Kernel times and registers of several source trees, in one process tree.

    python -m webrender_tpu_torch.kernel_ab TREE [TREE ...]

Each TREE is the root of a checkout that holds `webrender_tpu_torch/` (the
repository root, or an unpacked older commit).  For each, in the order
given, a child process started in that tree builds its CUDA tile-raster
kernel, reads ptxas's registers per instantiation, renders the 4K browsing
page and the 4K transformed page uncached on the card, and times the
kernel on each page's root dispatch with CUDA events (20 launches after
2, three times).  It prints one JSON line per tree and, last, nvidia-smi's
name and power limit.  Give the trees as parent, change, change, parent to
compare two versions on the same card in one call.
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
from webrender_tpu_torch.ops.tile_raster import _launch
from webrender_tpu_torch.render_backend import RenderBackend

_build.load()
flags = {("0", "0", "0", "0", "0"): "browsing",
         ("1", "0", "0", "0", "0"): "surface",
         ("1", "1", "0", "0", "0"): "content",
         ("1", "1", "1", "0", "0"): "media",
         ("1", "1", "1", "1", "0"): "general",
         ("1", "1", "1", "1", "1"): "filter"}
regs = {flags[m[:5]]: int(m[5]) for m in re.findall(
    r"tile_raster_kernelILb([01])ELb([01])ELb([01])ELb([01])ELb([01])E"
    r".*?Used (\d+) registers", _build.build_log, re.S)}


def timed(make):
    b = make(RenderBackend((3840, 2160), device="cuda",
                           resources=scenes.resource_cache()))
    b.renderer.picture_caching = False
    b.renderer.dispatch_log = log = []
    b.render()
    e = log[-1]
    args = (e["dense"], e["tile_counts"], e["tile_origins"],
            e["clear_color"], e["f32_rows"], e["alpha_atlas"],
            e["surface_atlas"], e["color_atlas"])
    kw = dict(kinds=e["kinds"], blends=e["blends"],
              mask_clips=e["mask_clips"], general=e["general"],
              step=e["step"])
    out = []
    for _ in range(3):
        for _ in range(2):
            _launch(*args, **kw)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            _launch(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / 20)
    return out


print(json.dumps({"tree": sys.argv[1], "registers": regs,
                  "browsing_merged_ms": timed(scenes.build_4k_scene),
                  "transformed_root_ms": timed(
                      scenes.build_4k_transformed_scene)}))
'''


def main(trees):
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in trees:
        tree = os.path.abspath(tree)
        out = subprocess.run([sys.executable, "-c", CHILD, tree], cwd=tree,
                             env=dict(os.environ, PYTHONPATH=tree),
                             capture_output=True, text=True, timeout=900)
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
