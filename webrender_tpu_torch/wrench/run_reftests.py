"""Runs reftest manifests through the port's harness. Usage:
  python -m webrender_tpu_torch.wrench.run_reftests
      [--engine device|oracle|cross] [--platform swgl|linux|union]
      [--suite NAME ...] [--base DIR] [--manifest PATH]
      [--device cuda|cpu] [--window-size WxH] [-v] [--json OUT.json]

The counterpart of the JAX package's `run_reftests.py`, over
`wrench/reftest.py::ReftestHarness` on `--device` (the card by default;
`--device cpu` runs the renderer's dispatches on the kernel's plain
version).  The engine is the renderer (`device`) unless the caller asks
for the numpy oracle (`oracle`) or both (`cross`).  The same lines are
printed and the JSON artifact has the same keys: per suite
pass/fail/skip, every failure with its detail, every skip with its
reason, and (device and cross engines) the harness's launches by the
kernel's instantiation.

`--base` is the upstream corpus's `wrench/reftests` directory, one suite a
subdirectory, as `run_reftests.py` reads it; the corpus is not in the
repository; a suite without a manifest there is passed over.
`--manifest` runs one manifest instead, and the run fails when it does
not exist; for example the port's own GL-flavoured documents:

    python -m webrender_tpu_torch.wrench.run_reftests \\
        --manifest webrender_tpu_torch/testdata/wrench/reftest.list \\
        --window-size 512x256
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from .reftest import (PLATFORM_SETS, ReftestHarness, parse_reftest_manifest,
                      summarize)

SUITES = ["aa", "backface", "blend", "border", "boxshadow", "clip",
          "compositor-surface", "crash", "filters", "gradient", "image",
          "mask", "performance", "scrolling", "snap", "split", "text",
          "tiles", "transforms"]
BASE = Path("/root/reference/wrench/reftests")
WINDOW_SIZE = (1920, 1080)


def window_size(text: str):
    """'WxH' -> (W, H)."""
    w, h = text.lower().split("x")
    return int(w), int(h)


def cuda_missing(device: str) -> bool:
    """True, with a message on stderr, when `device` is a card and the
    machine has none: the runners fail rather than run on the CPU."""
    if torch.device(device).type != "cuda" or torch.cuda.is_available():
        return False
    print("CUDA is not available (--device cpu runs on the CPU)",
          file=sys.stderr)
    return True


def parser():
    ap = argparse.ArgumentParser(
        description="Run reftest manifests through the port's harness.")
    ap.add_argument("--engine", default="device",
                    choices=("device", "oracle", "cross"),
                    help="device (default) | oracle | cross (cross = "
                         "render every case on BOTH engines and "
                         "bitwise-compare device output to the oracle)")
    ap.add_argument("--platform", default="union",
                    choices=sorted(PLATFORM_SETS),
                    help="which reference CI configuration to replicate: "
                         "'swgl' = the software-run semantics, 'linux' = "
                         "the GL-run semantics, 'union' (default) = every "
                         "line either configuration runs")
    ap.add_argument("--suite", nargs="*", default=SUITES)
    ap.add_argument("--base", type=Path, default=BASE,
                    help="the corpus's reftests directory, one suite a "
                         "subdirectory")
    ap.add_argument("--manifest", type=Path, default=None,
                    help="run this one manifest instead of the suites")
    ap.add_argument("--device", default="cuda",
                    help="the renderer's device: the card by default, "
                         "'cpu' on request")
    ap.add_argument("--window-size", type=window_size, default=WINDOW_SIZE,
                    help="the documents' window, WxH (wrench's default "
                         "1920x1080)")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--json", default=None)
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.manifest is not None and not args.manifest.is_file():
        ap.error(f"no manifest at {args.manifest}")
    if cuda_missing(args.device):
        return 2
    harness = ReftestHarness(args.window_size, engine=args.engine,
                             device=args.device)
    if args.manifest is not None:
        manifests = [(args.manifest.parent.name, args.manifest)]
    else:
        manifests = [(suite, args.base / suite / "reftest.list")
                     for suite in args.suite]
    grand = [0, 0, 0]
    suites_out = []
    for suite, manifest in manifests:
        if not manifest.exists():
            continue
        t0 = time.time()
        run1 = harness.run_case_cross if args.engine == "cross" \
            else harness.run_case
        results = [run1(c)
                   for c in parse_reftest_manifest(
                       manifest, PLATFORM_SETS[args.platform])]
        p, f, s = summarize(results)
        grand[0] += p
        grand[1] += f
        grand[2] += s
        dt = time.time() - t0
        print(f"{suite:22s} pass={p:3d} fail={f:3d} skip={s:3d}"
              f"  ({dt:.1f}s)", flush=True)
        fails = [{"line": r.case.line[:120], "detail": r.detail[:160]}
                 for r in results if not r.passed]
        skips = {}
        for r in results:
            if r.skipped:
                skips[r.detail] = skips.get(r.detail, 0) + 1
        suites_out.append({"suite": suite, "pass": p, "fail": f, "skip": s,
                           "seconds": round(dt, 1), "failures": fails,
                           "skip_reasons": skips})
        if args.verbose:
            for r in results:
                if not r.passed:
                    print(f"   FAIL {r.case.line[:90]} | {r.detail[:110]}")
    print(f"{'TOTAL':22s} pass={grand[0]} fail={grand[1]} skip={grand[2]}")
    if args.engine in ("device", "cross"):
        print(f"engine mix: {harness.engine_counts}")
    if args.json:
        with open(args.json, "w") as fjs:
            json.dump({"engine": args.engine,
                       "platform": args.platform,
                       "total": {"pass": grand[0], "fail": grand[1],
                                 "skip": grand[2]},
                       "engine_mix": harness.engine_counts,
                       "suites": suites_out}, fjs, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
