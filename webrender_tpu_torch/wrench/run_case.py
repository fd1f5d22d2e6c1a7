"""Runs the reftest cases whose manifest line holds a substring. Usage:
  python -m webrender_tpu_torch.wrench.run_case SUITE SUBSTR [SUBSTR ...]
      [--engine=device|oracle] [--base=DIR] [--device=cuda|cpu]
      [--window-size=WxH]
  python -m webrender_tpu_torch.wrench.run_case --manifest=PATH
      [SUBSTR ...] [...]

The counterpart of the JAX package's `tools/run_case.py`, over the port's
`ReftestHarness` on `--device` (the card by default), with the
renderer as its engine unless `--engine=oracle` asks for the numpy
oracle.  Each selected case prints one line, PASS, SKIP or FAIL with its
detail; the exit code is 1 when a case failed (2 when the card is asked
for and there is none, or the manifest does not exist).  With
`--manifest` every positional argument is a substring and the suite is
the manifest's; with no substring every case runs.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .reftest import ReftestHarness, parse_reftest_manifest
from .run_reftests import BASE, WINDOW_SIZE, cuda_missing, window_size


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Run the reftest cases whose line holds a substring.")
    ap.add_argument("words", nargs="*",
                    help="SUITE SUBSTR ..., or SUBSTR ... with --manifest")
    ap.add_argument("--engine", default="device",
                    choices=("device", "oracle"))
    ap.add_argument("--base", type=Path, default=BASE)
    ap.add_argument("--manifest", type=Path, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--window-size", type=window_size, default=WINDOW_SIZE)
    args = ap.parse_args(argv)
    if args.manifest is not None:
        manifest, subs = args.manifest, args.words
    else:
        if not args.words:
            ap.error("a SUITE is needed without --manifest")
        manifest = args.base / args.words[0] / "reftest.list"
        subs = args.words[1:]
    if not manifest.is_file():
        ap.error(f"no manifest at {manifest}")
    if cuda_missing(args.device):
        return 2
    harness = ReftestHarness(args.window_size, engine=args.engine,
                             device=args.device)
    n_fail = 0
    for c in parse_reftest_manifest(manifest):
        if subs and not any(s in c.line for s in subs):
            continue
        r = harness.run_case(c)
        status = "PASS" if r.passed else ("SKIP" if r.skipped else "FAIL")
        if not r.passed and not r.skipped:
            n_fail += 1
        print(f"{status} {c.line[:100]} | {r.detail[:140]}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
