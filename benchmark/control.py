"""The control of the comparison that decides `correct`: the plain
reference with every colour and texel kept to 4 bits a channel
(`reference.control_quantize`, the precision below the 8 bits the
configurations state), put in the program's place and compared with the
reference at the cell's own size.  It must come out not correct; its
smallest readings are the upper ends that the limits in `limits/` sit
below.  The benchmark's runs do not run it.

    python3 benchmark/control.py --workload motionmark_images.putimagedata \\
        --seeds 1,2,3 --frames 2

prints, per seed and frame, `pixels_off` and `max_step` of the control,
and the smallest of each over them all as a last JSON line.  The frames
are the one a run draws from the seed and then frames 50 apart, made by
the traffic generator alone (no program, no card).
"""
import argparse
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402
import reference  # noqa: E402
import refcheck  # noqa: E402
import traffic as traffic_mod  # noqa: E402


def readings(cell, seed: int, frames: int):
    """[(frame, {name: value})] of the control on `seed`."""
    t = traffic_mod.Traffic(cell.config, cell.mix, seed, cell.home)
    first = harness.compared_frame(cell, seed)
    wanted = [first + 50 * i for i in range(frames)]
    out = []
    while t.k < wanted[-1]:
        t.step()
        if t.k in wanted:
            ref = reference.compose(t.state, reference.identity, cell.home)
            ctl = reference.compose(t.state, reference.control_quantize,
                                    cell.home)
            out.append((t.k, refcheck.measure(ctl, ref)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--frames", type=int, default=2)
    args = ap.parse_args(argv)
    cell = harness.resolve(args.workload)
    least = {n: None for n in refcheck.NAMES}
    for seed in (int(s) for s in args.seeds.split(",")):
        for k, got in readings(cell, seed, args.frames):
            print(f"{args.workload} seed {seed} frame {k}: "
                  + ", ".join(f"{n} {v}" for n, v in got.items()),
                  flush=True)
            for n, v in got.items():
                least[n] = v if least[n] is None else min(least[n], v)
    print(json.dumps({"workload": args.workload, "control_least": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
