"""The benchmark of `webrender_tpu_torch` on one H100: closed-loop frames.

    python3 benchmark/run.py --workload motionmark_images.putimagedata \\
        --seed 7 --seconds 10 --trace 0

runs the cell named in `BENCHMARK.json` for `--seconds` of frames and
prints one JSON line on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer metrics), `device` and, last, `checks` (each number
compared with its limit, which also end standard error).  It runs from
the root of a checkout that holds the program; it exits non-zero and
prints no result where there is no CUDA card, fewer cards than the cell
asks for, no program, or where JAX, Flax or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ.setdefault("USE_FLAX", "0")
# one process with few threads: the program's host work runs on the main
# thread, and idle pools of numerical libraries only take cores from it
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def log(msg):
    print(f"[benchmark] {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr,
          flush=True)


def card() -> str:
    """nvidia-smi's name and power limit of the cards, for the log."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def pin_to_one_core():
    """Keeps the run, and the threads it starts, on the last core it may
    use: the program's host work is one thread, and a process that moves
    between cores reads slower or faster from run to run."""
    try:
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    except (AttributeError, OSError) as exc:
        log(f"the run is not pinned to one core: {exc}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    pin_to_one_core()
    import harness
    bench = harness.load_benchmark()
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    cell = harness.resolve(args.workload)
    if not (ROOT / "webrender_tpu_torch" / "__init__.py").exists():
        log("the program (webrender_tpu_torch) is not in this checkout")
        return 2
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        log("no CUDA card: the benchmark measures the card and has no "
            "CPU fallback")
        return 3
    if torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} cards; "
            f"{torch.cuda.device_count()} are visible")
        return 3
    log(f"{args.workload} seed {args.seed} for {args.seconds} s, trace "
        f"{args.trace}, on {card()}")
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START, log=log)
    found = harness.forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
