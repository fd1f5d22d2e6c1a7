"""The port's multi-device dry run: `dryrun_multichip(n, device)`.

The counterpart of the JAX package's entry
(`__graft_entry__.dryrun_multichip` and `_dryrun_impl`, :122-199), which
renders its test frame over an n-device mesh and holds it against the
unsharded render.  Here the mesh is SPMD over `torch.distributed`:
`run_ranks` spawns one process per device (NCCL on the cards, one rank
each; gloo on the CPU), joined by a `file://` rendezvous in a temporary
directory, so no port is opened.  Each rank renders the blurred 1024x256
test frame (`scenes.graft_test_scene`) unsharded and over the mesh, and
checks that dispatches were sharded and that the two images are equal
bit for bit; rank 0 prints the result.  A failure on any rank fails the
call, and every wait has a time limit, so nothing hangs.

From the repository root:

    python -c "from webrender_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(2, device='cpu')"
"""
from __future__ import annotations

import datetime
import multiprocessing
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .mesh import make_mesh

DRYRUN_SIZE = (1024, 256)
DRYRUN_RECTS = 48


def _rank_entry(rank, n, device, init_method, timeout, fn, args, results):
    """One rank: join the group, run `fn(mesh, *args)`, report to
    `results` as (rank, traceback or None, value)."""
    try:
        if device == "cuda":
            torch.cuda.set_device(rank)
        else:
            # the ranks share the machine's cores
            torch.set_num_threads(1)
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo", init_method=init_method,
            rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout))
        value = fn(make_mesh(n, device), *args)
        results.put((rank, None, value))
    except BaseException:  # reported to the caller, which raises
        results.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, n: int, device: str = "cuda", args=(),
              timeout: float = 600.0) -> list:
    """`fn(mesh, *args)` on `n` spawned ranks of one mesh, one process per
    device ("cuda": NCCL, rank r on card r; "cpu": gloo).  `fn` must be a
    module-level function and its return value picklable.  Returns the
    ranks' values in rank order.  Raises `RuntimeError` before spawning
    when the machine has fewer than `n` cards, and when a rank fails (with
    its traceback) or the ranks have not all finished within `timeout`
    seconds; every rank has stopped when it returns or raises."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"run_ranks: device {device!r}")
    if device == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if n > count:
            raise RuntimeError(f"{n} ranks on CUDA need {n} cards, this "
                               f"machine has {count}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="wr_mesh_")
    init = f"file://{tmp}/rendezvous"
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(r, n, device, init, timeout, fn, args,
                               results)) for r in range(n)]
    values = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(values) < n:
            try:
                rank, error, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in values and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} before "
                                       f"it reported")
                if time.monotonic() > deadline:
                    late = sorted(set(range(n)) - set(values))
                    raise RuntimeError(f"ranks {late} did not finish in "
                                       f"{timeout} s")
                continue
            if error is not None:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{error}")
            values[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10 if len(values) == n else 0.1)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [values[r] for r in range(n)]


def _dryrun_rank(mesh):
    """One rank of the dry run: the test frame unsharded and over `mesh`,
    held equal; rank 0 prints the line.  Returns the passes and the
    sharded renderer's `engine_counts`."""
    from .. import scenes
    from ..render_backend import RenderBackend
    from ..renderer import Renderer

    def render(renderer):
        backend = RenderBackend(DRYRUN_SIZE, renderer=renderer)
        scenes.graft_test_scene(backend, DRYRUN_SIZE, DRYRUN_RECTS,
                                with_blur=True)
        return backend, backend.render()

    _, ref = render(Renderer(mesh.device))
    backend, out = render(Renderer(mesh.device, mesh=mesh))
    counts = backend.renderer.engine_counts
    n_passes = len(backend.last_frame.passes)
    if counts["kernel-sharded"] == 0:
        raise RuntimeError(f"no dispatch ran sharded: {counts}")
    diff = int(np.abs(out.astype(np.int32) - ref.astype(np.int32)).max())
    if diff:
        raise RuntimeError(f"the sharded render differs from the unsharded "
                           f"one (max {diff})")
    if mesh.rank == 0:
        print(f"dryrun_multichip: {n_passes} passes ("
              f"{counts['kernel-sharded']} dispatches and "
              f"{counts['blur-sharded']} blurs sharded) across {mesh.size} "
              f"ranks ({mesh.backend} on {mesh.device.type}); sharded == "
              f"unsharded bit-exact; engines={counts}", flush=True)
    return {"passes": n_passes, "engine_counts": counts}


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout: float = 600.0) -> dict:
    """Render the dry run's test frame over a mesh of `n_devices` ranks
    (`device` "cuda": one card each, over NCCL; "cpu": gloo) and hold it
    equal to the unsharded render on every rank.  Returns rank 0's
    passes and engine counts; raises `RuntimeError` if a rank fails, the
    ranks do not finish within `timeout` seconds, or `n_devices` exceeds
    the machine's cards."""
    return run_ranks(_dryrun_rank, int(n_devices), device,
                     timeout=timeout)[0]
