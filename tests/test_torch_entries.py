"""The port's entry points against the JAX package's, on the CPU.

* `graft_entry.entry(device="cpu")`: each example argument equals the one
  `__graft_entry__.entry()` builds, and `fn(*example_args)` (the kernel's
  plain version here) equals JAX's `fn` (the Pallas kernel in interpret
  mode) on the [nt, 4, 64, 128] tiles, bitwise.  `entry()` checks the
  records once and binds `host_checked`, so `fn` reads nothing back, as
  the renderer's dispatch does.  Without CUDA `entry()`
  raises; `dryrun_multichip` is `parallel/dryrun.py`'s (its spawned run is
  `tests/test_torch_multichip.py`'s).
* `bench.run(device="cpu")` on bench's page cut as `test_torch_scene.py`'s
  SLICE cuts it: `detail` has every key `bench.py` prints and names the
  CPU baseline that ran; its passes and instances equal JAX's bench frame
  after the same scroll tick; the uncached, cached and CPU-baseline images
  equal each other and JAX's `render_software` of that state, bitwise.
  Where the native library is taken away, the baseline is numpy and says
  why.  `python bench_torch.py` without `--cpu` fails on a machine without
  CUDA.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from webrender_tpu_torch import bench, graft_entry
from webrender_tpu_torch.oracle import native
from webrender_tpu_torch.parallel import dryrun

ROOT = pathlib.Path(__file__).resolve().parents[1]
SLICE = (640, 384, 12, 4, 8, 4)  # w, h, rects, gradients, images, text runs


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal is not reachable")


@pytest.fixture(scope="module")
def entries():
    import __graft_entry__ as g
    ours = graft_entry.entry(device="cpu")
    theirs = g.entry()
    return ours, theirs


def test_entry_arguments_equal_jax(entries):
    (fn, args), (jfn, jargs) = entries
    assert len(args) == len(jargs) == 8
    for ours, theirs in zip(args, jargs):
        theirs = np.asarray(theirs)
        assert ours.device.type == "cpu"
        assert ours.numpy().dtype == theirs.dtype
        np.testing.assert_array_equal(ours.numpy(), theirs)
    for key in ("kinds", "blends", "mask_clips"):
        assert fn.keywords[key] == jfn.keywords[key]


def test_entry_output_equals_jax_interpret(entries):
    """Tolerance: bitwise, on the [nt, 4, 64, 128] f32 tiles."""
    (fn, args), (jfn, jargs) = entries
    assert jfn.keywords["interpret"]
    got = fn(*args).numpy()
    want = np.asarray(jfn(*jargs))
    assert got.shape == want.shape == (16, 4, 64, 128)
    np.testing.assert_array_equal(got, want)
    assert got.any()


def test_entry_checks_the_records_once(monkeypatch):
    from webrender_tpu_torch.ops import tile_raster
    calls = []
    for module in (graft_entry, tile_raster):
        for name in ("check_clip_kinds", "check_color_matrix_flags",
                     "check_general_flags"):
            real = getattr(module, name)
            monkeypatch.setattr(
                module, name,
                lambda *a, _real=real, _name=name, _mod=module, **k:
                calls.append((_mod.__name__, _name)) or _real(*a, **k))
    fn, args = graft_entry.entry(device="cpu")
    assert fn.keywords["host_checked"] is True
    assert sorted(calls) == [("webrender_tpu_torch.graft_entry", name)
                             for name in ("check_clip_kinds",
                                          "check_color_matrix_flags",
                                          "check_general_flags")]
    calls.clear()
    fn(*args)
    assert calls == []


def test_entry_without_cuda_raises():
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()


def test_dryrun_is_the_parallel_dry_run():
    assert graft_entry.dryrun_multichip is dryrun.dryrun_multichip


def _jax_bench_keys():
    """The keys of `detail` in the result `bench.py` prints."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "detail"
                for k in node.keys):
            detail = node.values[[k.value for k in node.keys].index("detail")]
            return {k.value for k in detail.keys}
    raise AssertionError("bench.py prints no detail")


def _jax_bench_state():
    """JAX's bench page at the SLICE cut after bench's first dirty(): its
    benched frame and its `render_software` image."""
    from bench import build_4k_scene
    from webrender_tpu.api import Point2D
    ref = build_4k_scene(*SLICE)
    ref.build_frame()
    ref.scroll_offsets[bench.FEED_SCROLL_ID] = [
        (Point2D(0.0, bench.SCROLL_STEP), 0)]
    return ref.build_frame(), ref.render_software()


@pytest.fixture(scope="module")
def small_bench():
    return bench.run(device="cpu", size=SLICE[:2], iters=2, e2e_iters=2,
                     counts=SLICE[2:])


def test_bench_detail_has_every_key_of_bench_py(small_bench):
    result, _ = small_bench
    keys = _jax_bench_keys()
    assert "native_cpu_ms_per_frame" in keys and "backend" in keys
    assert set(result) == {"metric", "value", "unit", "vs_baseline",
                           "detail"}
    detail = result["detail"]
    assert keys <= set(detail) and "cpu_baseline" in detail
    assert result["metric"] == "640x384_frames_per_second"
    assert detail["backend"] == "cpu" and detail["card"] is None
    assert detail["raster_engine_mix"] == {"plain": 1}
    assert set(detail["e2e_stage_breakdown_ms"]) == {
        "frame_build_ms", "dispatch_ms", "device_exec_ms"}
    assert all(v > 0 for v in detail["e2e_stage_breakdown_ms"].values())


def test_bench_names_the_native_baseline(small_bench):
    assert native.available()
    detail = small_bench[0]["detail"]
    assert detail["cpu_baseline"] == "native"
    assert "numpy_cpu_ms_per_frame" not in detail
    assert 0 < detail["native_in_cpp_ms"] < \
        detail["native_cpu_ms_per_frame"]


def test_bench_frame_equals_jax_bench(small_bench):
    frame, _ = _jax_bench_state()
    detail = small_bench[0]["detail"]
    assert detail["passes"] == len(frame.passes)
    assert detail["instances"] == frame.instances.shape[0]


def test_bench_images_equal_each_other_and_jax_oracle(small_bench):
    """Tolerance: bitwise, RGBA8."""
    _, images = small_bench
    _, want = _jax_bench_state()
    assert want.shape == (384, 640, 4) and want.any()
    for name in ("uncached", "cached", "cpu_baseline"):
        np.testing.assert_array_equal(images[name], want, err_msg=name)


def test_bench_without_the_native_library_says_numpy(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    result, images = bench.run(device="cpu", size=(256, 128), iters=1,
                               e2e_iters=1, counts=(4, 1, 2, 0))
    detail = result["detail"]
    assert detail["cpu_baseline"] == "numpy"
    assert "libspanraster" in detail["cpu_baseline_reason"]
    assert "native_cpu_ms_per_frame" not in detail
    assert detail["numpy_cpu_ms_per_frame"] > 0
    np.testing.assert_array_equal(images["cpu_baseline"], images["uncached"])


def test_bench_script_without_cuda_fails():
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and not res.stdout.strip()
    assert "CUDA is not available" in res.stderr
