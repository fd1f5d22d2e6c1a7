"""The port's example entries (`examples_torch/`) against the JAX package's
(`examples/`), on the CPU.

Each script of `examples_torch/` runs on the CPU at its own size and
frame count, as its `__main__` runs it (`main_wrapper` or `main`, in
this process; `basic.py` also as a program with `--cpu`), and writes its
image; the image equals the JAX example's `render_software` output (its
numpy oracle) on the same display lists, at the tolerance `TOLERANCE`
states (bitwise but where noted).  The JAX example is imported by path with its own `common.py`;
the port's scripts import nothing of it (`tests/test_torch_isolation.py`
walks them).  Every script renders on the card unless asked for the CPU.
"""
import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_EXAMPLES = ROOT / "examples"
PORT_EXAMPLES = ROOT / "examples_torch"

# script -> (example function, size, frames) of its `__main__`; None for
# the scripts with a `main()` of their own
SCRIPTS = {"alpha_perf": ("alpha_perf", (512, 384), 1),
           "animation": ("animation", (512, 384), 6),
           "basic": ("basic", (512, 384), 1),
           "blob": ("blob", (512, 384), 1),
           "document": None,
           "iframe": ("iframe", (512, 384), 1),
           "image_resize": ("image_resize", (512, 384), 2),
           "multiwindow": None,
           "scrolling": ("scrolling", (512, 384), 3),
           "texture_cache_stress": ("texture_cache_stress", (512, 384), 1),
           "yuv": ("yuv", (512, 384), 1)}

# (max u8 steps, values at most) from the JAX example's numpy oracle: every
# example's image is bitwise JAX's (none has a gradient stop or blend that
# lands on the oracle's float64 `where`s, `ROADMAP.md` C)
TOLERANCE = {name: (0, 0) for name in SCRIPTS}


def _load(directory, name):
    """Module `name` of `directory` (loaded by path under a name of its
    own) with that directory's `common.py` as `common` (None where it
    imports none)."""
    saved = sys.modules.pop("common", None)
    sys.path.insert(0, str(directory))
    try:
        spec = importlib.util.spec_from_file_location(
            f"_{directory.name}_{name}", directory / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod, sys.modules.get("common")
    finally:
        sys.path.remove(str(directory))
        sys.modules.pop("common", None)
        if saved is not None:
            sys.modules["common"] = saved


def _jax_image(name, tmp_path):
    """The JAX example's image through its numpy oracle, written under
    `tmp_path`."""
    mod, common = _load(JAX_EXAMPLES, name)
    if name == "document":
        from webrender_tpu.api import ColorF, PipelineId
        from webrender_tpu.render_backend import MultiDocumentBackend
        mdb = MultiDocumentBackend()
        colors = [ColorF(0.8, 0.2, 0.2, 1), ColorF(0.2, 0.8, 0.2, 1),
                  ColorF(0.2, 0.2, 0.8, 1), ColorF(0.8, 0.8, 0.2, 1)]
        tiles = []
        for i, col in enumerate(colors):
            mdb.add_document(i, (256, 192))
            mod.build_doc(mdb, i, PipelineId(0, i + 1), col, (256, 192))
            tiles.append(mdb.documents[i].render_software())
        return np.concatenate([np.concatenate(tiles[:2], axis=1),
                               np.concatenate(tiles[2:], axis=1)], axis=0)
    if name == "multiwindow":
        return np.concatenate([mod.build_window(i, (220, 160))
                               for i in range(3)], axis=1)
    fn, size, frames = SCRIPTS[name]
    return common.main_wrapper(getattr(mod, fn), size=size, frames=frames,
                               out=str(tmp_path / f"jax_{name}.png"))


def _saved(out, name):
    png = out / f"{name}.png"
    if png.exists():
        from PIL import Image
        return np.asarray(Image.open(png))
    return np.load(out / f"{name}.npy")


def _port_image(name, tmp_path):
    """The port's script run on the CPU as its `__main__` runs it; the
    image it saved."""
    out = tmp_path / "port"
    mod, common = _load(PORT_EXAMPLES, name)
    argv = [f"{name}.py", "--cpu"]
    if SCRIPTS[name] is None:
        mod.main(out=str(out), argv=argv)
    else:
        fn, size, frames = SCRIPTS[name]
        common.main_wrapper(getattr(mod, fn), size=size, frames=frames,
                            out=str(out), argv=argv)
    return _saved(out, name)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_example_equals_jax(name, tmp_path):
    want = _jax_image(name, tmp_path)
    got = _port_image(name, tmp_path)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    steps, count = TOLERANCE[name]
    assert diff.max(initial=0) <= steps
    assert int((diff > 0).sum()) <= count


def test_script_runs_as_a_program(tmp_path):
    """`python examples_torch/basic.py --cpu --out DIR` writes the image
    the example renders."""
    out = tmp_path / "cli"
    proc = subprocess.run(
        [sys.executable, str(PORT_EXAMPLES / "basic.py"), "--cpu", "--out",
         str(out)], cwd=str(PORT_EXAMPLES), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "wrote" in proc.stdout
    np.testing.assert_array_equal(_saved(out, "basic"),
                                  _jax_image("basic", tmp_path))


def test_scripts_default_to_the_card(tmp_path):
    """Without `--cpu` a script renders on the card: here, with no CUDA,
    its backend refuses (`Renderer(device="cuda")` raises)."""
    import torch
    _, common = _load(PORT_EXAMPLES, "basic")
    assert common.device_from_argv([]) == "cuda"
    assert common.device_from_argv(["x.py", "--cpu"]) == "cpu"
    if torch.cuda.is_available():
        return
    basic, common = _load(PORT_EXAMPLES, "basic")
    with pytest.raises(RuntimeError, match="CUDA"):
        common.main_wrapper(basic.basic, out=str(tmp_path), argv=[])
    for name in ("document", "multiwindow"):
        mod, _ = _load(PORT_EXAMPLES, name)
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(out=str(tmp_path), argv=[])


def test_multiwindow_replays_recorded_glyphs(tmp_path, monkeypatch):
    """Where no font stack exists (the GPU machine has no matplotlib), the
    windows' text replays `testdata/glyphs.npz` (`scenes.window_scene`
    is in the recording): the same image as JAX's, bitwise."""
    from webrender_tpu_torch import scenes
    monkeypatch.setattr(scenes, "font_stack_available", lambda: False)
    mod, _ = _load(PORT_EXAMPLES, "multiwindow")
    got = mod.main(device="cpu", out=str(tmp_path), argv=["--cpu"])
    np.testing.assert_array_equal(got, _jax_image("multiwindow", tmp_path))
