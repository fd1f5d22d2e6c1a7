"""The port imports nothing of JAX and nothing of the JAX package.

* An AST walk of every module of `webrender_tpu_torch` and of
  `chip_smoke.py`: no `import`, `from ... import`, `importlib.import_module`
  or `__import__` names `webrender_tpu` or `jax`.
* A fresh interpreter imports the port and builds (without rendering) a
  frame that takes the frame builder's two lazy-import paths: a blurred
  box-shadow mask (`_render_box_shadow_mask`) and a gradient nine-patch
  source (`_raster_gradient_source`), with a repeating gradient beside
  them.  Neither `jax` nor `webrender_tpu` is loaded afterwards.
* A fresh interpreter builds the small content frame and renders it
  through the plain version: every content branch of the kernel's module
  (gradients, box shadows, line decorations, mask clips, mix blends) and
  the frame builder's box-shadow mask task run, and neither `jax` nor
  `webrender_tpu` is loaded afterwards.
* A fresh interpreter builds the small zoomed frame with its video and
  clear rects, renders it, sends a video tick and renders again: the
  resource cache's plane path (`request_yuv_planes`), the frame
  builder's lazy imports for YUV items and the kernel module's scaled
  text, video and clear branches run, and neither `jax` nor
  `webrender_tpu` is loaded afterwards.
* A fresh interpreter renders the small SVG-filter frame: the SVG filter
  passes of `ops/filters.py`, the float-domain blend ops and the linearRGB
  color matrix run, and neither `jax` nor `webrender_tpu` is loaded
  afterwards.
* A fresh interpreter renders the small CSS-3D frame: the plane splitter,
  backface culling, plane surfaces and a dispatch with polygon clips run,
  and neither `jax` nor `webrender_tpu` is loaded afterwards.
* The walk covers the numpy oracle (`oracle/`) and the wrench reader and
  harness (`wrench/`); a fresh interpreter runs a GL line of the port's
  manifest through the harness and its cross mode (the reader, the gl
  dispatches, the oracle), and neither `jax` nor `webrender_tpu` is loaded
  afterwards.
"""
import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the fresh interpreters run beside the other test workers: one thread each
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
FORBIDDEN = ("webrender_tpu", "jax", "jaxlib")


def _port_files():
    files = sorted((ROOT / "webrender_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_names(tree):
    """Every absolute module name an import statement or an import call of
    the tree names."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", None)
            if name in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 40
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for line, name in _imported_names(tree):
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}:{line} {name}")
    assert not bad, bad


LAZY_PATHS = """
import sys
from webrender_tpu_torch import api as A
from webrender_tpu_torch.frame import frame_builder as fbm
from webrender_tpu_torch.render_backend import RenderBackend

calls = {"box_shadow_mask": 0, "gradient_source": 0}
mask = fbm.FrameBuilder._render_box_shadow_mask
source = fbm._raster_gradient_source

def counted_mask(*a, **k):
    calls["box_shadow_mask"] += 1
    return mask(*a, **k)

def counted_source(*a, **k):
    calls["gradient_source"] += 1
    return source(*a, **k)

fbm.FrameBuilder._render_box_shadow_mask = counted_mask
fbm._raster_gradient_source = counted_source

backend = RenderBackend((256, 128), device="cpu")
pid = A.PipelineId(0, 1)
b = A.DisplayListBuilder(pid)
b.begin()
root = A.SpatialId.root_scroll_node(pid)
common = A.CommonItemProperties(A.Rect(0, 0, 256, 128), root)
b.push_rect(common, A.Rect(0, 0, 256, 128), A.ColorF(1, 1, 1, 1))
b.push_box_shadow(common, A.Rect(20, 20, 80, 50), A.Point2D(4, 4),
                  A.ColorF(0, 0, 0, 0.5), 10.0, 0.0,
                  A.BorderRadius.uniform(6.0), A.BoxShadowClipMode.OUTSET)
stops = [A.GradientStop(0.0, A.ColorF(1, 0, 0, 1)),
         A.GradientStop(1.0, A.ColorF(0, 0, 1, 1))]
g, s = b.create_gradient(A.Point2D(0, 0), A.Point2D(16, 0), stops,
                         A.ExtendMode.REPEAT)
b.push_gradient(common, A.Rect(130, 10, 110, 40), g, s,
                tile_size=A.Size2D(30, 20), tile_spacing=A.Size2D(4, 4))
src = A.NinePatchBorder(
    source_kind="gradient",
    gradient=A.Gradient(A.Point2D(0, 0), A.Point2D(30, 30),
                        A.ExtendMode.CLAMP),
    stops=tuple(stops), width=30, height=30,
    slice=A.SideOffsets(10, 10, 10, 10))
b.push_border(common, A.Rect(130, 60, 100, 60),
              A.SideOffsets(10, 10, 10, 10), details_nine_patch=src)
_, dl = b.end()
txn = A.Transaction()
txn.set_root_pipeline(pid)
txn.set_display_list(A.Epoch(0), dl)
txn.generate_frame()
backend.send_transaction(txn)
frame = backend.build_frame()
assert frame.instances.shape[0] > 0
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "webrender_tpu"))
print(calls["box_shadow_mask"], calls["gradient_source"], len(loaded),
      loaded[:5])
"""


def test_frame_build_on_the_lazy_import_paths_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", LAZY_PATHS], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=ONE_THREAD)
    assert out.returncode == 0, out.stderr[-3000:]
    masks, sources, n_loaded, loaded = out.stdout.split(maxsplit=3)
    assert int(masks) >= 1 and int(sources) >= 1, out.stdout
    assert int(n_loaded) == 0, loaded


CONTENT_FRAME = """
import sys
from webrender_tpu_torch import scenes
from webrender_tpu_torch.frame import frame_builder as fbm
from webrender_tpu_torch.render_backend import RenderBackend

masks = []
mask = fbm.FrameBuilder._render_box_shadow_mask
fbm.FrameBuilder._render_box_shadow_mask = \\
    lambda *a, **k: masks.append(1) or mask(*a, **k)
backend = scenes.content_scene(RenderBackend((1024, 512), device="cpu"))
img = backend.render()
assert img.shape == (512, 1024, 4) and img.any()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "webrender_tpu"))
print(len(masks), len(loaded), loaded[:5])
"""


def test_content_frame_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", CONTENT_FRAME], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=ONE_THREAD)
    assert out.returncode == 0, out.stderr[-3000:]
    masks, n_loaded, loaded = out.stdout.split(maxsplit=2)
    assert int(masks) >= 1, out.stdout
    assert int(n_loaded) == 0, loaded


ZOOMED_FRAME = """
import sys
from webrender_tpu_torch import scenes
from webrender_tpu_torch.render_backend import RenderBackend
from webrender_tpu_torch.resources import resource_cache as rc

planes = []
request = rc.ResourceCache.request_yuv_planes
rc.ResourceCache.request_yuv_planes = \\
    lambda *a, **k: planes.append(1) or request(*a, **k)
backend = scenes.zoomed_scene(RenderBackend(scenes.ZOOMED_SIZE,
                                            device="cpu"), 2.0)
backend.renderer.dispatch_log = log = []
img = backend.render()
assert img.shape == (512, 1024, 4) and img.any()
kinds = set().union(*(e["kinds"] for e in log))
assert {7, 14, 16, 17} <= kinds, kinds
scenes.video_tick(backend, 1, scenes.MEDIA_SMALL["video_size"])
assert (backend.render() != img).any()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "webrender_tpu"))
print(len(planes), len(loaded), loaded[:5])
"""


def test_zoomed_frame_with_video_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", ZOOMED_FRAME], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=ONE_THREAD)
    assert out.returncode == 0, out.stderr[-3000:]
    planes, n_loaded, loaded = out.stdout.split(maxsplit=2)
    assert int(planes) >= 2, out.stdout
    assert int(n_loaded) == 0, loaded


TRANSFORMED_FRAME = """
import sys
from webrender_tpu_torch import scenes
from webrender_tpu_torch.render_backend import RenderBackend

backend = scenes.transformed_scene(RenderBackend((1024, 512), device="cpu"))
backend.renderer.dispatch_log = log = []
img = backend.render()
assert img.shape == (512, 1024, 4) and img.any()
kinds = set().union(*(e["kinds"] for e in log))
assert {1, 12, 18, 19, 20} <= kinds, kinds
general, tiles = backend.renderer.last_general_tiles[-1]
scenes.video_tick(backend, 1, scenes.TRANSFORMED_SMALL["video_size"])
assert (backend.render() != img).any()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "webrender_tpu"))
print(general, tiles, len(loaded), loaded[:5])
"""


def test_transformed_frame_loads_no_jax():
    """A fresh interpreter renders the small transformed frame (the
    general tiles, the host conversion of the tilted video) and ticks its
    video with neither JAX nor the JAX package loaded."""
    out = subprocess.run([sys.executable, "-c", TRANSFORMED_FRAME], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=ONE_THREAD)
    assert out.returncode == 0, out.stderr[-3000:]
    general, tiles, n_loaded, loaded = out.stdout.split(maxsplit=3)
    assert 0 < int(general) < int(tiles) == 64, out.stdout
    assert int(n_loaded) == 0, loaded


SVG_FRAME = """
import sys
from webrender_tpu_torch import scenes
from webrender_tpu_torch.ops import filters
from webrender_tpu_torch.render_backend import RenderBackend

calls = []
for name in ("apply_channel_lut", "apply_srgb", "apply_arith"):
    fn = getattr(filters, name)
    setattr(filters, name, lambda *a, _f=fn, _n=name, **k:
            calls.append(_n) or _f(*a, **k))
backend = scenes.svg_filter_scene(RenderBackend((1024, 512), device="cpu"))
backend.renderer.picture_caching = False
backend.renderer.dispatch_log = log = []
img = backend.render()
assert img.shape == (512, 1024, 4) and img.any()
assert any(e["linear_cm"] for e in log)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "webrender_tpu"))
print(len(set(calls)), len(loaded), loaded[:5])
"""


def test_svg_filter_frame_loads_no_jax():
    """A fresh interpreter renders the small SVG-filter frame: the new
    module `ops/filters.py` (its three passes), the float-domain blend ops
    and the linearRGB color matrix run, with neither JAX nor the JAX
    package loaded."""
    out = subprocess.run([sys.executable, "-c", SVG_FRAME], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=ONE_THREAD)
    assert out.returncode == 0, out.stderr[-3000:]
    passes, n_loaded, loaded = out.stdout.split(maxsplit=2)
    assert int(passes) == 3, out.stdout
    assert int(n_loaded) == 0, loaded


CSS3D_FRAME = """
import sys
from webrender_tpu_torch import scenes
from webrender_tpu_torch.render_backend import RenderBackend

backend = scenes.preserve3d_scene(RenderBackend((1024, 512), device="cpu"))
backend.renderer.picture_caching = False
backend.renderer.dispatch_log = log = []
with scenes.CulledFaces() as culled:
    img = backend.render()
assert img.shape == (512, 1024, 4) and img.any()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "webrender_tpu"))
print(sum(e["polygon_clips"] for e in log), len(culled.nodes), len(loaded),
      loaded[:5])
"""


def test_css3d_frame_loads_no_jax():
    """A fresh interpreter renders the small CSS-3D frame (the plane
    splitter, backface culling, plane surfaces and a dispatch with polygon
    clips) with neither JAX nor the JAX package loaded."""
    out = subprocess.run([sys.executable, "-c", CSS3D_FRAME], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=ONE_THREAD)
    assert out.returncode == 0, out.stderr[-3000:]
    polygons, culled, n_loaded, loaded = out.stdout.split(maxsplit=3)
    assert int(polygons) >= 1 and int(culled) >= 1, out.stdout
    assert int(n_loaded) == 0, loaded


def test_oracle_and_wrench_modules_are_walked():
    """The AST walk above covers the numpy oracle and the wrench reader and
    harness, and none of them names JAX or the JAX package."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    for module in ("oracle/__init__.py", "oracle/sw.py",
                   "wrench/__init__.py", "wrench/yaml_reader.py",
                   "wrench/reftest.py"):
        path = ROOT / "webrender_tpu_torch" / module
        assert str(path.relative_to(ROOT)) in names
        tree = ast.parse(path.read_text(), str(path))
        assert not [n for _, n in _imported_names(tree)
                    if n.split(".")[0] in FORBIDDEN], module


REFTEST_PATH = """
import sys
from webrender_tpu_torch import scenes
from webrender_tpu_torch.wrench import reftest

harness = reftest.ReftestHarness(scenes.GL_SMALL_SIZE, device="cpu")
cases = reftest.parse_reftest_manifest(scenes.GL_MANIFEST)
masks = [c for c in cases if c.gl_only and c.tests[0].name == "gl-masks.json"]
results = [harness.run_case(masks[0]), harness.run_case_cross(masks[0])]
assert results[0].passed, results[0].detail
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "webrender_tpu"))
print(harness.engine_counts.get("plain", 0), len(loaded), loaded[:5])
"""


def test_reftest_path_loads_no_jax():
    """A fresh interpreter parses the port's manifest and runs a GL line
    through the harness (the reader, the renderer's gl dispatches on the
    plain version) and its cross mode (the numpy oracle), with neither JAX
    nor the JAX package loaded."""
    out = subprocess.run([sys.executable, "-c", REFTEST_PATH], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=ONE_THREAD)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, n_loaded, loaded = out.stdout.split(maxsplit=2)
    assert int(plain) >= 3, out.stdout
    assert int(n_loaded) == 0, loaded
