"""Shared helpers of the tests/test_torch_*.py twins: the JAX package's
kernel inputs for a scene, their torch copies, and the carrying of values
built with one package's API into the other's classes."""
import contextlib
import enum
import importlib
import math
import types

import numpy as np
import pytest
import torch

import webrender_tpu.api as jax_api
from webrender_tpu_torch import scenes
from webrender_tpu_torch.oracle.sw import Float32Where
from webrender_tpu_torch.ops import tile_raster as tr

# the small frames of the kernel checks: (scene, device size)
SMALL_FRAMES = scenes.SMALL_FRAMES

# the test workers run in parallel: one torch thread each keeps them from
# oversubscribing the cores (the plain version is no faster with more)
torch.set_num_threads(1)


def jax_backend(size):
    """A JAX RenderBackend whose renderer runs the Pallas kernel in
    interpret mode, uncached."""
    from webrender_tpu.render_backend import RenderBackend
    from webrender_tpu.renderer.renderer import Renderer
    r = Renderer(use_pallas=True, pallas_interpret=True)
    r.picture_caching = False
    return RenderBackend(size, renderer=r)


def jax_scene(make, size, *extra, **kw):
    """`make` (a builder of webrender_tpu_torch.scenes) on `jax_backend`,
    built with the JAX package's API."""
    return make(jax_backend(size), *extra, api=jax_api, **kw)


def to_port(obj):
    """A copy of `obj` (a transaction, a display list, any value built with
    the JAX package's API) made of the port's classes: the host layers
    of both packages check item types by class."""
    cls = type(obj)
    mod = cls.__module__
    if mod.startswith("webrender_tpu."):
        port_cls = getattr(importlib.import_module(
            "webrender_tpu_torch." + mod.split(".", 1)[1]), cls.__qualname__)
        if isinstance(obj, enum.Enum):
            return port_cls(obj.value)
        new = object.__new__(port_cls)
        slots = getattr(cls, "__slots__", ())
        state = {k: getattr(obj, k) for k in slots} if slots else vars(obj)
        for k, v in state.items():
            object.__setattr__(new, k, to_port(v))
        return new
    if isinstance(obj, (list, tuple, set, frozenset)):
        items = [to_port(v) for v in obj]
        return cls(*items) if hasattr(obj, "_fields") else cls(items)
    if isinstance(obj, dict):
        return {to_port(k): to_port(v) for k, v in obj.items()}
    return obj


class PortFeed:
    """The port's backend, fed transactions built with the JAX package's
    API (the scene helpers of the JAX tests): each is carried over by
    `to_port` before the backend takes it."""

    def __init__(self, backend):
        self.backend = backend

    def send_transaction(self, txn):
        self.backend.send_transaction(to_port(txn))

    def __getattr__(self, name):
        return getattr(self.backend, name)


def jax_kernel_inputs(backend):
    """(frame, pass, dense kinds, kernel kwargs as numpy) for the
    backend's one merged root pass, built by the JAX package (offscreen
    passes are not run)."""
    frame = backend.build_frame()
    r = backend.renderer
    r.apply_uploads(backend.resources.take_uploads())
    from webrender_tpu.frame.frame_builder import TARGET_ROOT
    (p,) = [q for q in r._merged_root_passes(frame)
            if q.target == TARGET_ROOT]
    return (frame, p) + jax_pass_inputs(r, frame, p)


def jax_pass_inputs(r, frame, p):
    """(dense kinds, dispatch sets, kernel kwargs as numpy) of raster pass
    `p` of `frame` on JAX renderer `r`, with its atlases as they stand."""
    import jax.numpy as jnp
    from webrender_tpu.ops.pallas import tile_raster as jt
    dk = jt.classify_dense_kinds(frame.f32_buf, frame.instances,
                                 frame.transforms)
    kinds, blends, mask_clips = jt.dense_dispatch_info(
        frame.f32_buf, frame.instances, p.tile_insts, dk)
    dense = jt.build_dense_records_device(
        jnp.asarray(frame.f32_buf), jnp.asarray(frame.instances),
        jnp.asarray(frame.transforms), jnp.asarray(p.tile_insts),
        jnp.asarray(dk), aligned=True)
    args = dict(dense=np.asarray(dense),
                counts=(p.tile_insts >= 0).sum(1).astype(np.int32),
                origins=r._tile_origins(p),
                clear=np.asarray(p.clear, np.float32),
                f32_rows=frame.f32_buf.reshape(-1, 128),
                alpha_atlas=np.asarray(r.alpha_atlas),
                surface_atlas=np.asarray(r.surface_atlas),
                color_atlas=np.asarray(r.color_atlas))
    return dk, (kinds, blends, mask_clips), args


def run_pallas(args, kinds, blends, mask_clips):
    """The Pallas kernel in interpret mode on kernel inputs `args`, with a
    dispatch's sets; without `mask_clips` it reads image-mask and
    box-shadow clip records as polygons."""
    import jax.numpy as jnp
    from webrender_tpu.ops.pallas import tile_raster as jt
    a = {k: jnp.asarray(v) for k, v in args.items()}
    return np.asarray(jt.render_tiles_pallas_dense(
        a["dense"], a["counts"], a["origins"], a["clear"], a["f32_rows"],
        a["alpha_atlas"], a["surface_atlas"], a["color_atlas"],
        kinds=kinds, blends=blends, mask_clips=mask_clips, interpret=True))


def pallas_args(a):
    """run_pallas's inputs (numpy) from kernel arguments named as the
    wrapper names them (a dispatch-log entry) or as `scenes.kernel_inputs`
    does."""
    names = dict(dense="dense", counts="tile_counts", origins="tile_origins",
                 clear="clear_color", f32_rows="f32_rows",
                 alpha_atlas="alpha_atlas", surface_atlas="surface_atlas",
                 color_atlas="color_atlas")
    return {k: np.asarray((a[k] if k in a else a[v]).cpu().numpy())
            for k, v in names.items()}


def to_torch(args, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in args.items()}


def positional(t):
    return (t["dense"], t["counts"], t["origins"], t["clear"],
            t["f32_rows"], t["alpha_atlas"], t["surface_atlas"],
            t["color_atlas"])


def rgba8(tiles, nx, ny, w, h):
    """Tiles → RGBA8 the way Renderer.render converts (f64, half-up)."""
    img = tiles.reshape(ny, nx, 4, 64, 128).transpose(2, 0, 3, 1, 4) \
        .reshape(4, ny * 64, nx * 128)[:, :h, :w]
    v = np.transpose(img, (1, 2, 0)).astype(np.float64) * 255.0
    return np.clip(np.floor(np.nan_to_num(v) + 0.5), 0, 255).astype(np.uint8)


def jax_rgba8(name):
    """The JAX package's RGBA8 of one small frame (Pallas, interpret)."""
    make, size = SMALL_FRAMES[name]
    _, p, _, dispatch, args = jax_kernel_inputs(jax_scene(make, size))
    return rgba8(run_pallas(args, *dispatch), p.nx, p.ny, *size)


def jax_effects_backend(caching=False):
    """The small effects frame on a JAX backend whose renderer runs the
    Pallas kernel in interpret mode (offscreen passes included)."""
    name, make, size = scenes.EFFECTS_FRAME
    backend = jax_scene(make, size)
    backend.renderer.picture_caching = caching
    return backend


def jax_zoomed_backend(zoom, caching=False):
    """The small zoomed frame at `zoom` on a JAX backend whose renderer
    runs the Pallas kernel in interpret mode."""
    backend = jax_scene(scenes.zoomed_scene, scenes.ZOOMED_SIZE, zoom)
    backend.renderer.picture_caching = caching
    return backend


def edge_inputs(kind, corner, H=192, W=512, seed=3):
    """Kernel inputs (numpy) of one tile and one sampled record of `kind`
    whose uv rect lies at an atlas corner (the origin, or the far corner
    with `corner`), drawn at a fractional device offset: the bilinear taps
    of its edge pixels fall outside the atlas.  Tint 1, no color matrix;
    the atlases hold seeded u8 values."""
    rng = np.random.RandomState(seed)
    rec = np.zeros(128, np.float32)
    w, h = 40.0, 30.0
    if corner:
        u0, v0, ox, oy, tx, ty = W - w, H - h, 256.0, 64.0, 300.3, 90.6
    else:
        u0, v0, ox, oy, tx, ty = 0.0, 0.0, 0.0, 0.0, 0.3, 0.6
    rec[0:4] = (0, 0, w, h)              # the prim rect
    rec[4:8] = (0, 0, w, h)              # its coverage rect
    rec[8:12] = (u0, v0, u0 + w, v0 + h)
    rec[12:16] = 1.0
    rec[64], rec[65], rec[66] = kind, 0, 15   # kind, blend, edge AA
    rec[69:81] = (1, 0, 0, 0, 1, 0, -tx, -ty, 1, 1, 1, 0)

    def u8(shape):
        return (rng.randint(0, 256, shape) / 255.0).astype(np.float32)
    return dict(dense=rec[None, None, :], counts=np.array([1], np.int32),
                origins=np.array([[ox, oy]], np.float32),
                clear=np.array([0.2, 0.2, 0.2, 1.0], np.float32),
                f32_rows=np.zeros((1, 128), np.float32),
                alpha_atlas=u8((H, W)), surface_atlas=u8((4, H, W)),
                color_atlas=u8((4, H, W)))


IDENTITY_TROW = (1, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0)


def record(kind, payload, blend=0, edge_aa=15, clip_row=0, clip_count=0,
           trow=IDENTITY_TROW):
    """One dense record (128 f32): `payload` from [0], then the kind,
    blend, edge-AA bits, clip count, first clip row and transform row."""
    rec = np.zeros(128, np.float32)
    rec[:len(payload)] = payload
    rec[64:69] = (kind, blend, edge_aa, clip_count, clip_row)
    rec[69:81] = trow
    return rec


def u8_planes(rng, shape):
    """[4, *shape] premultiplied RGBA on the u8 grid: alphas uniform with
    extra weight on 0 and 255, each color at most its alpha."""
    a = rng.randint(0, 256, shape)
    a = np.where(rng.rand(*shape) < 0.3, 255, a)
    a = np.where(rng.rand(*shape) < 0.1, 0, a)
    c = np.minimum((rng.rand(3, *shape) * (a + 1)).astype(int), a)
    return (np.concatenate([c, a[None]], 0) / 255.0).astype(np.float32)


def picture_variant(dense, counts, variant, matrix=None):
    """A copy of dense records (torch) whose valid picture records (kinds
    6 and 15) are changed: "flag0" turns their color matrix off, "flag1"
    on with `matrix` (20 floats), "local" puts the separable ones in the
    raster-root local mode (p[37..40]: offsets 3, 2, scale 1)."""
    dense = dense.clone()
    slot = torch.arange(dense.shape[1], device=dense.device)
    valid = slot[None, :] < counts.long()[:, None]
    kind = dense[..., 64]
    pic = valid & ((kind == 6) | (kind == 15))
    if variant == "flag0":
        dense[..., 36][pic] = 0.0
    elif variant == "flag1":
        m = torch.as_tensor(np.asarray(matrix, np.float32),
                            device=dense.device)
        dense[pic, 16:36] = m
        dense[..., 36][pic] = 1.0
    elif variant == "local":
        sep = valid & (kind == 15)
        dense[sep, 37:41] = torch.tensor([1.0, 3.0, 2.0, 1.0],
                                         device=dense.device)
    else:
        raise ValueError(variant)
    return dense


def jax_transformed_backend(caching=False, tilt=None):
    """The small transformed frame on a JAX backend whose renderer runs the
    Pallas kernel in interpret mode and splits the tiles it cannot draw
    off to `render_tiles`."""
    backend = jax_scene(scenes.transformed_scene, (1024, 512), tilt=tilt)
    backend.renderer.picture_caching = caching
    return backend


def write_goldens(path=scenes.GOLDENS):
    goldens = {n: jax_rgba8(n) for n in SMALL_FRAMES}
    goldens[scenes.EFFECTS_FRAME[0]] = jax_effects_backend().render()
    name, make, size = scenes.CONTENT_FRAME
    goldens[name] = jax_scene(make, size).render()
    for name, zoom in scenes.ZOOMED_FRAMES:
        goldens[name] = jax_zoomed_backend(zoom).render()
    # the transformed frame's golden is the JAX package's numpy oracle:
    # its device render differs from it where XLA's CPU build contracts
    # the general tiles' multiply-adds (tests/test_torch_transformed_frame)
    goldens[scenes.TRANSFORMED_FRAME[0]] = \
        jax_transformed_backend().render_software()
    # so is the SVG-filter frame's: its linearRGB groups round through
    # exp and log, which XLA, numpy and torch round each their own way
    name, make, size = scenes.SVG_FRAME
    goldens[name] = jax_scene(make, size).render_software()
    # and the CSS-3D frame's: XLA contracts the general tiles' polygon
    # half-planes and perspective divisions
    name, make, size = scenes.PRESERVE3D_FRAME
    goldens[name] = jax_scene(make, size).render_software()
    for name in scenes.GL_DOCUMENTS:
        goldens[scenes.gl_golden_name(name)] = jax_document_golden(name)
    np.savez_compressed(path, **goldens)


def jax_document_golden(name):
    """The JAX package's RGBA8 of a small reftest document under
    gl_flavor: its renderer's (the Pallas kernel in interpret mode with
    gl=True), or for a document with general tiles, which XLA draws with
    multiply-adds contracted, its numpy oracle's with the oracle's float64
    `where`s held in float32 (`jax_oracle_float32`)."""
    from webrender_tpu.wrench.yaml_reader import YamlFrameReader
    backend = jax_backend(scenes.GL_SMALL_SIZE)
    backend.frame_builder.gl_flavor = True
    YamlFrameReader(scenes.WRENCH / name, scenes.GL_SMALL_SIZE).build(
        backend)
    if name not in scenes.GL_GENERAL_DOCUMENTS:
        return backend.render()
    with jax_oracle_float32():
        return backend.render_software()


if __name__ == "__main__":
    write_goldens()
    print(f"wrote {scenes.GOLDENS}")


# --- hand-built frames for the general tiles ---------------------------------

def rotation_row(angle_deg, tx, ty, scale=1.0, skew=0.0):
    """The palette row (screen-to-local inverse, AA scales, flags) of a
    rotation by `angle_deg`, a skew and a uniform scale about the local
    origin, then a device translation; flag 4 (transformed) when the map
    is not axis-aligned (`frame/transforms.py`)."""
    a = np.deg2rad(angle_deg)
    fwd = np.array([[np.cos(a) * scale, np.sin(a) * scale, 0.0],
                    [(-np.sin(a) + skew) * scale, np.cos(a) * scale, 0.0],
                    [tx, ty, 1.0]])
    inv = np.linalg.inv(fwd)
    aligned = angle_deg == 0 and skew == 0
    return tuple(inv.reshape(-1).astype(np.float32)) + (
        float(np.hypot(fwd[0, 0], fwd[0, 1])),
        float(np.hypot(fwd[1, 0], fwd[1, 1])), 0.0 if aligned else 4.0)



def adversarial_dispatch(general=False, float_op=True):
    """Kernel inputs (numpy) of one dispatch whose three tiles (one at the
    origin, two at fractional origins) each list the same solid records
    made to test the kernel's culling (`adversarial_dispatch.NAMES`, one a
    slot): sub-pixel rects; edges at exact halves and on the 32-pixel
    runs' borders; each edge's AA off and on; hard and AA edges under the
    is_tx path; rotations, a mirror, scales; a projective row; a row with
    every pixel behind the projection plane; a record far outside; two
    under a rect clip and a rounded clip, two under chains of 16 and 18
    clips; and a float-domain op (blend 2)
    outside its tile (`float_op=False`: the normal blend).  `general`:
    every record carries REC_GENERAL.  No atlas is sampled."""
    recs, names = [], []
    color = (0.6, 0.4, 0.2, 0.8)

    def add(name, rect, trow=IDENTITY_TROW, edge_aa=15, blend=0,
            clip_row=0, clip_count=0):
        rec = record(0, tuple(rect) + tuple(rect) + color, blend, edge_aa,
                     clip_row, clip_count, trow)
        rec[81] = 1.0 if general else 0.0
        recs.append(rec)
        names.append(name)

    add("subpixel", (10.2, 5.3, 10.7, 5.6))
    add("half_edges", (31.5, 7.5, 64.5, 20.5))
    add("run_borders", (32.0, 0.0, 64.0, 64.0))
    add("straddle", (31.5, 1.0, 32.5, 3.0))
    for edge in (0, 1, 2, 4, 8, 5, 10):
        add(f"aa_{edge}", (63.5, 10.5, 96.5, 30.5), edge_aa=edge)
    add("hard_thin", (40.4, 12.0, 40.6, 50.0), edge_aa=0)
    tx = IDENTITY_TROW[:11] + (4.0,)
    add("tx_hard_halves", (20.5, 0.5, 50.5, 10.5), tx, edge_aa=0)
    add("tx_aa", (100.25, 3.5, 127.75, 60.0), tx)
    add("rot30_aa", (0.0, 0.0, 40.0, 25.0), rotation_row(30, 70.3, 20.7))
    add("rot30_hard", (0.0, 0.0, 40.0, 25.0), rotation_row(30, 70.3, 20.7),
        edge_aa=0)
    add("rot90", (0.0, 0.0, 30.0, 12.0), rotation_row(90, 60.0, 5.5))
    add("mirror", (10.0, 10.0, 30.0, 30.0),
        (-1, 0, 0, 0, 1, 0, 120, 0, 1, 1, 1, 0))
    add("scale_half", (0.0, 0.0, 30.0, 20.0),
        rotation_row(0, 5.25, 3.75, scale=0.5))
    add("scale_three", (2.0, 2.0, 9.0, 5.0),
        rotation_row(0, 0.3, 0.6, scale=3.0))
    add("negative_sx", (10.0, 10.0, 40.0, 40.0),
        (1, 0, 0, 0, 1, 0, 0, 0, 1, -1, 1, 0))
    add("projective", (0.0, 0.0, 20.0, 20.0),
        (1, 0, 0.001, 0, 1, 0, 0, 0, 1, 1, 1, 4))
    add("behind", (0.0, 0.0, 1000.0, 1000.0),
        (1, 0, 0, 0, 1, 0, 0, 0, -1, 1, 1, 0))
    add("far_outside", (1e6, 1e6, 1e6 + 10.0, 1e6 + 10.0))
    add("rect_clipped", (5.0, 5.0, 120.0, 60.0), clip_row=1, clip_count=1)
    add("two_clips", (5.0, 5.0, 120.0, 60.0), clip_row=1, clip_count=2)
    # a chain that fills a chunk's clip rows, and one longer than they hold
    # (read from the f32 buffer; its rows past the last clamp to it)
    add("chain_16", (5.0, 5.0, 120.0, 60.0), clip_row=1, clip_count=16)
    add("chain_18", (3.0, 2.0, 100.0, 50.0), clip_row=1, clip_count=18)
    add("float_op_outside", (-500.0, -500.0, -400.0, -400.0),
        blend=2 if float_op else 0)
    adversarial_dispatch.NAMES = names
    slots = len(recs)
    origins = np.array([[0.0, 0.0], [-0.5, 17.25], [37.75, -3.5]],
                       np.float32)
    dense = np.broadcast_to(np.stack(recs), (3, slots, 128)).copy()
    rows = np.zeros((3, 128), np.float32)
    rows[1, 0:4] = (0.0, 0.0, 50.5, 40.0)                 # a rect clip
    rows[2, 0:12] = (20.0, 10.0, 90.0, 50.0) + (8.0,) * 8  # rounded
    rows[2, 14:16] = (1.0, 1.0)
    rows[1:, 96:108] = IDENTITY_TROW
    rng = np.random.RandomState(11)
    return dict(dense=dense, counts=np.full(3, slots, np.int32),
                origins=origins,
                clear=np.array([0.1, 0.2, 0.3, 1.0], np.float32),
                f32_rows=rows,
                alpha_atlas=rng.rand(8, 8).astype(np.float32),
                surface_atlas=rng.rand(4, 8, 8).astype(np.float32),
                color_atlas=rng.rand(4, 8, 8).astype(np.float32))


adversarial_dispatch.NAMES = []

class HandFrame:
    """Frame arrays made by hand: f32 rows (payloads, clip records and
    gradient stops, each 128-aligned), instance records and a transform
    palette, with every tile of `origins` listing every instance."""

    def __init__(self, origins, atlas_hw=(192, 512), seed=5, block=1):
        self.rows = [np.zeros(128, np.float32)]
        self.inst = []
        self.xf = [IDENTITY_TROW]
        self.origins = np.asarray(origins, np.float32)
        rng = np.random.RandomState(seed)
        h, w = atlas_hw

        def u8(planes):
            shape = (planes, -(-h // block), -(-w // block))
            v = np.kron(rng.randint(0, 256, shape), np.ones((1, block, block)))
            return (v[:, :h, :w] / 255.0).astype(np.float32)
        self.alpha_atlas = u8(1)[0]
        self.surface_atlas = u8_planes(rng, (h, w))
        self.color_atlas = u8_planes(rng, (h, w))
        self.color_atlas[:, :, w // 2:] = u8(4)[:, :, w // 2:]

    def transform(self, row):
        self.xf.append(tuple(row))
        return len(self.xf) - 1

    def _push(self, values):
        values = np.asarray(values, np.float32).reshape(-1)
        addr = len(self.rows) * 128
        for i in range(0, len(values), 128):
            row = np.zeros(128, np.float32)
            chunk = values[i:i + 128]
            row[:len(chunk)] = chunk
            self.rows.append(row)
        return addr

    def stops(self, stops):
        """[(offset, r, g, b, a), ...] (premultiplied) -> their address."""
        recs = np.zeros((len(stops), 8), np.float32)
        recs[:, :5] = stops
        return self._push(recs)

    def clip(self, kind, rect, spatial=0, rest=(), invert=0.0, mode=0.0,
             uv=(0, 0, 0, 0), edges=()):
        """One clip record: [0:4] rect, [4:12] `rest` (radii, or a nine-
        patch's alloc size and stretch modes), [12] invert, [13] spatial,
        [14] kind, [15] the fast flag or nine-patch mode, [16:20] uv,
        [24:48] the half-planes `edges` (`polygon_edges`), and the
        transform row at [96:108]."""
        rec = np.zeros(128, np.float32)
        rec[0:4] = rect
        rec[4:4 + len(rest)] = rest
        rec[12:16] = (invert, spatial, kind, mode)
        rec[16:20] = uv
        rec[24:24 + len(edges)] = edges
        rec[96:108] = self.xf[spatial]
        return rec

    def prim(self, kind, payload, spatial=0, blend=0, edge_aa=15, clips=()):
        addr = self._push(np.asarray(payload, np.float32))
        caddr = 0
        for i, c in enumerate(clips):
            a = self._push(c)
            caddr = caddr if i else a
        self.inst.append((kind, spatial, addr, caddr, len(clips), blend,
                          edge_aa, 0))
        return len(self.inst) - 1

    def arrays(self):
        """(f32_buf, instances, transforms, tile_insts) as numpy."""
        n = len(self.inst)
        slots = 1 << max(3, int(np.ceil(np.log2(max(n, 1)))))
        ti = np.full((len(self.origins), slots), -1, np.int32)
        ti[:, :n] = np.arange(n)
        return (np.concatenate(self.rows), np.asarray(self.inst, np.int32),
                np.asarray(self.xf, np.float32), ti)


def polygon_edges(poly):
    """The 24 floats [24:48] of a polygon clip record (kind 3) for the
    convex device-space polygon `poly` (3 to 8 points), computed as the
    frame builder's `_polygon_clip_record` computes them: inward unit
    half-planes (a, b, c) in float64, unused ones (0, 0, 1e9)."""
    n = len(poly)
    cx = sum(p[0] for p in poly) / n
    cy = sum(p[1] for p in poly) / n
    out = []
    for i in range(8):
        a, b, c = 0.0, 0.0, 1e9
        if i < n:
            (x0, y0), (x1, y1) = poly[i], poly[(i + 1) % n]
            a, b = y0 - y1, x1 - x0
            ln = math.hypot(a, b)
            a, b = a / ln, b / ln
            c = -(a * x0 + b * y0)
            if a * cx + b * cy + c < 0:
                a, b, c = -a, -b, -c
        out += [a, b, c]
    return out


# numpy, but `where` of two Python floats stays float32 (as jax.numpy's
# and the port's do), so that the JAX package's math runs in float32
# throughout
Numpy32 = Float32Where


@contextlib.contextmanager
def jax_oracle_float32():
    """The JAX package's numpy oracle (`oracle/sw.py`, which hands its
    numpy to the pattern and blend math) with float32 `where`s, within the
    block: the port's `oracle.sw.float32_where` for the JAX package."""
    import webrender_tpu.oracle.sw as jsw
    jsw.np = Numpy32()
    try:
        yield
    finally:
        jsw.np = np


# the bounding box that makes the numpy oracle draw an instance everywhere
WHOLE = (-1e6, -1e6, 1e6, 1e6)


def oracle_tiles(h, clear, step=1.0, init=None, gl=False):
    """The JAX package's numpy oracle on hand frame `h`: every instance
    over the whole target (cleared to `clear`, or starting from `init`),
    its `patterns` and `blend` math by numpy; `gl`: under gl_flavor."""
    from webrender_tpu.oracle.sw import SoftwareRenderer
    f32, inst, xf, ti = h.arrays()
    nx = int(round((h.origins[:, 0].max() - h.origins[0, 0]) / (128 * step))
             ) + 1
    ny = len(h.origins) // nx
    sw = SoftwareRenderer(h.color_atlas, h.alpha_atlas,
                          surface_atlas_size=h.surface_atlas.shape[1:])
    sw.surface_atlas = h.surface_atlas
    if init is None:
        target = np.broadcast_to(clear[:, None, None],
                                 (4, ny * 64, nx * 128)).copy()
    else:
        target = init.reshape(ny, nx, 4, 64, 128).transpose(2, 0, 3, 1, 4) \
            .reshape(4, ny * 64, nx * 128).copy()
    frame = types.SimpleNamespace(
        f32_buf=f32, instances=inst, transforms=xf, gl_flavor=gl,
        inst_bboxes=np.tile(np.asarray(WHOLE, np.float32), (len(inst), 1)))
    p = types.SimpleNamespace(tile_insts=ti, inst_order=None,
                              origin=tuple(h.origins[0]), raster_step=step)
    sw._raster(frame, p, target)
    return target.reshape(4, ny, 64, nx, 128).transpose(1, 3, 0, 2, 4) \
        .reshape(ny * nx, 4, 64, 128)


def polygon_inside(bbox):
    """A triangle inside the device box `bbox` (x0, y0, x1, y1) that
    leaves part of it out."""
    x0, y0, x1, y1 = (float(v) for v in bbox)
    return ((x0, y0), (x1, y0 + 0.6 * (y1 - y0)), (x0 + 0.3 * (x1 - x0), y1))


def polygon_clip(rows, row, poly):
    """Turns clip record `row` of f32 rows `rows` ([R, 128], numpy or
    torch) into a polygon clip (kind 3) over the device-space polygon
    `poly`, in place."""
    edges = np.asarray(polygon_edges(poly), np.float32)
    if isinstance(rows, torch.Tensor):
        edges = torch.from_numpy(edges)
    rows[row, 14] = 3.0
    rows[row, 24:48] = edges


def hold_polygon_dispatch(inp, kinds, blends):
    """The dispatch `inp` (`scenes.kernel_inputs`) with the clip record of
    its first clipped record turned into a triangle over that record's
    first tile: refused without `polygon_clips` (the build it would take
    has no polygon), drawn with it on the general instantiation, equal to
    the Pallas kernel in interpret mode on the tiles that list the clip,
    and different from the unedited dispatch."""
    dense, rows = inp["dense"], inp["f32_rows"].clone()
    valid = torch.arange(dense.shape[1])[None, :] < inp["counts"][:, None]
    clipped = valid & (dense[..., 67] > 0)
    tile = int(torch.nonzero(clipped.any(1))[0])
    row = dense[tile, :, 68][clipped[tile]][0].long()
    ox, oy = (float(v) for v in inp["origins"][tile])
    polygon_clip(rows, row, ((ox, oy), (ox + 128.0, oy + 40.0),
                             (ox + 40.0, oy + 64.0)))
    args = dict(inp, f32_rows=rows)
    call = dict(kinds=kinds, blends=blends, mask_clips=inp["mask_clips"])
    before = (tr.LaunchCounts.launches, tr.LaunchCounts.plain_calls)
    with pytest.raises(ValueError, match="polygon_clips"):
        tr.render_tiles_dense(*positional(args), **call)
    assert (tr.LaunchCounts.launches, tr.LaunchCounts.plain_calls) == before
    assert tr.instantiation(**call, polygon_clips=True) == "general"
    got = tr.render_tiles_dense(*positional(args), **call,
                                polygon_clips=True)
    assert tr.LaunchCounts.plain_calls == before[1] + 1
    tiles = torch.nonzero(
        (valid & (dense[..., 67] > 0) & (dense[..., 68] == row)).any(1)
    ).reshape(-1)
    sub = pallas_args(args)
    for k in ("dense", "counts", "origins"):
        sub[k] = sub[k][tiles.numpy()]
    want = run_pallas(sub, kinds, blends, inp["mask_clips"])
    np.testing.assert_array_equal(got[tiles].numpy(), want)
    unedited = tr.render_tiles_dense(*positional(inp), **call)
    assert not torch.equal(got[tile], unedited[tile])
