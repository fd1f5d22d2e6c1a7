"""The SVG-filter offscreen passes as torch ops.

Ports of the JAX renderer's XLA glue for the passes that SVG filter graphs
and the CSS `srgb-to-linear`, `linear-to-srgb` and `component-transfer`
filters emit (webrender_tpu/renderer/renderer.py):

* `apply_channel_lut` (`_apply_channel_lut`, :319): a 256-entry LUT per
  channel on straight-alpha values, `PASS_CHANNEL_LUT`;
* `apply_srgb` (`_apply_srgb`, :283): sRGB <-> linearRGB on straight rgb,
  `PASS_SRGB`;
* `apply_arith` (`_apply_arith`, :292): feComposite
  `operator="arithmetic"`, `k1·a·b + k2·a + k3·b + k4` on unpremultiplied
  inputs, `PASS_ARITH`.

Each takes a planar premultiplied [4, h, w] region on the u8 grid and
returns the unquantized result; the renderer quantizes it at the RGBA8
target write (`raster.quantize_unorm8`).  The order of operations is
numpy's (the JAX package's oracle, `oracle/sw.py`): products and sums left
to right, `x / c` a division, `rint` half to even.  The sRGB conversions
are `ops/blend.py`'s, whose power is `exp(y·log(x))`: torch's `exp` and
`log` need not round as numpy's do, so those results may differ from the
oracle's by a step of the u8 grid after the quantize.
"""
from __future__ import annotations

import torch

from . import blend as blend_mod
from . import xp


def _straight(c):
    """c with its rgb divided by its alpha where the alpha is above 1e-6
    (`blend._unpremult`'s guard); the alpha stays."""
    safe = xp.where(c[3] > 1e-6, c[3], 1.0)
    return torch.stack([c[0] / safe, c[1] / safe, c[2] / safe, c[3]], 0)


def apply_channel_lut(src, lut):
    """`lut` ([4, 256] f32) applied to each straight-alpha channel of
    `src`, indexed by round(value · 255) clipped to [0, 255]; the result
    is premultiplied by its new alpha."""
    straight = _straight(src)
    idx = torch.round(straight * 255.0).clamp(0.0, 255.0).long()
    out = torch.stack([lut[c][idx[c]] for c in range(4)], 0)
    na = out[3]
    return torch.stack([out[0] * na, out[1] * na, out[2] * na, na], 0)


def apply_srgb(src, to_linear: bool):
    """Premultiplied sRGB -> linearRGB (`to_linear`) or back."""
    if to_linear:
        return blend_mod.premult_srgb_to_linear(xp, src)
    return blend_mod.premult_linear_to_srgb(xp, src)


def apply_arith(a, b, k, linear: bool):
    """feComposite arithmetic: `k` = (k1, k2, k3, k4); the inputs
    unpremultiplied (and first converted to linearRGB when `linear`), the
    result clipped to [0, 1] and stored as it is, as premultiplied (the
    reference's cs_svg_filter.glsl:503), converted back when `linear`."""
    k1, k2, k3, k4 = (float(v) for v in k)
    if linear:
        a = blend_mod.premult_srgb_to_linear(xp, a)
        b = blend_mod.premult_srgb_to_linear(xp, b)
    a, b = _straight(a), _straight(b)
    out = xp.clip(k1 * a * b + k2 * a + k3 * b + k4, 0.0, 1.0)
    if linear:
        out = blend_mod.premult_linear_to_srgb(xp, out)
    return out
