"""Image resize for screenshots: `jax.image.resize(x, shape, "linear")`
in torch.

The JAX renderer scales a screenshot with `jax.image.resize` (linear,
`antialias=True`), which scales each resized axis by a weight matrix
(`jax/_src/image/scale.py::compute_weight_mat`): a triangle kernel at
each output pixel's centre mapped into the input, widened by the inverse
scale when it scales down (the antialiasing), each column normalised by
its sum, zero where the centre falls outside the input.  PyTorch's
`interpolate` does not widen the kernel by default, and with
`antialias=True` follows PIL's weights, which need not equal JAX's bit
for bit.  So the weights here are JAX's, computed in float32 in its
order of operations on the host (each column summed in input order, as
numpy sums axis 0), and applied on the image's device as two plain
contractions, the axis JAX's `einsum` path contracts first first.  Each
output sample is a chain of fused multiply-adds over its band of nonzero
weights in input order, one elementwise torch op at a time: no matrix
product, so no TF32 and no library's summation order, and the card rounds
every sum as the CPU does.  On the CPU here that equals XLA's sum along
the rows; along the columns XLA sums in an order of its own, so the result
may differ from JAX's by an ulp, which the u8 conversion shows only at
exact ties (`tests/test_torch_screenshot.py` states the counts).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def _weights_host(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32: `compute_weight_mat(in_size, out_size,
    out_size / in_size, 0.0, triangle, antialias=True)`."""
    scale = out_size / in_size          # a Python float, as in jax's _resize
    inv_scale = 1.0 / scale             # in double, then float32 below
    kernel_scale = np.float32(max(inv_scale, 1.0))
    inv32 = np.float32(inv_scale)
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) \
        * inv32 - np.float32(0.0) - np.float32(0.5)
    x = np.abs(sample_f[None, :] -
               np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    safe = np.where(total != 0, total, np.float32(1.0))
    weights = np.where(np.abs(total) > np.float32(1000.0 * np.finfo(
        np.float32).eps), weights / safe, np.float32(0.0))
    inside = (sample_f >= np.float32(-0.5)) & \
        (sample_f <= np.float32(in_size - 0.5))
    return np.where(inside[None, :], weights,
                    np.float32(0.0)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _band_host(in_size: int, out_size: int):
    """(rows [k, out_size] int64, weights [k, out_size] float32): for each
    output sample the k input samples from its first nonzero weight on,
    and their weights (0 past the input or the sample's band)."""
    w = _weights_host(in_size, out_size)
    nz = w != 0
    has = nz.any(0)
    lo = np.where(has, nz.argmax(0), 0)
    hi = np.where(has, in_size - 1 - nz[::-1].argmax(0), 0)
    k = int((hi - lo).max()) + 1
    rows = lo[None, :] + np.arange(k)[:, None]
    inside = rows < in_size
    rows = np.minimum(rows, in_size - 1)
    wk = np.where(inside, w[rows, np.arange(out_size)[None, :]],
                  np.float32(0.0)).astype(np.float32)
    return rows, wk


def _contract(img: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """The weights of `axis` (1: rows, 2: columns) of [C, H, W] `img`
    applied to it: each output sample a chain of fused multiply-adds over
    its band in input order from zero, as XLA's CPU dot sums (each step in
    float64, where the float32 product is exact, rounded to float32 once),
    one elementwise operation at a time: the same rounding on every
    device."""
    rows, wk = _band_host(img.shape[axis], out_size)
    rows = torch.from_numpy(rows).to(img.device)
    wk = torch.from_numpy(wk).to(img.device, torch.float64)
    shape = (1, -1, 1) if axis == 1 else (1, 1, -1)
    out = None
    for k in range(rows.shape[0]):
        term = img.index_select(axis, rows[k]).double() * wk[k].reshape(shape)
        out = (term if out is None else term + out.double()).float()
    return out


def resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """`jax.image.resize(img, (C, out_h, out_w), "linear")` of a [C, H, W]
    float32 image: an axis whose size does not change is left as it is,
    as in JAX; of two resized axes, the one whose contraction costs less
    first (opt_einsum's choice for JAX's three-operand einsum)."""
    c, h, w = img.shape
    axes = [a for a, n, m in ((1, h, out_h), (2, w, out_w)) if n != m]
    if len(axes) == 2 and h * w * out_w + h * out_h * out_w < \
            h * w * out_h + out_h * w * out_w:
        axes = [2, 1]
    for a in axes:
        img = _contract(img, a, out_h if a == 1 else out_w)
    return img
