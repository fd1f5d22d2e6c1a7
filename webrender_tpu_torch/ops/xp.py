"""A torch array module for the single-source math of `ops/patterns.py`
and `ops/blend.py`.

Those modules take an array module `xp` (numpy on the host, jax.numpy in
the JAX package they were copied from).  This module gives them
torch tensors with numpy's rounding, so each function returns the same
f32 bits as its numpy run:

* `rint` and `round` round half to even (`torch.round`);
* `sqrt` of float32 is correctly rounded (through float64);
* `maximum`, `minimum`, `clip` and `where` take Python scalars and cast
  them to the tensor's dtype, as numpy casts weak scalars;
* `take` indexes the flattened tensor;
* `divide` divides by a Python scalar as a tensor on the dividend's
  device: on CUDA, torch multiplies by the reciprocal of a Python (CPU)
  scalar divisor instead, which rounds twice where numpy rounds once;
* no fused op that rounds once where numpy rounds twice (no `addcmul`,
  no `lerp`): every function here is one elementwise op or pure data
  movement.
"""
from __future__ import annotations

import torch


def _ref(*args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a
    return None


def _t(x, like):
    """`x` as a tensor on `like`'s device; Python scalars take `like`'s
    dtype when it is floating (numpy's weak-scalar rule)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, bool):
        dtype = torch.bool
    elif isinstance(x, float):
        dtype = like.dtype if like is not None and \
            like.is_floating_point() else torch.float32
    else:
        # an int beside a bool tensor (a `where` choosing between ints)
        # stays an int, as in numpy
        dtype = like.dtype if like is not None and \
            like.dtype != torch.bool else None
    return torch.as_tensor(x, dtype=dtype,
                           device=like.device if like is not None else None)


def _pair(a, b):
    ref = _ref(a, b)
    return _t(a, ref), _t(b, ref)


def where(cond, a, b):
    ref = _ref(a, b, cond)
    return torch.where(_t(cond, ref), _t(a, ref), _t(b, ref))


def maximum(a, b):
    return torch.maximum(*_pair(a, b))


def minimum(a, b):
    return torch.minimum(*_pair(a, b))


def clip(x, lo, hi):
    # numpy's clip is minimum(maximum(x, lo), hi)
    return minimum(maximum(x, lo), hi)


def divide(a, b):
    return torch.div(*_pair(a, b))


def floor(x):
    return torch.floor(x)


def ceil(x):
    return torch.ceil(x)


def abs(x):  # noqa: A001 - array-module name
    return torch.abs(x)


def sqrt(x):
    # torch's vectorised float32 sqrt on the CPU is not correctly rounded
    # (AVX-512: about 6 values in 1000 a unit in the last place off); the
    # float64 root rounded to float32 is (the double rounding is
    # innocuous for a square root), as numpy's and the card's sqrtf are
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def exp(x):
    return torch.exp(x)


def log(x):
    return torch.log(x)


def sign(x):
    return torch.sign(x)


def rint(x):
    return torch.round(x)


def round(x, decimals=0):  # noqa: A001 - array-module name
    return torch.round(x, decimals=decimals)


def stack(xs, axis=0):
    return torch.stack(list(xs), dim=axis)


def broadcast_to(x, shape):
    ref = x if isinstance(x, torch.Tensor) else None
    return torch.broadcast_to(_t(x, ref), tuple(shape))


def take(a, idx):
    return a.reshape(-1)[idx]


def arange(*args, dtype=None, device=None):
    return torch.arange(*args, dtype=dtype, device=device)


def zeros(shape, dtype=torch.float32, device=None):
    """numpy's dtype names ("float32") are taken too."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, dtype=torch.float32, device=None):
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.ones(shape, dtype=dtype, device=device)


def ones_like(x):
    return torch.ones_like(x)


def full_like(x, v):
    return torch.full_like(x, v)


def pad(x, pad_width, constant_values=0.0):
    """numpy-style `pad_width` ((before, after) per axis), constant mode."""
    flat = []
    for before, after in reversed([tuple(p) for p in pad_width]):
        flat += [before, after]
    return torch.nn.functional.pad(x, flat, value=constant_values)


def meshgrid(*xs, indexing="xy"):
    return torch.meshgrid(*xs, indexing=indexing)
