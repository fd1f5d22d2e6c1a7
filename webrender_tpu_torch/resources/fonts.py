"""Glyph answers without a font stack.

`ResourceCache` builds its FreeType `FontContext` (matplotlib's `ft2font`)
when the first font is added or used.  Where no font stack exists at all,
`ReplayFontContext` gives the answers a `RecordingFontContext` kept on a
machine that has one, so scenes with text still build
(`testdata/glyphs.npz`, written by scenes.py).
"""
from __future__ import annotations

import json
from typing import Dict

import numpy as np


def _key(*parts) -> str:
    return repr(parts)


class RecordingFontContext:
    """Wraps a `FontContext` and keeps every answer its glyph calls give,
    so that `ReplayFontContext` can give them again without FreeType."""

    def __init__(self, ctx):
        self._ctx = ctx
        self.scalars: Dict[str, tuple] = {}
        self.arrays: Dict[str, np.ndarray] = {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._ctx, name)

    def glyph_index(self, key, ch):
        v = self._ctx.glyph_index(key, ch)
        self.scalars[_key("index", key.namespace, key.key, ch)] = (int(v),)
        return v

    def linear_advance(self, key, size, gi):
        v = self._ctx.linear_advance(key, size, gi)
        self.scalars[_key("advance", key.namespace, key.key, float(size),
                          int(gi))] = (float(v),)
        return v

    def rasterize(self, key, size, glyph_index, mono=False,
                  synthetic_bold=0.0, synthetic_italics_deg=0.0, face=None):
        alpha, left, top, adv = self._ctx.rasterize(
            key, size, glyph_index, mono=mono, synthetic_bold=synthetic_bold,
            synthetic_italics_deg=synthetic_italics_deg, face=face)
        k = _key("raster", key.namespace, key.key, float(size),
                 int(glyph_index), bool(mono), float(synthetic_bold),
                 float(synthetic_italics_deg))
        self.scalars[k] = (float(left), float(top), float(adv))
        self.arrays[k] = np.asarray(alpha)
        return alpha, left, top, adv

    def rasterize_lcd(self, key, size, glyph_index, subpx_x=0.0):
        m3, left, top = self._ctx.rasterize_lcd(key, size, glyph_index,
                                                subpx_x)
        k = _key("lcd", key.namespace, key.key, float(size),
                 int(glyph_index), float(subpx_x))
        self.scalars[k] = (float(left), float(top))
        self.arrays[k] = np.asarray(m3)
        return m3, left, top

    def save(self, path) -> None:
        keys = sorted(self.scalars)
        arrays = {f"a{i}": self.arrays[k] for i, k in enumerate(keys)
                  if k in self.arrays}
        np.savez_compressed(
            path, keys=np.array(keys),
            scalars=np.array(json.dumps([self.scalars[k] for k in keys])),
            **arrays)


class ReplayFontContext:
    """Answers the glyph calls a `RecordingFontContext` kept: the font
    files named by `add_font` are never opened.  A call that was not
    recorded raises KeyError."""

    def __init__(self, path):
        z = np.load(path)
        keys = [str(k) for k in z["keys"]]
        scalars = json.loads(str(z["scalars"]))
        self._table = {k: (tuple(s), z[f"a{i}"] if f"a{i}" in z.files
                           else None)
                       for i, (k, s) in enumerate(zip(keys, scalars))}
        self.faces: Dict = {}

    def _get(self, *parts):
        k = _key(*parts)
        if k not in self._table:
            raise KeyError(f"glyph call {k} was not recorded")
        return self._table[k]

    def add_font(self, key, data, path, index=0):
        self.faces[(key.namespace, key.key)] = path

    def delete_font(self, key):
        self.faces.pop((key.namespace, key.key), None)

    def has_font(self, key):
        return (key.namespace, key.key) in self.faces

    def thread_local_face(self, key):
        return None

    def glyph_index(self, key, ch):
        return self._get("index", key.namespace, key.key, ch)[0][0]

    def linear_advance(self, key, size, gi):
        return self._get("advance", key.namespace, key.key, float(size),
                         int(gi))[0][0]

    def rasterize(self, key, size, glyph_index, mono=False,
                  synthetic_bold=0.0, synthetic_italics_deg=0.0, face=None):
        (left, top, adv), alpha = self._get(
            "raster", key.namespace, key.key, float(size), int(glyph_index),
            bool(mono), float(synthetic_bold), float(synthetic_italics_deg))
        return alpha.copy(), left, top, adv

    def rasterize_lcd(self, key, size, glyph_index, subpx_x=0.0):
        (left, top), m3 = self._get("lcd", key.namespace, key.key,
                                    float(size), int(glyph_index),
                                    float(subpx_x))
        return m3.copy(), left, top
