"""Texture table: host-side parse + tensor evaluation (port of
tungsten_tpu/scene/textures.py).

A texture value in scene JSON is a scalar, an [r,g,b] array, a path
string (bitmap), or a typed object (checker / constant / bitmap).
Checker: on iff (floor(u*resU) ^ floor(v*resV)) & 1.  Bitmap: bilinear,
wrap addressing, v flipped.
"""
from __future__ import annotations

import numpy as np
import torch

from tungsten_tpu_torch.utils.vecmath import take

TEX_CONST = 0
TEX_CHECKER = 1
TEX_BITMAP = 2


class TextureTableBuilder:
    """Accumulates textures during flattening; emits SoA numpy arrays."""

    def __init__(self, resolve_path):
        self.resolve_path = resolve_path
        self.types: list[int] = []
        self.const: list[np.ndarray] = []
        self.params: list[np.ndarray] = []
        self.bitmap_id: list[int] = []
        self.bitmaps: list[np.ndarray] = []
        self._bitmap_cache: dict[str, int] = {}

    def _push(self, ttype, const=(0, 0, 0), params=(0,) * 8, bitmap=-1) -> int:
        self.types.append(ttype)
        self.const.append(np.asarray(const, np.float32))
        self.params.append(np.asarray(params, np.float32))
        self.bitmap_id.append(bitmap)
        return len(self.types) - 1

    def _load_bitmap(self, rel_path) -> int:
        key = str(rel_path)
        if key in self._bitmap_cache:
            return self._bitmap_cache[key]
        from tungsten_tpu_torch.io import image as imageio_mod
        img = imageio_mod.load_image(self.resolve_path(rel_path))
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        self.bitmaps.append(np.ascontiguousarray(img, np.float32))
        self._bitmap_cache[key] = len(self.bitmaps) - 1
        return self._bitmap_cache[key]

    def add(self, value, default=None) -> int:
        """Parse a texture JSON value; returns texture index."""
        if value is None:
            value = default if default is not None else 0.0
        if isinstance(value, (int, float)):
            return self._push(TEX_CONST, const=(value,) * 3)
        if isinstance(value, (list, tuple)):
            v = list(value) + [value[-1]] * (3 - len(value))
            return self._push(TEX_CONST, const=v[:3])
        if isinstance(value, str):
            return self._push(TEX_BITMAP, bitmap=self._load_bitmap(value))
        if isinstance(value, dict):
            t = value.get("type", "constant")
            if t == "constant":
                return self.add(value.get("value", 0.0))
            if t == "checker":
                on = value.get("on_color", [0.8, 0.8, 0.8])
                off = value.get("off_color", [0.2, 0.2, 0.2])
                if isinstance(on, (int, float)):
                    on = [on] * 3
                if isinstance(off, (int, float)):
                    off = [off] * 3
                ru = float(value.get("res_u", 20))
                rv = float(value.get("res_v", 20))
                return self._push(
                    TEX_CHECKER, const=on, params=tuple(off) + (ru, rv, 0, 0, 0)
                )
            if t == "bitmap":
                return self._push(TEX_BITMAP,
                                  bitmap=self._load_bitmap(value["file"]))
            raise ValueError(f"unsupported texture type: {t}")
        raise TypeError(f"bad texture value: {value!r}")

    def finalize(self):
        """Returns (tex_type, tex_const, tex_params, tex_bitmap_id,
        bitmaps) as numpy arrays (bitmaps: a list of (H, W, 3))."""
        if not self.types:
            self._push(TEX_CONST)
        return (
            np.asarray(self.types, np.int32),
            np.stack(self.const).astype(np.float32),
            np.stack(self.params).astype(np.float32),
            np.asarray(self.bitmap_id, np.int32),
            list(self.bitmaps),
        )


def eval_texture(tex_type, tex_const, tex_params, tex_bitmap_id, bitmaps,
                 tex_idx, uv):
    """Evaluate textures for a batch: tex_idx (R,), uv (R,2) -> (R,3)."""
    t = tex_type[tex_idx]
    const = take(tex_const, tex_idx)
    p = take(tex_params, tex_idx)
    ui = torch.floor(uv[..., 0] * p[..., 3]).to(torch.int32)
    vi = torch.floor(uv[..., 1] * p[..., 4]).to(torch.int32)
    on = ((ui ^ vi) & 1) == 1
    checker = torch.where(on[..., None], const, p[..., 0:3])
    out = torch.where((t == TEX_CHECKER)[..., None], checker, const)
    if bitmaps:
        bid = tex_bitmap_id[tex_idx]
        for i, img in enumerate(bitmaps):
            val = sample_bitmap(img, uv)
            out = torch.where(((t == TEX_BITMAP) & (bid == i))[..., None],
                              val, out)
    return out


def _bilinear(c00, c10, c01, c11, fu, fv):
    return (c00 * (1 - fu) + c10 * fu) * (1 - fv) + \
        (c01 * (1 - fu) + c11 * fu) * fv


def sample_bitmap_quad(quad, h, w, uv, active=None):
    """Bilinear tap through a (H*W, 12) neighborhood table (see
    flatten._build_env_quad): one row gather fetches the whole 2x2
    footprint.  Lanes with `active` False tap row 0."""
    u = uv[..., 0] * w - 0.5
    v = (1.0 - uv[..., 1]) * h - 0.5
    iu0 = torch.floor(u).to(torch.int32)
    iv0 = torch.floor(v).to(torch.int32)
    fu = (u - iu0)[..., None]
    fv = (v - iv0)[..., None]
    idx = torch.remainder(iv0, h) * w + torch.remainder(iu0, w)
    if active is not None:
        idx = torch.where(active, idx, 0)
    rows = quad[idx.long()].to(torch.float32)
    return _bilinear(rows[..., 0:3], rows[..., 3:6], rows[..., 6:9],
                     rows[..., 9:12], fu, fv)


def sample_bitmap(img, uv):
    """Bilinear, wrap addressing, v flipped (BitmapTexture::operator[])."""
    h, w = img.shape[0], img.shape[1]
    u = uv[..., 0] * w - 0.5
    v = (1.0 - uv[..., 1]) * h - 0.5
    iu0 = torch.floor(u).to(torch.int32)
    iv0 = torch.floor(v).to(torch.int32)
    fu = (u - iu0)[..., None]
    fv = (v - iv0)[..., None]
    iu0 = torch.remainder(iu0, w)
    iv0 = torch.remainder(iv0, h)
    iu1 = torch.remainder(iu0 + 1, w)
    iv1 = torch.remainder(iv0 + 1, h)
    flat = img.reshape(h * w, -1)
    r0 = iv0 * w
    r1 = iv1 * w
    c00 = take(flat, (r0 + iu0).long()).to(torch.float32)
    c10 = take(flat, (r0 + iu1).long()).to(torch.float32)
    c01 = take(flat, (r1 + iu0).long()).to(torch.float32)
    c11 = take(flat, (r1 + iu1).long()).to(torch.float32)
    return _bilinear(c00, c10, c01, c11, fu, fv)
