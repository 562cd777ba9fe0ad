"""Gather-based texture sampling from the flat channel-plane atlas.

Counterpart of `raytracing_c_tpu/ops/texture.py` with the same wrap
semantics: repeat wrap including the negative-UV fixup (driver.c:32-37,
51-56), bilinear clamps the +1 texel at the image edge (driver.c:66-67),
u8 -> f32 divides by 255.999 (driver.c:43-45). Texels are plain gathers on
the flat planes; the JAX package's tiled 13x8 pages are a TPU gather
workaround with the same results.
"""

from __future__ import annotations

import torch

from raytracing_c_tpu_torch.utils.vec3 import Vec3


def _wrap01(x):
    """Repeat wrap: the reference's negative fixup + fract is x - floor(x)."""
    return x - torch.floor(x)


def _fetch(atlas, off, w, x, y) -> Vec3:
    """Texel (x, y) of the texture at `off` -> Vec3 rgb in [0, 1]."""
    idx = (off + y * w + x).long()
    s = 1.0 / 255.999  # torch casts the scalar to float32, as the JAX package does
    return Vec3(atlas.tex_r[idx].to(torch.float32) * s,
                atlas.tex_g[idx].to(torch.float32) * s,
                atlas.tex_b[idx].to(torch.float32) * s)


def _params(atlas, tex_id):
    tid = torch.clamp_min(tex_id, 0).long()
    return atlas.offset[tid], atlas.width[tid], atlas.height[tid]


def sample_nearest(atlas, tex_id, uv_u, uv_v) -> Vec3:
    """sample_texture_nearest (driver.c:31-47). tex_id: (R,) i32, clamped
    to 0 for "no texture" lanes (callers select on tex_id >= 0)."""
    off, w, h = _params(atlas, tex_id)
    x = torch.minimum(torch.clamp_min((_wrap01(uv_u) * w).to(torch.int32), 0), w - 1)
    y = torch.minimum(torch.clamp_min((_wrap01(uv_v) * h).to(torch.int32), 0), h - 1)
    return _fetch(atlas, off, w, x, y)


def sample_bilinear(atlas, tex_id, uv_u, uv_v) -> Vec3:
    """sample_texture_bilinear (driver.c:49-93), the pipeline default."""
    off, w, h = _params(atlas, tex_id)
    px = _wrap01(uv_u) * w
    py = _wrap01(uv_v) * h
    x0 = torch.minimum(torch.clamp_min(px.to(torch.int32), 0), w - 1)
    y0 = torch.minimum(torch.clamp_min(py.to(torch.int32), 0), h - 1)
    a = px - x0
    b = py - y0
    x1 = torch.minimum(x0 + 1, w - 1)
    y1 = torch.minimum(y0 + 1, h - 1)
    c0 = _fetch(atlas, off, w, x0, y0).lerp(_fetch(atlas, off, w, x1, y0), a)
    c1 = _fetch(atlas, off, w, x0, y1).lerp(_fetch(atlas, off, w, x1, y1), a)
    return c0.lerp(c1, b)


def sample(atlas, tex_id, uv_u, uv_v, mode: str = "bilinear") -> Vec3:
    if mode == "nearest":
        return sample_nearest(atlas, tex_id, uv_u, uv_v)
    return sample_bilinear(atlas, tex_id, uv_u, uv_v)
