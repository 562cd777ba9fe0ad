"""Environment-light importance sampling for next-event estimation (NEE).

Counterpart of `raytracing_c_tpu/ops/env_light.py`. The equirect map's
texels form a discrete distribution, linear luminance x the sin(theta) row
weight; a Vose alias table samples it with one uniform (slot and accept
fraction) and a compare. The texel is jittered uniformly in (u, v) inside
its footprint and the pdf is evaluated at the sampled point, so that
`eval_pdf` of a sampled direction is the sampler's own pdf and the MIS
weights of the two strategies sum to one.

The tables are built on the host in float64 exactly as the JAX package
builds them (the same Vose loop and pop order), so `prob`, `alias` and
`lum_p` are bit-identical to its tables; they are kept flat, (w*h,), where
the JAX package pads them into 128-lane pages for its one-hot lane fetch.
The build is a Python loop over the texels, so a scene builds its table
only when a NEE render needs it (`scene_env_light`) and keeps it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from raytracing_c_tpu_torch.models.scene import BG_EQUIRECT, _to
from raytracing_c_tpu_torch.utils import spans
from raytracing_c_tpu_torch.utils.vec3 import Vec3

TWO_PI = 2.0 * math.pi
INV_2PISQ = float(1.0 / (2.0 * np.pi * np.pi))


@dataclass
class EnvLight:
    prob: torch.Tensor  # (w*h,) f32, alias acceptance probability per texel
    alias: torch.Tensor  # (w*h,) i64, alias texel id
    lum_p: torch.Tensor  # (w*h,) f32, discrete texel probability (sums to 1)
    w: int
    h: int
    seconds: float = 0.0  # wall seconds of the host build

    to = _to


def build_env_light(atlas, tex_id: int) -> EnvLight | None:
    """Host build of the alias table from the (u8, sRGB) equirect texture
    `tex_id` of the atlas, an `env_table` span. Returns None for an
    all-black map."""
    with spans.timed("env_table") as clock:
        off = int(atlas.offset[tex_id])
        w = int(atlas.width[tex_id])
        h = int(atlas.height[tex_id])
        sl = slice(off, off + w * h)

        def lin(c):
            # the JAX package's pure-pow sRGB decode
            return np.power(c[sl].cpu().numpy().astype(np.float64) / 255.0, 2.2)

        lum = (0.2126 * lin(atlas.tex_r) + 0.7152 * lin(atlas.tex_g)
               + 0.0722 * lin(atlas.tex_b)).reshape(h, w)
        sin_t = np.sin(np.pi * (np.arange(h) + 0.5) / h)[:, None]
        wgt = (lum * sin_t).reshape(-1)
        total = wgt.sum()
        if total <= 0.0:
            return None
        p = wgt / total

        # Vose alias construction on Python floats (float64, as numpy's): the
        # JAX package's loop with its small/large pop order
        n = w * h
        scaled = (p * n).tolist()
        alias = [0] * n
        prob = [1.0] * n
        small = np.flatnonzero(p * n < 1.0).tolist()
        large = np.flatnonzero(p * n >= 1.0).tolist()
        while small and large:
            s, g = small.pop(), large.pop()
            prob[s] = scaled[s]
            alias[s] = g
            scaled[g] = scaled[g] - (1.0 - scaled[s])
            (small if scaled[g] < 1.0 else large).append(g)

        dev = atlas.tex_r.device
        out = EnvLight(
            prob=torch.tensor(np.asarray(prob, np.float32), device=dev),
            alias=torch.tensor(alias, dtype=torch.int64, device=dev),
            lum_p=torch.tensor(p.astype(np.float32), device=dev), w=w, h=h,
        )
    out.seconds = clock.seconds
    return out


def scene_env_light(scene) -> EnvLight | None:
    """The scene's env-light table, built at the first call (for an equirect
    background) and kept on the scene; None for a constant sky or an
    all-black map."""
    bg = scene.background
    if scene.env_light is None and bg.kind == BG_EQUIRECT and bg.tex_id >= 0:
        scene.env_light = build_env_light(scene.atlas, bg.tex_id)
    return scene.env_light


def _dir_from_uv(u, v) -> Vec3:
    """Inverse of the equirect mapping (ops/background.py): u = 0.5 +
    atan2(z, x)/2pi, v = 0.5 - asin(y)/pi."""
    phi = (u - 0.5) * TWO_PI
    ang = (0.5 - v) * math.pi
    r = torch.cos(ang)  # sin(theta), the horizontal radius
    return Vec3(r * torch.cos(phi), torch.sin(ang), r * torch.sin(phi))


def sample(env: EnvLight, u_sel, u_jx, u_jy):
    """One env direction per lane: u_sel picks the alias slot and its accept
    fraction, u_jx/u_jy jitter inside the texel. Returns (direction Vec3,
    pdf (R,) in 1/sr)."""
    n = env.w * env.h
    r_ = u_sel * n
    j = torch.clamp(r_.to(torch.int32), 0, n - 1)
    frac = r_ - j.to(torch.float32)
    j = j.long()
    texel = torch.where(frac < env.prob[j], j, env.alias[j])

    x = texel % env.w
    y = texel // env.w
    u = (x.to(torch.float32) + u_jx) / env.w
    v = (y.to(torch.float32) + u_jy) / env.h
    sin_t = torch.clamp_min(torch.cos((0.5 - v) * math.pi), 1e-6)
    pdf = env.lum_p[texel] * n * INV_2PISQ / sin_t
    return _dir_from_uv(u, v), pdf


def eval_pdf(env: EnvLight, d: Vec3):
    """Solid-angle pdf of `sample` at unit directions d: the light-side term
    of the BRDF sample's MIS weight at a miss."""
    u = 0.5 + torch.atan2(d.z, d.x) * (0.5 / math.pi)
    v = 0.5 - torch.asin(torch.clamp(d.y, -1.0, 1.0)) * (1.0 / math.pi)
    x = torch.clamp((u * env.w).to(torch.int32), 0, env.w - 1)
    y = torch.clamp((v * env.h).to(torch.int32), 0, env.h - 1)
    sin_t = torch.clamp_min(torch.cos((0.5 - v) * math.pi), 1e-6)
    return env.lum_p[(y * env.w + x).long()] * (env.w * env.h) * INV_2PISQ / sin_t
