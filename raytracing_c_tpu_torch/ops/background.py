"""Environment background for miss rays.

Counterpart of `raytracing_c_tpu/ops/background.py`: equirect mapping
u = 0.5 + atan2(z, x)/2pi, v = 0.5 - asin(y)/pi with a bilinear tap and the
sRGB decode (sample_background, driver.c:95-104), or a constant colour.
"""

from __future__ import annotations

import math

import torch

from raytracing_c_tpu_torch.models.scene import BG_EQUIRECT
from raytracing_c_tpu_torch.ops import texture
from raytracing_c_tpu_torch.utils import color
from raytracing_c_tpu_torch.utils.vec3 import Vec3


def eval_background(scene, direction: Vec3) -> Vec3:
    """Background radiance for unit directions (Vec3 of (R,)) -> linear RGB."""
    bg = scene.background
    r = direction.shape[0]
    if bg.kind == BG_EQUIRECT and bg.tex_id >= 0:
        u = 0.5 + torch.atan2(direction.z, direction.x) * (0.5 / math.pi)
        v = 0.5 - torch.asin(torch.clamp(direction.y, -1.0, 1.0)) * (1.0 / math.pi)
        tid = torch.full((r,), bg.tex_id, dtype=torch.int32, device=u.device)
        return texture.sample_bilinear(scene.atlas, tid, u, v).map(color.srgb_to_linear)
    c = bg.color
    return Vec3(c[0].expand(r), c[1].expand(r), c[2].expand(r))
