"""Pinhole camera ray generation (component-plane output).

Counterpart of `raytracing_c_tpu/render/camera.py`: jittered uv in
[-1, 1], aspect scaling on x, y flip, -focal_length forward, rotation by
the view matrix's upper-left 3x3 (raytracer.c:641-698).
"""

from __future__ import annotations

import numpy as np
import torch

from raytracing_c_tpu_torch.utils.vec3 import Vec3


def generate_rays(camera, width: int, height: int, px, py, jitter_u, jitter_v):
    """px/py: (R,) integer pixel coordinates; jitter_u/v: (R,) uniforms in
    [0, 1). Returns (origin, direction): Vec3 of (R,), unit directions."""
    f32 = torch.float32
    w, h = float(width), float(height)
    aspect = float(np.float32(width) / np.float32(height))  # rounded once in f32

    u = ((px.to(f32) + jitter_u - 0.5) * 2.0 / w) - 1.0
    v = ((py.to(f32) + jitter_v - 0.5) * 2.0 / h) - 1.0

    dx = u * aspect
    dy = -v
    dz = (-camera.focal_length).expand(dx.shape)

    m = camera.view_matrix
    d = Vec3(
        m[0, 0] * dx + m[0, 1] * dy + m[0, 2] * dz,
        m[1, 0] * dx + m[1, 1] * dy + m[1, 2] * dz,
        m[2, 0] * dx + m[2, 1] * dy + m[2, 2] * dz,
    ).normalized()
    origin = Vec3(m[0, 3].expand(dx.shape), m[1, 3].expand(dx.shape),
                  m[2, 3].expand(dx.shape))
    return origin, d
