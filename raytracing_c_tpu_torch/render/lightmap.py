"""Lightmap baking.

Counterpart of `raytracing_c_tpu/render/lightmap.py` (lightmap_bake,
raytracer.c:722-784): every triangle's UV-space bounding box is
rasterized on the host with a barycentric inside test, each covered texel
gets its world position and normal, and the texels' hemisphere rays go
through the path integrator on the scene's device, a batch of
batch_texels x samples rays at a time; the texel keeps the mean
cosine-weighted radiance.

As in the JAX package: directions are Gaussian draws normalised, the half
below the horizon reflected (uniform on the hemisphere, stateless; the
reference rejection-samples, raytracer.c:765-773), and the lightmap stays
float32 (the reference truncates into u8). The streams are the JAX
package's: batch key fold_in(PRNGKey(seed), first texel), split into the
direction and material keys.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracing_c_tpu_torch import EPSILON
from raytracing_c_tpu_torch.ops import traverse
from raytracing_c_tpu_torch.render import integrator
from raytracing_c_tpu_torch.utils import rng
from raytracing_c_tpu_torch.utils.vec3 import Vec3


def _rasterize_host(scene, width: int, height: int):
    """UV-space rasterization of every triangle into texel records: the
    bbox + barycentric inside test of raytracer.c:727-757, vectorised over
    a flat arena of candidate texels (triangle-major, then row-major in the
    box, so overlapping triangles overwrite in the reference's order).

    Returns (texel_idx (T,) i64, position (T, 3) f32, normal (T, 3) f32)."""
    tris = scene.triangles
    n = scene.n_triangles

    def host(a):
        return a[:n].cpu().numpy()

    def planes(v):
        return np.stack([host(v.x), host(v.y), host(v.z)], axis=-1)

    uv0 = np.stack([host(tris.uv0u), host(tris.uv0v)], axis=-1) * [width, height]
    uv1 = np.stack([host(tris.uv1u), host(tris.uv1v)], axis=-1) * [width, height]
    uv2 = np.stack([host(tris.uv2u), host(tris.uv2v)], axis=-1) * [width, height]
    v0 = planes(tris.v0)
    v1 = v0 + planes(tris.e1)
    v2 = v0 + planes(tris.e2)
    n0, n1, n2 = planes(tris.n0), planes(tris.n1), planes(tris.n2)

    denom = ((uv1[:, 1] - uv2[:, 1]) * (uv0[:, 0] - uv2[:, 0])
             + (uv2[:, 0] - uv1[:, 0]) * (uv0[:, 1] - uv2[:, 1]))

    def lo(k):
        return np.trunc(np.minimum(np.minimum(uv0[:, k], uv1[:, k]), uv2[:, k])).astype(np.int64)

    def hi(k):
        return np.trunc(np.maximum(np.maximum(uv0[:, k], uv1[:, k]), uv2[:, k])).astype(np.int64)

    mnx, mxx = np.maximum(lo(0), 0), np.minimum(hi(0), width - 1)
    mny, mxy = np.maximum(lo(1), 0), np.minimum(hi(1), height - 1)

    ok = (np.abs(denom) >= 1e-20) & (mxx >= mnx) & (mxy >= mny)
    tri_ids = np.nonzero(ok)[0]
    if len(tri_ids) == 0:
        return (np.zeros(0, np.int64), np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.float32))

    bw = mxx[tri_ids] - mnx[tri_ids] + 1
    bh = mxy[tri_ids] - mny[tri_ids] + 1
    area = bw * bh
    starts = np.concatenate([[0], np.cumsum(area)])
    total = int(starts[-1])

    t_of = np.repeat(np.arange(len(tri_ids)), area)  # index into tri_ids
    local = np.arange(total, dtype=np.int64) - np.repeat(starts[:-1], area)
    gx = mnx[tri_ids][t_of] + local % bw[t_of]
    gy = mny[tri_ids][t_of] + local // bw[t_of]
    tri = tri_ids[t_of]

    dx2 = gx.astype(np.float64) - uv2[tri, 0]
    dy2 = gy.astype(np.float64) - uv2[tri, 1]
    w0 = ((uv1[tri, 1] - uv2[tri, 1]) * dx2 + (uv2[tri, 0] - uv1[tri, 0]) * dy2) / denom[tri]
    w1 = ((uv2[tri, 1] - uv0[tri, 1]) * dx2 + (uv0[tri, 0] - uv2[tri, 0]) * dy2) / denom[tri]
    w2 = 1.0 - w0 - w1
    inside = (w0 >= -EPSILON) & (w1 >= -EPSILON) & (w2 >= -EPSILON)

    tri = tri[inside]
    w0, w1, w2 = w0[inside], w1[inside], w2[inside]
    pos = v0[tri] * w0[:, None] + v1[tri] * w1[:, None] + v2[tri] * w2[:, None]
    nrm = n0[tri] * w0[:, None] + n1[tri] * w1[:, None] + n2[tri] * w2[:, None]
    return ((gx[inside] + gy[inside] * width).astype(np.int64), pos.astype(np.float32),
            nrm.astype(np.float32))


def bake_lightmap(scene, width: int, height: int, samples: int = 16, max_bounces: int = 8,
                  seed: int = 0, batch_texels: int = 16384, method: str = "auto",
                  stats: dict | None = None):
    """Bake a float32 (height, width, 3) irradiance lightmap on the scene's
    device. method="auto" runs the brute-force oracle for scenes of <= 64
    triangle slots and the "bvh" traversal kernel (K1) otherwise; the JAX
    package's names map as `traverse.port_method` says. Texels no
    triangle covers stay 0. With `stats`, it receives texels (covered) and
    rays (traced)."""
    method = traverse.port_method(method, scene)
    dev = scene.device

    idx, pos, nrm = _rasterize_host(scene, width, height)
    lightmap = np.zeros((height * width, 3), np.float32)
    key = rng.prng_key(seed, dev)
    rays_total = 0

    def rep(a):
        return torch.from_numpy(np.repeat(a, samples)).to(dev)

    for lo in range(0, len(idx), batch_texels):
        hi = min(lo + batch_texels, len(idx))
        t = hi - lo
        k_dir, k_mat = rng.split(rng.fold_in(key, lo))

        p = pos[lo:hi]
        nn = nrm[lo:hi]
        nn = nn / np.maximum(np.linalg.norm(nn, axis=-1, keepdims=True), 1e-30)

        # uniform on the hemisphere about the normal, cosine-weighted estimate
        g = rng.normal(k_dir, (3, t * samples))
        d = Vec3(g[0], g[1], g[2]).normalized()
        cos = d.dot(Vec3(rep(nn[:, 0]), rep(nn[:, 1]), rep(nn[:, 2])))
        d = Vec3.where(cos < 0, -d, d)
        cos = torch.abs(cos)

        start = p + nn * EPSILON
        origins = Vec3(rep(start[:, 0]), rep(start[:, 1]), rep(start[:, 2]))
        uni = rng.uniform(k_mat, (max_bounces, 4, t * samples))
        radiance, rays = integrator.trace(scene, origins, d, uni, max_bounces, method=method)
        rays_total += int(rays)
        rad = radiance * cos
        lightmap[idx[lo:hi]] = np.stack(
            [c.cpu().numpy().reshape(t, samples).mean(axis=1) for c in (rad.x, rad.y, rad.z)],
            axis=-1)

    if stats is not None:
        stats.update(texels=len(idx), rays=rays_total)
    return lightmap.reshape(height, width, 3)
