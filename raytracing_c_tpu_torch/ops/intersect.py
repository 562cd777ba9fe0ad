"""Ray/primitive intersection, component-plane layout.

Counterpart of `raytracing_c_tpu/ops/intersect.py`, with the reference's
tolerances: Moller-Trumbore (ray_triangles_hit_8, raytracer.c:84-188),
slab test (ray_aabbs_hit_8, raytracer.c:190-230), analytic spheres
(ray_spheres_hit_8, raytracer.c:34-82). Misses are t = +inf; no backface
culling. The operation order is the JAX package's, and the CUDA traversal
kernel (csrc/traverse.cu) repeats it for Moller-Trumbore, so its hits are
bit-equal to these.
"""

from __future__ import annotations

import torch

from raytracing_c_tpu_torch import EPSILON
from raytracing_c_tpu_torch.utils.vec3 import Vec3

INF = float("inf")


def moller_trumbore(origin: Vec3, direction: Vec3, v0: Vec3, e1: Vec3,
                    e2: Vec3, eps: float = EPSILON):
    """Batched Moller-Trumbore on broadcastable planes. Returns (t, u, v);
    t == +inf encodes a miss. NaNs from degenerate (all-zero padding)
    triangles fail the ordered compares and miss."""
    pvec = direction.cross(e2)
    det = e1.dot(pvec)
    inv_det = 1.0 / det

    tvec = origin - v0
    qvec = tvec.cross(e1)

    u = inv_det * tvec.dot(pvec)
    v = inv_det * direction.dot(qvec)
    t = inv_det * e2.dot(qvec)

    ok = (u >= -eps) & (u <= 1.0 + eps) & (v >= -eps) & (u + v <= 1.0 + eps) & (t >= eps)
    return torch.where(ok, t, INF), u, v


def aabb_slab(origin: Vec3, inv_dir: Vec3, box_min: Vec3, box_max: Vec3,
              t_min, t_max):
    """Batched slab test: entry distance, +inf for a miss. NaN lanes (an
    origin exactly on the plane of a slab the ray runs parallel to) miss
    here, as in the JAX package; the CUDA kernel treats them as inside."""
    t0 = (box_min - origin) * inv_dir
    t1 = (box_max - origin) * inv_dir
    lo = Vec3(torch.minimum(t0.x, t1.x), torch.minimum(t0.y, t1.y), torch.minimum(t0.z, t1.z))
    hi = Vec3(torch.maximum(t0.x, t1.x), torch.maximum(t0.y, t1.y), torch.maximum(t0.z, t1.z))
    t_small = torch.maximum(lo.x, torch.maximum(lo.y, lo.z))
    t_big = torch.minimum(hi.x, torch.minimum(hi.y, hi.z))
    t_near = torch.clamp_min(t_small, t_min)
    t_far = torch.minimum(t_big, torch.as_tensor(t_max, dtype=t_big.dtype, device=t_big.device))
    return torch.where(t_near < t_far, t_near, INF)


def sphere_hit(origin: Vec3, direction: Vec3, center: Vec3, radius,
               eps: float = EPSILON):
    """Near root only (rays starting inside a sphere miss it); d <= 0 and
    t <= eps are misses."""
    oc = origin - center
    a = direction.dot(direction)
    b = 2.0 * oc.dot(direction)
    c = oc.dot(oc) - radius * radius
    d = b * b - 4.0 * a * c
    t = (-b - torch.sqrt(torch.clamp_min(d, 0.0))) / (2.0 * a)
    return torch.where((d > 0.0) & (t > eps), t, INF)


def intersect_bruteforce(origin: Vec3, direction: Vec3, triangles,
                         eps: float = EPSILON):
    """Every ray against every triangle (the reference's `#if 0` oracle,
    raytracer.c:497-503). Intermediates are (N, R): small scenes only;
    ops/traverse.intersect_bruteforce_chunked bounds the memory."""
    o = origin.map(lambda a: a[None, :])
    d = direction.map(lambda a: a[None, :])
    col = lambda a: a[:, None]  # noqa: E731
    t, u, v = moller_trumbore(o, d, triangles.v0.map(col), triangles.e1.map(col),
                              triangles.e2.map(col), eps)
    best = torch.argmin(t, dim=0)
    r = torch.arange(t.shape[1], device=t.device)
    return {"t": t[best, r], "tri": best.to(torch.int32), "u": u[best, r], "v": v[best, r]}


def intersect_spheres(origin: Vec3, direction: Vec3, spheres, best_t,
                      eps: float = EPSILON):
    """Brute-force sphere pass. Returns (t, sphere_index), t=+inf and -1
    where no sphere beats best_t."""
    r = origin.shape[0]
    dev = origin.x.device
    if spheres.count == 0:
        return (torch.full((r,), INF, device=dev),
                torch.full((r,), -1, dtype=torch.int32, device=dev))
    o = origin.map(lambda a: a[None, :])
    d = direction.map(lambda a: a[None, :])
    c = spheres.center.map(lambda a: a[:, None])
    t = sphere_hit(o, d, c, spheres.radius[:, None], eps)  # (S, R)
    idx = torch.argmin(t, dim=0)
    tb = t[idx, torch.arange(r, device=dev)]
    hit = tb < best_t
    return torch.where(hit, tb, INF), torch.where(hit, idx.to(torch.int32), -1)
