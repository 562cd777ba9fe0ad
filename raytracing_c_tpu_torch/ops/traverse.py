"""Scene intersection: the traversal kernel or the brute-force oracle.

Counterpart of `raytracing_c_tpu/ops/traverse.py:343,625`. Methods of
`intersect_scene` and their JAX counterparts:

| port      | JAX package                         | what runs                          |
|-----------|-------------------------------------|------------------------------------|
| `"bvh"`   | `"pallas_fused"` / `"pallas"`       | K1 `traverse_cuda.bvh_traverse`; with `fuse_attr` its epilogue interpolates the winner's attributes (pallas_fused), without it `_gather_hit_geometry` calls K2 (pallas) |
| `"brute"` | `"brute"`                           | `intersect_bruteforce_chunked`     |

K1 is exact by construction (an ordered stack traversal), so the JAX
package's verified tiers, suspect repair and stale-attribute refetch have
nothing to do here; the top-k, DFS and forest traversals are TPU-side
alternatives of the same function and are not ported.
"""

from __future__ import annotations

import torch

from raytracing_c_tpu_torch.ops import intersect, traverse_cuda
from raytracing_c_tpu_torch.utils.vec3 import Vec3

INF = float("inf")


def intersect_bruteforce_chunked(origin: Vec3, direction: Vec3, triangles,
                                 active=None, t_max=None):
    """Memory-bounded exhaustive oracle: every ray against every triangle,
    a chunk of triangles at a time, so the (chunk, R) intermediates stay
    near 2**20 elements on the CPU and 2**24 on a GPU.

    Ties go to the lowest triangle id (argmin within a chunk, strict `<`
    across chunks). Only hits closer than t_max count. Misses and inactive
    lanes return t = +inf, tri = -1, u = v = 0."""
    r = origin.shape[0]
    n = triangles.capacity
    dev = origin.x.device
    budget = 2**24 if dev.type == "cuda" else 2**20
    chunk = max(1, min(n, budget // max(r, 1)))
    o = origin.map(lambda a: a[None, :])
    d = direction.map(lambda a: a[None, :])
    best_t = torch.full((r,), INF, device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((r,), device=dev)
    best_v = torch.zeros((r,), device=dev)
    for c0 in range(0, n, chunk):
        col = lambda a: a[c0:c0 + chunk, None]  # noqa: E731
        t, u, v = intersect.moller_trumbore(
            o, d, triangles.v0.map(col), triangles.e1.map(col), triangles.e2.map(col)
        )
        j = torch.argmin(t, dim=0, keepdim=True)
        tb = t.gather(0, j)[0]
        better = tb < best_t
        best_t = torch.where(better, tb, best_t)
        best_tri = torch.where(better, (j[0] + c0).to(torch.int32), best_tri)
        best_u = torch.where(better, u.gather(0, j)[0], best_u)
        best_v = torch.where(better, v.gather(0, j)[0], best_v)
    hit = torch.isfinite(best_t)
    if t_max is not None:
        hit &= best_t < t_max
    if active is not None:
        hit &= active
    return {
        "t": torch.where(hit, best_t, INF),
        "tri": torch.where(hit, best_tri, -1),
        "u": torch.where(hit, best_u, 0.0),
        "v": torch.where(hit, best_v, 0.0),
    }


def intersect_scene(scene, origin: Vec3, direction: Vec3, active=None,
                    method: str = "bvh", fuse_attr: bool = False):
    """ray_scene_hit (raytracer.c:497-503) + the sphere pass: nearest hit
    among BVH triangles and analytic spheres. Returns dict(t, tri, sph, u,
    v), tri/sph = -1 where not the winner, plus "attrs" (16, R) when the
    "bvh" method fused the attribute epilogue."""
    if method == "bvh":
        hit = traverse_cuda.bvh_traverse(origin, direction, scene.triangles,
                                         scene.bvh, active, fuse_attr=fuse_attr)
        hit.pop("dropped_min")  # +inf: the traversal is exact
    elif method == "brute":
        hit = intersect_bruteforce_chunked(origin, direction, scene.triangles, active)
    else:
        raise ValueError(f"unknown traversal method '{method}'")

    t_tri = hit["t"]
    tri = torch.where(torch.isfinite(t_tri), hit["tri"], -1)
    t_sph, sph = intersect.intersect_spheres(origin, direction, scene.spheres, t_tri)
    sphere_wins = t_sph < t_tri
    if active is not None:
        sphere_wins &= active
    out = {
        "t": torch.where(sphere_wins, t_sph, t_tri),
        "tri": torch.where(sphere_wins, -1, tri),
        "sph": torch.where(sphere_wins, sph, -1),
        "u": hit["u"],
        "v": hit["v"],
    }
    if "attrs" in hit:
        out["attrs"] = hit["attrs"]
    return out
