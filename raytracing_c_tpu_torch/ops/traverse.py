"""Scene intersection: the traversal kernel or the brute-force oracle.

Counterpart of `raytracing_c_tpu/ops/traverse.py:343,625`. Methods of
`intersect_scene` and their JAX counterparts:

| port      | JAX package                         | what runs                          |
|-----------|-------------------------------------|------------------------------------|
| `"bvh"`   | `"pallas_fused"` / `"pallas"`       | K1 `traverse_cuda.bvh_traverse`; with `fuse_attr` its epilogue interpolates the winner's attributes (pallas_fused), without it `_gather_hit_geometry` calls K2 (pallas); on CPU tensors the wrapper runs `intersect_bvh_culled` |
| `"brute"` | `"brute"`                           | `intersect_bruteforce_chunked`     |

K1 is exact by construction (an ordered stack traversal), so the JAX
package's verified tiers, suspect repair and stale-attribute refetch have
nothing to do here; the top-k, DFS and forest traversals are TPU-side
alternatives of the same function and are not ported. Every function of
the port that takes `method=` accepts the JAX package's names as well
(`port_method`): each traversal runs K1, "brute" the oracle.
"""

from __future__ import annotations

import torch

from raytracing_c_tpu_torch import BVH_WIDTH as W
from raytracing_c_tpu_torch import EPSILON
from raytracing_c_tpu_torch.ops import intersect, traverse_cuda
from raytracing_c_tpu_torch.utils.vec3 import Vec3

INF = float("inf")
#: rays per pass of intersect_bvh_culled, which bounds its (ray, node) pairs
CULLED_RAY_CHUNK = 32768
#: the JAX package's traversal names (its CLI's --method list) and the
#: port's method for each: every traversal runs K1, which is exact (the
#: JAX package's *_fast passes are unverified; here they are exact too)
JAX_METHODS = {"pallas": "bvh", "pallas_fused": "bvh", "pallas_fast": "bvh", "topk": "bvh",
               "topk_fast": "bvh", "dfs": "bvh", "brute": "brute"}


def port_method(method: str, scene=None) -> str:
    """The port's traversal method for `method`: "bvh" and "brute" as
    they are, a JAX package name through JAX_METHODS, and "auto" by its
    rule, the brute-force oracle for scenes of <= 64 triangle slots (the
    reference's own `#if 0` path) and "bvh" otherwise; without a scene
    "auto" stays "auto". Any other name raises ValueError."""
    if method == "auto":
        if scene is None:
            return method
        return "brute" if scene.triangles.capacity <= 64 else "bvh"
    if method in ("bvh", "brute"):
        return method
    if method not in JAX_METHODS:
        raise ValueError(f"unknown traversal method '{method}'")
    return JAX_METHODS[method]


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


def intersect_bvh_culled(origin: Vec3, direction: Vec3, triangles, bvh, active=None,
                        t_max=None):
    """K1's function on the host's terms: the tree walked level by level,
    keeping every child whose box the ray's slab test (`aabb_slab`, from
    t = EPSILON on) does not reject, with no order and no cap, then every
    slot of the leaves reached through Moller-Trumbore, as the brute-force
    oracle computes each test. The nearest hit wins, ties to the lowest
    triangle id; only hits closer than t_max count; misses and inactive
    lanes return t = +inf, tri = -1, u = v = 0. The boxes are K1's
    (`traverse_cuda.walk_boxes`: each holds every point the test accepts
    on its triangles), so it equals `intersect_bruteforce_chunked` but
    where an origin lies on the plane of a slab its ray runs along
    (`aabb_slab`), and costs a few leaves per ray instead of every
    triangle. Rays go CULLED_RAY_CHUNK at a time."""
    r = origin.shape[0]
    dev = origin.x.device
    n_internal = bvh.n_internal
    boxes = traverse_cuda.walk_boxes(bvh, triangles)
    inv = Vec3(1.0 / direction.x, 1.0 / direction.y, 1.0 / direction.z)
    lane = torch.arange(W, device=dev)
    best_t = torch.full((r,), INF, device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((r,), device=dev)
    best_v = torch.zeros((r,), device=dev)
    lanes = torch.arange(r, device=dev) if active is None else torch.nonzero(active).squeeze(1)
    for c0 in range(0, lanes.numel(), CULLED_RAY_CHUNK):
        ray = lanes[c0:c0 + CULLED_RAY_CHUNK]
        node = torch.zeros_like(ray)
        for _ in range(bvh.depth):
            b = boxes[node]  # (P, 6, 8)
            take = lambda a: a[ray, None]  # noqa: E731
            d = intersect.aabb_slab(origin.map(take), inv.map(take),
                                    Vec3(b[:, 0], b[:, 1], b[:, 2]),
                                    Vec3(b[:, 3], b[:, 4], b[:, 5]), EPSILON, INF)
            p, j = torch.nonzero(torch.isfinite(d), as_tuple=True)
            ray, node = ray[p], W * node[p] + 1 + j
        slot = ((node - n_internal)[:, None] * W + lane).reshape(-1)
        ray = ray[:, None].expand(-1, W).reshape(-1)
        tri = lambda a: a[slot]  # noqa: E731
        t, u, v = intersect.moller_trumbore(
            origin.map(lambda a: a[ray]), direction.map(lambda a: a[ray]),
            triangles.v0.map(tri), triangles.e1.map(tri), triangles.e2.map(tri))
        near = best_t.scatter_reduce(0, ray, t, "amin")
        tie = torch.isfinite(t) & (t == near[ray])
        first = torch.full_like(best_tri, triangles.capacity).scatter_reduce(
            0, ray[tie], slot[tie], "amin")
        win = tie & (slot == first[ray])
        best_t[ray[win]] = t[win]
        best_tri[ray[win]] = slot[win]
        best_u[ray[win]] = u[win]
        best_v[ray[win]] = v[win]
    hit = torch.isfinite(best_t)
    if t_max is not None:
        hit &= best_t < t_max
    return {
        "t": torch.where(hit, best_t, INF),
        "tri": torch.where(hit, best_tri, -1).to(torch.int32),
        "u": torch.where(hit, best_u, 0.0),
        "v": torch.where(hit, best_v, 0.0),
    }


def intersect_scene(scene, origin: Vec3, direction: Vec3, active=None,
                    method: str = "bvh", fuse_attr: bool = False):
    """ray_scene_hit (raytracer.c:497-503) + the sphere pass: nearest hit
    among BVH triangles and analytic spheres. Returns dict(t, tri, sph, u,
    v), tri/sph = -1 where not the winner, plus "attrs" (16, R) when the
    "bvh" method fused the attribute epilogue. method: see port_method."""
    method = port_method(method, scene)
    if method == "bvh":
        hit = traverse_cuda.bvh_traverse(origin, direction, scene.triangles,
                                         scene.bvh, active, fuse_attr=fuse_attr)
        hit.pop("dropped_min")  # +inf: the traversal is exact
    else:  # "brute"
        hit = intersect_bruteforce_chunked(origin, direction, scene.triangles, active)

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
