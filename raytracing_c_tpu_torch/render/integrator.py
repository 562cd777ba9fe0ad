"""Wavefront path integrator over component-plane state.

Counterpart of `raytracing_c_tpu/render/integrator.py`. Every bounce
intersects, shades and advances all live rays at once. Semantics kept
exactly (cast_ray, raytracer.c:505-558):

- throughput x per-bounce shader tint; accumulated emission;
  shader-driven terminate (raytracer.c:506-544)
- hits whose geometric OR shading normal faces along the ray are skipped
  by re-casting from an epsilon-advanced origin, and this consumes a
  bounce (raytracer.c:516-521)
- the next origin is biased +/-epsilon along the geometric normal by the
  side the sampled direction leaves (raytracer.c:546-552)
- a miss returns background * throughput + emission and stops
  (raytracer.c:553-555); rays that exhaust max_bounces keep emission only
- the ray count is every executed scene intersection, backface re-casts
  included (the Mrays/s numerator, BASELINE.md measurement note)

Attribute fetch on the "bvh" method: the first (camera) bounce runs K1
with its fused attribute epilogue; deeper bounces run K1 bare and fetch
the winners' attributes with K2. Both forms give the same planes.
"""

from __future__ import annotations

import torch

from raytracing_c_tpu_torch import EPSILON
from raytracing_c_tpu_torch.ops import background as bg_ops
from raytracing_c_tpu_torch.ops import disney, traverse, traverse_cuda
from raytracing_c_tpu_torch.utils import rng
from raytracing_c_tpu_torch.utils.vec3 import Vec3

#: first bounce eligible for Russian roulette (when enabled)
RR_START = 3


def _gather_hit_geometry(scene, origin: Vec3, direction: Vec3, hit,
                         method: str = "bvh"):
    """Winning triangle's interpolated attributes (the SIMD kernel's inline
    interpolation, raytracer.c:159-183): from K1's fused epilogue when the
    hit carries "attrs", from K2 on the "bvh" method, else from the plain
    row gather. Sphere winners take the analytic normal and basis."""
    if "attrs" in hit:
        g = traverse_cuda.attrs_to_dict(hit["attrs"])
    else:
        fetch = traverse_cuda.fetch_attrs if method == "bvh" else traverse_cuda.fetch_attrs_plain
        g = traverse_cuda.attrs_to_dict(
            fetch(scene.triangles.attr_rows, hit["tri"], hit["u"], hit["v"])
        )
    normal, ng = g["normal"], g["ng"]
    tangent, bitangent = g["tangent"], g["bitangent"]
    uv_u, uv_v, mat_id = g["uv_u"], g["uv_v"], g["mat_id"]

    point = origin + direction * hit["t"]

    if scene.spheres.count > 0:
        sph = torch.clamp_min(hit["sph"], 0).long()
        is_sph = hit["sph"] >= 0
        center = scene.spheres.center.gather(sph)
        n_sph = (point - center) * (1.0 / scene.spheres.radius[sph])
        t_sph, b_sph = disney.basis(direction, n_sph)
        normal = Vec3.where(is_sph, n_sph, normal)
        ng = Vec3.where(is_sph, n_sph, ng)
        tangent = Vec3.where(is_sph, t_sph, tangent)
        bitangent = Vec3.where(is_sph, b_sph, bitangent)
        uv_u = torch.where(is_sph, 0.0, uv_u)
        uv_v = torch.where(is_sph, 0.0, uv_v)
        mat_id = torch.where(is_sph, scene.spheres.mat_id[sph], mat_id)

    return {
        "point": point,
        "normal": normal,  # unnormalised interpolated normal
        "ng": ng,
        "tangent": tangent,
        "bitangent": bitangent,
        "uv_u": uv_u,
        "uv_v": uv_v,
        "mat_id": mat_id,
    }


def bounce_step(scene, st, rand4, method: str = "bvh",
                texture_mode: str = "bilinear", rr: bool = False,
                bounce_i: int | None = None, fuse_attr: bool = False):
    """One wavefront bounce over a state dict of per-ray planes.

    st: dict(origin, direction, throughput, radiance: Vec3; active: bool
    (R,); rays: int64 scalar tensor). rand4: (>=3, R) uniforms (lobe, u1,
    u2[, rr]). rr: Russian roulette from bounce RR_START (beyond the
    reference, default off): a continuing path survives with
    p = clip(max(throughput), 0.05, 1) and is divided by p; reads rand4[3].
    fuse_attr: fetch attributes in K1's epilogue ("bvh" method only).
    """
    active = st["active"]
    o, d = st["origin"], st["direction"]
    r = o.shape[0]

    hit = traverse.intersect_scene(scene, o, d, active, method=method,
                                   fuse_attr=fuse_attr)
    rays = st["rays"] + active.sum()

    is_hit = active & torch.isfinite(hit["t"])
    geom = _gather_hit_geometry(scene, o, d, hit, method=method)

    # backface skip: geometric OR shading normal along the ray
    backface = is_hit & ((geom["ng"].dot(d) > 0.0) | (geom["normal"].dot(d) > 0.0))
    shaded = is_hit & ~backface

    out = disney.shade(
        scene, d, geom["normal"].normalized(), geom["ng"], geom["tangent"],
        geom["bitangent"], geom["uv_u"], geom["uv_v"], geom["mat_id"], rand4,
        texture_mode,
    )

    zero = Vec3.zeros((r,), o.x.device)
    radiance = st["radiance"] + Vec3.where(shaded, st["throughput"] * out["emission"], zero)
    miss = active & ~is_hit
    bg = bg_ops.eval_background(scene, d)
    radiance = radiance + Vec3.where(miss, st["throughput"] * bg, zero)

    # terminated rays keep their accumulated emission and go inactive
    cont = shaded & ~out["terminate"]
    throughput = Vec3.where(cont, st["throughput"] * out["tint"], st["throughput"])

    if rr:
        if bounce_i is None:
            raise ValueError("rr needs bounce_i")
        lum = torch.maximum(torch.maximum(throughput.x, throughput.y), throughput.z)
        p = torch.clamp(lum, 0.05, 1.0)
        gamble = cont & (bounce_i >= RR_START)
        kill = gamble & (rand4[3] >= p)
        cont = cont & ~kill
        throughput = throughput * torch.where(gamble & ~kill, 1.0 / p, 1.0)

    # next ray origin: epsilon rules (raytracer.c:520, 551-552)
    bias = torch.where(geom["ng"].dot(out["direction"]) < 0.0, -EPSILON, EPSILON)
    origin_shaded = geom["point"] + geom["ng"] * bias
    origin_back = geom["point"] + d * EPSILON
    new_origin = Vec3.where(backface, origin_back, Vec3.where(cont, origin_shaded, o))
    new_dir = Vec3.where(cont, out["direction"], d)

    return {
        "origin": new_origin,
        "direction": new_dir,
        "throughput": throughput,
        "radiance": radiance,
        "active": cont | backface,
        "rays": rays,
    }


def _initial_state(origin: Vec3, direction: Vec3) -> dict:
    r = origin.shape[0]
    dev = origin.x.device
    return {
        "origin": origin,
        "direction": direction,
        "throughput": Vec3.full((r,), 1.0, dev),
        "radiance": Vec3.zeros((r,), dev),
        "active": torch.ones((r,), dtype=torch.bool, device=dev),
        "rays": torch.zeros((), dtype=torch.int64, device=dev),
    }


def trace(scene, origin: Vec3, direction: Vec3, uniforms, max_bounces: int,
          method: str = "bvh", texture_mode: str = "bilinear", rr: bool = False,
          nee: bool = False):
    """Trace a batch of rays to completion with pre-drawn uniforms
    (max_bounces, 4, R). Returns (radiance Vec3 of (R,), rays traced)."""
    if nee:
        raise NotImplementedError("nee: env-light sampling is not ported yet")
    st = _initial_state(origin, direction)
    for i in range(max_bounces):
        if i > 0 and not bool(st["active"].any()):
            break  # every path ended (the reference's per-pixel break)
        st = bounce_step(scene, st, uniforms[i], method, texture_mode, rr=rr,
                         bounce_i=i, fuse_attr=i == 0)
    return st["radiance"], st["rays"]


_PLANES = ("origin", "direction", "throughput", "radiance")


def trace_bucketed(scene, origin: Vec3, direction: Vec3, key, max_bounces: int,
                   method: str = "bvh", texture_mode: str = "bilinear",
                   rr: bool = False, nee: bool = False):
    """trace() with live-lane compaction and the slot-keyed RNG.

    After each bounce the live lanes are gathered to the front
    (`nonzero` on the active mask) and the next bounce runs on those only.
    Each lane carries its sample slot; the bounce uniforms derive from
    (key, slot, bounce) exactly as the JAX package's
    `uniform(fold_in(fold_in(key, slot), bounce), (nu,))`, so a sample's
    stream and the image do not depend on the compaction. Radiance lands in
    slot order as lanes retire (the final unpermute).
    """
    if nee:
        raise NotImplementedError("nee: env-light sampling is not ported yet")
    r = origin.shape[0]
    dev = origin.x.device
    result = Vec3(*(torch.zeros((r,), device=dev) for _ in range(3)))
    st = _initial_state(origin, direction)
    slot = torch.arange(r, device=dev)
    nu = 4 if rr else 3  # uniform(k, (3,)) is the prefix of uniform(k, (4,))
    for i in range(max_bounces):
        if slot.numel() == 0:
            break
        lane_keys = rng.fold_in(rng.fold_in(key, slot), i)  # (n, 2)
        rand = rng.uniform(lane_keys, (nu,)).T  # (nu, n)
        st = bounce_step(scene, st, rand, method, texture_mode, rr=rr,
                         bounce_i=i, fuse_attr=i == 0)
        for c in "xyz":
            getattr(result, c).index_copy_(0, slot, getattr(st["radiance"], c))
        live = torch.nonzero(st["active"]).squeeze(1)
        if live.numel() < slot.numel():
            slot = slot[live]
            for name in _PLANES:
                st[name] = st[name].gather(live)
            st["active"] = st["active"][live]
    return result, st["rays"]
