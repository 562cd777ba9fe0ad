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
the winners' attributes with K2. Both forms give the same planes. With
nee, each bounce also launches K1 bare once more, on the shadow rays of
its shaded lanes. On CUDA tensors the rest of a bounce, from shade to
advance, is one launch of K4 (`ops/shade_cuda.py`), plus one that adds the
NEE contribution of the unoccluded lanes; on CPU tensors it is the plain
PyTorch tail that K4 is held to.

Spans (`utils/spans.py`, off by default): each bounce of `trace` and
`trace_bucketed` is a `bounce` span (its index and the lanes that enter
it) over the leaves `rng` (the slot-keyed draw, one K5 launch on the card;
`utils/rng.py` notes its kernel and width), `intersect` (K1 and its
input packing; kind camera, bounce or shadow, and K1's wrapper notes the
kernel it ran and its rays), `attrs`, `shade` (kernel `k4` or `plain` and
the lanes it shades), `background` and `advance` (the plain tail's; K4's
path keeps `advance` for the NEE add) and `compact`, and a `sync` around
each host read of device data (`what`: `compaction`, `shadow_lanes`,
`active_any`). The NEE shadow test tallies the shadow rays it launched and
those that hit something (`shadow_rays`, `shadow_occluded`) on the frame's
`render` span, counted on the device and read when that span closes.
"""

from __future__ import annotations

import torch

from raytracing_c_tpu_torch import EPSILON
from raytracing_c_tpu_torch.ops import background as bg_ops
from raytracing_c_tpu_torch.ops import (disney, env_light, shade_cuda, traverse,
                                        traverse_cuda)
from raytracing_c_tpu_torch.utils import rng, spans
from raytracing_c_tpu_torch.utils.vec3 import Vec3

#: first bounce eligible for Russian roulette (when enabled)
RR_START = 3


def _attr_planes(scene, hit, method: str):
    """The winners' (16, R) attribute planes (`traverse_cuda.fetch_attrs_plain`'s
    layout): K1's fused epilogue when the hit carries "attrs", K2 on the
    "bvh" method, else the plain row gather."""
    if "attrs" in hit:
        return hit["attrs"]
    fetch = traverse_cuda.fetch_attrs if method == "bvh" else traverse_cuda.fetch_attrs_plain
    return fetch(scene.triangles.attr_rows, hit["tri"], hit["u"], hit["v"])


def _with_spheres(scene, direction: Vec3, hit, g: dict) -> dict:
    """Sphere winners take the analytic normal and basis, uv 0 and their
    sphere's material in the geometry dict g (which holds the hit point)."""
    sph = torch.clamp_min(hit["sph"], 0).long()
    is_sph = hit["sph"] >= 0
    center = scene.spheres.center.gather(sph)
    n_sph = (g["point"] - center) * (1.0 / scene.spheres.radius[sph])
    t_sph, b_sph = disney.basis(direction, n_sph)
    return {
        **g,
        "normal": Vec3.where(is_sph, n_sph, g["normal"]),
        "ng": Vec3.where(is_sph, n_sph, g["ng"]),
        "tangent": Vec3.where(is_sph, t_sph, g["tangent"]),
        "bitangent": Vec3.where(is_sph, b_sph, g["bitangent"]),
        "uv_u": torch.where(is_sph, 0.0, g["uv_u"]),
        "uv_v": torch.where(is_sph, 0.0, g["uv_v"]),
        "mat_id": torch.where(is_sph, scene.spheres.mat_id[sph], g["mat_id"]),
    }


def _gather_hit_geometry(scene, origin: Vec3, direction: Vec3, hit,
                         method: str = "bvh"):
    """Winning triangle's interpolated attributes (the SIMD kernel's inline
    interpolation, raytracer.c:159-183) from `_attr_planes`, the hit point,
    and the sphere winners' analytic normal and basis: dict(point, normal
    (unnormalised interpolated), ng, tangent, bitangent, uv_u, uv_v,
    mat_id)."""
    g = traverse_cuda.attrs_to_dict(_attr_planes(scene, hit, method))
    g["point"] = origin + direction * hit["t"]
    if scene.spheres.count > 0:
        g = _with_spheres(scene, direction, hit, g)
    return g


def bounce_step(scene, st, rand4, method: str = "bvh",
                texture_mode: str = "bilinear", rr: bool = False,
                bounce_i: int | None = None, fuse_attr: bool = False,
                nee: bool = False, rand2=None):
    """One wavefront bounce over a state dict of per-ray planes.

    st: dict(origin, direction, throughput, radiance: Vec3; active: bool
    (R,); rays: int64 scalar tensor; prev_pdf: (R,) f32). rand4: (>=3, R)
    uniforms (lobe, u1, u2[, rr]). rr: Russian roulette from bounce
    RR_START (beyond the reference, default off): a continuing path
    survives with p = clip(max(throughput), 0.05, 1) and is divided by p;
    reads rand4[3]. fuse_attr: fetch attributes in K1's epilogue ("bvh"
    method only).

    nee (beyond the reference, default off): next-event estimation of the
    environment light with power-heuristic MIS. Each shaded vertex draws
    one light sample (rand2: (3, R)) and casts a shadow ray from the hit
    point, offset +-EPSILON along the geometric normal, through K1 bare
    (no attributes: only whether it hits counts), one launch over the
    shaded lanes; an unoccluded sample adds throughput x nee_partial. A
    miss's background carries the BRDF side's MIS weight from
    st["prev_pdf"] (+inf: the previous vertex drew no light sample, full
    weight). Shadow rays count in `rays`. method: any name
    `traverse.port_method` takes.

    After the intersection, CUDA tensors take K4 (`_tail_k4`: one kernel
    from shade to advance) and CPU tensors the plain PyTorch tail
    (`_tail_plain`, K4's oracle), which compute the same planes.
    """
    if rr and bounce_i is None:
        raise ValueError("rr needs bounce_i")
    method = traverse.port_method(method, scene)
    active = st["active"]
    o, d = st["origin"], st["direction"]

    tail = _tail_k4 if o.x.device.type == "cuda" else _tail_plain
    with spans.span("intersect", kind="camera" if bounce_i == 0 else "bounce"):
        hit = traverse.intersect_scene(scene, o, d, active, method=method,
                                       fuse_attr=fuse_attr)
        rays = st["rays"] + active.sum()
        if tail is _tail_plain:  # K4 tests its lanes' hits itself
            hit["is_hit"] = active & torch.isfinite(hit["t"])
    return tail(scene, st, hit, rays, rand4, method, texture_mode, rr, bounce_i, nee, rand2)


def _tail_plain(scene, st, hit, rays, rand4, method, texture_mode, rr, bounce_i, nee,
                rand2):
    """bounce_step after the intersection, in plain PyTorch: attributes,
    shade, background, the NEE shadow ray, advance. hit["is_hit"]: the
    active lanes whose t is finite."""
    active = st["active"]
    o, d = st["origin"], st["direction"]
    r = o.shape[0]
    is_hit = hit["is_hit"]
    with spans.span("attrs"):
        geom = _gather_hit_geometry(scene, o, d, hit, method=method)

    with spans.span("shade", kernel="plain", lanes=r):
        # backface skip: geometric OR shading normal along the ray
        backface = is_hit & ((geom["ng"].dot(d) > 0.0) | (geom["normal"].dot(d) > 0.0))
        shaded = is_hit & ~backface
        out = disney.shade(
            scene, d, geom["normal"].normalized(), geom["ng"], geom["tangent"],
            geom["bitangent"], geom["uv_u"], geom["uv_v"], geom["mat_id"], rand4,
            texture_mode, nee=nee, rand2=rand2,
        )
        zero = Vec3.zeros((r,), o.x.device)
        radiance = st["radiance"] + Vec3.where(shaded, st["throughput"] * out["emission"], zero)

    with spans.span("background"):
        miss = active & ~is_hit
        bg = bg_ops.eval_background(scene, d)
        if nee:
            pp2 = st["prev_pdf"] * st["prev_pdf"]
            if scene.env_light is not None:
                pl = env_light.eval_pdf(scene.env_light, d)
                pl2 = pl * pl
            else:
                pl2 = disney.UNIFORM_SPHERE_PDF_SQ
            bg = bg * torch.where(torch.isfinite(st["prev_pdf"]), pp2 / (pp2 + pl2), 1.0)
        radiance = radiance + Vec3.where(miss, st["throughput"] * bg, zero)

    if nee:
        # the shadow ray toward the light sample, over the shaded lanes only
        wd = out["nee_dir"]
        with spans.span("sync", what="shadow_lanes"):
            lanes = torch.nonzero(shaded).squeeze(1)
        with spans.span("intersect", kind="shadow"):
            s_org = geom["point"] + geom["ng"] * torch.where(geom["ng"].dot(wd) < 0.0,
                                                             -EPSILON, EPSILON)
            shot = traverse.intersect_scene(scene, s_org.gather(lanes), wd.gather(lanes),
                                            method=method)
        with spans.span("advance"):
            lit = torch.zeros_like(shaded).index_fill_(
                0, lanes[~torch.isfinite(shot["t"])], True)
            if spans.enabled():
                spans.tally(shadow_rays=lanes.numel(),
                            shadow_occluded=torch.isfinite(shot["t"]).sum())
            radiance = radiance + Vec3.where(lit, st["throughput"] * out["nee_partial"], zero)
            rays = rays + lanes.numel()

    with spans.span("advance"):
        # terminated rays keep their accumulated emission and go inactive
        cont = shaded & ~out["terminate"]
        throughput = Vec3.where(cont, st["throughput"] * out["tint"], st["throughput"])

        if rr:
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

        prev_pdf = st["prev_pdf"]
        if nee:
            # a backface re-cast continues the same segment: it keeps its pdf
            prev_pdf = torch.where(backface, prev_pdf,
                                   torch.where(cont, out["pdf_eval"], float("inf")))
        active = cont | backface
    return {
        "origin": new_origin,
        "direction": new_dir,
        "throughput": throughput,
        "radiance": radiance,
        "active": active,
        "rays": rays,
        "prev_pdf": prev_pdf,
    }


def k4_attr_planes(scene, origin: Vec3, direction: Vec3, hit, method: str):
    """K4's (16, R) attribute planes: `_attr_planes` with the sphere
    winners' normal, basis, uv and material written in."""
    attrs = _attr_planes(scene, hit, method)
    if scene.spheres.count == 0:
        return attrs
    g = traverse_cuda.attrs_to_dict(attrs)
    g["point"] = origin + direction * hit["t"]
    g = _with_spheres(scene, direction, hit, g)
    return torch.stack([*(getattr(g[k], c) for k in ("normal", "ng", "tangent", "bitangent")
                          for c in "xyz"),
                        g["uv_u"], g["uv_v"], g["mat_id"].to(torch.float32), attrs[15]])


def _tail_k4(scene, st, hit, rays, rand4, method, texture_mode, rr, bounce_i, nee, rand2):
    """bounce_step after the intersection through K4 (`ops/shade_cuda.py`):
    the attribute planes (sphere winners' written in), one launch from
    shade to advance, and with nee the shadow rays of the shaded lanes
    through K1 and the unoccluded ones' contribution added."""
    o, d = st["origin"], st["direction"]
    r = o.shape[0]
    with spans.span("attrs"):
        attrs = k4_attr_planes(scene, o, d, hit, method)
    with spans.span("shade", kernel="k4", lanes=r):
        out = shade_cuda.shade_bounce(scene, st, hit["t"], attrs, rand4, rand2,
                                      texture_mode=texture_mode, rr=rr,
                                      gamble=rr and bounce_i >= RR_START, nee=nee)
    if nee:
        with spans.span("sync", what="shadow_lanes"):
            lanes = torch.nonzero(out["shaded"]).squeeze(1)
        with spans.span("intersect", kind="shadow"):
            ray = out["shadow"][:, lanes]
            shot = traverse.intersect_scene(scene, Vec3(ray[0], ray[1], ray[2]),
                                            Vec3(ray[3], ray[4], ray[5]), method=method)
        with spans.span("advance"):
            shade_cuda.nee_add(out, lanes, shot["t"])
            if spans.enabled():
                spans.tally(shadow_rays=lanes.numel(),
                            shadow_occluded=torch.isfinite(shot["t"]).sum())
            rays = rays + lanes.numel()
    return {name: out[name] for name in ("origin", "direction", "throughput", "radiance",
                                         "active", "prev_pdf")} | {"rays": rays}


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
        "prev_pdf": torch.full((r,), float("inf"), device=dev),
    }


def trace(scene, origin: Vec3, direction: Vec3, uniforms, max_bounces: int,
          method: str = "bvh", texture_mode: str = "bilinear", rr: bool = False,
          nee: bool = False, nee_uniforms=None):
    """Trace a batch of rays to completion with pre-drawn uniforms
    (max_bounces, 4, R) and, with nee, light-sample uniforms
    (max_bounces, 3, R). Returns (radiance Vec3 of (R,), rays traced).
    nee samples `scene.env_light` where it is built (render() builds it,
    `env_light.scene_env_light`), else the sphere uniformly."""
    method = traverse.port_method(method, scene)
    st = _initial_state(origin, direction)
    for i in range(max_bounces):
        if i > 0:
            with spans.span("sync", what="active_any"):
                done = not bool(st["active"].any())
            if done:
                break  # every path ended (the reference's per-pixel break)
        with spans.span("bounce", index=i, lanes=origin.shape[0]):
            st = bounce_step(scene, st, uniforms[i], method, texture_mode, rr=rr,
                             bounce_i=i, fuse_attr=i == 0, nee=nee,
                             rand2=nee_uniforms[i] if nee else None)
    return st["radiance"], st["rays"]


_PLANES = ("origin", "direction", "throughput", "radiance", "prev_pdf", "active")


def trace_bucketed(scene, origin: Vec3, direction: Vec3, key, max_bounces: int,
                   method: str = "bvh", texture_mode: str = "bilinear",
                   rr: bool = False, nee: bool = False):
    """trace() with live-lane compaction and the slot-keyed RNG.

    After each bounce the live lanes are gathered to the front
    (`nonzero` on the active mask) and the next bounce runs on those only.
    Each lane carries its sample slot; the bounce uniforms derive from
    (key, slot, bounce) exactly as the JAX package's
    `uniform(fold_in(fold_in(key, slot), bounce), (nu,))` (`rng.bounce_uniforms`:
    one K5 launch a bounce on the card), so a sample's
    stream and the image do not depend on the compaction. Radiance lands in
    slot order as lanes retire (the final unpermute). With nee each lane
    draws 7 uniforms per bounce: 4 for the material, 3 for the light sample.
    """
    method = traverse.port_method(method, scene)
    r = origin.shape[0]
    dev = origin.x.device
    result = Vec3(*(torch.zeros((r,), device=dev) for _ in range(3)))
    st = _initial_state(origin, direction)
    slot = torch.arange(r, device=dev)
    # uniform(k, (3,)) is the prefix of uniform(k, (4,)) and of (7,)
    nu = 7 if nee else (4 if rr else 3)
    for i in range(max_bounces):
        if slot.numel() == 0:
            break
        with spans.span("bounce", index=i, lanes=slot.numel()):
            with spans.span("rng"):
                rand = rng.bounce_uniforms(key, slot, i, nu)  # (nu, n)
            st = bounce_step(scene, st, rand[:4], method, texture_mode, rr=rr,
                             bounce_i=i, fuse_attr=i == 0, nee=nee,
                             rand2=rand[4:] if nee else None)
            with spans.span("compact"):
                for c in "xyz":
                    getattr(result, c).index_copy_(0, slot, getattr(st["radiance"], c))
            with spans.span("sync", what="compaction"):
                live = torch.nonzero(st["active"]).squeeze(1)
            if live.numel() < slot.numel():
                with spans.span("compact"):
                    slot = slot[live]
                    for name in _PLANES:
                        v = st[name]
                        st[name] = v.gather(live) if isinstance(v, Vec3) else v[live]
    return result, st["rays"]
