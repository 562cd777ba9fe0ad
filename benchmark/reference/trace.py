"""Plain reference of the render path: raygen, brute-force intersection,
the wavefront bounce loop with NEE, the spp mean and the u8 encode, and
the firefly median filter.

Frozen copies, at commit f272015, of `raytracing_c_tpu_torch/render/
camera.py`, `render/integrator.py` (bounce_step, trace_bucketed: the
slot-keyed threefry draws, backface re-casts, epsilon offsets, MIS),
`render/renderer.py` (the 32x32 tile order, the batch keys, the spp mean),
`ops/traverse_cuda.py:fetch_attrs_plain` and `ops/denoise.py:
denoise_u8_plain` (the reference C renderer's raytracer.c:505-720 and
denoiser.c:9-127). In place of the program's traversal kernels K1 and K2
every ray is tested against every occupied triangle slot
(Moller-Trumbore, raytracer.c:84-188; the nearest hit, ties to the lowest
slot) and the winner's attribute row is interpolated in PyTorch; in place
of K3, the plain median. Spheres, Russian roulette, tonemaps and the
debug shader are left out: no configuration of the benchmark uses them.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import rng, shade
from reference.vec3 import Vec3

EPSILON = 1.0e-4
INF = float("inf")


def pixel_tables(width: int, height: int, pad: int):
    """Tile-ordered pixel tables (32x32 chunks), padded to whole batches."""
    tile = 32
    ids = np.arange(width * height, dtype=np.int64)
    x = ids % width
    y = ids // width
    order = np.lexsort((x % tile, y % tile, x // tile, y // tile))
    xs = np.concatenate([x[order].astype(np.int32), np.zeros(pad, np.int32)])
    ys = np.concatenate([y[order].astype(np.int32), np.zeros(pad, np.int32)])
    return xs, ys, order


def batch_layout(width: int, height: int, spp: int):
    """The program's batch size for a frame and its batch count:
    (batch_pixels, n_batches, pad)."""
    n = width * height
    bp = max(1, min(n, 262_144 // max(spp, 1)))
    nb = (n + bp - 1) // bp
    return bp, nb, nb * bp - n


def generate_rays(scene, width: int, height: int, px, py, jitter_u, jitter_v):
    ft = scene.ft
    w, h = float(width), float(height)
    aspect = float(np.float32(width) / np.float32(height))
    u = ((px.to(ft) + jitter_u - 0.5) * 2.0 / w) - 1.0
    v = ((py.to(ft) + jitter_v - 0.5) * 2.0 / h) - 1.0
    dx = u * aspect
    dy = -v
    dz = (-scene.focal).expand(dx.shape)
    m = scene.view
    d = Vec3(m[0, 0] * dx + m[0, 1] * dy + m[0, 2] * dz,
             m[1, 0] * dx + m[1, 1] * dy + m[1, 2] * dz,
             m[2, 0] * dx + m[2, 1] * dy + m[2, 2] * dz).normalized()
    origin = Vec3(m[0, 3].expand(dx.shape), m[1, 3].expand(dx.shape), m[2, 3].expand(dx.shape))
    return origin, d


def moller_trumbore(origin: Vec3, direction: Vec3, v0: Vec3, e1: Vec3, e2: Vec3,
                    eps: float = EPSILON):
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


def intersect(scene, origin: Vec3, direction: Vec3, active=None):
    """Every ray against every occupied slot, a chunk of slots at a time.
    Returns dict(t, tri (slot id), u, v); misses t = +inf, tri = -1."""
    r = origin.shape[0]
    n = scene.slots.numel()
    dev = origin.x.device
    budget = 2**24 if dev.type == "cuda" else 2**20
    chunk = max(1, min(n, budget // max(r, 1)))
    o = origin.map(lambda a: a[None, :])
    d = direction.map(lambda a: a[None, :])
    best_t = torch.full((r,), INF, device=dev, dtype=scene.ft)
    best_tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((r,), device=dev, dtype=scene.ft)
    best_v = torch.zeros((r,), device=dev, dtype=scene.ft)
    for c0 in range(0, n, chunk):
        col = lambda a: a[c0:c0 + chunk, None]  # noqa: E731
        t, u, v = moller_trumbore(o, d, scene.v0.map(col), scene.e1.map(col),
                                  scene.e2.map(col))
        j = torch.argmin(t, dim=0, keepdim=True)
        tb = t.gather(0, j)[0]
        better = tb < best_t
        best_t = torch.where(better, tb, best_t)
        best_tri = torch.where(better, scene.slots[c0:c0 + chunk][j[0]], best_tri)
        best_u = torch.where(better, u.gather(0, j)[0], best_u)
        best_v = torch.where(better, v.gather(0, j)[0], best_v)
    hit = torch.isfinite(best_t)
    if active is not None:
        hit &= active
    return {"t": torch.where(hit, best_t, INF), "tri": torch.where(hit, best_tri, -1),
            "u": torch.where(hit, best_u, 0.0), "v": torch.where(hit, best_v, 0.0)}


def hit_geometry(scene, origin: Vec3, direction: Vec3, hit) -> dict:
    a = scene.attr[torch.clamp_min(hit["tri"], 0).long()].T
    u, v = hit["u"], hit["v"]
    w = 1.0 - u - v
    return {
        "point": origin + direction * hit["t"],
        "normal": Vec3(*(a[c] * w + a[3 + c] * u + a[6 + c] * v for c in range(3))),
        "ng": Vec3(a[9], a[10], a[11]),
        "tangent": Vec3(a[12], a[13], a[14]),
        "bitangent": Vec3(a[15], a[16], a[17]),
        "uv_u": a[18] * w + a[20] * u + a[22] * v,
        "uv_v": a[19] * w + a[21] * u + a[23] * v,
        "mat_id": a[24].to(torch.int32),
    }


def bounce_step(scene, st, rand4, nee: bool, rand2=None):
    active = st["active"]
    o, d = st["origin"], st["direction"]
    r = o.shape[0]
    ft = scene.ft
    hit = intersect(scene, o, d, active)
    rays = st["rays"] + active.sum()
    is_hit = active & torch.isfinite(hit["t"])
    geom = hit_geometry(scene, o, d, hit)
    backface = is_hit & ((geom["ng"].dot(d) > 0.0) | (geom["normal"].dot(d) > 0.0))
    shaded = is_hit & ~backface

    out = shade.shade(scene, d, geom["normal"].normalized(), geom["tangent"], geom["bitangent"],
                      geom["uv_u"], geom["uv_v"], geom["mat_id"], rand4, nee=nee, rand2=rand2)

    zero = Vec3.zeros((r,), o.x.device, ft)
    radiance = st["radiance"] + Vec3.where(shaded, st["throughput"] * out["emission"], zero)
    miss = active & ~is_hit
    bg = shade.eval_background(scene, d)
    if nee:
        pp2 = st["prev_pdf"] * st["prev_pdf"]
        if scene.env is not None:
            pl = shade.env_eval_pdf(scene.env, d)
            pl2 = pl * pl
        else:
            pl2 = shade.UNIFORM_SPHERE_PDF_SQ
        bg = bg * torch.where(torch.isfinite(st["prev_pdf"]), pp2 / (pp2 + pl2), 1.0).to(ft)
    radiance = radiance + Vec3.where(miss, st["throughput"] * bg, zero)

    if nee:
        wd = out["nee_dir"]
        lanes = torch.nonzero(shaded).squeeze(1)
        s_org = geom["point"] + geom["ng"] * torch.where(geom["ng"].dot(wd) < 0.0, -EPSILON,
                                                         EPSILON).to(ft)
        shot = intersect(scene, s_org.gather(lanes), wd.gather(lanes))
        lit = torch.zeros_like(shaded).index_fill_(0, lanes[~torch.isfinite(shot["t"])], True)
        radiance = radiance + Vec3.where(lit, st["throughput"] * out["nee_partial"], zero)
        rays = rays + lanes.numel()

    cont = shaded & ~out["terminate"]
    throughput = Vec3.where(cont, st["throughput"] * out["tint"], st["throughput"])
    bias = torch.where(geom["ng"].dot(out["direction"]) < 0.0, -EPSILON, EPSILON).to(ft)
    origin_shaded = geom["point"] + geom["ng"] * bias
    origin_back = geom["point"] + d * EPSILON
    new_origin = Vec3.where(backface, origin_back, Vec3.where(cont, origin_shaded, o))
    new_dir = Vec3.where(cont, out["direction"], d)
    prev_pdf = st["prev_pdf"]
    if nee:
        prev_pdf = torch.where(backface, prev_pdf, torch.where(cont, out["pdf_eval"], INF))
    return {"origin": new_origin, "direction": new_dir, "throughput": throughput,
            "radiance": radiance, "active": cont | backface, "rays": rays, "prev_pdf": prev_pdf}


_PLANES = ("origin", "direction", "throughput", "radiance", "prev_pdf", "active")


def trace(scene, origin: Vec3, direction: Vec3, key, max_bounces: int, nee: bool):
    """Live-lane compacted bounce loop with the slot-keyed draws: lane s
    of bounce i reads uniform(fold_in(fold_in(key, s), i), (3 or 7,)).
    Returns (radiance Vec3 by sample slot, rays traced)."""
    r = origin.shape[0]
    dev = origin.x.device
    ft = scene.ft
    result = Vec3(*(torch.zeros((r,), device=dev, dtype=ft) for _ in range(3)))
    st = {"origin": origin, "direction": direction,
          "throughput": Vec3.full((r,), 1.0, dev, ft), "radiance": Vec3.zeros((r,), dev, ft),
          "active": torch.ones((r,), dtype=torch.bool, device=dev),
          "rays": torch.zeros((), dtype=torch.int64, device=dev),
          "prev_pdf": torch.full((r,), INF, device=dev, dtype=ft)}
    slot = torch.arange(r, device=dev)
    nu = 7 if nee else 3
    for i in range(max_bounces):
        if slot.numel() == 0:
            break
        lane_keys = rng.fold_in(rng.fold_in(key, slot), i)
        rand = rng.uniform(lane_keys, (nu,)).T.to(ft)
        st = bounce_step(scene, st, rand[:4], nee, rand[4:] if nee else None)
        for c in "xyz":
            getattr(result, c).index_copy_(0, slot, getattr(st["radiance"], c))
        live = torch.nonzero(st["active"]).squeeze(1)
        if live.numel() < slot.numel():
            slot = slot[live]
            for name in _PLANES:
                v = st[name]
                st[name] = v.gather(live) if isinstance(v, Vec3) else v[live]
    return result, st["rays"]


def render_batch(scene, px, py, key, *, width: int, height: int, spp: int, max_bounces: int,
                 nee: bool):
    """One batch of pixels (px, py) with the batch key: the jitter from
    split(key)[0], the bounce draws from fold_in(key, 1). Returns (u8
    (P, 3), rays traced)."""
    p = px.shape[0]
    k_jit, _ = rng.split(key)
    jitter = rng.uniform(k_jit, (2, p * spp)).to(scene.ft)
    origin, direction = generate_rays(scene, width, height, px.repeat_interleave(spp),
                                      py.repeat_interleave(spp), jitter[0], jitter[1])
    radiance, rays = trace(scene, origin, direction, rng.fold_in(key, 1), max_bounces, nee)
    rgb = torch.stack([c.reshape(p, spp).mean(dim=1)
                       for c in (radiance.x, radiance.y, radiance.z)], dim=-1)
    return shade.encode_u8(rgb), rays


def render_batches(scene, seed: int, batches, *, width: int, height: int, spp: int,
                   max_bounces: int, nee: bool):
    """The pixels of the given batches of the frame rendered with `seed`.
    Returns {b: (xs, ys, rgb u8 (n, 3))} on the host, padding positions
    left out."""
    bp, nb, pad = batch_layout(width, height, spp)
    xs, ys, _ = pixel_tables(width, height, pad)
    key = rng.prng_key(seed, scene.device)
    n = width * height
    out = {}
    for b in batches:
        lo, hi = b * bp, min((b + 1) * bp, n)
        px = torch.from_numpy(xs[b * bp:(b + 1) * bp]).to(scene.device)
        py = torch.from_numpy(ys[b * bp:(b + 1) * bp]).to(scene.device)
        rgb, _ = render_batch(scene, px, py, rng.fold_in(key, b), width=width, height=height,
                              spp=spp, max_bounces=max_bounces, nee=nee)
        out[b] = (xs[lo:hi], ys[lo:hi], rgb[:hi - lo].cpu().numpy())
    return out


# --- the firefly median filter -------------------------------------------------------

DENOISING_THRESHOLD = 0.0125
NEIGHBOURHOOD_WEIGHT = 5.0


def _div(a, c: float):
    return a / torch.tensor(c, dtype=a.dtype, device=a.device)


def denoise_u8(img: torch.Tensor, ft=torch.float32) -> torch.Tensor:
    """(H, W, 3) u8 -> (H, W, 3) u8: the edge-clamped 3x3 neighbourhood
    sorted by Rec.709 luminance (stable), the median, the mean luminance
    without the least and greatest, and outliers in quiet neighbourhoods
    blended toward the median."""
    f = img.to(ft) * (1.0 / 255.999)
    h, w, _ = f.shape
    rows = torch.arange(h, device=f.device)
    cols = torch.arange(w, device=f.device)
    samples = []
    for dy in (-1, 0, 1):
        ys = torch.clamp(rows + dy, 0, h - 1)
        for dx in (-1, 0, 1):
            xs = torch.clamp(cols + dx, 0, w - 1)
            samples.append(f[ys][:, xs])
    luma = shade.LUMA
    lums = [(s[..., 0] * luma[0] + s[..., 1] * luma[1]) + s[..., 2] * luma[2] for s in samples]
    lum = torch.stack(lums, dim=-1)
    lum_sorted, order = torch.sort(lum, dim=-1, stable=True)
    stack = torch.stack(samples, dim=2)
    median_rgb = torch.gather(stack, 2, order[..., 4:5, None].expand(h, w, 1, 3))[:, :, 0]
    median_lum = lum_sorted[..., 4]
    total = lums[0]
    for lv in lums[1:]:
        total = total + lv
    mean = _div(total - lum_sorted[..., 0] - lum_sorted[..., 8], 7.0)
    noisiness = torch.abs(median_lum - mean)
    diff = torch.abs(median_lum - lums[4]) - noisiness * NEIGHBOURHOOD_WEIGHT
    t = _div(torch.clamp(diff, 0.0, DENOISING_THRESHOLD), DENOISING_THRESHOLD)[..., None]
    out = samples[4] * (1.0 - t) + median_rgb * t
    return (out * 255.999).to(torch.uint8)
