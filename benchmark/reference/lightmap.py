"""The plain reference of a lightmap bake (`raytracing_c_tpu_torch/render/
lightmap.py:bake_lightmap`; the reference C renderer's lightmap_bake,
raytracer.c:722-784): its own UV rasterization, its own hemisphere draw,
and the culled intersection under a dense bounce loop with pre-drawn
uniforms.

- Rasterization reads the soup (positions, normals, the lightmap UVs) in
  the slot order of the benchmark's own tree (`roofline/bvh.py`): the
  occupied slots ascending, each triangle's UV box row by row, a texel
  kept where its three barycentrics are >= -1e-4 (raytracer.c:727-757),
  later records overwriting earlier ones. The triangle's corners are v0,
  v0 + (v1 - v0) and v0 + (v2 - v0) in float32, as a stored triangle
  gives them; the UVs and barycentrics are float64. Nothing of the
  program's store is read, so a program that rasterizes other slots, or
  other UVs, writes other texels or other values.
- Batch b holds the texel records [b * batch_texels, (b + 1) *
  batch_texels); its key is fold_in(PRNGKey(seed), b * batch_texels),
  split into the direction and the material keys. The directions are
  normal draws, sqrt(2) * erfinv(u) of u uniform on [nextafter(-1, 0), 1)
  (frozen copies of `raytracing_c_tpu_torch/utils/rng.py`'s plain
  `uniform` and `erfinv` at commit 6c8c098), normalised, the half below
  the texel's normal reflected; the origins are the texel's position
  moved 1e-4 along its normal. One dense (max_bounces, 4, R) uniform
  draw a batch feeds the bounces.
- The bounce loop is `trace.py`'s bounce_step on every lane (a private
  copy whose `intersect` is `culled.py`'s), stopping once no lane is
  active, as `render/integrator.py:trace` does; then the cosine weight,
  and the mean over a texel's samples as the bake takes it on the host
  (numpy's float mean).

The texel preparation and the mean are numpy on the host, as in the bake,
in float32 (float64 for the float64 variant; the bfloat16 control rounds
its inputs and its trace to bfloat16). TF32 is off. No JAX and no kernel
of the program is imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import culled, rng
from reference.vec3 import Vec3
from roofline.bvh import build_bvh

EPSILON = 1.0e-4
#: candidate texels a rasterization chunk holds at most
ARENA = 1 << 22


def slot_map(positions: np.ndarray) -> np.ndarray:
    """The benchmark's own tree's leaf slots: (capacity,) soup index or -1."""
    return build_bvh(np.asarray(positions, np.float32))["slot_map"]


def rasterize(positions, normals, uvs, slots: np.ndarray, width: int, height: int) -> dict:
    """The texel records of the soup's triangles (positions, normals (n,
    3, 3), uvs (n, 3, 2) float32) taken in the order of `slots` (the
    occupied slots' soup indices, ascending by slot). Returns index (T,)
    int64 texel ids, position and normal (T, 3) float64, tri (T,) the
    record's position in `slots`, and candidates, the texels tested."""
    p = torch.from_numpy(np.asarray(positions, np.float32)[slots])
    v0 = p[:, 0]
    v1 = v0 + (p[:, 1] - v0)
    v2 = v0 + (p[:, 2] - v0)
    nrm = torch.from_numpy(np.asarray(normals, np.float32)[slots])
    uv = torch.from_numpy(np.asarray(uvs, np.float32)[slots]).double()
    uv = uv * torch.tensor([float(width), float(height)], dtype=torch.float64)
    a, b, c = uv[:, 0], uv[:, 1], uv[:, 2]
    denom = (b[:, 1] - c[:, 1]) * (a[:, 0] - c[:, 0]) + (c[:, 0] - b[:, 0]) * (a[:, 1] - c[:, 1])
    lo = torch.trunc(torch.minimum(torch.minimum(a, b), c)).long()
    hi = torch.trunc(torch.maximum(torch.maximum(a, b), c)).long()
    x0, y0 = lo[:, 0].clamp_min(0), lo[:, 1].clamp_min(0)
    x1, y1 = hi[:, 0].clamp_max(width - 1), hi[:, 1].clamp_max(height - 1)
    ok = (denom.abs() >= 1e-20) & (x1 >= x0) & (y1 >= y0)
    tris = torch.nonzero(ok).squeeze(1)
    bw = x1[tris] - x0[tris] + 1
    area = bw * (y1[tris] - y0[tris] + 1)
    ends = torch.cumsum(area, 0)
    parts = []
    first = 0
    while first < tris.numel():
        # whole triangles, ARENA candidates at most (one triangle at least)
        base = int(ends[first] - area[first])
        last = max(first + 1, int(torch.searchsorted(ends, base + ARENA, right=True)))
        n = area[first:last]
        k = torch.repeat_interleave(torch.arange(first, last), n)
        local = torch.arange(int(n.sum())) - torch.repeat_interleave(ends[first:last] - n - base, n)
        tk = tris[k]
        gx = x0[tk] + local % bw[k]
        gy = y0[tk] + local // bw[k]
        dx = gx.double() - c[tk, 0]
        dy = gy.double() - c[tk, 1]
        w0 = ((b[tk, 1] - c[tk, 1]) * dx + (c[tk, 0] - b[tk, 0]) * dy) / denom[tk]
        w1 = ((c[tk, 1] - a[tk, 1]) * dx + (a[tk, 0] - c[tk, 0]) * dy) / denom[tk]
        w2 = 1.0 - w0 - w1
        keep = (w0 >= -EPSILON) & (w1 >= -EPSILON) & (w2 >= -EPSILON)
        tk, w0, w1, w2 = tk[keep], w0[keep, None], w1[keep, None], w2[keep, None]
        parts.append((
            gx[keep] + gy[keep] * width,
            v0[tk].double() * w0 + v1[tk].double() * w1 + v2[tk].double() * w2,
            nrm[tk, 0].double() * w0 + nrm[tk, 1].double() * w1 + nrm[tk, 2].double() * w2,
            tk))
        first = last
    if not parts:
        parts = [(torch.zeros(0, dtype=torch.int64), torch.zeros((0, 3), dtype=torch.float64),
                  torch.zeros((0, 3), dtype=torch.float64), torch.zeros(0, dtype=torch.int64))]
    index, pos, nn, tri = (torch.cat(x).numpy() for x in zip(*parts))
    return {"index": index, "position": pos, "normal": nn, "tri": tri,
            "candidates": int(area.sum())}


def last_writes(index: np.ndarray) -> np.ndarray:
    """Whether each record is the last to write its texel (the value the
    map keeps)."""
    order = torch.arange(len(index))
    last = torch.full((int(index.max()) + 1 if len(index) else 0,), -1, dtype=torch.int64)
    last = last.scatter_reduce(0, torch.from_numpy(index), order, "amax")
    return (last[torch.from_numpy(index)] == order).numpy()


# --- the draws: frozen copies of the port's plain uniform on [lo, hi) and erfinv ---------

_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def uniform_range(key: torch.Tensor, shape, minval: float, maxval: float) -> torch.Tensor:
    bits = rng.random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=f.device) - lo
    return torch.maximum(lo, (f.double() * span.double() + lo.double()).float())


def erfinv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERFINV_W_LT_5[0], _ERFINV_W_GE_5[0])
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        c = torch.where(lt, torch.tensor(a, dtype=torch.float32, device=x.device),
                        torch.tensor(b, dtype=torch.float32, device=x.device))
        p = (c.double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    return math.sqrt(2.0) * erfinv(uniform_range(key, shape, lo, 1.0))


# --- the bake -------------------------------------------------------------------------

_TRACE = None


def trace_dense(scene, origin: Vec3, direction: Vec3, uniforms: torch.Tensor,
                max_bounces: int):
    """Every lane through `max_bounces` bounces of trace.py's bounce_step
    with the culled intersection, uniforms[i] (4, R) feeding bounce i;
    stops once no lane is active. Returns (radiance Vec3, rays traced)."""
    global _TRACE
    if _TRACE is None:
        _TRACE = culled._trace_copy()
    r = origin.shape[0]
    dev, ft = origin.x.device, scene.ft
    st = {"origin": origin, "direction": direction,
          "throughput": Vec3.full((r,), 1.0, dev, ft), "radiance": Vec3.zeros((r,), dev, ft),
          "active": torch.ones((r,), dtype=torch.bool, device=dev),
          "rays": torch.zeros((), dtype=torch.int64, device=dev),
          "prev_pdf": torch.full((r,), float("inf"), device=dev, dtype=ft)}
    for i in range(max_bounces):
        if i > 0 and not bool(st["active"].any()):
            break
        st = _TRACE.bounce_step(scene, st, uniforms[i].to(ft), False)
    return st["radiance"], st["rays"]


def bake_batches(scene, texels: dict, seed: int, batches, *, samples: int, max_bounces: int,
                 batch_texels: int) -> dict:
    """The given batches' texel values on the scene's device, in its float
    type: {b: (the records' texel ids, (n, 3) float64 numpy)}."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return {b: _bake_batch(scene, texels, seed, b, samples, max_bounces, batch_texels)
                for b in batches}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _bake_batch(scene, texels, seed, b, samples, max_bounces, batch_texels):
    dev, ft = scene.device, scene.ft
    host = np.float64 if ft == torch.float64 else np.float32
    lo = b * batch_texels
    hi = min(lo + batch_texels, len(texels["index"]))
    t = hi - lo
    k_dir, k_mat = rng.split(rng.fold_in(rng.prng_key(seed, dev), lo))
    g = normal(k_dir, (3, t * samples)).to(ft)
    uni = rng.uniform(k_mat, (max_bounces, 4, t * samples))

    nn = texels["normal"][lo:hi].astype(host)
    nn = nn / np.maximum(np.linalg.norm(nn, axis=-1, keepdims=True), 1e-30)
    start = texels["position"][lo:hi].astype(host) + nn * EPSILON

    def rep(a):
        return torch.from_numpy(np.repeat(a, samples)).to(dev).to(ft)

    d = Vec3(g[0], g[1], g[2]).normalized()
    cos = d.dot(Vec3(rep(nn[:, 0]), rep(nn[:, 1]), rep(nn[:, 2])))
    d = Vec3.where(cos < 0, -d, d)
    cos = torch.abs(cos)
    origin = Vec3(rep(start[:, 0]), rep(start[:, 1]), rep(start[:, 2]))
    radiance, _ = trace_dense(scene, origin, d, uni, max_bounces)
    rad = radiance * cos
    mean = [(c if ft != torch.bfloat16 else c.float()).cpu().numpy().reshape(t, samples).mean(1)
            for c in (rad.x, rad.y, rad.z)]
    return texels["index"][lo:hi], np.stack(mean, -1).astype(np.float64)
