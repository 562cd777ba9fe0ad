"""Lightmap baking.

Counterpart of `raytracing_c_tpu/render/lightmap.py` (lightmap_bake,
raytracer.c:722-784): every triangle's UV-space bounding box is
rasterized on the host with a barycentric inside test, each covered texel
gets its world position and normal, and the texels' hemisphere rays go
through the path integrator on the scene's device, a batch of
batch_texels x samples rays at a time; the texel keeps the mean
cosine-weighted radiance.

The triangles are the occupied slots of the padded store (mat_id >= 0),
read in ascending slot order. That order fixes the texel records' order,
so which triangle overwrites which at a shared texel, the batch
boundaries and each batch's key fold_in(PRNGKey(seed), first record). The
JAX package reads the first n_triangles slots instead (its lightmap.py,
`_rasterize_host`), which on a padded tree hold only some of the
triangles; on a scene with no padding ahead of slot n the two read the
same records. The UVs are the scene's lightmap UV set where it has one
(`Scene.lightmap_uvs`, glTF TEXCOORD_1: unique, so no two charts share a
texel), else the texture UVs, as the reference renderer does.

As in the JAX package: directions are Gaussian draws normalised, the half
below the horizon reflected (uniform on the hemisphere, stateless; the
reference rejection-samples, raytracer.c:765-773), and the lightmap stays
float32 (the reference truncates into u8). The streams are the JAX
package's: batch key fold_in(PRNGKey(seed), first texel record), split
into the direction and material keys.

Spans (`utils/spans.py`, off by default): `bake` (width, height, samples,
triangles read, texels covered, batches, rays) over `rasterize`
(kernel: `native`, the C rasterizer `native/raster.c`; candidates: the
texels of the triangles' UV boxes; texels covered; overwritten: texels
written by more than one triangle) and one `batch` span a texel batch (texels,
rays) that holds `rng` (the batch's keys, Gaussian and bounce draws),
`raygen` (the hemisphere directions and the origins: the normals'
normalisation, the repeat and the upload), the tracer's `bounce` spans and
`readback` (the radiance to the host and the scatter into the map).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from raytracing_c_tpu_torch import EPSILON
from raytracing_c_tpu_torch.ops import traverse
from raytracing_c_tpu_torch.render import integrator
from raytracing_c_tpu_torch.utils import rng, spans
from raytracing_c_tpu_torch.utils.vec3 import Vec3

#: texel records a batch by default: 262,144 rays at 16 samples
BATCH_TEXELS = 16384


@dataclass
class Texels:
    """A rasterization's texel records, in record order: the texel each
    writes (row-major id, i64), its world position and interpolated normal
    ((T, 3) f32) and the slot of the triangle that wrote it (i64); with
    the triangles read, the candidate texels tested, and the texels
    covered and written more than once."""

    index: np.ndarray
    position: np.ndarray
    normal: np.ndarray
    slot: np.ndarray
    triangles: int = 0
    candidates: int = 0
    covered: int = 0
    overwritten: int = 0

    def __len__(self) -> int:
        return len(self.index)

    def select(self, keep: np.ndarray) -> "Texels":
        """The records where `keep` holds, in their order; counts of the
        texels recomputed."""
        index = self.index[keep]
        counts = np.bincount(index)
        return Texels(index, self.position[keep], self.normal[keep], self.slot[keep],
                      self.triangles, self.candidates, int((counts > 0).sum()),
                      int((counts > 1).sum()))


def rasterize(scene, width: int, height: int) -> Texels:
    """UV-space rasterization of every occupied slot's triangle into texel
    records: the bbox + barycentric inside test of raytracer.c:727-757,
    triangle by triangle in ascending slot order, then row-major in the box
    (so overlapping triangles overwrite in ascending slot order), in native
    C (`native/raster.c`). Span: `rasterize`."""
    with spans.span("rasterize"):
        texels = _rasterize(scene, width, height)
        spans.note(candidates=texels.candidates, texels=texels.covered,
                   overwritten=texels.overwritten)
    return texels


def _host_triangles(scene):
    """The occupied slots (ascending, i64) and their triangles on the host:
    (n, 3, 2) f32 UVs (the lightmap UV set where the scene has one, else the
    texture UVs) and (n, 3) f32 v0, e1, e2, n0, n1, n2."""
    tris = scene.triangles
    occ = torch.nonzero(tris.mat_id >= 0).squeeze(1)
    slots = occ.cpu().numpy()

    def host(a):
        return a.index_select(0, occ).cpu().numpy()

    def planes(v):
        return np.stack([host(v.x), host(v.y), host(v.z)], axis=-1)

    if scene.lightmap_uvs is not None:
        uv = np.ascontiguousarray(scene.lightmap_uvs[slots], np.float32)
    else:
        uv = np.stack([host(a) for a in (tris.uv0u, tris.uv0v, tris.uv1u, tris.uv1v,
                                         tris.uv2u, tris.uv2v)], axis=-1).reshape(-1, 3, 2)
    return (slots, uv, planes(tris.v0), planes(tris.e1), planes(tris.e2), planes(tris.n0),
            planes(tris.n1), planes(tris.n2))


def _rasterize(scene, width: int, height: int) -> Texels:
    """The texel records, from the native rasterizer; the same records,
    byte for byte, as `_rasterize_plain`."""
    from raytracing_c_tpu_torch.native import raster_native

    slots, uv, v0, e1, e2, n0, n1, n2 = _host_triangles(scene)
    index, position, normal, slot, candidates, covered, overwritten = \
        raster_native().rasterize(uv, v0, e1, e2, n0, n1, n2, slots, width, height)
    spans.note(kernel="native")
    return Texels(index, position, normal, slot, len(slots), candidates, covered, overwritten)


def _rasterize_plain(scene, width: int, height: int) -> Texels:
    """The plain numpy version of `_rasterize`: a flat arena of candidate
    texels (slot-major, then row-major in the box), float64 weights."""
    slots, uv, v0, e1, e2, n0, n1, n2 = _host_triangles(scene)
    uv0, uv1, uv2 = (uv[:, k] * [width, height] for k in range(3))
    v1 = v0 + e1
    v2 = v0 + e2

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
        return Texels(np.zeros(0, np.int64), np.zeros((0, 3), np.float32),
                      np.zeros((0, 3), np.float32), np.zeros(0, np.int64), len(slots))

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
    index = (gx[inside] + gy[inside] * width).astype(np.int64)
    counts = np.bincount(index, minlength=width * height)
    return Texels(index, pos.astype(np.float32), nrm.astype(np.float32), slots[tri],
                  len(slots), total, int((counts > 0).sum()), int((counts > 1).sum()))


def bake_batches(scene, texels: Texels, lightmap: np.ndarray, key, batches, *, samples: int,
                 max_bounces: int, batch_texels: int, method: str) -> torch.Tensor:
    """Bake the texel batches `batches` (batch b: records [b * batch_texels,
    (b + 1) * batch_texels)) into `lightmap`, (H * W, 3) float32 written at
    the records' texels in record order, under the bake's key; `method` as
    `traverse.port_method` names it. A group of batches run alone computes
    what the whole bake computes for them. Returns the rays traced, a 0-d
    tensor on the scene's device. Spans: one `batch` a batch."""
    dev = scene.device
    rays_total = torch.zeros((), dtype=torch.int64, device=dev)

    def rep(a):
        return torch.from_numpy(np.repeat(a, samples)).to(dev)

    for b in batches:
        lo = b * batch_texels
        hi = min(lo + batch_texels, len(texels))
        t = hi - lo
        with spans.span("batch", texels=t):
            with spans.span("rng"):
                k_dir, k_mat = rng.split(rng.fold_in(key, lo))
                g = rng.normal(k_dir, (3, t * samples))
                uni = rng.uniform(k_mat, (max_bounces, 4, t * samples))

            # uniform on the hemisphere about the normal, cosine-weighted estimate
            with spans.span("raygen"):
                nn = texels.normal[lo:hi]
                nn = nn / np.maximum(np.linalg.norm(nn, axis=-1, keepdims=True), 1e-30)
                d = Vec3(g[0], g[1], g[2]).normalized()
                cos = d.dot(Vec3(rep(nn[:, 0]), rep(nn[:, 1]), rep(nn[:, 2])))
                d = Vec3.where(cos < 0, -d, d)
                cos = torch.abs(cos)
                start = texels.position[lo:hi] + nn * EPSILON
                origins = Vec3(rep(start[:, 0]), rep(start[:, 1]), rep(start[:, 2]))

            radiance, rays = integrator.trace(scene, origins, d, uni, max_bounces, method=method)
            rays_total += rays
            with spans.span("readback"):
                rad = radiance * cos
                lightmap[texels.index[lo:hi]] = np.stack(
                    [c.cpu().numpy().reshape(t, samples).mean(axis=1)
                     for c in (rad.x, rad.y, rad.z)], axis=-1)
            if spans.enabled():
                spans.note(rays=int(rays))
    return rays_total


def bake_lightmap(scene, width: int, height: int, samples: int = 16, max_bounces: int = 8,
                  seed: int = 0, batch_texels: int = BATCH_TEXELS, method: str = "auto",
                  stats: dict | None = None):
    """Bake a float32 (height, width, 3) irradiance lightmap on the scene's
    device. method="auto" runs the brute-force oracle for scenes of <= 64
    triangle slots and the "bvh" traversal kernel (K1) otherwise; the JAX
    package's names map as `traverse.port_method` says. Texels no
    triangle covers stay 0. With `stats`, it receives texels (records),
    covered (texels), triangles (read), batches and rays (traced). Span:
    `bake`."""
    method = traverse.port_method(method, scene)
    with spans.span("bake", width=width, height=height, samples=samples):
        texels = rasterize(scene, width, height)
        lightmap = np.zeros((height * width, 3), np.float32)
        n_batches = -(-len(texels) // batch_texels)
        rays = int(bake_batches(scene, texels, lightmap, rng.prng_key(seed, scene.device),
                                range(n_batches), samples=samples, max_bounces=max_bounces,
                                batch_texels=batch_texels, method=method))
        spans.note(triangles=texels.triangles, texels=texels.covered, batches=n_batches,
                   rays=rays)
    if stats is not None:
        stats.update(texels=len(texels), covered=texels.covered, triangles=texels.triangles,
                     batches=n_batches, rays=rays)
    return lightmap.reshape(height, width, 3)
