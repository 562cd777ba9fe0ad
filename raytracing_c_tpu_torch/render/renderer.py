"""Batched tile renderer.

Counterpart of `raytracing_c_tpu/render/renderer.py`: the image is cut
into flat pixel batches in 32x32 tile order (the reference's chunks,
raytracer.c:596-720); each batch renders as one ray arena of
(pixels x spp) rays on the scene's device, and its u8 pixels land in a
device-resident frame buffer that is read back once at the end. The JAX
package's batch grouping, drain thread pool and device mesh are TPU
dispatch plumbing and have no counterpart.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass

import numpy as np
import torch

from raytracing_c_tpu_torch.ops import env_light
from raytracing_c_tpu_torch.render import camera as camera_mod
from raytracing_c_tpu_torch.render import integrator
from raytracing_c_tpu_torch.utils import color, rng


@dataclass
class RenderStats:
    """Render timers and throughput (the reference's -V metrics,
    driver.c:776-836), with rays = every scene intersection executed."""

    wall_ms: float = 0.0
    samples: int = 0
    rays_traced: int = 0
    batches: int = 0

    @property
    def samples_per_sec(self) -> float:
        return self.samples / max(self.wall_ms / 1e3, 1e-9)

    @property
    def mrays_per_sec(self) -> float:
        return self.rays_traced / 1e6 / max(self.wall_ms / 1e3, 1e-9)


def _draw_uniforms(key, r: int, max_bounces: int, nee: bool = False,
                   skip_mat: bool = False):
    """One threefry draw for raygen jitter (2, R) and, for the dense
    tracer, the per-bounce material uniforms (max_bounces, 4, R) and, with
    nee, the light-sample uniforms (max_bounces, 3, R) from their own
    stream fold_in(key, 7919), so that the others do not change with nee.
    Returns (jitter, uniforms or None, nee uniforms or None)."""
    k_jit, k_mat = rng.split(key)
    jitter = rng.uniform(k_jit, (2, r))
    if skip_mat:
        return jitter, None, None
    uniforms = rng.uniform(k_mat, (max_bounces, 4, r))
    nee_uniforms = rng.uniform(rng.fold_in(key, 7919), (max_bounces, 3, r)) if nee else None
    return jitter, uniforms, nee_uniforms


def _batch_core(scene, px, py, jitter, uniforms, nee_uniforms, key, *, width, height,
                spp, max_bounces, method, texture_mode, compact, rr, nee, tonemap=None):
    """raygen -> trace -> per-pixel spp mean -> u8. The dense tracer reads
    the pre-drawn `uniforms` (and `nee_uniforms`); the bucketed tracer
    derives its uniforms from (key, sample slot, bounce)."""
    p = px.shape[0]
    origin, direction = camera_mod.generate_rays(
        scene.camera, width, height, px.repeat_interleave(spp),
        py.repeat_interleave(spp), jitter[0], jitter[1],
    )
    if compact:
        radiance, rays = integrator.trace_bucketed(
            scene, origin, direction, key, max_bounces, method=method,
            texture_mode=texture_mode, rr=rr, nee=nee,
        )
    else:
        radiance, rays = integrator.trace(
            scene, origin, direction, uniforms, max_bounces, method=method,
            texture_mode=texture_mode, rr=rr, nee=nee, nee_uniforms=nee_uniforms,
        )
    rgb = torch.stack([c.reshape(p, spp).mean(dim=1)
                       for c in (radiance.x, radiance.y, radiance.z)], dim=-1)
    if tonemap == "aces":
        rgb = color.aces(rgb)
    elif tonemap == "reinhard":
        rgb = color.reinhard(rgb)
    return color.encode_u8(rgb), rays


@functools.lru_cache(maxsize=8)
def _pixel_tables(width: int, height: int, pad: int):
    """Tile-ordered pixel tables (32x32 chunks, raytracer.c:601), padded to
    whole batches; out[perm[i]] is the pixel rendered at position i."""
    tile = 32
    ids = np.arange(width * height, dtype=np.int64)
    x = ids % width
    y = ids // width
    order = np.lexsort((x % tile, y % tile, x // tile, y // tile))
    xs = np.concatenate([x[order].astype(np.int32), np.zeros(pad, np.int32)])
    ys = np.concatenate([y[order].astype(np.int32), np.zeros(pad, np.int32)])
    return xs, ys, order


def render(scene, width: int, height: int, spp: int = 16, max_bounces: int = 8,
           seed: int = 0, batch_pixels: int | None = None, method: str = "auto",
           texture_mode: str = "bilinear", limit_batches: int | None = None,
           compact: bool | None = None, rr: bool = False, nee: bool = False,
           tonemap: str | None = None, progress=None, to_host: bool = True):
    """Render a full image on the scene's device.

    Returns (image u8 (H, W, 3) numpy, RenderStats); with to_host=False the
    image is the frame buffer itself, a tensor on the scene's device, and
    the wall time ends when the frame is complete. method="auto" picks the
    brute-force oracle for scenes of <= 64 triangle slots (the reference's
    own `#if 0` path) and the "bvh" traversal kernel otherwise. compact
    (default on) selects the live-lane compacted tracer. limit_batches
    renders only the first batches (the rest of the frame stays black).
    progress(done, total) is called after each batch is enqueued. nee
    (environment next-event estimation with MIS, default off) builds the
    scene's env-light table first if the scene has none yet
    (`env_light.scene_env_light`), outside the timed loop.
    """
    if nee:
        env_light.scene_env_light(scene)
    if compact is None:
        compact = True
    if method == "auto":
        method = "brute" if scene.triangles.capacity <= 64 else "bvh"

    n_pixels = width * height
    if batch_pixels is None:
        batch_pixels = max(1, min(n_pixels, 262_144 // max(spp, 1)))
    n_batches = (n_pixels + batch_pixels - 1) // batch_pixels
    pad = n_batches * batch_pixels - n_pixels
    xs, ys, perm = _pixel_tables(width, height, pad)
    if limit_batches is not None:
        n_batches = min(n_batches, limit_batches)

    dev = scene.device
    xs_d = torch.from_numpy(xs).to(dev)
    ys_d = torch.from_numpy(ys).to(dev)
    perm_d = torch.from_numpy(perm).to(dev)
    key = rng.prng_key(seed, dev)
    frame = torch.zeros((n_pixels, 3), dtype=torch.uint8, device=dev)
    rays_per_batch = torch.zeros((max(n_batches, 1),), dtype=torch.int64, device=dev)

    t0 = time.perf_counter()
    for b in range(n_batches):
        lo = b * batch_pixels
        kb = rng.fold_in(key, b)
        jitter, uniforms, nee_uniforms = _draw_uniforms(
            kb, batch_pixels * spp, max_bounces, nee, skip_mat=compact)
        rgb, rays = _batch_core(
            scene, xs_d[lo:lo + batch_pixels], ys_d[lo:lo + batch_pixels],
            jitter, uniforms, nee_uniforms, rng.fold_in(kb, 1), width=width,
            height=height, spp=spp, max_bounces=max_bounces, method=method,
            texture_mode=texture_mode, compact=compact, rr=rr, nee=nee, tonemap=tonemap,
        )
        hi = min(lo + batch_pixels, n_pixels)
        frame[perm_d[lo:hi]] = rgb[: hi - lo]
        rays_per_batch[b] = rays
        if progress is not None:
            progress(b + 1, n_batches)
    img = frame.reshape(height, width, 3)
    if to_host:
        img = img.cpu().numpy()
    # the counters follow the last batch on the stream: reading them waits
    # for the whole frame
    rays_total = float(rays_per_batch.cpu().numpy().astype(np.float64).sum())
    wall_ms = (time.perf_counter() - t0) * 1e3

    return img, RenderStats(
        wall_ms=wall_ms,
        samples=n_pixels * spp,
        rays_traced=int(rays_total),
        batches=n_batches,
    )
