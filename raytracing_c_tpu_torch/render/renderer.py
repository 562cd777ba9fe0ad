"""Batched tile renderer.

Counterpart of `raytracing_c_tpu/render/renderer.py`: the image is cut
into flat pixel batches in 32x32 tile order (the reference's chunks,
raytracer.c:596-720); each batch renders as one ray arena of
(pixels x spp) rays on the scene's device, and its u8 pixels land in a
device-resident frame buffer that is read back once at the end.

With a mesh (`parallel/mesh.py`, one process per device), every rank runs
the same batch loop and renders its contiguous block of each batch
(`render_batch_sharded`, the JAX package's shard_map): the random draws of
a batch are global and each rank keeps its slice, so the dense tracer
gives the single-process image bit for bit; the compacted tracer keys its
draws by local slot under fold_in(fold_in(key, 1), rank), as each JAX
shard does. Each rank keeps its blocks in a frame shard on its device;
the frame is gathered once, in rank order, at the end of the render, and
the ray counter is reduced once. The JAX package's batch grouping and
drain thread pool are TPU dispatch plumbing and have no counterpart.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from raytracing_c_tpu_torch.ops import env_light
from raytracing_c_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce, shard_rays
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


def _method(scene, method: str) -> str:
    """method="auto": the brute-force oracle for scenes of <= 64 triangle
    slots (the reference's own `#if 0` path), else the "bvh" kernel."""
    if method == "auto":
        return "brute" if scene.triangles.capacity <= 64 else "bvh"
    return method


def render_batch(scene, px, py, key, *, width: int, height: int, spp: int,
                 max_bounces: int, method: str = "auto", texture_mode: str = "bilinear",
                 compact: bool = False, rr: bool = False, nee: bool = False,
                 tonemap: str | None = None):
    """Render one flat batch of pixels px, py ((P,) int32) with `key`:
    the batch's draws from key, the tracer's from fold_in(key, 1).
    Returns (rgb u8 (P, 3), rays traced (int64 scalar tensor))."""
    if nee:
        env_light.scene_env_light(scene)
    jitter, uniforms, nee_uniforms = _draw_uniforms(key, px.shape[0] * spp, max_bounces, nee,
                                                    skip_mat=compact)
    return _batch_core(
        scene, px, py, jitter, uniforms, nee_uniforms, rng.fold_in(key, 1), width=width,
        height=height, spp=spp, max_bounces=max_bounces, method=_method(scene, method),
        texture_mode=texture_mode, compact=compact, rr=rr, nee=nee, tonemap=tonemap,
    )


def _render_shard(scene, px, py, key, mesh: Mesh, **kw):
    """This rank's block of the batch px, py (the whole batch's pixels):
    the batch's global draws from key, sliced along the ray axis, and the
    tracer's key fold_in(fold_in(key, 1), rank). No collective."""
    jitter, uniforms, nee_uniforms = _draw_uniforms(
        key, px.shape[0] * kw["spp"], kw["max_bounces"], kw["nee"], skip_mat=kw["compact"])
    block = lambda a: None if a is None else shard_rays(a, mesh, axis=-1)  # noqa: E731
    return _batch_core(scene, shard_rays(px, mesh), shard_rays(py, mesh), block(jitter),
                       block(uniforms), block(nee_uniforms),
                       rng.fold_in(rng.fold_in(key, 1), mesh.rank), **kw)


def render_batch_sharded(scene, px, py, key, *, mesh: Mesh, width: int, height: int,
                         spp: int, max_bounces: int, method: str = "auto",
                         texture_mode: str = "bilinear", compact: bool = False,
                         rr: bool = False, nee: bool = False, tonemap: str | None = None):
    """render_batch over the mesh: every rank passes the whole batch px, py
    (its length a multiple of the world size) and renders its contiguous
    block (`_render_shard`). Returns (this rank's rgb u8 (P / n, 3), the
    rays traced by all ranks, summed on the backend's collective device)."""
    if nee:
        env_light.scene_env_light(scene)
    rgb, rays = _render_shard(
        scene, px, py, key, mesh, width=width, height=height, spp=spp,
        max_bounces=max_bounces, method=_method(scene, method), texture_mode=texture_mode,
        compact=compact, rr=rr, nee=nee, tonemap=tonemap)
    return rgb, all_reduce(rays, mesh)


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
           tonemap: str | None = None, progress=None, to_host: bool = True,
           mesh: Mesh | None = None):
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

    mesh: every rank of the mesh calls render with its copy of the scene
    (`parallel/mesh.py:replicate_scene`, on the mesh's device) and the same
    arguments. batch_pixels rounds down to a multiple of the world size n
    (at least n); each rank renders its block of every batch
    (`render_batch_sharded`, less its per-batch reduction), the frame is
    gathered once at the end, and every rank returns the same image and
    RenderStats (wall_ms the slowest rank's); progress fires on rank 0.
    """
    if mesh is not None and scene.device != mesh.device:
        raise ValueError(f"render: the scene is on {scene.device}, the mesh's rank on "
                         f"{mesh.device}")
    if nee:
        env_light.scene_env_light(scene)
    if compact is None:
        compact = True
    method = _method(scene, method)

    n_pixels = width * height
    if batch_pixels is None:
        batch_pixels = max(1, min(n_pixels, 262_144 // max(spp, 1)))
    if mesh is not None:
        n = mesh.world_size
        batch_pixels = max(n, (batch_pixels // n) * n)
    n_batches = (n_pixels + batch_pixels - 1) // batch_pixels
    pad = n_batches * batch_pixels - n_pixels
    xs, ys, perm = _pixel_tables(width, height, pad)
    if limit_batches is not None:
        n_batches = min(n_batches, limit_batches)

    dev = scene.device
    xs_d = torch.from_numpy(xs).to(dev)
    ys_d = torch.from_numpy(ys).to(dev)
    key = rng.prng_key(seed, dev)
    rays_per_batch = torch.zeros((max(n_batches, 1),), dtype=torch.int64, device=dev)
    kw = dict(width=width, height=height, spp=spp, max_bounces=max_bounces, method=method,
              texture_mode=texture_mode, compact=compact, rr=rr, nee=nee, tonemap=tonemap)

    if mesh is None:
        perm_d = torch.from_numpy(perm).to(dev)
        frame = torch.zeros((n_pixels, 3), dtype=torch.uint8, device=dev)
        t0 = time.perf_counter()
        for b in range(n_batches):
            lo = b * batch_pixels
            rgb, rays = render_batch(scene, xs_d[lo:lo + batch_pixels],
                                     ys_d[lo:lo + batch_pixels], rng.fold_in(key, b), **kw)
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
        rays_total = int(rays_per_batch.sum())
        wall_ms = (time.perf_counter() - t0) * 1e3
    else:
        shard = torch.zeros((n_batches, batch_pixels // mesh.world_size, 3),
                            dtype=torch.uint8, device=dev)
        t0 = time.perf_counter()
        for b in range(n_batches):
            lo = b * batch_pixels
            shard[b], rays_per_batch[b] = _render_shard(
                scene, xs_d[lo:lo + batch_pixels], ys_d[lo:lo + batch_pixels],
                rng.fold_in(key, b), mesh, **kw)
            if progress is not None and mesh.rank == 0:
                progress(b + 1, n_batches)
        # position i of the tile order is rank (i % batch) // (batch / n)'s
        # pixel: the blocks of batch b, in rank order, are its positions
        flat = torch.stack(all_gather(shard, mesh), 1).reshape(-1, 3)
        done = min(n_batches * batch_pixels, n_pixels)
        frame = torch.zeros((n_pixels, 3), dtype=torch.uint8, device=flat.device)
        frame[torch.from_numpy(perm[:done]).to(flat.device)] = flat[:done]
        img = frame.reshape(height, width, 3)
        img = img.cpu().numpy() if to_host else img.to(dev)
        rays_total = int(all_reduce(rays_per_batch.sum(), mesh))
        wall_ms = (time.perf_counter() - t0) * 1e3
        wall_ms = float(all_reduce(torch.tensor(wall_ms, dtype=torch.float64), mesh,
                                   op=dist.ReduceOp.MAX))

    return img, RenderStats(
        wall_ms=wall_ms,
        samples=n_pixels * spp,
        rays_traced=rays_total,
        batches=n_batches,
    )
