"""Batched tile renderer.

Counterpart of `raytracing_c_tpu/render/renderer.py`: the image is cut
into flat pixel batches in 32x32 tile order (the reference's chunks,
raytracer.c:596-720); each batch renders as one ray arena of
(pixels x spp) rays on the scene's device, and its u8 pixels land in a
device-resident frame buffer that is read back once at the end.

The batch loop is the JAX package's: render() walks the batches in
groups of k_group (`render_batches_grouped`, a loop over
`render_batch_indexed`, which slices batch b from the device-resident
pixel tables and folds b into the key). With accumulate (the default
without a mesh or a progress callback) each group's pixels and ray
counts land in place in a device accumulator sized for the whole frame
(`render_batches_grouped_acc`), so under limit_batches the whole last
group reaches the image, as in the JAX package; without it, each batch
of a group is scattered into the frame as it comes, and batches at or
past limit_batches are not rendered. Every batch renders through
`render_batch`, one batch at a time. The JAX package's drain thread pool
has no counterpart: the frame never leaves the device before the end.

With a mesh (`parallel/mesh.py`, one process per device), every rank runs
the same batch loop and renders its contiguous block of each batch
(`render_batch_sharded`, the JAX package's shard_map): the random draws of
a batch are global and each rank keeps its slice, so the dense tracer
gives the single-process image bit for bit; the compacted tracer keys its
draws by local slot under fold_in(fold_in(key, 1), rank), as each JAX
shard does. Each rank keeps its blocks in a frame shard on its device;
the frame is gathered once, in rank order, at the end of the render, and
the ray counter is reduced once.

Spans (`utils/spans.py`, off by default): `render` over the interval of
RenderStats.wall_ms; `group` per render_batches_grouped(_acc) call;
`batch` per render_batch, over `rng` (threefry draws), `raygen`, the
integrator's bounces and `encode` (spp mean, tonemap, u8); `accumulate` and
`scatter` for the frame writes; `readback` for the image and the ray count
(its `sync`) reaching the host.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from raytracing_c_tpu_torch.ops import env_light, traverse
from raytracing_c_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce, shard_rays
from raytracing_c_tpu_torch.render import camera as camera_mod
from raytracing_c_tpu_torch.render import integrator
from raytracing_c_tpu_torch.utils import color, rng, spans


@dataclass
class RenderStats:
    """Render timers and throughput (the reference's -V metrics,
    driver.c:776-836), with rays = every scene intersection executed.
    compile_ms and extra are the JAX package's fields: the port has no
    compile step inside a render (its kernels build once per process, at
    first use), so compile_ms stays 0.0."""

    wall_ms: float = 0.0
    samples: int = 0
    rays_traced: int = 0
    batches: int = 0
    compile_ms: float = 0.0
    extra: dict = field(default_factory=dict)

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
    with spans.span("rng"):
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
    with spans.span("raygen"):
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
    with spans.span("encode"):
        rgb = torch.stack([c.reshape(p, spp).mean(dim=1)
                           for c in (radiance.x, radiance.y, radiance.z)], dim=-1)
        if tonemap == "aces":
            rgb = color.aces(rgb)
        elif tonemap == "reinhard":
            rgb = color.reinhard(rgb)
        return color.encode_u8(rgb), rays


def render_batch(scene, px, py, key, *, width: int, height: int, spp: int,
                 max_bounces: int, method: str = "auto", texture_mode: str = "bilinear",
                 compact: bool = False, rr: bool = False, nee: bool = False,
                 tonemap: str | None = None):
    """Render one flat batch of pixels px, py ((P,) int32) with `key`:
    the batch's draws from key, the tracer's from fold_in(key, 1).
    method: "auto", "bvh", "brute" or a JAX package name
    (`traverse.port_method`). Returns (rgb u8 (P, 3), rays traced (int64
    scalar tensor))."""
    if nee:
        env_light.scene_env_light(scene)
    with spans.span("batch"):
        jitter, uniforms, nee_uniforms = _draw_uniforms(key, px.shape[0] * spp, max_bounces,
                                                        nee, skip_mat=compact)
        with spans.span("rng"):
            key = rng.fold_in(key, 1)
        return _batch_core(
            scene, px, py, jitter, uniforms, nee_uniforms, key, width=width,
            height=height, spp=spp, max_bounces=max_bounces,
            method=traverse.port_method(method, scene), texture_mode=texture_mode,
            compact=compact, rr=rr, nee=nee, tonemap=tonemap,
        )


def _render_shard(scene, px, py, key, mesh: Mesh, **kw):
    """This rank's block of the batch px, py (the whole batch's pixels):
    the batch's global draws from key, sliced along the ray axis, and the
    tracer's key fold_in(fold_in(key, 1), rank). No collective."""
    with spans.span("batch"):
        jitter, uniforms, nee_uniforms = _draw_uniforms(
            key, px.shape[0] * kw["spp"], kw["max_bounces"], kw["nee"], skip_mat=kw["compact"])
        block = lambda a: None if a is None else shard_rays(a, mesh, axis=-1)  # noqa: E731
        with spans.span("rng"):
            key = rng.fold_in(rng.fold_in(key, 1), mesh.rank)
        return _batch_core(scene, shard_rays(px, mesh), shard_rays(py, mesh), block(jitter),
                           block(uniforms), block(nee_uniforms), key, **kw)


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
        max_bounces=max_bounces, method=traverse.port_method(method, scene),
        texture_mode=texture_mode, compact=compact, rr=rr, nee=nee, tonemap=tonemap)
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


@functools.lru_cache(maxsize=8)
def _pixel_tables_device(width: int, height: int, pad: int, device: torch.device):
    """_pixel_tables' (xs, ys, perm) as tensors on `device`, cached per
    (width, height, pad, device), so that a second render of the same shape
    uploads nothing. Callers must not write to them."""
    return tuple(torch.from_numpy(a).to(device) for a in _pixel_tables(width, height, pad))


def render_batch_indexed(scene, xs_all, ys_all, key, b, *, width: int, height: int,
                         spp: int, max_bounces: int, batch_px: int, method: str = "topk",
                         texture_mode: str = "bilinear", compact: bool = False,
                         rr: bool = False, nee: bool = False, tonemap: str | None = None):
    """Batch b of the pixel tables xs_all, ys_all (`_pixel_tables_device`'s):
    the pixels [b * batch_px, (b + 1) * batch_px) rendered by render_batch
    with fold_in(key, b). b is a python int or a 0-d integer tensor on the
    tables' device, which slices there with no read-back. Returns what
    render_batch returns for that slice."""
    if isinstance(b, torch.Tensor):
        idx = b.to(torch.int64) * batch_px + torch.arange(batch_px, device=xs_all.device)
        px, py = xs_all[idx], ys_all[idx]
    else:
        px, py = xs_all[b * batch_px:(b + 1) * batch_px], ys_all[b * batch_px:(b + 1) * batch_px]
    with spans.span("rng"):
        key = rng.fold_in(key, b)
    return render_batch(scene, px, py, key, width=width, height=height, spp=spp,
                        max_bounces=max_bounces, method=method, texture_mode=texture_mode,
                        compact=compact, rr=rr, nee=nee, tonemap=tonemap)


def render_batches_grouped(scene, xs_all, ys_all, key, b0, *, width: int, height: int,
                           spp: int, max_bounces: int, batch_px: int, k_group: int,
                           method: str = "topk", texture_mode: str = "bilinear",
                           compact: bool = False, rr: bool = False, nee: bool = False,
                           tonemap: str | None = None):
    """Batches b0 .. b0 + k_group - 1 through render_batch_indexed, each
    index clamped to the last batch (n_batches - 1, n_batches =
    len(xs_all) // batch_px), so that a tail group holds the last batch
    again. A batch renders once: its copies are the same pixels and rays,
    since its key and pixels are the same. b0: a python int or a 0-d
    integer tensor (read once). Returns (rgb u8 (k_group, batch_px, 3),
    rays float32 (k_group,)), the JAX package's shapes and types: a batch's
    count is exact below 2**24 rays (262,144 rays x 8 bounces is 2**21)."""
    with spans.span("group"):
        n_batches = xs_all.shape[0] // batch_px
        order = [min(int(b0) + j, n_batches - 1) for j in range(k_group)]
        done = {b: render_batch_indexed(
            scene, xs_all, ys_all, key, b, width=width, height=height, spp=spp,
            max_bounces=max_bounces, batch_px=batch_px, method=method, texture_mode=texture_mode,
            compact=compact, rr=rr, nee=nee, tonemap=tonemap) for b in dict.fromkeys(order)}
        return (torch.stack([done[b][0] for b in order]),
                torch.stack([done[b][1] for b in order]).to(torch.float32))


def render_batches_grouped_acc(scene, xs_all, ys_all, key, b0, acc, rays_acc, *, width: int,
                               height: int, spp: int, max_bounces: int, batch_px: int,
                               k_group: int, method: str = "topk",
                               texture_mode: str = "bilinear", compact: bool = False,
                               rr: bool = False, nee: bool = False,
                               tonemap: str | None = None):
    """render_batches_grouped, its pixels written in place into the device
    accumulator acc (u8 (N, 3)) at rows [b0 * batch_px, (b0 + k_group) *
    batch_px) and its ray counts into rays_acc (float32, one per batch) at
    [b0, b0 + k_group): the port's counterpart of the JAX package's donated
    buffers. Returns (acc, rays_acc), the tensors given."""
    rgb, rays = render_batches_grouped(
        scene, xs_all, ys_all, key, b0, width=width, height=height, spp=spp,
        max_bounces=max_bounces, batch_px=batch_px, k_group=k_group, method=method,
        texture_mode=texture_mode, compact=compact, rr=rr, nee=nee, tonemap=tonemap)
    with spans.span("accumulate"):
        b0 = int(b0)
        acc[b0 * batch_px:(b0 + k_group) * batch_px].copy_(rgb.reshape(-1, 3))
        rays_acc[b0:b0 + k_group].copy_(rays)
    return acc, rays_acc


def render(scene, width: int, height: int, spp: int = 16, max_bounces: int = 8,
           seed: int = 0, batch_pixels: int | None = None, method: str = "auto",
           mesh: Mesh | None = None, progress=None, texture_mode: str = "bilinear",
           limit_batches: int | None = None, compact: bool | None = None, rr: bool = False,
           nee: bool = False, k_group: int | None = None, tonemap: str | None = None,
           accumulate: bool | None = None, to_host: bool = True):
    """Render a full image on the scene's device.

    Returns (image u8 (H, W, 3) numpy, RenderStats); with to_host=False the
    image is the frame buffer itself, a tensor on the scene's device, and
    the wall time ends when the frame is complete. method="auto" picks the
    brute-force oracle for scenes of <= 64 triangle slots (the reference's
    own `#if 0` path) and the "bvh" traversal kernel otherwise; the JAX
    package's names map as `traverse.port_method` says. compact
    (default on) selects the live-lane compacted tracer. limit_batches
    renders only the first batches (the rest of the frame stays black,
    but see accumulate). nee (environment next-event estimation with MIS,
    default off) builds the scene's env-light table first if the scene
    has none yet (`env_light.scene_env_light`), outside the timed loop.

    The JAX package's batch loop: the batches go in groups of k_group
    (default min(4, batches to render), clamped to [1, batches]; 1 on a
    mesh). accumulate (default: no mesh and no progress) writes each
    group into a device accumulator (`render_batches_grouped_acc`) and
    calls progress(min(b + k_group, n), n) per group; the image is the
    whole accumulator, so under limit_batches the rest of the last group
    is in it too, while rays_traced and batches count the first n only.
    Without it, each batch of a group (`render_batches_grouped`) lands in
    the frame and progress(done, total) is called after each batch is
    enqueued.

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
    method = traverse.port_method(method, scene)

    n_pixels = width * height
    if batch_pixels is None:
        batch_pixels = max(1, min(n_pixels, 262_144 // max(spp, 1)))
    if mesh is not None:
        n = mesh.world_size
        batch_pixels = max(n, (batch_pixels // n) * n)
    n_batches_full = (n_pixels + batch_pixels - 1) // batch_pixels
    pad = n_batches_full * batch_pixels - n_pixels
    n_batches = n_batches_full if limit_batches is None else min(n_batches_full, limit_batches)
    # the JAX package's defaults (renderer.py:545-549)
    if mesh is not None:
        k_group = 1
    else:
        k_group = max(1, min(min(4, n_batches) if k_group is None else k_group, n_batches))
    if accumulate is None:
        accumulate = mesh is None and progress is None

    dev = scene.device
    xs_d, ys_d, perm_d = _pixel_tables_device(width, height, pad, dev)
    key = rng.prng_key(seed, dev)
    kw = dict(width=width, height=height, spp=spp, max_bounces=max_bounces, method=method,
              texture_mode=texture_mode, compact=compact, rr=rr, nee=nee, tonemap=tonemap)

    if mesh is None:
        frame = torch.zeros((n_pixels, 3), dtype=torch.uint8, device=dev)
        with spans.span("render"):
            t0 = time.perf_counter()
            if accumulate:
                # sized from the whole frame's batches, as the JAX package's
                n_slots = -(-n_batches_full // k_group) * k_group
                acc = torch.zeros((n_slots * batch_pixels, 3), dtype=torch.uint8, device=dev)
                rays_per_batch = torch.zeros((n_slots,), dtype=torch.float32, device=dev)
                for b in range(0, n_batches, k_group):
                    render_batches_grouped_acc(scene, xs_d, ys_d, key, b, acc, rays_per_batch,
                                               batch_px=batch_pixels, k_group=k_group, **kw)
                    if progress is not None:
                        progress(min(b + k_group, n_batches), n_batches)
                with spans.span("scatter"):
                    frame[perm_d] = acc[:n_pixels]
            else:
                rays_per_batch = torch.zeros((max(n_batches, 1),), dtype=torch.float32,
                                             device=dev)
                for b in range(0, n_batches, k_group):
                    k = min(k_group, n_batches - b)  # batches past n_batches would be dropped
                    rgb, rays = render_batches_grouped(scene, xs_d, ys_d, key, b,
                                                       batch_px=batch_pixels, k_group=k, **kw)
                    with spans.span("scatter"):
                        for j in range(k):
                            lo = (b + j) * batch_pixels
                            hi = min(lo + batch_pixels, n_pixels)
                            frame[perm_d[lo:hi]] = rgb[j, : hi - lo]
                            if progress is not None:
                                progress(b + j + 1, n_batches)
                        rays_per_batch[b:b + k] = rays
            with spans.span("readback"):
                img = frame.reshape(height, width, 3)
                if to_host:
                    img = img.cpu().numpy()
                # the counters follow the last batch on the stream: reading them
                # waits for the whole frame
                with spans.span("sync", what="rays"):
                    rays_total = int(rays_per_batch[:n_batches].sum(dtype=torch.float64))
            wall_ms = (time.perf_counter() - t0) * 1e3
    else:
        rays_per_batch = torch.zeros((max(n_batches, 1),), dtype=torch.int64, device=dev)
        shard = torch.zeros((n_batches, batch_pixels // mesh.world_size, 3),
                            dtype=torch.uint8, device=dev)
        with spans.span("render"):
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
            with spans.span("scatter"):
                frame = torch.zeros((n_pixels, 3), dtype=torch.uint8, device=flat.device)
                frame[perm_d[:done].to(flat.device)] = flat[:done]
            with spans.span("readback"):
                img = frame.reshape(height, width, 3)
                img = img.cpu().numpy() if to_host else img.to(dev)
                with spans.span("sync", what="rays"):
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
