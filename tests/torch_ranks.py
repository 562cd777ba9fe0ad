"""Rank functions of the port's multi-device tests (tests/test_torch_sharding.py).

`parallel/launch.py:run_ranks` starts each rank as a fresh process that
unpickles its function by module and name; this module imports torch and
the port only, never jax, so that a rank does not import JAX.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch
import torch.distributed as dist

from raytracing_c_tpu_torch.models.serialization import load_scene_cache
from raytracing_c_tpu_torch.parallel.mesh import replicate_scene, shard_rays
from raytracing_c_tpu_torch.render.renderer import render, render_batch_sharded
from raytracing_c_tpu_torch.utils import rng
from raytracing_c_tpu_torch.utils.vec3 import Vec3


def scene_digest(obj) -> str:
    """sha256 over every tensor of a scene (dtype, shape and bytes, in field
    order) and its static fields."""
    h = hashlib.sha256()

    def walk(v):
        if isinstance(v, torch.Tensor):
            a = v.detach().cpu().contiguous()
            h.update(f"{a.dtype}{tuple(a.shape)}".encode())
            h.update(a.numpy().tobytes())
        elif isinstance(v, Vec3):
            for c in (v.x, v.y, v.z):
                walk(c)
        elif dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                walk(getattr(v, f.name))
        else:
            h.update(repr(v).encode())

    walk(obj)
    return hashlib.sha256(h.digest()).hexdigest()


def gather(mesh, obj) -> list:
    out = [None] * mesh.world_size
    dist.all_gather_object(out, obj)
    return out


def sharding_cases(mesh, scene_path: str, renders, batch: dict, rows: int):
    """Every case of the sharding tests in one start of the ranks: the
    scene's digest on each rank after replicate_scene; each rank's
    shard_rays blocks of arange(rows) and of a (2, rows) array along its
    last axis; each render of `renders` through the mesh (rank 0's image
    and ray count, every rank's image digest); and render_batch_sharded on
    `batch` (px, py, seed and keyword arguments) with each rank's rgb
    block and summed rays."""
    scene = load_scene_cache(scene_path, device="cpu") if mesh.rank == 0 else None
    scene = replicate_scene(scene, mesh)
    x = torch.arange(rows)
    out = {"digests": gather(mesh, scene_digest(scene)),
           "blocks": gather(mesh, (shard_rays(x, mesh).numpy(),
                                   shard_rays(torch.stack([x, -x]), mesh, axis=-1).numpy()))}
    out["renders"] = []
    for kw in renders:
        img, st = render(scene, mesh=mesh, **kw)
        digests = gather(mesh, hashlib.sha256(img.tobytes()).hexdigest())
        out["renders"].append((img, st.rays_traced, st.batches, digests))
    px = torch.from_numpy(np.asarray(batch["px"], np.int32))
    py = torch.from_numpy(np.asarray(batch["py"], np.int32))
    rgb, rays = render_batch_sharded(scene, px, py, rng.prng_key(batch["seed"]), mesh=mesh,
                                     **batch["kw"])
    out["batch"] = gather(mesh, (rgb.numpy(), int(rays)))
    return out


def raise_on_rank_1(mesh):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()
    return "rank 0 got past the barrier"
