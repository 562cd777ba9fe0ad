"""Start the ranks of a mesh from one process.

`run_ranks(fn, world_size, backend, devices, *args)` runs
`fn(mesh, *args)` in `world_size` processes started with
`torch.multiprocessing.spawn`, joined in a process group on a free
loopback port, and returns rank 0's return value. `fn` must be a
module-level function of a module that the spawned processes can import
(they unpickle it by its module and name), and its result must pickle:
keep it on the host. A rank that raises, or dies, fails the whole call
(the others are stopped) and no result is returned.

Under torchrun, each process calls `mesh.make_mesh()` itself instead.
`render_scene_cache` is a rank function for either: it renders a scene
cache on the mesh.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from raytracing_c_tpu_torch.models.serialization import load_scene_cache
from raytracing_c_tpu_torch.ops import cuda_build
from raytracing_c_tpu_torch.parallel.mesh import make_mesh, replicate_scene
from raytracing_c_tpu_torch.render.renderer import render


def _free_port() -> int:
    """A TCP port on the loopback interface that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(fn, world_size: int, backend: str, devices, *args):
    """Run fn(mesh, *args) on `world_size` ranks, rank k on devices[k]
    ("cpu", "cuda:k", or one card for several gloo ranks), over `backend`.
    Each rank gets cpu_count // world_size intra-op threads. Returns rank
    0's return value; raises if any rank fails."""
    devices = [str(d) for d in devices]
    if len(devices) != world_size:
        raise ValueError(f"run_ranks: {len(devices)} devices for {world_size} ranks")
    with tempfile.TemporaryDirectory(prefix="run_ranks_") as tmp:
        out = os.path.join(tmp, "rank0.pickle")
        mp.spawn(_rank_main, args=(fn, world_size, backend, devices, _free_port(), out, args),
                 nprocs=world_size, join=True)
        with open(out, "rb") as f:
            return pickle.load(f)


def _rank_main(rank, fn, world_size, backend, devices, port, out, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    mesh = make_mesh(backend, devices[rank])
    result = fn(mesh, *args)
    # every rank is done with its collectives before the group goes away
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(out + ".tmp", out)


def render_scene_cache(mesh, path: str, renders):
    """A rank function: rank 0 reads the scene cache at `path`
    (`models/serialization.py`), `replicate_scene` hands every rank its
    copy, and each dict of `renders` is one `render(scene, mesh=mesh,
    **kw)` (width and height among its keys). Returns, on every rank, one
    (image, RenderStats, launches) per render; launches lists each rank's
    launch counts of every kernel in that render
    (`ops/cuda_build.launch_counts`; denoise_u8 is 0, render() does not
    denoise), in rank order."""
    scene = load_scene_cache(path, device="cpu") if mesh.rank == 0 else None
    scene = replicate_scene(scene, mesh)
    results = []
    for kw in renders:
        cuda_build.reset_launch_counts()
        img, stats = render(scene, mesh=mesh, **kw)
        launches = [None] * mesh.world_size
        dist.all_gather_object(launches, cuda_build.launch_counts())
        results.append((img, stats, launches))
    return results
