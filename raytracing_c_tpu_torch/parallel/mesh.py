"""The device mesh: one process per device over torch.distributed.

Counterpart of `raytracing_c_tpu/parallel/mesh.py`. The JAX package keeps
one controller and shards arrays over a 1-D `jax.sharding.Mesh`; eager
PyTorch runs one process per device (a rank) instead, the way DDP does,
so that the host work of each device's share runs in a process of its
own. The semantics are the JAX package's: rays are sharded (rank k holds
the k-th contiguous block, as `P(axis)` gives shard k), the scene is
replicated, and tracing needs no collective. A render reduces its ray
counter and gathers its frame once (`render/renderer.py`).

`make_mesh` joins the default process group, initialising it from the
torchrun variables (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) if need be. The backend is the caller's choice, "nccl" on
CUDA devices or "gloo", and is never switched: NCCL runs its collectives
on the device, gloo on host copies of the tensors (it gathers no CUDA
tensor), which a frame read back to the host needs anyway.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from raytracing_c_tpu_torch.models.scene import Scene, _with_k1_tables, resolve_device

#: how long a collective may wait for the other ranks before it raises
TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class Mesh:
    """This process's place in the default process group."""

    rank: int
    world_size: int
    device: torch.device
    backend: str

    @property
    def collective_device(self) -> torch.device:
        """Where this backend's collectives take their tensors: the device
        for NCCL, the host for gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def make_mesh(backend: str | None = None, device=None) -> Mesh:
    """The mesh of the default process group, initialised from the torchrun
    variables if it is not yet.

    device: this rank's device, by default cuda:LOCAL_RANK (raising
    without CUDA); pass "cpu" for CPU ranks, or the same card for several
    ranks (gloo only: NCCL takes one rank per card). A CUDA device becomes
    the current device before any CUDA work. backend: "nccl" for a CUDA
    device and "gloo" for the CPU by default."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"make_mesh: backend {backend!r} is neither 'nccl' nor 'gloo'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"make_mesh: NCCL needs a CUDA device, got {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]), timeout=TIMEOUT,
                                **kw)
    elif dist.get_backend() != backend:
        raise ValueError(f"make_mesh: the process group runs {dist.get_backend()!r}, "
                         f"not {backend!r}")
    return Mesh(dist.get_rank(), dist.get_world_size(), dev, backend)


def replicate_scene(scene: Scene | None, mesh: Mesh) -> Scene:
    """Every rank's copy of rank 0's scene, bit for bit, on its own device,
    with K1's tables built there (counterpart of `shard_scene`). Rank 0
    passes the scene, on any device; the other ranks may pass None."""
    box = [scene.to("cpu") if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0, device=mesh.collective_device)
    return _with_k1_tables(box[0].to(mesh.device))


def shard_rays(x: torch.Tensor, mesh: Mesh, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous block of `axis` (counterpart of `shard_rays`:
    `P(axis)` gives shard k the k-th block, `P(None, axis)` the same along
    the second axis). The axis must split evenly."""
    n = x.shape[axis]
    if n % mesh.world_size:
        raise ValueError(f"shard_rays: {n} rows do not split over {mesh.world_size} ranks")
    per = n // mesh.world_size
    return x.narrow(axis, mesh.rank * per, per)


def all_reduce(x: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`x` reduced over the ranks (a sum by default), on the backend's
    collective device."""
    x = x.to(mesh.collective_device, copy=True)
    dist.all_reduce(x, op=op)
    return x


def all_gather(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Every rank's `x` (all of one shape and dtype), in rank order, on the
    backend's collective device."""
    x = x.to(mesh.collective_device).contiguous()
    out = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(out, x)
    return out
