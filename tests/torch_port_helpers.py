"""Helpers for the port's tests (tests/test_torch_*.py): carry a JAX scene
and JAX inputs across to raytracing_c_tpu_torch through numpy."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from raytracing_c_tpu.models.scene import Spheres
from raytracing_c_tpu_torch.models import scene as ps
from raytracing_c_tpu_torch.utils.vec3 import Vec3

from helpers import quad_mesh, simple_scene


def jax_scene_arrays(obj, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten a JAX Scene pytree to {dotted field path: numpy array}."""
    out = {}
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(jax_scene_arrays(getattr(obj, f.name), f"{prefix}{f.name}."))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            out.update(jax_scene_arrays(v, f"{prefix}{i}."))
    elif obj is not None:
        out[prefix[:-1]] = np.asarray(obj)
    return out


def port_scene(jax_scene) -> ps.Scene:
    return ps.scene_from_numpy(jax_scene_arrays(jax_scene))


def port_mesh(mesh) -> ps.HostMesh:
    return ps.HostMesh(mesh.positions, mesh.normals, mesh.uvs, mesh.mat_id)


def tvec(a) -> Vec3:
    """(R, 3) numpy -> port Vec3 of (R,) float32 planes."""
    a = torch.as_tensor(np.asarray(a, np.float32).reshape(-1, 3))
    return Vec3(a[:, 0].contiguous(), a[:, 1].contiguous(), a[:, 2].contiguous())


def jvec(a):
    """(R, 3) numpy -> JAX Vec3 of (R,) planes."""
    from raytracing_c_tpu.utils.vec3 import Vec3 as JVec3

    a = np.asarray(a, np.float32).reshape(-1, 3)
    return JVec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))


def np3(v) -> np.ndarray:
    """Vec3 of either package -> (R, 3) numpy."""
    return np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)], axis=-1)


def aimed_rays(r: int, rng: np.random.Generator):
    """Rays from outside the unit soup aimed at random points inside it, so
    most of them hit something."""
    o = rng.uniform(-2.5, 2.5, (r, 3)).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (r, 3)).astype(np.float32) - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def quad_sphere_scene():
    """The quad + sphere tiny scene (__graft_entry__._tiny_scene's)."""
    return simple_scene(
        quad_mesh(), bg=(0.5, 0.6, 0.7), spheres=Spheres.make([[0.4, 0.0, 0.6]], [0.35], [0])
    )


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10.0 * np.log10(255.0**2 / mse)
