"""The two CUDA kernels of the render path, their plain versions and wrappers.

Counterpart of `raytracing_c_tpu/ops/traverse_pallas.py`:

| kernel (csrc/traverse.cu) | wrapper        | replaces (Pallas)                                  |
|---------------------------|----------------|----------------------------------------------------|
| K1 `bvh_traverse_kernel`  | `bvh_traverse` | `intersect_bvh_pallas` -> `_traverse_kernel`       |
| K2 `fetch_attrs_kernel`   | `fetch_attrs`  | `fetch_attrs` -> `_attr_kernel`                    |

A wrapper given CPU tensors runs the kernel's plain PyTorch version in this
module; given CUDA tensors it launches the kernel or raises. There is no
fallback from a failed build or launch. Each wrapper counts its launches in
`<wrapper>.launches`.

The kernels read the scene's own row tables (`BVH.nodes`,
`Triangles.leaf_rows`, `Triangles.attr_rows`); the TPU package's compacted,
split and one-hot tables have no counterpart. The library builds with
every other kernel of the package at first use (`ops/cuda_build.py`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from raytracing_c_tpu_torch.ops import cuda_build
from raytracing_c_tpu_torch.utils.vec3 import Vec3

INF = float("inf")

#: deepest tree the kernel's stack sizes admit (7 * 16 + 1 = 113 entries)
MAX_DEPTH = 16

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("traverse")
    lib.rt_bvh_traverse.argtypes = [_P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P]
    lib.rt_bvh_traverse.restype = _I
    lib.rt_fetch_attrs.argtypes = [_P, _P, _P, _P, _P, _I, _P]
    lib.rt_fetch_attrs.restype = _I
    return lib


def _check_table(name: str, t: torch.Tensor, device) -> None:
    if t.device != device or t.dtype != torch.float32 or t.dim() != 2 \
            or t.shape[1] != 128 or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous float32 (n, 128) tensor on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


# ---------------------------------------------------------------------------
# K2: hit attributes
# ---------------------------------------------------------------------------


def fetch_attrs_plain(attr_rows: torch.Tensor, tri, u, v) -> torch.Tensor:
    """Plain version of K2 (integrator.py:94-118 of the JAX package): the
    winner's attribute row, interpolated. Returns (16, R) planes
    [normal3, ng3, tangent3, bitangent3, uv_u, uv_v, mat, 0]; misses
    (tri < 0) read triangle 0."""
    a = attr_rows[torch.clamp_min(tri, 0).long()].T  # (128, R)
    w = 1.0 - u - v
    normal = [a[c] * w + a[3 + c] * u + a[6 + c] * v for c in range(3)]
    uv_u = a[18] * w + a[20] * u + a[22] * v
    uv_v = a[19] * w + a[21] * u + a[23] * v
    return torch.stack([*normal, *a[9:18], uv_u, uv_v, a[24], torch.zeros_like(u)])


def fetch_attrs(attr_rows: torch.Tensor, tri, u, v) -> torch.Tensor:
    """K2 wrapper: (16, R) attribute planes for hits (tri, u, v)."""
    if tri.device.type == "cpu":
        return fetch_attrs_plain(attr_rows, tri, u, v)
    dev = tri.device
    if dev.type != "cuda":
        raise ValueError(f"fetch_attrs: unsupported device {dev}")
    _check_table("attr_rows", attr_rows, dev)
    r = tri.shape[0]
    tri = tri.to(torch.int32).contiguous()
    u = u.to(torch.float32).contiguous()
    v = v.to(torch.float32).contiguous()
    out = torch.empty((16, r), dtype=torch.float32, device=dev)
    if r == 0:
        return out
    err = _library().rt_fetch_attrs(
        tri.data_ptr(), u.data_ptr(), v.data_ptr(), attr_rows.data_ptr(),
        out.data_ptr(), r, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "fetch_attrs")
    fetch_attrs.launches += 1
    return out


fetch_attrs.launches = 0


def attrs_to_dict(o: torch.Tensor) -> dict:
    """(16, R) attribute planes -> the geometry dict the integrator reads."""
    return {
        "normal": Vec3(o[0], o[1], o[2]),
        "ng": Vec3(o[3], o[4], o[5]),
        "tangent": Vec3(o[6], o[7], o[8]),
        "bitangent": Vec3(o[9], o[10], o[11]),
        "uv_u": o[12],
        "uv_v": o[13],
        "mat_id": o[14].to(torch.int32),
    }


# ---------------------------------------------------------------------------
# K1: traversal
# ---------------------------------------------------------------------------


def bvh_traverse_plain(origin: Vec3, direction: Vec3, triangles, active=None,
                       t_max=None, fuse_attr: bool = False) -> dict:
    """Plain version of K1: the chunked brute-force oracle (nearest hit,
    ties to the lowest triangle id, only hits closer than t_max), an
    all-+inf dropped_min, and K2's plain version for the fused attrs."""
    from raytracing_c_tpu_torch.ops.traverse import intersect_bruteforce_chunked

    hit = intersect_bruteforce_chunked(origin, direction, triangles, active, t_max)
    hit["dropped_min"] = torch.full_like(hit["t"], INF)
    if fuse_attr:
        hit["attrs"] = fetch_attrs_plain(triangles.attr_rows, hit["tri"], hit["u"], hit["v"])
    return hit


def bvh_traverse(origin: Vec3, direction: Vec3, triangles, bvh, active=None,
                 t_max=None, fuse_attr: bool = False) -> dict:
    """K1 wrapper: nearest triangle hit per ray over the implicit BVH.

    origin/direction: Vec3 of (R,); active: (R,) bool or None; t_max: (R,)
    or None (only hits strictly closer count). Returns dict(t, u, v, tri,
    dropped_min) with t = +inf, tri = -1, u = v = 0 on a miss, and with
    fuse_attr the (16, R) "attrs" planes of K2 for the winner.
    """
    dev = origin.x.device
    if dev.type == "cpu":
        return bvh_traverse_plain(origin, direction, triangles, active, t_max, fuse_attr)
    if dev.type != "cuda":
        raise ValueError(f"bvh_traverse: unsupported device {dev}")
    if not 1 <= bvh.depth <= MAX_DEPTH:
        raise ValueError(f"bvh_traverse: depth {bvh.depth} outside [1, {MAX_DEPTH}]")
    _check_table("bvh.nodes", bvh.nodes, dev)
    _check_table("leaf_rows", triangles.leaf_rows, dev)
    _check_table("attr_rows", triangles.attr_rows, dev)
    if bvh.n_internal != bvh.last_row_offset or \
            triangles.leaf_rows.shape[0] != 8 ** bvh.depth:
        raise ValueError("bvh_traverse: tables do not describe a complete 8-ary tree")

    r = origin.shape[0]
    one = torch.ones((r,), dtype=torch.float32, device=dev)
    act = one if active is None else active.to(torch.float32)
    tm = one * INF if t_max is None else t_max.to(torch.float32)
    rays = torch.stack([origin.x, origin.y, origin.z, direction.x, direction.y,
                        direction.z, act, tm]).to(torch.float32).contiguous()
    out = torch.empty((4, r), dtype=torch.float32, device=dev)
    tri = torch.empty((r,), dtype=torch.int32, device=dev)
    attrs = torch.empty((16, r), dtype=torch.float32, device=dev) if fuse_attr else None
    res = {"t": out[0], "u": out[1], "v": out[2], "tri": tri, "dropped_min": out[3]}
    if fuse_attr:
        res["attrs"] = attrs
    if r == 0:
        return res
    err = _library().rt_bvh_traverse(
        rays.data_ptr(), r, bvh.nodes.data_ptr(), bvh.n_internal, bvh.depth,
        triangles.leaf_rows.data_ptr(), triangles.attr_rows.data_ptr(),
        out.data_ptr(), tri.data_ptr(),
        attrs.data_ptr() if fuse_attr else None,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "bvh_traverse")
    bvh_traverse.launches += 1
    return res


bvh_traverse.launches = 0


def reset_launch_counts() -> None:
    bvh_traverse.launches = 0
    fetch_attrs.launches = 0


def launch_counts() -> dict:
    return {"bvh_traverse": bvh_traverse.launches, "fetch_attrs": fetch_attrs.launches}
