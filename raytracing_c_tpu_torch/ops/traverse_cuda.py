"""The two CUDA kernels of the render path, their plain versions and wrappers.

Counterpart of `raytracing_c_tpu/ops/traverse_pallas.py`:

| kernel (csrc/traverse.cu) | wrapper        | replaces (Pallas)                                  |
|---------------------------|----------------|----------------------------------------------------|
| K1 `bvh_traverse_kernel`  | `bvh_traverse` | `intersect_bvh_pallas` -> `_traverse_kernel`       |
| K2 `fetch_attrs_kernel`   | `fetch_attrs`  | `fetch_attrs` -> `_attr_kernel`                    |

A wrapper given CPU tensors runs the kernel's plain PyTorch version in this
module (K1's walks the tree with `ops/traverse.py:intersect_bvh_culled`);
given CUDA tensors it launches the kernel or raises. There is no
fallback from a failed build or launch. Each wrapper launches on its
tensors' device, whichever device is current, and counts its launches in
`<wrapper>.launches`.

K2 and K1's epilogue read the scene's `Triangles.attr_rows`. K1 walks a
node table and a triangle table laid out for the card (`K1Tables`), built
once per scene from `BVH.nodes` and `Triangles.leaf_rows` by
`build_k1_tables` and cached on the BVH by `k1_tables`; the source tables
stay as they are. K1 is two kernels: one thread per ray for a launch of
WIDE_BELOW rays or more, eight lanes per ray below (csrc/traverse.cu says
why); `launch_counts` counts them apart. The TPU package's compacted, split and one-hot tables
have no counterpart. The library builds with every other kernel of the
package at first use (`ops/cuda_build.py`).
"""

from __future__ import annotations

import ctypes
import functools
import time
from dataclasses import dataclass

import torch

from raytracing_c_tpu_torch import BVH_WIDTH
from raytracing_c_tpu_torch.ops import cuda_build
from raytracing_c_tpu_torch.utils.vec3 import Vec3

INF = float("inf")

#: deepest tree K1 admits: a child reference holds node << 8 | mask in 31
#: bits (n_internal < 2^23) and a leaf's first triangle in 27, and the
#: eight-lane kernel keeps one stack entry per internal level in a lane
MAX_DEPTH = 8
W = BVH_WIDTH
#: a child reference with this bit set is a leaf block's triangle range
LEAF_BIT = 1 << 31
#: K1 launches of fewer rays than this run eight lanes per ray
#: (bvh_traverse_wide_kernel), the others one thread per ray
WIDE_BELOW = 131072

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("traverse")
    lib.rt_bvh_traverse.argtypes = [_P, _I, _P, ctypes.c_uint, _P, _P, _P, _P, _P, _I, _P]
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
    with torch.cuda.device(dev):  # the launch goes to the current device
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
# K1: the node and triangle tables
# ---------------------------------------------------------------------------


@dataclass
class K1Tables:
    """K1's tables (csrc/traverse.cu), float32 with integer fields as bits.

    nodes: (n_internal * 16, 4); node e's record is rows 16e..16e+15, two
      per child, occupied children first in their original order:
      [center.xyz, half.x], [half.yz, ref, 0], the child box as its center
      and half-extent, rounded outward so that [center - half, center +
      half] holds the box of `BVH.nodes`. ref is an int32:
      an internal child c as c << 8 | its occupancy mask, a leaf block as
      LEAF_BIT | first << 4 | count, its triangles being tris records
      first..first+count-1. Empty slots are zero: the one-thread kernel
      loads them with the rest and drops their results.
    tris: (n_occupied * 3, 4); one record per occupied triangle slot, in
      slot order: [v0.xyz, slot], [e1.xyz, 0], [e2.xyz, 0].
    root: the root's stack entry, 0 << 8 | its occupancy mask (0: no
      triangle at all).
    seconds: wall seconds the build took (device work included).
    """

    nodes: torch.Tensor
    tris: torch.Tensor
    root: int
    seconds: float


def _int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _leaf_slots(leaf_rows: torch.Tensor) -> torch.Tensor:
    """(n_blocks, 8, 9): each slot's [v0.xyz, e1.xyz, e2.xyz]."""
    return leaf_rows[:, :9 * W].reshape(leaf_rows.shape[0], 9, W).transpose(1, 2)


def occupancy(leaf_rows: torch.Tensor, n_internal: int, depth: int):
    """Which triangle slots and children hold something a ray can hit.

    A slot is occupied unless its v0, e1 and e2 are all zero (the padding,
    which no ray hits: its determinant is 0); a child is occupied if its
    subtree holds an occupied slot. Returns (slot_occ (n_blocks, 8) bool,
    child_occ (n_internal, 8) bool)."""
    slot_occ = (_leaf_slots(leaf_rows) != 0).any(-1)
    block_occ = slot_occ.any(1)
    dev = leaf_rows.device
    child = W * torch.arange(n_internal, device=dev)[:, None] + 1 + torch.arange(W, device=dev)
    occ = torch.zeros((n_internal, W), dtype=torch.bool, device=dev)
    for level in reversed(range(depth)):  # bottom-up, one level at a time
        lo, n = (W**level - 1) // (W - 1), W**level
        c = child[lo:lo + n]
        occ[lo:lo + n] = block_occ[c - n_internal] if level == depth - 1 else occ[c].any(2)
    return slot_occ, occ


def build_k1_tables(nodes: torch.Tensor, leaf_rows: torch.Tensor, n_internal: int,
                    depth: int) -> K1Tables:
    """K1's tables from the scene's `BVH.nodes` (n_internal, 128) and
    `Triangles.leaf_rows` (8**depth, 128), on their device. Only occupied
    children and slots (`occupancy`) go into them, so skipping the rest
    loses no hit."""
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"K1 tables: depth {depth} outside [1, {MAX_DEPTH}]")
    t0 = time.perf_counter()
    dev = nodes.device
    nb = leaf_rows.shape[0]
    slot_occ, occ = occupancy(leaf_rows, n_internal, depth)
    count = slot_occ.sum(1)
    start = torch.cumsum(count, 0) - count
    ids = torch.nonzero(slot_occ.reshape(-1)).squeeze(1)
    comp = _leaf_slots(leaf_rows).reshape(-1, 9)[ids].contiguous().view(torch.int32)
    tris = torch.zeros((ids.numel(), 12), dtype=torch.int32, device=dev)
    tris[:, 0:3], tris[:, 3] = comp[:, 0:3], ids.to(torch.int32)
    tris[:, 4:7], tris[:, 8:11] = comp[:, 3:6], comp[:, 6:9]

    lane = torch.arange(W, device=dev)
    child = W * torch.arange(n_internal, device=dev)[:, None] + 1 + lane  # (n, 8)
    cnt = occ.sum(1)
    is_leaf = child >= n_internal
    blk = (child - n_internal).clamp(0, nb - 1)
    ref = torch.where(is_leaf, LEAF_BIT | (start[blk] << 4) | count[blk],
                      (child << 8) | (2 ** cnt[child.clamp(max=n_internal - 1)] - 1))
    rec = torch.zeros((n_internal, W, 8), dtype=torch.int32, device=dev)
    box = nodes[:, :6 * W].reshape(n_internal, 6, W).transpose(1, 2).double()
    center = ((box[..., :3] + box[..., 3:]) * 0.5).float()
    c64 = center.double()
    half64 = torch.maximum(box[..., 3:] - c64, c64 - box[..., :3])  # exact in float64
    half = half64.float()
    half = torch.where(half.double() < half64, torch.nextafter(half, torch.full_like(half, INF)),
                       half)
    rec[:, :, 0:6] = torch.cat([center, half], -1).view(torch.int32)
    rec[:, :, 6] = _int32_bits(ref)
    order = torch.argsort((~occ).to(torch.int32), dim=1, stable=True)
    rec = torch.gather(rec, 1, order[:, :, None].expand(-1, -1, 8))
    rec[lane[None, :] >= cnt[:, None]] = 0
    root = int(2 ** int(cnt[0]) - 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return K1Tables(nodes=rec.reshape(-1, 4).view(torch.float32),
                    tris=tris.reshape(-1, 4).view(torch.float32), root=root,
                    seconds=time.perf_counter() - t0)


def k1_tables(bvh, triangles) -> K1Tables:
    """K1's tables for this BVH, built at the first call and cached on it;
    rebuilt when `bvh.nodes` or `triangles.leaf_rows` is replaced or
    changed in place."""
    nodes, leaf_rows = bvh.nodes, triangles.leaf_rows
    c = getattr(bvh, "_k1_tables", None)
    if c is not None and c[0] is nodes and c[1] == nodes._version \
            and c[2] is leaf_rows and c[3] == leaf_rows._version:
        return c[4]
    tables = build_k1_tables(nodes, leaf_rows, bvh.n_internal, bvh.depth)
    bvh._k1_tables = (nodes, nodes._version, leaf_rows, leaf_rows._version, tables)
    return tables


# ---------------------------------------------------------------------------
# K1: traversal
# ---------------------------------------------------------------------------


def bvh_traverse_plain(origin: Vec3, direction: Vec3, triangles, active=None,
                       t_max=None, fuse_attr: bool = False, bvh=None) -> dict:
    """Plain version of K1: the nearest hit, ties to the lowest triangle
    id, only hits closer than t_max, an all-+inf dropped_min, and K2's
    plain version for the fused attrs. Without `bvh` the hits come from the
    chunked brute-force oracle; with it from `intersect_bvh_culled`, the
    same tests over only the leaves whose boxes each ray enters (what the
    wrapper runs on the CPU: the oracle tests every triangle)."""
    from raytracing_c_tpu_torch.ops import traverse

    if bvh is None:
        hit = traverse.intersect_bruteforce_chunked(origin, direction, triangles, active, t_max)
    else:
        hit = traverse.intersect_bvh_culled(origin, direction, triangles, bvh, active, t_max)
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
    fuse_attr the (16, R) "attrs" planes of K2 for the winner. Raises for a
    tree deeper than MAX_DEPTH. The kernel walks `k1_tables(bvh, triangles)`
    with one thread per ray, or with eight lanes per ray for fewer than
    WIDE_BELOW rays.
    """
    dev = origin.x.device
    if dev.type == "cpu":
        return bvh_traverse_plain(origin, direction, triangles, active, t_max, fuse_attr, bvh)
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

    tables = k1_tables(bvh, triangles)

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
    wide = r < WIDE_BELOW
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = _library().rt_bvh_traverse(
            rays.data_ptr(), r, tables.nodes.data_ptr(), tables.root,
            tables.tris.data_ptr(), triangles.attr_rows.data_ptr(),
            out.data_ptr(), tri.data_ptr(),
            attrs.data_ptr() if fuse_attr else None, int(wide),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "bvh_traverse")
    if wide:
        bvh_traverse.wide_launches += 1
    else:
        bvh_traverse.launches += 1
    return res


bvh_traverse.launches = 0
bvh_traverse.wide_launches = 0


def reset_launch_counts() -> None:
    bvh_traverse.launches = 0
    bvh_traverse.wide_launches = 0
    fetch_attrs.launches = 0


def launch_counts() -> dict:
    """Launches per kernel: K1 with one thread per ray (bvh_traverse) and
    with eight lanes per ray (bvh_traverse_wide), K2 (fetch_attrs)."""
    return {"bvh_traverse": bvh_traverse.launches,
            "bvh_traverse_wide": bvh_traverse.wide_launches,
            "fetch_attrs": fetch_attrs.launches}
