"""Host-side implicit 8-ary BVH construction (numpy).

Counterpart of `raytracing_c_tpu/models/bvh.py` with the reference's
midpoint splitter (scene.c:203-426), so the port builds the same tree and
the same leaf-slot map:

- complete implicit tree, fan-out 8; node i's children are 8*i + 1 + j
- depth = smallest d with 8**d >= ceil(n/8), clamped to >= 1
- a slice splits at `partition_count` (scene.c:235-242) on the axis whose
  centroid sort minimises the summed child surface areas; ties keep the
  later axis (the reference's `<=` compare, scene.c:344-360)
- per-triangle boxes are padded by +/-EPSILON (aabb_triangle, scene.c:177-188)
"""

from __future__ import annotations

import numpy as np
import torch

from raytracing_c_tpu_torch import BVH_WIDTH, EPSILON
from raytracing_c_tpu_torch.models.scene import BVH, HostMesh

W = BVH_WIDTH


def n_leaf_nodes(depth: int) -> int:
    """8**depth (scene.h:103-109)."""
    return W**depth


def n_internal_nodes(depth: int) -> int:
    """sum_{i<depth} 8**i (scene.h:111-119)."""
    return sum(W**i for i in range(depth))


def required_depth(n_triangles: int) -> int:
    """bvh_required_depth (scene.c:224-233), clamped to >= 1."""
    blocks = (n_triangles + W - 1) // W
    n, depth = 1, 0
    while n < blocks:
        n *= W
        depth += 1
    return max(depth, 1)


def partition_count(n_triangles: int, per_child: int) -> int:
    """bvh_partition_triangles (scene.c:235-242), ported literally."""
    n, left = 0, n_triangles
    while n < n_triangles // 2 and left > per_child:
        n += per_child
        left -= per_child
    return n


def build_bvh(mesh: HostMesh):
    """Build the implicit BVH. Returns (bvh, slot_map, capacity): slot_map
    is a (capacity,) int64 array mapping each padded leaf slot to a mesh
    triangle index (-1 = empty padding slot)."""
    n = mesh.positions.shape[0]
    depth = required_depth(n)
    n_internal = n_internal_nodes(depth)
    capacity = n_leaf_nodes(depth) * W

    mins = np.zeros((n_internal, W, 3), np.float32)
    maxs = np.zeros((n_internal, W, 3), np.float32)
    slot_map = np.full(capacity, -1, np.int64)

    if n > 0:
        pos = mesh.positions.astype(np.float64)
        centroids = pos.sum(axis=1)  # sum of vertex coords (scene.c:213-219)
        tri_min = pos.min(axis=1) - EPSILON
        tri_max = pos.max(axis=1) + EPSILON
        order = np.arange(n, dtype=np.int64)
        _build_node(order, 0, n, 0, depth, n_internal, centroids, tri_min,
                    tri_max, mins, maxs, slot_map)

    nodes = np.zeros((n_internal, 128), np.float32)
    nodes[:, : 6 * W] = np.concatenate(
        [mins.transpose(0, 2, 1), maxs.transpose(0, 2, 1)], axis=1
    ).reshape(n_internal, 6 * W)
    bvh = BVH(nodes=torch.from_numpy(nodes), depth=depth, last_row_offset=n_internal)
    return bvh, slot_map, capacity


def _build_node(order, lo, hi, index, depth, last_row_offset, centroids,
                tri_min, tri_max, mins, maxs, slot_map):
    """Recursive node build (bvh_build, scene.c:311-414), iterative split."""
    if depth == 0:
        block = index - last_row_offset
        slot_map[block * W: block * W + hi - lo] = order[lo:hi]
        return

    per_child = n_leaf_nodes(depth)

    # iterative partition of [lo, hi) into <= 8 finished child ranges
    slices = [(lo, hi)]
    finished = []
    while slices:
        sl, sh = slices.pop()
        ln = sh - sl
        if ln <= per_child:
            if ln > 0:
                finished.append((sl, sh))
            continue
        seg = order[sl:sh]
        split = partition_count(ln, per_child)
        best_axis, best_key = 0, np.inf
        perms = []
        for axis in range(3):
            perm = np.argsort(centroids[seg, axis], kind="stable")
            perms.append(perm)
            left = seg[perm[:split]]
            right = seg[perm[split:]]
            sa = _sa(tri_min[left], tri_max[left]) + _sa(tri_min[right], tri_max[right])
            if sa <= best_key:
                best_key, best_axis = sa, axis
        order[sl:sh] = seg[perms[best_axis]]
        slices.append((sl, sl + split))
        slices.append((sl + split, sh))

    for i, (fl, fh) in enumerate(finished):
        idx = order[fl:fh]
        mins[index, i] = tri_min[idx].min(axis=0)
        maxs[index, i] = tri_max[idx].max(axis=0)
        _build_node(order, fl, fh, W * index + 1 + i, depth - 1, last_row_offset,
                    centroids, tri_min, tri_max, mins, maxs, slot_map)


def _sa(lo, hi):
    """Surface area of the AABB over a triangle set (aabb_surface_area,
    scene.c:157-162)."""
    if len(lo) == 0:
        return 0.0
    d = hi.max(axis=0) - lo.min(axis=0)
    return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])
