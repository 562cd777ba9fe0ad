"""The benchmark's own implicit 8-ary BVH of a scene (the midpoint splitter).

Frozen copy of the midpoint splitter of `raytracing_c_tpu_torch/models/
bvh.py` at commit f272015 (the reference C renderer's bvh_build,
scene.c:224-414): a complete implicit tree, fan-out 8, node i's children
8*i + 1 + j; depth the least d with 8**d >= ceil(n/8); a slice splits at
`partition_count` on the axis whose centroid sort gives the least summed
child surface area, the later axis on ties; triangle boxes padded by
+-EPSILON. K1's yardstick (`roofline/k1.py`) counts its work on this tree,
and the plain reference takes its triangle slots from it, so that neither
moves when the program's splitter, K1's layout or K1 change.
"""

from __future__ import annotations

import numpy as np

W = 8
EPSILON = 1.0e-4


def n_leaf_nodes(depth: int) -> int:
    return W**depth


def n_internal_nodes(depth: int) -> int:
    return sum(W**i for i in range(depth))


def required_depth(n_triangles: int) -> int:
    blocks = (n_triangles + W - 1) // W
    n, depth = 1, 0
    while n < blocks:
        n *= W
        depth += 1
    return max(depth, 1)


def partition_count(n_triangles: int, per_child: int) -> int:
    n, left = 0, n_triangles
    while n < n_triangles // 2 and left > per_child:
        n += per_child
        left -= per_child
    return n


def build_bvh(positions: np.ndarray):
    """positions: (n, 3, 3) float32 triangles. Returns dict(depth,
    n_internal, mins, maxs ((n_internal, 8, 3) float32 child boxes),
    slot_map ((8**depth * 8,) int64: the triangle in each leaf slot, -1 for
    an empty slot))."""
    n = positions.shape[0]
    depth = required_depth(n)
    n_internal = n_internal_nodes(depth)
    capacity = n_leaf_nodes(depth) * W
    mins = np.zeros((n_internal, W, 3), np.float32)
    maxs = np.zeros((n_internal, W, 3), np.float32)
    slot_map = np.full(capacity, -1, np.int64)
    if n > 0:
        pos = positions.astype(np.float64)
        centroids = pos.sum(axis=1)
        tri_min = pos.min(axis=1) - EPSILON
        tri_max = pos.max(axis=1) + EPSILON
        order = np.arange(n, dtype=np.int64)
        _build_node(order, 0, n, 0, depth, n_internal, centroids, tri_min, tri_max, mins, maxs,
                    slot_map)
    return {"depth": depth, "n_internal": n_internal, "mins": mins, "maxs": maxs,
            "slot_map": slot_map}


def _build_node(order, lo, hi, index, depth, last_row_offset, centroids, tri_min, tri_max,
                mins, maxs, slot_map):
    if depth == 0:
        block = index - last_row_offset
        slot_map[block * W: block * W + hi - lo] = order[lo:hi]
        return
    per_child = n_leaf_nodes(depth)
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
        perms = [np.argsort(centroids[seg, axis], kind="stable") for axis in range(3)]
        split = partition_count(ln, per_child)
        best_axis, best_key = 0, np.inf
        for axis, perm in enumerate(perms):
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
        _build_node(order, fl, fh, W * index + 1 + i, depth - 1, last_row_offset, centroids,
                    tri_min, tri_max, mins, maxs, slot_map)


def _sa(lo, hi):
    if len(lo) == 0:
        return 0.0
    d = hi.max(axis=0) - lo.min(axis=0)
    return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])
