"""The least time one H100 could take for the work of each CUDA kernel.

A kernel's bound is the larger of two times: the bytes its function must
move (each input read once, each output written once) over the card's
memory rate, and the operations it does over the card's rate for them.
`chip_smoke.py` computes the bounds it reports here, from the inputs of
its own run.

Rates: one H100 SXM at its 700 W limit (NVIDIA's data sheet). Its 67
TFLOP/s of float32 outside the tensor cores counts a fused multiply-add as
two operations. Every instruction here (add, multiply, fused multiply-add,
compare, min, max, select, integer op) counts as one at half of that rate,
one per lane per clock: the kernels build with --fmad=false, so that they
round like their plain PyTorch versions, and fuse only where no output
depends on the rounding. The card issues compares, min/max and integer
operations at half that rate and conversions at an eighth, so the bound
is a floor, never reached.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracing_c_tpu_torch import EPSILON
from raytracing_c_tpu_torch.ops.traverse_cuda import occupancy

HBM_BYTES_PER_S = 3.35e12
F32_INSTR_PER_S = 67e12 / 2

#: K1, one box test of an occupied child at the least instruction count:
#: per axis, with the box as center c and half-extent h and -o * inv
#: taken once per ray, tc = c * inv - o * inv and the entry and exit tc -+
#: h |inv| (3 fused multiply-adds) folded into the running entry max and
#: exit min (2), then entry < exit and entry <= best t (2); the entry and
#: exit start at EPSILON and t_max. (csrc/traverse.cu spends one more
#: instruction per axis, (c - o) * inv, so that the slab's rounding stays
#: relative to the origin's distance to the box: 20.)
BOX_TEST_OPS = 17
#: K1, one Moller-Trumbore test of an occupied slot, unfused as the
#: output's rounding requires, at the cost of the step where it leaves:
#: u outside [-EPSILON, 1 + EPSILON] after the cross p (9), det (5), its
#: reciprocal (1), o - v0 (3), u (5 + 1) and 2 compares; v or u + v
#: outside after the cross q (9), v (5 + 1), u + v (1) and 2 compares;
#: else t (5 + 1) and 2 compares (t >= EPSILON, and against the best hit)
TRI_U_FAIL_OPS = 26
TRI_V_FAIL_OPS = TRI_U_FAIL_OPS + 18
TRI_TEST_OPS = TRI_V_FAIL_OPS + 8
#: K1, per ray outside the walk: 3 reciprocals and -o * inv (3); the fused
#: epilogue's interpolation (2 + 5 x 5)
RAY_SETUP_OPS = 6
EPILOGUE_OPS = 27
#: K1's operations per launch come from a re-walk of this many of its rays
K1_SAMPLE = 2048

#: K2: w = 1 - u - v (2) and 5 interpolations of 3 products and 2 sums
K2_OPS_PER_RAY = 27

#: K3, operations per pixel of the shared-memory design (csrc/denoise.cu),
#: each input pixel's work shared by its 9 neighbours: 3 conversions, 3
#: scalings, the luminance (5) and its sort key (3) of the pixel; per
#: output pixel the 9 keys' neighbour index (9), the 9-sum in neighbourhood
#: order (8), the minimum and maximum from the new window row's (4) and the
#: three rows' (4), the mean (3), the 19-compare-exchange median-of-9
#: network on (luminance, index) keys packed in 32 bits, a min and a max
#: each (38), the blend factor (9), the blend (10) and the encode (6)
K3_OPS_PER_PIXEL = 14 + 9 + 8 + 8 + 3 + 19 * 2 + 25


def bound(work: dict) -> dict:
    """The larger of work["bytes"] over the memory rate and work["ops"]
    over the instruction rate, in ms, and which one it is."""
    bytes_ms = work["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = work["ops"] / F32_INSTR_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms}


def k1_walk(nodes, leaf_rows, n_internal: int, origins, directions) -> dict:
    """Re-walk the ordered nearest-first descent (the work of csrc/
    traverse.cu's K1, and of any exact traversal of this tree in that
    order) on the host in float32 for each ray of (n, 3) numpy
    origins/directions: children sorted by entry distance (ties to the
    lower child), an entry strictly farther than the best hit pruned,
    empty children and slots (`traverse_cuda.occupancy`) never tested.
    Returns per ray, each (n,): node_visits, leaf_visits, box_tests (the
    occupied children of the visited nodes), tri_tests (the occupied slots
    of the visited leaf blocks), tri_ops (those tests' operations, each at
    the cost of the step where it leaves: TRI_U_FAIL_OPS, TRI_V_FAIL_OPS
    or TRI_TEST_OPS) and t (the nearest hit)."""
    f32 = np.float32
    eps = f32(EPSILON)
    one_eps = f32(1.0 + EPSILON)
    nodes = np.asarray(nodes, f32)
    leaf_rows = np.asarray(leaf_rows, f32)
    depth = int(round(np.log(leaf_rows.shape[0]) / np.log(8)))
    slot_occ, child_occ = (a.numpy() for a in occupancy(torch.from_numpy(leaf_rows),
                                                         n_internal, depth))
    n = len(origins)
    out = {k: np.zeros(n, np.int64) for k in ("node_visits", "leaf_visits", "box_tests",
                                                 "tri_tests", "tri_ops")}
    best_t = np.full(n, np.inf, f32)
    with np.errstate(all="ignore"):
        for i in range(n):
            o = np.asarray(origins[i], f32)
            d = np.asarray(directions[i], f32)
            inv = f32(1.0) / d
            best = f32(np.inf)
            stack = [(0, f32(0.0))]
            while stack:
                e, dist = stack.pop()
                if dist > best:
                    continue
                if e < n_internal:
                    occ = child_occ[e]
                    out["node_visits"][i] += 1
                    out["box_tests"][i] += occ.sum()
                    row = nodes[e]
                    t0 = (row[0:24].reshape(3, 8) - o[:, None]) * inv[:, None]
                    t1 = (row[24:48].reshape(3, 8) - o[:, None]) * inv[:, None]
                    bad = np.isnan(t0) | np.isnan(t1)
                    lo = np.where(bad, -np.inf, np.minimum(t0, t1)).max(0)
                    hi = np.where(bad, np.inf, np.maximum(t0, t1)).min(0)
                    t_near = np.maximum(lo, eps)
                    ok = occ & (t_near < hi) & (t_near <= best)
                    js = np.flatnonzero(ok)
                    js = js[np.argsort(t_near[js], kind="stable")]
                    stack.extend((8 * e + 1 + int(j), t_near[j]) for j in js[::-1])
                else:
                    blk = e - n_internal
                    occ = slot_occ[blk]
                    out["leaf_visits"][i] += 1
                    out["tri_tests"][i] += occ.sum()
                    lr = leaf_rows[blk][:72].reshape(9, 8)
                    v0, e1, e2 = lr[0:3], lr[3:6], lr[6:9]
                    p = np.stack([d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
                                  d[0] * e2[1] - d[1] * e2[0]])
                    det = e1[0] * p[0] + e1[1] * p[1] + e1[2] * p[2]
                    inv_det = f32(1.0) / det
                    tv = o[:, None] - v0
                    q = np.stack([tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
                                  tv[0] * e1[1] - tv[1] * e1[0]])
                    u = inv_det * (tv[0] * p[0] + tv[1] * p[1] + tv[2] * p[2])
                    v = inv_det * (d[0] * q[0] + d[1] * q[1] + d[2] * q[2])
                    t = inv_det * (e2[0] * q[0] + e2[1] * q[1] + e2[2] * q[2])
                    u_in = (u >= -eps) & (u <= one_eps)
                    v_in = u_in & (v >= -eps) & (u + v <= one_eps)
                    out["tri_ops"][i] += np.where(
                        u_in, np.where(v_in, TRI_TEST_OPS, TRI_V_FAIL_OPS),
                        TRI_U_FAIL_OPS)[occ].sum()
                    hit = v_in & (t >= eps)
                    if hit.any():
                        best = min(best, f32(t[hit].min()))
            best_t[i] = best
    out["t"] = best_t
    return out


def k1_work(scene, origin, direction, epilogue: bool) -> dict:
    """K1's bytes and operations for one launch over the rays (origin,
    direction: Vec3 of (R,)), with the fused attribute epilogue (as on the
    camera bounce) or without it (bounces 1+); the operations from k1_walk
    on K1_SAMPLE of the rays (seeded), scaled to R. Returns bytes, ops, the
    mean visits and tests per ray and the sample size."""
    r = origin.shape[0]
    idx = np.sort(np.random.default_rng(0).choice(r, min(K1_SAMPLE, r), replace=False))
    o = np.stack([c.cpu().numpy()[idx] for c in (origin.x, origin.y, origin.z)], 1)
    d = np.stack([c.cpu().numpy()[idx] for c in (direction.x, direction.y, direction.z)], 1)
    bvh, tris = scene.bvh, scene.triangles
    walk = k1_walk(bvh.nodes.cpu().numpy(), tris.leaf_rows.cpu().numpy(), bvh.n_internal, o, d)
    per_ray = (RAY_SETUP_OPS + walk["box_tests"].mean() * BOX_TEST_OPS
               + walk["tri_ops"].mean() + (EPILOGUE_OPS if epilogue else 0))
    # each input read once: the rays (8 planes), each occupied child's box
    # (6 floats), each occupied slot's v0, e1, e2 (9) and, for the
    # epilogue, each triangle's 25 attribute columns; each output written
    # once: t, u, v, dropped_min, tri and the epilogue's 16 planes
    slot_occ, child_occ = occupancy(tris.leaf_rows.cpu(), bvh.n_internal, bvh.depth)
    table_bytes = 4 * (int(child_occ.sum()) * 6 + int(slot_occ.sum()) * 9
                       + (scene.n_triangles * 25 if epilogue else 0))
    ray_bytes = r * 4 * (8 + 5 + (16 if epilogue else 0))
    return {"bytes": ray_bytes + table_bytes, "ops": float(per_ray * r),
            **{f"{k}_per_ray": float(walk[k].mean())
               for k in ("node_visits", "leaf_visits", "box_tests", "tri_tests", "tri_ops")},
            "sample": len(idx)}


def k2_work(n_rays: int, n_winners: int) -> dict:
    """K2's bytes (tri, u, v in; the winners' 25-float attribute rows; 16
    planes out) and operations for one launch."""
    return {"bytes": n_rays * (12 + 64) + n_winners * 25 * 4, "ops": n_rays * K2_OPS_PER_RAY}


def k3_work(height: int, width: int) -> dict:
    """K3's bytes (3 in and 3 out per pixel) and operations for one launch."""
    n = height * width
    return {"bytes": 6 * n, "ops": n * K3_OPS_PER_PIXEL}
