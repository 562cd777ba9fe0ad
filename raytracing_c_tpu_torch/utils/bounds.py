"""The least time one H100 could take for the work of each CUDA kernel.

A kernel's bound is the larger of two times: the bytes its function must
move (each input read once, each output written once) over the card's
memory rate, and the operations it does over the card's rate for them.
`chip_smoke.py` and `tools/torch_profile.py` compute the bounds they report
here, from the inputs of their own run.

Rates: one H100 SXM at its 700 W limit (NVIDIA's data sheet). Its 67
TFLOP/s of float32 outside the tensor cores counts a fused multiply-add as
two operations. The kernels are built with --fmad=false, so that they round
like their plain PyTorch versions, and every add, multiply, compare and
select issues as one instruction: their rate is half of it.
"""

from __future__ import annotations

import numpy as np

from raytracing_c_tpu_torch import EPSILON

HBM_BYTES_PER_S = 3.35e12
F32_INSTR_PER_S = 67e12 / 2

#: K1, one child-box slab test: 3 axes x (2 sub, 2 mul, min, max, max,
#: min), the entry/exit clamps and the 2 compares
BOX_TEST_OPS = 28
#: K1, one Moller-Trumbore test (2 crosses of 9, 4 dots of 5, 1 reciprocal,
#: 3 subs, 3 scalings, 6 compares and 1 add)
TRI_TEST_OPS = 52
#: K1, per ray outside the walk: 3 reciprocals, and the fused epilogue's
#: interpolation (2 + 5 x 5)
RAY_SETUP_OPS = 3
EPILOGUE_OPS = 27
#: K1's operations per launch come from a re-walk of this many of its rays
K1_SAMPLE = 2048

#: K2: w = 1 - u - v (2) and 5 interpolations of 3 products and 2 sums
K2_OPS_PER_RAY = 27

#: K3, the least operations per pixel of its function, each input pixel's
#: luminance shared by its 9 neighbours: 3 conversions, 3 scalings and the
#: luminance (5) of the pixel; the 9-sum in neighbourhood order (8); min
#: and max of 9 (16); the mean (3); a median-of-9 selection network of 19
#: compare-exchanges on (luminance, index) keys, which picks the stable
#: sort's median, each a 3-instruction lexicographic compare and 4 selects
#: (133); the blend factor (9), the blend (10) and the encode (6)
K3_OPS_PER_PIXEL = 11 + 8 + 16 + 3 + 19 * 7 + 25


def bound(work: dict) -> dict:
    """The larger of work["bytes"] over the memory rate and work["ops"]
    over the instruction rate, in ms, and which one it is."""
    bytes_ms = work["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = work["ops"] / F32_INSTR_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms}


def k1_walk(nodes, leaf_rows, n_internal: int, origins, directions):
    """Re-walk K1's ordered nearest-first descent (csrc/traverse.cu) on the
    host in float32 for each ray of (n, 3) numpy origins/directions, with
    the kernel's pruning (an entry strictly farther than the best hit is
    skipped) and its child order. Returns (internal node visits, leaf
    block visits, best t) per ray, each (n,)."""
    f32 = np.float32
    eps = f32(EPSILON)
    one_eps = f32(1.0 + EPSILON)
    nodes = np.asarray(nodes, f32)
    leaf_rows = np.asarray(leaf_rows, f32)
    n = len(origins)
    visits_n = np.zeros(n, np.int64)
    visits_l = np.zeros(n, np.int64)
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
                    visits_n[i] += 1
                    row = nodes[e]
                    t0 = (row[0:24].reshape(3, 8) - o[:, None]) * inv[:, None]
                    t1 = (row[24:48].reshape(3, 8) - o[:, None]) * inv[:, None]
                    bad = np.isnan(t0) | np.isnan(t1)
                    lo = np.where(bad, -np.inf, np.minimum(t0, t1)).max(0)
                    hi = np.where(bad, np.inf, np.maximum(t0, t1)).min(0)
                    t_near = np.maximum(lo, eps)
                    ok = (t_near < hi) & (t_near <= best)
                    js = np.flatnonzero(ok)
                    js = js[np.argsort(t_near[js], kind="stable")]
                    stack.extend((8 * e + 1 + int(j), t_near[j]) for j in js[::-1])
                else:
                    visits_l[i] += 1
                    lr = leaf_rows[e - n_internal][:72].reshape(9, 8)
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
                    hit = (u >= -eps) & (u <= one_eps) & (v >= -eps) & (u + v <= one_eps) & (t >= eps)
                    if hit.any():
                        best = min(best, f32(t[hit].min()))
            best_t[i] = best
    return visits_n, visits_l, best_t


def k1_work(scene, origin, direction) -> dict:
    """K1's bytes and operations for one launch with the fused attribute
    epilogue over the rays (origin, direction: Vec3 of (R,)); the
    operations from k1_walk on K1_SAMPLE of them (seeded), scaled to R.
    Returns bytes, ops, the mean visits per ray and the sample size."""
    r = origin.shape[0]
    idx = np.sort(np.random.default_rng(0).choice(r, min(K1_SAMPLE, r), replace=False))
    o = np.stack([c.cpu().numpy()[idx] for c in (origin.x, origin.y, origin.z)], 1)
    d = np.stack([c.cpu().numpy()[idx] for c in (direction.x, direction.y, direction.z)], 1)
    bvh, tris = scene.bvh, scene.triangles
    vn, vl, _ = k1_walk(bvh.nodes.cpu().numpy(), tris.leaf_rows.cpu().numpy(),
                        bvh.n_internal, o, d)
    per_ray = (RAY_SETUP_OPS + vn.mean() * 8 * BOX_TEST_OPS + vl.mean() * 8 * TRI_TEST_OPS
               + EPILOGUE_OPS)
    # each input read once (rays: 8 planes; the tables at the columns K1
    # reads: 48 of a node row, 72 of a leaf row, 25 of an attribute row),
    # each output written once (t, u, v, dropped_min, tri; 16 planes)
    table_bytes = 4 * (bvh.n_internal * 48 + tris.leaf_rows.shape[0] * 72
                       + scene.n_triangles * 25)
    ray_bytes = r * (8 * 4 + 5 * 4 + 16 * 4)
    return {"bytes": ray_bytes + table_bytes, "ops": float(per_ray * r),
            "node_visits_per_ray": float(vn.mean()), "leaf_visits_per_ray": float(vl.mean()),
            "sample": len(idx)}


def k2_work(n_rays: int, n_winners: int) -> dict:
    """K2's bytes (tri, u, v in; the winners' 25-float attribute rows; 16
    planes out) and operations for one launch."""
    return {"bytes": n_rays * (12 + 64) + n_winners * 25 * 4, "ops": n_rays * K2_OPS_PER_RAY}


def k3_work(height: int, width: int) -> dict:
    """K3's bytes (3 in and 3 out per pixel) and operations for one launch."""
    n = height * width
    return {"bytes": 6 * n, "ops": n * K3_OPS_PER_PIXEL}
