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

#: K4 (csrc/shade.cu: k4_lane), operations per lane of each kind, counted
#: from the source with each libm routine (powf, sinf, cosf, atan2f, asinf,
#: sqrtf, rsqrtf, floorf) and each IEEE division as one instruction, so a
#: floor far below what the card issues. Every lane: the hit test (2), the
#: hit point (6), the miss test (2), the two radiance sums and their
#: select (9), the continue test, the next state's selects and the active
#: flag (11)
K4_LANE_OPS = 30
#: a hit: the two dot products (10), their compares and the shaded flag (4)
K4_HIT_OPS = 14
#: a shaded lane, its maps aside: the unit normal (11), the material row's
#: clamp and conversions (8), roughness and metalness (6), the view basis
#: (54), sample_disney_brdf with both lobes evaluated (372: the VNDF sample
#: 91, Fresnel 36, the lobe weights 12, the cosine sample 12, the half
#: vector 23, the diffuse and sheen terms 72, the specular lobe 96, the
#: pick 18), the world direction (15), the tint, terminate flag and debug
#: shader (19), the next origin's bias (13)
K4_SHADED_OPS = 11 + 8 + 6 + 54 + 372 + 15 + 19 + 13
#: Russian roulette on a shaded lane
K4_RR_OPS = 18
#: one map's taps: bilinear (the wrap, the texel index, four taps of 3
#: conversions and 3 scalings, three lerps) or nearest (one tap)
K4_TAP_OPS = {"bilinear": 86, "nearest": 24}
#: what a shaded lane does with each map's colour, in the material row's
#: MROW_TEX_* order: albedo (the sRGB decode and product), normal (the
#: tangent-space map and its blend), metal-roughness (2), emissive (as
#: albedo)
K4_MAP_OPS = (18, 43, 2, 18)
#: the equirect background at one direction: its angles (9), the bilinear
#: taps (86) and the sRGB decode (15); a constant sky costs nothing
K4_BG_OPS = 110
#: with NEE, a shaded lane: the light sample (the env table's 36, the
#: uniform sphere's 10), the light in the basis (15), two eval_disney_brdf
#: (230 each), the MIS weight and the light's inverse pdf (8), the
#: contribution and the pdf (8), the shadow ray (13); the background at
#: the light direction is K4_BG_OPS
K4_NEE_OPS = {"table": 36 + 15 + 460 + 8 + 8 + 13, "sphere": 10 + 15 + 460 + 8 + 8 + 13}
#: a miss: its throughput product (3); with NEE also the MIS weight (the env
#: table's pdf 28 + 8, the uniform sphere's 8)
K4_MISS_OPS = {"plain": 3, "table": 3 + 36, "sphere": 3 + 8}
#: the NEE add, per shaded lane: the finite test, three selects and sums
NEE_ADD_OPS = 8

#: K5 (csrc/rng.cu), one threefry2x32 block at the least instruction count:
#: per round an add, a rotation (one funnel shift) and an xor (3 x 20), per
#: key injection an add and a three-input add (2 x 5), the third key word
#: (one three-input xor) and the two initial adds (3)
THREEFRY_OPS = 73
#: a uniform from a block's words: their xor, the mantissa's shift and or,
#: the subtraction of 1 and the max with 0
UNIFORM_WORD_OPS = 5


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


def k4_work(scene, st: dict, t, attrs, shaded, nee: bool, texture_mode: str = "bilinear",
            rr: bool = False) -> dict:
    """K4's bytes and operations for one launch over the lanes of the
    state `st` (as `shade_cuda.shade_bounce` takes them, with the hits' t
    and attribute planes) given the mask of the lanes it shaded (its
    output "shaded"). Bytes, each read or written once: every lane's state
    (the position, direction, throughput and radiance planes, a plane of
    stride 0 once; active; t; with NEE prev_pdf) and next state (12
    floats, active and shaded; with NEE prev_pdf); a hit's two normals; a
    shaded lane's 9 other attribute floats, 3 draws, and per map of its
    material 4 taps of 3 bytes (nearest: 1); with NEE a shaded lane's 3
    draws, the alias slot (prob, alias, lum_p: 16 bytes) with an env
    table, the background's 4 taps at the light under an equirect sky,
    and its shadow ray and contribution (9 floats); a miss's 4 background
    taps under an equirect sky and its lum_p with an env table. Not
    counted: the material rows and the atlas's and env table's small
    tables (read once per launch), Russian roulette's draw, the waste of
    texel sectors. Operations: the K4_* counts per lane kind. Returns
    bytes, ops and the lanes of each kind."""
    from raytracing_c_tpu_torch.models.scene import BG_EQUIRECT, MROW_TEX_ALBEDO

    active = st["active"]
    r = active.numel()
    is_hit = active & torch.isfinite(t)
    hits, n_shaded = int(is_hit.sum()), int(shaded.sum())
    misses = int((active & ~is_hit).sum())
    rows = scene.materials.rows
    mat = attrs[14][shaded].to(torch.int32).clamp(0, rows.shape[0] - 1).long()
    maps = (rows[mat][:, MROW_TEX_ALBEDO:MROW_TEX_ALBEDO + 4] >= 0).sum(0).tolist()
    bg = scene.background
    equirect = bg.kind == BG_EQUIRECT and bg.tex_id >= 0
    light = "table" if scene.env_light is not None else "sphere"
    table = nee and light == "table"

    state = sum(4 * (r if p.stride(0) else 1) for name in ("origin", "direction", "throughput",
                                                          "radiance")
                for p in (st[name].x, st[name].y, st[name].z))
    lane_bytes = 1 + 4 + 48 + 2 + (8 if nee else 0)
    shaded_bytes = 36 + 12 + ((12 + (16 if table else 0) + (12 if equirect else 0) + 36)
                              if nee else 0)
    tap_bytes = 12 if texture_mode == "bilinear" else 3
    miss_bytes = (12 if equirect else 0) + (4 if table else 0)
    nbytes = (state + r * lane_bytes + hits * 24 + n_shaded * shaded_bytes
              + sum(maps) * tap_bytes + misses * miss_bytes)

    ops = (r * K4_LANE_OPS + hits * K4_HIT_OPS
           + n_shaded * (K4_SHADED_OPS + (K4_RR_OPS if rr else 0))
           + sum(m * (K4_TAP_OPS[texture_mode] + k) for m, k in zip(maps, K4_MAP_OPS))
           + misses * ((K4_BG_OPS if equirect else 0) + K4_MISS_OPS[light if nee else "plain"]))
    if nee:
        ops += n_shaded * (K4_NEE_OPS[light] + (K4_BG_OPS if equirect else 0))
    return {"bytes": nbytes, "ops": float(ops), "lanes": r, "hits": hits, "shaded": n_shaded,
            "misses": misses, "map_taps": maps}


def nee_add_work(n_lanes: int) -> dict:
    """The NEE add's bytes (a lane's index and shadow t, its radiance read
    and written, its contribution) and operations for one launch over the
    shaded lanes."""
    return {"bytes": n_lanes * (8 + 4 + 12 + 12 + 12), "ops": n_lanes * NEE_ADD_OPS}


def k5_bounce_work(lanes: int, nu: int) -> dict:
    """K5's rt_bounce_uniforms over `lanes` lanes: bytes (a lane's int64
    slot in, its nu float32 words out; the key once) and operations (the
    two fold_ins and nu blocks a lane, and nu words)."""
    return {"bytes": 16 + lanes * (8 + 4 * nu),
            "ops": float(lanes * ((2 + nu) * THREEFRY_OPS + nu * UNIFORM_WORD_OPS))}


def k5_uniform_work(words: int) -> dict:
    """K5's rt_uniform under one key: bytes (the key in, `words` float32
    out) and operations (a block and a word each)."""
    return {"bytes": 16 + 4 * words, "ops": float(words * (THREEFRY_OPS + UNIFORM_WORD_OPS))}


def k5_key_work(keys: int) -> dict:
    """K5's rt_fold_in or rt_split writing `keys` keys from one: bytes (the
    key in, two int64 words a key out) and operations (a block a key)."""
    return {"bytes": 16 + 16 * keys, "ops": float(keys * THREEFRY_OPS)}
