"""K1's work on the benchmark's own tree of the scene, whatever walks it.

The walk is a frozen copy of `raytracing_c_tpu_torch/utils/bounds.py:
k1_walk` at commit f272015, re-rooted on the tree of `roofline/bvh.py`:
children in order of their entry distance (ties to the lower child), an
entry strictly farther than the best hit pruned, empty children and slots
never tested. A camera or bounce ray counts this nearest-first walk to
its end. A shadow ray needs only whether anything lies on its path, so it
counts the same descent stopped at its first occluder: its work is what
an any-hit walk needs, and an any-hit kernel reads against that.

A launch's operations are the mean over a seeded sample of its rays,
scaled to its ray count; its bytes are the rays (8 planes in, 5 out, and
16 more out with the fused attribute epilogue) and the tables each read
once (6 floats per occupied child box, 9 per occupied slot, 25 attribute
floats per triangle for the epilogue).
"""

from __future__ import annotations

import numpy as np

from roofline import bounds
from roofline.bvh import EPSILON, W, build_bvh


class K1Tree:
    """The benchmark's tree of a scene's float32 triangles (n, 3, 3)."""

    def __init__(self, positions: np.ndarray):
        f32 = np.float32
        tree = build_bvh(positions.astype(f32))
        self.n_internal, self.depth = tree["n_internal"], tree["depth"]
        self.n_triangles = positions.shape[0]
        # node rows as (3, 8) mins and maxs per node
        self.lo = np.ascontiguousarray(tree["mins"].transpose(0, 2, 1))
        self.hi = np.ascontiguousarray(tree["maxs"].transpose(0, 2, 1))
        slot_map = tree["slot_map"]
        valid = slot_map >= 0
        pos = positions.astype(f32)[np.where(valid, slot_map, 0)]
        pos[~valid] = 0
        v0, e1, e2 = pos[:, 0], pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0]
        nb = len(slot_map) // W
        # per leaf block: (3, 8) v0, e1, e2 component rows
        self.v0 = np.ascontiguousarray(v0.reshape(nb, W, 3).transpose(0, 2, 1))
        self.e1 = np.ascontiguousarray(e1.reshape(nb, W, 3).transpose(0, 2, 1))
        self.e2 = np.ascontiguousarray(e2.reshape(nb, W, 3).transpose(0, 2, 1))
        self.slot_occ = valid.reshape(nb, W)
        block_occ = self.slot_occ.any(1)
        occ = np.zeros((self.n_internal, W), bool)
        child = W * np.arange(self.n_internal)[:, None] + 1 + np.arange(W)
        for level in reversed(range(self.depth)):
            lo, n = (W**level - 1) // (W - 1), W**level
            c = child[lo:lo + n]
            occ[lo:lo + n] = (block_occ[c - self.n_internal] if level == self.depth - 1
                              else occ[c].any(2))
        self.child_occ = occ

    def table_bytes(self, epilogue: bool) -> int:
        return 4 * (int(self.child_occ.sum()) * 6 + int(self.slot_occ.sum()) * 9
                    + (self.n_triangles * 25 if epilogue else 0))

    def walk_ops(self, o, d, any_hit: bool) -> int:
        """Operations of one ray's walk (box tests and triangle tests)."""
        f32 = np.float32
        eps, one_eps = f32(EPSILON), f32(1.0 + EPSILON)
        o = np.asarray(o, f32)
        d = np.asarray(d, f32)
        ops = 0
        with np.errstate(all="ignore"):
            inv = f32(1.0) / d
            best = f32(np.inf)
            stack = [(0, f32(0.0))]
            while stack:
                e, dist = stack.pop()
                if dist > best:
                    continue
                if e < self.n_internal:
                    occ = self.child_occ[e]
                    ops += int(occ.sum()) * bounds.BOX_TEST_OPS
                    t0 = (self.lo[e] - o[:, None]) * inv[:, None]
                    t1 = (self.hi[e] - o[:, None]) * inv[:, None]
                    bad = np.isnan(t0) | np.isnan(t1)
                    lo = np.where(bad, -np.inf, np.minimum(t0, t1)).max(0)
                    hi = np.where(bad, np.inf, np.maximum(t0, t1)).min(0)
                    t_near = np.maximum(lo, eps)
                    ok = occ & (t_near < hi) & (t_near <= best)
                    js = np.flatnonzero(ok)
                    js = js[np.argsort(t_near[js], kind="stable")]
                    stack.extend((W * e + 1 + int(j), t_near[j]) for j in js[::-1])
                    continue
                blk = e - self.n_internal
                occ = self.slot_occ[blk]
                v0, e1, e2 = self.v0[blk], self.e1[blk], self.e2[blk]
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
                cost = np.where(u_in, np.where(v_in, bounds.TRI_TEST_OPS, bounds.TRI_V_FAIL_OPS),
                                bounds.TRI_U_FAIL_OPS)
                hit = v_in & (t >= eps) & occ
                if any_hit and hit.any():
                    first = int(np.flatnonzero(hit)[0])
                    return ops + int(cost[:first + 1][occ[:first + 1]].sum())
                ops += int(cost[occ].sum())
                if hit.any():
                    best = min(best, f32(t[hit].min()))
        return ops


def launch_work(tree: K1Tree, n_rays: int, origins, directions, any_hit: bool,
                epilogue: bool) -> tuple[float, float]:
    """(bytes, operations) of one K1 launch over n_rays rays, from the walks
    of the sampled rays (origins, directions: (s, 3) float32)."""
    if n_rays == 0 or len(origins) == 0:
        return 0.0, 0.0
    per_ray = np.mean([tree.walk_ops(o, d, any_hit) for o, d in zip(origins, directions)])
    per_ray += bounds.RAY_SETUP_OPS + (bounds.EPILOGUE_OPS if epilogue else 0)
    nbytes = n_rays * 4 * (8 + 5 + (16 if epilogue else 0)) + tree.table_bytes(epilogue)
    return float(nbytes), float(per_ray * n_rays)
