"""The plain reference for scenes too large for brute force: `trace.py`'s
raygen, bounce loop, shading and NEE, with a conservative cull in front of
its Moller-Trumbore tests.

`trace.intersect` tests every ray against every occupied slot; at a
quarter of a million triangles that is minutes a batch. `intersect` here
gives the same hit, bit for bit, ties included (on equal t the lower
slot): the occupied slots, already in the benchmark's own tree's leaf
order and so spatially sorted, go in chunks of CHUNK consecutive slots,
each with a box over its triangles as the test sees them (v0, v0 + e1,
v0 + e2 from the stored planes), padded outward by `slack` (room for the
test's barycentric epsilon and for the rounding of the float type, which
the bfloat16 control stretches to tens of centimetres). A ray is tested
against a chunk's triangles only where it enters that chunk's box no
farther than its nearest hit so far (plus a margin), nearest boxes first,
in rounds (`_nearest_pairs`). The tests are `trace.moller_trumbore` on the same planes in the
same float type, elementwise, so each (ray, triangle) pair computes the
value the brute force computes; the nearest over the tested pairs, ties to
the lower slot, is then the brute force's winner. Nothing of the program
is imported, nor of its tree: the cull is the reference's own.

`render_batches` is `trace.render_batches` run on a private copy of
`trace.py` whose `intersect` is this module's, with TF32 off.
"""

from __future__ import annotations

import importlib.util
import os

import torch

from reference import trace
from reference.vec3 import Vec3

INF = float("inf")
#: consecutive occupied slots under one box
CHUNK = 64
#: each ray's nearest chunks (by box entry) tested in the first round; each
#: later round tests twice as many
K_FIRST = 4


def _trace_copy():
    """trace.py loaded again as its own module, `intersect` replaced, so
    that its bounce loop calls the culled test; reference.trace itself is
    untouched."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "trace.py")
    spec = importlib.util.spec_from_file_location("reference._trace_culled", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.intersect = intersect
    return mod


def _prepare(scene) -> dict:
    """The chunks of the scene's occupied slots (padded with zero
    triangles, which no ray hits: their determinant is 0) and their padded
    boxes, float32, cached on the scene."""
    got = getattr(scene, "_cull", None)
    if got is not None:
        return got
    n = scene.slots.numel()
    nc = max(1, -(-n // CHUNK))
    pad = nc * CHUNK - n
    dev = scene.device

    def padded(v: Vec3) -> Vec3:
        return v.map(lambda a: torch.cat([a, a.new_zeros(pad)]))

    v0, e1, e2 = padded(scene.v0), padded(scene.e1), padded(scene.e2)
    slots = torch.cat([scene.slots, torch.full((pad,), 2**62, dtype=torch.int64, device=dev)])
    real = torch.arange(nc * CHUNK, device=dev) < n
    lo, hi = [], []
    for c in "xyz":
        a = getattr(v0, c).double()
        verts = torch.stack([a, a + getattr(e1, c).double(), a + getattr(e2, c).double()])
        lo.append(torch.where(real, verts.min(0).values, INF).view(nc, CHUNK).min(1).values)
        hi.append(torch.where(real, verts.max(0).values, -INF).view(nc, CHUNK).max(1).values)
    lo, hi = torch.stack(lo), torch.stack(hi)  # (3, nc)
    finite = torch.isfinite(lo).all(0)
    scale = float(torch.maximum(lo[:, finite].abs().max(), hi[:, finite].abs().max())) \
        + float((hi[:, finite] - lo[:, finite]).max())
    eps = torch.finfo(scene.ft).eps
    slack = 1e-3 + 4.0 * eps * scale
    got = scene._cull = {
        "v0": v0, "e1": e1, "e2": e2, "slots": slots, "nc": nc, "slack": slack,
        "lo": (lo - slack).float(), "hi": (hi + slack).float(),
    }
    return got


def _entries(cull, o: Vec3, d: Vec3) -> torch.Tensor:
    """(B, nc) float32: where each ray enters each chunk's padded box (0 if
    it starts inside), +inf where it misses the box or the box lies behind
    it. Zero direction components take a tiny stand-in, so that an origin
    on a slab's plane never makes 0 * inf."""
    tn = tf = None
    for k, c in enumerate("xyz"):
        oc = getattr(o, c).float()[:, None]
        dc = getattr(d, c).float()
        dc = torch.where(dc.abs() < 1e-30, torch.full_like(dc, 1e-30).copysign(dc), dc)
        inv = (1.0 / dc)[:, None]
        t1 = (cull["lo"][k][None, :] - oc) * inv
        t2 = (cull["hi"][k][None, :] - oc) * inv
        near, far = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tn = near if tn is None else torch.maximum(tn, near)
        tf = far if tf is None else torch.minimum(tf, far)
    hit = (tn <= tf + 1e-4 + 1e-5 * tf.abs()) & (tf >= -1e-4)
    return torch.where(hit, torch.clamp_min(tn, 0.0), INF)


def _test_pairs(cull, o: Vec3, d: Vec3, ray, chunk):
    """Rays `ray` against all triangles of chunks `chunk` ((P,) each):
    per pair the chunk's nearest hit (t, slot, u, v), ties to the lower
    slot; t = +inf, slot 2**62 where none."""
    p = ray.numel()
    ft = o.x.dtype
    out_t = torch.full((p,), INF, dtype=ft, device=ray.device)
    out_s = torch.full((p,), 2**62, dtype=torch.int64, device=ray.device)
    out_u = torch.zeros((p,), dtype=ft, device=ray.device)
    out_v = torch.zeros((p,), dtype=ft, device=ray.device)
    step = max(1, (2**24 if ray.device.type == "cuda" else 2**18) // CHUNK)
    lane = torch.arange(CHUNK, device=ray.device)
    for a in range(0, p, step):
        r, c = ray[a:a + step], chunk[a:a + step]
        tri = c[:, None] * CHUNK + lane[None, :]
        t, u, v = trace.moller_trumbore(o.gather(r).map(lambda x: x[:, None]),
                                        d.gather(r).map(lambda x: x[:, None]),
                                        cull["v0"].gather(tri), cull["e1"].gather(tri),
                                        cull["e2"].gather(tri))
        j = torch.argmin(t, dim=1, keepdim=True)
        out_t[a:a + step] = t.gather(1, j)[:, 0]
        out_s[a:a + step] = torch.where(torch.isfinite(out_t[a:a + step]),
                                        cull["slots"][tri.gather(1, j)[:, 0]], 2**62)
        out_u[a:a + step] = u.gather(1, j)[:, 0]
        out_v[a:a + step] = v.gather(1, j)[:, 0]
    return out_t, out_s, out_u, out_v


def intersect(scene, origin: Vec3, direction: Vec3, active=None):
    """`trace.intersect`'s result, through the cull: dict(t, tri (slot id),
    u, v); misses t = +inf, tri = -1. Inactive rays are not tested (their
    result is a miss either way)."""
    cull = _prepare(scene)
    r = origin.shape[0]
    dev = origin.x.device
    ft = scene.ft
    best_t = torch.full((r,), INF, dtype=ft, device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((r,), dtype=ft, device=dev)
    best_v = torch.zeros((r,), dtype=ft, device=dev)
    todo = torch.arange(r, device=dev) if active is None else torch.nonzero(active).squeeze(1)
    block = max(1, (2**25 if dev.type == "cuda" else 2**21) // cull["nc"])
    for b0 in range(0, todo.numel(), block):
        rays = todo[b0:b0 + block]
        pr, pt, ps, pu, pv = _nearest_pairs(cull, origin.gather(rays), direction.gather(rays), ft)
        # the nearest t, then the lowest slot at that t: the brute force's winner
        n = rays.numel()
        tmin = torch.full((n,), INF, dtype=ft, device=dev).scatter_reduce(0, pr, pt, "amin")
        at_min = torch.isfinite(pt) & (pt == tmin[pr])
        smin = torch.full((n,), 2**62, dtype=torch.int64, device=dev).scatter_reduce(
            0, pr[at_min], ps[at_min], "amin")
        win = torch.nonzero(at_min & (ps == smin[pr])).squeeze(1)
        wr = rays[pr[win]]
        best_t[wr] = pt[win]
        best_tri[wr] = ps[win]
        best_u[wr] = pu[win]
        best_v[wr] = pv[win]
    hit = torch.isfinite(best_t)
    if active is not None:
        hit &= active
    return {"t": torch.where(hit, best_t, INF), "tri": torch.where(hit, best_tri, -1),
            "u": torch.where(hit, best_u, 0.0), "v": torch.where(hit, best_v, 0.0)}


def _nearest_pairs(cull, o: Vec3, d: Vec3, ft):
    """Every (ray, chunk) pair of a block of rays that can hold a hit no
    farther than the ray's nearest: in rounds, each ray's next K nearest
    chunks by box entry (K_FIRST, doubling each round) among those it
    enters no farther than its nearest hit so far plus a margin, until no
    ray has such a chunk left. Returns the tested pairs' (ray, t, slot, u,
    v), each pair's being its chunk's nearest hit (`_test_pairs`)."""
    ent = _entries(cull, o, d)
    n, dev = ent.shape[0], ent.device
    near = torch.full((n,), INF, dtype=ft, device=dev)
    rows = torch.arange(n, device=dev)
    got = []
    k = K_FIRST
    while rows.numel():
        bound = near[rows].float()
        bound = torch.where(torch.isfinite(bound),
                            bound + cull["slack"] + 1e-4 * bound.abs(), INF)
        e = ent[rows]
        e = torch.where(e <= bound[:, None], e, INF)
        k_ent, k_idx = torch.topk(e, min(k, e.shape[1]), dim=1, largest=False)
        i, j = torch.nonzero(torch.isfinite(k_ent), as_tuple=True)
        if not i.numel():
            break
        ray, chunk = rows[i], k_idx[i, j]
        res = _test_pairs(cull, o, d, ray, chunk)
        got.append((ray,) + res)
        ent[ray, chunk] = INF
        near = near.scatter_reduce(0, ray, res[0], "amin")
        rows = torch.unique(ray)  # only a ray that still had chunks can have more
        k *= 2
    if not got:
        z = torch.zeros((0,), device=dev)
        return (z.long(), z.to(ft), z.long(), z.to(ft), z.to(ft))
    return tuple(torch.cat(parts) for parts in zip(*got))


_TRACE = None


def render_batches(scene, seed: int, batches, **kw):
    """`trace.render_batches` with the culled intersection, TF32 off."""
    global _TRACE
    if _TRACE is None:
        _TRACE = _trace_copy()
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _TRACE.render_batches(scene, seed, batches, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
