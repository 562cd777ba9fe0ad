"""K1's node and triangle tables (ops/traverse_cuda.py: build_k1_tables)
and the traversal orders of its two kernels, on the CPU.

The CUDA kernels (csrc/traverse.cu) cannot run here, so `_rewalk` (one
thread per ray) and `_rewalk_wide` (eight lanes per ray) repeat them in
numpy float32 over the same tables: occupied children only, the fused
center/half-extent box test (a float32 fma, emulated through float64) and
Moller-Trumbore in the kernels' operation order. `_rewalk` sorts the hit
children by entry distance and keeps one (node, children left) entry per
level, re-testing its next child against the best t; `_rewalk_wide`
re-tests all of an entry's children at once and takes the nearest, and
takes the least (t, triangle id) of a leaf block. Their (tri, t) must
equal the brute-force oracle's exactly: on a random soup, and on
chip_smoke.py's helmet stand-in (cut to 16 x 16 quads) for camera rays and
for the live rays entering bounce 1, with axis-parallel rays whose origins
lie on box planes among them; and on a soup moved to 1e4 for rays that
graze its leaf boxes.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from raytracing_c_tpu_torch import EPSILON
from raytracing_c_tpu_torch.models import scene as ps
from raytracing_c_tpu_torch.ops import traverse_cuda as tc
from raytracing_c_tpu_torch.render import camera, integrator
from raytracing_c_tpu_torch.utils import rng
from raytracing_c_tpu_torch.utils.vec3 import Vec3

from helpers import random_mesh
from torch_port_helpers import aimed_rays, port_mesh, tvec

F32 = np.float32
LEAF = 1 << 31


def _fma(a, b, c):
    """float32 fma through float64: a * b is exact there; the sum rounds
    twice, which differs from one rounding in rare last-bit cases (the
    kernel's box test reaches no output)."""
    return F32(np.float64(a) * np.float64(b) + np.float64(c))


def _mt(o, d, v0, e1, e2):
    """Moller-Trumbore of one ray against (n, 3) triangles, the kernel's
    operation order, float32; t = inf on a miss."""
    eps, one_eps = F32(EPSILON), F32(1.0 + EPSILON)
    p = np.stack([d[1] * e2[:, 2] - d[2] * e2[:, 1], d[2] * e2[:, 0] - d[0] * e2[:, 2],
                  d[0] * e2[:, 1] - d[1] * e2[:, 0]])
    det = e1[:, 0] * p[0] + e1[:, 1] * p[1] + e1[:, 2] * p[2]
    inv_det = F32(1.0) / det
    tv = (o[None, :] - v0).T
    q = np.stack([tv[1] * e1[:, 2] - tv[2] * e1[:, 1], tv[2] * e1[:, 0] - tv[0] * e1[:, 2],
                  tv[0] * e1[:, 1] - tv[1] * e1[:, 0]])
    u = inv_det * (tv[0] * p[0] + tv[1] * p[1] + tv[2] * p[2])
    v = inv_det * (d[0] * q[0] + d[1] * q[1] + d[2] * q[2])
    t = inv_det * (e2[:, 0] * q[0] + e2[:, 1] * q[1] + e2[:, 2] * q[2])
    ok = (u >= -eps) & (u <= one_eps) & (v >= -eps) & (u + v <= one_eps) & (t >= eps)
    return np.where(ok, t, F32(np.inf))


def _box_entry(rec, k, inv, o, best_t):
    """The kernel's box_entry for child slot k of a node record: the entry
    distance, or None when the ray misses or the box is strictly farther
    than best_t."""
    a, b = rec[2 * k], rec[2 * k + 1]
    lo, hi = F32(EPSILON), F32(np.inf)
    for j, (c, h) in enumerate(((a[0], a[3]), (a[1], b[0]), (a[2], b[1]))):
        tc = (c - o[j]) * inv[j]
        lo = np.fmax(lo, _fma(-h, abs(inv[j]), tc))
        hi = np.fmin(hi, _fma(h, abs(inv[j]), tc))
    return lo if lo < hi and lo <= best_t else None


def _rewalk(tables, origins, directions):
    """The kernel's walk over `tables` per ray: expand a node (test its
    occupied children, sort the hits by key = entry distance's bits with
    the slot in the low 3, go to the nearest, keep the rest as a list),
    or take the next child of the deepest entry and re-test it. Returns
    (tri, t, deepest stack), each per ray."""
    nodes = tables.nodes.numpy()
    refs = tables.nodes.view(torch.int32).numpy()[1::2, 2].astype(np.int64) & 0xFFFFFFFF
    tris = tables.tris.numpy().reshape(-1, 3, 4)
    ids = tables.tris.view(torch.int32).numpy().reshape(-1, 3, 4)[:, 0, 3]
    n = len(origins)
    out_tri = np.full(n, -1, np.int64)
    out_t = np.full(n, np.inf, F32)
    deepest = np.zeros(n, np.int64)
    with np.errstate(all="ignore"):
        for i in range(n):
            o, d = F32(origins[i]), F32(directions[i])
            inv = F32(1.0) / d
            inv = np.where(np.abs(inv) > F32(1e30), np.copysign(F32(np.inf), inv), inv)
            best_t, best_tri = F32(np.inf), -1
            fresh, cur, stack = tables.root, None, []  # cur: [node, slots left]
            while True:
                leaf = None
                while leaf is None:
                    if fresh:
                        node, m = fresh >> 8, fresh & 0xFF
                        rec = nodes[16 * node:16 * node + 16]
                        fresh = 0
                        keys = []
                        for k in range(8):
                            t = _box_entry(rec, k, inv, o, best_t) if m >> k & 1 else None
                            if t is not None:
                                keys.append((int(F32(t).view(np.uint32)) & ~7) | k)
                        if not keys:
                            continue
                        keys.sort()
                        ref = int(refs[8 * node + (keys[0] & 7)])
                        if len(keys) > 1:
                            if cur and cur[1]:
                                stack.append(cur)
                            cur = [node, [kk & 7 for kk in keys[1:]]]
                    else:
                        if not (cur and cur[1]):
                            if not stack:
                                break
                            cur = stack.pop()
                        node, k = cur[0], cur[1].pop(0)
                        if _box_entry(nodes[16 * node:16 * node + 16], k, inv, o,
                                      best_t) is None:
                            continue
                        ref = int(refs[8 * node + k])
                    if ref & LEAF:
                        leaf = ((ref & ~LEAF) >> 4, ref & 0xF)
                    else:
                        fresh = ref
                    deepest[i] = max(deepest[i], len(stack))
                if leaf is None:
                    break
                first, count = leaf
                blk = tris[first:first + count]
                ts = _mt(o, d, blk[:, 0, :3], blk[:, 1, :3], blk[:, 2, :3])
                for t, tri in zip(ts, ids[first:first + count]):
                    if t < np.inf and (t < best_t or (t == best_t and tri < best_tri)):
                        best_t, best_tri = t, int(tri)
            out_tri[i], out_t[i] = best_tri, best_t
    return out_tri, out_t, deepest


def _rewalk_wide(tables, origins, directions):
    """bvh_traverse_wide_kernel's walk over `tables` per ray: a step tests
    the children of (node, mask) and goes to the nearest hit one, pushing
    the other hit ones as one entry; a leaf block's least (t, id) against
    the best so far wins; then the top entry is popped and its children
    re-tested. Returns (tri, t, deepest stack), each per ray."""
    nodes = tables.nodes.numpy()
    refs = tables.nodes.view(torch.int32).numpy()[1::2, 2].astype(np.int64) & 0xFFFFFFFF
    tris = tables.tris.numpy().reshape(-1, 3, 4)
    ids = tables.tris.view(torch.int32).numpy().reshape(-1, 3, 4)[:, 0, 3]
    n = len(origins)
    out_tri = np.full(n, -1, np.int64)
    out_t = np.full(n, np.inf, F32)
    deepest = np.zeros(n, np.int64)
    with np.errstate(all="ignore"):
        for i in range(n):
            o, d = F32(origins[i]), F32(directions[i])
            inv = F32(1.0) / d
            inv = np.where(np.abs(inv) > F32(1e30), np.copysign(F32(np.inf), inv), inv)
            best = (F32(np.inf), -1)
            node, m, stack = 0, tables.root & 0xFF, []
            while m:
                rec = nodes[16 * node:16 * node + 16]
                keys = []
                for k in range(8):
                    t = _box_entry(rec, k, inv, o, best[0]) if m >> k & 1 else None
                    if t is not None:
                        keys.append((int(F32(t).view(np.uint32)) & ~7) | k)
                if keys:
                    j = min(keys) & 7
                    rest = sum(1 << (kk & 7) for kk in keys) & ~(1 << j)
                    if rest:
                        stack.append((node, rest))
                        deepest[i] = max(deepest[i], len(stack))
                    ref = int(refs[8 * node + j])
                    if not ref & LEAF:
                        node, m = ref >> 8, ref & 0xFF
                        continue
                    first, count = (ref & ~LEAF) >> 4, ref & 0xF
                    blk = tris[first:first + count]
                    ts = _mt(o, d, blk[:, 0, :3], blk[:, 1, :3], blk[:, 2, :3])
                    cands = [(t, int(tri)) for t, tri in zip(ts, ids[first:first + count])
                             if t < np.inf]
                    best = min([best] + cands)
                node, m = stack.pop() if stack else (0, 0)
            out_t[i], out_tri[i] = best
    return out_tri, out_t, deepest


def _axis_parallel(o, d):
    """Plant axis-parallel rays, some with origins on box planes (0 * inf
    slabs), as tests/test_torch_cuda.py does."""
    d[:16] = [1.0, 0.0, 0.0]
    d[16:24] = [0.0, -1.0, 0.0]
    o[:8, 1:] = 0.0
    return o, d


@pytest.fixture(scope="module")
def soup():
    rng_ = np.random.default_rng(5)
    scene = ps.build_scene(port_mesh(random_mesh(900, rng_)), ps.MaterialTable.default(),
                           ps.TextureAtlas.empty(), ps.Background.constant((0.7, 0.8, 1.0)),
                           ps.Camera.default(), device="cpu")
    o, d = aimed_rays(384, rng_)
    return scene, _axis_parallel(o, d)


@pytest.fixture(scope="module")
def standin():
    """The stand-in at 16 x 16 quads (514 triangles, depth 3, most of the
    tree empty), its 32 x 24 camera rays and the rays entering bounce 1."""
    scene = chip_smoke.procedural_scene(ps, np, torch, "cpu", n=16, tex=16)
    w, h = 32, 24
    px = torch.arange(w * h) % w
    py = torch.arange(w * h) // w
    jit = torch.full((w * h,), 0.5)
    o, d = camera.generate_rays(scene.camera, w, h, px, py, jit, jit)
    _, _, states, _ = chip_smoke.bounce_rays(integrator, scene, o, d, rng.prng_key(3), 2)
    return scene, (o, d), states[1]


def _np(v: Vec3) -> np.ndarray:
    return np.stack([v.x.numpy(), v.y.numpy(), v.z.numpy()], 1).astype(F32)


def _check_rewalk(scene, o, d, kernel):
    """The kernel's walk finds the oracle's (tri, t); its stack holds at
    most one entry per internal level (the thread kernel keeps the deepest
    in registers)."""
    tables = tc.k1_tables(scene.bvh, scene.triangles)
    walk = _rewalk if kernel == "thread" else _rewalk_wide
    tri, t, deepest = walk(tables, o, d)
    want = tc.bvh_traverse_plain(tvec(o), tvec(d), scene.triangles)
    np.testing.assert_array_equal(tri, want["tri"].numpy())
    np.testing.assert_array_equal(t, want["t"].numpy())
    assert deepest.max() <= scene.bvh.depth - (kernel == "thread")
    return tri


@pytest.mark.parametrize("kernel", ["thread", "wide"])
def test_rewalk_finds_the_bruteforce_hits_on_the_soup(soup, kernel):
    scene, (o, d) = soup
    tri = _check_rewalk(scene, o, d, kernel)
    assert 0.3 < (tri >= 0).mean() < 1.0


@pytest.mark.parametrize("kernel", ["thread", "wide"])
def test_rewalk_finds_the_bruteforce_hits_on_a_sah_tree(soup, kernel):
    """The same walks over the tables of the soup's SAH tree (the sweep's
    split positions, models/bvh.py) find the oracle's hits."""
    scene, (o, d) = soup
    mesh = port_mesh(random_mesh(900, np.random.default_rng(5)))
    sah = ps.build_scene(mesh, ps.MaterialTable.default(), ps.TextureAtlas.empty(),
                         ps.Background.constant((0.7, 0.8, 1.0)), ps.Camera.default(),
                         device="cpu", sah=True)
    assert not torch.equal(sah.bvh.nodes, scene.bvh.nodes)
    tri = _check_rewalk(sah, o, d, kernel)
    assert 0.3 < (tri >= 0).mean() < 1.0


@pytest.mark.parametrize("kernel", ["thread", "wide"])
@pytest.mark.parametrize("rays", ["camera", "bounce1"])
def test_rewalk_finds_the_bruteforce_hits_on_the_standin(standin, rays, kernel):
    scene, cam, bounce1 = standin
    o, d = cam if rays == "camera" else bounce1
    o, d = _np(o), _np(d)
    if rays == "bounce1":
        assert 100 < len(o) <= 32 * 24
        o, d = _axis_parallel(o, d)
    tri = _check_rewalk(scene, o, d, kernel)
    assert (tri >= 0).mean() > 0.2


@pytest.fixture(scope="module")
def far():
    """chip_smoke.far_soup: 900 triangles moved to 1e4, and rays that pass
    2e-4 inside a face of a leaf block's box."""
    return chip_smoke.far_soup(ps, np, "cpu")


@pytest.mark.parametrize("kernel", ["thread", "wide"])
def test_rewalk_finds_the_bruteforce_hits_far_from_the_origin(far, kernel):
    """Far from the scene's zero the slab test's rounding must stay
    relative to the ray's distance to the box: every grazing hit is
    found."""
    scene, o, d = far
    assert len(o) == 4 * int((scene.triangles.leaf_rows[:, :72] != 0).any(1).sum())
    tri = _check_rewalk(scene, o, d, kernel)
    assert (tri >= 0).mean() > 0.5


@pytest.mark.parametrize("which", ["soup", "standin"])
def test_tables_are_conservative_and_skip_empty_children(soup, standin, which):
    """Each child record's box (center +- half-extent) contains the exact
    child box grown to what the triangle test accepts (`accept_boxes`,
    itself holding the BVH's box) and exceeds it by a rounding at most,
    its reference names
    the right child with that child's occupancy, and exactly the children
    whose subtree holds a triangle are there, in their original order."""
    scene = soup[0] if which == "soup" else standin[0]
    bvh, tris = scene.bvh, scene.triangles
    tables = tc.k1_tables(bvh, tris)
    n_int = bvh.n_internal
    nodes = tables.nodes.numpy().reshape(n_int, 8, 8)
    refs = tables.nodes.view(torch.int32).numpy().reshape(n_int, 8, 8)[:, :, 6]
    refs = refs.astype(np.int64) & 0xFFFFFFFF
    built = bvh.nodes.numpy()[:, :48].reshape(n_int, 6, 8).transpose(0, 2, 1)
    box = tc.accept_boxes(bvh.nodes, tris.leaf_rows, n_int, bvh.depth).numpy()
    slots = tris.leaf_rows.numpy()[:, :72].reshape(-1, 9, 8).transpose(0, 2, 1)
    slot_occ = (slots != 0).any(-1)

    def subtree_has_triangles(c):
        if c >= n_int:
            return bool(slot_occ[c - n_int].any())
        return any(subtree_has_triangles(8 * c + 1 + j) for j in range(8))

    occ = np.array([[subtree_has_triangles(8 * e + 1 + j) for j in range(8)]
                    for e in range(n_int)])
    assert occ.sum() < occ.size  # the stand-in and the soup both pad
    first = np.concatenate([[0], np.cumsum(slot_occ.sum(1))])
    assert tables.root == (1 << int(occ[0].sum())) - 1
    for e in range(n_int):
        js = np.flatnonzero(occ[e])
        k = len(js)
        assert (nodes[e, k:] == 0).all()
        center = nodes[e, :k, 0:3].astype(np.float64)
        half = nodes[e, :k, 3:6].astype(np.float64)
        assert (half >= 0).all()
        assert (box[e, js, 0:3] <= built[e, js, 0:3]).all()
        assert (box[e, js, 3:6] >= built[e, js, 3:6]).all()
        assert (center - half <= box[e, js, 0:3]).all() and (center + half >= box[e, js, 3:6]).all()
        # and not by more than a rounding: the decoded box is the exact one
        np.testing.assert_allclose(center - half, box[e, js, 0:3], rtol=0, atol=1e-6)
        np.testing.assert_allclose(center + half, box[e, js, 3:6], rtol=0, atol=1e-6)
        for kk, j in enumerate(js):
            c, ref = 8 * e + 1 + j, int(refs[e, kk])
            if c >= n_int:
                b = c - n_int
                assert ref == LEAF | int(first[b]) << 4 | int(slot_occ[b].sum())
            else:
                assert ref == c << 8 | (1 << int(occ[c].sum())) - 1


@pytest.mark.parametrize("which", ["soup", "standin"])
def test_triangle_records_equal_leaf_rows(soup, standin, which):
    """The triangle table holds exactly the occupied slots, in slot order,
    each with its slot id and the leaf rows' v0, e1, e2 bit for bit."""
    scene = soup[0] if which == "soup" else standin[0]
    tables = tc.k1_tables(scene.bvh, scene.triangles)
    slots = scene.triangles.leaf_rows.numpy()[:, :72].reshape(-1, 9, 8).transpose(0, 2, 1)
    slots = slots.reshape(-1, 9)
    occ = np.flatnonzero((slots != 0).any(-1))
    rec = tables.tris.numpy().reshape(-1, 12)
    ids = tables.tris.view(torch.int32).numpy().reshape(-1, 12)[:, 3]
    np.testing.assert_array_equal(ids, occ)
    got = np.concatenate([rec[:, 0:3], rec[:, 4:7], rec[:, 8:11]], 1)
    np.testing.assert_array_equal(got.view(np.int32), slots[occ].view(np.int32))
    assert (rec[:, [7, 11]] == 0).all()
    assert len(occ) == scene.n_triangles


def test_tables_are_cached_and_rebuilt_on_new_rows(soup):
    scene = soup[0]
    bvh, tris = scene.bvh, scene.triangles
    first = tc.k1_tables(bvh, tris)
    assert tc.k1_tables(bvh, tris) is first
    bvh.nodes = bvh.nodes.clone()
    again = tc.k1_tables(bvh, tris)
    assert again is not first
    torch.testing.assert_close(again.nodes, first.nodes, rtol=0, atol=0)
    bvh.nodes.mul_(1.0)  # in place: a new version
    assert tc.k1_tables(bvh, tris) is not again


def test_depth_above_the_limit_raises(soup):
    """The 32-bit child references hold a node index below 2^23: depth 8
    is the deepest tree K1 takes."""
    scene = soup[0]
    assert tc.MAX_DEPTH == 8
    with pytest.raises(ValueError, match="depth 9"):
        tc.build_k1_tables(scene.bvh.nodes, scene.triangles.leaf_rows,
                           scene.bvh.n_internal, 9)
    # the deepest admitted tree's largest references still fit, one level
    # deeper they would not
    n_int = sum(8**i for i in range(tc.MAX_DEPTH))
    assert (n_int - 1) << 8 | 0xFF < tc.LEAF_BIT
    assert (8**(tc.MAX_DEPTH + 1) - 1) << 4 | 8 < tc.LEAF_BIT
    assert (8 * n_int) << 8 >= tc.LEAF_BIT


def test_empty_scene_has_an_empty_root():
    pos = np.zeros((1, 3, 3), F32)
    mesh = ps.HostMesh(pos, pos.copy(), np.zeros((1, 3, 2), F32), np.zeros(1, np.int32))
    scene = ps.build_scene(mesh, ps.MaterialTable.default(), ps.TextureAtlas.empty(),
                           ps.Background.constant((0.7, 0.8, 1.0)), ps.Camera.default(),
                           device="cpu")
    tables = tc.k1_tables(scene.bvh, scene.triangles)
    assert tables.root == 0 and tables.tris.shape == (0, 4)
