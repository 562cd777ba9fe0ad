"""The port's lightmap baker (render/lightmap.py) against the JAX package's
and against the benchmark's plain reference (benchmark/reference/lightmap.py).

The port rasterizes every occupied triangle slot, in ascending slot order;
the JAX package reads the first n_triangles slots, which on a padded tree
hold only some of the triangles. So the port is held to the JAX package
on scenes where the two read the same triangles: "soup", 64 triangles
that fill their 8 leaf blocks, "quad" and "half_quad". The 100-triangle
"padded_soup" (28 of its triangles sit beyond slot 100) is held to a plain
per-triangle rasterization written here and to the plain reference; its
records below slot n are still the JAX package's, in its order.

Tolerances: the host rasterization is the same float64 arithmetic in the
same order (the port's in native C, native/raster.c, which
tests/test_torch_raster_native.py holds to its plain numpy version), so
texel ids, positions and normals are compared exactly. A bake draws the same
threefry streams; its Gaussian directions go through erfinv, whose
float32 result may differ from XLA's by 2 ulps (tests/test_torch_rng.py),
and through the path integrator, so texels agree with the JAX package
within rtol/atol 1e-4 (measured 1.2e-7 on these scenes). The plain
reference runs the port's plain PyTorch arithmetic, so it agrees bit for
bit.
"""

import os
import sys

import numpy as np
import pytest
import torch

from raytracing_c_tpu.render import lightmap as jlm
from raytracing_c_tpu_torch.models import scene as ps
from raytracing_c_tpu_torch.render import lightmap as tlm
from raytracing_c_tpu_torch.utils import spans

from helpers import quad_mesh, random_mesh, simple_scene
from torch_port_helpers import port_scene

BAKE_TOL = dict(rtol=1e-4, atol=1e-4)
BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")


def _scenes():
    half = quad_mesh()
    half.uvs = half.uvs * 0.5  # the quad covers the lower-left UV quadrant only
    return {"soup": simple_scene(random_mesh(64, np.random.default_rng(5)), bg=(0.9, 0.8, 0.7)),
            "padded_soup": simple_scene(random_mesh(100, np.random.default_rng(5)),
                                        bg=(0.9, 0.8, 0.7)),
            "quad": simple_scene(quad_mesh(), bg=(1.0, 1.0, 1.0)),
            "half_quad": simple_scene(half, bg=(1.0, 1.0, 1.0))}


@pytest.fixture(scope="module")
def scenes():
    return {k: (js, port_scene(js)) for k, js in _scenes().items()}


def _occupied(ts):
    return np.flatnonzero(ts.triangles.mat_id.numpy() >= 0)


@pytest.mark.parametrize("name,w,h", [("soup", 24, 16), ("quad", 16, 16), ("half_quad", 16, 16),
                                      ("soup", 1, 1)])
def test_rasterize_identical(scenes, name, w, h):
    js, ts = scenes[name]
    assert (_occupied(ts) == np.arange(ts.n_triangles)).all()  # no padding ahead of slot n
    want = jlm._rasterize_host(js, w, h)
    got = tlm.rasterize(ts, w, h)
    for a, b in zip(want, (got.index, got.position, got.normal)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["soup", "quad"])
def test_bake_matches_jax(scenes, name):
    """The soup's 1,458 texel records bake in two batches of 729 (one
    shape, so the JAX package compiles its trace once); the quad's 256 in
    three."""
    js, ts = scenes[name]
    kw = dict(samples=4, max_bounces=2, seed=3, batch_texels=729 if name == "soup" else 100)
    want = jlm.bake_lightmap(js, 16, 16, **kw)
    stats = {}
    got = tlm.bake_lightmap(ts, 16, 16, stats=stats, **kw)
    assert got.shape == (16, 16, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **BAKE_TOL)
    covered = (want != 0).any(-1).sum()
    assert covered > 20 and stats["texels"] >= covered and stats["rays"] >= stats["texels"] * 4
    assert stats["covered"] == covered and stats["triangles"] == ts.n_triangles


def test_texels_outside_the_uvs_stay_zero(scenes):
    js, ts = scenes["half_quad"]
    lm = tlm.bake_lightmap(ts, 16, 16, samples=4, max_bounces=2, seed=0)
    assert (lm[9:, :] == 0).all() and (lm[:, 9:] == 0).all()
    assert (lm[:8, :8] > 0).mean() > 0.9
    np.testing.assert_allclose(lm, jlm.bake_lightmap(js, 16, 16, samples=4, max_bounces=2,
                                                     seed=0), **BAKE_TOL)


def _plain_rasterize(ts, w, h, uv_of_slot=None):
    """Triangle by triangle in ascending slot order, texel by texel in
    its UV box, row by row: (texel id, slot) of each record."""
    tr = ts.triangles
    n = lambda a: a.numpy().astype(np.float64)  # noqa: E731
    out = []
    for s in _occupied(ts):
        if uv_of_slot is None:
            uv = np.array([[n(tr.uv0u)[s], n(tr.uv0v)[s]], [n(tr.uv1u)[s], n(tr.uv1v)[s]],
                           [n(tr.uv2u)[s], n(tr.uv2v)[s]]])
        else:
            uv = uv_of_slot[s].astype(np.float64)
        a, b, c = uv * [w, h]
        den = (b[1] - c[1]) * (a[0] - c[0]) + (c[0] - b[0]) * (a[1] - c[1])
        if abs(den) < 1e-20:
            continue
        for y in range(max(int(min(a[1], b[1], c[1])), 0),
                       min(int(max(a[1], b[1], c[1])), h - 1) + 1):
            for x in range(max(int(min(a[0], b[0], c[0])), 0),
                           min(int(max(a[0], b[0], c[0])), w - 1) + 1):
                w0 = ((b[1] - c[1]) * (x - c[0]) + (c[0] - b[0]) * (y - c[1])) / den
                w1 = ((c[1] - a[1]) * (x - c[0]) + (a[0] - c[0]) * (y - c[1])) / den
                if min(w0, w1, 1.0 - w0 - w1) >= -1e-4:
                    out.append((x + y * w, s))
    return np.array(out, np.int64).reshape(-1, 2)


@pytest.mark.parametrize("w,h", [(24, 16), (16, 16), (7, 5)])
def test_padded_scene_rasterizes_every_occupied_slot(scenes, w, h):
    """The padded soup's records are the plain per-triangle rasterization's,
    in its order, and its 28 triangles beyond slot n write texels too."""
    _, ts = scenes["padded_soup"]
    occ = _occupied(ts)
    assert len(occ) == 100 and (occ >= ts.n_triangles).sum() == 28
    got = tlm.rasterize(ts, w, h)
    want = _plain_rasterize(ts, w, h)
    np.testing.assert_array_equal(got.index, want[:, 0])
    np.testing.assert_array_equal(got.slot, want[:, 1])
    assert len(np.unique(got.slot[got.slot >= ts.n_triangles])) >= 20
    assert got.triangles == 100 and got.covered == len(np.unique(want[:, 0]))
    assert got.overwritten == int((np.bincount(want[:, 0]) > 1).sum())


def test_records_below_slot_n_are_the_jax_packages(scenes):
    """What the JAX package reads of a padded tree (the first n slots) is
    the port's records of the slots below n, in the same order."""
    js, ts = scenes["padded_soup"]
    want = jlm._rasterize_host(js, 24, 16)
    got = tlm.rasterize(ts, 24, 16)
    below = got.select(got.slot < ts.n_triangles)
    assert len(below) < len(got)
    for a, b in zip(want, (below.index, below.position, below.normal)):
        np.testing.assert_array_equal(a, b)


def _lightmap_scene(mesh, env):
    """mesh on the CPU under the equirect env map, one grey material."""
    table = ps.MaterialTable.default(1)
    return ps.build_scene(mesh, table, ps.TextureAtlas.pack([env]), ps.Background.equirect(1),
                          ps.Camera.default(), device="cpu")


def _soup(n, seed, lightmap_uvs):
    j = random_mesh(n, np.random.default_rng(seed))
    rnd = np.random.default_rng(seed + 1)
    lm = rnd.uniform(0.0, 1.0, j.uvs.shape).astype(np.float32) if lightmap_uvs else None
    env = rnd.integers(0, 256, (16, 32, 3), dtype=np.uint8)
    return ps.HostMesh(j.positions, j.normals, j.uvs, j.mat_id, lightmap_uvs=lm), env


def test_lightmap_uvs_are_rasterized_when_present():
    """A scene with a lightmap UV set rasterizes it, in slot order, in place
    of the texture UVs; the same triangles with those UVs as their texture
    UVs give the same records."""
    mesh, env = _soup(100, 9, lightmap_uvs=True)
    scene = _lightmap_scene(mesh, env)
    assert scene.lightmap_uvs.shape == (scene.triangles.capacity, 3, 2)
    got = tlm.rasterize(scene, 24, 16)
    want = _plain_rasterize(scene, 24, 16, uv_of_slot=scene.lightmap_uvs)
    np.testing.assert_array_equal(got.index, want[:, 0])
    np.testing.assert_array_equal(got.slot, want[:, 1])
    swapped = _lightmap_scene(ps.HostMesh(mesh.positions, mesh.normals, mesh.lightmap_uvs,
                                          mesh.mat_id), env)
    assert swapped.lightmap_uvs is None
    plain = tlm.rasterize(swapped, 24, 16)
    for a, b in ((got.index, plain.index), (got.position, plain.position),
                 (got.normal, plain.normal)):
        np.testing.assert_array_equal(a, b)
    texture = tlm.rasterize(_lightmap_scene(ps.HostMesh(mesh.positions, mesh.normals, mesh.uvs,
                                                        mesh.mat_id), env), 24, 16)
    assert not np.array_equal(texture.index, got.index)


def _reference():
    if BENCH not in sys.path:
        sys.path.append(BENCH)
    from reference import lightmap as rlm
    from reference import scene as ref_scene

    return rlm, ref_scene


@pytest.mark.parametrize("seed,lightmap_uvs,size,samples,bounces,batch", [
    (5, False, (24, 16), 4, 3, 300), (2**31 + 7, True, (32, 32), 2, 4, 512),
    (4_000_000_007, True, (16, 24), 3, 2, 200)])
def test_bake_of_a_padded_scene_equals_the_plain_reference(seed, lightmap_uvs, size, samples,
                                                           bounces, batch):
    """The bake of a 100-triangle soup (28 triangles beyond slot n) under a
    seeded env map equals benchmark/reference/lightmap.py, its own
    rasterization on the benchmark's own tree, at every texel the map
    keeps, bit for bit."""
    rlm, ref_scene = _reference()
    mesh, env = _soup(100, seed % 1000, lightmap_uvs)
    scene = _lightmap_scene(mesh, env)
    w, h = size
    kw = dict(samples=samples, max_bounces=bounces, batch_texels=batch)
    got = tlm.bake_lightmap(scene, w, h, seed=seed % 2**32, **kw).reshape(-1, 3)
    slot_map = rlm.slot_map(mesh.positions)
    uvs = mesh.lightmap_uvs if lightmap_uvs else mesh.uvs
    texels = rlm.rasterize(mesh.positions, mesh.normals, uvs, slot_map[slot_map >= 0], w, h)
    grey = dict(base_color=(0.8, 0.8, 0.8), emission=(0.0, 0.0, 0.0), roughness=0.5,
                metalness=0.0, normal_strength=0.0, sheen=0.0, sheen_tint=0.0, anisotropic=0.0,
                tex_albedo=-1, tex_normal=-1, tex_mr=-1, tex_emission=-1)
    rs = ref_scene.build({"positions": mesh.positions, "normals": mesh.normals, "uvs": mesh.uvs,
                          "mat_id": mesh.mat_id}, [grey], [env], 1, np.eye(4, dtype=np.float32),
                         np.float32(1.0), "cpu", torch.float32)
    n_batches = -(-len(texels["index"]) // batch)
    out = rlm.bake_batches(rs, texels, seed % 2**32, range(n_batches), **kw)
    last = rlm.last_writes(texels["index"])
    compared = 0
    for b, (index, values) in out.items():
        keep = last[b * batch:b * batch + len(index)]
        np.testing.assert_array_equal(got[index[keep]], values[keep].astype(np.float32))
        compared += int(keep.sum())
    assert compared == len(np.unique(texels["index"])) and (got != 0).any(-1).sum() > compared // 2


def test_a_group_of_batches_bakes_what_the_whole_bake_does(scenes):
    """bake_batches over all batches is bake_lightmap; over batches 2-3
    alone it writes, at their texels, what batches 0-3 write there."""
    from raytracing_c_tpu_torch.utils import rng

    _, ts = scenes["padded_soup"]
    kw = dict(samples=3, max_bounces=2, batch_texels=150, method="auto")
    texels = tlm.rasterize(ts, 24, 16)
    key = rng.prng_key(11)
    whole = np.zeros((24 * 16, 3), np.float32)
    tlm.bake_batches(ts, texels, whole, key, range(-(-len(texels) // 150)), **kw)
    np.testing.assert_array_equal(whole.reshape(16, 24, 3),
                                  tlm.bake_lightmap(ts, 24, 16, seed=11, samples=3,
                                                    max_bounces=2, batch_texels=150))
    first = np.zeros_like(whole)
    tlm.bake_batches(ts, texels, first, key, range(4), **kw)
    part = np.zeros_like(whole)
    rays = tlm.bake_batches(ts, texels, part, key, range(2, 4), **kw)
    at = np.unique(texels.index[300:600])
    np.testing.assert_array_equal(part[at], first[at])
    assert (part[at] != 0).any(-1).mean() > 0.5 and int(rays) >= 300 * 3
    assert (part[np.setdiff1d(np.arange(24 * 16), at)] == 0).all()


def test_bake_spans_and_their_counters(scenes):
    """The `bake` span holds `rasterize` and one `batch` span a texel batch,
    each batch its `rng`, `raygen`, the tracer's `bounce` spans and
    `readback`; the counters are the bake's stats."""
    _, ts = scenes["padded_soup"]
    stats = {}
    spans.enable()
    try:
        tlm.bake_lightmap(ts, 24, 16, samples=2, max_bounces=2, seed=1, batch_texels=1000,
                          stats=stats)
        recs = spans.collect()
    finally:
        spans.disable()
    bake = [r for r in recs if r["name"] == "bake"]
    assert len(bake) == 1
    assert bake[0]["attrs"] == dict(width=24, height=16, samples=2, triangles=100,
                                    texels=stats["covered"], batches=stats["batches"],
                                    rays=stats["rays"])
    ras = [r for r in recs if r["name"] == "rasterize"][0]
    assert ras["parent"] == bake[0]["id"] and ras["attrs"]["texels"] == stats["covered"]
    assert ras["attrs"]["candidates"] >= stats["texels"] > ras["attrs"]["overwritten"] > 0
    batches = [r for r in recs if r["name"] == "batch"]
    assert len(batches) == stats["batches"] == 3
    assert sum(r["attrs"]["texels"] for r in batches) == stats["texels"]
    assert sum(r["attrs"]["rays"] for r in batches) == stats["rays"]
    for r in batches:
        inside = {x["name"] for x in recs if x["parent"] == r["id"]}
        assert {"rng", "raygen", "bounce", "readback"} <= inside
        assert all(x["batch"] == r["batch"] for x in recs if x["parent"] == r["id"])
