"""Traversal and hit attributes: the port against the JAX package, and the
CUDA kernels against their plain versions.

On the CPU the wrappers run the plain versions; they are held against the
JAX package's production path (`intersect_scene(method="pallas_fused")`,
the Pallas kernels in interpret mode) and its brute-force oracle on
random_mesh(900) with 1,024 rays. Tolerances: `tri` identical; t, u, v
and attribute planes within 1e-6 absolute / relative of the JAX brute
force and row gather (a float32 ulp or two of scheduling), and within 1e-4
of the Pallas kernel, whose staged Moller-Trumbore moves grazing hits by
more (traverse_pallas.py's module docstring: up to ~0.1% there).

The kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_c_tpu.ops import traverse as jtrav
from raytracing_c_tpu.ops import traverse_pallas as jtp
from raytracing_c_tpu.render import integrator as jint
from raytracing_c_tpu_torch.ops import cuda_build
from raytracing_c_tpu_torch.ops import traverse as ttrav
from raytracing_c_tpu_torch.ops import traverse_cuda as tc
from raytracing_c_tpu_torch.render import integrator as tint

from helpers import random_mesh, simple_scene
from torch_port_helpers import aimed_rays, jvec, np3, port_scene, tvec

TOL = dict(rtol=1e-6, atol=1e-6)
#: against the Pallas kernel (grazing-hit conditioning, see the docstring)
PALLAS_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def soup():
    rng = np.random.default_rng(21)
    js = simple_scene(random_mesh(900, rng), bg=(0.7, 0.8, 1.0))
    o, d = aimed_rays(1024, rng)
    d[:8] = [[1.0, 0.0, 0.0]] * 8  # axis-parallel rays: zero direction components
    return js, port_scene(js), o, d


@pytest.fixture(scope="module")
def jax_fused(soup):
    js, _, o, d = soup
    return jtrav.intersect_scene(js, jvec(o), jvec(d), method="pallas_fused")


def _assert_hits(want, got, tol=TOL):
    wt = np.asarray(want["t"])
    hit = np.isfinite(wt)
    np.testing.assert_array_equal(np.asarray(want["tri"]), got["tri"].numpy())
    np.testing.assert_allclose(wt, got["t"].numpy(), **tol)
    for k in ("u", "v"):
        np.testing.assert_allclose(np.asarray(want[k])[hit], got[k].numpy()[hit], **tol)
    return hit


def test_hits_match_jax_pallas_fused(soup, jax_fused):
    _, ts, o, d = soup
    got = ttrav.intersect_scene(ts, tvec(o), tvec(d), method="bvh", fuse_attr=True)
    hit = _assert_hits(jax_fused, got, PALLAS_TOL)
    assert 300 < hit.sum() < 1024


def test_hits_match_jax_bruteforce(soup):
    js, ts, o, d = soup
    want = jtrav.intersect_scene(js, jvec(o), jvec(d), method="brute")
    for method in ("bvh", "brute"):
        _assert_hits(want, ttrav.intersect_scene(ts, tvec(o), tvec(d), method=method))


def test_fused_attrs_match_jax(soup, jax_fused):
    """K1's fused attribute planes (plain version here) against the JAX
    Pallas epilogue, on hit lanes whose tier-0 winner the JAX repair tiers
    kept (`attrs_stale` lanes are refetched there, and are covered by the
    fetch_attrs test below; misses interpolate garbage u/v in JAX)."""
    _, ts, o, d = soup
    got = ttrav.intersect_scene(ts, tvec(o), tvec(d), method="bvh", fuse_attr=True)
    stale = np.asarray(jax_fused["attrs_stale"])
    assert stale.mean() < 0.1
    hit = np.isfinite(np.asarray(jax_fused["t"])) & ~stale
    want = np.asarray(jax_fused["attrs"])[:15]
    np.testing.assert_allclose(want[:, hit], got["attrs"].numpy()[:15, hit], **PALLAS_TOL)


def test_fetch_attrs_matches_jax_kernel_and_gather(soup, jax_fused):
    """K2's plain version against the JAX attribute kernel (interpret mode)
    and the JAX integrator's non-fused row gather."""
    js, ts, o, d = soup
    tri, u, v = jax_fused["tri"], jax_fused["u"], jax_fused["v"]
    hit = np.asarray(tri) >= 0
    got = tc.fetch_attrs(ts.triangles.attr_rows, torch.as_tensor(np.array(tri)),
                         torch.as_tensor(np.array(u)), torch.as_tensor(np.array(v)))
    got = tc.attrs_to_dict(got)
    want_k = jtp.fetch_attrs(js.ptables, tri, u, v)
    want_g = jint._gather_hit_geometry(
        js, jvec(o), jvec(d), {k: jax_fused[k] for k in ("t", "tri", "u", "v")}, "brute")
    for want in (want_k, want_g):
        for k in ("normal", "ng", "tangent", "bitangent"):
            np.testing.assert_allclose(np3(want[k])[hit], np3(got[k])[hit], err_msg=k, **TOL)
        for k in ("uv_u", "uv_v"):
            np.testing.assert_allclose(np.asarray(want[k])[hit], got[k].numpy()[hit], **TOL)
        np.testing.assert_array_equal(np.asarray(want["mat_id"])[hit], got["mat_id"].numpy()[hit])


def test_active_and_t_max(soup):
    """Inactive lanes and hits at or beyond t_max come back as misses
    (t = +inf, tri = -1, u = v = 0); the rest are unchanged."""
    _, ts, o, d = soup
    full = tc.bvh_traverse(tvec(o), tvec(d), ts.triangles, ts.bvh)
    active = torch.arange(1024) % 3 != 0
    t_max = torch.where(torch.arange(1024) % 2 == 0, full["t"], torch.tensor(float("inf")))
    part = tc.bvh_traverse(tvec(o), tvec(d), ts.triangles, ts.bvh, active=active, t_max=t_max)
    keep = active & (torch.arange(1024) % 2 == 1)
    for k in ("t", "u", "v", "tri"):
        np.testing.assert_array_equal(part[k][keep].numpy(), full[k][keep].numpy())
    gone = ~keep
    assert torch.isinf(part["t"][gone]).all() and (part["tri"][gone] == -1).all()
    assert (part["u"][gone] == 0).all() and (part["v"][gone] == 0).all()
    assert torch.isinf(part["dropped_min"]).all()


def test_launch_counters_stay_zero_on_cpu(soup):
    _, ts, o, d = soup
    cuda_build.reset_launch_counts()
    hit = ttrav.intersect_scene(ts, tvec(o), tvec(d), method="bvh", fuse_attr=True)
    tc.fetch_attrs(ts.triangles.attr_rows, hit["tri"], hit["u"], hit["v"])
    st = tint._initial_state(tvec(o), tvec(d))
    tint.bounce_step(ts, st, torch.rand(3, 1024), method="bvh")
    counts = cuda_build.launch_counts()
    assert {k: counts[k] for k in ("bvh_traverse", "bvh_traverse_wide", "fetch_attrs")} == \
        {"bvh_traverse": 0, "bvh_traverse_wide": 0, "fetch_attrs": 0}


def test_wrapper_rejects_other_devices(soup):
    _, ts, o, d = soup
    meta = tvec(o)
    meta = type(meta)(*(t.to("meta") for t in (meta.x, meta.y, meta.z)))
    with pytest.raises(ValueError):
        tc.bvh_traverse(meta, meta, ts.triangles, ts.bvh)


def test_k1_walk_finds_the_plain_hits(soup):
    """utils/bounds.k1_walk, whose test counts give K1's operation bound,
    re-walks the ordered nearest-first descent on the host: its nearest t
    equals the plain version's on every ray (exact), it tests only occupied
    children and slots, and it visits no more leaves than the tree holds."""
    from raytracing_c_tpu_torch.utils import bounds

    _, ts, o, d = soup
    bvh, tris = ts.bvh, ts.triangles
    walk = bounds.k1_walk(bvh.nodes.numpy(), tris.leaf_rows.numpy(), bvh.n_internal,
                          o[:256], d[:256])
    want = tc.bvh_traverse_plain(tvec(o[:256]), tvec(d[:256]), tris)
    np.testing.assert_array_equal(walk["t"], want["t"].numpy())
    assert (walk["node_visits"] >= 1).all()
    assert walk["leaf_visits"].max() <= tris.leaf_rows.shape[0]
    assert (walk["box_tests"] <= 8 * walk["node_visits"]).all()
    assert (walk["tri_tests"] <= 8 * walk["leaf_visits"]).all()
    # each triangle test at the cost of the step where it leaves: some
    # leave after u or v, none costs more than the full test
    assert (walk["tri_ops"] >= bounds.TRI_U_FAIL_OPS * walk["tri_tests"]).all()
    assert (walk["tri_ops"] <= bounds.TRI_TEST_OPS * walk["tri_tests"]).all()
    assert walk["tri_ops"].sum() < bounds.TRI_TEST_OPS * walk["tri_tests"].sum()
    # random_mesh(900) fills 113 of 512 leaf blocks: empty children skipped
    assert walk["box_tests"].sum() < 8 * walk["node_visits"].sum()


@pytest.mark.parametrize("epilogue", [True, False])
def test_k1_work_counts_the_walk(soup, epilogue):
    """utils/bounds.k1_work walks every ray when it has fewer than its
    sample; its operations follow the walk's box and triangle tests (exact
    up to float64 rounding); its bytes count each occupied child box and
    slot once, and the epilogue's attribute rows and 16 planes only with
    the epilogue."""
    from raytracing_c_tpu_torch.ops.traverse_cuda import occupancy
    from raytracing_c_tpu_torch.utils import bounds

    _, ts, o, d = soup
    work = bounds.k1_work(ts, tvec(o[:300]), tvec(d[:300]), epilogue=epilogue)
    walk = bounds.k1_walk(ts.bvh.nodes.numpy(), ts.triangles.leaf_rows.numpy(),
                          ts.bvh.n_internal, o[:300], d[:300])
    per_ray = (bounds.RAY_SETUP_OPS + walk["box_tests"].mean() * bounds.BOX_TEST_OPS
               + walk["tri_ops"].mean() + (bounds.EPILOGUE_OPS if epilogue else 0))
    assert work["sample"] == 300
    assert work["ops"] == pytest.approx(per_ray * 300, rel=1e-12)
    assert work["node_visits_per_ray"] == pytest.approx(walk["node_visits"].mean(), rel=1e-12)
    assert work["box_tests_per_ray"] == pytest.approx(walk["box_tests"].mean(), rel=1e-12)
    assert work["tri_ops_per_ray"] == pytest.approx(walk["tri_ops"].mean(), rel=1e-12)
    slot_occ, child_occ = occupancy(ts.triangles.leaf_rows, ts.bvh.n_internal, ts.bvh.depth)
    assert int(slot_occ.sum()) == 900
    tables = 4 * (6 * int(child_occ.sum()) + 9 * 900 + (25 * 900 if epilogue else 0))
    assert work["bytes"] == 300 * 4 * (13 + (16 if epilogue else 0)) + tables


@pytest.mark.parametrize("corners,want", [
    # u = x - y, v = y: a hit at (0.75, 0.25), u outside at (0.25, 0.75)
    (((0, 0, 0), (1, 0, 0), (1, 1, 0)), [52, 26]),
    # u = x, v = y - x: v outside at (0.75, 0.25), a hit at (0.25, 0.75)
    (((0, 0, 0), (1, 1, 0), (0, 1, 0)), [44, 52]),
])
def test_k1_walk_counts_a_triangle_test_where_it_leaves(corners, want):
    """One triangle, two rays down -z through its box: the test costs
    TRI_U_FAIL_OPS when u falls outside, TRI_V_FAIL_OPS when v or u + v
    does, TRI_TEST_OPS when it runs to t."""
    from raytracing_c_tpu_torch.models import scene as ps
    from raytracing_c_tpu_torch.utils import bounds

    assert (bounds.TRI_U_FAIL_OPS, bounds.TRI_V_FAIL_OPS, bounds.TRI_TEST_OPS) == (26, 44, 52)
    pos = np.array([corners], np.float32)
    mesh = ps.HostMesh(pos, np.tile(np.float32([0, 0, 1]), (1, 3, 1)),
                       np.zeros((1, 3, 2), np.float32), np.zeros(1, np.int32))
    scene = ps.build_scene(mesh, ps.MaterialTable.default(), ps.TextureAtlas.empty(),
                           ps.Background.constant((0.7, 0.8, 1.0)), ps.Camera.default(),
                           device="cpu")
    o = np.float32([[0.75, 0.25, 1.0], [0.25, 0.75, 1.0]])
    d = np.float32([[0, 0, -1]] * 2)
    walk = bounds.k1_walk(scene.bvh.nodes.numpy(), scene.triangles.leaf_rows.numpy(),
                          scene.bvh.n_internal, o, d)
    assert walk["tri_tests"].tolist() == [1, 1]
    assert walk["tri_ops"].tolist() == want
    assert np.isfinite(walk["t"]).tolist() == [w == 52 for w in want]


def _assert_same_hits(want, got):
    for k in ("t", "u", "v", "tri"):
        np.testing.assert_array_equal(want[k].numpy(), got[k].numpy(), err_msg=k)


@pytest.mark.parametrize("ray_chunk", [32768, 100])
def test_culled_walk_equals_the_oracle(soup, ray_chunk, monkeypatch):
    """intersect_bvh_culled, which the K1 wrapper's plain version runs on
    the CPU, gives the brute-force oracle's hits bit for bit: all rays
    (axis-parallel ones too), inactive lanes and t_max, over one chunk of
    rays or many."""
    monkeypatch.setattr(ttrav, "CULLED_RAY_CHUNK", ray_chunk)
    _, ts, o, d = soup
    tris, bvh = ts.triangles, ts.bvh
    want = ttrav.intersect_bruteforce_chunked(tvec(o), tvec(d), tris)
    got = ttrav.intersect_bvh_culled(tvec(o), tvec(d), tris, bvh)
    _assert_same_hits(want, got)
    assert got["tri"].dtype == torch.int32 and 0.3 < float((got["tri"] >= 0).float().mean())
    active = torch.arange(1024) % 3 != 0
    t_max = torch.where(torch.arange(1024) % 2 == 0, want["t"], torch.tensor(float("inf")))
    _assert_same_hits(
        ttrav.intersect_bruteforce_chunked(tvec(o), tvec(d), tris, active, t_max),
        ttrav.intersect_bvh_culled(tvec(o), tvec(d), tris, bvh, active, t_max))


def test_culled_walk_equals_the_oracle_on_the_standin():
    """The same on chip_smoke's helmet.glb stand-in (15,490 triangles, a
    depth-4 tree, a floor quad far larger than its triangles): camera rays
    through the image and random rays at the sphere."""
    import chip_smoke
    from raytracing_c_tpu_torch.models import scene as ps
    from raytracing_c_tpu_torch.render import camera
    from raytracing_c_tpu_torch.utils.vec3 import Vec3

    sc = chip_smoke.procedural_scene(ps, np, torch, "cpu", tex=16)
    rng = np.random.default_rng(5)
    px = torch.from_numpy(rng.integers(0, 256, 800).astype(np.int32))
    py = torch.from_numpy(rng.integers(0, 256, 800).astype(np.int32))
    jit = torch.from_numpy(rng.uniform(0, 1, (2, 800)).astype(np.float32))
    rays = [camera.generate_rays(sc.camera, 256, 256, px, py, jit[0], jit[1]),
            chip_smoke.random_rays(800, 2, "cpu", np, torch, Vec3)]
    for o, d in rays:
        want = ttrav.intersect_bruteforce_chunked(o, d, sc.triangles)
        _assert_same_hits(want, ttrav.intersect_bvh_culled(o, d, sc.triangles, sc.bvh))
        assert float((want["tri"] >= 0).float().mean()) > 0.3


def test_plain_k1_with_a_tree_equals_the_oracle(soup):
    """bvh_traverse_plain(..., bvh=) (the wrapper's CPU path) and without
    it (the oracle the card compares K1 with) return the same dict."""
    _, ts, o, d = soup
    want = tc.bvh_traverse_plain(tvec(o), tvec(d), ts.triangles, fuse_attr=True)
    got = tc.bvh_traverse_plain(tvec(o), tvec(d), ts.triangles, fuse_attr=True, bvh=ts.bvh)
    wrapped = tc.bvh_traverse(tvec(o), tvec(d), ts.triangles, ts.bvh, fuse_attr=True)
    assert set(got) == set(want) == set(wrapped)
    for k in want:
        np.testing.assert_array_equal(want[k].numpy(), got[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(want[k].numpy(), wrapped[k].numpy(), err_msg=k)
