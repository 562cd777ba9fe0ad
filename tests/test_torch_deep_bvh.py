"""Trees deeper than the helmet's: a seeded room of 33,000 triangles (an
8-ary BVH of depth 5) and of 262,267 (depth 6, the Sponza stand-in's
count).

On the CPU: render() with NEE through the BVH path equals the brute-force
oracle's render bit for bit, `build_scene`'s `bvh` span carries the tree's
shape, and the NEE shadow test's tallies reach the `render` span. On the
card (marked `cuda`, skipped without a GPU; run it as tests/test_torch_cuda.py
is run, with --noconftest): both K1 kernels return the oracle's hits at
depths 5 and 6 on camera rays, on the rays entering bounce 1 and on the
shadow rays of bounces 0 and 1.
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from raytracing_c_tpu_torch.models import scene as ps
from raytracing_c_tpu_torch.ops import cuda_build, env_light
from raytracing_c_tpu_torch.ops import traverse_cuda as tc
from raytracing_c_tpu_torch.render import camera, integrator
from raytracing_c_tpu_torch.render.renderer import render
from raytracing_c_tpu_torch.utils import rng, spans
from raytracing_c_tpu_torch.utils.vec3 import Vec3


def _room(n: int, seed: int):
    """A closed 8 m x 4 m x 8 m room of 8 x 8-cell walls, floor and a
    ceiling with a 4 m x 4 m skylight (768 triangles less the skylight's
    cells), filled up to n triangles with seeded small triangles of four
    materials: (HostMesh, MaterialTable)."""
    r = np.random.default_rng(seed)
    tris, nrms = [], []

    def grid(p0, du, dv, keep=lambda i, j: True):
        p0, du, dv = (np.asarray(a, np.float64) for a in (p0, du, dv))
        n_hat = np.cross(du, dv)
        n_hat /= np.linalg.norm(n_hat)
        for i in range(8):
            for j in range(8):
                if not keep(i, j):
                    continue
                a = p0 + du * i / 8 + dv * j / 8
                b, c, d = a + du / 8, a + du / 8 + dv / 8, a + dv / 8
                tris.extend([(a, b, c), (a, c, d)])
                nrms.extend([n_hat, n_hat])

    grid((-4, 0, -4), (0, 0, 8), (8, 0, 0))  # floor, facing up
    grid((-4, 4, -4), (8, 0, 0), (0, 0, 8), lambda i, j: not (2 <= i <= 5 and 2 <= j <= 5))
    grid((-4, 0, -4), (8, 0, 0), (0, 4, 0))
    grid((-4, 0, 4), (0, 4, 0), (8, 0, 0))
    grid((-4, 0, -4), (0, 4, 0), (0, 0, 8))
    grid((4, 0, -4), (0, 0, 8), (0, 4, 0))
    walls = np.asarray(tris, np.float32)
    k = n - len(walls)
    soup = (r.uniform([-3.6, 0.2, -3.6], [3.6, 3.6, 3.6], (k, 1, 3))
            + r.normal(0, 0.04, (k, 3, 3))).astype(np.float32)
    pos = np.concatenate([walls, soup])
    ng = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    nrm = np.repeat(ng[:, None], 3, 1).astype(np.float32)
    uv = r.uniform(0, 1, (n, 3, 2)).astype(np.float32)
    mat = np.concatenate([np.zeros(len(walls), np.int32), r.integers(1, 4, k).astype(np.int32)])
    table = ps.MaterialTable.default(4)
    f = lambda *v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    table = ps.MaterialTable(
        base_color=table.base_color, emission=table.emission, roughness=f(0.8, 0.3, 0.6, 0.9),
        metalness=f(0.0, 1.0, 0.0, 0.0), normal_strength=table.normal_strength,
        sheen=f(0.0, 0.0, 0.0, 0.7), sheen_tint=f(0.0, 0.0, 0.0, 0.5),
        anisotropic=f(0.0, 0.4, 0.0, 0.0), tex_albedo=table.tex_albedo,
        tex_normal=table.tex_normal, tex_mr=table.tex_mr, tex_emission=table.tex_emission,
        shader_kind=table.shader_kind).with_rows()
    return ps.HostMesh(pos, nrm, uv, mat), table


def _room_scene(n: int, seed: int, device) -> ps.Scene:
    """The room under an equirect sky (env map of 64 x 32), a 60-degree
    camera inside it looking at a corner."""
    mesh, table = _room(n, seed)
    env = chip_smoke.make_env_map(64, 32, seed)
    eye, target = np.array([-3.0, 1.7, -3.0]), np.array([3.0, 2.2, 3.0])
    fwd = (target - eye) / np.linalg.norm(target - eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    view = np.eye(4, dtype=np.float32)
    view[:3, 0], view[:3, 1], view[:3, 2], view[:3, 3] = right, np.cross(right, fwd), -fwd, eye
    return ps.build_scene(mesh, table, ps.TextureAtlas.pack([env]), ps.Background.equirect(1),
                          ps.Camera.look(view, 60.0), device=device)


@functools.cache
def _cpu_room():
    return _room_scene(33_000, 3, "cpu")


def test_room_is_depth_5():
    scene = _cpu_room()
    assert scene.bvh.depth == 5 and scene.triangles.capacity == 8**6
    assert scene.n_triangles == 33_000


def test_render_nee_through_the_bvh_equals_the_oracle():
    """render(nee=True) at 16x16, 2 spp, 3 bounces through the BVH path
    (K1's plain walk on the CPU) gives the brute-force oracle's image and
    ray count, bit for bit."""
    scene = _cpu_room()
    kw = dict(spp=2, max_bounces=3, seed=2**31 + 5, nee=True)
    img, stats = render(scene, 16, 16, method="bvh", **kw)
    want, want_stats = render(scene, 16, 16, method="brute", **kw)
    np.testing.assert_array_equal(img, want)
    assert stats.rays_traced == want_stats.rays_traced > 16 * 16 * 2 * 2
    assert (img > 0).mean() > 0.2


def test_bvh_span_carries_the_tree_and_render_the_shadow_tallies():
    """build_scene's `bvh` span: triangles, depth, slots, occupied leaf
    blocks; render(nee=True)'s `render` span: the shadow rays launched and
    those occluded, read when it closes. With spans off neither appears."""
    mesh, table = _room(33_000, 3)
    spans.enable()
    try:
        scene = ps.build_scene(mesh, table, ps.TextureAtlas.empty(),
                               ps.Background.constant((0.6, 0.7, 0.9)), ps.Camera.default(),
                               device="cpu")
        recs = spans.collect()
        render(scene, 8, 8, spp=1, max_bounces=2, nee=True)
        frame = spans.collect()
    finally:
        spans.disable()
    bvh = [r for r in recs if r["name"] == "bvh"]
    assert len(bvh) == 1
    a = bvh[0]["attrs"]
    assert a == {"triangles": 33_000, "depth": 5, "slots": 8**6,
                 "blocks": a["blocks"]} and 33_000 / 8 <= a["blocks"] <= 8**5
    (rend,) = [r for r in frame if r["name"] == "render"]
    shadow = [r for r in frame if r["name"] == "intersect" and r["attrs"].get("kind") == "shadow"]
    assert sum(r["attrs"]["rays"] for r in shadow) == rend["attrs"]["shadow_rays"] > 0
    assert 0 < rend["attrs"]["shadow_occluded"] <= rend["attrs"]["shadow_rays"]
    assert isinstance(rend["attrs"]["shadow_occluded"], int)
    # spans off: nothing recorded, nothing tallied
    render(scene, 8, 8, spp=1, max_bounces=2, nee=True)
    assert spans.collect() == []


def _slack_scene(device):
    """A 10 m right triangle on y = 0 (slot order puts it among 200 small
    filler triangles), and rays straight down just outside its legs: 5e-4
    m outside is past the build's 1e-4 box padding but inside the test's
    barycentric slack (1e-4 of 10 m), so the oracle hits it there."""
    r = np.random.default_rng(6)
    big = np.array([[[0, 0, 0], [0, 0, 10], [10, 0, 0]]], np.float32)
    filler = (r.uniform([20, 1, 20], [30, 5, 30], (200, 1, 3))
              + r.normal(0, 0.1, (200, 3, 3))).astype(np.float32)
    pos = np.concatenate([filler[:100], big, filler[100:]])
    ng = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    ng /= np.linalg.norm(ng, axis=-1, keepdims=True)
    mesh = ps.HostMesh(pos, np.repeat(ng[:, None], 3, 1).astype(np.float32),
                       np.zeros((len(pos), 3, 2), np.float32), np.zeros(len(pos), np.int32))
    scene = ps.build_scene(mesh, ps.MaterialTable.default(), ps.TextureAtlas.empty(),
                           ps.Background.constant((0.5, 0.5, 0.5)), ps.Camera.default(),
                           device=device)
    z = np.linspace(0.5, 9.0, 64)
    x = np.concatenate([np.full(32, -5e-4), np.full(32, 3.0)])
    zz = np.concatenate([z[:32], np.full(32, -5e-4)])
    xx = np.concatenate([x[:32], np.linspace(0.5, 9.0, 32)])
    o = np.stack([xx, np.full(64, 2.0), zz], 1).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    down = torch.zeros(64, device=device)
    return scene, Vec3(t(o[:, 0]), t(o[:, 1]), t(o[:, 2])), Vec3(down, down - 1.0, down)


def test_walk_finds_hits_in_the_tests_slack():
    """K1's host walk (its plain version on the CPU) finds the oracle's
    hits just outside a large triangle's legs, where the test's
    barycentric slack reaches past the build's box padding."""
    scene, o, d = _slack_scene("cpu")
    got = tc.bvh_traverse(o, d, scene.triangles, scene.bvh)
    want = tc.bvh_traverse_plain(o, d, scene.triangles)
    assert (want["tri"] >= 0).all()
    for k in ("tri", "t", "u", "v"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


# --- the card ----------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.fixture(params=["bvh_traverse", "bvh_traverse_wide"])
def k1_kernel(request, monkeypatch):
    """Each K1 kernel in turn, whatever the launch's size (as in
    tests/test_torch_cuda.py)."""
    monkeypatch.setattr(tc, "WIDE_BELOW", 0 if request.param == "bvh_traverse" else 2**31)
    return request.param


@functools.cache
def _card_rays(n: int):
    """The room of n triangles on the card under its sky with the env
    light's table, and its ray sets: camera rays of a 96 x 64 frame, the
    rays entering bounce 1 and the NEE shadow rays of bounces 0 and 1, from
    trace_bucketed's own state."""
    dev = torch.device("cuda")
    scene = _room_scene(n, 4, dev)
    assert env_light.scene_env_light(scene) is not None
    w, h = 96, 64
    px = torch.arange(w * h, device=dev) % w
    py = torch.arange(w * h, device=dev) // w
    jit = torch.full((w * h,), 0.5, device=dev)
    o, d = camera.generate_rays(scene.camera, w, h, px, py, jit, jit)
    _, _, states, shadows = chip_smoke.bounce_rays(integrator, scene, o, d,
                                                   rng.prng_key(0, dev), 3, nee=True)
    rays = {"camera": (o, d), "bounce1": states[1], "shadow0": shadows[0],
            "shadow1": shadows[1]}
    want = {k: tc.bvh_traverse_plain(o_, d_, scene.triangles, fuse_attr=not k.startswith("s"))
            for k, (o_, d_) in rays.items()}
    return scene, rays, want


@pytest.mark.cuda
@pytest.mark.parametrize("n_tri,depth", [(33_000, 5), (262_267, 6)])
def test_k1_matches_the_oracle_on_a_deep_tree(cuda_device, k1_kernel, n_tri, depth):
    scene, rays, want = _card_rays(n_tri)
    assert scene.bvh.depth == depth
    for kind, (o, d) in rays.items():
        cuda_build.reset_launch_counts()
        shadow = kind.startswith("shadow")
        got = tc.bvh_traverse(o, d, scene.triangles, scene.bvh, fuse_attr=not shadow)
        torch.cuda.synchronize()
        assert cuda_build.launch_counts()[k1_kernel] == 1, kind
        for k in ("tri", "t", "u", "v") + (() if shadow else ("attrs",)):
            torch.testing.assert_close(got[k], want[kind][k], rtol=0, atol=0,
                                       msg=f"{kind} {k}")
        assert (got["tri"] >= 0).float().mean() > (0.2 if shadow else 0.5), kind


@pytest.mark.cuda
def test_k1_finds_hits_in_the_tests_slack(cuda_device, k1_kernel):
    """Both K1 kernels find the oracle's hits just outside a large
    triangle's legs (`_slack_scene`)."""
    scene, o, d = _slack_scene(cuda_device)
    got = tc.bvh_traverse(o, d, scene.triangles, scene.bvh, fuse_attr=True)
    want = tc.bvh_traverse_plain(o, d, scene.triangles, fuse_attr=True)
    torch.cuda.synchronize()
    assert (want["tri"] >= 0).all()
    for k in ("tri", "t", "u", "v", "attrs"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
