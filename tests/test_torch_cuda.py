"""The CUDA kernels (K1, K2, K3, K4, K5) on the card against their plain
PyTorch versions, K1 also on the NEE shadow rays and under render(nee=True).

Every test here is marked `cuda` and skips where there is no GPU. The file
imports neither jax nor the JAX package, so it also runs on a machine with
only PyTorch; tests/conftest.py imports jax, so run it there without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: none. The kernels are built with --fmad=false and repeat the
plain versions' operation order, so hits and attribute planes are
bit-equal to the plain versions run on the same card; so are K3's u8
pixels (it sums the luminances in the plain version's order) and every
plane of K4's bounce against the integrator's plain tail (`_tail_plain`)
on the same lanes; so is every word K5 draws against utils/rng.py's plain
int64 threefry on CPU copies of the same keys. The K1 tests run each of
its two kernels (`k1_kernel`).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from raytracing_c_tpu_torch.models import scene as ps
from raytracing_c_tpu_torch.ops import denoise as dn
from raytracing_c_tpu_torch.ops import env_light
from raytracing_c_tpu_torch.ops import rng_cuda as rc
from raytracing_c_tpu_torch.ops import shade_cuda as sc
from raytracing_c_tpu_torch.ops import traverse_cuda as tc
from raytracing_c_tpu_torch.render import camera, integrator
from raytracing_c_tpu_torch.render.renderer import render
from raytracing_c_tpu_torch.utils import rng
from raytracing_c_tpu_torch.utils.vec3 import Vec3

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.fixture(params=["bvh_traverse", "bvh_traverse_wide"])
def k1_kernel(request, monkeypatch):
    """Each K1 kernel in turn, whatever the launch's size: WIDE_BELOW at 0
    keeps every launch on one thread per ray, at 2^31 on eight lanes."""
    monkeypatch.setattr(tc, "WIDE_BELOW", 0 if request.param == "bvh_traverse" else 2**31)
    return request.param


def _soup_scene(n: int, seed: int, device, sah: bool = False) -> ps.Scene:
    """Random triangle soup in [-1, 1]^3 (the shape of tests/helpers.random_mesh),
    its BVH built by the midpoint splitter or, with sah, the SAH sweep."""
    rng = np.random.default_rng(seed)
    pos = (rng.uniform(-1, 1, (n, 1, 3)) + rng.normal(0, 0.12, (n, 3, 3))).astype(np.float32)
    ng = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    mesh = ps.HostMesh(pos, np.repeat(ng[:, None], 3, 1).astype(np.float32),
                       rng.uniform(0, 1, (n, 3, 2)).astype(np.float32),
                       np.zeros(n, np.int32))
    return ps.build_scene(mesh, ps.MaterialTable.default(), ps.TextureAtlas.empty(),
                          ps.Background.constant((0.7, 0.8, 1.0)), ps.Camera.default(),
                          device=device, sah=sah)


def _rays(n: int, seed: int, device):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:64] = [1.0, 0.0, 0.0]  # axis-parallel: 0 * inf slabs
    o[:32, 1:] = 0.0  # ... with the origin on box planes too
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return Vec3(t(o[:, 0]), t(o[:, 1]), t(o[:, 2])), Vec3(t(d[:, 0]), t(d[:, 1]), t(d[:, 2]))


@pytest.mark.parametrize("n_tri,depth", [(900, 3), (15452, 4), (33000, 5)])
def test_kernels_match_plain(cuda_device, k1_kernel, n_tri, depth):
    ts = _soup_scene(n_tri, 8, cuda_device)
    assert ts.bvh.depth == depth
    o, d = _rays(4096, 9, cuda_device)
    tc.reset_launch_counts()
    got = tc.bvh_traverse(o, d, ts.triangles, ts.bvh, fuse_attr=True)
    bare = tc.bvh_traverse(o, d, ts.triangles, ts.bvh)
    want = tc.bvh_traverse_plain(o, d, ts.triangles, fuse_attr=True)
    torch.cuda.synchronize()
    assert tc.launch_counts()[k1_kernel] == 2
    for k in ("tri", "t", "u", "v", "attrs"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    for k in ("tri", "t", "u", "v"):
        torch.testing.assert_close(bare[k], want[k], rtol=0, atol=0, msg=k)
    assert torch.isinf(got["dropped_min"]).all()
    assert (got["tri"] >= 0).float().mean() > 0.3
    attrs = tc.fetch_attrs(ts.triangles.attr_rows, got["tri"], got["u"], got["v"])
    torch.testing.assert_close(attrs, want["attrs"], rtol=0, atol=0)
    assert tc.launch_counts()["fetch_attrs"] == 1


def test_sah_tree_matches_plain(cuda_device, k1_kernel):
    """K1 over the tables of a SAH tree (models/bvh.py, sah=True) finds the
    oracle's hits, with and without its epilogue."""
    ts = _soup_scene(15452, 8, cuda_device, sah=True)
    assert not torch.equal(ts.bvh.nodes, _soup_scene(15452, 8, cuda_device).bvh.nodes)
    o, d = _rays(4096, 9, cuda_device)
    got = tc.bvh_traverse(o, d, ts.triangles, ts.bvh, fuse_attr=True)
    bare = tc.bvh_traverse(o, d, ts.triangles, ts.bvh)
    want = tc.bvh_traverse_plain(o, d, ts.triangles, fuse_attr=True)
    torch.cuda.synchronize()
    for k in ("tri", "t", "u", "v", "attrs"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    for k in ("tri", "t", "u", "v"):
        torch.testing.assert_close(bare[k], want[k], rtol=0, atol=0, msg=k)
    assert (got["tri"] >= 0).float().mean() > 0.3


def test_kernels_on_another_card_than_the_current_one(cuda_device, k1_kernel):
    """K1, K2 and K3 on tensors on the last card while card 0 is current:
    each launches on its tensors' card and matches its plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    ts = _soup_scene(900, 8, last)
    o, d = _rays(4096, 9, last)
    got = tc.bvh_traverse(o, d, ts.triangles, ts.bvh, fuse_attr=True)
    want = tc.bvh_traverse_plain(o, d, ts.triangles, fuse_attr=True)
    attrs = tc.fetch_attrs(ts.triangles.attr_rows, got["tri"], got["u"], got["v"])
    img = torch.from_numpy(chip_smoke.firefly_image(np, 67, 131)[0]).to(last)
    den = dn.denoise_u8(img)
    torch.cuda.synchronize(last)
    assert torch.cuda.current_device() == 0
    for k in ("tri", "t", "u", "v", "attrs"):
        assert got[k].device == last
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    torch.testing.assert_close(attrs, want["attrs"], rtol=0, atol=0)
    torch.testing.assert_close(den, dn.denoise_u8_plain(img), rtol=0, atol=0)
    assert (got["tri"] >= 0).float().mean() > 0.3


def test_far_from_the_origin_matches_plain(cuda_device, k1_kernel):
    """A soup moved to 1e4 and rays that graze its leaf boxes
    (chip_smoke.far_soup): the slab test's rounding grows with the ray's
    distance to the box, not with |o|, so K1 finds every hit."""
    scene, o, d = chip_smoke.far_soup(ps, np, cuda_device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)  # noqa: E731
    o = Vec3(t(o[:, 0]), t(o[:, 1]), t(o[:, 2]))
    d = Vec3(t(d[:, 0]), t(d[:, 1]), t(d[:, 2]))
    tc.reset_launch_counts()
    got = tc.bvh_traverse(o, d, scene.triangles, scene.bvh, fuse_attr=True)
    want = tc.bvh_traverse_plain(o, d, scene.triangles, fuse_attr=True)
    torch.cuda.synchronize()
    assert tc.launch_counts()[k1_kernel] == 1
    for k in ("tri", "t", "u", "v", "attrs"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    assert (got["tri"] >= 0).float().mean() > 0.5


def test_bounce1_rays_match_plain(cuda_device, k1_kernel):
    """The live rays entering bounce 1 of a stand-in render (incoherent
    secondary rays, trace_bucketed's own compacted state): K1 with and
    without its epilogue equals the oracle."""
    scene = chip_smoke.procedural_scene(ps, np, torch, cuda_device, n=40, tex=64)
    w, h = 96, 64
    px = torch.arange(w * h, device=cuda_device) % w
    py = torch.arange(w * h, device=cuda_device) // w
    jit = torch.full((w * h,), 0.5, device=cuda_device)
    o, d = camera.generate_rays(scene.camera, w, h, px, py, jit, jit)
    _, _, states, _ = chip_smoke.bounce_rays(integrator, scene, o, d,
                                             rng.prng_key(0, cuda_device), 2)
    o1, d1 = states[1]
    assert 1000 < o1.shape[0] < w * h
    got = tc.bvh_traverse(o1, d1, scene.triangles, scene.bvh, fuse_attr=True)
    bare = tc.bvh_traverse(o1, d1, scene.triangles, scene.bvh)
    want = tc.bvh_traverse_plain(o1, d1, scene.triangles, fuse_attr=True)
    torch.cuda.synchronize()
    for k in ("tri", "t", "u", "v", "attrs"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    for k in ("tri", "t", "u", "v"):
        torch.testing.assert_close(bare[k], want[k], rtol=0, atol=0, msg=k)
    assert (got["tri"] >= 0).float().mean() > 0.2


def test_shadow_rays_match_plain(cuda_device, k1_kernel):
    """The NEE shadow rays of bounces 0 and 1 of a stand-in render under an
    equirect env map (incoherent, mostly unoccluded, from
    trace_bucketed's own state): K1 bare equals the oracle."""
    scene = chip_smoke.procedural_scene(ps, np, torch, cuda_device, n=40, tex=64)
    scene = chip_smoke.with_env_map(ps, torch, scene, chip_smoke.make_env_map(128, 64))
    assert env_light.scene_env_light(scene) is not None
    w, h = 96, 64
    px = torch.arange(w * h, device=cuda_device) % w
    py = torch.arange(w * h, device=cuda_device) // w
    jit = torch.full((w * h,), 0.5, device=cuda_device)
    o, d = camera.generate_rays(scene.camera, w, h, px, py, jit, jit)
    _, _, _, shadows = chip_smoke.bounce_rays(integrator, scene, o, d,
                                              rng.prng_key(0, cuda_device), 3, nee=True)
    assert len(shadows) >= 2 and shadows[0][0].shape[0] > 1000
    for so, sd in shadows[:2]:
        tc.reset_launch_counts()
        got = tc.bvh_traverse(so, sd, scene.triangles, scene.bvh)
        want = tc.bvh_traverse_plain(so, sd, scene.triangles)
        torch.cuda.synchronize()
        assert tc.launch_counts()[k1_kernel] == 1
        for k in ("tri", "t", "u", "v"):
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_render_nee_kernel_path_matches_brute(cuda_device, k1_kernel):
    """render(nee=True) through the kernels equals it through the
    brute-force oracle, under an env map and under a constant sky; the
    shadow rays add K1 launches."""
    ts = _soup_scene(2000, 6, cuda_device)
    for scene in (ts, chip_smoke.with_env_map(ps, torch, ts, chip_smoke.make_env_map(64, 32))):
        kw = dict(spp=2, max_bounces=4, seed=1, nee=True)
        tc.reset_launch_counts()
        img_k, st_k = render(scene, 48, 40, method="bvh", **kw)
        with_nee = tc.launch_counts()[k1_kernel]
        img_b, st_b = render(scene, 48, 40, method="brute", **kw)
        tc.reset_launch_counts()
        render(scene, 48, 40, method="bvh", **{**kw, "nee": False})
        assert with_nee > tc.launch_counts()[k1_kernel]
        np.testing.assert_array_equal(img_k, img_b)
        assert st_k.rays_traced == st_b.rays_traced


def test_depth_above_the_table_limit_raises(cuda_device):
    """K1's child references admit trees of depth <= 8: a deeper BVH raises
    before any launch."""
    ts = _soup_scene(100, 1, cuda_device)
    o, d = _rays(64, 2, cuda_device)
    before = tc.launch_counts()
    deep = ps.BVH(nodes=ts.bvh.nodes, depth=tc.MAX_DEPTH + 1,
                  last_row_offset=ts.bvh.last_row_offset)
    with pytest.raises(ValueError, match="depth 9"):
        tc.bvh_traverse(o, d, ts.triangles, deep)
    assert tc.launch_counts() == before


def test_launch_size_picks_the_kernel(cuda_device):
    """Fewer than WIDE_BELOW rays run eight lanes per ray, WIDE_BELOW or
    more one thread per ray; both give the oracle's hits."""
    ts = _soup_scene(900, 3, cuda_device)
    o, d = _rays(tc.WIDE_BELOW, 5, cuda_device)
    want = tc.bvh_traverse_plain(o, d, ts.triangles)
    for r, kernel in ((tc.WIDE_BELOW - 1, "bvh_traverse_wide"), (tc.WIDE_BELOW, "bvh_traverse")):
        part = Vec3(o.x[:r], o.y[:r], o.z[:r]), Vec3(d.x[:r], d.y[:r], d.z[:r])
        tc.reset_launch_counts()
        got = tc.bvh_traverse(*part, ts.triangles, ts.bvh)
        assert tc.launch_counts() == {"bvh_traverse": 0, "bvh_traverse_wide": 0,
                                      "fetch_attrs": 0, kernel: 1}
        torch.testing.assert_close(got["tri"], want["tri"][:r], rtol=0, atol=0)
        torch.testing.assert_close(got["t"], want["t"][:r], rtol=0, atol=0)


def test_active_and_t_max(cuda_device, k1_kernel):
    ts = _soup_scene(900, 3, cuda_device)
    o, d = _rays(2048, 4, cuda_device)
    i = torch.arange(2048, device=cuda_device)
    active = i % 3 != 0
    t_max = torch.where(i % 2 == 0, torch.full_like(o.x, 1.5), torch.full_like(o.x, float("inf")))
    got = tc.bvh_traverse(o, d, ts.triangles, ts.bvh, active=active, t_max=t_max)
    want = tc.bvh_traverse_plain(o, d, ts.triangles, active=active, t_max=t_max)
    for k in ("tri", "t", "u", "v"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_bad_tables_raise(cuda_device):
    ts = _soup_scene(100, 1, cuda_device)
    o, d = _rays(64, 2, cuda_device)
    ts.bvh.nodes = ts.bvh.nodes.double()
    with pytest.raises(ValueError):
        tc.bvh_traverse(o, d, ts.triangles, ts.bvh)


def test_render_kernel_path_matches_brute(cuda_device, k1_kernel):
    """render() through the kernels equals render() through the brute-force
    oracle, and the main path launched K1 (each of its kernels in turn) and
    K2."""
    ts = _soup_scene(2000, 6, cuda_device)
    tc.reset_launch_counts()
    img_k, st_k = render(ts, 48, 40, spp=2, max_bounces=4, seed=1, method="bvh")
    counts = tc.launch_counts()
    img_b, st_b = render(ts, 48, 40, spp=2, max_bounces=4, seed=1, method="brute")
    assert counts[k1_kernel] > 0 and counts["fetch_attrs"] > 0
    np.testing.assert_array_equal(img_k, img_b)
    assert st_k.rays_traced == st_b.rays_traced


@pytest.mark.parametrize("h,w", [(1080, 1920), (7, 5), (1, 1), (1, 77), (77, 1), (33, 65)])
def test_denoise_matches_plain(cuda_device, h, w):
    rng = np.random.default_rng(h + w)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img[rng.random((h, w)) < 0.02] = 255
    x = torch.from_numpy(img).to(cuda_device)
    before = dn.denoise_u8.launches
    got = dn.denoise_u8(x)
    want = dn.denoise_u8_plain(x)
    torch.cuda.synchronize()
    assert dn.denoise_u8.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.uint8 and got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_denoise_ties_match_plain(cuda_device):
    """Equal luminances ((0, 10, 0) and (17, 0, 49)) around fireflies, and
    a black band: the network's index keys pick the stable sort's sample."""
    rng_ = np.random.default_rng(3)
    tie = np.array([[0, 10, 0], [17, 0, 49]], np.uint8)
    img = tie[rng_.integers(0, 2, (48, 70))]
    img[2::4, 2::4] = 255
    img[40:] = 0
    img[44, 30] = 255
    x = torch.from_numpy(img).to(cuda_device)
    torch.testing.assert_close(dn.denoise_u8(x), dn.denoise_u8_plain(x), rtol=0, atol=0)


def test_denoise_removes_a_firefly(cuda_device):
    img = torch.full((16, 32, 3), 90, dtype=torch.uint8)
    img[7, 9] = torch.tensor([255, 250, 240], dtype=torch.uint8)
    got = dn.denoise_u8(img.to(cuda_device)).cpu()
    assert got[7, 9].tolist() == [90, 90, 90]
    assert int((got != img).any(-1).sum()) == 1


@pytest.mark.parametrize("dtype,shape", [(torch.float32, (4, 4, 3)), (torch.uint8, (4, 4)),
                                         (torch.uint8, (4, 4, 4))])
def test_denoise_bad_input_raises(cuda_device, dtype, shape):
    before = dn.denoise_u8.launches
    with pytest.raises(ValueError):
        dn.denoise_u8(torch.zeros(shape, dtype=dtype, device=cuda_device))
    assert dn.denoise_u8.launches == before


# ---------------------------------------------------------------------------
# K4: the bounce's shade, background and advance
# ---------------------------------------------------------------------------

#: K4's materials: all four maps; untextured; the debug-normal shader;
#: metallic, anisotropic, albedo map only; emissive with full sheen
K4_MATERIALS = (
    dict(base=(0.9, 0.7, 0.5), emi=(1.0, 1.0, 1.0), rough=0.6, metal=0.3, nstr=0.8, sheen=0.5,
         sheen_tint=0.3, aniso=0.4, tex=(1, 2, 3, 4), kind=0),
    dict(base=(0.8, 0.8, 0.8), emi=(0.0, 0.0, 0.0), rough=0.9, metal=0.0, nstr=0.0, sheen=0.0,
         sheen_tint=0.0, aniso=0.0, tex=(-1, -1, -1, -1), kind=0),
    dict(base=(0.5, 0.5, 0.5), emi=(0.0, 0.0, 0.0), rough=0.5, metal=0.0, nstr=0.0, sheen=0.0,
         sheen_tint=0.0, aniso=0.0, tex=(-1, 2, -1, -1), kind=ps.SHADER_DEBUG_NORMAL),
    dict(base=(0.95, 0.6, 0.3), emi=(0.0, 0.0, 0.0), rough=0.05, metal=1.0, nstr=0.0,
         sheen=0.0, sheen_tint=0.0, aniso=0.9, tex=(1, -1, -1, -1), kind=0),
    dict(base=(0.2, 0.4, 0.9), emi=(2.0, 1.0, 0.5), rough=0.3, metal=0.0, nstr=0.0, sheen=1.0,
         sheen_tint=1.0, aniso=0.0, tex=(-1, -1, 3, -1), kind=0),
)


def _k4_scene(device, equirect: bool, table: bool) -> ps.Scene:
    """A soup of 300 triangles with two spheres, K4_MATERIALS on random
    textures of odd sizes, under a 96x40 equirect map or a constant sky;
    with `table` the env light's alias table of that map (set on the scene
    under a constant sky too)."""
    rng_ = np.random.default_rng(11)
    n = 300
    pos = (rng_.uniform(-1, 1, (n, 1, 3)) + rng_.normal(0, 0.2, (n, 3, 3))).astype(np.float32)
    ng = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    mesh = ps.HostMesh(pos, np.repeat(ng[:, None], 3, 1).astype(np.float32),
                       rng_.uniform(-2, 3, (n, 3, 2)).astype(np.float32),
                       rng_.integers(0, len(K4_MATERIALS), n).astype(np.int32))
    f = lambda k: torch.tensor([m[k] for m in K4_MATERIALS], dtype=torch.float32)  # noqa: E731
    i = lambda k, c: torch.tensor([m[k][c] for m in K4_MATERIALS], dtype=torch.int32)  # noqa: E731
    v = lambda k: Vec3(*(torch.tensor([m[k][c] for m in K4_MATERIALS], dtype=torch.float32)  # noqa: E731
                         for c in range(3)))
    table_ = ps.MaterialTable(
        base_color=v("base"), emission=v("emi"), roughness=f("rough"), metalness=f("metal"),
        normal_strength=f("nstr"), sheen=f("sheen"), sheen_tint=f("sheen_tint"),
        anisotropic=f("aniso"), tex_albedo=i("tex", 0), tex_normal=i("tex", 1),
        tex_mr=i("tex", 2), tex_emission=i("tex", 3),
        shader_kind=torch.tensor([m["kind"] for m in K4_MATERIALS], dtype=torch.int32),
    ).with_rows()
    images = [rng_.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in ((23, 37), (64, 64), (3, 5), (17, 1))]
    images.append(chip_smoke.make_env_map(96, 40, seed=3))
    env_id = len(images)
    bg = ps.Background.equirect(env_id) if equirect else ps.Background.constant((0.6, 0.7, 0.9))
    scene = ps.build_scene(mesh, table_, ps.TextureAtlas.pack(images), bg, ps.Camera.default(),
                           spheres=ps.Spheres.make([[0.3, 0.2, 0.1], [-0.5, 0.4, 0.6]],
                                                   [0.4, 0.25], [3, 4]),
                           device=device)
    if table:
        scene.env_light = env_light.build_env_light(scene.atlas, env_id)
    return scene


def _k4_lanes(scene, r: int, seed: int, strided: bool, device):
    """Random lanes entering a bounce's tail: (st, hit, rand4, rand2).
    Misses (t = inf) and lanes that left, backface lanes (a shading or
    geometric normal along the ray), sphere winners, every material and
    none (-1), UVs outside [0, 1), previous pdfs of both kinds. strided:
    the origin an expanded scalar (bounce 0's) and the uniforms rows of a
    transposed (R, 7) draw (trace_bucketed's), else contiguous planes."""
    g = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa: E731

    def unit(k):
        a = g.normal(size=(k, 3))
        return a / np.linalg.norm(a, axis=-1, keepdims=True)

    d = unit(r)
    ng = unit(r)
    face = g.random(r) < 0.7  # most geometric normals face the ray
    ng[face] = -np.sign((ng * d).sum(-1, keepdims=True))[face] * ng[face]
    nrm = ng + 0.4 * unit(r)
    flip = g.random(r) < 0.1  # shading normal along the ray
    nrm[flip] = -nrm[flip]
    nrm *= g.uniform(0.5, 1.5, (r, 1))
    attrs = np.zeros((16, r), np.float32)
    attrs[0:3], attrs[3:6] = nrm.T, ng.T
    attrs[6:9], attrs[9:12] = unit(r).T, unit(r).T
    attrs[12:14] = g.uniform(-3.0, 4.0, (2, r))
    attrs[14] = g.integers(-1, len(K4_MATERIALS), r)
    hit_t = g.uniform(0.05, 4.0, r).astype(np.float32)
    hit_t[g.random(r) < 0.2] = np.inf
    sph = np.where(g.random(r) < 0.1, g.integers(0, scene.spheres.count, r), -1)
    sph[~np.isfinite(hit_t)] = -1
    prev = g.uniform(0.0, 5.0, r).astype(np.float32)
    prev[g.random(r) < 0.3] = np.inf
    draws = g.random((r, 7)).astype(np.float32)
    if strided:
        o = Vec3(*(torch.tensor(float(c), device=device).expand(r) for c in g.uniform(-2, 2, 3)))
        rand = torch.from_numpy(draws).to(device).T
    else:
        o = Vec3(*(t(c) for c in g.uniform(-2, 2, (3, r))))
        rand = t(draws.T)
    st = {
        "origin": o, "direction": Vec3(*(t(c) for c in d.T)),
        "throughput": Vec3(*(t(c) for c in g.uniform(0.0, 1.5, (3, r)))),
        "radiance": Vec3(*(t(c) for c in g.uniform(0.0, 3.0, (3, r)))),
        "active": torch.from_numpy(g.random(r) < 0.92).to(device),
        "rays": torch.zeros((), dtype=torch.int64, device=device),
        "prev_pdf": t(prev),
    }
    hit = {"t": t(hit_t), "attrs": t(attrs),
           "sph": torch.from_numpy(sph.astype(np.int32)).to(device)}
    return st, hit, rand[:4], rand[4:]


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("equirect,table", [(True, True), (True, False), (False, True),
                                            (False, False)])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("rr", [False, True])
@pytest.mark.parametrize("nee", [False, True])
def test_k4_matches_the_plain_tail(cuda_device, nee, rr, mode, equirect, table):
    """K4 (`integrator._tail_k4`) against the plain tail on the same lanes,
    both on the card: every plane of the next state, the radiance after
    the NEE add and the ray count, bit for bit."""
    from raytracing_c_tpu_torch.render import integrator as it

    scene = _k4_scene(cuda_device, equirect, table)
    for strided in (True, False):
        st, hit, rand4, rand2 = _k4_lanes(scene, 5000, 7 + strided, strided, cuda_device)
        rays = st["rays"] + st["active"].sum()
        args = (rays, rand4, "bvh", mode, rr, 3, nee, rand2 if nee else None)
        before = sc.shade_bounce.launches
        got = it._tail_k4(scene, st, hit, *args)
        # the plain tail takes bounce_step's hit test with the hits
        plain_hit = {**hit, "is_hit": st["active"] & torch.isfinite(hit["t"])}
        want = it._tail_plain(scene, st, plain_hit, *args)
        torch.cuda.synchronize()
        assert sc.shade_bounce.launches == before + 1
        for name in ("origin", "direction", "throughput", "radiance"):
            for c in "xyz":
                a, b = getattr(got[name], c), getattr(want[name], c)
                assert torch.equal(_bits(a), _bits(b)), (name, c, strided,
                                                          int((_bits(a) != _bits(b)).sum()))
        for name in ("active", "prev_pdf", "rays"):
            assert torch.equal(_bits(got[name]), _bits(want[name])), (name, strided)
        act = want["active"]
        assert 0.2 < float(act.float().mean()) < 0.95  # lanes of every kind
        if nee:
            assert int(got["rays"]) > int(st["active"].sum())


def test_k4_through_render_matches_the_plain_tail(cuda_device, monkeypatch):
    """render() with NEE, Russian roulette and the compacted tracer: the
    frame through K4 equals the frame through the plain tail on the card,
    and every bounce went through K4."""
    from raytracing_c_tpu_torch.render import integrator as it

    scene = _k4_scene(cuda_device, True, False)
    kw = dict(spp=2, max_bounces=5, seed=3, nee=True, rr=True)
    before = sc.shade_bounce.launches
    img_k, st_k = render(scene, 40, 32, **kw)
    assert sc.shade_bounce.launches > before
    monkeypatch.setattr(it, "_tail_k4", it._tail_plain)
    img_p, st_p = render(scene, 40, 32, **kw)
    np.testing.assert_array_equal(img_k, img_p)
    assert st_k.rays_traced == st_p.rays_traced


def _k4_call(scene, st, hit, rand4):
    return sc.shade_bounce(scene, st, hit["t"], hit["attrs"], rand4)


@pytest.mark.parametrize("fault", ["cpu", "float64_plane", "attrs_rows", "rows_layout"])
def test_k4_bad_input_raises(cuda_device, fault):
    scene = _k4_scene(cuda_device, False, False)
    st, hit, rand4, _ = _k4_lanes(scene, 256, 1, False, cuda_device)
    if fault == "cpu":
        st = {k: (v.map(lambda a: a.cpu()) if isinstance(v, Vec3) else v.cpu())
              for k, v in st.items()}
        hit = {k: v.cpu() for k, v in hit.items()}
        rand4 = rand4.cpu()
    elif fault == "float64_plane":
        st["throughput"] = st["throughput"].map(lambda a: a.double())
    elif fault == "attrs_rows":
        hit["attrs"] = hit["attrs"][:15]
    else:
        rows = scene.materials.rows
        scene.materials.rows = torch.zeros((rows.shape[0], 256), device=cuda_device)[:, ::2]
    before = sc.shade_bounce.launches
    with pytest.raises(ValueError):
        _k4_call(scene, st, hit, rand4)
    assert sc.shade_bounce.launches == before


# --- K5: the threefry draws (csrc/rng.cu, ops/rng_cuda.py) ---

#: slots and data words at the ends of the uint32 range and beyond it (the
#: plain version keeps the low 32 bits)
K5_WORDS = [0, 1, 2, 7919, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1, 2**32, 2**40 + 3, -1]


def _k5_key(device, seed: int = 4, b: int = 2):
    return rng.fold_in(rng.prng_key(seed, device), b)


def _k5_cases(device):
    """(label, K5 call, the plain version's call on CPU copies, launches)."""
    key = _k5_key(device)
    keys = rng.split(key, 5)  # (5, 2)
    words = torch.tensor(K5_WORDS + list(range(3, 3000, 7)), dtype=torch.int64)
    wd = words.to(device)
    w32 = torch.tensor([0, 1, 7919, 2**31 - 1, -1, -2**31], dtype=torch.int32)
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    return [
        ("fold_in scalar", lambda: rng.fold_in(key, 123456789),
         lambda: rng.fold_in(key.cpu(), 123456789)),
        ("fold_in 2^32 - 1", lambda: rng.fold_in(key, 2**32 - 1),
         lambda: rng.fold_in(key.cpu(), 2**32 - 1)),
        ("fold_in words", lambda: rng.fold_in(key, wd), lambda: rng.fold_in(key.cpu(), words)),
        ("fold_in int32 words", lambda: rng.fold_in(key, w32.to(device)),
         lambda: rng.fold_in(key.cpu(), w32)),
        ("fold_in keys x words", lambda: rng.fold_in(keys, wd[:5]),
         lambda: rng.fold_in(keys.cpu(), words[:5])),
        ("fold_in keys x scalar", lambda: rng.fold_in(keys, 7),
         lambda: rng.fold_in(keys.cpu(), 7)),
        ("fold_in 0-d device word", lambda: rng.fold_in(key, wd[3]),
         lambda: rng.fold_in(key.cpu(), words[3])),
        ("split 2", lambda: rng.split(key), lambda: rng.split(key.cpu())),
        ("split 5", lambda: rng.split(key, 5), lambda: rng.split(key.cpu(), 5)),
        ("split keys", lambda: rng.split(keys, 4), lambda: rng.split(keys.cpu(), 4)),
        ("random_bits", lambda: rng.random_bits(key, (3, 129)),
         lambda: rng.random_bits(key.cpu(), (3, 129))),
        ("random_bits keys", lambda: rng.random_bits(keys, (7,)),
         lambda: rng.random_bits(keys.cpu(), (7,))),
        ("uniform jitter", lambda: rng.uniform(key, (2, 4099)),
         lambda: rng.uniform(key.cpu(), (2, 4099))),
        ("uniform dense", lambda: rng.uniform(key, (8, 4, 1000)),
         lambda: rng.uniform(key.cpu(), (8, 4, 1000))),
        ("uniform keys", lambda: rng.uniform(keys, (7,)),
         lambda: rng.uniform(keys.cpu(), (7,))),
        ("uniform [-1, 1)", lambda: rng.uniform(key, (3, 1000), -1.0, 1.0),
         lambda: rng.uniform(key.cpu(), (3, 1000), -1.0, 1.0)),
        ("uniform [0.25, 3.5)", lambda: rng.uniform(key, (3, 1000), 0.25, 3.5),
         lambda: rng.uniform(key.cpu(), (3, 1000), 0.25, 3.5)),
        ("uniform normal's bounds", lambda: rng.uniform(keys, (3, 1000), lo, 1.0),
         lambda: rng.uniform(keys.cpu(), (3, 1000), lo, 1.0)),
    ]


def test_k5_draws_match_plain(cuda_device):
    """Every K5 entry point (fold_in with a python int, a tensor of words,
    batched keys and a 0-d word on the card; split; random_bits; uniform
    on [0, 1) and bounded) against the plain int64 version on CPU copies of
    the same keys: every word bit for bit, one launch a draw."""
    for label, k5, plain in _k5_cases(cuda_device):
        before = sum(rc.launch_counts().values())
        got = k5()
        torch.cuda.synchronize()
        assert sum(rc.launch_counts().values()) == before + 1, label
        want = plain()
        assert got.device.type == "cuda" and got.dtype == want.dtype, label
        assert got.shape == want.shape, label
        assert torch.equal(_bits(got.cpu()), _bits(want)), (
            label, int((_bits(got.cpu()) != _bits(want)).sum()))


@pytest.mark.parametrize("n", [0, 1, 1000, 262_144])
def test_k5_bounce_uniforms_match_plain(cuda_device, n):
    """rt_bounce_uniforms against the plain composition
    uniform(fold_in(fold_in(key, slot), bounce), (nu,)).T on CPU copies,
    at nu 3, 4 and 7 and bounces 0, 1 and 7, on contiguous int64 slots
    (with the ends of the uint32 range), a strided view and int32 slots:
    a contiguous (nu, n) float32 plane, bit for bit; one launch a draw
    (none for no lane)."""
    key = _k5_key(cuda_device, 11, 3)
    slots = torch.randperm(max(4 * n, 16), generator=torch.Generator().manual_seed(n))[:n]
    slots[:min(n, 9)] = torch.tensor(K5_WORDS[:9])[:min(n, 9)]
    sd = slots.to(cuda_device)
    s32 = (slots % 2**31).to(torch.int32)
    views = [("int64", sd, slots), ("int32", s32.to(cuda_device), s32)]
    if n > 1:
        views.append(("strided", sd[::2], slots[::2]))
    for nu in (3, 4, 7):
        for bounce in (0, 1, 7):
            for label, s_d, s_h in views:
                before = rc.launch_counts()["rng_bounce_uniforms"]
                got = rng.bounce_uniforms(key, s_d, bounce, nu)
                torch.cuda.synchronize()
                want = rng.uniform(rng.fold_in(rng.fold_in(key.cpu(), s_h), bounce), (nu,)).T
                assert got.shape == (nu, s_d.shape[0]) and got.is_contiguous()
                assert rc.launch_counts()["rng_bounce_uniforms"] == before + (s_d.numel() > 0)
                assert torch.equal(_bits(got.cpu()), _bits(want.contiguous())), (
                    nu, bounce, label)


@pytest.mark.parametrize("nee", [False, True])
def test_k5_through_render(cuda_device, monkeypatch, nee):
    """A compacted render() batch of 262,144 samples on the stand-in: K5
    launches 4 times a batch (fold_in of the batch, split, the jitter,
    fold_in(key, 1)) and once a bounce run, the `rng` spans count those
    draws through K5 and none through the plain version, and the planes
    each bounce hands K4 (rand4, and with nee rand2) are the rows of that
    bounce's K5 draw, bit-equal to the plain composition on the same
    slots on the CPU."""
    from raytracing_c_tpu_torch.render import integrator as it
    from raytracing_c_tpu_torch.utils import spans

    scene = chip_smoke.procedural_scene(ps, np, torch, cuda_device, tex=256)
    if nee:
        scene = chip_smoke.with_env_map(ps, torch, scene, chip_smoke.make_env_map(256, 128))
    draws, handed = [], []
    draw, tail = rng.bounce_uniforms, it._tail_k4

    def keep_draw(key, slot, bounce, nu):
        out = draw(key, slot, bounce, nu)
        draws.append((key.clone(), slot.clone(), bounce, nu, out))
        return out

    def keep_tail(scene_, st, hit, rays, rand4, *rest):
        handed.append((rand4, rest[-1]))
        return tail(scene_, st, hit, rays, rand4, *rest)

    monkeypatch.setattr(rng, "bounce_uniforms", keep_draw)
    monkeypatch.setattr(it, "_tail_k4", keep_tail)
    rc.reset_launch_counts()
    spans.enable()
    try:
        # 128 x 128 pixels at 16 spp: one batch of the main path's 262,144 lanes
        _, stats = render(scene, 128, 128, spp=16, max_bounces=8, seed=9, nee=nee)
        summary = spans.rng_summary(spans.collect())
    finally:
        spans.disable()
    assert stats.batches == 1
    bounces = len(draws)
    assert 2 <= bounces <= 8 and len(handed) == bounces
    launches = rc.launch_counts()
    assert launches["rng_bounce_uniforms"] == bounces
    assert sum(launches.values()) == 4 + bounces, launches
    assert summary["k5_draws"] == 4 + bounces and summary["plain_draws"] == 0
    assert summary["k5_launches_per_batch"] == 4 + bounces
    nu = 7 if nee else 3
    for i, ((key, slot, bounce, n_u, out), (rand4, rand2)) in enumerate(zip(draws, handed)):
        assert bounce == i and n_u == nu and out.shape == (nu, slot.numel())
        assert rand4.data_ptr() == out.data_ptr() and torch.equal(rand4, out[:4])
        if nee:
            assert torch.equal(rand2, out[4:])
        want = rng.uniform(rng.fold_in(rng.fold_in(key.cpu(), slot.cpu()), i), (nu,)).T
        assert torch.equal(_bits(out.cpu()), _bits(want.contiguous())), i


@pytest.mark.parametrize("fault", ["cpu_key", "float_slot", "batched_key", "nu_0",
                                   "other_device_data"])
def test_k5_bad_input_raises(cuda_device, fault):
    key = _k5_key(cuda_device)
    keys = rng.split(key, 3)
    slot = torch.arange(8, device=cuda_device)
    call = {
        "cpu_key": lambda: rc.bounce_uniforms(key.cpu(), slot.cpu(), 0, 3),
        "float_slot": lambda: rc.bounce_uniforms(key, slot.float(), 0, 3),
        "batched_key": lambda: rc.bounce_uniforms(keys, slot, 0, 3),
        "nu_0": lambda: rc.bounce_uniforms(key, slot, 0, 0),
        "other_device_data": lambda: rc.fold_in(key, torch.arange(4)),
    }[fault]
    before = rc.launch_counts()
    with pytest.raises(ValueError):
        call()
    assert rc.launch_counts() == before
