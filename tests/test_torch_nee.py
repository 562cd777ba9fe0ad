"""NEE (environment next-event estimation with MIS) of the port against the
JAX package: shade(nee=True), trace / trace_bucketed with nee, and
render(nee=True), on the same scene arrays and seeds.

Tolerances: shade's NEE outputs pass through sin/cos/pow/atan2 and the
env sampler; their float32 results agree within rtol/atol 2e-5 except on
the lanes where the anisotropic lobe or 1/sin(theta) amplifies an ulp
(atol 1e-3 there, on under 1% of the lanes). Radiance within 1e-4, as the
non-NEE integrator tests. Images: bit-identical where reached, else
PSNR >= 45 dB (the cross-backend bound of test_golden.py:75); measured:
the four 32x32 NEE renders are bit-identical to the JAX package's. Ray
counts, shadow rays included, exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_c_tpu.io.materials import AtlasBuilder
from raytracing_c_tpu.models.scene import (
    BG_EQUIRECT, SHADER_DEBUG_NORMAL, Background, Camera, MaterialTable, build_scene,
)
from raytracing_c_tpu.ops import disney as jdisney
from raytracing_c_tpu.render import integrator as jint
from raytracing_c_tpu.render import renderer as jren
from raytracing_c_tpu.utils.vec3 import Vec3 as JVec3
from raytracing_c_tpu_torch.ops import disney as tdisney
from raytracing_c_tpu_torch.ops import env_light as tel
from raytracing_c_tpu_torch.render import integrator as tint
from raytracing_c_tpu_torch.render import renderer as tren
from raytracing_c_tpu_torch.utils import rng as trng

from helpers import random_mesh, random_rays
from test_torch_env_light import env_image
from torch_port_helpers import aimed_rays, jvec, np3, port_scene, psnr, quad_sphere_scene, tvec

TRANS_TOL = dict(rtol=2e-5, atol=2e-5)
RAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _equirect(rng, mesh, materials, textures=()):
    b = AtlasBuilder()
    for img in textures:
        b.add(img)
    tid = b.add(env_image(rng))
    js = build_scene(mesh, materials, b.build(),
                     Background(kind=BG_EQUIRECT, color=jnp.zeros((3,)), tex_id=tid),
                     Camera.default())
    ts = port_scene(js)
    tel.scene_env_light(ts)
    return js, ts


def _materials():
    """Textured, metal, sheen, anisotropic and debug-normal materials."""
    f = lambda *v: jnp.asarray(np.array(v, np.float32))  # noqa: E731
    i = lambda *v: jnp.asarray(np.array(v, np.int32))  # noqa: E731
    return MaterialTable(
        base_color=JVec3(f(0.8, 0.9, 1.0, 0.5), f(0.8, 0.7, 0.3, 0.5), f(0.8, 0.1, 0.0, 0.5)),
        emission=JVec3(f(0, 0, 0, 0), f(0, 0, 0, 0), f(0, 0, 0, 0)),
        roughness=f(0.5, 0.35, 0.9, 0.3), metalness=f(0.0, 1.0, 0.2, 0.95),
        normal_strength=f(1.0, 0.0, 0.0, 0.0), sheen=f(0.0, 0.0, 0.8, 0.0),
        sheen_tint=f(0.0, 0.0, 0.5, 0.0), anisotropic=f(0.0, 0.7, 0.0, 0.0),
        tex_albedo=i(1, -1, -1, -1), tex_normal=i(2, -1, -1, -1), tex_mr=i(-1, -1, -1, -1),
        tex_emission=i(-1, -1, -1, -1), shader_kind=i(0, 0, 0, SHADER_DEBUG_NORMAL),
    ).with_rows()


@pytest.fixture(scope="module")
def scenes():
    rng = np.random.default_rng(3)
    soup = _equirect(rng, random_mesh(900, np.random.default_rng(3)), MaterialTable.default())
    jq = quad_sphere_scene()
    return {"soup_env": soup, "quad_sphere": (jq, port_scene(jq))}


@pytest.mark.parametrize("sky", ["equirect", "constant"])
def test_shade_nee(rng, sky):
    tex = [rng.integers(0, 256, (9, 14, 3), dtype=np.uint8) for _ in range(2)]
    mesh = random_mesh(20, rng)
    mesh.mat_id = (np.arange(20) % 4).astype(np.int32)
    if sky == "equirect":
        js, ts = _equirect(rng, mesh, _materials(), tex)
    else:
        b = AtlasBuilder()
        for img in tex:
            b.add(img)
        js = build_scene(mesh, _materials(), b.build(), Background.constant((0.4, 0.5, 0.6)),
                         Camera.default())
        ts = port_scene(js)
    r = 4096
    _, d = random_rays(r, rng)
    n = -d + rng.normal(0, 0.4, (r, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    tan = np.cross(n, [0.0, 1.0, 0.0]).astype(np.float32)
    tan /= np.linalg.norm(tan, axis=-1, keepdims=True)
    btn = np.cross(n, tan).astype(np.float32)
    uu, vv = rng.uniform(-0.5, 1.5, (2, r)).astype(np.float32)
    mat = rng.integers(0, 4, r).astype(np.int32)
    rand4, rand2 = rng.uniform(0, 1, (4, r)).astype(np.float32), rng.uniform(0, 1, (3, r)).astype(
        np.float32)
    j = jnp.asarray
    want = jdisney.shade(js, jvec(d), jvec(n), jvec(n), jvec(tan), jvec(btn), j(uu), j(vv),
                         j(mat), j(rand4), nee=True, rand2=j(rand2))
    t = torch.from_numpy
    got = tdisney.shade(ts, tvec(d), tvec(n), tvec(n), tvec(tan), tvec(btn), t(uu), t(vv),
                        t(mat), t(rand4), nee=True, rand2=t(rand2))
    np.testing.assert_allclose(np3(want["nee_dir"]), np3(got["nee_dir"]), rtol=0, atol=1e-5)
    for k in ("nee_partial",):
        w_, g_ = np3(want[k]), np3(got[k])
        np.testing.assert_allclose(w_, g_, rtol=1e-3, atol=1e-3, err_msg=k)
        close = np.isclose(w_, g_, **TRANS_TOL).all(axis=1)
        assert close.mean() > 0.99, k
    pw, pg = np.asarray(want["pdf_eval"]), got["pdf_eval"].numpy()
    debug = mat == 3
    assert np.isinf(pg[debug]).all() and np.isinf(pw[debug]).all()
    assert (np3(got["nee_partial"])[debug] == 0).all()
    live = ~debug & ~np.asarray(want["terminate"])
    np.testing.assert_allclose(pw[live], pg[live], rtol=1e-3, atol=1e-3)
    assert np.isclose(pw[live], pg[live], **TRANS_TOL).mean() > 0.99
    assert (np3(got["nee_partial"]).sum(axis=1) > 0).mean() > 0.2


def _rays(name, n=2048):
    rng = np.random.default_rng(17)
    if name == "soup_env":
        return aimed_rays(n, rng)
    o = np.tile([[0.0, 0.0, 3.0]], (n, 1)).astype(np.float32)
    d = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)), -np.ones((n, 1))], 1)
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name", ["soup_env", "quad_sphere"])
def test_trace_nee_matches_jax(scenes, name):
    js, ts = scenes[name]
    o, d = _rays(name)
    uni = np.array(jax.random.uniform(jax.random.PRNGKey(2), (4, 4, len(o))))
    nu = np.array(jax.random.uniform(jax.random.PRNGKey(3), (4, 3, len(o))))
    jrad, jrays = jint.trace(js, jvec(o), jvec(d), jnp.asarray(uni), 4, method="brute",
                             nee=True, nee_uniforms=jnp.asarray(nu))
    trad, trays = tint.trace(ts, tvec(o), tvec(d), torch.from_numpy(uni), 4, method="bvh",
                             nee=True, nee_uniforms=torch.from_numpy(nu))
    np.testing.assert_allclose(np3(jrad), np3(trad), **RAD_TOL)
    assert float(jrays) == int(trays)
    plain, plain_rays = tint.trace(ts, tvec(o), tvec(d), torch.from_numpy(uni), 4, method="bvh")
    assert int(trays) > int(plain_rays)  # the shadow rays count


@pytest.mark.parametrize("name", ["soup_env", "quad_sphere"])
def test_trace_bucketed_nee_matches_jax(scenes, name):
    js, ts = scenes[name]
    o, d = _rays(name)
    jrad, jrays = jint.trace_bucketed(js, jvec(o), jvec(d), jax.random.PRNGKey(5), 5,
                                      method="topk" if name == "soup_env" else "brute", nee=True)
    trad, trays = tint.trace_bucketed(ts, tvec(o), tvec(d), trng.prng_key(5), 5, method="bvh",
                                      nee=True)
    np.testing.assert_allclose(np3(jrad), np3(trad), **RAD_TOL)
    assert float(jrays) == int(trays)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("name", ["soup_env", "quad_sphere"])
def test_render_nee_matches_jax(scenes, name, compact):
    js, ts = scenes[name]
    kw = dict(spp=2, max_bounces=3, seed=7, compact=compact, nee=True)
    jimg, jst = jren.render(js, 32, 32, method="topk" if name == "soup_env" else "auto", **kw)
    timg, tst = tren.render(ts, 32, 32, **kw)
    assert timg.shape == (32, 32, 3) and timg.std() > 5.0
    assert (timg == jimg).all() or psnr(timg, jimg) >= 45.0
    assert tst.rays_traced == jst.rays_traced
    plain, pst = tren.render(ts, 32, 32, **{**kw, "nee": False})
    assert pst.rays_traced < tst.rays_traced


def test_render_nee_builds_the_env_table(scenes):
    """render(nee=True) on a scene without the table builds it once from
    the atlas, and its image does not depend on who built it."""
    js, ts = scenes["soup_env"]
    fresh = port_scene(js)
    assert fresh.env_light is None
    kw = dict(spp=1, max_bounces=2, seed=1, nee=True)
    img, _ = tren.render(fresh, 16, 16, **kw)
    assert isinstance(fresh.env_light, tel.EnvLight)
    np.testing.assert_array_equal(img, tren.render(ts, 16, 16, **kw)[0])


@pytest.mark.parametrize("nee", [False, True])
def test_k4_work_counts_each_lane_kind(rng, nee):
    """utils/bounds.k4_work, K4's bytes and operations for its bound, on
    four lanes under the equirect sky and its env table: one that left,
    one miss, one shaded hit of material 0 (albedo and normal maps) and
    one backface hit. Each kind counts once, the shaded lane per map of
    its material, the position's stride-0 planes once, NEE's terms only
    with NEE."""
    from raytracing_c_tpu_torch.utils import bounds as b
    from raytracing_c_tpu_torch.utils.vec3 import Vec3

    tex = [rng.integers(0, 256, (9, 14, 3), dtype=np.uint8) for _ in range(2)]
    mesh = random_mesh(4, rng)
    mesh.mat_id = np.zeros(4, np.int32)
    _, ts = _equirect(rng, mesh, _materials(), tex)
    planes = lambda: Vec3(*(torch.rand(4) for _ in range(3)))  # noqa: E731
    st = {"origin": Vec3(*(torch.tensor(0.5).expand(4) for _ in range(3))),
          "direction": planes(), "throughput": planes(), "radiance": planes(),
          "active": torch.tensor([False, True, True, True]),
          "prev_pdf": torch.ones(4)}
    t = torch.tensor([1.0, float("inf"), 2.0, 2.0])
    attrs = torch.zeros((16, 4))
    shaded = torch.tensor([False, False, True, False])
    work = b.k4_work(ts, st, t, attrs, shaded, nee)
    assert (work["lanes"], work["hits"], work["shaded"], work["misses"]) == (4, 2, 1, 1)
    assert work["map_taps"] == [1, 1, 0, 0]
    state = 3 * 4 + 9 * 4 * 4
    nee_bytes = 4 * 8 + (12 + 16 + 12 + 36) + 4
    assert work["bytes"] == (state + 4 * 55 + 2 * 24 + (36 + 12) + 2 * 12 + 12
                             + (nee_bytes if nee else 0))
    ops = (4 * b.K4_LANE_OPS + 2 * b.K4_HIT_OPS + b.K4_SHADED_OPS
           + 2 * b.K4_TAP_OPS["bilinear"] + b.K4_MAP_OPS[0] + b.K4_MAP_OPS[1] + b.K4_BG_OPS)
    ops += (b.K4_NEE_OPS["table"] + b.K4_BG_OPS + b.K4_MISS_OPS["table"] if nee
            else b.K4_MISS_OPS["plain"])
    assert work["ops"] == ops
    nearest = b.k4_work(ts, st, t, attrs, shaded, nee, texture_mode="nearest")
    assert work["bytes"] - nearest["bytes"] == 2 * 9
    assert b.nee_add_work(10) == {"bytes": 480, "ops": 10 * b.NEE_ADD_OPS}
