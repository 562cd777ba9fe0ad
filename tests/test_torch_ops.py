"""The port's ray primitives, texture, background and shading against the
JAX package on the same numpy inputs.

Tolerances: integer outputs and pure gathers are exact. Float results
built only from + - * / and sqrt agree to a few float32 ulps (XLA:CPU may
fuse or vectorise differently from torch). Results that pass through
transcendental functions (pow, sin, cos, atan2, asin, rsqrt), whose
implementations differ between XLA and torch by an ulp or so, are held to
rtol 2e-5 and atol 2e-5 after the shading pipeline amplifies them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_c_tpu.io.materials import AtlasBuilder
from raytracing_c_tpu.models.scene import (
    Background, Camera, MaterialTable, SHADER_DEBUG_NORMAL, Spheres, build_scene,
)
from raytracing_c_tpu.ops import background as jbg
from raytracing_c_tpu.ops import disney as jdisney
from raytracing_c_tpu.ops import intersect as jint
from raytracing_c_tpu.ops import texture as jtex
from raytracing_c_tpu.render import camera as jcam
from raytracing_c_tpu.utils import color as jcolor
from raytracing_c_tpu.utils.vec3 import Vec3 as JVec3
from raytracing_c_tpu_torch.models import scene as ps
from raytracing_c_tpu_torch.ops import background as tbg
from raytracing_c_tpu_torch.ops import disney as tdisney
from raytracing_c_tpu_torch.ops import intersect as tint
from raytracing_c_tpu_torch.ops import texture as ttex
from raytracing_c_tpu_torch.render import camera as tcam
from raytracing_c_tpu_torch.utils import color as tcolor

from helpers import random_mesh, random_rays
from torch_port_helpers import aimed_rays, jvec, np3, port_scene, tvec

ULP_TOL = dict(rtol=1e-6, atol=1e-6)
TRANS_TOL = dict(rtol=2e-5, atol=2e-5)
TEX_SIZES = [(7, 5), (64, 48), (1, 1), (9, 14), (3, 200)]


def _atlas(rng):
    b = AtlasBuilder()
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in TEX_SIZES]
    for img in imgs:
        b.add(img)
    return b.build(), imgs


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_camera_rays(rng):
    m = np.eye(4, dtype=np.float32)
    ang = 0.4
    m[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
    m[:3, 3] = [0.3, -0.2, 4.0]
    jc = Camera(view_matrix=jnp.asarray(m), fov=jnp.float32(0.9),
                focal_length=jnp.float32(1.0 / np.tan(0.45)))
    tc = ps.Camera(_t(m), torch.tensor(np.float32(0.9)),
                   torch.tensor(np.float32(1.0 / np.tan(0.45))))
    px = rng.integers(0, 160, 2000).astype(np.int32)
    py = rng.integers(0, 90, 2000).astype(np.int32)
    ju, jv = rng.uniform(0, 1, (2, 2000)).astype(np.float32)
    jo, jd = jcam.generate_rays(jc, 160, 90, jnp.asarray(px), jnp.asarray(py),
                                jnp.asarray(ju), jnp.asarray(jv))
    to, td = tcam.generate_rays(tc, 160, 90, _t(px), _t(py), _t(ju), _t(jv))
    np.testing.assert_array_equal(np3(jo), np3(to))
    np.testing.assert_allclose(np3(jd), np3(td), **ULP_TOL)


def test_moller_trumbore_and_bruteforce(rng):
    mesh = random_mesh(300, rng)
    js = build_scene(mesh, MaterialTable.default(), AtlasBuilder().build(),
                     Background.constant((0, 0, 0)), Camera.default())
    ts = port_scene(js)
    o, d = aimed_rays(512, rng)
    jh = jint.intersect_bruteforce(jvec(o), jvec(d), js.triangles)
    th = tint.intersect_bruteforce(tvec(o), tvec(d), ts.triangles)
    np.testing.assert_array_equal(np.asarray(jh["tri"]), th["tri"].numpy())
    np.testing.assert_allclose(np.asarray(jh["t"]), th["t"].numpy(), **ULP_TOL)
    hit = np.isfinite(np.asarray(jh["t"]))
    assert hit.sum() > 50
    for k in ("u", "v"):
        np.testing.assert_allclose(np.asarray(jh[k])[hit], th[k].numpy()[hit], **ULP_TOL)


def test_aabb_slab(rng):
    o, d = random_rays(1000, rng)
    inv = 1.0 / d
    inv[::50, 0] = np.inf  # axis-parallel lanes
    lo = rng.uniform(-1, 0, (1000, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 1, (1000, 3)).astype(np.float32)
    want = jint.aabb_slab(jvec(o), jvec(inv), jvec(lo), jvec(hi), 1e-4, jnp.float32(3.0))
    got = tint.aabb_slab(tvec(o), tvec(inv), tvec(lo), tvec(hi), 1e-4, 3.0)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_spheres(rng):
    o, d = random_rays(700, rng)
    centers = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 0.6, 5).astype(np.float32)
    best = rng.uniform(0.5, 6.0, 700).astype(np.float32)
    jt, ji = jint.intersect_spheres(jvec(o), jvec(d), Spheres.make(centers, radii, [0] * 5),
                                    jnp.asarray(best))
    tt, ti = tint.intersect_spheres(tvec(o), tvec(d), ps.Spheres.make(centers, radii, [0] * 5),
                                    _t(best))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    # near-tangent rays: sqrt of a discriminant near 0 turns an ulp of b*b -
    # 4ac into ~1e-4 of t
    np.testing.assert_allclose(np.asarray(jt), tt.numpy(), rtol=5e-4, atol=1e-4)
    assert (ti.numpy() >= 0).sum() > 20


def test_atlas_pack_matches_builder(rng):
    jat, imgs = _atlas(rng)
    tat = ps.TextureAtlas.pack(imgs)
    for f in ("tex_r", "tex_g", "tex_b", "offset", "width", "height"):
        np.testing.assert_array_equal(np.asarray(getattr(jat, f)), getattr(tat, f).numpy())


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_texture_wrap_and_clamp(rng, mode):
    """Negative and >1 uv (repeat wrap), exact-integer uv (edge clamp),
    every texture including the 1x1 dummy and 'no texture' (-1) lanes."""
    jat, imgs = _atlas(rng)
    tat = ps.TextureAtlas.pack(imgs)
    r = 3000
    uu = rng.uniform(-3.0, 3.0, r).astype(np.float32)
    vv = rng.uniform(-3.0, 3.0, r).astype(np.float32)
    uu[:40] = np.arange(40) / 4.0 - 5.0  # integers and quarters, negative
    vv[40:80] = 1.0
    tid = rng.integers(-1, len(TEX_SIZES) + 1, r).astype(np.int32)
    want = jtex.sample(jat, jnp.asarray(tid), jnp.asarray(uu), jnp.asarray(vv), mode)
    got = ttex.sample(tat, _t(tid), _t(uu), _t(vv), mode)
    np.testing.assert_allclose(np3(want), np3(got), **ULP_TOL)
    if mode == "nearest":  # pure texel gathers: exact
        np.testing.assert_array_equal(np3(want), np3(got))


def _bg_scene(rng, kind):
    jat, imgs = _atlas(rng)
    bg = Background.constant((0.3, 0.5, 0.9)) if kind == "constant" else Background.equirect(2)
    js = build_scene(random_mesh(10, rng), MaterialTable.default(), jat, bg, Camera.default())
    return js, port_scene(js)


@pytest.mark.parametrize("kind", ["constant", "equirect"])
def test_background(rng, kind):
    js, ts = _bg_scene(rng, kind)
    _, d = random_rays(2000, rng)
    d[:10] = [0.0, 1.0, 0.0]  # poles
    d[10:20] = [0.0, -1.0, 0.0]
    want = jbg.eval_background(js, jvec(d))
    got = tbg.eval_background(ts, tvec(d))
    np.testing.assert_allclose(np3(want), np3(got), **TRANS_TOL)


def test_color_encode(rng):
    x = rng.uniform(-0.2, 1.3, (4096, 3)).astype(np.float32)
    x[:5] = np.array([0.0, 0.0031308, 1.0, 1e-9, 0.5], np.float32)[:, None]
    np.testing.assert_array_equal(np.asarray(jcolor.encode_u8(x)), tcolor.encode_u8(_t(x)).numpy())
    for fn in ("aces", "reinhard", "srgb_to_linear", "linear_to_srgb"):
        np.testing.assert_allclose(np.asarray(getattr(jcolor, fn)(jnp.asarray(x))),
                                   getattr(tcolor, fn)(_t(x)).numpy(), **TRANS_TOL)


def _material_scene(rng):
    """Five materials over textured, untextured, sheen, anisotropic,
    emissive and debug-normal variants. Roughness stays >= 0.3 where the
    material is anisotropic: at alpha_y ~ 1e-6 the VNDF sample is so
    ill-conditioned that an ulp of sin/cos moves the direction by O(1)."""
    jat, _ = _atlas(rng)
    m = 5
    f = lambda *v: jnp.asarray(np.array(v, np.float32))  # noqa: E731
    i = lambda *v: jnp.asarray(np.array(v, np.int32))  # noqa: E731
    mats = MaterialTable(
        base_color=JVec3(f(0.8, 0.2, 1.0, 0.5, 0.9), f(0.8, 0.7, 0.3, 0.5, 0.1),
                         f(0.8, 0.1, 0.0, 0.5, 0.4)),
        emission=JVec3(f(0, 0, 2.0, 0, 0), f(0, 0, 1.0, 0, 0), f(0, 0, 0.5, 0, 0)),
        roughness=f(0.5, 0.35, 0.9, 0.3, 1.0),
        metalness=f(0.0, 1.0, 0.2, 0.95, 0.5),
        normal_strength=f(0.0, 1.0, 0.5, 0.0, 0.0),
        sheen=f(0.0, 0.0, 0.8, 0.0, 0.3),
        sheen_tint=f(0.0, 0.0, 0.5, 0.0, 1.0),
        anisotropic=f(0.0, 0.7, 0.0, 0.3, 0.0),
        tex_albedo=i(-1, 1, 3, -1, 5),
        tex_normal=i(-1, 2, 4, -1, -1),
        tex_mr=i(-1, 5, 2, 1, -1),
        tex_emission=i(-1, -1, 1, -1, -1),
        shader_kind=i(0, 0, 0, SHADER_DEBUG_NORMAL, 0),
    ).with_rows()
    js = build_scene(random_mesh(20, rng), mats, jat, Background.constant((0.4, 0.4, 0.4)),
                     Camera.default())
    return js, port_scene(js), m


def test_shade(rng):
    js, ts, m = _material_scene(rng)
    r = 4096
    _, d = random_rays(r, rng)
    n = -d + rng.normal(0, 0.4, (r, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    tan = np.cross(n, [0.0, 1.0, 0.0]).astype(np.float32)
    tan /= np.linalg.norm(tan, axis=-1, keepdims=True)
    btn = np.cross(n, tan).astype(np.float32)
    uu, vv = rng.uniform(-1.5, 2.5, (2, r)).astype(np.float32)
    mat = rng.integers(-1, m, r).astype(np.int32)
    rand = rng.uniform(0, 1, (4, r)).astype(np.float32)
    want = jdisney.shade(js, jvec(d), jvec(n), jvec(n), jvec(tan), jvec(btn), jnp.asarray(uu),
                         jnp.asarray(vv), jnp.asarray(mat), jnp.asarray(rand))
    got = tdisney.shade(ts, tvec(d), tvec(n), tvec(n), tvec(tan), tvec(btn), _t(uu), _t(vv),
                        _t(mat), _t(rand))
    term = np.asarray(want["terminate"])
    np.testing.assert_array_equal(term, got["terminate"].numpy())
    assert 0 < term.sum() < r
    for k in ("emission", "normal"):
        np.testing.assert_allclose(np3(want[k]), np3(got[k]), err_msg=k, **TRANS_TOL)
    # sampled directions: the anisotropic metal amplifies an ulp of the
    # transcendentals to ~1e-4 on a few lanes per thousand
    dw, dg = np3(want["direction"]), np3(got["direction"])
    np.testing.assert_allclose(dw, dg, rtol=0, atol=1e-3)
    assert (np.abs(dw - dg).max(axis=1) > 2e-5).mean() < 0.01
    live = ~term
    np.testing.assert_allclose(np3(want["tint"])[live], np3(got["tint"])[live], rtol=1e-4,
                               atol=2e-5)


def test_shade_nee_not_ported(rng):
    """shade(nee=True), once refused, now adds the light sample: a unit
    direction, a finite partial contribution and the scatter pdf (the
    values are held against JAX's in test_torch_nee.py)."""
    _, ts, _ = _material_scene(rng)
    v = tvec(np.tile([[0.0, 0.0, -1.0]], (4, 1)).astype(np.float32))
    n = tvec(np.tile([[0.0, 0.0, 1.0]], (4, 1)).astype(np.float32))
    z = torch.zeros(4)
    out = tdisney.shade(ts, v, n, n, v, v, z, z, z.int(), torch.full((4, 4), 0.3), nee=True,
                        rand2=torch.full((3, 4), 0.6))
    assert torch.allclose(out["nee_dir"].length2(), torch.ones(4))
    assert all(torch.isfinite(c).all() for c in (out["nee_partial"].x, out["nee_partial"].y,
                                                  out["nee_partial"].z))
    assert (out["pdf_eval"] > 0).all()
