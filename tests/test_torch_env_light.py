"""The port's env-light sampler (ops/env_light.py) and the NEE half of its
Disney module against the JAX package on the same seeded numpy inputs.

Tolerances: the alias tables are built on the host in float64 by the same
loop, so `prob`, `alias` and `lum_p` are compared exactly. The sampler and
pdf are float32 formulas through sin/cos/atan2/asin, which differ between
XLA and torch by an ulp or so: directions within 1e-5, pdfs within
rtol 1e-4 (their 1/sin(theta) amplifies an ulp of cos near the poles:
measured 2.2e-5 on 1 of 20,000 lanes). eval_disney_brdf goes through pow and
rsqrt: rtol/atol 2e-5, as the shading tests allow.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_c_tpu.io.materials import AtlasBuilder
from raytracing_c_tpu.models.scene import BG_EQUIRECT, Background, Camera, MaterialTable
from raytracing_c_tpu.models.scene import build_scene as jbuild_scene
from raytracing_c_tpu.ops import disney as jdisney
from raytracing_c_tpu.ops import env_light as jel
from raytracing_c_tpu_torch.ops import disney as tdisney
from raytracing_c_tpu_torch.ops import env_light as tel

from helpers import random_mesh
from torch_port_helpers import jvec, np3, port_scene, tvec

TRANS_TOL = dict(rtol=2e-5, atol=2e-5)


def env_image(rng, h=32, w=64):
    """A dim seeded sky with a bright sun block and a black band."""
    img = rng.integers(5, 40, (h, w, 3), dtype=np.int64)
    img[6:9, 20:25] = 255
    img[h - 4:] = 0
    return img.astype(np.uint8)


def env_scenes(rng, img):
    """A JAX scene with `img` as its equirect background (its build_scene
    builds the env-light table) and the port's copy of it."""
    b = AtlasBuilder()
    b.add(rng.integers(0, 256, (5, 7, 3), dtype=np.uint8))
    tid = b.add(img)
    js = jbuild_scene(random_mesh(20, rng), MaterialTable.default(), b.build(),
                      Background(kind=BG_EQUIRECT, color=jnp.zeros((3,)), tex_id=tid),
                      Camera.default())
    return js, port_scene(js), tid


def _flat(pages, n):
    return np.asarray(pages).reshape(-1)[:n]


def test_tables_bit_identical(rng):
    js, ts, tid = env_scenes(rng, env_image(rng))
    want = js.env_light
    got = tel.build_env_light(ts.atlas, tid)
    n = 64 * 32
    assert (got.w, got.h) == (want.w, want.h) == (64, 32)
    for name in ("prob", "alias", "lum_p"):
        w_ = _flat(getattr(want, name), n)
        g_ = getattr(got, name).numpy()
        assert g_.shape == (n,)
        np.testing.assert_array_equal(w_.astype(g_.dtype), g_, err_msg=name)
    assert got.seconds > 0.0


def test_black_map_has_no_table(rng):
    js, ts, tid = env_scenes(rng, np.zeros((8, 16, 3), np.uint8))
    assert js.env_light is None
    assert tel.build_env_light(ts.atlas, tid) is None
    assert tel.scene_env_light(ts) is None


def test_scene_env_light_builds_once(rng):
    _, ts, _ = env_scenes(rng, env_image(rng))
    assert ts.env_light is None  # never read from the JAX arrays
    env = tel.scene_env_light(ts)
    assert env is not None and tel.scene_env_light(ts) is env
    moved = ts.to(torch.device("cpu"))
    assert isinstance(moved.env_light, tel.EnvLight)


def test_sample_and_eval_pdf(rng):
    js, ts, _ = env_scenes(rng, env_image(rng))
    env = tel.scene_env_light(ts)
    u = rng.uniform(0, 1, (3, 20000)).astype(np.float32)
    u[:, :4] = [[0.0, 0.999999, 0.5, 0.25], [0.0, 0.999999, 0.0, 1.0 - 2**-24],
                [0.0, 0.999999, 1.0 - 2**-24, 0.0]]
    jd, jp = jel.sample(js.env_light, *(jnp.asarray(c) for c in u))
    td, tp = tel.sample(env, *(torch.from_numpy(c) for c in u))
    np.testing.assert_allclose(np3(jd), np3(td), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jp), tp.numpy(), rtol=1e-4)
    # eval_pdf at random directions, at the samples and at the poles
    d = rng.normal(size=(20000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:4] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0]]
    for dirs in (d, np3(td)):
        want = np.asarray(jel.eval_pdf(js.env_light, jvec(dirs)))
        got = tel.eval_pdf(env, tvec(dirs)).numpy()
        np.testing.assert_allclose(want, got, rtol=1e-4)


def test_eval_disney_brdf(rng):
    r = 8192
    base = rng.uniform(0, 1, (r, 3)).astype(np.float32)
    rough, metal, sheen, tint = rng.uniform(0.001, 1, (4, r)).astype(np.float32)
    metal[: r // 4] = 0.0
    w_in = rng.normal(size=(r, 3)).astype(np.float32)
    w_out = rng.normal(size=(r, 3)).astype(np.float32)
    w_in /= np.linalg.norm(w_in, axis=-1, keepdims=True)
    w_out /= np.linalg.norm(w_out, axis=-1, keepdims=True)
    w_in[:, 2] = np.abs(w_in[:, 2])
    w_in[:16, 2] *= -1  # viewer below the surface: f and pdf are 0
    sc = lambda a: jnp.asarray(a)  # noqa: E731
    jf, jpdf = jdisney.eval_disney_brdf(jvec(base), sc(rough), sc(metal), sc(sheen), sc(tint),
                                        jvec(w_in), jvec(w_out))
    t = torch.from_numpy
    tf, tpdf = tdisney.eval_disney_brdf(tvec(base), t(rough), t(metal), t(sheen), t(tint),
                                        tvec(w_in), tvec(w_out))
    np.testing.assert_allclose(np3(jf), np3(tf), **TRANS_TOL)
    np.testing.assert_allclose(np.asarray(jpdf), tpdf.numpy(), **TRANS_TOL)
    below = (w_in[:, 2] <= 0) | (w_out[:, 2] <= 0)
    assert (tpdf.numpy()[below] == 0).all() and (tpdf.numpy()[~below] > 0).all()


@pytest.mark.parametrize("n", [1, 4097])
def test_sample_uniform_sphere(rng, n):
    u1, u2 = rng.uniform(0, 1, (2, n)).astype(np.float32)
    want = jdisney.sample_uniform_sphere(jnp.asarray(u1), jnp.asarray(u2))
    got = tdisney.sample_uniform_sphere(torch.from_numpy(u1), torch.from_numpy(u2))
    np.testing.assert_allclose(np3(want), np3(got), rtol=0, atol=1e-6)
    assert tdisney.UNIFORM_SPHERE_PDF == jdisney.UNIFORM_SPHERE_PDF
