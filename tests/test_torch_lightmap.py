"""The port's lightmap baker (render/lightmap.py) against the JAX package's.

Tolerances: the host rasterization is the same numpy, so texel ids,
positions and normals are compared exactly. A bake draws the same
threefry streams; its Gaussian directions go through erfinv, whose
float32 result may differ from XLA's by 2 ulps (tests/test_torch_rng.py),
and through the path integrator, so texels agree within rtol/atol 1e-4
(measured 1.2e-7 on these scenes).
"""

import numpy as np
import pytest

from raytracing_c_tpu.render import lightmap as jlm
from raytracing_c_tpu_torch.render import lightmap as tlm

from helpers import quad_mesh, random_mesh, simple_scene
from torch_port_helpers import port_scene

BAKE_TOL = dict(rtol=1e-4, atol=1e-4)


def _scenes():
    half = quad_mesh()
    half.uvs = half.uvs * 0.5  # the quad covers the lower-left UV quadrant only
    return {"soup": simple_scene(random_mesh(100, np.random.default_rng(5)), bg=(0.9, 0.8, 0.7)),
            "quad": simple_scene(quad_mesh(), bg=(1.0, 1.0, 1.0)),
            "half_quad": simple_scene(half, bg=(1.0, 1.0, 1.0))}


@pytest.fixture(scope="module")
def scenes():
    return {k: (js, port_scene(js)) for k, js in _scenes().items()}


@pytest.mark.parametrize("name,w,h", [("soup", 24, 16), ("quad", 16, 16), ("half_quad", 16, 16),
                                      ("soup", 1, 1)])
def test_rasterize_identical(scenes, name, w, h):
    js, ts = scenes[name]
    want = jlm._rasterize_host(js, w, h)
    got = tlm._rasterize_host(ts, w, h)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["soup", "quad"])
def test_bake_matches_jax(scenes, name):
    """The soup's 1,368 texel records bake in two batches of 684 (one
    shape, so the JAX package compiles its trace once); the quad's 256 in
    three."""
    js, ts = scenes[name]
    kw = dict(samples=4, max_bounces=2, seed=3, batch_texels=684 if name == "soup" else 100)
    want = jlm.bake_lightmap(js, 16, 16, **kw)
    stats = {}
    got = tlm.bake_lightmap(ts, 16, 16, stats=stats, **kw)
    assert got.shape == (16, 16, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **BAKE_TOL)
    covered = (want != 0).any(-1).sum()
    assert covered > 20 and stats["texels"] >= covered and stats["rays"] >= stats["texels"] * 4


def test_texels_outside_the_uvs_stay_zero(scenes):
    js, ts = scenes["half_quad"]
    lm = tlm.bake_lightmap(ts, 16, 16, samples=4, max_bounces=2, seed=0)
    assert (lm[9:, :] == 0).all() and (lm[:, 9:] == 0).all()
    assert (lm[:8, :8] > 0).mean() > 0.9
    np.testing.assert_allclose(lm, jlm.bake_lightmap(js, 16, 16, samples=4, max_bounces=2,
                                                     seed=0), **BAKE_TOL)
