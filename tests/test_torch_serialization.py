"""The port's scene cache (models/serialization.py) against the JAX
package's: the same npz layout and FORMAT_VERSION, read both ways.

Tolerance: none. Every array of a cache round trip is compared exactly,
the two TPU-derived keys the port writes for the JAX loader
(`bvh_nodes_bf16`, `atlas_pages`) bit for bit against the JAX package's
own, and the renders of a loaded scene equal the renders of the scene
that was saved.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_c_tpu.io.materials import AtlasBuilder
from raytracing_c_tpu.models import serialization as jser
from raytracing_c_tpu.models.scene import BG_EQUIRECT, Background, Camera, MaterialTable
from raytracing_c_tpu.models.scene import build_scene as jbuild_scene
from raytracing_c_tpu.render import renderer as jren
from raytracing_c_tpu.utils import bf16 as jbf16
from raytracing_c_tpu_torch.models import serialization as tser
from raytracing_c_tpu_torch.render import renderer as tren
from raytracing_c_tpu_torch.utils import bf16 as tbf16

from helpers import random_mesh
from test_torch_env_light import env_image
from torch_port_helpers import assert_scene_equal, jax_scene_arrays, port_scene, quad_sphere_scene

KW = dict(spp=1, max_bounces=2, seed=4)


def _textured_env_scene():
    rng = np.random.default_rng(11)
    b = AtlasBuilder()
    for h, w in ((9, 14), (3, 200)):
        b.add(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    tid = b.add(env_image(rng))
    mats = MaterialTable.default(2)
    mats = mats.replace(tex_albedo=jnp.asarray(np.array([1, -1], np.int32))).with_rows()
    mesh = random_mesh(300, rng)
    mesh.mat_id = (np.arange(300) % 2).astype(np.int32)
    return jbuild_scene(mesh, mats, b.build(),
                        Background(kind=BG_EQUIRECT, color=jnp.zeros((3,)), tex_id=tid),
                        Camera.default())


@pytest.fixture(scope="module", params=["textured_env", "quad_sphere"])
def jscene(request):
    return _textured_env_scene() if request.param == "textured_env" else quad_sphere_scene()


def test_port_round_trip(tmp_path, jscene):
    ts = port_scene(jscene)
    path = str(tmp_path / "port.npz")
    tser.save_scene_cache(path, ts)
    back = tser.load_scene_cache(path, device="cpu")
    assert_scene_equal(jscene, back)
    for f in ("center",):
        for c in "xyz":
            assert torch.equal(getattr(getattr(back.spheres, f), c),
                               getattr(getattr(ts.spheres, f), c))
    assert torch.equal(back.spheres.radius, ts.spheres.radius)
    assert torch.equal(back.camera.fov, ts.camera.fov)
    assert back.env_light is None
    np.testing.assert_array_equal(tren.render(back, 16, 12, nee=True, **KW)[0],
                                  tren.render(ts, 16, 12, nee=True, **KW)[0])


def test_jax_cache_loads_in_the_port(tmp_path, jscene):
    path = str(tmp_path / "jax.npz")
    jser.save_scene_cache(path, jscene)
    ts = tser.load_scene_cache(path, device="cpu")
    assert_scene_equal(jscene, ts)
    np.testing.assert_array_equal(tren.render(ts, 16, 12, **KW)[0],
                                  tren.render(port_scene(jscene), 16, 12, **KW)[0])


def test_port_cache_loads_in_jax(tmp_path, jscene):
    """The JAX loader reads the port's cache, including the bf16 node twin
    and the atlas pages it requires, bit for bit as the JAX package wrote
    them, and renders the same image."""
    path = str(tmp_path / "port.npz")
    tser.save_scene_cache(path, port_scene(jscene))
    js = jser.load_scene_cache(path)
    want, got = jax_scene_arrays(jscene), jax_scene_arrays(js)
    for key in ("bvh.nodes", "bvh.nodes_bf16", "atlas.pages", "triangles.leaf_rows",
                "triangles.attr_rows", "materials.rows", "atlas.tex_r", "camera.view_matrix",
                "spheres.radius", "background.color"):
        w_, g_ = want[key], got[key]
        assert w_.dtype == g_.dtype, key
        np.testing.assert_array_equal(w_.view(np.uint8), g_.view(np.uint8), err_msg=key)
    kw = dict(width=16, height=12, method="topk", **KW)
    np.testing.assert_array_equal(jren.render(js, **kw)[0], jren.render(jscene, **kw)[0])


def test_wrong_version_raises(tmp_path):
    ts = port_scene(quad_sphere_scene())
    path = str(tmp_path / "c.npz")
    tser.save_scene_cache(path, ts)
    with np.load(path) as z:
        data = dict(z)
    data["header"] = data["header"].copy()
    data["header"][0] = tser.FORMAT_VERSION + 1
    np.savez(path, **data)
    with pytest.raises(ValueError, match="version 4 != 3"):
        tser.load_scene_cache(path, device="cpu")
    with pytest.raises(ValueError, match="version 4 != 3"):
        jser.load_scene_cache(path)


def test_load_needs_cuda_unless_cpu_is_asked(tmp_path):
    path = str(tmp_path / "c.npz")
    tser.save_scene_cache(path, port_scene(quad_sphere_scene()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs CUDA"):
            tser.load_scene_cache(path)


def test_bf16_directed_rounding_matches_jax():
    """utils/bf16.py without ml_dtypes against the JAX package's on values
    that round both ways, exact bf16 values, signed zeros, subnormals,
    values next to the largest bf16 and the infinities."""
    rng = np.random.default_rng(2)
    x = np.concatenate([
        rng.normal(0, 3, 5000), rng.normal(0, 1e-30, 500), rng.uniform(-1e38, 1e38, 500),
        [0.0, -0.0, 1.0, -1.0, 1e-45, -1e-45, 3.3895314e38, -3.3895314e38, np.inf, -np.inf],
    ]).astype(np.float32)
    x = np.concatenate([x, jbf16.round_down(x).astype(np.float32)])
    for port, ref in ((tbf16.round_down, jbf16.round_down), (tbf16.round_up, jbf16.round_up)):
        np.testing.assert_array_equal(port(x), ref(x).view(np.uint16))
    np.testing.assert_array_equal(tbf16.to_bits(x), x.astype(jbf16.BF16).view(np.uint16))
