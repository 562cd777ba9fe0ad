"""Scene construction in the port against the JAX package: the port's own
build_scene (host numpy BVH build) and the scene_from_numpy bridge must
give arrays equal to the JAX scene's (tolerance: none, exact equality)."""

import numpy as np
import pytest
import torch

from raytracing_c_tpu.models import bvh as jbvh
from raytracing_c_tpu.models.scene import (
    Background, Camera, MaterialTable, TextureAtlas, build_scene,
)
from raytracing_c_tpu_torch.models import bvh as pbvh
from raytracing_c_tpu_torch.models import scene as ps

from helpers import quad_mesh, random_mesh
from torch_port_helpers import jax_scene_arrays, port_mesh, port_scene

_TRI_FIELDS = ("v0", "e1", "e2", "n0", "n1", "n2", "ng", "tangent", "bitangent")


def _meshes():
    rng = np.random.default_rng(5)
    return {
        "quad": quad_mesh(),
        "soup9": random_mesh(9, rng),
        "soup900": random_mesh(900, rng),
        "soup600_mats": _with_mats(random_mesh(600, rng), 3),
    }


def _with_mats(mesh, k):
    mesh.mat_id = (np.arange(mesh.mat_id.shape[0]) % k).astype(np.int32)
    return mesh


def _jax_build(mesh):
    mats = MaterialTable.default(int(mesh.mat_id.max()) + 1)
    return build_scene(mesh, mats, TextureAtlas.empty(), Background.constant((0.2, 0.3, 0.4)),
                       Camera.default())


def _port_build(mesh):
    mats = ps.MaterialTable.default(int(mesh.mat_id.max()) + 1)
    return ps.build_scene(port_mesh(mesh), mats, ps.TextureAtlas.empty(),
                          ps.Background.constant((0.2, 0.3, 0.4)), ps.Camera.default())


def _assert_scene_equal(js, ts):
    a = jax_scene_arrays(js)
    np.testing.assert_array_equal(a["bvh.nodes"], ts.bvh.nodes.numpy())
    assert int(a["bvh.depth"]) == ts.bvh.depth
    assert int(a["bvh.last_row_offset"]) == ts.bvh.last_row_offset
    tr = ts.triangles
    np.testing.assert_array_equal(a["triangles.leaf_rows"], tr.leaf_rows.numpy())
    np.testing.assert_array_equal(a["triangles.attr_rows"], tr.attr_rows.numpy())
    np.testing.assert_array_equal(a["triangles.mat_id"], tr.mat_id.numpy())
    for f in _TRI_FIELDS:
        for c in "xyz":
            np.testing.assert_array_equal(
                a[f"triangles.{f}.{c}"], getattr(getattr(tr, f), c).numpy(), err_msg=f
            )
    for f in ("uv0u", "uv0v", "uv1u", "uv1v", "uv2u", "uv2v"):
        np.testing.assert_array_equal(a[f"triangles.{f}"], getattr(tr, f).numpy())
    np.testing.assert_array_equal(a["materials.rows"], ts.materials.rows.numpy())
    for f in ("tex_r", "tex_g", "tex_b", "offset", "width", "height"):
        np.testing.assert_array_equal(a[f"atlas.{f}"], getattr(ts.atlas, f).numpy())
    np.testing.assert_array_equal(a["camera.view_matrix"], ts.camera.view_matrix.numpy())
    np.testing.assert_array_equal(a["camera.focal_length"], ts.camera.focal_length.numpy())
    np.testing.assert_array_equal(a["background.color"], ts.background.color.numpy())
    assert int(a["n_triangles"]) == ts.n_triangles


@pytest.mark.parametrize("name", ["quad", "soup9", "soup900", "soup600_mats"])
def test_build_scene_matches_jax(name):
    mesh = _meshes()[name]
    _assert_scene_equal(_jax_build(mesh), _port_build(mesh))


@pytest.mark.parametrize("name", ["quad", "soup900"])
def test_slot_map_matches_jax(name):
    mesh = _meshes()[name]
    _, jmap, jcap = jbvh.build_bvh(mesh, sah=False)
    _, tmap, tcap = pbvh.build_bvh(port_mesh(mesh))
    assert jcap == tcap
    np.testing.assert_array_equal(jmap, tmap)


@pytest.mark.parametrize("name", ["quad", "soup900"])
def test_scene_from_numpy_matches_jax(name):
    js = _jax_build(_meshes()[name])
    _assert_scene_equal(js, port_scene(js))


def test_scene_to_moves_every_tensor():
    ts = _port_build(quad_mesh())
    moved = ts.to("cpu")
    assert moved.device == torch.device("cpu")
    assert moved.triangles.v0.x.device.type == "cpu"
    assert moved.bvh.depth == ts.bvh.depth
