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
from torch_port_helpers import assert_scene_equal, port_mesh, port_scene


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
                          ps.Background.constant((0.2, 0.3, 0.4)), ps.Camera.default(),
                          device="cpu")


@pytest.mark.parametrize("name", ["quad", "soup9", "soup900", "soup600_mats"])
def test_build_scene_matches_jax(name):
    mesh = _meshes()[name]
    assert_scene_equal(_jax_build(mesh), _port_build(mesh))


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
    assert_scene_equal(js, port_scene(js))


def test_scene_to_moves_every_tensor():
    ts = _port_build(quad_mesh())
    moved = ts.to("cpu")
    assert moved.device == torch.device("cpu")
    assert moved.triangles.v0.x.device.type == "cpu"
    assert moved.bvh.depth == ts.bvh.depth


def _sah_meshes():
    rng = np.random.default_rng(11)
    return {"soup9": random_mesh(9, rng), "soup200": random_mesh(200, rng),
            "soup900": random_mesh(900, rng), "soup3000": random_mesh(3000, rng)}


@pytest.mark.parametrize("name", ["soup9", "soup200", "soup900", "soup3000"])
def test_sah_tree_matches_jax(name):
    """build_bvh(sah=True) builds the JAX package's SAH tree: nodes, slot map
    and packed leaf rows exact, on soups of depth 1 to 3."""
    from raytracing_c_tpu.models.scene import pack_triangles

    mesh = _sah_meshes()[name]
    jb, jmap, jcap = jbvh.build_bvh(mesh, sah=True)
    tb, tmap, tcap = pbvh.build_bvh(port_mesh(mesh), sah=True)
    assert jcap == tcap and jb.depth == tb.depth
    np.testing.assert_array_equal(jmap, tmap)
    np.testing.assert_array_equal(np.asarray(jb.nodes), tb.nodes.numpy())
    np.testing.assert_array_equal(np.asarray(pack_triangles(mesh, jmap).leaf_rows),
                                  ps.pack_triangles(port_mesh(mesh), tmap).leaf_rows.numpy())
    if name != "soup9":  # the sweep moves split positions off the midpoint
        assert not np.array_equal(tmap, pbvh.build_bvh(port_mesh(mesh), sah=False)[1])


def test_sah_scene_hits_match_the_oracle():
    """The plain K1 over a SAH scene finds the same mesh triangles at the
    same t as over the midpoint scene (slot ids mapped back to the mesh)."""
    from raytracing_c_tpu_torch.ops import traverse_cuda as tc

    from torch_port_helpers import aimed_rays, tvec

    mesh = port_mesh(_sah_meshes()["soup900"])
    o, d = aimed_rays(1024, np.random.default_rng(2))
    hits = {}
    for sah in (True, False):
        scene = ps.build_scene(mesh, ps.MaterialTable.default(), ps.TextureAtlas.empty(),
                               ps.Background.constant((0.2, 0.3, 0.4)), ps.Camera.default(),
                               device="cpu", sah=sah)
        slot_map = pbvh.build_bvh(mesh, sah=sah)[1]
        h = tc.bvh_traverse(tvec(o), tvec(d), scene.triangles, scene.bvh)
        tri = h["tri"].numpy()
        hits[sah] = (np.where(tri >= 0, slot_map[np.maximum(tri, 0)], -1), h["t"].numpy())
    np.testing.assert_array_equal(hits[True][0], hits[False][0])
    np.testing.assert_array_equal(hits[True][1], hits[False][1])
    assert 0.3 < (hits[True][0] >= 0).mean() < 1.0


def test_sah_env_var_selects_the_sah_splitter(monkeypatch):
    """RAYTPU_BVH_SAH=1, read when the module is imported, makes SAH the
    default splitter (build_bvh(sah=None))."""
    import importlib

    mesh = port_mesh(_sah_meshes()["soup900"])
    try:
        monkeypatch.setenv("RAYTPU_BVH_SAH", "1")
        importlib.reload(pbvh)
        assert pbvh.SAH_DEFAULT is True
        np.testing.assert_array_equal(pbvh.build_bvh(mesh)[1],
                                      pbvh.build_bvh(mesh, sah=True)[1])
        monkeypatch.setenv("RAYTPU_BVH_SAH", "0")
        importlib.reload(pbvh)
        assert pbvh.SAH_DEFAULT is False
        np.testing.assert_array_equal(pbvh.build_bvh(mesh)[1],
                                      pbvh.build_bvh(mesh, sah=False)[1])
    finally:
        monkeypatch.undo()
        importlib.reload(pbvh)
