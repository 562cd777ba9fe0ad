"""The port's loaders (io/obj_loader.py, io/gltf_loader.py, io/loader.py)
against the JAX package's on the same files: chip_smoke.py's helmet
stand-in written as OBJ + MTL + PNG textures and as GLB (and as .gltf with
an external or a data-URI buffer), at a small size.

Tolerance: none for the meshes, materials, atlases and scene tables (both
parse the same text and bytes); the camera within 1e-6.
"""

import base64
import dataclasses
import json
import os

import numpy as np
import pytest

import chip_smoke
from raytracing_c_tpu.io import loader as jl
from raytracing_c_tpu_torch.io import gltf_loader as tg
from raytracing_c_tpu_torch.io import loader as tl
from raytracing_c_tpu_torch.models.scene import BG_CONSTANT, BG_EQUIRECT

from torch_port_helpers import assert_scene_equal

N, TEX = 6, 32  # 72 sphere triangles + the floor; 32^2 albedo, 16^2 maps
QUIET = dict(warn=lambda *a: None)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("standin")
    chip_smoke.write_glb(str(d / "standin.glb"), n=N, tex=TEX)
    chip_smoke.write_obj_mtl(str(d), n=N, tex=TEX)
    chip_smoke.write_env_map(str(d / "background.png"), 64, 32)
    doc, blob = tg.parse_glb((d / "standin.glb").read_bytes())
    (d / "standin.bin").write_bytes(blob)
    external = dict(doc, buffers=[{"uri": "standin.bin", "byteLength": len(blob)}])
    (d / "external.gltf").write_text(json.dumps(external))
    uri = "data:application/octet-stream;base64," + base64.b64encode(blob).decode()
    embedded = dict(doc, buffers=[{"uri": uri, "byteLength": len(blob)}])
    (d / "embedded.gltf").write_text(json.dumps(embedded))
    return d


MODELS = ["standin.obj", "standin.glb", "external.gltf", "embedded.gltf"]


@pytest.mark.parametrize("name", MODELS)
def test_load_model_matches_jax(files, name):
    path = str(files / name)
    jmesh, jmats, jatlas, jcam = jl.load_model(path, **QUIET)
    tmesh, tmats, tatlas, tcam = tl.load_model(path, **QUIET)
    for f in ("positions", "normals", "uvs", "mat_id"):
        a, b = getattr(jmesh, f), getattr(tmesh, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert len(jmats) == len(tmats) == 3
    for jm, tm in zip(jmats, tmats):
        assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    ja, ta = jatlas.build(), tatlas.build()
    for f in ("tex_r", "tex_g", "tex_b", "offset", "width", "height"):
        np.testing.assert_array_equal(np.asarray(getattr(ja, f)), getattr(ta, f).numpy(),
                                      err_msg=f)
    if name.endswith(".obj"):
        assert jcam is None and tcam is None
    else:
        for f in ("view_matrix", "fov", "focal_length"):
            np.testing.assert_allclose(np.asarray(getattr(jcam, f)),
                                       getattr(tcam, f).numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["standin.glb", "external.gltf", "embedded.gltf"])
def test_gltf_forms_load_the_same_model(files, name):
    ref = tl.load_model(str(files / "standin.glb"), **QUIET)
    got = tl.load_model(str(files / name), **QUIET)
    np.testing.assert_array_equal(got[0].positions, ref[0].positions)
    np.testing.assert_array_equal(got[2].build().tex_r.numpy(), ref[2].build().tex_r.numpy())


def test_glb_is_the_standin(files):
    """The GLB's node hierarchy puts the stand-in where standin_parts has
    it; its three materials come through with sheen and textures."""
    (pos, _nrm, _uv, mat), _tex, view = chip_smoke.standin_parts(np, N, TEX)
    mesh, mats, _atlas, cam = tl.load_model(str(files / "standin.glb"), **QUIET)
    order = np.argsort(mat, kind="stable")
    np.testing.assert_allclose(mesh.positions, pos[order], atol=2e-6)
    np.testing.assert_array_equal(mesh.mat_id, mat[order])
    np.testing.assert_allclose(cam.view_matrix.numpy(), view, atol=1e-7)
    assert [m.tex_albedo for m in mats] == [1, -1, -1] and mats[2].sheen == pytest.approx(0.5)


@pytest.mark.parametrize("name", ["standin.obj", "standin.glb"])
@pytest.mark.parametrize("env", [True, False])
def test_load_scene_matches_jax(files, name, env, monkeypatch):
    monkeypatch.chdir(files)
    bg = "background.png" if env else None
    js = jl.load_scene(name, background_path=bg, **QUIET)
    ts = tl.load_scene(name, background_path=bg, device="cpu", **QUIET)
    assert_scene_equal(js, ts)
    assert ts.device.type == "cpu"
    if env:
        assert ts.background.kind == BG_EQUIRECT and ts.background.tex_id == 4
    else:
        assert ts.background.kind == BG_CONSTANT
        np.testing.assert_array_equal(ts.background.color.numpy(),
                                      np.float32(tl.DEFAULT_SKY))


def test_missing_env_map_is_fatal(files):
    path = str(files / "nowhere.png")
    with pytest.raises(FileNotFoundError, match="Failed to load texture: '.*nowhere.png'"):
        tl.load_scene(str(files / "standin.obj"), background_path=path, device="cpu", **QUIET)


def test_undecodable_env_map_is_fatal(files, tmp_path):
    bad = tmp_path / "background.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n not really")
    with pytest.raises(FileNotFoundError, match="Failed to load texture"):
        tl.load_scene(str(files / "standin.obj"), background_path=str(bad), device="cpu",
                      **QUIET)


def test_unknown_extension_raises(tmp_path):
    p = tmp_path / "model.stl"
    p.write_text("solid x\n")
    with pytest.raises(ValueError, match="Unrecognized file type"):
        tl.load_model(str(p), **QUIET)


def test_missing_texture_degrades_with_warning(files, tmp_path):
    """A texture the MTL names but the disk lacks leaves the slot empty and
    warns, as in the JAX package."""
    for name in ("standin.obj", "standin.mtl", "normal.png", "mr.png"):
        (tmp_path / name).write_bytes((files / name).read_bytes())
    warnings = []
    _mesh, mats, _atlas, _ = tl.load_model(str(tmp_path / "standin.obj"), warn=warnings.append)
    jwarn = []
    _, jmats, _, _ = jl.load_model(str(tmp_path / "standin.obj"), warn=jwarn.append)
    assert mats[0].tex_albedo == jmats[0].tex_albedo == -1
    assert any("albedo.png" in w for w in warnings) and len(warnings) == len(jwarn)
    assert os.path.exists(tmp_path / "mr.png")


def _glb(doc: dict, blob: bytes) -> bytes:
    """A GLB container of a glTF document and its binary buffer."""
    import struct

    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\0" * (-len(blob) % 4)
    body = struct.pack("<II", len(js), 0x4E4F534A) + js + struct.pack("<II", len(blob), 0x004E4942)
    return struct.pack("<III", 0x46546C67, 2, 12 + len(body) + len(blob)) + body + blob


def test_glb_texcoord_1_loads_as_lightmap_uvs(files, tmp_path):
    """The stand-in GLB with a TEXCOORD_1 accessor added to its first
    primitive: that primitive's triangles carry it as lightmap UVs, the
    others zero; the rest of the mesh is unchanged. Without TEXCOORD_1 a
    mesh carries no set."""
    doc, blob = tg.parse_glb((files / "standin.glb").read_bytes())
    plain, _, _, _ = tg.load_gltf(str(files / "standin.glb"), **QUIET)
    assert plain.lightmap_uvs is None
    prim = doc["meshes"][0]["primitives"][0]
    count = doc["accessors"][prim["attributes"]["POSITION"]]["count"]
    uv1 = np.random.default_rng(3).uniform(0, 1, (count, 2)).astype(np.float32)
    blob = blob + b"\0" * (-len(blob) % 4)
    doc["bufferViews"].append({"buffer": 0, "byteOffset": len(blob), "byteLength": uv1.nbytes})
    doc["accessors"].append({"bufferView": len(doc["bufferViews"]) - 1, "componentType": 5126,
                             "count": count, "type": "VEC2"})
    prim["attributes"]["TEXCOORD_1"] = len(doc["accessors"]) - 1
    doc["buffers"][0]["byteLength"] = len(blob) + uv1.nbytes
    (tmp_path / "lightmapped.glb").write_bytes(_glb(doc, blob + uv1.tobytes()))
    mesh, _, _, _ = tg.load_gltf(str(tmp_path / "lightmapped.glb"), **QUIET)
    for k in ("positions", "normals", "uvs", "mat_id"):
        np.testing.assert_array_equal(getattr(mesh, k), getattr(plain, k))
    idx = (tg._read_accessor(doc, [blob], prim["indices"]).astype(np.int64).reshape(-1, 3)
           if "indices" in prim else np.arange(count).reshape(-1, 3))
    first = len(idx)
    assert mesh.lightmap_uvs.shape == mesh.uvs.shape and mesh.lightmap_uvs.dtype == np.float32
    np.testing.assert_array_equal(mesh.lightmap_uvs[:first], uv1[idx])
    assert first < len(mesh.uvs) and (mesh.lightmap_uvs[first:] == 0).all()
    scene = tl.load_scene(str(tmp_path / "lightmapped.glb"), background_path=None, device="cpu",
                          **QUIET)
    assert scene.lightmap_uvs.shape == (scene.triangles.capacity, 3, 2)
    assert np.isin(uv1[idx].reshape(-1, 2), scene.lightmap_uvs.reshape(-1, 2)).all()
