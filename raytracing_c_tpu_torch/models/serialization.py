"""Scene cache: versioned save and load.

Counterpart of `raytracing_c_tpu/models/serialization.py`, in its npz
layout: the same FORMAT_VERSION, the same keys, one entry per component
plane, so that each package loads the other's cache (the reference's
scene_save_writer / scene_load_bytes, scene.c:13-76, as a capability).

The JAX loader requires two TPU-derived tables that the port's scene has
no field for; the port writes them as the JAX package computes them:
`bvh_nodes_bf16`, the node rows with minima rounded toward -inf and maxima
toward +inf in bfloat16 (`utils/bf16.py`), and `atlas_pages`, the texels
packed r<<16|g<<8|b in 128-lane rows. On load the port ignores every key
it has no field for, and rebuilds K1's tables on a GPU as `build_scene`
does. The env-light table is never stored: a NEE render rebuilds it from
the atlas. A scene with a lightmap UV set (`Scene.lightmap_uvs`) also
writes it, in slot order, as `tri_lightmap_uv` (capacity, 3, 2); a cache
without that key, as every JAX cache, loads without the set.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracing_c_tpu_torch import BVH_WIDTH
from raytracing_c_tpu_torch.models.scene import (
    BVH,
    Background,
    Camera,
    MaterialTable,
    Scene,
    Spheres,
    TextureAtlas,
    Triangles,
    _with_k1_tables,
    resolve_device,
)
from raytracing_c_tpu_torch.utils import bf16, spans
from raytracing_c_tpu_torch.utils.vec3 import Vec3

FORMAT_VERSION = 3  # the JAX package's v3: + packed row tables

_TRI_VEC = ("v0", "e1", "e2", "n0", "n1", "n2", "ng", "tangent", "bitangent")
_TRI_SCALAR = (
    "uv0u", "uv0v", "uv1u", "uv1v", "uv2u", "uv2v", "mat_id",
    "leaf_rows", "attr_rows",
)
_MAT_VEC = ("base_color", "emission")
_MAT_SCALAR = (
    "roughness", "metalness", "normal_strength", "sheen", "sheen_tint",
    "anisotropic", "tex_albedo", "tex_normal", "tex_mr", "tex_emission",
    "shader_kind", "rows",
)
_ATLAS = ("tex_r", "tex_g", "tex_b", "offset", "width", "height")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def nodes_bf16_bits(nodes: np.ndarray) -> np.ndarray:
    """The JAX BVH's conservative bf16 twin of the node rows, as uint16
    bits (models/bvh.py of the JAX package): min columns rounded down, max
    columns rounded up, pad lanes zero."""
    w = BVH_WIDTH
    out = np.zeros(nodes.shape, np.uint16)
    out[:, :3 * w] = bf16.round_down(nodes[:, :3 * w])
    out[:, 3 * w:6 * w] = bf16.round_up(nodes[:, 3 * w:6 * w])
    return out


def atlas_pages(tex_r: np.ndarray, tex_g: np.ndarray, tex_b: np.ndarray) -> np.ndarray:
    """The JAX atlas's texel pages: r<<16|g<<8|b (uint32) in rows of 128."""
    packed = (tex_r.astype(np.uint32) << 16) | (tex_g.astype(np.uint32) << 8) \
        | tex_b.astype(np.uint32)
    pages = np.zeros((max((len(packed) + 127) // 128, 1), 128), np.uint32)
    pages.reshape(-1)[:len(packed)] = packed
    return pages


def _save_vec3(data: dict, prefix: str, v: Vec3) -> None:
    data[f"{prefix}_x"] = _np(v.x)
    data[f"{prefix}_y"] = _np(v.y)
    data[f"{prefix}_z"] = _np(v.z)


def save_scene_cache(path: str, scene: Scene) -> None:
    """Write `scene` to `path` (npz, compressed; numpy appends ".npz" to a
    path without it)."""
    atlas = scene.atlas
    data = {
        "header": np.array(
            [
                FORMAT_VERSION,
                scene.bvh.n_internal,
                scene.n_triangles,
                scene.bvh.depth,
                scene.bvh.last_row_offset,
                scene.background.kind,
                scene.background.tex_id,
            ],
            np.int64,
        ),
        "camera_view": _np(scene.camera.view_matrix),
        "camera_fov": _np(scene.camera.fov),
        "camera_focal": _np(scene.camera.focal_length),
        "bvh_nodes": _np(scene.bvh.nodes),
        "bvh_nodes_bf16": nodes_bf16_bits(_np(scene.bvh.nodes)),
        "bg_color": _np(scene.background.color),
        "sph_radius": _np(scene.spheres.radius),
        "sph_mat_id": _np(scene.spheres.mat_id),
    }
    for f in _TRI_VEC:
        _save_vec3(data, f"tri_{f}", getattr(scene.triangles, f))
    for f in _TRI_SCALAR:
        data[f"tri_{f}"] = _np(getattr(scene.triangles, f))
    for f in _MAT_VEC:
        _save_vec3(data, f"mat_{f}", getattr(scene.materials, f))
    for f in _MAT_SCALAR:
        data[f"mat_{f}"] = _np(getattr(scene.materials, f))
    for f in _ATLAS:
        data[f"atlas_{f}"] = _np(getattr(atlas, f))
    data["atlas_pages"] = atlas_pages(data["atlas_tex_r"], data["atlas_tex_g"],
                                      data["atlas_tex_b"])
    _save_vec3(data, "sph_center", scene.spheres.center)
    if scene.lightmap_uvs is not None:
        data["tri_lightmap_uv"] = np.asarray(scene.lightmap_uvs, np.float32)
    np.savez_compressed(path, **data)


def load_scene_cache(path: str, device="cuda") -> Scene:
    """Read a scene cache written by either package onto `device`. Raises
    ValueError for another format version. Spans: `load` over `parse`,
    `upload` and, on a GPU, `k1_tables`."""
    dev = resolve_device(device)
    with spans.span("load"):
        with spans.span("parse"), np.load(path) as z:
            header = z["header"]
            version = int(header[0])
            if version != FORMAT_VERSION:
                raise ValueError(f"scene cache version {version} != {FORMAT_VERSION}")
            _, n_nodes, n_triangles, depth, last_row_offset, bg_kind, bg_tex = (
                int(x) for x in header)

            t = lambda key: torch.from_numpy(np.array(z[key]))  # noqa: E731
            v3 = lambda p: Vec3(t(f"{p}_x"), t(f"{p}_y"), t(f"{p}_z"))  # noqa: E731
            bvh = BVH(nodes=t("bvh_nodes"), depth=depth, last_row_offset=last_row_offset)
            if bvh.n_internal != n_nodes:
                raise ValueError(f"scene cache: {bvh.n_internal} node rows, header says {n_nodes}")
            scene = Scene(
                triangles=Triangles(**{f: v3(f"tri_{f}") for f in _TRI_VEC},
                                    **{f: t(f"tri_{f}") for f in _TRI_SCALAR}),
                bvh=bvh,
                materials=MaterialTable(**{f: v3(f"mat_{f}") for f in _MAT_VEC},
                                        **{f: t(f"mat_{f}") for f in _MAT_SCALAR}),
                atlas=TextureAtlas(**{f: t(f"atlas_{f}") for f in _ATLAS}),
                spheres=Spheres(center=v3("sph_center"), radius=t("sph_radius"),
                                mat_id=t("sph_mat_id")),
                background=Background(kind=bg_kind, color=t("bg_color"), tex_id=bg_tex),
                camera=Camera(view_matrix=t("camera_view"), fov=t("camera_fov"),
                              focal_length=t("camera_focal")),
                n_triangles=n_triangles,
                lightmap_uvs=(np.array(z["tri_lightmap_uv"]) if "tri_lightmap_uv" in z.files
                              else None),
            )
        with spans.span("upload"):
            scene = scene.to(dev)
        return _with_k1_tables(scene)
