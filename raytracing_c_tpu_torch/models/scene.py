"""Scene representation: dataclasses of tensors, component-plane layouts.

Counterpart of `raytracing_c_tpu/models/scene.py`. The layouts are the JAX
package's, so its arrays carry across unchanged (`scene_from_numpy`):

- node i's children are `8*i + 1 + j`; children with index >=
  `last_row_offset` are leaf blocks `child - last_row_offset`
  (scene.h:72-90). `BVH.nodes` rows hold the 8 child boxes as
  component * 8 + child for (min.xyz, max.xyz), 128 floats per row.
- `Triangles.leaf_rows[b]` holds leaf block b's 8 triangles as 9 groups of
  8 lanes [v0.xyz | e1.xyz | e2.xyz]; `attr_rows[i]` holds triangle i's
  shading attributes at the ATTR_* columns.
- textures are three flat u8 planes with per-texture offset and size.

The TPU-only derived tables of the JAX scene (Pallas tables, bf16 node
twin, texture pages) have no counterpart (the scene cache writes the two
its format requires, `models/serialization.py`). On a GPU, `build_scene` and
`scene_from_numpy` also build the traversal kernel's own node and triangle
tables from the rows above (`ops/traverse_cuda.py:k1_tables`, cached on the
BVH), so that the load, not the first render batch, pays for them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from raytracing_c_tpu_torch import BVH_WIDTH
from raytracing_c_tpu_torch.utils import spans
from raytracing_c_tpu_torch.utils.vec3 import Vec3

# Shader kinds (reference: disney_shader_proc driver.c:350, debug_shader_proc
# driver.c:411).
SHADER_DISNEY = 0
SHADER_DEBUG_NORMAL = 1

# Background kinds (reference Background_Proc scene.h:65-70).
BG_CONSTANT = 0
BG_EQUIRECT = 1

# Column layout of Triangles.attr_rows (per-triangle shading attributes).
ATTR_N0 = 0  # 0-2   vertex normal a
ATTR_N1 = 3  # 3-5   vertex normal b
ATTR_N2 = 6  # 6-8   vertex normal c
ATTR_NG = 9  # 9-11  geometric normal
ATTR_TAN = 12  # 12-14 tangent
ATTR_BTN = 15  # 15-17 bitangent
ATTR_UV = 18  # 18-23 uv0u, uv0v, uv1u, uv1v, uv2u, uv2v
ATTR_MAT = 24  # 24    material id (stored as f32)
ATTR_COLS = 25

# Column layout of MaterialTable.rows (one row per material).
MROW_BASE = 0  # 0-2 base color
MROW_EMI = 3  # 3-5 emission
MROW_ROUGH = 6
MROW_METAL = 7
MROW_NSTR = 8
MROW_SHEEN = 9
MROW_SHEENT = 10
MROW_ANISO = 11
MROW_TEX_ALBEDO = 12  # texture ids stored as f32 (-1 = none)
MROW_TEX_NORMAL = 13
MROW_TEX_MR = 14
MROW_TEX_EMI = 15
MROW_KIND = 16
MROW_COLS = 17


def _t(a, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def _vec3(a: np.ndarray) -> Vec3:
    """(N, 3) numpy -> Vec3 of (N,) float32 planes."""
    a = np.asarray(a, np.float32)
    return Vec3(_t(a[:, 0]), _t(a[:, 1]), _t(a[:, 2]))


def _to(obj, device):
    """Copy every tensor (and Vec3 plane) of a dataclass to `device`."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        elif isinstance(v, Vec3):
            v = v.map(lambda a: a.to(device))
        elif dataclasses.is_dataclass(v):
            v = v.to(device)
        out[f.name] = v
    return dataclasses.replace(obj, **out)


@dataclass
class Camera:
    """Pinhole camera (scene.h:14-17). `view_matrix` is camera-to-world."""

    view_matrix: torch.Tensor  # (4, 4) f32
    fov: torch.Tensor  # () f32, radians
    focal_length: torch.Tensor  # () f32 = 1 / tan(fov / 2)

    @staticmethod
    def default() -> "Camera":
        """Position (0,0,3), identity rotation, 70 degree fov (driver.c:765-767)."""
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [0.0, 0.0, 3.0]
        return Camera.look(m, 70.0)

    @staticmethod
    def look(view_matrix: np.ndarray, fov_deg: float) -> "Camera":
        fov = np.float32(fov_deg / 360.0 * 2.0 * np.pi)
        return Camera(
            view_matrix=_t(view_matrix, torch.float32),
            fov=torch.tensor(fov),
            focal_length=torch.tensor(np.float32(1.0 / np.tan(fov * 0.5))),
        )

    to = _to


@dataclass
class Triangles:
    """Padded SoA triangle store, leaf-block-major (scene.h:44-63). Padding
    slots are all zero, which the epsilon tests reject."""

    v0: Vec3
    e1: Vec3
    e2: Vec3
    n0: Vec3
    n1: Vec3
    n2: Vec3
    ng: Vec3
    tangent: Vec3
    bitangent: Vec3
    uv0u: torch.Tensor
    uv0v: torch.Tensor
    uv1u: torch.Tensor
    uv1v: torch.Tensor
    uv2u: torch.Tensor
    uv2v: torch.Tensor
    mat_id: torch.Tensor  # (N,) i32, -1 for padding slots
    leaf_rows: torch.Tensor  # (N / 8, 128) f32
    attr_rows: torch.Tensor  # (N, 128) f32

    @property
    def capacity(self) -> int:
        return self.mat_id.shape[0]

    to = _to


@dataclass
class BVH:
    """Implicit complete 8-ary BVH; internal nodes only (scene.h:72-90)."""

    nodes: torch.Tensor  # (n_internal, 128) f32
    depth: int
    last_row_offset: int

    @property
    def n_internal(self) -> int:
        return self.nodes.shape[0]

    def child_boxes_np(self):
        """(n_internal, 8, 3) mins and maxs as numpy, from the node rows
        (cols = component * 8 + child for min.xyz, max.xyz); host tooling."""
        t = self.nodes.detach().cpu().numpy()[:, : 6 * BVH_WIDTH]
        t = t.reshape(-1, 6, BVH_WIDTH).transpose(0, 2, 1)  # (n, 8, 6)
        return np.ascontiguousarray(t[..., :3]), np.ascontiguousarray(t[..., 3:])

    to = _to


@dataclass
class MaterialTable:
    """PBR material parameters (PBR_Shader_Data, driver.c:191-198) plus the
    packed `rows` table (MROW_* columns) the shader gathers from."""

    base_color: Vec3
    emission: Vec3
    roughness: torch.Tensor
    metalness: torch.Tensor
    normal_strength: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    anisotropic: torch.Tensor
    tex_albedo: torch.Tensor  # (M,) i32, -1 = none
    tex_normal: torch.Tensor
    tex_mr: torch.Tensor
    tex_emission: torch.Tensor
    shader_kind: torch.Tensor
    rows: torch.Tensor | None = None

    def with_rows(self) -> "MaterialTable":
        """(Re)build the packed row table from the field tensors."""
        m = self.roughness.shape[0]
        rows = torch.zeros((m, 128), dtype=torch.float32, device=self.roughness.device)
        for c, v in ((MROW_BASE, self.base_color), (MROW_EMI, self.emission)):
            rows[:, c], rows[:, c + 1], rows[:, c + 2] = v.x, v.y, v.z
        for c, v in (
            (MROW_ROUGH, self.roughness), (MROW_METAL, self.metalness),
            (MROW_NSTR, self.normal_strength), (MROW_SHEEN, self.sheen),
            (MROW_SHEENT, self.sheen_tint), (MROW_ANISO, self.anisotropic),
            (MROW_TEX_ALBEDO, self.tex_albedo), (MROW_TEX_NORMAL, self.tex_normal),
            (MROW_TEX_MR, self.tex_mr), (MROW_TEX_EMI, self.tex_emission),
            (MROW_KIND, self.shader_kind),
        ):
            rows[:, c] = v.to(torch.float32)
        return dataclasses.replace(self, rows=rows)

    @staticmethod
    def default(n: int = 1) -> "MaterialTable":
        """Mid-grey diffuse materials (MTL defaults, driver.c:549-556)."""
        f = lambda v: torch.full((n,), v, dtype=torch.float32)  # noqa: E731
        i = lambda v: torch.full((n,), v, dtype=torch.int32)  # noqa: E731
        return MaterialTable(
            base_color=Vec3(f(0.8), f(0.8), f(0.8)),
            emission=Vec3(f(0.0), f(0.0), f(0.0)),
            roughness=f(0.5), metalness=f(0.0), normal_strength=f(0.0),
            sheen=f(0.0), sheen_tint=f(0.0), anisotropic=f(0.0),
            tex_albedo=i(-1), tex_normal=i(-1), tex_mr=i(-1),
            tex_emission=i(-1), shader_kind=i(0),
        ).with_rows()

    to = _to


@dataclass
class TextureAtlas:
    """Textures packed into three flat u8 channel planes: texture k owns
    texels [offset[k], offset[k] + width[k]*height[k]) in row-major order.
    Index 0 is a 1x1 white dummy so "no texture" lanes gather in bounds."""

    tex_r: torch.Tensor  # (T,) u8
    tex_g: torch.Tensor
    tex_b: torch.Tensor
    offset: torch.Tensor  # (K,) i32
    width: torch.Tensor
    height: torch.Tensor

    @staticmethod
    def empty() -> "TextureAtlas":
        one = torch.full((1,), 255, dtype=torch.uint8)
        k = torch.ones((1,), dtype=torch.int32)
        return TextureAtlas(one, one, one, k * 0, k, k)

    @staticmethod
    def pack(images) -> "TextureAtlas":
        """Pack (h, w, 3) u8 images; texture k + 1 is images[k] (slot 0 is
        the white dummy)."""
        planes = [np.full((1, 3), 255, np.uint8)]
        offs, ws, hs = [0], [1], [1]
        total = 1
        for img in images:
            h, w, _ = img.shape
            offs.append(total)
            ws.append(w)
            hs.append(h)
            planes.append(np.asarray(img, np.uint8).reshape(-1, 3))
            total += w * h
        flat = np.concatenate(planes)
        return TextureAtlas(
            _t(flat[:, 0]), _t(flat[:, 1]), _t(flat[:, 2]),
            _t(np.array(offs, np.int32)), _t(np.array(ws, np.int32)),
            _t(np.array(hs, np.int32)),
        )

    to = _to


@dataclass
class Spheres:
    """Analytic sphere primitives (raytracer.h:35-42)."""

    center: Vec3
    radius: torch.Tensor  # (S,) f32
    mat_id: torch.Tensor  # (S,) i32

    @staticmethod
    def make(centers, radii, mat_ids) -> "Spheres":
        return Spheres(
            center=_vec3(np.asarray(centers, np.float32).reshape(-1, 3)),
            radius=_t(np.asarray(radii, np.float32)),
            mat_id=_t(np.asarray(mat_ids, np.int32)),
        )

    @staticmethod
    def empty() -> "Spheres":
        return Spheres.make(np.zeros((0, 3)), [], [])

    @property
    def count(self) -> int:
        return self.radius.shape[0]

    to = _to


@dataclass
class Background:
    """Constant colour or equirect env map (sample_background driver.c:95-104)."""

    kind: int = BG_CONSTANT
    color: torch.Tensor = field(default_factory=lambda: torch.zeros(3))
    tex_id: int = -1

    @staticmethod
    def constant(rgb) -> "Background":
        return Background(BG_CONSTANT, torch.tensor(rgb, dtype=torch.float32), -1)

    @staticmethod
    def equirect(tex_id: int) -> "Background":
        """The atlas texture `tex_id` as an equirect environment map."""
        return Background(BG_EQUIRECT, torch.zeros(3, dtype=torch.float32), tex_id)

    to = _to


@dataclass
class Scene:
    """Scene{bvh, camera, triangles, background} (scene.h:92-97) plus
    material/texture tables and optional spheres."""

    triangles: Triangles
    bvh: BVH
    materials: MaterialTable
    atlas: TextureAtlas
    spheres: Spheres
    background: Background
    camera: Camera
    n_triangles: int = 0
    #: the lightmap UV set (`HostMesh.lightmap_uvs`) in slot order, (capacity,
    #: 3, 2) float32 and zero in empty slots, or None; kept on the host, where
    #: the bake's rasterizer is its only reader (`render/lightmap.py`)
    lightmap_uvs: np.ndarray | None = None
    #: env-light sampling tables (ops/env_light.EnvLight) for NEE over an
    #: equirect background: derived from the atlas, built by the first NEE
    #: render (`env_light.scene_env_light`), never read from arrays or files
    env_light: object = None

    @property
    def device(self) -> torch.device:
        return self.bvh.nodes.device

    to = _to


# ---------------------------------------------------------------------------
# Host-side construction (numpy in, tensors out)
# ---------------------------------------------------------------------------


@dataclass
class HostMesh:
    """Host triangle soup before the BVH build (Triangle_Slice, scene.h:37-44)."""

    positions: np.ndarray  # (n, 3, 3) f32  [tri, vertex, xyz]
    normals: np.ndarray  # (n, 3, 3) f32
    uvs: np.ndarray  # (n, 3, 2) f32
    mat_id: np.ndarray  # (n,) i32
    #: a second, unique UV set for lightmaps (glTF TEXCOORD_1), (n, 3, 2)
    #: f32, or None: a bake rasterizes it in place of `uvs`
    lightmap_uvs: np.ndarray | None = None


def compute_tangents(positions: np.ndarray, uvs: np.ndarray):
    """Face normal + per-triangle tangent/bitangent from UV deltas with the
    degenerate-UV clamp (triangles_insert, scene.c:105-155).
    Returns (ng, tangent, bitangent), each (n, 3) f32."""
    p0, p1, p2 = positions[:, 0], positions[:, 1], positions[:, 2]
    e1 = p1 - p0
    e2 = p2 - p0

    ng = np.cross(e1, e2)
    ng = ng / np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-30)

    duv1 = uvs[:, 1] - uvs[:, 0]
    duv2 = uvs[:, 2] - uvs[:, 0]
    d = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    # degenerate-UV clamp (scene.c:128-135): |d| < 1e-4 snaps to +/-1e-4
    small = np.abs(d) < 1e-4
    d = np.where(small, np.where(d < 0, -1e-4, 1e-4), d)
    inv_d = (1.0 / d)[:, None]

    tangent = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv_d
    bitangent = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * inv_d

    def _norm(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-30)

    return (
        ng.astype(np.float32),
        _norm(tangent).astype(np.float32),
        _norm(bitangent).astype(np.float32),
    )


def place_in_slots(a: np.ndarray, slot_map: np.ndarray) -> np.ndarray:
    """Per-triangle rows `a` placed in the BVH build's leaf slots (-1 =
    empty padding slot -> zero)."""
    valid = slot_map >= 0
    out = a[np.where(valid, slot_map, 0)]
    out[~valid] = 0
    return out


def pack_triangles(mesh: HostMesh, slot_map: np.ndarray) -> Triangles:
    """Pack host triangles into the SoA layout by the BVH build's leaf-slot
    assignment (-1 = empty padding slot -> all zero). The lightmap UV set,
    which no kernel reads, is placed by `build_scene` the same way."""
    capacity = len(slot_map)
    if capacity % BVH_WIDTH:
        raise ValueError(f"capacity {capacity} is not a multiple of {BVH_WIDTH}")
    valid = slot_map >= 0
    pos = place_in_slots(mesh.positions.astype(np.float32), slot_map)
    nrm = place_in_slots(mesh.normals.astype(np.float32), slot_map)
    uv = place_in_slots(mesh.uvs.astype(np.float32), slot_map)
    ng, tan, btn = compute_tangents(pos, uv)
    ng[~valid] = 0.0
    tan[~valid] = 0.0
    btn[~valid] = 0.0
    mat = place_in_slots(mesh.mat_id.astype(np.int32), slot_map)
    mat[~valid] = -1

    v0, v1, v2 = pos[:, 0], pos[:, 1], pos[:, 2]
    e1, e2 = v1 - v0, v2 - v0

    n_blocks = capacity // BVH_WIDTH
    comps = np.concatenate([v0, e1, e2], axis=1)  # (capacity, 9)
    rows = np.zeros((n_blocks, 128), np.float32)
    rows[:, : 9 * BVH_WIDTH] = (
        comps.reshape(n_blocks, BVH_WIDTH, 9).transpose(0, 2, 1).reshape(n_blocks, -1)
    )

    attr = np.zeros((capacity, 128), np.float32)
    attr[:, ATTR_N0:ATTR_N0 + 3] = nrm[:, 0]
    attr[:, ATTR_N1:ATTR_N1 + 3] = nrm[:, 1]
    attr[:, ATTR_N2:ATTR_N2 + 3] = nrm[:, 2]
    attr[:, ATTR_NG:ATTR_NG + 3] = ng
    attr[:, ATTR_TAN:ATTR_TAN + 3] = tan
    attr[:, ATTR_BTN:ATTR_BTN + 3] = btn
    attr[:, ATTR_UV:ATTR_UV + 6] = uv.reshape(capacity, 6)
    attr[:, ATTR_MAT] = mat.astype(np.float32)

    return Triangles(
        v0=_vec3(v0), e1=_vec3(e1), e2=_vec3(e2),
        n0=_vec3(nrm[:, 0]), n1=_vec3(nrm[:, 1]), n2=_vec3(nrm[:, 2]),
        ng=_vec3(ng), tangent=_vec3(tan), bitangent=_vec3(btn),
        uv0u=_t(uv[:, 0, 0]), uv0v=_t(uv[:, 0, 1]),
        uv1u=_t(uv[:, 1, 0]), uv1v=_t(uv[:, 1, 1]),
        uv2u=_t(uv[:, 2, 0]), uv2v=_t(uv[:, 2, 1]),
        mat_id=_t(mat), leaf_rows=_t(rows), attr_rows=_t(attr),
    )


def resolve_device(device) -> torch.device:
    """torch.device(device), raising for a CUDA device when there is none:
    an entry point never carries on on the CPU unless it was asked to."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs CUDA, but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU"
        )
    return dev


def build_scene(
    mesh: HostMesh,
    materials: MaterialTable,
    atlas: TextureAtlas,
    background: Background,
    camera: Camera,
    spheres: Spheres | None = None,
    device="cuda",
    sah: bool | None = None,
) -> Scene:
    """scene_init (scene.c:416-426): build the BVH (`sah` picks the splitter,
    `models/bvh.py:build_bvh`) and pack the SoA store on the host, then put
    the scene on `device`; the mesh's lightmap UV set, if any, stays on the
    host in slot order (`Scene.lightmap_uvs`). Spans: `bvh` (the build and
    the packing; its triangles, depth, slots and occupied leaf blocks),
    `upload`, and K1's `k1_tables` on a GPU."""
    from raytracing_c_tpu_torch.models.bvh import build_bvh

    dev = resolve_device(device)
    with spans.span("bvh"):
        bvh, slot_map, capacity = build_bvh(mesh, sah)
        triangles = pack_triangles(mesh, slot_map)
        lightmap_uvs = (None if mesh.lightmap_uvs is None else
                        place_in_slots(np.asarray(mesh.lightmap_uvs, np.float32), slot_map))
        if spans.enabled():
            spans.note(triangles=int(mesh.positions.shape[0]), depth=bvh.depth, slots=capacity,
                       blocks=int((slot_map.reshape(-1, BVH_WIDTH) >= 0).any(1).sum()))
    with spans.span("upload"):
        scene = Scene(
            triangles=triangles,
            bvh=bvh,
            materials=materials,
            atlas=atlas,
            spheres=spheres if spheres is not None else Spheres.empty(),
            background=background,
            camera=camera,
            n_triangles=int(mesh.positions.shape[0]),
            lightmap_uvs=lightmap_uvs,
        ).to(dev)
    return _with_k1_tables(scene)


def _with_k1_tables(scene: Scene) -> Scene:
    """Build the traversal kernel's tables of a scene on a GPU (cached on
    its BVH); a CPU scene runs the kernels' plain versions, which need none."""
    if scene.device.type == "cuda":
        from raytracing_c_tpu_torch.ops.traverse_cuda import k1_tables

        k1_tables(scene.bvh, scene.triangles)
    return scene


# ---------------------------------------------------------------------------
# Bridge from the JAX package's scene
# ---------------------------------------------------------------------------


def scene_from_numpy(arrays: dict[str, np.ndarray], device="cuda") -> Scene:
    """Build a Scene on `device` from the JAX package's Scene arrays, keyed
    by their dotted field path ("triangles.v0.x", "bvh.nodes", "bvh.depth", ...).

    Static fields (bvh.depth, bvh.last_row_offset, n_triangles,
    background.kind, background.tex_id) come as 0-d arrays. Keys of the
    TPU-only derived tables (ptables, bvh.nodes_bf16, atlas.pages,
    atlas.tpages, ...) have no field here and are ignored; so are the
    env_light keys, whose tables a NEE render rebuilds from the atlas.
    """

    dev = resolve_device(device)

    def get(path: str):
        if path not in arrays:
            raise KeyError(f"scene array '{path}' missing")
        return torch.as_tensor(np.array(arrays[path]))

    def build(cls, prefix: str):
        kw = {}
        for f in dataclasses.fields(cls):
            path = f"{prefix}.{f.name}"
            if f.type in ("Vec3",):
                kw[f.name] = Vec3(get(path + ".x"), get(path + ".y"), get(path + ".z"))
            elif f.type in ("int",):
                kw[f.name] = int(arrays[path])
            else:
                kw[f.name] = get(path)
        return cls(**kw)

    return _with_k1_tables(Scene(
        triangles=build(Triangles, "triangles"),
        bvh=build(BVH, "bvh"),
        materials=build(MaterialTable, "materials"),
        atlas=build(TextureAtlas, "atlas"),
        spheres=build(Spheres, "spheres"),
        background=build(Background, "background"),
        camera=build(Camera, "camera"),
        n_triangles=int(arrays["n_triangles"]),
    ).to(dev))
