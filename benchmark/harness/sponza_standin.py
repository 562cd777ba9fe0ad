"""The Crytek Sponza stand-in: an arcaded atrium made from a seed.

Crytek Sponza (Frank Meinl, Crytek, 2010; 262,267 triangles in McGuire's
Computer Graphics Archive) is not in the repository. This module builds an
interior of its plan and its triangle count from numpy alone, the seed
giving only the textures' noise (the shape never depends on it):

- a building of 37 m x 23 m x 12.4 m (x the long axis, y up) around a
  courtyard of 29 m x 15 m, open only to the sky above the courtyard, whose
  attic wall rises to 15 m;
- two storeys of column-and-arch galleries on all four sides of the
  courtyard (ground: columns 0.4 m across to 4.2 m, arches to 6.0 m; upper:
  0.3 m columns from 6.4 m to 10.2 m, arches to 12.0 m), the gallery
  ceilings, the slab between the storeys, the roof over the galleries and a
  balustrade on the upper storey;
- the floor, the outer walls with a plinth, a lion-head relief and niche
  panels on the end walls, vases on the floor and hanging vases on chains;
- curtains on poles in the upper arches of the long sides and banners on
  the end walls, finely tessellated cloth, two-sided, whose rows take every
  triangle the rest leaves of the count (`n_triangles`, 262,267 by default:
  an 8-ary BVH of depth 6).

25 materials named after sponza.mtl's. Its alpha-masked `leaf` (foliage)
is left out, since neither the reference C renderer nor the port reads
`alphaMode`; its row is the lion relief's. Every material has a tex^2
albedo map, 8 a normal map (floor, bricks, the three column materials,
both arch materials, the plinth) and 4 a metal-roughness map (flagpole,
chain, hanging vase, details); the 6 fabrics have sheen; nothing emits.
The camera stands at one end of the courtyard at 1.7 m, looking down the
long axis with a 60-degree fov. The sky is the helmet's seeded equirect
sky (`standin.make_env_map`), its columns rolled so that the sun (40
degrees up) shines down the long axis into the courtyard.
"""

from __future__ import annotations

import math

import numpy as np

from harness import standin

N_TRIANGLES = 262_267
FOV_DEG = 60.0
#: the building's outer extent and the courtyard's (x, z), in m
HALF_X, HALF_Z = 18.5, 11.5
COURT_X, COURT_Z = 14.5, 7.5
#: heights, in m
SLAB_LO, SLAB_HI, ROOF_LO, ROOF_HI, ATTIC = 6.0, 6.4, 12.0, 12.4, 15.0
#: the sun's azimuth after the roll (degrees; atan2(z, x) of the direction
#: toward it): behind the camera, a little off the long axis
SUN_AZIMUTH_DEG = 165.0
EYE = (-13.0, 1.7, 0.0)
TARGET = (13.0, 3.2, 0.0)

# name, base colour, roughness, metalness, normal strength, sheen, sheen tint,
# anisotropic, normal map, metal-roughness map, albedo pattern
_M = [
    ("floor", (0.62, 0.58, 0.52), 0.8, 0.0, 1.0, 0.0, 0.0, 0.0, True, False, "tiles"),
    ("bricks", (0.66, 0.52, 0.42), 0.9, 0.0, 1.0, 0.0, 0.0, 0.0, True, False, "bricks"),
    ("ceiling", (0.74, 0.70, 0.62), 0.85, 0.0, 0.0, 0.0, 0.0, 0.0, False, False, "plaster"),
    ("roof", (0.55, 0.35, 0.28), 0.75, 0.0, 0.0, 0.0, 0.0, 0.0, False, False, "tiles"),
    ("column_a", (0.70, 0.66, 0.60), 0.6, 0.0, 1.0, 0.0, 0.0, 0.0, True, False, "marble"),
    ("column_b", (0.68, 0.64, 0.58), 0.6, 0.0, 1.0, 0.0, 0.0, 0.0, True, False, "marble"),
    ("column_c", (0.64, 0.60, 0.55), 0.7, 0.0, 1.0, 0.0, 0.0, 0.0, True, False, "marble"),
    ("arch", (0.72, 0.67, 0.58), 0.8, 0.0, 1.0, 0.0, 0.0, 0.0, True, False, "bricks"),
    ("details", (0.60, 0.56, 0.50), 0.5, 1.0, 0.0, 0.0, 0.0, 0.0, False, True, "plaster"),
    ("Material__25", (0.70, 0.64, 0.56), 0.8, 0.0, 1.0, 0.0, 0.0, 0.0, True, False, "bricks"),
    ("Material__298", (0.64, 0.60, 0.54), 0.9, 0.0, 0.0, 0.0, 0.0, 0.0, False, False, "plaster"),
    ("Material__47", (0.50, 0.46, 0.42), 0.7, 0.0, 0.0, 0.0, 0.0, 0.0, False, False, "marble"),
    ("Material__57", (0.58, 0.55, 0.50), 0.8, 0.0, 1.0, 0.0, 0.0, 0.0, True, False, "tiles"),
    ("fabric_a", (0.62, 0.12, 0.10), 0.9, 0.0, 0.0, 0.8, 0.5, 0.0, False, False, "cloth"),
    ("fabric_c", (0.12, 0.40, 0.16), 0.9, 0.0, 0.0, 0.8, 0.5, 0.0, False, False, "cloth"),
    ("fabric_d", (0.14, 0.20, 0.55), 0.9, 0.0, 0.0, 0.8, 0.5, 0.0, False, False, "cloth"),
    ("fabric_e", (0.66, 0.50, 0.14), 0.9, 0.0, 0.0, 0.6, 0.3, 0.0, False, False, "cloth"),
    ("fabric_f", (0.50, 0.12, 0.40), 0.9, 0.0, 0.0, 0.6, 0.3, 0.0, False, False, "cloth"),
    ("fabric_g", (0.18, 0.46, 0.48), 0.9, 0.0, 0.0, 0.6, 0.3, 0.0, False, False, "cloth"),
    ("flagpole", (0.55, 0.45, 0.30), 0.4, 1.0, 0.0, 0.0, 0.0, 0.4, False, True, "marble"),
    ("chain", (0.45, 0.42, 0.40), 0.35, 1.0, 0.0, 0.0, 0.0, 0.0, False, True, "marble"),
    ("vase_hanging", (0.60, 0.48, 0.30), 0.4, 1.0, 0.0, 0.0, 0.0, 0.0, False, True, "marble"),
    ("vase_round", (0.60, 0.36, 0.24), 0.7, 0.0, 0.0, 0.0, 0.0, 0.0, False, False, "marble"),
    ("vase", (0.56, 0.40, 0.28), 0.7, 0.0, 0.0, 0.0, 0.0, 0.0, False, False, "marble"),
    ("lion", (0.66, 0.62, 0.56), 0.7, 0.0, 0.0, 0.0, 0.0, 0.0, False, False, "marble"),
]
MATERIAL_NAMES = tuple(m[0] for m in _M)
_ID = {name: k for k, name in enumerate(MATERIAL_NAMES)}


def material_rows() -> list:
    """The 25 materials as dicts of the reference's keys: base_color,
    emission, roughness, metalness, normal_strength, sheen, sheen_tint,
    anisotropic and the texture ids tex_albedo, tex_normal, tex_mr,
    tex_emission (-1 for none), texture k + 1 being `textures[k]` of
    `sponza_parts` (the albedo maps in material order, then the normal
    maps, then the metal-roughness maps)."""
    n_nrm = sum(m[8] for m in _M)
    rows, k_nrm, k_mr = [], 0, 0
    for k, m in enumerate(_M):
        row = dict(name=m[0], base_color=m[1], emission=(0.0, 0.0, 0.0), roughness=m[2],
                   metalness=m[3], normal_strength=m[4], sheen=m[5], sheen_tint=m[6],
                   anisotropic=m[7], tex_albedo=k + 1, tex_normal=-1, tex_mr=-1,
                   tex_emission=-1)
        if m[8]:
            row["tex_normal"] = len(_M) + 1 + k_nrm
            k_nrm += 1
        if m[9]:
            row["tex_mr"] = len(_M) + 1 + n_nrm + k_mr
            k_mr += 1
        rows.append(row)
    return rows


# --- geometry --------------------------------------------------------------------------


class _Mesh:
    """Triangles gathered part by part: positions (n, 3, 3), vertex
    normals, uvs (n, 3, 2) and material ids."""

    def __init__(self):
        self.parts = []

    def add(self, pos, nrm, uv, mat: str):
        pos = np.array(pos, np.float64).reshape(-1, 3, 3)
        nrm = np.array(nrm, np.float64).reshape(-1, 3, 3)
        uv = np.array(uv, np.float64).reshape(-1, 3, 2)
        # wind each triangle so that its geometric normal faces its vertex normals
        ng = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
        flip = (ng * nrm.sum(1)).sum(-1) < 0
        for a in (pos, nrm, uv):
            a[flip, 1], a[flip, 2] = a[flip, 2].copy(), a[flip, 1].copy()
        self.parts.append((pos, nrm, uv, np.full(len(pos), _ID[mat], np.int32)))

    def surface(self, p, n, uv, mat: str):
        """A (nu + 1, nv + 1) grid of points p, normals n and uvs as
        2 nu nv triangles."""
        def corners(a):
            return (a[:-1, :-1], a[1:, :-1], a[1:, 1:], a[:-1, 1:])

        def tris(a):
            c00, c10, c11, c01 = corners(a)
            t1 = np.stack([c00, c10, c11], 2).reshape(-1, 3, a.shape[-1])
            t2 = np.stack([c00, c11, c01], 2).reshape(-1, 3, a.shape[-1])
            return np.concatenate([t1, t2])

        self.add(tris(p), tris(n), tris(uv), mat)

    def count(self) -> int:
        return sum(len(p[0]) for p in self.parts)

    def arrays(self):
        pos, nrm, uv, mat = (np.concatenate(a) for a in zip(*self.parts))
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
        return (pos.astype(np.float32), nrm.astype(np.float32), uv.astype(np.float32),
                mat.astype(np.int32))


def _quad(mesh, p0, du, dv, nu, nv, mat, normal=None, tile=2.0):
    """The rectangle p0 + s du + t dv (s, t in [0, 1]) as an nu x nv grid
    facing `normal` (default du x dv), its uvs in tiles of `tile` m."""
    p0, du, dv = (np.asarray(a, np.float64) for a in (p0, du, dv))
    s = np.linspace(0.0, 1.0, nu + 1)[:, None, None]
    t = np.linspace(0.0, 1.0, nv + 1)[None, :, None]
    p = p0 + s * du + t * dv
    n = np.cross(du, dv) if normal is None else np.asarray(normal, np.float64)
    n = np.broadcast_to(n / np.linalg.norm(n), p.shape)
    uv = np.concatenate([np.broadcast_to(s * np.linalg.norm(du) / tile, p.shape[:2] + (1,)),
                         np.broadcast_to(t * np.linalg.norm(dv) / tile, p.shape[:2] + (1,))], -1)
    mesh.surface(p, n, uv, mat)


def _lathe(mesh, base, radii, heights, nseg, mat, axis_down=False):
    """A surface of revolution about the vertical through `base`: radius
    radii[i] at height heights[i], nseg segments round, facing out."""
    r = np.asarray(radii, np.float64)[None, :, None]
    h = np.asarray(heights, np.float64)[None, :, None]
    phi = np.linspace(0.0, 2 * np.pi, nseg + 1)[:, None, None]
    ring = np.concatenate([np.cos(phi), np.zeros_like(phi), np.sin(phi)], -1)
    up = np.array([0.0, 1.0, 0.0])
    p = np.asarray(base, np.float64) + ring * r + up * (-h if axis_down else h)
    dr = np.gradient(r[0, :, 0])[None, :, None]
    dh = np.gradient(h[0, :, 0])[None, :, None]
    # the profile's outward normal in (radial, up): (dh, -dr), its up part
    # mirrored for a profile that runs down
    n = ring * dh + up * (dr if axis_down else -dr)
    uv = np.concatenate([np.broadcast_to(phi / (2 * np.pi), p.shape[:2] + (1,)),
                         np.broadcast_to(np.linspace(0, 1, r.shape[1])[None, :, None],
                                         p.shape[:2] + (1,))], -1)
    mesh.surface(p, n, uv, mat)


def _cylinder(mesh, a, b, radius, nseg, nlen, mat):
    """A cylinder from point a to point b, facing out, open at its ends."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ax = b - a
    ln = np.linalg.norm(ax)
    ax = ax / ln
    ref = np.array([0.0, 1.0, 0.0]) if abs(ax[1]) < 0.9 else np.array([1.0, 0.0, 0.0])
    e1 = np.cross(ax, ref)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(ax, e1)
    phi = np.linspace(0.0, 2 * np.pi, nseg + 1)[:, None, None]
    s = np.linspace(0.0, 1.0, nlen + 1)[None, :, None]
    ring = np.cos(phi) * e1 + np.sin(phi) * e2
    p = a + ring * radius + s * (b - a)
    n = np.broadcast_to(ring, p.shape)
    uv = np.concatenate([np.broadcast_to(phi / (2 * np.pi), p.shape[:2] + (1,)),
                         np.broadcast_to(s * ln / 2.0, p.shape[:2] + (1,))], -1)
    mesh.surface(p, n, uv, mat)


def _box(mesh, lo, hi, mat, n=1):
    """An axis-aligned box's six faces, facing out, each n x n."""
    lo, hi = np.minimum(lo, hi).astype(np.float64), np.maximum(lo, hi).astype(np.float64)
    d = hi - lo
    ex, ey, ez = np.diag(d)
    for p0, du, dv, nn in ((lo, ez, ey, (-1, 0, 0)), (lo + ex, ey, ez, (1, 0, 0)),
                           (lo, ex, ez, (0, -1, 0)), (lo + ey, ez, ex, (0, 1, 0)),
                           (lo, ey, ex, (0, 0, -1)), (lo + ez, ex, ey, (0, 0, 1))):
        _quad(mesh, p0, du, dv, n, n, mat, normal=nn, tile=1.0)


def _sides():
    """The courtyard's four sides: (start, direction along, outward normal
    toward the gallery, length), the long sides first."""
    return [((-COURT_X, 0.0, -COURT_Z), (1.0, 0.0, 0.0), (0.0, 0.0, -1.0), 2 * COURT_X),
            ((-COURT_X, 0.0, COURT_Z), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), 2 * COURT_X),
            ((-COURT_X, 0.0, -COURT_Z), (0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), 2 * COURT_Z),
            ((COURT_X, 0.0, -COURT_Z), (0.0, 0.0, 1.0), (1.0, 0.0, 0.0), 2 * COURT_Z)]


def _arcade(mesh, start, along, out, length, bays, y0, spring, top, col_r, d, mats):
    """One storey of one side: bays + 1 columns (shaft, base, capital), and
    over each bay an arch, its intrados and the spandrel's two faces."""
    col_mat, cap_mat, arch_mat = mats
    start, along, out = (np.asarray(a, np.float64) for a in (start, along, out))
    up = np.array([0.0, 1.0, 0.0])
    span = length / bays
    nseg = 8 * d
    for i in range(bays + 1):
        c = start + along * span * i
        _cylinder(mesh, c + up * (y0 + 0.35), c + up * (spring - 0.3), col_r, nseg, 4 * d,
                  col_mat)
        w = col_r * 1.5
        _box(mesh, c + up * y0 - w * (along + out), c + up * (y0 + 0.35) + w * (along + out),
             cap_mat, d)
        _box(mesh, c + up * (spring - 0.3) - w * (along + out),
             c + up * spring + w * (along + out), cap_mat, d)
    radius = span / 2 - col_r * 1.5
    height = top - spring
    half_t = col_r * 1.4
    na, nr = 12 * d, 2 * d
    theta = np.linspace(0.0, np.pi, na + 1)
    for i in range(bays):
        centre = start + along * span * (i + 0.5) + up * spring
        dirs = np.cos(theta)[:, None] * along + np.sin(theta)[:, None] * up
        # the spandrel: from the arch's curve out to the bay's rectangle
        reach = np.minimum(np.where(np.abs(np.cos(theta)) > 1e-9,
                                    (span / 2) / np.maximum(np.abs(np.cos(theta)), 1e-9), np.inf),
                           np.where(np.sin(theta) > 1e-9, height / np.maximum(np.sin(theta), 1e-9),
                                    np.inf))
        f = np.linspace(0.0, 1.0, nr + 1)[None, :, None]
        rad = radius + (reach[:, None, None] - radius) * f
        for side in (1.0, -1.0):
            p = centre + dirs[:, None, :] * rad - side * out * half_t
            n = np.broadcast_to(-side * out, p.shape)
            uv = np.stack([((p - start) @ along) / 2.0, (p @ up) / 2.0], -1)
            mesh.surface(p, n, uv, arch_mat)
        # the intrados: the arch's underside across the wall's thickness
        s = np.linspace(-1.0, 1.0, 2 * d + 1)[None, :, None]
        p = centre + dirs[:, None, :] * radius + s * out * half_t
        n = np.broadcast_to(-dirs[:, None, :], p.shape)
        uv = np.stack([np.broadcast_to(theta[:, None] * radius / 2.0, p.shape[:2]),
                       np.broadcast_to(s[..., 0] * half_t, p.shape[:2])], -1)
        mesh.surface(p, n, uv, arch_mat)


def _structure(mesh, d: int):
    """Everything but the cloth, at tessellation level d."""
    up = np.array([0.0, 1.0, 0.0])
    g = 8 * d
    # the floor, the gallery ceilings, the slab and the roof
    _quad(mesh, (-HALF_X, 0.0, -HALF_Z), (0, 0, 2 * HALF_Z), (2 * HALF_X, 0, 0), g, 2 * g,
          "floor", normal=up)
    ring = [((-HALF_X, -HALF_Z), (2 * HALF_X, HALF_Z - COURT_Z)),
            ((-HALF_X, COURT_Z), (2 * HALF_X, HALF_Z - COURT_Z)),
            ((-HALF_X, -COURT_Z), (HALF_X - COURT_X, 2 * COURT_Z)),
            ((COURT_X, -COURT_Z), (HALF_X - COURT_X, 2 * COURT_Z))]
    for (x0, z0), (sx, sz) in ring:
        for y, mat, nrm in ((SLAB_LO, "ceiling", -up), (SLAB_HI, "floor", up),
                            (ROOF_LO, "ceiling", -up), (ROOF_HI, "roof", up)):
            _quad(mesh, (x0, y, z0), (sx, 0, 0), (0, 0, sz), g, g // 2, mat, normal=nrm)
    # the outer walls, facing in, with a plinth in front of them
    walls = [((-HALF_X, 0, -HALF_Z), (2 * HALF_X, 0, 0), (0, 0, 1)),
             ((-HALF_X, 0, HALF_Z), (2 * HALF_X, 0, 0), (0, 0, -1)),
             ((-HALF_X, 0, -HALF_Z), (0, 0, 2 * HALF_Z), (1, 0, 0)),
             ((HALF_X, 0, -HALF_Z), (0, 0, 2 * HALF_Z), (-1, 0, 0))]
    for p0, du, nrm in walls:
        n = np.asarray(nrm, np.float64)
        _quad(mesh, p0, du, (0, ROOF_LO, 0), 2 * g, g, "bricks", normal=n)
        _quad(mesh, np.add(p0, n * 0.04), du, (0, 1.0, 0), 2 * g, d, "Material__57", normal=n)
    # the slab's and the roof's edges toward the courtyard, and the attic wall
    for start, along, out, length in _sides():
        s = np.asarray(start, np.float64)
        a = np.asarray(along, np.float64) * length
        o = -np.asarray(out, np.float64)
        _quad(mesh, s + up * SLAB_LO, a, up * (SLAB_HI - SLAB_LO), g, 1, "Material__298", normal=o)
        _quad(mesh, s + up * ROOF_LO, a, up * (ATTIC - ROOF_LO), g, 2 * d, "Material__298",
              normal=o)
        _quad(mesh, s + up * ROOF_HI - o * 0.3, a, up * (ATTIC - ROOF_HI), g, d, "Material__298",
              normal=-o)
    # the arcades: 9 bays on the long sides, 5 on the ends, two storeys
    for (start, along, out, length), bays in zip(_sides(), (9, 9, 5, 5)):
        _arcade(mesh, start, along, out, length, bays, 0.0, 4.2, SLAB_LO, 0.4, d,
                ("column_a", "column_c", "arch"))
        _arcade(mesh, start, along, out, length, bays, SLAB_HI, 10.2, ROOF_LO, 0.3, d,
                ("column_b", "column_c", "Material__25"))
        # the upper storey's balustrade, both faces and its rail
        s = np.asarray(start, np.float64) + up * SLAB_HI
        a = np.asarray(along, np.float64) * length
        o = np.asarray(out, np.float64)
        _quad(mesh, s - o * 0.12, a, up * 0.9, g, d, "details", normal=-o)
        _quad(mesh, s + o * 0.12, a, up * 0.9, g, d, "details", normal=o)
        _cylinder(mesh, s + up * 0.95, s + up * 0.95 + a, 0.09, 4 * d, g, "details")
    # the end walls' lion reliefs and niche panels
    for x, nx in ((-HALF_X, 1.0), (HALF_X, -1.0)):
        n = np.array([nx, 0.0, 0.0])
        m = 12 * d
        s = np.linspace(-1.0, 1.0, m + 1)
        zz, yy = np.meshgrid(s, s, indexing="ij")
        bump = 0.25 * np.exp(-2.5 * (zz**2 + yy**2)) * (1 + 0.3 * np.cos(6 * zz) * np.cos(5 * yy))
        p = np.stack([np.full_like(zz, x) + nx * (0.05 + bump), 8.6 + 0.9 * yy, 0.9 * zz], -1)
        gz, gy = np.gradient(bump, 0.9 * 2 / m, 0.9 * 2 / m)
        nrm = np.stack([np.full_like(zz, nx), -gy, -gz], -1)
        uv = np.stack([(zz + 1) / 2, (yy + 1) / 2], -1)
        mesh.surface(p, nrm, uv, "lion")
        for zc in (-6.0, 6.0):
            _quad(mesh, (x + nx * 0.03, 1.5, zc - 1.0), (0, 0, 2.0), (0, 3.0, 0), 2 * d, 3 * d,
                  "Material__47", normal=n)
    # vases on the floor and hanging vases on chains in the ground gallery
    prof = np.linspace(0.0, 1.0, 6 * d + 1)
    for k, x in enumerate(np.linspace(-12.0, 12.0, 7)):
        for z in (-COURT_Z + 1.0, COURT_Z - 1.0):
            if k % 2:
                _lathe(mesh, (x, 0.0, z), 0.05 + 0.45 * np.sin(np.pi * prof) ** 0.8,
                       0.9 * prof, 12 * d, "vase_round")
            else:
                _lathe(mesh, (x, 0.0, z), 0.2 + 0.15 * np.sin(2.5 * np.pi * prof) + 0.1 * prof,
                       1.6 * prof, 12 * d, "vase")
    for x in np.linspace(-12.0, 12.0, 5):
        for z in (-(COURT_Z + 2.0), COURT_Z + 2.0):
            _cylinder(mesh, (x, SLAB_LO, z), (x, 3.6, z), 0.02, 4, 2 * d, "chain")
            _lathe(mesh, (x, 3.6, z), 0.05 + 0.3 * np.sin(np.pi * prof) ** 0.7, 0.7 * prof,
                   10 * d, "vase_hanging", axis_down=True)


def _cloths():
    """The cloth pieces: (top-left corner, along, down, facing, fold
    direction, material), curtains in the upper arches of the long sides
    and banners on the end walls."""
    out = []
    fabrics = ("fabric_a", "fabric_c", "fabric_d")
    for start, along, face, length in _sides()[:2]:
        span = length / 9
        for i in range(9):
            c = np.asarray(start) + np.asarray(along) * span * (i + 0.5)
            o = np.asarray(face, np.float64)
            top = c + np.array([0.0, 10.9, 0.0]) - o * 0.35 - np.asarray(along) * 1.0
            out.append((top, np.asarray(along, np.float64) * 2.0, np.array([0.0, -3.6, 0.0]),
                        -o, fabrics[i % 3]))
    for x, nx in ((-HALF_X, 1.0), (HALF_X, -1.0)):
        for k, z in enumerate((-3.4, 2.0, 4.0)):
            top = np.array([x + nx * 0.3, 11.5, z - 0.8])
            out.append((top, np.array([0.0, 0.0, 1.6]), np.array([0.0, -4.8, 0.0]),
                        np.array([nx, 0.0, 0.0]), ("fabric_e", "fabric_f", "fabric_g")[k]))
    return out


def _cloth(mesh, top, along, down, face, mat, quads, poles: bool):
    """One cloth piece: two faces of a folded sheet, `quads` cells per
    face, in rows of columns in proportion to its sides (a shorter last
    row), and the pole it hangs from."""
    w, h = np.linalg.norm(along), np.linalg.norm(down)
    cols = max(1, int(round(math.sqrt(quads * w / h))))
    rows, last = divmod(quads, cols)
    a_hat = along / w

    def sheet(nu, nv, v0, v1, side):
        s = np.linspace(0.0, 1.0, nu + 1)[:, None]
        t = np.linspace(v0, v1, nv + 1)[None, :]
        fold = 0.07 * np.sin(2 * np.pi * s * w / 0.35) * (0.4 + 0.6 * t)
        dfold = 0.07 * 2 * np.pi / 0.35 * np.cos(2 * np.pi * s * w / 0.35) * (0.4 + 0.6 * t)
        p = (top + s[..., None] * along + t[..., None] * down
             + (fold[..., None] + side * 0.004) * face)
        n = side * (face - dfold[..., None] * a_hat)
        n = np.broadcast_to(n, p.shape)
        uv = np.stack([np.broadcast_to(s * w, p.shape[:2]), np.broadcast_to(t * h, p.shape[:2])],
                      -1)
        mesh.surface(p, n, uv, mat)

    split = rows / (rows + (last > 0))
    for side in (1.0, -1.0):
        if rows:
            sheet(cols, rows, 0.0, split, side)
        if last:
            sheet(last, 1, split, 1.0, side)
    if poles:
        _cylinder(mesh, top - a_hat * 0.1, top + along + a_hat * 0.1, 0.04, 8, 2, "flagpole")


def sponza_mesh(n_triangles: int = N_TRIANGLES):
    """(positions (n, 3, 3), normals (n, 3, 3), uvs (n, 3, 2) float32,
    mat_id (n,) int32) with exactly n_triangles triangles: the structure
    at the finest level that leaves at least a quarter of the count to the
    cloth, then the cloth's rows, then single tassels under the first
    curtains for what an even split leaves."""
    cloths = _cloths()
    poles = 2 * 8 * 2 * len(cloths)
    d = 1
    while True:
        probe = _Mesh()
        _structure(probe, d + 1)
        if probe.count() + poles > 0.75 * n_triangles:
            break
        d += 1
    mesh = _Mesh()
    _structure(mesh, d)
    left = n_triangles - mesh.count() - poles
    if left < 4 * len(cloths):
        raise ValueError(f"{n_triangles} triangles: too few for the stand-in")
    quads, tassels = divmod(left, 2 * 2)  # two faces, two triangles a cell
    per = [quads // len(cloths) + (k < quads % len(cloths)) for k in range(len(cloths))]
    for (top, along, down, face, mat), q in zip(cloths, per):
        _cloth(mesh, top, along, down, face, mat, q, poles=True)
    for k in range(tassels):
        top, along, down, face, mat = cloths[k]
        a = top + down + along * (0.25 + 0.25 * k)
        tri = np.stack([a, a + along * 0.05, a + along * 0.025 + down * 0.04])[None]
        mesh.add(tri, np.broadcast_to(face, tri.shape), np.zeros((1, 3, 2)), mat)
    arrays = mesh.arrays()
    assert len(arrays[0]) == n_triangles, (len(arrays[0]), n_triangles)
    return arrays


# --- textures --------------------------------------------------------------------------


def _patterns(n: int) -> dict:
    """Height fields in [0, 1] on an n x n grid, one per albedo pattern."""
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / n
    row = np.floor(y * 16)
    bx = (x * 8 + 0.5 * (row % 2)) % 1.0
    by = (y * 16) % 1.0
    bricks = ((bx > 0.05) & (by > 0.1)).astype(np.float32)
    tiles = ((((x * 8) % 1.0) > 0.04) & (((y * 8) % 1.0) > 0.04)).astype(np.float32)
    marble = 0.5 + 0.5 * np.sin(x * 40 + 6 * np.sin(y * 9) + 3 * np.sin(x * 13 + y * 7))
    plaster = 0.5 + 0.25 * np.sin(x * 23) * np.sin(y * 19) + 0.25 * np.sin((x + y) * 31)
    cloth = 0.5 + 0.5 * np.sin(x * 2 * np.pi * 64) * np.sin(y * 2 * np.pi * 64)
    return {"bricks": bricks, "tiles": tiles, "marble": marble.astype(np.float32),
            "plaster": plaster.astype(np.float32), "cloth": cloth.astype(np.float32)}


def _u8(a):
    return (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)


def sponza_textures(seed: int, tex: int = 1024) -> list:
    """The maps, each tex^2 u8 RGB: 25 albedo maps in material order, then
    the normal maps and the metal-roughness maps of the materials that have
    them; the noise comes from the seed."""
    rng = np.random.default_rng([seed, 16])
    pat = _patterns(tex)
    albedo, normal, mr = [], [], []
    for m in _M:
        h = pat[m[10]]
        noise = rng.uniform(-0.06, 0.06, (tex, tex)).astype(np.float32)
        shade = 0.75 + 0.25 * h + noise
        albedo.append(_u8(shade[..., None] * np.asarray(m[1], np.float32) / max(m[1])))
        if m[8]:
            gy, gx = np.gradient(h + 0.5 * noise)
            nrm = np.stack([-gx * 4.0, -gy * 4.0, np.ones_like(gx)], -1)
            nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
            normal.append(_u8(nrm * 0.5 + 0.5))
        if m[9]:
            mr.append(_u8(np.stack([np.zeros_like(h), 0.3 + 0.6 * h + noise,
                                    0.7 + 0.3 * (1 - h)], -1)))
    return albedo + normal + mr


def sponza_env(width: int, height: int, seed: int) -> np.ndarray:
    """The helmet's seeded sky (`standin.make_env_map`), its columns rolled
    so that the sun sits at SUN_AZIMUTH_DEG: a whole number of columns, so
    every texel is the original's."""
    env = standin.make_env_map(width, height, seed)
    sun_u = 0.5 + (-60.0) / 360.0  # make_env_map's sun
    want_u = 0.5 + SUN_AZIMUTH_DEG / 360.0
    return np.roll(env, int(round((want_u - sun_u) * width)), axis=1)


def view_matrix() -> np.ndarray:
    """(4, 4) float32 camera to world: EYE looking at TARGET."""
    eye, target = np.array(EYE), np.array(TARGET)
    fwd = (target - eye) / np.linalg.norm(target - eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    view = np.eye(4, dtype=np.float32)
    view[:3, 0], view[:3, 1], view[:3, 2], view[:3, 3] = right, up, -fwd, eye
    return view


def sponza_parts(seed: int, n_triangles: int = N_TRIANGLES, tex: int = 1024):
    """Returns (positions, normals, uvs, mat_id), the textures
    (`sponza_textures`), the view (4, 4) float32 camera to world."""
    return sponza_mesh(n_triangles), sponza_textures(seed, tex), view_matrix()
