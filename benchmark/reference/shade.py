"""Plain reference of the material stage: colour, textures, background,
the environment light's alias table and the Disney/PBR shader.

Frozen copies, at commit f272015, of `raytracing_c_tpu_torch/utils/
color.py`, `ops/texture.py`, `ops/background.py`, `ops/env_light.py` and
`ops/disney.py` (the reference C renderer's driver.c:31-418 and common.h:
82-92), with the float type taken from the scene (`RefScene.ft`) where the
program's modules fix float32, and the debug-normal shader and spheres
left out (no configuration of the benchmark has them). The operation order
is the program's, so the float32 reference rounds as the program's plain
PyTorch does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from reference.vec3 import Vec3

LUMA = (0.2126, 0.7152, 0.0722)
PI = float(torch.tensor(math.pi, dtype=torch.float32))
TWO_PI = 2.0 * math.pi
INV_2PISQ = float(1.0 / (2.0 * np.pi * np.pi))
UNIFORM_SPHERE_PDF = float(1.0 / (4.0 * math.pi))
UNIFORM_SPHERE_PDF_SQ = UNIFORM_SPHERE_PDF * UNIFORM_SPHERE_PDF

# material row columns
MROW_BASE, MROW_EMI, MROW_ROUGH, MROW_METAL, MROW_NSTR = 0, 3, 6, 7, 8
MROW_SHEEN, MROW_SHEENT, MROW_ANISO = 9, 10, 11
MROW_TEX_ALBEDO, MROW_TEX_NORMAL, MROW_TEX_MR, MROW_TEX_EMI = 12, 13, 14, 15
MROW_COLS = 16


# --- colour -----------------------------------------------------------------


def srgb_to_linear(c):
    return torch.pow(torch.clamp_min(c + 0.055, 0.0) / 1.055, 2.4)


def linear_to_srgb(c):
    lo = 12.92 * c
    hi = 1.055 * torch.pow(torch.clamp_min(c, 1e-12), 1.0 / 2.4) - 0.055
    return torch.where(c <= 0.0031308, lo, hi)


def encode_u8(linear_rgb):
    c = linear_to_srgb(torch.clamp(linear_rgb, 0.0, 1.0))
    return (c * 255.999).to(torch.uint8)


# --- textures ---------------------------------------------------------------


def _wrap01(x):
    return x - torch.floor(x)


def _fetch(scene, off, w, x, y) -> Vec3:
    idx = (off + y * w + x).long()
    s = 1.0 / 255.999
    return Vec3(scene.tex_r[idx].to(scene.ft) * s, scene.tex_g[idx].to(scene.ft) * s,
                scene.tex_b[idx].to(scene.ft) * s)


def sample_bilinear(scene, tex_id, uv_u, uv_v) -> Vec3:
    tid = torch.clamp_min(tex_id, 0).long()
    off, w, h = scene.tex_offset[tid], scene.tex_width[tid], scene.tex_height[tid]
    px = _wrap01(uv_u) * w
    py = _wrap01(uv_v) * h
    x0 = torch.minimum(torch.clamp_min(px.to(torch.int32), 0), w - 1)
    y0 = torch.minimum(torch.clamp_min(py.to(torch.int32), 0), h - 1)
    a = px - x0
    b = py - y0
    x1 = torch.minimum(x0 + 1, w - 1)
    y1 = torch.minimum(y0 + 1, h - 1)
    c0 = _fetch(scene, off, w, x0, y0).lerp(_fetch(scene, off, w, x1, y0), a)
    c1 = _fetch(scene, off, w, x0, y1).lerp(_fetch(scene, off, w, x1, y1), a)
    return c0.lerp(c1, b)


# --- background ---------------------------------------------------------------


def eval_background(scene, direction: Vec3) -> Vec3:
    r = direction.shape[0]
    if scene.bg_tex >= 0:
        u = 0.5 + torch.atan2(direction.z, direction.x) * (0.5 / math.pi)
        v = 0.5 - torch.asin(torch.clamp(direction.y, -1.0, 1.0)) * (1.0 / math.pi)
        tid = torch.full((r,), scene.bg_tex, dtype=torch.int32, device=u.device)
        return sample_bilinear(scene, tid, u, v).map(srgb_to_linear)
    c = scene.bg_color
    return Vec3(c[0].expand(r), c[1].expand(r), c[2].expand(r))


# --- environment light ----------------------------------------------------------


@dataclass
class EnvTable:
    prob: torch.Tensor
    alias: torch.Tensor
    lum_p: torch.Tensor
    w: int
    h: int


def build_env_table(rgb: np.ndarray, device, ft) -> EnvTable | None:
    """The alias table of an (h, w, 3) u8 sRGB equirect map: texel weight
    = linear luminance x sin(theta) of its row, Vose's construction in
    float64 with its small/large pop order."""
    h, w, _ = rgb.shape
    lin = np.power(rgb.reshape(-1, 3).astype(np.float64) / 255.0, 2.2)
    lum = (0.2126 * lin[:, 0] + 0.7152 * lin[:, 1] + 0.0722 * lin[:, 2]).reshape(h, w)
    sin_t = np.sin(np.pi * (np.arange(h) + 0.5) / h)[:, None]
    wgt = (lum * sin_t).reshape(-1)
    total = wgt.sum()
    if total <= 0.0:
        return None
    p = wgt / total
    n = w * h
    scaled = (p * n).tolist()
    alias = [0] * n
    prob = [1.0] * n
    small = np.flatnonzero(p * n < 1.0).tolist()
    large = np.flatnonzero(p * n >= 1.0).tolist()
    while small and large:
        s, g = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = scaled[g] - (1.0 - scaled[s])
        (small if scaled[g] < 1.0 else large).append(g)
    return EnvTable(prob=torch.tensor(np.asarray(prob, np.float32), device=device).to(ft),
                    alias=torch.tensor(alias, dtype=torch.int64, device=device),
                    lum_p=torch.tensor(p.astype(np.float32), device=device).to(ft), w=w, h=h)


def _dir_from_uv(u, v) -> Vec3:
    phi = (u - 0.5) * TWO_PI
    ang = (0.5 - v) * math.pi
    r = torch.cos(ang)
    return Vec3(r * torch.cos(phi), torch.sin(ang), r * torch.sin(phi))


def env_sample(env: EnvTable, u_sel, u_jx, u_jy):
    n = env.w * env.h
    r_ = u_sel * n
    j = torch.clamp(r_.to(torch.int32), 0, n - 1)
    frac = r_ - j.to(u_sel.dtype)
    j = j.long()
    texel = torch.where(frac < env.prob[j], j, env.alias[j])
    x = texel % env.w
    y = texel // env.w
    u = (x.to(u_sel.dtype) + u_jx) / env.w
    v = (y.to(u_sel.dtype) + u_jy) / env.h
    sin_t = torch.clamp_min(torch.cos((0.5 - v) * math.pi), 1e-6)
    pdf = env.lum_p[texel] * n * INV_2PISQ / sin_t
    return _dir_from_uv(u, v), pdf


def env_eval_pdf(env: EnvTable, d: Vec3):
    u = 0.5 + torch.atan2(d.z, d.x) * (0.5 / math.pi)
    v = 0.5 - torch.asin(torch.clamp(d.y, -1.0, 1.0)) * (1.0 / math.pi)
    x = torch.clamp((u * env.w).to(torch.int32), 0, env.w - 1)
    y = torch.clamp((v * env.h).to(torch.int32), 0, env.h - 1)
    sin_t = torch.clamp_min(torch.cos((0.5 - v) * math.pi), 1e-6)
    return env.lum_p[(y * env.w + x).long()] * (env.w * env.h) * INV_2PISQ / sin_t


# --- Disney / PBR ----------------------------------------------------------------


def luminance(v: Vec3):
    return v.x * LUMA[0] + v.y * LUMA[1] + v.z * LUMA[2]


def _pow5(x):
    return torch.pow(torch.clamp_min(1.0 - x, 0.0), 5.0)


def fresnel_schlick_scalar(f0, f90, theta):
    return f0 + (f90 - f0) * _pow5(theta)


def fresnel_schlick_rgb(f0: Vec3, f90, theta) -> Vec3:
    return f0 + (Vec3(f90, f90, f90) - f0) * _pow5(theta)


def distribution_ggx(roughness, noh, k):
    a2 = roughness * roughness
    return a2 / (PI * torch.pow((noh * noh) * (a2 * a2 - 1.0) + 1.0, k))


def smith_g(ndotv, alpha2):
    a = alpha2 * alpha2
    b = ndotv * ndotv
    return (2.0 * ndotv) / (ndotv + torch.sqrt(torch.clamp_min(a + b - a * b, 0.0)))


def geometry_term(nol, nov, roughness):
    a2 = roughness * roughness
    return smith_g(nov, a2) * smith_g(nol, a2)


def shadowed_f90(f0: Vec3):
    return torch.clamp_max((1.0 / 0.04) * luminance(f0), 1.0)


def sheen_tint_color(base_color: Vec3) -> Vec3:
    lum = base_color.x * 0.3 + base_color.y * 0.6 + base_color.z * 1.0
    tint = base_color * (1.0 / torch.clamp_min(lum, 1e-20))
    one = torch.ones_like(lum)
    return Vec3.where(lum > 0.0, tint, Vec3(one, one, one))


def evaluate_sheen(sheen, base_color: Vec3, sheen_tint, hol) -> Vec3:
    one = torch.ones_like(sheen)
    col = Vec3(one, one, one).lerp(sheen_tint_color(base_color), sheen_tint)
    m = torch.clamp_min(1.0 - hol, 0.0)
    out = col * (sheen * (m * m * m * m * m))
    zero = torch.zeros_like(sheen)
    return Vec3.where(sheen > 0.0, out, Vec3(zero, zero, zero))


def eval_diffuse(base_color: Vec3, nol, nov, loh, roughness) -> Vec3:
    fd90 = 0.5 + 2.0 * roughness * loh * loh
    a = fresnel_schlick_scalar(1.0, fd90, nol)
    b = fresnel_schlick_scalar(1.0, fd90, nov)
    return base_color * (a * b / PI)


def eval_specular(roughness, fresnel: Vec3, noh, nov, nol) -> Vec3:
    d = distribution_ggx(roughness, noh, 2.0)
    g = geometry_term(nol, nov, roughness)
    return fresnel * (d * g / (4.0 * nol * nov))


def pdf_ggx_vndf(noh, nov, roughness):
    d = distribution_ggx(roughness, noh, 2.0)
    g1 = smith_g(nov, roughness * roughness)
    return (d * g1) / torch.clamp_min(4.0 * nov, 1e-5)


def sample_cosine_hemisphere(u1, u2) -> Vec3:
    angle = u1 * 2.0 * PI
    dist = torch.sqrt(u2)
    return Vec3(torch.sin(angle) * dist, torch.cos(angle) * dist,
                torch.sqrt(torch.clamp_min(1.0 - dist * dist, 0.0)))


def sample_ggx_vndf(v: Vec3, ax, ay, u1, u2) -> Vec3:
    vh = Vec3(ax * v.x, ay * v.y, v.z).normalized()
    lensq = vh.x * vh.x + vh.y * vh.y
    has = lensq > 0.0
    inv_len = torch.where(has, 1.0 / torch.sqrt(torch.clamp_min(lensq, 1e-30)), 0.0)
    one = torch.ones_like(inv_len)
    zero = torch.zeros_like(inv_len)
    t1 = Vec3.where(has, Vec3(-vh.y * inv_len, vh.x * inv_len, zero), Vec3(one, zero, zero))
    t2 = vh.cross(t1)
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh.z)
    p2 = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - p1 * p1, 0.0)) + s * p2
    nh = t1 * p1 + t2 * p2 + vh * torch.sqrt(torch.clamp_min(1.0 - p1 * p1 - p2 * p2, 0.0))
    return Vec3(ax * nh.x, ay * nh.y, torch.clamp_min(nh.z, 0.0)).normalized()


def sample_disney_brdf(base_color: Vec3, roughness, metalness, sheen, sheen_tint, aniso2,
                       in_dir: Vec3, u_lobe, u1, u2):
    alpha_x = roughness * roughness * (1.0 - aniso2) + aniso2
    alpha_y = roughness * roughness
    micro_n = sample_ggx_vndf(in_dir, alpha_x, alpha_y, u1, u2)

    f004 = Vec3.full(roughness.shape, 0.04, roughness.device, roughness.dtype)
    f0 = f004.lerp(base_color, metalness)
    fresnel = fresnel_schlick_rgb(f0, shadowed_f90(f0), in_dir.dot(micro_n))

    dw = 1.0 - metalness
    sw = luminance(fresnel)
    inv_w = 1.0 / torch.clamp_min(dw + sw, 1e-20)
    dw = dw * inv_w
    sw = sw * inv_w

    pick_diffuse = u_lobe < dw
    nov = in_dir.z

    out_d = sample_cosine_hemisphere(u1, u2)
    half_d = (out_d + in_dir).normalized()
    nol_d = out_d.z
    ok_d = (nol_d > 0.0) & (nov > 0.0)
    loh = out_d.dot(half_d)
    pdf_d = nol_d / PI
    one = torch.ones_like(nov)
    diff = eval_diffuse(base_color, nol_d, nov, loh, roughness) * (
        Vec3(one, one, one) - fresnel
    ) + evaluate_sheen(sheen, base_color, sheen_tint, loh)
    rgb_d = diff * torch.where(ok_d, nol_d, 0.0)
    a_d = torch.where(ok_d, dw * pdf_d, 0.0)

    out_s = (-in_dir).reflect(micro_n)
    nol_s = out_s.z
    ok_s = (nol_s > 0.0) & (nov > 0.0)
    nol_sc = torch.clamp_min(nol_s, 0.001)
    nov_sc = torch.clamp_min(nov, 0.001)
    noh = torch.clamp_max(micro_n.z, 0.99)
    pdf_s = pdf_ggx_vndf(noh, nov_sc, roughness)
    spec = eval_specular(roughness, fresnel, noh, nov_sc, nol_sc)
    rgb_s = spec * torch.where(ok_s, nol_sc, 0.0)
    a_s = torch.where(ok_s, sw * pdf_s, 0.0)

    out_dir = Vec3.where(pick_diffuse, out_d, out_s).normalized()
    rgb = Vec3.where(pick_diffuse, rgb_d, rgb_s)
    pdf = torch.where(pick_diffuse, a_d, a_s)
    return out_dir, rgb, pdf


def eval_disney_brdf(base_color: Vec3, roughness, metalness, sheen, sheen_tint,
                     in_dir: Vec3, out_dir: Vec3):
    nov = torch.clamp_min(in_dir.z, 0.001)
    nol = out_dir.z
    ok = (nol > 0.0) & (in_dir.z > 0.0)
    nol_c = torch.clamp_min(nol, 0.001)

    h = (in_dir + out_dir).normalized()
    noh = torch.clamp_max(h.z, 0.99)
    loh = out_dir.dot(h)

    f004 = Vec3.full(roughness.shape, 0.04, roughness.device, roughness.dtype)
    f0 = f004.lerp(base_color, metalness)
    fresnel = fresnel_schlick_rgb(f0, shadowed_f90(f0), in_dir.dot(h))

    dw = 1.0 - metalness
    sw = luminance(fresnel)
    inv_w = 1.0 / torch.clamp_min(dw + sw, 1e-20)
    dw = dw * inv_w
    sw = sw * inv_w

    one = torch.ones_like(nov)
    diff = eval_diffuse(base_color, nol_c, nov, loh, roughness) * (
        Vec3(one, one, one) - fresnel
    ) + evaluate_sheen(sheen, base_color, sheen_tint, loh)
    spec = eval_specular(roughness, fresnel, noh, nov, nol_c)

    f_nol = (diff + spec) * torch.where(ok, nol_c, 0.0)
    pdf = dw * torch.clamp_min(nol, 0.0) / PI + sw * pdf_ggx_vndf(noh, nov, roughness)
    return f_nol, torch.where(ok, pdf, 0.0)


def sample_uniform_sphere(u1, u2) -> Vec3:
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * u2
    return Vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def apply_normal_map(normal: Vec3, tangent: Vec3, bitangent: Vec3, tex_rgb: Vec3, strength,
                     has_map) -> Vec3:
    vx = tex_rgb.x * 2.0 - 1.0
    vy = -(tex_rgb.y * 2.0 - 1.0)
    vz = tex_rgb.z * 2.0 - 1.0
    mapped = tangent * vx + bitangent * vy + normal * vz
    n = (mapped * strength + normal * (1.0 - strength)).normalized()
    return Vec3.where(has_map, n, normal)


def basis(view: Vec3, normal: Vec3):
    zero = torch.zeros_like(normal.x)
    one = torch.ones_like(normal.x)
    use_view = torch.abs(normal.dot(view)) < 0.9999
    use_y = torch.abs(normal.y) < 0.9999
    t = Vec3.where(
        use_view,
        normal.cross(view),
        Vec3.where(use_y, normal.cross(Vec3(zero, one, zero)),
                   normal.cross(Vec3(one, zero, zero))),
    ).normalized()
    return t, normal.cross(t)


def shade(scene, direction: Vec3, normal: Vec3, tangent: Vec3, bitangent: Vec3, uv_u, uv_v,
          mat_id, rand4, nee: bool = False, rand2=None):
    """The material stage (bilinear textures). Returns dict(direction,
    tint, emission, terminate) and, with nee, nee_dir, nee_partial and
    pdf_eval."""
    m = scene.mat_rows[torch.clamp_min(mat_id, 0).long()]
    base_color = Vec3(m[:, MROW_BASE], m[:, MROW_BASE + 1], m[:, MROW_BASE + 2])
    emission = Vec3(m[:, MROW_EMI], m[:, MROW_EMI + 1], m[:, MROW_EMI + 2])
    rough = m[:, MROW_ROUGH]
    metal = m[:, MROW_METAL]
    nstr = m[:, MROW_NSTR]
    sheen = m[:, MROW_SHEEN]
    sheen_tint = m[:, MROW_SHEENT]
    aniso = m[:, MROW_ANISO]
    t_alb = m[:, MROW_TEX_ALBEDO].to(torch.int32)
    t_nrm = m[:, MROW_TEX_NORMAL].to(torch.int32)
    t_mr = m[:, MROW_TEX_MR].to(torch.int32)
    t_emi = m[:, MROW_TEX_EMI].to(torch.int32)

    nrm_tex = sample_bilinear(scene, t_nrm, uv_u, uv_v)
    n = apply_normal_map(normal, tangent, bitangent, nrm_tex, nstr, t_nrm >= 0)

    alb_tex = sample_bilinear(scene, t_alb, uv_u, uv_v)
    base_color = Vec3.where(t_alb >= 0, base_color * alb_tex.map(srgb_to_linear), base_color)
    mr_tex = sample_bilinear(scene, t_mr, uv_u, uv_v)
    has_mr = t_mr >= 0
    rough = torch.where(has_mr, rough * mr_tex.y, rough)
    metal = torch.where(has_mr, metal * mr_tex.z, metal)

    rough = torch.clamp(rough, 0.001, 1.0)
    metal = torch.clamp_max(metal, 0.9) / 0.9

    emi_tex = sample_bilinear(scene, t_emi, uv_u, uv_v)
    emission = Vec3.where(t_emi >= 0, emission * emi_tex.map(srgb_to_linear), emission)

    t_basis, b_basis = basis(direction, n)
    neg_dir = -direction
    in_dir = Vec3(neg_dir.dot(t_basis), neg_dir.dot(b_basis), neg_dir.dot(n))

    out_t, rgb, pdf = sample_disney_brdf(base_color, rough, metal, sheen, sheen_tint,
                                         aniso * aniso, in_dir, rand4[0], rand4[1], rand4[2])
    out_world = t_basis * out_t.x + b_basis * out_t.y + n * out_t.z

    ok = pdf > 0.0
    inv_pdf = torch.where(ok, 1.0 / torch.where(ok, pdf, 1.0), 0.0)
    out = {"direction": out_world, "tint": rgb * inv_pdf, "emission": emission,
           "terminate": ~ok}
    if nee:
        env = scene.env
        if env is not None:
            wd, pl = env_sample(env, rand2[0], rand2[1], rand2[2])
            pl2 = pl * pl
        else:
            wd = sample_uniform_sphere(rand2[0], rand2[1])
            pl = torch.full_like(rand2[0], UNIFORM_SPHERE_PDF)
            pl2 = torch.full_like(rand2[0], UNIFORM_SPHERE_PDF_SQ)
        wd_t = Vec3(wd.dot(t_basis), wd.dot(b_basis), wd.dot(n))
        f_nol, pdf_ev = eval_disney_brdf(base_color, rough, metal, sheen, sheen_tint, in_dir,
                                         wd_t)
        w_nee = pl2 / (pl2 + pdf_ev * pdf_ev)
        ok_l = pl > 0.0
        inv_pl = torch.where(ok_l, 1.0 / torch.where(ok_l, pl, 1.0), 0.0)
        out["nee_dir"] = wd
        out["nee_partial"] = eval_background(scene, wd) * f_nol * (w_nee * inv_pl)
        _, pdf_out = eval_disney_brdf(base_color, rough, metal, sheen, sheen_tint, in_dir,
                                      out_t)
        out["pdf_eval"] = pdf_out
    return out
