"""Disney/PBR ubershader, the material stage of the wavefront integrator.

Counterpart of `raytracing_c_tpu/ops/disney.py`, formula for formula
(driver.c:118-418): the mixture sampler with weights (1 - metalness,
luminance(fresnel)); GGX VNDF sampling with anisotropic alpha; Disney
diffuse + luminance-normalised sheen; Smith G2 specular with the
shadowed-f90 Schlick fresnel; TBN normal mapping; albedo/emissive sRGB
decode; roughness *= mr.g, metalness *= mr.b, the metalness remap; the
debug-normal shader. Both lobes are evaluated and the sampled one selected,
so every ray runs the same code.

The material row is one plain index gather (the JAX package's one-hot
matmul fetch is a TPU workaround with the same values).
"""

from __future__ import annotations

import math

import torch

from raytracing_c_tpu_torch.models.scene import (
    MROW_ANISO, MROW_BASE, MROW_EMI, MROW_KIND, MROW_METAL, MROW_NSTR,
    MROW_ROUGH, MROW_SHEEN, MROW_SHEENT, MROW_TEX_ALBEDO, MROW_TEX_EMI,
    MROW_TEX_MR, MROW_TEX_NORMAL, SHADER_DEBUG_NORMAL,
)
from raytracing_c_tpu_torch.ops import background as bg_ops
from raytracing_c_tpu_torch.ops import env_light, texture
from raytracing_c_tpu_torch.utils import color
from raytracing_c_tpu_torch.utils.vec3 import Vec3

PI = float(torch.tensor(math.pi, dtype=torch.float32))


def luminance(v: Vec3):
    return v.x * color.LUMA[0] + v.y * color.LUMA[1] + v.z * color.LUMA[2]


def _pow5(x):
    return torch.pow(torch.clamp_min(1.0 - x, 0.0), 5.0)


def fresnel_schlick_scalar(f0, f90, theta):
    """driver.c:204-206."""
    return f0 + (f90 - f0) * _pow5(theta)


def fresnel_schlick_rgb(f0: Vec3, f90, theta) -> Vec3:
    """driver.c:208-210."""
    return f0 + (Vec3(f90, f90, f90) - f0) * _pow5(theta)


def distribution_ggx(roughness, noh, k):
    """driver.c:212-215."""
    a2 = roughness * roughness
    return a2 / (PI * torch.pow((noh * noh) * (a2 * a2 - 1.0) + 1.0, k))


def smith_g(ndotv, alpha2):
    """driver.c:217-221."""
    a = alpha2 * alpha2
    b = ndotv * ndotv
    return (2.0 * ndotv) / (ndotv + torch.sqrt(torch.clamp_min(a + b - a * b, 0.0)))


def geometry_term(nol, nov, roughness):
    """driver.c:223-228."""
    a2 = roughness * roughness
    return smith_g(nov, a2) * smith_g(nol, a2)


def shadowed_f90(f0: Vec3):
    """driver.c:273-276."""
    return torch.clamp_max((1.0 / 0.04) * luminance(f0), 1.0)


def sheen_tint_color(base_color: Vec3) -> Vec3:
    """disney_calculate_sheen_tint (driver.c:166-169)."""
    lum = base_color.x * 0.3 + base_color.y * 0.6 + base_color.z * 1.0
    tint = base_color * (1.0 / torch.clamp_min(lum, 1e-20))
    one = torch.ones_like(lum)
    return Vec3.where(lum > 0.0, tint, Vec3(one, one, one))


def evaluate_sheen(sheen, base_color: Vec3, sheen_tint, hol) -> Vec3:
    """disney_evaluate_sheen (driver.c:176-183)."""
    one = torch.ones_like(sheen)
    col = Vec3(one, one, one).lerp(sheen_tint_color(base_color), sheen_tint)
    m = torch.clamp_min(1.0 - hol, 0.0)
    out = col * (sheen * (m * m * m * m * m))
    zero = torch.zeros_like(sheen)
    return Vec3.where(sheen > 0.0, out, Vec3(zero, zero, zero))


def eval_diffuse(base_color: Vec3, nol, nov, loh, roughness) -> Vec3:
    """disney_eval_diffuse (driver.c:258-264)."""
    fd90 = 0.5 + 2.0 * roughness * loh * loh
    a = fresnel_schlick_scalar(1.0, fd90, nol)
    b = fresnel_schlick_scalar(1.0, fd90, nov)
    return base_color * (a * b / PI)


def eval_specular(roughness, fresnel: Vec3, noh, nov, nol) -> Vec3:
    """disney_eval_specular (driver.c:266-271)."""
    d = distribution_ggx(roughness, noh, 2.0)
    g = geometry_term(nol, nov, roughness)
    return fresnel * (d * g / (4.0 * nol * nov))


def pdf_ggx_vndf(noh, nov, roughness):
    """pdf_GGX_VNDF (driver.c:252-256)."""
    d = distribution_ggx(roughness, noh, 2.0)
    g1 = smith_g(nov, roughness * roughness)
    return (d * g1) / torch.clamp_min(4.0 * nov, 1e-5)


def sample_cosine_hemisphere(u1, u2) -> Vec3:
    """driver.c:118-127: z-up cosine-weighted direction."""
    angle = u1 * 2.0 * PI
    dist = torch.sqrt(u2)
    return Vec3(torch.sin(angle) * dist, torch.cos(angle) * dist,
                torch.sqrt(torch.clamp_min(1.0 - dist * dist, 0.0)))


def sample_ggx_vndf(v: Vec3, ax, ay, u1, u2) -> Vec3:
    """sample_GGX_VNDF (driver.c:230-250): visible-normal sampling."""
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


def sample_disney_brdf(base_color: Vec3, roughness, metalness, sheen,
                       sheen_tint, aniso2, in_dir: Vec3, u_lobe, u1, u2):
    """sample_disney_BRDF (driver.c:287-348) in tangent space (normal +z).
    in_dir points away from the surface. Returns (out_dir, rgb, pdf): rgb
    includes NoL, pdf the lobe weight; pdf <= 0 means terminate."""
    alpha_x = roughness * roughness * (1.0 - aniso2) + aniso2
    alpha_y = roughness * roughness
    micro_n = sample_ggx_vndf(in_dir, alpha_x, alpha_y, u1, u2)

    f004 = Vec3.full(roughness.shape, 0.04, roughness.device)
    f0 = f004.lerp(base_color, metalness)
    fresnel = fresnel_schlick_rgb(f0, shadowed_f90(f0), in_dir.dot(micro_n))

    dw = 1.0 - metalness
    sw = luminance(fresnel)
    inv_w = 1.0 / torch.clamp_min(dw + sw, 1e-20)
    dw = dw * inv_w
    sw = sw * inv_w

    pick_diffuse = u_lobe < dw
    nov = in_dir.z

    # diffuse lobe (cosine hemisphere)
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

    # specular lobe (VNDF reflection)
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
    """The BRDF for a given direction (NEE needs evaluation; the reference
    only samples, driver.c:287-348), in tangent space (normal +z); in_dir
    toward the viewer, out_dir toward the light. Returns (f_nol, pdf):
    both lobes x NoL, and the lobe-mixture density of out_dir with the
    Fresnel lobe weight at the true half vector, with the sampler's clamps
    and isotropic pdf, so that MIS weights built from it sum to one."""
    nov = torch.clamp_min(in_dir.z, 0.001)
    nol = out_dir.z
    ok = (nol > 0.0) & (in_dir.z > 0.0)
    nol_c = torch.clamp_min(nol, 0.001)

    h = (in_dir + out_dir).normalized()
    noh = torch.clamp_max(h.z, 0.99)
    loh = out_dir.dot(h)

    f004 = Vec3.full(roughness.shape, 0.04, roughness.device)
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
    """Uniform direction on the sphere (pdf 1/4pi): the NEE sample of a
    constant sky."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * u2
    return Vec3(r * torch.cos(phi), r * torch.sin(phi), z)


#: pdf of sample_uniform_sphere, and its square taken in float64 (the JAX
#: package squares the Python float before it meets a float32 array)
UNIFORM_SPHERE_PDF = float(1.0 / (4.0 * math.pi))
UNIFORM_SPHERE_PDF_SQ = UNIFORM_SPHERE_PDF * UNIFORM_SPHERE_PDF


def apply_normal_map(normal: Vec3, tangent: Vec3, bitangent: Vec3,
                     tex_rgb: Vec3, strength, has_map) -> Vec3:
    """normal_map_apply (driver.c:129-153): TBN transform with green flip
    and strength lerp toward the interpolated normal."""
    vx = tex_rgb.x * 2.0 - 1.0
    vy = -(tex_rgb.y * 2.0 - 1.0)
    vz = tex_rgb.z * 2.0 - 1.0
    mapped = tangent * vx + bitangent * vy + normal * vz
    n = (mapped * strength + normal * (1.0 - strength)).normalized()
    return Vec3.where(has_map, n, normal)


def basis(view: Vec3, normal: Vec3):
    """View-aligned tangent basis (driver.c:155-164), falling back to the +Y
    then +X axes. Returns (tangent, bitangent)."""
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


def shade(scene, direction: Vec3, normal: Vec3, normal_geo: Vec3,
          tangent: Vec3, bitangent: Vec3, uv_u, uv_v, mat_id, rand4,
          texture_mode: str = "bilinear", nee: bool = False, rand2=None):
    """The material stage for a batch of shaded rays.

    direction: incoming ray direction; normal: unit interpolated shading
    normal; rand4: (>=3, R) uniforms (lobe, u1, u2[, spare]). Returns
    dict(direction, tint, emission, terminate, normal) (Shader_Output,
    scene.h:24-28).

    nee (environment next-event estimation, default off): one light
    sample per vertex from rand2 (3, R), from the scene's env-light alias
    table (`scene.env_light`) or, for a constant sky, uniform on the
    sphere. Adds `nee_dir` (world), `nee_partial` (light x BRDF x NoL x
    power-heuristic MIS weight / light pdf: all but the visibility, which
    the caller's shadow ray decides; zero for the debug shader) and
    `pdf_eval` (the mixture pdf of the sampled scatter direction, for the
    BRDF side's MIS weight at the next miss; +inf for the debug shader).
    """
    m = scene.materials.rows[torch.clamp_min(mat_id, 0).long()]  # (R, 128)
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
    kind = m[:, MROW_KIND].to(torch.int32)

    atlas = scene.atlas
    nrm_tex = texture.sample(atlas, t_nrm, uv_u, uv_v, texture_mode)
    n = apply_normal_map(normal, tangent, bitangent, nrm_tex, nstr, t_nrm >= 0)

    # albedo / metal-roughness / emissive textures (driver.c:354-379)
    alb_tex = texture.sample(atlas, t_alb, uv_u, uv_v, texture_mode)
    base_color = Vec3.where(t_alb >= 0, base_color * alb_tex.map(color.srgb_to_linear),
                            base_color)
    mr_tex = texture.sample(atlas, t_mr, uv_u, uv_v, texture_mode)
    has_mr = t_mr >= 0
    rough = torch.where(has_mr, rough * mr_tex.y, rough)
    metal = torch.where(has_mr, metal * mr_tex.z, metal)

    rough = torch.clamp(rough, 0.001, 1.0)
    metal = torch.clamp_max(metal, 0.9) / 0.9  # metalness remap (driver.c:370-373)

    emi_tex = texture.sample(atlas, t_emi, uv_u, uv_v, texture_mode)
    emission = Vec3.where(t_emi >= 0, emission * emi_tex.map(color.srgb_to_linear),
                          emission)

    # view-aligned tangent basis + world<->tangent (driver.c:381-395)
    t_basis, b_basis = basis(direction, n)
    neg_dir = -direction
    in_dir = Vec3(neg_dir.dot(t_basis), neg_dir.dot(b_basis), neg_dir.dot(n))

    out_t, rgb, pdf = sample_disney_brdf(
        base_color, rough, metal, sheen, sheen_tint, aniso * aniso,
        in_dir, rand4[0], rand4[1], rand4[2],
    )
    out_world = t_basis * out_t.x + b_basis * out_t.y + n * out_t.z

    ok = pdf > 0.0
    inv_pdf = torch.where(ok, 1.0 / torch.where(ok, pdf, 1.0), 0.0)
    tint = rgb * inv_pdf
    terminate = ~ok

    # debug shader: emit the shading normal and stop (driver.c:411-418)
    is_debug = kind == SHADER_DEBUG_NORMAL
    emission = Vec3.where(is_debug, n * 0.5 + 0.5, emission)
    terminate = terminate | is_debug

    out = {
        "direction": out_world,
        "tint": tint,
        "emission": emission,
        "terminate": terminate,
        "normal": n,
    }
    if nee:
        env = scene.env_light
        if env is not None:
            wd, pl = env_light.sample(env, rand2[0], rand2[1], rand2[2])
            pl2 = pl * pl
        else:
            wd = sample_uniform_sphere(rand2[0], rand2[1])
            pl = torch.full_like(rand2[0], UNIFORM_SPHERE_PDF)
            pl2 = torch.full_like(rand2[0], UNIFORM_SPHERE_PDF_SQ)
        wd_t = Vec3(wd.dot(t_basis), wd.dot(b_basis), wd.dot(n))
        f_nol, pdf_ev = eval_disney_brdf(base_color, rough, metal, sheen, sheen_tint,
                                         in_dir, wd_t)
        w_nee = pl2 / (pl2 + pdf_ev * pdf_ev)
        ok_l = pl > 0.0
        inv_pl = torch.where(ok_l, 1.0 / torch.where(ok_l, pl, 1.0), 0.0)
        out["nee_dir"] = wd
        out["nee_partial"] = bg_ops.eval_background(scene, wd) * f_nol * torch.where(
            is_debug, 0.0, w_nee * inv_pl)
        # the mixture pdf of the sampled scatter direction
        _, pdf_out = eval_disney_brdf(base_color, rough, metal, sheen, sheen_tint,
                                      in_dir, out_t)
        out["pdf_eval"] = torch.where(is_debug, float("inf"), pdf_out)
    return out
