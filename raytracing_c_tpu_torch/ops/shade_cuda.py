"""K4: the bounce's shade, background and advance in one CUDA kernel.

| kernel (csrc/shade.cu)     | wrapper        | replaces                                                  |
|----------------------------|----------------|-----------------------------------------------------------|
| K4 `shade_bounce_kernel`   | `shade_bounce` | `render/integrator.py: _tail_plain`, shade to advance      |
| `nee_add_kernel`           | `nee_add`      | its `lit` add after the NEE shadow test                    |

No TPU kernel: the JAX package leaves this stage to XLA. The plain version
is the integrator's own tail, `render/integrator.py: _tail_plain`, which
the integrator runs for CPU tensors and the card tests hold K4 to; for
CUDA tensors the integrator calls `shade_bounce`, which launches K4 or
raises. There is no fallback from a failed build or launch. The wrappers
launch on their tensors' device through `cuda_build.launch`, which counts
the launches. The library builds with every other kernel of the
package at first use (`ops/cuda_build.py`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from raytracing_c_tpu_torch.models.scene import BG_EQUIRECT
from raytracing_c_tpu_torch.ops import cuda_build
from raytracing_c_tpu_torch.utils.vec3 import Vec3

_P = ctypes.c_void_p
_L = ctypes.c_longlong

#: variant flags of rt_shade_bounce (csrc/shade.cu)
V_NEE, V_ENV, V_EQUIRECT = 1, 2, 4
#: the output block's planes: origin, direction, throughput, radiance
#: (0-11); with NEE also prev_pdf (12), the shadow ray's origin and
#: direction (13-18) and its contribution (19-21)
PLANES, PLANES_NEE = 12, 22


class _Plane(ctypes.Structure):
    _fields_ = [("p", _P), ("s", _L)]


class _Args(ctypes.Structure):
    """csrc/shade.cu: K4Args, field for field."""

    _fields_ = [
        ("R", _L),
        ("o", _Plane * 3), ("d", _Plane * 3), ("tp", _Plane * 3), ("rad", _Plane * 3),
        ("prev_pdf", _Plane), ("t", _Plane),
        ("active", _P), ("active_s", _L),
        ("attrs", _P), ("attrs_s0", _L), ("attrs_s1", _L),
        ("rand4", _P), ("rand4_s0", _L), ("rand4_s1", _L),
        ("rand2", _P), ("rand2_s0", _L), ("rand2_s1", _L),
        ("mat_rows", _P), ("n_mat", _L),
        ("tex_r", _P), ("tex_g", _P), ("tex_b", _P),
        ("tex_off", _P), ("tex_w", _P), ("tex_h", _P), ("n_tex", _L),
        ("bg_color", _P), ("bg_tex", _L),
        ("env_prob", _P), ("env_alias", _P), ("env_lum_p", _P), ("env_w", _L), ("env_h", _L),
        ("env_inv_w", ctypes.c_float), ("env_inv_h", ctypes.c_float),
        ("rr", _L), ("gamble", _L), ("nearest", _L),
        ("pow5", ctypes.c_float), ("srgb_exp", ctypes.c_float),
        ("out", _P), ("flags", _P), ("R_out", _L),
    ]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("shade")
    lib.rt_shade_bounce.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, _P]
    lib.rt_shade_bounce.restype = ctypes.c_int
    lib.rt_nee_add.argtypes = [_P, _P, _L, _P, _P, _L, _L, _P]
    lib.rt_nee_add.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype, dim: int, device, rows=None, r=None) -> None:
    """t on `device`, of `dtype`, `dim` dimensions; (rows, r) or (r,)
    when given (rows: the least number of rows)."""
    bad = t.device != device or t.dtype != dtype or t.dim() != dim
    if not bad and r is not None:
        bad = t.shape[-1] != r or (rows is not None and t.shape[0] < rows)
    if bad:
        want = "" if r is None else f" of shape {((rows,) if rows else ()) + (r,)}"
        raise ValueError(f"shade_bounce: {name} needs a {dim}-d {dtype} tensor{want} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _table(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"shade_bounce: {name} needs a contiguous {dtype} tensor on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_vec(name: str, v: Vec3, r: int, device) -> None:
    for c in "xyz":
        _check(f"{name}.{c}", getattr(v, c), torch.float32, 1, device, r=r)


def _variant(scene, nee: bool) -> int:
    """The flags of the K4 variant for this call."""
    bg = scene.background
    return ((V_NEE if nee else 0) | (V_ENV if nee and scene.env_light is not None else 0)
            | (V_EQUIRECT if bg.kind == BG_EQUIRECT and bg.tex_id >= 0 else 0))


def _pack_args(scene, st: dict, t, attrs, rand4, rand2, flags: int, rr: bool, gamble: bool,
               nearest: bool, out: torch.Tensor, mask: torch.Tensor) -> _Args:
    """K4's argument for these tensors (checked by the caller; the pointers
    stay valid while the tensors live)."""
    a = _Args()
    a.R = st["active"].shape[0]
    for field, name in (("o", "origin"), ("d", "direction"), ("tp", "throughput"),
                        ("rad", "radiance")):
        v = st[name]
        planes = getattr(a, field)
        for k, c in enumerate("xyz"):
            p = getattr(v, c)
            planes[k].p, planes[k].s = p.data_ptr(), p.stride(0)
    a.t.p, a.t.s = t.data_ptr(), t.stride(0)
    a.active, a.active_s = st["active"].data_ptr(), st["active"].stride(0)
    a.attrs, a.attrs_s0, a.attrs_s1 = attrs.data_ptr(), *attrs.stride()
    a.rand4, a.rand4_s0, a.rand4_s1 = rand4.data_ptr(), *rand4.stride()
    if flags & V_NEE:
        a.prev_pdf.p, a.prev_pdf.s = st["prev_pdf"].data_ptr(), st["prev_pdf"].stride(0)
        a.rand2, a.rand2_s0, a.rand2_s1 = rand2.data_ptr(), *rand2.stride()
    rows = scene.materials.rows
    a.mat_rows, a.n_mat = rows.data_ptr(), rows.shape[0]
    at = scene.atlas
    a.tex_r, a.tex_g, a.tex_b = at.tex_r.data_ptr(), at.tex_g.data_ptr(), at.tex_b.data_ptr()
    a.tex_off, a.tex_w, a.tex_h = at.offset.data_ptr(), at.width.data_ptr(), at.height.data_ptr()
    a.n_tex = at.offset.shape[0]
    bg = scene.background
    a.bg_color, a.bg_tex = bg.color.data_ptr(), bg.tex_id
    if flags & V_ENV:
        env = scene.env_light
        a.env_prob, a.env_alias, a.env_lum_p = (env.prob.data_ptr(), env.alias.data_ptr(),
                                                env.lum_p.data_ptr())
        a.env_w, a.env_h = env.w, env.h
        # u / w on the card: u * (float)(1.0 / w), the reciprocal taken in double
        a.env_inv_w, a.env_inv_h = 1.0 / env.w, 1.0 / env.h
    a.rr, a.gamble, a.nearest = int(rr), int(gamble), int(nearest)
    a.pow5, a.srgb_exp = 5.0, 2.4
    a.out, a.flags, a.R_out = out.data_ptr(), mask.data_ptr(), out.shape[1]
    return a


def shade_bounce(scene, st: dict, t, attrs, rand4, rand2=None, texture_mode: str = "bilinear",
                 rr: bool = False, gamble: bool = False, nee: bool = False) -> dict:
    """K4 wrapper: one bounce's shade, background and advance over the R
    lanes of the state `st` (integrator.bounce_step's planes: origin,
    direction, throughput, radiance Vec3 of (R,) float32, active (R,)
    bool, prev_pdf (R,) float32), given the hits' t (R,) and their (16, R)
    attribute planes (`traverse_cuda.fetch_attrs_plain`'s layout, sphere
    winners written in), rand4 (>= 3 rows, 4 with rr, R) and with nee
    rand2 (3, R). Every plane may have any stride. gamble: Russian
    roulette plays this bounce (rr and bounce >= RR_START).

    Returns the next state's origin, direction, throughput, radiance,
    active and prev_pdf (the input's without nee), the shaded mask
    "shaded", and with nee the shadow rays "shadow" (6, R: origin,
    direction; valid on the shaded lanes) and their contribution "nee"
    (3, R) for `nee_add`. Raises for CPU tensors, a wrong dtype, shape or
    layout, or a failed launch."""
    dev = st["active"].device
    if dev.type != "cuda":
        raise ValueError(f"shade_bounce: needs CUDA tensors, got {dev}")
    r = st["active"].shape[0]
    _check("active", st["active"], torch.bool, 1, dev, r=r)
    for name in ("origin", "direction", "throughput", "radiance"):
        _check_vec(name, st[name], r, dev)
    _check("t", t, torch.float32, 1, dev, r=r)
    _check("attrs", attrs, torch.float32, 2, dev, rows=16, r=r)
    _check("rand4", rand4, torch.float32, 2, dev, rows=4 if rr else 3, r=r)
    if nee:
        _check("prev_pdf", st["prev_pdf"], torch.float32, 1, dev, r=r)
        _check("rand2", rand2, torch.float32, 2, dev, rows=3, r=r)
    rows = scene.materials.rows
    _table("materials.rows", rows, torch.float32, dev)
    if rows.dim() != 2 or rows.shape[1] != 128 or rows.shape[0] == 0:
        raise ValueError(f"shade_bounce: materials.rows needs shape (n >= 1, 128), got "
                         f"{tuple(rows.shape)}")
    at = scene.atlas
    for name in ("tex_r", "tex_g", "tex_b"):
        _table(f"atlas.{name}", getattr(at, name), torch.uint8, dev)
    for name in ("offset", "width", "height"):
        _table(f"atlas.{name}", getattr(at, name), torch.int32, dev)
    flags = _variant(scene, nee)
    if not flags & V_EQUIRECT:
        _table("background.color", scene.background.color, torch.float32, dev)
    if flags & V_ENV:
        env = scene.env_light
        _table("env_light.prob", env.prob, torch.float32, dev)
        _table("env_light.alias", env.alias, torch.int64, dev)
        _table("env_light.lum_p", env.lum_p, torch.float32, dev)

    out = torch.empty((PLANES_NEE if nee else PLANES, r), dtype=torch.float32, device=dev)
    mask = torch.empty((2, r), dtype=torch.bool, device=dev)
    res = {
        "origin": Vec3(out[0], out[1], out[2]),
        "direction": Vec3(out[3], out[4], out[5]),
        "throughput": Vec3(out[6], out[7], out[8]),
        "radiance": Vec3(out[9], out[10], out[11]),
        "active": mask[0],
        "shaded": mask[1],
        "prev_pdf": out[12] if nee else st["prev_pdf"],
    }
    if nee:
        res.update(shadow=out[13:19], nee=out[19:22], block=out)
    if r == 0:
        return res
    args = _pack_args(scene, st, t, attrs, rand4, rand2, flags, rr, gamble,
                      texture_mode == "nearest", out, mask)
    cuda_build.launch("shade_bounce", _library().rt_shade_bounce, ctypes.byref(args), flags,
                      device=dev)
    return res


def nee_add(k4: dict, lanes: torch.Tensor, shot_t: torch.Tensor) -> None:
    """Adds, in place, K4's NEE contribution to the radiance of the shaded
    lanes `lanes` (int64) whose shadow ray missed (shot_t not finite):
    radiance + (lit ? contribution : 0), the plain path's `lit` add."""
    out = k4["block"]
    dev = out.device
    _check("lanes", lanes, torch.int64, 1, dev)
    _check("shot_t", shot_t, torch.float32, 1, dev, r=lanes.shape[0])
    lanes = lanes.contiguous()
    n = lanes.shape[0]
    if n == 0:
        return
    cuda_build.launch("nee_add", _library().rt_nee_add, out[9].data_ptr(), out[19].data_ptr(),
                      out.shape[1], lanes.data_ptr(), shot_t.data_ptr(), shot_t.stride(0), n,
                      device=dev)
