"""K5: the threefry2x32 draws in one CUDA launch each.

| kernel (csrc/rng.cu)        | wrapper                  | counted as            |
|-----------------------------|--------------------------|-----------------------|
| `k5_fold_in_kernel`         | `fold_in`                | `rng_fold_in`         |
| `k5_split_kernel`           | `split`                  | `rng_split`           |
| `k5_bits_kernel`            | `random_bits`, `uniform` | `rng_bits`            |
| `k5_bounce_uniforms_kernel` | `bounce_uniforms`        | `rng_bounce_uniforms` |

Each wrapper replaces the `utils/rng.py` function of its name, whose plain
int64 PyTorch version stays for CPU keys; `bounce_uniforms` is
uniform(fold_in(fold_in(key, slot), bounce), (nu,)).T in one launch.

No TPU kernel: the JAX package draws through `jax.random`. `utils/rng.py`
calls these wrappers for CUDA keys; the card tests hold K5 to its plain
version bit for bit. A wrapper launches on its tensors' device or raises
(a CPU tensor, a wrong dtype or shape, a failed launch); there is no
fallback. Launches are counted per kernel in `launch_counts()`. The
library builds with every other kernel of the package at first use
(`ops/cuda_build.py`).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from raytracing_c_tpu_torch.ops import cuda_build

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_M32 = 0xFFFFFFFF

#: launches per kernel: random_bits and uniform share k5_bits_kernel
_launches = {"rng_fold_in": 0, "rng_split": 0, "rng_bits": 0, "rng_bounce_uniforms": 0}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("rng")
    lib.rt_fold_in.argtypes = [_P, _L, _P, _L, _L, _L, _P, _P]
    lib.rt_split.argtypes = [_P, _L, _L, _L, _P, _P]
    lib.rt_random_bits.argtypes = [_P, _L, _L, _L, _P, _P]
    lib.rt_uniform.argtypes = [_P, _L, _L, _L, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                               _P, _P]
    lib.rt_bounce_uniforms.argtypes = [_P, _P, _L, _L, ctypes.c_int, _L, _P, _P]
    for fn in (lib.rt_fold_in, lib.rt_split, lib.rt_random_bits, lib.rt_uniform,
               lib.rt_bounce_uniforms):
        fn.restype = ctypes.c_int
    return lib


def _check_key(name: str, key: torch.Tensor) -> None:
    if key.device.type != "cuda" or key.dtype != torch.int64 or key.dim() < 1 \
            or key.shape[-1] != 2:
        raise ValueError(f"{name}: the key needs an int64 CUDA tensor of shape (..., 2), got "
                         f"{key.dtype} {tuple(key.shape)} on {key.device}")


def _rows(t: torch.Tensor, width: int):
    """t (its leading dimensions, then `width` words a row when width is 2)
    as (tensor, row stride): stride 0 where every row is the same memory
    (one key, or an expanded one), else a contiguous tensor."""
    lead = t.stride()[:t.dim() - 1] if width == 2 else t.stride()
    if all(s == 0 for s in lead) and (width == 1 or t.stride(-1) == 1):
        return t, 0
    return t.contiguous(), width


def _launch(kernel: str, fn, *args, device) -> None:
    """fn(*args, stream) on `device`'s current stream, counted as `kernel`."""
    with torch.cuda.device(device):  # the launch goes to the current device
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
    _launches[kernel] += 1


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """rng.fold_in on the card: key (..., 2) and data a python int or an
    integer tensor broadcastable against the key's leading dimensions (a
    0-d CPU tensor counts as a python int). Returns the broadcast shape +
    (2,), int64."""
    _check_key("fold_in", key)
    if isinstance(data, torch.Tensor) and data.device.type == "cpu" and data.dim() == 0:
        data = int(data)
    if isinstance(data, torch.Tensor):
        if data.device != key.device:
            raise ValueError(f"fold_in: data on {data.device}, the key on {key.device}")
        lead = torch.broadcast_shapes(key.shape[:-1], data.shape)
        data, data_s = _rows(data.to(torch.int64).expand(lead), 1)
        ptr, scalar = data.data_ptr(), 0
    else:
        lead, ptr, data_s, scalar = key.shape[:-1], None, 0, int(data) & _M32
    keys, key_s = _rows(key.expand(lead + (2,)), 2)
    out = torch.empty(lead + (2,), dtype=torch.int64, device=key.device)
    m = math.prod(lead)
    if m:
        _launch("rng_fold_in", _library().rt_fold_in, keys.data_ptr(), key_s, ptr, data_s,
                scalar, m, out.data_ptr(), device=key.device)
    return out


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """rng.split on the card: (num,) + key.shape, int64."""
    _check_key("split", key)
    keys, key_s = _rows(key, 2)
    out = torch.empty((num,) + key.shape, dtype=torch.int64, device=key.device)
    if out.numel():
        _launch("rng_split", _library().rt_split, keys.data_ptr(), key_s, key[..., 0].numel(),
                num, out.data_ptr(), device=key.device)
    return out


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """rng.random_bits on the card: key.shape[:-1] + shape, int64 holding
    uint32 words."""
    _check_key("random_bits", key)
    shape = tuple(shape)
    keys, key_s = _rows(key, 2)
    out = torch.empty(key.shape[:-1] + shape, dtype=torch.int64, device=key.device)
    if out.numel():
        _launch("rng_bits", _library().rt_random_bits, keys.data_ptr(), key_s,
                key[..., 0].numel(), math.prod(shape), out.data_ptr(), device=key.device)
    return out


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """rng.uniform on the card: key.shape[:-1] + shape, float32; the
    bounds and their difference rounded to float32 as the plain version
    rounds them."""
    _check_key("uniform", key)
    shape = tuple(shape)
    keys, key_s = _rows(key, 2)
    out = torch.empty(key.shape[:-1] + shape, dtype=torch.float32, device=key.device)
    bounded = not (minval == 0.0 and maxval == 1.0)
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    if out.numel():
        _launch("rng_bits", _library().rt_uniform, keys.data_ptr(), key_s, key[..., 0].numel(),
                math.prod(shape), float(lo), float(span), int(bounded), out.data_ptr(),
                device=key.device)
    return out


def bounce_uniforms(key: torch.Tensor, slot: torch.Tensor, bounce: int, nu: int) -> torch.Tensor:
    """rng.bounce_uniforms on the card: one key (2,), the lanes' slots (n,)
    (any integer dtype and stride), the bounce index; returns the (nu, n)
    float32 plane, contiguous, lane j's nu uniforms in column j."""
    _check_key("bounce_uniforms", key)
    if key.shape != (2,):
        raise ValueError(f"bounce_uniforms: needs one key of shape (2,), got {tuple(key.shape)}")
    if slot.device != key.device or slot.dim() != 1 or slot.is_floating_point():
        raise ValueError(f"bounce_uniforms: slot needs a 1-d integer tensor on {key.device}, "
                         f"got {slot.dtype} {tuple(slot.shape)} on {slot.device}")
    if nu < 1:
        raise ValueError(f"bounce_uniforms: nu must be at least 1, got {nu}")
    slot = slot.to(torch.int64)
    n = slot.shape[0]
    out = torch.empty((nu, n), dtype=torch.float32, device=key.device)
    if n:
        key = key.contiguous()
        _launch("rng_bounce_uniforms", _library().rt_bounce_uniforms, key.data_ptr(),
                slot.data_ptr(), slot.stride(0), int(bounce) & _M32, nu, n, out.data_ptr(),
                device=key.device)
    return out


def launch_counts() -> dict:
    """K5's launches per kernel: rng_fold_in, rng_split, rng_bits (random_bits
    and uniform) and rng_bounce_uniforms."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
