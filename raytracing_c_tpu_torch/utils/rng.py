"""threefry2x32 in torch integer ops: `jax.random`'s stream, bit for bit.

The JAX package draws every random number from `jax.random` (threefry
under `jax_threefry_partitionable=True`, the JAX 0.9 default):

- the per-batch jitter, `split(fold_in(PRNGKey(seed), b))`
  (renderer.py:96-115, 140-147);
- the slot-keyed per-bounce draw,
  `uniform(fold_in(fold_in(fold_in(kb, 1), slot), bounce), (nu,))`
  (integrator.py:555-561).

This module reproduces `PRNGKey`, `fold_in`, `split` and `uniform(float32)`
so the port renders the same samples. A key is an int64 tensor of shape
(..., 2) holding two uint32 words; torch has no full uint32 arithmetic, so
the words live in int64 and every add and shift is masked to 32 bits.
Leading key dimensions batch: a (w, 2) key tensor gives w streams at once.

A draw whose key lies on the card is one launch of K5 (`ops/rng_cuda.py`,
`csrc/rng.cu`); a CPU key takes the plain int64 version below, which the
card tests hold K5 to bit for bit. `bounce_uniforms` is the compacted
tracer's draw a bounce. While spans are on, each draw notes on the open
span the kernel it went through (`k5` or `plain`) and adds its draws and
its width, the values it wrote (`spans.rng_summary` reads them).
"""

from __future__ import annotations

import math

import torch

from raytracing_c_tpu_torch.ops import rng_cuda
from raytracing_c_tpu_torch.utils import spans

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher, 20 rounds (Salmon et al. 2011), on
    broadcastable int64 tensors holding uint32 values."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) for 0 <= seed < 2**32."""
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def _draw(k5, plain, key: torch.Tensor, *args) -> torch.Tensor:
    """One draw: K5's wrapper for a key on the card, else the plain
    version; noted on the open span while spans are on."""
    cuda = key.device.type == "cuda"
    out = (k5 if cuda else plain)(key, *args)
    if spans.enabled():
        spans.note(kernel="k5" if cuda else "plain")
        spans.add(draws=1, width=out.numel())
    return out


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in: threefry of the counter pair (0, data).

    data: a python int or an integer tensor broadcastable against the
    key's leading dimensions."""
    return _draw(rng_cuda.fold_in, _fold_in_plain, key, data)


def _fold_in_plain(key: torch.Tensor, data) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _M32
        zero = torch.zeros_like(data)
    else:  # a python int stays on the host: no copy to the device
        data, zero = int(data) & _M32, 0
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], zero, data)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split (partitionable form): subkey i = threefry(key, (0, i)).
    Returns (num,) + key.shape."""
    return _draw(rng_cuda.split, _split_plain, key, num)


def _split_plain(key: torch.Tensor, num: int) -> torch.Tensor:
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    i = i.reshape((num,) + (1,) * (key.dim() - 1))
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit random words: bits1 ^ bits2 of threefry over the flat
    row-major counter. Returns key.shape[:-1] + shape (int64)."""
    return _draw(rng_cuda.random_bits, _random_bits_plain, key, shape)


def _random_bits_plain(key: torch.Tensor, shape) -> torch.Tensor:
    shape = tuple(shape)
    n = math.prod(shape)
    c = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.dim() - 1
    k0 = key[..., 0].reshape(key.shape[:-1] + (1,) * len(shape))
    k1 = key[..., 1].reshape(key.shape[:-1] + (1,) * len(shape))
    c = c.reshape((1,) * lead + shape)
    b0, b1 = threefry2x32(k0, k1, c >> 32, c & _M32)
    return b0 ^ b1


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval): the top 23
    bits as the mantissa of a float in [1, 2), minus one, then
    max(minval, f * (maxval - minval) + minval) with one rounding of the
    multiply-add (XLA fuses it; the float64 product of two float32 is
    exact), the bounds and their difference in float32."""
    return _draw(rng_cuda.uniform, _uniform_plain, key, shape, minval, maxval)


def _uniform_plain(key: torch.Tensor, shape, minval: float = 0.0,
                   maxval: float = 1.0) -> torch.Tensor:
    bits = _random_bits_plain(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return torch.clamp_min(f, 0.0)
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=f.device) - lo
    return torch.maximum(lo, (f.double() * span.double() + lo.double()).float())


def bounce_uniforms(key: torch.Tensor, slot: torch.Tensor, bounce: int, nu: int) -> torch.Tensor:
    """The compacted tracer's draw a bounce (integrator.trace_bucketed): for
    the lanes' sample slots (n,) under one key (2,), the (nu, n) float32
    plane uniform(fold_in(fold_in(key, slot), bounce), (nu,)).T, the JAX
    package's slot-keyed stream. One K5 launch on the card (a contiguous
    plane); on the CPU the plain composition (a transposed view)."""
    return _draw(rng_cuda.bounce_uniforms, _bounce_uniforms_plain, key, slot, bounce, nu)


def _bounce_uniforms_plain(key: torch.Tensor, slot: torch.Tensor, bounce: int,
                           nu: int) -> torch.Tensor:
    return _uniform_plain(_fold_in_plain(_fold_in_plain(key, slot), bounce), (nu,)).T


#: Giles' single-precision erfinv polynomials, |w| < 5 and beyond (the
#: coefficients XLA expands `erf_inv` to for float32)
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv with the polynomial XLA uses (Giles 2010):
    w = -log1p(-x^2), then a degree-8 polynomial in w - 2.5 or sqrt(w) - 3
    by Horner steps rounded once each (XLA fuses them into FMAs; the float64
    product of two float32 is exact), times x; +-inf at +-1. torch's log1p
    rounds differently from XLA's on some inputs, so results differ from
    jax.lax.erf_inv by up to 2 float32 ulps there."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERFINV_W_LT_5[0], _ERFINV_W_GE_5[0])
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        c = torch.where(lt, torch.tensor(a, dtype=torch.float32, device=x.device),
                        torch.tensor(b, dtype=torch.float32, device=x.device))
        p = (c.double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.normal(key, shape, float32): sqrt(2) * erfinv(u) of u
    uniform on [nextafter(-1, 0), 1)."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    return math.sqrt(2.0) * erfinv(uniform(key, shape, lo, 1.0))
