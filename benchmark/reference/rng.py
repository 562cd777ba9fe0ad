"""threefry2x32: `jax.random`'s key and uniform stream, in torch integer ops.

Frozen copy of `raytracing_c_tpu_torch/utils/rng.py` at commit f272015
(PRNGKey, fold_in, split, random_bits, uniform on [0, 1)): the program
draws every sample from this stream, so the reference draws the same.
A key is an int64 tensor of shape (..., 2) holding two uint32 words.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on broadcastable int64 tensors of uint32."""
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
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _M32
        zero = torch.zeros_like(data)
    else:
        data, zero = int(data) & _M32, 0
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], zero, data)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    i = i.reshape((num,) + (1,) * (key.dim() - 1))
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    shape = tuple(shape)
    n = math.prod(shape)
    c = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.dim() - 1
    k0 = key[..., 0].reshape(key.shape[:-1] + (1,) * len(shape))
    k1 = key[..., 1].reshape(key.shape[:-1] + (1,) * len(shape))
    c = c.reshape((1,) * lead + shape)
    b0, b1 = threefry2x32(k0, k1, c >> 32, c & _M32)
    return b0 ^ b1


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32) on [0, 1)."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f, 0.0)
