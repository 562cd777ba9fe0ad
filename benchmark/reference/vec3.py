"""Component-plane 3-vectors for the plain reference.

Frozen copy of `raytracing_c_tpu_torch/utils/vec3.py` at commit f272015,
with the float type of `full`/`zeros` given by the caller (the reference
runs in float32, and its lower-precision control in bfloat16). The
operation order of `dot`, `cross` and `normalized` is kept, so that the
float32 reference rounds as the program does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Vec3:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def full(shape, value, device=None, dtype=torch.float32) -> "Vec3":
        """The three planes share one tensor: never write them in place."""
        v = torch.full(shape, value, dtype=dtype, device=device)
        return Vec3(v, v, v)

    @staticmethod
    def zeros(shape, device=None, dtype=torch.float32) -> "Vec3":
        return Vec3.full(shape, 0.0, device, dtype)

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length2(self):
        return self.dot(self)

    def normalized(self) -> "Vec3":
        return self * torch.rsqrt(torch.clamp_min(self.length2(), 1e-38))

    def reflect(self, n: "Vec3") -> "Vec3":
        return self - n * (2.0 * self.dot(n))

    def lerp(self, o: "Vec3", t) -> "Vec3":
        return self * (1.0 - t) + o * t

    @staticmethod
    def where(mask, a: "Vec3", b: "Vec3") -> "Vec3":
        return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                    torch.where(mask, a.z, b.z))

    def gather(self, idx) -> "Vec3":
        return Vec3(self.x[idx], self.y[idx], self.z[idx])

    def map(self, fn) -> "Vec3":
        return Vec3(fn(self.x), fn(self.y), fn(self.z))

    @property
    def shape(self):
        return self.x.shape
