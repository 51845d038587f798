"""Structure-of-arrays 3-vectors (torch port of tpurt/core/v3.py).

A V3 is three same-shaped tensors. Every op is the same component
transcription as tpurt's, in the same association order, so the two
packages round identically; ``normalize`` uses the correctly rounded
``1/sqrt`` (rng.rsqrt) that the CUDA kernel also uses.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpurt_torch.config import EPSILON
from tpurt_torch.core.rng import rsqrt, sqrt

_EPS = float(np.float32(EPSILON))


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def __mul__(self, s):
        if isinstance(s, V3):
            return V3(self.x * s.x, self.y * s.y, self.z * s.z)
        return V3(self.x * s, self.y * s, self.z * s)

    def __rmul__(self, s):
        return V3(s * self.x, s * self.y, s * self.z)

    def __truediv__(self, s):
        if isinstance(s, V3):
            return V3(self.x / s.x, self.y / s.y, self.z / s.z)
        return V3(self.x / s, self.y / s, self.z / s)


def from_rows(a: torch.Tensor) -> V3:
    return V3(a[..., 0], a[..., 1], a[..., 2])


def to_rows(v: V3) -> torch.Tensor:
    return torch.stack([v.x, v.y, v.z], dim=-1)


def full_like(ref: torch.Tensor, value) -> V3:
    c = torch.full_like(ref, value, dtype=torch.float32)
    return V3(c, c, c)


def dot(a: V3, b: V3) -> torch.Tensor:
    """(x + y) + z, like tpurt's dot."""
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(a: V3) -> torch.Tensor:
    return sqrt(dot(a, a))


def normalize(a: V3) -> V3:
    inv = rsqrt(dot(a, a))
    return V3(a.x * inv, a.y * inv, a.z * inv)


def lerp(a: V3, b: V3, t) -> V3:
    w = 1.0 - t
    return V3(a.x * w + b.x * t, a.y * w + b.y * t, a.z * w + b.z * t)


def where(mask: torch.Tensor, a: V3, b: V3) -> V3:
    return V3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def reflect(in_dir: V3, normal: V3) -> V3:
    """Trace.cl:234-236 — in - 2*dot(in,n)*n."""
    k = 2.0 * dot(in_dir, normal)
    return V3(in_dir.x - k * normal.x, in_dir.y - k * normal.y,
              in_dir.z - k * normal.z)


def refract(in_dir: V3, normal: V3, ior_a, ior_b) -> V3:
    """Snell refraction, zero vector on TIR (Trace.cl:219-232)."""
    ratio = ior_a / ior_b
    cos_in = -dot(in_dir, normal)
    sin_sqr_refr = ratio * ratio * (1.0 - cos_in * cos_in)
    tir = sin_sqr_refr > 1.0
    root = sqrt(torch.clamp_min(1.0 - sin_sqr_refr, 0.0))
    k = ratio * cos_in - root
    out = V3(
        ratio * in_dir.x + k * normal.x,
        ratio * in_dir.y + k * normal.y,
        ratio * in_dir.z + k * normal.z,
    )
    return where(tir, full_like(out.x, 0.0), out)


def fresnel_reflectance(in_dir: V3, normal: V3, ior_a, ior_b) -> torch.Tensor:
    """Full s/p-average Fresnel (Trace.cl:401-432)."""
    ratio = ior_a / ior_b
    cos_in = -dot(in_dir, normal)
    sin_sqr_refr = ratio * ratio * (1.0 - cos_in * cos_in)
    cos_refr = sqrt(torch.clamp_min(1.0 - sin_sqr_refr, 0.0))
    denom = ior_a * cos_in + ior_b * cos_refr
    r_perp = (ior_a * cos_in - ior_b * cos_refr) / denom
    r_par = (ior_b * cos_in - ior_a * cos_refr) / denom
    refl = 0.5 * (r_perp * r_perp + r_par * r_par)
    degenerate = (cos_in <= 0.0) | (sin_sqr_refr >= 1.0) | (denom < _EPS)
    return torch.where(degenerate, 1.0, refl)
