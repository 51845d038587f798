"""Vector math on (..., 3) float32 tensors (torch port of
tpurt/core/vecmath.py; Trace.cl:80-156 and the optics at
Trace.cl:219-236,401-432).

The AoS helpers unpack their rows into the SoA arithmetic of
``core/v3.py`` and stack the result, so both forms round alike. Scalars
(t, the two indices of refraction) become float32 tensors on the input's
device before any arithmetic, as tpurt's do.

Rotation matrices are built on the host in numpy float32: they are a
handful of scalars per mesh or camera, and numpy's f32 cos/sin are the
ones tpurt's CPU reference and the scalar oracle agree with, so the
tables are identical on every device the port runs on.
"""

from __future__ import annotations

import numpy as np
import torch

from tpurt_torch.core import v3


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(x + y) + z, like tpurt's 3-element sum."""
    return v3.dot(v3.from_rows(a), v3.from_rows(b))


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return v3.to_rows(v3.cross(v3.from_rows(a), v3.from_rows(b)))


def length3(a: torch.Tensor) -> torch.Tensor:
    """Correctly rounded sqrt(dot3(a, a)) -> (...,)."""
    return v3.length(v3.from_rows(a))


def normalize3(a: torch.Tensor) -> torch.Tensor:
    return v3.to_rows(v3.normalize(v3.from_rows(a)))


def lerp3(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """a*(1-t) + b*t with t broadcast over the vector axis (Trace.cl:84)."""
    return v3.to_rows(v3.lerp(v3.from_rows(a), v3.from_rows(b), _f32(t, a)))


def reflect(in_dir: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Mirror reflection (Trace.cl:234-236)."""
    return v3.to_rows(v3.reflect(v3.from_rows(in_dir), v3.from_rows(normal)))


def refract(in_dir: torch.Tensor, normal: torch.Tensor, ior_a,
            ior_b) -> torch.Tensor:
    """Snell refraction; zero vector on total internal reflection
    (Trace.cl:219-232)."""
    return v3.to_rows(v3.refract(v3.from_rows(in_dir), v3.from_rows(normal),
                                 _f32(ior_a, in_dir), _f32(ior_b, in_dir)))


def fresnel_reflectance(in_dir: torch.Tensor, normal: torch.Tensor, ior_a,
                        ior_b) -> torch.Tensor:
    """Unpolarised Fresnel reflectance (Trace.cl:401-432) -> (...,);
    1 on grazing incidence and total internal reflection."""
    return v3.fresnel_reflectance(v3.from_rows(in_dir), v3.from_rows(normal),
                                  _f32(ior_a, in_dir), _f32(ior_b, in_dir))


def euler_rotation(pitch: float, yaw: float, roll: float) -> np.ndarray:
    """XYZ-Euler rotation, rows exactly as makeRotation (Trace.cl:90-100),
    as a (3, 3) numpy float32 array."""
    p, y, r = np.float32(pitch), np.float32(yaw), np.float32(roll)
    cx, sx = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(r), np.sin(r)
    return np.array([
        [cy * cz, cy * sz, -sy],
        [cz * sy * sx - cx * sz, cx * cz + sx * sy * sz, cy * sx],
        [sx * sz + cx * cz * sy, cx * sy * sz - cz * sx, cx * cy],
    ], np.float32)


def rotate(m: np.ndarray, v: torch.Tensor) -> torch.Tensor:
    """mul_mat_vec(m, v) (Trace.cl:105-107): out_i = sum_j m[i][j] * v_j,
    summed j = 0, 1, 2, for a host (3, 3) float32 matrix."""
    return rotate_t(np.asarray(m, np.float32).T, v)


def rotate_t(m: np.ndarray, v: torch.Tensor) -> torch.Tensor:
    """mul_mat_vec(transpose(m), v): out_i = sum_j m[j][i] * v_j,
    summed j = 0, 1, 2."""
    m = [[float(m[j][i]) for i in range(3)] for j in range(3)]
    return torch.stack([
        m[0][i] * v[..., 0] + m[1][i] * v[..., 1] + m[2][i] * v[..., 2]
        for i in range(3)
    ], dim=-1)


def hsv2rgb(h, s, v, device="cuda") -> torch.Tensor:
    """HSV -> RGB with the reference's sector semantics (src/math.hpp:19-75):
    h in degrees, h >= 360 wraps to 0, C truncation of h / 60 picks the
    sector and sectors outside 0..4 (h <= -60 among them) take the
    switch's default arm (5); s <= 0 gives the grey (v, v, v). h, s and v
    broadcast; returns (..., 3) float32 on h's device when h is a tensor,
    else on ``device``."""
    dev = h.device if isinstance(h, torch.Tensor) else device
    h, s, v = (torch.as_tensor(x, dtype=torch.float32, device=dev)
               for x in (h, s, v))
    h, s, v = torch.broadcast_tensors(h, s, v)
    # A 0-dim divisor: torch on CUDA divides by a Python scalar as a
    # multiply by its reciprocal, and the CPU divides (camera.jittered_uv).
    hh = torch.where(h >= 360.0, 0.0, h) / torch.tensor(60.0, device=dev)
    i = torch.trunc(hh)
    ff = hh - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * ff)
    t = v * (1.0 - s * (1.0 - ff))
    sector = i.to(torch.int32)
    # (r, g, b) per sector 0..4; anything else is the default arm.
    arms = ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v))
    rgb = [v, p, q]
    for k in range(4, -1, -1):
        rgb = [torch.where(sector == k, arm, c) for arm, c in zip(arms[k], rgb)]
    rgb = torch.stack(rgb, dim=-1)
    return torch.where((s <= 0.0)[..., None], torch.stack([v, v, v], -1), rgb)
