"""Vector math on (..., 3) float32 tensors (torch port of
tpurt/core/vecmath.py; Trace.cl:80-156).

Rotation matrices are built on the host in numpy float32: they are a
handful of scalars per mesh or camera, and numpy's f32 cos/sin are the
ones tpurt's CPU reference and the scalar oracle agree with, so the
tables are identical on every device the port runs on.
"""

from __future__ import annotations

import numpy as np
import torch

from tpurt_torch.core.rng import rsqrt


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(x + y) + z, like tpurt's 3-element sum."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize3(a: torch.Tensor) -> torch.Tensor:
    return a * rsqrt(dot3(a, a))[..., None]


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


def rotate_t(m: np.ndarray, v: torch.Tensor) -> torch.Tensor:
    """mul_mat_vec(transpose(m), v): out_i = sum_j m[j][i] * v_j,
    summed j = 0, 1, 2."""
    m = [[float(m[j][i]) for i in range(3)] for j in range(3)]
    return torch.stack([
        m[0][i] * v[..., 0] + m[1][i] * v[..., 1] + m[2][i] * v[..., 2]
        for i in range(3)
    ], dim=-1)
