"""Camera model and primary rays (torch port of tpurt/core/camera.py;
MakeRay, Trace.cl:596-621).

The per-camera scalars (tan of the half fov, the rotation) are computed
once on the host in numpy float32; the per-pixel arithmetic runs in
torch on the camera's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpurt_torch.core import rng
from tpurt_torch.core.vecmath import euler_rotation, normalize3, rotate_t
from tpurt_torch.utils.profiling import host_read


class Camera(NamedTuple):
    """Mirror of tpurt's Camera: (8,) f32 params = pos.xyz, pitch, yaw,
    roll, fov (degrees), aspect."""

    params: torch.Tensor

    @property
    def position(self) -> torch.Tensor:
        return self.params[0:3]

    @property
    def pitch(self) -> torch.Tensor:
        return self.params[3]

    @property
    def yaw(self) -> torch.Tensor:
        return self.params[4]

    @property
    def roll(self) -> torch.Tensor:
        return self.params[5]

    @property
    def fov_degrees(self) -> torch.Tensor:
        return self.params[6]

    @property
    def aspect_ratio(self) -> torch.Tensor:
        return self.params[7]

    @classmethod
    def create(cls, position, pitch=0.0, yaw=0.0, roll=0.0, fov_degrees=90.0,
               aspect_ratio=1.0, device="cuda") -> "Camera":
        position = np.asarray(position, np.float32)
        p = np.array([position[0], position[1], position[2],
                      pitch, yaw, roll, fov_degrees, aspect_ratio], np.float32)
        return cls(params=torch.from_numpy(p).to(device))

    def host_params(self) -> np.ndarray:
        return host_read(self.params.detach(), "camera").numpy().astype(np.float32)


def camera_scalars(camera: Camera):
    """The camera's per-frame scalars, as make_ray uses them: (position
    (3,), rotation (3, 3) row-major, tan of the half fov, aspect), numpy
    float32. Kernel B1 takes the same values for its jittered rays."""
    p = camera.host_params()
    # deg2rad as x * f32(pi/180), the form tpurt's jnp.deg2rad takes.
    tan = np.tan(p[6] * np.float32(0.5) * np.float32(np.pi / 180))
    return p[0:3], euler_rotation(p[3], p[4], p[5]), np.float32(tan), p[7]


def make_ray(camera: Camera, uv: torch.Tensor):
    """MakeRay for a batch of uv (..., 2) -> (origins, directions)."""
    _pos, rot, scale, aspect = camera_scalars(camera)
    scale, aspect = float(scale), float(aspect)
    ndc = uv * 2.0 - 1.0
    ndc_x = ndc[..., 0] * aspect
    ndc_y = ndc[..., 1]
    dir_cam = normalize3(torch.stack(
        [ndc_x * scale, ndc_y * scale, torch.ones_like(ndc_x)], dim=-1
    ))
    # The camera applies makeRotation transposed (Trace.cl:608-616).
    dir_world = normalize3(rotate_t(rot, dir_cam))
    origin = camera.position.to(uv.device).expand(dir_world.shape)
    return origin, dir_world


def pixel_uv(x: torch.Tensor, y: torch.Tensor, width: int, height: int):
    """Per-pixel uv with the kernel's y flip (Trace.cl:634-635), divided
    exactly on every device (``rng.divide``)."""
    u = rng.divide(x.to(torch.float32), width)
    v = 1.0 - rng.divide(y.to(torch.float32), height)
    return torch.stack([u, v], dim=-1)


#: Salt of the sub-pixel jitter's auxiliary stream (tpurt's camera_rays
#: and megakernel primary_ray): its own seed, so the main stream is
#: untouched.
JITTER_SALT = 0xA511E9B3


def jittered_uv(xs: torch.Tensor, ys: torch.Tensor, pixel_index: torch.Tensor,
                frame_index, sample, width: int, height: int) -> torch.Tensor:
    """pixel_uv moved by the sub-pixel jitter: two random_values of the
    stream MakeSeed(pixel ^ JITTER_SALT, frame, sample), and uv +=
    ((jx - 0.5) / W, (jy - 0.5) / H).

    Every division divides by a 0-dim tensor on the pixels' device: torch
    on CUDA divides by a Python scalar as a multiply by its reciprocal,
    while kernel B1, which recomputes these rays, divides as IEEE does.
    On the CPU both forms give pixel_uv's bits."""
    dev = xs.device
    w = torch.tensor(float(width), dtype=torch.float32, device=dev)
    h = torch.tensor(float(height), dtype=torch.float32, device=dev)
    u = xs.to(torch.float32) / w
    v = 1.0 - ys.to(torch.float32) / h
    seed = rng.make_seed(rng.u32(pixel_index) ^ JITTER_SALT, frame_index, sample)
    seed, jx = rng.random_value(seed)
    _seed, jy = rng.random_value(seed)
    return torch.stack([u + (jx - 0.5) / w, v + (jy - 0.5) / h], dim=-1)


def make_camera_rays(camera: Camera, xs: torch.Tensor, ys: torch.Tensor,
                     width: int, height: int, frame_index=0, ray_idx=0):
    """Primary rays + MakeSeed seeds for absolute pixel coords; seeds are
    u32 values held in int64 (see rng)."""
    uv = pixel_uv(xs, ys, width, height)
    origins, directions = make_ray(camera, uv)
    pixel_index = ys.to(torch.int64) * width + xs.to(torch.int64)
    seeds = rng.make_seed(pixel_index, frame_index, ray_idx)
    return origins, directions, seeds
