"""Bit-exact counterpart of the reference's 32-bit stateful PRNG
(torch port of tpurt/core/rng.py; Trace.cl:158-217).

A u32 state is held in an int64 tensor whose value lies in [0, 2^32):
CPU torch has no uint32 add, shift or compare, and int64 carries every
u32 operation exactly once results are masked back to 32 bits. Products
are split into 16-bit halves so no intermediate leaves int64's range.

No ``torch.Generator`` is involved anywhere in the renderer: every random
number is this exact hash of (pixel, frame, sample), so the CUDA kernel
(csrc/megakernel.cu, native ``uint32_t``) reproduces the stream bit for
bit. Functions are (state) -> (new_state, sample) over any shape; the
``*_masked`` variants advance the state only where ``mask`` is True.
"""

from __future__ import annotations

import numpy as np
import torch

TAU = 6.28318530717958647692  # Trace.cl:5
_EPS = float(np.float32(1e-6))
_TAU32 = float(np.float32(TAU))
_M32 = 0xFFFFFFFF
_INV_2_32 = 1.0 / 4294967296.0  # 2^-32, exact in f32


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a u32 held in int64 and a u32 constant,
    without a product above 2^48."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def u32(x, device=None) -> torch.Tensor:
    """Any integer tensor or value -> u32 value held in int64."""
    if not isinstance(x, torch.Tensor):
        return torch.as_tensor(int(x) & _M32, dtype=torch.int64, device=device)
    return x.to(torch.int64) & _M32


def u32_to_unit_float(s: torch.Tensor) -> torch.Tensor:
    """SafelyMapU32ToFloat: (s+1)/2^32 in float32 (Trace.cl:158-161);
    s == 0xFFFFFFFF maps to exactly 0 like the reference."""
    return ((s + 1) & _M32).to(torch.float32) * _INV_2_32


def lcg_step(state: torch.Tensor) -> torch.Tensor:
    return (mul32(state, 747796405) + 2891336453) & _M32


def make_seed(pixel_index, frame_index, ray_idx) -> torch.Tensor:
    """MakeSeed (Trace.cl:170-177)."""
    p = u32(pixel_index)
    f = u32(frame_index, p.device)
    r = u32(ray_idx, p.device)
    s = (mul32(p, 1664525) + mul32(f, 1013904223)) & _M32
    s = s ^ ((r + 0x9E3779B9) & _M32)
    return (mul32(s, 22695477) + 1) & _M32


def random_value(state: torch.Tensor):
    """RandomValue (Trace.cl:163-168) -> (new_state, float in (0,1))."""
    state = lcg_step(state)
    shift = (state >> 28) + 4
    result = mul32((state >> shift) ^ state, 277803737)
    result = (result >> 22) ^ result
    return state, u32_to_unit_float(result)


def rand01(state: torch.Tensor):
    """rand01 (Trace.cl:209-217) -> (new_state, float in (0,1))."""
    state = lcg_step(state)
    z = state
    z = mul32(z ^ (z >> 16), 0x7FEB352D)
    z = mul32(z ^ (z >> 15), 0x846CA68B)
    z = z ^ (z >> 16)
    return state, u32_to_unit_float(z)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt on every device: CPU torch's vectorised
    f32 sqrt is off by an ulp on ~0.6% of inputs, while sqrt of the
    exact double rounds back to the IEEE f32 result (the kernel's
    ``sqrtf``)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1/sqrt(x), both steps correctly rounded (the kernel's
    ``1.0f / sqrtf(x)``)."""
    return 1.0 / sqrt(x)


def divide(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d correctly rounded on every device: torch on CUDA divides by
    a Python scalar as a multiply by its reciprocal, an ulp off on some
    inputs, and by a 0-dim tensor as IEEE does (the CPU, kernel B1 and
    the reference). ``torch.full`` makes the divisor on the device with
    no copy from the host."""
    return a / torch.full((), float(d), dtype=a.dtype, device=a.device)


def random_normal(state: torch.Tensor):
    """Box-Muller standard normal (Trace.cl:179-187); draws twice."""
    state, u1 = random_value(state)
    state, u2 = random_value(state)
    u1 = torch.clamp_min(u1, _EPS)
    r = sqrt(-2.0 * torch.log(u1))
    theta = _TAU32 * u2
    return state, r * torch.cos(theta)


def random_direction_soa(state: torch.Tensor):
    """Uniform sphere direction from 3 Gaussians (Trace.cl:189-200) ->
    (new_state, (x, y, z)); non-finite falls back to (0, 1, 0)."""
    state, x = random_normal(state)
    state, y = random_normal(state)
    state, z = random_normal(state)
    inv = rsqrt(x * x + y * y + z * z)
    vx, vy, vz = x * inv, y * inv, z * inv
    bad = ~(torch.isfinite(vx) & torch.isfinite(vy) & torch.isfinite(vz))
    vx = torch.where(bad, 0.0, vx)
    vy = torch.where(bad, 1.0, vy)
    vz = torch.where(bad, 0.0, vz)
    return state, (vx, vy, vz)


def random_direction(state: torch.Tensor):
    """random_direction with a (..., 3) result."""
    state, (x, y, z) = random_direction_soa(state)
    return state, torch.stack([x, y, z], dim=-1)


def random_hemisphere_direction(normal: torch.Tensor, state: torch.Tensor):
    """Sign-flipped sphere sample (Trace.cl:202-207) -> (new_state, d)."""
    from tpurt_torch.core.vecmath import dot3

    state, d = random_direction(state)
    return state, torch.where((dot3(d, normal) < 0.0)[..., None], -d, d)


def sample_hemisphere_cosine(normal: torch.Tensor, state: torch.Tensor):
    """Cosine-weighted hemisphere sample about ``normal`` (Trace.cl:238-257)
    -> (new_state, unit (..., 3) direction)."""
    from tpurt_torch.core.vecmath import cross3, normalize3

    state, r1 = rand01(state)
    state, r2 = rand01(state)
    r = sqrt(r1)
    phi = _TAU32 * r2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = sqrt(torch.clamp_min(1.0 - r1, 0.0))
    z_up = torch.tensor([0.0, 0.0, 1.0], device=normal.device)
    x_up = torch.tensor([1.0, 0.0, 0.0], device=normal.device)
    up = torch.where(normal[..., 2:3].abs() < 0.999, z_up, x_up)
    t = normalize3(cross3(up, normal))
    b = cross3(normal, t)
    d = t * x[..., None] + b * y[..., None] + normal * z[..., None]
    return state, normalize3(d)


def random_value_masked(state, mask):
    new_state, x = random_value(state)
    return torch.where(mask, new_state, state), x


def rand01_masked(state, mask):
    new_state, x = rand01(state)
    return torch.where(mask, new_state, state), x


def random_direction_masked(state, mask):
    new_state, d = random_direction(state)
    return torch.where(mask, new_state, state), d


def random_direction_masked_soa(state, mask):
    new_state, d = random_direction_soa(state)
    return torch.where(mask, new_state, state), d
