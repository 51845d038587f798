"""Radiance -> display pixels (torch port of tpurt/render/tonemap.py;
Trace.cl:643-652): clamp to [0, 1], gamma 1/2.2, truncate to uint8.
The kernel writes alpha 0 and the host forces 255 (image.hpp:271);
``to_rgba`` writes 255 directly."""

from __future__ import annotations

import numpy as np
import torch

from tpurt_torch.utils.profiling import span

_GAMMA = float(np.float32(1.0 / 2.2))


def tonemap(radiance: torch.Tensor) -> torch.Tensor:
    """(..., 3) mean radiance -> (..., 3) uint8."""
    with span("tpurt.tonemap"):
        c = torch.clamp(radiance, 0.0, 1.0)
        c = torch.pow(c, _GAMMA)
        return (c * 255.0).to(torch.uint8)  # truncation, like (uchar)(x*255.0f)


def to_rgba(rgb_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 -> (..., 4) uint8 with alpha 255, on the input's
    device."""
    alpha = torch.full(rgb_u8.shape[:-1] + (1,), 255, dtype=torch.uint8,
                       device=rgb_u8.device)
    return torch.cat([rgb_u8, alpha], dim=-1)
