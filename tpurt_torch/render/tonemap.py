"""Radiance -> display pixels (torch port of tpurt/render/tonemap.py;
Trace.cl:643-652): clamp to [0, 1], gamma 1/2.2, truncate to uint8."""

from __future__ import annotations

import numpy as np
import torch

_GAMMA = float(np.float32(1.0 / 2.2))


def tonemap(radiance: torch.Tensor) -> torch.Tensor:
    """(..., 3) mean radiance -> (..., 3) uint8."""
    c = torch.clamp(radiance, 0.0, 1.0)
    c = torch.pow(c, _GAMMA)
    return (c * 255.0).to(torch.uint8)  # truncation, like (uchar)(x*255.0f)
