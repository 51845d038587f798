"""Core math: u32 RNG, SoA 3-vectors, vec math, camera rays."""

from tpurt_torch.core import rng, vecmath  # noqa: F401
from tpurt_torch.core.camera import Camera, make_camera_rays  # noqa: F401
