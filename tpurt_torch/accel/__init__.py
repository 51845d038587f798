"""Acceleration structures (tpurt/accel): the SAH BVH builder."""

from tpurt_torch.accel.bvh import (  # noqa: F401
    BVHNodes,
    build_bvh,
    bvh_stats,
    thread_links,
    validate_bvh,
)
