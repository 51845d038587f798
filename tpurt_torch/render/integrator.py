"""Monte-Carlo path integrator: the modular bounce loop (torch port of
tpurt/render/integrator.py; Trace.cl:487-594).

One trip intersects the whole scene (render/intersect.py) and applies
the shared shading step (render/shading.py) to every active lane;
control flow is masks, and every lane draws exactly the random numbers
the reference's scalar branches would. The Invisible pass-through makes
the reference's loop unbounded (Trace.cl:502-506), so the loop stops at
``max_bounces + invisible_budget`` trips.

This engine is the megakernel's cross-check: its phases are easy to read
and test, at the cost of synchronising every lane at every bounce.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpurt_torch.render.intersect import Hit, intersect_scene
from tpurt_torch.render.shading import shade_hit
from tpurt_torch.scene.types import Scene


def trace_paths(scene: Scene, origin: torch.Tensor, direction: torch.Tensor,
                rng_state: torch.Tensor, max_bounces: int,
                invisible_budget: int = 32, bruteforce_threshold: int = 4096,
                first_hit: Optional[Hit] = None, dense_engine: str = "exact"):
    """Trace one path per lane from rays (R, 3); returns (radiance (R, 3),
    rng state, path length (R,) i32 — the scene intersections of the
    path, the rays of Mrays/s).

    ``first_hit`` supplies the bounce-0 hit: the reference reuses one
    camera ray for every sample of a pixel (Trace.cl:636-641) and the
    first intersection draws no random number, so a caller can intersect
    the primaries once and share the hit across the sample loop."""
    r = origin.shape[0]
    dev = origin.device
    throughput = torch.ones((r, 3), dtype=torch.float32, device=dev)
    light = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    bounces = torch.zeros(r, dtype=torch.int32, device=dev)
    segments = torch.zeros(r, dtype=torch.int32, device=dev)
    active = torch.full((r,), max_bounces > 0, dtype=torch.bool, device=dev)
    rng = rng_state
    hard_cap = max_bounces + invisible_budget
    iteration = 0

    def step(hit: Hit):
        nonlocal origin, direction, throughput, light, rng, bounces, segments
        nonlocal active, iteration
        res = shade_hit(scene, active, hit.valid, hit.point, hit.normal,
                        hit.backface, hit.mesh_idx, origin, direction,
                        throughput, light, rng, bounces, max_bounces)
        origin, direction = res.origin, res.direction
        throughput, light, rng, bounces = (res.throughput, res.light, res.rng,
                                           res.bounces)
        segments = segments + active.to(torch.int32)
        active = active & res.continuing
        iteration += 1

    if first_hit is not None:
        step(first_hit)  # the peeled bounce 0
    while iteration < hard_cap and bool(active.any()):
        step(intersect_scene(scene, origin, direction, bruteforce_threshold,
                             dense_engine))
    return light, rng, segments
