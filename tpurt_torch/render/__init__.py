"""Shading, tonemap, the megakernel (plain torch version + CUDA kernel,
BVH and dense), the modular engine (intersection, the dense sweeps,
integrator) and the renderers."""

from tpurt_torch.render.intersect import Hit, intersect_scene  # noqa: F401
from tpurt_torch.render.integrator import trace_paths  # noqa: F401
from tpurt_torch.render.renderer import render_frame, render_tile  # noqa: F401
