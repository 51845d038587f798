"""Shading, tonemap, the megakernel (plain torch version + CUDA kernel,
BVH and dense), the modular engine (intersection, the dense sweeps,
integrator) and the renderers."""
