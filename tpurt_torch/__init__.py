"""tpurt_torch — the PyTorch + CUDA port of tpurt for one NVIDIA H100.

Same algorithm, scenes, knobs (``tpurt.config.RenderConfig``) and
images as the JAX package beside it, which stays the reference. The
layout mirrors tpurt's so every module has a named counterpart:

  core/    bit-exact u32 RNG, vec math, camera rays   (tpurt/core)
  scene/   OBJ, procedural meshes, builder + freeze   (tpurt/scene)
  render/  shading, tonemap, the megakernel (plain torch version and
           the hand-written Hopper kernel), flat renderer (tpurt/render)
  csrc/    CUDA C++ sources, built with nvcc at first use (_build.py)

The package imports torch and never jax. From tpurt it reuses only the
jax-free host modules: ``tpurt.config``, ``tpurt.accel.bvh``,
``tpurt._native`` and ``tpurt.io.bmp``.
"""

__version__ = "0.1.0"

from tpurt.config import RenderConfig  # noqa: F401
