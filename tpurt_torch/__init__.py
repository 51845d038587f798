"""tpurt_torch — the PyTorch + CUDA port of tpurt for one NVIDIA H100.

Same algorithm, scenes, knobs and images as the JAX package beside it,
which stays the reference. The layout mirrors tpurt's so every module
has a named counterpart:

  config   RenderConfig and the constants the port reads (tpurt/config)
  accel/   the SAH BVH builder                        (tpurt/accel)
  core/    bit-exact u32 RNG, vec math, camera rays   (tpurt/core)
  scene/   OBJ, procedural meshes, builder + freeze   (tpurt/scene)
  render/  shading, tonemap, the megakernel (BVH and dense), the
           modular engine (intersect, integrator), the dense sweeps,
           the renderers, mesh picking                (tpurt/render)
  io/      BMP files, the tile accumulator            (tpurt/io)
  anim     videos and progressive frames              (tpurt/anim.py)
  utils/   progress line, spans and counters          (tpurt/utils)
  parallel/ device inventory and selection            (tpurt/parallel)
  cli, viewer  the command line and the terminal viewer (tpurt/cli.py,
           tpurt/viewer.py): python -m tpurt_torch.cli
  csrc/    CUDA C++ kernels and the C++ BVH builder, built at first use
           (_build.py)

The package imports torch and never jax, nor any module of tpurt.
Scenes and cameras are made on the CUDA device unless the caller names
another one; the renderers run on the scene's device.
"""

__version__ = "0.2.0"

from tpurt_torch.config import RenderConfig  # noqa: F401
