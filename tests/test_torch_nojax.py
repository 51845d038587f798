"""tpurt_torch stands alone: in a fresh interpreter in which ``import
jax`` and ``import tpurt`` both fail (the GPU machine has no jax, and the
port keeps its own copy of everything it reads from tpurt), the package
imports, builds the Cornell-sphere scene and renders 8x8 on the CPU
through both engines, and renders a 9-instance grid in the TLAS regime
with bf16 node bounds; and no module of the port, nor chip_smoke.py,
imports jax, flax or any module of tpurt."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RENDER = """
import sys
sys.path.insert(0, {root!r})
for blocked in ("jax", "flax", "tpurt"):
    sys.modules[blocked] = None  # any import of these now raises ImportError
from tpurt_torch.config import RenderConfig
from tpurt_torch.render.renderer import render_image
from tpurt_torch.scene.presets import cornell_sphere_scene
import chip_smoke
cfg = RenderConfig(width=8, height=8, rays_per_pixel=2, max_bounces=3,
                   object_path="sphere0.obj")
scene, cam, _ = cornell_sphere_scene(0, cfg, device="cpu")
for engine in ("mega", "modular"):
    img = render_image(scene, cam, cfg.replace(engine=engine,
                                               dense_engine="pallas"))
    assert img.shape == (8, 8, 3) and str(img.dtype) == "uint8", img.shape
    assert (img > 0).any()
import tpurt_torch.config as config
from tpurt_torch.scene.presets import grid_scene
config.MEGA_BF16_BOUNDS = True
grid = grid_scene(9, device="cpu")
assert grid.mega_tlas and grid.mega_bounds_fmt == "bf16"
img = render_image(grid, cam, cfg.replace(rays_per_pixel=1, max_bounces=2))
assert img.shape == (8, 8, 3) and str(img.dtype) == "uint8", img.shape
print("rendered", sorted(m for m in sys.modules
                         if m == "tpurt" or m.startswith("tpurt.")))
"""


def test_port_imports_and_renders_without_jax_or_tpurt():
    out = subprocess.run(
        [sys.executable, "-c", _RENDER.format(root=ROOT)], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = eval(out.stdout.strip().splitlines()[-1].split(" ", 1)[1])
    assert loaded == ["tpurt"], loaded  # only the blocking None entry


def test_sources_import_no_jax_and_no_tpurt():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "tpurt_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    pat = re.compile(r"^\s*(?:from|import)\s+([\w.]+)", re.M)
    for path in files:
        with open(path) as f:
            mods = pat.findall(f.read())
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "flax", "tpurt"), (
                path, m)
