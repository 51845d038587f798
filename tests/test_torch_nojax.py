"""tpurt_torch runs where jax is not installed (the GPU machine has
none): in a fresh interpreter in which ``import jax`` fails, the package
imports, builds the Cornell-sphere scene and renders 8x8 on the CPU; and
no module of the port, nor chip_smoke.py, imports jax, flax or a tpurt
module beyond the jax-free host ones."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RENDER = """
import sys
sys.path.insert(0, {root!r})
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.modules["flax"] = None
from tpurt.config import RenderConfig
from tpurt_torch.render.renderer import render_image
from tpurt_torch.scene.presets import cornell_sphere_scene
import chip_smoke
cfg = RenderConfig(width=8, height=8, rays_per_pixel=2, max_bounces=3,
                   object_path="sphere0.obj")
scene, cam, _ = cornell_sphere_scene(0, cfg)
img = render_image(scene, cam, cfg)
assert img.shape == (8, 8, 3) and str(img.dtype) == "uint8", img.shape
assert (img > 0).any()
print("rendered", sorted(m for m in sys.modules if m.startswith("tpurt.")))
"""
# tpurt modules the port may import: the jax-free host side.
_ALLOWED = {"tpurt", "tpurt.config", "tpurt.accel", "tpurt.accel.bvh",
            "tpurt._native", "tpurt.io", "tpurt.io.bmp"}


def test_port_imports_and_renders_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _RENDER.format(root=ROOT)], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = eval(out.stdout.strip().splitlines()[-1].split(" ", 1)[1])
    assert set(loaded) <= _ALLOWED, loaded


def test_sources_import_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "tpurt_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    pat = re.compile(r"^\s*(?:from|import)\s+([\w.]+)", re.M)
    for path in files:
        with open(path) as f:
            mods = pat.findall(f.read())
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax"), (path, m)
            if top == "tpurt":
                assert m in _ALLOWED, (path, m)
