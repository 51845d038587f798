"""tpurt_torch stands alone: in a fresh interpreter in which ``import
jax`` and ``import tpurt`` both fail (the GPU machine has no jax, and the
port keeps its own copy of everything it reads from tpurt), the package
imports, builds the Cornell-sphere scene and renders 8x8 on the CPU
through both engines, renders a 9-instance grid in the TLAS regime
with bf16 node bounds, writes a video through tpurt_torch.anim (the
yaw hook, then a static-hook pack) and reads its BMPs back through
tpurt_torch.io, resumes a frame from a TileAccumulator, renders a
jittered frame, a list quota and a staged batch (respread) equal to the
plain batch, imports the application layer (cli,
viewer, render.pick, scene.jsonscene, utils, parallel, autotune),
runs a bench row through tpurt_torch.bench.run_config, renders a frame
over a two-position mesh through parallel.shard, and
runs ``cli.main(["--cpu", ...])`` on the default scene and on a JSON scene;
and no module of the port, nor chip_smoke.py, imports jax, flax or any
module of tpurt. The blocked interpreter imports tpurt_torch.accel, .core
and .render first (importing them loads no kernel builder) and calls a
helper of each of vecmath, rng, accel.bvh, SceneBuilder.stats, Scene,
tonemap and scene.obj."""

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
import tpurt_torch.accel, tpurt_torch.core, tpurt_torch.render
assert "tpurt_torch._build" not in sys.modules  # importing builds nothing
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
import tempfile
import numpy as np
import torch
from tpurt_torch.accel import (  # noqa: F401
    BVHNodes, build_bvh, bvh_stats, thread_links, validate_bvh)
from tpurt_torch.core import Camera, make_camera_rays, rng, vecmath  # noqa: F401
from tpurt_torch.render import (  # noqa: F401
    Hit, intersect_scene, render_frame, render_tile, trace_paths)
from tpurt_torch.render.tonemap import to_rgba
from tpurt_torch.scene import SceneBuilder
from tpurt_torch.scene.obj import load_obj, write_obj
from tpurt_torch.scene.procedural import icosphere
assert vecmath.hsv2rgb(120.0, 1.0, 1.0, device="cpu").tolist() == [0, 1, 0]
up = torch.tensor([[0.0, 0.0, 1.0]])
_, d = rng.sample_hemisphere_cosine(up, rng.make_seed(torch.arange(1), 0, 0))
assert float(d[0, 2]) >= 0.0
builder = SceneBuilder()
pos, nrm = icosphere(1)
mesh = builder.add_triangles(pos, nrm)
assert builder.stats(mesh) == bvh_stats(builder.nodes, mesh.node_idx)
validate_bvh(builder.nodes, mesh.node_idx, 0, len(pos), pos)
assert scene.num_nodes == scene.node_min.shape[0]
assert to_rgba(torch.from_numpy(img))[..., 3].eq(255).all()
with tempfile.TemporaryDirectory() as d:
    write_obj(d + "/m.obj", pos, torch.from_numpy(nrm))
    assert np.array_equal(load_obj(d + "/m.obj")[0], pos)
import tpurt_torch.config as config
from tpurt_torch.scene.presets import grid_scene
config.MEGA_BF16_BOUNDS = True
grid = grid_scene(9, device="cpu")
assert grid.mega_tlas and grid.mega_bounds_fmt == "bf16"
img = render_image(grid, cam, cfg.replace(rays_per_pixel=1, max_bounces=2))
assert img.shape == (8, 8, 3) and str(img.dtype) == "uint8", img.shape
config.MEGA_BF16_BOUNDS = False
from tpurt_torch import anim
from tpurt_torch.io import TileAccumulator, read_bmp
with tempfile.TemporaryDirectory() as d:
    vcfg = cfg.replace(video_frame_count=2, mega_frames_per_batch=2)
    paths = anim.render_video(scene, cam, vcfg, out_dir=d)
    first = render_image(anim.video_frame_scene(scene, 0, 2), cam, vcfg)
    assert np.array_equal(read_bmp(paths[0]), first)
    paths = anim.render_video(scene, cam, vcfg, out_dir=d,
                              frame_hook=lambda s, f, n: s)  # one pack
    assert np.array_equal(read_bmp(paths[1]),
                          render_image(scene, cam, vcfg, frame_index=1))
    acc = TileAccumulator(cfg, path=d + "/acc.npz")
    assert np.array_equal(render_image(scene, cam, cfg, accumulator=acc),
                          render_image(scene, cam, cfg))
    jit = render_image(scene, cam, cfg.replace(subpixel_jitter=True))
    assert jit.shape == (8, 8, 3) and (jit > 0).any()
    import torch
    from tpurt_torch.render.megakernel import run_megakernel
    from tpurt_torch.render.renderer import list_batch_args
    mean, segs, _ = run_megakernel(scene, **list_batch_args(
        scene, cam, cfg.replace(pixels_per_lane=2), np.arange(64)[::-1].copy()))
    assert mean.shape == (64, 3) and segs > 0
    from tpurt_torch.render import renderer
    renderer._MEGA_STAGE_ITERS = 8  # the batch outlives its first stage
    qcfg = cfg.replace(pixels_per_lane=2, compaction_threshold=128)
    stats = []
    staged, _, trips = renderer.render_batch_flat(scene, cam, qcfg, 0,
                                                  stage_stats=stats)
    assert trips is None and any("respread" in s for s in stats), stats
    plain = renderer.render_batch_flat(
        scene, cam, qcfg.replace(compaction_threshold=0), 0)[0]
    assert torch.equal(staged[:64], plain[:64])  # rows past the frame: pads
    renderer._MEGA_STAGE_ITERS = 384
    from tpurt_torch import cli, utils, viewer  # noqa: F401
    from tpurt_torch.parallel import device_inventory  # noqa: F401
    from tpurt_torch.render import pick  # noqa: F401
    from tpurt_torch.scene import jsonscene  # noqa: F401
    from tpurt_torch.utils import profiling  # noqa: F401
    from tpurt_torch import autotune  # noqa: F401
    from tpurt_torch import bench
    row = bench.run_config("tiny", "sphere", cfg.replace(rays_per_pixel=1),
                           repeats=1, device="cpu")
    assert row["avg_path"] > 0 and row["launches"] == 1, row
    from tpurt_torch.parallel import shard
    from tpurt_torch.render.renderer import render_frame
    import torch
    mesh = shard.make_mesh(2, devices=[torch.device("cpu")] * 2)
    assert np.array_equal(shard.render_frame_sharded(scene, cam, cfg, mesh=mesh),
                          render_frame(scene, cam, cfg))
    tiny = ["--cpu", "--width", "8", "--height", "8", "--rays-per-pixel", "1",
            "--max-bounces", "2"]
    assert cli.main(tiny + ["--object-path", "sphere0.obj",
                            "--output", d + "/cli.bmp"]) == 0
    assert read_bmp(d + "/cli.bmp").shape == (8, 8, 3)
    assert cli.main(tiny + ["--scene-json", {json!r}, "--engine", "modular",
                            "--output", d + "/json.bmp"]) == 0
print("rendered", sorted(m for m in sys.modules
                         if m == "tpurt" or m.startswith("tpurt.")))
"""


def test_port_imports_and_renders_without_jax_or_tpurt():
    out = subprocess.run(
        [sys.executable, "-c", _RENDER.format(
            root=ROOT, json=os.path.join(ROOT, "examples", "glass_sphere.json"))],
        cwd=ROOT,
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
