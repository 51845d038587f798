"""The many-instance (TLAS) regime, bf16 node bounds and material slots
on the CPU, against tpurt.

* Lane state of the K = 12 grid (tests/test_many_meshes.py _grid_scene,
  32x24, 2 spp, 3 bounces, 512 lanes) after 1, 4 and 16 trips against
  tpurt's XLA body: integer fields equal on >= 99.5% of lanes. The
  floats differ by an ulp from the first trip, because XLA's CPU backend
  fuses the camera's multiply-adds (ROADMAP C); measured: 0, 0 and 2 of
  512 lanes differ in an integer field after 1, 4 and 16 trips, each a
  bounce that hits or misses a glass or checker sphere by that ulp.
* The whole 32x24 frame against tpurt's (both of its batches run to the
  end from the same compiled program): <= 0.5% of pixels, segments
  within 0.5%.
* Within the port, bitwise: the TLAS frame equals the same geometry
  frozen as an unrolled chain and the modular engine's frame, and a bf16
  bank renders the u8 bank's frame with the same segment count.
* bf16 rounding (builder._bf16_dir) is conservative and tight, and a
  bf16 bank's chain and root tables equal tpurt's; the material-slot
  fetch equals the per-mesh fetch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_many_meshes import _grid_scene
from test_render_golden import assert_mostly_bitwise
from test_torch_megakernel import port_lane
import tpurt.config as t_config
from tpurt.render import renderer as t_renderer
from tpurt.render.megakernel import _chain_params as t_chain_params
from tpurt.scene import procedural as t_proc
from tpurt.scene.builder import Material as TMaterial
from tpurt.scene.builder import SceneBuilder as TBuilder
from tpurt.scene.builder import _bf16_dir as t_bf16_dir
from tpurt.scene.types import MaterialType as TMT
import tpurt_torch.config as config
from tpurt_torch.config import RenderConfig
from tpurt_torch.core.camera import Camera
from tpurt_torch.render import mega_cuda
from tpurt_torch.render import megakernel as mk
from tpurt_torch.render.renderer import flat_batch_args, render_frame
from tpurt_torch.render.shading import pack_materials, select_material_soa
from tpurt_torch.scene import procedural
from tpurt_torch.scene.builder import Material, SceneBuilder, _bf16_dir
from tpurt_torch.scene.presets import grid_scene
from tpurt_torch.scene.types import MaterialType

# test_many_meshes._grid_scene's render, one quota slot and one tail pass
# (tpurt's XLA program for the TLAS body compiles in ~20 s so; with P=2
# and 3 tail passes it takes over 2 minutes).
CFG = RenderConfig(width=32, height=24, rays_per_pixel=2, max_bounces=3,
                   tile_size=32, seed_mode="reference", rays_per_batch=512,
                   compaction_threshold=0, mega_body="xla")


def _camera(cfg, device="cpu"):
    return Camera.create(position=cfg.camera_position, pitch=cfg.camera_pitch,
                         yaw=cfg.camera_yaw, roll=cfg.camera_roll,
                         fov_degrees=cfg.fov_degrees,
                         aspect_ratio=cfg.aspect_ratio, device=device)


@pytest.fixture(scope="module")
def grid():
    """(port scene, camera, tpurt lane states after k trips of batch 0,
    and both batches run to the end) — one tpurt compile."""
    tscene, tcam, tcfg = _grid_scene(12)
    tcfg = tcfg.replace(mega_body="xla")
    statics = t_renderer._mega_statics(tcfg, tcfg.width, tcfg.height)
    b = t_renderer._flat_batch_size(tcfg)
    run = lambda start, k: port_lane(t_renderer._mega_flat_start(
        tscene, tcam, jnp.asarray([start, 0, 0, k], jnp.int32), batch=b,
        **statics)[0])
    states = {k: run(0, k) for k in (1, 4, 16)}
    final = [run(start, 10 ** 6) for start in (0, b)]
    scene = grid_scene(12, device="cpu")
    assert scene.mega_tlas and scene.mega_chain == ((-2, 22, False),)
    return scene, _camera(CFG), states, final


@pytest.mark.parametrize("trips", [1, 4, 16])
def test_lane_state_matches_tpurt(grid, trips):
    scene, cam, theirs, _final = grid
    mine = mk.run_megakernel(scene, max_iterations=trips, return_state=True,
                             **flat_batch_args(scene, cam, CFG, 0))
    assert mine.in_inst is not None and mine.iters == trips
    agree, _err = mega_cuda.compare_lanes(mine, theirs[trips])
    assert agree >= 0.995, agree


def test_frame_matches_tpurt(grid):
    scene, cam, _states, final = grid
    assert all(bool(f.done.all()) for f in final)
    ref = np.concatenate([np.stack([c.numpy() for c in f.acc], -1)
                          for f in final]) / np.float32(CFG.rays_per_pixel)
    ref = ref[:CFG.width * CFG.height].reshape(CFG.height, CFG.width, 3)
    stats = {}
    mine = render_frame(scene, cam, CFG, stats=stats)
    assert_mostly_bitwise(mine, ref)
    t_segs = sum(int(f.segments.sum()) for f in final)
    assert abs(stats["segments"] - t_segs) <= 0.005 * t_segs
    assert mine.max() > 0.0


def test_tlas_frame_equals_unrolled_and_modular(monkeypatch):
    cfg = CFG.replace(pixels_per_lane=2, mega_tail_passes=3, rays_per_batch=256)
    cam = _camera(cfg)
    scene = grid_scene(12, device="cpu")
    tlas_stats, chain_stats = {}, {}
    tlas = render_frame(scene, cam, cfg, stats=tlas_stats)
    modular = render_frame(scene, cam, cfg.replace(engine="modular"))
    monkeypatch.setattr(config, "MEGA_TLAS_THRESHOLD", 10_000)
    unrolled = grid_scene(12, device="cpu")
    assert not unrolled.mega_tlas and len(unrolled.mega_chain) == 12
    chain = render_frame(unrolled, cam, cfg, stats=chain_stats)
    np.testing.assert_array_equal(tlas, chain)
    np.testing.assert_array_equal(tlas, modular)
    assert tlas_stats["segments"] == chain_stats["segments"]
    assert tlas.max() > 0.0


def _bf16_scene(builder_cls, material_cls, mt, proc, device=None):
    """tests/test_bf16_bounds.py's scene: a Solid icosphere(2, 100) at
    scale 0.5 in the Cornell box, built with either package."""
    b = builder_cls()
    pos, nrm = proc.icosphere(2, radius=100.0)
    mesh = b.add_triangles(pos, nrm)
    mesh.material = material_cls(type=mt.SOLID, ior=1.0, color=(1.0, 1.0, 1.0),
                                 specular_probability=1.0)
    mesh.scale = 0.5
    b.add_cornell_box(mesh)
    b.add_mesh(mesh)
    return b.freeze() if device is None else b.freeze(device)


def test_bf16_frame_equals_u8(monkeypatch):
    """tpurt's contract (test_bf16_bounds.test_bf16_render_bitwise_vs_u8)
    at 24x16: conservative bounds change traversal work, never hits."""
    cfg = RenderConfig(width=24, height=16, rays_per_pixel=2, max_bounces=3,
                       seed_mode="reference", compaction_threshold=0,
                       pixels_per_lane=2, mega_tail_passes=2)
    cam = _camera(cfg)
    args = (SceneBuilder, Material, MaterialType, procedural, "cpu")
    u8_stats, bf_stats = {}, {}
    u8 = render_frame(_bf16_scene(*args), cam, cfg, stats=u8_stats)
    monkeypatch.setattr(config, "MEGA_BF16_BOUNDS", True)
    scene_bf = _bf16_scene(*args)
    assert scene_bf.mega_bounds_fmt == "bf16"
    bf = render_frame(scene_bf, cam, cfg, stats=bf_stats)
    np.testing.assert_array_equal(u8, bf)
    assert u8_stats["segments"] == bf_stats["segments"]
    assert u8.max() > 0.0


def test_bf16_chain_and_root_tables_match_tpurt(monkeypatch):
    """The bf16 root expansion's decoded tables (an entry that expands,
    unlike the TLAS entry) equal tpurt's, word for word."""
    monkeypatch.setattr(config, "MEGA_BF16_BOUNDS", True)
    monkeypatch.setattr(t_config, "MEGA_BF16_BOUNDS", True)
    mine = _bf16_scene(SceneBuilder, Material, MaterialType, procedural, "cpu")
    theirs = _bf16_scene(TBuilder, TMaterial, TMT, t_proc)
    assert mine.mega_bounds_fmt == theirs.mega_bounds_fmt == "bf16"
    bits = lambda a: np.ascontiguousarray(np.asarray(a), np.float32).view(np.uint32)
    np.testing.assert_array_equal(bits(mine.mega_rows.numpy()),
                                  bits(theirs.mega_rows))
    p, tp = mk._chain_params(mine), t_chain_params(theirs)
    assert any(p.expand) and p.expand == tp.expand
    np.testing.assert_array_equal(bits(p.table_np), bits(tp.table))
    np.testing.assert_array_equal(bits(p.roots_f), bits(tp.roots_f))
    np.testing.assert_array_equal(p.roots_i, np.asarray(tp.roots_i))


def _dec(u16):
    return (np.asarray(u16, np.uint32) << 16).view(np.float32)


def test_bf16_dir_conservative_and_tight():
    """tests/test_bf16_bounds.test_bf16_dir_conservative_and_tight on the
    port's copy, which also returns tpurt's bits."""
    rng = np.random.default_rng(7)
    vals = np.concatenate([
        rng.uniform(-1e6, 1e6, 4096).astype(np.float32),
        rng.uniform(-1e-3, 1e-3, 1024).astype(np.float32),
        np.asarray([0.0, -0.0, 1.0, -1.0, 255.0, -255.0], np.float32),
    ])
    for up in (False, True):
        np.testing.assert_array_equal(_bf16_dir(vals, up), t_bf16_dir(vals, up))
    lo = _dec(_bf16_dir(vals, up=False))
    hi = _dec(_bf16_dir(vals, up=True))
    assert np.all(lo <= vals) and np.all(hi >= vals)
    slack = np.maximum(np.abs(vals) * 2.0 ** -7, 1e-30)
    assert np.all(vals - lo <= slack) and np.all(hi - vals <= slack)
    exact = np.asarray([0.0, 1.0, -1.0, 0.5, 256.0], np.float32)
    assert np.array_equal(_dec(_bf16_dir(exact, False)), exact)
    assert np.array_equal(_dec(_bf16_dir(exact, True)), exact)


def test_slot_fetch_equals_per_mesh_fetch():
    scene = grid_scene(12, device="cpu")
    assert len(set(scene.mesh_mat_slot)) == len(scene.mat_slot_rep)
    assert len(scene.mat_slot_rep) < scene.num_meshes  # the dedup happened
    mats = pack_materials(scene)
    idx = torch.arange(scene.num_meshes, dtype=torch.int32)
    via_slots = select_material_soa(
        mats, idx, (scene.mesh_mat_slot, scene.mat_slot_rep))
    for a, b in zip(via_slots, select_material_soa(mats, idx)):
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert torch.equal(x, y)


def test_tlas_scene_refuses_the_dense_mode():
    scene = grid_scene(12, device="cpu")
    with pytest.raises(ValueError, match="TLAS"):
        render_frame(scene, _camera(CFG), CFG.replace(mega_dense=True))


def _lane_masks(a: mk._Lane, b: mk._Lane):
    """Per lane: all integer, u32 and bool fields (stack included) equal;
    all float fields (accumulators included) equal bit for bit."""
    fields = mega_cuda._FIELDS + mega_cuda._TLAS_FIELDS
    ints = torch.ones_like(a.done)
    floats = torch.ones_like(a.done)
    for name, kind in fields:
        va, vb = getattr(a, name), getattr(b, name)
        if va is None:
            continue
        if kind not in "vf":
            ints &= va.to(torch.int64) == vb.to(torch.int64)
            continue
        for x, y in (zip(va, vb) if kind == "v" else [(va, vb)]):
            floats &= (x.view(torch.int32) == y.view(torch.int32)) | (
                torch.isnan(x) & torch.isnan(y))
    for sa, sb in zip(a.stack, b.stack):
        ints &= sa == sb
    for acc_a, acc_b in zip(a.accs, b.accs):
        for x, y in zip(acc_a, acc_b):
            floats &= x.view(torch.int32) == y.view(torch.int32)
    return ints, floats


@pytest.mark.slow
def test_quota_tail3_lanes_against_tpurt():
    """ROADMAP C.3: the grid at P=2 with 3 tail passes (tpurt's program
    compiles for over a minute). Measured once: 4 of 512 lanes differ
    in an integer field from trip 3 on (0.78%), every one of them a lane
    whose floats already differed by 1-91 ulp at trip 2 — the class of
    XLA's fused multiply-adds (ROADMAP C) turning an ulp into a branch
    (a bounce, a hit or a miss) — and the frame is 0 of 768 pixels from
    tpurt's with equal segments. Held here: no lane's integer fields
    differ before its floats do, and the frame keeps tpurt's tolerance."""
    cfg = CFG.replace(pixels_per_lane=2, mega_tail_passes=3)
    tscene, tcam, tcfg = _grid_scene(12)
    tcfg = tcfg.replace(mega_body="xla", pixels_per_lane=2, mega_tail_passes=3)
    statics = t_renderer._mega_statics(tcfg, tcfg.width, tcfg.height)
    b = t_renderer._flat_batch_size(tcfg)
    run = lambda k: port_lane(t_renderer._mega_flat_start(
        tscene, tcam, jnp.asarray([0, 0, 0, k], jnp.int32), batch=b,
        pixels_per_lane=2, **statics)[0])
    scene = grid_scene(12, device="cpu")
    lane, ctx = mk.prepare(scene, **flat_batch_args(scene, _camera(cfg), cfg, 0))
    first_int = torch.zeros_like(lane.cur) - 1
    first_float = torch.zeros_like(lane.cur) - 1
    for k in range(1, 17):
        lane = mk._body_math(lane, ctx)._replace(iters=k)
        ints, floats = _lane_masks(lane, run(k))
        first_int = torch.where((first_int < 0) & ~ints, k, first_int)
        first_float = torch.where((first_float < 0) & ~floats, k, first_float)
    differing = first_int > 0
    assert bool((first_float[differing] > 0).all())
    assert bool((first_float[differing] < first_int[differing]).all())
    final = run(10 ** 6)
    assert bool(final.done.all())
    ref = np.concatenate([np.stack([c.numpy() for c in acc], -1)
                          for acc in final.accs]) / np.float32(cfg.rays_per_pixel)
    ref = ref[:cfg.width * cfg.height].reshape(cfg.height, cfg.width, 3)
    stats = {}
    mine = render_frame(scene, _camera(cfg), cfg, stats=stats)
    assert_mostly_bitwise(mine, ref)
    t_segs = int(final.segments.sum())
    assert abs(stats["segments"] - t_segs) <= 0.005 * t_segs
