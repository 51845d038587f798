"""The port's io/ and anim.py, its megakernel tile path, accumulators,
retries and the deep-stack scene, on the CPU against tpurt.

* ``bmp_bytes`` is byte-equal to tpurt's (rows padded to 4 bytes), the
  BMP round trip is exact, ``config_fingerprint`` equals tpurt's for
  equal knobs, and a checkpoint with a stale fingerprint is not resumed.
* ``rays_per_batch=0`` sweeps megakernel tiles: its frame equals the flat
  frame bit for bit (tests/test_flat_batching.py:25-33 holds tpurt's the
  same way), ``render_tile`` with the megakernel is a crop of it, and it
  matches tpurt's tiled frame. A TileAccumulator run cut after two tiles
  resumes to the same image; transient device errors are retried,
  deterministic ones are not.
* ``sample_flatten`` (one-sample passes accumulated in sample order)
  equals the in-lane frame bit for bit in decorrelated mode, as tpurt's
  does (tests/test_mega_pallas.py:77-90), and matches tpurt's frame.
* anim: the yaw schedule equals tpurt's, ``set_mesh_yaw`` refuses an
  identity-frozen mesh and a TLAS scene, ``render_video`` writes BMPs
  within tpurt's knife-edge tolerance of tpurt's video and equal to
  ``render_image`` of each frame, and a static-hook video packed two
  frames a launch is byte for byte the unpacked video.
* The deep-stack scene (presets.deep_stack_scene: mega_stack_depth 36,
  a budget of 72 stack words, above kernel B1's shared stack ring, of
  which its primary rays hold 67) freezes to tpurt's bank, and its
  frame matches tpurt's.
"""

import math
import os

import numpy as np
import pytest
import torch

from test_render_golden import assert_mostly_bitwise
import tpurt.anim as t_anim
import tpurt.config as t_config
from tpurt.core.camera import Camera as TCamera
from tpurt.io import bmp as t_bmp
from tpurt.io import checkpoint as t_checkpoint
from tpurt.render import renderer as t_renderer
from tpurt.scene.builder import Material as TMaterial
from tpurt.scene.builder import SceneBuilder as TBuilder
from tpurt.scene.presets import _model_for as t_model_for
from tpurt.scene.presets import default_scene as t_default_scene
from tpurt.scene.types import MaterialType as TMT
from tpurt_torch import anim
from tpurt_torch.config import RenderConfig
from tpurt_torch.io import (
    TileAccumulator, bmp_bytes, config_fingerprint, read_bmp, write_bmp)
from tpurt_torch.render import mega_cuda, renderer
from tpurt_torch.render import megakernel as mk
from tpurt_torch.render.renderer import (
    flat_batch_args, render_frame, render_image, render_tile)
from tpurt_torch.scene.presets import (
    DEEP_CAMERA_OFFSET, DEEP_CHAIN_POS, deep_chain, deep_stack_scene,
    default_scene, grid_scene)

TILE = RenderConfig(width=24, height=20, rays_per_pixel=2, max_bounces=3,
                    tile_size=16, object_path="sphere0.obj",
                    rays_per_batch=256, pixels_per_lane=2, mega_tail_passes=2,
                    compaction_threshold=0, mega_body="xla")


def tpurt_cfg(cfg: RenderConfig) -> t_config.RenderConfig:
    return t_config.RenderConfig(**{f: getattr(cfg, f) for f in
                                    t_config.RenderConfig.__dataclass_fields__})


@pytest.fixture(scope="module")
def tile_scene():
    scene, cam, _ = default_scene(TILE, device="cpu")
    return scene, cam, render_frame(scene, cam, TILE)


# ---------------------------------------------------------------- io


@pytest.mark.parametrize("width", [1, 2, 3, 5, 8])
def test_bmp_bytes_match_tpurt(width, tmp_path):
    img = np.random.default_rng(width).integers(0, 256, (3, width, 3),
                                                dtype=np.uint8)
    assert bmp_bytes(img) == t_bmp.bmp_bytes(img)
    path = str(tmp_path / "x.bmp")
    write_bmp(path, img)
    np.testing.assert_array_equal(read_bmp(path), img)


def test_checkpoint_fingerprint_and_stale_refusal(tmp_path):
    for kw in (dict(), dict(width=64, rays_per_pixel=3, seed_mode="decorrelated"),
               dict(engine="modular", tile_size=32, mega_frames_per_batch=2)):
        assert config_fingerprint(RenderConfig(**kw), 3) == \
            t_checkpoint.config_fingerprint(t_config.RenderConfig(**kw), 3), kw
    path = str(tmp_path / "acc.npz")
    tile = np.random.default_rng(0).random((16, 16, 3), np.float32)
    TileAccumulator(TILE, path=path).put_tile(1, 0, tile)
    back = TileAccumulator(TILE, path=path)
    assert back.has_tile(1, 0) and back.num_tiles == 1
    np.testing.assert_array_equal(back.get_tile(1, 0), tile)
    assert TileAccumulator(TILE, frame_index=1, path=path).num_tiles == 0
    assert TileAccumulator(TILE.replace(rays_per_pixel=3), path=path).num_tiles == 0


# ----------------------------------------------------------- tile path


def test_tiled_mega_frame_equals_flat_and_tpurt(tile_scene):
    scene, cam, flat = tile_scene
    tiled_cfg = TILE.replace(rays_per_batch=0)
    tiled = render_frame(scene, cam, tiled_cfg)
    np.testing.assert_array_equal(tiled, flat)
    tile = render_tile(scene, cam, TILE, x0=16, y0=16, tile_h=16, tile_w=16)
    np.testing.assert_array_equal(tile[:4, :8].numpy(), flat[16:20, 16:24])
    tscene, tcam, _ = t_default_scene(tpurt_cfg(tiled_cfg))
    theirs = t_renderer.render_frame(tscene, tcam, tpurt_cfg(tiled_cfg))
    assert_mostly_bitwise(tiled, theirs)


def test_accumulator_resume_gives_the_same_image(tile_scene, tmp_path,
                                                 monkeypatch):
    scene, cam, _flat = tile_scene
    want = render_image(scene, cam, TILE)
    path = str(tmp_path / "acc.npz")
    real = renderer.render_tile_with_stats
    calls = {"n": 0}

    def crash_after_two(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 2:
            raise KeyboardInterrupt("the run was stopped")
        return real(*a, **kw)

    monkeypatch.setattr(renderer, "render_tile_with_stats", crash_after_two)
    with pytest.raises(KeyboardInterrupt):
        render_image(scene, cam, TILE, accumulator=TileAccumulator(TILE, path=path))
    calls["n"] = -10  # no more crashes
    resumed = render_image(scene, cam, TILE,
                           accumulator=TileAccumulator(TILE, path=path))
    assert calls["n"] == -8  # only the two missing tiles were rendered
    np.testing.assert_array_equal(resumed, want)


def test_transient_error_retries(tile_scene, monkeypatch):
    scene, cam, flat = tile_scene
    real = renderer.render_batch_flat
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.AcceleratorError("injected transient device loss")
        return real(*a, **kw)

    monkeypatch.setattr(renderer, "render_batch_flat", flaky)
    np.testing.assert_array_equal(render_frame(scene, cam, TILE, retries=2), flat)
    assert calls["n"] >= 2


def test_deterministic_error_propagates(tile_scene, monkeypatch):
    scene, cam, _ = tile_scene
    calls = {"n": 0}

    def broken(*a, **kw):
        calls["n"] += 1
        raise ValueError("deterministic bug")

    monkeypatch.setattr(renderer, "render_batch_flat", broken)
    with pytest.raises(ValueError):
        render_frame(scene, cam, TILE, retries=3)
    assert calls["n"] == 1


def test_transient_error_exhausts_retries(tile_scene, monkeypatch):
    scene, cam, _ = tile_scene

    def always_down(*a, **kw):
        raise torch.AcceleratorError("device gone")

    monkeypatch.setattr(renderer, "render_tile_with_stats", always_down)
    with pytest.raises(torch.AcceleratorError):
        render_frame(scene, cam, TILE.replace(rays_per_batch=0), retries=2)


# ---------------------------------------------------------------- anim

# One sample, decorrelated seeds: tpurt's one-sample passes of
# sample_flatten then run the program its video compiled (t_video).
VIDEO = TILE.replace(width=16, height=16, tile_size=16, pixels_per_lane=1,
                     mega_tail_passes=1, video_frame_count=3,
                     rays_per_pixel=1, seed_mode="decorrelated")


@pytest.fixture(scope="module")
def t_video():
    """tpurt's scene and camera for VIDEO (one compiled program, shared
    by the video and sample_flatten comparisons)."""
    tscene, tcam, _ = t_default_scene(tpurt_cfg(VIDEO))
    return tscene, tcam


def test_video_yaw_schedule_matches_tpurt():
    scene, _cam, _ = default_scene(VIDEO, device="cpu")
    tscene, _tcam, _ = t_default_scene(tpurt_cfg(VIDEO))
    for f in range(4):
        np.testing.assert_array_equal(
            anim.video_frame_scene(scene, f, 4).mesh_yaw.numpy(),
            np.asarray(t_anim.video_frame_scene(tscene, f, 4).mesh_yaw))


def test_set_mesh_yaw_refusals():
    scene, _cam, _ = default_scene(VIDEO, device="cpu")
    assert scene.mesh_identity[0]  # a Cornell box quad
    with pytest.raises(ValueError, match="identity"):
        anim.set_mesh_yaw(scene, 0, 1.0)
    with pytest.raises(ValueError, match="TLAS"):
        anim.set_mesh_yaw(grid_scene(12, device="cpu"), -1, 1.0)


def test_render_video_matches_tpurt_and_render_image(tmp_path, t_video):
    scene, cam, _ = default_scene(VIDEO, device="cpu")
    paths = anim.render_video(scene, cam, VIDEO, out_dir=str(tmp_path / "p"))
    assert [os.path.basename(p) for p in paths] == [
        "output_0.bmp", "output_1.bmp", "output_2.bmp"]
    tscene, tcam = t_video
    tpaths = t_anim.render_video(tscene, tcam, tpurt_cfg(VIDEO),
                                 out_dir=str(tmp_path / "t"))
    for f, (p, tp) in enumerate(zip(paths, tpaths)):
        img = read_bmp(p)
        assert_mostly_bitwise(img, read_bmp(tp))
        np.testing.assert_array_equal(img, render_image(
            anim.video_frame_scene(scene, f, 3), cam, VIDEO, frame_index=f))


def test_sample_flatten_equals_in_lane_frame_and_tpurt(t_video):
    """sample_flatten (one-sample passes, accumulated on the device in
    sample order) equals the in-lane frame bit for bit in decorrelated
    mode, as tpurt's does (tests/test_mega_pallas.py:77-90), at one and
    two pixels a lane, and matches tpurt's frame."""
    scene, cam, _ = default_scene(VIDEO, device="cpu")
    for p in (1, 2):
        cfg = VIDEO.replace(rays_per_pixel=3, max_bounces=4, pixels_per_lane=p)
        s_in, s_fl = {}, {}
        ref = render_frame(scene, cam, cfg, stats=s_in)
        out = render_frame(scene, cam, cfg.replace(sample_flatten=True),
                           stats=s_fl)
        np.testing.assert_array_equal(out, ref)
        assert s_fl["segments"] == s_in["segments"]
    cfg = VIDEO.replace(rays_per_pixel=3, sample_flatten=True)
    stats, t_stats = {}, {}
    mine = render_frame(scene, cam, cfg, stats=stats)
    tscene, tcam = t_video
    theirs = t_renderer.render_frame(tscene, tcam, tpurt_cfg(cfg), stats=t_stats)
    assert_mostly_bitwise(mine, theirs)
    assert abs(stats["segments"] - t_stats["segments"]) <= \
        0.005 * t_stats["segments"]


def test_static_hook_packed_video_equals_unpacked(tmp_path, monkeypatch):
    scene, cam, _ = default_scene(VIDEO, device="cpu")
    static = lambda s, f, n: s
    packs = []
    real = renderer.render_batch_flat_frames

    def spy(s, cameras, *a, **kw):
        packs.append(len(cameras))
        return real(s, cameras, *a, **kw)

    monkeypatch.setattr(renderer, "render_batch_flat_frames", spy)
    packed = anim.render_video(scene, cam, VIDEO.replace(mega_frames_per_batch=2),
                               out_dir=str(tmp_path / "packed"), frame_hook=static)
    assert packs == [2]  # frames 0-1 in one launch, frame 2 alone
    alone = anim.render_video(scene, cam, VIDEO, out_dir=str(tmp_path / "alone"),
                              frame_hook=static)
    for p, q in zip(packed, alone):
        with open(p, "rb") as a, open(q, "rb") as b:
            assert a.read() == b.read()


def test_progressive_render(tmp_path):
    scene, cam, _ = default_scene(VIDEO, device="cpu")
    preview = str(tmp_path / "preview.bmp")
    mean = anim.progressive_render(scene, cam, VIDEO, 2, preview_path=preview)
    want = (render_frame(scene, cam, VIDEO, frame_index=0)
            + render_frame(scene, cam, VIDEO, frame_index=1)) / 2
    np.testing.assert_array_equal(mean, want)
    np.testing.assert_array_equal(
        read_bmp(preview), renderer.tonemap(torch.from_numpy(want)).numpy())


# ---------------------------------------------------- deep-stack scene


def test_deep_stack_scene_matches_tpurt():
    # One sample: the plain version's frame costs a torch step per trip,
    # and this scene's lanes take hundreds.
    cfg = TILE.replace(width=16, height=16, pixels_per_lane=1,
                       mega_tail_passes=1, rays_per_pixel=1)
    scene, cam = deep_stack_scene(cfg, device="cpu")
    assert scene.mega_stack_depth == 36  # > 32: a budget of 72 stack words
    assert 2 * scene.mega_stack_depth > mega_cuda.MAX_SHARED_STACK
    # Past the kernel's 64-word shared stack ring in earnest: the primary
    # rays hold 67 entries at the bottom of the chain, after trip 34.
    args = flat_batch_args(scene, cam, cfg, 0)
    ctx = mk.prepare(scene, **args)
    lane = mk.run_megakernel(scene, max_iterations=0, return_state=True, **args)
    assert int(mk.stack_entries(mk.run_plain(lane, ctx, 34)).max()) == 67
    # tpurt's twin, from the same numpy arrays and the same arity
    tcfg = tpurt_cfg(cfg)
    b = TBuilder()
    model = t_model_for(b, tcfg)
    model.material = TMaterial(type=TMT.SOLID, ior=1.0, color=(1.0, 1.0, 1.0),
                               specular_probability=1.0)
    model.scale = 0.5
    b.add_cornell_box(model)
    b.add_mesh(model)
    chain = b.add_triangles(*deep_chain(), max_depth=256)
    chain.material = TMaterial(type=TMT.SOLID, color=(0.9, 0.6, 0.3))
    chain.pos = DEEP_CHAIN_POS
    b.add_mesh(chain)
    old = t_config.MEGA_NODE_ARITY
    t_config.MEGA_NODE_ARITY = 4
    try:
        tscene = b.freeze()
    finally:
        t_config.MEGA_NODE_ARITY = old
    assert tscene.mega_stack_depth == scene.mega_stack_depth
    np.testing.assert_array_equal(np.asarray(tscene.mega_rows).view(np.int32),
                                  scene.mega_rows.numpy().view(np.int32))
    tcam = TCamera.create(position=np.add(DEEP_CHAIN_POS, DEEP_CAMERA_OFFSET),
                          yaw=math.pi / 2, fov_degrees=cfg.fov_degrees,
                          aspect_ratio=cfg.aspect_ratio)
    stats, t_stats = {}, {}
    mine = render_frame(scene, cam, cfg, stats=stats)
    theirs = t_renderer.render_frame(tscene, tcam, tcfg, stats=t_stats)
    assert_mostly_bitwise(mine, theirs)
    assert abs(stats["segments"] - t_stats["segments"]) <= \
        0.005 * t_stats["segments"]
    assert (mine > 0).any()
