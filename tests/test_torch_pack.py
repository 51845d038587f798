"""Cross-frame packing and sample_flatten on the CPU: the port against
itself, bit for bit, and against tpurt's XLA body.

* ``render_batch_flat_frames`` renders F frames in one launch, each
  bitwise what ``render_batch_flat`` gives for that frame alone, with
  the pack's segments the sum of the frames' (tests/test_flat_batching.py
  :51-123 holds tpurt's the same way): per-camera packs (a rotation-only
  second camera), all-identical packs (collapsed to one camera, whose
  slots share one frame's direction table), and the brute-force mode.
* Port-packed against tpurt's packed batch, frame by frame, within
  tpurt's knife-edge tolerance (``assert_mostly_bitwise``, <= 0.5% of
  pixels), segments within 0.5%.
* ``cross_frame_pack_ok`` gives tpurt's answer on a grid of configs.

sample_flatten's tests are in tests/test_torch_io_anim.py, where tpurt's
side shares the video's compiled program.
"""

import itertools

import numpy as np
import pytest
import torch

from test_render_golden import assert_mostly_bitwise
import tpurt.config as t_config
from tpurt.core.camera import Camera as TCamera
from tpurt.render import renderer as t_renderer
from tpurt.scene.presets import default_scene as t_default_scene
from tpurt_torch.config import RenderConfig
from tpurt_torch.core.camera import Camera
from tpurt_torch.render import renderer
from tpurt_torch.render.renderer import (
    _flat_batch_size, cross_frame_pack_ok, render_batch_flat,
    render_batch_flat_frames)
from tpurt_torch.scene.presets import default_scene

# test_flat_batching's packing config: two batches of 256 lanes x 2 slots.
PACK = RenderConfig(width=40, height=24, rays_per_pixel=2, max_bounces=3,
                    tile_size=16, object_path="sphere1.obj",
                    rays_per_batch=256, pixels_per_lane=2,
                    compaction_threshold=0, mega_body="xla")


def _turned(cam, d_yaw, maker, **kw):
    """A rotation-only companion of ``cam`` (shared position: packing's
    contract)."""
    p = np.asarray(cam.params, np.float32)
    return maker.create(position=tuple(float(v) for v in p[:3]),
                        pitch=float(p[3]), yaw=float(p[4]) + d_yaw,
                        roll=float(p[5]), fov_degrees=float(p[6]),
                        aspect_ratio=float(p[7]), **kw)


@pytest.fixture(scope="module")
def pack_scene():
    scene, cam, _ = default_scene(PACK, device="cpu")
    return scene, cam, _turned(cam, 0.15, Camera, device="cpu")


@pytest.mark.parametrize("form", ["per-camera", "shared"])
def test_packed_frames_equal_lone_frames(pack_scene, form, monkeypatch):
    scene, cam0, cam1 = pack_scene
    cams = (cam0, cam1) if form == "per-camera" else (cam0, cam0, cam0)
    seen = {}
    real = renderer._mega_flat_multi

    def spy(s, cameras, *a, **kw):
        seen["cameras"] = len(cameras)
        return real(s, cameras, *a, **kw)

    monkeypatch.setattr(renderer, "_mega_flat_multi", spy)
    rows = _flat_batch_size(PACK) * PACK.pixels_per_lane
    assert rows < PACK.width * PACK.height  # two distinct regions
    for start in (0, rows):
        packed, segs, _ = render_batch_flat_frames(scene, cams, PACK, start,
                                                   frame_index=3)
        assert packed.shape == (len(cams) * rows, 3)
        total = 0
        for f, cam in enumerate(cams):
            lone, s1, _ = render_batch_flat(scene, cam, PACK, start,
                                            frame_index=3 + f)
            assert torch.equal(packed[f * rows:(f + 1) * rows], lone), (f, start)
            total += s1
        assert segs == total
    # an all-identical tuple collapses to one camera (the shared table)
    assert seen["cameras"] == (2 if form == "per-camera" else 1)


def test_packed_dense_mode(pack_scene):
    scene, cam0, cam1 = pack_scene
    cfg = PACK.replace(mega_dense=True)
    rows = _flat_batch_size(cfg) * cfg.pixels_per_lane
    packed, segs, _ = render_batch_flat_frames(scene, (cam0, cam1), cfg, 0,
                                               frame_index=1)
    total = 0
    for f, cam in enumerate((cam0, cam1)):
        lone, s1, _ = render_batch_flat(scene, cam, cfg, 0, frame_index=1 + f)
        assert torch.equal(packed[f * rows:(f + 1) * rows], lone), f
        total += s1
    assert segs == total


def test_one_frame_pack_is_the_flat_batch(pack_scene):
    scene, cam0, _ = pack_scene
    one = render_batch_flat_frames(scene, (cam0,), PACK, 0, frame_index=2)
    flat = render_batch_flat(scene, cam0, PACK, 0, frame_index=2)
    assert torch.equal(one[0], flat[0]) and one[1:] == flat[1:]


def test_packed_matches_tpurt(pack_scene):
    """A camera a frame (the shared form's frames are held bit for bit to
    the lone frames above, which tests/test_torch_megakernel.py holds to
    tpurt)."""
    scene, cam0, cam1 = pack_scene
    tcfg = t_config.RenderConfig(**{f: getattr(PACK, f) for f in (
        "width", "height", "rays_per_pixel", "max_bounces", "tile_size",
        "object_path", "rays_per_batch", "pixels_per_lane",
        "compaction_threshold", "mega_body")})
    tscene, tcam0, _ = t_default_scene(tcfg)
    cams, tcams = (cam0, cam1), (tcam0, _turned(tcam0, 0.15, TCamera))
    rows = _flat_batch_size(PACK) * PACK.pixels_per_lane
    mine, segs, _ = render_batch_flat_frames(scene, cams, PACK, 0,
                                             frame_index=5)
    theirs, t_segs, _ = t_renderer.render_batch_flat_frames(
        tscene, tcams, tcfg, 0, frame_index=5)
    theirs = np.asarray(theirs)
    for f in range(len(cams)):
        assert_mostly_bitwise(mine[f * rows:(f + 1) * rows].numpy(),
                              theirs[f * rows:(f + 1) * rows])
    assert abs(segs - float(t_segs)) <= 0.005 * float(t_segs)


def test_cross_frame_pack_ok_matches_tpurt():
    grid = itertools.product(
        (0, 3), (False, True), (False, True), (1, 2), (0, 256, 100000),
        (256, 65536))
    for bounces, jitter, sflat, spp, threshold, batch in grid:
        kw = dict(width=64, height=48, max_bounces=bounces,
                  subpixel_jitter=jitter, sample_flatten=sflat,
                  rays_per_pixel=spp, compaction_threshold=threshold,
                  rays_per_batch=batch, pixels_per_lane=2,
                  seed_mode="decorrelated" if sflat else "reference")
        assert cross_frame_pack_ok(RenderConfig(**kw)) == \
            t_renderer.cross_frame_pack_ok(t_config.RenderConfig(**kw)), kw


@pytest.mark.parametrize("knob", [dict(compaction_threshold=256),
                                  dict(subpixel_jitter=True)])
def test_pack_refusals(pack_scene, knob):
    """Configs ``cross_frame_pack_ok`` rejects are refused, as tpurt's
    assertion refuses them."""
    scene, cam0, cam1 = pack_scene
    with pytest.raises(ValueError, match="plain flat schedule"):
        render_batch_flat_frames(scene, (cam0, cam1), PACK.replace(**knob), 0)
