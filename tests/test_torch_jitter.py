"""Sub-pixel jitter on the CPU: tpurt_torch's plain versions against
tpurt (its megakernel on the XLA body, its modular engine as it is).
List quotas, and the jittered decorrelated quota's frame and lane state
at 1,024 lanes, are held to tpurt in tests/test_torch_quota.py (each
tpurt program takes ~15-20 s to compile here, so the cases are split
over two files).

Jitter through both engines on test_render_golden's 16x16 scene: the
megakernel in reference mode at P = 1 and 2 and in decorrelated mode at
P = 1 (one tail pass), the modular engine in both seed modes. Frames
within tpurt's ``assert_mostly_bitwise`` (<= 0.5% of pixels differ),
segment counts within 0.5%. tpurt's megakernel frame comes from its
compiled start function run to the end (``_mega_flat_start``, whose trip
cap is traced), as the lane states of tests/test_torch_quota.py do.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_render_golden import assert_mostly_bitwise
from test_torch_megakernel import GOLDEN, port_lane
from tpurt.render import renderer as t_renderer
from tpurt.scene.presets import cornell_sphere_scene as t_cornell
from tpurt_torch.render.renderer import render_frame
from tpurt_torch.scene.presets import cornell_sphere_scene

JITTER = GOLDEN.replace(subpixel_jitter=True, compaction_threshold=0)


def t_start(cfg, cap):
    """tpurt's flat batch 0 of ``cfg`` after ``cap`` trips, as the port's
    lane state."""
    tscene, tcam, _ = t_cornell(0, cfg)
    statics = t_renderer._mega_statics(cfg, cfg.width, cfg.height)
    st, _active = t_renderer._mega_flat_start(
        tscene, tcam, jnp.asarray([0, 0, 0, cap], jnp.int32),
        batch=t_renderer._flat_batch_size(cfg),
        pixels_per_lane=cfg.pixels_per_lane, **statics)
    return port_lane(st)


def radiance(lane, cfg):
    """The frame and segment count of a finished lane state."""
    accs = lane.accs if cfg.pixels_per_lane > 1 else (lane.acc,)
    rows = torch.cat([torch.stack(list(a), 1) for a in accs])
    n = cfg.width * cfg.height
    frame = (rows[:n] / float(cfg.rays_per_pixel)).numpy()
    return frame.reshape(cfg.height, cfg.width, 3), int(lane.segments.sum())


@pytest.mark.parametrize("seed_mode,quota", [
    ("reference", 1), ("reference", 2), ("decorrelated", 1)])
def test_jittered_megakernel_frame_matches_tpurt(seed_mode, quota):
    cfg = JITTER.replace(seed_mode=seed_mode, pixels_per_lane=quota)
    theirs, t_segs = radiance(t_start(cfg, 1 << 30), cfg)
    scene, cam, _ = cornell_sphere_scene(0, cfg, device="cpu")
    stats = {}
    mine = render_frame(scene, cam, cfg, stats=stats)
    assert_mostly_bitwise(mine, theirs)
    assert abs(stats["segments"] - t_segs) <= 0.005 * t_segs
    # The jitter is live: the unjittered frame differs.
    assert not np.array_equal(mine, render_frame(
        scene, cam, cfg.replace(subpixel_jitter=False)))


@pytest.mark.parametrize("seed_mode", ["reference", "decorrelated"])
def test_jittered_modular_frame_matches_tpurt(seed_mode):
    """tpurt's asymmetry is kept: in reference mode sample 0's jittered
    ray (and its first hit) is shared by every sample, in decorrelated
    mode every sample has its own."""
    cfg = JITTER.replace(engine="modular", seed_mode=seed_mode)
    tscene, tcam, _ = t_cornell(0, cfg)
    tstats = {}
    theirs = t_renderer.render_frame(tscene, tcam, cfg, stats=tstats)
    scene, cam, _ = cornell_sphere_scene(0, cfg, device="cpu")
    stats = {}
    mine = render_frame(scene, cam, cfg, stats=stats)
    assert_mostly_bitwise(mine, theirs)
    assert abs(stats["segments"] - tstats["segments"]) <= 0.005 * tstats["segments"]
    assert not np.array_equal(mine, render_frame(
        scene, cam, cfg.replace(subpixel_jitter=False)))
