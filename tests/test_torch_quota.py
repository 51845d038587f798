"""Quotas at 1,024 lanes on the CPU: list quotas
(``run_megakernel(pixel_list=...)``) and the jittered quota in
tpurt_torch's plain version against tpurt's (on its XLA body).

A list quota at P = 2 and 4 over a seeded permutation of the 32x32
Cornell-sphere frame's pixels at 1,024 lanes (slot 0 reads the list,
later slots its last entry through the slot table): lane states equal
in every integer, u32 and bool field on >= 99.5% of lanes after 1, 4
and 16 trips (at 1,024 lanes one lane is 0.1%), the radiance rows
within tpurt's ``assert_mostly_bitwise`` (<= 0.5% differ), segments
within 0.5%. A list of P permutations (every slot a listed pixel, each
pixel listed P times) gives each pixel its row of the affine frame, bit
for bit (a pixel's radiance is a pure function of the pixel, frame and
sample). There the finished lanes of 11 of the 1,024 pixels hold
another bounce count than tpurt's (radiance and segments equal), as on
the affine path: the front wall's pass-through knife edge after a 1-ulp
direction difference (ROADMAP C), 1.07% of lanes, so that list is held
to the port's own affine frame, which tpurt holds elsewhere.
An identity list at the flat batch's lanes gives the affine quota's lanes
and frame bit for bit, and a run resumed from a listed lane state
rebuilds its slot pixels from lane0.

Sub-pixel jitter in decorrelated mode at P = 2 on the 32x32 frame (the
other seed modes and quotas are in tests/test_torch_jitter.py): the lane
state after 1, 4 and 16 trips under the same gate, and the frame from
the same tpurt program run to the end.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_render_golden import assert_mostly_bitwise
from test_torch_jitter import JITTER, radiance, t_start
from test_torch_megakernel import GOLDEN, port_lane
from tpurt.core.camera import make_ray as t_make_ray, pixel_uv as t_pixel_uv
from tpurt.render import renderer as t_renderer
from tpurt.render.megakernel import run_megakernel as t_run_megakernel
from tpurt.scene.presets import cornell_sphere_scene as t_cornell
from tpurt_torch.render import mega_cuda
from tpurt_torch.render import megakernel as mk
from tpurt_torch.render.renderer import (
    flat_batch_args, list_batch_args, render_frame)
from tpurt_torch.scene.presets import cornell_sphere_scene

LIST = GOLDEN.replace(width=32, height=32, compaction_threshold=0)
LANES = 1024
BIG = JITTER.replace(width=32, height=32, seed_mode="decorrelated",
                     pixels_per_lane=2)


@functools.lru_cache(maxsize=None)
def t_list_fn(p, lanes=LANES):
    """tpurt's run_megakernel in list mode on LIST's scene: (pixel list,
    trip cap) -> lane state; one compile per quota."""
    statics = t_renderer._mega_statics(LIST, LIST.width, LIST.height)

    @jax.jit
    def run(scene, camera, plist, cap):
        pix0 = plist[jnp.minimum(jnp.arange(lanes), plist.shape[0] - 1)]
        xs = (pix0 % LIST.width).astype(jnp.int32)
        ys = (pix0 // LIST.width).astype(jnp.int32)
        ro0, rd0 = t_make_ray(camera, t_pixel_uv(xs, ys, LIST.width, LIST.height))
        return t_run_megakernel(
            scene, ro0, rd0, pix0, 0, camera=camera, max_iterations=cap,
            return_state=True, pixels_per_lane=p, pixel_stride=lanes,
            pixel_list=plist, **statics)

    return run


@pytest.fixture(scope="module")
def list_scenes():
    tscene, tcam, _ = t_cornell(0, LIST)
    scene, cam, _ = cornell_sphere_scene(0, LIST, device="cpu")
    return tscene, tcam, scene, cam


@pytest.mark.parametrize("quota", [2, 4])
def test_list_quota_matches_tpurt(list_scenes, quota):
    tscene, tcam, scene, cam = list_scenes
    cfg = LIST.replace(pixels_per_lane=quota)
    perm = np.random.default_rng(quota).permutation(cfg.width * cfg.height)
    args = list_batch_args(scene, cam, cfg, perm, lanes=LANES)
    run = t_list_fn(quota, LANES)
    plist = jnp.asarray(perm.astype(np.uint32))
    for trips in (1, 4, 16):
        mine = mk.run_megakernel(scene, max_iterations=trips, return_state=True,
                                 **args)
        theirs = port_lane(run(tscene, tcam, plist, jnp.int32(trips)))
        assert torch.equal(mine.lane0.long(), theirs.lane0.long())
        agree, _err = mega_cuda.compare_lanes(mine, theirs)
        assert agree >= 0.995, (trips, agree)
    theirs = port_lane(run(tscene, tcam, plist, jnp.int32(1 << 30)))
    mean, segs, _ = mk.run_megakernel(scene, **args)
    t_rows = torch.cat([torch.stack(list(a), 1) for a in theirs.accs])
    n = perm.shape[0]
    assert_mostly_bitwise(mean[:n].numpy()[None],
                          (t_rows[:n] / float(cfg.rays_per_pixel)).numpy()[None])
    t_segs = int(theirs.segments.sum())
    assert abs(segs - t_segs) <= 0.005 * t_segs


@pytest.mark.parametrize("quota", [2, 4])
def test_listed_slots_are_the_affine_rows(list_scenes, quota):
    _ts, _tc, scene, cam = list_scenes
    cfg = LIST.replace(pixels_per_lane=quota)
    n = cfg.width * cfg.height
    rng = np.random.default_rng(quota)
    perm = np.concatenate([rng.permutation(n) for _ in range(quota)])[:-1]
    args = list_batch_args(scene, cam, cfg, perm)
    assert args["pixel_index"].shape[0] == LANES
    mean, _segs, _ = mk.run_megakernel(scene, **args)
    frame = torch.from_numpy(render_frame(scene, cam, LIST).reshape(n, 3))
    assert torch.equal(mean[:perm.shape[0]], frame[torch.from_numpy(perm)])


@pytest.mark.parametrize("quota", [2, 4])
def test_identity_list_is_the_affine_quota(list_scenes, quota):
    """pixel_list = the frame's pixels in order, at the flat batch's
    lanes: every lane field after 1, 4 and 16 trips and the frame equal
    the affine quota's bit for bit; a resumed run rebuilds its slot
    pixels from lane0."""
    _ts, _tc, scene, cam = list_scenes
    cfg = LIST.replace(pixels_per_lane=quota)
    affine = flat_batch_args(scene, cam, cfg, 0)
    lanes = affine["pixel_index"].shape[0]
    args = list_batch_args(scene, cam, cfg, np.arange(cfg.width * cfg.height),
                           lanes=lanes)
    for trips in (1, 4, 16):
        a = mk.run_megakernel(scene, max_iterations=trips, return_state=True,
                              **args)
        b = mk.run_megakernel(scene, max_iterations=trips, return_state=True,
                              **affine)
        assert mega_cuda.compare_lanes(a._replace(lane0=None), b) == (1.0, 0.0)
    resumed = mk.run_megakernel(scene, initial_state=a, **args)
    whole = mk.run_megakernel(scene, **args)
    assert torch.equal(resumed[0], whole[0]) and resumed[1] == whole[1]
    mean, _segs, _ = whole
    n = cfg.width * cfg.height
    np.testing.assert_array_equal(mean[:n].numpy().reshape(32, 32, 3),
                                  render_frame(scene, cam, cfg))


def test_list_is_ignored_at_quota_one(list_scenes):
    _ts, _tc, scene, cam = list_scenes
    args = flat_batch_args(scene, cam, LIST, 0)
    with_list = mk.run_megakernel(scene, pixel_list=torch.arange(5), **args)
    without = mk.run_megakernel(scene, **args)
    assert torch.equal(with_list[0], without[0])


@pytest.mark.parametrize("trips", [1, 4, 16])
def test_jittered_lane_state_matches_tpurt(trips):
    scene, cam, _ = cornell_sphere_scene(0, BIG, device="cpu")
    args = flat_batch_args(scene, cam, BIG, 0)
    assert args["pixel_index"].shape[0] == LANES
    mine = mk.run_megakernel(scene, max_iterations=trips, return_state=True,
                             **args)
    assert mine.c_set is None  # the primary-hit cache is off under jitter
    agree, _err = mega_cuda.compare_lanes(mine, t_start(BIG, trips))
    assert agree >= 0.995, agree


def test_jittered_quota_frame_matches_tpurt():
    theirs, t_segs = radiance(t_start(BIG, 1 << 30), BIG)
    scene, cam, _ = cornell_sphere_scene(0, BIG, device="cpu")
    stats = {}
    mine = render_frame(scene, cam, BIG, stats=stats)
    assert_mostly_bitwise(mine, theirs)
    assert abs(stats["segments"] - t_segs) <= 0.005 * t_segs
