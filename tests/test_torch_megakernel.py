"""The slice on the CPU: tpurt_torch's megakernel (its plain torch
version) against tpurt's XLA body and the scalar oracle.

* Lane state after 1, 4 and 16 loop trips equals tpurt's
  ``run_megakernel(..., max_iterations=k, return_state=True)`` (via its
  flat-batch entry point) in every integer, u32 and bool field — stack
  included — on >= 99.5% of lanes, at quota P=2 with 2 tail passes, on
  a 32x32 frame (1024 lanes: at 256 lanes a single lane is 0.4%, and
  the front-wall pass-through knife edge of ROADMAP C flips 5 of them
  after the first trip).
* Frames through ``render_frame`` / ``render_image`` match tpurt's and
  the oracle's under tpurt's own knife-edge tolerance
  (``assert_mostly_bitwise``, <= 0.5% of pixels), with segment counts
  within 0.5%, on test_render_golden's Cornell-sphere scene.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle
from test_render_golden import assert_mostly_bitwise
from tpurt.config import RenderConfig
from tpurt.render import renderer as t_renderer
from tpurt.render.tonemap import tonemap as t_tonemap
from tpurt.scene.presets import cornell_sphere_scene as t_cornell
from tpurt_torch.core.v3 import V3
from tpurt_torch.render import mega_cuda
from tpurt_torch.render import megakernel as mk
from tpurt_torch.render.renderer import (
    flat_batch_args, render_frame, render_image)
from tpurt_torch.scene.presets import cornell_sphere_scene

# test_render_golden.test_cornell_sphere_bitwise's frame
GOLDEN = RenderConfig(width=16, height=16, rays_per_pixel=2, max_bounces=3,
                      tile_size=16, object_path="sphere0.obj", mega_body="xla")
QUOTA = GOLDEN.replace(width=32, height=32, pixels_per_lane=2,
                       mega_tail_passes=2, compaction_threshold=0)


def port_lane(t) -> mk._Lane:
    """A tpurt lane state as the port's (u32 -> int64 values)."""
    def c(a):
        a = np.asarray(a)
        return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                                else a.copy())

    def v(x):
        if x is None:
            return None
        return V3(*(c(e) for e in x)) if isinstance(x, tuple) else c(x)

    vals = {f: v(getattr(t, f)) for f in mk._Lane._fields
            if f not in ("iters", "accs", "stack")}
    return mk._Lane(iters=int(t.iters), accs=tuple(v(a) for a in t.accs),
                    stack=tuple(c(s) for s in t.stack), **vals)


@pytest.fixture(scope="module")
def quota_states():
    """(port scene, camera, tpurt lane state after k trips for k = 1, 4,
    16) — one tpurt compile for all three (the cap is traced)."""
    tscene, tcam, _ = t_cornell(0, QUOTA)
    statics = t_renderer._mega_statics(QUOTA, QUOTA.width, QUOTA.height)
    b = t_renderer._flat_batch_size(QUOTA)
    states = {}
    for k in (1, 4, 16):
        st, _active = t_renderer._mega_flat_start(
            tscene, tcam, jnp.asarray([0, 0, 0, k], jnp.int32), batch=b,
            pixels_per_lane=2, **statics)
        states[k] = port_lane(st)
    scene, cam, _ = cornell_sphere_scene(0, QUOTA, device="cpu")
    return scene, cam, states


@pytest.mark.parametrize("trips", [1, 4, 16])
def test_lane_state_matches_tpurt(quota_states, trips):
    scene, cam, theirs = quota_states
    mine = mk.run_megakernel(scene, max_iterations=trips, return_state=True,
                             **flat_batch_args(scene, cam, QUOTA, 0))
    assert mine.iters == theirs[trips].iters == trips
    agree, _err = mega_cuda.compare_lanes(mine, theirs[trips])
    assert agree >= 0.995, agree


@pytest.fixture(scope="module")
def golden():
    tscene, tcam, _ = t_cornell(0, GOLDEN)
    tstats = {}
    theirs = t_renderer.render_frame(tscene, tcam, GOLDEN, stats=tstats)
    ref, ref_px = oracle.render(tscene, tcam, 16, 16, 2, 3)
    return theirs, tstats["segments"], ref, ref_px


@pytest.mark.parametrize("quota,tail", [(1, 1), (2, 2), (4, 3)])
def test_frame_matches_tpurt_and_oracle(golden, quota, tail):
    theirs, t_segs, ref, ref_px = golden
    cfg = GOLDEN.replace(pixels_per_lane=quota, mega_tail_passes=tail)
    scene, cam, _ = cornell_sphere_scene(0, cfg, device="cpu")
    stats = {}
    mine = render_frame(scene, cam, cfg, stats=stats)
    assert_mostly_bitwise(mine, ref)
    assert_mostly_bitwise(mine, theirs)
    img = render_image(scene, cam, cfg)
    assert img.dtype == np.uint8 and img.shape == (16, 16, 3)
    assert_mostly_bitwise(img, ref_px)
    np.testing.assert_array_equal(img, np.asarray(t_tonemap(jnp.asarray(mine))))
    if quota == 1:  # same lanes, same padding: the same segment count
        assert abs(stats["segments"] - t_segs) <= 0.005 * t_segs


def test_pallas_body_on_cpu_scene_raises():
    scene, cam, _ = cornell_sphere_scene(0, GOLDEN, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        render_frame(scene, cam, GOLDEN.replace(mega_body="pallas"))


@pytest.mark.parametrize("knob", [
    dict(subpixel_jitter=True), dict(mega_frames_per_batch=2),
    dict(sample_flatten=True, seed_mode="decorrelated"),
    dict(subpixel_jitter=True, engine="modular"),
])
def test_unported_knobs_raise(knob):
    """Knobs once refused now render. Jitter, in both engines: the frame
    differs from the unjittered one and equals the same plain version run
    by another route (the megakernel's tile path, one launch a tile; the
    modular engine in 8x8 tiles instead of one 16x16 tile), bit for bit.
    ``render_frame`` ignores mega_frames_per_batch, as tpurt's does (the
    frame equals the unpacked one bit for bit), and sample_flatten's frame
    equals the in-lane frame bit for bit."""
    scene, cam, _ = cornell_sphere_scene(0, GOLDEN, device="cpu")
    cfg = GOLDEN.replace(**knob)
    if cfg.subpixel_jitter:
        frame = render_frame(scene, cam, cfg)
        other = (cfg.replace(tile_size=8) if cfg.engine == "modular"
                 else cfg.replace(rays_per_batch=0))
        np.testing.assert_array_equal(frame, render_frame(scene, cam, other))
        assert not np.array_equal(frame, render_frame(
            scene, cam, cfg.replace(subpixel_jitter=False)))
        return
    plain = GOLDEN.replace(seed_mode=cfg.seed_mode)
    np.testing.assert_array_equal(render_frame(scene, cam, cfg),
                                  render_frame(scene, cam, plain))


def test_kernel_wrapper_on_cpu_is_the_plain_version(quota_states):
    """The kernel's wrapper refuses a CPU lane state (the plain version
    is ``run_plain``, which ``run_megakernel`` chooses), and a lane
    state packs and unpacks bit for bit."""
    scene, cam, _ = quota_states
    args = flat_batch_args(scene, cam, QUOTA, 0)
    ctx = mk.prepare(scene, **args)
    lane = mk._initial_lane(ctx, V3(*args["ro0"].unbind(-1)),
                            V3(*args["rd0"].unbind(-1)), args["pixel_index"])
    with pytest.raises(ValueError, match="CUDA"):
        mega_cuda.run(lane, ctx, 6)
    a = mk.run_plain(lane, ctx, 6)
    b = mk.run_megakernel(scene, body_backend="plain", max_iterations=6,
                          return_state=True, **args)
    assert mega_cuda.compare_lanes(a, b) == (1.0, 0.0)
    # the packed buffer round-trips bit for bit
    buf = mega_cuda.pack(a)
    assert buf.dtype == torch.int32 and buf.shape[1] == lane.done.shape[0]
    assert torch.equal(mega_cuda.pack(mega_cuda.unpack(buf, ctx, a.iters)), buf)
    with pytest.raises(ValueError, match="CUDA"):
        mega_cuda.launch(buf, ctx, 1)


def test_lane_layout_matches_kernel_enum():
    """LANE_WORDS is the kernel's enum Field and TLAS_WORDS its enum
    TlasField, which starts where Field ends."""
    src = open(mk.__file__.replace("render/megakernel.py",
                                   "csrc/megakernel.cu")).read()
    enum = lambda pat: [n.strip().split(" = ")[0] for n in
                        re.search(pat, src, re.S).group(1).split(",")
                        if n.strip()]
    want = [w.upper().replace(".", "_") for w in mega_cuda.LANE_WORDS]
    assert enum(r"enum Field : int \{(.*?)N_FIXED") == want
    assert re.search(r"IN_INST = N_FIXED", src)
    assert enum(r"enum TlasField : int \{(.*?)N_TLAS_END") == [
        w.upper() for w in mega_cuda.TLAS_WORDS]


def test_static_only_scene_matches_oracle():
    """No chain entries (only inline static quads): every segment
    resolves in the static stage, no bank row is ever read."""
    from tpurt_torch.core.camera import Camera
    from tpurt_torch.scene.builder import Material, SceneBuilder
    from tpurt_torch.scene.types import MaterialType

    b = SceneBuilder()
    b.add_quad((-100, 0, -100), (100, 0, -100), (100, 0, 100), (-100, 0, 100),
               (0, 1, 0), (0.8, 0.8, 0.8))
    b.add_quad((-100, 0, -60), (100, 0, -60), (100, 120, -60), (-100, 120, -60),
               (0, 0, 1), (0.2, 0.9, 0.3))
    light = b.add_quad((-40, 100, -40), (40, 100, -40), (40, 100, 40),
                       (-40, 100, 40), (0, -1, 0), (0, 0, 0))
    light.material = Material(type=MaterialType.SOLID, color=(1, 1, 1),
                              emission_color=(1, 1, 1), emission_strength=6.0)
    scene = b.freeze("cpu")
    assert scene.mega_chain == () and len(scene.mega_static_cull) == 6
    cam = Camera.create((0, 60, 150), pitch=-0.2, yaw=3.14159, aspect_ratio=1.0,
                        device="cpu")
    cfg = GOLDEN.replace(rays_per_pixel=3, max_bounces=4, pixels_per_lane=2,
                         mega_tail_passes=2)
    mine = render_frame(scene, cam, cfg)
    ref, _ = oracle.render(scene, cam, 16, 16, 3, 4)
    assert_mostly_bitwise(mine, ref)
    assert (mine > 0).any()


def test_fresh_lanes_on_the_cpu_and_their_buffer_words():
    """On the CPU the plain backend starts fresh lanes with
    ``_initial_lane``'s torch operations, bit for bit, and counts them in
    ``fresh_lanes.host``; the CUDA backend refuses a CPU scene. The
    buffer that the CUDA route writes instead (``mega_cuda.lane_words``)
    has ``pack``'s words in the u8, TLAS, packed, list and cache-off
    layouts."""
    from tpurt_torch.render.renderer import list_batch_args
    from tpurt_torch.scene.presets import grid_scene
    from tpurt_torch.utils import profiling as P

    scene, cam, _ = cornell_sphere_scene(0, QUOTA, device="cpu")
    args = flat_batch_args(scene, cam, QUOTA, 0)
    r = args["pixel_index"].shape[0]
    P.reset()
    lane = mk.run_megakernel(scene, body_backend="plain", max_iterations=0,
                             return_state=True, **args)
    assert P.totals()["counts"]["fresh_lanes.host"] == r
    assert "fresh_lanes.device" not in P.totals()["counts"]
    ctx = mk.prepare(scene, **args)
    want = mk._initial_lane(ctx, V3(*args["ro0"].unbind(-1)),
                            V3(*args["rd0"].unbind(-1)), args["pixel_index"])
    assert torch.equal(mega_cuda.pack(lane), mega_cuda.pack(want))
    with pytest.raises(ValueError, match="CUDA"):
        mk.run_megakernel(scene, body_backend="cuda", **args)

    grid = grid_scene(12, device="cpu")
    small = QUOTA.replace(width=16, height=16)
    layouts = {
        "u8": (scene, flat_batch_args(scene, cam, small, 0)),
        "tlas": (grid, flat_batch_args(grid, cam, small, 0)),
        "packed": (scene, flat_batch_args(scene, cam, small, 0, frames=2)),
        "list": (scene, list_batch_args(scene, cam, small, np.arange(200)[::-1].copy())),
        "cache-off": (scene, flat_batch_args(scene, cam, small.replace(
            rays_per_pixel=1, pixels_per_lane=1), 0)),
    }
    for name, (sc, a) in layouts.items():
        ctx = mk.prepare(sc, **a)
        lane = mk._initial_lane(ctx, V3(*a["ro0"].unbind(-1)),
                                V3(*a["rd0"].unbind(-1)), a["pixel_index"])
        assert (ctx.tlas, ctx.frames, ctx.pix_list, ctx.use_cache) == (
            name == "tlas", 2 if name == "packed" else 1, name == "list",
            name != "cache-off"), name
        assert mega_cuda.lane_words(ctx) == mega_cuda.pack(lane).shape[0], name
