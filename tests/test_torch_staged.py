"""The staged drivers (tpurt_torch/render/renderer.py, tpurt's
_mega_finish_staged and its family) on the CPU through the plain version,
with tpurt's test constants (tests/test_respread.py, test_cascade.py,
test_speculative.py): stages of 48 trips, a cascade first stage of 24,
cascade levels of 128 lanes, a cascade floor of 64 pixels.

Against the port's own plain schedule (``compaction_threshold=0``), bit
for bit, since each pixel's trace is a pure function of the pixel, frame
and sample: the respread batch, the cascade batch, a P = 1 batch (its
plan ends in the uncapped stage), quota lanes compacted below their
stride, a multi-batch frame, a staged megakernel tile and tiled frame,
and a cascade level (``_render_pixlist_staged``) over a seeded
permutation of the frame's pixels. A replay is taken and equal; a guard
failure falls back, equal, with the entry state untouched;
``mega_speculative=False`` never replays. Segments of a staged batch lie
within [1, 1.5] of the plain count after a respread (re-traced in-flight
pixels count twice), within [1, 3] after three cascade levels.

Against tpurt's staged driver on its XLA body (the same constants set in
both modules): the cascade batch records the same plan at every depth
and the same top-level counts, its segments agree within 0.5%, and its
radiance rows differ from tpurt's on exactly the rows where the two
plain schedules differ: 18 of 2,048 at this config, which is past
``assert_mostly_bitwise``'s 0.5% for the plain schedules themselves (the
rsqrt and fused-multiply-add classes, ROADMAP C.5). The port sums
segments as integers; tpurt sums them in f32. Those plain rows are held
against the scalar oracle (tests/oracle.py) pixel by pixel.

The paths tpurt never stages stay plain: the sharded frame, the viewer's
dispatch and cross-frame packs. About 3 minutes alone on a small CPU box
(tpurt's compiles ~70 s of it; the plain version's ~10-20 ms a trip the
rest).
"""

import functools

import numpy as np
import pytest
import torch

from tpurt_torch.config import RenderConfig
from tpurt_torch.render import renderer as R
from tpurt_torch.render.renderer import (
    render_batch_flat, render_batch_flat_frames, render_frame,
    render_tile_with_stats)
from tpurt_torch.scene.presets import default_scene

SHRUNK = dict(_MEGA_STAGE_ITERS=48, _CASCADE_STAGE0=24, _CASCADE_W=128,
              _CASCADE_MIN=64)


def _cfg(**kw):
    base = dict(width=64, height=32, rays_per_pixel=8, max_bounces=5,
                tile_size=32, object_path="sphere1.obj", engine="mega")
    base.update(kw)
    return RenderConfig(**base)


QUOTA = _cfg(rays_per_batch=256, pixels_per_lane=8, compaction_threshold=128)
#: QUOTA's knobs, as tpurt's RenderConfig takes them.
KNOBS = dict(width=64, height=32, rays_per_pixel=8, max_bounces=5,
             tile_size=32, object_path="sphere1.obj", engine="mega",
             rays_per_batch=256, pixels_per_lane=8, compaction_threshold=128)
#: The replay's tests: one respread plan at a cheaper size.
SPEC = QUOTA.replace(rays_per_pixel=4, max_bounces=3, mega_cascade=False)


def _shrink(monkeypatch, module=R):
    for name, value in SHRUNK.items():
        monkeypatch.setattr(module, name, value)
    monkeypatch.setattr(module, "_SCHED_TRACES", {})
    monkeypatch.setattr(module, "_RETIRE_CURVES", {})
    monkeypatch.setattr(module, "_SPEC_STATS", {"replayed": 0, "fallback": 0})
    return module


@functools.lru_cache(maxsize=None)
def _scene(cfg):
    scene, cam, _ = default_scene(cfg, device="cpu")
    return scene, cam


@functools.lru_cache(maxsize=None)
def _plain_of(cfg):
    scene, cam = _scene(cfg)
    return render_batch_flat(scene, cam, cfg.replace(compaction_threshold=0), 0)


def _plain(scene, cam, cfg):
    """The plain schedule's batch at 0 (of ``_scene(cfg)``'s scene)."""
    assert (scene, cam) == _scene(cfg)
    return _plain_of(cfg)


@functools.lru_cache(maxsize=None)
def _tpurt_quota():
    """tpurt's scene, camera and plain-schedule batch at 0 (on its XLA
    body) for QUOTA's knobs."""
    from tpurt.config import RenderConfig as TConfig
    from tpurt.render import renderer as TR
    from tpurt.scene.presets import default_scene as t_default_scene

    tcfg = TConfig(**KNOBS, mega_body="xla")
    tscene, tcam, _ = t_default_scene(tcfg)
    tplain = np.asarray(TR.render_batch_flat(
        tscene, tcam, tcfg.replace(compaction_threshold=0), 0)[0])
    return tcfg, tscene, tcam, tplain


def _oracle_rows(tscene, tcam, cfg, rows) -> np.ndarray:
    """The scalar oracle's mean radiance of frame-0 pixels ``rows``, each
    built as the loop body of ``oracle.render`` builds it."""
    import oracle

    f = np.float32
    sc = oracle.OracleScene(tscene)
    cam_pos = np.asarray(tcam.position, f)
    pitch, yaw, roll = f(tcam.pitch), f(tcam.yaw), f(tcam.roll)
    fov, aspect = f(tcam.fov_degrees), f(tcam.aspect_ratio)
    out = np.zeros((len(rows), 3), f)
    for i, pixel in enumerate(int(p) for p in rows):
        y, x = divmod(pixel, cfg.width)
        state = oracle.make_seed(pixel, 0, 0)
        u = f(x) / f(cfg.width)
        v = f(1.0) - f(y) / f(cfg.height)
        ro, rd = oracle.make_ray(cam_pos, pitch, yaw, roll, fov, aspect, u, v)
        acc = np.zeros(3, f)
        for _ in range(cfg.rays_per_pixel):
            col, state = oracle.trace(sc, ro, rd, state, cfg.max_bounces)
            acc = (acc + col).astype(f)
        out[i] = (acc / f(cfg.rays_per_pixel)).astype(f)
    return out


def _leaves(state):
    out = []
    R._lane_map(out.append, state)
    return out


@pytest.mark.parametrize("cascade", [False, True], ids=["respread", "cascade"])
def test_staged_batch_equals_plain(monkeypatch, cascade):
    """The respread batch (cascade off) and the cascade batch: the step
    fired, the radiance rows equal the plain schedule's bit for bit, the
    segments within [1, 1.5] of the plain count, and a second batch
    replays the plan, equal."""
    R = _shrink(monkeypatch)
    cfg = QUOTA.replace(mega_cascade=cascade)
    scene, cam = _scene(cfg)
    stats = []
    mean, segs, trips = render_batch_flat(scene, cam, cfg, 0, stage_stats=stats)
    assert trips is None
    step = "cascade" if cascade else "respread"
    assert any(step in s for s in stats), stats
    assert all(set(s) <= {"width", "iters", "active", "fold_to",
                          "pixno_hist", "respread", "cascade", "incomplete",
                          "respread_done", "cascade_done", "uncapped"}
               for s in stats)
    plain, psegs, _ = _plain(scene, cam, cfg)
    assert torch.equal(mean, plain)
    # A respread re-traces each in-flight pixel once (tpurt's bound,
    # tests/test_respread.py); a cascade level restarts its pixels and
    # may hand them on twice more.
    assert psegs <= segs <= (3.0 if cascade else 1.5) * psegs, (segs, psegs)
    again, asegs, _ = render_batch_flat(scene, cam, cfg, 0)
    # A replay at each cascade level, the top one's included.
    assert R._SPEC_STATS == {"replayed": 3 if cascade else 1, "fallback": 0}
    assert torch.equal(again, plain) and asegs == segs


def test_quota1_plan_ends_uncapped(monkeypatch):
    """P = 1: no respread; compaction down the ladder, then the uncapped
    stage; equal to the plain batch, and replayed equal."""
    R = _shrink(monkeypatch)
    cfg = _cfg(rays_per_batch=2048, pixels_per_lane=1, compaction_threshold=128)
    scene, cam = _scene(cfg)
    mean, segs, _ = render_batch_flat(scene, cam, cfg, 0)
    (plan,) = R._SCHED_TRACES.values()
    assert plan and plan[-1][0] == "uncapped", plan
    assert ("compact", 1024) in plan, plan
    plain, psegs, _ = _plain(scene, cam, cfg)
    assert torch.equal(mean, plain) and segs == psegs
    again, _, _ = render_batch_flat(scene, cam, cfg, 0)
    assert R._SPEC_STATS["replayed"] == 1, R._SPEC_STATS
    assert torch.equal(again, plain)


def test_compaction_below_the_stride(monkeypatch):
    """Quota lanes compacted to 64, then 16 of the batch's 256 (the
    ladder overridden, the respread off) resume at the batch's stride:
    their slot tables come from each lane's slot-0 pixel, and the rows
    equal the plain batch's bit for bit."""
    R = _shrink(monkeypatch)
    monkeypatch.setattr(R, "_STAGE_WIDTHS_OVERRIDE", [64, 16])
    cfg = SPEC.replace(mega_tail_respread=False)
    scene, cam = _scene(cfg)
    stats = []
    mean, segs, _ = render_batch_flat(scene, cam, cfg, 0, stage_stats=stats)
    (plan,) = R._SCHED_TRACES.values()
    assert ("compact", 64) in plan and ("compact", 16) in plan, plan
    assert plan[-1] == ("uncapped",), plan
    folds = [s for s in stats if "fold_to" in s]
    assert [s["fold_to"] for s in folds] == [64, 16]
    assert all(sum(s["pixno_hist"]) == s["active"] for s in folds)
    plain, psegs, _ = _plain(scene, cam, cfg)
    assert torch.equal(mean, plain) and segs == psegs


def test_multi_batch_frame(monkeypatch):
    """A frame of three staged batches (the last padded past the frame
    end; cascade levels, then respreads) through render_frame equals the
    plain frame bit for bit."""
    _shrink(monkeypatch)
    cfg = _cfg(width=56, height=24, rays_per_batch=64, pixels_per_lane=8,
               compaction_threshold=64)
    scene, cam = _scene(cfg)
    stats = {}
    staged = render_frame(scene, cam, cfg, stats=stats)
    pstats = {}
    plain = render_frame(scene, cam, cfg.replace(compaction_threshold=0),
                         stats=pstats)
    np.testing.assert_array_equal(staged, plain)
    assert stats["trips"] == 0 and pstats["trips"] > 0
    assert pstats["segments"] <= stats["segments"] <= 3 * pstats["segments"]


def test_staged_tile_and_tiled_frame(monkeypatch):
    """A megakernel tile of 1,024 pixels through the staged driver (the
    ladder, then the uncapped stage) equals the plain tile, and the tiled
    frame (rays_per_batch=0) equals the plain flat frame."""
    R = _shrink(monkeypatch)
    cfg = _cfg(rays_per_pixel=2, compaction_threshold=128, rays_per_batch=0)
    scene, cam = _scene(cfg)
    tile, segs = render_tile_with_stats(scene, cam, cfg, 32, 0, 32, 32)
    (plan,) = R._SCHED_TRACES.values()
    assert plan == [("compact", 1024), ("uncapped",)], plan
    ptile, psegs = render_tile_with_stats(
        scene, cam, cfg.replace(compaction_threshold=0), 32, 0, 32, 32)
    assert torch.equal(tile, ptile) and segs == psegs
    frame = render_frame(scene, cam, cfg)
    flat = render_frame(scene, cam, cfg.replace(rays_per_batch=256,
                                                compaction_threshold=0))
    np.testing.assert_array_equal(frame, flat)


def test_pixlist_staged_matches_flat(monkeypatch):
    """A cascade level over a seeded permutation of 480 of the frame's
    pixels (128 lanes x 4 slots, padded with the last pixel) gives each
    listed pixel its row of the plain flat batch, bit for bit: list
    position j is radiance row j."""
    R = _shrink(monkeypatch)
    cfg = _cfg(rays_per_batch=2048, pixels_per_lane=1, compaction_threshold=0)
    scene, cam = _scene(cfg)
    ref, _, _ = render_batch_flat(scene, cam, cfg, 0)
    pixels = np.random.RandomState(7).permutation(cfg.width * cfg.height)[:480]
    mean, segs = R._render_pixlist_staged(
        scene, cam, cfg, torch.from_numpy(pixels), 128, 4, 0, 0, depth=0)
    assert mean.shape == (512, 3) and int(segs) > 0
    assert torch.equal(mean[:480], ref[torch.from_numpy(pixels)])


def test_guard_failure_falls_back_with_the_entry_state_untouched(monkeypatch):
    """A plan whose compaction cannot hold the live lanes fails its guard:
    the blocking path runs from the entry state, which the failed replay
    left unchanged, gives the same rows and records an honest plan,
    which the next batch replays."""
    R = _shrink(monkeypatch)
    cfg = SPEC
    scene, cam = _scene(cfg)
    first, _, _ = render_batch_flat(scene, cam, cfg, 0)
    (key,) = list(R._SCHED_TRACES)
    honest = R._SCHED_TRACES[key]
    R._SCHED_TRACES[key] = [("compact", 128)]
    replay = R._mega_replay_staged
    seen = []

    def checked(scene, camera, cfg, state, active, *a, **kw):
        before = [t.clone() for t in _leaves(state)]
        out = replay(scene, camera, cfg, state, active, *a, **kw)
        after = _leaves(state)
        seen.append((out, len(after) == len(before) and all(
            torch.equal(x, y) for x, y in zip(before, after))))
        return out

    monkeypatch.setattr(R, "_mega_replay_staged", checked)
    second, _, _ = render_batch_flat(scene, cam, cfg, 0)
    assert R._SPEC_STATS == {"replayed": 0, "fallback": 1}, R._SPEC_STATS
    assert seen == [(None, True)]
    assert torch.equal(first, second)
    assert R._SCHED_TRACES[key] == honest
    third, _, _ = render_batch_flat(scene, cam, cfg, 0)
    assert R._SPEC_STATS == {"replayed": 1, "fallback": 1}, R._SPEC_STATS
    assert torch.equal(first, third)


def test_speculative_off_never_replays(monkeypatch):
    R = _shrink(monkeypatch)
    cfg = SPEC.replace(mega_speculative=False)
    scene, cam = _scene(cfg)
    a, _, _ = render_batch_flat(scene, cam, cfg, 0)
    b, _, _ = render_batch_flat(scene, cam, cfg, 0)
    assert R._SPEC_STATS == {"replayed": 0, "fallback": 0}
    assert torch.equal(a, b)


def test_cascade_against_tpurt(monkeypatch):
    """The cascade batch against tpurt's staged driver on its XLA body,
    both with the shrunken constants: equal plans at every depth, the
    same steps with the same top-level live counts, segments within 0.5%,
    and the radiance rows apart exactly where the two plain schedules
    are apart (ROADMAP C: 18 of 2,048 rows at this config, from the
    fused-multiply-add class; the deeper levels' incomplete counts differ
    by the same class)."""
    from tpurt.render import renderer as TR

    _shrink(monkeypatch)
    _shrink(monkeypatch, TR)
    assert RenderConfig(**KNOBS) == QUOTA
    cfg = RenderConfig(**KNOBS)
    tcfg, tscene, tcam, tplain = _tpurt_quota()
    scene, cam = _scene(cfg)
    tstats, stats = [], []
    tmean, tsegs, _ = TR.render_batch_flat(tscene, tcam, tcfg, 0,
                                           stage_stats=tstats)
    mean, segs, _ = render_batch_flat(scene, cam, cfg, 0, stage_stats=stats)
    plans = lambda traces: sorted((k[-1], v) for k, v in traces.items())
    assert plans(R._SCHED_TRACES) == plans(TR._SCHED_TRACES)
    assert len(plans(R._SCHED_TRACES)) == 3  # two cascade levels, a respread
    assert [sorted(set(s) - {"wall_s"}) for s in stats] == [
        sorted(set(s) - {"wall_s"}) for s in tstats]
    top = lambda s: (s["cascade"], s["incomplete"], s["active"])
    assert top(stats[0]) == top(tstats[0])
    assert abs(segs - float(tsegs)) <= 0.005 * float(tsegs), (segs, tsegs)
    plain = _plain(scene, cam, cfg)[0].numpy()
    apart = (mean.numpy() != np.asarray(tmean)).any(axis=-1)
    assert np.array_equal(apart, (plain != tplain).any(axis=-1))
    assert apart.mean() <= 0.01, apart.mean()


#: Rows where both plain schedules agree with each other and not with the
#: oracle (ROADMAP C.5: the full-frame three-way check).
BOTH_OFF_ORACLE = (1243, 1306, 1356, 1437, 1571, 1937, 1944, 2009, 2027)


def test_plain_rows_against_the_oracle():
    """ROADMAP C.5: the 18 rows where the port's and tpurt's plain
    schedules differ on QUOTA's batch, held against the scalar oracle
    (unfused f32, one pixel at a time) bit for bit. The oracle equals the
    port on at least 15 of them and tpurt on at most 3 (today 15 and 2,
    rows 1514 and 1701; neither on row 1505). On the 9 rows where both
    schedules differ from the oracle alike they equal each other, and on
    30 control rows drawn with a fixed seed from the other rows where
    they agree, all three are equal.

    Why the 18 rows differ, traced lane field by lane field against
    tpurt's state after every trip (P = 1 batch from row 1505):
    - Every lane starts with a primary direction (``rd0``) that make_ray
      rounds differently. In 1514 and 1701 it is the camera-space
      normalize: tpurt's XLA ``rsqrt`` against the port's correctly
      rounded ``1 / sqrt`` (the CUDA kernel's), one ulp apart on 711 of
      the frame's 2,048 rays. In 1505 it is the world-space normalize's
      dot product, which XLA fuses into multiply-adds (384 rays).
    - The ulp carries into each hit point, and turns into a branch on
      the front wall (mesh 2, one-sided, the plane z = 148): a bounce
      restarts at hit + 1e-6 * dir, but 1e-6 is below the ulp at 148
      (1.5e-5). A hit point one ulp short of the plane (147.99998)
      re-hits the wall at t = 1.9e-5 > EPS; one on the plane does not.
      The first fields apart are ``w_valid`` and ``w_mesh``: at trip 4
      in 1514 and trip 25 in 1701 the port's lane re-hits and tpurt's
      does not; at trip 29 in 1505 tpurt's re-hits.
    So the rows fall in the tolerated classes (transcendental/rsqrt
    ulps and fused products, which a knife edge turns into a branch),
    and the port is the nearer of the two to the unfused oracle.

    Why the 9 rows differ from the oracle, traced bounce by bounce (the
    port's lane after every trip, P = 1, against the oracle's hits): in
    each the first sample whose end state differs ends on the same front
    wall, with the directions into it 1-4 ulp from the oracle's. Those
    come from ``random_direction`` (the port, like tpurt, scales by a
    reciprocal square root where the oracle divides, and numpy's f32
    ``log`` and ``cos`` are not correctly rounded: the port draws the
    oracle's direction bit for bit on about 20% of states) and, in 7 of
    the 9, from make_ray's primary direction. In 7 rows the oracle's hit
    lands one ulp short of z = 148 and re-hits the wall; in 1937 and
    2009 the port's does. So only port = tpurt is held on them."""
    _tcfg, tscene, tcam, tplain = _tpurt_quota()
    scene, cam = _scene(QUOTA)
    plain = _plain(scene, cam, QUOTA)[0].numpy()
    apart = (plain != tplain).any(axis=-1)
    rows = np.flatnonzero(apart)
    assert len(rows) == 18 and {1505, 1514, 1701} <= set(rows.tolist())
    both = np.asarray(BOTH_OFF_ORACLE)
    assert not apart[both].any()
    others = np.setdiff1d(np.flatnonzero(~apart), both)
    controls = np.random.RandomState(0).choice(others, 30, replace=False)
    idx = np.concatenate([rows, controls])
    ref = _oracle_rows(tscene, tcam, QUOTA, idx).view(np.int32)
    port_eq = (plain[idx].view(np.int32) == ref).all(axis=-1)
    tpurt_eq = (tplain[idx].view(np.int32) == ref).all(axis=-1)
    n = len(rows)
    assert port_eq[:n].sum() >= 15 and tpurt_eq[:n].sum() <= 3, (
        rows[port_eq[:n]], rows[tpurt_eq[:n]])
    assert port_eq[n:].all() and tpurt_eq[n:].all()


def test_staged_kernel_on_a_cpu_scene_raises(monkeypatch):
    """A staged batch goes through the same backend choice as a plain
    one: the kernel on a CPU scene raises, with no fallback."""
    _shrink(monkeypatch)
    cfg = QUOTA.replace(mega_body="pallas")
    scene, cam = _scene(cfg)
    with pytest.raises(ValueError, match="CUDA device"):
        render_batch_flat(scene, cam, cfg, 0)


def test_unstaged_paths_stay_plain(monkeypatch):
    """tpurt never stages the sharded frame, the viewer's dispatch or a
    cross-frame pack; with the staged driver made to fail, each of them
    still renders at a config that would stage a flat batch."""
    from tpurt_torch.parallel import make_mesh, render_frame_sharded
    from tpurt_torch.viewer import ViewerSession

    _shrink(monkeypatch)

    def refuse(*a, **kw):
        raise AssertionError("the staged driver ran")

    cfg = _cfg(width=32, height=16, rays_per_pixel=2, max_bounces=2,
               rays_per_batch=256, pixels_per_lane=2, compaction_threshold=128)
    scene, cam = _scene(cfg)
    plain = render_frame(scene, cam, cfg.replace(compaction_threshold=0))
    monkeypatch.setattr(R, "_mega_finish_staged", refuse)
    with pytest.raises(AssertionError, match="staged driver ran"):
        render_frame(scene, cam, cfg)
    mesh = make_mesh(2, devices=[torch.device("cpu")] * 2)
    np.testing.assert_array_equal(
        render_frame_sharded(scene, cam, cfg, mesh=mesh), plain)
    tiled = cfg.replace(rays_per_batch=0, tile_size=16)
    np.testing.assert_array_equal(
        render_frame_sharded(scene, cam, tiled, mesh=mesh), plain)
    assert ViewerSession(scene, cfg)._dispatch_pass(0) is None
    with pytest.raises(ValueError, match="plain flat schedule"):
        render_batch_flat_frames(scene, (cam, cam), cfg, 0)
