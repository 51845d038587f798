"""tpurt_torch's autotuner on the CPU (mirroring tests/test_autotune.py):
the sweep's plumbing at tpurt's test config — the chosen values are
meaningless off the card, only the machinery is under test — its cache,
``apply`` and the CLI's ``--tuned``, and the host-side refusal of bank
shapes the kernel cannot take. Frames and segment counts are compared
exactly (same code, same inputs)."""

import json

import numpy as np
import pytest

import tpurt_torch.config as _c
from tpurt_torch import autotune, bench, cli
from tpurt_torch.config import RenderConfig
from tpurt_torch.io import read_bmp
from tpurt_torch.render import mega_cuda
from tpurt_torch.render import megakernel as mk
from tpurt_torch.render import renderer
from tpurt_torch.render.renderer import flat_batch_args, render_frame, render_image
from tpurt_torch.scene.presets import bench_scene, default_scene

# tests/test_autotune.py's config.
CFG = RenderConfig(width=32, height=16, rays_per_pixel=1, max_bounces=2,
                   rays_per_batch=256, pixels_per_lane=2,
                   compaction_threshold=0)


@pytest.fixture(autouse=True)
def restore_freeze_globals(monkeypatch, tmp_path):
    """Every global apply() sets goes back to the shipped value after the
    test; the cache lives in the test's directory."""
    for name in ("MEGA_BF16_BOUNDS", "MEGA_LEAF_TRIS", "MEGA_NODE_ARITY"):
        monkeypatch.setattr(_c, name, getattr(_c, name))
    monkeypatch.setenv("TPURT_TUNE_DIR", str(tmp_path))


def test_autotune_sweep_and_cache(monkeypatch):
    # Two-value axes keep the CPU sweep short. node_arity exercises the
    # freeze-time rebuild path.
    monkeypatch.setattr(autotune, "AXES", (
        ("node_arity", (8, 4)),
        ("mega_tail_passes", (1, 2)),
        ("pixels_per_lane", (2, 1)),
    ))
    legs = []
    time_leg = autotune._time_leg

    def recording(scene, cam, cfg, **kw):
        r = time_leg(scene, cam, cfg, **kw)
        legs.append((scene, cam, cfg, r))
        return r

    monkeypatch.setattr(autotune, "_time_leg", recording)
    knobs = autotune.sweep(CFG, scene_kind="sphere", log=lambda *a: None,
                           device="cpu")
    assert np.isfinite(knobs["seconds_per_frame"])
    assert knobs["mega_tail_passes"] in (1, 2)
    assert knobs["node_arity"] in (4, 8)
    assert knobs["pixels_per_lane"] in (1, 2)
    assert len(legs) == 4  # the baseline and one trial an axis
    # Globals restored to the WINNING set (not a losing trial's value).
    assert _c.MEGA_NODE_ARITY == knobs["node_arity"]
    assert _c.MEGA_LEAF_TRIS == knobs["leaf_tris"]
    assert _c.MEGA_BF16_BOUNDS == (knobs["bounds_fmt"] == "bf16")

    # A re-frozen leg renders its own bank: the same rows and, frame by
    # frame, the same segments as a fresh freeze of that shape.
    arities = set()
    for scene, cam, cfg, r in legs:
        if scene.mega_arity in arities:
            continue
        arities.add(scene.mega_arity)
        monkeypatch.setattr(_c, "MEGA_NODE_ARITY", scene.mega_arity)
        fresh, fcam = bench_scene("sphere", cfg, device="cpu")
        assert np.array_equal(fresh.mega_rows.numpy().view(np.uint32),
                              scene.mega_rows.numpy().view(np.uint32))
        segs = 0
        for f in range(r["frames"]):
            stats = {}
            render_frame(fresh, fcam, cfg, frame_index=f, stats=stats)
            segs += stats["segments"]
        assert segs == r["segments"] * r["frames"]
    assert arities == {4, 8}

    # Cache round-trip and apply(); tpurt's TPU-only keys are ignored.
    path = autotune.save_tuned(knobs, "cpu")
    assert path == autotune.cache_path("cpu")
    assert path.endswith("tpurt_torch_tune_cpu.json")
    loaded = autotune.load_tuned("cpu")
    assert loaded == knobs
    tpu_keys = {"mega_interleave": 8, "block_lanes": 2048, "mat_prune": False}
    cfg2 = autotune.apply(dict(loaded, **tpu_keys), CFG)
    assert cfg2 == CFG.replace(mega_tail_passes=knobs["mega_tail_passes"],
                               pixels_per_lane=knobs["pixels_per_lane"])
    assert not hasattr(_c, "MEGA_BLOCK_LANES") and not hasattr(_c, "MEGA_MAT_PRUNE")
    assert autotune.load_tuned("no_such_card") is None


def test_time_leg_packs_frames(monkeypatch):
    """The seed config's two frames a launch go through
    render_batch_flat_frames as one pack (twice in the warm-up, then the
    block), with the unpacked frames' segments; single frames (the
    warm-up's two, the latency frame, an unpacked block) through
    render_batch_flat."""
    scene, cam = bench_scene("sphere", CFG, device="cpu")
    packs, singles = [], []
    batch_frames = renderer.render_batch_flat_frames
    batch = renderer.render_batch_flat

    def counting(scene, cameras, cfg, start, **kw):
        packs.append(len(cameras))
        return batch_frames(scene, cameras, cfg, start, **kw)

    def counting_single(*a, **kw):
        singles.append(1)
        return batch(*a, **kw)

    monkeypatch.setattr(renderer, "render_batch_flat_frames", counting)
    monkeypatch.setattr(renderer, "render_batch_flat", counting_single)
    packed = autotune._time_leg(scene, cam, CFG.replace(mega_frames_per_batch=2),
                                frames=2)
    assert packs == [2, 2, 2] and len(singles) == 3
    assert packed["frames"] == 2
    single = autotune._time_leg(scene, cam, CFG, frames=2)
    assert packs == [2, 2, 2] and len(singles) == 3 + 5
    assert packed["segments"] == single["segments"] > 0


@pytest.mark.parametrize("pack", [1, 2])
def test_time_leg_is_the_bench_timer(pack):
    """A leg is bench.time_render_flat's block: the same frames and
    segments for one config."""
    cfg = CFG.replace(mega_frames_per_batch=pack)
    scene, cam = bench_scene("sphere", cfg, device="cpu")
    leg = autotune._time_leg(scene, cam, cfg, frames=2)
    r = bench.time_render_flat(scene, cam, cfg, repeats=1, max_frames=2)
    assert set(leg) == {"seconds", "segments", "frames"}
    assert (leg["frames"], leg["segments"]) == (r["frames"], r["segments"])


def test_refused_leg_is_recorded_and_skipped(monkeypatch):
    """A bank the kernel cannot take (arity 64: six slot bits) is refused
    on the host, logged as failed, and the descent goes on."""
    monkeypatch.setattr(autotune, "AXES", (("node_arity", (64, 8)),))
    lines = []
    knobs = autotune.sweep(CFG, scene_kind="sphere", log=lines.append,
                           device="cpu")
    assert knobs["node_arity"] == 8 and _c.MEGA_NODE_ARITY == 8
    assert any("node_arity=64 failed" in ln and "2 to 63" in ln for ln in lines)


def test_check_bank_refuses_before_launch():
    scene, cam, _ = default_scene(CFG.replace(object_path="sphere0.obj"),
                                  device="cpu")
    ctx = mk.prepare(scene, **flat_batch_args(scene, cam, CFG, 0))
    mega_cuda.check_bank(ctx)
    with pytest.raises(ValueError, match="2 to 63 children"):
        mega_cuda.check_bank(ctx._replace(arity=64))
    # The dense sweep has no deep-stack instantiation.
    dense = ctx._replace(tables=ctx.tables._replace(dense=object()),
                         s_depth=mega_cuda.MAX_SHARED_STACK + 2)
    with pytest.raises(ValueError, match="deep-stack"):
        mega_cuda.check_bank(dense)
    mega_cuda.check_bank(ctx._replace(s_depth=mega_cuda.MAX_SHARED_STACK + 2))


def _preset(name):
    """(scene, camera, config) of a preset that chip_smoke.py drives on
    the card, frozen on the CPU at a small frame size."""
    from tpurt_torch.core.camera import Camera
    from tpurt_torch.scene.presets import (cornell_sphere_scene, deep_stack_scene,
                                           grid_scene)

    cfg = CFG.replace(width=16, height=8)
    if name == "cornell":
        scene, cam, _ = cornell_sphere_scene(2, cfg, device="cpu")
    elif name in ("bunny", "teapot"):
        cfg = cfg.replace(mega_dense=name == "teapot")
        scene, cam = bench_scene(name, cfg, device="cpu")
    elif name == "grid-64":
        scene = grid_scene(64, subdivisions=1, device="cpu")
        cam = Camera.create(position=(0.0, 150.0, 380.0), pitch=-0.1, yaw=np.pi,
                            fov_degrees=90.0, aspect_ratio=2.0, device="cpu")
    else:
        scene, cam = deep_stack_scene(cfg, device="cpu")
    return scene, cam, cfg


@pytest.mark.parametrize("name, words, shared", [
    ("cornell", 12, True), ("bunny", 22, True), ("teapot", 16, True),
    ("grid-64", 16, True), ("deep-stack", 72, False)])
def test_stack_placement_rule(name, words, shared):
    """Where B1 keeps each preset's traversal stacks: a budget up to
    MAX_SHARED_STACK words is a ring in the block's dynamic shared memory
    (s_depth words a thread, in the BVH and the dense instantiations);
    a deeper one is the kDeep instantiation's global scratch, with no
    shared memory for it."""
    scene, cam, cfg = _preset(name)
    ctx = mk.prepare(scene, **flat_batch_args(scene, cam, cfg, 0))
    assert ctx.s_depth == words == 2 * scene.mega_stack_depth
    assert (ctx.tables.dense is not None) == (name == "teapot")
    assert (words <= mega_cuda.MAX_SHARED_STACK) == shared
    assert mega_cuda.deep_stack(ctx) == (not shared)
    for threads in (128, 256):
        assert mega_cuda.shared_stack_bytes(ctx, threads) == (
            4 * words * threads if shared else 0)
    mega_cuda.check_bank(ctx)
    # The threshold itself: 64 words still fit, 65 take the kDeep scratch
    # (a dense context has no kDeep instantiation and is refused instead).
    at = ctx._replace(s_depth=mega_cuda.MAX_SHARED_STACK)
    past = ctx._replace(s_depth=mega_cuda.MAX_SHARED_STACK + 1)
    assert mega_cuda.MAX_SHARED_STACK == 64 and not mega_cuda.deep_stack(at)
    assert mega_cuda.shared_stack_bytes(at, 128) == 4 * 64 * 128
    if ctx.tables.dense is None:
        assert mega_cuda.deep_stack(past) and mega_cuda.shared_stack_bytes(past, 128) == 0
    else:
        with pytest.raises(ValueError, match="deep-stack"):
            mega_cuda.check_bank(past)


def test_main_cpu_writes_the_cpu_cache(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(autotune, "AXES", (("mega_tail_passes", (1, 2)),))
    assert autotune.main(["--cpu", "--quick"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-2])
    assert out["platform"] == "cpu"
    assert lines[-1] == f"cached -> {tmp_path / 'tpurt_torch_tune_cpu.json'}"
    assert autotune.load_tuned("cpu") == out["knobs"]


TINY = ["--cpu", "--width", "16", "--height", "16", "--rays-per-pixel", "2",
        "--max-bounces", "2", "--object-path", "sphere0.obj"]


def test_cli_tuned_without_a_cache(tmp_path, capsys):
    out = str(tmp_path / "o.bmp")
    assert cli.main(TINY + ["--tuned", "--output", out]) == 0
    assert ("no autotune cache for this platform; run `python -m "
            "tpurt_torch.autotune` (using defaults)") in capsys.readouterr().out
    cfg = RenderConfig(width=16, height=16, rays_per_pixel=2, max_bounces=2,
                       object_path="sphere0.obj")
    scene, cam, _ = default_scene(cfg, device="cpu")
    np.testing.assert_array_equal(read_bmp(out), render_image(scene, cam, cfg))


def test_cli_tuned_applies_the_cache(tmp_path, capsys):
    knobs = {"mega_tail_passes": 2, "pixels_per_lane": 2, "bounds_fmt": "u8",
             "leaf_tris": 3, "node_arity": 4, "mega_interleave": 8,
             "seconds_per_frame": 0.5}
    autotune.save_tuned(knobs, "cpu")
    out = str(tmp_path / "o.bmp")
    assert cli.main(TINY + ["--tuned", "--output", out]) == 0
    assert f"Tuned knobs ({autotune.cache_path('cpu')})" in capsys.readouterr().out
    assert _c.MEGA_NODE_ARITY == 4
    cfg = RenderConfig(width=16, height=16, rays_per_pixel=2, max_bounces=2,
                       object_path="sphere0.obj", pixels_per_lane=2,
                       mega_tail_passes=2)
    scene, cam, _ = default_scene(cfg, device="cpu")
    assert scene.mega_arity == 4
    np.testing.assert_array_equal(read_bmp(out), render_image(scene, cam, cfg))
