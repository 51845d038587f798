"""tpurt_torch's bench harness on the CPU against tpurt's bench.py itself
(imported from the repository root, as tests/test_parallel.py does), on
the same scene and config: the sphere row's scene at 32x16, 2 spp, 2
bounces, a quota of 2 pixels a lane, 256 lanes a launch.

* ``time_render_flat`` unpacked, packed two frames a launch, and
  sample-flattened with decorrelated seeds: equal frames and loop trips
  ("iters"; the port's trips are tpurt's iterations), segments within
  0.5% (the 1-ulp knife-edge class of tests/test_torch_quota.py: XLA's
  CPU backend fuses multiply-adds the port rounds twice).
* ``time_render_tiles`` through the modular engine, ``run_config_anim``
  at 2 frames (``avg_path``) and ``run_config`` (tpurt's result keys, plus
  the port's ``launches`` on a flat row), also through tpurt's staged
  schedule (more than one launch a frame).
* ``run_sharding_efficiency``'s measuring branch on one CPU in three
  positions (tests/test_parallel.py::test_sharding_efficiency_branch_runs).
* ``main``: the ladder's rows, names, configs and order equal tpurt's
  (both mains run with their row functions recorded, not timed); the two
  JSON lines carry metric, value, unit and device and no TPU baseline;
  the history lands at ``--history`` and BENCH_history.jsonl (tpurt's
  rounds) is untouched.
"""

import functools
import hashlib
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from tpurt.config import RenderConfig as TConfig
from tpurt_torch import bench
from tpurt_torch import config as p_config
from tpurt_torch.config import RenderConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench as t_bench  # noqa: E402  (tpurt's, at the repository root)

KNOBS = dict(width=32, height=16, rays_per_pixel=2, max_bounces=2,
             rays_per_batch=256, pixels_per_lane=2, compaction_threshold=0,
             seed_mode="reference", tile_size=16)
CASES = {
    "unpacked": {},
    "packed": {"mega_frames_per_batch": 2},
    "sample_flatten": {"sample_flatten": True, "seed_mode": "decorrelated"},
}
SEG_TOL = 0.005


def configs(**over):
    return TConfig(**{**KNOBS, **over}), RenderConfig(**{**KNOBS, **over})


@functools.lru_cache(maxsize=None)
def scenes():
    """(tpurt scene, camera), (port scene, camera) of the sphere row."""
    tcfg, cfg = configs()
    return t_bench.build_scene("sphere", tcfg), bench.build_scene("sphere", cfg,
                                                                  "cpu")


def assert_segments_close(mine, theirs):
    assert abs(mine - theirs) <= SEG_TOL * theirs, (mine, theirs)


@pytest.mark.parametrize("case", list(CASES))
def test_time_render_flat_matches_tpurt(case):
    tcfg, cfg = configs(**CASES[case])
    (tscene, tcam), (scene, cam) = scenes()
    theirs = t_bench.time_render_flat(tscene, tcam, tcfg, repeats=1, max_frames=2)
    mine = bench.time_render_flat(scene, cam, cfg, repeats=1, max_frames=2)
    assert mine["frames"] == theirs["frames"] == 2
    assert mine["iters"] == theirs["iters"] > 0
    assert_segments_close(mine["segments"], theirs["segments"])
    assert mine["launches"] == {"unpacked": 1, "packed": 0.5,
                                "sample_flatten": 2}[case]
    for k in ("seconds", "latency_s", "d2h_s"):
        assert np.isfinite(mine[k]) and mine[k] > 0


def test_time_render_tiles_matches_tpurt():
    tcfg, cfg = configs(engine="modular")
    (tscene, tcam), (scene, cam) = scenes()
    _dt, theirs, _ = t_bench.time_render_tiles(tscene, tcam, tcfg, repeats=1)
    dt, mine, iters = bench.time_render_tiles(scene, cam, cfg, repeats=1)
    assert dt > 0 and iters == 0
    assert_segments_close(mine, theirs)


def test_run_config_anim_matches_tpurt():
    tcfg, cfg = configs()
    theirs = t_bench.run_config_anim("anim", "sphere", tcfg, frames=2)
    mine = bench.run_config_anim("anim", "sphere", cfg, frames=2, device="cpu")
    assert set(mine) == set(theirs) | {"launches"}
    assert mine["launches"] == 1
    assert abs(mine["avg_path"] - theirs["avg_path"]) <= SEG_TOL * theirs["avg_path"]


@pytest.mark.parametrize("engine", ["mega", "modular"])
def test_run_config_returns_tpurts_keys(engine):
    tcfg, cfg = configs(engine=engine)
    theirs = t_bench.run_config("row", "sphere", tcfg, repeats=1)
    mine = bench.run_config("row", "sphere", cfg, repeats=1, device="cpu")
    extra = {"launches"} if engine == "mega" else set()
    assert set(mine) == set(theirs) | extra
    assert mine["name"] == "row"
    assert_segments_close(mine["avg_path"], theirs["avg_path"])
    assert mine["mrays"] == pytest.approx(
        mine["avg_path"] * 32 * 16 * 2 / mine["seconds"] / 1e6)


def test_run_config_names_the_plain_schedule(monkeypatch):
    """A config for which tpurt runs its staged schedule runs it here too
    (the name is from when the port ran such a row plain): with tpurt's
    test stage constants in both renderers, so that the batch outlives
    its first stage, the row has tpurt's keys (no trips: staged batches
    report none) plus ``launches``, counts more than one launch a frame,
    and its segments agree with tpurt's staged row within 0.5%."""
    from tpurt.render import renderer as t_renderer
    from tpurt_torch.render import renderer

    for module in (t_renderer, renderer):
        monkeypatch.setattr(module, "_MEGA_STAGE_ITERS", 48)
        monkeypatch.setattr(module, "_CASCADE_STAGE0", 24)
        monkeypatch.setattr(module, "_SCHED_TRACES", {})
        monkeypatch.setattr(module, "_SPEC_STATS",
                            {"replayed": 0, "fallback": 0})
    # The same two frames in both blocks (a block's length follows its
    # latency), so that their segments a frame are comparable.
    for module in (t_bench, bench):
        monkeypatch.setattr(module, "time_render_flat", functools.partial(
            module.time_render_flat, max_frames=2))
    tcfg, cfg = configs(compaction_threshold=256)
    theirs = t_bench.run_config("staged", "sphere", tcfg, repeats=1)
    row = bench.run_config("staged", "sphere", cfg, repeats=1, device="cpu")
    assert set(row) == set(theirs) | {"launches"} and "schedule" not in row
    assert row["frames"] == theirs["frames"] == 2 and row["launches"] > 1, row
    assert renderer._SPEC_STATS["replayed"] > 0, renderer._SPEC_STATS
    assert_segments_close(row["avg_path"], theirs["avg_path"])


def test_sharding_efficiency_branch_runs():
    _tcfg, cfg = configs()
    cpu = torch.device("cpu")
    row = bench.run_sharding_efficiency(cfg, repeats=1, force=True,
                                        scene_kind="sphere", devices=[cpu] * 3)
    assert row["devices"] == 3
    assert np.isfinite(row["efficiency"]) and row["efficiency"] > 0
    unforced = bench.run_sharding_efficiency(cfg, scene_kind="sphere",
                                             devices=[cpu] * 3)
    assert unforced == {"name": "sharding-efficiency", "devices": 1,
                        "efficiency": None}


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class Rows:
    """Stands in for a bench module's row functions: records each call
    and returns a row without rendering."""

    def __init__(self, mrays):
        self.calls, self.mrays = [], mrays

    def _row(self, fn, name, kind, cfg, **kw):
        self.calls.append((fn, name, kind, p_config.tpurt_knobs(cfg), kw))
        return {"name": name, "seconds": 1.0, "mrays": self.mrays.get(name, 1.0)}

    def run_config(self, name, scene_kind, cfg, repeats=2, strict=False, **_):
        return self._row("config", name, scene_kind, cfg, strict=strict)

    def run_config_anim(self, name, scene_kind, cfg, frames=4, **_):
        return self._row("anim", name, scene_kind, cfg, frames=frames)

    def run_sharding_efficiency(self, cfg, repeats=2, force=False,
                                scene_kind="bunny", **_):
        self.calls.append(("sharding", scene_kind, p_config.tpurt_knobs(cfg),
                           force))
        return {"name": "sharding-efficiency", "devices": 1, "efficiency": None}


def _patch_rows(monkeypatch, module, rows):
    for fn in ("run_config", "run_config_anim", "run_sharding_efficiency"):
        monkeypatch.setattr(module, fn, getattr(rows, fn))


@pytest.mark.parametrize("argv", [["--ladder"], ["--force-cpu-mesh"],
                                  ["--spp", "4", "--tile-size", "128",
                                   "--strict"]])
def test_ladder_rows_match_tpurt(monkeypatch, capsys, argv):
    theirs, mine = Rows({}), Rows({})
    _patch_rows(monkeypatch, t_bench, theirs)
    monkeypatch.setattr(t_bench, "record_history", lambda entry: None)
    monkeypatch.setattr(jax.config, "update", lambda *a: None)  # no cache dir
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    monkeypatch.setattr(sys, "argv", ["bench.py"] + argv)
    t_bench.main()
    _patch_rows(monkeypatch, bench, mine)
    assert bench.main(argv + ["--cpu", "--no-history"]) == 0
    assert mine.calls == theirs.calls
    names = [c[1] for c in mine.calls if c[0] != "sharding"]
    assert names[-2:] == ["bunny-1080p-plain", "bunny-1080p-bvh"]
    if argv == ["--ladder"]:
        assert names[:-2] == ["parity-640x480-1spp", "teapot-720p-bruteforce",
                              "teapot-720p-mega", "cornell-256spp-1080p",
                              "4k-anim-sweep", "knot-1080p-plain"]
    capsys.readouterr()


def test_main_json_lines_and_history(monkeypatch, capsys, tmp_path):
    tpurt_history = os.path.join(ROOT, "BENCH_history.jsonl")
    before = _sha(tpurt_history)
    rows = Rows({"bunny-1080p-plain": 300.0, "bunny-1080p-bvh": 310.125})
    _patch_rows(monkeypatch, bench, rows)
    path = tmp_path / "hist.jsonl"
    assert bench.main(["--cpu", "--history", str(path)]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines == [
        {"metric": "Mrays/sec/chip bunny-class 1080p BVH path trace",
         "value": 300.0, "unit": "Mrays/s", "device": "cpu",
         "provisional": True},
        {"metric": "Mrays/sec/chip bunny-class 1080p BVH path trace",
         "value": 310.12, "unit": "Mrays/s", "device": "cpu"},
    ]
    with open(path) as f:
        hist = [json.loads(s) for s in f]
    assert [h["name"] for h in hist] == ["bunny-1080p-plain", "bunny-1080p-bvh"]
    assert all(h["platform"] == "cpu" and h["device"] == "cpu" for h in hist)
    bench.record_history({"name": "extra"}, str(path))
    with open(path) as f:
        assert json.loads(f.readlines()[-1]) == {"name": "extra"}
    assert bench.main(["--cpu", "--no-history"]) == 0
    assert len(path.read_text().splitlines()) == 3
    assert _sha(tpurt_history) == before


def test_main_without_a_card_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main(["--no-history"])


def test_main_tuned_applies_the_cache(monkeypatch, capsys, tmp_path):
    """--tuned reads this device's autotune cache through autotune.apply:
    the RenderConfig knobs feed every row, the freeze globals are set."""
    import tpurt_torch.config as _c
    from tpurt_torch import autotune

    monkeypatch.setattr(_c, "MEGA_NODE_ARITY", _c.MEGA_NODE_ARITY)
    monkeypatch.setenv("TPURT_TUNE_DIR", str(tmp_path))
    autotune.save_tuned({"mega_tail_passes": 3, "pixels_per_lane": 16,
                         "node_arity": 16, "mega_interleave": 8}, "cpu")
    rows = Rows({})
    _patch_rows(monkeypatch, bench, rows)
    assert bench.main(["--cpu", "--tuned", "--no-history"]) == 0
    assert _c.MEGA_NODE_ARITY == 16
    cfgs = [c[3] for c in rows.calls]
    assert [(c["mega_tail_passes"], c["pixels_per_lane"]) for c in cfgs] == [
        (3, 16), (3, 16)]
    assert "tuned knobs" in capsys.readouterr().err
