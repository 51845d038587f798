"""Whole runs of the harness on the CPU, at a tiny size: a dummy cell is
added as data only (a configuration, a traffic mix, a limit and entries
of BENCHMARK.json, in a copy of the tree), the harness finds it by name,
runs it through the program's plain versions, and prints the result
line. The look for a card is skipped (``runner.run`` is called with the
CPU); everything after it is the run's own path.

With the timed path broken underneath, ``correct`` comes out false, once
for each fault a cell of this benchmark can have: a step that returns
its state unchanged (every frame rendered at one frame index), half of
the batch left out, and an answer altered where it is produced. The
exchange between chips does not exist on one chip."""

import io
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from yardstick import runner  # noqa: E402

REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}
TINY_MESH = {"kind": "torus_knot", "segments": 12, "sides": 4, "radius": 80.0,
             "tube": 22.0, "triangles": 96}
STREAM = {"kind": "stream", "width": 16, "height": 8, "spp": 2, "bounces": 5,
          "frames_per_pack": 2,
          "render": {"pixels_per_lane": 2, "mega_tail_passes": 2,
                     "compaction_threshold": 0, "mega_frames_per_batch": 2,
                     "rays_per_batch": 64},
          "warmup": 1, "profile": {"skip": 0, "seconds": 0.01, "min_requests": 1},
          "check": {"frames": 2, "pixels": 64}}
STILLS = {"kind": "stills", "width": 16, "height": 8, "spp": 2, "bounces": 5,
          "render": {"pixels_per_lane": 2, "mega_tail_passes": 2,
                     "compaction_threshold": 32, "mega_frames_per_batch": 1,
                     "rays_per_batch": 64},
          "camera": {"yaw_step_turns": 0.01, "yaw_cycle": 8},
          "warmup": 1, "profile": {"skip": 0, "seconds": 0.01, "min_requests": 1},
          "check": {"frames": 2, "pixels": 64}}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A copy of the benchmark with a dummy configuration and two dummy
    cells added as files and entries; no file of the copy is edited
    except BENCHMARK.json, to which entries are added."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "*.obj.gz"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(BENCH, "configs", "teapot-cornell.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny-knot", mesh=TINY_MESH,
               render={"seed_mode": "reference", "mega_dense": False})
    (root / "benchmark" / "configs" / "tiny-knot.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny-knot", "source": "https://example.org",
                             "file": "benchmark/configs/tiny-knot.json",
                             "reduced": [], "why": "test"})
    for name, traffic in (("tiny-stream", STREAM), ("tiny-stills", STILLS)):
        (root / "benchmark" / "traffic" / f"{name}.json").write_text(
            json.dumps(traffic))
        (root / "benchmark" / "limits" / f"{name}.json").write_text(
            json.dumps({"limits": {"px_diff_pct": 1.0}}))
        bench["workloads"].append({"name": name, "config": "tiny-knot",
                                   "traffic": name, "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("tiny-stream")
        if m["name"].startswith("still_ms"):
            m["workloads"].append("tiny-stills")
    for m in bench["per_layer"]:
        sfx = m["name"].rsplit(".", 1)[-1]
        m["workloads"] += {"stream": ["tiny-stream"], "stills": ["tiny-stills"]
                           }.get(sfx, ["tiny-stream", "tiny-stills"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def run(tree, cell, trace=False, seed=4294967311 + 17):
    out = io.StringIO()
    rc = runner.run(tree, os.path.join(tree, "benchmark"), cell, seed, 0.5,
                    trace, "cpu", runner.process_start(), out=out)
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-1])


@pytest.mark.parametrize("cell", ["tiny-stream", "tiny-stills"])
def test_a_dummy_cell_prints_the_result_line(tree, cell):
    res = run(tree, cell)
    assert REQUIRED <= set(res) and set(res) - REQUIRED == {"check"}
    assert list(res)[-1] == "check"
    assert res["correct"] is True
    assert res["check"]["px_diff_pct"]["limit"] == 1.0
    assert "setup_s" in res["metrics"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])


def test_the_traced_run_prints_per_layer_metrics(tree):
    res = run(tree, "tiny-stream", trace=True)
    assert set(res) - REQUIRED <= {"check", "breakdown"}
    assert list(res)[-1] == "check"
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert "launches_per_frame.stream" in res["metrics"]
    assert "setup_s" not in res["metrics"]
    assert res["correct"] is True


def _stale(monkeypatch):
    from tpurt_torch.render import renderer

    inner = renderer.render_batch_flat_frames
    monkeypatch.setattr(renderer, "render_batch_flat_frames",
                        lambda s, c, cfg, start, frame_index=0, sample_offset=0:
                        inner(s, c, cfg, start, 0, sample_offset))


def _half(monkeypatch):
    from tpurt_torch.render import renderer

    inner = renderer.render_batch_flat_frames

    def half(*a, **k):
        m, s, t = inner(*a, **k)
        m = m.clone()
        m[m.shape[0] // 2:] = 0.0
        return m, s, t

    monkeypatch.setattr(renderer, "render_batch_flat_frames", half)


def _altered(monkeypatch):
    from tpurt_torch.render import tonemap as tm

    inner = tm.tonemap
    monkeypatch.setattr(tm, "tonemap", lambda x: inner(x) ^ 1)


@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["state-unchanged", "half-left-out",
                              "answer-altered"])
def test_a_broken_timed_path_is_not_correct(tree, monkeypatch, fault):
    fault(monkeypatch)
    res = run(tree, "tiny-stream")
    assert res["correct"] is False
    assert res["check"]["px_diff_pct"]["value"] > 1.0


def test_an_altered_still_is_not_correct(tree, monkeypatch):
    from tpurt_torch.render import renderer

    inner = renderer.render_image
    monkeypatch.setattr(renderer, "render_image",
                        lambda *a, **k: inner(*a, **k) ^ 1)
    res = run(tree, "tiny-stills")
    assert res["correct"] is False
