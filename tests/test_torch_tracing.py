"""The spans and counters of tpurt_torch/utils/profiling.py on the frame
path, on the CPU through the plain version, and on the card.

With no profiler the traced view stays empty, and a flat batch, a packed
pack and a staged batch give the same bits with tracing on and off.
Under ``device_trace`` the Chrome trace nests the program's spans
(``tpurt.batch`` > ``tpurt.prepare`` > ``tpurt.prepare.scene``,
``tpurt.launch`` > ``tpurt.launch.call``) with their ids as args; self
time never exceeds total time, nor children's totals their parent's;
identical batches add identical ``host_syncs``; each staged step is one
``tpurt.stage`` span, and ``stage_stats`` holds no host clock.
``idle_by_span`` is held against a hand-built trace, and the CLI's
``--trace-dir`` writes a trace and its summary.

On the card (marked ``cuda``, skips without one): every megakernel
launch lies inside a ``tpurt.launch.call`` span, and the device-to-host
copies launched inside ``tpurt.image`` / ``tpurt.batch`` spans number
exactly the ``host_syncs`` counted, so every read goes through
``host_read``; fresh lanes are written by the ``fresh_lanes`` kernel
inside ``tpurt.prepare.lanes``, and a launch from them packs nothing;
every launch's tables are made inside ``tpurt.prepare``, none inside
``tpurt.launch``.
On the GPU machine:

    python -m pytest tests/test_torch_tracing.py -q --noconftest
"""

import functools
import threading
import time

import pytest
import torch

from tpurt_torch import cli
from tpurt_torch.config import RenderConfig
from tpurt_torch.render import renderer as R
from tpurt_torch.render.renderer import (
    render_batch_flat, render_batch_flat_frames, render_image)
from tpurt_torch.scene.presets import default_scene
from tpurt_torch.utils import profiling as P

#: Small, since the profiler records every torch operation of the plain
#: version: a 32x16 frame in two batches of 64 lanes x 4 pixels.
FLAT = RenderConfig(width=32, height=16, rays_per_pixel=1, max_bounces=2,
                    object_path="sphere1.obj", rays_per_batch=64,
                    pixels_per_lane=4, compaction_threshold=0)
#: A P = 1 staged batch: capped stages, compactions, the uncapped stage
#: (with its constants in STAGED).
STAGED_P1 = FLAT.replace(max_bounces=3, rays_per_batch=512, pixels_per_lane=1,
                         compaction_threshold=128)
#: A quota staged batch whose survivors respread.
STAGED_QUOTA = FLAT.replace(rays_per_pixel=2, rays_per_batch=128,
                            compaction_threshold=128, mega_cascade=False)
STAGED = {"p1": (STAGED_P1, dict(_MEGA_STAGE_ITERS=2,
                                 _STAGE_WIDTHS_OVERRIDE=[500, 256, 32])),
          "quota": (STAGED_QUOTA, dict(_MEGA_STAGE_ITERS=4))}


@functools.lru_cache(maxsize=None)
def _scene(cfg):
    scene, cam, _ = default_scene(cfg, device="cpu")
    return scene, cam


def _staged_constants(monkeypatch, kind):
    cfg, consts = STAGED[kind]
    for name, value in consts.items():
        monkeypatch.setattr(R, name, value)
    monkeypatch.setattr(R, "_SCHED_TRACES", {})
    monkeypatch.setattr(R, "_RETIRE_CURVES", {})
    monkeypatch.setattr(R, "_SPEC_STATS", {"replayed": 0, "fallback": 0})
    return cfg


def _events(log_dir):
    return [e for e in P.trace_events(str(log_dir))
            if e.get("ph") == "X" and "dur" in e]


def _spans(events, name):
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") == name]


def _inside(inner, outer) -> bool:
    a, b = float(inner["ts"]), float(inner["ts"]) + float(inner["dur"])
    c, d = float(outer["ts"]), float(outer["ts"]) + float(outer["dur"])
    return c <= a and b <= d


# -- the registry ---------------------------------------------------------------


def test_span_count_report_and_threads():
    """Self = total less the children, per thread; counters add; the
    report names both; reset empties them."""
    P.reset()
    with P.span("tpurt.t.outer", frame=1):
        time.sleep(0.01)
        with P.span("tpurt.t.inner"):
            time.sleep(0.01)
    P.count("tpurt.t.n", 2)
    P.count("tpurt.t.n")

    def other():
        with P.span("tpurt.t.thread"):
            time.sleep(0.005)

    with P.span("tpurt.t.main"):
        th = threading.Thread(target=other)
        th.start()
        th.join()
    tot = P.totals()
    outer, inner = tot["spans"]["tpurt.t.outer"], tot["spans"]["tpurt.t.inner"]
    assert outer["calls"] == inner["calls"] == 1
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inner["total_s"])
    assert inner["self_s"] == inner["total_s"] >= 0.01
    # A span on another thread is not the main span's child.
    main = tot["spans"]["tpurt.t.main"]
    assert main["self_s"] == main["total_s"]
    assert tot["counts"] == {"tpurt.t.n": 3}
    assert P.totals(traced=True) == {"spans": {}, "counts": {}}
    text = P.report()
    assert "tpurt.t.outer" in text and "tpurt.t.n" in text
    P.reset()
    assert P.totals() == {"spans": {}, "counts": {}}


def test_idle_by_span_on_a_hand_built_trace():
    """Device-idle time goes to the innermost tpurt.* span around it,
    ``outside`` where there is none; ``within`` counts only inside the
    named spans."""
    def x(cat, name, ts, end):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts}

    events = [
        x("user_annotation", "render", 0.0, 100.0),
        x("user_annotation", "tpurt.batch", 10.0, 90.0),
        x("user_annotation", "tpurt.prepare", 20.0, 40.0),
        x("user_annotation", "tpurt.sync.chain", 25.0, 30.0),
        x("kernel", "megakernel<0,0,0,0>", 40.0, 80.0),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 85.0, 88.0),
        x("cpu_op", "aten::copy_", 100.0, 120.0),
        {"ph": "i", "name": "marker", "ts": 200.0},
    ]
    got = P.idle_by_span(events, within="render")
    want = {"outside": 20.0, "tpurt.batch": 17.0, "tpurt.prepare": 15.0,
            "tpurt.sync.chain": 5.0}
    assert got.keys() == want.keys()
    for name, us in want.items():
        assert got[name] == pytest.approx(us * 1e-6)
    whole = P.idle_by_span(events)
    assert whole["outside"] == pytest.approx(40e-6)
    assert sum(whole.values()) == pytest.approx((120.0 - 43.0) * 1e-6)
    assert P.idle_by_span([]) == {}


# -- the frame path on the CPU ----------------------------------------------------


def _flat(scene, cam):
    return render_batch_flat(scene, cam, FLAT, 256, frame_index=7)


def _packed(scene, cam):
    return render_batch_flat_frames(scene, (cam, cam), FLAT, 0, frame_index=5)


@pytest.mark.parametrize("kind", ["flat", "packed", "staged"])
def test_tracing_changes_no_bit(tmp_path, monkeypatch, kind):
    """Off: nothing in the traced view. On (under device_trace): the same
    radiance, segments and trips, and the spans in the traced view."""
    if kind == "staged":
        cfg = _staged_constants(monkeypatch, "quota")
        scene, cam = _scene(cfg)

        def run():
            monkeypatch.setattr(R, "_SCHED_TRACES", {})  # the blocking path
            return render_batch_flat(scene, cam, cfg, 0, frame_index=3)
    else:
        scene, cam = _scene(FLAT)
        run = functools.partial(_flat if kind == "flat" else _packed, scene, cam)
    P.reset()
    off = run()
    assert P.totals(traced=True) == {"spans": {}, "counts": {}}
    assert P.totals()["counts"]["host_syncs"] > 0
    with P.device_trace(str(tmp_path / "tr"), device="cpu"):
        on = run()
    assert torch.equal(off[0], on[0])
    assert off[1:] == on[1:]
    traced = P.totals(traced=True)
    assert "tpurt.batch" in traced["spans"] and "tpurt.launch" in traced["spans"]
    assert traced["counts"]["host_syncs"] == P.totals()["counts"]["host_syncs"] // 2
    if kind == "staged":  # a replay of the recorded plan, traced
        with P.device_trace(str(tmp_path / "tr2"), device="cpu"):
            again = render_batch_flat(scene, cam, cfg, 0, frame_index=3)
        assert R._SPEC_STATS["replayed"] == 1
        assert torch.equal(again[0], off[0]) and again[1] == off[1]


def test_trace_nests_the_spans_with_their_ids(tmp_path):
    """tpurt.batch > tpurt.prepare > tpurt.prepare.scene and
    tpurt.launch > tpurt.launch.call in the Chrome trace, the batch's
    frame index and start in its args; totals are consistent."""
    scene, cam = _scene(FLAT)
    P.reset()
    with P.device_trace(str(tmp_path / "tr"), device="cpu"):
        _flat(scene, cam)
    ev = _events(tmp_path / "tr")
    (batch,) = _spans(ev, "tpurt.batch")
    assert batch["args"]["frame"] == 7 and batch["args"]["start"] == 256
    assert batch["args"]["frames"] == 1
    (prep,) = _spans(ev, "tpurt.prepare")
    (chain,) = _spans(ev, "tpurt.prepare.scene")
    (launch,) = _spans(ev, "tpurt.launch")
    (call,) = _spans(ev, "tpurt.launch.call")
    assert _inside(prep, batch) and _inside(chain, prep)
    assert _inside(launch, batch) and _inside(call, launch)
    assert all(_inside(s, chain) for s in _spans(ev, "tpurt.sync.chain"))

    spans = P.totals(traced=True)["spans"]
    for rec in spans.values():
        assert 0 <= rec["self_s"] <= rec["total_s"]
    children = {"tpurt.batch": ("tpurt.prepare", "tpurt.launch", "tpurt.finish"),
                "tpurt.prepare": ("tpurt.prepare.scene", "tpurt.prepare.slots",
                                  "tpurt.prepare.lanes"),
                "tpurt.launch": ("tpurt.launch.call",)}
    for parent, kids in children.items():
        assert all(k in spans for k in kids)
        assert sum(spans[k]["total_s"] for k in kids) <= spans[parent]["total_s"]


def test_identical_batches_add_identical_host_syncs():
    scene, cam = _scene(FLAT)
    adds = []
    for _ in range(2):
        before = P.totals()["counts"].get("host_syncs", 0)
        _packed(scene, cam)
        adds.append(P.totals()["counts"]["host_syncs"] - before)
    assert adds[0] == adds[1] > 0


@pytest.mark.parametrize("kind", ["p1", "quota"])
def test_one_stage_span_a_staged_step(tmp_path, monkeypatch, kind):
    """Each step ``stage_stats`` logs is one tpurt.stage span of its kind;
    no entry carries a host clock."""
    cfg = _staged_constants(monkeypatch, kind)
    scene, cam = _scene(cfg)
    stats = []
    with P.device_trace(str(tmp_path / "tr"), device="cpu"):
        render_batch_flat(scene, cam, cfg, 0, stage_stats=stats)
    assert stats and all("wall_s" not in s for s in stats)
    kinds = [s["args"]["kind"] for s in _spans(_events(tmp_path / "tr"),
                                                "tpurt.stage")]
    n = lambda k: kinds.count(k)
    assert n("stage") == sum("iters" in s and "uncapped" not in s for s in stats)
    assert n("uncapped") == sum("uncapped" in s for s in stats)
    assert n("respread") == sum("respread" in s for s in stats)
    assert n("cascade") == sum("cascade" in s for s in stats)
    assert n("assemble") == 1 + n("cascade")
    if cfg.pixels_per_lane > 1:
        assert n("compact") == sum("fold_to" in s for s in stats)
    if kind == "p1":
        assert n("stage") == 2 and n("compact") >= 2 and n("uncapped") == 1
    else:
        assert n("respread") == 1


def test_cli_trace_dir(tmp_path, capsys):
    """--trace-dir writes the Chrome trace and prints the report and the
    idle time by span."""
    rc = cli.main(["--cpu", "--width", "16", "--height", "8",
                   "--rays-per-pixel", "1", "--max-bounces", "2",
                   "--object-path", "sphere1.obj",
                   "--output", str(tmp_path / "o.bmp"),
                   "--trace-dir", str(tmp_path / "tr")])
    assert rc == 0
    err = capsys.readouterr().err
    assert "tpurt.image" in err and "host_syncs" in err
    assert "device idle ms by span" in err
    assert _spans(_events(tmp_path / "tr"), "tpurt.image")


# -- on the card ----------------------------------------------------------------


@pytest.fixture(scope="module")
def card_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpurt_torch.scene.builder import SceneBuilder
    from tpurt_torch.scene.presets import scene_around
    from tpurt_torch.scene.procedural import torus_knot

    pos, nrm = torus_knot(96, 32, 80, 22)
    builder = SceneBuilder()
    handle = builder.add_triangles(pos, nrm)
    cfg = RenderConfig(width=320, height=180, rays_per_pixel=2, max_bounces=4,
                       pixels_per_lane=8, mega_tail_passes=5,
                       rays_per_batch=4096)
    scene, cam = scene_around(builder, handle, cfg, device="cuda")
    return scene, cam, cfg


def _device_reads_in(events, roots=("tpurt.image", "tpurt.batch")):
    """Device-to-host copies whose launch lies inside a ``roots`` span."""
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    outer = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") in roots]
    n = 0
    for e in events:
        if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", ""):
            ts = launch_ts.get(e.get("args", {}).get("correlation"))
            if ts is not None and any(a <= ts <= b for a, b in outer):
                n += 1
    return n


@pytest.mark.cuda
def test_card_reads_and_launches_in_their_spans(tmp_path, card_scene):
    """A packed frame (two frames a launch) and a staged still: every
    megakernel launch inside tpurt.launch.call, every device-to-host copy
    inside the frame's spans a counted host_read; every fresh launch's
    lanes written by the fresh_lanes kernel inside tpurt.prepare.lanes,
    with no pack."""
    scene, cam, cfg = card_scene
    still = cfg.replace(compaction_threshold=4096)

    def frames():
        total = cfg.width * cfg.height
        start = 0
        while start < total:
            m, _s, _t = render_batch_flat_frames(scene, (cam, cam), cfg, start,
                                                 frame_index=11)
            start += m.shape[0] // 2
        render_image(scene, cam, still, frame_index=12)

    frames()  # kernels built and loaded, the staged plan recorded
    frames()
    P.reset()
    with P.device_trace(str(tmp_path / "tr")):
        frames()
        torch.cuda.synchronize()
    ev = _events(tmp_path / "tr")
    syncs = P.totals(traced=True)["counts"]["host_syncs"]
    assert syncs > 0
    assert _device_reads_in(ev) == syncs

    calls = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in _spans(ev, "tpurt.launch.call")]
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in ev
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    kernels = [e for e in ev if e.get("cat") == "kernel"
               and "megakernel" in e.get("name", "")]
    assert kernels
    for k in kernels:
        ts = launch_ts[k["args"]["correlation"]]
        assert any(a <= ts <= b for a, b in calls), k["name"]

    # Fresh lanes: one fresh_lanes kernel a launch that starts from them,
    # launched inside tpurt.prepare.lanes, out of the trace reader's
    # megakernel match; such a launch packs nothing, so the pack spans
    # are the resumed launches'.
    lanes = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in _spans(ev, "tpurt.prepare.lanes")]
    fresh = [e for e in ev if e.get("cat") == "kernel"
             and "fresh_lanes" in e.get("name", "")]
    counts = P.totals(traced=True)["counts"]
    assert fresh and len(fresh) == len(lanes) and "fresh_lanes.host" not in counts
    assert counts["fresh_lanes.device"] > 0
    for k in fresh:
        assert "megakernel" not in k["name"], k["name"]
        ts = launch_ts[k["args"]["correlation"]]
        assert any(a <= ts <= b for a, b in lanes), k["name"]
    assert len(_spans(ev, "tpurt.launch.pack")) == len(kernels) - len(fresh)
    # Every launch's tables are made once, inside prepare; no tables span
    # lies under tpurt.launch.
    assert len(_spans(ev, "tpurt.prepare.scene")) == len(kernels)
    assert not [e for e in ev if e.get("cat") == "user_annotation"
                and e["name"].startswith("tpurt.launch.") and "tables" in e["name"]]
