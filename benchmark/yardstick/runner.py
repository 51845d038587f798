"""One run of one cell: set-up, the timed window, the check, the result.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared beside its
limit. The same numbers end standard error. A run without enough CUDA
devices, or one that finds JAX or the JAX package loaded after the
window, prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from yardstick import check, drivers, reference, scene, spec, trace

#: Top-level module names that may not be loaded in a run's process: the
#: JAX package this program was ported from, and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpurt")


@dataclass
class Run:
    """What the metric readers read."""

    cell: dict
    config: dict
    traffic: dict
    seconds: float
    trace: bool
    setup_s: float = 0.0
    scene_build_s: float = 0.0
    window: Optional[drivers.Window] = None
    summary: Optional[trace.Summary] = None
    mesh_triangles: int = 0
    scene_triangles: int = 0
    width: int = 0
    height: int = 0
    exact_segments: Optional[int] = None
    readings: dict = field(default_factory=dict)

    @property
    def frames(self) -> List[drivers.Frame]:
        return self.window.frames

    def window_s(self) -> float:
        return self.window.t_end - self.window.t_start

    def profiled(self) -> List[drivers.Frame]:
        return [f for f in self.frames if f.profiled]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_info(device, chips: int, peak: int) -> dict:
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": int(peak)}


@dataclass
class Cell:
    """A cell's inputs, found by name: everything but the program."""

    name: str
    bench: dict
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    pos: np.ndarray
    nrm: np.ndarray
    sspec: scene.SceneSpec
    pose: scene.Pose
    device: object

    @property
    def size(self):
        return int(self.traffic["width"]), int(self.traffic["height"])


def load_cell(root: str, here: str, name: str, device) -> Cell:
    bench = spec.benchmark(root)
    cell = spec.cell(bench, name)
    cfg = spec.config(root, bench, cell["config"])
    traffic = spec.traffic(here, cell["traffic"])
    pos, nrm = scene.model_triangles(cfg, spec.config_dir(root, bench,
                                                          cell["config"]))
    w, h = int(traffic["width"]), int(traffic["height"])
    return Cell(name=name, bench=bench, cell=cell, config=cfg, traffic=traffic,
                limits=spec.limits(here, name), pos=pos, nrm=nrm,
                sspec=scene.scene_spec(cfg, pos, nrm),
                pose=scene.pose(cfg, w, h), device=device)


@dataclass
class Program:
    scene: object
    cam: object
    rcfg: object
    build_s: float


def build_program(c: Cell) -> Program:
    """The program's scene on the device from the cell's triangles."""
    from tpurt_torch.scene.builder import SceneBuilder
    from tpurt_torch.scene.presets import scene_around

    rcfg = drivers.render_config(c.config, c.traffic, c.pose)
    t = time.perf_counter()
    builder = SceneBuilder()
    handle = builder.add_triangles(c.pos, c.nrm)
    prog_scene, cam = scene_around(builder, handle, rcfg, device=c.device)
    if torch.device(c.device).type == "cuda":
        torch.cuda.synchronize()
    return Program(prog_scene, cam, rcfg, time.perf_counter() - t)


@dataclass
class Draw:
    """What the seed picks: the first frame index, the camera cycle's
    phase, the pixels kept of every frame, and the generator that later
    picks the frames to check."""

    rng: np.random.Generator
    first: int
    phase: int
    pick: np.ndarray


def draw(c: Cell, seed: int) -> Draw:
    rng = np.random.default_rng(seed)
    w, h = c.size
    first = 1024 + int(rng.integers(0, 1 << 20))
    phase = int(rng.integers(0, 1 << 16))
    pick = check.pick_pixels(w * h, int(c.traffic["check"]["pixels"]), rng)
    return Draw(rng, first, phase, pick)


def timed_window(c: Cell, prog: Program, d: Draw, seconds: float,
                 profiler: drivers.Profiler) -> drivers.Window:
    kind = c.traffic["kind"]
    if kind == "stream":
        return drivers.stream_window(prog.scene, prog.cam, prog.rcfg, c.pose,
                                     c.traffic, seconds, d.first, d.pick,
                                     profiler)
    if kind == "stills":
        with drivers.annotated_tonemap(profiler.enabled):
            return drivers.stills_window(prog.scene, prog.rcfg, c.config,
                                         c.traffic, seconds, d.first, d.phase,
                                         d.pick, profiler, c.device)
    raise spec.SpecError(f"unknown traffic kind {kind!r}")


def judge(c: Cell, chosen: List[drivers.Frame], pick: np.ndarray, extra=(),
          dtype=torch.float32):
    """The reference over the chosen frames' kept pixels (then the
    ``extra`` (frame, pixel) lanes): (readings, reference uint8 of the
    extra lanes, reference segments of the extra lanes). With a lower
    ``dtype`` the reference in that precision stands in the program's
    place: the control."""
    lanes = check.lanes_for(chosen, pick, extra)
    ref_u8, ref_segs = check.trace(reference.RefScene(c.sspec, c.device),
                                   lanes, c.traffic)
    n = len(chosen) * len(pick)
    if dtype == torch.float32:
        got = (np.concatenate([f.pixels for f in chosen]) if chosen
               else np.zeros((0, 3), np.uint8))
    else:
        ctrl = check.lanes_for(chosen, pick)
        got, _ = check.trace(reference.RefScene(c.sspec, c.device, dtype),
                             ctrl, c.traffic)
    readings = {"px_diff_pct": check.px_diff_pct(got, ref_u8[:n])}
    return readings, ref_u8[n:], ref_segs[n:]


def free_device():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(root: str, here: str, cell_name: str, seed: int, seconds: float,
        trace_on: bool, device, t0: float, out=None) -> int:
    out = out or sys.stdout
    c = load_cell(root, here, cell_name, device)
    metrics = (spec.per_layer(c.bench, cell_name) if trace_on
               else spec.end_to_end(c.bench, cell_name))
    readers = {m["name"]: spec.reader(here, m["name"]) for m in metrics}
    d = draw(c, seed)
    w, h = c.size
    r = Run(cell=c.cell, config=c.config, traffic=c.traffic, seconds=seconds,
            trace=trace_on, mesh_triangles=int(c.pos.shape[0]),
            scene_triangles=sum(len(m.pos) for m in c.sspec.meshes),
            width=w, height=h)
    prog = build_program(c)
    r.scene_build_s = prog.build_s
    prof_cfg = c.traffic.get("profile", {})
    profiler = drivers.Profiler(
        trace_on, skip=int(prof_cfg.get("skip", 1)),
        seconds=min(float(prof_cfg.get("seconds", 3.0)), seconds / 3.0),
        min_requests=int(prof_cfg.get("min_requests", 2)), device=device)
    profiler.warm()
    win = r.window = timed_window(c, prog, d, seconds, profiler)
    r.setup_s = win.t_start - t0
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    if profiler.prof is not None:
        r.summary = trace.summarize(trace.chrome_events(profiler.prof))
        profiler.prof = None
        if c.traffic["kind"] == "stills":
            drivers.plain_segments(prog.scene, prog.rcfg, r.profiled(), device)

    # -- the check: the program's state freed, then the reference -------------
    del prog
    free_device()
    chosen = check.choose_frames(win.frames, int(c.traffic["check"]["frames"]),
                                 d.rng)
    pads = ([(f, w * h - 1) for f in r.profiled() if f.pad_slots]
            if trace_on else [])
    r.readings, _, pad_px_segs = judge(c, chosen, d.pick, pads)
    if trace_on and r.profiled():
        pad_segs = sum(int(f.pad_slots) * int(s)
                       for (f, _), s in zip(pads, pad_px_segs))
        r.exact_segments = (sum(int(f.segments or 0) for f in r.profiled())
                            - pad_segs)
    correct, rows = check.compare(r.readings, c.limits)
    correct &= len(chosen) > 0

    # -- the result -----------------------------------------------------------
    values = {}
    for m in metrics:
        v = readers[m["name"]](r)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = device_info(device, int(c.cell["chips"]), peak)
    result = {"correct": bool(correct), "attempted": int(win.attempted),
              "failed": int(win.attempted - len(win.frames)),
              "metrics": values, "device": dev}
    if trace_on:
        sm = r.summary
        dev["busy_s"] = sm.busy_s if sm else 0.0
        dev["window_s"] = sm.window_s if sm else 0.0
        if sm:
            result["breakdown"] = {
                "device_ops": [[n, s] for n, s in sm.device_ops],
                "idle_gaps": [[n, s] for n, s in sm.idle_gaps]}
    result["check"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}

    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 4
    log(f"frames {len(win.frames)} in {r.window_s():.3f} s; checked "
        f"{len(chosen)} frames x {len(d.pick)} pixels")
    for name, v, lim in rows:
        log(f"check {name} {v} limit {lim}")
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv, t0: float, root: str, here: str) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.benchmark(root)
    cell = spec.cell(bench, args.workload)
    need = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"this cell needs {need} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
            "visible")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run(root, here, args.workload, args.seed, args.seconds,
               bool(args.trace), "cuda", t0)


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock, from the
    kernel's record of it (10 ms resolution), or now where there is none."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - start_ticks / float(os.sysconf("SC_CLK_TCK")))
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now

