"""The bench harness (port of tpurt's bench.py): tpurt's ladder of
configs on one CUDA card, under tpurt's row names, metric and JSON line.

    python -m tpurt_torch.bench             # the headline rows
    python -m tpurt_torch.bench --ladder    # every row of tpurt's ladder
    python -m tpurt_torch.bench --cpu       # the same sizes on the CPU,
                                            # through the plain versions
                                            # (hours at full size)

The metric is tpurt's: Mrays/s = exact path segments / frame time, the
segments counted per lane by the renderer (padding lanes included) and
the frame time that of a steady block of frames (``time_render_flat``).
Standard output carries two JSON lines for the headline,
bunny-1080p-plain: a provisional one after its packed row, and the final
one after bunny-1080p-bvh, which takes the larger of the two rows. Each
names the device it ran on: the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, or "cpu". Standard error carries each row's log line and dict.
Every row is appended to ``BENCH_torch_history.jsonl`` at the
repository root (``--history PATH``, ``--no-history``).

Where the port differs from tpurt's harness:

* Each launch synchronises: ``render_batch_flat`` returns its segment
  count and loop trips as host integers. A timed block is CUDA events
  around the block with one synchronise after its end, but the card
  waits for the host between launches; moving the counts to the device
  is ROADMAP D.4 (D.1-D.4 take the host's work between launches).
* The kernels build (nvcc) before the first row, and their seconds are
  logged on a line of their own; each row's warm-up absorbs the rest of
  its set-up.
* The JSON lines carry ``device`` where tpurt's carry its TPU target
  (``vs_baseline``); ``mega_interleave`` is accepted and ignored, as
  ``RenderConfig`` does.
* A flat row's record adds ``launches``: runs of
  ``megakernel.run_megakernel`` a frame in its steady block (counted in
  ``megakernel.RUNS``; on the card each is one B1 launch), so a staged
  row (bunny-1080p-bvh, tpurt's staged schedule) counts each of its
  stages, compacted resumes and tail batches.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HISTORY = os.path.join(_ROOT, "BENCH_torch_history.jsonl")
METRIC = "Mrays/sec/chip bunny-class 1080p BVH path trace"
#: What the ladder builds before its first row: kernel B1's library
#: (which holds B2 in its brute-force instantiation) and the BVH builder.
KERNELS = ("megakernel", "tpurt_native")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def record_history(entry: dict, path: str = HISTORY):
    try:
        with open(path, "a") as f:
            f.write(json.dumps(entry) + "\n")
    except OSError as e:  # never let bookkeeping kill the bench
        log(f"history append failed: {e}")


def device_label(device) -> str:
    """"cpu", or the card's name and power limit as nvidia-smi gives them."""
    if torch.device(device).type == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def headline_line(row: dict, device: str, provisional: bool = False) -> dict:
    """The JSON line of the headline metric for ``row``."""
    line = {"metric": METRIC, "value": round(row["mrays"], 2),
            "unit": "Mrays/s", "device": device}
    if provisional:
        line["provisional"] = True
    return line


def _elapsed_ms(device: torch.device, fn):
    """(fn(), its ms): CUDA events on the card, with one synchronise at
    the end, the host's clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize(device)
    return out, e0.elapsed_time(e1)


def build_scene(kind: str, cfg, device="cuda"):
    """tpurt's bench scenes: ``presets.bench_scene``."""
    from tpurt_torch.scene.presets import bench_scene

    return bench_scene(kind, cfg, device=device)


def time_render_flat(scene, cam, cfg, repeats=2, max_frames=32, strict=False):
    """Steady-state multi-frame throughput of the flat megakernel path.
    A block of frames with distinct frame_index values (the animation and
    progressive-accumulation workload) is dispatched back to back, every
    batch tonemapped on the device inside the block, the segments and
    loop trips summed; packed ``mega_frames_per_batch`` frames a launch
    through ``render_batch_flat_frames`` where ``cross_frame_pack_ok``
    allows it, and with ``sample_flatten`` as one-sample passes summed
    per batch. Warm-up: every batch of a frame twice, with its display
    frames copied to the host (``d2h_s`` times that copy), and the packed
    launches twice. Then one frame's ``latency_s``: dispatch to the
    uint8 frame on the host. The block holds max(2, min(max_frames,
    3 s / latency + 1)) frames in whole packs, best of ``repeats``.
    Each launch synchronises (its counts come back to the host). Returns
    a dict: seconds, segments, iters (loop trips of the plain-schedule
    launches: a staged batch reports none, as tpurt's does) and launches
    (counted) per frame, frames, latency_s, d2h_s, and with ``strict``
    strict_seconds: the block again with every frame's uint8 copied to
    the host."""
    from tpurt_torch.render import megakernel
    from tpurt_torch.render.renderer import (
        _flat_batch_size, cross_frame_pack_ok, render_batch_flat,
        render_batch_flat_frames)
    from tpurt_torch.render.tonemap import tonemap

    device = scene.device
    total = cfg.width * cfg.height
    sflat = cfg.sample_flatten and cfg.rays_per_pixel > 1
    spp = cfg.rays_per_pixel
    if sflat:
        cfg = cfg.replace(rays_per_pixel=1)
    groups = spp if sflat else 1
    b = _flat_batch_size(cfg) * cfg.pixels_per_lane  # pixels per launch
    n_batches = -(-total // b)
    pack = max(1, int(cfg.mega_frames_per_batch))
    if sflat or not cross_frame_pack_ok(cfg):
        pack = 1

    def frame(f, collect=None):
        """One frame's launches; returns (segments, trips)."""
        segs = trips = 0
        accs = [None] * n_batches
        for g in range(groups):
            for i in range(n_batches):
                m, s, it = render_batch_flat(scene, cam, cfg, i * b,
                                             frame_index=f, sample_offset=g)
                segs += s
                trips += it or 0
                accs[i] = m if accs[i] is None else accs[i] + m
        if collect is not None:
            for m in accs:
                collect.append(tonemap(m / float(spp) if sflat else m))
        return segs, trips

    def frame_pack(f0, n_frames, collect=None):
        """Frames f0 .. f0 + n_frames - 1 as cross-frame packed launches,
        each frame bit for bit the frame alone; returns (segments, trips)."""
        segs = trips = 0
        cams = (cam,) * n_frames
        for i in range(n_batches):
            m, s, it = render_batch_flat_frames(scene, cams, cfg, i * b,
                                                frame_index=f0)
            segs += s
            trips += it
            if collect is not None:
                for k in range(n_frames):
                    collect.append(tonemap(m[k * b:(k + 1) * b]))
        return segs, trips

    def ship(display):
        return [t.cpu() for t in display]

    for _ in range(2):
        shipped = []
        frame(0, collect=shipped)
        _, ms = _elapsed_ms(device, lambda: ship(shipped))
        d2h_s = ms / 1e3
    if pack > 1:
        for _ in range(2):
            shipped = []
            frame_pack(0, pack, collect=shipped)
            ship(shipped)

    def one_frame():
        shipped = []
        frame(0, collect=shipped)
        return ship(shipped)

    _, ms = _elapsed_ms(device, one_frame)
    latency_s = ms / 1e3

    frames = max(2, min(max_frames, int(3.0 / max(latency_s, 1e-3)) + 1))
    frames = -(-frames // pack) * pack  # whole packs

    def block(to_host=False):
        segs = trips = 0
        for f in range(0, frames, pack):
            display = []
            if pack > 1:
                s, it = frame_pack(f, pack, collect=display)
            else:
                s, it = frame(f, collect=display)
            segs += s
            trips += it
            if to_host:
                ship(display)
        return segs, trips

    best = None
    for _ in range(repeats):
        runs = megakernel.RUNS
        (segs, trips), ms = _elapsed_ms(device, block)
        launches = megakernel.RUNS - runs
        if best is None or ms < best[0]:
            best = (ms, segs, trips, launches)
    ms, segs, trips, launches = best
    out = {
        "seconds": ms / 1e3 / frames, "segments": segs / frames,
        "iters": trips / frames, "frames": frames,
        "latency_s": latency_s, "d2h_s": d2h_s,
        "launches": launches / frames,
    }
    if strict:
        best_s = min(_elapsed_ms(device, lambda: block(to_host=True))[1]
                     for _ in range(repeats))
        out["strict_seconds"] = best_s / 1e3 / frames
    return out


def time_render_tiles(scene, cam, cfg, repeats=2):
    """Tile-loop render (the modular engine, or the megakernel's tile
    path): (seconds, segments, 0) of the best of ``repeats`` frames, each
    tile's radiance copied to the host."""
    from tpurt_torch.render.renderer import render_tile_with_stats

    ts = cfg.tile_size
    tiles_x, tiles_y = cfg.tiles()
    r, _s = render_tile_with_stats(scene, cam, cfg, 0, 0, ts, ts)
    r.cpu()

    def sweep():
        segs = 0
        for ty in range(tiles_y):
            for tx in range(tiles_x):
                r, s = render_tile_with_stats(scene, cam, cfg, tx * ts,
                                              ty * ts, ts, ts)
                segs += s
                r.cpu()
        return segs

    best = None
    for _ in range(repeats):
        segs, ms = _elapsed_ms(scene.device, sweep)
        if best is None or ms / 1e3 < best[0]:
            best = (ms / 1e3, segs, 0)
    return best


def run_config_anim(name, scene_kind, cfg, frames=4, device="cuda"):
    """An animated camera sweep (yaw advancing 1/720 turn a frame, the
    viewer's schedule), every frame through the flat path unpacked, each
    under its own camera and frame index; the last frame's display copy
    is timed after the block (``d2h_s``)."""
    from tpurt_torch.core.camera import Camera
    from tpurt_torch.render.renderer import _flat_batch_size, render_batch_flat
    from tpurt_torch.render.tonemap import tonemap

    scene, _ = build_scene(scene_kind, cfg, device)
    cams = [
        Camera.create(
            position=cfg.camera_position, pitch=cfg.camera_pitch,
            yaw=cfg.camera_yaw + 2.0 * math.pi * f / 720.0,
            roll=cfg.camera_roll, fov_degrees=cfg.fov_degrees,
            aspect_ratio=cfg.aspect_ratio, device=device,
        )
        for f in range(frames)
    ]
    total = cfg.width * cfg.height
    b = _flat_batch_size(cfg) * cfg.pixels_per_lane
    n_batches = -(-total // b)
    log(f"[{name}] scene={scene_kind} {cfg.width}x{cfg.height} "
        f"spp={cfg.rays_per_pixel} frames={frames} batches={n_batches}")

    for _ in range(2):
        for i in range(n_batches):
            m, _s, _ = render_batch_flat(scene, cams[0], cfg, i * b)
            tonemap(m).cpu()

    def sweep():
        segs, outs = 0, []
        for f, cam in enumerate(cams):
            outs = []
            for i in range(n_batches):
                m, s, _ = render_batch_flat(scene, cam, cfg, i * b,
                                            frame_index=f)
                segs += s
                outs.append(m)
        return segs, outs

    best = None
    for _ in range(2):
        (segs, outs), ms = _elapsed_ms(scene.device, sweep)
        if best is None or ms / 1e3 < best:
            best = ms / 1e3
    dt = best
    _, ms = _elapsed_ms(scene.device, lambda: [tonemap(m).cpu() for m in outs])
    d2h_s = ms / 1e3
    mrays = segs / dt / 1e6
    log(f"[{name}] {frames} frames in {dt:.3f}s "
        f"({dt/frames:.3f}s/frame, frame d2h {d2h_s:.3f}s)  "
        f"=> {mrays:.1f} Mrays/s")
    return {"name": name, "seconds": dt, "mrays": mrays,
            "seconds_per_frame": dt / frames, "d2h_s": d2h_s,
            "avg_path": segs / (total * cfg.rays_per_pixel * frames),
            "launches": n_batches}


def run_sharding_efficiency(cfg, repeats=2, force=False, scene_kind="bunny",
                            devices=None):
    """Per-device efficiency of the tile-sharded frame
    (``parallel.render_frame_sharded``) against the single-device flat
    path: (single-frame latency / sharded frame time) / positions.
    ``devices``: the mesh's positions (default: every CUDA card). It is
    measured over two or more distinct devices; with fewer the row
    reports the measurement as unavailable, unless ``force``, which runs
    the measuring branch on whatever mesh the positions make — one
    device in several positions included, by default the one card in
    two — where the number means nothing but the branch is exercised
    end to end."""
    from tpurt_torch.parallel import make_mesh, render_frame_sharded

    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if force and len(devices) == 1:
            devices = devices * 2
    devices = [torch.device(d) for d in devices]
    if len(devices) < 2 or (len(set(devices)) < 2 and not force):
        log("[sharding-eff] fewer than 2 devices — efficiency not "
            "measurable on this machine; row emitted for several cards")
        return {"name": "sharding-efficiency", "devices": 1,
                "efficiency": None}
    scene, cam = build_scene(scene_kind, cfg, devices[0])
    n = len(devices)
    r1 = time_render_flat(scene, cam, cfg, repeats)
    dt1 = r1["latency_s"]
    mesh = make_mesh(tile_devices=n, devices=devices)
    stats: dict = {}
    render_frame_sharded(scene, cam, cfg, mesh=mesh, stats=stats)  # warm-up
    best = None
    for _ in range(repeats):
        _, ms = _elapsed_ms(scene.device, lambda: render_frame_sharded(
            scene, cam, cfg, mesh=mesh, stats=stats))
        best = ms / 1e3 if best is None else min(best, ms / 1e3)
    eff = (dt1 / best) / n
    log(f"[sharding-eff] single {dt1:.3f}s, {n}-position {best:.3f}s "
        f"=> speedup {dt1/best:.2f}x, efficiency {eff*100:.1f}%")
    return {"name": "sharding-efficiency", "devices": n,
            "single_s": dt1, "sharded_s": best, "efficiency": eff}


def run_config(name, scene_kind, cfg, repeats=2, strict=False, device="cuda"):
    scene, cam = build_scene(scene_kind, cfg, device)
    log(f"[{name}] scene={scene_kind} tris={scene.num_triangles} "
        f"{cfg.width}x{cfg.height} spp={cfg.rays_per_pixel} "
        f"bounces={cfg.max_bounces} engine={cfg.engine} "
        f"dense={cfg.dense_engine} bf_threshold={cfg.bruteforce_threshold}")
    extra = {}
    if cfg.engine == "mega" and cfg.rays_per_batch > 0 and cfg.max_bounces > 0:
        r = time_render_flat(scene, cam, cfg, repeats, strict=strict)
        dt, segments, iters = r["seconds"], r["segments"], r["iters"]
        extra.update({k: r[k] for k in ("frames", "latency_s", "d2h_s",
                                        "launches")})
        if "strict_seconds" in r:
            extra["strict_seconds"] = r["strict_seconds"]
    else:
        dt, segments, iters = time_render_tiles(scene, cam, cfg, repeats)
    mrays = segments / dt / 1e6
    prim = cfg.width * cfg.height * cfg.rays_per_pixel
    breakdown = ""
    result = {"name": name, "seconds": dt, "mrays": mrays,
              "avg_path": segments / prim, **extra}
    if iters:
        # Loop trips a frame: the currency for rows per segment.
        us_per_iter = dt / iters * 1e6
        result["iters"] = iters
        result["us_per_iter"] = us_per_iter
        result["iters_per_seg"] = iters * min(
            cfg.rays_per_batch, cfg.width * cfg.height) / segments
        breakdown = (f" | {iters:.0f} iters, {us_per_iter:.0f} us/iter, "
                     f"{result['iters_per_seg']:.2f} iters(rows)/seg")
    if "frames" in extra:
        breakdown += (f" | {extra['launches']:g} launches a frame, steady over "
                      f"{extra['frames']} frames, 1-frame latency "
                      f"{extra['latency_s']:.3f}s (d2h {extra['d2h_s']:.3f}s)")
        if "strict_seconds" in extra:
            breakdown += (f" | strict (per-frame host frame) "
                          f"{extra['strict_seconds']:.3f}s/frame")
    log(f"[{name}] {dt:.3f}s/frame  {segments/1e6:.1f}M segments "
        f"(avg path {segments/prim:.2f})  => {mrays:.1f} Mrays/s{breakdown}")
    return result


def main(argv=None) -> int:
    from tpurt_torch.config import RenderConfig

    ap = argparse.ArgumentParser(prog="python -m tpurt_torch.bench")
    ap.add_argument("--ladder", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU through the plain versions")
    ap.add_argument("--strict", action="store_true",
                    help="additionally time the headline with every frame's "
                         "uint8 copied to the host inside the timed block")
    ap.add_argument("--tile-size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--tuned", action="store_true",
                    help="apply the cached autotuner knob set for this "
                         "device (python -m tpurt_torch.autotune)")
    ap.add_argument("--force-cpu-mesh", action="store_true",
                    help="run the sharding-efficiency measuring branch on "
                         "the CPU in 8 positions (plumbing check; the "
                         "efficiency number means nothing there)")
    ap.add_argument("--history", default=HISTORY,
                    help="the JSON-lines file each row is appended to")
    ap.add_argument("--no-history", action="store_true")
    args = ap.parse_args(argv)

    if args.force_cpu_mesh:
        args.cpu = True
    device = "cpu" if args.cpu else "cuda"
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("tpurt_torch.bench: no CUDA device is visible "
                         "(--cpu runs on the CPU)")
    label = device_label(device)
    log(f"device: {label}")
    if not args.cpu:
        from tpurt_torch import _build

        done = _build.build_all(KERNELS)
        log("built " + ", ".join(f"{k} {s:.1f} s" for k, s in done.items()))

    # The ladder's knobs (tpurt's): a quota of 8 pixels a lane, 5 tail
    # passes, plain batches.
    common = dict(tile_size=args.tile_size, seed_mode="reference",
                  pixels_per_lane=8, mega_interleave=4,
                  mega_tail_passes=5, compaction_threshold=0)
    if args.tuned:
        from tpurt_torch import autotune

        knobs = autotune.load_tuned(autotune.device_key(device))
        if knobs:
            log(f"tuned knobs: {knobs}")
            # apply() sets the freeze-time tunables (arity, leaf tris,
            # bounds format) as the tuner swept them; the RenderConfig
            # fields feed ``common``.
            tuned_cfg = autotune.apply(knobs, RenderConfig())
            for k in ("mega_tail_passes", "pixels_per_lane"):
                if k in knobs:
                    common[k] = int(getattr(tuned_cfg, k))
        else:
            log("no autotune cache for this device — run "
                "`python -m tpurt_torch.autotune` first; using defaults")
    staged = dict(common, compaction_threshold=32768)
    mesh_devices = None
    if args.cpu:
        mesh_devices = [torch.device("cpu")] * (8 if args.force_cpu_mesh else 1)

    results = []
    if args.ladder:
        # tpurt's config 1: the CPU-oracle parity scene, packed four frames
        # a launch.
        results.append(run_config(
            "parity-640x480-1spp", "sphere",
            RenderConfig(width=640, height=480, rays_per_pixel=1,
                         max_bounces=1, mega_frames_per_batch=4,
                         **common), device=device))
        # Config 2: low-poly brute force at 720p through the dense
        # megakernel (B2); P=4 covers the frame in one launch of 230,400
        # lanes with no padding lane.
        results.append(run_config(
            "teapot-720p-bruteforce", "teapot",
            RenderConfig(width=1280, height=720, rays_per_pixel=args.spp,
                         max_bounces=4, mega_dense=True,
                         rays_per_batch=230400,
                         **{**common, "pixels_per_lane": 4}), device=device))
        # The same scene through the BVH megakernel.
        results.append(run_config(
            "teapot-720p-mega", "teapot",
            RenderConfig(width=1280, height=720, rays_per_pixel=args.spp,
                         max_bounces=4, **common), device=device))
        # Config 4: Cornell box + mesh, 4 bounces, 256 spp at 1080p.
        results.append(run_config(
            "cornell-256spp-1080p", "sphere",
            RenderConfig(width=1920, height=1080, rays_per_pixel=256,
                         max_bounces=4, **common), device=device))
        # Config 5: a 4K animated camera sweep at a quota of 16 (two
        # launches a frame), and the sharding efficiency.
        results.append(run_config_anim(
            "4k-anim-sweep", "bunny",
            RenderConfig(width=3840, height=2160, rays_per_pixel=4,
                         max_bounces=4,
                         **{**common, "pixels_per_lane": 16}), device=device))
        results.append(run_sharding_efficiency(
            RenderConfig(width=1920, height=1080, rays_per_pixel=args.spp,
                         max_bounces=4, **common),
            force=args.force_cpu_mesh, devices=mesh_devices))
        # The headline's triangle count as a smooth, regular torus knot.
        results.append(run_config(
            "knot-1080p-plain", "knot",
            RenderConfig(width=1920, height=1080, rays_per_pixel=args.spp,
                         max_bounces=4, **common), device=device))
    elif args.force_cpu_mesh:
        # The measuring branch alone at a tiny frame.
        results.append(run_sharding_efficiency(
            RenderConfig(width=64, height=32, rays_per_pixel=2,
                         max_bounces=2, rays_per_batch=1024,
                         **{**common, "pixels_per_lane": 2}),
            force=True, scene_kind="sphere", devices=mesh_devices))

    # Config 3, the headline: the bunny-class BVH scene at 1080p with
    # reference seeds, packed two frames a launch in the steady block.
    headline = run_config(
        "bunny-1080p-plain", "bunny",
        RenderConfig(width=1920, height=1080, rays_per_pixel=args.spp,
                     max_bounces=4, mega_frames_per_batch=2, **common),
        strict=args.strict, device=device)
    print(json.dumps(headline_line(headline, label, provisional=True)),
          flush=True)
    results.append(headline)
    staged_row = run_config(
        "bunny-1080p-bvh", "bunny",
        RenderConfig(width=1920, height=1080, rays_per_pixel=args.spp,
                     max_bounces=4, **staged), device=device)
    if staged_row["mrays"] > headline["mrays"]:
        headline = staged_row
    results.append(staged_row)

    ts = time.time()
    platform = "cpu" if args.cpu else "gpu"
    for r in results:
        log(json.dumps(r))
        if not args.no_history:
            record_history({"ts": ts, "platform": platform, "device": label,
                            **r}, args.history)

    print(json.dumps(headline_line(headline, label)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
