"""Command-line driver (port of tpurt/cli.py).

Reproduces the reference's interactive flow (src/main.cpp:14-244): dump
the device inventory, prompt for device list / width / height /
rays-per-pixel / max bounces / OBJ path with empty-input-keeps-default
semantics (parseDefaultInput, math.hpp:182-218), render with a live
progress/ETA line, write output.bmp — with tpurt's flags, defaults,
prompts and output lines: JSON scene files, checkpoint/resume, video and
progressive-preview modes, the interactive viewer.

It renders on the CUDA card (kernels B1, B2, B3 as the config asks);
``--cpu`` renders on the CPU through their plain torch versions. Without
a card and without ``--cpu`` it fails; it never falls back to the CPU.
One device renders the frame through ``render_frame``; several devices,
or any ``--devices`` pick, render it over a (tile, sample) mesh through
``parallel.render_frame_sharded`` (on ``--cpu`` the CPU fills as many
mesh positions as the axes ask). ``--coordinator`` joins a
torch.distributed group (NCCL on the card, gloo with ``--cpu``) whose
mesh spans every process's devices; every process writes the frame.
``--tuned`` applies the autotuner's cache for the card (or the CPU).

    python -m tpurt_torch.cli --cpu --width 64 --height 64
    tpurt-torch --rays-per-pixel 8          # on the card
    tpurt-torch --devices 0 --overdecompose 4
    tpurt-torch --trace-dir trace           # spans, counters, device idle

``--trace-dir DIR`` renders inside ``utils.profiling.device_trace(DIR)``
(a Chrome trace, ``DIR/trace.json``, with the program's spans) and prints
the spans and counters (``profiling.report``) and the device's idle time
by span (``profiling.idle_by_span``) to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from tpurt_torch.config import RenderConfig

#: Megakernel defaults on the card: the headline's quota and tail passes
#: (bunny-1080p-plain), not tuned for the H100 (``--tuned`` applies the
#: autotuner's). On the CPU both are 1, as tpurt's are off the TPU.
CARD_PIXELS_PER_LANE = 8
CARD_TAIL_PASSES = 5


def _prompt(label: str, default, cast):
    """parseDefaultInput semantics: empty line keeps the default;
    unparseable input falls back to the default with a warning."""
    try:
        line = input(f"{label} [{default}]: ").strip()
    except EOFError:
        return default
    if not line:
        return default
    try:
        return cast(line)
    except ValueError:
        print(f"could not parse {line!r}; keeping {default}", file=sys.stderr)
        return default


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpurt-torch",
        description="Monte-Carlo path tracer on one CUDA card (the PyTorch + "
        "CUDA port of tpurt; re-implementation of ripoff-raytracer's "
        "capabilities)",
    )
    d = RenderConfig()
    p.add_argument("--width", type=int, default=d.width)
    p.add_argument("--height", type=int, default=d.height)
    p.add_argument("--rays-per-pixel", type=int, default=d.rays_per_pixel)
    p.add_argument("--max-bounces", type=int, default=d.max_bounces)
    p.add_argument("--tile-size", type=int, default=d.tile_size)
    p.add_argument("--object-path", default=d.object_path,
                   help="OBJ file; missing files fall back to procedural "
                        "stand-ins (sphereN / knot)")
    p.add_argument("--scene-json", default=None,
                   help="JSON scene description (see scene.jsonscene)")
    p.add_argument("--seed-mode", choices=["reference", "decorrelated"],
                   default=d.seed_mode)
    p.add_argument("--subpixel-jitter", action="store_true")
    p.add_argument("--engine", choices=["mega", "modular"], default=d.engine,
                   help="integrator: persistent-lane megakernel (fast "
                        "path) or the modular bounce loop")
    p.add_argument("--mega-body", choices=["auto", "xla", "pallas"],
                   default=d.mega_body,
                   help="megakernel backend (auto: the CUDA kernel on the "
                        "card, the plain torch version on the CPU; xla: "
                        "the plain version; pallas: the CUDA kernel)")
    p.add_argument("--pixels-per-lane", type=int, default=None,
                   help="pixel quota per megakernel lane (work "
                        f"equalisation). Default: {CARD_PIXELS_PER_LANE} on "
                        "the card, the headline's value, not tuned for the "
                        "H100 (see --tuned); 1 on the CPU")
    p.add_argument("--rays-per-batch", type=int, default=d.rays_per_batch,
                   help="lanes per flat megakernel launch (0 = tile loop)")
    p.add_argument("--interleave", type=int, default=None,
                   help="megakernel sub-batches per loop iteration; a TPU "
                        "schedule, bitwise-identical by contract: accepted "
                        "and ignored")
    p.add_argument("--tail-passes", type=int, default=None,
                   help="segment-completion passes per megakernel loop "
                        "iteration (bitwise-identical scheduling knob). "
                        f"Default: {CARD_TAIL_PASSES} on the card, the "
                        "headline's value, not tuned for the H100; 1 on "
                        "the CPU")
    p.add_argument("--frames-per-batch", type=int, default=1,
                   help="cross-frame lane packing for --frames videos "
                        "with a static-position camera: pack this many "
                        "frames per megakernel launch (bitwise-identical "
                        "to frame-by-frame)")
    p.add_argument("--tuned", action="store_true",
                   help="apply the autotuner's cached knob set "
                        "(python -m tpurt_torch.autotune)")
    p.add_argument("--mega-dense", action="store_true",
                   help="brute-force the megakernel: one dense Pluecker "
                        "sweep per bounce segment instead of the BVH walk "
                        "(the reference's UseBVH=false mode; fastest "
                        "below a few thousand triangles)")
    p.add_argument("--output", default="output.bmp")
    p.add_argument("--checkpoint", default=None,
                   help="npz tile accumulator path for resume/preview")
    p.add_argument("--frames", type=int, default=1,
                   help="video frame count; >1 writes <video-dir>/output_<i>.bmp")
    p.add_argument("--video-dir", default=d.video_output_dir)
    p.add_argument("--progressive", type=int, default=0, metavar="PASSES",
                   help="progressive refinement: average PASSES whole-frame "
                        "passes, writing preview.bmp periodically")
    p.add_argument("--preview-every", type=int, default=10)
    p.add_argument("--devices", default=None, metavar="IDS",
                   help="comma-separated device ids to render on (the "
                        "reference's interactive device pick, "
                        "main.cpp:159-193); default: all")
    p.add_argument("--tile-devices", type=int, default=None,
                   help="devices on the image-tile mesh axis (default: all)")
    p.add_argument("--sample-devices", type=int, default=1,
                   help="devices on the samples-per-pixel mesh axis "
                        "(needs --seed-mode decorrelated)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process: the torch.distributed rendezvous "
                        "address (process 0 listens there); requires "
                        "--num-processes and --process-id")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--group-timeout", type=float, default=600.0,
                   metavar="SECONDS",
                   help="multi-process: how long the group waits for its "
                        "processes to join and for each collective")
    p.add_argument("--overdecompose", type=int, default=1, metavar="K",
                   help="round-robin pixel blocks per tile-axis device "
                        "(load balance for non-uniform scenes; mega "
                        "engine only)")
    p.add_argument("--single-chip", action="store_true",
                   help="render on the first selected device, without a "
                        "mesh")
    p.add_argument("--interactive", action="store_true",
                   help="prompt for settings like the reference driver")
    p.add_argument("--view", action="store_true",
                   help="interactive progressive viewer: steer the "
                        "camera (wasd/qe + ijkl), adjust spp/bounces, "
                        "pick-to-tint; writes preview.bmp per pass")
    p.add_argument("--list-devices", action="store_true")
    p.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="render under the profiler: DIR/trace.json, and the "
                        "spans, counters and idle time by span on stderr")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (the kernels' plain versions)")
    return p


def _join_group(args) -> int:
    """Join the torch.distributed group --coordinator names (NCCL on the
    card, gloo with --cpu); 0, or 2 with the reason on stderr when it
    does not form within --group-timeout (no process renders alone)."""
    import datetime

    import torch

    try:
        torch.distributed.init_process_group(
            "gloo" if args.cpu else "nccl",
            init_method=f"tcp://{args.coordinator}",
            world_size=args.num_processes, rank=args.process_id,
            timeout=datetime.timedelta(seconds=args.group_timeout))
    except torch.distributed.DistError as e:
        print(f"error: the process group did not form: {e}", file=sys.stderr)
        return 2
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    # Multi-process initialisation precedes any device use: the mesh then
    # spans every process (tpurt's jax.distributed analog of the
    # reference's single-host multi-GPU setup, image.hpp:280-350).
    if args.coordinator is not None:
        if args.num_processes is None or args.process_id is None:
            print("--coordinator requires --num-processes and --process-id",
                  file=sys.stderr)
            return 2
        rc = _join_group(args)
        if rc:
            return rc
    try:
        return _run(args)
    finally:
        if args.coordinator is not None:
            import torch

            torch.distributed.destroy_process_group()


def _run(args) -> int:
    platform = "cpu" if args.cpu else "cuda"
    from tpurt_torch.parallel.mesh import (
        device_inventory, process_rank, select_devices)

    try:
        inventory = device_inventory(platform)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"Found {len(inventory)} device(s):")
    for rec in inventory:
        extra = f", {rec['memory_gb']} GiB" if "memory_gb" in rec else ""
        print(f"  [{rec['id']}] {rec['kind']} ({rec['platform']}{extra})")
    if args.list_devices:
        return 0

    if args.interactive:
        # The reference prompts for a comma-separated device list first
        # (main.cpp:159-193).
        args.devices = _prompt("Devices (comma-separated ids)",
                               args.devices or "all", str)
        if args.devices == "all":
            args.devices = None
        args.width = _prompt("Width", args.width, int)
        args.height = _prompt("Height", args.height, int)
        args.rays_per_pixel = _prompt("Rays per pixel", args.rays_per_pixel, int)
        args.max_bounces = _prompt("Max bounces", args.max_bounces, int)
        args.object_path = _prompt("OBJ path", args.object_path, str)

    try:
        devices = select_devices(args.devices, platform)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.single_chip:
        devices = devices[:1]
    device = devices[0]
    on_card = device.type == "cuda"
    _rank, world = process_rank()
    if on_card and world > 1:
        import torch

        torch.cuda.set_device(device)  # NCCL's tensors live on this card
    # tpurt's choice: one device and no pick renders without a mesh.
    sharded = not args.single_chip and (
        world > 1 or len(inventory) > 1 or bool(args.devices))

    cfg = RenderConfig(
        width=args.width, height=args.height,
        rays_per_pixel=args.rays_per_pixel, max_bounces=args.max_bounces,
        tile_size=args.tile_size, object_path=args.object_path,
        seed_mode=args.seed_mode, subpixel_jitter=args.subpixel_jitter,
        video_frame_count=args.frames, video_output_dir=args.video_dir,
        engine=args.engine, mega_body=args.mega_body,
        pixels_per_lane=(
            args.pixels_per_lane if args.pixels_per_lane is not None
            else (CARD_PIXELS_PER_LANE if on_card else 1)
        ),
        rays_per_batch=args.rays_per_batch,
        mega_interleave=args.interleave if args.interleave is not None else 1,
        mega_dense=args.mega_dense,
        mega_tail_passes=(
            args.tail_passes if args.tail_passes is not None
            else (CARD_TAIL_PASSES if on_card else 1)
        ),
        mega_frames_per_batch=max(1, args.frames_per_batch),
        # The modular engine's brute-force sweep: kernel B3 on the card
        # (the exact sweep's bits), the exact sweep on the CPU.
        dense_engine="pallas" if on_card else "exact",
    )
    if args.tuned:
        from tpurt_torch import autotune

        key = autotune.device_key(device)
        knobs = autotune.load_tuned(key)
        if knobs:
            cfg = autotune.apply(knobs, cfg)
            print(f"Tuned knobs ({autotune.cache_path(key)}): {knobs}")
        else:
            print("no autotune cache for this platform; run "
                  "`python -m tpurt_torch.autotune` (using defaults)")

    from tpurt_torch.utils import profiling

    if not args.trace_dir:
        return _render(args, cfg, device, devices, world, sharded)
    with profiling.device_trace(args.trace_dir, device=device):
        rc = _render(args, cfg, device, devices, world, sharded)
    print(profiling.report(), file=sys.stderr)
    idle = profiling.idle_by_span(profiling.trace_events(args.trace_dir))
    print("device idle ms by span:", file=sys.stderr)
    for name, sec in sorted(idle.items(), key=lambda kv: -kv[1]):
        print(f"  {name:<28} {sec * 1e3:11.3f}", file=sys.stderr)
    return rc


def _render(args, cfg: RenderConfig, device, devices, world: int,
            sharded: bool) -> int:
    """Build the scene, render as the flags ask, write the output."""
    import torch

    from tpurt_torch import anim
    from tpurt_torch.io.bmp import write_bmp
    from tpurt_torch.io.checkpoint import TileAccumulator
    from tpurt_torch.render.renderer import render_frame
    from tpurt_torch.render.tonemap import tonemap
    from tpurt_torch.scene.jsonscene import scene_from_json
    from tpurt_torch.scene.presets import default_scene
    from tpurt_torch.utils.progress import ProgressReporter, mrays_per_second

    if args.scene_json:
        with open(args.scene_json) as f:
            scene, camera = scene_from_json(json.load(f), cfg, device)
    else:
        scene, camera, _ = default_scene(cfg, device)
    print(
        f"Scene: {scene.num_triangles} triangles, {scene.num_nodes} BVH "
        f"nodes, {scene.num_meshes} meshes"
    )

    live = sys.stderr.isatty()
    t0 = time.perf_counter()
    stats: dict = {}  # filled with {"segments": N} where the path supports it

    if args.view:
        from tpurt_torch.viewer import run_terminal

        # Interactive sessions run the plain flat megakernel schedule
        # (tpurt's choice: the staged drivers read counts on the host
        # between stages).
        run_terminal(scene, cfg.replace(compaction_threshold=0),
                     preview_path="preview.bmp")
        return 0

    if args.frames > 1:
        prog = ProgressReporter(args.frames, label="frames", live=live)
        paths = anim.render_video(scene, camera, cfg, progress=prog)
        prog.finish()
        print(f"Wrote {len(paths)} frames to {args.video_dir}/ "
              f"(assemble with scripts/render.sh)")
        return 0

    if args.progressive > 0:
        prog = ProgressReporter(args.progressive, label="passes", live=live)
        radiance = anim.progressive_render(
            scene, camera, cfg, args.progressive,
            preview_path="preview.bmp", preview_every=args.preview_every,
            progress=prog,
        )
        prog.finish()
    elif not sharded:
        tiles_x, tiles_y = cfg.tiles()
        prog = ProgressReporter(tiles_x * tiles_y, live=live)
        acc = (
            TileAccumulator(cfg, path=args.checkpoint) if args.checkpoint else None
        )
        radiance = render_frame(
            scene, camera, cfg, progress=prog, accumulator=acc, stats=stats
        )
        prog.finish()
    else:
        from tpurt_torch.parallel import make_mesh, mesh_info, render_frame_sharded

        if args.cpu:
            # The CPU fills as many positions as the axes ask (tpurt's
            # tests render on virtual host devices), split evenly over
            # the processes.
            n = (args.tile_devices or world) * args.sample_devices
            if n % world:
                print(f"error: {n} mesh positions do not split over {world} "
                      "processes", file=sys.stderr)
                return 2
            devices = [device] * (n // world)
        try:
            mesh = make_mesh(args.tile_devices, args.sample_devices,
                             devices=devices)
            print(mesh_info(mesh))
            radiance = render_frame_sharded(
                scene, camera, cfg, mesh=mesh,
                overdecompose=args.overdecompose, stats=stats,
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    elapsed = time.perf_counter() - t0
    # Tonemapped on the scene's device, as render_image does per batch.
    pixels = tonemap(torch.as_tensor(np.ascontiguousarray(radiance),
                                     device=scene.device))
    write_bmp(args.output, pixels.cpu().numpy())
    if stats.get("segments"):
        # Exact path-segment count from the integrator (the true "rays"
        # of Mrays/s — rays = W*H*spp*avg_path_length, SURVEY.md §6).
        rate = f"{stats['segments'] / elapsed / 1e6:.1f} Mrays/s"
    else:
        # Paths without segment accounting report the primary-ray lower
        # bound (avg path length >= 1.0).
        mrays = mrays_per_second(
            cfg.width, cfg.height, cfg.rays_per_pixel, 1.0, elapsed
        )
        rate = f">= {mrays:.1f} Mrays/s"
    print(
        f"Rendered {cfg.width}x{cfg.height} @ {cfg.rays_per_pixel} spp in "
        f"{elapsed:.2f}s ({rate}) -> {args.output}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
