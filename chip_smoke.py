#!/usr/bin/env python3
"""Drive tpurt_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root, one card

Phases (each raises on failure, so any failure exits nonzero):

1. Versions: torch, CUDA, nvcc, Triton, the card and its power limit.
2. Build the megakernel (csrc/megakernel.cu) with nvcc into build/.
3. Small check, Cornell sphere 64x64, 2 spp, 3 bounces, P=2, tail 2:
   the CUDA kernel against the plain torch version on the card — lane
   state after 1, 4 and 16 trips (integer fields equal on >= 99.5% of
   lanes), the whole frame (<= 0.5% of pixels differ) and the segment
   counts (within 0.5%).
4. The same on the 69,120-triangle bunny scene at 480x270, 8 spp,
   4 bounces, P=8, tail 5.
5. The slice at full size: bunny 1920x1080, 8 spp, 4 bounces, P=8,
   tail 5, plain schedule, ``render_image`` with mega_body="auto". The
   kernel must be launched, the frame finite and more than 5% lit. The
   kernel and the plain version also run 16 trips of the full 262,144-
   lane batch from one state (compared and timed), and 3 frames are
   timed after the first with CUDA events.

The last two lines of standard output are the kernel table as JSON and
{"ok": true, "device": {...}}. There is no CPU path: without a CUDA
device the script raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
LANE_AGREE = 0.995  # integer lane-state fields equal on >= 99.5% of lanes
MAX_FLIP = 0.005  # frames: <= 0.5% of pixels differ (knife-edge class)
SEG_TOL = 0.005  # segment counts within 0.5%
KERNEL_SOURCE = "tpurt_torch/csrc/megakernel.cu"
REPLACES = "tpurt/render/mega_pallas.py:237"


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def mostly_bitwise(a, b, what: str) -> float:
    """Fraction of pixels that differ; raises beyond MAX_FLIP."""
    import numpy as np

    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        raise AssertionError(f"{what}: non-finite values")
    frac = float((a != b).any(axis=-1).mean())
    if frac > MAX_FLIP:
        raise AssertionError(f"{what}: {frac:.4%} of pixels differ")
    return frac


def phase1():
    import torch

    log("torch", torch.__version__, "cuda", torch.version.cuda)
    from tpurt_torch import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    try:
        import triton

        log("triton", triton.__version__)
    except ImportError:
        log("triton not installed")
    log("card:", smi(), "| device count", torch.cuda.device_count())


def phase2():
    from tpurt_torch import _build
    from tpurt_torch.render import mega_cuda

    t0 = time.time()
    mega_cuda._lib()
    log(f"built megakernel in {time.time() - t0:.1f} s")
    for line in _build.build_log("megakernel").splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            log("  ptxas:", line.strip())


def compare_backends(name, scene, cam, cfg, trips=(1, 4, 16)):
    """Kernel against the plain version on the card: lane states after
    ``trips`` trips, then whole frames and segment counts."""
    import torch

    from tpurt_torch.render import mega_cuda
    from tpurt_torch.render.megakernel import run_megakernel
    from tpurt_torch.render.renderer import flat_batch_args, render_frame

    args = flat_batch_args(scene, cam, cfg, 0)
    for k in trips:
        st = {b: run_megakernel(scene, body_backend=b, max_iterations=k,
                                return_state=True, **args)
              for b in ("plain", "cuda")}
        agree, err = mega_cuda.compare_lanes(st["plain"], st["cuda"])
        log(f"{name}: after {k} trips, integer fields agree on "
            f"{agree:.4%} of {args['pixel_index'].shape[0]} lanes, float "
            f"max abs err {err:.3g}")
        if agree < LANE_AGREE:
            raise AssertionError(f"{name}: lane state agreement {agree:.4%}")
    out = {}
    for body in ("xla", "pallas"):
        stats = {}
        torch.cuda.synchronize()
        t0 = time.time()
        img = render_frame(scene, cam, cfg.replace(mega_body=body), stats=stats)
        torch.cuda.synchronize()
        out[body] = (img, stats, time.time() - t0)
    frac = mostly_bitwise(out["pallas"][0], out["xla"][0], name)
    sk, sp = out["pallas"][1]["segments"], out["xla"][1]["segments"]
    log(f"{name}: frames differ on {frac:.4%} of pixels; segments kernel "
        f"{sk} plain {sp}; trips kernel {out['pallas'][1]['trips']} plain "
        f"{out['xla'][1]['trips']}; wall s kernel {out['pallas'][2]:.3f} "
        f"plain {out['xla'][2]:.3f}")
    if abs(sk - sp) > SEG_TOL * sp:
        raise AssertionError(f"{name}: segment counts {sk} vs {sp}")


def phase3():
    from tpurt.config import RenderConfig
    from tpurt_torch.scene.presets import cornell_sphere_scene

    cfg = RenderConfig(width=64, height=64, rays_per_pixel=2, max_bounces=3,
                       pixels_per_lane=2, mega_tail_passes=2)
    scene, cam, _ = cornell_sphere_scene(2, cfg, device="cuda")
    compare_backends("cornell-sphere-64", scene, cam, cfg)


def bunny_scene(cfg, device="cuda"):
    """bench.py's "bunny" scene: assets/blob69k.obj in the Cornell box."""
    from tpurt_torch.scene.builder import SceneBuilder
    from tpurt_torch.scene.obj import load_obj
    from tpurt_torch.scene.presets import scene_around

    b = SceneBuilder()
    pos, nrm = load_obj(os.path.join(ROOT, "assets", "blob69k.obj"))
    return scene_around(b, b.add_triangles(pos, nrm), cfg, device)


def camera_for(cfg, device="cuda"):
    from tpurt_torch.core.camera import Camera

    return Camera.create(
        position=cfg.camera_position, pitch=cfg.camera_pitch,
        yaw=cfg.camera_yaw, roll=cfg.camera_roll,
        fov_degrees=cfg.fov_degrees, aspect_ratio=cfg.aspect_ratio,
        device=device)


def bunny_cfg(width, height):
    from tpurt.config import RenderConfig

    # bench.py's bunny-1080p-plain knobs, unpacked (one frame per launch).
    return RenderConfig(width=width, height=height, rays_per_pixel=8,
                        max_bounces=4, seed_mode="reference",
                        pixels_per_lane=8, mega_interleave=4,
                        mega_tail_passes=5, compaction_threshold=0)


def phase4():
    cfg = bunny_cfg(480, 270)
    t0 = time.time()
    scene, cam = bunny_scene(cfg)
    log(f"bunny scene: {scene.num_triangles} triangles, bank "
        f"{tuple(scene.mega_rows.shape)}, chain {scene.mega_chain}, built in "
        f"{time.time() - t0:.1f} s")
    compare_backends("bunny-480x270", scene, cam, cfg)
    return scene


def time_16_trips(scene, cam, cfg):
    """The full-size batch's first 16 trips through both backends from
    one lane state: agreement, kernel ms, plain ms."""
    import torch

    from tpurt_torch.render import mega_cuda
    from tpurt_torch.render import megakernel as mk
    from tpurt_torch.render.renderer import flat_batch_args

    lane, ctx = mk.prepare(scene, **flat_batch_args(scene, cam, cfg, 0))
    ev = lambda: torch.cuda.Event(enable_timing=True)
    buf0 = mega_cuda.pack(lane)
    mega_cuda.launch(buf0.clone(), ctx, 16)  # warm-up
    times = {}
    for backend in ("cuda", "plain", "cuda", "plain"):
        buf = buf0.clone()
        torch.cuda.synchronize()
        e0, e1 = ev(), ev()
        e0.record()
        if backend == "cuda":
            mega_cuda.launch(buf, ctx, 16)
        else:
            plain = mk.run_plain(lane, ctx, 16)
        e1.record()
        torch.cuda.synchronize()
        times.setdefault(backend, []).append(e0.elapsed_time(e1))
        if backend == "cuda":
            kern = mega_cuda.unpack(buf, ctx, lane.iters + 16)
    agree, err = mega_cuda.compare_lanes(plain, kern)
    log(f"1080p batch ({lane.done.shape[0]} lanes), 16 trips: integer "
        f"fields agree on {agree:.4%} of lanes, float max abs err {err:.3g}; "
        f"kernel ms {times['cuda']}, plain ms {times['plain']}")
    if agree < LANE_AGREE:
        raise AssertionError(f"1080p 16 trips: lane agreement {agree:.4%}")
    # The kernel alone on the whole batch, to completion.
    buf = buf0.clone()
    e0, e1 = ev(), ev()
    e0.record()
    trips = mega_cuda.launch(buf, ctx, None)
    e1.record()
    torch.cuda.synchronize()
    log(f"1080p batch to completion: kernel {e0.elapsed_time(e1):.3f} ms, "
        f"{int(trips.max())} trips for the slowest lane, mean "
        f"{float(trips.float().mean()):.1f}")
    return agree, err, min(times["cuda"]), min(times["plain"])


def phase5(scene):
    import numpy as np
    import torch

    from tpurt_torch.render import mega_cuda
    from tpurt_torch.render.renderer import render_image

    cfg = bunny_cfg(1920, 1080)
    cam = camera_for(cfg)
    agree, err, ms, plain_ms = time_16_trips(scene, cam, cfg)

    # The main path, counted: render_image with mega_body="auto".
    mega_cuda.LAUNCHES = 0
    stats = {}
    img = render_image(scene, cam, cfg, stats=stats)
    launches = mega_cuda.LAUNCHES
    if launches < 1:
        raise AssertionError("render_image did not launch the megakernel")
    if img.shape != (cfg.height, cfg.width, 3) or img.dtype != np.uint8:
        raise AssertionError(f"frame {img.shape} {img.dtype}")
    lit = float((img.max(axis=-1) > 0).mean())
    log(f"main path: {launches} kernel launch(es), {stats['segments']} "
        f"segments, {stats['trips']} trips, lit fraction {lit:.4f}, mean "
        f"pixel {img.mean():.3f}")
    if lit <= 0.05:
        raise AssertionError(f"lit fraction {lit:.4f}")

    frame_ms = []
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        again = render_image(scene, cam, cfg)
        e1.record()
        torch.cuda.synchronize()
        frame_ms.append(e0.elapsed_time(e1))
        if not np.array_equal(again, img):
            raise AssertionError("a repeated frame differs")
    best = min(frame_ms)
    card = smi()
    log(f"bunny-1080p-plain frame ms {[round(t, 3) for t in frame_ms]} "
        f"(best {best:.3f}); {stats['segments']} exact path segments -> "
        f"{stats['segments'] / best / 1e3:.3f} Mrays/s | card: {card}")
    return dict(name="megakernel", route="cuda", source=KERNEL_SOURCE,
                replaces=REPLACES, launches=launches, max_abs_err=err,
                ms=ms, plain_ms=plain_ms)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    import tpurt_torch  # noqa: F401  (fails outside the repository)

    phase1()
    phase2()
    phase3()
    kernel = phase5(phase4())
    log(smi())
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
