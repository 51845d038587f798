#!/usr/bin/env python3
"""Drive tpurt_torch's paths on one CUDA card and check them.

    python3 chip_smoke.py                # from the repository root, one card
    python3 chip_smoke.py --b3-public    # B3's parity launches and frames only
    python3 chip_smoke.py --b1-public    # B1's headline batch only

Phases (each raises on failure, so any failure exits nonzero):

1. Versions: torch, CUDA, nvcc, Triton, the card and its power limit.
2. Build every kernel (csrc/megakernel.cu, dense_sweep.cu, mt_sweep.cu)
   and the C++ BVH builder, one compiler process each, all at once.
3. B1, small: Cornell sphere 64x64, 2 spp, 3 bounces, P=2, tail 2 — the
   megakernel against its plain torch version on the card: lane state
   after 1, 4 and 16 trips (integer fields equal on >= 99.5% of lanes),
   the whole frame (<= 0.5% of pixels differ), segments within 0.5%.
4. B1, the same on the 69,120-triangle bunny at 480x270, 4 bounces,
   P=8, tail 5, and 2 spp (the headline's 8 cut to 2: at 8 spp its plain
   frame took ~235 s on an H100).
5. B1's path at full size, bunny-1080p-plain: 16 trips of the 262,144-
   lane batch through kernel and plain version (compared, timed), the
   kernel to completion (its persistent launch: resident blocks, lanes
   per thread; slowest and mean lane trips; the bound counted from the
   kernel's per-lane work), ``render_image`` with mega_body="auto"
   (launches counted), 3 frames timed.
6. B2 alone at full width: 230,400 primary rays of the teapot frame
   (every fourth pixel, so the whole frame is sampled) in the teapot's
   local space against its 6,144 triangle columns, through the block
   sweep — columns equal on every ray, t bit-identical — both timed.
7. B2's path at full size, teapot-720p-bruteforce: 4 trips of the
   230,400-lane batch through the dense megakernel and its plain
   version, the kernel to completion (launch, trips and counted bound as
   in phase 5), ``render_image`` (dense launches counted), 3 frames
   timed.
8. B2's path, small: teapot at 320x180 with the same knobs, the dense
   megakernel against its plain version as in phase 3.
9. B3 alone at full width: the 307,200 camera rays of the 640x480 frame
   in the sphere's local space against its 1,280 rows, read from the
   scene's layout by range as the engine reads them — rows equal on
   every ray, t bit-identical — timed with the host around it (the
   kernel table's ``ms``) and on the device (``device_ms``); its bound,
   counted from the operations the sweep needs (``mt_loop_ops``) and,
   for comparison, as counted before the layout (``mt_sweep_ops``); the
   share of det-passing pairs the pre-test sends to the division; the
   loop's issued f32 operations against the unfused ceiling at the SM
   clock measured under it. Then each of the parity frame's 18 launches
   as the engine makes them, recorded from one frame (6 tiles of 65,536
   rays; per tile the fused walls through their id list, the OneSided
   front wall and the sphere by range), each equal to the plain version
   and timed both ways; their sums are B3's time per frame.
10. B3's path at full size: the parity-640x480-1spp frame through
   engine="modular", dense_engine="pallas" (B3 launches counted), held
   against the megakernel's frame (<= 0.5% of pixels) and against
   dense_engine="exact" (identical), 3 frames timed.
11. B1's TLAS instantiation, small: tpurt's K = 12 instance grid
   (tests/test_many_meshes.py) at 160x90, 2 spp, 3 bounces, P=2, tail 2,
   against the plain version as in phase 3; then its frame against the
   same geometry frozen as an unrolled chain (MEGA_TLAS_THRESHOLD
   raised) and against engine="modular", with the pixels that differ
   counted (0 expected).
12. B1's TLAS path at full size, grid-64-720p-tlas (probe r74's 230k-lane
   leg, scripts/probe_r74.py): 64 icosphere(1) instances on the grid in
   the Cornell box, 1280x720, 4 spp, 4 bounces, P=4, tail 3, one launch
   of 230,400 lanes: as phase 5 (16 trips through both backends, the
   kernel to completion with instance enters and exits in its counted
   bound, ``render_image`` with its launches counted, 3 frames timed).
13. B1's bf16 instantiation (MEGA_BF16_BOUNDS): the bunny at phase 4's
   knobs (2 spp) and the K = 12 grid against the plain version as in phase 3,
   each bf16 frame against the u8 frame (equal segments, pixels that
   differ counted), the grid packed F = 2 as in phase 14, and the
   bunny-1080p batch's 16 trips in u8 and bf16 in turns.
14. Cross-frame packing, small: the Cornell sphere (phase 3's knobs) and
   the K = 12 grid (phase 11's), each packed F = 2 with a rotation-only
   second camera and F = 3 with one camera (the shared direction
   table), and the teapot at 320x180 through the dense instantiation,
   F = 2: B1's packed launch against the plain version in every lane
   field after 1, 4 and 16 trips, and every packed frame of every batch
   bit for bit the frame rendered alone through B1, the segments summing
   equal.
15. The headline packed, bunny-1080p-plain with mega_frames_per_batch=2
   (one launch of 262,144 lanes x 16 slots covering frames 0 and 1): 16
   trips against the plain version and the batch to completion as in
   phase 5 (trips, counted bound); both frames bit for bit the unpacked
   frames 0 and 1; the pack through the video path's dispatch (B1
   launches counted) timed against the unpacked ``render_image`` frame in
   turns, 3 of each. Then the parity row on the megakernel packed F = 4
   (bench.py:567-571), its four frames equal to ``render_image``'s and
   timed the same way.
16. The other schedules, small (the Cornell sphere at 64x64 through B1): a
   sample_flatten frame equal to the in-lane frame (decorrelated); a
   ``rays_per_batch=0`` tiled frame and ``render_tile`` with the
   megakernel equal to the flat frame; a TileAccumulator resume giving
   the same image with no launch; ``anim.render_video`` of 3 frames
   (hook ``video_frame_scene``) and a static-hook video packed 2 frames
   a launch, their BMPs read back equal to ``render_image`` of each
   frame. Then presets.deep_stack_scene (mega_stack_depth 36: 72 stack
   words in global memory, of which its primary rays hold 67) through
   B1's deep-stack instantiation against the plain version as in phase
   3 (1 spp, P=1) after 1, 16, 34 and 100 trips, with its budget cut to 66 words (a
   full stack drops its bottom entry) and packed F = 2 as in phase 14,
   its first 34 trips timed, its frame counted.

Every scene's ``mega_stack_depth`` is logged where a phase first drives
it. Each path's launch counts are set to 0 just before its counted
``render_image`` and read just after. ``--b1-public`` builds B1 alone
and times the bunny-1080p batch through ``mega_cuda.launch`` on the
device (16 trips, then to completion), calls every version of the port
has, so the same script times an earlier tree's headline kernel.
``--b3-public`` builds B3 alone
and times it through the public entry ``mt_sweep.mt_sweep`` on phase
9's full-width rays and on the parity frame's launches (rebuilt from
calls every version of the port has), then the parity scene's modular
frames, so the same script times an earlier tree's B3 path. Times are
printed beside the card's name and power limit. The last two lines of
standard output are the kernel table as JSON and {"ok": true,
"device": {...}}. There is no CPU path: without a CUDA device the
script raises.
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
PEAK_F32 = 67e12  # H100 SXM f32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM bytes/s
SPIN_CYCLES = 2_000_000  # device_ms's spin, ~1 ms: longer than a wrapper's host work
# f32 operations of the megakernel's branches, read stage by stage off
# csrc/megakernel.cu, for its per-lane work counts. Where a branch
# leaves early on its data, only the stages that always run are counted,
# so the bound they give stays a lower bound.
#: A child-box test of a node row: 6 u8 -> f32 conversions, the box on
#: the node's grid (6 mul, 6 add), the slab test (6 sub, 6 mul, 6
#: NaN-guarded min/max at 3 each, 4 min/max, a max and 2 compares).
BOX_OPS = 55
#: The same test on a bf16 node row: the bounds are bits (shift and
#: mask), so only the slab test's 37 operations remain.
BOX_OPS_BF16 = 37
#: An instance enter: origin - pos (3 sub), two rotations (9 mul, 6 add
#: each), 6 divisions by the scale, the normalisation (3 mul, 2 add, a
#: square root, a reciprocal, 3 mul), 3 reciprocals, the pretest's limit
#: (a division, a multiply) and slab test (37), the scale test.
INST_ENTER_OPS = 92
#: An instance exit: the world ray recomputed as the chain enter does it
#: (3 sub, 30 for the two rotations, 6 divisions, 10 to normalise, 3
#: reciprocals). The fold of a hit, which not every exit makes, is not
#: counted.
INST_EXIT_OPS = 52
#: One triangle of a leaf row up to its det test: e1, e2 (6 sub),
#: h = ld x e2 (6 mul, 3 sub), det (3 mul, 2 add), a compare.
MT_DET_OPS = 21
#: A segment completion's shading tail, whatever the material: the
#: throughput weight (3 mul), emission (6 mul), light (3 add), the
#: colour (3 mul), Russian roulette's max and q (10). The material's own
#: scatter, the bounce origin, the static stage and the chain re-entry
#: of a restarted segment are not counted.
SHADE_OPS = 25
CARD = ""


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


def bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of operations / f32 peak and
    bytes / memory rate."""
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(fn, reps: int = 1):
    """(last result, [ms per call]) timed with CUDA events around each call."""
    import torch

    times, out = [], None
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return out, times


def reset_counts():
    from tpurt_torch.render import mega_cuda, mt_sweep, plucker_fused

    mega_cuda.LAUNCHES = mega_cuda.DENSE_LAUNCHES = 0
    mt_sweep.LAUNCHES = plucker_fused.LAUNCHES = 0


def counts() -> dict:
    from tpurt_torch.render import mega_cuda, mt_sweep, plucker_fused

    return dict(megakernel=mega_cuda.LAUNCHES, dense=mega_cuda.DENSE_LAUNCHES,
                mt_sweep=mt_sweep.LAUNCHES, dense_sweep=plucker_fused.LAUNCHES)


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
    log("card:", CARD, "| device count", torch.cuda.device_count())


def phase2():
    from tpurt_torch import _build

    names = ["megakernel", "dense_sweep", "mt_sweep", "tpurt_native"]
    t0 = time.time()
    done = _build.build_all(names)
    log(f"built {', '.join(f'{n} {s:.1f} s' for n, s in done.items())}; "
        f"all in {time.time() - t0:.1f} s")
    for name in names[:3]:
        for line in _build.build_log(name).splitlines():
            if any(k in line for k in ("entry function", "registers", "spill",
                                       "stack frame")):
                log(f"  ptxas {name}:", line.strip())


def log_depth(name, scene):
    """The scene's stack budget and where B1 keeps it."""
    from tpurt_torch.render import mega_cuda

    words = 2 * scene.mega_stack_depth
    where = ("global memory (deep-stack instantiation)"
             if words > mega_cuda.MAX_REGISTER_STACK else "the lane's array")
    log(f"{name}: mega_stack_depth {scene.mega_stack_depth}, {words} stack "
        f"words a lane in {where}")


def compare_backends(name, scene, cam, cfg, trips=(1, 4, 16)):
    """Kernel against the plain version on the card: lane states after
    ``trips`` trips, then whole frames and segment counts."""
    import torch

    from tpurt_torch.render import mega_cuda
    from tpurt_torch.render.megakernel import run_megakernel
    from tpurt_torch.render.renderer import flat_batch_args, render_frame

    log_depth(name, scene)
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
    from tpurt_torch.config import RenderConfig
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
    from tpurt_torch.config import RenderConfig

    # bench.py's bunny-1080p-plain knobs, unpacked (one frame per launch).
    return RenderConfig(width=width, height=height, rays_per_pixel=8,
                        max_bounces=4, seed_mode="reference",
                        pixels_per_lane=8, mega_interleave=4,
                        mega_tail_passes=5, compaction_threshold=0)


def teapot_cfg(width, height):
    from tpurt_torch.config import RenderConfig

    # bench.py's teapot-720p-bruteforce row (bench.py:579-587 with the
    # common knobs of :528-530): one launch of 230,400 lanes x P=4 covers
    # 1280x720.
    return RenderConfig(width=width, height=height, rays_per_pixel=8,
                        max_bounces=4, mega_dense=True, rays_per_batch=230400,
                        tile_size=256, seed_mode="reference", pixels_per_lane=4,
                        mega_interleave=4, mega_tail_passes=5,
                        compaction_threshold=0)


def parity_cfg():
    from tpurt_torch.config import RenderConfig

    # bench.py's parity-640x480-1spp row (bench.py:567-571 with the common
    # knobs), unpacked, through the modular engine and kernel B3.
    return RenderConfig(width=640, height=480, rays_per_pixel=1, max_bounces=1,
                        tile_size=256, seed_mode="reference", pixels_per_lane=8,
                        mega_interleave=4, mega_tail_passes=5,
                        compaction_threshold=0, engine="modular",
                        dense_engine="pallas")


def small_bunny_cfg():
    """Phases 4 and 13: the bunny's knobs at 480x270 and 2 spp."""
    return bunny_cfg(480, 270).replace(rays_per_pixel=2)


def phase4():
    cfg = small_bunny_cfg()
    t0 = time.time()
    scene, cam = bunny_scene(cfg)
    log(f"bunny scene: {scene.num_triangles} triangles, bank "
        f"{tuple(scene.mega_rows.shape)}, chain {scene.mega_chain}, built in "
        f"{time.time() - t0:.1f} s")
    compare_backends("bunny-480x270", scene, cam, cfg)
    return scene


def time_trips(scene, cam, cfg, k: int, label: str, args=None):
    """The full-size batch's first ``k`` trips through both backends from
    one lane state (agreement, kernel ms, plain ms, the lane work those
    k trips did), then the kernel alone to completion, twice (ms, trips,
    work), with its persistent launch configuration. ``args``: the
    batch's run_megakernel arguments (default: the flat batch at 0)."""
    import torch

    from tpurt_torch.core.v3 import V3
    from tpurt_torch.render import mega_cuda
    from tpurt_torch.render import megakernel as mk
    from tpurt_torch.render.renderer import flat_batch_args

    log_depth(label, scene)
    lane, ctx = mk.prepare(scene, **(args or flat_batch_args(scene, cam, cfg, 0)))
    buf0 = mega_cuda.pack(lane)
    r = lane.done.shape[0]
    mega_cuda.launch(buf0.clone(), ctx, k)  # warm-up
    times = {}
    for backend in ("cuda", "plain", "cuda", "plain"):
        buf = buf0.clone()
        if backend == "cuda":
            (trips_k, work_k), ms = cuda_ms(lambda: mega_cuda.launch(buf, ctx, k))
            kern, kbuf = mega_cuda.unpack(buf, ctx, lane.iters + k), buf
        else:
            plain, ms = cuda_ms(lambda: mk.run_plain(lane, ctx, k))
        times.setdefault(backend, []).extend(ms)
    agree, err = mega_cuda.compare_lanes(plain, kern)
    log(f"{label} batch ({r} lanes), {k} trips: integer "
        f"fields agree on {agree:.4%} of lanes, float max abs err {err:.3g}; "
        f"kernel ms {times['cuda']}, plain ms {times['plain']} | {CARD}")
    if agree < LANE_AGREE:
        raise AssertionError(f"{label} {k} trips: lane agreement {agree:.4%}")
    # The next k trips from the kernel's k-trip state: the rate of later,
    # less coherent trips against the first ones.
    later = kbuf.clone()
    (trips_2k, _w), later_ms = cuda_ms(lambda: mega_cuda.launch(later, ctx, k))
    n_k, n_2k = int(trips_k.long().sum()), int(trips_2k.long().sum())
    log(f"{label}: trips 1-{k} {min(times['cuda']):.3f} ms for {n_k} lane trips "
        f"({n_k / min(times['cuda']) * 1e3:.4g}/s); trips {k + 1}-{2 * k} "
        f"{later_ms[0]:.3f} ms for {n_2k} ({n_2k / later_ms[0] * 1e3:.4g}/s) | {CARD}")
    full = []
    for _ in range(2):
        buf = buf0.clone()
        (trips, work), ms = cuda_ms(lambda: mega_cuda.launch(buf, ctx, None))
        full.extend(ms)
    launch = mega_cuda.launch_config(ctx.dense is not None, tlas=ctx.tlas,
                                     bf16=ctx.bf16, deep=mega_cuda.deep_stack(ctx))
    blocks = min(launch["blocks_per_sm"] * launch["sms"],
                 -(-r // launch["threads"]))
    log(f"{label} persistent launch: {blocks} blocks x {launch['threads']} "
        f"threads ({launch['blocks_per_sm']} resident per SM x {launch['sms']} "
        f"SMs = {launch['resident_lanes']} resident lanes) for {r} lanes, "
        f"{r / (blocks * launch['threads']):.2f} lanes per thread")
    log(f"{label} batch to completion: kernel ms {full}, {int(trips.max())} "
        f"trips for the slowest lane, mean {float(trips.float().mean()):.2f}, "
        f"{int(trips.long().sum())} lane trips | {CARD}")
    # The slowest lane alone, from its first state: how long its chain of
    # trips takes with the card to itself (the floor under a batch that
    # starts it late). It must end where it ended in the batch.
    i = int(trips.argmax())
    ctx1 = ctx if ctx.slot_rd is None else ctx._replace(
        slot_rd=V3(*(c[:, i:i + 1].contiguous() for c in ctx.slot_rd)))
    if ctx.slot_pix is not None:
        ctx1 = ctx1._replace(slot_pix=ctx.slot_pix[:, i:i + 1].contiguous())
    buf1 = buf0[:, i:i + 1].contiguous()
    _out, one_ms = cuda_ms(lambda: mega_cuda.launch(buf1, ctx1, None))
    if not torch.equal(buf1[:, 0], buf[:, i]):
        raise AssertionError(f"{label}: the slowest lane alone ended elsewhere")
    tenth = max(1, r // 10)
    log(f"{label} slowest lane (index {i}) alone: {one_ms[0]:.3f} ms for its "
        f"{int(trips[i])} trips; mean trips of the first / last tenth of the "
        f"lane indices {float(trips[:tenth].float().mean()):.1f} / "
        f"{float(trips[-tenth:].float().mean()):.1f} | {CARD}")
    done = mega_cuda.unpack(buf, ctx, lane.iters)
    return dict(err=err, ms=min(times["cuda"]), plain_ms=min(times["plain"]),
                full_ms=min(full), work_k=[int(w) for w in work_k.long().sum(1)],
                work=[int(w) for w in work.long().sum(1)], lanes=r, ctx=ctx,
                adv_k=kern.pixno - lane.pixno, adv=done.pixno - lane.pixno,
                state=buf, trips=trips)


def main_path(name, scene, cam, cfg, counter: str, min_lit=0.05):
    """``render_image`` counted (counts reset just before, read just
    after), checked (uint8 (H, W, 3), more than ``min_lit`` of it lit)
    and timed (3 frames after it); returns (image, stats, launches, best
    ms)."""
    import numpy as np

    from tpurt_torch.render.renderer import render_image

    reset_counts()
    stats = {}
    img = render_image(scene, cam, cfg, stats=stats)
    launched = counts()
    if launched[counter] < 1:
        raise AssertionError(f"{name}: render_image launched no {counter} kernel "
                             f"({launched})")
    if img.shape != (cfg.height, cfg.width, 3) or img.dtype != np.uint8:
        raise AssertionError(f"{name}: frame {img.shape} {img.dtype}")
    lit = float((img.max(axis=-1) > 0).mean())
    log(f"{name} main path: launches {launched}, {stats['segments']} segments, "
        f"lit fraction {lit:.4f}, mean pixel {img.mean():.3f}")
    if min_lit is not None and lit <= min_lit:
        raise AssertionError(f"{name}: lit fraction {lit:.4f}")
    again, frame_ms = cuda_ms(lambda: render_image(scene, cam, cfg), reps=3)
    if not np.array_equal(again, img):
        raise AssertionError(f"{name}: a repeated frame differs")
    best = min(frame_ms)
    log(f"{name} frame ms {[round(t, 3) for t in frame_ms]} (best {best:.3f}); "
        f"{stats['segments']} exact path segments -> "
        f"{stats['segments'] / best / 1e3:.3f} Mrays/s | {CARD}")
    return img, stats, launched[counter], best


def megakernel_bound(scene, tt, work, adv, label: str):
    """B1's bound for a launch whose lanes did ``work`` (child-box tests,
    leaf rows, segment completions) and advanced ``adv`` (R,) quota
    slots: those counts times their branches' operations; the bank and
    each lane's words read once, the lane words written once, and the
    slot table rows the lanes read (a lane reads one direction row, and
    in a pack one pixel row, where it advances), each once."""
    from tpurt_torch.render import mega_cuda

    ctx = tt["ctx"]
    words = len(mega_cuda.LANE_WORDS) + ctx.s_depth + (
        3 * ctx.p_count if ctx.p_count > 1 else 0) + (
        len(mega_cuda.TLAS_WORDS) if ctx.tlas else 0)
    tables = 0
    if ctx.slot_rd is not None:
        a = adv.long()
        tables = int(a.clamp(max=ctx.slot_rd.x.shape[0]).sum()) * 12
        if ctx.slot_pix is not None:
            tables += int(a.clamp(max=ctx.ppf).sum()) * 4
    nbytes = (scene.mega_rows.numel() * 4 + tables
              + 2 * words * 4 * tt["lanes"])
    boxes, leaves, segs, enters, exits = (list(work) + [0, 0])[:5]
    box_ops = BOX_OPS_BF16 if ctx.bf16 else BOX_OPS
    ops = (boxes * box_ops + leaves * ctx.leaf_tris * MT_DET_OPS
           + segs * SHADE_OPS + enters * INST_ENTER_OPS + exits * INST_EXIT_OPS)
    b_ms, b_by = bound(ops, nbytes)
    log(f"B1 bound, {label}: {b_ms:.3f} ms ({b_by}): {boxes} box tests x "
        f"{box_ops} + {leaves} leaf rows x {ctx.leaf_tris} x {MT_DET_OPS} + "
        f"{segs} segments x {SHADE_OPS} + {enters} instance enters x "
        f"{INST_ENTER_OPS} + {exits} exits x {INST_EXIT_OPS} = {ops:.4g} ops, "
        f"{nbytes} bytes ({tables} of slot table rows)")
    return b_ms, b_by


def phase5(scene):
    cfg = bunny_cfg(1920, 1080)
    cam = camera_for(cfg)
    tt = time_trips(scene, cam, cfg, 16, "bunny-1080p")
    img, _stats, launches, best = main_path(
        "bunny-1080p-plain", scene, cam, cfg, "megakernel")
    b_ms, b_by = megakernel_bound(scene, tt, tt["work_k"], tt["adv_k"], "16 trips")
    f_ms, _f_by = megakernel_bound(scene, tt, tt["work"], tt["adv"], "whole batch")
    log(f"B1 whole batch: {tt['full_ms']:.3f} ms against its bound "
        f"{f_ms:.3f} ms | {CARD}")
    # img, frame_ms and full_ms are for phase 15 (not in the kernels line).
    return dict(name="megakernel (B1)", route="cuda",
                source="tpurt_torch/csrc/megakernel.cu",
                replaces="tpurt/render/mega_pallas.py:237", launches=launches,
                max_abs_err=tt["err"], ms=tt["ms"], plain_ms=tt["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                img=img, frame_ms=best, full_ms=tt["full_ms"])


def dense_sweep_ops(lo, ld, entry, table):
    """f32 operations the block sweep does on these inputs, stage by
    stage as the kernel leaves a column early: every pair 21 (det: 3 mul,
    2 add; the u numerator: 6 mul, 5 add; the det test and the pre-test:
    2 multiplies, 3 compares); kept by both tests 4 (reciprocal, a
    multiply, 2 compares); u in range 15 (v the same, u + v, 2
    compares); v in range 11 (t: 3 mul 3 add, a multiply, 2 compares,
    the cull test). Also returns the share of det-passing pairs that
    reach the division."""
    import torch

    from tpurt_torch.core.v3 import V3
    from tpurt_torch.render import plucker_fused as pf

    ops = n_det = n_keep = 0.0
    for e in range(table.entry_range.shape[0]):
        a, b = (int(x) for x in table.entry_range[e])
        c = table.coeffs[:, :, a:b]
        rows = torch.nonzero(entry == e)[:, 0]
        for r0 in range(0, rows.shape[0], 4096):
            idx = rows[r0:r0 + 4096]
            o = V3(*(x[idx, None] for x in lo))
            d = V3(*(x[idx, None] for x in ld))
            det, u_num, v_num, _t = pf._planes(o, d, c)
            ok_det = torch.abs(det) >= pf._EPS
            keep = ok_det & ~pf.u_pretest_drops(det, u_num)
            f = 1.0 / det
            u = f * u_num
            ok_u = keep & (u >= 0.0) & (u <= 1.0)
            v = f * v_num
            ok_v = ok_u & (v >= 0.0) & (u + v <= 1.0)
            n_det += float(ok_det.sum())
            n_keep += float(keep.sum())
            ops += (21.0 * det.numel() + 4.0 * float(keep.sum())
                    + 15.0 * float(ok_u.sum()) + 11.0 * float(ok_v.sum()))
    return ops, n_keep / max(n_det, 1.0)


def teapot_sweep_inputs(device="cuda"):
    """B2's inputs at full width: one primary ray per lane of the teapot
    batch, from every fourth pixel (so the whole frame is sampled), in
    the teapot's local space -> (scene, lo, ld, entry, table)."""
    import torch

    from tpurt_torch.core import v3 as v3lib
    from tpurt_torch.core.camera import make_ray, pixel_uv
    from tpurt_torch.render import plucker_fused as pf
    from tpurt_torch.render.intersect import local_rays
    from tpurt_torch.scene.presets import bench_scene

    cfg = teapot_cfg(1280, 720)
    scene, cam = bench_scene("teapot", cfg, device=device)
    table = pf.build_dense_table(scene)
    pix = torch.arange(0, cfg.width * cfg.height, cfg.pixels_per_lane,
                       device=device)
    ro, rd = make_ray(cam, pixel_uv(pix % cfg.width, pix // cfg.width,
                                    cfg.width, cfg.height))
    (mesh, _root, _leaf), = scene.mega_chain
    lo, ld = local_rays(scene, mesh, v3lib.from_rows(ro), v3lib.from_rows(rd))
    entry = torch.zeros(pix.shape[0], dtype=torch.int32, device=device)
    return scene, lo, ld, entry, table


def phase6():
    """B2 alone at full width (teapot_sweep_inputs)."""
    import torch

    from tpurt_torch.render import plucker_fused as pf

    scene, lo, ld, entry, table = teapot_sweep_inputs()
    r = entry.shape[0]
    log(f"teapot scene: {scene.num_triangles} triangles, {table.count} columns "
        f"in {table.entry_range.shape[0]} chain entry, {r} rays")
    pf.sweep_entry_local(lo, ld, entry, table)  # warm-up
    (t, col), k_ms = cuda_ms(
        lambda: pf.sweep_entry_local(lo, ld, entry, table), reps=3)
    (tp, colp), p_ms = cuda_ms(
        lambda: pf.sweep_plain(lo, ld, entry, table), reps=2)
    same_col = float((col == colp).float().mean())
    hit = colp >= 0
    same_t = bool(torch.equal(t, tp))
    err = float((t - tp)[hit].abs().max()) if bool(hit.any()) else 0.0
    log(f"B2 alone: {r} rays x {table.count} columns, hit "
        f"{float(hit.float().mean()):.4f}; columns equal on {same_col:.6%}, t "
        f"bit-identical {same_t}; kernel ms {k_ms}, plain ms {p_ms} | {CARD}")
    if same_col < 1.0 or not same_t:
        raise AssertionError("B2 kernel differs from its plain version")
    ops, divided = dense_sweep_ops(lo, ld, entry, table)
    tpad = table.ids.shape[0]
    nbytes = (r * 7 * 4 + (table.coeffs.numel() + table.det_u.numel()) * 4
              + 2 * tpad * 4 + r * 8)
    b_ms, b_by = bound(ops, nbytes)
    log(f"B2 bound {b_ms:.3f} ms ({b_by}): {ops:.4g} ops "
        f"({ops / (r * table.count):.2f} per pair), {nbytes} bytes; the "
        f"pre-test sends {divided:.4%} of det-passing pairs to the division")
    return dict(name="dense_sweep (B2)", route="cuda",
                source="tpurt_torch/csrc/dense_sweep.cuh",
                replaces="tpurt/render/plucker_fused.py:251", launches=None,
                max_abs_err=err, ms=min(k_ms), plain_ms=min(p_ms),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                ops_per_pair=ops / (r * table.count))


def phase7(b2):
    from tpurt_torch.scene.presets import bench_scene

    cfg = teapot_cfg(1280, 720)
    scene, cam = bench_scene("teapot", cfg, device="cuda")
    tt = time_trips(scene, cam, cfg, 4, "teapot-720p-dense")
    _img, _stats, launches, _best = main_path(
        "teapot-720p-bruteforce", scene, cam, cfg, "dense")
    # The batch's sweeps (counted by the kernel; the teapot is one entry of
    # every column) at the primary sweep's operations per pair, plus the
    # shading tails.
    cols = tt["ctx"].dense.count
    _boxes, sweeps, segs = tt["work"][:3]
    f_ms, f_by = bound(sweeps * cols * b2["ops_per_pair"] + segs * SHADE_OPS, 0)
    log(f"teapot-720p-bruteforce: dense kernel to completion {tt['full_ms']:.3f} "
        f"ms against its bound {f_ms:.3f} ms ({f_by}: {sweeps} sweeps x {cols} "
        f"columns x {b2['ops_per_pair']:.2f} ops + {segs} segments x "
        f"{SHADE_OPS}) | {CARD}")
    b2["launches"] = launches
    return b2


def phase8():
    from tpurt_torch.scene.presets import bench_scene

    cfg = teapot_cfg(320, 180)
    scene, cam = bench_scene("teapot", cfg, device="cuda")
    compare_backends("teapot-320x180-dense", scene, cam, cfg)


def mt_sweep_counts(ro, rd, rows, count) -> dict:
    """How far the exact sweep's pairs of these inputs get, counted in
    torch in the plain version's op order: all pairs, |det| >= eps, kept
    by B3's u pre-test as well (plucker_fused.u_pretest_drops, the
    kernel's test), u in range, v in range."""
    import torch

    from tpurt_torch.core import v3 as v3lib
    from tpurt_torch.core.v3 import V3
    from tpurt_torch.render import plucker_fused as pf
    from tpurt_torch.render.intersect import _EPS, _tri_v3

    n = dict(pairs=0.0, det=0.0, kept=0.0, u=0.0, v=0.0)
    tri = rows[:count][None]
    pa = _tri_v3(tri, 0)
    e1, e2 = _tri_v3(tri, 3) - pa, _tri_v3(tri, 6) - pa
    for r0 in range(0, ro.shape[0], 4096):
        o = V3(*(ro[r0:r0 + 4096, i, None] for i in range(3)))
        d = V3(*(rd[r0:r0 + 4096, i, None] for i in range(3)))
        h = v3lib.cross(d, e2)
        det = v3lib.dot(e1, h)
        ok_det = torch.abs(det) >= _EPS
        s = o - pa
        u_num = v3lib.dot(s, h)
        u = u_num / det
        ok_u = ok_det & (u >= 0.0) & (u <= 1.0)
        v = v3lib.dot(d, v3lib.cross(s, e1)) / det
        ok_v = ok_u & (v >= 0.0) & (u + v <= 1.0)
        n["pairs"] += float(det.numel())
        n["det"] += float(ok_det.sum())
        n["kept"] += float((ok_det & ~pf.u_pretest_drops(det, u_num)).sum())
        n["u"] += float(ok_u.sum())
        n["v"] += float(ok_v.sum())
    return n


def mt_sweep_ops(n: dict) -> float:
    """f32 operations of the exact sweep on pairs counted by
    ``mt_sweep_counts``, stage by stage as a pair leaves early, with the
    edges made per pair and the division on every pair that passes det
    (B3's bound before the scene layout and the pre-test; logged beside
    ``mt_loop_ops`` so that the two stay comparable): every pair 21 (e1,
    e2, h = d x e2, det, a compare); |det| >= eps 12 (reciprocal, s, u, 2
    compares); u in range 18 (q, v, u + v, 2 compares); v in range 8 (t,
    2 compares). The smooth normal of a closer culled candidate is not
    counted."""
    return 21.0 * n["pairs"] + 12.0 * n["det"] + 18.0 * n["u"] + 8.0 * n["v"]


def mt_loop_ops(n: dict) -> float:
    """f32 operations the sweep needs on the same pairs with the edges
    taken from the scene's layout (made once per triangle) and the
    division only where the u pre-test cannot settle u — B3's bound, and
    what its loop issues, unfused: every pair 27 (h 9, det 5, s 3, u
    numerator 5, the det test, the pre-test's 2 multiplies and 2
    compares); kept by the pre-test 4 (reciprocal, u, 2 compares); u in
    range 18; v in range 8. A kept pair's h, det, s and u numerator are
    not counted twice."""
    return 27.0 * n["pairs"] + 4.0 * n["kept"] + 18.0 * n["u"] + 8.0 * n["v"]


def parity_b3_launches(scene, cam, cfg):
    """B3's launches in one parity frame for ``--b3-public``, rebuilt from
    calls every version of the port has (an older tree's engine makes
    them through other functions; ``record_b3_launches`` takes this
    tree's from the engine itself): per tile, at full tile shape (an edge
    tile is cropped after it is rendered), the fused identity pass in
    world space, then each other mesh in its local space ->
    [dict(tile, what, ro, rd (R, 3), first, count, ids or None,
    cull (count,) bool)]."""
    import torch

    from tpurt_torch.core import v3 as v3lib
    from tpurt_torch.core.camera import make_ray, pixel_uv
    from tpurt_torch.render.intersect import _cull_policy, local_rays
    from tpurt_torch.render.renderer import _tile_pixel_coords
    from tpurt_torch.scene.types import MaterialType

    dev = scene.device
    fused, separate = [], []
    for i, (_first, count) in enumerate(scene.mesh_tri_ranges):
        if (scene.mesh_identity[i] and count <= cfg.bruteforce_threshold
                and scene.mesh_mat_types[i] != int(MaterialType.ONE_SIDED)):
            fused.append(i)
        else:
            separate.append(i)
    ranges = [scene.mesh_tri_ranges[i] for i in fused]
    ids = torch.cat([torch.arange(f, f + n) for f, n in ranges]).to(dev)
    fused_cull = torch.cat([torch.full((n,), _cull_policy(scene.mesh_mat_types[i]))
                            for i, (_f, n) in zip(fused, ranges)]).to(dev)
    rows = lambda v: v3lib.to_rows(v).contiguous()
    ts = cfg.tile_size
    tiles_x, tiles_y = cfg.tiles()
    out = []
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            xs, ys = _tile_pixel_coords(ts, ts, tx * ts, ty * ts, dev)
            ro, rd = make_ray(cam, pixel_uv(xs, ys, cfg.width, cfg.height))
            o, d = v3lib.from_rows(ro), v3lib.from_rows(rd)
            out.append(dict(tile=(tx, ty), what="fused walls", ro=rows(o),
                            rd=rows(v3lib.normalize(d)), first=None,
                            count=ids.shape[0], ids=ids, cull=fused_cull))
            for i in separate:
                first, count = scene.mesh_tri_ranges[i]
                lo, ld = local_rays(scene, i, o, d)
                cull = _cull_policy(scene.mesh_mat_types[i])
                out.append(dict(tile=(tx, ty), what=f"mesh {i}", ro=rows(lo),
                                rd=rows(ld), first=first, count=count, ids=None,
                                cull=torch.full((count,), cull, device=dev)))
    return out


def device_ms(fn, reps: int = 5):
    """(last result, [ms per call]) of the card's time for ``fn``'s work:
    a spin kernel keeps the card busy while the host enqueues the start
    event and ``fn``'s launches, so the events bracket the device's work
    and not the host's Python around it."""
    import torch

    times, out = [], None
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return out, times


def sm_clock_under(fn, seconds: float = 1.0) -> float:
    """Median SM clock (MHz) that nvidia-smi reads while ``fn`` runs back
    to back for about ``seconds``."""
    import statistics
    import threading

    import torch

    samples, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, check=True)
            samples.append(float(out.stdout.split()[0]))
            time.sleep(0.05)

    poller = threading.Thread(target=poll)
    poller.start()
    t0 = time.time()
    try:
        while time.time() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        stop.set()
        poller.join()
    return statistics.median(samples)


def b3_alone_rays(scene, cam, cfg):
    """B3 alone at full width: the frame's camera rays, one a pixel, in
    the local space of the scene's last mesh (the parity scene's sphere)
    -> (ro, rd (W * H, 3) contiguous, first, count of its rows)."""
    import torch

    from tpurt_torch.core import v3 as v3lib
    from tpurt_torch.core.camera import make_ray, pixel_uv
    from tpurt_torch.render.intersect import local_rays

    pix = torch.arange(cfg.width * cfg.height, device=scene.device)
    ro, rd = make_ray(cam, pixel_uv(pix % cfg.width, pix // cfg.width,
                                    cfg.width, cfg.height))
    mesh = scene.num_meshes - 1
    first, count = scene.mesh_tri_ranges[mesh]
    lo, ld = local_rays(scene, mesh, v3lib.from_rows(ro), v3lib.from_rows(rd))
    return v3lib.to_rows(lo).contiguous(), v3lib.to_rows(ld).contiguous(), first, count


def time_b3_public(scene, launches, what: str, reps: int = 5) -> float:
    """Each launch through the public entry ``mt_sweep.mt_sweep`` (its
    rows gathered and padded beforehand, outside the timing), timed with
    the host around it (``cuda_ms``) and on the device (``device_ms``);
    logs every launch and returns the sum of best device times (ms)."""
    from tpurt_torch.render import mt_sweep

    total = host = 0.0
    for ln in launches:
        tri = (scene.tri_packed[ln["ids"]] if ln["ids"] is not None else
               scene.tri_packed[ln["first"]:ln["first"] + ln["count"]])
        rows, flags = mt_sweep.pad_tri_rows(tri, ln["cull"])
        call = lambda: mt_sweep.mt_sweep(ln["ro"], ln["rd"], rows, flags, ln["count"])
        call()  # warm-up
        _out, h_ms = cuda_ms(call, reps)
        _out, d_ms = device_ms(call, reps)
        total += min(d_ms)
        host += min(h_ms)
        log(f"B3 public entry, tile {ln['tile']} {ln['what']}: {ln['ro'].shape[0]} "
            f"rays x {ln['count']} rows, best of {reps}: device {min(d_ms):.4f} ms, "
            f"with the host {min(h_ms):.4f} ms | {CARD}")
    log(f"B3 public entry, {what}: {len(launches)} launches, sums of best "
        f"times: device {total:.4f} ms, with the host {host:.4f} ms | {CARD}")
    return total


def sass_summary(lib: str) -> dict:
    """{kernel entry: (instructions, sha1 of its opcode sequence)} of a
    built library, from ``cuobjdump -sass``: two builds whose opcode
    sequences hash alike run the same instructions, whatever registers
    and parameter offsets they use."""
    import hashlib
    import re

    from tpurt_torch import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    ops, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            ops[fn] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn and m:
            ops[fn].append(m.group(1))
    return {f: (len(o), hashlib.sha1(" ".join(o).encode()).hexdigest()[:12])
            for f, o in ops.items()}


def b1_public_main():
    """``--b1-public``: the bunny-1080p batch through B1's public entry,
    16 trips and to completion, best of 5 and of 3 on the device; the
    SASS of each megakernel instantiation (``sass_summary``)."""
    from tpurt_torch import _build
    from tpurt_torch.render import mega_cuda
    from tpurt_torch.render import megakernel as mk
    from tpurt_torch.render.renderer import flat_batch_args

    _build.build_all(["megakernel", "tpurt_native"])
    for fn, (n, digest) in sass_summary(_build.lib_path("megakernel")).items():
        log(f"B1 SASS {fn}: {n} instructions, opcode sequence {digest}")
    cfg = bunny_cfg(1920, 1080)
    scene, cam = bunny_scene(cfg)
    lane, ctx = mk.prepare(scene, **flat_batch_args(scene, cam, cfg, 0))
    buf0 = mega_cuda.pack(lane)
    for trips, reps in ((16, 5), (None, 3)):
        mega_cuda.launch(buf0.clone(), ctx, trips)  # warm-up
        bufs = [buf0.clone() for _ in range(reps)]
        it = iter(bufs)
        _out, ms = device_ms(lambda: mega_cuda.launch(next(it), ctx, trips), reps)
        log(f"B1 public entry, bunny-1080p batch, "
            f"{'16 trips' if trips else 'to completion'}: device ms "
            f"{[round(t, 3) for t in ms]} (best {min(ms):.3f}) | {CARD}")


def b3_public_main():
    """``--b3-public``: build B3 alone, time it through the public entry
    on the parity frame's rays in the sphere's space (as phase 9 does by
    range) and on the parity frame's launches, then the modular frames of
    the parity scene (1 spp, 1 bounce and 2 spp, 4 bounces; a warm-up,
    best of 5) through ``render_image``: calls every version of the port
    has."""
    import torch

    from tpurt_torch import _build
    from tpurt_torch.render.renderer import render_image
    from tpurt_torch.scene.presets import bench_scene

    _build.build_all(["mt_sweep"])
    cfg = parity_cfg()
    scene, cam = bench_scene("sphere", cfg, device="cuda")
    lo, ld, first, count = b3_alone_rays(scene, cam, cfg)
    time_b3_public(scene, [dict(tile="all", what="sphere", ro=lo, rd=ld, first=first,
                                count=count, ids=None,
                                cull=torch.ones(count, dtype=torch.bool, device="cuda"))],
                   "alone")
    time_b3_public(scene, parity_b3_launches(scene, cam, cfg), "parity frame")
    for label, c in (("parity-640x480", cfg),
                     ("640x480-2spp-4-bounces", cfg.replace(rays_per_pixel=2,
                                                            max_bounces=4))):
        render_image(scene, cam, c)  # warm-up
        _img, ms = cuda_ms(lambda: render_image(scene, cam, c), reps=5)
        log(f"{label} modular frame ms {[round(t, 3) for t in ms]} (best "
            f"{min(ms):.3f}) | {CARD}")


def record_b3_launches(scene, cam, cfg) -> list:
    """B3's launches in one frame as the modular engine makes them: one
    ``render_image`` with ``mt_sweep.sweep`` wrapped to keep each call's
    arguments -> [dict(ro, rd, count, first, ids, cull_flags, cull)], in
    launch order (tile by tile)."""
    from tpurt_torch.render import mt_sweep
    from tpurt_torch.render.renderer import render_image

    calls, sweep = [], mt_sweep.sweep

    def keep(ro, rd, tri_mt, tri_rows, count, first=0, ids=None, cull_flags=None,
             cull=False):
        calls.append(dict(ro=ro.clone(), rd=rd.clone(), count=count, first=first,
                          ids=ids, cull_flags=cull_flags, cull=cull))
        return sweep(ro, rd, tri_mt, tri_rows, count, first=first, ids=ids,
                     cull_flags=cull_flags, cull=cull)

    mt_sweep.sweep = keep
    try:
        render_image(scene, cam, cfg)
    finally:
        mt_sweep.sweep = sweep
    return calls


def b3_engine_call(scene, ln, plain: bool = False):
    """One launch of ``record_b3_launches``'s form on the scene's layout,
    by the kernel (or its plain version)."""
    from tpurt_torch.render import mt_sweep

    fn = mt_sweep.sweep_plain if plain else mt_sweep.sweep
    lay = () if plain else (mt_sweep.scene_layout(scene),)
    kw = {k: ln[k] for k in ("first", "ids", "cull_flags", "cull")}
    return lambda: fn(ln["ro"], ln["rd"], *lay, scene.tri_packed, ln["count"], **kw)


def phase9():
    """B3 alone at full width (``b3_alone_rays``: the parity frame's
    307,200 camera rays in the sphere's local space against its 1,280
    rows, by range as the engine reads them), then each of the parity
    frame's launches as the engine makes them (``record_b3_launches``);
    every result equal to the plain version's."""
    import torch

    from tpurt_torch.render import mt_sweep
    from tpurt_torch.scene.presets import bench_scene

    cfg = parity_cfg()
    scene, cam = bench_scene("sphere", cfg, device="cuda")
    lo, ld, first, count = b3_alone_rays(scene, cam, cfg)
    alone = dict(ro=lo, rd=ld, count=count, first=first, ids=None, cull_flags=None,
                 cull=True)
    call = b3_engine_call(scene, alone)
    call()  # warm-up
    (t, idx), k_ms = device_ms(call)
    _out, h_ms = cuda_ms(call, reps=5)
    (tp, idxp), p_ms = cuda_ms(b3_engine_call(scene, alone, plain=True), reps=2)
    same_i = float((idx == idxp).float().mean())
    same_t = bool(torch.equal(t, tp))
    hit = idxp >= 0
    err = float((t - tp)[hit].abs().max()) if bool(hit.any()) else 0.0
    r = lo.shape[0]
    launch = mt_sweep.launch_config(r)
    log(f"B3 alone: {r} rays x {count} rows, hit {float(hit.float().mean()):.4f}; "
        f"rows equal on {same_i:.6%}, t bit-identical {same_t}; kernel device ms "
        f"{k_ms}, with the host {h_ms}, plain ms {p_ms}; launch {launch} | {CARD}")
    if same_i < 1.0 or not same_t:
        raise AssertionError("B3 kernel differs from its plain version")
    n = mt_sweep_counts(lo, ld, scene.tri_packed[first:], count)
    ops, loop_ops = mt_sweep_ops(n), mt_loop_ops(n)
    nbytes = r * 6 * 4 + count * mt_sweep.MT_WIDTH * 4 + r * 8
    b_ms, b_by = bound(loop_ops, nbytes)
    old_ms, _by = bound(ops, nbytes)
    log(f"B3 bound {b_ms:.4f} ms ({b_by}): {loop_ops:.4g} ops ({loop_ops / n['pairs']:.2f} "
        f"per pair, mt_loop_ops), {nbytes} bytes; counted as before the layout and "
        f"the pre-test (mt_sweep_ops) {old_ms:.4f} ms: {ops:.4g} ops "
        f"({ops / n['pairs']:.2f} per pair); the pre-test sends "
        f"{n['kept'] / n['det']:.4%} of det-passing pairs to the division "
        f"({n['u'] / n['det']:.4%} pass u)")
    mhz = sm_clock_under(call)
    lanes = torch.cuda.get_device_properties(0).multi_processor_count * 128
    log(f"B3's loop issues {loop_ops:.4g} f32 ops ({loop_ops / n['pairs']:.2f} per "
        f"pair), {loop_ops / (PEAK_F32 / 2) / (min(k_ms) * 1e-3):.2%} of the unfused "
        f"ceiling ({PEAK_F32 / 2:.3g}/s) in {min(k_ms):.4f} ms; the SM clock under "
        f"it {mhz:.0f} MHz, where {lanes} f32 lanes issue {lanes * mhz * 1e6:.4g}/s: "
        f"{loop_ops / (lanes * mhz * 1e6) / (min(k_ms) * 1e-3):.2%} | {CARD}")
    total = host = 0.0
    launches = record_b3_launches(scene, cam, cfg)
    tiles_x, tiles_y = cfg.tiles()
    per_tile = len(launches) // (tiles_x * tiles_y)
    for k, ln in enumerate(launches):
        call = b3_engine_call(scene, ln)
        call()  # warm-up
        (t, idx), ms = device_ms(call)
        _out, lh_ms = cuda_ms(call, reps=5)
        tp, idxp = b3_engine_call(scene, ln, plain=True)()
        if not (torch.equal(t, tp) and torch.equal(idx, idxp)):
            raise AssertionError(f"B3 differs from its plain version at launch {k}")
        total += min(ms)
        host += min(lh_ms)
        by_ids = ln["ids"] is not None
        rows = (scene.tri_packed[ln["ids"].long()] if by_ids
                else scene.tri_packed[ln["first"]:])
        n = mt_sweep_counts(ln["ro"], ln["rd"], rows, ln["count"])
        what = ("the fused id list" if by_ids else
                f"rows {ln['first']} .. {ln['first'] + ln['count'] - 1} by range")
        log(f"B3 engine launch {k} (tile {k // per_tile}): {ln['ro'].shape[0]} rays x "
            f"{ln['count']} rows ({what}, G "
            f"{mt_sweep.launch_config(ln['ro'].shape[0])['groups']}), equal to the "
            f"plain version, best of 5: device {min(ms):.4f} ms, with the host "
            f"{min(lh_ms):.4f} ms; the pre-test sends {n['kept'] / n['pairs']:.4%} of "
            f"its pairs to the division | {CARD}")
    log(f"B3 per parity frame: {len(launches)} launches, sums of best times: device "
        f"{total:.4f} ms, with the host {host:.4f} ms | {CARD}")
    return dict(name="mt_sweep (B3)", route="cuda",
                source="tpurt_torch/csrc/mt_sweep.cu",
                replaces="tpurt/render/pallas_kernels.py:156", launches=None,
                max_abs_err=err, ms=min(h_ms), device_ms=min(k_ms), plain_ms=min(p_ms),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def phase10(b3):
    import numpy as np

    from tpurt_torch.render.intersect import _partition
    from tpurt_torch.render.renderer import render_image
    from tpurt_torch.scene.presets import bench_scene

    cfg = parity_cfg()
    scene, cam = bench_scene("sphere", cfg, device="cuda")
    log_depth("parity-640x480-modular", scene)
    # At one bounce only emitters seen directly add light, and this camera
    # does not see the ceiling light: the parity frame is black by
    # construction. The lit check is the 4-bounce frame below.
    img, _stats, launches, _best = main_path(
        "parity-640x480-modular", scene, cam, cfg, "mt_sweep", min_lit=None)
    # One launch a tile for the fused identity pass and one for each other
    # mesh: every one of them counted.
    tiles_x, tiles_y = cfg.tiles()
    per_tile = 1 + len(_partition(scene, cfg.bruteforce_threshold)[1])
    if launches != tiles_x * tiles_y * per_tile:
        raise AssertionError(f"parity frame: {launches} B3 launches counted, "
                             f"{tiles_x * tiles_y * per_tile} made")
    b3["launches"] = launches
    for label, c in (("parity-640x480", cfg),
                     ("640x480-2spp-4-bounces", cfg.replace(rays_per_pixel=2,
                                                            max_bounces=4))):
        reset_counts()
        mod, d_ms = cuda_ms(lambda: render_image(scene, cam, c))
        mega, m_ms = cuda_ms(lambda: render_image(scene, cam, c.replace(engine="mega")))
        launched = counts()
        if launched["megakernel"] < 1 or launched["mt_sweep"] < 1:
            raise AssertionError(f"{label}: kernels not launched ({launched})")
        frac = mostly_bitwise(mod, mega, f"{label}: modular vs megakernel")
        exact, e_ms = cuda_ms(lambda: render_image(
            scene, cam, c.replace(dense_engine="exact")))
        if not np.array_equal(exact, mod):
            raise AssertionError(f"{label}: kernel B3 and the exact sweep differ")
        lit = float((mod.max(axis=-1) > 0).mean())
        log(f"{label}: the modular (B3) frame ({d_ms[0]:.3f} ms, lit {lit:.4f}) "
            f"differs from the megakernel (B1) frame ({m_ms[0]:.3f} ms) on "
            f"{frac:.4%} of pixels and equals the dense_engine='exact' frame "
            f"({e_ms[0]:.3f} ms) | {CARD}")
    if lit <= 0.05:
        raise AssertionError(f"640x480 4-bounce modular frame: lit fraction {lit:.4f}")
    return b3


def grid_camera(width, height, device="cuda"):
    """scripts/probe_r74.py's camera on the instance grid."""
    import math

    from tpurt_torch.core.camera import Camera

    return Camera.create(position=(0.0, 150.0, 380.0), pitch=-0.1, yaw=math.pi,
                         roll=0.0, fov_degrees=90.0, aspect_ratio=width / height,
                         device=device)


def grid_cfg(width, height, **kw):
    from tpurt_torch.config import RenderConfig

    # probe r74's knobs (scripts/probe_r74.py:74-78), unpacked.
    return RenderConfig(width=width, height=height, rays_per_pixel=4,
                        max_bounces=4, tile_size=256, seed_mode="reference",
                        pixels_per_lane=4, mega_tail_passes=3,
                        compaction_threshold=0, **kw)


def frames_differ(name, scene, cam, cfg, other_scene, other_cfg, what):
    """A frame of ``scene`` against one of ``other_scene`` (the same
    geometry in another regime, or another engine): the pixels that
    differ, counted; segments where both are megakernel frames."""
    from tpurt_torch.render.renderer import render_frame

    sa, sb = {}, {}
    a = render_frame(scene, cam, cfg, stats=sa)
    b = render_frame(other_scene, cam, other_cfg, stats=sb)
    frac = mostly_bitwise(a, b, f"{name}: {what}")
    n = int((a != b).any(axis=-1).sum())
    mega = other_cfg.engine == "mega"
    segs = f"; segments {sa['segments']} and {sb['segments']}" if mega else ""
    log(f"{name}: against {what}, {n} of {a.shape[0] * a.shape[1]} pixels differ "
        f"({frac:.4%}){segs}")
    if mega and abs(sa["segments"] - sb["segments"]) > SEG_TOL * sb["segments"]:
        raise AssertionError(f"{name}: segments {sa['segments']} vs {sb['segments']}")
    return n


def phase11():
    """B1's TLAS instantiation on tpurt's K = 12 grid, small."""
    import tpurt_torch.config as config
    from tpurt_torch.scene.presets import grid_scene

    cfg = grid_cfg(160, 90, rays_per_batch=4096).replace(
        rays_per_pixel=2, max_bounces=3, pixels_per_lane=2, mega_tail_passes=2)
    cam = grid_camera(160, 90)
    scene = grid_scene(12, device="cuda")
    if not scene.mega_tlas:
        raise AssertionError("the K = 12 grid did not freeze into the TLAS regime")
    compare_backends("grid-12-160x90-tlas", scene, cam, cfg)
    old = config.MEGA_TLAS_THRESHOLD
    config.MEGA_TLAS_THRESHOLD = 10_000
    try:
        unrolled = grid_scene(12, device="cuda")
    finally:
        config.MEGA_TLAS_THRESHOLD = old
    frames_differ("grid-12-160x90-tlas", scene, cam, cfg, unrolled, cfg,
                  f"the unrolled chain ({len(unrolled.mega_chain)} entries)")
    frames_differ("grid-12-160x90-tlas", scene, cam, cfg, scene,
                  cfg.replace(engine="modular"), "engine='modular'")


def phase12():
    """grid-64-720p-tlas at full width through B1's TLAS instantiation."""
    from tpurt_torch.scene.presets import PROBE_MATERIAL, grid_scene

    cfg = grid_cfg(1280, 720, rays_per_batch=230400)
    cam = grid_camera(1280, 720)
    t0 = time.time()
    scene = grid_scene(64, subdivisions=1, materials=(PROBE_MATERIAL,), device="cuda")
    log(f"grid-64 scene: {scene.num_meshes} meshes, {scene.num_triangles} "
        f"triangles, bank {tuple(scene.mega_rows.shape)}, chain {scene.mega_chain}, "
        f"stack {2 * scene.mega_stack_depth}, built in {time.time() - t0:.1f} s")
    if not scene.mega_tlas:
        raise AssertionError("grid-64 did not freeze into the TLAS regime")
    tt = time_trips(scene, cam, cfg, 16, "grid-64-720p-tlas")
    # The camera sees the grid from outside the Cornell box (through its
    # one-sided front wall) and most instances sit above its ceiling: the
    # frame is ~2.5% lit by construction (2.46% at 160x90 on the CPU).
    _img, _stats, launches, _best = main_path(
        "grid-64-720p-tlas", scene, cam, cfg, "megakernel", min_lit=0.02)
    b_ms, b_by = megakernel_bound(scene, tt, tt["work_k"], tt["adv_k"], "grid-64, 16 trips")
    f_ms, _f_by = megakernel_bound(scene, tt, tt["work"], tt["adv"], "grid-64, whole batch")
    log(f"B1 TLAS whole batch: {tt['full_ms']:.3f} ms against its bound "
        f"{f_ms:.3f} ms | {CARD}")
    return dict(name="megakernel (B1), TLAS instantiation", route="cuda",
                source="tpurt_torch/csrc/megakernel.cu",
                replaces="tpurt/render/mega_pallas.py:237", launches=launches,
                max_abs_err=tt["err"], ms=tt["ms"], plain_ms=tt["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def phase13(bunny_u8):
    """B1's bf16 instantiation: the bunny and the K = 12 grid against the
    plain version and against their u8 frames; the bunny-1080p batch's
    16 trips in both formats, in turns."""
    import tpurt_torch.config as config
    from tpurt_torch.render import mega_cuda
    from tpurt_torch.render import megakernel as mk
    from tpurt_torch.render.renderer import flat_batch_args
    from tpurt_torch.scene.presets import grid_scene

    old = config.MEGA_BF16_BOUNDS
    config.MEGA_BF16_BOUNDS = True
    try:
        bunny_bf, _cam = bunny_scene(small_bunny_cfg())
        grid_bf = grid_scene(12, device="cuda")
    finally:
        config.MEGA_BF16_BOUNDS = old
    grid_u8 = grid_scene(12, device="cuda")
    for scene in (bunny_bf, grid_bf):
        if scene.mega_bounds_fmt != "bf16":
            raise AssertionError("MEGA_BF16_BOUNDS did not give a bf16 bank")
    cfg = small_bunny_cfg()
    cam = camera_for(cfg)
    compare_backends("bunny-480x270-bf16", bunny_bf, cam, cfg)
    frames_differ("bunny-480x270-bf16", bunny_bf, cam, cfg, bunny_u8, cfg,
                  "the u8 bank")
    gcfg = grid_cfg(160, 90, rays_per_batch=4096).replace(
        rays_per_pixel=2, max_bounces=3, pixels_per_lane=2, mega_tail_passes=2)
    gcam = grid_camera(160, 90)
    compare_backends("grid-12-160x90-bf16", grid_bf, gcam, gcfg)
    frames_differ("grid-12-160x90-bf16", grid_bf, gcam, gcfg, grid_u8, gcfg,
                  "the u8 bank")
    compare_packed("grid-12-160x90-bf16", grid_bf, gcam, gcfg,
                   (gcam, turned(gcam, 0.1)))
    # The bunny-1080p batch's first 16 trips in both formats, in turns.
    big = bunny_cfg(1920, 1080)
    bcam = camera_for(big)
    runs = {}
    for label, scene in (("u8", bunny_u8), ("bf16", bunny_bf)):
        lane, ctx = mk.prepare(scene, **flat_batch_args(scene, bcam, big, 0))
        runs[label] = (mega_cuda.pack(lane), ctx)
        mega_cuda.launch(runs[label][0].clone(), ctx, 16)  # warm-up
    times, boxes = {}, {}
    for label in ("u8", "bf16", "bf16", "u8"):
        buf0, ctx = runs[label]
        buf = buf0.clone()
        (_trips, work), ms = cuda_ms(lambda: mega_cuda.launch(buf, ctx, 16))
        times.setdefault(label, []).extend(ms)
        boxes[label] = int(work[0].long().sum())
    log(f"bunny-1080p batch, 16 trips: u8 ms {times['u8']}, bf16 ms {times['bf16']}; "
        f"box tests u8 {boxes['u8']}, bf16 {boxes['bf16']} | {CARD}")
    return dict(u8_ms=min(times["u8"]), bf16_ms=min(times["bf16"]))


def compare_packed(name, scene, cam, cfg, cams):
    """A cross-frame packed launch (the frames of ``cams``: a tuple of
    distinct cameras, or one camera repeated for the shared table) through
    B1 against the plain version after 1, 4 and 16 trips, then every
    batch of the frame packed through B1 against each of its frames
    rendered alone through B1, bit for bit, the segments summing equal."""
    import torch

    from tpurt_torch.render import mega_cuda
    from tpurt_torch.render.megakernel import run_megakernel
    from tpurt_torch.render.renderer import (
        _flat_batch_size, flat_batch_args, render_batch_flat,
        render_batch_flat_frames)

    shared = all(c is cams[0] for c in cams)
    form = f"F = {len(cams)}, " + ("one camera" if shared else "a camera a frame")
    args = flat_batch_args(scene, cam, cfg, 0, frames=len(cams),
                           cameras=None if shared else cams)
    for k in (1, 4, 16):
        st = [run_megakernel(scene, body_backend=b, max_iterations=k,
                             return_state=True, **args) for b in ("plain", "cuda")]
        agree, err = mega_cuda.compare_lanes(*st)
        log(f"{name} packed ({form}): after {k} trips, integer fields agree on "
            f"{agree:.4%} of {args['pixel_index'].shape[0]} lanes, float max abs "
            f"err {err:.3g}")
        if agree < LANE_AGREE:
            raise AssertionError(f"{name} packed: lane agreement {agree:.4%}")
    kcfg = cfg.replace(mega_body="pallas")
    b = _flat_batch_size(cfg) * cfg.pixels_per_lane
    batches = -(-cfg.width * cfg.height // b)
    for i in range(batches):
        packed, segs, _ = render_batch_flat_frames(scene, cams, kcfg, i * b,
                                                   frame_index=4)
        total = 0
        for f, c in enumerate(cams):
            lone, s1, _ = render_batch_flat(scene, c, kcfg, i * b, frame_index=4 + f)
            if not torch.equal(packed[f * b:(f + 1) * b], lone):
                raise AssertionError(f"{name} packed: frame {f} of batch {i} "
                                     "differs from the frame alone")
            total += s1
        if segs != total:
            raise AssertionError(f"{name} packed: segments {segs} vs {total}")
    log(f"{name} packed ({form}): {batches} batches, every frame bit for bit the "
        f"frame alone through B1, segments summing equal")


def turned(cam, d_yaw):
    """A rotation-only companion of ``cam`` (packing's shared position)."""
    from tpurt_torch.core.camera import Camera

    p = cam.host_params()
    return Camera.create(tuple(float(v) for v in p[:3]), pitch=float(p[3]),
                         yaw=float(p[4]) + d_yaw, roll=float(p[5]),
                         fov_degrees=float(p[6]), aspect_ratio=float(p[7]),
                         device="cuda")


def phase14():
    """Cross-frame packing, small: Cornell sphere and the K = 12 grid in
    both camera forms, the teapot through the dense instantiation."""
    from tpurt_torch.config import RenderConfig
    from tpurt_torch.scene.presets import bench_scene, cornell_sphere_scene, grid_scene

    cfg = RenderConfig(width=64, height=64, rays_per_pixel=2, max_bounces=3,
                       pixels_per_lane=2, mega_tail_passes=2)
    scene, cam, _ = cornell_sphere_scene(2, cfg, device="cuda")
    gcfg = grid_cfg(160, 90, rays_per_batch=4096).replace(
        rays_per_pixel=2, max_bounces=3, pixels_per_lane=2, mega_tail_passes=2)
    gcam = grid_camera(160, 90)
    grid = grid_scene(12, device="cuda")
    for name, sc, c, k in (("cornell-sphere-64", scene, cfg, cam),
                           ("grid-12-160x90-tlas", grid, gcfg, gcam)):
        compare_packed(name, sc, k, c, (k, turned(k, 0.1)))
        compare_packed(name, sc, k, c, (k,) * 3)
    tcfg = teapot_cfg(320, 180)
    teapot, tcam = bench_scene("teapot", tcfg, device="cuda")
    compare_packed("teapot-320x180-dense", teapot, tcam, tcfg,
                   (tcam, turned(tcam, 0.1)))


def packed_images(scene, cam, cfg, frame_index: int, frames: int) -> list:
    """``frames`` uint8 frames of a static scene through the video path's
    packed dispatch (anim: cross-frame packed launches, tonemap on the
    device, uint8 to the host)."""
    from tpurt_torch import anim

    return [anim._materialise_frame_u8(b, cfg)
            for b in anim._dispatch_pack_u8(scene, cam, cfg, frame_index, frames)]


def pack_against_frames(label, scene, cam, cfg, frames: int):
    """The pack of ``frames`` frames (packed_images, B1 launches counted:
    counts set to 0 just before, read just after) against ``render_image``
    of each frame, bit for bit; then both timed in turns, 3 of each:
    (launches, per-frame ms of the pack, ms of an unpacked frame)."""
    import numpy as np

    from tpurt_torch.render.renderer import render_image

    reset_counts()
    imgs = packed_images(scene, cam, cfg, 0, frames)
    launched = counts()["megakernel"]
    if launched < 1:
        raise AssertionError(f"{label}: the pack launched no megakernel")
    for f, img in enumerate(imgs):
        if not np.array_equal(img, render_image(scene, cam, cfg, frame_index=f)):
            raise AssertionError(f"{label}: packed frame {f} differs from "
                                 "render_image's")
    pack_ms, frame_ms = [], []
    for _ in range(3):
        pack_ms += cuda_ms(lambda: packed_images(scene, cam, cfg, 0, frames))[1]
        frame_ms += cuda_ms(lambda: render_image(scene, cam, cfg))[1]
    per = min(pack_ms) / frames
    log(f"{label}: a pack of {frames} frames, {launched} B1 launch(es), every "
        f"frame bit for bit render_image's; pack ms {[round(t, 3) for t in pack_ms]} "
        f"-> {per:.3f} ms a frame against the unpacked frame's "
        f"{[round(t, 3) for t in frame_ms]} (best {min(frame_ms):.3f}), "
        f"{per / min(frame_ms):.3f}x | {CARD}")
    return launched, per, min(frame_ms)


def phase15(scene, b1):
    """bunny-1080p-plain packed F = 2 at full width, then the parity row
    on the megakernel packed F = 4."""
    import numpy as np
    import torch

    from tpurt_torch.render.renderer import (
        flat_batch_args, render_batch_flat, render_batch_flat_frames)
    from tpurt_torch.render.tonemap import tonemap
    from tpurt_torch.scene.presets import bench_scene

    cfg = bunny_cfg(1920, 1080).replace(mega_frames_per_batch=2)
    cam = camera_for(cfg)
    args = flat_batch_args(scene, cam, cfg, 0, frames=2)
    tt = time_trips(scene, cam, cfg, 16, "bunny-1080p-packF2", args=args)
    kcfg = cfg.replace(mega_body="pallas")
    packed, segs, _ = render_batch_flat_frames(scene, (cam, cam), kcfg, 0)
    rows = packed.shape[0] // 2
    total = cfg.width * cfg.height
    lone_segs = 0
    for f in (0, 1):
        lone, s1, _ = render_batch_flat(scene, cam, kcfg, 0, frame_index=f)
        lone_segs += s1
        if not torch.equal(packed[f * rows:(f + 1) * rows], lone):
            raise AssertionError(f"bunny packed: frame {f} differs from unpacked")
    if segs != lone_segs:
        raise AssertionError(f"bunny packed: segments {segs} vs {lone_segs}")
    frame0 = tonemap(packed[:total]).cpu().numpy().reshape(cfg.height, cfg.width, 3)
    if not np.array_equal(frame0, b1["img"]):
        raise AssertionError("bunny packed: frame 0 differs from phase 5's image")
    log(f"bunny-1080p-packF2: frames 0 and 1 bit for bit the unpacked frames "
        f"(and frame 0 phase 5's image); {segs} segments = {lone_segs}")
    launches, per, unpacked = pack_against_frames("bunny-1080p-packF2", scene, cam,
                                                  cfg, 2)
    b_ms, b_by = megakernel_bound(scene, tt, tt["work_k"], tt["adv_k"], "packed F=2, 16 trips")
    f_ms, _f_by = megakernel_bound(scene, tt, tt["work"], tt["adv"], "packed F=2, whole batch")
    log(f"B1 packed batch (2 frames): {tt['full_ms']:.3f} ms against its bound "
        f"{f_ms:.3f} ms; {tt['full_ms'] / 2:.3f} ms a frame against the unpacked "
        f"batch's {b1['full_ms']:.3f} ms in phase 5 | {CARD}")
    pcfg = parity_cfg().replace(engine="mega", mega_frames_per_batch=4)
    pscene, pcam = bench_scene("sphere", pcfg, device="cuda")
    log_depth("parity-640x480-mega-packF4", pscene)
    pack_against_frames("parity-640x480-mega-packF4", pscene, pcam, pcfg, 4)
    return dict(name="megakernel (B1), packed F=2", route="cuda",
                source="tpurt_torch/csrc/megakernel.cu",
                replaces="tpurt/render/mega_pallas.py:237", launches=launches,
                max_abs_err=tt["err"], ms=tt["ms"], plain_ms=tt["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def phase16():
    """The other schedules on the card, small; then the deep-stack scene."""
    import shutil

    import numpy as np

    from tpurt_torch import anim
    from tpurt_torch.config import RenderConfig
    from tpurt_torch.io import TileAccumulator, read_bmp
    from tpurt_torch.render import mega_cuda
    from tpurt_torch.render import megakernel as mk
    from tpurt_torch.render.renderer import (
        flat_batch_args, render_frame, render_image, render_tile)
    from tpurt_torch.scene.presets import cornell_sphere_scene, deep_stack_scene

    cfg = RenderConfig(width=64, height=64, rays_per_pixel=2, max_bounces=3,
                       pixels_per_lane=2, mega_tail_passes=2, tile_size=24)
    scene, cam, _ = cornell_sphere_scene(2, cfg, device="cuda")
    out = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)

    def counted(what, fn, at_least=1):
        reset_counts()
        got = fn()
        n = counts()["megakernel"]
        if n < at_least:
            raise AssertionError(f"{what}: {n} B1 launches")
        return got, n

    dcfg = cfg.replace(seed_mode="decorrelated")
    sflat, n = counted("sample_flatten", lambda: render_frame(
        scene, cam, dcfg.replace(sample_flatten=True)), cfg.rays_per_pixel)
    if not np.array_equal(sflat, render_frame(scene, cam, dcfg)):
        raise AssertionError("sample_flatten frame differs from the in-lane frame")
    log(f"schedules: sample_flatten ({n} launches) equals the in-lane frame")
    flat = render_frame(scene, cam, cfg)
    tiled, n = counted("tiled", lambda: render_frame(
        scene, cam, cfg.replace(rays_per_batch=0)), 9)
    tile = render_tile(scene, cam, cfg, x0=48, y0=24, tile_h=24, tile_w=24)
    if not (np.array_equal(tiled, flat)
            and np.array_equal(tile[:24, :16].cpu().numpy(), flat[24:48, 48:64])):
        raise AssertionError("tiled frame or render_tile differs from the flat frame")
    log(f"schedules: rays_per_batch=0 ({n} tile launches) and render_tile equal "
        "the flat frame")
    want = render_image(scene, cam, cfg)
    path = os.path.join(out, "acc.npz")
    first, n1 = counted("accumulator", lambda: render_image(
        scene, cam, cfg, accumulator=TileAccumulator(cfg, path=path)), 9)
    resumed, n2 = counted("resume", lambda: render_image(
        scene, cam, cfg, accumulator=TileAccumulator(cfg, path=path)), 0)
    if not (np.array_equal(first, want) and np.array_equal(resumed, want)) or n2:
        raise AssertionError("TileAccumulator resume differs or relaunched")
    log(f"schedules: TileAccumulator frame ({n1} launches) and its resume (0 "
        "launches) equal the flat image")
    vcfg = cfg.replace(video_frame_count=3)
    paths, n = counted("render_video", lambda: anim.render_video(
        scene, cam, vcfg, out_dir=os.path.join(out, "video")), 3)
    for f, p in enumerate(paths):
        if not np.array_equal(read_bmp(p), render_image(
                anim.video_frame_scene(scene, f, 3), cam, vcfg, frame_index=f)):
            raise AssertionError(f"video frame {f} differs from render_image's")
    static = lambda s, f, n_: s
    paths, n_packed = counted("packed video", lambda: anim.render_video(
        scene, cam, vcfg.replace(mega_frames_per_batch=2),
        out_dir=os.path.join(out, "packed"), frame_hook=static), 2)
    for f, p in enumerate(paths):
        if not np.array_equal(read_bmp(p), render_image(scene, cam, vcfg,
                                                        frame_index=f)):
            raise AssertionError(f"packed video frame {f} differs")
    log(f"schedules: render_video, 3 frames ({n} launches), and the static-hook "
        f"video packed 2 frames a launch ({n_packed} launches): BMPs equal "
        "render_image of each frame")
    shutil.rmtree(out)
    dscene, dcam = deep_stack_scene(cfg, device="cuda")
    # Its primary rays hold 67 entries after trip 34, past the register
    # stack's 64: compared there, and with the budget cut to 66 words
    # (still kDeep), where each of them drops its bottom entry. One
    # sample a pixel: the plain version takes a step per trip, and each
    # sample's walk down and back up the chain is ~140 trips.
    one = cfg.replace(rays_per_pixel=1, pixels_per_lane=1)
    compare_backends("deep-stack-64", dscene, dcam, one, trips=(1, 16, 34, 100))
    lane, ctx = mk.prepare(dscene, **flat_batch_args(dscene, dcam, one, 0))
    held = int(mk.stack_entries(mk.run_plain(lane, ctx, 34)).max())
    lane, ctx = lane._replace(stack=lane.stack[:66]), ctx._replace(s_depth=66)
    if held <= mega_cuda.MAX_REGISTER_STACK or not mega_cuda.deep_stack(ctx):
        raise AssertionError(f"deep-stack-64 holds {held} entries")
    for k in (34, 100, None):
        buf = mega_cuda.pack(lane)
        mega_cuda.launch(buf, ctx, k)
        agree, _err = mega_cuda.compare_lanes(
            mk.run_plain(lane, ctx, k), mega_cuda.unpack(buf, ctx, 0))
        if agree < 1.0:
            raise AssertionError(f"deep-stack-64 overflow, {k} trips: {agree:.4%}")
    log(f"deep-stack-64: the plain version's lanes hold up to {held} stack "
        "entries; with a 66-word budget (full stacks drop their bottom "
        "entry) B1 equals it in every lane field after 34, 100 trips and "
        "to the end")
    compare_packed("deep-stack-64", dscene, dcam, one, (dcam, turned(dcam, 0.1)))
    big = cfg.replace(width=256, height=256)
    _lane, ctx = mk.prepare(dscene, **flat_batch_args(dscene, dcam, big, 0))
    if not mega_cuda.deep_stack(ctx):
        raise AssertionError("the deep-stack scene did not take kDeep")
    # 34 trips: the window in which its stacks grow past 64 entries.
    tt = time_trips(dscene, dcam, big, 34, "deep-stack-256")
    _img, _stats, launches, _best = main_path("deep-stack-256", dscene, dcam, big,
                                              "megakernel")
    b_ms, b_by = megakernel_bound(dscene, tt, tt["work_k"], tt["adv_k"],
                                  "deep stack, 34 trips")
    return dict(name="megakernel (B1), deep-stack instantiation", route="cuda",
                source="tpurt_torch/csrc/megakernel.cu",
                replaces="tpurt/render/mega_pallas.py:237", launches=launches,
                max_abs_err=tt["err"], ms=tt["ms"], plain_ms=tt["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def main():
    global CARD
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    import tpurt_torch  # noqa: F401  (fails outside the repository)

    t0 = time.time()
    CARD = smi()
    if sys.argv[1:] == ["--b1-public"]:
        log("card:", CARD)
        b1_public_main()
        return
    if sys.argv[1:] == ["--b3-public"]:
        log("card:", CARD)
        b3_public_main()
        return
    phase1()
    phase2()
    phase3()
    bunny = phase4()
    b1 = phase5(bunny)
    b2 = phase7(phase6())
    phase8()
    b3 = phase10(phase9())
    phase11()
    b1_tlas = phase12()
    phase13(bunny)
    phase14()
    b1_packed = phase15(bunny, b1)
    b1_deep = phase16()
    log(f"chip_smoke wall {time.time() - t0:.1f} s")
    log(smi())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # B3 also gives its device time (``device_ms``) beside ``ms``, which
    # for every kernel is CUDA events around the call, the host included.
    print(json.dumps({"kernels": [{k: b[k] for k in keys + ("device_ms",) if k in b}
                                  for b in (b1, b1_tlas, b1_packed, b1_deep, b2, b3)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
