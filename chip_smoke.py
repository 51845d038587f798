#!/usr/bin/env python3
"""Drive tpurt_torch's paths on one CUDA card and check them.

    python3 chip_smoke.py                # from the repository root, one card
    python3 chip_smoke.py --b3-public    # B3's parity launches and frames only
    python3 chip_smoke.py --b1-public    # B1's batches and the headline row only
    python3 chip_smoke.py --b1-turns DIR # the same in DIR (an older tree)
                                         # and here, in turns
    python3 chip_smoke.py --tuned-vs-shipped  # the card's autotune cache
                                              # against the shipped knobs

Phases (each raises on failure, so any failure exits nonzero):

1. Versions: torch, CUDA, nvcc, Triton, the card and its power limit.
2. Build every kernel (csrc/megakernel.cu, dense_sweep.cu, mt_sweep.cu)
   and the C++ BVH builder, one compiler process each, all at once.
3. B1, small: Cornell sphere 64x64, 2 spp, 3 bounces, P=2, tail 2 — the
   megakernel against its plain torch version on the card: lane state
   after 1, 4 and 16 trips (integer fields equal on >= 99.5% of lanes),
   the whole frame (<= 0.5% of pixels differ), segments within 0.5%.
4. B1, the same on the 69,120-triangle bunny at 480x270, 4 bounces,
   P=8, tail 5, and 1 spp (the headline's 8 cut to 1: the plain version
   pays per trip, ~0.2 s, and a lane's trips grow with its samples; at
   8 spp its plain frame took ~235 s on an H100, at 2 spp ~52-56 s).
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
   knobs (1 spp) and the K = 12 grid against the plain version as in phase 3,
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

17. B1 with sub-pixel jitter and with list quotas, small (phase 3's
   Cornell sphere and knobs): the jitter library's kernel against the
   plain version in both seed modes as in phase 3; list quotas at P = 2
   and 4 over a seeded permutation of the frame's pixels, lane fields
   after 1, 4 and 16 trips, the radiance rows and segments; the identity
   list at the flat batch's lanes against phase 3's frame, bit for bit.
18. This slice's path at full size, bunny-1080p-jitter: bunny-1080p-plain
   with subpixel_jitter=True (the primary-hit cache off), as phase 5: 16
   trips through the kernel and the plain version, the batch to
   completion (trips, the slowest lane, the counted bound),
   ``render_image`` with its jitter launches counted, 3 frames timed; its
   frame against phase 5's unjittered one (pixels that differ counted).
19. The application layer on the card: ``cli.main`` at the reference
   defaults (512x512, 50 spp, 50 bounces, the knight.obj stand-in; B1
   launches counted) writes output.bmp, equal bit for bit to
   ``render_image``'s frame of the same config; the CLI with
   ``--scene-json examples/cornell_knot.json`` and with ``--engine
   modular --subpixel-jitter --seed-mode decorrelated`` (B3 launches
   counted) at 64x64; ``pick_mesh`` on the card against the CPU pick on
   a uv grid; a scripted ``viewer.run_terminal`` session (move, +,
   p X Y, g 2, o) writing preview.bmp and output.bmp.

20. The autotuner on the card: every bank shape of
   ``autotune.AXES`` (node arity 4/8/16/32, leaf rows of 2/3/4/5/8
   triangles, u8 and bf16 bounds, one axis off the shipped a8/l3/u8 at a
   time) frozen around icosphere(3) and held through B1 against the
   plain version as in phase 3 (at 1 spp); the quick sweep (``autotune.main
   (["--quick"])``: tail passes and quota from the bunny-1080p seed
   config, each leg's ms logged) into a temporary TPURT_TUNE_DIR, and
   its baseline leg three more times (the spread of a leg); then
   ``cli.main(["--tuned"])`` at the reference defaults, which must load
   that cache and write ``render_image``'s frame of the tuned config.
21. Sharded frames on the card (``parallel.render_frame_sharded``):
   bunny-1080p-plain on a 1x1 mesh over cuda:0 at over-decomposition 1
   and 4, each bit for bit phase 5's frame (``render_frame``, and its
   ``render_image`` pixels), B1 launches counted, segments equal to the
   per-pixel counts over the pixels each decomposition's launches cover
   (its padding lanes repeat pixels); a decorrelated 1x2 sample mesh
   (cuda:0 twice) at tpurt's atol=1e-5; teapot-720p-bruteforce on a 2x1
   mesh (B2 launches counted) and the parity scene's modular frame at 1
   spp / 1 bounce and 2 spp / 4 bounces on a 2x1 mesh (B3 launches
   counted), each equal to its own ``render_frame`` and ``render_image``
   frames; a world-size-1 NCCL group (``init_process_group`` over
   tcp://127.0.0.1) through which the sharded bunny frame is
   all-gathered and its segments all-reduced; and the sharded frames
   timed against ``render_image`` in turns.
22. The bench harness (``tpurt_torch.bench``) and its ladder's new
   regimes. 2,048 samples a lane (cornell-256spp-1080p's count): the
   ladder's sphere scene at 16x16, 256 spp, 4 bounces, P=8, tail 5 (256
   lanes, the smallest flat batch), whose ~12,400 trips the plain version
   cannot run whole, so ``compare_deep`` holds the lane fields after 1,
   4 and 16 trips and over 16 trips of both backends from the kernel's
   own state at a quarter, half and the end of its run, and the
   kernel's frame against the same frame at one pixel a lane and the
   modular engine's plain frame (pixels, segments). A quota of 16
   (4k-anim-sweep's): the bunny at 128x72, 4 spp, against the plain
   version as in phase 3. Each logs its trips and seconds. Then
   ``bench.run_config`` (one block) on bunny-1080p-plain packed F = 2 (B1
   launches counted) and teapot-720p-bruteforce (dense launches counted:
   B2), each block's segments equal to ``render_image``'s over the same
   frame indices and its Mrays/s its segments over its seconds; and
   ``bench.run_sharding_efficiency(force=True)`` on cuda:0 in two
   positions (plumbing only: the number means nothing on one card).
23. tpurt's staged drivers (``renderer._mega_finish_staged`` and family)
   through B1. Small, with tpurt's test constants (stages of 48 trips,
   cascade levels of 128 lanes): phase 3's Cornell sphere at 64x32, 8
   spp, 5 bounces, P=8, 256 lanes, compaction_threshold=128 in five
   schedules — respread, cascade (then its replay), P=1 (compaction,
   then the uncapped stage), quota lanes compacted to 64 and 16 of 256
   (their stride stays 256; at 4 spp, 3 bounces) — and the respread
   batch on a small teapot through the dense instantiation and on the
   K = 12 grid through the TLAS one: B1 and the plain version record equal plans and steps with
   equal live counts, and give equal rows and segments, equal to the
   plain schedule's rows through B1. Then bunny-1080p-bvh at tpurt's
   staged knobs (bench.py:484, :674-680) through ``render_frame``, once
   blocking (recording the plan) and once replayed (B1 launches counted
   a frame), each bit for bit the plain schedule's frame with segments
   in [1, 1.5] of its count; the plan and every step logged; the
   blocking, replayed and plain ``render_image`` frames timed in turns;
   the host cost of a resume and of a fresh start with no trips; the
   plan's respread tail (a fresh P = 1 batch over the collected
   stragglers), 16 trips of B1 against the plain version from its start,
   its middle and its end, and B1 to completion (the kernels line's
   ``b1_staged`` row); and, logged only, 16 trips from the first
   stage's 262,144-lane state (the uncapped alternative). Phases 19 and
   20's CLI frames (512x512 at a quota of 8: 32,768 lanes) run through
   the staged driver too, as tpurt's do, and are timed in turns against
   the plain schedule.
24. tpurt's last public helpers on the card against the CPU, on the same
   seeded inputs (65,536 rows): the AoS vector math (cross3, length3,
   lerp3, reflect, refract, fresnel_reflectance, rotate), hsv2rgb and
   to_rgba bit for bit; random_hemisphere_direction,
   sample_hemisphere_cosine and random_direction_masked with their
   states bit for bit (a masked lane's state unchanged) and directions
   within 4 ulp at unit scale (log, cos and sin round differently on the
   two devices). A freshly built bunny BVH (assets/blob69k.obj in the
   Cornell box, as ``bench_scene`` builds it, not frozen again):
   ``validate_bvh`` over the triangles of phase 4's scene, frozen on the
   card, ``SceneBuilder.stats`` equal to ``bvh_stats``, that scene's
   ``num_nodes`` equal to the builder's node count. A procedural torus knot written
   from CUDA tensors by ``write_obj`` to a temporary directory reads back
   through ``load_obj`` bit for bit. No kernel runs here.
25. The fresh-lanes kernel (``mega_cuda.fresh``, fresh_lanes in
   csrc/megakernel.cu) at the main paths' shapes: bunny-1080p packed
   F = 2 (262,144 lanes), teapot-720p through the dense instantiation
   (230,400 lanes), and the bunny-1080p-bvh still's first stage and its
   respread tail. Each buffer equals ``pack`` of ``_initial_lane``'s lanes
   in every word; one call counts one fresh launch and no megakernel
   launch; it is timed with the host around it and, the kernel alone, on
   the device (torch.profiler), against ``_initial_lane`` and ``pack``,
   beside its bound (the buffer written and the rays and pixels read
   once, at HBM rate); and a frame of each path is rendered with its
   fresh launches counted. The first three are rows of the kernels line.

Every scene's ``mega_stack_depth`` is logged where a phase first drives
it. Each path's launch counts are set to 0 just before its counted
``render_image`` and read just after. ``--b1-public`` builds B1 alone
and times its batches on the main paths through ``mega_cuda.launch`` on
the device (bunny-1080p: 16 trips and to completion; its jitter and
packed forms, grid-64 TLAS, deep-stack-256, the dense teapot and the
staged respread tail, to completion; glass-cornell's final batch: 64
trips and to completion), each with its lane trips a segment and the
lanes a completion group where the kernel counts them, and the headline
ladder row, with calls every version of the port with glass-cornell's
RenderConfig fields has, so the script times an earlier tree's B1;
``--b1-turns DIR`` copies the script into
the unpacked older tree DIR and runs ``--b1-public`` there and here in
turns.
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


def staged_vs_plain(name, scene, cam, cfg):
    """``render_image`` at ``cfg`` (its default compaction_threshold: the
    staged schedule where the batch is wide enough) and at
    compaction_threshold=0 (the plain schedule), timed in turns, best of
    3, B1 launches a frame counted; the two frames equal bit for bit."""
    import numpy as np

    from tpurt_torch.render.renderer import render_image

    scheds = {"default": cfg, "plain": cfg.replace(compaction_threshold=0)}
    frames, launched, ms = {}, {}, {k: [] for k in scheds}
    for k, c in scheds.items():
        reset_counts()
        frames[k] = render_image(scene, cam, c)
        launched[k] = counts()["megakernel"]
    if not np.array_equal(frames["default"], frames["plain"]):
        raise AssertionError(f"{name}: the default schedule's frame differs "
                             "from the plain schedule's")
    for _ in range(3):
        for k, c in scheds.items():
            ms[k].extend(cuda_ms(lambda: render_image(scene, cam, c))[1])
    log(f"{name} frame ms in turns (render_image, threshold "
        f"{cfg.compaction_threshold}): " + "; ".join(
            f"{k} {launched[k]} B1 launches, {[round(t, 3) for t in v]} best "
            f"{min(v):.3f}" for k, v in ms.items())
        + f"; frames equal bit for bit | {CARD}")


def reset_counts():
    from tpurt_torch.render import mega_cuda, mt_sweep, plucker_fused

    mega_cuda.LAUNCHES = mega_cuda.DENSE_LAUNCHES = mega_cuda.JITTER_LAUNCHES = 0
    mega_cuda.FRESH_LAUNCHES = mt_sweep.LAUNCHES = plucker_fused.LAUNCHES = 0


def counts() -> dict:
    from tpurt_torch.render import mega_cuda, mt_sweep, plucker_fused

    return dict(megakernel=mega_cuda.LAUNCHES, dense=mega_cuda.DENSE_LAUNCHES,
                jitter=mega_cuda.JITTER_LAUNCHES, fresh=mega_cuda.FRESH_LAUNCHES,
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

    names = ["megakernel", "megakernel_jitter", "dense_sweep", "mt_sweep",
             "tpurt_native"]
    t0 = time.time()
    done = _build.build_all(names)
    log(f"built {', '.join(f'{n} {s:.1f} s' for n, s in done.items())}; "
        f"all in {time.time() - t0:.1f} s")
    for name in names[:4]:
        for line in _build.build_log(name).splitlines():
            if any(k in line for k in ("entry function", "registers", "spill",
                                       "stack frame")):
                log(f"  ptxas {name}:", line.strip())
    for name in names[:2]:
        log_sass_memory(name, _build.lib_path(name))


def log_depth(name, scene):
    """The scene's stack budget and where B1 keeps it."""
    from tpurt_torch.render import mega_cuda

    words = 2 * scene.mega_stack_depth
    where = ("global memory (deep-stack instantiation)"
             if words > mega_cuda.MAX_SHARED_STACK else "a shared-memory ring")
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
    from tpurt_torch.scene.presets import bench_scene

    return bench_scene("bunny", cfg, device=device)


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


def glass_cfg(width, height):
    """glass-cornell's final renders (benchmark/configs/glass-cornell.json,
    benchmark/traffic/final-1080p.json): the reference's 50 spp and 50
    bounces, one launch of 262,144 lanes x P = 8 a 1080p frame, the
    model Glassy (ior 1.5) at scale 1.0 before a product-shot camera."""
    from tpurt_torch.config import RenderConfig

    return RenderConfig(width=width, height=height, rays_per_pixel=50,
                        max_bounces=50, seed_mode="reference", pixels_per_lane=8,
                        mega_tail_passes=5, compaction_threshold=0,
                        rays_per_batch=262144, camera_position=(0.0, 20.0, 230.0),
                        camera_pitch=-0.08, camera_yaw=3.14, fov_degrees=45.0,
                        model_scale=1.0, model_material={
                            "type": 3, "ior": 1.5, "color": [1.0, 1.0, 1.0]})


def glass_scene(cfg, device="cuda"):
    """glass-cornell: bench.py's "bunny" mesh (assets/blob69k.obj) with
    ``cfg``'s model material and scale in the Cornell box."""
    from tpurt_torch.scene.builder import SceneBuilder
    from tpurt_torch.scene.obj import load_obj
    from tpurt_torch.scene.presets import BUNNY_OBJ, scene_around

    b = SceneBuilder()
    return scene_around(b, b.add_triangles(*load_obj(BUNNY_OBJ)), cfg, device)


def lanes_per_group(work) -> str:
    """The segments over the completion groups of a launch's work rows
    (the last row, where the kernel counts them: 4 rows, or 6 in the
    TLAS regime), or "not counted"."""
    if work.shape[0] not in (4, 6):
        return "not counted"
    return f"{int(work[2].long().sum()) / max(int(work[-1].long().sum()), 1):.3f}"


def small_bunny_cfg():
    """Phases 4 and 13: the bunny's knobs at 480x270 and 1 spp (the plain
    version's frame is the script's largest cost)."""
    return bunny_cfg(480, 270).replace(rays_per_pixel=1)


def phase4():
    cfg = small_bunny_cfg()
    t0 = time.time()
    scene, cam = bunny_scene(cfg)
    log(f"bunny scene: {scene.num_triangles} triangles, bank "
        f"{tuple(scene.mega_rows.shape)}, chain {scene.mega_chain}, built in "
        f"{time.time() - t0:.1f} s")
    compare_backends("bunny-480x270", scene, cam, cfg)
    return scene


def plain_start(scene, args, state=None):
    """(lanes, loop invariants) of one launch's run_megakernel
    arguments: the plain backend's fresh lanes, or ``state`` to resume."""
    from tpurt_torch.render import megakernel as mk

    ctx = mk.prepare(scene, **args, initial_state=state)
    if not isinstance(ctx, mk._Ctx):  # an older tree's prepare: (lanes, ctx)
        return ctx
    if state is None:
        state = mk.run_megakernel(scene, max_iterations=0, return_state=True, **args)
    return state, ctx


def time_trips(scene, cam, cfg, k: int, label: str, args=None, state=None):
    """The full-size batch's first ``k`` trips through both backends from
    one lane state (agreement, kernel ms, plain ms, the lane work those
    k trips did), then the kernel alone to completion, twice (ms, trips,
    work), with its persistent launch configuration. ``args``: the
    batch's run_megakernel arguments (default: the flat batch at 0);
    ``state``: a lane state to resume instead of the fresh lanes (``args``
    then as ``renderer._mega_stage_more`` passes them)."""
    import torch

    from tpurt_torch.render import mega_cuda
    from tpurt_torch.render import megakernel as mk
    from tpurt_torch.render.renderer import flat_batch_args

    log_depth(label, scene)
    lane, ctx = plain_start(scene, args or flat_batch_args(scene, cam, cfg, 0), state)
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
    launch = mega_cuda.launch_config(ctx.tables.dense is not None, tlas=ctx.tlas,
                                     bf16=ctx.bf16, deep=mega_cuda.deep_stack(ctx),
                                     jitter=ctx.jitter, s_depth=ctx.s_depth)
    blocks = min(launch["blocks_per_sm"] * launch["sms"],
                 -(-r // launch["threads"]))
    log(f"{label} persistent launch: {blocks} blocks x {launch['threads']} "
        f"threads ({launch['blocks_per_sm']} resident per SM x {launch['sms']} "
        f"SMs = {launch['resident_lanes']} resident lanes, "
        f"{launch['smem_bytes']} bytes of dynamic shared memory a block) for "
        f"{r} lanes, {r / (blocks * launch['threads']):.2f} lanes per thread")
    log(f"{label} batch to completion: kernel ms {full}, {int(trips.max())} "
        f"trips for the slowest lane, mean {float(trips.float().mean()):.2f}, "
        f"{int(trips.long().sum())} lane trips, {lanes_per_group(work)} lanes a "
        f"completion group | {CARD}")
    # The slowest lane alone, from its first state: how long its chain of
    # trips takes with the card to itself (the floor under a batch that
    # starts it late). It must end where it ended in the batch.
    i = int(trips.argmax())
    ctx1 = ctx if ctx.slot_rd is None else ctx._replace(
        slot_rd=ctx.slot_rd[:, :, i:i + 1].contiguous())
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
    in a pack or a list quota one pixel row, where it advances), each
    once."""
    from tpurt_torch.render import mega_cuda

    ctx = tt["ctx"]
    words = len(mega_cuda.LANE_WORDS) + ctx.s_depth + (
        3 * ctx.p_count if ctx.p_count > 1 else 0) + (
        len(mega_cuda.TLAS_WORDS) if ctx.tlas else 0)
    tables = 0
    if ctx.slot_rd is not None:
        a = adv.long()
        tables = int(a.clamp(max=ctx.slot_rd.shape[1]).sum()) * 12
        if ctx.slot_pix is not None:
            tables += int(a.clamp(max=ctx.slot_pix.shape[0]).sum()) * 4
    nbytes = (scene.mega_rows.numel() * 4 + tables
              + 2 * words * 4 * tt["lanes"])
    boxes, leaves, segs = work[:3]
    enters, exits = work[3:5] if ctx.tlas else (0, 0)
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
    cols = tt["ctx"].tables.dense.count
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
    from tpurt_torch.render.intersect import local_rays
    from tpurt_torch.render.renderer import _tile_pixel_coords
    from tpurt_torch.scene.types import MaterialType, culls_backfaces

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
    fused_cull = torch.cat([torch.full((n,), culls_backfaces(scene.mesh_mat_types[i]))
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
                cull = culls_backfaces(scene.mesh_mat_types[i])
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


def sass_opcodes(lib: str) -> dict:
    """{kernel entry: [opcode, ...]} of a built library, from
    ``cuobjdump -sass``; a megakernel entry is named by its template
    arguments (``megakernel<kDense,kTlas,kBf16,kDeep>``, 0/1)."""
    import re

    from tpurt_torch import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    ops, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            t = re.search(r"megakernelILb(\d)ELb(\d)ELb(\d)ELb(\d)E", m.group(1))
            fn = f"megakernel<{','.join(t.groups())}>" if t else m.group(1)
            ops[fn] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn and m:
            ops[fn].append(m.group(1))
    return ops


def sass_summary(lib: str) -> dict:
    """{kernel entry: (instructions, sha1 of its opcode sequence)} of a
    built library: two builds whose opcode sequences hash alike run the
    same instructions, whatever registers and parameter offsets they
    use."""
    import hashlib

    return {f: (len(o), hashlib.sha1(" ".join(o).encode()).hexdigest()[:12])
            for f, o in sass_opcodes(lib).items()}


#: The memory instructions ``sass_memory`` counts: local loads and stores
#: (spills and local arrays), global loads (LDG; the row loads among
#: them), shared loads and stores, and generic loads and stores.
SASS_MEMORY = ("LDL", "STL", "LDG", "LDS", "STS", "LD", "ST")


def sass_memory(lib: str) -> dict:
    """{kernel entry: {opcode: static count}} of ``SASS_MEMORY`` in a
    built library's SASS, and of the 128-bit global loads (``LDG.128``)."""
    out = {}
    for fn, ops in sass_opcodes(lib).items():
        base = [op.split(".")[0] for op in ops]
        n = {k: base.count(k) for k in SASS_MEMORY}
        n["LDG.128"] = sum(op.startswith("LDG") and ".128" in op for op in ops)
        out[fn] = n
    return out


def log_sass_memory(name: str, lib: str):
    for fn, n in sass_memory(lib).items():
        log(f"  SASS {name} {fn}: " + ", ".join(f"{k} {v}" for k, v in n.items()))


def b1_batch_inputs():
    """[(batch, scene, lane state, context, trips)] of B1's batches on the
    port's main paths, each from its first lane state: bunny-1080p-plain's
    batch (its first 16 trips, and to completion), its jitter and packed
    F = 2 forms, grid-64-720p-tlas, deep-stack-256, teapot-720p-bruteforce
    (the dense instantiation), the staged bunny-1080p-bvh frame's
    respread tail and glass-cornell's final 1080p batch (its first 64
    trips, and to completion). Calls that every version of the port with
    the glass configuration's RenderConfig fields has."""
    from tpurt_torch.render import megakernel as mk
    from tpurt_torch.render import renderer as R
    from tpurt_torch.render.renderer import flat_batch_args, render_frame
    from tpurt_torch.scene.presets import (PROBE_MATERIAL, bench_scene,
                                           deep_stack_scene, grid_scene)

    out = []

    def add(name, scene, args, trips=None):
        lane, ctx = plain_start(scene, args)
        out.append((name, scene, lane, ctx, trips))

    cfg = bunny_cfg(1920, 1080)
    bunny, cam = bunny_scene(cfg)
    add("bunny 16 trips", bunny, flat_batch_args(bunny, cam, cfg, 0), 16)
    add("bunny", bunny, flat_batch_args(bunny, cam, cfg, 0))
    jcfg = cfg.replace(subpixel_jitter=True)
    add("bunny jitter", bunny, flat_batch_args(bunny, cam, jcfg, 0))
    pcfg = cfg.replace(mega_frames_per_batch=2)
    add("bunny packed F = 2", bunny, flat_batch_args(bunny, cam, pcfg, 0, frames=2))
    gcfg = grid_cfg(1280, 720, rays_per_batch=230400)
    grid = grid_scene(64, subdivisions=1, materials=(PROBE_MATERIAL,), device="cuda")
    add("grid-64 TLAS", grid, flat_batch_args(grid, grid_camera(1280, 720), gcfg, 0))
    from tpurt_torch.config import RenderConfig

    dcfg = RenderConfig(width=256, height=256, rays_per_pixel=2, max_bounces=3,
                        pixels_per_lane=2, mega_tail_passes=2, tile_size=24)
    deep, dcam = deep_stack_scene(dcfg, device="cuda")
    add("deep-stack-256", deep, flat_batch_args(deep, dcam, dcfg, 0))
    tcfg = teapot_cfg(1280, 720)
    teapot, tcam = bench_scene("teapot", tcfg, device="cuda")
    add("teapot dense", teapot, flat_batch_args(teapot, tcam, tcfg, 0))
    scfg = ladder_cfg(1920, 1080, rays_per_pixel=8, max_bounces=4,
                      compaction_threshold=32768)
    scam = camera_for(scfg)
    clear_plans()
    render_frame(bunny, scam, scfg)
    tail_w, pixpack = respread_tail(bunny, scam, scfg, plan_of())
    targs = dict(R._mega_statics(scfg, bunny), pixel_index=pixpack[:tail_w],
                 frame_index=0, sample_offset=0, camera=scam)
    del targs["body_backend"]
    targs["ro0"], targs["rd0"] = R._rays_of(scam, targs["pixel_index"],
                                            scfg.width, scfg.height)
    add("staged respread tail", bunny, targs)
    gcfg = glass_cfg(1920, 1080)
    glass, gcam = glass_scene(gcfg)
    add("glass final 64 trips", glass, flat_batch_args(glass, gcam, gcfg, 0), 64)
    add("glass final", glass, flat_batch_args(glass, gcam, gcfg, 0))
    return out


def b1_public_main():
    """``--b1-public``: B1's batches (``b1_batch_inputs``) through its
    public entry ``mega_cuda.launch``, best of 3 on the device; the
    headline ladder row (``bench.run_config`` on bunny-1080p-plain
    packed F = 2); the SASS of each megakernel instantiation
    (``sass_summary``, ``sass_memory``). The last line is JSON."""
    from tpurt_torch import _build, bench
    from tpurt_torch.render import mega_cuda

    _build.build_all(["megakernel", "megakernel_jitter", "tpurt_native"])
    for name in ("megakernel", "megakernel_jitter"):
        lib = _build.lib_path(name)
        for fn, (n, digest) in sass_summary(lib).items():
            log(f"B1 SASS {name} {fn}: {n} instructions, opcode sequence {digest}")
        log_sass_memory(name, lib)
    batches = {}
    for name, _scene, lane, ctx, trips in b1_batch_inputs():
        buf0 = mega_cuda.pack(lane)
        mega_cuda.launch(buf0.clone(), ctx, trips)  # warm-up
        bufs = iter([buf0.clone() for _ in range(3)])
        (tr, work), ms = device_ms(lambda: mega_cuda.launch(next(bufs), ctx, trips), 3)
        batches[name] = min(ms)
        log(f"B1 public entry, {name} ({buf0.shape[1]} lanes): device ms "
            f"{[round(t, 3) for t in ms]} (best {min(ms):.3f}); "
            f"{int(tr.long().sum()) / max(int(work[2].long().sum()), 1):.3f} lane "
            f"trips a segment, {lanes_per_group(work)} lanes a completion "
            f"group | {CARD}")
    row = bench.run_config("bunny-1080p-plain", "bunny", ladder_cfg(
        1920, 1080, rays_per_pixel=8, max_bounces=4, mega_frames_per_batch=2),
        repeats=2)
    log(f"headline bunny-1080p-plain: {row['seconds'] * 1e3:.3f} ms a frame, "
        f"{row['mrays']:.1f} Mrays/s | {CARD}")
    print(json.dumps({"card": CARD, "b1_ms": batches,
                      "headline": {"ms": row["seconds"] * 1e3, "mrays": row["mrays"]}}))


def b1_turns_main(other: str):
    """``--b1-turns DIR``: ``--b1-public`` in an unpacked older tree
    ``DIR`` (this script copied into it) and in this one, in turns (older,
    this, this, older), each in its own process; then each batch's and
    the headline's times side by side."""
    import shutil

    shutil.copy(os.path.abspath(__file__), os.path.join(other, "chip_smoke.py"))
    trees = {"parent": os.path.abspath(other), "change": ROOT}
    runs = {k: [] for k in trees}
    for k in ("parent", "change", "change", "parent"):
        t = time.time()
        proc = subprocess.run([sys.executable, "chip_smoke.py", "--b1-public"],
                              cwd=trees[k], capture_output=True, text=True)
        for line in proc.stdout.splitlines()[:-1]:
            if "device ms" in line or "headline" in line:
                log(f"  {k}: {line}")
        if proc.returncode != 0:
            raise AssertionError(f"--b1-public in {trees[k]} failed:\n"
                                 f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        runs[k].append(json.loads(proc.stdout.splitlines()[-1]))
        log(f"{k} --b1-public: {time.time() - t:.1f} s")
    for batch in runs["change"][0]["b1_ms"]:
        vals = {k: [r["b1_ms"][batch] for r in v] for k, v in runs.items()}
        log(f"B1 {batch} in turns, device ms best of 3: parent "
            f"{[round(t, 3) for t in vals['parent']]}, change "
            f"{[round(t, 3) for t in vals['change']]} | {CARD}")
    for key in ("ms", "mrays"):
        vals = {k: [r["headline"][key] for r in v] for k, v in runs.items()}
        log(f"headline bunny-1080p-plain {key} in turns: parent "
            f"{[round(t, 3) for t in vals['parent']]}, change "
            f"{[round(t, 3) for t in vals['change']]} | {CARD}")
    print(json.dumps({"card": CARD, "runs": runs}))


def tuned_vs_shipped_main():
    """``--tuned-vs-shipped``: the autotuner's leg (``autotune._time_leg``,
    bunny-1080p at the seed config, packed F = 2) under the card's cached
    knob set against the shipped knobs (a8/l3/u8, tail 5, P = 8), in
    turns, 4 legs each."""
    from tpurt_torch import _build, autotune

    _build.build_all(["megakernel", "tpurt_native"])
    tuned = autotune.load_tuned()
    if not tuned:
        raise SystemExit("no autotune cache for this card (run python -m "
                         "tpurt_torch.autotune first)")
    seed = autotune._seed_config()
    shipped = {"node_arity": 8, "leaf_tris": 3, "bounds_fmt": "u8",
               "mega_tail_passes": seed.mega_tail_passes,
               "pixels_per_lane": seed.pixels_per_lane}
    legs = {}
    for name, knobs in (("shipped", shipped), ("tuned", tuned)):
        cfg = autotune.apply(knobs, seed)
        scene, cam = bunny_scene(cfg)
        legs[name] = (scene, cam, cfg)
    autotune.apply(shipped, seed)
    times = {"shipped": [], "tuned": []}
    for name in ("shipped", "tuned", "tuned", "shipped") * 2:
        r = autotune._time_leg(*legs[name])
        times[name].append(round(r["seconds"] * 1e3, 3))
    log(f"tuned {tuned}")
    log(f"bunny-1080p leg in turns, ms/frame: shipped {times['shipped']}, "
        f"tuned {times['tuned']} | {CARD}")


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
        lane, ctx = plain_start(scene, flat_batch_args(scene, bcam, big, 0))
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
    # Its primary rays hold 67 entries after trip 34, past the shared
    # ring's 64 words: compared there, and with the budget cut to 66 words
    # (still kDeep), where each of them drops its bottom entry. One
    # sample a pixel: the plain version takes a step per trip, and each
    # sample's walk down and back up the chain is ~140 trips.
    one = cfg.replace(rays_per_pixel=1, pixels_per_lane=1)
    compare_backends("deep-stack-64", dscene, dcam, one, trips=(1, 16, 34, 100))
    lane, ctx = plain_start(dscene, flat_batch_args(dscene, dcam, one, 0))
    held = int(mk.stack_entries(mk.run_plain(lane, ctx, 34)).max())
    lane, ctx = lane._replace(stack=lane.stack[:66]), ctx._replace(s_depth=66)
    if held <= mega_cuda.MAX_SHARED_STACK or not mega_cuda.deep_stack(ctx):
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
    ctx = mk.prepare(dscene, **flat_batch_args(dscene, dcam, big, 0))
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


def compare_list(name, scene, cam, cfg, pixels, lanes=None):
    """A list-quota launch over ``pixels`` (renderer.list_batch_args)
    through B1 against the plain version: lane fields after 1, 4 and 16
    trips, then the radiance rows and segments to the end; the launch to
    completion timed against the plain version, with its counted bound.
    Returns the kernel's rows."""
    import torch

    from tpurt_torch.render import mega_cuda
    from tpurt_torch.render import megakernel as mk
    from tpurt_torch.render.megakernel import run_megakernel
    from tpurt_torch.render.renderer import list_batch_args

    args = list_batch_args(scene, cam, cfg, pixels, lanes=lanes)
    r = args["pixel_index"].shape[0]
    for k in (1, 4, 16):
        st = [run_megakernel(scene, body_backend=b, max_iterations=k,
                             return_state=True, **args) for b in ("plain", "cuda")]
        agree, err = mega_cuda.compare_lanes(*st)
        log(f"{name}: after {k} trips, integer fields (lane0 included) agree on "
            f"{agree:.4%} of {r} lanes, float max abs err {err:.3g}")
        if agree < LANE_AGREE:
            raise AssertionError(f"{name}: lane agreement {agree:.4%}")
    reset_counts()
    kern = run_megakernel(scene, body_backend="cuda", **args)
    if counts()["megakernel"] != 1:
        raise AssertionError(f"{name}: {counts()} launches")
    plain = run_megakernel(scene, body_backend="plain", **args)
    n = len(pixels)
    same = float((kern[0][:n] == plain[0][:n]).all(-1).float().mean())
    log(f"{name}: {n} listed pixels, {r} lanes; rows equal on {same:.4%}, "
        f"bit for bit {bool(torch.equal(kern[0], plain[0]))}; segments kernel "
        f"{kern[1]} plain {plain[1]}; trips {kern[2]}")
    if 1.0 - same > MAX_FLIP or abs(kern[1] - plain[1]) > SEG_TOL * plain[1]:
        raise AssertionError(f"{name}: rows or segments differ")
    lane, ctx = plain_start(scene, args)
    buf0 = mega_cuda.pack(lane)
    mega_cuda.launch(buf0.clone(), ctx, None)  # warm-up
    bufs = [buf0.clone() for _ in range(3)]
    it = iter(bufs)
    (_trips, work), k_ms = cuda_ms(lambda: mega_cuda.launch(next(it), ctx, None), 3)
    _out, p_ms = cuda_ms(lambda: mk.run_plain(lane, ctx, None))
    adv = mega_cuda.unpack(bufs[-1], ctx, 0).pixno - lane.pixno
    b_ms, b_by = megakernel_bound(scene, dict(ctx=ctx, lanes=r),
                                  [int(w) for w in work.long().sum(1)], adv, name)
    log(f"{name}: to completion kernel ms {[round(t, 4) for t in k_ms]}, plain ms "
        f"{[round(t, 1) for t in p_ms]}, bound {b_ms:.4f} ms ({b_by}) | {CARD}")
    return kern[0]


def phase17():
    """B1 with jitter (both seed modes) and with list quotas, small."""
    import numpy as np

    from tpurt_torch.config import RenderConfig
    from tpurt_torch.render.renderer import flat_batch_args, render_frame
    from tpurt_torch.scene.presets import cornell_sphere_scene

    cfg = RenderConfig(width=64, height=64, rays_per_pixel=2, max_bounces=3,
                       pixels_per_lane=2, mega_tail_passes=2)
    scene, cam, _ = cornell_sphere_scene(2, cfg, device="cuda")
    for mode in ("reference", "decorrelated"):
        jcfg = cfg.replace(subpixel_jitter=True, seed_mode=mode)
        reset_counts()
        compare_backends(f"cornell-sphere-64-jitter-{mode}", scene, cam, jcfg)
        launched = counts()
        if launched["jitter"] < 1 or launched["megakernel"]:
            raise AssertionError(f"jitter: launches {launched}")
    n = cfg.width * cfg.height
    for p in (2, 4):
        perm = np.random.default_rng(p).permutation(n)
        compare_list(f"cornell-sphere-64-list-P{p}", scene, cam,
                     cfg.replace(pixels_per_lane=p), perm)
    lanes = flat_batch_args(scene, cam, cfg, 0)["pixel_index"].shape[0]
    rows = compare_list("cornell-sphere-64-list-identity", scene, cam, cfg,
                        np.arange(n), lanes=lanes)
    flat = render_frame(scene, cam, cfg.replace(mega_body="pallas"))
    if not np.array_equal(rows[:n].cpu().numpy().reshape(flat.shape), flat):
        raise AssertionError("the identity list differs from the affine frame")
    log("cornell-sphere-64: the identity list's frame is phase 3's flat frame, "
        "bit for bit")


def phase18(scene, b1):
    """bunny-1080p-jitter at full width through B1's jitter library."""
    import numpy as np

    cfg = bunny_cfg(1920, 1080).replace(subpixel_jitter=True)
    cam = camera_for(cfg)
    tt = time_trips(scene, cam, cfg, 16, "bunny-1080p-jitter")
    if tt["ctx"].use_cache or not tt["ctx"].jitter:
        raise AssertionError("bunny-1080p-jitter: the cache is on or jitter off")
    img, _stats, launches, best = main_path(
        "bunny-1080p-jitter", scene, cam, cfg, "jitter")
    b_ms, b_by = megakernel_bound(scene, tt, tt["work_k"], tt["adv_k"],
                                  "jitter, 16 trips")
    f_ms, _f_by = megakernel_bound(scene, tt, tt["work"], tt["adv"],
                                   "jitter, whole batch")
    differ = float((img != b1["img"]).any(axis=-1).mean())
    log(f"B1 jitter whole batch: {tt['full_ms']:.3f} ms against its bound "
        f"{f_ms:.3f} ms; the unjittered batch (phase 5) {b1['full_ms']:.3f} ms; "
        f"lane trips {int(tt['trips'].long().sum())}, slowest lane "
        f"{int(tt['trips'].max())}; the frame differs from phase 5's on "
        f"{differ:.4%} of pixels (mean pixel {img.mean():.3f} against "
        f"{b1['img'].mean():.3f}); frame {best:.3f} ms against phase 5's "
        f"{b1['frame_ms']:.3f} | {CARD}")
    if differ <= 0.0:
        raise AssertionError("bunny-1080p-jitter: the frame equals the unjittered one")
    return dict(name="b1_jitter: megakernel (B1) built with jitter", route="cuda",
                source="tpurt_torch/csrc/megakernel_jitter.cu",
                replaces="tpurt/render/mega_pallas.py:237", launches=launches,
                max_abs_err=tt["err"], ms=tt["ms"], plain_ms=tt["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def phase19():
    """The application layer on the card: the CLI, pick, the viewer."""
    import contextlib
    import io
    import shutil

    import numpy as np

    from tpurt_torch import cli
    from tpurt_torch.config import RenderConfig
    from tpurt_torch.io import read_bmp
    from tpurt_torch.render.pick import pick_mesh
    from tpurt_torch.render.renderer import render_image
    from tpurt_torch.scene.presets import default_scene
    from tpurt_torch.viewer import run_terminal

    out = os.path.join(ROOT, "build", "chip_smoke_app")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    bmp = os.path.join(out, "output.bmp")
    text = io.StringIO()
    reset_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(text):
        rc = cli.main(["--output", bmp])
    wall = time.time() - t0
    launched = counts()
    for line in text.getvalue().splitlines():
        log("  cli:", line)
    if rc != 0 or launched["megakernel"] < 1:
        raise AssertionError(f"cli: rc {rc}, launches {launched}")
    # The CLI's config on the card: tpurt's defaults, quota 8, 5 tail passes.
    cfg = RenderConfig(pixels_per_lane=cli.CARD_PIXELS_PER_LANE,
                       mega_tail_passes=cli.CARD_TAIL_PASSES, mega_interleave=1)
    scene, cam, _ = default_scene(cfg, device="cuda")
    want = render_image(scene, cam, cfg)
    got = read_bmp(bmp)
    if not np.array_equal(got, want):
        raise AssertionError("cli: output.bmp differs from render_image's frame")
    log(f"cli at the reference defaults ({cfg.width}x{cfg.height}, "
        f"{cfg.rays_per_pixel} spp, {cfg.max_bounces} bounces, "
        f"{cfg.object_path} stand-in): {wall:.2f} s with the scene build, "
        f"launches {launched}; output.bmp equals render_image's frame bit for "
        f"bit (mean pixel {got.mean():.3f}) | {CARD}")
    staged_vs_plain("cli", scene, cam, cfg)
    small = ["--width", "64", "--height", "64", "--rays-per-pixel", "2",
             "--max-bounces", "3"]
    for what, extra, counter in (
            ("scene-json", ["--scene-json", os.path.join(ROOT, "examples",
                                                         "cornell_knot.json")],
             "megakernel"),
            ("modular jitter", ["--engine", "modular", "--subpixel-jitter",
                                "--seed-mode", "decorrelated",
                                "--object-path", "sphere2.obj"], "mt_sweep")):
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(small + extra + ["--output", os.path.join(out, "s.bmp")])
        launched = counts()
        img = read_bmp(os.path.join(out, "s.bmp"))
        if rc != 0 or launched[counter] < 1 or img.shape != (64, 64, 3):
            raise AssertionError(f"cli {what}: rc {rc}, launches {launched}")
        log(f"cli {what} at 64x64: launches {launched}, mean pixel {img.mean():.3f}")
    vcfg = RenderConfig(width=64, height=64, rays_per_pixel=1, max_bounces=3,
                        tile_size=64, object_path="sphere2.obj")
    vscene, vcam, _ = default_scene(vcfg, device="cuda")
    g = (np.arange(16, dtype=np.float32) + 0.5) / 16
    uv = np.stack(np.meshgrid(g, g, indexing="xy"), -1)
    on_card = pick_mesh(vscene, vcam, uv).cpu().numpy()
    cscene, ccam, _ = default_scene(vcfg, device="cpu")
    on_cpu = pick_mesh(cscene, ccam, uv).numpy()
    if not np.array_equal(on_card, on_cpu):
        raise AssertionError("pick_mesh on the card differs from the CPU pick")
    log(f"pick_mesh: a 16x16 uv grid on the card equals the CPU pick "
        f"({len(set(on_card.ravel().tolist()))} distinct meshes)")
    cwd = os.getcwd()
    os.chdir(out)
    try:
        reset_counts()
        ses = run_terminal(vscene, vcfg, preview_path="preview.bmp",
                           stream=io.StringIO("ww\n+\np 32 48\ng 2\no\nQ\n"),
                           out=io.StringIO())
        launched = counts()
        made = sorted(f for f in os.listdir(".") if f in ("preview.bmp", "output.bmp"))
    finally:
        os.chdir(cwd)
    if made != ["output.bmp", "preview.bmp"] or launched["megakernel"] < 1:
        raise AssertionError(f"viewer: wrote {made}, launches {launched}")
    log(f"viewer: scripted session (ww, +, p 32 48 -> mesh {ses.picked}, g 2, o) "
        f"wrote preview.bmp and output.bmp; {ses.num_passes} passes, launches "
        f"{launched}")
    shutil.rmtree(out)


def phase20():
    """The autotuner: every AXES bank shape through B1, the quick sweep
    and the CLI's --tuned."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np

    import tpurt_torch.config as cfgmod
    from tpurt_torch import autotune, cli
    from tpurt_torch.config import RenderConfig
    from tpurt_torch.io import read_bmp
    from tpurt_torch.render.renderer import render_image
    from tpurt_torch.scene.presets import cornell_sphere_scene, default_scene

    saved = {k: getattr(cfgmod, k) for k in (
        "MEGA_NODE_ARITY", "MEGA_LEAF_TRIS", "MEGA_BF16_BOUNDS")}
    tune_dir = os.environ.get("TPURT_TUNE_DIR")
    tmp = tempfile.mkdtemp(prefix="tpurt_tune_")
    try:
        cfg = RenderConfig(width=64, height=64, rays_per_pixel=1, max_bounces=3,
                           pixels_per_lane=2, mega_tail_passes=2)
        shipped = {"node_arity": 8, "leaf_tris": 3, "bounds_fmt": "u8"}
        axes = dict(autotune.AXES)
        shapes = []
        for axis in ("node_arity", "leaf_tris", "bounds_fmt"):
            for v in axes[axis]:
                shape = dict(shipped, **{axis: v})
                if shape not in shapes:
                    shapes.append(shape)
        for shape in shapes:
            autotune.apply(shape, cfg)
            scene, cam, _ = cornell_sphere_scene(3, cfg, device="cuda")
            label = "a{node_arity}-l{leaf_tris}-{bounds_fmt}".format(**shape)
            log(f"bank {label}: rows {tuple(scene.mega_rows.shape)}, chain "
                f"{scene.mega_chain}")
            compare_backends(f"cornell-sphere3-64-{label}", scene, cam, cfg)
        for k, v in saved.items():
            setattr(cfgmod, k, v)

        os.environ["TPURT_TUNE_DIR"] = tmp
        text = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(text):
            rc = autotune.main(["--quick"])
        for line in text.getvalue().splitlines():
            log("  autotune:", line)
        knobs = autotune.load_tuned()
        if rc != 0 or not knobs:
            raise AssertionError(f"autotune --quick: rc {rc}, cache {knobs}")
        log(f"quick sweep at bunny-1080p: {time.time() - t0:.1f} s, winner "
            f"{knobs} | {CARD}")
        # The baseline leg again, three times: the spread a winner's
        # margin is read against.
        seed = autotune._seed_config()
        scene, cam = bunny_scene(seed)
        again = [autotune._time_leg(scene, cam, seed)["seconds"] * 1e3
                 for _ in range(3)]
        log(f"baseline leg (seed config) three more times, ms/frame: "
            f"{[round(t, 3) for t in again]} | {CARD}")

        bmp = os.path.join(tmp, "output.bmp")
        text = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(text):
            rc = cli.main(["--tuned", "--output", bmp])
        launched = counts()
        for line in text.getvalue().splitlines():
            log("  cli --tuned:", line)
        if (rc != 0 or launched["megakernel"] < 1
                or f"Tuned knobs ({autotune.cache_path(autotune.device_key())})"
                not in text.getvalue()):
            raise AssertionError(f"cli --tuned: rc {rc}, launches {launched}")
        tcfg = autotune.apply(knobs, RenderConfig(
            pixels_per_lane=cli.CARD_PIXELS_PER_LANE,
            mega_tail_passes=cli.CARD_TAIL_PASSES, mega_interleave=1))
        scene, cam, _ = default_scene(tcfg, device="cuda")
        if not np.array_equal(read_bmp(bmp), render_image(scene, cam, tcfg)):
            raise AssertionError("cli --tuned: output.bmp differs from "
                                 "render_image's frame of the tuned config")
        log(f"cli --tuned at the reference defaults: P={tcfg.pixels_per_lane}, "
            f"tail {tcfg.mega_tail_passes}, bank a{scene.mega_arity}-"
            f"l{scene.mega_leaf_tris}-{scene.mega_bounds_fmt}, launches "
            f"{launched}; output.bmp equals render_image's frame")
        staged_vs_plain("cli --tuned", scene, cam, tcfg)
    finally:
        for k, v in saved.items():
            setattr(cfgmod, k, v)
        if tune_dir is None:
            os.environ.pop("TPURT_TUNE_DIR", None)
        else:
            os.environ["TPURT_TUNE_DIR"] = tune_dir
        shutil.rmtree(tmp, ignore_errors=True)


def covered_segments(per_px, starts, launch_px) -> int:
    """The segments of flat launches of ``launch_px`` pixels at
    ``starts`` (tensors on the card), each pixel past the frame end
    counted as the last one (the lanes' clamp)."""
    import torch

    last = per_px.shape[0] - 1
    ar = torch.arange(launch_px, device=per_px.device)
    return sum(int(per_px[torch.clamp_max(ar + s, last)].sum()) for s in starts)


def sharded_starts(cfg, n_tile: int, k: int):
    """(starts, launch pixels) of render_frame_sharded's flat launches."""
    total = cfg.width * cfg.height
    block = -(-total // (n_tile * k))
    p = cfg.pixels_per_lane
    launch = min(cfg.rays_per_batch, -(-block // (256 * p)) * 256) * p
    return [j * block + q * launch for j in range(n_tile * k)
            for q in range(-(-block // launch))], launch


def phase21(bunny, b1):
    """Sharded frames: B1 (bunny), B2 (teapot), B3 (parity, modular) and
    one NCCL group of one process."""
    import datetime
    import socket

    import numpy as np
    import torch

    from tpurt_torch.parallel import make_mesh, mesh_info, render_frame_sharded
    from tpurt_torch.render.megakernel import run_megakernel
    from tpurt_torch.render.renderer import (
        _flat_batch_size, flat_batch_args, render_frame, render_image)
    from tpurt_torch.render.tonemap import tonemap
    from tpurt_torch.scene.presets import bench_scene

    dev = torch.device("cuda", 0)

    def u8(radiance):
        return tonemap(torch.as_tensor(radiance, device=dev)).cpu().numpy()

    def sharded(name, scene, cam, cfg, mesh, counter, want, k=1, stats=None,
                replicate_out=None):
        reset_counts()
        out = render_frame_sharded(scene, cam, cfg, mesh=mesh, overdecompose=k,
                                   stats=stats, replicate_out=replicate_out)
        launched = counts()
        if launched[counter] < 1:
            raise AssertionError(f"{name}: no {counter} launch ({launched})")
        if not np.array_equal(out, want):
            raise AssertionError(f"{name}: differs from the single-device frame")
        log(f"{name} ({mesh_info(mesh)}, k {k}): equal bit for bit to "
            f"render_frame; launches {launched}")
        return out

    def in_turns(label, scene, cam, cfg, mesh):
        t_img, t_sh = [], []
        for _ in range(2):
            t_img += cuda_ms(lambda: render_image(scene, cam, cfg))[1]
            t_sh += cuda_ms(lambda: render_frame_sharded(scene, cam, cfg,
                                                         mesh=mesh))[1]
        log(f"{label} in turns, ms: render_image {t_img}, sharded "
            f"({mesh_info(mesh)}) {t_sh} | {CARD}")

    cfg = bunny_cfg(1920, 1080)
    cam = camera_for(cfg)
    st = {}
    ref = render_frame(bunny, cam, cfg, stats=st)
    if not np.array_equal(u8(ref), b1["img"]):
        raise AssertionError("bunny-1080p: render_frame's pixels are not phase 5's")
    lane = run_megakernel(bunny, body_backend="cuda", return_state=True,
                          **flat_batch_args(bunny, cam, cfg.replace(
                              pixels_per_lane=1), 0,
                              batch=cfg.width * cfg.height))
    per_px = lane.segments.long()
    b = _flat_batch_size(cfg) * cfg.pixels_per_lane
    want = covered_segments(per_px, range(0, cfg.width * cfg.height, b), b)
    if st["segments"] != want:
        raise AssertionError(f"bunny-1080p: {st['segments']} segments, the "
                             f"per-pixel counts give {want}")
    one = make_mesh(1, 1, devices=[dev])
    for k in (1, 4):
        s = {}
        out = sharded("bunny-1080p-plain sharded", bunny, cam, cfg, one,
                      "megakernel", ref, k=k, stats=s)
        starts, launch = sharded_starts(cfg, 1, k)
        want = covered_segments(per_px, starts, launch)
        if s["segments"] != want or not np.array_equal(u8(out), b1["img"]):
            raise AssertionError(f"bunny sharded k {k}: segments {s['segments']} "
                                 f"against {want}, or pixels not phase 5's")
        log(f"bunny-1080p-plain sharded k {k}: {len(starts)} launches of "
            f"{launch} pixels, {s['segments']} segments (render_frame "
            f"{st['segments']}: {b} pixels a launch); both equal the per-pixel "
            f"counts over the pixels their launches cover")
    times = {}
    for what in ("image", "k1", "k4", "k4", "k1", "image"):
        fn = (lambda: render_image(bunny, cam, cfg)) if what == "image" else (
            lambda: render_frame_sharded(bunny, cam, cfg, mesh=one,
                                         overdecompose=int(what[1])))
        _out, ms = cuda_ms(fn)
        times.setdefault(what, []).extend(ms)
    log(f"bunny-1080p in turns, ms: render_image {times['image']}, sharded "
        f"k 1 {times['k1']}, sharded k 4 {times['k4']} (f32 frame to the host) "
        f"| {CARD}")

    dcfg = cfg.replace(seed_mode="decorrelated")
    single = render_frame(bunny, cam, dcfg)
    reset_counts()
    two = make_mesh(1, 2, devices=[dev, dev])
    samp = render_frame_sharded(bunny, cam, dcfg, mesh=two)
    err = float(np.abs(samp - single).max())
    log(f"bunny-1080p decorrelated over {mesh_info(two)}: max abs err {err:.3g} "
        f"(tolerance 1e-5); launches {counts()}")
    if not err <= 1e-5:
        raise AssertionError(f"sample axis: max abs err {err}")

    tile2 = make_mesh(2, 1, devices=[dev, dev])
    tcfg = teapot_cfg(1280, 720)
    teapot, tcam = bench_scene("teapot", tcfg, device="cuda")
    tref = render_frame(teapot, tcam, tcfg)
    out = sharded("teapot-720p-bruteforce sharded", teapot, tcam, tcfg, tile2,
                  "dense", tref)
    if not np.array_equal(u8(out), render_image(teapot, tcam, tcfg)):
        raise AssertionError("teapot sharded: pixels differ from render_image's")
    in_turns("teapot-720p-bruteforce", teapot, tcam, tcfg, tile2)
    pcfg = parity_cfg()
    sphere, pcam = bench_scene("sphere", pcfg, device="cuda")
    for label, c in (("parity-640x480-modular", pcfg),
                     ("640x480-2spp-4-bounces-modular",
                      pcfg.replace(rays_per_pixel=2, max_bounces=4))):
        out = sharded(f"{label} sharded", sphere, pcam, c, tile2, "mt_sweep",
                      render_frame(sphere, pcam, c))
        if not np.array_equal(u8(out), render_image(sphere, pcam, c)):
            raise AssertionError(f"{label} sharded: pixels differ from "
                                 "render_image's")
        in_turns(label, sphere, pcam, c, tile2)

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=120))
    try:
        torch.cuda.set_device(dev)
        s = {}
        out = sharded("bunny-1080p-plain through a world-size-1 NCCL group",
                      bunny, cam, cfg, make_mesh(1, 1, devices=[dev]),
                      "megakernel", ref, k=2, stats=s, replicate_out=True)
        starts, launch = sharded_starts(cfg, 1, 2)
        if s["segments"] != covered_segments(per_px, starts, launch):
            raise AssertionError("NCCL group: all-reduced segments differ")
        log(f"NCCL group (backend {torch.distributed.get_backend()}): the "
            f"frame all-gathered, {s['segments']} segments all-reduced")
    finally:
        torch.distributed.destroy_process_group()


def ladder_cfg(width, height, **kw):
    """A row of tpurt_torch.bench's ladder: its common knobs (tile 256,
    reference seeds, quota 8, tail 5, plain batches) under ``kw``."""
    from tpurt_torch.config import RenderConfig

    knobs = dict(tile_size=256, seed_mode="reference", pixels_per_lane=8,
                 mega_interleave=4, mega_tail_passes=5, compaction_threshold=0)
    return RenderConfig(width=width, height=height, **{**knobs, **kw})


def compare_deep(name, scene, cam, cfg, k: int = 16):
    """B1 against its plain version on a run too long for the plain
    version's whole frame (at 2,048 samples a lane its ~10^4 trips took
    over 950 s on an H100): the lane states after 1, 4 and 16 trips from
    the start, then after ``k`` more trips of each backend from the
    kernel's own state at a quarter, half and the end of its run (integer
    fields on >= 99.5% of lanes); the kernel's frame against the same
    frame at one pixel a lane and against the modular engine's plain
    torch frame (dense_engine="exact", no kernel): pixels <= 0.5%, the
    one-pixel-a-lane segments (no padding lane) within 0.5% of the
    modular engine's."""
    import torch

    from tpurt_torch.render import mega_cuda
    from tpurt_torch.render.megakernel import run_megakernel
    from tpurt_torch.render.renderer import flat_batch_args, render_frame

    log_depth(name, scene)
    args = flat_batch_args(scene, cam, cfg, 0)

    def check(label, a, b):
        agree, err = mega_cuda.compare_lanes(a, b)
        log(f"{name}: {label}, integer fields agree on {agree:.4%} of "
            f"{args['pixel_index'].shape[0]} lanes, float max abs err {err:.3g}")
        if agree < LANE_AGREE:
            raise AssertionError(f"{name}: {label}: lane agreement {agree:.4%}")

    for t in (1, 4, 16):
        check(f"after {t} trips", *(
            run_megakernel(scene, body_backend=b, max_iterations=t,
                           return_state=True, **args) for b in ("plain", "cuda")))
    kstats = {}
    img = render_frame(scene, cam, cfg.replace(mega_body="pallas"), stats=kstats)
    total = kstats["trips"]
    for start in (total // 4, total // 2, total - k):
        state = run_megakernel(scene, body_backend="cuda", max_iterations=start,
                               return_state=True, **args)
        out = {}
        for b in ("plain", "cuda"):
            torch.cuda.synchronize()
            t0 = time.time()
            out[b] = run_megakernel(scene, body_backend=b, initial_state=state,
                                    max_iterations=k, return_state=True, **args)
            torch.cuda.synchronize()
            out[b + "_s"] = time.time() - t0
        check(f"trips {start + 1}-{start + k} from the kernel's state (plain "
              f"{out['plain_s'] / k * 1e3:.1f} ms a trip, kernel "
              f"{out['cuda_s'] / k * 1e3:.2f})", out["plain"], out["cuda"])
    one = {}
    img1 = render_frame(scene, cam, cfg.replace(mega_body="pallas",
                                                pixels_per_lane=1), stats=one)
    t0 = time.time()
    mod = {}
    img_m = render_frame(scene, cam, cfg.replace(engine="modular",
                                                 dense_engine="exact"), stats=mod)
    mod_s = time.time() - t0
    f1 = mostly_bitwise(img1, img, f"{name}: P=1 against P={cfg.pixels_per_lane}")
    fm = mostly_bitwise(img_m, img, f"{name}: the modular engine against B1")
    log(f"{name}: kernel {total} trips, {kstats['segments']} segments (padding "
        f"lanes included); at one pixel a lane {one['trips']} trips, "
        f"{one['segments']} segments, frame differs on {f1:.4%} of pixels; the "
        f"modular engine's plain frame ({mod_s:.1f} s) {mod['segments']} "
        f"segments, differs on {fm:.4%} of pixels")
    if abs(one["segments"] - mod["segments"]) > SEG_TOL * mod["segments"]:
        raise AssertionError(f"{name}: segments {one['segments']} against the "
                             f"modular engine's {mod['segments']}")


def phase22(bunny):
    """tpurt_torch.bench on the card: B1 against its plain version in two
    of the ladder's regimes, two bench rows against ``render_image``'s
    segments, and the sharding row's measuring branch."""
    import math

    import torch

    from tpurt_torch import bench
    from tpurt_torch.render.renderer import render_image

    # 256 spp at a quota of 8: 2,048 samples a lane, cornell-256spp-1080p's
    # count, on the ladder's sphere scene.
    t0 = time.time()
    cfg = ladder_cfg(16, 16, rays_per_pixel=256, max_bounces=4)
    scene, cam = bench.build_scene("sphere", cfg, "cuda")
    compare_deep("cornell-16x16-256spp-P8", scene, cam, cfg)
    log(f"cornell-16x16-256spp-P8: {time.time() - t0:.1f} s")
    # A quota of 16, 4k-anim-sweep's.
    t0 = time.time()
    cfg = ladder_cfg(128, 72, rays_per_pixel=4, max_bounces=4,
                     pixels_per_lane=16)
    compare_backends("bunny-128x72-4spp-P16", bunny, camera_for(cfg), cfg)
    log(f"bunny-128x72-4spp-P16: {time.time() - t0:.1f} s")

    for name, kind, cfg, counter in (
            ("bunny-1080p-plain", "bunny",
             ladder_cfg(1920, 1080, rays_per_pixel=8, max_bounces=4,
                        mega_frames_per_batch=2), "megakernel"),
            ("teapot-720p-bruteforce", "teapot",
             ladder_cfg(1280, 720, rays_per_pixel=8, max_bounces=4,
                        mega_dense=True, rays_per_batch=230400,
                        pixels_per_lane=4), "dense")):
        reset_counts()
        row = bench.run_config(name, kind, cfg, repeats=1)
        launched = counts()
        if launched[counter] < 1:
            raise AssertionError(f"bench {name}: no {counter} launch ({launched})")
        if not math.isclose(row["mrays"], row["avg_path"] * cfg.width
                            * cfg.height * cfg.rays_per_pixel / row["seconds"]
                            / 1e6, rel_tol=1e-12):
            raise AssertionError(f"bench {name}: mrays is not segments / seconds")
        scene, cam = bench.build_scene(kind, cfg, "cuda")
        total = 0
        for f in range(row["frames"]):
            stats = {}
            render_image(scene, cam, cfg, frame_index=f, stats=stats)
            total += stats["segments"]
        block = round(row["avg_path"] * cfg.width * cfg.height
                      * cfg.rays_per_pixel * row["frames"])
        if block != total:
            raise AssertionError(f"bench {name}: the block's {block} segments, "
                                 f"render_image's {total} over its frames")
        log(f"bench {name}: {row}; launches {launched}; the block's {block} "
            f"segments over {row['frames']} frames equal render_image's | {CARD}")

    dev = torch.device("cuda", 0)
    row = bench.run_sharding_efficiency(
        ladder_cfg(1920, 1080, rays_per_pixel=8, max_bounces=4), repeats=1,
        force=True, devices=[dev, dev])
    if row["devices"] != 2 or not (math.isfinite(row["efficiency"])
                                   and row["efficiency"] > 0):
        raise AssertionError(f"bench sharding-efficiency: {row}")
    log(f"bench sharding-efficiency on one card in 2 positions: {row} (plumbing "
        f"only: the number means nothing on one card) | {CARD}")


#: tpurt's test constants for the staged drivers (tests/test_cascade.py):
#: stages of 48 trips, a cascade first stage of 24, levels of 128 lanes,
#: a cascade floor of 64 pixels.
STAGED_SMALL = dict(_MEGA_STAGE_ITERS=48, _CASCADE_STAGE0=24, _CASCADE_W=128,
                    _CASCADE_MIN=64)


def clear_plans():
    """Forget every recorded plan and curve; zero the replay counts."""
    from tpurt_torch.render import renderer as R

    R._SCHED_TRACES.clear()
    R._RETIRE_CURVES.clear()
    R._SPEC_STATS.update(replayed=0, fallback=0)


def plan_of():
    """The recorded plans by depth."""
    from tpurt_torch.render import renderer as R

    return sorted((k[-1], v) for k, v in R._SCHED_TRACES.items())


def staged_pair(name, scene, cam, cfg, replay: bool = False):
    """A staged batch through B1 (mega_body="pallas") and through its
    plain version ("xla"), each recording its plan from scratch: equal
    plans and equal steps with equal live counts, radiance rows and
    segments equal, the rows equal to the plain schedule's batch through
    B1 (compaction_threshold=0) and the segments at least its count. With
    ``replay`` a second batch of each backend replays its plan (no
    fallback), equal again. Returns the steps."""
    import torch

    from tpurt_torch.render import renderer as R

    out = {}
    for body in ("pallas", "xla"):
        clear_plans()
        c = cfg.replace(mega_body=body)
        stats = []
        torch.cuda.synchronize()
        t0 = time.time()
        mean, segs, trips = R.render_batch_flat(scene, cam, c, 0,
                                                stage_stats=stats)
        torch.cuda.synchronize()
        wall = time.time() - t0
        if trips is not None:
            raise AssertionError(f"{name}: the batch did not stage")
        out[body] = (mean, segs, stats, plan_of(), wall)
        if replay:
            again, asegs, _ = R.render_batch_flat(scene, cam, c, 0)
            if (R._SPEC_STATS["replayed"] < 1 or R._SPEC_STATS["fallback"]
                    or not torch.equal(again, mean) or asegs != segs):
                raise AssertionError(f"{name} ({body}): the replay "
                                     f"{R._SPEC_STATS} differs")
    (km, ks, kst, kplan, kw), (pm, ps, pst, pplan, pw) = out["pallas"], out["xla"]
    if kplan != pplan or kst != pst:
        raise AssertionError(f"{name}: plans or steps differ: kernel {kplan} "
                             f"{kst}, plain {pplan} {pst}")
    if not torch.equal(km, pm) or ks != ps:
        raise AssertionError(f"{name}: kernel and plain version differ "
                             f"(segments {ks} and {ps})")
    ref, rsegs, _ = R.render_batch_flat(
        scene, cam, cfg.replace(mega_body="pallas", compaction_threshold=0), 0)
    if not torch.equal(km, ref) or ks < rsegs:
        raise AssertionError(f"{name}: the staged rows differ from the plain "
                             f"schedule's (segments {ks} and {rsegs})")
    log(f"{name}: plan {kplan}; steps {kst}; rows and segments ({ks}) of B1 "
        f"and the plain version equal, and the rows equal the plain "
        f"schedule's ({rsegs} segments); wall s kernel {kw:.2f}, plain "
        f"{pw:.2f}{'; replayed equal' if replay else ''}")
    return kst


def phase23(bunny):
    """tpurt's staged drivers (renderer._mega_finish_staged and family)
    on the card: small, B1 against its plain version in five schedules
    and the dense and TLAS instantiations; then bunny-1080p-bvh at tpurt's
    staged knobs, blocking and replayed, against the plain schedule."""
    import numpy as np

    from tpurt_torch.config import RenderConfig
    from tpurt_torch.render import renderer as R
    from tpurt_torch.render.renderer import render_frame, render_image
    from tpurt_torch.scene.presets import (bench_scene, cornell_sphere_scene,
                                           grid_scene)

    saved = {k: getattr(R, k) for k in (*STAGED_SMALL, "_STAGE_WIDTHS_OVERRIDE")}
    try:
        for k, v in STAGED_SMALL.items():
            setattr(R, k, v)
        small = RenderConfig(width=64, height=32, rays_per_pixel=8,
                             max_bounces=5, rays_per_batch=256,
                             pixels_per_lane=8, compaction_threshold=128)
        scene, cam, _ = cornell_sphere_scene(2, small, device="cuda")
        steps = staged_pair("staged respread", scene, cam,
                            small.replace(mega_cascade=False))
        if not any("respread" in s for s in steps):
            raise AssertionError("staged respread: no respread step")
        steps = staged_pair("staged cascade (and its replay)", scene, cam,
                            small, replay=True)
        if not any("cascade" in s for s in steps):
            raise AssertionError("staged cascade: no cascade step")
        staged_pair("staged P=1", scene, cam,
                    small.replace(pixels_per_lane=1, rays_per_batch=2048))
        if plan_of()[-1][1][-1] != ("uncapped",):
            raise AssertionError(f"staged P=1: the plan {plan_of()} does not "
                                 "end uncapped")
        # Quota lanes compacted below their stride: the ladder overridden
        # to 64 then 16 lanes of the 256, the respread off (4 spp, 3
        # bounces: the plain version's 16-lane tail is long).
        R._STAGE_WIDTHS_OVERRIDE = [64, 16]
        staged_pair("staged compaction to 64 and 16 lanes", scene, cam,
                    small.replace(mega_tail_respread=False, rays_per_pixel=4,
                                  max_bounces=3))
        if not {("compact", 64), ("compact", 16)} <= set(plan_of()[0][1]):
            raise AssertionError(f"staged compaction: the plan {plan_of()} "
                                 "does not compact to 64 and 16 lanes")
        R._STAGE_WIDTHS_OVERRIDE = None
        tcfg = small.replace(mega_dense=True, mega_cascade=False)
        tscene, tcam = bench_scene("teapot", tcfg, device="cuda")
        reset_counts()
        staged_pair("staged respread, teapot dense", tscene, tcam, tcfg)
        if counts()["dense"] < 1:
            raise AssertionError(f"teapot dense: no dense launch ({counts()})")
        gscene = grid_scene(12, device="cuda")
        gcam = grid_camera(64, 32)
        if not gscene.mega_tlas:
            raise AssertionError("the K = 12 grid is not in the TLAS regime")
        staged_pair("staged respread, grid-12 TLAS", gscene, gcam,
                    small.replace(mega_cascade=False))
    finally:
        for k, v in saved.items():
            setattr(R, k, v)
        clear_plans()

    # bunny-1080p-bvh: tpurt's staged knobs (bench.py:484, :674-680).
    t_full = time.time()
    cfg = ladder_cfg(1920, 1080, rays_per_pixel=8, max_bounces=4,
                     compaction_threshold=32768)
    cam = camera_for(cfg)
    b = R._flat_batch_size(cfg)
    frames = {}
    launches = {}
    for label in ("blocking", "replayed"):
        reset_counts()
        stats = {}
        frames[label] = render_frame(bunny, cam, cfg, stats=stats)
        launches[label] = counts()
        frames[label + "_segs"] = stats["segments"]
        if launches[label]["megakernel"] < 2:
            raise AssertionError(f"bunny-1080p-bvh {label}: B1 launches "
                                 f"{launches[label]}")
        if label == "blocking":
            plan = plan_of()
            if R._SPEC_STATS != {"replayed": 0, "fallback": 0}:
                raise AssertionError(f"blocking frame replayed: {R._SPEC_STATS}")
    if R._SPEC_STATS["replayed"] < 1 or R._SPEC_STATS["fallback"]:
        raise AssertionError(f"bunny-1080p-bvh replay: {R._SPEC_STATS}")
    spec = dict(R._SPEC_STATS)
    pstats = {}
    plain = render_frame(bunny, cam, cfg.replace(compaction_threshold=0),
                         stats=pstats)
    for label in ("blocking", "replayed"):
        if not np.array_equal(frames[label], plain):
            raise AssertionError(f"bunny-1080p-bvh {label}: "
                                 f"{int((frames[label] != plain).any(-1).sum())} "
                                 "pixels differ from the plain schedule")
        ratio = frames[label + "_segs"] / pstats["segments"]
        if not 1.0 <= ratio <= 1.5:
            raise AssertionError(f"bunny-1080p-bvh {label}: segments "
                                 f"{frames[label + '_segs']} against plain "
                                 f"{pstats['segments']}")
    log(f"bunny-1080p-bvh: plan {plan}; B1 launches a frame blocking "
        f"{launches['blocking']}, replayed {launches['replayed']} ({spec}); "
        f"both frames equal the plain schedule's bit for bit; segments "
        f"{frames['blocking_segs']} / {frames['replayed_segs']} against plain "
        f"{pstats['segments']} ({frames['blocking_segs'] / pstats['segments']:.4f}x)")
    stage_stats = []
    R.render_batch_flat(bunny, cam, cfg, 0, stage_stats=stage_stats)
    if plan_of() != plan:
        raise AssertionError(f"bunny-1080p-bvh: the plan moved: {plan_of()}")
    for st in stage_stats:
        log(f"  bunny-1080p-bvh step: {st}")
    # Frame times in turns, best of 3: blocking (speculation off), replayed,
    # the plain schedule.
    scheds = {"blocking": cfg.replace(mega_speculative=False),
              "replayed": cfg, "plain": cfg.replace(compaction_threshold=0)}
    ms = {k: [] for k in scheds}
    for _ in range(3):
        for k, c in scheds.items():
            ms[k].extend(cuda_ms(lambda: render_image(bunny, cam, c))[1])
    log(f"bunny-1080p-bvh frame ms (render_image, in turns): " + "; ".join(
        f"{k} {[round(t, 3) for t in v]} best {min(v):.3f}" for k, v in ms.items())
        + f" | {CARD}")
    # The host cost of a launch: a resume of the first stage's 262,144
    # lanes and a fresh start, each with a trip cap of 0.
    p = cfg.pixels_per_lane
    state, _ = R._mega_flat_start(bunny, cam, cfg, 0, 0, 0, R._first_cap(cfg, p), b)
    _o, resume_ms = cuda_ms(lambda: R._mega_stage_more(
        bunny, cam, cfg, state, 0, 0, 0, pixels_per_lane=p, pixel_stride=b), reps=3)
    _o, fresh_ms = cuda_ms(lambda: R._mega_flat_start(bunny, cam, cfg, 0, 0, 0, 0, b),
                           reps=3)
    log(f"bunny-1080p-bvh host cost of a launch with no trips: resume "
        f"{[round(t, 3) for t in resume_ms]} ms, fresh start "
        f"{[round(t, 3) for t in fresh_ms]} ms | {CARD}")
    # The plan's launches after the first stage: its respread tail, a
    # fresh P = 1 batch over the collected stragglers (the kernels line's
    # row; the first stage's first trips are phase 5's bunny batch).
    tail_w, pixpack = respread_tail(bunny, cam, cfg, plan)
    targs = dict(R._mega_statics(cfg, bunny), pixel_index=pixpack[:tail_w],
                 frame_index=0, sample_offset=0, camera=cam)
    del targs["body_backend"]
    targs["ro0"], targs["rd0"] = R._rays_of(cam, targs["pixel_index"],
                                            cfg.width, cfg.height)
    tt = time_trips(bunny, cam, cfg, 16, "bunny-1080p-bvh respread tail",
                    args=targs)
    b_ms, b_by = megakernel_bound(bunny, tt, tt["work_k"], tt["adv_k"],
                                  "respread tail, 16 trips")
    f_ms, _f_by = megakernel_bound(bunny, tt, tt["work"], tt["adv"],
                                   "respread tail, whole launch")
    # Later trips of the tail through both backends, 16 from the kernel's
    # own state at half and at the end of its run (the plain version's
    # whole tail, ~1,300 trips at ~130 ms each on the card, is too long).
    from tpurt_torch.render import mega_cuda
    from tpurt_torch.render.megakernel import run_megakernel

    total, errs = int(tt["trips"].max()), [tt["err"]]
    for at in (total // 2, total - 16):
        st = run_megakernel(bunny, body_backend="cuda", max_iterations=at,
                            return_state=True, **targs)
        k2, p2 = (run_megakernel(bunny, body_backend=be, initial_state=st,
                                 max_iterations=16, return_state=True, **targs)
                  for be in ("cuda", "plain"))
        agree, err = mega_cuda.compare_lanes(p2, k2)
        log(f"bunny-1080p-bvh respread tail, trips {at + 1}-{at + 16} from the "
            f"kernel's state: integer fields agree on {agree:.4%} of lanes, "
            f"float max abs err {err:.3g}")
        if agree < LANE_AGREE:
            raise AssertionError(f"respread tail trips {at + 1}-{at + 16}: lane "
                                 f"agreement {agree:.4%}")
        errs.append(err)
    log(f"bunny-1080p-bvh respread tail ({tail_w} lanes, P=1): whole launch "
        f"{tt['full_ms']:.3f} ms against its bound {f_ms:.3f} ms | {CARD}")
    # The uncapped alternative: B1 from the first stage's 262,144-lane
    # state (which the recorded plan does not run), for comparison only.
    pix0 = state.pix - state.pixno.long() * b
    args = dict(R.flat_batch_args(bunny, cam, cfg, 0), ro0=state.ro0,
                rd0=state.rd0, pixel_index=pix0, pixel_stride=b)
    time_trips(bunny, cam, cfg, 16, "bunny-1080p-bvh uncapped alternative "
               "(first stage's state resumed)", args=args, state=state)
    log(f"bunny-1080p-bvh full-width part: {time.time() - t_full:.1f} s")
    return dict(name="b1_staged: megakernel (B1), the staged bunny-1080p-bvh "
                "frame's respread tail (P=1; launches: the frame's B1 launches)",
                route="cuda", source="tpurt_torch/csrc/megakernel.cu",
                replaces="tpurt/render/mega_pallas.py:237",
                launches=launches["replayed"]["megakernel"],
                max_abs_err=max(errs), ms=tt["ms"],
                plain_ms=tt["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def respread_tail(scene, cam, cfg, plan):
    """The inputs of a recorded flat plan's respread tail: (tail width,
    packed pixel list), from the first stage on through the plan's
    stages and compactions, as the blocking driver collects them."""
    from tpurt_torch.render import renderer as R

    p = cfg.pixels_per_lane
    b = R._flat_batch_size(cfg)
    steps = dict(plan)[0]
    state, _ = R._mega_flat_start(scene, cam, cfg, 0, 0, 0, R._first_cap(cfg, p), b)
    for step in steps:
        if step[0] == "stage":
            state, _ = R._mega_stage_more(scene, cam, cfg, state, 0, 0, step[1],
                                          pixels_per_lane=p, pixel_stride=b)
        elif step[0] == "compact":
            state, _ = R._mega_compact(state, step[1])
        elif step[0] == "respread":
            pixpack, _pos, _n = R._collect_tail_pixels(
                state, 0, p, b, cfg.width * cfg.height,
                R._respread_lanes_for(cfg, p, b))
            return min(step[1], pixpack.shape[0]), pixpack
    raise AssertionError(f"the plan {steps} has no respread tail")


def phase24(bunny):
    import tempfile

    import numpy as np
    import torch

    from tpurt_torch.accel import bvh_stats, validate_bvh
    from tpurt_torch.core import rng, vecmath as vm
    from tpurt_torch.render.tonemap import to_rgba
    from tpurt_torch.scene import SceneBuilder
    from tpurt_torch.scene.obj import load_obj, write_obj
    from tpurt_torch.scene.presets import BUNNY_OBJ
    from tpurt_torch.scene.procedural import torus_knot

    assert bunny.device.type == "cuda"
    n = 1 << 16
    r = np.random.default_rng(24)
    a, b, hsv = (r.standard_normal((n, 3)).astype(np.float32) for _ in range(3))
    d = a / np.linalg.norm(a, axis=-1, keepdims=True)
    nrm = b / np.linalg.norm(b, axis=-1, keepdims=True)
    nrm = np.where((np.sum(d * nrm, -1) > 0)[:, None], -nrm, nrm)
    nrm[:256] = (0.0, 0.0, 1.0)  # the hemisphere's other up vector
    cpu = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in dict(
        a=a, b=b, d=d.astype(np.float32), n=nrm.astype(np.float32),
        t=r.random(n, dtype=np.float32),
        ia=r.uniform(1.0, 2.0, n).astype(np.float32),
        ib=r.uniform(1.0, 2.0, n).astype(np.float32),
        h=hsv[:, 0] * np.float32(300.0), s=np.abs(hsv[:, 1]) - np.float32(0.2),
        v=np.abs(hsv[:, 2]), u8=r.integers(0, 256, (n, 3), dtype=np.uint8),
        seed=r.integers(0, 2 ** 32, n, dtype=np.int64),
        mask=np.arange(n) % 3 == 0).items()}
    gpu = {k: v.cuda() for k, v in cpu.items()}
    m = vm.euler_rotation(0.3, -1.2, 2.0)
    exact = {
        "cross3": lambda x: vm.cross3(x["a"], x["b"]),
        "length3": lambda x: vm.length3(x["a"]),
        "lerp3": lambda x: vm.lerp3(x["a"], x["b"], x["t"]),
        "reflect": lambda x: vm.reflect(x["d"], x["n"]),
        "refract": lambda x: vm.refract(x["d"], x["n"], x["ia"], x["ib"]),
        "fresnel_reflectance": lambda x: vm.fresnel_reflectance(
            x["d"], x["n"], x["ia"], x["ib"]),
        "rotate": lambda x: vm.rotate(m, x["a"]),
        "hsv2rgb": lambda x: vm.hsv2rgb(x["h"], x["s"], x["v"]),
        "to_rgba": lambda x: to_rgba(x["u8"]),
    }
    for name, fn in exact.items():
        want, got = fn(cpu), fn(gpu)
        if got.device.type != "cuda" or not torch.equal(got.cpu(), want):
            raise AssertionError(f"{name}: the card's result is not the CPU's")
    draws = {
        "random_hemisphere_direction": lambda x: rng.random_hemisphere_direction(
            x["n"], x["seed"]),
        "sample_hemisphere_cosine": lambda x: rng.sample_hemisphere_cosine(
            x["n"], x["seed"]),
        "random_direction_masked": lambda x: rng.random_direction_masked(
            x["seed"], x["mask"]),
    }
    errs = {}
    for name, fn in draws.items():
        (s_cpu, d_cpu), (s_gpu, d_gpu) = fn(cpu), fn(gpu)
        errs[name] = float((d_gpu.cpu() - d_cpu).abs().max()) / 2.0 ** -23
        if not torch.equal(s_gpu.cpu(), s_cpu) or errs[name] > 4:
            raise AssertionError(f"{name}: states differ or directions "
                                 f"{errs[name]:.2f} ulp apart")
    keep = ~cpu["mask"]
    if not torch.equal(draws["random_direction_masked"](gpu)[0].cpu()[keep],
                       cpu["seed"][keep]):
        raise AssertionError("random_direction_masked moved a masked lane")
    log(f"helpers: {len(exact)} bit for bit on {n} rows; directions "
        + ", ".join(f"{k} {v:.2f}" for k, v in errs.items())
        + " ulp at unit scale apart, states equal")

    # A fresh builder, as bench_scene("bunny") builds it up to the freeze:
    # its BVH and node count against phase 4's scene, frozen on the card.
    t0 = time.time()
    builder = SceneBuilder()
    mesh = builder.load_obj(BUNNY_OBJ)
    mesh.scale = 0.5
    builder.add_cornell_box(mesh)
    builder.add_mesh(mesh)
    tris = torch.stack([bunny.tri_pos_a, bunny.tri_pos_b, bunny.tri_pos_c],
                       1).cpu().numpy()
    validate_bvh(builder.nodes, mesh.node_idx, mesh.first_tri, mesh.num_tris,
                 tris)
    stats = builder.stats(mesh)
    if stats != bvh_stats(builder.nodes, mesh.node_idx) or (
            bunny.num_nodes != len(builder.nodes)):
        raise AssertionError(f"bunny BVH: stats {stats}, {bunny.num_nodes} "
                             f"nodes against {len(builder.nodes)}")
    log(f"bunny BVH: {mesh.num_tris} triangles, {bunny.num_nodes} scene nodes, "
        f"{stats}; valid over the frozen scene's triangles; built and checked "
        f"in {time.time() - t0:.1f} s")

    pos, nrm_k = torus_knot(segments=64, sides=8)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "knot.obj")
        write_obj(path, torch.from_numpy(pos).cuda(), torch.from_numpy(nrm_k).cuda())
        back = load_obj(path)
    if not (np.array_equal(back[0], pos) and np.array_equal(back[1], nrm_k)):
        raise AssertionError("write_obj -> load_obj: the knot did not round-trip")
    log(f"write_obj -> load_obj: {len(pos)} triangles round-trip bit for bit")


def kernel_device_ms(fn, match: str, reps: int = 5) -> list:
    """[ms] of each kernel whose name holds ``match`` that ``reps`` calls
    of ``fn`` launched: its own time on the device (torch.profiler), not
    the copies and allocations launched around it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if match in e.name and e.device_type == torch.autograd.DeviceType.CUDA]
    if len(times) != reps:
        raise AssertionError(f"{match}: {len(times)} kernels traced for {reps} calls")
    return times


def fresh_lanes(label, scene, args, render):
    """The fresh-lanes kernel (``mega_cuda.fresh``) on one main path's
    launch: its buffer against ``pack`` of the plain backend's fresh
    lanes (``_initial_lane``) in every word, one FRESH_LAUNCHES and
    no megakernel launch for the call; its time with the host around it
    (``ms``) and the kernel alone on the device (``device_ms``, traced)
    against ``_initial_lane`` and ``pack`` (``plain_ms``); its bound, the
    buffer written and the rays and pixels read once; and the fresh
    launches of one frame of the path (``render()``, counts reset just
    before)."""
    import torch

    from tpurt_torch.core import v3 as v3lib
    from tpurt_torch.render import mega_cuda
    from tpurt_torch.render import megakernel as mk

    lane, ctx = plain_start(scene, args)
    want = mega_cuda.pack(lane)
    ro0, rd0 = v3lib.from_rows(args["ro0"]), v3lib.from_rows(args["rd0"])
    pix = args["pixel_index"]
    reset_counts()
    got = mega_cuda.fresh(ctx, ro0, rd0, pix)
    launched = counts()
    if [launched[k] for k in ("fresh", "megakernel", "dense", "jitter")] != [1, 0, 0, 0]:
        raise AssertionError(f"{label}: one fresh call launched {launched}")
    if got.shape != want.shape or not torch.equal(got, want):
        rows = (got != want).any(dim=1).nonzero().flatten().tolist()
        raise AssertionError(f"{label}: the fresh buffer differs from "
                             f"pack(_initial_lane(...)) in words {rows}")

    def plain():
        return mega_cuda.pack(mk._initial_lane(ctx, ro0, rd0, pix))

    mega_cuda.fresh(ctx, ro0, rd0, pix)  # warm-up
    _o, ms = cuda_ms(lambda: mega_cuda.fresh(ctx, ro0, rd0, pix), reps=5)
    dev_ms = kernel_device_ms(lambda: mega_cuda.fresh(ctx, ro0, rd0, pix),
                              "fresh_lanes", reps=5)
    again, plain_ms = cuda_ms(plain, reps=3)
    if not torch.equal(again, want):
        raise AssertionError(f"{label}: _initial_lane's buffer moved")
    r = want.shape[1]
    nbytes = want.numel() * 4 + r * (6 * 4 + pix.element_size())
    b_ms, b_by = bound(0, nbytes)
    reset_counts()
    render()
    per_frame = counts()
    if per_frame["fresh"] < 1:
        raise AssertionError(f"{label}: a frame launched no fresh_lanes kernel "
                             f"({per_frame})")
    log(f"fresh_lanes, {label}: {r} lanes x {want.shape[0]} words equal "
        f"pack(_initial_lane(...)) in every word; ms (host around it) "
        f"{[round(t, 4) for t in ms]}, device ms {[round(t, 4) for t in dev_ms]}, "
        f"plain (_initial_lane + pack) ms {[round(t, 3) for t in plain_ms]}; "
        f"bound {b_ms:.4f} ms ({nbytes} bytes); launches in a frame "
        f"{per_frame} | {CARD}")
    return dict(name=f"fresh_lanes: fresh lanes of B1's launch, {label}",
                route="cuda", source="tpurt_torch/csrc/megakernel.cu",
                replaces="tpurt/render/mega_pallas.py (its fresh lanes, XLA "
                "operations)", launches=per_frame["fresh"], max_abs_err=0.0,
                ms=min(ms), device_ms=min(dev_ms), plain_ms=min(plain_ms),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def phase25(bunny):
    """The fresh-lanes kernel at the main paths' shapes: bunny-1080p
    packed F = 2 (the stream's launch), teapot-720p through the dense
    instantiation, and the bunny-1080p-bvh still's first stage and
    respread tail."""
    from tpurt_torch.render import renderer as R
    from tpurt_torch.render.renderer import (
        flat_batch_args, render_batch_flat_frames, render_image)
    from tpurt_torch.scene.presets import bench_scene

    out = []
    cfg = bunny_cfg(1920, 1080).replace(mega_frames_per_batch=2)
    cam = camera_for(cfg)
    out.append(fresh_lanes(
        "bunny-1080p packed F=2", bunny, flat_batch_args(bunny, cam, cfg, 0, frames=2),
        lambda: render_batch_flat_frames(bunny, (cam, cam), cfg, 0)))
    tcfg = teapot_cfg(1280, 720)
    teapot, tcam = bench_scene("teapot", tcfg, device="cuda")
    out.append(fresh_lanes(
        "teapot-720p dense", teapot, flat_batch_args(teapot, tcam, tcfg, 0),
        lambda: render_image(teapot, tcam, tcfg)))
    scfg = ladder_cfg(1920, 1080, rays_per_pixel=8, max_bounces=4,
                      compaction_threshold=32768)
    scam = camera_for(scfg)
    clear_plans()
    render_image(bunny, scam, scfg)  # records the still's plan
    out.append(fresh_lanes(
        "bunny-1080p-bvh still, first stage", bunny,
        flat_batch_args(bunny, scam, scfg, 0), lambda: render_image(bunny, scam, scfg)))
    tail_w, pixpack = respread_tail(bunny, scam, scfg, plan_of())
    targs = dict(R._mega_statics(scfg, bunny), pixel_index=pixpack[:tail_w],
                 frame_index=0, sample_offset=0, camera=scam)
    del targs["body_backend"]
    targs["ro0"], targs["rd0"] = R._rays_of(scam, targs["pixel_index"],
                                            scfg.width, scfg.height)
    fresh_lanes("bunny-1080p-bvh still, respread tail", bunny, targs,
                lambda: render_image(bunny, scam, scfg))
    clear_plans()
    return out


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
    if sys.argv[1:2] == ["--b1-turns"] and len(sys.argv) == 3:
        log("card:", CARD)
        b1_turns_main(sys.argv[2])
        return
    if sys.argv[1:] == ["--tuned-vs-shipped"]:
        log("card:", CARD)
        tuned_vs_shipped_main()
        return
    if sys.argv[1:] == ["--b3-public"]:
        log("card:", CARD)
        b3_public_main()
        return
    def timed(fn, *args):
        t = time.time()
        out = fn(*args)
        log(f"{fn.__name__}: {time.time() - t:.1f} s")
        return out

    timed(phase1)
    timed(phase2)
    timed(phase3)
    bunny = timed(phase4)
    b1 = timed(phase5, bunny)
    b2 = timed(phase7, timed(phase6))
    timed(phase8)
    b3 = timed(phase10, timed(phase9))
    timed(phase11)
    b1_tlas = timed(phase12)
    timed(phase13, bunny)
    timed(phase14)
    b1_packed = timed(phase15, bunny, b1)
    b1_deep = timed(phase16)
    timed(phase17)
    b1_jitter = timed(phase18, bunny, b1)
    timed(phase19)
    timed(phase20)
    timed(phase21, bunny, b1)
    timed(phase22, bunny)
    b1_staged = timed(phase23, bunny)
    timed(phase24, bunny)
    fresh = timed(phase25, bunny)
    log(f"chip_smoke wall {time.time() - t0:.1f} s")
    log(smi())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # B3 and fresh_lanes also give their device time (``device_ms``)
    # beside ``ms``, which for every kernel is CUDA events around the call,
    # the host included.
    print(json.dumps({"kernels": [{k: b[k] for k in keys + ("device_ms",) if k in b}
                                  for b in (b1, b1_tlas, b1_packed, b1_deep,
                                            b1_jitter, b1_staged, b2, b3, *fresh)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
