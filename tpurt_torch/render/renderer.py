"""Frame renderer (port of tpurt/render/renderer.py): the megakernel's
flat batches and tiles, and the modular engine's tiles.

``engine="mega"`` (the default): a frame is sliced row-major into
ceil(W*H / (B * pixels_per_lane)) megakernel launches of B lanes, each
lane owning a quota of pixels at stride B; seeds and rays are pure
functions of the absolute pixel, so any decomposition gives the same
frame. A scene frozen into the TLAS regime (more instanced meshes than
config.MEGA_TLAS_THRESHOLD) or with bf16 node bounds renders through the
same path. ``mega_dense=True`` runs the brute-force megakernel; a TLAS
scene refuses it, as tpurt's does. ``sample_flatten`` renders
rays_per_pixel one-sample passes accumulated on the device in sample
order. With ``rays_per_batch=0``, with an accumulator, or with
``max_bounces <= 0`` the frame is swept in square tiles instead, each
tile one megakernel launch of one pixel a lane (tpurt's tile path: no
quota, one tail pass, no brute-force mode), bitwise equal to the flat
frame. ``render_batch_flat_frames`` packs several frames into one
launch (cross-frame packing); ``cross_frame_pack_ok`` says when a
config may.

``engine="modular"``: tiles of ``tile_size`` swept row-major, edge tiles
rendered at full shape and cropped; each tile intersects its primary
rays once (they are shared by every sample), then traces its samples
through the nested bounce loop (render/integrator.py). ``dense_engine``
picks its brute-force sweep ("pallas" is kernel B3 on the card).

``RenderConfig.mega_body`` (tpurt's knob) picks the megakernel backend:

  "auto"    the hand-written CUDA kernel for a scene on a CUDA device,
            the plain torch version for a CPU scene;
  "xla"     the plain torch version on any device — the parity anchor,
            as tpurt's XLA body is;
  "pallas"  the CUDA kernel; raises on a CPU scene.

The staged drivers (tpurt's, under its names): a flat batch of at least
``compaction_threshold`` lanes, or a megakernel tile of that many
pixels, with bounces on, runs in capped stages; between stages the host
reads the live lane count, compacts the survivors to a narrower width
(``_mega_compact``) and, in a quota batch, re-traces every incomplete
pixel as a P = 1 tail batch (respread, ``mega_tail_respread``) or as a
staged list-quota level (cascade, ``mega_cascade``). Each pixel's trace
is a pure function of the pixel, frame and sample, so every staged
schedule gives the plain schedule's frame bit for bit; re-traced
in-flight pixels add their partial segments again. The executed plan is
recorded per (scene, shape) in ``_SCHED_TRACES`` and a later batch with
the same key replays it without reading the live counts
(``mega_speculative``), its guards checked once at the end; a failed
guard falls back to the blocking path from the untouched entry state.

``mega_interleave`` and ``mega_schedule`` are bitwise no-ops by contract
and are ignored, as ``render_frame`` ignores ``mega_frames_per_batch``
(tpurt's does too; ``render_batch_flat_frames`` and ``anim`` read it).
``subpixel_jitter`` jitters the primary rays from an auxiliary stream, as
tpurt does: the megakernel recomputes each new sample's ray from the
lane's pixel (kernel B1 too); the modular engine jitters sample 0's ray
once and shares it in reference seed mode, and jitters every sample in
decorrelated mode. The modular engine walks ``scene.node_*`` and ignores
the TLAS (tpurt's tests/test_tlas.py holds the two engines equal on a
TLAS scene).

A transient device error (``torch.AcceleratorError``, ``OSError``)
retries a batch or tile up to ``retries`` times; any other error
propagates at once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpurt_torch.config import RenderConfig
from tpurt_torch.core import rng as rnglib
from tpurt_torch.core import v3 as v3lib
from tpurt_torch.core.camera import Camera, jittered_uv, make_ray, pixel_uv
from tpurt_torch.core.v3 import V3
from tpurt_torch.render.integrator import trace_paths
from tpurt_torch.render.intersect import intersect_scene
from tpurt_torch.render.megakernel import run_megakernel
from tpurt_torch.render.tonemap import tonemap
from tpurt_torch.scene.types import Scene
from tpurt_torch.utils.profiling import host_read, span


def body_backend(cfg: RenderConfig, scene: Scene) -> str:
    """mega_body -> "plain" or "cuda" for this scene's device."""
    on_cuda = scene.device.type == "cuda"
    if cfg.mega_body == "xla":
        return "plain"
    if cfg.mega_body == "pallas" and not on_cuda:
        raise ValueError(
            "mega_body='pallas' runs the CUDA kernel and needs a scene on a "
            "CUDA device; use 'auto' or 'xla' for a CPU scene")
    return "cuda" if on_cuda else "plain"


#: Errors worth retrying a batch or tile for: device- or transport-level
#: failures. Deterministic bugs propagate at once.
_TRANSIENT_ERRORS = (getattr(torch, "AcceleratorError", OSError), OSError)


def _retrying(fn, retries: int):
    """fn() again after a transient device error, at most ``retries``
    more times."""
    attempt = 0
    while True:
        try:
            return fn()
        except _TRANSIENT_ERRORS:
            attempt += 1
            if attempt > retries:
                raise


# ---------------------------------------------------------------------------
# The megakernel's flat batches
# ---------------------------------------------------------------------------


def _flat_batch_size(cfg: RenderConfig) -> int:
    """Lanes per flat batch: rays_per_batch, clamped so small frames do
    not pad to a huge batch (tpurt's rule, multiples of 256 lanes)."""
    total = cfg.width * cfg.height
    b = min(cfg.rays_per_batch, -(-total // 256) * 256)
    if b * cfg.pixels_per_lane > 2 * total:
        b = -(-total // (256 * cfg.pixels_per_lane)) * 256
    return b


def _flat_coords(start: int, batch: int, width: int, height: int, device):
    """Pixel coords of lanes [start, start+batch); lanes past the frame
    end repeat the last pixel (their output is discarded)."""
    pix = torch.arange(batch, dtype=torch.int64, device=device) + start
    pix = torch.clamp_max(pix, width * height - 1)
    return pix % width, pix // width, pix


def flat_batch_args(scene: Scene, camera: Camera, cfg: RenderConfig,
                    start: int, frame_index: int = 0, sample_offset: int = 0,
                    frames: int = 1, cameras=None,
                    batch: Optional[int] = None) -> dict:
    """run_megakernel's arguments for the flat batch at ``start`` (less
    the scene and the backend). ``frames`` > 1 is the packed form: the
    lanes' quota covers ``frames`` frames of pixels_per_lane slots each,
    ``camera`` gives the entry rays and ``cameras`` (one per frame, or
    None for ``camera`` in every frame) the slots' directions. ``batch``
    lanes (default: the frame's, ``_flat_batch_size``)."""
    b = batch or _flat_batch_size(cfg)
    xs, ys, pix = _flat_coords(start, b, cfg.width, cfg.height, scene.device)
    ro0, rd0 = make_ray(camera, pixel_uv(xs, ys, cfg.width, cfg.height))
    return dict(
        ro0=ro0, rd0=rd0, pixel_index=pix, frame_index=frame_index,
        rays_per_pixel=cfg.rays_per_pixel, max_bounces=cfg.max_bounces,
        seed_mode=cfg.seed_mode, invisible_budget=cfg.invisible_budget,
        sample_offset=sample_offset, camera=camera,
        width=cfg.width, height=cfg.height,
        pixels_per_lane=cfg.pixels_per_lane * frames,
        tail_passes=cfg.mega_tail_passes, dense=cfg.mega_dense,
        frames_per_batch=frames, cameras=cameras,
        subpixel_jitter=cfg.subpixel_jitter,
    )


def list_batch_args(scene: Scene, camera: Camera, cfg: RenderConfig,
                    pixel_list, lanes: Optional[int] = None,
                    frame_index: int = 0, sample_offset: int = 0) -> dict:
    """run_megakernel's arguments for one list-quota launch (tpurt's
    ``pixel_list`` mode, P = pixels_per_lane > 1): ``lanes`` lanes
    (default ceil(N / P)) at stride ``lanes``, lane i's slot k rendering
    pixel_list[min(i + k*lanes, N-1)], so radiance row j < N is
    pixel_list[j]."""
    plist = torch.as_tensor(pixel_list, device=scene.device).to(torch.int64)
    n = plist.shape[0]
    r = lanes or -(-n // cfg.pixels_per_lane)
    pix0 = plist[torch.clamp_max(torch.arange(r, device=scene.device), n - 1)]
    args = flat_batch_args(scene, camera, cfg, 0, frame_index, sample_offset)
    ro0, rd0 = _rays_of(camera, pix0, cfg.width, cfg.height)
    args.update(ro0=ro0, rd0=rd0, pixel_index=pix0, pixel_stride=r,
                pixel_list=plist)
    return args


def _staged(cfg: RenderConfig, lanes: int) -> bool:
    """Whether a launch of ``lanes`` lanes (a flat batch, or a tile's
    pixels) takes tpurt's staged driver."""
    return (bool(cfg.compaction_threshold) and lanes >= cfg.compaction_threshold
            and cfg.max_bounces > 0)


def render_batch_flat(scene: Scene, camera: Camera, cfg: RenderConfig,
                      start: int, frame_index: int = 0, sample_offset: int = 0,
                      batch: Optional[int] = None, stage_stats=None):
    """Mean radiance of one flat batch: pixels [start, start + B*P) in
    row-major order, padded past the frame end, with B = ``batch`` lanes
    (default: the frame's batch). Returns ((B*P, 3) radiance on the
    scene's device, exact segment count, loop trips). A batch of at least
    ``compaction_threshold`` lanes runs through the staged driver and
    returns None for its trips, as tpurt's does; ``stage_stats`` (a list)
    then receives its per-stage telemetry (``_mega_finish_staged``)."""
    b = batch or _flat_batch_size(cfg)
    with span("tpurt.batch", frame=frame_index, start=start, frames=1):
        if _staged(cfg, b):
            p = cfg.pixels_per_lane
            state, active = _mega_flat_start(scene, camera, cfg, start,
                                             frame_index, sample_offset,
                                             _first_cap(cfg, p), b)
            mean, segs = _mega_finish_staged(
                scene, camera, cfg, state, active, frame_index, sample_offset,
                b, pixels_per_lane=p, stage_stats=stage_stats, start=start)
            return mean, host_read(segs, "segments", int), None
        args = flat_batch_args(scene, camera, cfg, start, frame_index,
                               sample_offset, batch=b)
        return run_megakernel(scene, body_backend=body_backend(cfg, scene),
                              **args)


def _mega_flat_multi(scene: Scene, cameras, cfg: RenderConfig, start: int,
                     frame_index: int, sample_offset: int, frames: int):
    """One cross-frame packed launch: ``frames`` frames of the batch at
    ``start``. A 1-tuple of cameras marks an all-identical pack, whose
    slots share one frame's direction table."""
    args = flat_batch_args(
        scene, cameras[0], cfg, start, frame_index, sample_offset,
        frames=frames, cameras=None if len(cameras) == 1 else tuple(cameras))
    return run_megakernel(scene, body_backend=body_backend(cfg, scene), **args)


def cross_frame_pack_ok(cfg: RenderConfig) -> bool:
    """Single source of truth for cross-frame packing eligibility
    (anim's video packs, render_batch_flat_frames' refusal, and the
    packed rows of ``tpurt_torch.bench.time_render_flat``): packing runs
    the PLAIN flat megakernel schedule with in-lane samples only — no
    per-sample jitter, no staged/compaction schedule engaging at this
    batch size, and a live bounce loop."""
    return (
        cfg.max_bounces > 0
        and not cfg.subpixel_jitter
        and not (cfg.sample_flatten and cfg.rays_per_pixel > 1)
        and not _staged(cfg, _flat_batch_size(cfg))
    )


def render_batch_flat_frames(scene: Scene, cameras, cfg: RenderConfig,
                             start: int, frame_index: int = 0,
                             sample_offset: int = 0):
    """Cross-frame packed flat batch: len(cameras) FRAMES of pixels
    [start, start + B*pixels_per_lane) in ONE launch, frame f under
    cameras[f] with frame index frame_index+f. Returns ((F*P*B, 3)
    radiance, segments summed over the frames, trips) where frame f's
    rows are [f*P*B, (f+1)*P*B), each bitwise what render_batch_flat
    gives for that frame alone. The cameras must share a position; an
    all-identical tuple (the same object) collapses to one camera, whose
    slots share one frame's direction table. F = 1 is render_batch_flat."""
    f = len(cameras)
    if f < 1:
        raise ValueError("render_batch_flat_frames needs at least one camera")
    if f == 1:
        return render_batch_flat(scene, cameras[0], cfg, start, frame_index,
                                 sample_offset)
    if not (cfg.max_bounces <= 0 or cross_frame_pack_ok(cfg)):
        raise ValueError("cross-frame packing runs the plain flat schedule "
                         "only (see cross_frame_pack_ok)")
    cams = tuple(cameras)
    if all(c is cams[0] for c in cams[1:]):
        cams = (cams[0],)
    with span("tpurt.batch", frame=frame_index, start=start, frames=f):
        return _mega_flat_multi(scene, cams, cfg, start, frame_index,
                                sample_offset, f)


def _render_frame_flat(scene: Scene, camera: Camera, cfg: RenderConfig,
                       frame_index: int, progress, retries: int = 1,
                       as_u8: bool = False, stats: Optional[dict] = None,
                       passes: int = 1) -> np.ndarray:
    """The frame in row-major flat batches. ``passes`` > 1 is
    sample_flatten: that many one-sample passes of each batch (pass g at
    sample_offset g), summed on the device in sample order and then
    divided — bitwise the in-lane sample loop in decorrelated mode, since
    each sample's path is a pure function of (pixel, frame, sample) and
    the f32 adds run in the same order."""
    if passes > 1:
        cfg = cfg.replace(rays_per_pixel=1)
    total = cfg.width * cfg.height
    b = _flat_batch_size(cfg) * cfg.pixels_per_lane  # pixels per launch
    n_batches = -(-total // b)
    out = np.zeros((total, 3), np.uint8 if as_u8 else np.float32)
    total_segs = 0
    trips = 0
    for i in range(n_batches):
        start = i * b
        acc = None
        for g in range(passes):
            mean, segs, iters = _retrying(lambda: render_batch_flat(
                scene, camera, cfg, start, frame_index, sample_offset=g),
                retries)
            total_segs += segs
            if iters is not None:  # a staged batch reports no trips
                trips += iters
            acc = mean if acc is None else acc + mean
        if passes > 1:
            acc = rnglib.divide(acc, passes)
        if as_u8:
            acc = tonemap(acc)  # on the device: only uint8 comes back
        n = min(b, total - start)
        out[start:start + n] = host_read(acc[:n], "frame").numpy()
        if progress is not None:
            progress(i + 1, n_batches)
    if stats is not None:
        stats["segments"] = total_segs
        stats["trips"] = trips
    return out.reshape(cfg.height, cfg.width, 3)


# ---------------------------------------------------------------------------
# The staged drivers (tpurt/render/renderer.py:187-928)
#
# Lane states are never written in place: a stage runs from its input
# state into a fresh one (the kernel packs into a new buffer, the plain
# loop builds new tensors), compaction gathers and the fold scatters out
# of place, so a fold can still read the wider state it was carved from
# and a failed replay can restart from its entry state.
# ---------------------------------------------------------------------------

_MEGA_STAGE_ITERS = 384  # trips per capped stage before a host check

#: Widest tail batch the respread launches (and the alive-lane bound
#: under which it activates: active * P must fit).
_TAIL_RESPREAD_MAX = 65536

#: Cascade respread (quota batches): fire while up to this many
#: incomplete PIXELS remain and re-trace them as a full-occupancy quota
#: batch over the packed pixel list, each level's stragglers respreading
#: again, instead of waiting for the tail to fit one P = 1 batch.
_CASCADE_MAX = 524288
#: First-stage cap with the cascade on: the boundary must land while the
#: retirement curve is still mid-decay, so the cascade has work to
#: redistribute.
_CASCADE_STAGE0 = 288
#: Lane width of a cascade level.
_CASCADE_W = 65536
#: Recursion bound: below this many incomplete pixels, or past depth 2,
#: the tail runs as the plain P = 1 respread batch.
_CASCADE_MIN = 49152
#: Stage cap while waiting for the cascade to activate (a batch whose
#: first boundary landed before the crossing probes in short stages).
_CASCADE_PROBE = 96

#: Last observed retirement curve per (scene, shape): (cumulative trips,
#: live lanes) at each host check. Kept, with _stage_cap's arguments,
#: only for parity with tpurt (whose tests and tools read and reset it):
#: no schedule of either package reads it back.
_RETIRE_CURVES: dict = {}
#: Executed plan per (scene, shape, constants, cascade, depth): the steps
#: ("stage", cap), ("compact", width), ("respread", tail width),
#: ("cascade", lanes, quota) and ("uncapped",) of the last blocking run,
#: which a later batch with the same key replays (_mega_replay_staged).
_SCHED_TRACES: dict = {}
#: Staged batches that replayed a recorded plan, and replays whose guards
#: failed and fell back to the blocking path.
_SPEC_STATS = {"replayed": 0, "fallback": 0}
#: Override of the compaction-width ladder (absolute widths, widest
#: first), read at schedule time; None = _stage_widths' default.
_STAGE_WIDTHS_OVERRIDE = None


def _mega_statics(cfg: RenderConfig, scene: Scene) -> dict:
    """run_megakernel's knobs for every launch of a staged batch."""
    return dict(
        rays_per_pixel=cfg.rays_per_pixel, max_bounces=cfg.max_bounces,
        seed_mode=cfg.seed_mode, invisible_budget=cfg.invisible_budget,
        width=cfg.width, height=cfg.height,
        subpixel_jitter=cfg.subpixel_jitter,
        body_backend=body_backend(cfg, scene),
        tail_passes=cfg.mega_tail_passes, dense=cfg.mega_dense,
    )


def _active(state):
    """Live lanes of a lane state, as a tensor on its device (read on the
    host only where the blocking driver decides)."""
    return (~state.done).sum()


def _rays_of(camera: Camera, pix: torch.Tensor, width: int, height: int):
    """Primary rays of pixel ids, through the flat path's uv chain."""
    return make_ray(camera, pixel_uv(pix % width, pix // width, width, height))


def _mega_flat_start(scene, camera, cfg: RenderConfig, start: int,
                     frame_index: int, sample_offset: int, cap: int, batch: int):
    """The flat batch at ``start``, run for ``cap`` trips: (lane state,
    live lanes)."""
    args = flat_batch_args(scene, camera, cfg, start, frame_index,
                           sample_offset, batch=batch)
    state = run_megakernel(scene, body_backend=body_backend(cfg, scene),
                           max_iterations=cap, return_state=True, **args)
    return state, _active(state)


def _mega_stage_start(scene, camera, cfg: RenderConfig, x0: int, y0: int,
                      tile_h: int, tile_w: int, frame_index: int,
                      sample_offset: int, cap: int):
    """The tile's lanes (one pixel each), run for ``cap`` trips."""
    xs, ys = _tile_pixel_coords(tile_h, tile_w, x0, y0, scene.device)
    pix = (ys * cfg.width + xs) & 0xFFFFFFFF
    ro0, rd0 = make_ray(camera, pixel_uv(xs, ys, cfg.width, cfg.height))
    state = run_megakernel(
        scene, ro0, rd0, pix, frame_index, sample_offset=sample_offset,
        camera=camera, max_iterations=cap, return_state=True,
        **_mega_statics(cfg, scene))
    return state, _active(state)


def _mega_stage_more(scene, camera, cfg: RenderConfig, state, frame_index: int,
                     sample_offset: int, cap: int, uncapped: bool = False,
                     pixels_per_lane: int = 1, pixel_stride=None,
                     pixel_list=None):
    """Resume ``state`` for ``cap`` more trips (or to the end). Its lanes
    may be a compacted subset of a batch of ``pixel_stride`` lanes: the
    quota's slot tables are rebuilt from each lane's slot-0 pixel,
    ``pix - pixno * stride`` (a list quota: ``pixel_list[lane0]``)."""
    pix0 = state.pix
    if pixels_per_lane > 1:
        if pixel_list is not None:
            pix0 = pixel_list[torch.clamp(state.lane0.long(), 0,
                                          pixel_list.shape[0] - 1)]
        else:
            pix0 = state.pix - state.pixno.long() * pixel_stride
    out = run_megakernel(
        scene, state.ro0, state.rd0, pix0, frame_index,
        sample_offset=sample_offset, camera=camera, initial_state=state,
        max_iterations=None if uncapped else cap, return_state=True,
        pixels_per_lane=pixels_per_lane, pixel_stride=pixel_stride,
        pixel_list=pixel_list, **_mega_statics(cfg, scene))
    return out, _active(out)


def _lane_map(fn, x):
    """``fn`` on every tensor of a lane state (V3s and tuples recursed)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        vals = [_lane_map(fn, v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def _mega_compact(state, quarter: int):
    """Stable-sort the live lanes to the front and keep ``quarter`` lanes
    of every per-lane field: (the narrower state, the kept lanes'
    indices)."""
    order = torch.argsort(state.done.to(torch.uint8), stable=True)
    idx = order[:quarter]
    r = state.done.shape[0]
    small = _lane_map(
        lambda a: a[idx] if a.dim() >= 1 and a.shape[0] == r else a, state)
    return small, idx


def _mega_fold(big, small, idx):
    """Scatter a compacted state's results (radiance accumulators and
    segment counts) back into the wider state it was carved from, at
    rows ``idx``; its other fields are stale but never read again."""
    upd = lambda full, part: full.index_copy(0, idx, part)
    v3 = lambda full, part: V3(*map(upd, full, part))
    return big._replace(
        acc=v3(big.acc, small.acc),
        accs=tuple(v3(f, p) for f, p in zip(big.accs, small.accs)),
        segments=upd(big.segments, small.segments),
    )


def _mega_finalize(state, spp: int):
    """(mean radiance rows, segment count as an exact integer tensor) of
    a finished state, as ``megakernel.finish`` computes them."""
    accs = state.accs if state.accs else (state.acc,)
    mean = rnglib.divide(torch.cat([v3lib.to_rows(a) for a in accs]), spp)
    return mean, state.segments.sum()


def _collect_tail_pixels(state, start: int, p_count: int, stride: int,
                         wh: int, max_lanes: int, pixel_list=None):
    """Every incomplete pixel of a quota batch, packed valid-first.

    A lane owns quota pixels ``pix + (j - pixno) * stride`` for slots
    j = 0..P-1 (clamped to the frame's last pixel, as the quota advance
    clamps) or, in a list quota, ``pixel_list[lane0 + j * stride]``;
    slots >= pixno of a live lane are incomplete. The caller guarantees
    at most ``max_lanes`` live lanes. Returns (pixel ids, pad entries
    wh - 1; their positions in the batch's radiance rows, pad entries -1;
    the valid count as a tensor)."""
    order = torch.argsort(state.done.to(torch.uint8), stable=True)[:max_lanes]
    alive = ~state.done[order]
    pixno = state.pixno[order].long()[:, None]
    js = torch.arange(p_count, device=alive.device)[None, :]
    if pixel_list is not None:
        posc = state.lane0[order].long()[:, None] + js * stride
        cand = pixel_list[torch.clamp_max(posc, pixel_list.shape[0] - 1)]
    else:
        base = state.pix[order][:, None]
        cand = torch.clamp_max(base + (js - pixno) * stride, wh - 1)
        posc = cand - start
    valid = (alive[:, None] & (js >= pixno)).reshape(-1)
    pack = torch.argsort((~valid).to(torch.uint8), stable=True)
    vp = valid[pack]
    pix = torch.where(vp, cand.reshape(-1)[pack], wh - 1)
    pos = torch.where(vp, posc.reshape(-1)[pack], -1)
    return pix, pos, valid.sum()


def _mega_tail_full(scene, camera, cfg: RenderConfig, pixpack, frame_index: int,
                    sample_offset: int, tail_w: int):
    """Respread tail: ``pixpack[:tail_w]`` as a fresh P = 1 batch, to the
    end. An in-flight pixel re-traced from sample 0 gets the radiance the
    quota batch would have given it."""
    pix = pixpack[:tail_w]
    ro0, rd0 = _rays_of(camera, pix, cfg.width, cfg.height)
    mean, segs, _iters = run_megakernel(
        scene, ro0, rd0, pix, frame_index, sample_offset=sample_offset,
        camera=camera, **_mega_statics(cfg, scene))
    return mean, segs


def _tail_overwrite(mean, tail_mean, pospack, n_valid):
    """Scatter the tail's radiance over the batch mean at the collected
    POSITIONS. Pad entries (-1), entries past the valid count and
    positions outside the batch drop (into a spare row); duplicate
    frame-end pixels write equal values."""
    limit = mean.shape[0]
    tw = tail_mean.shape[0]
    idx = pospack[:tw]
    j = torch.arange(tw, device=idx.device)
    ok = (j < n_valid) & (idx >= 0) & (idx < limit)
    idx = torch.where(ok, idx, limit)
    spare = torch.cat([mean, mean.new_zeros((1, mean.shape[1]))])
    return spare.index_put((idx,), tail_mean)[:limit]


def _mega_pix_start(scene, camera, cfg: RenderConfig, pixpack, frame_index: int,
                    sample_offset: int, cap: int, w: int, p: int):
    """Start a staged list-quota batch over ``pixpack`` (w lanes x p
    slots; lane i owns pixpack[i + k*w]): a cascade level's
    _mega_flat_start."""
    pix = pixpack[:w]
    ro0, rd0 = _rays_of(camera, pix, cfg.width, cfg.height)
    state = run_megakernel(
        scene, ro0, rd0, pix, frame_index, sample_offset=sample_offset,
        camera=camera, max_iterations=cap, return_state=True,
        pixels_per_lane=p, pixel_stride=w, pixel_list=pixpack,
        **_mega_statics(cfg, scene))
    return state, _active(state)


def _render_pixlist_staged(scene, camera, cfg: RenderConfig, pixpack, w: int,
                           p: int, frame_index: int, sample_offset: int,
                           depth: int, stage_stats=None):
    """One cascade level: pixpack[:w*p] as a staged quota batch (its own
    compaction ladder and respread recursion). Returns (mean (w*p, 3)
    radiance rows positionally matching pixpack, segments)."""
    need = w * p
    npix = pixpack.shape[0]
    if npix < need:
        pixpack = torch.cat([pixpack, torch.full(
            (need - npix,), cfg.width * cfg.height - 1, dtype=pixpack.dtype,
            device=pixpack.device)])
    elif npix > need:
        pixpack = pixpack[:need]  # drops only pad entries (need >= valid)
    state, active = _mega_pix_start(scene, camera, cfg, pixpack, frame_index,
                                    sample_offset, _MEGA_STAGE_ITERS, w, p)
    return _mega_finish_staged(
        scene, camera, cfg, state, active, frame_index, sample_offset, w,
        pixels_per_lane=p, stage_stats=stage_stats, pixel_list=pixpack,
        depth=depth)


def _curve_key(scene, cfg: RenderConfig, r: int, p: int):
    return (id(scene.mega_rows), r, p, cfg.rays_per_pixel, cfg.max_bounces,
            cfg.width, cfg.height, cfg.seed_mode)


def _stage_widths(r: int):
    """The compaction ladder: r/4, r/16, ... while at least 65,536 lanes,
    else one level of max(r/4, 1024)."""
    if _STAGE_WIDTHS_OVERRIDE is not None:
        return [w for w in _STAGE_WIDTHS_OVERRIDE if w < r] or [r // 4]
    widths = []
    w = r // 4
    while w >= 65536:
        widths.append(w)
        w //= 4
    return widths or [max(r // 4, 1024)]


def _stage_cap(prev_curve, iters_now: int, target_active: int) -> int:
    """Trips before the next host check: the fixed grid. The arguments
    are ignored; they stay for parity with tpurt, which measured a cap
    predicted from the previous curve slower on its card and kept the
    fixed grid too."""
    return _MEGA_STAGE_ITERS


def _respread_lanes_for(cfg: RenderConfig, p: int, r: int) -> int:
    """Live-lane bound under which the respread or cascade fires (and the
    collect capacity): survivors' pixels fit one _TAIL_RESPREAD_MAX batch,
    or with the cascade up to _CASCADE_MAX pixels remain, never before
    the batch has drained to a quarter of its lanes."""
    if p <= 1 or not cfg.mega_tail_respread:
        return 0
    cap = _CASCADE_MAX if cfg.mega_cascade else _TAIL_RESPREAD_MAX
    return min(cap // p, max(r // 4, 1024))


def _first_cap(cfg: RenderConfig, p: int) -> int:
    """Trip cap of a batch's first stage: with the cascade, mid-decay of
    the retirement curve, which scales with the lane's work (P x spp),
    relative to _CASCADE_STAGE0; otherwise _MEGA_STAGE_ITERS."""
    if cfg.mega_cascade and p > 1 and cfg.mega_tail_respread:
        work = p * cfg.rays_per_pixel
        if work <= 32:
            cap = max(1, _CASCADE_STAGE0 // 3)
        elif work < 128:
            cap = _CASCADE_STAGE0
        else:
            cap = (_CASCADE_STAGE0 * 4) // 3
        return min(cap, _MEGA_STAGE_ITERS)
    return _MEGA_STAGE_ITERS


def _assemble_staged(scene, camera, cfg: RenderConfig, state, folds, tail,
                     frame_index: int, sample_offset: int, stage_stats=None):
    """Shared epilogue of the staged drivers: unfold the compactions,
    build the mean, trace and scatter the tail, if any. ``tail`` is
    ("plain", pixpack, pospack, n_valid, tail_w), one P = 1 batch, or
    ("cascade", pixpack, pospack, n_valid, w, p, depth), a staged quota
    level over the packed pixel list."""
    with span("tpurt.stage", kind="assemble",
              width=(folds[0][0] if folds else state).done.shape[0]):
        for big, idx in reversed(folds):
            state = _mega_fold(big, state, idx)
        mean, segs = _mega_finalize(state, cfg.rays_per_pixel)
        if tail is None:
            return mean, segs
        if tail[0] == "cascade":
            _, pixpack, pospack, n_valid, w, p, depth = tail
            tmean, tsegs = _render_pixlist_staged(
                scene, camera, cfg, pixpack, w, p, frame_index, sample_offset,
                depth + 1, stage_stats=stage_stats)
            label = dict(cascade_done=w * p)
        else:
            _, pixpack, pospack, n_valid, tail_w = tail
            tmean, tsegs = _mega_tail_full(scene, camera, cfg, pixpack,
                                           frame_index, sample_offset, tail_w)
            label = dict(respread_done=tail_w)
        mean = _tail_overwrite(mean, tmean, pospack, n_valid)
        if stage_stats is not None:
            stage_stats.append(label)
        return mean, segs + tsegs


def _mega_replay_staged(scene, camera, cfg: RenderConfig, state, active,
                        frame_index: int, sample_offset: int, r: int,
                        pixels_per_lane: int, start: int, plan,
                        pixel_list=None, depth: int = 0):
    """Replay a recorded plan without reading live counts on the host,
    then check its guards once: (mean, segments), or None if a guard
    failed (the caller re-runs the blocking path from its entry state).

    The guarded steps are those that would drop work had the retirement
    curve moved: a compaction to width w needs active <= w, a collect
    needs active <= its lane bound and valid pixels <= the tail's slots.
    A stage on a drained batch does nothing, so stages need no guard. On
    the card every launch still waits for its trip count
    (``mega_cuda.run``); the replay saves the live-count reads only."""
    quota = {}
    if pixels_per_lane > 1:
        quota = dict(pixels_per_lane=pixels_per_lane, pixel_stride=r,
                     pixel_list=pixel_list)
    respread_lanes = _respread_lanes_for(cfg, pixels_per_lane, r)
    guards, folds = [], []
    tail = None

    def collect():
        return _collect_tail_pixels(state, start, pixels_per_lane, r,
                                    cfg.width * cfg.height, respread_lanes,
                                    pixel_list=pixel_list)

    with span("tpurt.stage", kind="replay", width=r):
        for step in plan:
            kind = step[0]
            if kind in ("respread", "cascade") and not respread_lanes:
                return None  # the config changed since the plan
            with span("tpurt.stage", kind=kind,
                      width=step[1] if kind == "compact" else state.done.shape[0],
                      cap=step[1] if kind == "stage" else None):
                if kind == "stage":
                    state, active = _mega_stage_more(
                        scene, camera, cfg, state, frame_index, sample_offset,
                        step[1], **quota)
                elif kind == "compact":
                    guards.append(active <= step[1])
                    small, idx = _mega_compact(state, step[1])
                    folds.append((state, idx))
                    state = small
                elif kind in ("respread", "cascade"):
                    guards.append(active <= respread_lanes)
                    pixpack, pospack, n_valid = collect()
                    if kind == "respread":
                        tail_w = min(step[1], pixpack.shape[0])
                        guards.append(n_valid <= tail_w)
                        tail = ("plain", pixpack, pospack, n_valid, tail_w)
                    else:
                        w2, p2 = step[1], step[2]
                        guards.append(n_valid <= w2 * p2)
                        tail = ("cascade", pixpack, pospack, n_valid, w2, p2,
                                depth)
                else:  # "uncapped": always valid
                    state, active = _mega_stage_more(
                        scene, camera, cfg, state, frame_index, sample_offset,
                        0, uncapped=True, **quota)
        if not plan or plan[-1][0] not in ("respread", "cascade", "uncapped"):
            # The recorded run finished inside its capped stages; this one
            # must too, or lanes would be left untraced.
            guards.append(active == 0)
        mean, segs = _assemble_staged(scene, camera, cfg, state, folds, tail,
                                      frame_index, sample_offset)
        if guards and not host_read(torch.stack(guards).all(), "guards", bool):
            return None
        return mean, segs


def _mega_finish_staged(scene, camera, cfg: RenderConfig, state, active,
                        frame_index: int, sample_offset: int, r: int,
                        pixels_per_lane: int = 1, stage_stats=None,
                        start: int = 0, pixel_list=None, depth: int = 0):
    """The staged driver from a started batch of ``r`` lanes: capped
    stages at full width while most lanes retire, then compaction down
    the width ladder; in a quota batch, once the live lanes' remaining
    pixels fit a respread (or cascade) batch, every incomplete pixel is
    re-traced there and its radiance overwrites its slot; otherwise an
    uncapped stage finishes the survivors. Returns (mean (r*P, 3),
    segments).

    ``stage_stats`` (a list) receives a dict a step — {width, iters,
    active}; at a fold {fold_to, active, pixno_hist} (quota progress of
    the surviving lanes, read back on the host); at a respread or
    cascade {respread or cascade, incomplete, active}; at its end
    {respread_done or cascade_done}; an uncapped stage adds ``uncapped``
    — and disables the replay. Each step runs in a ``tpurt.stage`` span
    (utils/profiling.py), whose ids name its kind, width and cap."""
    quota = {}
    if pixels_per_lane > 1:
        quota = dict(pixels_per_lane=pixels_per_lane, pixel_stride=r,
                     pixel_list=pixel_list)
    widths = _stage_widths(r)
    key = _curve_key(scene, cfg, r, pixels_per_lane)
    prev = _RETIRE_CURVES.get(key)

    respread_lanes = _respread_lanes_for(cfg, pixels_per_lane, r)
    if respread_lanes and respread_lanes < widths[-1]:
        # A last ladder level that never compacts: capped stages at the
        # last width until the survivors fit a respread batch.
        widths = widths + [respread_lanes]

    plan_key = (key, _MEGA_STAGE_ITERS, _TAIL_RESPREAD_MAX, cfg.mega_cascade,
                depth)
    if stage_stats is None and cfg.mega_speculative:
        plan = _SCHED_TRACES.get(plan_key)
        if plan is not None:
            out = _mega_replay_staged(
                scene, camera, cfg, state, active, frame_index, sample_offset,
                r, pixels_per_lane, start, plan, pixel_list=pixel_list,
                depth=depth)
            if out is not None:
                _SPEC_STATS["replayed"] += 1
                return out
            # A guard failed: the blocking path from the untouched entry
            # state, which records the plan again.
            _SPEC_STATS["fallback"] += 1

    active = host_read(active, "active", int)
    iters_now = 0
    curve = [(iters_now, active)]
    plan = []
    folds = []  # (wider state, kept indices) per compaction, innermost last
    for wq in widths:
        while active > wq:
            if respread_lanes and active <= respread_lanes:
                break
            cap = (min(_CASCADE_PROBE, _MEGA_STAGE_ITERS)
                   if cfg.mega_cascade and respread_lanes
                   and pixels_per_lane > 1 and depth == 0
                   else _stage_cap(prev, iters_now, wq))
            with span("tpurt.stage", kind="stage", width=state.done.shape[0],
                      cap=cap):
                state, active = _mega_stage_more(scene, camera, cfg, state,
                                                 frame_index, sample_offset,
                                                 cap, **quota)
                active = host_read(active, "active", int)
            iters_now += cap
            curve.append((iters_now, active))
            plan.append(("stage", cap))
            if stage_stats is not None:
                stage_stats.append(dict(width=state.done.shape[0], iters=cap,
                                        active=active))
        if active == 0 or (respread_lanes and active <= respread_lanes):
            break
        with span("tpurt.stage", kind="compact", width=wq):
            small, idx = _mega_compact(state, wq)
        folds.append((state, idx))
        state = small
        plan.append(("compact", wq))
        if stage_stats is not None and pixels_per_lane > 1:
            alive = ~host_read(small.done, "stage_stats").numpy()
            pixno = host_read(small.pixno, "stage_stats").numpy()[alive]
            stage_stats.append(dict(
                fold_to=int(wq), active=int(alive.sum()),
                pixno_hist=np.bincount(pixno,
                                       minlength=pixels_per_lane).tolist()))
    tail = None
    if active > 0 and respread_lanes and active <= respread_lanes:
        with span("tpurt.stage", kind="respread",
                  width=state.done.shape[0]) as sp:
            pixpack, pospack, n_valid_dev = _collect_tail_pixels(
                state, start, pixels_per_lane, r, cfg.width * cfg.height,
                respread_lanes, pixel_list=pixel_list)
            n_valid = host_read(n_valid_dev, "n_valid", int)
            if cfg.mega_cascade and depth < 2 and n_valid > _CASCADE_MIN:
                # Too much for one P = 1 batch: a full-occupancy quota level
                # over the packed list, at most 8 pixels a lane (wider
                # instead, so that w2 * p2 covers every collected pixel).
                sp.ids["kind"] = "cascade"
                w2 = _CASCADE_W
                p2 = -(-n_valid // w2)
                if p2 > 8:
                    p2 = 8
                    w2 = -(-(-(-n_valid // 8)) // 128) * 128
                tail = ("cascade", pixpack, pospack, n_valid_dev, w2, p2, depth)
                plan.append(("cascade", w2, p2))
                if stage_stats is not None:
                    stage_stats.append(dict(cascade=w2 * p2,
                                            incomplete=n_valid, active=active))
            else:
                tail_w = 2048
                while tail_w < n_valid:
                    tail_w *= 2
                tail_w = min(tail_w, pixpack.shape[0])
                tail = ("plain", pixpack, pospack, n_valid_dev, tail_w)
                plan.append(("respread", tail_w))
                if stage_stats is not None:
                    stage_stats.append(dict(respread=tail_w,
                                            incomplete=n_valid, active=active))
    elif active > 0:
        with span("tpurt.stage", kind="uncapped", width=state.done.shape[0]):
            state, _ = _mega_stage_more(scene, camera, cfg, state, frame_index,
                                        sample_offset, 0, uncapped=True,
                                        **quota)
        plan.append(("uncapped",))
        if stage_stats is not None:
            stage_stats.append(dict(width=state.done.shape[0],
                                    iters=state.iters, active=0,
                                    uncapped=True))
    _RETIRE_CURVES[key] = curve
    _SCHED_TRACES[plan_key] = plan
    return _assemble_staged(scene, camera, cfg, state, folds, tail,
                            frame_index, sample_offset, stage_stats=stage_stats)


def _render_tile_mega_staged(scene, camera, cfg: RenderConfig, x0: int, y0: int,
                             tile_h: int, tile_w: int, frame_index: int,
                             sample_offset: int = 0):
    """A megakernel tile through the staged driver: (radiance (tile_h,
    tile_w, 3), segments)."""
    r = tile_h * tile_w
    cap0 = _stage_cap(_RETIRE_CURVES.get(_curve_key(scene, cfg, r, 1)), 0,
                      _stage_widths(r)[0])
    state, active = _mega_stage_start(scene, camera, cfg, x0, y0, tile_h,
                                      tile_w, frame_index, sample_offset, cap0)
    mean, segs = _mega_finish_staged(scene, camera, cfg, state, active,
                                     frame_index, sample_offset, r)
    return mean.reshape(tile_h, tile_w, 3), int(segs)


# ---------------------------------------------------------------------------
# Tiles (the modular engine, and the megakernel's tile path)
# ---------------------------------------------------------------------------


def _tile_pixel_coords(tile_h: int, tile_w: int, x0: int, y0: int, device):
    """Absolute pixel coords of a tile, flattened row-major."""
    ys = torch.arange(tile_h, dtype=torch.int64, device=device) + y0
    xs = torch.arange(tile_w, dtype=torch.int64, device=device) + x0
    return (xs[None, :].expand(tile_h, tile_w).reshape(-1),
            ys[:, None].expand(tile_h, tile_w).reshape(-1))


def render_tile_with_stats(scene: Scene, camera: Camera, cfg: RenderConfig,
                           x0: int = 0, y0: int = 0,
                           tile_h: Optional[int] = None,
                           tile_w: Optional[int] = None, frame_index: int = 0,
                           sample_offset: int = 0):
    """(mean radiance (tile_h, tile_w, 3) f32 on the scene's device, exact
    path-segment count) of one tile (tpurt's _render_tile_impl). The
    megakernel renders the tile as one launch of one pixel a lane, with
    tpurt's tile arguments: no quota, one tail pass, the BVH walk (the
    knobs that change none of its bits; ``mega_dense`` too is left to
    the flat path, as tpurt leaves it). A tile of at least
    ``compaction_threshold`` pixels runs through the staged driver
    instead (``_render_tile_mega_staged``, with the config's tail passes
    and ``mega_dense``, as tpurt's)."""
    tile_h = tile_h or min(cfg.tile_size, cfg.height)
    tile_w = tile_w or min(cfg.tile_size, cfg.width)
    if cfg.engine == "mega" and _staged(cfg, tile_h * tile_w):
        return _render_tile_mega_staged(scene, camera, cfg, x0, y0, tile_h,
                                        tile_w, frame_index, sample_offset)
    xs, ys = _tile_pixel_coords(tile_h, tile_w, x0, y0, scene.device)
    pixel_index = (ys * cfg.width + xs) & 0xFFFFFFFF
    ro, rd = make_ray(camera, pixel_uv(xs, ys, cfg.width, cfg.height))
    if cfg.engine == "mega":
        mean, segs, _iters = run_megakernel(
            scene, ro, rd, pixel_index, frame_index,
            rays_per_pixel=cfg.rays_per_pixel, max_bounces=cfg.max_bounces,
            seed_mode=cfg.seed_mode, invisible_budget=cfg.invisible_budget,
            sample_offset=sample_offset, camera=camera, width=cfg.width,
            height=cfg.height, body_backend=body_backend(cfg, scene),
            subpixel_jitter=cfg.subpixel_jitter)
        return mean.reshape(tile_h, tile_w, 3), segs

    def camera_rays(sample):
        # Jitter from an auxiliary stream, sample ``sample``'s (a capability
        # the reference lacks: it reuses one ray for every sample,
        # Trace.cl:636-641).
        if not cfg.subpixel_jitter:
            return ro, rd
        return make_ray(camera, jittered_uv(xs, ys, pixel_index, frame_index,
                                            sample, cfg.width, cfg.height))

    def trace(state, rays, hit0):
        return trace_paths(
            scene, *rays, state, cfg.max_bounces, cfg.invisible_budget,
            cfg.bruteforce_threshold, first_hit=hit0,
            dense_engine=cfg.dense_engine)

    acc = torch.zeros((tile_h * tile_w, 3), dtype=torch.float32,
                      device=scene.device)
    segs = 0
    if cfg.seed_mode == "reference":
        # One ray and one continuous stream across the pixel's samples
        # (Trace.cl:632-642): sample 0's ray, whose first intersection
        # draws no random number, is intersected once and shared.
        rays = camera_rays(0)
        hit0 = intersect_scene(scene, *rays, cfg.bruteforce_threshold,
                               cfg.dense_engine)
        state = rnglib.make_seed(pixel_index, frame_index, 0)
        for _ in range(cfg.rays_per_pixel):
            light, state, segments = trace(state, rays, hit0)
            acc = acc + light
            segs += host_read(segments.sum(), "segments", int)
    else:
        # Decorrelated streams: MakeSeed(pixel, frame, sample). Without
        # jitter the camera ray is shared, so its first hit is too; with
        # it every sample has its own ray.
        hit0 = None if cfg.subpixel_jitter else intersect_scene(
            scene, ro, rd, cfg.bruteforce_threshold, cfg.dense_engine)
        for s in range(cfg.rays_per_pixel):
            sample = (s + sample_offset) & 0xFFFFFFFF
            state = rnglib.make_seed(pixel_index, frame_index, sample)
            light, _state, segments = trace(state, camera_rays(sample), hit0)
            acc = acc + light
            segs += host_read(segments.sum(), "segments", int)
    mean = rnglib.divide(acc, cfg.rays_per_pixel)
    return mean.reshape(tile_h, tile_w, 3), segs


def render_tile(scene: Scene, camera: Camera, cfg: RenderConfig, x0: int = 0,
                y0: int = 0, tile_h: Optional[int] = None,
                tile_w: Optional[int] = None, frame_index: int = 0):
    """Mean radiance of one tile, (tile_h, tile_w, 3) f32."""
    return render_tile_with_stats(scene, camera, cfg, x0, y0, tile_h, tile_w,
                                  frame_index)[0]


def _render_frame_tiles(scene: Scene, camera: Camera, cfg: RenderConfig,
                        frame_index: int, progress, retries: int = 1,
                        as_u8: bool = False, stats: Optional[dict] = None,
                        accumulator=None) -> np.ndarray:
    """Row-major tile sweep (singleThreadedCompute, image.hpp:352-381);
    edge tiles render at full tile shape and are cropped. An
    ``accumulator`` (io.checkpoint.TileAccumulator) gives back the tiles
    it holds, which trace no rays and add no segments, and receives each
    tile rendered, as f32 radiance."""
    ts = cfg.tile_size
    tiles_x, tiles_y = cfg.tiles()
    out = np.zeros((cfg.height, cfg.width, 3), np.uint8 if as_u8 else np.float32)
    total_segs = 0
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            if accumulator is not None and accumulator.has_tile(tx, ty):
                tile = torch.as_tensor(accumulator.get_tile(tx, ty),
                                       device=scene.device)
            else:
                tile, segs = _retrying(lambda: render_tile_with_stats(
                    scene, camera, cfg, x0=tx * ts, y0=ty * ts, tile_h=ts,
                    tile_w=ts, frame_index=frame_index), retries)
                total_segs += segs
                if accumulator is not None:
                    accumulator.put_tile(
                        tx, ty, host_read(tile, "checkpoint").numpy())
            if as_u8:
                tile = tonemap(tile)  # on the device: only uint8 comes back
            h = min(ts, cfg.height - ty * ts)
            w = min(ts, cfg.width - tx * ts)
            out[ty * ts:ty * ts + h, tx * ts:tx * ts + w] = host_read(
                tile[:h, :w], "frame").numpy()
            if progress is not None:
                progress(ty * tiles_x + tx + 1, tiles_x * tiles_y)
    if stats is not None:
        stats["segments"] = total_segs
    return out


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------


def _render(scene, camera, cfg, frame_index, progress, accumulator, retries,
            stats, as_u8):
    kw = dict(retries=retries, as_u8=as_u8, stats=stats)
    if (accumulator is None and cfg.engine == "mega"
            and cfg.rays_per_batch > 0 and cfg.max_bounces > 0):
        passes = cfg.rays_per_pixel if cfg.sample_flatten else 1
        return _render_frame_flat(scene, camera, cfg, frame_index, progress,
                                  passes=passes, **kw)
    return _render_frame_tiles(scene, camera, cfg, frame_index, progress,
                               accumulator=accumulator, **kw)


def render_frame(scene: Scene, camera: Camera, cfg: RenderConfig,
                 frame_index: int = 0, progress=None, accumulator=None,
                 retries: int = 1, stats: Optional[dict] = None) -> np.ndarray:
    """Full-frame mean radiance (H, W, 3) float32 on the host.

    The megakernel renders flat batches (``sample_flatten``: one-sample
    passes) unless ``rays_per_batch`` is 0, an ``accumulator`` is given
    or ``max_bounces`` <= 0: then square tiles, as tpurt's render_frame
    chooses. ``progress(done, total)`` is called per batch or tile;
    ``accumulator`` (io.checkpoint.TileAccumulator) resumes from its
    finished tiles and receives the rest; ``retries`` re-renders a batch
    or tile after a transient device error.

    ``stats``: a dict that receives {"segments": exact path-segment count
    (the "rays" of Mrays/s)} and, for the flat megakernel, "trips": the
    loop trips of its plain-schedule batches (a staged batch adds none)."""
    with span("tpurt.image", frame=frame_index):
        return _render(scene, camera, cfg, frame_index, progress, accumulator,
                       retries, stats, as_u8=False)


def render_image(scene: Scene, camera: Camera, cfg: RenderConfig,
                 frame_index: int = 0, progress=None, accumulator=None,
                 retries: int = 1, stats: Optional[dict] = None) -> np.ndarray:
    """Full pipeline to display pixels (H, W, 3) uint8; the tonemap runs
    on the scene's device (elementwise, so per batch or tile it gives the
    whole frame's bits)."""
    with span("tpurt.image", frame=frame_index):
        return _render(scene, camera, cfg, frame_index, progress, accumulator,
                       retries, stats, as_u8=True)
