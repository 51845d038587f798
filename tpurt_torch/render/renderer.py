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

The port runs tpurt's plain flat and tile schedules:
``compaction_threshold`` is read (``cross_frame_pack_ok`` gives tpurt's
answer) but the staged schedules are not ported (ROADMAP A.5); the port
renders plain batches and plain tiles. ``mega_interleave`` and
``mega_schedule`` are bitwise no-ops by contract and are ignored, as
``render_frame`` ignores ``mega_frames_per_batch`` (tpurt's does too;
``render_batch_flat_frames`` and ``anim`` read it). ``subpixel_jitter``
raises NotImplementedError naming its ROADMAP item. The modular engine
walks ``scene.node_*`` and ignores the TLAS (tpurt's tests/test_tlas.py
holds the two engines equal on a TLAS scene).

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
from tpurt_torch.core.camera import Camera, make_ray, pixel_uv
from tpurt_torch.render.integrator import trace_paths
from tpurt_torch.render.intersect import intersect_scene
from tpurt_torch.render.megakernel import run_megakernel
from tpurt_torch.render.tonemap import tonemap
from tpurt_torch.scene.types import Scene


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


def _check_supported(cfg: RenderConfig) -> None:
    if cfg.subpixel_jitter:
        raise NotImplementedError(
            "subpixel_jitter is not ported yet (ROADMAP A.4)")


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
                    frames: int = 1, cameras=None) -> dict:
    """run_megakernel's arguments for the flat batch at ``start`` (less
    the scene and the backend). ``frames`` > 1 is the packed form: the
    lanes' quota covers ``frames`` frames of pixels_per_lane slots each,
    ``camera`` gives the entry rays and ``cameras`` (one per frame, or
    None for ``camera`` in every frame) the slots' directions."""
    _check_supported(cfg)
    b = _flat_batch_size(cfg)
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
    )


def render_batch_flat(scene: Scene, camera: Camera, cfg: RenderConfig,
                      start: int, frame_index: int = 0, sample_offset: int = 0):
    """Mean radiance of one flat batch: pixels [start, start + B*P) in
    row-major order, padded past the frame end. Returns ((B*P, 3)
    radiance on the scene's device, exact segment count, loop trips)."""
    args = flat_batch_args(scene, camera, cfg, start, frame_index,
                           sample_offset)
    return run_megakernel(scene, body_backend=body_backend(cfg, scene), **args)


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
    (anim's video packs, render_batch_flat_frames' refusal, and a
    benchmark's packed rows): packing runs the PLAIN flat megakernel
    schedule with in-lane samples only — no per-sample jitter, no
    staged/compaction schedule engaging at this batch size (tpurt's
    answer, though the port runs plain batches), and a live bounce
    loop."""
    return (
        cfg.max_bounces > 0
        and not cfg.subpixel_jitter
        and not (cfg.sample_flatten and cfg.rays_per_pixel > 1)
        and not (
            cfg.compaction_threshold
            and _flat_batch_size(cfg) >= cfg.compaction_threshold
        )
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
            trips += iters
            acc = mean if acc is None else acc + mean
        if passes > 1:
            acc = acc / float(passes)
        if as_u8:
            acc = tonemap(acc)  # on the device: only uint8 comes back
        n = min(b, total - start)
        out[start:start + n] = acc[:n].cpu().numpy()
        if progress is not None:
            progress(i + 1, n_batches)
    if stats is not None:
        stats["segments"] = total_segs
        stats["trips"] = trips
    return out.reshape(cfg.height, cfg.width, 3)


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
    the flat path, as tpurt leaves it); a plain launch, not the staged
    tile schedule."""
    _check_supported(cfg)
    tile_h = tile_h or min(cfg.tile_size, cfg.height)
    tile_w = tile_w or min(cfg.tile_size, cfg.width)
    xs, ys = _tile_pixel_coords(tile_h, tile_w, x0, y0, scene.device)
    pixel_index = (ys * cfg.width + xs) & 0xFFFFFFFF
    ro, rd = make_ray(camera, pixel_uv(xs, ys, cfg.width, cfg.height))
    if cfg.engine == "mega":
        mean, segs, _iters = run_megakernel(
            scene, ro, rd, pixel_index, frame_index,
            rays_per_pixel=cfg.rays_per_pixel, max_bounces=cfg.max_bounces,
            seed_mode=cfg.seed_mode, invisible_budget=cfg.invisible_budget,
            sample_offset=sample_offset, camera=camera, width=cfg.width,
            height=cfg.height, body_backend=body_backend(cfg, scene))
        return mean.reshape(tile_h, tile_w, 3), segs
    # The camera ray is shared by every sample (Trace.cl:636-641) and its
    # first intersection draws no random number: intersect it once.
    hit0 = intersect_scene(scene, ro, rd, cfg.bruteforce_threshold,
                           cfg.dense_engine)
    trace = lambda state: trace_paths(
        scene, ro, rd, state, cfg.max_bounces, cfg.invisible_budget,
        cfg.bruteforce_threshold, first_hit=hit0, dense_engine=cfg.dense_engine)
    acc = torch.zeros((tile_h * tile_w, 3), dtype=torch.float32,
                      device=scene.device)
    segs = 0
    if cfg.seed_mode == "reference":
        # One continuous stream across the pixel's samples (Trace.cl:632-642).
        state = rnglib.make_seed(pixel_index, frame_index, 0)
        for _ in range(cfg.rays_per_pixel):
            light, state, segments = trace(state)
            acc = acc + light
            segs += int(segments.sum())
    else:
        # Decorrelated streams: MakeSeed(pixel, frame, sample).
        for s in range(cfg.rays_per_pixel):
            state = rnglib.make_seed(pixel_index, frame_index,
                                     (s + sample_offset) & 0xFFFFFFFF)
            light, _state, segments = trace(state)
            acc = acc + light
            segs += int(segments.sum())
    mean = acc / float(cfg.rays_per_pixel)
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
                    accumulator.put_tile(tx, ty, tile.cpu().numpy())
            if as_u8:
                tile = tonemap(tile)  # on the device: only uint8 comes back
            h = min(ts, cfg.height - ty * ts)
            w = min(ts, cfg.width - tx * ts)
            out[ty * ts:ty * ts + h, tx * ts:tx * ts + w] = tile[:h, :w].cpu().numpy()
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
    _check_supported(cfg)
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
    (the "rays" of Mrays/s)} and, for the flat megakernel, "trips": its
    loop trips."""
    return _render(scene, camera, cfg, frame_index, progress, accumulator,
                   retries, stats, as_u8=False)


def render_image(scene: Scene, camera: Camera, cfg: RenderConfig,
                 frame_index: int = 0, progress=None, accumulator=None,
                 retries: int = 1, stats: Optional[dict] = None) -> np.ndarray:
    """Full pipeline to display pixels (H, W, 3) uint8; the tonemap runs
    on the scene's device (elementwise, so per batch or tile it gives the
    whole frame's bits)."""
    return _render(scene, camera, cfg, frame_index, progress, accumulator,
                   retries, stats, as_u8=True)
