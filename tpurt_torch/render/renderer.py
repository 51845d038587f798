"""Frame renderer (port of tpurt/render/renderer.py): the megakernel's
flat batches and the modular engine's tiles.

``engine="mega"`` (the default): a frame is sliced row-major into
ceil(W*H / (B * pixels_per_lane)) megakernel launches of B lanes, each
lane owning a quota of pixels at stride B; seeds and rays are pure
functions of the absolute pixel, so any decomposition gives the same
frame. A scene frozen into the TLAS regime (more instanced meshes than
config.MEGA_TLAS_THRESHOLD) or with bf16 node bounds renders through the
same path. ``mega_dense=True`` runs the brute-force megakernel; a TLAS
scene refuses it, as tpurt's does.

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

The port runs tpurt's plain flat schedule: ``compaction_threshold`` is
read but the staged drivers are not ported (ROADMAP A.5);
``mega_interleave`` and ``mega_schedule`` are bitwise no-ops by contract
and are ignored. ``subpixel_jitter``, ``mega_frames_per_batch > 1``,
``sample_flatten`` and accumulators raise NotImplementedError naming
their ROADMAP item. The modular engine walks ``scene.node_*`` and
ignores the TLAS (tpurt's tests/test_tlas.py holds the two engines
equal on a TLAS scene).
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


def _check_supported(cfg: RenderConfig) -> None:
    def no(what, item):
        raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")

    if cfg.subpixel_jitter:
        no("subpixel_jitter", "A.4")
    if cfg.engine == "modular":
        return
    if cfg.mega_frames_per_batch > 1:
        no("mega_frames_per_batch > 1 (cross-frame packing)", "A.3")
    if cfg.sample_flatten and cfg.rays_per_pixel > 1:
        no("sample_flatten", "A.5")
    if cfg.rays_per_batch <= 0:
        no("the tiled (rays_per_batch=0) megakernel path", "A.5")


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
                    start: int, frame_index: int = 0,
                    sample_offset: int = 0) -> dict:
    """run_megakernel's arguments for the flat batch at ``start`` (less
    the scene and the backend)."""
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
        pixels_per_lane=cfg.pixels_per_lane, tail_passes=cfg.mega_tail_passes,
        dense=cfg.mega_dense,
    )


def render_batch_flat(scene: Scene, camera: Camera, cfg: RenderConfig,
                      start: int, frame_index: int = 0, sample_offset: int = 0):
    """Mean radiance of one flat batch: pixels [start, start + B*P) in
    row-major order, padded past the frame end. Returns ((B*P, 3)
    radiance on the scene's device, exact segment count, loop trips)."""
    args = flat_batch_args(scene, camera, cfg, start, frame_index,
                           sample_offset)
    return run_megakernel(scene, body_backend=body_backend(cfg, scene), **args)


def _render_frame_flat(scene: Scene, camera: Camera, cfg: RenderConfig,
                       frame_index: int, progress, as_u8: bool = False,
                       stats: Optional[dict] = None) -> np.ndarray:
    total = cfg.width * cfg.height
    b = _flat_batch_size(cfg) * cfg.pixels_per_lane  # pixels per launch
    n_batches = -(-total // b)
    out = np.zeros((total, 3), np.uint8 if as_u8 else np.float32)
    total_segs = 0
    trips = 0
    for i in range(n_batches):
        start = i * b
        mean, segs, iters = render_batch_flat(scene, camera, cfg, start,
                                              frame_index)
        total_segs += segs
        trips += iters
        if as_u8:
            mean = tonemap(mean)  # on the device: only uint8 comes back
        n = min(b, total - start)
        out[start:start + n] = mean[:n].cpu().numpy()
        if progress is not None:
            progress(i + 1, n_batches)
    if stats is not None:
        stats["segments"] = total_segs
        stats["trips"] = trips
    return out.reshape(cfg.height, cfg.width, 3)


# ---------------------------------------------------------------------------
# The modular engine's tiles
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
    path-segment count) of one tile through the modular engine (tpurt's
    _render_tile_impl, non-mega branch)."""
    _check_supported(cfg)
    if cfg.engine != "modular":
        raise ValueError("render_tile renders the modular engine; the "
                         "megakernel renders flat batches (render_frame)")
    tile_h = tile_h or min(cfg.tile_size, cfg.height)
    tile_w = tile_w or min(cfg.tile_size, cfg.width)
    xs, ys = _tile_pixel_coords(tile_h, tile_w, x0, y0, scene.device)
    pixel_index = (ys * cfg.width + xs) & 0xFFFFFFFF
    ro, rd = make_ray(camera, pixel_uv(xs, ys, cfg.width, cfg.height))
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
                        frame_index: int, progress, as_u8: bool = False,
                        stats: Optional[dict] = None) -> np.ndarray:
    """Row-major tile sweep (singleThreadedCompute, image.hpp:352-381);
    edge tiles render at full tile shape and are cropped."""
    ts = cfg.tile_size
    tiles_x, tiles_y = cfg.tiles()
    out = np.zeros((cfg.height, cfg.width, 3), np.uint8 if as_u8 else np.float32)
    total_segs = 0
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            tile, segs = render_tile_with_stats(
                scene, camera, cfg, x0=tx * ts, y0=ty * ts, tile_h=ts, tile_w=ts,
                frame_index=frame_index)
            total_segs += segs
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


def _render(scene, camera, cfg, frame_index, progress, accumulator, stats,
            as_u8):
    if accumulator is not None:
        raise NotImplementedError(
            "tile accumulators (checkpoint/resume) are not ported yet "
            "(ROADMAP A.7)")
    _check_supported(cfg)
    draw = _render_frame_tiles if cfg.engine == "modular" else _render_frame_flat
    return draw(scene, camera, cfg, frame_index, progress, as_u8=as_u8,
                stats=stats)


def render_frame(scene: Scene, camera: Camera, cfg: RenderConfig,
                 frame_index: int = 0, progress=None, accumulator=None,
                 stats: Optional[dict] = None) -> np.ndarray:
    """Full-frame mean radiance (H, W, 3) float32 on the host.

    ``stats``: a dict that receives {"segments": exact path-segment count
    (the "rays" of Mrays/s)} and, for the megakernel, "trips": its loop
    trips."""
    return _render(scene, camera, cfg, frame_index, progress, accumulator,
                   stats, as_u8=False)


def render_image(scene: Scene, camera: Camera, cfg: RenderConfig,
                 frame_index: int = 0, progress=None, accumulator=None,
                 stats: Optional[dict] = None) -> np.ndarray:
    """Full pipeline to display pixels (H, W, 3) uint8; the tonemap runs
    on the scene's device."""
    return _render(scene, camera, cfg, frame_index, progress, accumulator,
                   stats, as_u8=True)
