"""Flat-batch renderer (port of tpurt/render/renderer.py's flat path).

A frame is sliced row-major into ceil(W*H / (B * pixels_per_lane))
megakernel launches of B lanes, each lane owning a quota of pixels at
stride B; seeds and rays are pure functions of the absolute pixel, so
any decomposition gives the same frame.

``RenderConfig.mega_body`` (tpurt's knob, shared) picks the backend:

  "auto"    the hand-written CUDA kernel for a scene on a CUDA device,
            the plain torch version for a CPU scene;
  "xla"     the plain torch version on any device — the parity anchor,
            as tpurt's XLA body is;
  "pallas"  the CUDA kernel; raises on a CPU scene.

The port always runs tpurt's PLAIN flat schedule: ``compaction_threshold``
is read but the staged/cascade/speculative drivers are not ported (tpurt
documents staged as near-bitwise to plain; ROADMAP A.9 decides after an
on-card measurement whether they are worth porting). ``mega_interleave``
and ``mega_schedule`` are bitwise no-ops by contract and are ignored.
``subpixel_jitter``, ``mega_frames_per_batch > 1``, ``mega_dense``,
``sample_flatten``, the modular engine, accumulators and TLAS scenes
raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpurt.config import RenderConfig
from tpurt_torch.core.camera import Camera, make_ray, pixel_uv
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

    if cfg.engine != "mega":
        no("engine='modular'", "A.8")
    if cfg.subpixel_jitter:
        no("subpixel_jitter", "A.7")
    if cfg.mega_frames_per_batch > 1:
        no("mega_frames_per_batch > 1 (cross-frame packing)", "A.5")
    if cfg.mega_dense:
        no("mega_dense (kernel B2)", "A.8")
    if cfg.sample_flatten and cfg.rays_per_pixel > 1:
        no("sample_flatten", "A.9")
    if cfg.rays_per_batch <= 0:
        no("the tiled (rays_per_batch=0) path", "A.9")


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


def render_frame(scene: Scene, camera: Camera, cfg: RenderConfig,
                 frame_index: int = 0, progress=None, accumulator=None,
                 stats: Optional[dict] = None) -> np.ndarray:
    """Full-frame mean radiance (H, W, 3) float32 on the host.

    ``stats``: a dict that receives {"segments": exact path-segment count
    (the "rays" of Mrays/s), "trips": megakernel loop trips}."""
    if accumulator is not None:
        raise NotImplementedError(
            "tile accumulators (checkpoint/resume) are not ported yet "
            "(ROADMAP A.11)")
    return _render_frame_flat(scene, camera, cfg, frame_index, progress,
                              stats=stats)


def render_image(scene: Scene, camera: Camera, cfg: RenderConfig,
                 frame_index: int = 0, progress=None,
                 stats: Optional[dict] = None) -> np.ndarray:
    """Full pipeline to display pixels (H, W, 3) uint8; the tonemap runs
    on the scene's device."""
    return _render_frame_flat(scene, camera, cfg, frame_index, progress,
                              as_u8=True, stats=stats)
