"""Animation: per-frame scene updates and the video render loop (port of
tpurt/anim.py).

setupNextVideoFrame (src/image.hpp:385-399) rotates the last mesh's yaw
to 2*pi*frame/VIDEO_FRAME_COUNT + 5.5 before each frame. The reference's
multi-frame loop is commented out (main.cpp:686-704), so this module
supplies the capability the reference documents: frames rendered to
<out_dir>/output_<i>.bmp, assembled by scripts/render.sh (ffmpeg), with
per-frame seeds flowing through MakeSeed's frameIndex.

Mesh transforms are scene tensors read at every launch's setup, so a
frame update is a ``dataclasses.replace`` of the frozen Scene: no
rebuild. Frames render on the scene's device and are tonemapped there;
only uint8 pixels come to the host.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from tpurt_torch.config import RenderConfig
from tpurt_torch.core.camera import Camera
from tpurt_torch.io.bmp import write_bmp
from tpurt_torch.render import renderer
from tpurt_torch.render.tonemap import tonemap
from tpurt_torch.scene.types import Scene


def set_mesh_yaw(scene: Scene, mesh_index: int, yaw: float) -> Scene:
    """A scene with one mesh's yaw replaced.

    Refuses meshes frozen as identity transforms (the freeze routed them
    into the static world-space stages, so rotating them afterwards
    would render stale geometry) and scenes whose instance transforms
    were baked into the TLAS rows; re-freeze to animate those."""
    if scene.mesh_identity[mesh_index % scene.num_meshes]:
        raise ValueError(
            f"mesh {mesh_index} was frozen with an identity transform and "
            "is fused into the static world sweep; re-freeze the scene "
            "with a non-identity transform to animate it")
    if scene.mega_tlas:
        raise ValueError(
            "this scene froze its instance transforms into the TLAS row "
            "bank (instance count > config.MEGA_TLAS_THRESHOLD); rebuild "
            "and re-freeze per frame to animate, or raise the threshold "
            "to keep transforms in the scene")
    mesh_yaw = scene.mesh_yaw.clone()
    mesh_yaw[mesh_index] = float(np.float32(yaw))
    return dataclasses.replace(scene, mesh_yaw=mesh_yaw)


def video_frame_scene(scene: Scene, frame_index: int, frame_count: int) -> Scene:
    """setupNextVideoFrame semantics: last mesh yaw =
    2*pi*frame/count + 5.5 (the +5.5 makes a single frame 'start out
    cool', image.hpp:390)."""
    yaw = (2.0 * math.pi / float(frame_count)) * float(frame_index) + 5.5
    return set_mesh_yaw(scene, scene.num_meshes - 1, yaw)


def _dispatch_frame_u8(scene: Scene, camera: Camera, cfg: RenderConfig,
                       frame_index: int) -> list:
    """One whole frame's tonemapped uint8 batches, left on the device
    (flat megakernel path only)."""
    b = renderer._flat_batch_size(cfg) * cfg.pixels_per_lane
    return [tonemap(renderer.render_batch_flat(scene, camera, cfg, i * b,
                                               frame_index=frame_index)[0])
            for i in range(-(-cfg.width * cfg.height // b))]


def _dispatch_pack_u8(scene: Scene, camera: Camera, cfg: RenderConfig,
                      frame_index: int, frames: int) -> list:
    """``frames`` frames of an unchanging scene from frame_index on, in
    cross-frame packed launches (one a batch): each frame's tonemapped
    uint8 batches, left on the device."""
    b = renderer._flat_batch_size(cfg) * cfg.pixels_per_lane
    packs = [[] for _ in range(frames)]
    for i in range(-(-cfg.width * cfg.height // b)):
        m, _, _ = renderer.render_batch_flat_frames(
            scene, (camera,) * frames, cfg, i * b, frame_index=frame_index)
        for j in range(frames):
            packs[j].append(tonemap(m[j * b:(j + 1) * b]))
    return packs


def _materialise_frame_u8(bufs, cfg: RenderConfig) -> np.ndarray:
    total = cfg.width * cfg.height
    out = np.zeros((total, 3), np.uint8)
    start = 0
    for t in bufs:
        n = min(t.shape[0], total - start)
        out[start:start + n] = t[:n].cpu().numpy()
        start += n
    return out.reshape(cfg.height, cfg.width, 3)


def render_video(scene: Scene, camera: Camera, cfg: RenderConfig,
                 out_dir: Optional[str] = None,
                 frame_hook: Callable[[Scene, int, int], Scene] = video_frame_scene,
                 progress=None) -> list:
    """Render cfg.video_frame_count frames to out_dir/output_<i>.bmp
    (the names the reference's render.sh reads); returns the paths.

    On the flat megakernel path a frame's batches are all launched
    before the previous frame's pixels are read back and written, as
    tpurt orders it. Frames whose hook leaves the scene unchanged (the
    same object) render ``cfg.mega_frames_per_batch`` at a time in one
    cross-frame packed launch a batch, where ``cross_frame_pack_ok``
    allows; each packed frame is bitwise the frame rendered alone.
    Other configs render frame by frame through ``render_image``."""
    out_dir = out_dir or cfg.video_output_dir
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    n = cfg.video_frame_count
    fast = (cfg.engine == "mega" and cfg.rays_per_batch > 0
            and cfg.max_bounces > 0
            and not (cfg.sample_flatten and cfg.rays_per_pixel > 1))
    if not fast:
        for f in range(n):
            img = renderer.render_image(frame_hook(scene, f, n), camera, cfg,
                                        frame_index=f)
            paths.append(_write(out_dir, f, img))
            if progress is not None:
                progress(f + 1, n)
        return paths

    pending = []  # [(frame index, uint8 batches on the device)]

    def deliver():
        for f, bufs in pending:
            paths.append(_write(out_dir, f, _materialise_frame_u8(bufs, cfg)))
            if progress is not None:
                progress(f + 1, n)
        pending.clear()

    pack = max(1, int(cfg.mega_frames_per_batch))
    if not renderer.cross_frame_pack_ok(cfg):
        pack = 1
    f = 0
    while f < n:
        frame_scene = frame_hook(scene, f, n)
        k = 1
        if pack > 1 and frame_scene is scene:
            while f + k < n and k < pack and frame_hook(scene, f + k, n) is scene:
                k += 1
        if k > 1:
            packs = _dispatch_pack_u8(frame_scene, camera, cfg, f, k)
            items = [(f + j, packs[j]) for j in range(k)]
        else:
            items = [(f, _dispatch_frame_u8(frame_scene, camera, cfg, f))]
        deliver()  # the previous frames ship after this pack's launches
        pending.extend(items)
        f += k
    deliver()
    return paths


def _write(out_dir: str, f: int, img: np.ndarray) -> str:
    path = os.path.join(out_dir, f"output_{f}.bmp")
    write_bmp(path, img)
    return path


def progressive_render(scene: Scene, camera: Camera, cfg: RenderConfig,
                       passes: int, preview_path: Optional[str] = "preview.bmp",
                       preview_every: int = 10, progress=None) -> np.ndarray:
    """Progressive refinement: whole-frame passes with frame indices
    0..passes-1, averaged — the reference viewer's accumulation
    (main.cpp:574-582) and its documented 'preview.bmp every 10 frames'
    (settings.hpp:19-20), tonemapped on the scene's device. Returns the
    final averaged radiance (H, W, 3) float32."""
    acc = np.zeros((cfg.height, cfg.width, 3), np.float32)
    for i in range(passes):
        acc += renderer.render_frame(scene, camera, cfg, frame_index=i)
        if preview_path and ((i + 1) % preview_every == 0 or i + 1 == passes):
            mean = torch.as_tensor(acc / (i + 1), device=scene.device)
            write_bmp(preview_path, tonemap(mean).cpu().numpy())
        if progress is not None:
            progress(i + 1, passes)
    return acc / passes
