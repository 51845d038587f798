"""The traffic generator and the timed window: the only code of the
benchmark that calls the program (``tpurt_torch``).

A traffic file (``traffic/<name>.json``) is data: its ``kind`` picks one
of the two closed loops below, and its numbers (frame size, samples,
bounces, the renderer's knobs, packing, the camera's path) set what each
request asks for. One client sends the next request when the last one
has come back as uint8 pixels on the host.

- ``stream``: frames back to back under one camera, with distinct frame
  indices from a seeded first one; ``frames_per_pack`` frames a launch
  where the renderer packs them. The frame and pack loop is a frozen
  copy of ``tpurt_torch/bench.py:155-206`` (``time_render_flat``'s
  ``frame_pack``), rewritten to a fixed window: every batch of a frame is
  tonemapped on the device and the frame is copied to the host before
  the next pack starts.
- ``stills``: one ``render_image`` a request, each at a new camera (the
  yaw steps through a fixed cycle of poses from a seeded phase) and a
  new frame index.

Work runs inside ``torch.profiler.record_function`` spans named after
the layer it enters (``render``, ``present``, ``request``), which the
trace reader uses to attribute device time.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from yardstick.scene import Pose


@dataclass
class Frame:
    """One finished frame: when it was asked for and when its pixels
    reached the host, its frame index and pose, and its sampled pixels."""

    index: int
    pose: Pose
    t_request: float
    t_done: float
    pixels: np.ndarray
    profiled: bool = False
    segments: Optional[int] = None
    pad_slots: int = 0


@dataclass
class Window:
    t_start: float = 0.0
    t_end: float = 0.0
    frames: List[Frame] = field(default_factory=list)
    launches: int = 0
    attempted: int = 0


def span(name: str):
    return torch.profiler.record_function(name)


def render_config(cfg: dict, traffic: dict, pose: Pose):
    """The program's RenderConfig for a configuration and a traffic mix."""
    from tpurt_torch.config import RenderConfig

    knobs = dict(cfg.get("render", {}))
    knobs.update(traffic.get("render", {}))
    return RenderConfig(
        width=int(traffic["width"]), height=int(traffic["height"]),
        rays_per_pixel=int(traffic["spp"]), max_bounces=int(traffic["bounces"]),
        camera_position=tuple(pose.position), camera_pitch=pose.pitch,
        camera_yaw=pose.yaw, camera_roll=pose.roll,
        fov_degrees=pose.fov_degrees, **knobs)


def camera(pose: Pose, device):
    from tpurt_torch.core.camera import Camera

    return Camera.create(position=pose.position, pitch=pose.pitch, yaw=pose.yaw,
                         roll=pose.roll, fov_degrees=pose.fov_degrees,
                         aspect_ratio=pose.aspect, device=device)


def render_pack(scene, cam, rcfg, f0: int, pack: int):
    """Frames f0 .. f0 + pack - 1 through the flat driver, packed into one
    launch a batch where ``pack`` > 1: (uint8 frames on the host, segments
    summed over the pack as the program counts them, padding slots a
    frame). A batch of B lanes x P pixels returns B*P rows a frame; rows
    past the frame end repeat its last pixel and are dropped."""
    from tpurt_torch.render.renderer import render_batch_flat_frames
    from tpurt_torch.render.tonemap import tonemap

    total = rcfg.width * rcfg.height
    parts = [[] for _ in range(pack)]
    cams = (cam,) * pack
    start = segs = pad = 0
    while start < total:
        with span("render"):
            m, s, _ = render_batch_flat_frames(scene, cams, rcfg, start,
                                               frame_index=f0)
        rows = m.shape[0] // pack
        n = min(rows, total - start)
        with span("present"):
            for k in range(pack):
                parts[k].append(tonemap(m[k * rows:k * rows + n]))
        segs += int(s)
        pad += rows - n
        start += rows
    with span("present"):
        frames = [torch.cat(p).cpu().numpy() for p in parts]
    return frames, segs, pad


def still(scene, rcfg, pose: Pose, index: int, device):
    """One still: the uint8 image on the host and the program's segment
    count (a staged frame counts what it traced again)."""
    from tpurt_torch.render.renderer import render_image

    stats = {}
    img = render_image(scene, camera(pose, device), rcfg, frame_index=index,
                       stats=stats)
    return img.reshape(-1, 3), stats.get("segments")


def stills_pose(cfg: dict, traffic: dict, k: int, width: int, height: int):
    """The pose of request ``k``: the yaw of the configuration's camera
    plus ``yaw_step_turns`` of a turn for each step along a cycle of
    ``yaw_cycle`` poses centred on it."""
    from yardstick.scene import pose

    cyc = int(traffic["camera"]["yaw_cycle"])
    step = float(traffic["camera"]["yaw_step_turns"]) * 2.0 * math.pi
    base = float(cfg["camera"]["yaw"])
    j = k % cyc - cyc // 2
    return pose(cfg, width, height, yaw=base + j * step)


class Profiler:
    """The trace run's profiler over a short steady stretch of requests:
    started at a request boundary, stopped at one."""

    def __init__(self, enabled: bool, skip: int, seconds: float, min_requests: int,
                 device):
        self.enabled = enabled
        self.skip = skip
        self.seconds = seconds
        self.min_requests = min_requests
        self.device = device
        self.prof = None
        self.stretch = None
        self.t0 = 0.0
        self.count = 0
        self.done = False

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self):
        """Start and stop the profiler once during set-up, so that the
        stretch does not pay for the tracer's own start (seconds)."""
        if self.enabled:
            with self._profile():
                torch.ones(1, device=self.device).add_(1).sum().item()

    def before(self, k: int):
        """Called before request ``k`` of the window: starts the stretch."""
        if not self.enabled or self.done or self.prof is not None or k < self.skip:
            return False
        self.prof = self._profile()
        self.prof.__enter__()
        self.stretch = span("stretch")
        self.stretch.__enter__()
        self.t0 = time.perf_counter()
        return True

    def active(self) -> bool:
        return self.prof is not None and not self.done

    def after(self, n_requests: int):
        """Called after a request of the stretch has come back."""
        if not self.active():
            return
        self.count += n_requests
        if (time.perf_counter() - self.t0 >= self.seconds
                and self.count >= self.min_requests):
            self.stop()

    def stop(self):
        if self.active():
            self.stretch.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.done = True


def stream_window(scene, cam, rcfg, pose: Pose, traffic: dict, seconds: float,
                  first: int, pick: np.ndarray, profiler: Profiler) -> Window:
    """Warm up on the frames before ``first``, then frames back to back for
    ``seconds``: the window ends with the first pack that comes back after
    it. ``pick`` are the pixel indices kept of every frame."""
    from tpurt_torch.render import megakernel

    pack = int(traffic.get("frames_per_pack", 1))
    for w in range(int(traffic.get("warmup", 2))):
        render_pack(scene, cam, rcfg, first - (w + 1) * pack, pack)
    win = Window()
    runs0 = megakernel.RUNS
    win.t_start = t = time.perf_counter()
    k = 0
    while True:
        f0 = first + k * pack
        on = profiler.before(k) or profiler.active()
        t_req = t
        with span("request"):
            frames, segs, pad = render_pack(scene, cam, rcfg, f0, pack)
        t = time.perf_counter()
        win.attempted += pack
        for j, img in enumerate(frames):
            win.frames.append(Frame(index=f0 + j, pose=pose, t_request=t_req,
                                    t_done=t, pixels=img[pick], profiled=on,
                                    segments=segs if j == 0 else 0,
                                    pad_slots=pad))
        profiler.after(pack)
        k += 1
        if t - win.t_start >= seconds:
            break
    profiler.stop()
    win.t_end = t
    win.launches = megakernel.RUNS - runs0
    return win


def stills_window(scene, rcfg, cfg: dict, traffic: dict, seconds: float,
                  first: int, phase: int, pick: np.ndarray, profiler: Profiler,
                  device) -> Window:
    """Warm up on the poses before ``phase``, then stills back to back for
    ``seconds``; the window ends with the first still that comes back
    after it."""
    from tpurt_torch.render import megakernel

    w, h = rcfg.width, rcfg.height
    for j in range(int(traffic.get("warmup", 3))):
        k = phase - (j + 1)
        still(scene, rcfg, stills_pose(cfg, traffic, k, w, h), first - (j + 1),
              device)
    win = Window()
    runs0 = megakernel.RUNS
    win.t_start = time.perf_counter()
    i = 0
    while True:
        pose = stills_pose(cfg, traffic, phase + i, w, h)
        on = profiler.before(i) or profiler.active()
        t_req = time.perf_counter()
        with span("request"):
            img, segs = still(scene, rcfg, pose, first + i, device)
        t = time.perf_counter()
        win.attempted += 1
        win.frames.append(Frame(index=first + i, pose=pose, t_request=t_req,
                                t_done=t, pixels=img[pick], profiled=on,
                                segments=segs))
        profiler.after(1)
        i += 1
        if t - win.t_start >= seconds:
            break
    profiler.stop()
    win.t_end = t
    win.launches = megakernel.RUNS - runs0
    return win


@contextlib.contextmanager
def annotated_tonemap(enabled: bool):
    """In the trace run, the program's tonemap inside render_image runs
    within a ``present`` span, as the stream loop's own calls do."""
    if not enabled:
        yield
        return
    from tpurt_torch.render import renderer

    inner = renderer.tonemap

    def tonemap(x):
        with span("present"):
            return inner(x)

    renderer.tonemap = tonemap
    try:
        yield
    finally:
        renderer.tonemap = inner


def plain_segments(scene, rcfg, frames: List[Frame], device):
    """Each profiled still again on the plain schedule (no staging): its
    segment count as a plain frame counts it, and its padding slots. Run
    after the window, untimed."""
    plain = rcfg.replace(compaction_threshold=0, mega_frames_per_batch=1)
    for fr in frames:
        if fr.profiled:
            _, segs, pad = render_pack(scene, camera(fr.pose, device), plain,
                                       fr.index, 1)
            fr.segments, fr.pad_slots = segs, pad
