"""Interactive progressive viewer (port of tpurt/viewer.py).

A working counterpart of the reference's bit-rotted GLFW/ImGui viewer
(src/main.cpp:341-653): a driver loop where the user steers the camera,
adjusts rays-per-pixel / bounce count at runtime, picks a mesh under a
screen position to tint it red, and watches the render refine
progressively — with the accumulation buffer resetting on every camera
or scene change (main.cpp:352-357, 574-582).

There is no GL window in this environment, so the frontend is a
terminal key loop writing ``preview.bmp`` after every pass; the
``ViewerSession`` state machine underneath is frontend-agnostic (and
unit-testable: keys in, camera/accumulation state out). Commands can
also be piped line-wise (one command per line) for scripted sessions.

Key semantics transcribed from the reference (main.cpp:482-529):

  w/s   +-forward: pos.x += v*sin(yaw), pos.z += v*cos(yaw)
  a/d   strafe:    pos.x -+= v*cos(yaw), pos.z +-= v*sin(yaw)
  q/e   down/up:   pos.y -+= v
  i/k   pitch -+  (UP/DOWN arrows)
  j/l   yaw   -+  (LEFT/RIGHT arrows)

with moveSpeed=100/s and rotSpeed=1.5/s applied over a fixed 0.1 s
virtual timestep per keypress. Further commands:

  +/-   rays per pixel +-1        (the ImGui slider, main.cpp:625)
  [/]   max bounces -+1           (main.cpp:626)
  p X Y pick the mesh under pixel (X, Y) and tint it red
        (checkIntersectingRay + mapped-buffer recolor,
        main.cpp:359-382, Trace.cl:655-699)
  u     undo all tints (restore original materials)
  r     reset accumulation
  space render one more pass
  g N   render N more passes
  o     write output.bmp from the current accumulation
  h     help, Q quit
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from tpurt_torch.config import RenderConfig
from tpurt_torch.core.camera import Camera
from tpurt_torch.io.bmp import write_bmp
from tpurt_torch.render.pick import pick_mesh
from tpurt_torch.render.renderer import render_frame
from tpurt_torch.render.tonemap import tonemap
from tpurt_torch.scene.types import Scene

MOVE_SPEED = 100.0  # units/s (main.cpp:484)
ROT_SPEED = 1.5  # rad/s (main.cpp:485)
KEY_DT = 0.1  # virtual seconds per keypress


def recolor_mesh(scene: Scene, mesh_idx: int,
                 color: Tuple[float, float, float] = (1.0, 0.0, 0.0)) -> Scene:
    """Tint one mesh's material color (the reference pokes the mapped
    mesh buffer to turn the picked mesh red, main.cpp:359-382). Returns
    a new Scene; the original is untouched (scenes are immutable).

    Scenes carrying the freeze-time material dedup (mesh_mat_slot) get
    the tinted mesh RE-SLOTTED into its own exclusive slot so the new
    color cannot leak to meshes that shared its material — and if the
    mesh was a shared slot's representative, the slot's rep moves to
    another member first. ``dataclasses.replace`` gives the new Scene an
    empty ``cache``, and the megakernel packs its material table from the
    scene at every launch, so the tint reaches kernel B1 at once."""
    mat_color = scene.mat_color.clone()
    mat_color[mesh_idx] = torch.tensor(color, dtype=torch.float32,
                                       device=mat_color.device)
    scene = dataclasses.replace(scene, mat_color=mat_color)
    if scene.mesh_mat_slot:
        slots = list(scene.mesh_mat_slot)
        reps = list(scene.mat_slot_rep)
        old = slots[mesh_idx]
        members = [j for j, s in enumerate(slots) if s == old]
        if len(members) > 1:
            if reps[old] == mesh_idx:
                reps[old] = next(j for j in members if j != mesh_idx)
            slots[mesh_idx] = len(reps)
            reps.append(mesh_idx)
        else:
            reps[old] = mesh_idx
        scene = dataclasses.replace(scene, mesh_mat_slot=tuple(slots),
                                    mat_slot_rep=tuple(reps))
    return scene


@dataclasses.dataclass
class ViewerSession:
    """Frontend-agnostic interactive state: camera pose, runtime render
    knobs, progressive accumulation, and pick-to-tint."""

    scene: Scene
    cfg: RenderConfig
    position: Tuple[float, float, float] = None
    pitch: float = None
    yaw: float = None
    roll: float = None

    def __post_init__(self):
        if self.position is None:
            self.position = tuple(self.cfg.camera_position)
        if self.pitch is None:
            self.pitch = self.cfg.camera_pitch
        if self.yaw is None:
            self.yaw = self.cfg.camera_yaw
        if self.roll is None:
            self.roll = self.cfg.camera_roll
        self._orig_scene = self.scene
        self._acc = np.zeros((self.cfg.height, self.cfg.width, 3), np.float32)
        self.num_passes = 0  # numFrames analog (main.cpp:574-582)
        self.picked: Optional[int] = None

    # -- camera ------------------------------------------------------------

    def camera(self) -> Camera:
        return Camera.create(
            position=self.position, pitch=self.pitch, yaw=self.yaw,
            roll=self.roll, fov_degrees=self.cfg.fov_degrees,
            aspect_ratio=self.cfg.aspect_ratio, device=self.scene.device,
        )

    def reset_accumulation(self) -> None:
        """shouldRefreshBuffers semantics: any camera/scene change
        zeroes the integration buffer and the pass counter
        (main.cpp:352-357)."""
        self._acc[:] = 0.0
        self.num_passes = 0

    def move_key(self, key: str, dt: float = KEY_DT) -> bool:
        """Apply one reference movement key; returns True if the pose
        changed (which resets accumulation)."""
        v = MOVE_SPEED * dt
        r = ROT_SPEED * dt
        x, y, z = self.position
        sy, cy = math.sin(self.yaw), math.cos(self.yaw)
        if key == "w":
            self.position = (x + v * sy, y, z + v * cy)
        elif key == "s":
            self.position = (x - v * sy, y, z - v * cy)
        elif key == "a":
            self.position = (x - v * cy, y, z + v * sy)
        elif key == "d":
            self.position = (x + v * cy, y, z - v * sy)
        elif key == "q":
            self.position = (x, y - v, z)
        elif key == "e":
            self.position = (x, y + v, z)
        elif key == "i":
            self.pitch -= r
        elif key == "k":
            self.pitch += r
        elif key == "j":
            self.yaw -= r
        elif key == "l":
            self.yaw += r
        else:
            return False
        self.reset_accumulation()
        return True

    # -- runtime knobs (the ImGui sliders, main.cpp:625-626) ----------------

    def adjust_spp(self, delta: int) -> None:
        self.cfg = self.cfg.replace(
            rays_per_pixel=max(1, self.cfg.rays_per_pixel + delta)
        )
        # spp affects every sample of a pass; keep accumulated passes
        # (each pass is an unbiased estimate regardless of its spp).

    def adjust_bounces(self, delta: int) -> None:
        self.cfg = self.cfg.replace(
            max_bounces=max(1, self.cfg.max_bounces + delta)
        )
        self.reset_accumulation()  # changes the estimator

    # -- picking ------------------------------------------------------------

    def pick(self, px: int, py: int) -> Optional[int]:
        """Pick the mesh under pixel (px, py) and tint it red; returns
        the mesh index (None = background). A new pick replaces the
        previous tint (the reference keeps one selectedMeshIdx)."""
        # Same uv convention as the raytrace kernel: y flipped
        # (Trace.cl:634-635), so picking pixel (px, py) targets exactly
        # what was rendered there.
        u = (px + 0.5) / self.cfg.width
        v = 1.0 - (py + 0.5) / self.cfg.height
        idx = int(pick_mesh(self.scene, self.camera(), [(u, v)])[0])
        if idx < 0:
            return None
        self.scene = recolor_mesh(self._orig_scene, idx)
        self.picked = idx
        self.reset_accumulation()
        return idx

    def clear_tint(self) -> None:
        self.scene = self._orig_scene
        self.picked = None
        self.reset_accumulation()

    # -- rendering ------------------------------------------------------------

    def render_pass(self) -> np.ndarray:
        """One whole-frame pass accumulated into the integration buffer
        (intBuffer += frame; display = intBuffer / numFrames,
        main.cpp:574-582). Returns the current averaged radiance."""
        frame = render_frame(
            self.scene, self.camera(), self.cfg, frame_index=self.num_passes
        )
        self._acc += frame
        self.num_passes += 1
        return self.display()

    # -- double-buffered multi-pass (the anim.py delivery overlap) ---------

    def _dispatch_pass(self, frame_index: int):
        """Dispatch one whole-frame pass's device work WITHOUT reading
        it back (the radiance batch buffers stay on the device); None
        when the flat mega fast path does not apply (caller falls back to
        the sequential render_pass), as when a compaction threshold is
        set: the staged driver reads live counts on the host between
        stages."""
        cfg = self.cfg
        fast = (
            cfg.engine == "mega" and cfg.rays_per_batch > 0
            and cfg.max_bounces > 0
            and not (cfg.sample_flatten and cfg.rays_per_pixel > 1)
            and not cfg.compaction_threshold
        )
        if not fast:
            return None
        from tpurt_torch.render.renderer import _flat_batch_size, render_batch_flat

        total = cfg.width * cfg.height
        b = _flat_batch_size(cfg) * cfg.pixels_per_lane
        bufs = []
        for i in range(-(-total // b)):
            mean, _, _ = render_batch_flat(
                self.scene, self.camera(), cfg, i * b,
                frame_index=frame_index,
            )
            bufs.append(mean)
        return bufs

    def _accumulate(self, bufs) -> None:
        """Materialise a dispatched pass into the integration buffer
        (the host read the double-buffered loop defers). A TRANSIENT
        device/transport failure re-renders the same pass index through
        the sequential path (render_frame's retry policy, on the same
        backend) — idempotent: the accumulator is only touched once the
        whole pass materialised."""
        from tpurt_torch.render.renderer import _TRANSIENT_ERRORS

        total = self.cfg.width * self.cfg.height
        flat = np.zeros((total, 3), np.float32)
        start = 0
        try:
            for t in bufs:
                t_np = t.cpu().numpy()
                n = min(t_np.shape[0], total - start)
                flat[start : start + n] = t_np[:n]
                start += n
        except _TRANSIENT_ERRORS:
            # The dispatched buffers died with the device context;
            # re-render this pass index from scratch (render_pass owns
            # its own retries via render_frame).
            self.render_pass()
            return
        self._acc += flat.reshape(self.cfg.height, self.cfg.width, 3)
        self.num_passes += 1

    def render_passes(self, n: int) -> np.ndarray:
        """``n`` progressive passes, DOUBLE-BUFFERED on the flat mega
        path: pass k+1's device work is dispatched before pass k's
        pixels are pulled to the host, so delivery (the D2H that
        dominates interactive latency over slow transports) overlaps
        the next pass's render — steady-state wall clock per pass
        approaches max(render, D2H) instead of their sum (the anim.py
        video-loop delivery, main.cpp:574-582 being improved on).
        Bitwise-identical to n sequential render_pass calls: dispatch
        order per pass is unchanged and accumulation happens in pass
        order, only the host reads move later."""
        pending = None
        for k in range(n):
            bufs = self._dispatch_pass(self.num_passes + (1 if pending else 0))
            if bufs is None:  # non-flat config: sequential fallback
                if pending is not None:
                    self._accumulate(pending)
                    pending = None
                self.render_pass()
                continue
            if pending is not None:
                self._accumulate(pending)
            pending = bufs
        if pending is not None:
            self._accumulate(pending)
        return self.display()

    def display(self) -> np.ndarray:
        n = max(self.num_passes, 1)
        return self._acc / n

    def display_u8(self) -> np.ndarray:
        """The display tonemapped on the scene's device."""
        mean = torch.as_tensor(self.display(), device=self.scene.device)
        return tonemap(mean).cpu().numpy()


def run_terminal(scene: Scene, cfg: RenderConfig,
                 preview_path: str = "preview.bmp",
                 stream=None, out=None) -> ViewerSession:
    """Terminal frontend: read commands (one per line; bare movement
    keys may be concatenated like 'wwdd'), render a pass after each,
    write the preview after every pass. EOF or 'Q' ends the session."""
    stream = stream if stream is not None else sys.stdin
    out = out if out is not None else sys.stdout
    ses = ViewerSession(scene, cfg)

    def status():
        x, y, z = ses.position
        return (
            f"pos=({x:.0f},{y:.0f},{z:.0f}) pitch={ses.pitch:.2f} "
            f"yaw={ses.yaw:.2f} spp={ses.cfg.rays_per_pixel} "
            f"bounces={ses.cfg.max_bounces} passes={ses.num_passes}"
            + (f" picked={ses.picked}" if ses.picked is not None else "")
        )

    def render_and_preview(n=1):
        # Multi-pass bursts ('g N') ride the double-buffered path so
        # pass k+1 renders while pass k's pixels ship to the host.
        if n > 1:
            ses.render_passes(n)
        else:
            ses.render_pass()
        write_bmp(preview_path, ses.display_u8())
        print(f"{status()} -> {preview_path}", file=out, flush=True)

    print(__doc__.split("Key semantics")[0], file=out)
    render_and_preview()
    for line in stream:
        line = line.strip()
        if not line:
            continue
        if line[0] == "Q":
            break
        parts = line.split()
        cmd = parts[0]
        if cmd == "p" and len(parts) == 3:
            idx = ses.pick(int(parts[1]), int(parts[2]))
            print(f"picked mesh {idx}", file=out, flush=True)
        elif cmd == "g" and len(parts) == 2:
            render_and_preview(int(parts[1]))
            continue
        elif cmd == "u":
            ses.clear_tint()
        elif cmd == "r":
            ses.reset_accumulation()
        elif cmd == "+":
            ses.adjust_spp(+1)
        elif cmd == "-":
            ses.adjust_spp(-1)
        elif cmd == "[":
            ses.adjust_bounces(-1)
        elif cmd == "]":
            ses.adjust_bounces(+1)
        elif cmd == "o":
            write_bmp("output.bmp", ses.display_u8())
            print("wrote output.bmp", file=out, flush=True)
            continue
        elif cmd == "h":
            print(__doc__, file=out, flush=True)
            continue
        elif all(c in "wasdqeijkl" for c in cmd):
            for c in cmd:
                ses.move_key(c)
        else:
            print(f"unknown command {line!r} (h for help)", file=out, flush=True)
            continue
        render_and_preview()
    return ses
