"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample
of the window's frames, drawn from the seed, is traced again by the
plain reference at the pixels the run kept of every frame (also drawn
from the seed). The number compared is ``px_diff_pct``: the share of the
compared pixels whose uint8 value differs from the reference's in any
channel. The reference and the program follow one RNG stream per pixel,
so a pixel's value is the same whenever each of its paths hits the same
sequence of materials; a pixel differs where rounding moves a path
across a silhouette, and everywhere where a frame is wrong.

The limit of each cell is ``limits/<cell>.json``; PERF.md gives the
readings it was set from.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from yardstick import reference
from yardstick.drivers import Frame


@dataclass
class Lanes:
    """Reference lanes: pixel, frame index and pose of each."""

    pix: np.ndarray
    frame: np.ndarray
    pose_of: np.ndarray
    poses: list


def lanes_for(frames: List[Frame], pick: np.ndarray, extra_pixels=()) -> Lanes:
    """``pick`` pixels of each frame, then ``extra_pixels`` (frame, pixel)
    pairs."""
    poses, index = [], {}
    pix, fidx, pose_of = [], [], []
    for fr, px in [(f, pick) for f in frames] + [
            (f, np.asarray([p])) for f, p in extra_pixels]:
        if fr.pose not in index:
            index[fr.pose] = len(poses)
            poses.append(fr.pose)
        pix.append(px)
        fidx.append(np.full(len(px), fr.index))
        pose_of.append(np.full(len(px), index[fr.pose]))
    cat = lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int64)
    return Lanes(cat(pix).astype(np.int64), cat(fidx).astype(np.int64),
                 cat(pose_of).astype(np.int64), poses)


def trace(scene: reference.RefScene, lanes: Lanes, traffic: dict):
    """(uint8 (N, 3), segments (N,)) of the reference, on the host."""
    u8, segs, _ = reference.render(
        scene, lanes.poses, lanes.pose_of, lanes.pix, lanes.frame,
        int(traffic["width"]), int(traffic["height"]), int(traffic["spp"]),
        int(traffic["bounces"]))
    return u8.cpu().numpy(), segs.cpu().numpy()


def px_diff_pct(program: np.ndarray, ref: np.ndarray) -> float:
    """Per cent of pixels whose uint8 RGB differs in any channel."""
    if len(ref) == 0:
        return float("nan")
    return 100.0 * float((program != ref).any(axis=1).mean())


def compare(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every limit must hold; a number
    that is missing or not finite fails."""
    rows = []
    ok = True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and np.isfinite(value) and value <= limit
        ok &= bool(good)
        rows.append((name, value, limit))
    return ok, rows


def choose_frames(frames: List[Frame], k: int, rng: np.random.Generator):
    if not frames:
        return []
    idx = np.sort(rng.choice(len(frames), size=min(k, len(frames)),
                             replace=False))
    return [frames[i] for i in idx]


def pick_pixels(total: int, n: int, rng: np.random.Generator) -> np.ndarray:
    return np.sort(rng.choice(total, size=min(n, total), replace=False))

