"""First-run autotuner (port of tpurt/autotune.py): re-derive the engine
knob set on a new card.

The CLI's card defaults (quota 8, 5 tail passes, the a8/l3 u8 bank) are
the headline's knobs, carried over from tpurt's v5e optimum; nothing
says they are the H100's. This module re-runs tpurt's measurement:
coordinate descent over the knob axes on the headline's workload, one
steady-state timed block per leg, the result cached per card so the
sweep runs once per card model.

    python -m tpurt_torch.autotune            # full sweep, on the card
    python -m tpurt_torch.autotune --quick    # tail passes + quota only
    python -m tpurt_torch.autotune --cpu      # plumbing on the CPU (tiny
                                              # shapes, numbers meaningless)
    python -m tpurt_torch.cli --tuned         # apply the cached knob set

The axes are tpurt's, less the three that only the TPU has:
``mega_interleave`` (the port accepts it and ignores it: the sub-batch
interleave is a TPU schedule, bitwise a no-op by contract),
``block_lanes`` (Pallas grid blocks; kernel B1's threads a block are a
compile-time constant under ``__launch_bounds__``, so a threads axis
needs new instantiations — ROADMAP) and ``mat_prune`` (Mosaic's pruned
body; the port has one body). ``apply`` ignores those keys, as tpurt's
ignores unknown ones, so a tpurt cache still loads. ``pixels_per_lane``
joins the quick sweep in the dropped interleave's place, as the port's
other scheduler knob.

A leg whose bank the kernel cannot take is refused on the host before
any launch (``ValueError``: ``SceneBuilder.freeze``,
``mega_cuda.check_bank``) and recorded as failed, as is one that runs
out of device memory. Any other error, a CUDA fault above all (it leaves
the context unusable for every later leg), ends the sweep.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
from typing import Optional

import torch

#: Axes swept, in descent order (tpurt's: the bank layout first — arity
#: and leaf capacity together derive the row width W at freeze — then
#: tail passes, then the scheduler knob, then the bounds format). The
#: current best of every other axis is held while one axis sweeps; the
#: descent starts from the shipped config.
AXES = (
    ("node_arity", (4, 8, 16, 32)),
    ("leaf_tris", (2, 3, 4, 5, 8)),
    ("mega_tail_passes", (3, 4, 5, 6)),
    ("pixels_per_lane", (4, 8, 16)),
    ("bounds_fmt", ("u8", "bf16")),
)
QUICK_AXES = ("mega_tail_passes", "pixels_per_lane")

_CFG_FIELDS = {"mega_tail_passes", "pixels_per_lane"}
#: Axes baked into the Scene at freeze time (bank layout / encoding):
#: each leg rebuilds and re-freezes the scene.
_FREEZE_AXES = {"bounds_fmt", "leaf_tris", "node_arity"}


def device_key(device="cuda") -> str:
    """The cache key of ``device``: "cpu", or the card's name
    (torch.cuda.get_device_name) with every run of other characters than
    letters and digits made one underscore."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    name = torch.cuda.get_device_name(device)
    return re.sub(r"[^A-Za-z0-9]+", "_", name).strip("_")


def cache_path(key: str) -> str:
    root = os.environ.get("TPURT_TUNE_DIR") or os.path.expanduser("~/.cache")
    return os.path.join(root, f"tpurt_torch_tune_{key}.json")


def load_tuned(key: Optional[str] = None) -> Optional[dict]:
    """The cached knob set for ``key`` (default: this process's card),
    or None."""
    if key is None:
        key = device_key("cuda")
    try:
        with open(cache_path(key)) as f:
            return json.load(f)["knobs"]
    except (OSError, KeyError, ValueError):
        return None


def save_tuned(knobs: dict, key: str) -> str:
    """Write ``knobs`` as ``key``'s cache; returns its path."""
    path = cache_path(key)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"platform": key, "ts": time.time(), "knobs": knobs}, f,
                  indent=1)
    return path


def apply(knobs: dict, cfg):
    """Returns cfg with the tuned RenderConfig fields, after setting the
    config-module tunables the freeze reads. Unknown keys (tpurt's
    TPU-only ones among them) are ignored so old caches survive knob
    renames."""
    import tpurt_torch.config as _c

    updates = {k: knobs[k] for k in _CFG_FIELDS if k in knobs}
    if "bounds_fmt" in knobs:
        # Scene freeze reads the format; the sweep re-freezes per value.
        _c.MEGA_BF16_BOUNDS = knobs["bounds_fmt"] == "bf16"
    if "leaf_tris" in knobs:
        _c.MEGA_LEAF_TRIS = int(knobs["leaf_tris"])
    if "node_arity" in knobs:
        _c.MEGA_NODE_ARITY = int(knobs["node_arity"])
    return cfg.replace(**updates) if updates else cfg


def _time_leg(scene, cam, cfg, frames: int = 3) -> dict:
    """Steady-state seconds and segments a frame of the flat megakernel
    path: ``bench.time_render_flat`` with one block of at most ``frames``
    frames (tpurt/autotune.py:119-126), packed where the config packs."""
    from tpurt_torch import bench

    r = bench.time_render_flat(scene, cam, cfg, repeats=1, max_frames=frames)
    return {k: r[k] for k in ("seconds", "segments", "frames")}


def _build(cfg, scene_kind: str, device):
    from tpurt_torch.scene.presets import bench_scene

    return bench_scene(scene_kind, cfg, device=device)


def _seed_config():
    """The shipped headline config tpurt's sweep seeds from
    (tpurt/autotune.py:141-158): bunny-1080p-plain as bench ships it,
    packed two frames a launch, so the knobs are priced under the slot
    pressure they will run with."""
    from tpurt_torch.config import RenderConfig

    return RenderConfig(width=1920, height=1080, rays_per_pixel=8,
                        max_bounces=4, seed_mode="reference",
                        pixels_per_lane=8, mega_interleave=4,
                        mega_tail_passes=5, compaction_threshold=0,
                        mega_frames_per_batch=2)


def sweep(cfg=None, scene_kind: str = "bunny", quick: bool = False,
          log=print, device="cuda") -> dict:
    """Coordinate descent over AXES on ``device``; returns the winning
    knob dict (including its measured seconds/frame). Each leg is a fresh
    steady block; a leg refused on the host (ValueError) or out of device
    memory is logged as failed and skipped. The config-module tunables
    are left at the winning set."""
    import tpurt_torch.config as _c

    device = torch.device(device)
    if cfg is None:
        cfg = _seed_config()
    best = {
        "mega_tail_passes": cfg.mega_tail_passes,
        "pixels_per_lane": cfg.pixels_per_lane,
        "bounds_fmt": "bf16" if _c.MEGA_BF16_BOUNDS else "u8",
        "leaf_tris": int(_c.MEGA_LEAF_TRIS),
        "node_arity": int(_c.MEGA_NODE_ARITY),
    }
    scene, cam = _build(apply(best, cfg), scene_kind, device)
    r = _time_leg(scene, cam, apply(best, cfg))
    t_best = r["seconds"]
    log(f"[autotune] baseline {best} -> {t_best*1e3:.3f} ms/frame, "
        f"{r['segments']:.0f} segments/frame")
    for axis, values in AXES:
        if quick and axis not in QUICK_AXES:
            continue
        for v in values:
            if v == best[axis]:
                continue
            trial = dict(best, **{axis: v})
            try:
                tcfg = apply(trial, cfg)
                tscene = scene
                if axis in _FREEZE_AXES:  # baked into the Scene
                    tscene, cam = _build(tcfg, scene_kind, device)
                r = _time_leg(tscene, cam, tcfg)
            except (ValueError, torch.cuda.OutOfMemoryError) as e:
                log(f"[autotune] {axis}={v} failed: {str(e)[:120]}")
                continue
            t = r["seconds"]
            log(f"[autotune] {axis}={v} -> {t*1e3:.3f} ms/frame, "
                f"{r['segments']:.0f} segments/frame")
            if t < t_best:
                t_best, best = t, trial
                if axis in _FREEZE_AXES:
                    scene = tscene
    # Every config-module tunable back to the winning set (a losing trial
    # otherwise leaves its value for any later freeze in this process).
    apply(best, cfg)
    best["seconds_per_frame"] = t_best
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpurt_torch.autotune")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--scene", default="bunny")
    ap.add_argument("--cpu", action="store_true",
                    help="plumbing smoke on the CPU (tiny shapes, numbers "
                         "meaningless)")
    args = ap.parse_args(argv)
    cfg = None
    device = "cpu" if args.cpu else "cuda"
    if args.cpu:
        from tpurt_torch.config import RenderConfig

        cfg = RenderConfig(width=64, height=32, rays_per_pixel=2,
                           max_bounces=2, rays_per_batch=1024,
                           compaction_threshold=0)
    key = device_key(device)
    knobs = sweep(cfg, scene_kind=args.scene if not args.cpu else "sphere",
                  quick=args.quick, device=device)
    path = save_tuned(knobs, key)
    print(json.dumps({"platform": key, "knobs": knobs}))
    print(f"cached -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
