"""Tile-grain render checkpoints (resume + progressive preview):
tpurt_torch's own copy of tpurt/io/checkpoint.py (numpy only).

The reference has no checkpointing (its settings.hpp:19-20 promises a
preview.bmp every 10 frames that was never implemented, and a dead
RELAX_GPU flag). Because every tile render is a pure function of
(scene, camera, config, tile coords, frame), a crashed or interrupted
render resumes by re-rendering only missing tiles. Accumulators persist
as .npz with a config fingerprint so stale checkpoints are refused.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

import numpy as np


def config_fingerprint(cfg, frame_index: int = 0) -> str:
    payload = json.dumps(
        {**dataclasses.asdict(cfg), "frame_index": frame_index}, sort_keys=True
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


class TileAccumulator:
    """Float32 radiance tiles, keyed by (tile_x, tile_y)."""

    def __init__(self, cfg, frame_index: int = 0, path: Optional[str] = None):
        self.cfg = cfg
        self.frame_index = frame_index
        self.path = path
        self.fingerprint = config_fingerprint(cfg, frame_index)
        self.tiles = {}
        if path and os.path.exists(path):
            self._load(path)

    def _key(self, tx: int, ty: int) -> str:
        return f"tile_{tx}_{ty}"

    def has_tile(self, tx: int, ty: int) -> bool:
        return self._key(tx, ty) in self.tiles

    def get_tile(self, tx: int, ty: int) -> np.ndarray:
        return self.tiles[self._key(tx, ty)]

    def put_tile(self, tx: int, ty: int, radiance: np.ndarray) -> None:
        self.tiles[self._key(tx, ty)] = np.asarray(radiance, np.float32)
        if self.path:
            self.save(self.path)

    def save(self, path: str) -> None:
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, __fingerprint__=self.fingerprint, **self.tiles)
        os.replace(tmp, path)

    def _load(self, path: str) -> None:
        with np.load(path) as data:
            fp = str(data["__fingerprint__"])
            if fp != self.fingerprint:
                return  # different config/frame — start fresh
            for key in data.files:
                if key.startswith("tile_"):
                    self.tiles[key] = data[key]

    def preview(self) -> np.ndarray:
        """Assemble whatever is finished into an (H, W, 3) image;
        missing tiles stay black. The 'preview.bmp' the reference only
        documented (settings.hpp:19-20)."""
        cfg = self.cfg
        ts = cfg.tile_size
        out = np.zeros((cfg.height, cfg.width, 3), np.float32)
        for key, tile in self.tiles.items():
            _, tx, ty = key.split("_")
            tx, ty = int(tx), int(ty)
            h = min(ts, cfg.height - ty * ts)
            w = min(ts, cfg.width - tx * ts)
            out[ty * ts : ty * ts + h, tx * ts : tx * ts + w] = tile[:h, :w]
        return out

    @property
    def num_tiles(self) -> int:
        return len(self.tiles)
