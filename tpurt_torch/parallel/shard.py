"""Frames over a device mesh (port of tpurt/parallel/shard.py).

The replacement for the reference's host-threaded dynamic tile work
queue (src/image.hpp:280-350): the frame is decomposed statically over
the mesh's positions (parallel/mesh.py), each position renders its share
on its own device through the single-device drivers, and the shares are
assembled on the host. Seeds are pure functions of the absolute pixel
(core/camera.py), so tile sharding and over-decomposition give the
single-device frame bit for bit — the property the reference's
per-device seeding broke (image.hpp:228,304).

  * The flat path (the megakernel with ``rays_per_batch > 0``): the
    frame is n_tile * k row-major pixel blocks, dealt round-robin to the
    tile axis (position ti owns blocks ti, ti + n_tile, ...); each block
    is ceil(block_px / (B * P)) flat launches of B lanes, B tpurt's
    per-block batch. A launch that runs past its block renders pixels of
    the next one (or the last pixel again, past the frame end) into rows
    that are cut off before the block is stored.
  * The tile path (the modular engine, or the megakernel's tile path):
    position ti renders rows [ti * h, (ti + 1) * h) as one tile,
    h = ceil(H / n_tile), through ``renderer.render_tile_with_stats``.
  * The sample axis (seed_mode="decorrelated"): position (ti, si)
    renders samples [si * s, (si + 1) * s) of its share, s = spp /
    n_sample, and the per-position means are summed in si order and
    divided by n_sample — tpurt's psum, equal to the single-device
    estimator up to f32 reassociation.

Each device that a position names gets the scene and camera once
(``Scene.to``), as tpurt replicates them. A position's work is enqueued
in mesh order and its result stays on its device until every position
of this process is done; the flat driver reads each launch's segment
count on the host (``megakernel.finish``), so positions on different
cards of one process run one after another.

Under a torch.distributed group of several processes (the CLI's
``--coordinator``; NCCL on the card, gloo on the CPU) each process
renders the positions it owns, the blocks are all-gathered so that every
process holds the frame, and the segment counts are all-reduced.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpurt_torch.config import RenderConfig
from tpurt_torch.core.camera import Camera
from tpurt_torch.parallel.mesh import (
    SAMPLE_AXIS, TILE_AXIS, Mesh, make_mesh, process_rank)
from tpurt_torch.render.renderer import (
    render_batch_flat, render_tile_with_stats)
from tpurt_torch.scene.types import Scene

Position = Tuple[int, int]


def _padded_rows(height: int, n_tile: int) -> int:
    return -(-height // n_tile) * n_tile


def _device(d) -> torch.device:
    """``d`` with its CUDA index made explicit (a scene's device has one)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _shares(scene: Scene, camera: Camera, mesh: Mesh, rank: int, render):
    """({(ti, si): share} and the summed segment count) over this
    process's positions in mesh order, ``render(scene, camera, ti, si)``
    giving each position's (share on its device, segments). Each device
    gets the scene and camera once: the caller's own where they already
    live there, else a copy."""
    replicas = {}
    shares, segs = {}, 0
    t, s = mesh.devices.shape
    for ti in range(t):
        for si in range(s):
            if mesh.ranks[ti, si] != rank:
                continue
            d = _device(mesh.devices[ti, si])
            if d not in replicas:
                replicas[d] = ((scene, camera) if d == scene.device else
                               (scene.to(d), Camera(params=camera.params.to(d))))
            shares[(ti, si)], n = render(*replicas[d], ti, si)
            segs += n
    return shares, segs


def _gather(shares: Dict[Position, torch.Tensor], segs: int, mesh: Mesh,
            rank: int, world: int, shape):
    """Every position's share on every process (torch.distributed
    all_gather of each process's shares, padded to the most positions a
    process owns) and the segments summed over the processes
    (all_reduce). NCCL moves tensors on this process's card, gloo on the
    CPU."""
    dist = torch.distributed
    comm = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))
    t, s = mesh.devices.shape
    owned = [[(ti, si) for ti in range(t) for si in range(s)
              if mesh.ranks[ti, si] == r] for r in range(world)]
    rows = max(len(o) for o in owned)
    mine = torch.zeros((rows,) + tuple(shape), dtype=torch.float32, device=comm)
    for i, pos in enumerate(owned[rank]):
        mine[i] = shares[pos].to(comm)
    got = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(got, mine)
    total = torch.tensor([segs], dtype=torch.int64, device=comm)
    dist.all_reduce(total)
    return ({pos: got[r][i] for r in range(world)
             for i, pos in enumerate(owned[r])}, int(total.item()))


def _assemble(shares: Dict[Position, torch.Tensor], n_tile: int,
              n_sample: int) -> np.ndarray:
    """(n_tile, ...) per tile position: its sample positions' means
    summed in si order, over n_sample when above 1."""
    out = []
    for ti in range(n_tile):
        acc = shares[(ti, 0)].cpu().numpy()
        for si in range(1, n_sample):
            acc = acc + shares[(ti, si)].cpu().numpy()
        if n_sample > 1:
            acc = acc / np.float32(n_sample)
        out.append(acc)
    return np.stack(out)


def render_frame_sharded(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    frame_index: int = 0,
    mesh: Optional[Mesh] = None,
    overdecompose: int = 1,
    stats: Optional[dict] = None,
    replicate_out: Optional[bool] = None,
) -> np.ndarray:
    """Full-frame mean radiance (H, W, 3) float32 on the host, over the
    device mesh (default: every CUDA device on the tile axis).

    With the megakernel's flat path (``rays_per_batch > 0`` and bounces)
    the frame renders in flat launches per pixel block, bit for bit the
    single-device frame for any tile decomposition. ``overdecompose=k``
    gives each tile-axis position k round-robin pixel blocks instead of
    one (load balance for non-uniform scenes; flat path only).
    ``stats`` (dict) receives {"segments": N} on the flat path.

    ``replicate_out``: gather the frame onto every process of the
    torch.distributed group (default: when the group has several
    processes, which it requires; True under a one-process group runs
    the same collectives).
    """
    mesh = mesh or make_mesh()
    n_tile = mesh.shape[TILE_AXIS]
    n_sample = mesh.shape[SAMPLE_AXIS]
    if n_sample > 1 and cfg.seed_mode != "decorrelated":
        raise ValueError(
            "sample-axis sharding needs seed_mode='decorrelated': the "
            "reference seed mode is a single sequential RNG stream per "
            "pixel (Trace.cl:639-642) and cannot be split across devices"
        )
    if cfg.rays_per_pixel % n_sample != 0:
        raise ValueError(
            f"rays_per_pixel={cfg.rays_per_pixel} not divisible by "
            f"sample axis size {n_sample}"
        )
    if overdecompose < 1:
        raise ValueError("overdecompose must be >= 1")
    rank, world = process_rank()
    gather = world > 1 if replicate_out is None else bool(replicate_out)
    if world > 1 and not gather:
        raise ValueError("a frame over several processes is gathered onto "
                         "every one (replicate_out=False refused)")
    if gather and not torch.distributed.is_initialized():
        raise ValueError("replicate_out needs an initialised "
                         "torch.distributed group")

    local_spp = cfg.rays_per_pixel // n_sample
    # Plain launches only, as tpurt's sharded paths run (its staged
    # driver needs host reads between a batch's stages).
    lcfg = cfg.replace(rays_per_pixel=local_spp, compaction_threshold=0)
    flat = (cfg.engine == "mega" and cfg.rays_per_batch > 0
            and cfg.max_bounces > 0)
    if flat:
        k = int(overdecompose)
        total = cfg.width * cfg.height
        nblocks = n_tile * k
        block_px = -(-total // nblocks)
        p = cfg.pixels_per_lane
        batch = min(cfg.rays_per_batch, -(-block_px // (256 * p)) * 256)
        launch_px = batch * p

        def render(sc, cam, ti, si):
            # Frame blocks ti, ti + n_tile, ...: each in launches of B
            # lanes from its first pixel, rows past the block cut off.
            blocks, segs = [], 0
            for j in range(k):
                base = (j * n_tile + ti) * block_px
                parts = []
                for q in range(-(-block_px // launch_px)):
                    mean, n, _trips = render_batch_flat(
                        sc, cam, lcfg, base + q * launch_px, frame_index,
                        sample_offset=si * local_spp, batch=batch)
                    parts.append(mean)
                    segs += n
                blocks.append(torch.cat(parts)[:block_px])
            return torch.stack(blocks), segs

        share_shape = (k, block_px, 3)
    else:
        if overdecompose != 1:
            raise ValueError(
                "overdecompose > 1 requires the mega engine's flat path"
            )
        rows_per_dev = _padded_rows(cfg.height, n_tile) // n_tile

        def render(sc, cam, ti, si):
            return render_tile_with_stats(
                sc, cam, lcfg, x0=0, y0=ti * rows_per_dev,
                tile_h=rows_per_dev, tile_w=cfg.width,
                frame_index=frame_index, sample_offset=si * local_spp)

        share_shape = (rows_per_dev, cfg.width, 3)
    shares, segs = _shares(scene, camera, mesh, rank, render)
    if gather:
        shares, segs = _gather(shares, segs, mesh, rank, world, share_shape)
    arr = _assemble(shares, n_tile, n_sample)
    if not flat:
        return arr.reshape(-1, cfg.width, 3)[: cfg.height]
    if stats is not None:
        stats["segments"] = segs
    # Position ti holds frame blocks ti, ti + n_tile, ...: row (ti, j) is
    # frame block j * n_tile + ti — reorder to frame-block order (j, ti).
    out = arr.transpose(1, 0, 2, 3).reshape(nblocks * block_px, 3)
    return out[:total].reshape(cfg.height, cfg.width, 3)
