"""Device inventory, device selection and the device mesh (port of
tpurt/parallel/mesh.py).

Replaces the reference's OpenCL platform/device discovery and the
user's comma-separated device pick (src/main.cpp:54-193) with the CUDA
devices torch sees, and tpurt's jax Mesh with ``Mesh``: a (tile, sample)
grid of positions, each a torch device and the rank of the process that
owns it. Two logical axes, as tpurt's:

  * ``tile``   — image row blocks (static: tiles are near-uniform cost,
                 and over-decomposition spreads the rest);
  * ``sample`` — the samples-per-pixel axis, per-position means summed
                 (needs the decorrelated seed mode).

One device may fill several positions: the port's counterpart of the
virtual host devices tpurt's tests run on, through which the CPU and a
single card drive n-way decompositions. Under an initialised
``torch.distributed`` group of several processes, ``make_mesh`` spans
every process's devices.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

TILE_AXIS = "tile"
SAMPLE_AXIS = "sample"


def device_inventory(device="cuda") -> List[dict]:
    """The analog of the reference's startup device dump
    (main.cpp:79-140): one record per visible CUDA device (id, platform
    "gpu", kind, memory in GiB), or the one CPU for ``device="cpu"``.
    Without a CUDA device a CUDA inventory raises."""
    if torch.device(device).type == "cpu":
        return [{"id": 0, "platform": "cpu", "kind": "cpu", "process": 0}]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible (pass device='cpu', "
                           "or --cpu, to render on the CPU)")
    out = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        out.append({"id": i, "platform": "gpu", "kind": props.name,
                    "process": 0,
                    "memory_gb": round(props.total_memory / 2**30, 2)})
    return out


def select_devices(spec: Optional[str], device="cuda") -> List[torch.device]:
    """Resolve a comma-separated device-id list (the reference's
    interactive pick, main.cpp:159-193) to torch devices. ``None`` /
    "all" selects every device of the inventory; bad ids raise
    ValueError with the valid set listed."""
    by_id = {}
    for rec in device_inventory(device):
        by_id[rec["id"]] = (torch.device("cpu") if rec["platform"] == "cpu"
                            else torch.device("cuda", rec["id"]))
    if spec is None or str(spec).strip().lower() in ("", "all"):
        return list(by_id.values())
    picked = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        try:
            did = int(part)
        except ValueError:
            raise ValueError(
                f"device id {part!r} is not an integer; valid ids: "
                f"{sorted(by_id)}"
            )
        if did not in by_id:
            raise ValueError(
                f"no device with id {did}; valid ids: {sorted(by_id)}"
            )
        if by_id[did] in picked:
            raise ValueError(f"device id {did} given twice")
        picked.append(by_id[did])
    if not picked:
        raise ValueError("empty device list")
    return picked


def process_rank():
    """(this process's rank, the number of processes): those of the
    initialised torch.distributed group, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A (tile, sample) grid of positions: ``devices`` (object array of
    torch devices) and ``ranks`` (int array: the process that renders
    each position; a device of another process is that process's own
    name for it). ``shape`` maps each axis name to its size, as a jax
    Mesh's does."""

    def __init__(self, devices: np.ndarray, ranks: np.ndarray):
        if devices.ndim != 2 or ranks.shape != devices.shape:
            raise ValueError("a mesh is a (tile, sample) grid of devices "
                             "with a rank for each")
        self.devices = devices
        self.ranks = ranks

    @property
    def shape(self) -> dict:
        t, s = self.devices.shape
        return {TILE_AXIS: t, SAMPLE_AXIS: s}


def make_mesh(
    tile_devices: Optional[int] = None,
    sample_devices: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (tile, sample) mesh over ``devices`` (default: every CUDA
    device), row-major; the tile axis defaults to all of them. A device
    listed twice fills two positions. Under a group of several processes
    ``devices`` are this process's, and the mesh lists every process's in
    rank order (each process passes its own)."""
    local = [torch.device(d) for d in
             (devices if devices is not None else select_devices(None))]
    if not local:
        raise ValueError("a mesh needs at least one device")
    rank, world = process_rank()
    if world == 1:
        positions = [(rank, d) for d in local]
    else:
        names = [None] * world
        torch.distributed.all_gather_object(names, [str(d) for d in local])
        positions = [(r, torch.device(d)) for r, ds in enumerate(names)
                     for d in ds]
    n = len(positions)
    if tile_devices is None:
        tile_devices = n // sample_devices
    if tile_devices * sample_devices != n:
        raise ValueError(
            f"{tile_devices} x {sample_devices} != {n} devices"
        )
    grid = np.empty(n, dtype=object)
    grid[:] = [d for _r, d in positions]
    ranks = np.asarray([r for r, _d in positions], np.int64)
    shape = (tile_devices, sample_devices)
    return Mesh(grid.reshape(shape), ranks.reshape(shape))


def mesh_info(mesh: Mesh) -> str:
    t, s = mesh.shape[TILE_AXIS], mesh.shape[SAMPLE_AXIS]
    return f"mesh {t}x{s} (tile x sample) over {t * s} devices"
