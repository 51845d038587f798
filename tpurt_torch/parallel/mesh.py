"""Device inventory and device selection (port of the first half of
tpurt/parallel/mesh.py).

Replaces the reference's OpenCL platform/device discovery and the
user's comma-separated device pick (src/main.cpp:54-193) with the CUDA
devices torch sees. The mesh over several devices (``make_mesh``,
``mesh_info``) and the sharded renderers are ROADMAP A.6.
"""

from __future__ import annotations

from typing import List, Optional

import torch


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
