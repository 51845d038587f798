"""Reduce the trace run's profiler window to what the per-layer metrics
read: device busy time, device time by layer, and the breakdown.

The profiler is the benchmark's own ``torch.profiler`` (CPU and CUDA
activity) over a stretch of whole requests, inside one ``stretch`` span;
``tpurt_torch/utils/profiling.py:22-35`` (``device_trace``) is the
program's copy of the same idea. Its Chrome trace is read back from a
temporary file, which is deleted.

Device activity is every kernel, copy and memset on the card. A kernel
belongs to a layer by its name (``megakernel``: kernels B1 and B2) or by
the benchmark span its launch was made in (``present``: the tonemap);
device-to-host copies of at least ``FRAME_COPY_BYTES`` are the frames'
copies to the host.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: Device-to-host copies at least this large carry frame pixels; smaller
#: ones are the drivers' count reads.
FRAME_COPY_BYTES = 1 << 16
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class Summary:
    window_s: float = 0.0
    busy_s: float = 0.0
    by_layer: Dict[str, float] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def chrome_events(prof) -> List[dict]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name: str) -> str:
    return name if len(name) <= 96 else name[:93] + "..."


def summarize(events: List[dict]) -> Optional[Summary]:
    """The stretch's busy time, device seconds by layer, the ten device
    operations that took most time and the ten longest idle gaps, each
    named after what the host was doing then. None without a stretch."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    stretch = [e for e in xs if e.get("cat") == "user_annotation"
               and e.get("name") == "stretch"]
    if not stretch:
        return None
    s0 = float(stretch[0]["ts"])
    s1 = s0 + float(stretch[0]["dur"])
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and float(e["ts"]) < s1 and float(e["ts"]) + float(e["dur"]) > s0]
    host = [e for e in xs if e.get("cat") in HOST_CATS]
    spans = [e for e in host if e.get("cat") == "user_annotation"]
    launch_ts = {}
    for e in host:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
            launch_ts[corr] = float(e["ts"])

    present = sorted((float(s["ts"]), float(s["ts"]) + float(s["dur"]))
                     for s in spans if s.get("name") == "present")
    starts = [a for a, _ in present]

    def in_present(ts: float) -> bool:
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= present[i][1]

    sm = Summary(window_s=(s1 - s0) * 1e-6)
    clipped = [(max(float(e["ts"]), s0), min(float(e["ts"]) + float(e["dur"]), s1))
               for e in dev]
    busy = _union(clipped)
    sm.busy_s = sum(b - a for a, b in busy) * 1e-6
    by_layer: Dict[str, float] = {"megakernel": 0.0, "present": 0.0}
    per_op: Dict[str, float] = {}
    for e in dev:
        d = float(e["dur"]) * 1e-6
        name = e.get("name", "")
        per_op[_short(name)] = per_op.get(_short(name), 0.0) + d
        if e.get("cat") == "kernel" and "megakernel" in name:
            by_layer["megakernel"] += d
            continue
        corr = (e.get("args") or {}).get("correlation")
        ts = launch_ts.get(corr)
        copy_bytes = (e.get("args") or {}).get("bytes", 0) or 0
        if (e.get("cat") == "gpu_memcpy" and "DtoH" in name
                and copy_bytes >= FRAME_COPY_BYTES):
            by_layer["present"] += d
        elif e.get("cat") == "kernel" and ts is not None and in_present(ts):
            by_layer["present"] += d
    sm.by_layer = by_layer
    sm.device_ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    edges = [s0] + [x for ab in busy for x in ab] + [s1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda ab: -(ab[1] - ab[0]))
    sm.idle_gaps = [(_host_doing(host, spans, (a + b) / 2), (b - a) * 1e-6)
                    for a, b in gaps[:10]]
    return sm


def _host_doing(host: List[dict], spans: List[dict], t: float) -> str:
    """The benchmark span and the innermost host operation around ``t``."""
    def around(es):
        return [e for e in es if float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"])]

    outer = [e for e in around(spans) if e.get("name") not in ("stretch", "request")]
    inner = around(host)
    span_name = min(outer, key=lambda e: float(e["dur"]))["name"] if outer else "host"
    if not inner:
        return f"{span_name}: python"
    op = min(inner, key=lambda e: float(e["dur"]))["name"]
    return _short(f"{span_name}: {op}")
