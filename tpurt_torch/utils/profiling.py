"""Profiling hooks (port of tpurt/utils/profiling.py).

The reference's only instrumentation is wall-clock around the tile loop
(src/image.hpp:283,316-323). Here: a context manager around
torch.profiler for a trace of the enclosed block (CPU and CUDA activity,
written as a Chrome trace for Perfetto), plus a phase timer that reads
CUDA events on the card and the host clock on the CPU. torch returns
before the card finishes, so ``materialize`` is the honest sync point.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import torch


@contextlib.contextmanager
def device_trace(log_dir: str = "tpurt-trace", device="cuda"):
    """Capture a torch.profiler trace of the enclosed block — CPU
    activity, and CUDA activity unless ``device`` is the CPU — written to
    ``log_dir/trace.json``; yields the profiler (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def materialize(tree) -> None:
    """Wait until every tensor in a nested tuple/list/dict is computed:
    the card's queue drains (torch.cuda.synchronize) when one of them
    lies on a CUDA device; CPU tensors are computed when torch returns."""
    devices = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulates time per named phase: CUDA events around the phase
    on a CUDA ``device`` (the card's time for the work the phase
    enqueued, host included), the host clock on the CPU.

    >>> t = PhaseTimer()
    >>> with t.phase("render"):
    ...     out = render_tile(...)
    >>> t.report()
    """

    def __init__(self, device="cuda") -> None:
        self.device = torch.device(device)
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        cuda = self.device.type == "cuda"
        if cuda:
            stream = torch.cuda.current_stream(self.device)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record(stream)
        else:
            t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                materialize(sync)
            if cuda:
                e1.record(stream)
                e1.synchronize()
                dt = e0.elapsed_time(e1) / 1e3
            else:
                dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> List[str]:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total, {n}x, {total/n*1e3:.1f}ms avg")
        return lines

    def __str__(self) -> str:
        return "\n".join(self.report())
