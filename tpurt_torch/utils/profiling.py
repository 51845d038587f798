"""Spans and counters of the frame path, and the device trace.

The registry:

- ``span(name, **ids)`` times a block on the host clock
  (``time.perf_counter_ns``) into an aggregate by name: calls, total
  time, and self time (the total less the part its child spans cover,
  on a per-thread stack). While a torch.profiler records
  (``torch.autograd._profiler_enabled()``) it also opens
  ``torch.profiler.record_function(name)``, so the span sits in the
  profiler's timeline, on the clock of CUPTI's kernels and copies, with
  its parent given by nesting, and it adds to a second aggregate, the
  traced view, which holds only what ran while a profiler recorded. Its
  ``ids`` (frame index, batch start, stage kind or width) become the
  span's args in ``device_trace``'s Chrome trace.
- ``count(name, n)`` follows the same two rules.
- ``host_read(t, site)`` is the frame path's one way to read a device
  tensor back: inside a span ``tpurt.sync.<site>``, counting
  ``host_syncs`` for every read that copies at least one element.
- ``totals``, ``reset`` and ``report`` give the aggregates and the
  operator's text summary; ``idle_by_span`` splits a trace's device-idle
  time by the innermost ``tpurt.*`` span around it.

A span never synchronises, records no CUDA event and moves no read: its
time is the host's, and the device's comes from the trace. With no
profiler recording it costs one flag check and two clock reads.

``device_trace`` is the operator's switch: while it records, spans go
to its Chrome trace (``<log_dir>/trace.json``) and to the traced view.
The span and counter names are listed in README.md.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import threading
from time import perf_counter_ns
from typing import Dict, List, Optional

import torch

_profiler_enabled = torch.autograd._profiler_enabled

#: Prefix of every span of the program; the sync spans' own prefix.
PREFIX = "tpurt."
SYNC = "tpurt.sync."
#: Device activity in a Chrome trace: kernels, copies, memsets.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_LOCK = threading.Lock()
#: Most traced spans whose ids are kept for the Chrome trace's args.
_IDS_MAX = 1 << 17
#: (name, ids) of each span with ids opened while a profiler recorded,
#: in order.
_IDS: List[tuple] = []
#: Every thread's aggregates, merged when read.
_AGGS: list = []


class _Agg:
    """One thread's aggregates, so that a span takes no lock: {name:
    [calls, total ns, self ns]} and {name: count}, for all spans and for
    the traced ones."""

    __slots__ = ("spans", "counts", "traced_spans", "traced_counts")

    def __init__(self) -> None:
        self.spans: Dict[str, list] = {}
        self.counts: Dict[str, int] = {}
        self.traced_spans: Dict[str, list] = {}
        self.traced_counts: Dict[str, int] = {}


class _Local(threading.local):
    """A thread's span stack and aggregates."""

    def __init__(self) -> None:
        self.stack: list = []
        self.agg = _Agg()
        with _LOCK:
            _AGGS.append(self.agg)


_TLS = _Local()


def _add(spans: dict, name: str, total: int, self_ns: int) -> None:
    rec = spans.get(name)
    if rec is None:
        spans[name] = [1, total, self_ns]
    else:
        rec[0] += 1
        rec[1] += total
        rec[2] += self_ns


class span:
    """``with span("tpurt.prepare"):`` — see the module's docstring."""

    __slots__ = ("name", "ids", "_t0", "_child", "_rf")

    def __init__(self, name: str, **ids) -> None:
        self.name = name
        self.ids = ids

    def __enter__(self) -> "span":
        if _profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
            if self.ids and len(_IDS) < _IDS_MAX:
                _IDS.append((self.name, self.ids))
        else:
            self._rf = None
        _TLS.stack.append(self)
        self._child = 0
        self._t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        dt = perf_counter_ns() - self._t0
        loc = _TLS
        stack = loc.stack
        stack.pop()
        if stack:
            stack[-1]._child += dt
        agg = loc.agg
        _add(agg.spans, self.name, dt, dt - self._child)
        rf = self._rf
        if rf is not None:
            _add(agg.traced_spans, self.name, dt, dt - self._child)
            self._rf = None
            rf.__exit__(*exc)
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (and to its traced view while a
    profiler records)."""
    agg = _TLS.agg
    agg.counts[name] = agg.counts.get(name, 0) + n
    if _profiler_enabled():
        agg.traced_counts[name] = agg.traced_counts.get(name, 0) + n


def host_read(t: torch.Tensor, site: str, to=None):
    """``t`` read back to the host inside the span ``tpurt.sync.<site>``:
    ``t.cpu()``, or with ``to`` = int or bool that scalar of a one-element
    ``t``. Counts ``host_syncs`` when ``t`` has an element to copy (on a
    CPU tensor too: the read the card would wait for)."""
    with span(SYNC + site):
        if t.numel():
            count("host_syncs")
        return t.cpu() if to is None else to(t)


def totals(traced: bool = False) -> dict:
    """{"spans": {name: {"calls", "total_s", "self_s"}}, "counts": {name:
    n}}: the whole process's aggregates, every thread's, or with
    ``traced`` only what ran while a profiler recorded."""
    spans: Dict[str, list] = {}
    counts: Dict[str, int] = {}
    with _LOCK:
        aggs = list(_AGGS)
    for agg in aggs:
        for name, rec in list((agg.traced_spans if traced else agg.spans).items()):
            acc = spans.setdefault(name, [0, 0, 0])
            for i in range(3):
                acc[i] += rec[i]
        for name, n in list((agg.traced_counts if traced else agg.counts).items()):
            counts[name] = counts.get(name, 0) + n
    return {"spans": {name: {"calls": c, "total_s": t * 1e-9, "self_s": s * 1e-9}
                      for name, (c, t, s) in spans.items()},
            "counts": counts}


def reset() -> None:
    """Empty the aggregates of every thread."""
    with _LOCK:
        for agg in _AGGS:
            for d in (agg.spans, agg.counts, agg.traced_spans,
                      agg.traced_counts):
                d.clear()
        _IDS.clear()


def report() -> str:
    """The whole process's aggregates as text: spans by self time, then
    the counters."""
    tot = totals()
    lines = [f"{'span':<28} {'calls':>7} {'self ms':>11} {'total ms':>11}"]
    for name, rec in sorted(tot["spans"].items(),
                            key=lambda kv: -kv[1]["self_s"]):
        lines.append(f"{name:<28} {rec['calls']:>7} "
                     f"{rec['self_s'] * 1e3:>11.3f} {rec['total_s'] * 1e3:>11.3f}")
    for name, n in sorted(tot["counts"].items()):
        lines.append(f"{name:<28} {n:>7}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Chrome traces
# ---------------------------------------------------------------------------


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_by_span(events: List[dict], within: Optional[str] = None
                 ) -> Dict[str, float]:
    """Device-idle seconds (no kernel, copy or memset running) by the
    innermost ``tpurt.*`` span around them, ``"outside"`` for idle time
    in none. ``events``: a Chrome trace's ``traceEvents``. Counted over
    the spans named ``within`` where given, else from the trace's first
    event to its last."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if not xs:
        return {}

    def ends(e):
        ts = float(e["ts"])
        return ts, ts + float(e["dur"])

    busy = _union([ends(e) for e in xs if e.get("cat") in DEVICE_CATS])
    annotations = [e for e in xs if e.get("cat") == "user_annotation"]
    if within is None:
        windows = [[min(ends(e)[0] for e in xs), max(ends(e)[1] for e in xs)]]
    else:
        windows = _union([ends(e) for e in annotations
                          if e.get("name") == within])
    # Idle = windows less busy.
    busy_ends = [d for _, d in busy]
    idle = []
    for a, b in windows:
        t = a
        for c, d in busy[bisect.bisect_left(busy_ends, a):]:
            if c >= b:
                break
            if c > t:
                idle.append((t, c))
            t = max(t, d)
        if t < b:
            idle.append((t, b))
    spans = sorted((ends(e) + (e["name"],) for e in annotations
                    if e.get("name", "").startswith(PREFIX)))
    cuts = sorted({t for s in spans for t in s[:2]})
    out: Dict[str, float] = {}
    active: list = []
    nxt = 0
    for a, b in idle:
        pts = [a] + cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)] + [b]
        for p, q in zip(pts, pts[1:]):
            mid = 0.5 * (p + q)
            while nxt < len(spans) and spans[nxt][0] <= mid:
                active.append(spans[nxt])
                nxt += 1
            active = [s for s in active if s[1] > mid]
            name = (max(active, key=lambda s: (s[0], -s[1]))[2] if active
                    else "outside")
            out[name] = out.get(name, 0.0) + (q - p) * 1e-6
    return out


def _annotate(path: str, ids: List[tuple]) -> None:
    """Write each traced span's ids into its Chrome trace event's args,
    the k-th event of a name taking the k-th ids of that name."""
    with open(path) as f:
        trace = json.load(f)
    by_name: Dict[str, list] = {}
    for name, kw in ids:
        by_name.setdefault(name, []).append(kw)
    seen: Dict[str, int] = {}
    evs = sorted((e for e in trace.get("traceEvents", [])
                  if e.get("cat") == "user_annotation" and e.get("ph") == "X"
                  and e.get("name") in by_name),
                 key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
    for e in evs:
        k = seen.get(e["name"], 0)
        seen[e["name"]] = k + 1
        kws = by_name[e["name"]]
        if k < len(kws) and kws[k]:
            e.setdefault("args", {}).update(kws[k])
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def device_trace(log_dir: str = "tpurt-trace", device="cuda"):
    """Capture a torch.profiler trace of the enclosed block — CPU
    activity, and CUDA activity unless ``device`` is the CPU — written to
    ``log_dir/trace.json`` with the program's spans and their ids; yields
    the profiler (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with _LOCK:
        _IDS.clear()
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with _LOCK:
        ids = list(_IDS)
        _IDS.clear()
    _annotate(path, ids)


def trace_events(log_dir: str) -> List[dict]:
    """The ``traceEvents`` of ``device_trace``'s trace in ``log_dir``."""
    with open(os.path.join(log_dir, "trace.json")) as f:
        return json.load(f)["traceEvents"]
