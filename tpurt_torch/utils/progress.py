"""Progress/ETA reporting and throughput metrics (the port's copy of
tpurt/utils/progress.py, pure Python).

Matches the reference's live progress line — tiles done, percent,
elapsed ms and ETA = elapsed * (100/pct - 1) printed with an erase-line
escape (src/image.hpp:306-344,352-369) — and adds the Mrays/s metric the
benchmark harness records (rays = W*H*spp*average path length).
"""

from __future__ import annotations

import sys
import time


class ProgressReporter:
    def __init__(self, total: int, label: str = "tiles", stream=None, live: bool = True):
        self.total = total
        self.label = label
        self.stream = stream or sys.stderr
        self.live = live
        self.start = time.perf_counter()
        self.done = 0

    def __call__(self, done: int, total: int = None) -> None:
        self.done = done
        if total is not None:
            self.total = total
        elapsed_ms = (time.perf_counter() - self.start) * 1e3
        pct = 100.0 * done / max(self.total, 1)
        eta_ms = elapsed_ms * (100.0 / pct - 1.0) if pct > 0 else float("inf")
        prefix = "\033[2K\r" if self.live else ""
        suffix = "" if self.live else "\n"
        self.stream.write(
            f"{prefix}Finished {done}/{self.total} {self.label} "
            f"({pct:.2f}%) in {elapsed_ms:.0f}ms; eta {eta_ms:.0f}ms{suffix}"
        )
        self.stream.flush()

    def finish(self) -> float:
        """Returns elapsed seconds and terminates the live line."""
        if self.live:
            self.stream.write("\n")
        return time.perf_counter() - self.start


def mrays_per_second(
    width: int, height: int, spp: int, avg_path_length: float, seconds: float
) -> float:
    rays = width * height * spp * max(avg_path_length, 1.0)
    return rays / seconds / 1e6
