"""lane_idle_pct: the share of kernel B1's lane-trip slots in the
profiler's stretch in which a lane had already finished: 100 x (1 -
``b1.lane_trips`` / ``b1.lane_trip_slots``), a launch's slots being its
lanes times the most trips a lane ran. B1's tail. Layer: kernels B1 /
B2. A program counter; nothing where the program keeps no such
counter."""


def read(run):
    try:
        from tpurt_torch.utils import profiling

        counts = profiling.totals(traced=True)["counts"]
    except (ImportError, AttributeError):
        return None
    slots = counts.get("b1.lane_trip_slots", 0)
    if not run.profiled() or not slots or "b1.lane_trips" not in counts:
        return None
    return 100.0 * (1.0 - counts["b1.lane_trips"] / slots)
