"""device_idle_pct: the share of the profiler's stretch in which no
kernel, copy or memset runs on the card. Layer: the device. Read from
the device trace; nothing where the trace holds no device activity."""


def read(run):
    sm = run.summary
    if sm is None or sm.busy_s <= 0 or sm.window_s <= 0:
        return None
    return 100.0 * (sm.window_s - sm.busy_s) / sm.window_s
