"""present_ms_per_frame: device time of the tonemap's kernels (launched
in the benchmark's ``present`` span, which also wraps the renderer's
tonemap in the trace run) and of the frames' copies to the host (at
least 64 KiB each), in the profiler's stretch, divided by its frames.
Layer: tonemap and copy to the host (render/tonemap.py)."""


def read(run):
    sm = run.summary
    frames = len(run.profiled())
    if sm is None or frames == 0 or sm.by_layer.get("present", 0.0) <= 0:
        return None
    return sm.by_layer["present"] * 1e3 / frames
