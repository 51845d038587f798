"""driver_host_ms_per_frame: the host's own work inside the program in
the profiler's stretch, divided by its frames: the self time of every
``tpurt.*`` span but the ``tpurt.sync.*`` ones (the blocking reads, in
which the host waits for the device). The device waits for this work
whenever its queue is empty. Layer: the flat and staged drivers
(render/renderer.py, render/megakernel.py). A program span; nothing
where the program has no such spans."""


def read(run):
    try:
        from tpurt_torch.utils import profiling

        spans = profiling.totals(traced=True)["spans"]
    except (ImportError, AttributeError):
        return None
    frames = len(run.profiled())
    own = [rec["self_s"] for name, rec in spans.items()
           if name.startswith("tpurt.") and not name.startswith("tpurt.sync.")]
    if not frames or not own:
        return None
    return sum(own) * 1e3 / frames
