"""host_syncs_per_frame: blocking device-to-host reads the program made
in the profiler's stretch (its ``host_syncs`` counter, counted by
``tpurt_torch.utils.profiling.host_read`` while a profiler records),
divided by the stretch's frames. Layer: the flat and staged drivers
(render/renderer.py, render/megakernel.py). A program counter; nothing
where the program keeps no such counter."""


def read(run):
    try:
        from tpurt_torch.utils import profiling

        counts = profiling.totals(traced=True)["counts"]
    except (ImportError, AttributeError):
        return None
    frames = len(run.profiled())
    if not frames or "host_syncs" not in counts:
        return None
    return counts["host_syncs"] / frames
