"""prepare_ms_per_frame: host time of the program's ``tpurt.prepare``
spans (megakernel.prepare: chain and root tables, the dense table, quota
slot tables, fresh lanes) in the profiler's stretch, divided by the
stretch's frames. Layer: the flat and staged drivers (render/renderer.py,
render/megakernel.py). A program span; nothing where the program has no
such span."""


def read(run):
    try:
        from tpurt_torch.utils import profiling

        spans = profiling.totals(traced=True)["spans"]
    except (ImportError, AttributeError):
        return None
    frames = len(run.profiled())
    if not frames or "tpurt.prepare" not in spans:
        return None
    return spans["tpurt.prepare"]["total_s"] * 1e3 / frames
