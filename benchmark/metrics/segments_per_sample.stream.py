"""segments_per_sample: the path segments kernel B1 completed in the
profiler's stretch (the program's ``b1.segments`` counter, the launches'
summed per-lane work, read with each launch's trips) over the stretch's
samples, frames x width x height x spp. Padding lanes' segments count.
Layer: kernels B1 / B2. A program counter; nothing where the program
keeps no such counter."""


def read(run):
    try:
        from tpurt_torch.utils import profiling

        counts = profiling.totals(traced=True)["counts"]
    except (ImportError, AttributeError):
        return None
    samples = (len(run.profiled()) * run.width * run.height
               * int(run.traffic["spp"]))
    if not samples or "b1.segments" not in counts:
        return None
    return counts["b1.segments"] / samples
