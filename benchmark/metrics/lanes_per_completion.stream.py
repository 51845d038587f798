"""lanes_per_completion: the lanes that kernel B1 runs a path segment's
completion for together, on average, in the profiler's stretch: the
program's ``b1.segments`` over its ``b1.completion_warps``, the groups
of a warp's threads that ran a completion together (each completing
lane counted in one group), so 1 to 32. Layer: kernels B1 / B2. A
program counter; nothing where the program keeps no such counter."""


def read(run):
    try:
        from tpurt_torch.utils import profiling

        counts = profiling.totals(traced=True)["counts"]
    except (ImportError, AttributeError):
        return None
    groups = counts.get("b1.completion_warps", 0)
    if not run.profiled() or not groups or "b1.segments" not in counts:
        return None
    return counts["b1.segments"] / groups
