"""box_tests_per_segment: the child-box tests kernel B1 made in node
rows in the profiler's stretch over the path segments it completed
(the program's ``b1.box_tests`` and ``b1.segments`` counters). Layer:
kernels B1 / B2. A program counter; nothing where the program keeps no
such counter."""


def read(run):
    try:
        from tpurt_torch.utils import profiling

        counts = profiling.totals(traced=True)["counts"]
    except (ImportError, AttributeError):
        return None
    segs = counts.get("b1.segments", 0)
    if not run.profiled() or not segs or "b1.box_tests" not in counts:
        return None
    return counts["b1.box_tests"] / segs
