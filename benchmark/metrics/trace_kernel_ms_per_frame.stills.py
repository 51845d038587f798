"""trace_kernel_ms_per_frame: device time of the ``megakernel`` kernels
(B1, and B2 inside its brute-force instantiation) in the profiler's
stretch, divided by the stretch's frames. Layer: kernels B1 / B2
(csrc/megakernel.cu, csrc/dense_sweep.cuh via render/mega_cuda.py)."""


def read(run):
    sm = run.summary
    frames = len(run.profiled())
    if sm is None or frames == 0 or sm.by_layer.get("megakernel", 0.0) <= 0:
        return None
    return sm.by_layer["megakernel"] * 1e3 / frames
