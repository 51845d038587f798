"""setup_s: from the process's start to the first timed request: imports,
CUDA's start, the kernel libraries loaded (built on a checkout's first
run), the mesh read, the scene built on the device, the warm-up of the
cell's own shapes. Host clock."""


def read(run):
    return run.setup_s
