"""The benchmark of tpurt_torch: one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the CUDA devices the
cell asks for. See yardstick/runner.py for what it prints.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Kernel and build caches at fixed paths inside the checkout.
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = os.path.join(ROOT, "build", "benchmark", _sub)
sys.path[:0] = [HERE, ROOT]

from yardstick import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], runner.process_start(), ROOT, HERE))
