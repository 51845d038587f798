"""On the card: one short run of each cell through ``benchmark/run.py``,
as the benchmark's own command runs it, with ``correct`` true and the
result line's keys. Skips without a CUDA device (decided in the test).

    python -m pytest benchmark/tests/test_yardstick_cuda.py -q --noconftest
"""

import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "3405691582", "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["check"]
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert res["device"]["busy_s"] > 0
