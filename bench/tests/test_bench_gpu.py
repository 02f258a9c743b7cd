"""The command on the card: a short run of the cheapest cell prints a
correct result line.  Card only: skips here without one.

    python -m pytest -q -m gpu bench/tests/test_bench_gpu.py
"""
import json
import subprocess
import sys

import pytest

from bench_tiny import ROOT


@pytest.mark.gpu
def test_command_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "paper-usecase.sweep",
         "--seed", str(2**31 + 5), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["metrics"]["sims_per_s"]["value"] > 0
