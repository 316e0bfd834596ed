"""On the card: every cell of ``BENCHMARK.json`` runs through the command
for a short window and comes out correct.

    python -m pytest benchmark/tests -q -m cuda
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU tests drive the rest of a run")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                          "--seed", str(2**31 + 77), "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert result["device"]["busy_s"] > 0
