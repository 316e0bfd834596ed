"""The result line: its keys and their order, the metrics a cell reports
with the units ``BENCHMARK.json`` gives, and the command's refusals without
a card."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark.harness import cell, spec
from benchmark.tests.small import small_cell

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("workload", ["v24_stream_1h", "perch_embed_1h", "v24_stream_10min"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(workload, trace):
    c = small_cell(workload)
    r = cell.run(workload, 7, 0.3, trace, time.perf_counter(), device="cpu", cell=c)
    json.dumps(r)
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert isinstance(r["correct"], bool) and r["attempted"] >= 1 and r["failed"] == 0
    dev = r["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    units = spec.units(spec.load(workload))
    wanted = {m["name"] for m in spec.load(workload).metrics(trace)}
    assert set(r["metrics"]) <= wanted and r["metrics"]
    for name, m in r["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
    if trace:
        assert {"busy_s", "window_s"} <= set(dev) and dev["window_s"] > 0
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in r["breakdown"].values())
    else:
        assert "setup_s" in r["metrics"] and "breakdown" not in r
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


def _run_command(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "v24_stream_1h",
                           "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run_command(ROOT, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run_command(tmp_path, env)
    assert out.returncode != 0 and out.stdout.strip() == ""
