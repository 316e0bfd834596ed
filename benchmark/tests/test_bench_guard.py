"""The check that a run loaded neither JAX nor the JAX package compares
whole top-level names, and a run of a cell leaves none loaded."""

import json
import os
import subprocess
import sys
from pathlib import Path

from benchmark.harness.guard import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_whole_top_level_names():
    names = ["birdnet_tpu_torch", "birdnet_tpu_torch.compiler.stream", "jaxtyping",
             "flaxen", "numpy", "birdnet_tpu", "birdnet_tpu.ops", "jax.numpy", "jaxlib", "flax"]
    assert forbidden_modules(names) == sorted(
        ["birdnet_tpu", "birdnet_tpu.ops", "jax.numpy", "jaxlib", "flax"])


def test_a_small_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.tests.small import small_cell\n"
        "from benchmark.harness import cell, guard\n"
        "r = cell.run('v24_stream_1h', 1, 0.5, True, time.perf_counter(), device='cpu',\n"
        "             cell=small_cell('v24_stream_1h'))\n"
        "print(json.dumps(guard.forbidden_modules()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
