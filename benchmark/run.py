"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (its configuration, traffic mix and metrics) is read from
``BENCHMARK.json`` at the root of the checkout. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``checks``: each number compared beside its limit, which also close
standard error. Without a CUDA card, or with fewer cards than the cell
asks for, or if the run loaded JAX or the JAX package, it prints no result
and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # Every build and kernel cache at a fixed path inside the checkout.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness import guard, spec

    chips = spec.load(args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = cells.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    found = guard.forbidden_modules()
    if found:
        print(f"the run loaded JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
