"""Run one cell several times, each run its own process as the check runs
it, and report every run's result and the spread of each metric.

    python benchmark/sweep.py --workload <name> --seeds 11 12 13 [--seconds 30]
        [--trace 0] [--out .bench_cache/sweep.jsonl]

Each run is ``python3 benchmark/run.py --workload ... --seed <s>``; its
result line, exit code, seconds and the end of its standard error go to
``--out``, one JSON object a line. Then one line per metric: the median,
the quartiles (``statistics.quantiles(values, n=4)``) and the spread, the
distance between the quartiles over the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return {"median": med, "q1": q1, "q3": q3, "spread": (q3 - q1) / med if med else None}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float,
                    default=json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"])
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / ".bench_cache" / "sweep.jsonl"))
    args = ap.parse_args()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    values = {}
    with out.open("a") as log:
        for seed in args.seeds:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", args.workload,
                 "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)],
                cwd=ROOT, capture_output=True, text=True)
            lines = proc.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                result = None
            rec = {"workload": args.workload, "seed": seed, "trace": args.trace,
                   "rc": proc.returncode, "wall_s": time.perf_counter() - t0,
                   "result": result, "stderr_tail": proc.stderr[-2000:]}
            log.write(json.dumps(rec) + "\n")
            log.flush()
            brief = ({k: v["value"] for k, v in result["metrics"].items()} if result else None)
            print(json.dumps({"seed": seed, "rc": rec["rc"], "wall_s": round(rec["wall_s"], 1),
                              "correct": result and result["correct"], "metrics": brief,
                              "window": result and result.get("window"),
                              "checks": result and result["checks"]}), flush=True)
            if result:
                for k, v in result["metrics"].items():
                    values.setdefault(k, []).append(v["value"])
    for k, vs in values.items():
        print(json.dumps({"metric": k, "n": len(vs), **(spread(vs) or {})}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
