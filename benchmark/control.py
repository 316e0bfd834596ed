"""Readings of the comparison that decides ``correct``, at a cell's own
size on the card, several seeds in one process: the program as the
configuration states it (``--mode sound``) or with its int8 path switched
on (``--mode int8``), the control that the check has to refuse.

    python benchmark/control.py --workload <name> --mode int8 --seeds 1 2 3 \
        [--seconds 5] [--check-every 4] [--rows-out rows.jsonl]

One JSON line per seed: the numbers compared, their limits, ``correct``,
and the largest and 99th-percentile per-row readings. ``--check-every``
keeps more of a short window's recordings for the check, so that it
compares as many rows as a run of the cell's full window does;
``--rows-out`` appends every compared row's readings, one seed a line, to
set the per-row limits from.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("sound", "int8"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--check-every", type=int, default=None)
    ap.add_argument("--rows-out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import numpy as np

    from benchmark.harness import cell, spec

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    c = spec.load(args.workload)
    if args.check_every:
        c.traffic["check_every"] = args.check_every
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = cell.run(args.workload, seed, args.seconds, False, t0, cell=c,
                     int8=args.mode == "int8", keep_rows=True)
        rows = {k: np.nan_to_num(np.asarray(v), nan=np.inf) for k, v in r["rows"].items()}
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "failed": r["failed"], "checks": r["checks"],
                          "rows": {k: {"n": int(v.size), "max": float(v.max()),
                                       "p99": float(np.percentile(v, 99))}
                                   for k, v in rows.items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
        if args.rows_out:
            with open(args.rows_out, "a") as f:
                f.write(json.dumps({"workload": args.workload, "mode": args.mode,
                                    "seed": seed, "rows": r["rows"]}) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
