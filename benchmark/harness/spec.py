"""The cell a run measures, read from ``BENCHMARK.json`` and the files it
names: the workload's configuration, its traffic mix and the metrics that
apply to it. Nothing here names a cell: every cell is data."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    spec = json.loads(Path(benchmark).read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {benchmark}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(workload=w, config=config, traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, workload)])


def units(cell: Cell) -> Dict[str, str]:
    return {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
