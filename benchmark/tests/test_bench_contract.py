"""BENCHMARK.json keeps to its format: names, units, keys, the metrics
every cell reports, and a file for every configuration, traffic mix and
metric it names."""

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    assert all(_line(w) for w in SPEC["command"]) and len(SPEC["command"]) <= 32
    cells = len(SPEC["workloads"])
    # A full check: 2 + 14 runs a cell, each run_seconds + 60, each cell
    # 180 s of compiling, 1,200 s spare, all of it at 24 cells.
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024 and 1 <= cells <= 24


def test_configs_and_cells():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert _line(c["source"]) and _line(c["why"]) and c["file"].startswith("benchmark/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"] and all(k in body for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "channels")) for k in c["reduced"])
    used = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in configs and w["chips"] == 1
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
        used.add(w["config"])
    assert used == set(configs)
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(SPEC["workloads"])


def _applies(m, cell):
    return "workloads" not in m or cell in m["workloads"]


def test_metrics():
    e2e, layers = SPEC["end_to_end"], SPEC["per_layer"]
    names = [m["name"] for m in e2e + layers]
    assert len(names) == len(set(names))
    cells = [w["name"] for w in SPEC["workloads"]]
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and set(m.get("workloads", cells)) <= set(cells)
        reader = m["name"].split(".", 1)[0]
        assert (ROOT / "benchmark" / "metrics" / f"{reader}.py").exists()
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e_names = {m["name"] for m in e2e}
    assert "setup_s" in e2e_names
    for m in layers:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e_names
        if m["name"].endswith(("_roofline", "_roofline_pct")) or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = {m["name"] for m in e2e if _applies(m, cell)}
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in layers if _applies(m, cell)]
        assert layer and all(m["moves"] in reported for m in layer)
