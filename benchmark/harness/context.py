"""What a metric's reader reads: the window's calls on the host clock and,
in a traced run, the probe's host seconds and the profiled stretch. Every
metric is read by a file ``benchmark/metrics/<reader>.py`` with
``read(ctx)``, where ``<reader>`` is the metric's name up to its first dot
(``b2_roofline_pct.embed`` is read by ``b2_roofline_pct.py``: one quantity
split by the end-to-end metric it moves). A reader returns a number or None
where it finds nothing to read; the harness leaves a None out of the
result line."""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class Window:
    seconds: float            # first call's start to the last call's return
    latencies_s: List[float]  # every recording's call, in order
    segments: int             # segments of the recordings completed
    setup_s: float            # process start to the first timed call
    peak_bytes: int           # torch.cuda.max_memory_allocated() at the close
    gc_pause_s: float = 0.0   # seconds in the cyclic collector inside the window


@dataclass
class Traced:
    probe_seconds: Dict[str, float]   # host seconds per step, whole window
    probe_calls: Dict[str, int]       # calls per step, whole window
    stretch: object                   # harness.trace.Stretch
    stretch_calls: Dict[str, int]     # calls per step inside the stretch
    stretch_segments: int             # segments of the stretch's recordings
    rows: Optional[int]               # segments per tile of the last replay
    flops_per_segment: float          # the forward's operations per segment


@dataclass
class Context:
    cfg: dict
    traffic: dict
    window: Window
    traced: Optional[Traced] = None


def read(names: List[str], ctx: Context) -> Dict[str, float]:
    out = {}
    for name in names:
        reader = name.split(".", 1)[0]
        value = importlib.import_module(f"benchmark.metrics.{reader}").read(ctx)
        if value is not None:
            out[name] = float(value)
    return out
