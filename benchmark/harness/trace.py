"""What a traced run (``--trace 1``) records, all from the benchmark's own
files: host seconds per step of the program, from wrappers around its
methods (a copy of the program's ``StepTimer``), and a torch.profiler trace
of a steady stretch of whole recordings inside the window, reduced to the
device's busy time (the union of its kernel, copy and set intervals, a copy
of the program's ``_device_busy_ms``), its time by operation, and its idle
gaps labelled with the host step that was running.

The wrappers hold private methods of the program; where a later version
renames one, its label reads nothing and the metrics that read it are left
out of the result line.
"""

from __future__ import annotations

import importlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "bench."

# (module, attribute path, label): the host steps from the entry point down.
STEPS = (
    ("birdnet_tpu_torch.classifier", "Classifier.analyze_samples", "classifier"),
    ("birdnet_tpu_torch.classifier", "Classifier.embed_samples", "classifier"),
    ("birdnet_tpu_torch.compiler.stream", "StreamingEngine.analyze", "engine"),
    ("birdnet_tpu_torch.compiler.stream", "_Ring.stage", "stage"),
    ("birdnet_tpu_torch.compiler.stream", "_Ring.upload", "upload"),
    ("birdnet_tpu_torch.compiler.stream", "_TileProgram.run", "replay"),
    ("birdnet_tpu_torch.compiler.stream", "_wait", "wait"),
    ("birdnet_tpu_torch.compiler.stream", "StreamingEngine._drain", "drain"),
)


class Probe:
    """Wraps the program's steps to add up the host seconds and calls of
    each; while ``annotate`` is set, each step also runs inside a
    ``torch.profiler.record_function`` of its label. ``stage_wait`` is
    ``torch.cuda.Event.synchronize`` inside ``stage``: the wait for the
    slot's last upload. ``rows`` holds the tile size of the last replay."""

    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.annotate = False
        self.rows: Optional[int] = None
        self._inside_stage = False
        self._undo: List[tuple] = []

    def install(self) -> None:
        import torch

        for module, path, label in STEPS:
            try:
                owner = importlib.import_module(module)
                *outer, name = path.split(".")
                for part in outer:
                    owner = getattr(owner, part)
                self._wrap(owner, name, label)
            except (ImportError, AttributeError):
                continue
        self._wrap(torch.cuda.Event, "synchronize", "stage_wait")

    def uninstall(self) -> None:
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()

    def _wrap(self, owner, name: str, label: str) -> None:
        import torch

        orig = getattr(owner, name)
        probe = self

        def timed(*args, **kwargs):
            if label == "stage_wait" and not probe._inside_stage:
                return orig(*args, **kwargs)
            if label == "replay" and args:
                probe.rows = getattr(args[0], "tile", probe.rows)
            probe._inside_stage |= label == "stage"
            t0 = time.perf_counter()
            try:
                if probe.annotate:
                    with torch.profiler.record_function(PREFIX + label):
                        return orig(*args, **kwargs)
                return orig(*args, **kwargs)
            finally:
                probe.seconds[label] += time.perf_counter() - t0
                probe.calls[label] += 1
                if label == "stage":
                    probe._inside_stage = False

        self._undo.append((owner, name, orig))
        setattr(owner, name, timed)

    def snapshot(self) -> Dict[str, int]:
        return dict(self.calls)


def export_events(prof) -> list:
    """The chrome-trace events of a finished profiler, through a file in
    the run's temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def union_us(spans) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy


def merged(spans) -> List[tuple]:
    out = []
    for s, t in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


class Stretch:
    """A profiled stretch of whole calls, reduced.

    ``window_s`` runs from the first call's start to the last call's end
    (the ``bench.call`` annotations the window loop makes); ``busy_s`` is
    the union of device intervals inside it."""

    def __init__(self, events: list):
        calls = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("ph") == "X" and e.get("name") == PREFIX + "call"]
        if not calls:
            raise ValueError("the trace holds no bench.call span")
        lo, hi = min(s for s, _ in calls), max(t for _, t in calls)
        self.lo, self.hi = lo, hi
        self.device = [e for e in events if e.get("ph") == "X"
                       and e.get("cat") in DEVICE_CATEGORIES
                       and e["ts"] < hi and e["ts"] + e["dur"] > lo]
        self.host = [(e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):]) for e in events
                     if e.get("ph") == "X" and str(e.get("name", "")).startswith(PREFIX)]
        spans = [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in self.device]
        self.window_s = (hi - lo) / 1e6
        self.busy_s = union_us(spans) / 1e6
        self._spans = spans

    def kernel_s(self, *names: str, category: str = "kernel") -> float:
        """Device seconds of the operations whose name holds any of
        ``names`` (every operation of ``category`` when none is given)."""
        return sum(e["dur"] for e in self.device if e.get("cat") == category
                   and (not names or any(n in e["name"] for n in names))) / 1e6

    def device_ops(self, top: int = 10) -> List[list]:
        by_name = defaultdict(float)
        for e in self.device:
            by_name[e["name"][:120]] += e["dur"] / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle seconds of the device inside the stretch, split by the
        innermost host step running (the latest started, then the
        shortest), summed by step."""
        busy = merged(self._spans)
        edges = [self.lo] + [x for span in busy for x in span] + [self.hi]
        by_step = defaultdict(float)
        for s, t in zip(edges[0::2], edges[1::2]):
            cuts = sorted({s, t, *(x for a, b, _ in self.host for x in (a, b) if s < x < t)})
            for a, b in zip(cuts, cuts[1:]):
                mid = (a + b) / 2
                inside = [(-h0, h1, label) for h0, h1, label in self.host if h0 <= mid <= h1]
                label = min(inside)[2] if inside else "between calls"
                by_step[label] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by_step.items(), key=lambda kv: -kv[1])[:top]]
