"""Profiling and phase timing.

The counterpart of :mod:`birdnet_tpu.utils.profiling` (the reference's
per-phase CLI timings and nvidia-smi sweep script, birdnet-analyze.rs:284-316,
scripts/README.md:20-46), on PyTorch:

- :func:`sync` — wait for the device work of every CUDA tensor in a tree;
- :class:`PhaseTimer` — named phase timings (init/build/read/chunk/batch);
- :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome/Perfetto trace of the host and CUDA activity into a directory
  (the CLI's ``--profile``);
- :func:`device_memory_stats` — the caching allocator's counters for a CUDA
  device (``torch.cuda.memory_stats``);
- :func:`card_description` — the card's name and power limit, as
  nvidia-smi gives them, for the line beside a measurement.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def sync(tree) -> None:
    """Wait until the device work producing every CUDA tensor in ``tree``
    (a tensor, or dicts, lists and tuples of them) is done: each device is
    synchronized once; host values are ready."""
    for device in {t.device for t in _leaves(tree)
                   if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(device)


@dataclass
class PhaseTimer:
    """Accumulates named phase durations; printable summary."""

    phases: Dict[str, float] = field(default_factory=dict)
    order: List[str] = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            if name not in self.phases:
                self.order.append(name)
                self.phases[name] = 0.0
            self.phases[name] += dt

    def summary(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{'phase':<24}{'seconds':>10}{'share':>8}"]
        for name in self.order:
            dt = self.phases[name]
            share = dt / total * 100 if total else 0.0
            lines.append(f"{name:<24}{dt:>10.3f}{share:>7.1f}%")
        lines.append(f"{'total':<24}{total:>10.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the host and, where CUDA is
    available, the CUDA activity, written to ``log_dir/trace.json`` (open
    with Perfetto or chrome://tracing) when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def card_description(device=None) -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    line for ``device`` (default the first card), or ``"cpu"`` for a host
    device. A card may run below its maximum power, and then slower under
    load, so every measurement keeps this beside it."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[device.index or 0]


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The CUDA caching allocator's counters for ``device`` (default: the
    current CUDA device), or None for a host device or without CUDA."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return dict(torch.cuda.memory_stats(device))
