"""The comparison that decides ``correct``: the answers the timed path
served for a seeded sample of the window's recordings and segments,
against the plain reference run on the same raw int16 samples with the
same weights, at float32 with TF32 off, once the program is freed.

The call's module reads each sampled row against the reference and turns
the rows into the numbers compared: percentiles and maxima, and the share
of rows whose reading passes the configuration's per-row limit
(``row_limits``), which catches a fault confined to a few rows (one tile
slot, each recording's last segment) that a percentile lets through. Each
number is held to the limit the configuration gives it (``limits``); a
number without a limit, or one that is not finite, fails.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np
import torch

# Segments per reference forward: bounds the reference's device memory.
BLOCK = 64


def reference_module(cfg: dict):
    return importlib.import_module(f"benchmark.reference.{cfg['reference']}")


def compare(cfg: dict, weights: Dict[str, np.ndarray], kept: List[tuple], recordings,
            call, device) -> Dict[str, np.ndarray]:
    """The call's per-row readings over the rows of every kept recording's
    sample (reading name -> array). ``kept``: (recording samples, served
    answers) pairs."""
    ref = reference_module(cfg)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows: Dict[str, list] = {}
    try:
        w = {k: torch.from_numpy(v).to(device) for k, v in weights.items()}
        for recording, answer in kept:
            idx = recordings.sample()
            got = call.served(answer, idx, cfg)
            pcm = recordings.segments(recording, idx, cfg["sample_count"])
            outs = []
            with torch.inference_mode():
                for lo in range(0, len(idx), BLOCK):
                    x = torch.from_numpy(pcm[lo:lo + BLOCK]).to(device)
                    outs.append({k: v.cpu().numpy() for k, v in ref.forward(cfg, w, x).items()})
            want = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
            for name, value in call.compare(got, want, cfg).items():
                rows.setdefault(name, []).append(value)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {k: np.concatenate(v) for k, v in rows.items()}


def share_over(values: np.ndarray, limit: float) -> float:
    """The share of rows whose reading is over ``limit`` (or not finite)."""
    values = np.nan_to_num(values, nan=np.inf)
    return float(np.mean(values > limit))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """name -> {"value", "limit", "ok"} for every number compared."""
    out = {}
    for name, value in numbers.items():
        limit = limits.get(name)
        ok = limit is not None and np.isfinite(value) and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    return out
