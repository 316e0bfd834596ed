"""The system under test, built through its normal path: the model file
written from the frozen generator and the seeded weights, then
``Classifier.builder().model_path(...)`` with the configuration's
precision and top-K."""

from __future__ import annotations

import importlib
import os

import numpy as np

# Segments of the seed's audio that set the batch norms' statistics, and
# how many of them are silent in their second half.
BN_CALIBRATION_SEGMENTS, BN_CALIBRATION_PADDED = 64, 8


def generator_module(cfg: dict):
    return importlib.import_module(f"benchmark.models.{cfg['generator']}")


def write_model(cfg: dict, gb, weights, directory: str) -> str:
    path = os.path.join(directory, f"{cfg['name']}.onnx")
    data = gb.encode(weights, *generator_module(cfg).io(cfg))
    with open(path, "wb") as f:
        f.write(data)
    return path


def build_classifier(cfg: dict, path: str, device: str, int8_calibration=None):
    from birdnet_tpu_torch import Classifier

    b = (Classifier.builder().model_path(path)
         .labels([f"species_{i}" for i in range(cfg["num_species"])])
         .precision(cfg["precision"]).top_k(cfg["top_k"]))
    if device == "cpu":
        b = b.with_device("cpu")
    if int8_calibration is not None:
        b = b.int8(int8_calibration)
    return b.build()


def calibrated(cfg: dict, weights: dict, recordings, device) -> dict:
    """The weights with every batch norm's running statistics set from the
    seed's own audio by the plain reference (float32, TF32 off), over
    ``BN_CALIBRATION_SEGMENTS`` segments spread over the pool, the last
    ``BN_CALIBRATION_PADDED`` of them silent in their second half as the
    last segment of an overlapped recording is (the program pads it with
    zeros)."""
    import torch

    from .check import reference_module

    n, S = BN_CALIBRATION_SEGMENTS, cfg["sample_count"]
    idx = np.linspace(0, (recordings.pool.shape[0] - S) // recordings.step, n).astype(np.int64)
    pcm = recordings.segments(recordings.pool, idx, S)
    pcm[n - BN_CALIBRATION_PADDED:, S // 2:] = 0
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        w = {k: torch.from_numpy(v).to(device) for k, v in weights.items()}
        with torch.inference_mode():
            reference_module(cfg).calibrate(cfg, w, torch.from_numpy(pcm).to(device))
        return {k: v.to(torch.float32).cpu().numpy() for k, v in w.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
