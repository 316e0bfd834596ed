"""``Classifier.analyze_samples`` over a whole recording: per segment the
top-K species and their confidences (sigmoid of the logits), on the host.

Per sampled segment the check reads, against the plain reference's float32
logits ``z`` of the same segment:

- the rank gap: how far the k-th served species' reference logit lies below
  the reference's k-th best, ``max_k (sorted(z)[k] - z[served_k])``, over
  the row's largest ``|z|``; 0 where the served species are the
  reference's top-K in its order; near ties swapped by rounding read small;
- the confidence error: the largest ``|served confidence - sigmoid(z[served])|``.

Numbers compared: ``rank_gap_p90``, the 90th percentile of the rank gap
over the sampled segments (its largest swings with the few segments on
which rounding reorders near ties, as far in the reference rounded to
bfloat16 as in the program); ``rank_gap_rows_over``, the share of sampled
segments whose rank gap passes ``row_limits["rank_gap"]`` (a wrong top-K
confined to a tenth of the segments or less); and ``conf_err``, the
largest confidence error.
"""

from __future__ import annotations

import numpy as np

from ..harness.check import share_over


def invoke(clf, recording: np.ndarray, traffic: dict):
    return clf.analyze_samples(recording, overlap_seconds=traffic["overlap_seconds"])


def count(result) -> int:
    return len(result)


def served(result, idx: np.ndarray, cfg: dict) -> dict:
    k = cfg["top_k"]
    conf = np.full((len(idx), k), np.nan)
    ids = np.full((len(idx), k), -1, np.int64)
    for row, i in enumerate(idx):
        preds = result[int(i)][1]
        for j, p in enumerate(preds[:k]):
            conf[row, j], ids[row, j] = p.confidence, p.index
    return {"conf": conf, "idx": ids}


def compare(got: dict, ref: dict, cfg: dict) -> dict:
    """Per-row readings of one recording's sample."""
    z = ref["logits"].astype(np.float64)
    if (got["idx"] < 0).any():
        inf = np.full(z.shape[0], np.inf)
        return {"rank_gap": inf, "conf_err": inf}
    best = -np.sort(-z, axis=1)[:, :cfg["top_k"]]
    served_z = np.take_along_axis(z, got["idx"], axis=1)
    scale = np.abs(z).max(axis=1, keepdims=True)
    return {"rank_gap": ((best - served_z) / scale).max(axis=1),
            "conf_err": np.abs(got["conf"] - 1.0 / (1.0 + np.exp(-served_z))).max(axis=1)}


def numbers(rows: dict, cfg: dict) -> dict:
    """The numbers compared, over every sampled row."""
    return {"rank_gap_p90": float(np.percentile(rows["rank_gap"], 90)),
            "rank_gap_rows_over": share_over(rows["rank_gap"], cfg["row_limits"]["rank_gap"]),
            "conf_err": float(np.nan_to_num(rows["conf_err"], nan=np.inf).max())}
