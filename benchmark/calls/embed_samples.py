"""``Classifier.embed_samples`` over a whole recording: the pooled
embedding ``[N, E]`` of every segment, on the host.

Per sampled segment the check reads, against the plain reference's float32
embedding ``e`` of the same segment, the largest ``|served - e|`` over the
row's largest ``|e|``. The number compared, ``emb_err_rows_over``, is the
share of sampled segments whose error passes ``row_limits["emb_err"]``:
it refuses a fault in any share of the rows down to a few in a thousand.
No percentile of the error is compared: the random model's bfloat16 drift
puts the program's within three times the int8 control's at every
percentile (PERF.md), so no limit between them would hold.
"""

from __future__ import annotations

import numpy as np

from ..harness.check import share_over


def invoke(clf, recording: np.ndarray, traffic: dict):
    return clf.embed_samples(recording, overlap_seconds=traffic["overlap_seconds"])


def count(result) -> int:
    return int(result[0].shape[0])


def served(result, idx: np.ndarray, cfg: dict) -> dict:
    return {"embedding": np.asarray(result[0][idx], np.float64)}


def compare(got: dict, ref: dict, cfg: dict) -> dict:
    """Per-row readings of one recording's sample."""
    e = ref["embedding"].astype(np.float64)
    err = np.abs(got["embedding"] - e).max(axis=1) / np.abs(e).max(axis=1)
    return {"emb_err": np.nan_to_num(err, nan=np.inf)}


def numbers(rows: dict, cfg: dict) -> dict:
    return {"emb_err_rows_over": share_over(rows["emb_err"], cfg["row_limits"]["emb_err"])}
