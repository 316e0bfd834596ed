"""Google Perch v2-shaped model generator, copied from the program's
(``models/perch_v2.py``, ``frontend="conv"``) and frozen here, its sizes
and its per-stage schedule read from a configuration file.

Contract: input ``[batch, sample_count]`` float32 (5 s at 32 kHz); four
outputs in ONNX order: embedding ``[batch, E]``, spatial embedding
``[batch, frames, E]``, spectrogram ``[batch, frames, filters]`` and
logits ``[batch, num_species]`` (the logits at index 3).
"""

from __future__ import annotations

import numpy as np

from ._builder import FRAME_LENGTH, GraphBuilder, backbone, learned_frontend

OUTPUTS = ("embedding", "spatial_embedding", "spectrogram", "logits")


def build(cfg: dict) -> GraphBuilder:
    gb = GraphBuilder("perch_v2")
    img, _ = learned_frontend(gb, "input", cfg["sample_count"], cfg["n_filters"], cfg["hop"])
    # spectrogram output: [N,1,M,T] -> [N,T,M]
    spec = gb.node("Squeeze", [img, gb.const("sq_ax", np.array([1], dtype=np.int64))])
    gb.node("Transpose", [spec], ["spectrogram"], perm=[0, 2, 1])
    x = backbone(gb, img, cfg)
    # Project to the embedding width while spatial structure is still present.
    emb = cfg["embedding_dim"]
    x = gb.conv_bn_act(x, cfg["stages"][-1][0], emb, [1, 1], "head")
    # spatial embedding: average over freq, keep time: [N,E,F',T'] -> [N,T',E]
    freq_avg = gb.node("ReduceMean", [x, gb.const("rm_ax", np.array([2], dtype=np.int64))],
                       keepdims=0)
    gb.node("Transpose", [freq_avg], ["spatial_embedding"], perm=[0, 2, 1])
    # pooled embedding: mean over time of the spatial embedding
    gb.node("ReduceMean", ["spatial_embedding",
                           gb.const("rm_ax2", np.array([1], dtype=np.int64))],
            ["embedding"], keepdims=0)
    gb.gemm("embedding", emb, cfg["num_species"], "logits")
    return gb


def frames(cfg: dict) -> tuple:
    """(frontend frames, frames after the stem and the strided stages)."""
    t = (cfg["sample_count"] - FRAME_LENGTH) // cfg["hop"] + 1
    t_out = t
    for _ in range(1 + sum(1 for s in cfg["stages"] if s[3] == 2)):
        t_out = (t_out + 1) // 2
    return t, t_out


def io(cfg: dict):
    t, t_out = frames(cfg)
    b, e = "batch", cfg["embedding_dim"]
    return ([("input", [b, cfg["sample_count"]])],
            [("embedding", [b, e]), ("spatial_embedding", [b, t_out, e]),
             ("spectrogram", [b, t, cfg["n_filters"]]), ("logits", [b, cfg["num_species"]])])
