"""BirdNET v2.4-shaped model generator, copied from the program's
(``models/birdnet_v24.py``, ``frontend="conv"``) and frozen here, its sizes
and its per-stage schedule read from a configuration file.

Contract: input ``[batch, sample_count]`` float32 (3 s at 48 kHz); one
output, logits ``[batch, num_species]``. A learned conv frontend (strided
Conv1d filterbank → power → log) feeds an EfficientNet-style MBConv stack
and a linear head.
"""

from __future__ import annotations

from ._builder import GraphBuilder, backbone, learned_frontend

OUTPUTS = ("output",)


def build(cfg: dict) -> GraphBuilder:
    """The graph of ``cfg``, its weights still to be drawn; the model's
    inputs and outputs are :func:`io`."""
    gb = GraphBuilder("birdnet_v24")
    img, _ = learned_frontend(gb, "input", cfg["sample_count"], cfg["n_filters"], cfg["hop"])
    x = backbone(gb, img, cfg)
    head = cfg["head_channels"]
    x = gb.conv_bn_act(x, cfg["stages"][-1][0], head, [1, 1], "head")
    gb.gemm(gb.gap(x), head, cfg["num_species"], "output")
    return gb


def io(cfg: dict):
    return ([("input", ["batch", cfg["sample_count"]])],
            [("output", ["batch", cfg["num_species"]])])
