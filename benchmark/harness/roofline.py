"""The yardstick of the kernels and of the whole step: the card's published
peaks, the least time a piece of work could take on it, and the operations
and bytes of the work, counted from the configuration's shapes.

Copied from the program's chip smoke test (``bound``, ``prefix_bound``),
with the weights' bytes counted from the configuration instead of from the
program's prepared tables. ``bound`` takes the LARGER of the memory time
and each operand type's compute time; it does not add them. For B4 that
means the float32 (SIMT) depthwise, stem and squeeze-excite work bounds it
alone, though the same kernels also run bfloat16 products.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

from ..models._builder import FRAME_LENGTH, blocks, se_channels

# The H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "fp32": 67e12}
BF16, F32 = 2, 4


def bound_s(bytes_moved: float, ops: Dict[str, float]) -> Tuple[float, str]:
    """The least time the card could take for a kernel's work: the larger
    of the bytes it must move (each input read once, each output written
    once) over the memory rate and, per operand type, its operations over
    that type's peak. Returns (seconds, "bytes" or "operations")."""
    mem_s = bytes_moved / HBM_BYTES_PER_S
    ops_s = max(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items())
    return max(mem_s, ops_s), ("bytes" if mem_s >= ops_s else "operations")


def frontend_frames(cfg: dict) -> int:
    return (cfg["sample_count"] - FRAME_LENGTH) // cfg["hop"] + 1


def b2_work(cfg: dict, rows: int) -> Tuple[float, Dict[str, float]]:
    """B2 (the filterbank log-power kernel) over a tile of ``rows``
    segments: bfloat16 frames ``[rows, S]`` and filters ``[F, K]`` read,
    bfloat16 log-power ``[rows, F, T]`` written; ``2 rows T K F``
    operations on the bfloat16 tensor cores."""
    t, k, f = frontend_frames(cfg), FRAME_LENGTH, cfg["n_filters"]
    moved = BF16 * (rows * cfg["sample_count"] + f * k + rows * f * t)
    return moved, {"bf16": 2.0 * rows * t * k * f}


def _prefix_blocks(cfg: dict):
    """(c_in, c_mid, c_se, c_out, stride, kernel) of the blocks B4 fuses."""
    return [(c_in, c_in * e, se_channels(c_in), c_out, s, k)
            for _, c_in, c_out, s, e, k in blocks(cfg)[:cfg["b4_blocks"]]]


def b4_work(cfg: dict, rows: int) -> Tuple[float, Dict[str, float]]:
    """B4 (the stem and the first ``b4_blocks`` MBConv blocks in one stage
    prefix) over ``rows`` images ``[1, F, T]``: the 1x1 expand and project
    products on the bfloat16 tensor cores, the stem, depthwise and
    squeeze-excite products on the float32 SIMT units; the bfloat16 image
    read and the bfloat16 output written once, each weight (batch norms
    folded) read once as float32."""
    h, w = cfg["n_filters"], frontend_frames(cfg)
    image = rows * h * w * BF16
    h, w = math.ceil(h / 2), math.ceil(w / 2)  # the stem's stride 2
    stem = cfg["stem_channels"]
    mma, simt = 0, stem * 9 * h * w
    weights = stem * 10
    c_out = stem
    for c_in, c_mid, c_se, c_out, stride, k in _prefix_blocks(cfg):
        mma += c_in * c_mid * h * w
        h, w = math.ceil(h / stride), math.ceil(w / stride)
        simt += k * k * c_mid * h * w + 2 * c_mid * c_se
        mma += c_mid * c_out * h * w
        weights += (c_in * c_mid + c_mid + (k * k + 1) * c_mid + 2 * c_mid * c_se + c_se
                    + c_mid + c_mid * c_out + c_out)
    moved = image + rows * c_out * h * w * BF16 + weights * F32
    return moved, {"bf16": 2.0 * rows * mma, "fp32": 2.0 * rows * simt}


def forward_flops(gb, sample_count: int) -> float:
    """Operations of one segment's forward: twice the multiply-adds of every
    Conv and Gemm of the frozen generator's graph, by the shapes its nodes
    give one another from ``[1, sample_count]``."""
    shapes = {"input": (1, sample_count)}
    shapes.update({k: tuple(v.shape) for k, v in gb.consts.items()})
    shapes.update({name: shape for name, shape, *_ in gb.specs})
    flops = 0.0
    for op, ins, outs, attrs in gb.nodes:
        x = shapes[ins[0]]
        if op in ("Unsqueeze", "Squeeze"):
            axes = [int(a) % (len(x) + (op == "Unsqueeze")) for a in gb.consts[ins[1]]]
            y = list(x)
            for a in sorted(axes, reverse=op == "Squeeze"):
                y.insert(a, 1) if op == "Unsqueeze" else y.pop(a)
        elif op == "Conv":
            wshape = shapes[ins[1]]
            k, s, p = attrs["kernel_shape"], attrs["strides"], attrs["pads"]
            nd = len(k)
            sp = [(x[2 + i] + p[i] + p[nd + i] - k[i]) // s[i] + 1 for i in range(nd)]
            y = [x[0], wshape[0], *sp]
            flops += 2.0 * x[0] * wshape[0] * math.prod(sp) * wshape[1] * math.prod(k)
        elif op in ("Mul", "Add"):
            y = list(np.broadcast_shapes(x, shapes[ins[1]]))
        elif op == "GlobalAveragePool":
            y = [x[0], x[1]] + [1] * (len(x) - 2)
        elif op == "Flatten":
            y = [x[0], math.prod(x[1:])]
        elif op == "Gemm":
            wshape = shapes[ins[1]]
            y = [x[0], wshape[0]]
            flops += 2.0 * x[0] * wshape[0] * wshape[1]
        elif op == "Transpose":
            y = [x[i] for i in attrs["perm"]]
        elif op == "ReduceMean":
            axes = {int(a) % len(x) for a in gb.consts[ins[1]]}
            y = [d for i, d in enumerate(x) if i not in axes]
        elif op in ("Log", "Sigmoid", "Relu", "BatchNormalization"):
            y = list(x)
        else:
            raise ValueError(f"forward_flops: no shape rule for {op}")
        shapes[outs[0]] = tuple(y)
    return flops
