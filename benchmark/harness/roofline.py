"""The yardstick of the kernels and of the whole step: the card's published
peaks, the least time a piece of work could take on it, and the operations
and bytes of the work, counted from the configuration's shapes.

Copied from the program's chip smoke test (``bound``, ``prefix_bound``),
with the weights' bytes counted from the configuration instead of from the
program's prepared tables. ``bound`` takes the LARGER of the memory time
and each operand type's compute time; it does not add them. For B4 that
means the float32 (SIMT) depthwise, stem and squeeze-excite work bounds it
alone, though the same kernels also run bfloat16 products.

The whole step's operations (``forward_flops``) are counted from the
frozen generator's graph by a table of shape rules, one per ONNX op, so
that a configuration of any architecture its generator writes is counted
without an edit here: a new op is a new rule.
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
    Conv, Gemm and MatMul of the frozen generator's graph, by the shapes its
    nodes give one another from ``[1, sample_count]`` at its ``input``.

    Every op is looked up in :data:`SHAPE_RULES`, which gives its output's
    shape and its multiply-adds. The products are the only ops that count;
    elementwise ops, normalisations, softmax, reductions and the shape ops
    count none. An op without a rule, a node with more than one output, or a
    shape operand that is not one of the graph's constants raises
    ``ValueError``: nothing is counted as zero unseen."""
    shapes = {"input": (1, sample_count)}
    shapes.update({k: tuple(v.shape) for k, v in gb.consts.items()})
    shapes.update({name: shape for name, shape, *_ in gb.specs})
    macs = 0
    for op, ins, outs, attrs in gb.nodes:
        rule = SHAPE_RULES.get(op)
        if rule is None:
            raise ValueError(f"forward_flops: no shape rule for {op}")
        if len(outs) != 1:
            raise ValueError(f"forward_flops: {op} has {len(outs)} outputs, the rules give one")
        xs = [shapes[name] if name else None for name in ins]
        y, n = rule(xs, attrs, _Consts(op, ins, gb.consts))
        shapes[outs[0]] = tuple(int(d) for d in y)
        macs += n
    return 2.0 * macs


class _Consts:
    """The values of a node's constant inputs (shape targets, axes, slice
    bounds, pads), read from the graph's constants."""

    def __init__(self, op: str, ins, consts):
        self.op, self.ins, self.consts = op, ins, consts

    def __call__(self, i: int, default=None):
        if i >= len(self.ins) or not self.ins[i]:
            return default
        if self.ins[i] not in self.consts:
            raise ValueError(f"forward_flops: {self.op}'s input {self.ins[i]} is not a constant")
        return [int(v) for v in np.asarray(self.consts[self.ins[i]]).reshape(-1)]


def _axis(a: int, rank: int) -> int:
    return a + rank if a < 0 else a


def _same(xs, attrs, const):
    return xs[0], 0


def _broadcast(xs, attrs, const):
    return np.broadcast_shapes(*[x for x in xs if x is not None]), 0


def _reshape(xs, attrs, const):
    x, y = xs[0], const(1)
    if not attrs.get("allowzero", 0):
        y = [x[i] if d == 0 else d for i, d in enumerate(y)]
    if -1 in y:
        k = y.index(-1)
        y[k] = math.prod(x) // math.prod(d for i, d in enumerate(y) if i != k)
    if math.prod(y) != math.prod(x):
        raise ValueError(f"forward_flops: Reshape of {x} to {y}")
    return y, 0


def _transpose(xs, attrs, const):
    x = xs[0]
    return [x[i] for i in attrs.get("perm", range(len(x) - 1, -1, -1))], 0


def _squeeze(xs, attrs, const):
    x = xs[0]
    axes = const(1, attrs.get("axes"))
    if axes is None:
        axes = [i for i, d in enumerate(x) if d == 1]
    axes = {_axis(a, len(x)) for a in axes}
    return [d for i, d in enumerate(x) if i not in axes], 0


def _unsqueeze(xs, attrs, const):
    y = list(xs[0])
    axes = const(1, attrs.get("axes"))
    for a in sorted(_axis(a, len(y) + len(axes)) for a in axes):
        y.insert(a, 1)
    return y, 0


def _flatten(xs, attrs, const):
    x = xs[0]
    axis = _axis(attrs.get("axis", 1), len(x))
    return [math.prod(x[:axis]), math.prod(x[axis:])], 0


def _concat(xs, attrs, const):
    y = list(xs[0])
    axis = _axis(attrs["axis"], len(y))
    y[axis] = sum(x[axis] for x in xs)
    return y, 0


def _slice(xs, attrs, const):
    y = list(xs[0])
    starts, ends = const(1), const(2)
    axes = const(3, list(range(len(starts))))
    steps = const(4, [1] * len(starts))
    for start, end, axis, step in zip(starts, ends, axes, steps):
        axis = _axis(axis, len(y))
        y[axis] = len(range(*slice(start, end, step).indices(y[axis])))
    return y, 0


def _pad(xs, attrs, const):
    y = list(xs[0])
    pads = const(1)
    axes = [_axis(a, len(y)) for a in const(3, list(range(len(y))))]
    for i, axis in enumerate(axes):
        y[axis] += pads[i] + pads[len(axes) + i]
    return y, 0


def _reduce_mean(xs, attrs, const):
    x = xs[0]
    axes = const(1, attrs.get("axes"))
    if not axes:
        if attrs.get("noop_with_empty_axes", 0):
            return x, 0
        axes = range(len(x))
    axes = {_axis(a, len(x)) for a in axes}
    if attrs.get("keepdims", 1):
        return [1 if i in axes else d for i, d in enumerate(x)], 0
    return [d for i, d in enumerate(x) if i not in axes], 0


def _global_average_pool(xs, attrs, const):
    x = xs[0]
    return [x[0], x[1]] + [1] * (len(x) - 2), 0


def _conv(xs, attrs, const):
    """``[N, C, *spatial]`` by a ``[M, C / group, *kernel]`` weight, with
    strides, dilations and explicit pads; ``N M prod(out) (C / group)
    prod(kernel)`` multiply-adds."""
    x, w = xs[0], xs[1]
    if attrs.get("auto_pad", "NOTSET") != "NOTSET":
        raise ValueError("forward_flops: Conv with auto_pad")
    nd, kernel = len(w) - 2, w[2:]
    strides = attrs.get("strides", [1] * nd)
    dilations = attrs.get("dilations", [1] * nd)
    pads = attrs.get("pads", [0] * 2 * nd)
    if x[1] != w[1] * attrs.get("group", 1):
        raise ValueError(f"forward_flops: Conv of {x} by {w} in {attrs.get('group', 1)} groups")
    out = [(x[2 + i] + pads[i] + pads[nd + i] - dilations[i] * (kernel[i] - 1) - 1)
           // strides[i] + 1 for i in range(nd)]
    return [x[0], w[0], *out], x[0] * w[0] * math.prod(out) * w[1] * math.prod(kernel)


def _gemm(xs, attrs, const):
    """``A [M, K]`` by ``B [K, N]``, either transposed first; the bias
    counts none."""
    m, k = xs[0][::-1] if attrs.get("transA", 0) else xs[0]
    k2, n = xs[1][::-1] if attrs.get("transB", 0) else xs[1]
    if k != k2:
        raise ValueError(f"forward_flops: Gemm of {xs[0]} by {xs[1]}")
    return [m, n], m * k * n


def _matmul(xs, attrs, const):
    """numpy's ``matmul``: a 1-D operand gains a unit row (first) or column
    (second) that the output drops; the leading dims broadcast."""
    a, b = list(xs[0]), list(xs[1])
    a_vec, b_vec = len(a) == 1, len(b) == 1
    a = [1] + a if a_vec else a
    b = b + [1] if b_vec else b
    if a[-1] != b[-2]:
        raise ValueError(f"forward_flops: MatMul of {xs[0]} by {xs[1]}")
    batch = list(np.broadcast_shapes(tuple(a[:-2]), tuple(b[:-2])))
    y = batch + ([] if a_vec else [a[-2]]) + ([] if b_vec else [b[-1]])
    return y, math.prod(batch) * a[-2] * a[-1] * b[-1]


# op -> rule(input shapes, attributes, constant reader) -> (output shape,
# multiply-adds).
SHAPE_RULES = {
    **dict.fromkeys(("Relu", "Sigmoid", "Tanh", "Erf", "Log", "Exp", "Sqrt", "Neg", "Cast",
                     "Identity", "Softmax", "LayerNormalization", "BatchNormalization"), _same),
    **dict.fromkeys(("Add", "Sub", "Mul", "Div", "Pow", "Where"), _broadcast),
    "Reshape": _reshape, "Transpose": _transpose, "Squeeze": _squeeze,
    "Unsqueeze": _unsqueeze, "Flatten": _flatten, "Concat": _concat, "Slice": _slice,
    "Pad": _pad, "ReduceMean": _reduce_mean, "GlobalAveragePool": _global_average_pool,
    "Conv": _conv, "Gemm": _gemm, "MatMul": _matmul,
}
