"""Frozen copy of the program's ONNX graph builder for its reference-shaped
models (the port's ``models/_builder.py``), so that the benchmark's models
do not move when the program changes.

Three departures from the original:

- each stage gives its own width, expand ratio, depthwise kernel, stride
  and number of blocks (``blocks``), and squeeze-excite narrows to a
  quarter of the block's input channels, as EfficientNet's published
  schedules have them (the original runs one kernel size, one block count
  and a quarter of the expanded channels);
- weights are named by their place in the model (``b3.expand.w``) rather
  than by a running counter, so the plain reference finds them by name;
- the builder records each weight's shape and initial distribution (He
  normal, zeros, the batch norms' uniform and normal draws) instead of
  drawing it from numpy: :mod:`benchmark.models.weights` draws them all on
  the device from the seed in a few large calls, and :meth:`GraphBuilder.
  encode` writes them into the file.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import onnx_writer

# The frontend's taps per frame: both configurations' strided Conv1d.
FRAME_LENGTH = 1024
# EfficientNet's squeeze-excite width: a quarter of the block's input
# channels (not of its expanded ones).
SE_RATIO = 0.25


class GraphBuilder:
    """Accumulates ONNX nodes, constants and weight specs."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: List[Tuple[str, list, list, dict]] = []
        self.consts: Dict[str, np.ndarray] = {}
        # (name, shape, kind, a, b): kind "normal" (mean a, std b),
        # "uniform" (low a, high b) or "zeros".
        self.specs: List[Tuple[str, Tuple[int, ...], str, float, float]] = []
        self._counter = 0

    # -- naming / registration -------------------------------------------

    def fresh(self, hint: str) -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    def const(self, hint: str, arr: np.ndarray) -> str:
        name = self.fresh(hint)
        self.consts[name] = np.asarray(arr)
        return name

    def spec(self, name: str, shape: Sequence[int], kind: str, a: float = 0.0,
             b: float = 0.0) -> str:
        self.specs.append((name, tuple(int(s) for s in shape), kind, float(a), float(b)))
        return name

    def weight(self, name: str, shape: Sequence[int], fan_in: Optional[int] = None) -> str:
        """He-scaled random weight so activations stay O(1) through depth."""
        if fan_in is None:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        return self.spec(name, shape, "normal", 0.0, float(np.sqrt(2.0 / max(fan_in, 1))))

    def node(self, op_type: str, inputs, outputs=None, **attrs) -> str:
        if outputs is None:
            outputs = [self.fresh(op_type.lower())]
        self.nodes.append((op_type, list(inputs), list(outputs), attrs))
        return outputs[0]

    # -- layer helpers -----------------------------------------------------

    def conv(self, x: str, c_in: int, c_out: int, kernel, name: str, strides=None,
             pads=None, group: int = 1, bias: bool = False) -> str:
        if isinstance(kernel, int):
            kernel = [kernel]
        nd = len(kernel)
        strides = strides or [1] * nd
        if isinstance(strides, int):
            strides = [strides] * nd
        if pads is None:
            pads = [k // 2 for k in kernel] * 2  # SAME-ish for odd kernels
        inputs = [x, self.weight(f"{name}.w", [c_out, c_in // group] + list(kernel))]
        if bias:
            inputs.append(self.spec(f"{name}.b", [c_out], "zeros"))
        return self.node("Conv", inputs, [name], kernel_shape=list(kernel),
                         strides=list(strides), pads=list(pads), group=group)

    def batchnorm(self, x: str, channels: int, name: str) -> str:
        inputs = [x, self.spec(f"{name}.s", [channels], "uniform", 0.8, 1.2),
                  self.spec(f"{name}.b", [channels], "normal", 0.0, 0.05),
                  self.spec(f"{name}.m", [channels], "normal", 0.0, 0.05),
                  self.spec(f"{name}.v", [channels], "uniform", 0.8, 1.2)]
        return self.node("BatchNormalization", inputs, [name], epsilon=1e-3)

    def swish(self, x: str) -> str:
        s = self.node("Sigmoid", [x])
        return self.node("Mul", [x, s])

    def gap(self, x: str) -> str:
        """GlobalAveragePool → Flatten to [N, C]."""
        g = self.node("GlobalAveragePool", [x])
        return self.node("Flatten", [g], axis=1)

    def gemm(self, x: str, c_in: int, c_out: int, name: str) -> str:
        inputs = [x, self.weight(f"{name}.w", [c_out, c_in], fan_in=c_in),
                  self.spec(f"{name}.b", [c_out], "zeros")]
        return self.node("Gemm", inputs, [name], transB=1)

    def conv_bn_act(self, x, c_in, c_out, kernel, name: str, strides=1, group=1):
        y = self.conv(x, c_in, c_out, kernel, f"{name}.conv", strides=strides, group=group)
        y = self.batchnorm(y, c_out, f"{name}.bn")
        return self.swish(y)

    def se_block(self, x: str, channels: int, mid: int, name: str) -> str:
        """Squeeze-and-excitation: GAP → 1x1 conv → swish → 1x1 conv → sigmoid → scale."""
        g = self.node("GlobalAveragePool", [x])
        r = self.conv(g, channels, mid, [1, 1], f"{name}.reduce", pads=[0, 0, 0, 0], bias=True)
        r = self.swish(r)
        e = self.conv(r, mid, channels, [1, 1], f"{name}.expand", pads=[0, 0, 0, 0], bias=True)
        e = self.node("Sigmoid", [e])
        return self.node("Mul", [x, e])

    def mbconv(self, x, c_in, c_out, name: str, stride=1, expand=4, kernel=3):
        """EfficientNet's inverted residual block. An expand ratio of 1 keeps
        its 1x1 expand conv (of the input's width), which EfficientNet
        leaves out: the program's fusions match a block by that conv."""
        mid = c_in * expand
        y = self.conv_bn_act(x, c_in, mid, [1, 1], f"{name}.expand", strides=[1, 1])
        y = self.conv_bn_act(y, mid, mid, [kernel, kernel], f"{name}.dw", strides=stride,
                             group=mid)
        y = self.se_block(y, mid, se_channels(c_in), f"{name}.se")
        y = self.conv(y, mid, c_out, [1, 1], f"{name}.project.conv", pads=[0, 0, 0, 0])
        y = self.batchnorm(y, c_out, f"{name}.project.bn")
        if stride == 1 and c_in == c_out:
            y = self.node("Add", [x, y])
        return y

    # -- graph assembly ----------------------------------------------------

    def encode(self, weights: Dict[str, np.ndarray], inputs, outputs) -> bytes:
        """The serialized model with ``weights`` (name -> float32 array of
        its spec's shape) as initializers."""
        inits = dict(self.consts)
        for name, shape, _, _, _ in self.specs:
            arr = weights[name]
            if arr.shape != shape or arr.dtype != np.float32:
                raise ValueError(f"weight {name}: {arr.dtype}{arr.shape}, spec {shape}")
            inits[name] = arr
        return onnx_writer.encode_model(self.name, self.nodes, inits, inputs, outputs)


def se_channels(c_in: int) -> int:
    return max(1, int(c_in * SE_RATIO))


def learned_frontend(gb: GraphBuilder, x: str, n_samples: int, n_filters: int,
                     stride: int) -> tuple:
    """In-graph audio frontend: framing+filterbank as a strided Conv1d of
    ``FRAME_LENGTH`` taps, power, log compression. Returns (tensor_name,
    n_frames): output shaped [N, 1, n_filters, T]."""
    kernel = FRAME_LENGTH
    t = (n_samples - kernel) // stride + 1
    x3 = gb.node("Unsqueeze", [x, gb.const("axes", np.array([1], dtype=np.int64))])
    fb = gb.conv(x3, 1, n_filters, [kernel], "frontend", strides=[stride], pads=[0, 0])
    power = gb.node("Mul", [fb, fb])
    eps = gb.const("eps", np.array(1e-6, dtype=np.float32))
    logmel = gb.node("Log", [gb.node("Add", [power, eps])])
    img = gb.node("Unsqueeze", [logmel, gb.const("axes", np.array([1], dtype=np.int64))])
    return img, t


def blocks(cfg: dict):
    """``(name, c_in, c_out, stride, expand, kernel)`` of every MBConv block,
    in order. ``cfg["stages"]`` holds each stage's ``[c_out, expand,
    kernel, stride]`` and ``cfg["repeats"]`` its blocks: the first with
    the stage's stride, the rest of stride 1 and the stage's width in and
    out."""
    out = []
    c_in = cfg["stem_channels"]
    for (c_out, expand, kernel, stride), repeats in zip(cfg["stages"], cfg["repeats"]):
        for r in range(repeats):
            out.append((f"b{len(out)}", c_in, c_out, stride if r == 0 else 1, expand, kernel))
            c_in = c_out
    return out


def backbone(gb: GraphBuilder, img: str, cfg: dict) -> str:
    """The stem and every MBConv block."""
    x = gb.conv_bn_act(img, 1, cfg["stem_channels"], [3, 3], "stem", strides=[2, 2])
    for name, c_in, c_out, stride, expand, kernel in blocks(cfg):
        x = gb.mbconv(x, c_in, c_out, name, stride=stride, expand=expand, kernel=kernel)
    return x
