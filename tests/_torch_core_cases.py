"""One small graph per ai.onnx core op of the port (the 118 names ported
from birdnet_tpu/compiler/ops.py with the ai.onnx core), built with the
port's own codec: it imports numpy and birdnet_tpu_torch only, so the
card's machine, which has no JAX, runs it (tests/test_torch_cuda.py holds
the card to the host with it).

``CASES[name] = (nodes, inputs, inits, outputs, opset)``: graph inputs
reach the forward as tensors, initializers as params or host constants.
An op whose result is a host value (Shape, Range, the windows) feeds a
tensor op after it, so that every case runs on the device.
"""

from __future__ import annotations

import numpy as np

from birdnet_tpu_torch.onnx import proto as P

I64 = np.int64
F = P.DataType


def _n(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _i(shape, seed, lo=-9, hi=9, dtype=np.int32):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(dtype)


X = _n((2, 3, 4, 5), 0)
POS = np.abs(_n((2, 3, 4), 1)) + 0.1
UNIT = np.clip(_n((2, 3, 4), 2, 0.5), -0.99, 0.99).astype(np.float32)
I32 = _i((3, 4), 3)
I32B = np.where(_i((3, 4), 4, -6, 6) == 0, 3, _i((3, 4), 4, -6, 6)).astype(np.int32)
BOOL_A = np.random.default_rng(5).random((3, 4)) < 0.5
BOOL_B = np.random.default_rng(6).random((3, 4)) < 0.5
TIES = np.array([[1.0, 3.0, 3.0, 0.0, 3.0], [2.0, 2.0, -1.0, -1.0, 0.0]], np.float32)

CASES = {}


def _one(name, op_type, ins, inputs=None, inits=None, n_out=1, opset=17, **attrs):
    outputs = ["y"] if n_out == 1 else [f"y{i}" for i in range(n_out)]
    CASES[name] = ([P.make_node(op_type, list(ins), outputs, **attrs)], dict(inputs or {}),
                   dict(inits or {}), outputs, opset)


def _graph(name, nodes, inputs=None, inits=None, outputs=("y",), opset=17):
    CASES[name] = (nodes, dict(inputs or {}), dict(inits or {}), list(outputs), opset)


# trivial / elementwise
_one("Identity", "Identity", ["x"], {"x": X})
_one("Dropout", "Dropout", ["x"], {"x": X}, n_out=2)
_one("Cast", "Cast", ["x"], {"x": X * 3}, to=int(F.INT32))
_one("CastLike", "CastLike", ["x", "l"], {"x": X}, {"l": np.zeros(2, np.int64)})
_graph("Constant", [P.make_node("Constant", [], ["c"],
                                value=P.TensorProto.from_numpy(_n((4, 5), 7), name="c")),
                    P.make_node("Add", ["x", "c"], ["y"])], {"x": X})
_graph("ConstantOfShape", [P.make_node("ConstantOfShape", ["s"], ["c"]),
                           P.make_node("Add", ["x", "c"], ["y"])],
       {"x": X}, {"s": np.array([4, 5], I64)})
for _op in ("Sub", "Div", "Pow"):
    _one(_op, _op, ["a", "b"], {"a": POS, "b": POS[0] + 0.5})
for _op in ("Equal", "Greater", "Less", "GreaterOrEqual", "LessOrEqual", "BitwiseAnd",
            "BitwiseOr", "BitwiseXor"):
    _one(_op, _op, ["a", "b"], {"a": I32, "b": I32B})
for _op in ("And", "Or", "Xor"):
    _one(_op, _op, ["a", "b"], {"a": BOOL_A, "b": BOOL_B})
_one("Mod", "Mod", ["a", "b"], {"a": _n((3, 4), 8) * 5, "b": POS[0, :3] + 1.0}, fmod=1)
for _op in ("Min", "Max", "Sum", "Mean"):
    _one(_op, _op, ["a", "b", "c"], {"a": _n((2, 3, 4), 9), "b": _n((3, 4), 10)},
         {"c": np.float32(0.1)})
for _op, _x in (("Sqrt", POS), ("Exp", UNIT), ("Abs", X), ("Neg", X), ("Floor", X * 3),
                ("Ceil", X * 3), ("Round", X * 3), ("Sign", X), ("Not", BOOL_A),
                ("Reciprocal", POS), ("Sin", X), ("Cos", X), ("Tan", UNIT), ("Asin", UNIT),
                ("Acos", UNIT), ("Atan", X), ("Sinh", UNIT), ("Cosh", UNIT), ("Tanh", X),
                ("Erf", X), ("Softplus", X * 10), ("Softsign", X), ("Mish", X * 4),
                ("HardSwish", X * 4), ("IsNaN", X), ("IsInf", X), ("BitwiseNot", I32)):
    _one(_op, _op, ["x"], {"x": _x})
for _op, _a in (("LeakyRelu", {"alpha": 0.2}), ("Elu", {}), ("Selu", {}),
                ("HardSigmoid", {}), ("Celu", {"alpha": 0.8}),
                ("ThresholdedRelu", {"alpha": 0.3}), ("Shrink", {"lambd": 0.4, "bias": 0.1})):
    _one(_op, _op, ["x"], {"x": X * 2}, **_a)
_one("Gelu", "Gelu", ["x"], {"x": X * 2}, opset=20)
_one("PRelu", "PRelu", ["x", "s"], {"x": X}, {"s": _n((3, 1, 1), 11)})
_one("Clip", "Clip", ["x", "lo", "hi"], {"x": X}, {"lo": np.float32(-0.5), "hi": np.float32(0.7)})
_one("Where", "Where", ["c", "a", "b"], {"c": BOOL_A, "a": _n((3, 4), 12)},
     {"b": np.float32(-1.0)})
_one("Softmax", "Softmax", ["x"], {"x": X}, axis=1)
_one("LogSoftmax", "LogSoftmax", ["x"], {"x": X}, opset=11, axis=2)
_one("Trilu", "Trilu", ["x", "k"], {"x": _n((2, 4, 5), 13)}, {"k": np.int64(1)}, upper=0)
_one("EyeLike", "EyeLike", ["x"], {"x": _n((4, 6), 14)}, k=1)
_one("BitShift", "BitShift", ["x", "s"], {"x": np.array([[1, 2, 128, 255]], np.uint8),
                                         "s": np.array([[1, 3, 1, 4]], np.uint8)},
     direction="LEFT")

# matrix ops
_one("Einsum", "Einsum", ["a", "b"], {"a": _n((2, 3, 16), 15), "b": _n((2, 16, 5), 16)},
     equation="bij,bjk->bik")
_one("ConvTranspose", "ConvTranspose", ["x", "w", "b"], {"x": _n((2, 4, 5, 6), 17)},
     {"w": _n((4, 3, 3, 3), 18, 0.3), "b": _n((3,), 19)}, strides=[2, 2],
     pads=[1, 0, 0, 1], output_padding=[1, 0])

# normalization
_one("InstanceNormalization", "InstanceNormalization", ["x", "s", "b"],
     {"x": _n((2, 3, 5, 4), 20)}, {"s": _n((3,), 21), "b": _n((3,), 22)})
_one("LayerNormalization", "LayerNormalization", ["x", "s", "b"], {"x": _n((2, 3, 32), 23)},
     {"s": _n((32,), 24), "b": _n((32,), 25)}, n_out=3)
_one("GroupNormalization", "GroupNormalization", ["x", "s", "b"], {"x": _n((2, 6, 4, 3), 26)},
     {"s": _n((6,), 27), "b": _n((6,), 28)}, opset=21, num_groups=3)
_one("LRN", "LRN", ["x"], {"x": _n((2, 7, 3, 4), 29)}, size=3)

# pooling
_one("MaxPool", "MaxPool", ["x"], {"x": np.round(_n((2, 3, 7, 9), 30) * 2) / 2}, n_out=2,
     kernel_shape=[3, 3], strides=[2, 2], auto_pad="SAME_UPPER")
_graph("MaxUnpool", [P.make_node("MaxPool", ["x"], ["p", "i"], kernel_shape=[2, 2],
                                 strides=[2, 2]),
                     P.make_node("MaxUnpool", ["p", "i"], ["y"], kernel_shape=[2, 2],
                                 strides=[2, 2])], {"x": _n((2, 3, 6, 6), 31)})
_one("AveragePool", "AveragePool", ["x"], {"x": _n((2, 2, 7, 8), 32)}, opset=19,
     kernel_shape=[3, 3], strides=[2, 2], pads=[1, 0, 1, 0], count_include_pad=1, ceil_mode=1)
_one("GlobalMaxPool", "GlobalMaxPool", ["x"], {"x": X})
_one("LpPool", "LpPool", ["x"], {"x": _n((1, 2, 6, 7), 33)}, opset=18, kernel_shape=[2, 3],
     strides=[2, 2], p=3)
_one("GlobalLpPool", "GlobalLpPool", ["x"], {"x": X})

# shape manipulation
_graph("Shape", [P.make_node("Shape", ["x"], ["s"]),
                 P.make_node("Reshape", ["x", "s"], ["y"])], {"x": X})
_graph("Size", [P.make_node("Size", ["x"], ["s"]), P.make_node("Cast", ["s"], ["sf"],
                                                                to=int(F.FLOAT)),
                P.make_node("Mul", ["x", "sf"], ["y"])], {"x": X})
_one("Reshape", "Reshape", ["x", "s"], {"x": X}, {"s": np.array([0, -1], I64)})
_one("Concat", "Concat", ["a", "b"], {"a": _n((2, 3), 34)}, {"b": _n((2, 5), 35)}, axis=1)
_one("Split", "Split", ["x", "s"], {"x": _n((7, 4), 36)}, {"s": np.array([2, 5], I64)},
     n_out=2, opset=13)
_one("Slice", "Slice", ["x", "s", "e", "a", "t"], {"x": X},
     {"s": np.array([-1, 3], I64), "e": np.array([np.iinfo(I64).min, 0], I64),
      "a": np.array([0, 1], I64), "t": np.array([-1, -2], I64)})
_one("Gather", "Gather", ["x", "i"], {"x": X, "i": np.array([2, -1, 0], I64)}, axis=3)
_one("GatherElements", "GatherElements", ["x", "i"],
     {"x": X, "i": _i((2, 3, 2, 5), 37, -4, 4, I64)}, axis=2)
_one("GatherND", "GatherND", ["x", "i"], {"x": _n((3, 4, 5), 38),
                                          "i": np.array([[[1], [-1]], [[0], [2]], [[3], [3]]],
                                                        I64)}, batch_dims=1)
_REPEATED = np.array([[1, 1, 0, -1, 3], [1, 2, 2, 1, 0], [1, 3, 3, 3, 3]], I64)
_one("ScatterElements", "ScatterElements", ["x", "i", "u"],
     {"x": _n((4, 5), 39), "i": _REPEATED, "u": _n((3, 5), 40)}, opset=18, reduction="add")
_one("Scatter", "Scatter", ["x", "i", "u"],
     {"x": _n((4, 5), 41), "i": np.array([[1, 0, 2, 3, 3]], I64), "u": _n((1, 5), 42)},
     opset=10)
_one("ScatterND", "ScatterND", ["x", "i", "u"],
     {"x": _n((4, 3, 2), 43), "i": np.array([[1], [3], [1], [-4]], I64),
      "u": _n((4, 3, 2), 44)}, opset=18, reduction="mul")
_one("Expand", "Expand", ["x", "s"], {"x": _n((3, 4, 1), 45)}, {"s": np.array([2, 1, 4, 5], I64)})
_one("Tile", "Tile", ["x", "r"], {"x": _n((2, 3), 46)}, {"r": np.array([2, 3], I64)})
_one("Pad", "Pad", ["x", "p"], {"x": _n((2, 3, 4), 47)}, {"p": np.array([0, 2, 1, 0, 2, 3], I64)},
     opset=18, mode="reflect")
_graph("Range", [P.make_node("Range", ["s", "l", "d"], ["r"]),
                 P.make_node("Add", ["x", "r"], ["y"])],
       {"x": _n((3, 10), 48)}, {"s": np.float32(0.0), "l": np.float32(1.0), "d": np.float32(0.1)})
_one("OneHot", "OneHot", ["i", "d", "v"], {"i": np.array([[0, 3, -1], [5, 2, 1]], I64)},
     {"d": np.int64(4), "v": np.array([-1.0, 2.0], np.float32)}, axis=1)

# reductions
for _op in ("ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd", "ReduceL1", "ReduceL2",
            "ReduceLogSumExp"):
    _one(_op, _op, ["x", "a"], {"x": X}, {"a": np.array([1, -1], I64)}, opset=18)
_one("ReduceLogSum", "ReduceLogSum", ["x", "a"], {"x": np.abs(X) + 0.5},
     {"a": np.array([0, 2], I64)}, opset=18, keepdims=0)
_one("ArgMax", "ArgMax", ["x"], {"x": TIES}, axis=1, select_last_index=1)
_one("ArgMin", "ArgMin", ["x"], {"x": TIES}, axis=1)
_one("TopK", "TopK", ["x", "k"], {"x": np.concatenate([TIES, _n((2, 40), 49)], axis=1)},
     {"k": np.array([7], I64)}, n_out=2)
_one("CumSum", "CumSum", ["x", "a"], {"x": _n((3, 6), 50)}, {"a": np.int64(1)}, exclusive=1,
     reverse=1)

# signal / extensions
for _op in ("HannWindow", "HammingWindow", "BlackmanWindow"):
    _graph(_op, [P.make_node(_op, ["n"], ["w"], periodic=0),
                 P.make_node("Mul", ["x", "w"], ["y"])], {"x": _n((3, 16), 51)},
           {"n": np.int64(16)})
_one("DepthToSpace", "DepthToSpace", ["x"], {"x": _n((2, 8, 3, 4), 52)}, blocksize=2,
     mode="CRD")
_one("SpaceToDepth", "SpaceToDepth", ["x"], {"x": _n((2, 3, 4, 6), 53)}, blocksize=2)
_one("Hardmax", "Hardmax", ["x"], {"x": np.round(X * 4) / 4}, axis=1)
_one("LpNormalization", "LpNormalization", ["x"], {"x": _n((3, 5, 4), 54)}, axis=1, p=2)
_one("ReverseSequence", "ReverseSequence", ["x", "l"],
     {"x": _n((5, 3, 2), 55), "l": np.array([5, 1, 3], I64)}, batch_axis=1, time_axis=0)
_one("DFT", "DFT", ["x", "", "a"], {"x": _n((2, 9, 4, 1), 56)}, {"a": np.int64(1)}, opset=20,
     onesided=1)

# Outputs that must be equal on the card and the host bit for bit: integers,
# shapes, TopK's indices and the scatters (their float reductions are
# folded in a fixed order).
BITWISE = {"ScatterElements", "Scatter", "ScatterND", "TopK", "ArgMax", "ArgMin", "Gather",
           "GatherElements", "GatherND", "MaxUnpool", "Slice", "Expand", "Tile", "Pad",
           "Reshape", "Shape", "Concat", "Split", "Identity"}


def model_bytes(name: str) -> bytes:
    nodes, inputs, inits, outputs, opset = CASES[name]
    init = [P.TensorProto.from_numpy(np.asarray(v), name=k) for k, v in inits.items()]
    in_vis = [P.make_value_info(k, P._NUMPY_TO_DTYPE[np.asarray(v).dtype],
                                list(np.asarray(v).shape)) for k, v in inputs.items()]
    out_vis = [P.make_value_info(n, F.FLOAT, []) for n in outputs]
    graph = P.GraphProto(name=name, node=nodes, initializer=init, input=in_vis, output=out_vis)
    return P.encode_model(P.make_model(graph, opset_version=opset))
