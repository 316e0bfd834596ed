"""Axis attributes outside their range: the port raises where the JAX
package raises, and agrees with it where both accept.

Every lowering that takes an ``axis`` (or ``dim``, ``time_axis``, an axes
list or an axis input) is called directly, with each package's
``OpContext`` and ``get_lowering``, on seeded inputs of the op's minimal
rank ``r`` (``[3, 4]`` where the op allows it), at the axes ``r``,
``-r - 1`` and ``-2r``, at opsets 11 and 13 where the op has both. Adding
the rank once to a negative axis turns ``[-2r, -r)`` into another axis; the
JAX lowerings mostly raise there (jnp's own bounds), so the port must not
answer.

Four lowerings answered on another axis where the JAX package raises
(ArgMax, ArgMin, GatherElements, OneHot; also Gather at -2r,
SplitToSequence and TensorScatter); each of the four also runs through both
packages' classifier builders on a one-node file, where the validation
forward turns the lowering's error into the same ``ModelLoadError``.

``REFERENCE_FAULTS`` pins the other direction: axes ONNX refuses where the
JAX lowering answers on another axis (TopK at -3 on a rank-2 input ranks
the last axis; LayerNormalization at ``r`` normalizes over no axis). The
port raises numpy's ``AxisError`` there and must not inherit them.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_core_common import _host, assert_close
from birdnet_tpu.compiler import ops as j_ops
from birdnet_tpu.onnx import proto as P
from birdnet_tpu_torch.compiler import ops as t_ops

MS = "com.microsoft"
TOL = 1e-6


class T:
    """A graph tensor: a jnp array for the JAX package, a CPU tensor for
    the port."""

    def __init__(self, arr):
        self.arr = np.asarray(arr)


class H:
    """A host value (a constant input: k, axes, split sizes): numpy on both
    sides."""

    def __init__(self, arr):
        self.arr = np.asarray(arr)


def _x(shape=(3, 4), seed=0, dtype=np.float32):
    return (np.random.default_rng(seed).normal(size=shape)).astype(dtype)


def _latin(n=3):
    """A Latin square: a permutation along either axis, so a scatter writes
    each element once whichever axis it runs on."""
    return np.add.outer(np.arange(n), np.arange(n)) % n


def _qconcat_inputs():
    q = lambda s: (np.random.default_rng(s).integers(0, 255, size=(3, 4))).astype(np.uint8)
    f, z = np.float32(0.05), np.uint8(128)
    return [H(f), H(z), T(q(0)), H(f), H(z), T(q(1)), H(np.float32(0.1)), H(np.uint8(100))]


# name: (op_type, domain, opsets, rank, build(axis) -> (attrs, inputs, num_outputs))
CASES = {
    "Add_legacy": ("Add", "", (6,), 2,
                   lambda a: ({"broadcast": 1, "axis": a}, [T(_x()), T(_x((4,), 1))], 1)),
    "Softmax": ("Softmax", "", (11, 13), 2, lambda a: ({"axis": a}, [T(_x())], 1)),
    "LogSoftmax": ("LogSoftmax", "", (11, 13), 2, lambda a: ({"axis": a}, [T(_x())], 1)),
    "Hardmax": ("Hardmax", "", (11, 13), 2, lambda a: ({"axis": a}, [T(_x())], 1)),
    "LayerNormalization": ("LayerNormalization", "", (17,), 2,
                           lambda a: ({"axis": a}, [T(_x()), T(_x((4,), 1))], 1)),
    "Flatten": ("Flatten", "", (11, 13), 2, lambda a: ({"axis": a}, [T(_x())], 1)),
    "Concat": ("Concat", "", (11, 13), 2, lambda a: ({"axis": a}, [T(_x()), T(_x(seed=1))], 1)),
    "Split": ("Split", "", (11, 13), 2, lambda a: ({"axis": a}, [T(_x((4, 4)))], 2)),
    "Gather": ("Gather", "", (11, 13), 2,
               lambda a: ({"axis": a}, [T(_x()), H(np.array([0, 2], np.int64))], 1)),
    "GatherElements": ("GatherElements", "", (11, 13), 2,
                       lambda a: ({"axis": a}, [T(_x()), T(_latin()[:, :2].astype(np.int64))], 1)),
    "ScatterElements": ("ScatterElements", "", (11, 13), 2,
                        lambda a: ({"axis": a}, [T(_x((3, 3))), T(_latin().astype(np.int64)),
                                                 T(_x((3, 3), 1))], 1)),
    "Scatter": ("Scatter", "", (10,), 2,
                lambda a: ({"axis": a}, [T(_x((3, 3))), T(_latin().astype(np.int64)),
                                         T(_x((3, 3), 1))], 1)),
    "OneHot": ("OneHot", "", (11,), 2,
               lambda a: ({"axis": a}, [T(np.array([0, 2, 1], np.int64)), H(np.int64(4)),
                                        H(np.array([0.0, 1.0], np.float32))], 1)),
    "ArgMax": ("ArgMax", "", (11, 13), 2, lambda a: ({"axis": a}, [T(_x())], 1)),
    "ArgMin": ("ArgMin", "", (11, 13), 2, lambda a: ({"axis": a}, [T(_x())], 1)),
    "QuantizeLinear": ("QuantizeLinear", "", (11, 13), 2,
                       lambda a: ({"axis": a}, [T(_x((4, 4))), T(np.full(4, 0.05, np.float32)),
                                                T(np.full(4, 128, np.uint8))], 1)),
    "DequantizeLinear": ("DequantizeLinear", "", (11, 13), 2,
                         lambda a: ({"axis": a}, [T(np.arange(16, dtype=np.uint8).reshape(4, 4)),
                                                  T(np.full(4, 0.05, np.float32)),
                                                  T(np.full(4, 3, np.uint8))], 1)),
    "TopK": ("TopK", "", (11, 13), 2,
             lambda a: ({"axis": a}, [T(_x()), H(np.array([2], np.int64))], 2)),
    "LpNormalization": ("LpNormalization", "", (11, 13), 2, lambda a: ({"axis": a}, [T(_x())], 1)),
    "DFT": ("DFT", "", (17,), 3, lambda a: ({"axis": a}, [T(_x((2, 4, 2)))], 1)),
    "CumSum": ("CumSum", "", (11, 13), 2, lambda a: ({}, [T(_x()), H(np.int64(a))], 1)),
    "ReverseSequence": ("ReverseSequence", "", (11, 13), 2,
                        lambda a: ({"time_axis": a, "batch_axis": 1},
                                   [T(_x()), T(np.array([1, 2, 3, 3], np.int64))], 1)),
    "Compress": ("Compress", "", (11, 13), 2,
                 lambda a: ({"axis": a}, [T(_x()), H(np.array([1, 0, 1], bool))], 1)),
    "Unique": ("Unique", "", (11,), 2,
               lambda a: ({"axis": a}, [H(np.array([[1, 2], [1, 2], [3, 4]], np.int64))], 4)),
    "ConcatFromSequence": ("ConcatFromSequence", "", (11, 13), 2,
                           lambda a: ({"axis": a}, [[T(_x()), T(_x(seed=1))]], 1)),
    "SplitToSequence": ("SplitToSequence", "", (11, 13), 2,
                        lambda a: ({"axis": a}, [T(_x())], 1)),
    "TensorScatter": ("TensorScatter", "", (24,), 3,
                      lambda a: ({"axis": a}, [T(_x((2, 4, 3))), T(_x((2, 1, 3), 1)),
                                               T(np.array([0, 2], np.int64))], 1)),
    "RMSNormalization": ("RMSNormalization", "", (23,), 2,
                         lambda a: ({"axis": a}, [T(_x()), T(_x((4,), 1))], 1)),
    "SimplifiedLayerNormalization": ("SimplifiedLayerNormalization", "", (17,), 2,
                                     lambda a: ({"axis": a}, [T(_x()), T(_x((4,), 1))], 1)),
    "Squeeze": ("Squeeze", "", (11, 13), 2,
                lambda a: ({"axes": [a]}, [T(_x((3, 1)))], 1)),
    "Unsqueeze": ("Unsqueeze", "", (11, 13), 3,
                  lambda a: ({"axes": [a]}, [T(_x())], 1)),
    "Slice": ("Slice", "", (11, 13), 2,
              lambda a: ({}, [T(_x()), H(np.array([0], np.int64)), H(np.array([2], np.int64)),
                              H(np.array([a], np.int64))], 1)),
    "Pad": ("Pad", "", (18,), 2,
            lambda a: ({}, [T(_x()), H(np.array([1, 1], np.int64)), None,
                            H(np.array([a], np.int64))], 1)),
    "ReduceSum": ("ReduceSum", "", (11, 13), 2, lambda a: ({"axes": [a]}, [T(_x())], 1)),
    "ReduceMax": ("ReduceMax", "", (11, 13), 2, lambda a: ({"axes": [a]}, [T(_x())], 1)),
    "BiasSoftmax": ("BiasSoftmax", MS, (13,), 2,
                    lambda a: ({"axis": a}, [T(_x()), T(_x(seed=1))], 1)),
    "QLinearConcat": ("QLinearConcat", MS, (13,), 2, lambda a: ({"axis": a}, _qconcat_inputs(), 1)),
    "QLinearSoftmax": ("QLinearSoftmax", MS, (13,), 2,
                       lambda a: ({"axis": a},
                                  [T(np.arange(12, dtype=np.uint8).reshape(3, 4) * 20),
                                   H(np.float32(0.05)), H(np.uint8(128)),
                                   H(np.float32(1 / 256)), H(np.uint8(0))], 1)),
    "UnfoldTensor": ("UnfoldTensor", MS, (13,), 2,
                     lambda a: ({"dim": a, "size": 2, "step": 1}, [T(_x())], 1)),
}

# Axes ONNX refuses that the JAX lowering accepts, adding the rank once
# (or, at r, reducing over no axes) and answering on another axis: the
# reference's faults. The port refuses them.
REFERENCE_FAULTS = {
    ("TopK", 11): (-3, -4), ("TopK", 13): (-3, -4),
    ("Hardmax", 11): (2, -3, -4), ("Hardmax", 13): (-3, -4),
    ("LayerNormalization", 17): (2,),
    ("RMSNormalization", 23): (2,),
    ("SimplifiedLayerNormalization", 17): (2,),
    ("ScatterElements", 11): (-3, -4), ("ScatterElements", 13): (-3, -4),
    ("Scatter", 10): (-3, -4),
    ("Squeeze", 11): (-3,), ("Squeeze", 13): (-3,),
    ("Slice", 11): (-3, -4), ("Slice", 13): (-3, -4),
    ("UnfoldTensor", 13): (-3, -4),
}

# Axes lists go in as an input from opset 13 (Squeeze, Unsqueeze,
# ReduceSum) and stay an attribute before it.
_AXES_INPUT_FROM_13 = ("Squeeze", "Unsqueeze", "ReduceSum")


def _params(faults: bool):
    for name, (_, _, opsets, r, _) in CASES.items():
        for opset in opsets:
            for axis in (r, -r - 1, -2 * r):
                if (axis in REFERENCE_FAULTS.get((name, opset), ())) == faults:
                    yield pytest.param(name, opset, axis, id=f"{name}-opset{opset}-axis{axis}")


def _call(pkg, op_type, domain, attrs, inputs, opset, num_outputs):
    ops = j_ops if pkg == "jax" else t_ops

    def conv(v):
        if v is None:
            return None
        if isinstance(v, list):
            return [conv(e) for e in v]
        if isinstance(v, H):
            return v.arr
        if pkg == "jax":
            import jax.numpy as jnp

            return jnp.asarray(v.arr)
        return torch.from_numpy(v.arr.copy())

    ctx = ops.OpContext(op_type, dict(attrs), opset=opset, num_outputs=num_outputs)
    return ops.get_lowering(op_type, domain)(ctx, *[conv(v) for v in inputs])


def _outcome(pkg, name, opset, axis):
    op_type, domain, _, _, build = CASES[name]
    attrs, inputs, n_out = build(axis)
    if op_type in _AXES_INPUT_FROM_13 and opset >= 13:
        inputs = inputs + [H(np.array(attrs.pop("axes"), np.int64))]
    try:
        return _call(pkg, op_type, domain, attrs, inputs, opset, n_out), None
    except Exception as e:  # noqa: BLE001 - the outcome under test
        return None, e


def _flat(outs):
    for o in outs:
        if isinstance(o, (list, tuple)):
            yield from _flat(o)
        else:
            yield o


@pytest.mark.parametrize("name,opset,axis", list(_params(faults=False)))
def test_out_of_range_axis_raises_or_agrees_in_both_packages(name, opset, axis):
    """An axis at ``r``, ``-r - 1`` or ``-2r``: both packages raise, or both
    answer alike."""
    want, j_err = _outcome("jax", name, opset, axis)
    got, t_err = _outcome("port", name, opset, axis)
    assert (j_err is None) == (t_err is None), (
        f"{name} opset {opset} axis {axis}: JAX "
        f"{'raised ' + repr(j_err) if j_err else 'accepted'}, the port "
        f"{'raised ' + repr(t_err) if t_err else 'accepted'}")
    if j_err is not None:
        return
    want, got = list(_flat(want)), list(_flat(got))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(_host(g), _host(w), TOL, f"{name} output {i}")


@pytest.mark.parametrize("name,opset,axis", list(_params(faults=True)))
def test_axis_the_reference_accepts_against_onnx_is_refused(name, opset, axis):
    """The reference's faults: ONNX refuses the axis and the JAX lowering
    answers on another axis (TopK at -3 on a rank-2 input ranks the last
    axis); the port raises numpy's AxisError instead."""
    want, j_err = _outcome("jax", name, opset, axis)
    assert j_err is None and len(list(_flat(want))) > 0
    _, t_err = _outcome("port", name, opset, axis)
    assert isinstance(t_err, np.exceptions.AxisError), repr(t_err)


# One-node classifier files: input [1, 144000] (a v2.4 segment), one
# output, so detection passes and the validation forward reaches the node.
def _one_node_file(case):
    x = P.make_value_info("x", P.DataType.FLOAT, [1, 144000])
    inits, extra, attrs = [], [], {}
    if case in ("ArgMax", "ArgMin"):
        attrs, out_shape, out_type = {"axis": -3}, [1, 1], P.DataType.INT64
    elif case == "GatherElements":
        idx = np.zeros((1, 3), np.int64)
        inits.append(P.TensorProto.from_numpy(idx, name="idx"))
        extra, attrs = ["idx"], {"axis": -3}
        out_shape, out_type = [1, 3], P.DataType.FLOAT
    else:  # OneHot: rank-3 output, axis -6 in [-2r, -r)
        inits += [P.TensorProto.from_numpy(np.array(2, np.int64), name="depth"),
                  P.TensorProto.from_numpy(np.array([0.0, 1.0], np.float32), name="vals")]
        extra, attrs = ["depth", "vals"], {"axis": -6}
        out_shape, out_type = [1, 144000, 2], P.DataType.FLOAT
    node = P.make_node(case, ["x"] + extra, ["y"], **attrs)
    graph = P.GraphProto(name="g", node=[node], initializer=inits, input=[x],
                         output=[P.make_value_info("y", out_type, out_shape)])
    return P.encode_model(P.make_model(graph, opset_version=13)), out_shape[-1]


@pytest.mark.parametrize("case", ["ArgMax", "ArgMin", "GatherElements", "OneHot"])
def test_repaired_axis_fails_the_classifier_build_alike(tmp_path, case):
    """Through each package's ``Classifier.builder()``: the repaired
    lowering raises in the validation forward, which both packages turn
    into the same ``BirdnetError`` subclass."""
    import birdnet_tpu
    import birdnet_tpu_torch

    data, n = _one_node_file(case)
    path = tmp_path / f"{case}.onnx"
    path.write_bytes(data)
    labels = [f"s{i}" for i in range(n)]
    with pytest.raises(birdnet_tpu.BirdnetError) as j_err:
        birdnet_tpu.Classifier.builder().model_path(str(path)).labels(labels).build()
    with pytest.raises(birdnet_tpu_torch.BirdnetError) as t_err:
        (birdnet_tpu_torch.Classifier.builder().model_path(str(path)).labels(labels)
         .with_device("cpu").build())
    assert type(t_err.value).__name__ == type(j_err.value).__name__
