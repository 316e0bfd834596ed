"""The port's ai.onnx core lowerings, shape manipulation and reductions
(the JAX file's ``:1113-1561``): each op as a graph through the JAX package
and the port on the same seeded inputs (tests/_torch_core_common.py); the
host fold of an exporter's shape chain; the values that must be
compile-time constants."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_core_common import (  # noqa: E402
    EXACT, POLICY, TRANSCENDENTAL, check_after_matmul, check_graph, check_op, model_bytes,
    normal, rng,
)
from birdnet_tpu.onnx import proto as P  # noqa: E402

I64 = np.int64
INT64_MAX, INT64_MIN = np.iinfo(np.int64).max, np.iinfo(np.int64).min
X = normal((2, 3, 4, 5), 0)


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attrs", [{}, {"start": 1}, {"start": 1, "end": -1}])
def test_shape_and_size(attrs):
    check_op("Shape", ["x"], {"x": X}, opset=15, **attrs)
    check_op("Size", ["x"], {"x": X})


@pytest.mark.parametrize("shape,attrs", [
    ([0, -1], {}), ([2, 0, 20], {}), ([-1], {}), ([2, 3, 20], {"allowzero": 1}),
])
def test_reshape(shape, attrs):
    check_op("Reshape", ["x", "s"], {"x": X}, {"s": np.array(shape, I64)}, opset=14, **attrs)


def test_tf_flatten_chain_folds_on_the_host():
    """The TF dialect's Shape -> Gather -> Unsqueeze -> Concat -> Reshape:
    the port computes the target shape in numpy (never on a device), as the
    JAX interpreter folds it at trace time."""
    from birdnet_tpu_torch.compiler.importer import import_onnx, interpret_graph

    nodes = [P.make_node("Shape", ["x"], ["sh"]),
             P.make_node("Gather", ["sh", "i0"], ["n"], axis=0),
             P.make_node("Unsqueeze", ["n", "ax0"], ["n1"]),
             P.make_node("Concat", ["n1", "neg1"], ["target"], axis=0),
             P.make_node("Reshape", ["x", "target"], ["y"])]
    inits = {"i0": np.array(0, I64), "ax0": np.array([0], I64), "neg1": np.array([-1], I64)}
    check_graph(nodes, {"x": X}, inits)
    model = import_onnx(model_bytes(nodes, {"x": X}, inits, ["y"], 17), optimize=False)
    env = {**model.consts, "x": torch.from_numpy(X)}
    interpret_graph(model.graph, 17, "fp32", env, ["y"], torch.device("cpu"))
    for name in ("sh", "n", "n1", "target"):
        assert isinstance(env[name], np.ndarray), name
    np.testing.assert_array_equal(env["target"], [2, -1])


def test_host_arithmetic_on_shapes_answers_in_numpy():
    """A shape computed through Cast/Div/Mul/Cast stays numpy in the port
    (the folding wrapper), and the reshape it feeds agrees with JAX."""
    from birdnet_tpu_torch.compiler import ops as tops

    nodes = [P.make_node("Shape", ["x"], ["sh"]),
             P.make_node("Cast", ["sh"], ["shf"], to=int(P.DataType.FLOAT)),
             P.make_node("Div", ["shf", "two"], ["half"]),
             P.make_node("Mul", ["half", "two"], ["back"]),
             P.make_node("Cast", ["back"], ["target"], to=int(P.DataType.INT64)),
             P.make_node("Reshape", ["x", "target"], ["y"])]
    check_graph(nodes, {"x": normal((2, 4, 6), 1)}, {"two": np.float32(2.0)})
    ctx = tops.OpContext("Div", {})
    out = tops.get_lowering("Div")(ctx, np.array([2.0, 4.0], np.float32), np.float32(2.0))[0]
    assert isinstance(out, np.ndarray) and out.dtype == np.float32


def test_concat_of_tensors_and_host_values():
    check_op("Concat", ["a", "b", "c"], {"a": normal((2, 3), 2), "b": normal((1, 3), 3)},
             {"c": normal((2, 3), 4)}, axis=0)
    check_op("Concat", ["a", "b"], {"a": normal((2, 3), 5)}, {"b": np.zeros((2, 1), np.float32)},
             axis=-1)


@pytest.mark.parametrize("how", ["sizes", "equal", "uneven"])
def test_split(how):
    x = normal((7, 4), 6)
    if how == "sizes":
        check_op("Split", ["x", "s"], {"x": x}, {"s": np.array([2, 5], I64)}, n_out=2, opset=13)
    elif how == "equal":
        check_op("Split", ["x"], {"x": x[:6]}, n_out=3, opset=13)
    else:
        check_op("Split", ["x"], {"x": x}, n_out=2, opset=13, axis=0)


SLICE_CASES = {
    "basic": ([1, 0], [3, 4], [0, 1], [1, 2]),
    "negative-steps": ([-1, 3], [INT64_MIN, 0], [0, 1], [-1, -2]),
    "clamped": ([-100, 2], [INT64_MAX, 100], [1, 2], [1, 1]),
    "negative-start-clamps": ([INT64_MIN], [INT64_MAX], [3], [2]),
    "reverse-from-end": ([INT64_MAX], [INT64_MIN], [2], [-1]),
    "empty": ([3], [1], [1], [1]),
    "negative-axes": ([1], [-1], [-1], [1]),
}


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_slice(case):
    starts, ends, axes, steps = SLICE_CASES[case]
    check_op("Slice", ["x", "s", "e", "a", "t"], {"x": X},
             {"s": np.array(starts, I64), "e": np.array(ends, I64),
              "a": np.array(axes, I64), "t": np.array(steps, I64)})


def test_slice_attributes_before_opset_10():
    check_op("Slice", ["x"], {"x": X}, opset=9, starts=[0, 1], ends=[2, -1], axes=[1, 3])


GATHER_CASES = {
    "scalar-index": (np.array(-1, I64), 1),
    "vector-negative": (np.array([2, -1, 0, -2], I64), 3),
    "matrix": (np.array([[0, 1], [1, 0]], I64), 0),
}


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather(case):
    idx, axis = GATHER_CASES[case]
    check_op("Gather", ["x", "i"], {"x": X}, {"i": idx}, axis=axis)


def test_gather_with_data_indices():
    check_op("Gather", ["x", "i"], {"x": X, "i": np.array([1, -3, 2], I64)}, axis=2)


def test_gather_elements():
    idx = rng(7).integers(-4, 4, size=(2, 3, 2, 5)).astype(I64)
    check_op("GatherElements", ["x", "i"], {"x": X, "i": idx}, axis=2)


@pytest.mark.parametrize("batch_dims", [0, 1])
def test_gather_nd(batch_dims):
    x = normal((3, 4, 5), 8)
    if batch_dims == 0:
        idx = np.array([[0, 1], [2, -1], [1, 3]], I64)
    else:
        idx = np.array([[[1], [-1]], [[0], [2]], [[3], [3]]], I64)
    check_op("GatherND", ["x", "i"], {"x": x, "i": idx}, batch_dims=batch_dims)


SCATTER_CASES = {
    "none": ("none", False),
    "add-repeated": ("add", True),
    "mul-repeated": ("mul", True),
    "min-repeated": ("min", True),
    "max-repeated": ("max", True),
}


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_scatter_elements(case):
    """Repeated indices under a reduction: the port's float sum folds them
    in a fixed order (tests/test_torch_cuda.py holds the card to the host
    bit for bit)."""
    reduction, repeated = SCATTER_CASES[case]
    x = normal((4, 5), 9)
    if repeated:
        idx = np.array([[1, 1, 0, -1, 3], [1, 2, 2, 1, 0], [1, 3, 3, 3, 3]], I64)
    else:
        idx = np.array([[1, 0, 2, -1, 3], [0, 2, 3, 1, 0]], I64)
    upd = normal(idx.shape, 10)
    check_op("ScatterElements", ["x", "i", "u"], {"x": x, "i": idx, "u": upd}, opset=18,
             axis=0, reduction=reduction)


def test_scatter_elements_on_integers_and_axis_1():
    x = rng(11).integers(-5, 5, size=(3, 6)).astype(np.int32)
    idx = np.array([[0, 0, 5], [1, 1, 1], [-1, 2, 2]], I64)
    upd = rng(12).integers(-5, 5, size=idx.shape).astype(np.int32)
    check_op("ScatterElements", ["x", "i", "u"], {"x": x, "i": idx, "u": upd}, opset=18,
             axis=1, reduction="add")


def test_scatter_is_the_deprecated_scatter_elements():
    x = normal((4, 5), 13)
    idx = np.array([[1, 0, 2, 3, 3]], I64)
    check_op("Scatter", ["x", "i", "u"], {"x": x, "i": idx, "u": normal((1, 5), 14)}, opset=10,
             axis=0)


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_scatter_nd(case):
    reduction, repeated = SCATTER_CASES[case]
    x = normal((4, 3, 2), 15)
    idx = np.array([[1], [3], [1], [-4]], I64) if repeated else np.array([[1], [3], [0]], I64)
    upd = normal((idx.shape[0], 3, 2), 16)
    check_op("ScatterND", ["x", "i", "u"], {"x": x, "i": idx, "u": upd}, opset=18,
             reduction=reduction)


def test_scatter_nd_element_indices():
    x = normal((3, 4), 17)
    idx = np.array([[0, 1], [2, 3], [0, 1]], I64)
    check_op("ScatterND", ["x", "i", "u"], {"x": x, "i": idx, "u": normal((3,), 18)}, opset=18,
             reduction="add")


@pytest.mark.parametrize("shape", [[2, 1, 4, 5], [3, 1, 1], [1, 2, 3, 4, 5]])
def test_expand(shape):
    check_op("Expand", ["x", "s"], {"x": normal((3, 4, 1), 19)}, {"s": np.array(shape, I64)})


def test_tile():
    check_op("Tile", ["x", "r"], {"x": normal((2, 3), 20)}, {"r": np.array([2, 3], I64)})


PAD_CASES = {
    "constant-value": ("constant", [1, 0, 2, 1], 1.5, None),
    "reflect": ("reflect", [0, 2, 1, 0, 2, 3], None, None),
    "edge": ("edge", [1, 1, 0, 2, 0, 3], None, None),
    "wrap": ("wrap", [0, 3, 1, 0, 2, 2], None, None),
    "negative-crops": ("constant", [-1, 2, 1, -2], 0.0, None),
    "axes-input": ("reflect", [1, 2, 2, 1], None, [1, -1]),
}


@pytest.mark.parametrize("case", sorted(PAD_CASES))
def test_pad(case):
    mode, pads, cv, axes = PAD_CASES[case]
    x = normal((2, 3, 4), 21)
    if len(pads) == 4 and axes is None:
        x = x[0]
    ins, inits = ["x", "p"], {"p": np.array(pads, I64)}
    if cv is not None or axes is not None:
        ins.append("c" if cv is not None else "")
        if cv is not None:
            inits["c"] = np.float32(cv)
    if axes is not None:
        ins.append("a")
        inits["a"] = np.array(axes, I64)
    check_op("Pad", ins, {"x": x}, inits, opset=18, mode=mode)


RANGE_CASES = {
    "int": (np.int64(2), np.int64(17), np.int64(3)),
    "int-descending": (np.int32(10), np.int32(-3), np.int32(-4)),
    "float-steps-accumulate": (np.float32(0.0), np.float32(1.0), np.float32(0.1)),
    "float-negative": (np.float32(1.5), np.float32(-2.0), np.float32(-0.7)),
}


@pytest.mark.parametrize("case", sorted(RANGE_CASES))
def test_range(case):
    """Float Range as the JAX lowering computes it: ceil((limit - start) /
    delta) elements of ``k * delta + start`` in float64, rounded once (a
    running sum in float32 drifts by ulps), equal on both sides."""
    s, lim, d = RANGE_CASES[case]
    nodes = [P.make_node("Range", ["s", "l", "d"], ["r"]),
             P.make_node("Cast", ["r"], ["y"], to=int(P.DataType.FLOAT))]
    got = check_graph(nodes, {"x": X}, {"s": s, "l": lim, "d": d}, tol=0.0)
    if case == "float-steps-accumulate":
        np.testing.assert_array_equal(np.asarray(got[0]),
                                      (np.arange(10) * float(d)).astype(np.float32))


@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_onehot(axis):
    idx = np.array([[0, 3, -1], [5, 2, 1]], I64)  # -1 and 5 miss (jax.nn.one_hot)
    check_op("OneHot", ["i", "d", "v"], {"i": idx}, {"d": np.int64(4),
             "v": np.array([-1.0, 2.0], np.float32)}, axis=axis)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

REDUCE_OPS = {
    "ReduceSum": EXACT, "ReduceMax": EXACT, "ReduceMin": EXACT,
    "ReduceProd": EXACT, "ReduceL1": EXACT, "ReduceL2": TRANSCENDENTAL,
    "ReduceLogSum": TRANSCENDENTAL, "ReduceLogSumExp": TRANSCENDENTAL,
    "ReduceMean": EXACT, "ReduceSumSquare": EXACT,
}


@pytest.mark.parametrize("op_type", sorted(REDUCE_OPS))
@pytest.mark.parametrize("form", ["attr-opset11", "input-opset18", "all-keepdims0"])
def test_reductions(op_type, form):
    x = np.abs(X) + 0.5 if op_type == "ReduceLogSum" else X
    tol = REDUCE_OPS[op_type]
    if form == "attr-opset11":
        check_op(op_type, ["x"], {"x": x}, opset=11, tol=tol, axes=[1, -1])
    elif form == "input-opset18":
        check_op(op_type, ["x", "a"], {"x": x}, {"a": np.array([0, 2], I64)}, opset=18,
                 tol=tol)
    else:
        check_op(op_type, ["x"], {"x": x}, opset=18, tol=tol, keepdims=0)


def test_reduce_sum_axes_input_at_opset_13():
    check_op("ReduceSum", ["x", "a"], {"x": X}, {"a": np.array([-1], I64)}, opset=13,
             keepdims=0)


@pytest.mark.parametrize("opset", [13, 18])
def test_reduce_sum_noop_with_empty_axes(opset):
    """``noop_with_empty_axes`` with no axes listed (absent input, or an
    empty one) passes the input through; without it every axis reduces."""
    check_op("ReduceSum", ["x"], {"x": X}, opset=opset, noop_with_empty_axes=1)
    check_op("ReduceSum", ["x", "a"], {"x": X}, {"a": np.zeros(0, I64)}, opset=opset,
             noop_with_empty_axes=1)
    check_op("ReduceSum", ["x", "a"], {"x": X}, {"a": np.zeros(0, I64)}, opset=opset)


def test_reduce_on_integers():
    x = rng(22).integers(-9, 9, size=(3, 4)).astype(np.int32)
    for op_type in ("ReduceSum", "ReduceMax", "ReduceProd", "ReduceL1"):
        check_op(op_type, ["x", "a"], {"x": x}, {"a": np.array([1], I64)}, opset=18)


@pytest.mark.parametrize("precision", ["mixed", "fast"])
def test_reduce_sum_under_the_policies(precision):
    """The TF dialect's power: Mul + ReduceSum after a policy product."""
    check_after_matmul("ReduceSum", precision, (2, 7, 16), 10, inits={"a": np.array([-1], I64)},
                       extra_ins=("a",), keepdims=0)


TIES = np.array([[1.0, 3.0, 3.0, 0.0, 3.0], [2.0, 2.0, -1.0, -1.0, 0.0]], np.float32)


@pytest.mark.parametrize("op_type", ["ArgMax", "ArgMin"])
@pytest.mark.parametrize("last", [0, 1])
@pytest.mark.parametrize("axis,keepdims", [(1, 1), (0, 0), (-1, 0)])
def test_arg_reductions_with_ties(op_type, last, axis, keepdims):
    check_op(op_type, ["x"], {"x": TIES}, axis=axis, keepdims=keepdims, select_last_index=last)


@pytest.mark.parametrize("largest", [1, 0])
@pytest.mark.parametrize("axis", [-1, 0])
def test_topk_ties_lower_index_first(largest, axis):
    x = np.array([[3.0, 1.0, 3.0, 2.0, 1.0, 3.0], [0.0, 0.0, 5.0, 5.0, -1.0, 0.0]], np.float32)
    x = x if axis == -1 else x.T.copy()
    got = check_op("TopK", ["x", "k"], {"x": x}, {"k": np.array([2], I64)}, n_out=2,
                   axis=axis, largest=largest)
    if largest and axis == -1:
        np.testing.assert_array_equal(np.asarray(got[1]), [[0, 2], [2, 3]])


def test_topk_on_data():
    check_op("TopK", ["x", "k"], {"x": normal((3, 40), 23)}, {"k": np.array([7], I64)}, n_out=2)


@pytest.mark.parametrize("exclusive,reverse", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_cumsum(exclusive, reverse):
    check_op("CumSum", ["x", "a"], {"x": normal((3, 6), 24)}, {"a": np.int64(1)},
             exclusive=exclusive, reverse=reverse)


def test_cumsum_integers():
    x = rng(25).integers(-9, 9, size=(4, 5)).astype(np.int32)
    check_op("CumSum", ["x", "a"], {"x": x}, {"a": np.int64(0)})


# ---------------------------------------------------------------------------
# compile-time constants
# ---------------------------------------------------------------------------

STATIC_CASES = {
    # op: (attrs, the data input, the argument that must be static, position)
    "Reshape": ({}, normal((2, 6), 26), np.array([3, 4], I64), "Reshape shape"),
    "Expand": ({}, normal((1, 3), 27), np.array([2, 3], I64), "Expand shape"),
    "Tile": ({}, normal((2, 3), 28), np.array([2, 1], I64), "Tile repeats"),
    "TopK": ({}, normal((2, 5), 29), np.array([2], I64), "TopK k"),
    "Slice": ({}, normal((4, 3), 30), np.array([1], I64), "Slice starts"),
    "Pad": ({}, normal((2, 3), 31), np.array([0, 1, 0, 1], I64), "Pad pads"),
}


@pytest.mark.parametrize("op_type", sorted(STATIC_CASES))
def test_values_on_the_card_must_be_compile_time_constants(op_type):
    """Where the JAX lowering needs a compile-time constant and raises on a
    tracer, the port raises the same on a tensor that lives on a device
    (read back, it would sync every forward): here a meta-device tensor,
    which stands for the card on a host without one."""
    from birdnet_tpu.compiler import ops as jops
    from birdnet_tpu_torch.compiler import ops as tops

    attrs, x, static, what = STATIC_CASES[op_type]
    extra = [np.array([3], I64)] if op_type == "Slice" else []
    with pytest.raises(ValueError, match=f"{what} must be a compile-time constant"):
        tops.get_lowering(op_type)(tops.OpContext(op_type, attrs), torch.from_numpy(x),
                                   torch.from_numpy(static).to("meta"), *extra)

    def traced(s):
        return jops.get_lowering(op_type)(jops.OpContext(op_type, attrs), x, s, *extra)[0]

    with pytest.raises(ValueError, match=f"{what} must be a compile-time constant"):
        jax.jit(traced)(static)


@pytest.mark.parametrize("op_type", ["Range", "OneHot"])
def test_range_and_onehot_need_constants(op_type):
    from birdnet_tpu.compiler import ops as jops
    from birdnet_tpu_torch.compiler import ops as tops

    meta = torch.zeros((), dtype=torch.int64, device="meta")
    if op_type == "Range":
        args, what = (meta, np.int64(5), np.int64(1)), "Range start"
    else:
        args, what = (np.array([0, 1], I64), meta, np.array([0.0, 1.0], np.float32)), \
            "OneHot depth"
    with pytest.raises(ValueError, match=f"{what} must be a compile-time constant"):
        tops.get_lowering(op_type)(tops.OpContext(op_type, {}), *args)

    def traced(v):
        jargs = (v,) + args[1:] if op_type == "Range" else (args[0], v, args[2])
        return jops.get_lowering(op_type)(jops.OpContext(op_type, {}), *jargs)[0]

    with pytest.raises(ValueError, match="must be a compile-time constant"):
        jax.jit(traced)(np.int64(0) if op_type == "Range" else np.int64(2))


def test_transpose_after_a_fast_product_stays_bf16():
    """A shape op after a policy product keeps the product's dtype."""
    got = check_after_matmul("Transpose", "fast", (2, 3, 16), 8, perm=[0, 2, 1], tol=POLICY)
    assert got[0].dtype_name == "bfloat16"


@pytest.mark.parametrize("value", [np.int64(0), np.float32(2.5), np.array([[1, 2]], np.int32),
                                   np.arange(6, dtype=np.float32).reshape(2, 3).T])
def test_a_host_value_reaches_a_device_with_its_shape(value):
    """``_on_device`` (how a host value reaches the card, once per value)
    keeps a 0-d value 0-d and a transposed one's values: a 0-d Gather index
    on the card once came out 1-d, so a ``past[0]`` kept its axis."""
    from birdnet_tpu_torch.compiler.ops import _on_device

    got = _on_device(value, "cpu")
    assert got.shape == np.shape(value)
    np.testing.assert_array_equal(got.numpy(), value)
