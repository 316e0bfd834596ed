"""The port's ai.onnx core lowerings, trivial and elementwise part (the
JAX file's ``:210-555``, ``:1856-1893`` and ``:3186-3203``): each op as a
one-node graph through the JAX package and the port on the same seeded
inputs (tests/_torch_core_common.py), plus the registry and the int64 and
unsigned-dtype differences of ROADMAP C."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_core_common import (  # noqa: E402
    EXACT, POLICY, TRANSCENDENTAL, check_after_matmul, check_graph, check_op, model_bytes,
    normal, rng, run_jax, run_port,
)
from birdnet_tpu.onnx import proto as P  # noqa: E402

# The JAX package's ops.py names that the port leaves for later: none.
DEFERRED_OPS_PY = set()


def test_registry_is_the_ops_py_core_less_the_deferred_names():
    """The port's registry: the names birdnet_tpu/compiler/ops.py registers,
    less the deferred ones, plus ``Scatter`` (ops_extended.py's alias of
    ScatterElements), the names of ops_extended.py and
    ``SimplifiedLayerNormalization`` (ops_contrib.py's one core name): 204
    names, the JAX registry's."""
    import re
    from pathlib import Path

    from birdnet_tpu.compiler import ops as jops
    from birdnet_tpu.compiler import ops_extended as jext
    from birdnet_tpu_torch.compiler import ops as tops

    def registered(module):
        names = set()
        for line in Path(module.__file__).read_text().splitlines():
            if line.lstrip().startswith(("@op(", "op(")):
                names.update(re.findall(r'"([A-Za-z_0-9]+)"', line.split(")")[0]))
        return names

    port = set(tops.supported_ops())
    assert port == ((registered(jops) - DEFERRED_OPS_PY) | registered(jext)
                    | {"SimplifiedLayerNormalization"})
    assert len(port) == 204
    assert port == set(jops.supported_ops())


X = normal((2, 3, 4, 5), 0)
POS = np.abs(normal((2, 3, 4), 1)) + 0.1
UNIT = np.clip(normal((2, 3, 4), 2, 0.5), -0.99, 0.99).astype(np.float32)
I32 = rng(3).integers(-20, 20, size=(3, 4)).astype(np.int32)
I32B = np.where(rng(4).integers(-6, 6, size=(3, 4)) == 0, 3,
                rng(4).integers(-6, 6, size=(3, 4))).astype(np.int32)
BOOL_A = rng(5).random((3, 4)) < 0.5
BOOL_B = rng(6).random((3, 4)) < 0.5
TIES = np.array([[0.5, 1.5, 2.5, -0.5], [-1.5, -2.5, 3.5, 0.49]], np.float32)
SPECIAL = np.array([[1.0, np.inf, -np.inf, np.nan], [0.0, -2.0, 3.0, np.nan]], np.float32)


# ---------------------------------------------------------------------------
# trivial
# ---------------------------------------------------------------------------


def test_identity():
    check_op("Identity", ["x"], {"x": X})


def test_dropout_with_mask():
    got = check_op("Dropout", ["x"], {"x": X}, n_out=2)
    assert got[1].dtype_name == "bool" and np.asarray(got[1]).all()


CAST_CASES = {
    "float-to-int32-truncates": (np.array([[1.7, -1.7, 2.5, -0.2]], np.float32), P.DataType.INT32),
    "float-to-bool": (np.array([[0.0, -0.0, 0.1, -3.0]], np.float32), P.DataType.BOOL),
    "int-to-float": (I32, P.DataType.FLOAT),
    "float-to-float16": (X, P.DataType.FLOAT16),
    "float-to-uint8": (np.array([[0.0, 1.9, 200.5, 255.0]], np.float32), P.DataType.UINT8),
    "bool-to-int64": (BOOL_A, P.DataType.INT64),
}


@pytest.mark.parametrize("case", sorted(CAST_CASES))
def test_cast(case):
    x, to = CAST_CASES[case]
    check_op("Cast", ["x"], {"x": x}, to=int(to))


@pytest.mark.parametrize("saturate", [1, 0])
def test_cast_to_float8_saturates(saturate):
    """Cast to float8 e4m3fn (opset 19) and back: with ``saturate`` out of
    range values clamp to ±448; in range they round."""
    x = np.array([[1.0, -3.3, 0.07, 447.0]], np.float32) if not saturate else \
        np.array([[1000.0, -1000.0, 0.3, 5.7]], np.float32)
    nodes = [P.make_node("Cast", ["x"], ["f8"], to=int(P.DataType.FLOAT8E4M3FN),
                         saturate=saturate),
             P.make_node("Cast", ["f8"], ["y"], to=int(P.DataType.FLOAT))]
    got = check_graph(nodes, {"x": x}, opset=19)
    if saturate:
        assert np.asarray(got[0])[0, 0] == 448.0 and np.asarray(got[0])[0, 1] == -448.0


def test_cast_like():
    check_op("CastLike", ["x", "like"], {"x": X}, {"like": np.zeros(2, np.int32)})


def test_constant_forms():
    tensor = P.TensorProto.from_numpy(normal((2, 3), 7), name="c")
    nodes = [P.make_node("Constant", [], ["a"], value=tensor),
             P.make_node("Constant", [], ["b"], value_float=2.5),
             P.make_node("Constant", [], ["c"], value_ints=[1, 2, 3]),
             P.make_node("Add", ["x", "a"], ["y"]),
             P.make_node("Mul", ["y", "b"], ["z"])]
    check_graph(nodes, {"x": normal((2, 3), 8)}, outputs=("z", "c"))


def test_constant_of_shape():
    fill = P.TensorProto.from_numpy(np.array([7], np.int32), name="v")
    nodes = [P.make_node("ConstantOfShape", ["s"], ["a"], value=fill),
             P.make_node("ConstantOfShape", ["s"], ["b"]),
             P.make_node("Add", ["x", "b"], ["y"])]
    check_graph(nodes, {"x": normal((2, 3), 9)}, {"s": np.array([2, 3], np.int64)},
                outputs=("a", "y"))


# ---------------------------------------------------------------------------
# the binary table, Mod, the variadic ops
# ---------------------------------------------------------------------------

BINARY_CASES = {
    "Sub": ("float", {}),
    "Div": ("float", {}),
    "Equal": ("ints", {}),
    "Greater": ("ints", {}),
    "Less": ("ints", {}),
    "GreaterOrEqual": ("ints", {}),
    "LessOrEqual": ("ints", {}),
    "And": ("bool", {}),
    "Or": ("bool", {}),
    "Xor": ("bool", {}),
    "BitwiseAnd": ("ints", {}),
    "BitwiseOr": ("ints", {}),
    "BitwiseXor": ("ints", {}),
}


def _pair(kind):
    if kind == "float":
        return normal((3, 4), 10), normal((4,), 11) + 3.0
    if kind == "ints":
        return I32, I32B
    return BOOL_A, BOOL_B


@pytest.mark.parametrize("op_type", sorted(BINARY_CASES))
def test_binary_ops(op_type):
    a, b = _pair(BINARY_CASES[op_type][0])
    check_op(op_type, ["a", "b"], {"a": a, "b": b})


@pytest.mark.parametrize("op_type", ["Sub", "Div", "Greater", "Equal"])
def test_binary_ops_with_a_host_scalar(op_type):
    """A host 0-d constant on either side, as exporters write epsilons."""
    check_op(op_type, ["a", "s"], {"a": normal((3, 4), 12)}, {"s": np.float32(0.25)})
    check_op(op_type, ["s", "a"], {"a": normal((3, 4), 13) + 2.0}, {"s": np.float32(1.5)})


def test_integer_div_truncates_toward_zero():
    """ONNX Div on integers truncates (lax.div), -7 / 2 = -3, not -4."""
    a = np.array([[-7, 7, -8, 9, -1, 0]], np.int32)
    b = np.array([[2, -2, 3, -4, 5, 3]], np.int32)
    got = check_op("Div", ["a", "b"], {"a": a, "b": b})
    np.testing.assert_array_equal(np.asarray(got[0]), [[-3, -3, -2, -2, 0, 0]])


def test_pow_keeps_the_base_dtype():
    check_op("Pow", ["a", "b"], {"a": POS}, {"b": np.array([2.0, 0.5, 3.0, -1.0], np.float32)},
             tol=TRANSCENDENTAL)
    check_op("Pow", ["a", "e"], {"a": normal((3, 4), 14)}, {"e": np.int64(3)},
             tol=TRANSCENDENTAL)


MOD_CASES = {
    "fmod-float": (np.array([[5.5, -5.5, 5.5, -5.5]], np.float32),
                   np.array([[2.0, 2.0, -2.0, -2.0]], np.float32), 1),
    "fmod-int": (np.array([[7, -7, 7, -7]], np.int32), np.array([[3, 3, -3, -3]], np.int32), 1),
    "mod-int-sign-of-divisor": (np.array([[7, -7, 7, -7]], np.int32),
                                np.array([[3, 3, -3, -3]], np.int32), 0),
}


@pytest.mark.parametrize("case", sorted(MOD_CASES))
def test_mod(case):
    a, b, fmod = MOD_CASES[case]
    check_op("Mod", ["a", "b"], {"a": a, "b": b}, fmod=fmod)


@pytest.mark.parametrize("op_type", ["Min", "Max", "Sum", "Mean"])
def test_variadic_ops(op_type):
    check_op(op_type, ["a", "b", "c"],
             {"a": normal((2, 3, 4), 15), "b": normal((3, 4), 16)}, {"c": np.float32(0.1)})


def test_mean_of_integers_is_float():
    check_op("Mean", ["a", "b"], {"a": I32, "b": I32B})


# ---------------------------------------------------------------------------
# the unary table and the activations
# ---------------------------------------------------------------------------

UNARY_CASES = {
    "Sqrt": (POS, TRANSCENDENTAL), "Exp": (UNIT, TRANSCENDENTAL), "Abs": (X, EXACT),
    "Neg": (X, EXACT), "Floor": (X * 3, EXACT), "Ceil": (X * 3, EXACT),
    "Round": (TIES, EXACT), "Sign": (X, EXACT), "Not": (BOOL_A, EXACT),
    "Reciprocal": (POS, EXACT), "Sin": (X, TRANSCENDENTAL), "Cos": (X, TRANSCENDENTAL),
    "Tan": (UNIT, TRANSCENDENTAL), "Asin": (UNIT, TRANSCENDENTAL),
    "Acos": (UNIT, TRANSCENDENTAL), "Atan": (X, TRANSCENDENTAL),
    "Sinh": (UNIT, TRANSCENDENTAL), "Cosh": (UNIT, TRANSCENDENTAL),
    "Tanh": (X, TRANSCENDENTAL), "Erf": (X, TRANSCENDENTAL),
    "Softplus": (X * 10, TRANSCENDENTAL), "Softsign": (X, EXACT),
    "Mish": (X * 4, TRANSCENDENTAL), "HardSwish": (X * 4, EXACT), "IsNaN": (SPECIAL, EXACT),
    "BitwiseNot": (I32, EXACT), "Relu": (X, EXACT), "Sigmoid": (X, TRANSCENDENTAL),
    "Log": (POS, TRANSCENDENTAL),
}


@pytest.mark.parametrize("op_type", sorted(UNARY_CASES))
def test_unary_ops(op_type):
    x, tol = UNARY_CASES[op_type]
    check_op(op_type, ["x"], {"x": x}, tol=tol)


def test_unary_op_on_integers_gives_float():
    check_op("Sqrt", ["x"], {"x": np.abs(I32)}, tol=TRANSCENDENTAL)


@pytest.mark.parametrize("neg,pos", [(1, 1), (0, 1), (1, 0)])
def test_isinf_halves(neg, pos):
    check_op("IsInf", ["x"], {"x": SPECIAL}, detect_negative=neg, detect_positive=pos)


ACTIVATION_CASES = {
    "LeakyRelu": ({"alpha": 0.2}, EXACT), "Elu": ({"alpha": 0.7}, TRANSCENDENTAL),
    "Selu": ({}, TRANSCENDENTAL), "HardSigmoid": ({"alpha": 0.3, "beta": 0.4}, EXACT),
    "Gelu": ({}, TRANSCENDENTAL), "Celu": ({"alpha": 0.8}, TRANSCENDENTAL),
    "ThresholdedRelu": ({"alpha": 0.3}, EXACT), "Shrink": ({"lambd": 0.4, "bias": 0.1}, EXACT),
}


@pytest.mark.parametrize("op_type", sorted(ACTIVATION_CASES))
def test_activations(op_type):
    attrs, tol = ACTIVATION_CASES[op_type]
    check_op(op_type, ["x"], {"x": X * 2}, tol=tol, opset=20 if op_type == "Gelu" else 17,
             **attrs)


def test_gelu_tanh_approximation():
    check_op("Gelu", ["x"], {"x": X * 2}, tol=TRANSCENDENTAL, opset=20, approximate="tanh")


def test_prelu_per_channel_slope():
    check_op("PRelu", ["x", "s"], {"x": X}, {"s": normal((3, 1, 1), 17)})


def test_clip_with_inputs():
    check_op("Clip", ["x", "lo", "hi"], {"x": X}, {"lo": np.float32(-0.5), "hi": np.float32(0.7)})
    check_op("Clip", ["x", "", "hi"], {"x": X}, {"hi": np.float32(0.2)})
    check_op("Clip", ["x"], {"x": I32}, opset=13)


def test_clip_attributes_before_opset_11():
    check_op("Clip", ["x"], {"x": X}, opset=10, min=-0.3, max=0.4)


def test_where_broadcasts_and_promotes():
    check_op("Where", ["c", "a", "b"], {"c": rng(18).random((3, 4)) < 0.5,
                                        "a": normal((3, 4), 19)}, {"b": np.float32(-1.0)})


@pytest.mark.parametrize("op_type", ["Softmax", "LogSoftmax", "Hardmax"])
@pytest.mark.parametrize("opset,axis", [(13, 1), (13, -1), (11, 1), (11, 2)])
def test_softmax_family(op_type, opset, axis):
    """Opset 13 normalizes along ``axis``; before 13 the input is flattened
    to 2-D at ``axis`` and normalized over the flattened tail."""
    x = np.round(X * 4) / 4  # ties for Hardmax
    check_op(op_type, ["x"], {"x": x}, tol=TRANSCENDENTAL, opset=opset, axis=axis)


@pytest.mark.parametrize("precision", ["mixed", "fast"])
def test_softmax_under_the_policies(precision):
    check_after_matmul("Softmax", precision, (2, 5, 16), 12, axis=-1)


# ---------------------------------------------------------------------------
# misc and bitwise extensions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("upper,k", [(1, 0), (0, 0), (1, 1), (0, -1)])
def test_trilu(upper, k):
    check_op("Trilu", ["x", "k"], {"x": normal((2, 4, 5), 20)}, {"k": np.int64(k)},
             upper=upper)


@pytest.mark.parametrize("attrs", [{}, {"k": 1}, {"k": -2, "dtype": int(P.DataType.INT32)}])
def test_eyelike(attrs):
    check_op("EyeLike", ["x"], {"x": normal((4, 6), 21)}, **attrs)


@pytest.mark.parametrize("direction", ["LEFT", "RIGHT"])
def test_bitshift(direction):
    x = np.array([[1, 2, 128, 255]], np.uint8)
    s = np.array([[1, 3, 1, 4]], np.uint8)
    check_op("BitShift", ["x", "s"], {"x": x, "s": s}, direction=direction)


# ---------------------------------------------------------------------------
# deliberate differences (ROADMAP C), each pinned on both sides
# ---------------------------------------------------------------------------


def test_int64_beyond_int32_stays_int64_in_the_port():
    """The JAX package runs with x64 off: ONNX int64 is int32 there, and a
    product past 2^31 wraps. The port keeps int64."""
    a = np.array([[3_000_000_000, -5, 2 ** 40]], np.int64)
    b = np.array([[2, 3, 2]], np.int64)
    data = model_bytes([P.make_node("Mul", ["a", "b"], ["y"])], {"a": a, "b": b}, {}, ["y"], 17)
    got = np.asarray(run_port(data, {"a": a, "b": b})[0])
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, a * b)
    want = np.asarray(run_jax(data, {"a": a, "b": b})[0])
    assert want.dtype == np.int32
    assert not np.array_equal(want.astype(np.int64), a * b)
    np.testing.assert_array_equal(want[0, 1], -15)  # in range: equal


def test_wide_unsigned_arithmetic_raises_naming_the_dtype():
    """torch has no add kernel for uint32: the port raises
    NotImplementedError naming the dtype (it computes it in no other
    dtype); the JAX package adds."""
    a = np.array([[1, 2, 4_000_000_000]], np.uint32)
    data = model_bytes([P.make_node("Add", ["a", "a"], ["y"])], {"a": a}, {}, ["y"], 17)
    with pytest.raises(NotImplementedError, match="uint32"):
        run_port(data, {"a": a})
    want = np.asarray(run_jax(data, {"a": a})[0])
    np.testing.assert_array_equal(want, (a + a).astype(np.uint32))
    # What torch can do on these types it does: equality and casts.
    check_op("Equal", ["a", "b"], {"a": a, "b": np.array([[1, 3, 4_000_000_000]], np.uint32)})
    check_op("Cast", ["a"], {"a": a}, to=int(P.DataType.FLOAT))


@pytest.mark.parametrize("precision", ["mixed", "fast"])
def test_elementwise_after_a_policy_product_keeps_its_dtype(precision):
    """An elementwise op after a policy product keeps the policy's dtype
    (bf16 under fast, float32 under mixed), as in the JAX package."""
    got = check_after_matmul("Tanh", precision, (3, 16), 8, tol=POLICY)
    assert got[0].dtype_name == ("bfloat16" if precision == "fast" else "float32")
