"""The port's ai.onnx core lowerings, network part: Einsum and
ConvTranspose under the precision policies, the normalizations, pooling,
and the signal and sequence extensions (the JAX file's ``:594``, ``:748``,
``:808-1110`` and ``:3040-3331``), each through the JAX package and the
port on the same seeded inputs (tests/_torch_core_common.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_core_common import (  # noqa: E402
    EXACT, POLICY, TRANSCENDENTAL, check_after_matmul, check_graph, check_op, model_bytes,
    normal, rng, run_jax, run_port,
)
from birdnet_tpu.onnx import proto as P  # noqa: E402

I64 = np.int64


# ---------------------------------------------------------------------------
# Einsum and ConvTranspose under the policies
# ---------------------------------------------------------------------------

EINSUM_CASES = {
    "batched-matmul": ("bij,bjk->bik", [(2, 3, 16), (2, 16, 5)]),
    "transpose": ("ij->ji", [(4, 6)]),
    "outer": ("i,j->ij", [(5,), (7,)]),
    "reduce-ellipsis": ("...ij->...i", [(2, 3, 4, 8)]),
    "spaces": ("b i d , b j d -> b i j", [(2, 4, 16), (2, 3, 16)]),
}


@pytest.mark.parametrize("precision", ["fp32", "mixed", "fast"])
@pytest.mark.parametrize("case", sorted(EINSUM_CASES))
def test_einsum(case, precision):
    eq, shapes = EINSUM_CASES[case]
    inputs = {f"x{i}": normal(s, 10 + i) for i, s in enumerate(shapes)}
    got = check_op("Einsum", list(inputs), inputs, precision=precision,
                   tol=EXACT if precision == "fp32" else POLICY, equation=eq)
    assert got[0].dtype_name == ("bfloat16" if precision == "fast" else "float32")


CONVT_CASES = {
    "2d-stride2": ((1, 4, 5, 6), (4, 3, 3, 3), dict(strides=[2, 2])),
    "2d-asymmetric-pads": ((2, 2, 4, 4), (2, 3, 3, 2),
                           dict(strides=[2, 1], pads=[1, 0, 0, 1])),
    "2d-output-padding": ((1, 2, 3, 5), (2, 2, 3, 3),
                          dict(strides=[2, 2], pads=[1, 1, 1, 1], output_padding=[1, 0])),
    "2d-groups-dilation": ((1, 4, 5, 5), (4, 2, 3, 3), dict(group=2, dilations=[2, 1])),
    "1d": ((2, 3, 9), (3, 4, 4), dict(strides=[3], pads=[1, 2])),
    "same-upper": ((1, 2, 6, 7), (2, 3, 3, 3), dict(strides=[2, 2], auto_pad="SAME_UPPER")),
}


@pytest.mark.parametrize("precision", ["fp32", "mixed", "fast"])
@pytest.mark.parametrize("case", sorted(CONVT_CASES))
def test_conv_transpose(case, precision):
    xs, ws, attrs = CONVT_CASES[case]
    inputs = {"x": normal(xs, 20)}
    inits = {"w": normal(ws, 21, 0.3), "b": normal((ws[1] * attrs.get("group", 1),), 22)}
    check_op("ConvTranspose", ["x", "w", "b"], inputs, inits, precision=precision,
             tol=EXACT if precision == "fp32" else POLICY, **attrs)


def test_conv_transpose_after_a_fast_product():
    """Under ``fast`` the activations are bf16 and the weights float32: the
    JAX lowering hands lax both as they are and raises; the port rounds
    both operands (ROADMAP C) and agrees with JAX's float32 result within
    the policy bound."""
    x = normal((1, 4, 3, 16), 23)
    w = normal((16, 4), 24, 0.25)
    wt = normal((4, 2, 3, 3), 25, 0.3)
    nodes = [P.make_node("MatMul", ["x", "w"], ["h"]),
             P.make_node("ConvTranspose", ["h", "wt"], ["y"], strides=[2, 2])]
    data = model_bytes(nodes, {"x": x}, {"w": w, "wt": wt}, ["y"], 17)
    with pytest.raises(TypeError, match="same dtypes"):
        run_jax(data, {"x": x}, "fast")
    got = np.asarray(run_port(data, {"x": x}, "fast")[0], np.float64)
    want = np.asarray(run_jax(data, {"x": x}, "fp32")[0], np.float64)
    assert np.abs(got - want).max() <= 2 ** -6 * np.abs(want).max()


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def test_instance_normalization():
    check_op("InstanceNormalization", ["x", "s", "b"], {"x": normal((2, 3, 5, 4), 30)},
             {"s": normal((3,), 31), "b": normal((3,), 32)}, tol=TRANSCENDENTAL, epsilon=1e-3)


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_normalization_with_mean_and_inv_std(axis):
    """Mean and InvStdDev as the second and third outputs; ``stash_type``
    is carried and, as in the JAX lowering, not read."""
    x = normal((2, 3, 8), 33)
    shape = x.shape[axis:] if axis > 0 else x.shape[-1:]
    check_op("LayerNormalization", ["x", "s", "b"], {"x": x},
             {"s": normal(shape, 34), "b": normal(shape, 35)}, n_out=3, tol=TRANSCENDENTAL,
             axis=axis, epsilon=1e-5, stash_type=1)


@pytest.mark.parametrize("precision", ["mixed", "fast"])
def test_layer_normalization_under_the_policies(precision):
    check_after_matmul("LayerNormalization", precision, (2, 5, 16), 24,
                       inits={"s": normal((24,), 36), "b": normal((24,), 37)},
                       extra_ins=("s", "b"), n_out=3, axis=-1)


def test_group_normalization_per_channel_opset_21():
    check_op("GroupNormalization", ["x", "s", "b"], {"x": normal((2, 6, 4, 3), 38)},
             {"s": normal((6,), 39), "b": normal((6,), 40)}, opset=21, tol=TRANSCENDENTAL,
             num_groups=3)


def test_group_normalization_per_group_opset_18():
    """Opset 18 gives one scale and bias per group: the port repeats each
    over its group's channels; the JAX lowering reshapes it per channel and
    raises (ROADMAP C)."""
    x = normal((2, 6, 4, 3), 41)
    s, b = normal((3,), 42), normal((3,), 43)
    data = model_bytes([P.make_node("GroupNormalization", ["x", "s", "b"], ["y"],
                                    num_groups=3)], {"x": x}, {"s": s, "b": b}, ["y"], 18)
    got = np.asarray(run_port(data, {"x": x})[0], np.float64)
    xg = x.reshape(2, 3, 2, 4, 3).astype(np.float64)
    mean = xg.mean(axis=(2, 3, 4), keepdims=True)
    var = xg.var(axis=(2, 3, 4), keepdims=True)
    want = ((xg - mean) / np.sqrt(var + 1e-5)).reshape(x.shape)
    want = want * np.repeat(s, 2)[None, :, None, None] + np.repeat(b, 2)[None, :, None, None]
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(TypeError, match="broadcast"):
        run_jax(data, {"x": x})


def test_lrn():
    check_op("LRN", ["x"], {"x": normal((2, 7, 3, 4), 44)}, tol=TRANSCENDENTAL, size=3,
             alpha=1e-3, beta=0.6, bias=1.5)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

MAXPOOL_CASES = {
    "same-upper-neg-inf-pad": ((1, 2, 5, 7), dict(kernel_shape=[2, 2], strides=[2, 2],
                                                  auto_pad="SAME_UPPER")),
    "ceil-mode": ((2, 3, 6, 7), dict(kernel_shape=[3, 3], strides=[2, 2], ceil_mode=1)),
    "dilations-pads": ((1, 2, 8, 9), dict(kernel_shape=[2, 3], dilations=[2, 2],
                                          pads=[1, 0, 1, 2])),
    "1d": ((2, 3, 11), dict(kernel_shape=[3], strides=[2], pads=[1, 1])),
    "3d": ((1, 2, 4, 5, 6), dict(kernel_shape=[2, 2, 2], strides=[1, 2, 2])),
}


@pytest.mark.parametrize("case", sorted(MAXPOOL_CASES))
@pytest.mark.parametrize("storage_order", [0, 1])
def test_maxpool_with_indices(case, storage_order):
    """Values and the Indices output: flat over the whole tensor (N and C
    included), row- or column-major spatial block, ties to the first valid
    kernel position."""
    shape, attrs = MAXPOOL_CASES[case]
    x = np.round(normal(shape, 50) * 2) / 2  # ties
    x.reshape(-1)[::7] = -np.inf
    check_op("MaxPool", ["x"], {"x": x}, n_out=2, storage_order=storage_order, **attrs)


def test_maxpool_on_integers():
    x = rng(51).integers(-50, 50, size=(1, 2, 5, 5)).astype(np.int32)
    check_op("MaxPool", ["x"], {"x": x}, kernel_shape=[2, 2], strides=[2, 2],
             auto_pad="SAME_UPPER")


def test_maxunpool_inverts_maxpool():
    x = normal((2, 3, 6, 6), 52)
    nodes = [P.make_node("MaxPool", ["x"], ["p", "i"], kernel_shape=[2, 2], strides=[2, 2]),
             P.make_node("MaxUnpool", ["p", "i"], ["y"], kernel_shape=[2, 2], strides=[2, 2])]
    check_graph(nodes, {"x": x})


AVGPOOL_CASES = {
    "exclude-pad": dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1]),
    "include-pad": dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1],
                        count_include_pad=1),
    "include-pad-ceil": dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 0, 1, 0],
                             count_include_pad=1, ceil_mode=1),
    "exclude-pad-ceil": dict(kernel_shape=[2, 3], strides=[2, 2], ceil_mode=1),
    "same-upper-dilated": dict(kernel_shape=[2, 2], dilations=[2, 1], auto_pad="SAME_UPPER"),
}


@pytest.mark.parametrize("case", sorted(AVGPOOL_CASES))
def test_average_pool(case):
    """The divisor at the ceil edge counts the explicit padding but not the
    overhang under count_include_pad (where torch's own divisor differs)."""
    check_op("AveragePool", ["x"], {"x": normal((2, 2, 7, 8), 53)}, opset=19,
             **AVGPOOL_CASES[case])


def test_global_pools():
    x = normal((2, 3, 4, 5), 54)
    check_op("GlobalMaxPool", ["x"], {"x": x})
    check_op("GlobalLpPool", ["x"], {"x": x}, tol=TRANSCENDENTAL, p=2)
    check_op("GlobalLpPool", ["x"], {"x": x}, tol=TRANSCENDENTAL, p=3)


@pytest.mark.parametrize("p", [2, 3])
def test_lp_pool(p):
    check_op("LpPool", ["x"], {"x": normal((1, 2, 6, 7), 55)}, tol=TRANSCENDENTAL, opset=18,
             kernel_shape=[2, 3], strides=[2, 2], pads=[0, 1, 1, 0], p=p)


# ---------------------------------------------------------------------------
# signal and extensions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op_type", ["HannWindow", "HammingWindow", "BlackmanWindow"])
@pytest.mark.parametrize("periodic", [1, 0])
def test_windows(op_type, periodic):
    nodes = [P.make_node(op_type, ["n"], ["w"], periodic=periodic),
             P.make_node("Mul", ["x", "w"], ["y"])]
    check_graph(nodes, {"x": normal((3, 16), 60)}, {"n": np.int64(16)}, opset=17)


@pytest.mark.parametrize("mode", ["DCR", "CRD"])
def test_depth_to_space(mode):
    check_op("DepthToSpace", ["x"], {"x": normal((2, 8, 3, 4), 61)}, blocksize=2, mode=mode)


def test_space_to_depth():
    check_op("SpaceToDepth", ["x"], {"x": normal((2, 3, 4, 6), 62)}, blocksize=2)


@pytest.mark.parametrize("p", [1, 2])
def test_lp_normalization(p):
    check_op("LpNormalization", ["x"], {"x": normal((3, 5, 4), 63)}, tol=TRANSCENDENTAL,
             axis=1, p=p)


@pytest.mark.parametrize("batch_axis,time_axis", [(1, 0), (0, 1)])
def test_reverse_sequence(batch_axis, time_axis):
    x = normal((5, 3, 2) if batch_axis == 1 else (3, 5, 2), 64)
    check_op("ReverseSequence", ["x", "l"], {"x": x, "l": np.array([5, 1, 3], I64)},
             batch_axis=batch_axis, time_axis=time_axis)


DFT_CASES = {
    "opset17-attr-axis-onesided": (17, (2, 16, 1), dict(axis=1, onesided=1), None),
    "opset17-complex": (17, (2, 12, 3, 2), dict(axis=1), None),
    "opset17-inverse": (17, (3, 10, 2), dict(axis=1, inverse=1), None),
    "opset20-axis-input": (20, (2, 3, 8, 1), dict(), -2),
    "opset20-axis-input-onesided": (20, (2, 9, 4, 1), dict(onesided=1), 1),
}


@pytest.mark.parametrize("case", sorted(DFT_CASES))
def test_dft(case):
    """``axis`` as an attribute (opset 17) or an input (opset 20);
    ``onesided`` and ``inverse``."""
    opset, shape, attrs, axis = DFT_CASES[case]
    ins, inits = ["x"], {}
    if axis is not None:
        ins += ["", "a"]
        inits["a"] = np.int64(axis)
    check_op("DFT", ins, {"x": normal(shape, 65)}, inits, opset=opset, tol=TRANSCENDENTAL,
             **attrs)


def test_dft_length_pads_or_crops():
    check_op("DFT", ["x", "n"], {"x": normal((2, 10, 1), 66)}, {"n": np.int64(16)},
             opset=17, tol=TRANSCENDENTAL, axis=1)
