"""The port's int8 lowerings against the JAX package's, on one-node graphs:
QuantizeLinear, DequantizeLinear, QLinearConv (the stem 3x3 stride-2,
depthwise and 1x1 forms; the 1x1 form takes B3's plain version in the
port), QLinearMatMul, _QLinearGemm, ConvInteger, MatMulInteger and
DynamicQuantizeLinear. The cases mirror tests/test_quantized_ops.py;
QuantizeLinear and Cast to the four float8 types compare bits.

The same ONNX bytes go through both packages' import_onnx and make_forward
at fp32 on the CPU. The JAX side runs eagerly, op by op, as that file's
run_graph does, with the Pallas fusion off. Integer outputs must be equal;
float outputs agree within 1e-6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from birdnet_tpu.compiler import importer as jimp  # noqa: E402
from birdnet_tpu_torch.compiler import importer as timp  # noqa: E402
from birdnet_tpu_torch.onnx import proto as P  # noqa: E402

FLOAT_TOL = 1e-6
FLOAT8 = ("FLOAT8E4M3FN", "FLOAT8E4M3FNUZ", "FLOAT8E5M2", "FLOAT8E5M2FNUZ")
FLOAT8_TORCH = (torch.float8_e4m3fn, torch.float8_e4m3fnuz, torch.float8_e5m2,
                torch.float8_e5m2fnuz)


def _run_both(nodes, inputs, initializers=None, outputs=("y",), opset=17):
    """(port outputs, JAX outputs), each a list of numpy arrays."""
    init = [P.TensorProto.from_numpy(
        v if isinstance(v, torch.Tensor) else np.asarray(v), name=k)
        for k, v in (initializers or {}).items()]
    in_vis = [P.make_value_info(k, P._NUMPY_TO_DTYPE[np.asarray(v).dtype],
                                list(np.asarray(v).shape))
              for k, v in inputs.items()]
    out_vis = [P.make_value_info(n, P.DataType.FLOAT, []) for n in outputs]
    graph = P.GraphProto(name="t", node=nodes, initializer=init, input=in_vis,
                         output=out_vis)
    data = P.encode_model(P.make_model(graph, opset_version=opset))
    arrays = [np.asarray(v) for v in inputs.values()]

    j = jimp.import_onnx(data, optimize=False)
    want = jimp.make_forward(j, "fp32", disable_pallas_fusion=True)(j.params, *arrays)
    t = timp.import_onnx(data, optimize=False)
    got = timp.make_forward(t, "fp32", "cpu")(
        timp.params_to_torch(t.params, "cpu"), *[torch.from_numpy(a) for a in arrays]
    )
    # numpy has no float8 dtype of torch's: those outputs come back as bits.
    got = [g.view(torch.uint8) if g.dtype in FLOAT8_TORCH else g for g in got]
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=FLOAT_TOL, atol=FLOAT_TOL)


def _rand_q(rng, shape, dtype):
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, size=shape).astype(dtype)


def _names(*pairs):
    """Input names, '' for an absent optional input, trailing '' dropped."""
    names = [n if present else "" for n, present in pairs]
    while names and names[-1] == "":
        names.pop()
    return names


# ---------------------------------------------------------------------------
# MatMulInteger / ConvInteger: exact int32 accumulators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "a_dt,b_dt,a_zp,b_zp",
    [
        (np.int8, np.int8, None, None),
        (np.uint8, np.int8, np.uint8(131), None),
        (np.int8, np.int8, np.int8(-5), np.int8(0)),
        (np.uint8, np.uint8, np.uint8(120), np.uint8(128)),
        (np.int8, np.int8, np.int8(7), np.int8(3)),
    ],
)
def test_matmul_integer(a_dt, b_dt, a_zp, b_zp):
    rng = np.random.default_rng(1)
    a, b = _rand_q(rng, (5, 32), a_dt), _rand_q(rng, (32, 9), b_dt)
    inits = {k: v for k, v in (("azp", a_zp), ("bzp", b_zp)) if v is not None}
    names = _names(("a", True), ("b", True), ("azp", a_zp is not None),
                   ("bzp", b_zp is not None))
    _same(*_run_both([P.make_node("MatMulInteger", names, ["y"])], {"a": a, "b": b}, inits))


def test_matmul_integer_per_row_a_zp():
    rng = np.random.default_rng(2)
    a, b = _rand_q(rng, (4, 16), np.uint8), _rand_q(rng, (16, 6), np.int8)
    _same(*_run_both([P.make_node("MatMulInteger", ["a", "b", "azp"], ["y"])],
                     {"a": a, "b": b}, {"azp": _rand_q(rng, (4,), np.uint8)}))


@pytest.mark.parametrize(
    "x_dt,x_zp,w_zp,pads",
    [
        (np.int8, None, None, [0, 0, 0, 0]),
        (np.int8, np.int8(5), None, [1, 1, 1, 1]),
        (np.uint8, np.uint8(100), None, [2, 1, 2, 1]),
        (np.int8, np.int8(-3), np.int8(2), [1, 1, 1, 1]),
    ],
)
def test_conv_integer(x_dt, x_zp, w_zp, pads):
    rng = np.random.default_rng(3)
    x, w = _rand_q(rng, (2, 3, 8, 8), x_dt), _rand_q(rng, (4, 3, 3, 3), np.int8)
    inits = {"w": w, **{k: v for k, v in (("xzp", x_zp), ("wzp", w_zp)) if v is not None}}
    names = _names(("x", True), ("w", True), ("xzp", x_zp is not None),
                   ("wzp", w_zp is not None))
    _same(*_run_both([P.make_node("ConvInteger", names, ["y"], pads=pads, strides=[1, 1])],
                     {"x": x}, inits))


def test_conv_integer_grouped_with_zp():
    rng = np.random.default_rng(4)
    x, w = _rand_q(rng, (1, 4, 6, 6), np.uint8), _rand_q(rng, (4, 2, 3, 3), np.int8)
    _same(*_run_both(
        [P.make_node("ConvInteger", ["x", "w", "xzp"], ["y"], group=2, pads=[1, 1, 1, 1])],
        {"x": x}, {"w": w, "xzp": np.uint8(77)},
    ))


# ---------------------------------------------------------------------------
# QLinearMatMul / _QLinearGemm
# ---------------------------------------------------------------------------

QLINEAR_INPUTS = ["a", "as", "azp", "b", "bs", "bzp", "ys", "yzp"]


def test_qlinear_matmul():
    rng = np.random.default_rng(5)
    a = _rand_q(rng, (6, 24), np.uint8)
    _same(*_run_both(
        [P.make_node("QLinearMatMul", QLINEAR_INPUTS, ["y"])], {"a": a},
        {"as": np.float32(0.02), "azp": np.uint8(128), "b": _rand_q(rng, (24, 8), np.int8),
         "bs": np.float32(0.05), "bzp": np.int8(0), "ys": np.float32(0.1),
         "yzp": np.uint8(120)},
    ))


def test_qlinear_matmul_per_column_scale():
    rng = np.random.default_rng(6)
    a = _rand_q(rng, (5, 16), np.int8)
    _same(*_run_both(
        [P.make_node("QLinearMatMul", QLINEAR_INPUTS, ["y"])], {"a": a},
        {"as": np.float32(0.03), "azp": np.int8(0), "b": _rand_q(rng, (16, 4), np.int8),
         "bs": np.array([0.01, 0.02, 0.04, 0.08], np.float32),
         "bzp": np.zeros(4, np.int8), "ys": np.float32(0.2), "yzp": np.int8(0)},
    ))


@pytest.mark.parametrize("with_bias", [False, True])
def test_qlinear_gemm(with_bias):
    rng = np.random.default_rng(7)
    a = _rand_q(rng, (4, 12), np.int8)
    inits = {"as": np.float32(0.02), "azp": np.int8(0),
             "w": _rand_q(rng, (7, 12), np.int8),
             "ws": (rng.random(7) * 0.05 + 0.01).astype(np.float32),
             "wzp": np.zeros(7, np.int8), "ys": np.float32(0.15), "yzp": np.int8(-4)}
    names = ["a", "as", "azp", "w", "ws", "wzp", "ys", "yzp"]
    if with_bias:
        inits["b"] = rng.integers(-500, 500, size=7).astype(np.int32)
        names.append("b")
    _same(*_run_both([P.make_node("_QLinearGemm", names, ["y"], transB=1)], {"a": a}, inits))


# ---------------------------------------------------------------------------
# QLinearConv
# ---------------------------------------------------------------------------

QCONV_INPUTS = ["x", "xs", "xzp", "w", "ws", "wzp", "ys", "yzp", "b"]


@pytest.mark.parametrize("per_channel", [False, True])
def test_qlinear_conv_uint8(per_channel):
    rng = np.random.default_rng(8)
    x = _rand_q(rng, (2, 3, 10, 10), np.uint8)
    if per_channel:
        w_s = np.array([0.01, 0.02, 0.03, 0.015, 0.025], np.float32)
        w_zp = np.zeros(5, np.int8)
    else:
        w_s, w_zp = np.float32(0.02), np.int8(0)
    _same(*_run_both(
        [P.make_node("QLinearConv", QCONV_INPUTS, ["y"], pads=[1, 1, 1, 1])], {"x": x},
        {"xs": np.float32(0.015), "xzp": np.uint8(110), "w": _rand_q(rng, (5, 3, 3, 3), np.int8),
         "ws": w_s, "wzp": w_zp, "ys": np.float32(0.3), "yzp": np.uint8(128),
         "b": rng.integers(-2000, 2000, size=5).astype(np.int32)},
    ))


def test_qlinear_conv_fused_relu_legacy_flag():
    rng = np.random.default_rng(9)
    x = _rand_q(rng, (1, 2, 6, 6), np.int8)
    _same(*_run_both(
        [P.make_node("QLinearConv", QCONV_INPUTS[:8], ["y"], pads=[1, 1, 1, 1], _fused_relu=1)],
        {"x": x},
        {"xs": np.float32(0.05), "xzp": np.int8(0), "w": _rand_q(rng, (3, 2, 3, 3), np.int8),
         "ws": np.float32(0.04), "wzp": np.int8(0), "ys": np.float32(0.11), "yzp": np.int8(10)},
    ))


def _symmetric_conv(rng, x_shape, w_shape, act, **attrs):
    """A QLinearConv as quantize_model's QDQ fusion emits it: int8, every
    zero point 0, per-channel weight scales, int32 bias, ``_fused_act``."""
    c_out = w_shape[0]
    k = int(np.prod(w_shape[1:]))
    x = rng.integers(-127, 128, x_shape).astype(np.int8)
    inits = {"xs": np.float32(0.02), "xzp": np.int8(0),
             "w": rng.integers(-127, 128, w_shape).astype(np.int8),
             "ws": (rng.uniform(0.5, 1.5, c_out) / (np.sqrt(k) * 5418.0 * 0.02)).astype(np.float32),
             "wzp": np.zeros(c_out, np.int8), "ys": np.float32(3.0 / 127.0),
             "yzp": np.int8(0), "b": rng.integers(-3000, 3001, c_out).astype(np.int32)}
    if act:
        attrs["_fused_act"] = act
    return [P.make_node("QLinearConv", QCONV_INPUTS, ["y"], **attrs)], {"x": x}, inits


@pytest.mark.parametrize("act", ["", "silu"])
def test_qlinear_conv_stem_3x3_stride2(act):
    rng = np.random.default_rng(10)
    _same(*_run_both(*_symmetric_conv(rng, (2, 1, 24, 41), (8, 1, 3, 3), act,
                                      kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1])))


@pytest.mark.parametrize("stride", [1, 2])
def test_qlinear_conv_depthwise_3x3(stride):
    rng = np.random.default_rng(11)
    _same(*_run_both(*_symmetric_conv(rng, (2, 16, 12, 21), (16, 1, 3, 3), "silu",
                                      kernel_shape=[3, 3], strides=[stride, stride],
                                      pads=[1, 1, 1, 1], group=16)))


@pytest.mark.parametrize("act", ["", "relu", "sigmoid", "silu", "tanh"])
@pytest.mark.parametrize("hw", [(1, 1), (12, 20)])
def test_qlinear_conv_1x1_takes_b3(act, hw):
    """The 1x1 form B3 takes (its plain version on the CPU), at the SE
    convs' N = 1 and at a spatial map."""
    rng = np.random.default_rng(12)
    _same(*_run_both(*_symmetric_conv(rng, (2, 24, *hw), (40, 24, 1, 1), act,
                                      kernel_shape=[1, 1], pads=[0, 0, 0, 0])))


# ---------------------------------------------------------------------------
# DynamicQuantizeLinear, QuantizeLinear, DequantizeLinear
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x", [
    np.array([-1.0, -0.5, 0.0, 0.25, 0.5, 1.5], np.float32),
    np.zeros(8, np.float32),
    np.random.default_rng(13).normal(size=(3, 7)).astype(np.float32),
], ids=["ramp", "all-zero", "normal"])
def test_dynamic_quantize_linear(x):
    _same(*_run_both([P.make_node("DynamicQuantizeLinear", ["x"], ["y", "s", "z"])],
                     {"x": x}, outputs=("y", "s", "z")))


@pytest.mark.parametrize("zp", [np.int8(0), np.int8(-7), np.uint8(131), None],
                         ids=["int8-zero", "int8", "uint8", "no-zp"])
def test_quantize_dequantize_per_tensor(zp):
    x = (np.random.default_rng(14).normal(size=(2, 5, 9)) * 3).astype(np.float32)
    names = _names(("x", True), ("s", True), ("zp", zp is not None))
    inits = {"s": np.float32(0.037), **({"zp": zp} if zp is not None else {})}
    dq_names = ["q"] + names[1:]
    _same(*_run_both(
        [P.make_node("QuantizeLinear", names, ["q"]),
         P.make_node("DequantizeLinear", dq_names, ["y"])],
        {"x": x}, inits, outputs=("q", "y"),
    ))


def test_quantize_dequantize_per_axis():
    rng = np.random.default_rng(15)
    x = (rng.normal(size=(2, 4, 6)) * 2).astype(np.float32)
    inits = {"s": np.array([0.01, 0.02, 0.05, 0.1], np.float32),
             "zp": np.array([0, 3, -2, 10], np.int8)}
    _same(*_run_both(
        [P.make_node("QuantizeLinear", ["x", "s", "zp"], ["q"], axis=1),
         P.make_node("DequantizeLinear", ["q", "s", "zp"], ["y"], axis=1)],
        {"x": x}, inits, outputs=("q", "y"),
    ))


def test_quantize_linear_output_dtype_attr():
    x = np.array([[0.5, -3.2, 100.7]], np.float32)
    _same(*_run_both(
        [P.make_node("QuantizeLinear", ["x", "sc"], ["y"], output_dtype=int(P.DataType.INT16))],
        {"x": x}, {"sc": np.float32(0.1).reshape(())}, opset=21,
    ))


def test_quantize_linear_blocked():
    r = np.random.default_rng(81)
    x = (r.standard_normal((8, 2)) * 2).astype(np.float32)
    _same(*_run_both(
        [P.make_node("QuantizeLinear", ["x", "sc", "zp"], ["y"], axis=0, block_size=4)],
        {"x": x},
        {"sc": (r.random((2, 2)) * 0.05 + 0.01).astype(np.float32),
         "zp": r.integers(100, 156, (2, 2), dtype=np.uint8)},
        opset=21,
    ))


@pytest.mark.parametrize("trial", range(10))
def test_dequantize_linear_blocked(trial):
    """Random blocked-DQ configurations (rank, axis, block size, signed or
    unsigned, divisible and tail-block K), as the JAX package's property
    fuzz draws them."""
    rng = np.random.default_rng(90 + trial)
    rank = int(rng.integers(2, 4))
    shape = tuple(int(rng.integers(2, 7)) for _ in range(rank))
    axis = int(rng.integers(0, rank))
    bs = int(rng.choice([2, 3, 4]))
    dt = np.int8 if rng.integers(0, 2) else np.uint8
    sshape = list(shape)
    sshape[axis] = -(-shape[axis] // bs)
    _same(*_run_both(
        [P.make_node("DequantizeLinear", ["q", "sc", "zp"], ["y"], axis=axis, block_size=bs)],
        {"q": _rand_q(rng, shape, dt)},
        {"sc": (rng.random(sshape) * 0.1 + 0.01).astype(np.float32),
         "zp": _rand_q(rng, sshape, dt)},
        opset=21,
    ))


@pytest.mark.parametrize("kernel", [1, 3])
def test_qlinear_conv_reciprocal_hostile_scale(kernel):
    """x_s * w_s = 0.15 and y_s = 0.3, whose float32 reciprocal is inexact:
    a multiply by it would round some half-integer quotients the other way.
    Both lowerings divide (the JAX package eagerly), so the codes agree, in
    the 3x3 lowering and in the 1x1 form that takes B3."""
    rng = np.random.default_rng(16)
    x = rng.integers(-10, 11, (2, 8, 12, 20)).astype(np.int8)
    inits = {"xs": np.float32(0.15), "xzp": np.int8(0),
             "w": rng.integers(-3, 4, (16, 8, kernel, kernel)).astype(np.int8),
             "ws": np.ones(16, np.float32), "wzp": np.zeros(16, np.int8),
             "ys": np.float32(0.3), "yzp": np.int8(0),
             "b": rng.integers(-20, 21, 16).astype(np.int32)}
    pad = kernel // 2
    _same(*_run_both([P.make_node("QLinearConv", QCONV_INPUTS, ["y"],
                                  kernel_shape=[kernel, kernel], pads=[pad] * 4)],
                     {"x": x}, inits))


def _float8_inputs(seed):
    """Values in range, ties at each format's overflow threshold, values
    past it, infinities, NaN of both signs and signed zeros."""
    rng = np.random.default_rng(seed)
    special = np.array([464.0, 464.01, 248.0, 247.99, 61440.0, 61439.9, 1e6,
                        np.inf, np.nan, 0.0, 1e-9], np.float32)
    special = np.concatenate([special, -special])
    x = np.concatenate([rng.normal(size=42).astype(np.float32) * 300, special])
    return x.reshape(4, -1)


@pytest.mark.parametrize("form", ["zero_point", "output_dtype"])
@pytest.mark.parametrize("saturate", [0, 1])
@pytest.mark.parametrize("target", FLOAT8)
def test_quantize_linear_float8_matches_jax_bit_for_bit(target, saturate, form):
    """The float8 target from a float8 zero point (opset 19) or from
    ``output_dtype`` (opset 21): x / scale, clamped when saturate is 1. Unsaturated, torch's own
    cast would give e4m3fn's overflows 448 and e5m2's NaN 0x7F, where
    XLA gives NaN and 0x7E."""
    code = int(getattr(P.DataType, target))
    inits = {"s": np.float32(0.5)}
    names = ["x", "s"]
    attrs = {"saturate": saturate}
    if form == "zero_point":
        inits["zp"] = torch.zeros((), dtype=FLOAT8_TORCH[FLOAT8.index(target)])
        names.append("zp")
    else:
        attrs["output_dtype"] = code
    got, want = _run_both([P.make_node("QuantizeLinear", names, ["y"], **attrs)],
                          {"x": _float8_inputs(17)}, inits,
                          opset=19 if form == "zero_point" else 21)
    assert want[0].dtype.name == P.WIRE_NAMES[code]
    np.testing.assert_array_equal(got[0], want[0].view(np.uint8))


@pytest.mark.parametrize("saturate", [0, 1])
@pytest.mark.parametrize("target", FLOAT8)
def test_cast_to_float8_matches_jax_bit_for_bit(target, saturate):
    code = int(getattr(P.DataType, target))
    got, want = _run_both([P.make_node("Cast", ["x"], ["y"], to=code, saturate=saturate)],
                          {"x": _float8_inputs(18) * 100}, opset=19)
    np.testing.assert_array_equal(got[0], want[0].view(np.uint8))
