"""Each op lowering of the PyTorch port against the JAX package's lowering
of the same op, on the same numpy inputs: at ``fp32``, under ``mixed``
(bf16 operands, float32 sums and outputs) and under ``fast`` where the
policy changes the result."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from birdnet_tpu.compiler import ops as jops  # noqa: E402
from birdnet_tpu_torch.compiler import ops as tops  # noqa: E402

# fp32: both sides run full float32 passes (JAX at "highest" matmul
# precision, as its interpreter does under fp32); sums differ in order only.
FP32_TOL = 1e-4


def _run(op_type, precision, inputs, **attrs):
    """(port output as float32 numpy, JAX output as float32 numpy)."""
    jctx = jops.OpContext(op_type, attrs, precision=precision)
    tctx = tops.OpContext(op_type, attrs, precision=precision)
    if precision == "fp32":
        with jax.default_matmul_precision("highest"):
            want = jops.get_lowering(op_type)(jctx, *inputs)[0]
    else:
        want = jops.get_lowering(op_type)(jctx, *inputs)[0]
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) and a.ndim else a
             for a in inputs]
    got = tops.get_lowering(op_type)(tctx, *targs)[0]
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    return np.asarray(got, np.float32), np.asarray(want, np.float32), want


def _fast_close(got, want):
    """fast: both round operands and outputs to bf16; one bf16 ulp (2^-8
    relative) of disagreement comes from the other summation order."""
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2 ** -6, atol=2 ** -6 * scale)


def _mixed_close(got, want):
    """mixed: both round the operands to bf16 and sum their (exact) products
    in float32, so they differ only in summation order: within 1e-4 of the
    output's largest magnitude, the fp32 parity bound. One bf16 rounding of
    the output, which the port made before, is about 2e-3 of it."""
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def _rng(seed=0):
    return np.random.default_rng(seed)


CONV_CASES = {
    # [N, C_in, ...] input, [C_out, C_in/g, ...] weight, attrs
    "polyphase-1d": ((2, 1, 9000), (24, 1, 1024),
                     dict(kernel_shape=[1024], strides=[280], pads=[0, 0])),
    "stem-3x3-s2": ((2, 1, 24, 41), (8, 1, 3, 3),
                    dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1])),
    "pointwise-1x1": ((2, 8, 12, 20), (16, 8, 1, 1),
                      dict(kernel_shape=[1, 1], pads=[0, 0, 0, 0])),
    "depthwise-3x3": ((2, 16, 12, 21), (16, 1, 3, 3),
                      dict(kernel_shape=[3, 3], strides=[2, 2],
                           pads=[1, 1, 1, 1], group=16)),
    "asymmetric-pads": ((1, 4, 9, 9), (4, 4, 3, 3),
                        dict(kernel_shape=[3, 3], pads=[0, 1, 1, 0])),
}


@pytest.mark.parametrize("precision", ["fp32", "mixed", "fast"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv(case, precision):
    xs, ws, attrs = CONV_CASES[case]
    rng = _rng()
    x = (rng.normal(size=xs) * 0.5).astype(np.float32)
    w = (rng.normal(size=ws) * 0.1).astype(np.float32)
    b = (rng.normal(size=ws[0]) * 0.1).astype(np.float32)
    got, want, raw = _run("Conv", precision, [x, w, b], **attrs)
    assert got.shape == want.shape
    if precision == "fp32":
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    elif precision == "mixed":
        assert str(raw.dtype) == "float32"
        _mixed_close(got, want)
    else:
        assert str(raw.dtype) == "bfloat16"
        _fast_close(got, want)


def test_polyphase_fast_keeps_float32_partial_products():
    """fast: the polyphase Conv1d's partial products stay float32 through
    the shifted adds and the output is rounded to bf16 once, as the JAX
    lowering's ``preferred_element_type`` keeps them: every output within
    one bf16 ulp (2^-7 relative) of JAX's, where sums in another order can
    flip a rounding. Partial products rounded to bf16 miss that wherever the
    four partials cancel."""
    rng = _rng(10)
    x = (rng.normal(size=(2, 1, 24000)) * 0.5).astype(np.float32)
    w = (rng.normal(size=(32, 1, 1024)) * 0.1).astype(np.float32)
    got, want, raw = _run("Conv", "fast", [x, w], kernel_shape=[1024], strides=[280],
                          pads=[0, 0])
    assert str(raw.dtype) == "bfloat16" and got.shape == want.shape == (2, 32, 83)
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


def test_conv_mixed_returns_float32():
    """mixed: bf16 operands, float32 activations out."""
    rng = _rng()
    x = rng.normal(size=(2, 8, 12, 20)).astype(np.float32)
    w = (rng.normal(size=(16, 8, 1, 1)) * 0.1).astype(np.float32)
    ctx = tops.OpContext("Conv", {"kernel_shape": [1, 1]}, precision="mixed")
    y = tops.get_lowering("Conv")(ctx, torch.from_numpy(x), torch.from_numpy(w))[0]
    assert y.dtype == torch.float32


@pytest.mark.parametrize("precision", ["fp32", "mixed", "fast"])
def test_gemm(precision):
    rng = _rng(1)
    a = rng.normal(size=(4, 64)).astype(np.float32)
    w = (rng.normal(size=(30, 64)) * 0.1).astype(np.float32)
    c = rng.normal(size=(30,)).astype(np.float32)
    got, want, _ = _run("Gemm", precision, [a, w, c], transB=1)
    if precision == "fp32":
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    elif precision == "mixed":
        _mixed_close(got, want)
    else:
        _fast_close(got, want)


@pytest.mark.parametrize("precision", ["fp32", "mixed", "fast"])
def test_matmul(precision):
    rng = _rng(2)
    a = rng.normal(size=(2, 7, 33)).astype(np.float32)
    b = rng.uniform(size=(33, 12)).astype(np.float32)
    got, want, _ = _run("MatMul", precision, [a, b])
    if precision == "fp32":
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    elif precision == "mixed":
        _mixed_close(got, want)
    else:
        _fast_close(got, want)


@pytest.mark.parametrize("precision", ["fp32", "mixed", "fast"])
def test_stft(precision):
    """fp32/mixed keep float32 DFT passes; fast rounds the operands to
    bf16 and accumulates in float32 on both sides."""
    rng = _rng(3)
    x = (rng.normal(size=(2, 9000)) * 0.1).astype(np.float32)
    win = np.hanning(1024).astype(np.float32)
    got, want, _ = _run("STFT", precision, [x, np.array(280, np.int64), win],
                        onesided=1)
    assert got.shape == want.shape == (2, 29, 513, 2)
    tol = 1e-4 if precision != "fast" else 1e-3
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def test_mel_weight_matrix():
    inputs = [np.array(96, np.int64), np.array(1024, np.int64),
              np.array(48000, np.int64), np.array(150.0, np.float32),
              np.array(15000.0, np.float32)]
    got, want, raw = _run("MelWeightMatrix", "fp32", inputs)
    assert got.shape == (513, 96)
    np.testing.assert_array_equal(got, want)


def test_reduce_sum_square():
    x = _rng(4).normal(size=(2, 5, 7, 2)).astype(np.float32)
    got, want, _ = _run("ReduceSumSquare", "fp32", [x], axes=[-1], keepdims=0)
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


def test_global_average_pool():
    x = _rng(5).normal(size=(2, 6, 5, 9)).astype(np.float32)
    got, want, _ = _run("GlobalAveragePool", "fp32", [x])
    assert got.shape == (2, 6, 1, 1)
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


def test_batch_normalization():
    rng = _rng(6)
    x = rng.normal(size=(2, 4, 3, 5)).astype(np.float32)
    scale, bias, mean = (rng.normal(size=4).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 1.5, size=4).astype(np.float32)
    got, want, _ = _run("BatchNormalization", "fp32",
                        [x, scale, bias, mean, var], epsilon=1e-3)
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("op_type", ["Log", "Sigmoid", "Relu"])
def test_unary(op_type):
    x = _rng(7).uniform(0.1, 3.0, size=(3, 8)).astype(np.float32)
    got, want, _ = _run(op_type, "fp32", [x])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op_type", ["Add", "Mul"])
def test_binary_promotes_like_jax(op_type):
    """A bf16 activation meeting a 0-d float32 constant is promoted to
    float32, as jax.numpy does (torch's own rule would keep bf16)."""
    x = _rng(8).normal(size=(2, 3)).astype(np.float32)
    eps = np.array(1e-3, np.float32)
    ctx = tops.OpContext(op_type, {})
    xt = torch.from_numpy(x).to(torch.bfloat16)
    y = tops.get_lowering(op_type)(ctx, xt, eps)[0]
    jy = jops.get_lowering(op_type)(jops.OpContext(op_type, {}),
                                    jax.numpy.asarray(x, jax.numpy.bfloat16), eps)[0]
    assert y.dtype == torch.float32 and str(jy.dtype) == "float32"
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6)


def test_shape_ops():
    x = _rng(9).normal(size=(2, 3, 4)).astype(np.float32)
    got, want, _ = _run("Transpose", "fp32", [x], perm=[0, 2, 1])
    np.testing.assert_array_equal(got, want)
    got, want, _ = _run("Unsqueeze", "fp32", [x, np.array([1], np.int64)])
    assert got.shape == want.shape == (2, 1, 3, 4)
    got, want, _ = _run("Flatten", "fp32", [x], axis=1)
    assert got.shape == want.shape == (2, 12)
    np.testing.assert_array_equal(got, want)


def test_unported_op_names_the_port():
    # A com.microsoft name that neither package lowers.
    with pytest.raises(NotImplementedError, match="birdnet_tpu_torch"):
        tops.get_lowering("DecoderMaskedMultiHeadAttention", "com.microsoft")


def _run_axes_op(op_type, opset, x, axes_input, attrs, dtype=None):
    """(port output, JAX output) of a Squeeze/Reduce* node at ``opset``, the
    axes as an input (a host int64 array, as the interpreters hold
    constants) or in ``attrs``; ``dtype`` "bfloat16" feeds both sides bf16."""
    args = [x] if axes_input is None else [x, np.asarray(axes_input, np.int64)]
    jx = jax.numpy.asarray(x, dtype or x.dtype)
    want = jops.get_lowering(op_type)(
        jops.OpContext(op_type, attrs, opset=opset), jx, *args[1:])[0]
    tx = torch.from_numpy(x)
    if dtype == "bfloat16":
        tx = tx.to(torch.bfloat16)
    got = tops.get_lowering(op_type)(
        tops.OpContext(op_type, attrs, opset=opset), tx, *args[1:])[0]
    return got, want


def test_relu_bf16_and_constant_inputs_are_exact():
    x = _rng(10).normal(size=(4, 9)).astype(np.float32)
    for dtype in (None, "bfloat16"):
        got, want = _run_axes_op("Relu", 17, x, None, {}, dtype)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # A host constant (numpy) input, as a folded graph may hand it over.
    got = tops.get_lowering("Relu")(tops.OpContext("Relu", {}), x)[0]
    np.testing.assert_array_equal(got.numpy(), np.maximum(x, 0.0))


SQUEEZE_CASES = {
    # name: (shape, opset, axes input, attrs)
    "input-axes": ((2, 1, 5, 1), 13, [1], {}),
    "input-negative-axes": ((2, 1, 5, 1), 13, [-1, 1], {}),
    "attribute-axes": ((1, 3, 1), 11, None, {"axes": [0, 2]}),
    "attribute-negative": ((1, 3, 1), 11, None, {"axes": [-3]}),
    "no-axes": ((1, 4, 1, 2), 13, None, {}),
    "perch-spectrogram": ((2, 1, 128, 7), 17, [1], {}),
}


@pytest.mark.parametrize("case", sorted(SQUEEZE_CASES))
def test_squeeze_matches_jax_exactly(case):
    shape, opset, axes, attrs = SQUEEZE_CASES[case]
    x = _rng(11).normal(size=shape).astype(np.float32)
    got, want = _run_axes_op("Squeeze", opset, x, axes, attrs)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_squeeze_of_a_wider_axis_raises():
    x = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="size-1"):
        tops.get_lowering("Squeeze")(tops.OpContext("Squeeze", {}, opset=13),
                                     x, np.array([1], np.int64))


REDUCE_MEAN_CASES = {
    # name: (shape, opset, axes input, attrs)
    "input-axes-keepdims0": ((2, 8, 3, 5), 18, [2], {"keepdims": 0}),
    "input-axes-keepdims1": ((2, 8, 3, 5), 18, [2, 3], {"keepdims": 1}),
    "input-negative-axes": ((2, 6, 5), 18, [-1], {"keepdims": 0}),
    "attribute-axes": ((2, 6, 5), 13, None, {"axes": [1], "keepdims": 0}),
    "attribute-negative-axes": ((2, 6, 5), 13, None, {"axes": [-2, -1]}),
    "no-axes-reduces-all": ((3, 4, 5), 18, None, {"keepdims": 0}),
    "no-axes-attribute-form": ((3, 4, 5), 13, None, {}),
    "empty-axes-noop": ((3, 4), 18, [], {"noop_with_empty_axes": 1}),
    "absent-axes-noop": ((3, 4), 18, None, {"noop_with_empty_axes": 1}),
    "perch-freq-mean": ((2, 48, 4, 16), 17, [2], {"keepdims": 0}),
    "perch-time-mean": ((2, 16, 48), 17, [1], {"keepdims": 0}),
}


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("case", sorted(REDUCE_MEAN_CASES))
def test_reduce_mean_matches_jax(case, dtype):
    """Within 1e-6 relative at float32. In bf16 both sides sum and divide
    in float32 and round the mean to bf16 once (jnp.mean's promotion), so
    the bf16 results are equal unless the float32 sums' order moves a
    rounding: at most one bf16 ulp."""
    shape, opset, axes, attrs = REDUCE_MEAN_CASES[case]
    x = (_rng(12).normal(size=shape) + 0.5).astype(np.float32)
    got, want = _run_axes_op("ReduceMean", opset, x, axes, attrs, dtype)
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype is None:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)


def test_reduce_mean_of_integers_is_float32():
    x = np.arange(24, dtype=np.int32).reshape(2, 3, 4)
    got, want = _run_axes_op("ReduceMean", 18, x, [1], {"keepdims": 0})
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("case", ["input-axes-keepdims0", "attribute-negative-axes",
                                  "empty-axes-noop", "no-axes-reduces-all"])
def test_reduce_sum_square_axes_forms(case):
    shape, opset, axes, attrs = REDUCE_MEAN_CASES[case]
    x = _rng(13).normal(size=shape).astype(np.float32)
    got, want = _run_axes_op("ReduceSumSquare", opset, x, axes, attrs)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
