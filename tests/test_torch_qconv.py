"""B3, the fused int8 1x1 conv + requantize: the port's plain version (what
the wrapper runs on a CPU tensor) against the JAX package's Pallas kernel
in interpret mode, on the same numpy inputs.

The Pallas kernel takes only spatial sizes that are multiples of 128 (the
TPU's lane tiling); for N = 1 and 48 the JAX side runs on x zero-padded to
128 positions and is cut back to N. The kernel is independent per position,
so the padding changes none of the real columns."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from birdnet_tpu.ops.pallas.qconv import qconv1x1_requant as j_qconv  # noqa: E402
from birdnet_tpu_torch.ops.cuda import qconv as qc  # noqa: E402

ACTS = ["", "relu", "sigmoid", "silu", "tanh"]
# sigmoid/silu/tanh: torch's and XLA's exp/tanh may round differently by an
# ulp, which can move a code across a rounding boundary: at most 1 code
# apart, on at most this share of the codes.
TRANSCENDENTAL_MAX_SHARE = 1e-3


def _jax_kernel(x, w, b, scale, y_scale, act):
    n = x.shape[2]
    padded = -(-n // 128) * 128
    xp = np.pad(x, ((0, 0), (0, 0), (0, padded - n)))
    y = j_qconv(xp, w, b, scale, y_scale, act=act, interpret=True)
    return np.asarray(y)[:, :, :n]


def _port_plain(x, w, b, scale, y_scale, act):
    t = torch.from_numpy
    y = qc.qconv1x1_requant(t(x), t(w), t(b), t(scale), y_scale, act)
    return y.numpy()


def _inputs(rng, n_img, c_in, c_out, n):
    """Random codes and per-channel scales that leave most outputs
    unsaturated (the accumulator's spread is sqrt(C_in) * 127^2 / 3)."""
    x = rng.integers(-127, 128, (n_img, c_in, n)).astype(np.int8)
    w = rng.integers(-127, 128, (c_out, c_in)).astype(np.int8)
    b = rng.integers(-3000, 3001, c_out).astype(np.int32)
    acc_std = np.sqrt(c_in) * 5418.0
    scale = (rng.uniform(0.5, 1.5, c_out) / acc_std).astype(np.float32)
    return x, w, b, scale, np.float32(3.0 / 127.0)


def _compare(got, want, act):
    assert got.shape == want.shape and got.dtype == want.dtype == np.int8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if act in ("", "relu"):
        np.testing.assert_array_equal(got, want)
    else:
        assert diff.max() <= 1
        assert (diff > 0).mean() <= TRANSCENDENTAL_MAX_SHARE


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("n", [1, 48, 128])
@pytest.mark.parametrize("c_in", [6, 1280])
def test_plain_matches_jax_kernel(c_in, n, act):
    rng = np.random.default_rng(c_in * 1000 + n)
    args = _inputs(rng, 2, c_in, 24, n)
    want = _jax_kernel(*args, act)
    got = _port_plain(*args, act)
    _compare(got, want, act)
    # the case is not all saturated
    assert ((want > -128) & (want < 127)).mean() > 0.5


def _jax_qlinearconv_eager(x, w, b, x_s, w_s, y_s):
    """The JAX package's unfused QLinearConv lowering on a one-node graph,
    run eagerly (op by op, as its own tests run run_graph)."""
    from birdnet_tpu.compiler.importer import import_onnx, make_forward
    from birdnet_tpu.onnx import proto as P

    n_img, c_in, n = x.shape
    c_out = w.shape[0]
    inits = {"xs": np.float32(x_s), "xzp": np.int8(0), "w": w[:, :, None, None],
             "ws": w_s, "wzp": np.zeros(c_out, np.int8), "ys": np.float32(y_s),
             "yzp": np.int8(0), "b": b}
    graph = P.GraphProto(
        name="q", initializer=[P.TensorProto.from_numpy(v, name=k) for k, v in inits.items()],
        node=[P.make_node("QLinearConv", ["x", *inits], ["y"], kernel_shape=[1, 1])],
        input=[P.make_value_info("x", P.DataType.INT8, [n_img, c_in, 1, n])],
        output=[P.make_value_info("y", P.DataType.INT8, [n_img, c_out, 1, n])],
    )
    model = import_onnx(P.encode_model(P.make_model(graph)), optimize=False)
    fwd = make_forward(model, precision="fp32", disable_pallas_fusion=True)
    return np.asarray(fwd(model.params, x[:, :, None, :])[0])[:, :, 0, :]


@pytest.mark.parametrize("n", [48, 1024])
def test_reciprocal_hostile_scale_divides(n):
    """y_scale = 0.3 (an inexact float32 reciprocal) at x_s * w_s = 0.15:
    half-integer quotients abound, and a multiply by the reciprocal rounds
    some of them the other way. The port divides: its codes equal float32
    true division and the JAX package's unfused lowering run eagerly.

    The JAX kernel in interpret mode gives the reciprocal multiply's codes:
    XLA rewrites a division by a compile-time constant into a multiply by
    its reciprocal, and the kernel's y_scale is one (so is the output scale
    of the JAX package's jitted forward). ROADMAP C records it; this test
    pins both behaviours."""
    rng = np.random.default_rng(n)
    x = rng.integers(-10, 11, (4, 8, n)).astype(np.int8)
    w = rng.integers(-3, 4, (16, 8)).astype(np.int8)
    b = rng.integers(-20, 21, 16).astype(np.int32)
    scale = np.full(16, 0.15, np.float32)
    v = (w.astype(np.int64) @ x.astype(np.int64) + b[None, :, None]).astype(np.float32)
    v = v * np.float32(0.15)
    divided = np.clip(np.rint(v / np.float32(0.3)), -128, 127).astype(np.int8)
    multiplied = np.clip(np.rint(v * (np.float32(1) / np.float32(0.3))), -128, 127)
    multiplied = multiplied.astype(np.int8)
    assert (divided != multiplied).any()  # the case is hostile

    got = _port_plain(x, w, b, scale, 0.3, "")
    np.testing.assert_array_equal(got, divided)
    np.testing.assert_array_equal(
        got, _jax_qlinearconv_eager(x, w, b, 0.15, np.ones(16, np.float32), 0.3)
    )
    np.testing.assert_array_equal(_jax_kernel(x, w, b, scale, 0.3, ""), multiplied)


def test_no_bias_matches_jax_kernel():
    rng = np.random.default_rng(5)
    x, w, _, scale, y_scale = _inputs(rng, 3, 40, 16, 128)
    want = np.asarray(j_qconv(x, w, None, scale, y_scale, interpret=True))
    got = qc.qconv1x1_requant(torch.from_numpy(x), torch.from_numpy(w), None,
                              torch.from_numpy(scale), y_scale).numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_tensor_takes_the_plain_version():
    rng = np.random.default_rng(6)
    x, w, b, scale, y_scale = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                               for a in _inputs(rng, 1, 8, 8, 5))
    qc.reset_launches()
    got = qc.qconv1x1_requant(x, w, b, scale, y_scale, "silu")
    assert qc.LAUNCHES["qconv1x1_requant"] == 0
    torch.testing.assert_close(got, qc.qconv1x1_requant_plain(x, w, b, scale, y_scale, "silu"),
                               rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((1, 4, 3), dtype=torch.int8)
    w = torch.zeros((2, 4), dtype=torch.int8)
    scale = torch.ones(2)
    with pytest.raises(ValueError, match="x must be int8"):
        qc.qconv1x1_requant(x.float(), w, None, scale, 1.0)
    with pytest.raises(ValueError, match="w must be int8"):
        qc.qconv1x1_requant(x, w[:, :3], None, scale, 1.0)
    with pytest.raises(ValueError, match="bias must be int32"):
        qc.qconv1x1_requant(x, w, torch.zeros(2, dtype=torch.int64), scale, 1.0)
    with pytest.raises(ValueError, match="scale must be float32"):
        qc.qconv1x1_requant(x, w, None, scale.double(), 1.0)
    with pytest.raises(ValueError, match="activation"):
        qc.qconv1x1_requant(x, w, None, scale, 1.0, act="gelu")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        qc.qconv1x1_requant(x.to("meta"), w.to("meta"), None, scale.to("meta"), 1.0)
