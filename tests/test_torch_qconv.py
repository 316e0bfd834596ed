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

from _v24_qconv_shapes import v24_qconv_shapes  # noqa: E402
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


def _unpack_weights(packed):
    """w [tiles * cols, ceil(C_in/32) * 32] from pack_weights' layout."""
    tiles, kchunks, groups, kgroups, rows, per = packed.shape
    return packed.permute(0, 2, 4, 1, 3, 5).reshape(tiles * groups * rows,
                                                     kchunks * kgroups * per)


@pytest.mark.parametrize("c_out,tiles,cols", [
    (6, 1, 16), (16, 1, 16), (24, 1, 32), (40, 1, 48), (80, 2, 48), (96, 2, 48),
    (112, 2, 64), (160, 3, 64), (320, 5, 64), (1280, 20, 64),
])
def test_col_tiles(c_out, tiles, cols):
    assert qc.col_tiles(c_out) == (tiles, cols)
    assert cols in qc.COL_TILES and tiles * cols >= c_out > (tiles - 1) * cols


_FORWARD = sorted({(c_in, c_out) for c_in, c_out, _, _ in v24_qconv_shapes()})


@pytest.mark.parametrize("c_in,c_out", _FORWARD, ids=[f"{a}to{b}" for a, b in _FORWARD])
def test_pack_weights_reproduces_w_with_zero_padding(c_in, c_out):
    """B3's packed B operand [tiles, C_in/32, cols/8, 2, 8, 16] for every
    weight shape of the int8 v2.4 forward: unpacked it is w, zero past
    C_out and C_in; a core matrix holds 8 rows x 16 channels."""
    w = torch.from_numpy(np.random.default_rng(c_in * c_out).integers(
        -128, 128, (c_out, c_in)).astype(np.int8))
    packed = qc.pack_weights(w)
    tiles, cols = qc.col_tiles(c_out)
    k = -(-c_in // 32) * 32
    assert tuple(packed.shape) == (tiles, k // 32, cols // 8, 2, 8, 16)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert torch.equal(packed[0, 0, 0, 0, :min(8, c_out), :min(16, c_in)],
                       w[:8, :16])
    flat = _unpack_weights(packed)
    assert torch.equal(flat[:c_out, :c_in], w)
    assert not flat[c_out:].any() and not flat[:, c_in:].any()


@pytest.mark.parametrize("c_in,c_out,n", [(24, 96, 64), (6, 24, 1), (1280, 320, 3)])
def test_product_through_packed_weights(c_in, c_out, n):
    """The int32 sums as the kernel forms them, chunk by chunk of 32
    channels and tile by tile of columns from the packed operand, equal
    w @ x."""
    rng = np.random.default_rng(c_in)
    x = torch.from_numpy(rng.integers(-128, 128, (2, c_in, n)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (c_out, c_in)).astype(np.int8))
    packed = qc.pack_weights(w)
    xt = torch.nn.functional.pad(x.long(), (0, 0, 0, packed.shape[1] * 32 - c_in))
    acc = 0
    for c in range(packed.shape[1]):
        chunk = torch.cat([_unpack_weights(packed[t:t + 1, c:c + 1]) for t in range(packed.shape[0])])
        acc = acc + torch.einsum("mk,bkn->bmn", chunk.long(), xt[:, 32 * c:32 * c + 32])
    assert torch.equal(acc[:, :c_out], torch.einsum("mk,bkn->bmn", w.long(), x.long()))


def test_packed_weights_are_cached_per_tensor():
    """The pack of a weight is made once while its tensor lives and is
    unchanged, found again through a new view of it (the lowering reshapes
    [C_out, C_in, 1, 1] on every call); an in-place change packs it
    again."""
    w4 = torch.from_numpy(np.random.default_rng(1).integers(-128, 128, (40, 24, 1, 1))
                          .astype(np.int8))
    first = qc._packed_weights(w4.reshape(40, 24))
    assert qc._packed_weights(w4.reshape(40, 24)) is first
    w4.mul_(-1)
    again = qc._packed_weights(w4.reshape(40, 24))
    assert again is not first and torch.equal(again, -first)
    other = w4.reshape(40, 24)[:20]
    assert tuple(qc._packed_weights(other).shape) == (1, 1, 4, 2, 8, 16)


def test_packed_weights_of_an_inference_tensor_are_never_stale():
    """An inference tensor has no version counter: its pack is built on
    every call, so an in-place change is always seen."""
    with torch.inference_mode():
        w = torch.ones((16, 8), dtype=torch.int8)
    first = qc._packed_weights(w)
    with torch.inference_mode():
        w.mul_(3)
    assert torch.equal(qc._packed_weights(w), 3 * first)

