"""bfloat16, float8 and int4 ONNX tensors through the port, against the JAX
package, without ml_dtypes on the port's side.

One case for each of the 14 cases of tests/test_modern_dtypes.py (the
codec's decode and encode, then the lowerings), blocked int4/uint4
DequantizeLinear, a Constant / ConstantOfShape and a Cast / CastLike case
for each of the seven types, the legacy BatchNormalization forms that
both packages refuse, and the compiler package's exports. The same bytes
go through both packages: the JAX side as its own tests run it (jitted,
at fp32), the port eagerly with ``device="cpu"``. Integer and 4-bit
values must be equal, float8 and bfloat16 values equal bit for bit (a
bfloat16 NaN only as a NaN: torch's vectorized CPU cast writes 0xFFFF where
XLA writes 0x7FC0), float outputs within 1e-6 (two CPU matmul libraries
sum in different orders).

Then BirdNET v2.4 at width 0.1, depth 1 in the four forms of
tests/_torch_dtype_forms.py (bfloat16-stored, FP8 QDQ, int4 blocks, and
layers computing in bfloat16): through both packages'
``Classifier.builder()`` at fp32 the logits agree within 1e-4 of their
scale and the port's within 1e-4 of its yardstick file's (2^-7 for
``bf16_direct``, whose activations round to bfloat16 in four layers); a
subprocess with ``sys.modules['ml_dtypes'] = None`` gives the same logits
bit for bit and round-trips each form through ``.btck``.

Last, ``.int8()`` over ``bf16_direct``: the port, in a subprocess with
ml_dtypes blocked, picks the same layers as the JAX package (a layer that
reads a bfloat16 weight directly stays float), gives as many
``QLinearConv`` nodes and int8 logits within 1e-2 of the JAX package's
scale; a file whose only eligible layer reads a bfloat16 weight directly
raises ``ModelLoadError`` in both."""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")
pytest.importorskip("jax")

import birdnet_tpu  # noqa: E402
import birdnet_tpu_torch  # noqa: E402
from birdnet_tpu.compiler import importer as jimp  # noqa: E402
from birdnet_tpu.onnx import proto as JP  # noqa: E402
from birdnet_tpu_torch.compiler import importer as timp  # noqa: E402
from birdnet_tpu_torch.models import birdnet_v24  # noqa: E402
from birdnet_tpu_torch.onnx import proto as P  # noqa: E402

import _torch_dtype_forms as forms  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FLOAT_TOL = 1e-6
FORM_TOL = 1e-4
BF16_TOL = 2 ** -7

DT = P.DataType
FLOAT8 = {
    DT.FLOAT8E4M3FN: torch.float8_e4m3fn,
    DT.FLOAT8E4M3FNUZ: torch.float8_e4m3fnuz,
    DT.FLOAT8E5M2: torch.float8_e5m2,
    DT.FLOAT8E5M2FNUZ: torch.float8_e5m2fnuz,
}
WIRE_TYPES = [DT.BFLOAT16, *FLOAT8, DT.INT4, DT.UINT4]
WIRE_IDS = [P.WIRE_NAMES[t] for t in WIRE_TYPES]


def _pack_int4(vals):
    """4-bit values (ints) packed low nibble first, odd counts padded."""
    nib = [v & 0x0F for v in vals]
    if len(nib) % 2:
        nib.append(0)
    return bytes(nib[i] | (nib[i + 1] << 4) for i in range(0, len(nib), 2))


def _vi(name, dims, elem=DT.FLOAT):
    return P.make_value_info(name, elem, list(dims))


def _model_bytes(nodes, inputs, outputs, initializers=(), opset=21):
    graph = P.GraphProto(name="g", node=list(nodes), input=list(inputs),
                         output=list(outputs), initializer=list(initializers))
    return P.encode_model(P.ModelProto(
        ir_version=10, producer_name="pytest", graph=graph,
        opset_import=[P.OperatorSetId(domain="", version=opset)]))


def _port_value(v):
    """A port output as numpy: float8 and bfloat16 as their bits, 4-bit
    values in their container."""
    if isinstance(v, torch.Tensor):
        if v.dtype in (torch.bfloat16, *FLOAT8.values()):
            return P.wire_bits(v)
        return v.detach().cpu().as_subclass(torch.Tensor).numpy()
    return np.asarray(v)


def _jax_value(v):
    """A JAX output as numpy: ml_dtypes float8 and bfloat16 as their bits,
    4-bit values widened to int8 / uint8."""
    v = np.asarray(v)
    name = v.dtype.name
    if name == "bfloat16":
        return v.view(np.uint16)
    if name.startswith("float8"):
        return v.view(np.uint8)
    if name in ("int4", "uint4"):
        return v.astype(np.int8 if name == "int4" else np.uint8)
    return v


def _run_both(data: bytes, *inputs):
    """(port outputs, JAX outputs) of the model ``data`` on numpy
    ``inputs``, each as numpy (see ``_port_value`` / ``_jax_value``)."""
    import jax

    j = jimp.import_onnx(data)
    want = jax.jit(jimp.make_forward(j, precision="fp32"))(j.params, *inputs)
    t = timp.import_onnx(data)
    got = timp.make_forward(t, "fp32", "cpu")(
        timp.params_to_torch(t.params, "cpu"),
        *[torch.from_numpy(np.array(a)) for a in inputs])
    return [_port_value(g) for g in got], [_jax_value(w) for w in want]


def _bf16_nan(bits: np.ndarray) -> np.ndarray:
    return ((bits & 0x7F80) == 0x7F80) & ((bits & 0x007F) != 0)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=FLOAT_TOL, atol=FLOAT_TOL)
        elif w.dtype == np.uint16:  # bfloat16 bits: a NaN is any NaN
            nan = _bf16_nan(w)
            np.testing.assert_array_equal(_bf16_nan(g), nan)
            np.testing.assert_array_equal(g[~nan], w[~nan])
        else:
            np.testing.assert_array_equal(g, w)


def _both_decode(**fields):
    """The same TensorProto fields decoded by both codecs, as numpy."""
    t = P.TensorProto(name="w", **fields).to_numpy()
    j = JP.TensorProto(name="w", **fields).to_numpy()
    assert isinstance(t, P.WireTensor)
    assert P.WIRE_NAMES[t.data_type] == j.dtype.name
    return _port_value(t), _jax_value(j)


# ---------------------------------------------------------------------------
# the 14 cases of tests/test_modern_dtypes.py
# ---------------------------------------------------------------------------


def codec_unpacks_int4_even_and_odd_counts():
    vals = [-8, -1, 0, 7, 3, -5, 2]
    got, want = _both_decode(data_type=DT.INT4, dims=[7], raw_data=_pack_int4(vals))
    _same([got], [want])
    np.testing.assert_array_equal(got, vals)
    got, want = _both_decode(data_type=DT.UINT4, dims=[2, 2],
                             raw_data=_pack_int4([0, 15, 7, 8]))
    _same([got], [want])


def codec_int4_truncated_payload_is_an_error():
    for codec in (P, JP):
        t = codec.TensorProto(name="w", data_type=DT.INT4, dims=[9],
                              raw_data=_pack_int4([1, 2, 3, 4]))
        with pytest.raises(ValueError, match="nibbles"):
            t.to_numpy()


def codec_int4_int32_data_storage():
    got, want = _both_decode(data_type=DT.INT4, dims=[3], int32_data=[0x1F, 0x08])
    _same([got], [want])
    np.testing.assert_array_equal(got, [-1, 1, -8])


def codec_int4_roundtrip_via_from_numpy():
    vals = np.array([-8, 7, 0, -1, 3], np.int8)
    mine = P.TensorProto.from_numpy(P.wire_tensor(torch.from_numpy(vals), DT.INT4), "w")
    theirs = JP.TensorProto.from_numpy(vals.astype(ml_dtypes.int4), "w")
    assert mine.data_type == theirs.data_type == DT.INT4
    assert mine.raw_data == theirs.raw_data and len(mine.raw_data) == 3
    np.testing.assert_array_equal(_port_value(mine.to_numpy()), vals)


def codec_bfloat16_raw_and_bitpattern_roundtrip():
    arr = np.array([1.5, -2.0, 0.0, 3e8], dtype=ml_dtypes.bfloat16)
    for fields in ({"raw_data": arr.tobytes()},
                   {"int32_data": [int(v) for v in arr.view(np.uint16)]}):
        got, want = _both_decode(data_type=DT.BFLOAT16, dims=[4], **fields)
        _same([got], [want])
        np.testing.assert_array_equal(got, arr.view(np.uint16))


def codec_float8_raw_and_bitpattern():
    for code in FLOAT8:
        arr = np.array([0.5, -1.25, 0.0, 8.0], dtype=getattr(ml_dtypes, P.WIRE_NAMES[code]))
        for fields in ({"raw_data": arr.tobytes()},
                       {"int32_data": [int(v) for v in arr.view(np.uint8)]}):
            got, want = _both_decode(data_type=code, dims=[4], **fields)
            _same([got], [want])
            np.testing.assert_array_equal(got, arr.view(np.uint8))


def codec_encodes_bf16_and_fp8_numpy_arrays():
    """from_numpy of the port's own tensors, and of ml_dtypes arrays read by
    their dtype's name, writes the JAX codec's bytes."""
    for code, dt in ((DT.BFLOAT16, torch.bfloat16), *FLOAT8.items()):
        vals = [1.0, -0.5, 2.0]
        theirs = JP.TensorProto.from_numpy(
            np.array(vals, dtype=getattr(ml_dtypes, P.WIRE_NAMES[code])), "w")
        for x in (torch.tensor(vals).to(dt),
                  np.array(vals, dtype=getattr(ml_dtypes, P.WIRE_NAMES[code]))):
            mine = P.TensorProto.from_numpy(x, "w")
            assert (mine.data_type, mine.dims, mine.raw_data) == (
                theirs.data_type, theirs.dims, theirs.raw_data)
            back = mine.to_numpy()
            assert back.dtype == dt
            np.testing.assert_array_equal(back.float().numpy(), vals)


def weight_only_int4_dequant_matmul():
    r = np.random.default_rng(0)
    w_q = r.integers(-8, 8, (6, 4)).astype(np.int8)
    scale = (r.random(4, dtype=np.float32) * 0.1 + 0.01).astype(np.float32)
    zp = np.array([0, 1, -2, 3], np.int8)
    x = r.standard_normal((3, 6), dtype=np.float32)
    inits = [P.TensorProto(name="w_q", data_type=DT.INT4, dims=[6, 4],
                           raw_data=_pack_int4(w_q.reshape(-1).tolist())),
             P.TensorProto.from_numpy(scale, "scale"),
             P.TensorProto(name="zp", data_type=DT.INT4, dims=[4],
                           raw_data=_pack_int4(zp.tolist()))]
    nodes = [P.make_node("DequantizeLinear", ["w_q", "scale", "zp"], ["w"], axis=1),
             P.make_node("MatMul", ["x", "w"], ["y"])]
    got, want = _run_both(_model_bytes(nodes, [_vi("x", (3, 6))], [_vi("y", (3, 4))],
                                       inits), x)
    _same(got, want)
    ref = x @ ((w_q.astype(np.float32) - zp.astype(np.float32)) * scale)
    np.testing.assert_allclose(got[0], ref, atol=1e-4)


def _qdq_roundtrip(x, zp_tensor, opset):
    nodes = [P.make_node("QuantizeLinear", ["x", "s", "zp"], ["q"]),
             P.make_node("DequantizeLinear", ["q", "s", "zp"], ["y"])]
    data = _model_bytes(nodes, [_vi("x", x.shape)], [_vi("y", x.shape)],
                        [P.TensorProto.from_numpy(np.float32(0.5 if x.ndim > 1 else 1.0), "s"),
                         P.TensorProto.from_numpy(zp_tensor, "zp")], opset=opset)
    return _run_both(data, x)


def fp8_qdq_roundtrip_matches_mldtypes():
    x = (np.random.default_rng(1).standard_normal((4, 8)) * 20).astype(np.float32)
    got, want = _qdq_roundtrip(x, torch.zeros((), dtype=torch.float8_e4m3fn), 19)
    _same(got, want)
    q = np.clip(x / 0.5, -448.0, 448.0).astype(ml_dtypes.float8_e4m3fn)
    np.testing.assert_allclose(got[0], q.astype(np.float32) * 0.5, atol=1e-4)


def bf16_weights_cast_to_float_matmul():
    r = np.random.default_rng(2)
    w = torch.from_numpy(r.standard_normal((5, 3)).astype(np.float32)).to(torch.bfloat16)
    x = r.standard_normal((2, 5), dtype=np.float32)
    nodes = [P.make_node("Cast", ["w_bf16"], ["w"], to=DT.FLOAT),
             P.make_node("MatMul", ["x", "w"], ["y"])]
    got, want = _run_both(_model_bytes(nodes, [_vi("x", x.shape)], [_vi("y", (2, 3))],
                                       [P.TensorProto.from_numpy(w, "w_bf16")]), x)
    _same(got, want)
    np.testing.assert_allclose(got[0], x @ w.float().numpy(), atol=1e-4)


def cast_to_int4_saturates():
    x = np.array([-100.0, -8.4, -7.6, 7.4, 7.6, 100.0], np.float32)
    for code, lo, hi in ((DT.INT4, -8, 7), (DT.UINT4, 0, 15)):
        data = _model_bytes([P.make_node("Cast", ["x"], ["y"], to=code)],
                            [_vi("x", (6,))], [_vi("y", (6,), code)], [])
        got, want = _run_both(data, x)
        _same(got, want)
        np.testing.assert_array_equal(got[0], np.clip(np.round(x), lo, hi))


def fp8_e5m2_quantize_saturates_not_inf():
    x = np.array([1e6, -1e6, 3.0], np.float32)
    got, want = _qdq_roundtrip(x, torch.zeros((), dtype=torch.float8_e5m2), 19)
    _same(got, want)
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0][:2], [57344.0, -57344.0])


def quantize_linear_int4_zero_point_saturates_to_4bit():
    x = np.array([20.0, -20.0, 3.0], np.float32)
    zp = P.wire_tensor(torch.zeros((), dtype=torch.int8), DT.INT4)
    got, want = _qdq_roundtrip(x, zp, 21)
    _same(got, want)
    np.testing.assert_allclose(got[0], [7.0, -8.0, 3.0])


def cast_float8_saturate_attribute():
    x = np.array([1e6, -1e6, 500.0], np.float32)
    for code, saturate in ((DT.FLOAT8E4M3FN, 1), (DT.FLOAT8E5M2, 0)):
        data = _model_bytes(
            [P.make_node("Cast", ["x"], ["y"], to=code, saturate=saturate)],
            [_vi("x", (3,))], [_vi("y", (3,), code)], [])
        got, want = _run_both(data, x)
        _same(got, want)
    as_e5m2 = torch.from_numpy(got[0]).view(torch.float8_e5m2).float().numpy()
    assert np.isinf(as_e5m2[:2]).all()


MODERN_DTYPES_CASES = {
    f.__name__: f for f in (
        codec_unpacks_int4_even_and_odd_counts,
        codec_int4_truncated_payload_is_an_error,
        codec_int4_int32_data_storage,
        codec_int4_roundtrip_via_from_numpy,
        codec_bfloat16_raw_and_bitpattern_roundtrip,
        codec_float8_raw_and_bitpattern,
        codec_encodes_bf16_and_fp8_numpy_arrays,
        weight_only_int4_dequant_matmul,
        fp8_qdq_roundtrip_matches_mldtypes,
        bf16_weights_cast_to_float_matmul,
        cast_to_int4_saturates,
        fp8_e5m2_quantize_saturates_not_inf,
        quantize_linear_int4_zero_point_saturates_to_4bit,
        cast_float8_saturate_attribute,
    )
}


@pytest.mark.parametrize("case", sorted(MODERN_DTYPES_CASES))
def test_modern_dtypes_case_through_both_packages(case):
    MODERN_DTYPES_CASES[case]()


# ---------------------------------------------------------------------------
# blocked 4-bit DequantizeLinear, Constant / ConstantOfShape, Cast / CastLike
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("code", [DT.INT4, DT.UINT4], ids=["int4", "uint4"])
def test_blocked_4bit_dequantize_linear(code, axis):
    """Opset 21 blocked DequantizeLinear over a 4-bit weight with a 4-bit
    zero point per block, the last block short (70 along the axis, blocks
    of 32), into a MatMul."""
    rng = np.random.default_rng(3 + axis)
    lo, hi = (-8, 7) if code == DT.INT4 else (0, 15)
    shape = (70, 12) if axis == 0 else (12, 70)
    blocks = list(shape)
    blocks[axis] = 3
    w = rng.integers(lo, hi + 1, shape)
    zp = rng.integers(lo, hi + 1, blocks)
    scale = (rng.random(blocks) * 0.1 + 0.01).astype(np.float32)
    x = rng.standard_normal((2, shape[0]), dtype=np.float32)
    inits = [P.TensorProto(name="w", data_type=code, dims=list(shape),
                           raw_data=_pack_int4(w.reshape(-1).tolist())),
             P.TensorProto.from_numpy(scale, "s"),
             P.TensorProto(name="zp", data_type=code, dims=blocks,
                           raw_data=_pack_int4(zp.reshape(-1).tolist()))]
    nodes = [P.make_node("DequantizeLinear", ["w", "s", "zp"], ["wf"], axis=axis,
                         block_size=32),
             P.make_node("MatMul", ["x", "wf"], ["y"])]
    got, want = _run_both(_model_bytes(nodes, [_vi("x", x.shape)],
                                       [_vi("wf", shape), _vi("y", (2, shape[1]))],
                                       inits), x)
    _same(got, want)
    rep = np.repeat(scale, 32, axis=axis)[tuple(slice(0, n) for n in shape)]
    zrep = np.repeat(zp, 32, axis=axis)[tuple(slice(0, n) for n in shape)]
    np.testing.assert_allclose(got[0], (w - zrep) * rep, rtol=1e-6)


def _wire_constant(code, values):
    """A TensorProto of wire type ``code`` holding ``values`` (floats,
    rounded by torch's cast; integers for the 4-bit types)."""
    if code in (DT.INT4, DT.UINT4):
        t = P.wire_tensor(torch.tensor(values, dtype=torch.int8), code)
    else:
        dt = torch.bfloat16 if code == DT.BFLOAT16 else FLOAT8[code]
        t = torch.tensor(values, dtype=torch.float32).to(dt)
    return P.TensorProto.from_numpy(t, "value")


@pytest.mark.parametrize("code", WIRE_TYPES, ids=WIRE_IDS)
def test_constant_of_each_type(code):
    """Constant (a graph output as it is, and widened by Cast into an Add)
    and ConstantOfShape with a value of each type."""
    four_bit = code in (DT.INT4, DT.UINT4)
    vals = ([[-8, 7, 0], [3, -1, 5]] if code == DT.INT4 else
            [[0, 15, 7], [8, 1, 3]] if four_bit else [[1.5, -0.25, 3.0], [0.0, -6.0, 0.125]])
    value = _wire_constant(code, vals)
    fill = _wire_constant(code, [vals[0][1]])
    nodes = [P.make_node("Constant", [], ["c"], value=value),
             P.make_node("Cast", ["c"], ["cf"], to=DT.FLOAT),
             P.make_node("Add", ["cf", "x"], ["y"]),
             P.make_node("ConstantOfShape", ["shape"], ["k"], value=fill)]
    x = np.random.default_rng(4).standard_normal((2, 3)).astype(np.float32)
    data = _model_bytes(nodes, [_vi("x", (2, 3))],
                        [_vi("c", (2, 3), code), _vi("y", (2, 3)), _vi("k", (2, 2), code)],
                        [P.TensorProto.from_numpy(np.array([2, 2], np.int64), "shape")])
    got, want = _run_both(data, x)
    _same(got, want)


@pytest.mark.parametrize("code", WIRE_TYPES, ids=WIRE_IDS)
def test_cast_and_cast_like_each_type(code):
    """Cast of floats to the type (saturating, opset 21 default) and back
    to float, Cast of int32 to it, and CastLike of floats and of int32 to a
    constant of the type (jax.numpy's astype: float8 unsaturated, 4-bit
    truncated and saturated from floats, wrapped from integers). NaN stays
    out of the integer targets, where ONNX leaves it undefined."""
    four_bit = code in (DT.INT4, DT.UINT4)
    rng = np.random.default_rng(5)
    special = [np.inf, -np.inf, 1e6, -1e6, 500.0, 7.5, -8.5, 0.5, -0.0]
    if not four_bit:
        special.append(np.nan)
    x = np.concatenate([rng.standard_normal(23) * 20, special]).astype(np.float32)
    xi = np.array([-100, -9, -8, -1, 0, 7, 8, 15, 16, 300], np.int32)
    like = _wire_constant(code, [1] if four_bit else [1.0])
    nodes = [P.make_node("Cast", ["x"], ["c"], to=code),
             P.make_node("Cast", ["c"], ["cf"], to=DT.FLOAT),
             P.make_node("Cast", ["xi"], ["ci"], to=code),
             P.make_node("Constant", [], ["like"], value=like),
             P.make_node("CastLike", ["x", "like"], ["l"]),
             P.make_node("CastLike", ["xi", "like"], ["li"])]
    outs = [_vi("c", x.shape, code), _vi("cf", x.shape), _vi("ci", xi.shape, code),
            _vi("l", x.shape, code), _vi("li", xi.shape, code)]
    data = _model_bytes(nodes, [_vi("x", x.shape), _vi("xi", xi.shape, DT.INT32)],
                        outs, [])
    got, want = _run_both(data, x, xi)
    _same(got, want)


# ---------------------------------------------------------------------------
# legacy BatchNormalization, the compiler's exports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form,match", [
    ("training", "training form"), ("spatial0", "spatial=0")])
def test_legacy_batchnorm_refused_by_both_packages(form, match):
    """Opset 6 BatchNormalization: the multi-output training form and
    spatial=0 raise NotImplementedError in both packages, with one
    message."""
    if form == "training":
        node = P.make_node("BatchNormalization", ["x", "s", "b", "m", "v"],
                           ["y", "m_out", "v_out", "sm", "sv"], is_test=0)
        outs = [_vi("y", ()), _vi("m_out", [3])]
    else:
        node = P.make_node("BatchNormalization", ["x", "s", "b", "m", "v"], ["y"],
                           is_test=1, spatial=0)
        outs = [_vi("y", ())]
    graph = P.GraphProto(
        name="legacy_2017", node=[node],
        input=[_vi("x", (2, 3, 4, 4)), *[_vi(n, (3,)) for n in "sbmv"]],
        output=outs, initializer=[])
    data = P.encode_model(P.ModelProto(
        ir_version=3, producer_name="caffe2", graph=graph,
        opset_import=[P.OperatorSetId(domain="", version=6)]))
    args = [np.zeros((2, 3, 4, 4), np.float32)] + [np.ones(3, np.float32)] * 4
    with pytest.raises(NotImplementedError, match=match):
        import jax

        j = jimp.import_onnx(data)
        jax.jit(jimp.make_forward(j, precision="fp32"))(j.params, *args)
    t = timp.import_onnx(data)
    with pytest.raises(NotImplementedError, match=match):
        timp.make_forward(t, "fp32", "cpu")(
            timp.params_to_torch(t.params, "cpu"), *[torch.from_numpy(a) for a in args])


def test_bf16_conv_batchnorm_folds_as_the_jax_package_does():
    """A bfloat16 Conv weight with a BatchNormalization after it: the
    import-time fold (a copy of the JAX pass, written for numpy) gives the
    JAX package's folded weight and bias bit for bit."""
    rng = np.random.default_rng(7)

    def bf16(a, name):
        return P.TensorProto.from_numpy(
            torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16), name)

    inits = [bf16(rng.normal(size=(4, 3, 3, 3)), "w")] + [
        bf16(v, n) for n, v in (("s", rng.normal(size=4)), ("b", rng.normal(size=4)),
                                ("m", rng.normal(size=4)), ("v", rng.random(4) + 0.5))]
    nodes = [P.make_node("Conv", ["x", "w"], ["c"]),
             P.make_node("BatchNormalization", ["c", "s", "b", "m", "v"], ["y"])]
    data = _model_bytes(nodes, [_vi("x", (1, 3, 8, 8), DT.BFLOAT16)],
                        [_vi("y", (1, 4, 6, 6), DT.BFLOAT16)], inits, opset=17)
    j, t = jimp.import_onnx(data), timp.import_onnx(data)
    assert [n.op_type for n in t.graph.node] == [n.op_type for n in j.graph.node] == ["Conv"]
    mine = {**t.params, **t.consts}
    theirs = {**j.params, **j.consts}
    assert sorted(mine) == sorted(theirs) == ["w", "w_bn_bias"]
    for name, arr in theirs.items():
        assert isinstance(mine[name], P.WireTensor)
        np.testing.assert_array_equal(_port_value(mine[name]), _jax_value(arr))


@functools.lru_cache(maxsize=None)
def _bf16_graph():
    """A small graph in bfloat16 as a torch export writes one: bf16 weights,
    bf16 scalar Constants and a Cast of a float one, and the ops around
    them (Gemm, Where, Pow, Clip, Softmax, ConstantOfShape, Concat,
    LayerNormalization, the reductions)."""
    rng = np.random.default_rng(8)

    def bf16(values):
        return torch.tensor(np.asarray(values, np.float32)).to(torch.bfloat16)

    def const(name, value):
        return P.make_node("Constant", [], [name],
                           value=P.TensorProto.from_numpy(bf16(value), name))

    inits = {"w": bf16(rng.normal(size=(8, 8)) * 0.3), "b": bf16(rng.normal(size=8)),
             "g": bf16(rng.random(16) + 0.5), "beta": bf16(rng.normal(size=16) * 0.1)}
    nodes = [
        P.make_node("Gemm", ["x", "w", "b"], ["h"], transB=1),
        const("half", 0.5), const("one", 1.0), const("three", 3.0), const("two", 2.0),
        const("lo", -1.0), const("hi", 2.0),
        P.make_node("Mul", ["h", "half"], ["h1"]),
        P.make_node("Add", ["h1", "one"], ["h2"]),
        P.make_node("Constant", [], ["q32"], value=P.TensorProto.from_numpy(
            np.float32(0.25), "q32")),
        P.make_node("Cast", ["q32"], ["q"], to=DT.BFLOAT16),
        P.make_node("Greater", ["h2", "q"], ["m"]),
        P.make_node("Div", ["h2", "three"], ["h3"]),
        P.make_node("Where", ["m", "h2", "h3"], ["h4"]),
        P.make_node("Pow", ["h4", "two"], ["p"]),
        P.make_node("Clip", ["h4", "lo", "hi"], ["c"]),
        P.make_node("Sub", ["p", "c"], ["d"]),
        P.make_node("Softmax", ["d"], ["s"], axis=-1),
        P.make_node("Shape", ["s"], ["shape"]),
        P.make_node("ConstantOfShape", ["shape"], ["k"],
                    value=P.TensorProto.from_numpy(bf16([1.5]), "k")),
        P.make_node("Concat", ["s", "k"], ["cat"], axis=-1),
        P.make_node("LayerNormalization", ["cat", "g", "beta"], ["ln"], axis=-1),
        P.make_node("ReduceMean", ["ln"], ["mean"], axes=[-1], keepdims=1),
        P.make_node("ReduceMax", ["ln"], ["mx"], axes=[-1], keepdims=1),
        P.make_node("Add", ["mean", "mx"], ["y"]),
    ]
    data = _model_bytes(nodes, [_vi("x", ("b", 8), DT.BFLOAT16)],
                        [_vi("y", ("b", 1), DT.BFLOAT16)],
                        [P.TensorProto.from_numpy(v, k) for k, v in inits.items()], opset=17)
    return data, bf16(rng.normal(size=(3, 8)))


@pytest.mark.parametrize("precision", ["fp32", "mixed", "fast", "bf16"])
def test_bf16_graph_through_both_packages(precision):
    """A graph in bfloat16 through both packages at each policy: the
    JAX package's dtypes (fp32 widens bf16 matmul operands, as its
    ``preferred_element_type`` does) and values, at fp32 within 1e-6 of
    the scale and within 2^-7 of it under the bf16 policies (the repo's
    parity rule for ``mixed``: one bf16 rounding apart); on the meta device
    (which stands for the card) no host value meets a device tensor."""
    import jax

    data, x = _bf16_graph()
    j = jimp.import_onnx(data)
    want = np.asarray(jax.jit(jimp.make_forward(j, precision))(
        j.params, np.asarray(x.float()).astype(ml_dtypes.bfloat16))[0])
    t = timp.import_onnx(data)
    got = timp.make_forward(t, precision, "cpu")(timp.params_to_torch(t.params, "cpu"), x)[0]
    assert P.WIRE_NAMES.get(P.wire_type_of(got), "float32") == want.dtype.name
    got, want = got.float().numpy(), want.astype(np.float32)
    tol = (FLOAT_TOL if precision == "fp32" else BF16_TOL) * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    meta = timp.make_forward(t, precision, "meta")(
        timp.params_to_torch(t.params, "meta"), x.to("meta"))[0]
    assert meta.shape == (3, 1) and meta.device.type == "meta"


@pytest.mark.parametrize("value", [
    np.zeros((0, 4), np.float32),
    P.wire_tensor(torch.zeros((0, 4), dtype=torch.bfloat16)),
], ids=["float32", "bfloat16"])
def test_empty_host_value_reaches_a_device(value):
    """A host value of no elements uploads (the meta device stands for the
    card): it has no bytes to view as its dtype."""
    from birdnet_tpu_torch.compiler import ops as tops

    got = tops._on_device(value, torch.device("meta"))
    want = value.dtype if isinstance(value, torch.Tensor) else torch.float32
    assert got.shape == (0, 4) and got.dtype == want and got.device.type == "meta"


def test_compiler_package_exports_the_jax_names():
    import birdnet_tpu.compiler as jc
    import birdnet_tpu_torch.compiler as tc

    names = ("ImportedModel", "import_onnx", "make_forward", "supported_ops")
    assert all(hasattr(jc, n) for n in names)
    assert tc.import_onnx is timp.import_onnx and tc.make_forward is timp.make_forward
    assert tc.ImportedModel is timp.ImportedModel
    assert tc.supported_ops() == jc.supported_ops()


# ---------------------------------------------------------------------------
# the three weight forms of a small v2.4
# ---------------------------------------------------------------------------

N_SPECIES = 32
LABELS = [f"s{i}" for i in range(N_SPECIES)]


@functools.lru_cache(maxsize=None)
def _form_files(tmp: str) -> dict:
    """{form: (form path, yardstick path)} written under ``tmp``."""
    model = birdnet_v24.build_model(num_species=N_SPECIES, width=0.1, depth=1,
                                    seed=0, frontend="conv")
    out = {}
    for form in forms.FORMS:
        stored, yard = forms.form_bytes(model, form)
        paths = (os.path.join(tmp, f"{form}.onnx"), os.path.join(tmp, f"{form}_yard.onnx"))
        for p, data in zip(paths, (stored, yard)):
            Path(p).write_bytes(data)
        out[form] = paths
    return out


@pytest.fixture(scope="module")
def form_files(tmp_path_factory):
    return _form_files(str(tmp_path_factory.mktemp("forms")))


def _segments(n=3):
    return (np.random.default_rng(6).normal(size=(n, 144000)) * 0.1).astype(np.float32)


def _logits(pkg, path, **kw):
    builder = pkg.Classifier.builder().model_path(path).labels(LABELS).precision("fp32")
    for k, v in kw.items():
        builder = getattr(builder, k)(v)
    return np.stack([r.raw_scores for r in builder.build().predict_batch(_segments())])


@functools.lru_cache(maxsize=None)
def _port_logits(path: str) -> np.ndarray:
    return _logits(birdnet_tpu_torch, path, with_device="cpu")


# The port's distance from its yardstick file: the weight-only forms
# dequantize to the yardstick's weights exactly; bf16_direct's four layers
# also round their activations to bfloat16.
YARD_TOL = {"bf16_direct": BF16_TOL}


@pytest.mark.parametrize("form", forms.FORMS)
def test_weight_form_through_both_classifiers(form, form_files):
    path, yard = form_files[form]
    got = _port_logits(path)
    want = _logits(birdnet_tpu, path)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= FORM_TOL * scale
    ref = _port_logits(yard)
    assert np.abs(got - ref).max() <= YARD_TOL.get(form, FORM_TOL) * np.abs(ref).max()


def test_weight_forms_without_ml_dtypes(form_files, tmp_path):
    """With ml_dtypes blocked, a fresh process gives each form's logits bit
    for bit and loads each form back from a ``.btck`` with equal logits."""
    out = tmp_path / "logits.npz"
    code = (
        "import sys, json\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import numpy as np\n"
        "from birdnet_tpu_torch import Classifier\n"
        f"files = json.loads({json.dumps(json.dumps(form_files))})\n"
        f"labels = [f's{{i}}' for i in range({N_SPECIES})]\n"
        "segs = (np.random.default_rng(6).normal(size=(3, 144000)) * 0.1).astype(np.float32)\n"
        "res = {}\n"
        "for form, (path, _) in files.items():\n"
        "    clf = (Classifier.builder().model_path(path).labels(labels)\n"
        "           .precision('fp32').with_device('cpu').build())\n"
        "    res[form] = np.stack([r.raw_scores for r in clf.predict_batch(segs)])\n"
        f"    ck = {str(tmp_path)!r} + '/' + form + '.btck'\n"
        "    clf.save_checkpoint(ck)\n"
        "    back = (Classifier.builder().model_path(ck).labels(labels)\n"
        "            .precision('fp32').with_device('cpu').build())\n"
        "    res[form + '_btck'] = np.stack([r.raw_scores for r in back.predict_batch(segs)])\n"
        f"np.savez({str(out)!r}, **res)\n"
        "print('ML_DTYPES', sys.modules.get('ml_dtypes'))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr
    assert "ML_DTYPES None" in proc.stdout
    res = np.load(out)
    for form, (path, _) in form_files.items():
        np.testing.assert_array_equal(res[form], _port_logits(path))
        np.testing.assert_array_equal(res[form + "_btck"], res[form])


# ---------------------------------------------------------------------------
# .int8() over layers that read a bfloat16 weight directly
# ---------------------------------------------------------------------------

# The int8 forward of one file through both packages' builders at fp32: max
# |Δ| over the largest |logit| (tests/test_torch_quantize.py's bound).
INT8_SCALED_TOL = 1e-2


def _all_direct_bytes() -> bytes:
    """Conv → Relu → Cast(BFLOAT16) → Conv (BFLOAT16 weight and bias) →
    Cast(FLOAT) → Relu → Conv at opset 17: the first conv reads the graph
    input and the last gives the graph output (both stay float), so the
    only layer the quantizer could pick reads its weight in bfloat16."""
    rng = np.random.default_rng(8)
    w = [rng.normal(size=(4, 4, 1, 1)).astype(np.float32) * 0.5 for _ in range(3)]
    inits = [P.TensorProto.from_numpy(w[0], "w1"),
             P.TensorProto.from_numpy(torch.from_numpy(w[1]).to(torch.bfloat16), "w2"),
             P.TensorProto.from_numpy(torch.ones(4, dtype=torch.bfloat16), "b2"),
             P.TensorProto.from_numpy(w[2], "w3")]
    nodes = [P.make_node("Conv", ["x", "w1"], ["c1"]),
             P.make_node("Relu", ["c1"], ["r1"]),
             P.make_node("Cast", ["r1"], ["h"], to=DT.BFLOAT16),
             P.make_node("Conv", ["h", "w2", "b2"], ["c2"]),
             P.make_node("Cast", ["c2"], ["f"], to=DT.FLOAT),
             P.make_node("Relu", ["f"], ["r2"]),
             P.make_node("Conv", ["r2", "w3"], ["y"])]
    return _model_bytes(nodes, [_vi("x", [1, 4, 8, 8])], [_vi("y", [1, 4, 8, 8])],
                        inits, opset=17)


def _all_direct_input() -> np.ndarray:
    return np.random.default_rng(9).normal(size=(1, 4, 8, 8)).astype(np.float32)


def _calibration():
    return [_segments()[:2]]


@pytest.fixture(scope="module")
def port_int8_without_ml_dtypes(form_files, tmp_path_factory):
    """The port's half, in a fresh process with ml_dtypes blocked: the
    names of the nodes its quantizer picks on ``bf16_direct``, its
    QLinearConv count, its int8 logits, and the error of the all-direct
    file."""
    tmp = tmp_path_factory.mktemp("int8_direct")
    direct = tmp / "all_direct.onnx"
    direct.write_bytes(_all_direct_bytes())
    out = tmp / "port.npz"
    code = (
        "import sys, json\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import numpy as np\n"
        "from birdnet_tpu_torch import Classifier\n"
        "from birdnet_tpu_torch.compiler import importer, quantize\n"
        "picked = []\n"
        "pick = quantize._eligible_nodes\n"
        "def record(*a, **k):\n"
        "    out = pick(*a, **k)\n"
        "    picked.append([n.name for n, *_ in out])\n"
        "    return out\n"
        "quantize._eligible_nodes = record\n"
        f"labels = [f's{{i}}' for i in range({N_SPECIES})]\n"
        "segs = (np.random.default_rng(6).normal(size=(3, 144000)) * 0.1).astype(np.float32)\n"
        f"clf = (Classifier.builder().model_path({form_files['bf16_direct'][0]!r})\n"
        "       .labels(labels).precision('fp32').with_device('cpu').int8([segs[:2]]).build())\n"
        "logits = np.stack([r.raw_scores for r in clf.predict_batch(segs)])\n"
        "n_qconv = sum(n.op_type == 'QLinearConv' for n in clf._imported.graph.node)\n"
        "int8_picked = list(picked)\n"
        "x = np.random.default_rng(9).normal(size=(1, 4, 8, 8)).astype(np.float32)\n"
        "try:\n"
        f"    quantize.quantize_model(importer.import_onnx({str(direct)!r}), [x], device='cpu')\n"
        "    error = None\n"
        "except Exception as e:\n"
        "    error = [type(e).__name__, str(e)]\n"
        f"np.savez({str(out)!r}, logits=logits)\n"
        "print('RESULT', json.dumps({'picked': int8_picked, 'n_qconv': int(n_qconv),\n"
        "      'error': error, 'ml_dtypes': repr(sys.modules.get('ml_dtypes'))}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr
    (line,) = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    result = json.loads(line[len("RESULT "):])
    assert result["ml_dtypes"] == "None"
    result["logits"] = np.load(out)["logits"]
    result["all_direct"] = str(direct)
    return result


def test_int8_over_bf16_direct_picks_the_jax_layers(form_files, port_int8_without_ml_dtypes,
                                                    monkeypatch):
    """``.int8()`` on ``bf16_direct``: the same picked layers (the four
    bfloat16 ones left float) and QLinearConv count as the JAX package,
    int8 logits within INT8_SCALED_TOL of its scale."""
    from birdnet_tpu.compiler import quantize as jq

    picked = []
    pick = jq._eligible_nodes

    def record(*args, **kwargs):
        out = pick(*args, **kwargs)
        picked.append([n.name for n, *_ in out])
        return out

    monkeypatch.setattr(jq, "_eligible_nodes", record)
    clf = (birdnet_tpu.Classifier.builder().model_path(form_files["bf16_direct"][0])
           .labels(LABELS).precision("fp32").int8(_calibration()).build())
    want = np.stack([r.raw_scores for r in clf.predict_batch(_segments())])
    port = port_int8_without_ml_dtypes
    assert port["picked"] == picked and len(picked) == 1
    direct = {n.name for n in forms._direct_convs(
        P.decode_model(Path(form_files["bf16_direct"][1]).read_bytes()).graph)}
    assert len(direct) == forms.DIRECT_LAYERS and not direct & set(picked[0])
    assert port["n_qconv"] == sum(n.op_type == "QLinearConv" for n in clf._imported.graph.node)
    assert port["n_qconv"] > 0
    got = port["logits"]
    assert got.shape == want.shape == (3, N_SPECIES)
    assert np.abs(got - want).max() <= INT8_SCALED_TOL * np.abs(want).max()


def test_int8_with_only_bf16_direct_layers_fails_in_both(port_int8_without_ml_dtypes):
    from birdnet_tpu.compiler import quantize as jq
    from birdnet_tpu.errors import ModelLoadError

    with pytest.raises(ModelLoadError, match="no quantizable layers found") as info:
        jq.quantize_model(jimp.import_onnx(port_int8_without_ml_dtypes["all_direct"]),
                          [_all_direct_input()])
    assert port_int8_without_ml_dtypes["error"] == ["ModelLoadError", str(info.value)]
