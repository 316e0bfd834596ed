"""The com.microsoft contrib domain's cases, built with the port's own codec
and plain torch: this module imports numpy, torch and birdnet_tpu_torch only
(no JAX, no transformers), so the card's machine runs it too.

- ``CASES[name]()`` gives ``(model_bytes, inputs)`` for each of the 44
  com.microsoft names of birdnet_tpu_torch/compiler/ops_contrib.py: one
  small seeded graph per name (``inputs`` an ordered dict of numpy arrays,
  the graph's inputs in order). ``HOST_INPUTS`` names the inputs a
  lowering reads on the host (``max_length``...): a run on the card passes
  them as numpy. ``EAGER`` names the cases held against the JAX
  package's eager forward: the generation ops and DynamicTimeWarping need
  concrete inputs, and jitted XLA turns the requantize's division by a
  constant scale into a reciprocal multiply (ROADMAP C). The generation cases run at
  ``length_penalty = 0`` and Sampling at ``top_p -> 0``, where the two
  packages agree (ROADMAP C).
- ``BIG[name]()``: the same kind of graph at the shapes the card meets
  (v2.4's convs, BERT-base attention, a llama-style GQA layer, a 4096 ×
  4096 4-bit projection, 10^6 hashes).
- ``ort_optimized(model)``: a model rewritten as onnxruntime's offline
  optimizer writes it (BatchNormalization folded into Conv, then each
  ``x·sigmoid(x)`` as com.microsoft QuickGelu(alpha=1), then each Conv
  whose only consumer is a Sigmoid as FusedConv(activation="Sigmoid")).
- ``TinyGpt`` and ``EncDec``: plain-torch GPT-2-style and whisper/T5-style
  decoders with numpy-seeded weights, exported with torch's exporter into
  the subgraphs of convert_generation.py's GreedySearch / Sampling /
  BeamSearch / WhisperBeamSearch nodes (``gpt_step_graph``,
  ``encdec_graphs``, ``generation_model``).
"""

from __future__ import annotations

import functools
import importlib.util
import math
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from birdnet_tpu_torch.onnx import proto as P

MS = "com.microsoft"
F = P.DataType
I32, F32 = F.INT32, F.FLOAT
HOST_INPUTS = ("max_length", "min_length", "num_beams", "num_return_sequences",
               "length_penalty", "logits_processor")
GENERATION = ("GreedySearch", "Sampling", "BeamSearch", "WhisperBeamSearch")
QUANTIZED = ("QLinearAdd", "QLinearMul", "QLinearSigmoid", "QLinearLeakyRelu",
             "QLinearAveragePool", "QLinearGlobalAveragePool", "QLinearConcat", "QGemm",
             "QLinearSoftmax", "QLinearReduceMean")
EAGER = GENERATION + QUANTIZED + ("DynamicTimeWarping",)
# Codes requantized from a float sum (pools, means, softmax, QGemm's
# product): two backends add the float terms in other orders, so a value at
# a rounding tie may land on either side. They are held within one code.
ROUNDED = ("QLinearAveragePool", "QLinearGlobalAveragePool", "QLinearReduceMean",
           "QLinearSoftmax", "QGemm")
CASES = {}
BIG = {}


def compare(name: str, got, want) -> tuple:
    """(worst difference over each float output's largest magnitude,
    integer outputs agree) of one graph's outputs ``got`` against ``want``:
    codes of ``ROUNDED`` within one, every other integer equal. A shape or
    dtype that differs gives ``(inf, False)``."""
    if len(got) != len(want):
        return float("inf"), False
    err, ints_ok = 0.0, True
    for g, w in zip(got, want):
        g, w = torch.as_tensor(g).cpu(), torch.as_tensor(w).cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            return float("inf"), False
        if not g.numel():
            continue
        if w.is_floating_point():
            scale = max(float(w.double().abs().max()), 1e-30)
            err = max(err, float((g.double() - w.double()).abs().max()) / scale)
        else:
            diff = int((g.long() - w.long()).abs().max())
            ints_ok = ints_ok and diff <= (1 if name in ROUNDED else 0)
    return err, ints_ok


def _export_module():
    """tests/_torch_export.py, loaded by path (the card's machine runs
    chip_smoke.py from the repository root, without tests/ on the path)."""
    path = Path(__file__).with_name("_torch_export.py")
    spec = importlib.util.spec_from_file_location("_torch_export", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _n(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _vi(name, arr):
    arr = np.asarray(arr)
    return P.make_value_info(name, P._NUMPY_TO_DTYPE[arr.dtype], list(arr.shape))


def model(nodes, inputs, inits=None, outputs=("y",), opset=17, name="contrib"):
    """The bytes of a graph of com.microsoft nodes (opset imports for the
    default and the com.microsoft domains), as ORT writes such files."""
    init = [P.TensorProto.from_numpy(np.asarray(v), name=k)
            for k, v in (inits or {}).items()]
    graph = P.GraphProto(
        name=name, node=list(nodes), initializer=init,
        input=[_vi(k, v) for k, v in inputs.items()],
        output=[P.make_value_info(o, F32, []) for o in outputs])
    m = P.ModelProto(ir_version=8, producer_name="onnxruntime", producer_version="1.22.0",
                     graph=graph, opset_import=[P.OperatorSetId(domain="", version=opset),
                                                P.OperatorSetId(domain=MS, version=1)])
    return P.encode_model(m)


def _ms(op, inputs, outputs=("y",), **attrs):
    return P.make_node(op, list(inputs), list(outputs), domain=MS, **attrs)


def _case(table, name):
    def deco(fn):
        table[name] = fn
        return fn
    return deco


def _single(op, inputs, inits=None, outputs=("y",), **attrs):
    """One node reading every input and initializer in order."""
    names = list(inputs) + list(inits or {})
    return model([_ms(op, names, outputs, **attrs)], inputs, inits, outputs), inputs


def _q(rng, shape, dtype=np.uint8):
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, shape).astype(dtype)


def pack_nibbles(vals) -> np.ndarray:
    """4-bit values (0..15) packed low nibble first along the last axis."""
    v = np.asarray(vals).astype(np.uint8) & 0xF
    if v.shape[-1] % 2:
        v = np.concatenate([v, np.zeros(v.shape[:-1] + (1,), np.uint8)], axis=-1)
    return (v[..., 0::2] | (v[..., 1::2] << 4)).astype(np.uint8)


# ---------------------------------------------------------------------------
# fused CNN epilogues and elementwise fusions
# ---------------------------------------------------------------------------


@_case(CASES, "FusedConv")
def _fused_conv(shape=(2, 3, 8, 8), cout=4, seed=0):
    r = np.random.default_rng(seed)
    n, c, h, w = shape
    ins = OrderedDict(x=_n(r, shape), z=_n(r, (n, cout, h, w)))
    inits = {"w": _n(r, (cout, c, 3, 3), 0.3), "b": _n(r, (cout,))}
    node = _ms("FusedConv", ["x", "w", "b", "z"], pads=[1, 1, 1, 1],
               activation="LeakyRelu", activation_params=[0.2])
    return model([node], ins, inits), ins


@_case(CASES, "FusedGemm")
def _fused_gemm():
    r = np.random.default_rng(1)
    return _single("FusedGemm", OrderedDict(a=_n(r, (4, 6))),
                   {"b": _n(r, (5, 6)), "c": _n(r, (5,))}, transB=1,
                   activation="Clip", activation_alpha=-0.5, activation_beta=0.7)


@_case(CASES, "FusedMatMul")
def _fused_matmul():
    r = np.random.default_rng(2)
    return _single("FusedMatMul", OrderedDict(a=_n(r, (2, 3, 4)), b=_n(r, (2, 5, 4))),
                   transB=1, alpha=0.5)


@_case(CASES, "TransposeMatMul")
def _transpose_matmul():
    r = np.random.default_rng(3)
    return _single("TransposeMatMul", OrderedDict(a=_n(r, (2, 4, 3)), b=_n(r, (2, 4, 5))),
                   transA=1)


@_case(CASES, "FastGelu")
def _fast_gelu(shape=(2, 5, 8)):
    r = np.random.default_rng(4)
    return _single("FastGelu", OrderedDict(x=_n(r, shape)), {"bias": _n(r, shape[-1:])})


@_case(CASES, "BiasGelu")
def _bias_gelu():
    r = np.random.default_rng(5)
    return _single("BiasGelu", OrderedDict(x=_n(r, (2, 5, 8))), {"bias": _n(r, (8,))})


@_case(CASES, "QuickGelu")
def _quick_gelu():
    r = np.random.default_rng(6)
    return _single("QuickGelu", OrderedDict(x=_n(r, (2, 4, 6), 3.0)))


@_case(CASES, "GemmFastGelu")
def _gemm_fast_gelu():
    r = np.random.default_rng(7)
    return _single("GemmFastGelu", OrderedDict(x=_n(r, (3, 8))),
                   {"w": _n(r, (8, 6)), "bias": _n(r, (6,))})


@_case(CASES, "BiasAdd")
def _bias_add():
    r = np.random.default_rng(8)
    return _single("BiasAdd", OrderedDict(x=_n(r, (2, 4, 8)), bias=_n(r, (8,)),
                                          skip=_n(r, (2, 4, 8))))


@_case(CASES, "BiasSoftmax")
def _bias_softmax():
    r = np.random.default_rng(9)
    return _single("BiasSoftmax", OrderedDict(x=_n(r, (2, 3, 4, 5)), bias=_n(r, (2, 3, 4, 5))))


@_case(CASES, "SkipLayerNormalization")
def _skip_ln(shape=(2, 4, 8)):
    r = np.random.default_rng(10)
    h = shape[-1]
    ins = OrderedDict(x=_n(r, shape), skip=_n(r, shape))
    inits = {"gamma": _n(r, (h,)), "beta": _n(r, (h,)), "bias": _n(r, (h,))}
    return model([_ms("SkipLayerNormalization", ["x", "skip", "gamma", "beta", "bias"],
                      ["y", "mean", "inv", "sum"], epsilon=1e-5)],
                 ins, inits, ("y", "mean", "inv", "sum")), ins


@_case(CASES, "SkipSimplifiedLayerNormalization")
def _skip_simplified_ln():
    r = np.random.default_rng(11)
    ins = OrderedDict(x=_n(r, (2, 4, 8)), skip=_n(r, (2, 4, 8)))
    inits = {"gamma": _n(r, (8,)), "bias": _n(r, (8,))}
    return model([_ms("SkipSimplifiedLayerNormalization", ["x", "skip", "gamma", "bias"],
                      ["y", "mean", "inv", "sum"])],
                 ins, inits, ("y", "mean", "inv", "sum")), ins


@_case(CASES, "NhwcConv")
def _nhwc_conv():
    r = np.random.default_rng(12)
    return _single("NhwcConv", OrderedDict(x=_n(r, (2, 8, 8, 3))),
                   {"w": _n(r, (4, 3, 3, 3), 0.3), "b": _n(r, (4,))},
                   pads=[1, 1, 1, 1], strides=[2, 2])


# ---------------------------------------------------------------------------
# the quantized set
# ---------------------------------------------------------------------------


def _qparams(name, scale, zp):
    return {f"{name}_s": np.float32(scale), f"{name}_zp": np.asarray(zp)}


def _qbinary(op, seed, shape=(2, 3, 4, 4), omit_zp=False):
    r = np.random.default_rng(seed)
    ins = OrderedDict(a=_q(r, shape, np.int8), b=_q(r, shape[1:], np.int8))
    inits = {"a_s": np.float32(0.05), "a_zp": np.int8(3), "b_s": np.float32(0.04),
             "b_zp": np.int8(-2), "c_s": np.float32(0.07)}
    names = ["a", "a_s", "a_zp", "b", "b_s", "b_zp", "c_s"]
    if not omit_zp:
        inits["c_zp"] = np.int8(1)
        names.append("c_zp")
    return model([_ms(op, names)], ins, inits), ins


@_case(CASES, "QLinearAdd")
def _qlinear_add(shape=(2, 3, 4, 4)):
    return _qbinary("QLinearAdd", 13, shape, omit_zp=True)  # int8 by _default_zp


@_case(CASES, "QLinearMul")
def _qlinear_mul(shape=(2, 3, 4, 4)):
    return _qbinary("QLinearMul", 14, shape)


def _qunary(op, seed, shape=(2, 3, 4, 4), **attrs):
    r = np.random.default_rng(seed)
    ins = OrderedDict(x=_q(r, shape))
    inits = {"x_s": np.float32(0.03), "x_zp": np.uint8(128), "y_s": np.float32(0.004),
             "y_zp": np.uint8(0)}
    return model([_ms(op, ["x", "x_s", "x_zp", "y_s", "y_zp"], **attrs)], ins, inits), ins


@_case(CASES, "QLinearSigmoid")
def _qlinear_sigmoid(shape=(2, 3, 4, 4)):
    return _qunary("QLinearSigmoid", 15, shape)


@_case(CASES, "QLinearLeakyRelu")
def _qlinear_leaky_relu():
    return _qunary("QLinearLeakyRelu", 16, alpha=0.1)


@_case(CASES, "QLinearAveragePool")
def _qlinear_average_pool():
    return _qunary("QLinearAveragePool", 17, (2, 3, 6, 6), kernel_shape=[2, 2],
                   strides=[2, 2])


@_case(CASES, "QLinearGlobalAveragePool")
def _qlinear_global_average_pool(shape=(2, 5, 5, 3)):
    return _qunary("QLinearGlobalAveragePool", 18, shape, channels_last=1)


@_case(CASES, "QLinearConcat")
def _qlinear_concat():
    r = np.random.default_rng(19)
    ins = OrderedDict(a=_q(r, (2, 3, 4)), b=_q(r, (2, 5, 4)))
    inits = {"y_s": np.float32(0.05), "y_zp": np.uint8(120), "a_s": np.float32(0.04),
             "a_zp": np.uint8(128), "b_s": np.float32(0.06), "b_zp": np.uint8(100)}
    node = _ms("QLinearConcat", ["y_s", "y_zp", "a", "a_s", "a_zp", "b", "b_s", "b_zp"],
               axis=1)
    return model([node], ins, inits), ins


@_case(CASES, "MatMulIntegerToFloat")
def _matmul_integer_to_float():
    r = np.random.default_rng(20)
    ins = OrderedDict(a=_q(r, (3, 8)))
    inits = {"b": _q(r, (8, 5), np.int8), "a_s": np.float32(0.02),
             "b_s": (r.random(5) * 0.05 + 0.01).astype(np.float32),
             "a_zp": np.uint8(128), "b_zp": np.zeros(5, np.int8), "bias": _n(r, (5,))}
    return model([_ms("MatMulIntegerToFloat", ["a", "b", "a_s", "b_s", "a_zp", "b_zp",
                                               "bias"])], ins, inits), ins


@_case(CASES, "DynamicQuantizeMatMul")
def _dynamic_quantize_matmul():
    r = np.random.default_rng(21)
    ins = OrderedDict(a=_n(r, (3, 8)))
    inits = {"b": _q(r, (8, 5), np.int8), "b_s": np.float32(0.03), "b_zp": np.int8(0),
             "bias": _n(r, (5,))}
    return model([_ms("DynamicQuantizeMatMul", ["a", "b", "b_s", "b_zp", "bias"])],
                 ins, inits), ins


@_case(CASES, "QGemm")
def _qgemm():
    r = np.random.default_rng(22)
    ins = OrderedDict(a=_q(r, (4, 6)))
    inits = {"a_s": np.float32(0.02), "a_zp": np.uint8(128), "b": _q(r, (5, 6), np.int8),
             "b_s": (r.random(5) * 0.05 + 0.01).astype(np.float32),
             "b_zp": np.zeros(5, np.int8),
             "c": r.integers(-500, 500, 5).astype(np.int32), "y_s": np.float32(0.05),
             "y_zp": np.uint8(128)}
    node = _ms("QGemm", ["a", "a_s", "a_zp", "b", "b_s", "b_zp", "c", "y_s", "y_zp"],
               transB=1, alpha=0.9)
    return model([node], ins, inits), ins


def _attention_inputs(r, b, s, hidden, heads):
    return (_n(r, (b, s, hidden)), _n(r, (hidden, 3 * hidden), 1 / math.sqrt(hidden)),
            _n(r, (3 * hidden,), 0.1))


@_case(CASES, "QAttention")
def _qattention():
    r = np.random.default_rng(23)
    b, s, hidden = 2, 5, 8
    ins = OrderedDict(x=_q(r, (b, s, hidden)),
                      mask=np.array([5, 3], np.int32))
    inits = {"w": _q(r, (hidden, 3 * hidden)), "bias": _n(r, (3 * hidden,), 0.1),
             "x_s": np.float32(0.02), "w_s": np.float32(0.01), "x_zp": np.uint8(128),
             "w_zp": np.uint8(128)}
    node = _ms("QAttention", ["x", "w", "bias", "x_s", "w_s", "mask", "x_zp", "w_zp"],
               num_heads=2)
    return model([node], ins, inits), ins


@_case(CASES, "QLinearSoftmax")
def _qlinear_softmax():
    return _qunary("QLinearSoftmax", 24, (2, 3, 5), axis=1, opset=12)


@_case(CASES, "QLinearReduceMean")
def _qlinear_reduce_mean():
    return _qunary("QLinearReduceMean", 25, (2, 3, 4, 4), axes=[2, 3], keepdims=1)


# ---------------------------------------------------------------------------
# transformer ops
# ---------------------------------------------------------------------------


@_case(CASES, "Attention")
def _attention(b=2, s=5, hidden=8, heads=2, past=3, seed=26):
    r = np.random.default_rng(seed)
    x, w, bias = _attention_inputs(r, b, s, hidden, heads)
    ins = OrderedDict(x=x, mask=np.array([past + s, past + s - 2] * (b // 2), np.int32),
                      past=_n(r, (2, b, heads, past, hidden // heads)))
    node = _ms("Attention", ["x", "w", "bias", "mask", "past"], ["y", "present"],
               num_heads=heads, unidirectional=1)
    return model([node], ins, {"w": w, "bias": bias}, ("y", "present")), ins


@_case(CASES, "EmbedLayerNormalization")
def _embed_ln(b=2, s=6, hidden=8, vocab=20, seed=27):
    r = np.random.default_rng(seed)
    mask = np.ones((b, s), np.int32)
    mask[-1, -2:] = 0
    ins = OrderedDict(ids=r.integers(0, vocab, (b, s)).astype(np.int32),
                      seg=r.integers(0, 2, (b, s)).astype(np.int32), mask=mask)
    inits = {"word": _n(r, (vocab, hidden)), "pos": _n(r, (max(s, 16), hidden)),
             "segemb": _n(r, (2, hidden)), "gamma": _n(r, (hidden,)),
             "beta": _n(r, (hidden,))}
    node = _ms("EmbedLayerNormalization",
               ["ids", "seg", "word", "pos", "segemb", "gamma", "beta", "mask"],
               ["y", "mask_index", "sum"], epsilon=1e-12)
    return model([node], ins, inits, ("y", "mask_index", "sum")), ins


@_case(CASES, "MultiHeadAttention")
def _mha(b=2, sq=4, skv=6, hidden=8, heads=2, seed=28):
    r = np.random.default_rng(seed)
    ins = OrderedDict(q=_n(r, (b, sq, hidden)), k=_n(r, (b, skv, hidden)),
                      v=_n(r, (b, skv, hidden)),
                      kpm=np.array([skv, skv - 2] * (b // 2), np.int32))
    node = _ms("MultiHeadAttention", ["q", "k", "v", "bias", "kpm"], num_heads=heads)
    return model([node], ins, {"bias": _n(r, (3 * hidden,), 0.1)}), ins


def _rope_caches(max_pos, rd, base=10000.0):
    inv = 1.0 / base ** (np.arange(0, rd, 2) / rd)
    ang = np.arange(max_pos)[:, None] * inv[None]
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@_case(CASES, "RotaryEmbedding")
def _rotary():
    r = np.random.default_rng(29)
    b, s, heads, hd = 2, 5, 2, 8
    cos, sin = _rope_caches(32, hd)
    ins = OrderedDict(x=_n(r, (b, s, heads * hd)),
                      pos=r.integers(0, 32, (b, s)).astype(np.int64))
    node = _ms("RotaryEmbedding", ["x", "pos", "cos", "sin"], num_heads=heads)
    return model([node], ins, {"cos": cos, "sin": sin}), ins


def gqa_case(b, s, past, heads, kv_heads, hd, seed, window=-1, softcap=0.0, cache=None):
    """A GroupQueryAttention node with rotary (caches of ``cache``
    positions): a prefill (``past=0``) or a continuation over a
    ``past``-slot cache, row 1 three tokens short."""
    r = np.random.default_rng(seed)
    cos, sin = _rope_caches(cache or past + s + 8, hd)
    total = past + s
    ins = OrderedDict(q=_n(r, (b, s, heads * hd)), k=_n(r, (b, s, kv_heads * hd)),
                      v=_n(r, (b, s, kv_heads * hd)))
    names = ["q", "k", "v"]
    if past:
        ins["pk"] = _n(r, (b, kv_heads, past, hd))
        ins["pv"] = _n(r, (b, kv_heads, past, hd))
        names += ["pk", "pv"]
    else:
        names += ["", ""]
    lens = np.full(b, total - 1, np.int32)
    lens[1:] -= 3 if not past else 0
    ins["seqlens"] = lens
    ins["total"] = np.array([total], np.int32)
    names += ["seqlens", "total", "cos", "sin"]
    attrs = dict(num_heads=heads, kv_num_heads=kv_heads, do_rotary=1)
    if window > 0:
        attrs["local_window_size"] = window
    if softcap:
        attrs["softcap"] = softcap
    node = _ms("GroupQueryAttention", names, ["y", "pk_out", "pv_out"], **attrs)
    return model([node], ins, {"cos": cos, "sin": sin}, ("y", "pk_out", "pv_out")), ins


@_case(CASES, "GroupQueryAttention")
def _gqa():
    return gqa_case(2, 1, 6, 4, 2, 8, 30, window=4, softcap=20.0)


@_case(CASES, "GroupNorm")
def _group_norm():
    r = np.random.default_rng(31)
    return _single("GroupNorm", OrderedDict(x=_n(r, (2, 4, 4, 8))),
                   {"gamma": _n(r, (8,)), "beta": _n(r, (8,))}, groups=4, activation=1,
                   channels_last=1, epsilon=1e-5)


@_case(CASES, "SkipGroupNorm")
def _skip_group_norm():
    r = np.random.default_rng(32)
    ins = OrderedDict(x=_n(r, (2, 4, 4, 8)))
    inits = {"gamma": _n(r, (8,)), "beta": _n(r, (8,)), "skip": _n(r, (2, 8)),
             "bias": _n(r, (8,))}
    node = _ms("SkipGroupNorm", ["x", "gamma", "beta", "skip", "bias"], ["y", "sum"],
               groups=2, activation=0)
    return model([node], ins, inits, ("y", "sum")), ins


@_case(CASES, "BiasSplitGelu")
def _bias_split_gelu():
    r = np.random.default_rng(33)
    return _single("BiasSplitGelu", OrderedDict(x=_n(r, (2, 4, 16))), {"bias": _n(r, (16,))})


def nbits_case(m, k, n, block, seed, bits=4, batch=()):
    """MatMulNBits ``[*batch, m, k] @ W.T``, W [n, k] quantized at ``bits``
    in blocks of ``block`` (a tail block when ``block`` does not divide
    ``k``), 4-bit zero points packed."""
    r = np.random.default_rng(seed)
    n_blocks = -(-k // block)
    q = r.integers(0, 1 << bits, (n, n_blocks * block))
    scales = (r.random((n, n_blocks)) * 0.02 + 0.002).astype(np.float32)
    inits = {"scales": scales}
    if bits == 4:
        inits["b"] = pack_nibbles(q).reshape(n, n_blocks, block // 2)
        inits["zp"] = pack_nibbles(r.integers(0, 16, (n, n_blocks))).reshape(-1)
    else:
        inits["b"] = q.astype(np.uint8).reshape(n, n_blocks, block)
        inits["zp"] = r.integers(0, 256, (n, n_blocks)).astype(np.uint8)
    inits["bias"] = _n(r, (n,), 0.1)
    ins = OrderedDict(a=_n(r, tuple(batch) + (m, k)))
    node = _ms("MatMulNBits", ["a", "b", "scales", "zp", "", "bias"], K=k, N=n, bits=bits,
               block_size=block, accuracy_level=4)
    return model([node], ins, {k_: inits[k_] for k_ in ("b", "scales", "zp", "bias")}), ins


@_case(CASES, "MatMulNBits")
def _matmul_nbits():
    return nbits_case(3, 40, 6, 16, 34, batch=(2,))


@_case(CASES, "GatherBlockQuantized")
def _gather_block_quantized():
    r = np.random.default_rng(35)
    vocab, hdim, bs = 6, 8, 4
    q = r.integers(0, 16, (vocab, hdim))
    inits = {"data": pack_nibbles(q),
             "scales": (r.random((vocab, hdim // bs)) * 0.3 + 0.02).astype(np.float32),
             "zp": pack_nibbles(r.integers(0, 16, (vocab, hdim // bs)))}
    ins = OrderedDict(ids=np.array([[1, 4], [5, 0]], np.int64))
    node = _ms("GatherBlockQuantized", ["data", "ids", "scales", "zp"], gather_axis=0,
               quantize_axis=1, block_size=bs)
    return model([node], ins, inits), ins


@_case(CASES, "Inverse")
def _inverse():
    r = np.random.default_rng(36)
    x = _n(r, (3, 4, 4)) + 4 * np.eye(4, dtype=np.float32)
    return _single("Inverse", OrderedDict(x=x))


@_case(CASES, "MurmurHash3")
def _murmurhash3(n=64):
    r = np.random.default_rng(37)
    return _single("MurmurHash3", OrderedDict(x=r.integers(-2**31, 2**31, n).astype(np.int32)),
                   seed=42, positive=1)


@_case(CASES, "UnfoldTensor")
def _unfold():
    r = np.random.default_rng(38)
    return _single("UnfoldTensor", OrderedDict(x=_n(r, (2, 10, 3))), dim=1, size=4, step=3)


@_case(CASES, "DynamicTimeWarping")
def _dtw():
    r = np.random.default_rng(39)
    return _single("DynamicTimeWarping", OrderedDict(x=r.random((7, 9)).astype(np.float32)))


# ---------------------------------------------------------------------------
# plain-torch decoders for the generation ops
# ---------------------------------------------------------------------------


class _Params:
    """numpy-seeded weights (the same bits on every machine)."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __call__(self, *shape, scale=0.02):
        return torch.nn.Parameter(torch.from_numpy(_n(self.rng, shape, scale)),
                                  requires_grad=False)

    def ones(self, n):
        return torch.nn.Parameter(torch.ones(n), requires_grad=False)

    def zeros(self, n):
        return torch.nn.Parameter(torch.zeros(n), requires_grad=False)


def _ln(x, g, b):
    return torch.nn.functional.layer_norm(x, g.shape, g, b, 1e-5)


def _heads(x, h):
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h).transpose(1, 2)


def _merge(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _attend(q, k, v, keep):
    scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    scores = torch.where(keep, scores, torch.full_like(scores, -1e9))
    return torch.softmax(scores, dim=-1) @ v


class _Block(torch.nn.Module):
    """A pre-LN transformer block: self-attention (fused QKV), optional
    cross-attention, GELU MLP."""

    def __init__(self, p, d, heads, cross=False, wscale=0.02):
        super().__init__()
        self.heads = heads
        self.ln1_g, self.ln1_b = p.ones(d), p.zeros(d)
        self.qkv_w, self.qkv_b = p(d, 3 * d, scale=wscale), p(3 * d, scale=wscale)
        self.o_w = p(d, d, scale=wscale)
        if cross:
            self.lnx_g, self.lnx_b = p.ones(d), p.zeros(d)
            self.xq_w, self.xkv_w, self.xo_w = (p(d, d, scale=wscale),
                                                p(d, 2 * d, scale=wscale),
                                                p(d, d, scale=wscale))
        self.ln2_g, self.ln2_b = p.ones(d), p.zeros(d)
        self.fc_w, self.fc_b = p(d, 4 * d, scale=wscale), p(4 * d, scale=wscale)
        self.proj_w = p(4 * d, d, scale=wscale)

    def self_attn(self, x, past_k, past_v, keep):
        q, k, v = (_ln(x, self.ln1_g, self.ln1_b) @ self.qkv_w + self.qkv_b).chunk(3, dim=-1)
        k = torch.cat([past_k, _heads(k, self.heads)], dim=2)
        v = torch.cat([past_v, _heads(v, self.heads)], dim=2)
        y = _attend(_heads(q, self.heads), k, v, keep)
        return x + _merge(y) @ self.o_w, k, v

    def cross_kv(self, enc):
        k, v = (enc @ self.xkv_w).chunk(2, dim=-1)
        return _heads(k, self.heads), _heads(v, self.heads)

    def cross_attn(self, x, ck, cv, keep):
        q = _heads(_ln(x, self.lnx_g, self.lnx_b) @ self.xq_w, self.heads)
        return x + _merge(_attend(q, ck, cv, keep)) @ self.xo_w

    def mlp(self, x):
        h = torch.nn.functional.gelu(_ln(x, self.ln2_g, self.ln2_b) @ self.fc_w + self.fc_b)
        return x + h @ self.proj_w


class TinyGpt(torch.nn.Module):
    """A GPT-2-style decoder in the convert_generation.py step signature:
    (input_ids, position_ids, attention_mask [B, past + S], past_i
    [2, B, heads, past, head]) -> (logits [B, S, V], present_i). Key j is
    seen by query i when the mask keeps it and j <= past + i."""

    def __init__(self, vocab=50, d=32, layers=2, heads=2, n_pos=64, seed=0):
        super().__init__()
        p = _Params(seed)
        self.heads, self.layers_n = heads, layers
        self.wte, self.wpe = p(vocab, d, scale=0.5), p(n_pos, d, scale=0.1)
        # an untied head: a random tied one mostly repeats the last token
        self.head = p(vocab, d, scale=0.5 / math.sqrt(d) * 3.0)
        self.blocks = torch.nn.ModuleList(
            [_Block(p, d, heads, wscale=0.5 / math.sqrt(d)) for _ in range(layers)])
        self.lnf_g, self.lnf_b = p.ones(d), p.zeros(d)

    def forward(self, ids, pos, mask, *pasts):
        x = self.wte[ids.long()] + self.wpe[pos.long()]
        s, total = ids.shape[1], mask.shape[1]
        qpos = torch.arange(s)[:, None] + (total - s)
        keep = (mask[:, None, None, :] != 0) & (torch.arange(total)[None, :] <= qpos)
        presents = []
        for blk, past in zip(self.blocks, pasts):
            x, k, v = blk.self_attn(x, past[0], past[1], keep)
            x = blk.mlp(x)
            presents.append(torch.stack([k, v]))
        logits = _ln(x, self.lnf_g, self.lnf_b) @ self.head.t()
        return (logits, *presents)

    def head_dim(self):
        return self.wte.shape[1] // self.heads


def gpt_step_graph(m: TinyGpt, batch=2) -> P.GraphProto:
    """``m`` exported as the decoder subgraph (batch-polymorphic, as real
    exports are: BeamSearch runs it at batch·beams rows)."""
    ex = _export_module()
    hd, L = m.head_dim(), m.layers_n
    ids = torch.zeros((batch, 1), dtype=torch.int32)
    pos = torch.full((batch, 1), 5, dtype=torch.int32)
    mask = torch.ones((batch, 6), dtype=torch.int32)
    pasts = [torch.zeros(2, batch, m.heads, 5, hd) for _ in range(L)]
    past_names = [f"past_{i}" for i in range(L)]
    dyn = {"input_ids": {0: "batch", 1: "seq"}, "position_ids": {0: "batch", 1: "seq"},
           "attention_mask": {0: "batch", 1: "total"}}
    dyn.update({n: {1: "batch", 3: "past"} for n in past_names})
    data = ex.export_onnx_bytes(
        m, (ids, pos, mask, *pasts), opset_version=17,
        input_names=["input_ids", "position_ids", "attention_mask"] + past_names,
        output_names=["logits"] + [f"present_{i}" for i in range(L)], dynamic_axes=dyn)
    return P.decode_model(data).graph


class EncDec(torch.nn.Module):
    """A whisper-style (``kind="whisper"``: log-mel features [B, mels,
    frames] through two convs, the second of stride 2) or T5-style
    (``kind="t5"``: token ids with an encoder_attention_mask) encoder and a
    decoder with self- and cross-attention. ``init(...)`` is
    convert_generation.py's encoder_decoder_init (logits, present self and
    cross caches); ``step(...)`` the with-past decoder."""

    def __init__(self, kind="whisper", vocab=100, d=32, enc_layers=2, dec_layers=2,
                 heads=2, mels=8, n_pos=64, enc_pos=32, seed=0):
        super().__init__()
        p = _Params(seed)
        self.kind, self.heads, self.dec_n = kind, heads, dec_layers
        if kind == "whisper":
            self.c1_w, self.c1_b = p(d, mels, 3, scale=0.3), p(d)
            self.c2_w, self.c2_b = p(d, d, 3, scale=0.3 / math.sqrt(d)), p(d)
        else:
            self.enc_emb = p(vocab, d, scale=0.5)
        self.enc_pos = p(enc_pos, d, scale=0.1)
        ws = 0.5 / math.sqrt(d)
        self.enc_blocks = torch.nn.ModuleList(
            [_Block(p, d, heads, wscale=ws) for _ in range(enc_layers)])
        self.enc_ln_g, self.enc_ln_b = p.ones(d), p.zeros(d)
        self.tok, self.pos = p(vocab, d, scale=0.5), p(n_pos, d, scale=0.1)
        self.dec_blocks = torch.nn.ModuleList(
            [_Block(p, d, heads, cross=True, wscale=ws) for _ in range(dec_layers)])
        self.dec_ln_g, self.dec_ln_b = p.ones(d), p.zeros(d)

    def encode(self, src, src_mask=None):
        if self.kind == "whisper":
            f = torch.nn.functional
            h = f.gelu(f.conv1d(src, self.c1_w, self.c1_b, padding=1))
            h = f.gelu(f.conv1d(h, self.c2_w, self.c2_b, stride=2, padding=1)).transpose(1, 2)
        else:
            h = self.enc_emb[src.long()]
        h = h + self.enc_pos[: h.shape[1]]
        te = h.shape[1]
        keep = (torch.ones((1, 1, 1, te), dtype=torch.bool) if src_mask is None
                else (src_mask[:, None, None, :] != 0))
        for blk in self.enc_blocks:
            b, h0 = h.shape[0], h
            empty = h.new_zeros((b, self.heads, 0, h.shape[-1] // self.heads))
            h, _, _ = blk.self_attn(h0, empty, empty, keep)
            h = blk.mlp(h)
        return _ln(h, self.enc_ln_g, self.enc_ln_b)

    def decode(self, ids, self_pasts, cross, cross_keep):
        start = self_pasts[0][0].shape[2]
        s = ids.shape[1]
        x = self.tok[ids.long()] + self.pos[start:start + s]
        keep = (torch.arange(start + s)[None, :] <= (torch.arange(s)[:, None] + start))
        presents = []
        for blk, (pk, pv), (ck, cv) in zip(self.dec_blocks, self_pasts, cross):
            x, k, v = blk.self_attn(x, pk, pv, keep)
            x = blk.cross_attn(x, ck, cv, cross_keep)
            x = blk.mlp(x)
            presents += [k, v]
        return _ln(x, self.dec_ln_g, self.dec_ln_b) @ self.tok.t(), presents

    def head_dim(self):
        return self.tok.shape[1] // self.heads


class _EncDecInit(torch.nn.Module):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, src, *rest):
        src_mask, dec_ids = (rest if len(rest) == 2 else (None, rest[0]))
        enc = self.m.encode(src, src_mask)
        b, hd = dec_ids.shape[0], self.m.head_dim()
        empty = enc.new_zeros((b, self.m.heads, 0, hd))
        cross = [blk.cross_kv(enc) for blk in self.m.dec_blocks]
        keep = (torch.ones((1, 1, 1, enc.shape[1]), dtype=torch.bool) if src_mask is None
                else src_mask[:, None, None, :] != 0)
        logits, presents = self.m.decode(dec_ids, [(empty, empty)] * self.m.dec_n, cross,
                                         keep)
        return (logits, *presents, *[t for kv in cross for t in kv])


class _EncDecStep(torch.nn.Module):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, ids, *rest):
        n = self.m.dec_n
        if self.m.kind == "t5":
            src_mask, rest = rest[0], rest[1:]
            keep = src_mask[:, None, None, :] != 0
        else:
            keep = torch.ones((1, 1, 1, 1), dtype=torch.bool)
        selfs = [(rest[2 * i], rest[2 * i + 1]) for i in range(n)]
        cross = [(rest[2 * n + 2 * i], rest[2 * n + 2 * i + 1]) for i in range(n)]
        logits, presents = self.m.decode(ids, selfs, cross, keep)
        return (logits, *presents)


def encdec_graphs(m: EncDec, src, batch=1):
    """(encoder, decoder) subgraphs of ``m`` exported with the
    convert_generation.py names: ``present_{key,value}_{self,cross}_i`` out
    of the encoder, ``past_*`` into the decoder (``src`` shapes the
    encoder's example input)."""
    ex = _export_module()
    n, hd, h = m.dec_n, m.head_dim(), m.heads
    self_names = [f"present_{c}_self_{i}" for i in range(n) for c in ("key", "value")]
    cross_names = [f"present_{c}_cross_{i}" for i in range(n) for c in ("key", "value")]
    dec_ids = torch.ones((batch, 2), dtype=torch.int32)
    src = torch.as_tensor(src)
    if m.kind == "t5":
        src_mask = torch.ones(src.shape, dtype=torch.int32)
        enc_args = (src, src_mask, dec_ids)
        enc_in = ["encoder_input_ids", "encoder_attention_mask", "decoder_input_ids"]
        enc_dyn = {"encoder_input_ids": {0: "batch", 1: "enc"},
                   "encoder_attention_mask": {0: "batch", 1: "enc"}}
    else:
        enc_args = (src, dec_ids)
        enc_in = ["encoder_input_features", "decoder_input_ids"]
        enc_dyn = {"encoder_input_features": {0: "batch"}}
    enc_dyn["decoder_input_ids"] = {0: "batch", 1: "seq"}
    enc = P.decode_model(ex.export_onnx_bytes(
        _EncDecInit(m), enc_args, opset_version=17, input_names=enc_in,
        output_names=["logits"] + self_names + cross_names, dynamic_axes=enc_dyn)).graph
    with torch.no_grad():
        te = m.encode(src, enc_args[1] if m.kind == "t5" else None).shape[1]
    sk = [torch.zeros(batch, h, 2, hd) for _ in range(2 * n)]
    ck = [torch.zeros(batch, h, te, hd) for _ in range(2 * n)]
    past_self = [s.replace("present", "past") for s in self_names]
    past_cross = [s.replace("present", "past") for s in cross_names]
    dec_in = ["input_ids"] + (["encoder_attention_mask"] if m.kind == "t5" else [])
    dec_in += past_self + past_cross
    dec_args = (torch.zeros((batch, 1), dtype=torch.int32),)
    dec_dyn = {"input_ids": {0: "batch"}}
    if m.kind == "t5":
        dec_args += (torch.ones((batch, te), dtype=torch.int32),)
        dec_dyn["encoder_attention_mask"] = {0: "batch", 1: "enc"}
    dec_dyn.update({s: {0: "batch", 2: "past"} for s in past_self})
    dec_dyn.update({s: {0: "batch", 2: "enc"} for s in past_cross})
    dec = P.decode_model(ex.export_onnx_bytes(
        _EncDecStep(m), dec_args + tuple(sk) + tuple(ck), opset_version=17,
        input_names=dec_in, output_names=["logits"] + self_names,
        dynamic_axes=dec_dyn)).graph
    return enc, dec


_GEN_INPUTS = ("input_ids", "max_length", "min_length", "num_beams",
               "num_return_sequences", "length_penalty", "repetition_penalty")


def generation_model(op, subgraphs, values, *, eos, pad, outputs=("sequences",),
                     extra_inputs=(), **attrs) -> bytes:
    """A GreedySearch / Sampling / BeamSearch / WhisperBeamSearch node over
    ``subgraphs`` (its graph attributes), reading the graph inputs
    ``values`` (name -> array) at their convert_generation.py positions.
    Returns the model's bytes and the values in the graph's input order."""
    if op in ("GreedySearch", "Sampling"):
        order = ["input_ids", "max_length", "min_length", "repetition_penalty",
                 "vocab_mask", "prefix_vocab_mask", "attention_mask", "presence_mask",
                 "seed"]
    else:
        order = list(_GEN_INPUTS) + ["vocab_mask", "prefix_vocab_mask", "attention_mask",
                                     "decoder_input_ids", "logits_processor"]
    order += list(extra_inputs)
    ins = [n if n in values else "" for n in order]
    while ins and not ins[-1]:
        ins.pop()
    node = P.make_node(op, ins, list(outputs), domain=MS, eos_token_id=eos,
                       pad_token_id=pad, **subgraphs, **attrs)
    vis = [_vi(n, values[n]) for n in order if n in values]
    graph = P.GraphProto(name=op.lower(), node=[node], input=vis,
                         output=[P.make_value_info(o, I32 if o == "sequences" else F32, [])
                                 for o in outputs])
    m = P.ModelProto(ir_version=8, producer_name="convert_generation", graph=graph,
                     opset_import=[P.OperatorSetId(domain="", version=17),
                                   P.OperatorSetId(domain=MS, version=1)])
    return P.encode_model(m), OrderedDict((n, values[n]) for n in order if n in values)


def gen_values(prompt, max_len, **extra) -> "OrderedDict[str, np.ndarray]":
    vals = OrderedDict(input_ids=np.asarray(prompt, np.int32),
                       max_length=np.array([max_len], np.int32),
                       min_length=np.array([extra.pop("min_len", 1)], np.int32))
    for k, v in extra.items():
        vals[k] = np.asarray(v)
    return vals


@functools.lru_cache(maxsize=None)
def tiny_gpt_graph(seed=0, vocab=50):
    return gpt_step_graph(TinyGpt(vocab=vocab, seed=seed))


@functools.lru_cache(maxsize=None)
def tiny_encdec(kind="whisper", seed=0, vocab=100, batch=1):
    """A small EncDec, its example source (``batch`` log-mel windows of 8
    bins x 50 frames, or 7 token ids) and its exported subgraphs."""
    m = EncDec(kind=kind, vocab=vocab, seed=seed)
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((batch, 8, 50)).astype(np.float32) * 0.5
           if kind == "whisper" else rng.integers(2, vocab, (batch, 7)).astype(np.int32))
    return m, src, encdec_graphs(m, src[:1])


GPT_BEAM_EOS = 6  # several beams of the BeamSearch case absorb it
WHISPER_VOCAB, NO_TIMESTAMPS = 150, 108


def _gpt_gen_case(op, **attrs):
    r = np.random.default_rng(40)
    prompt = r.integers(0, 50, (2, 4))
    if op == "BeamSearch":
        vals = gen_values(prompt, 12, num_beams=np.array([4], np.int32),
                          num_return_sequences=np.array([3], np.int32),
                          length_penalty=np.array([0.0], np.float32),
                          repetition_penalty=np.array([1.2], np.float32))
        return generation_model(op, {"decoder": tiny_gpt_graph()}, vals, eos=GPT_BEAM_EOS,
                                pad=49, outputs=("sequences", "sequences_scores"),
                                model_type=0, early_stopping=1, **attrs)
    vals = gen_values(prompt, 10, repetition_penalty=np.array([1.2], np.float32))
    return generation_model(op, {"decoder": tiny_gpt_graph()}, vals, eos=7, pad=49, **attrs)


@_case(CASES, "GreedySearch")
def _greedy():
    return _gpt_gen_case("GreedySearch")


@_case(CASES, "Sampling")
def _sampling():
    return _gpt_gen_case("Sampling", temperature=0.8, top_p=1e-6, seed=5)


@_case(CASES, "BeamSearch")
def _beam():
    return _gpt_gen_case("BeamSearch")


@_case(CASES, "WhisperBeamSearch")
def _whisper_beam():
    """Two recordings, with the whisper timestamp rules (logits_processor=1)."""
    _, src, (enc, dec) = tiny_encdec("whisper", vocab=WHISPER_VOCAB, batch=2)
    vals = gen_values([[1, 5], [1, 5]], 10, num_beams=np.array([3], np.int32),
                      num_return_sequences=np.array([2], np.int32),
                      length_penalty=np.array([0.0], np.float32),
                      repetition_penalty=np.array([1.0], np.float32))
    vals["decoder_input_ids"] = vals["input_ids"]
    vals["input_ids"] = src
    vals["logits_processor"] = np.array([1], np.int32)
    return generation_model("WhisperBeamSearch", {"encoder": enc, "decoder": dec}, vals,
                            eos=2, pad=0, outputs=("sequences", "sequences_scores"),
                            model_type=2, no_timestamps_token_id=NO_TIMESTAMPS,
                            max_initial_timestamp_index=5)


assert len(CASES) == 44, sorted(CASES)


# ---------------------------------------------------------------------------
# the same ops at the shapes the card meets
# ---------------------------------------------------------------------------

BERT = dict(b=8, s=384, hidden=768, heads=12)


@_case(BIG, "FusedConv")
def _big_fused_conv():
    # v2.4's first MBConv expand at batch 32 (a 1x1 Conv with its epilogue
    # would be a pointwise conv; this is the 3x3 stem-like stage)
    return _fused_conv(shape=(32, 32, 48, 256), cout=32, seed=100)


@_case(BIG, "QLinearAdd")
def _big_qlinear_add():
    return _qlinear_add(shape=(32, 48, 24, 128))


@_case(BIG, "QLinearMul")
def _big_qlinear_mul():
    return _qlinear_mul(shape=(32, 48, 24, 128))


@_case(BIG, "QLinearSigmoid")
def _big_qlinear_sigmoid():
    return _qlinear_sigmoid(shape=(32, 96, 24, 128))


@_case(BIG, "QLinearGlobalAveragePool")
def _big_qlinear_gap():
    return _qlinear_global_average_pool(shape=(32, 12, 64, 96))


@_case(BIG, "Attention")
def _big_attention():
    b, s, hidden, heads = BERT["b"], BERT["s"], BERT["hidden"], BERT["heads"]
    r = np.random.default_rng(101)
    x, w, bias = _attention_inputs(r, b, s, hidden, heads)
    ins = OrderedDict(x=x, mask=np.array([s, s - 77] * (b // 2), np.int32))
    node = _ms("Attention", ["x", "w", "bias", "mask"], num_heads=heads)
    return model([node], ins, {"w": w, "bias": bias}), ins


@_case(BIG, "MultiHeadAttention")
def _big_mha():
    return _mha(b=BERT["b"], sq=BERT["s"], skv=BERT["s"], hidden=BERT["hidden"],
                heads=BERT["heads"], seed=102)


@_case(BIG, "SkipLayerNormalization")
def _big_skip_ln():
    return _skip_ln(shape=(BERT["b"], BERT["s"], BERT["hidden"]))


@_case(BIG, "EmbedLayerNormalization")
def _big_embed_ln():
    return _embed_ln(b=BERT["b"], s=BERT["s"], hidden=BERT["hidden"], vocab=30522, seed=103)


@_case(BIG, "FastGelu")
def _big_fast_gelu():
    return _fast_gelu(shape=(BERT["b"], BERT["s"], 4 * BERT["hidden"]))


@_case(BIG, "GroupQueryAttention_prefill")
def _big_gqa_prefill():
    return gqa_case(1, 1024, 0, 32, 8, 128, 104)


@_case(BIG, "GroupQueryAttention_decode")
def _big_gqa_decode():
    return gqa_case(1, 1, 1024, 32, 8, 128, 105)


@_case(BIG, "MatMulNBits_m16")
def _big_nbits_16():
    return nbits_case(16, 4096, 4096, 32, 106)


@_case(BIG, "MatMulNBits_m1024")
def _big_nbits_1024():
    return nbits_case(1024, 4096, 4096, 32, 107)


@_case(BIG, "MurmurHash3")
def _big_murmur():
    return _murmurhash3(n=1_000_000)


# ---------------------------------------------------------------------------
# the ORT offline optimizer's rewrite of a BirdNET file
# ---------------------------------------------------------------------------


def _consumers(graph):
    out = {}
    for node in graph.node:
        for i in node.input:
            if i:
                out.setdefault(i, []).append(node)
    return out


def _fold_bn(graph, inits):
    """BatchNormalization after a Conv it alone consumes, folded into the
    Conv's weight and bias."""
    cons = _consumers(graph)
    outputs = {o.name for o in graph.output}
    keep = []
    producer = {o: n for n in graph.node for o in n.output}
    drop = set()
    for node in graph.node:
        if node.op_type != "BatchNormalization":
            continue
        conv = producer.get(node.input[0])
        if (conv is None or conv.op_type != "Conv" or len(cons[conv.output[0]]) != 1
                or conv.output[0] in outputs or not all(i in inits for i in node.input[1:])):
            continue
        s, b, mean, var = (inits[i] for i in node.input[1:5])
        eps = float(node.attrs.get("epsilon", 1e-5))
        k = (s / np.sqrt(var + eps)).astype(np.float32)
        w = inits[conv.input[1]]
        cb = inits[conv.input[2]] if len(conv.input) > 2 and conv.input[2] else 0.0
        wn, bn = conv.input[1] + "_bnfold", conv.output[0] + "_bnfold_b"
        inits[wn] = (w * k.reshape(-1, *([1] * (w.ndim - 1)))).astype(np.float32)
        inits[bn] = ((cb - mean) * k + b).astype(np.float32)
        conv.input = [conv.input[0], wn, bn]
        conv.output = [node.output[0]]
        drop.add(id(node))
    for node in graph.node:
        if id(node) not in drop:
            keep.append(node)
    graph.node = keep


def _quick_gelu_rewrite(graph):
    """Each ``Mul(x, Sigmoid(x))`` as com.microsoft QuickGelu(alpha=1)."""
    producer = {o: n for n in graph.node for o in n.output}
    cons = _consumers(graph)
    out, drop = [], set()
    for node in graph.node:
        if node.op_type == "Mul" and len(node.input) == 2:
            for a, b in (node.input, node.input[::-1]):
                sig = producer.get(b)
                if sig is not None and sig.op_type == "Sigmoid" and sig.input[0] == a:
                    node = _ms("QuickGelu", [a], list(node.output), alpha=1.0)
                    node.name = f"quickgelu_{node.output[0]}"
                    if len(cons[b]) == 1:
                        drop.add(id(sig))
                    break
        out.append(node)
    graph.node = [n for n in out if id(n) not in drop]


def _fused_conv_rewrite(graph):
    """Each Conv whose only consumer is a Sigmoid as FusedConv(activation=
    "Sigmoid")."""
    cons = _consumers(graph)
    outputs = {o.name for o in graph.output}
    out, drop = [], set()
    for node in graph.node:
        if node.op_type == "Conv" and node.output[0] not in outputs:
            users = cons.get(node.output[0], [])
            if len(users) == 1 and users[0].op_type == "Sigmoid":
                sig = users[0]
                fused = P.NodeProto(op_type="FusedConv", name=f"fusedconv_{sig.output[0]}",
                                    domain=MS, input=list(node.input),
                                    output=list(sig.output),
                                    attribute=list(node.attribute)
                                    + [P.make_attr("activation", "Sigmoid")])
                out.append(fused)
                drop.add(id(sig))
                continue
        out.append(node)
    graph.node = [n for n in out if id(n) not in drop]


def ort_optimized(data: bytes) -> bytes:
    """``data`` (a model's bytes) as onnxruntime's offline optimizer writes
    it: BatchNormalization folded into Conv, then QuickGelu, then
    FusedConv(Sigmoid); the com.microsoft opset imported."""
    m = P.decode_model(data)
    g = m.graph
    inits = {t.name: t.to_numpy() for t in g.initializer}
    _fold_bn(g, inits)
    _quick_gelu_rewrite(g)
    _fused_conv_rewrite(g)
    used = {i for n in g.node for i in n.input}
    g.initializer = [P.TensorProto.from_numpy(np.asarray(v), name=k)
                     for k, v in inits.items() if k in used]
    if not any(o.domain == MS for o in m.opset_import):
        m.opset_import = list(m.opset_import) + [P.OperatorSetId(domain=MS, version=1)]
    m.producer_name = "onnxruntime"
    return P.encode_model(m)


def op_histogram(data: bytes) -> dict:
    out = {}
    for n in P.decode_model(data).graph.node:
        key = f"{n.domain}.{n.op_type}" if n.domain else n.op_type
        out[key] = out.get(key, 0) + 1
    return out
