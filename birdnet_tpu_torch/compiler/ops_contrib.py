"""ONNX Runtime contrib-op lowerings (the ``com.microsoft`` domain).

The counterpart of :mod:`birdnet_tpu.compiler.ops_contrib`, section by
section and name by name, registered into the (domain, name) table of
``ops.py`` (imported from its tail). Files saved by onnxruntime's offline
optimizer (``optimized_model_filepath``, ``ORT_ENABLE_ALL``) carry these
nodes: FusedConv, QuickGelu, FusedMatMul, the QLinear* family, Attention,
SkipLayerNormalization; ``convert_generation.py`` exports carry the
generation ops (GreedySearch, Sampling, BeamSearch, WhisperBeamSearch).

Design notes, beside those of ``ops.py``:

- **Precision.** Every product goes through the shared policy helpers
  (``_mxu_operands``, ``_acc_product``, ``_out_cast``), so ``mixed`` and
  ``fast`` round where the JAX lowering rounds. Attention scores are
  float32 sums under every policy (the JAX lowering's
  ``preferred_element_type=float32``), then the mask as
  ``mask_filter_value``, softmax and the product with V, in that order;
  no fused attention kernel changes the rounding.
- **Host values.** ``max_length``, ``num_beams``, ``num_return_sequences``,
  ``min_length``, ``length_penalty``, the Sampling seed and MatMulNBits'
  ``g_idx`` are read on the host; a tensor on the card there raises "must
  be a compile-time constant", as a tracer does in the JAX lowering.
- **Generation loops** keep the JAX lowering's fixed ``max_length`` KV
  buffers and its scatter of the appended present row, and run one
  decoder subgraph per step in a Python loop. The early stop ("every
  sequence finished", the JAX ``lax.while_loop`` condition) is read on
  the host once per step and counted in ``HOST_READS`` under the op's
  name, so a batch context refuses to capture such a graph and the stream
  runs it through an eager key. Beam reordering, the whisper timestamp
  rules and every other step of the loop stay on the device.
- **BeamSearch's length penalty** divides by the hypothesis' full length,
  prompt included, as onnxruntime's ``BeamHypotheses::Add`` and
  ``IsDone`` do: a hypothesis that ends in EOS counts the tokens before
  the EOS, one cut at ``max_length`` counts ``max_length``, and the
  early-stop bound divides the best running score by the current length.
  The JAX lowering divides by the generated length; the two agree at
  ``length_penalty = 0``.
- **Sampling's random bits** are torch's: the Gumbel noise of step ``t``
  is drawn on the host by a CPU ``torch.Generator`` keyed by
  ``(seed, t)`` (the JAX lowering keys ``fold_in(PRNGKey(seed), t)``) and
  uploaded, so the card draws the host's tokens bit for bit. The sampled
  sequences differ from the JAX package's; with ``top_p -> 0`` both equal
  GreedySearch.
- **MurmurHash3** hashes 4-byte elements on the device in int64
  arithmetic masked to 32 bits (the uint32 bits, without a uint32 kernel);
  8-byte and string inputs hash on the host in numpy.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.nn.functional as F

from ..onnx.proto import DataType, Int4Tensor
from ..ops.cuda.build import count_launch
from .ops import (
    _BF16_OPERAND_POLICIES,
    _REGISTRY,
    HOST_READS,
    _acc_product,
    _attr_str,
    _axis,
    _f32_sum_matmul,
    _int_matmul_acc,
    _is_host,
    _on_device,
    _out_cast,
    _requantize,
    _run_subgraph,
    _static_array,
    _static_int,
    _static_ints,
    _tensor,
    contrib_op,
)
from .ops_extended import _draw, _host_value

_MS = "com.microsoft"


def ms_op(*names):
    return contrib_op(_MS, *names)


def _f32_product(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the policy's operands and float32 sums under every
    policy (the JAX lowering's ``preferred_element_type=jnp.float32``)."""
    if (ctx.precision in _BF16_OPERAND_POLICIES and a.is_floating_point()
            and b.is_floating_point()):
        return _f32_sum_matmul(a, b)
    return torch.matmul(a, b).float()


def _t(ctx, x, like=None) -> torch.Tensor:
    """``x`` as a tensor on ``like``'s device (default: the forward's)."""
    return _tensor(ctx, x, like.device if like is not None else None)


def _static_float(x, what: str) -> float:
    return float(_static_array(x, what).reshape(-1)[0])


# ---------------------------------------------------------------------------
# fused activation epilogues (FusedConv / FusedGemm)
# ---------------------------------------------------------------------------


def _fused_activation(ctx, y):
    """Apply the ORT fusion epilogue named by the ``activation`` attribute.

    FusedConv packs its parameters into ``activation_params`` (floats, in
    op-specific order) while FusedGemm uses ``activation_alpha``/
    ``activation_beta``/``activation_gamma``; both are honored."""
    act = _attr_str(ctx, "activation", "")
    if not act:
        return y
    params = [float(p) for p in ctx.attr("activation_params", [])]

    def p(i, default, named):
        if i < len(params):
            return params[i]
        v = ctx.attr(named)
        return default if v is None else float(v)

    if act == "Relu":
        return torch.clamp_min(y, 0.0)
    if act == "Sigmoid":
        return torch.sigmoid(y)
    if act == "Tanh":
        return torch.tanh(y)
    if act == "LeakyRelu":
        alpha = p(0, 0.01, "activation_alpha")
        return torch.where(y >= 0, y, alpha * y)
    if act == "Clip":
        lo = p(0, float(np.finfo(np.float32).min), "activation_alpha")
        hi = p(1, float(np.finfo(np.float32).max), "activation_beta")
        return torch.clamp(y, lo, hi)
    if act == "HardSigmoid":
        alpha = p(0, 0.2, "activation_alpha")
        beta = p(1, 0.5, "activation_beta")
        return torch.clamp(alpha * y + beta, 0.0, 1.0)
    raise NotImplementedError(
        f"{ctx.op_type}: fused activation '{act}' is not supported"
    )


@ms_op("FusedConv")
def _fused_conv(ctx, x, w, b=None, z=None):
    """Conv + optional residual add (Z) + fused activation epilogue."""
    y = _REGISTRY["Conv"](ctx, x, w, b)[0]
    if z is not None:
        y = y + _t(ctx, z, y).to(y.dtype)
    return [_fused_activation(ctx, y).to(y.dtype)]


@ms_op("FusedGemm")
def _fused_gemm(ctx, a, b, c=None):
    y = _REGISTRY["Gemm"](ctx, a, b, c)[0]
    return [_fused_activation(ctx, y).to(y.dtype)]


@ms_op("FusedMatMul", "TransposeMatMul")
def _fused_matmul(ctx, a, b):
    """MatMul with pre-folded transposes and a scalar alpha. ``transA``/
    ``transB`` swap the last two axes; batch-axis transposes raise."""
    if int(ctx.attr("transBatchA", 0)) or int(ctx.attr("transBatchB", 0)):
        raise NotImplementedError("FusedMatMul: transBatchA/transBatchB")
    a = _t(ctx, a)
    b = _t(ctx, b, a)
    if int(ctx.attr("transA", 0)):
        a = a.transpose(-1, -2)
    if int(ctx.attr("transB", 0)):
        b = b.transpose(-1, -2)
    y = _out_cast(ctx, _acc_product(ctx, a, b), a.dtype)
    alpha = float(ctx.attr("alpha", 1.0))
    if alpha != 1.0:
        y = (alpha * y).to(y.dtype)
    return [y]


# ---------------------------------------------------------------------------
# Gelu family
# ---------------------------------------------------------------------------


@ms_op("FastGelu")
def _fast_gelu(ctx, x, bias=None):
    x = _t(ctx, x)
    if bias is not None:
        x = x + _t(ctx, bias, x).to(x.dtype)
    return [F.gelu(x, approximate="tanh").to(x.dtype)]


@ms_op("BiasGelu")
def _bias_gelu(ctx, x, bias):
    x = _t(ctx, x)
    x = x + _t(ctx, bias, x).to(x.dtype)
    return [F.gelu(x).to(x.dtype)]


@ms_op("QuickGelu")
def _quick_gelu(ctx, x):
    x = _t(ctx, x)
    alpha = float(ctx.attr("alpha", 1.702))
    return [(x * torch.sigmoid(alpha * x)).to(x.dtype)]


@ms_op("GemmFastGelu")
def _gemm_fast_gelu(ctx, x, w, bias=None):
    x = _t(ctx, x)
    w = _t(ctx, w, x)
    y = _out_cast(ctx, _acc_product(ctx, x, w), x.dtype)
    if bias is not None:
        y = y + _t(ctx, bias, y).to(y.dtype)
    return [F.gelu(y, approximate="tanh").to(y.dtype)]


# ---------------------------------------------------------------------------
# bias + skip fusions
# ---------------------------------------------------------------------------


@ms_op("BiasAdd")
def _bias_add(ctx, x, bias, skip):
    x = _t(ctx, x)
    return [x + _t(ctx, bias, x).to(x.dtype) + _t(ctx, skip, x).to(x.dtype)]


@ms_op("BiasSoftmax")
def _bias_softmax(ctx, x, bias):
    """softmax(x + bias) over ALL axes >= ``axis`` (default 1), the legacy
    coerce-to-2D Softmax. ``is_inner_broadcast=1``: the bias spans the
    leading axes and broadcasts along the inner ones."""
    x = _t(ctx, x)
    bias = _t(ctx, bias, x).to(x.dtype)
    axis = int(ctx.attr("axis", 1))
    if axis < 0:
        axis += x.ndim
    if int(ctx.attr("is_inner_broadcast", 0)):
        bias = bias.reshape(tuple(bias.shape) + (1,) * (x.ndim - bias.ndim))
    s = x + bias
    flat = s.reshape(tuple(s.shape[:axis]) + (-1,))
    return [torch.softmax(flat, dim=-1).reshape(s.shape)]


def _ln_stats(s, eps):
    mean = s.mean(dim=-1, keepdim=True)
    var = s.var(dim=-1, unbiased=False, keepdim=True)
    return mean, torch.rsqrt(var + eps)


def _skip_ln_sum(ctx, x, skip, bias):
    s = _t(ctx, x)
    s = s + _t(ctx, skip, s).to(s.dtype)
    if bias is not None:
        s = s + _t(ctx, bias, s).to(s.dtype)
    return s


@ms_op("SkipLayerNormalization")
def _skip_layer_norm(ctx, x, skip, gamma, beta=None, bias=None):
    """LayerNorm(input + skip + bias) over the last axis. Optional outputs
    (positional): mean, inv_std_var, and the pre-norm sum at index 3."""
    eps = float(ctx.attr("epsilon", 1e-5))
    s = _skip_ln_sum(ctx, x, skip, bias)
    sf = s.float()
    mean, inv = _ln_stats(sf, eps)
    y = ((sf - mean) * inv).to(s.dtype) * _t(ctx, gamma, s).to(s.dtype)
    if beta is not None:
        y = y + _t(ctx, beta, s).to(s.dtype)
    outs = [y]
    if ctx.num_outputs > 1:
        outs.append(mean)
    if ctx.num_outputs > 2:
        outs.append(inv)
    if ctx.num_outputs > 3:
        outs.append(s)
    return outs


@ms_op("SkipSimplifiedLayerNormalization")
def _skip_simplified_layer_norm(ctx, x, skip, gamma, bias=None):
    """RMS-norm variant: (input + skip + bias) * rsqrt(mean(sum²)+eps) * gamma."""
    eps = float(ctx.attr("epsilon", 1e-5))
    s = _skip_ln_sum(ctx, x, skip, bias)
    sf = s.float()
    inv = torch.rsqrt((sf * sf).mean(dim=-1, keepdim=True) + eps)
    y = (sf * inv).to(s.dtype) * _t(ctx, gamma, s).to(s.dtype)
    outs = [y]
    if ctx.num_outputs > 1:
        outs.append(torch.zeros_like(inv))  # "mean" slot: unused by the RMS form
    if ctx.num_outputs > 2:
        outs.append(inv)
    if ctx.num_outputs > 3:
        outs.append(s)
    return outs


# ---------------------------------------------------------------------------
# NHWC conv (ORT layout-transformer output)
# ---------------------------------------------------------------------------


@ms_op("NhwcConv")
def _nhwc_conv(ctx, x, w, b=None):
    """Conv with channels-last input [N,H,W,C] and weight [M, kH, kW, C/g],
    lowered by transposing around the core Conv."""
    x = _t(ctx, x)
    w = _t(ctx, w, x)
    y = _REGISTRY["Conv"](ctx, x.movedim(-1, 1), w.movedim(-1, 1), b)[0]
    return [y.movedim(1, -1)]


# ---------------------------------------------------------------------------
# QLinear* elementwise/pool family (int8 end-to-end graphs)
# ---------------------------------------------------------------------------


def _dq(ctx, x, scale, zp, like=None):
    xf = _t(ctx, x, like).float()
    if zp is not None:
        xf = xf - _t(ctx, zp, xf).float()
    return xf * _t(ctx, scale, xf).float()


def _np_dtype_of(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(0, dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


def _default_zp(y_zp, like):
    """ORT contrib QLinear* default when the output zero point is omitted:
    zp = 0 with the output dtype following the INPUT dtype (``_requantize``
    would otherwise default to uint8, flipping int8 graphs' signedness)."""
    if y_zp is not None:
        return y_zp
    return np.zeros((), dtype=_np_dtype_of(like))


@ms_op("QLinearAdd")
def _qlinear_add(ctx, a, a_s, a_zp, b, b_s, b_zp, c_s, c_zp=None):
    af = _dq(ctx, a, a_s, a_zp)
    return [_requantize(ctx, af + _dq(ctx, b, b_s, b_zp, af), c_s,
                        _default_zp(c_zp, a))]


@ms_op("QLinearMul")
def _qlinear_mul(ctx, a, a_s, a_zp, b, b_s, b_zp, c_s, c_zp=None):
    af = _dq(ctx, a, a_s, a_zp)
    return [_requantize(ctx, af * _dq(ctx, b, b_s, b_zp, af), c_s,
                        _default_zp(c_zp, a))]


@ms_op("QLinearSigmoid")
def _qlinear_sigmoid(ctx, x, x_s, x_zp, y_s, y_zp=None):
    return [_requantize(ctx, torch.sigmoid(_dq(ctx, x, x_s, x_zp)), y_s,
                        _default_zp(y_zp, x))]


@ms_op("QLinearLeakyRelu")
def _qlinear_leaky_relu(ctx, x, x_s, x_zp, y_s, y_zp=None):
    alpha = float(ctx.attr("alpha", 0.01))
    xf = _dq(ctx, x, x_s, x_zp)
    return [_requantize(ctx, torch.where(xf >= 0, xf, alpha * xf), y_s,
                        _default_zp(y_zp, x))]


def _maybe_channels_last(ctx, xf):
    if int(ctx.attr("channels_last", 0)):
        return xf.movedim(-1, 1), True
    return xf, False


@ms_op("QLinearAveragePool")
def _qlinear_average_pool(ctx, x, x_s, x_zp, y_s, y_zp=None):
    xf, was_cl = _maybe_channels_last(ctx, _dq(ctx, x, x_s, x_zp))
    y = _REGISTRY["AveragePool"](ctx, xf)[0]
    if was_cl:
        y = y.movedim(1, -1)
    return [_requantize(ctx, y, y_s, _default_zp(y_zp, x))]


@ms_op("QLinearGlobalAveragePool")
def _qlinear_global_average_pool(ctx, x, x_s, x_zp, y_s, y_zp=None):
    xf, was_cl = _maybe_channels_last(ctx, _dq(ctx, x, x_s, x_zp))
    y = xf.mean(dim=tuple(range(2, xf.ndim)), keepdim=True)
    if was_cl:
        y = y.movedim(1, -1)
    return [_requantize(ctx, y, y_s, _default_zp(y_zp, x))]


@ms_op("QLinearConcat")
def _qlinear_concat(ctx, y_s, y_zp, *parts):
    if len(parts) % 3:
        raise NotImplementedError(
            "QLinearConcat expects (tensor, scale, zero_point) triples"
        )
    axis = int(ctx.attr("axis"))
    xs = [_dq(ctx, parts[i], parts[i + 1], parts[i + 2])
          for i in range(0, len(parts), 3)]
    return [_requantize(ctx, torch.cat(xs, dim=axis), y_s, y_zp)]


@ms_op("MatMulIntegerToFloat")
def _matmul_integer_to_float(ctx, a, b, a_s, b_s, a_zp=None, b_zp=None,
                             bias=None):
    a = _t(ctx, a)
    acc = _int_matmul_acc(a, _t(ctx, b, a), a_zp, b_zp)
    a_scale = _t(ctx, a_s, a).float()
    if a_scale.ndim == 1 and a_scale.shape[0] > 1:
        a_scale = a_scale[:, None]  # per-ROW a scale: broadcast along rows
    b_scale = _t(ctx, b_s, a).float()  # 1-D: along the output's columns
    y = acc.float() * (a_scale * b_scale)
    if bias is not None:
        y = y + _t(ctx, bias, y).float()
    return [y]


@ms_op("DynamicQuantizeMatMul")
def _dynamic_quantize_matmul(ctx, a, b, b_s, b_zp=None, bias=None):
    a_q, a_s, a_zp = _REGISTRY["DynamicQuantizeLinear"](ctx, a)
    acc = _int_matmul_acc(a_q, _t(ctx, b, a_q), a_zp, b_zp)
    scale = _t(ctx, a_s, a_q).float() * _t(ctx, b_s, a_q).float()
    y = acc.float() * scale
    if bias is not None:
        y = y + _t(ctx, bias, y).float()
    return [y]


# ---------------------------------------------------------------------------
# Attention (com.microsoft): packed-QKV self-attention, not the opset-23
# core Attention (whose signature differs)
# ---------------------------------------------------------------------------


def _key_keep(m: torch.Tensor, t_len: int) -> torch.Tensor:
    """The [B, 1, 1, T] keep mask of a [B] length or [B, T] key mask."""
    if m.ndim == 1:
        ar = torch.arange(t_len, device=m.device)
        return (ar[None, :] < m[:, None])[:, None, None, :]
    return (m[:, -t_len:] != 0)[:, None, None, :]


def _causal_keep(s_len: int, t_len: int, past_len: int, window: int, device):
    """Query row i at global position past_len + i sees keys j <= that
    position (and, with a window, only the last ``window`` of them)."""
    g_pos = past_len + np.arange(s_len)[:, None]
    keep = np.arange(t_len)[None, :] <= g_pos
    if window and window > 0:
        keep &= np.arange(t_len)[None, :] > g_pos - window
    return _on_device(keep[None, None], device)


def _filled(logits, keep, value):
    """``logits`` where ``keep``, else ``logits + value`` (the ORT
    ``mask_filter_value`` convention)."""
    return torch.where(keep, logits, logits + value)


@ms_op("Attention")
def _ms_attention(ctx, x, weights, bias=None, mask_index=None, past=None,
                  attention_bias=None, past_sequence_length=None):
    """Self-attention over input [B,S,H_in] with packed QKV projection
    weights [H_in, q+k+v] (``qkv_hidden_sizes`` when unequal; no output
    projection). Mask forms: [B] right-padding lengths over the TOTAL
    (past + current) key sequence, [B,T] raw key masks, [B,S,T] per-query
    masks and [B,1,M,M] per-query masks sliced to the live rows/cols;
    masked logits get ``mask_filter_value`` added. The packed 1-D
    (2B,)/(3B+2,) forms raise. ``past`` is the stacked [2,B,heads,Sp,head]
    cache; output 1 is ``present``. ``past_present_share_buffer`` and
    ``do_rotary`` raise, as in the JAX lowering."""
    if past_sequence_length is not None or int(
        ctx.attr("past_present_share_buffer", 0)
    ):
        raise NotImplementedError(
            "com.microsoft.Attention: past_present_share_buffer"
        )
    if int(ctx.attr("do_rotary", 0)):
        raise NotImplementedError("com.microsoft.Attention: do_rotary")
    num_heads = int(ctx.attr("num_heads"))
    unidirectional = int(ctx.attr("unidirectional", 0))
    mask_filter = float(ctx.attr("mask_filter_value", -10000.0))

    x = _t(ctx, x)
    dev = x.device
    weights = _t(ctx, weights, x)
    b_sz, s_len, _ = x.shape
    sizes = ctx.attr("qkv_hidden_sizes")
    if sizes is not None:
        q_h, k_h, v_h = (int(v) for v in sizes)
    else:
        q_h = k_h = v_h = weights.shape[1] // 3

    orig = x.dtype
    qkv = _out_cast(ctx, _acc_product(ctx, x, weights), orig)
    if bias is not None:
        qkv = qkv + _t(ctx, bias, qkv).to(qkv.dtype)
    q = qkv[..., :q_h]
    k = qkv[..., q_h:q_h + k_h]
    v = qkv[..., q_h + k_h:]

    def heads(t, h_dim):
        return t.reshape(b_sz, s_len, num_heads, h_dim // num_heads).permute(0, 2, 1, 3)

    q, k, v = heads(q, q_h), heads(k, k_h), heads(v, v_h)
    past_len = 0
    if past is not None:
        p = _t(ctx, past, x)
        if p.ndim != 5 or p.shape[0] != 2:
            raise NotImplementedError(
                "com.microsoft.Attention: past must be [2,B,heads,S_past,head]"
            )
        past_len = p.shape[3]
        k = torch.cat([p[0].to(k.dtype), k], dim=2)
        v = torch.cat([p[1].to(v.dtype), v], dim=2)
    present = (k, v)
    t_len = k.shape[2]
    scale = ctx.attr("scale")
    scale = float(scale) if scale is not None else 1.0 / np.sqrt(k.shape[-1])
    logits = _f32_product(ctx, q, k.transpose(-1, -2)) * scale

    if mask_index is not None:
        m = _t(ctx, mask_index, x)
        if m.ndim == 1:
            if m.shape[0] != b_sz:
                raise NotImplementedError(
                    "com.microsoft.Attention: packed 1-D (2B,)/(3B+2,) "
                    "begin/end mask forms"
                )
            keep = _key_keep(m, t_len)
        elif m.ndim == 2:  # [B,T] raw key mask
            keep = _key_keep(m, t_len)
        elif m.ndim == 3:  # [B,S,T] per-query mask
            keep = (m[:, :, -t_len:] != 0)[:, None, :, :]
        elif m.ndim == 4:  # [B,1,M,M] per-query mask over max_seq
            keep = m[:, :, past_len:past_len + s_len, :t_len] != 0
        else:
            raise NotImplementedError(
                f"com.microsoft.Attention: mask_index rank {m.ndim}"
            )
        logits = _filled(logits, keep, mask_filter)
    if attention_bias is not None:
        logits = logits + _t(ctx, attention_bias, x).to(logits.dtype)
    if unidirectional:
        logits = _filled(logits, _causal_keep(s_len, t_len, past_len, 0, dev),
                         mask_filter)

    probs = torch.softmax(logits, dim=-1)
    y = _out_cast(ctx, _acc_product(ctx, probs.to(orig), v), orig)
    outs = [y.permute(0, 2, 1, 3).reshape(b_sz, s_len, v_h)]
    if ctx.num_outputs > 1:
        outs.append(torch.stack(present, dim=0))
    return outs


# ---------------------------------------------------------------------------
# Transformer contrib family beyond packed-QKV Attention: BERT embeddings,
# MultiHeadAttention, GroupQueryAttention, RotaryEmbedding, and the
# stable-diffusion UNet set (GroupNorm / SkipGroupNorm / BiasSplitGelu).
# ---------------------------------------------------------------------------


@ms_op("EmbedLayerNormalization")
def _embed_layer_norm(ctx, input_ids, segment_ids=None, word_emb=None,
                      position_emb=None, segment_emb=None, gamma=None,
                      beta=None, mask=None, position_ids=None):
    """BERT embedding fusion: word + position (+ segment) lookups,
    LayerNorm(gamma, beta), and the mask length reduction. Positions
    default to 0..S-1 per row (broadcast [1,S] accepted); segment ids
    default to zeros; output 1 (``mask_index``, int32 [B]) is the per-row
    count of nonzero mask entries, zeros without a mask; optional output 2
    is the pre-norm sum."""
    eps = float(ctx.attr("epsilon", 1e-12))
    word = _t(ctx, word_emb)
    dev = word.device
    ids = _t(ctx, input_ids, word).long()
    b_sz, s_len = ids.shape
    emb = word[ids]
    if position_ids is not None:
        pos = _t(ctx, position_ids, word).long().expand(b_sz, s_len)
    else:
        pos = torch.arange(s_len, device=dev)[None].expand(b_sz, s_len)
    emb = emb + _t(ctx, position_emb, word)[pos]
    if segment_emb is not None:
        seg = (_t(ctx, segment_ids, word).long() if segment_ids is not None
               else torch.zeros((b_sz, s_len), dtype=torch.long, device=dev))
        emb = emb + _t(ctx, segment_emb, word)[seg]
    ef = emb.float()
    mean, inv = _ln_stats(ef, eps)
    y = ((ef - mean) * inv).to(emb.dtype)
    y = y * _t(ctx, gamma, word).to(emb.dtype)
    if beta is not None:
        y = y + _t(ctx, beta, word).to(emb.dtype)
    if mask is not None:
        mask_index = (_t(ctx, mask, word) != 0).to(torch.int32).sum(dim=1, dtype=torch.int32)
    else:
        mask_index = torch.zeros((b_sz,), dtype=torch.int32, device=dev)
    outs = [y, mask_index]
    if ctx.num_outputs > 2:
        outs.append(emb)
    return outs


def _mha_core(ctx, q, k, v, *, past_key=None, past_value=None,
              key_padding_mask=None, attention_bias=None, scale=None,
              unidirectional=0, mask_filter=-10000.0, softcap=0.0,
              local_window=0, key_lengths=None):
    """Shared scaled-dot-product core over head-split [B,N,S,h] operands:
    KV-cache concat, GQA head repetition, [B]-length / [B,T]-mask key
    padding (``mask_filter`` added), additive ``attention_bias``, causal
    masking at global positions, a sliding window and softcap. With
    ``key_lengths`` (GQA's seqlens protocol: tokens left-aligned, masked
    logits -inf). Returns (y [B,N,S,h_v], present_k, present_v)."""
    past_len = 0
    if past_key is not None:
        pk = _t(ctx, past_key, q)
        past_len = pk.shape[2]
        k = torch.cat([pk.to(k.dtype), k], dim=2)
        v = torch.cat([_t(ctx, past_value, q).to(v.dtype), v], dim=2)
    present_k, present_v = k, v
    n_q, n_kv = q.shape[1], k.shape[1]
    if n_q != n_kv:
        if n_q % n_kv:
            raise ValueError(
                f"{ctx.op_type}: q heads ({n_q}) must be a multiple of "
                f"kv heads ({n_kv})"
            )
        rep = n_q // n_kv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s_len, t_len = q.shape[2], k.shape[2]
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])

    orig = q.dtype
    dev = q.device
    logits = _f32_product(ctx, q, k.transpose(-1, -2)) * scale

    if key_padding_mask is not None:
        m = _t(ctx, key_padding_mask, q)
        if m.ndim not in (1, 2):
            raise NotImplementedError(
                f"{ctx.op_type}: key_padding_mask rank {m.ndim}"
            )
        logits = _filled(logits, _key_keep(m, t_len), mask_filter)
    if attention_bias is not None:
        logits = logits + _t(ctx, attention_bias, q).to(logits.dtype)
    neg_inf = torch.full((), -np.inf, dtype=logits.dtype, device=dev)
    if key_lengths is not None:
        # Prompt (no past): token i sits at position i; valid keys are
        # j <= i and j < len_b. Continuation (past of static length Sp):
        # row b's valid past occupies slots 0..len_b-S-1, the current chunk
        # sits at slots Sp..Sp+S-1 at positions len_b-S+i.
        lens_b = key_lengths.to(torch.int64)[:, None, None, None]
        jj = torch.arange(t_len, device=dev)[None, None, None, :]
        ii = torch.arange(s_len, device=dev)[None, None, :, None]
        if past_len == 0:
            keep = (jj <= ii) & (jj < lens_b)
            q_pos, k_pos = ii, jj
        else:
            valid_past = jj < torch.clamp_min(lens_b - s_len, 0)
            current = (jj >= past_len) & ((jj - past_len) <= ii)
            keep = valid_past | current
            q_pos = lens_b - s_len + ii
            k_pos = torch.where(jj >= past_len, lens_b - s_len + (jj - past_len), jj)
        if local_window and local_window > 0:
            keep = keep & (k_pos > q_pos - local_window)
        logits = torch.where(keep, logits, neg_inf)
    elif unidirectional:
        logits = torch.where(
            _causal_keep(s_len, t_len, past_len, local_window, dev), logits, neg_inf)
    if softcap and softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)

    probs = torch.softmax(logits, dim=-1)
    y = _out_cast(ctx, _acc_product(ctx, probs.to(orig), v), orig)
    return y, present_k, present_v


def _merge_heads(y):
    b, h, s, d = y.shape
    return y.permute(0, 2, 1, 3).reshape(b, s, h * d)


@ms_op("MultiHeadAttention")
def _multi_head_attention(ctx, query, key=None, value=None, bias=None,
                          key_padding_mask=None, attention_bias=None,
                          past_key=None, past_value=None):
    """Attention over already-projected Q/K/V. Input forms: separate 3-D
    Q/K/V; K/V pre-split 4-D [B,N,Skv,h]; packed QKV [B,S,N,3,h]; packed
    KV [B,Skv,N,2,h]. ``bias`` [Hq+Hk+Hv] adds before the head split (3-D
    forms only). Masks follow Attention's conventions;
    ``past_key``/``past_value`` are [B,N,Sp,h] with presents at outputs
    1/2."""
    num_heads = int(ctx.attr("num_heads"))
    mask_filter = float(ctx.attr("mask_filter_value", -10000.0))
    unidirectional = int(ctx.attr("unidirectional", 0))
    scale = ctx.attr("scale")
    scale = float(scale) if scale is not None else None

    q = _t(ctx, query)

    def split_heads(t):
        b, s, h = t.shape
        return t.reshape(b, s, num_heads, h // num_heads).permute(0, 2, 1, 3)

    if q.ndim == 5:  # packed QKV [B,S,N,3,h]
        if key is not None or value is not None or bias is not None:
            raise NotImplementedError(
                "com.microsoft.MultiHeadAttention: packed QKV with "
                "key/value/bias inputs"
            )
        qkv = q.permute(0, 2, 3, 1, 4)  # [B,N,3,S,h]
        q_, k_, v_ = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        kk = None if key is None else _t(ctx, key, q)
        if kk is not None and kk.ndim == 5:  # packed KV [B,Skv,N,2,h]
            if value is not None or bias is not None:
                raise NotImplementedError(
                    "com.microsoft.MultiHeadAttention: packed KV with "
                    "value/bias inputs"
                )
            kv = kk.permute(0, 2, 3, 1, 4)
            k_, v_ = kv[:, :, 0], kv[:, :, 1]
            q_ = split_heads(q)
        elif kk is not None and kk.ndim == 4:  # pre-split cross-attn K/V
            if bias is not None:
                raise NotImplementedError(
                    "com.microsoft.MultiHeadAttention: bias with 4-D "
                    "pre-split key/value"
                )
            k_, v_ = kk, _t(ctx, value, q)
            q_ = split_heads(q)
        else:
            vv = _t(ctx, value, q)
            if bias is not None:
                bb = _t(ctx, bias, q)
                qh, kh = q.shape[-1], kk.shape[-1]
                q = q + bb[:qh].to(q.dtype)
                kk = kk + bb[qh:qh + kh].to(kk.dtype)
                vv = vv + bb[qh + kh:].to(vv.dtype)
            q_, k_, v_ = split_heads(q), split_heads(kk), split_heads(vv)

    y, pres_k, pres_v = _mha_core(
        ctx, q_, k_, v_,
        past_key=past_key, past_value=past_value,
        key_padding_mask=key_padding_mask, attention_bias=attention_bias,
        scale=scale, unidirectional=unidirectional, mask_filter=mask_filter,
    )
    outs = [_merge_heads(y)]
    if ctx.num_outputs > 1:
        outs.append(pres_k)
    if ctx.num_outputs > 2:
        outs.append(pres_v)
    return outs


@ms_op("RotaryEmbedding")
def _ms_rotary_embedding(ctx, x, position_ids, cos_cache, sin_cache):
    """The opset-23 core RotaryEmbedding's math, plus the contrib-only
    position forms: ``position_ids`` [B,S], broadcastable [1,S], or a
    single-element offset meaning positions ``offset + arange(S)``."""
    if float(ctx.attr("scale", 1.0)) != 1.0:
        raise NotImplementedError(
            "com.microsoft.RotaryEmbedding: scale != 1.0"
        )
    if int(ctx.attr("is_packed_batching", 0)):
        raise NotImplementedError(
            "com.microsoft.RotaryEmbedding: is_packed_batching"
        )
    x = _t(ctx, x)
    b_sz = x.shape[0]
    s_len = x.shape[1] if x.ndim == 3 else x.shape[2]
    pos = _t(ctx, position_ids, x).long()
    if pos.numel() == 1:
        pos = pos.reshape(()) + torch.arange(s_len, device=x.device)
        pos = pos[None].expand(b_sz, s_len)
    else:
        pos = pos.expand(b_sz, s_len)
    return _REGISTRY["RotaryEmbedding"](ctx, x, cos_cache, sin_cache, pos)


def _gqa_rotary(ctx, t, pos, cos_cache, sin_cache, interleaved):
    """Apply rotary embedding to head-split [B,N,S,h] at positions [B,S]."""
    cos = _t(ctx, cos_cache, t)[pos][:, None].to(t.dtype)
    sin = _t(ctx, sin_cache, t)[pos][:, None].to(t.dtype)
    rd = 2 * cos.shape[-1]
    rot, tail = t[..., :rd], t[..., rd:]
    if interleaved:
        x1, x2 = rot[..., 0::2], rot[..., 1::2]
    else:
        x1, x2 = rot[..., : rd // 2], rot[..., rd // 2:]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    if interleaved:
        rot_out = torch.stack([r1, r2], dim=-1).reshape(rot.shape)
    else:
        rot_out = torch.cat([r1, r2], dim=-1)
    return torch.cat([rot_out, tail], dim=-1) if rd < t.shape[-1] else rot_out


@ms_op("GroupQueryAttention")
def _group_query_attention(ctx, query, key=None, value=None, past_key=None,
                           past_value=None, seqlens_k=None,
                           total_sequence_length=None, cos_cache=None,
                           sin_cache=None):
    """GroupQueryAttention (llama-family ORT exports), the JAX lowering's
    static-shape subset: query [B,S,N*h] with key/value [B,S,kvN*h] (or
    packed QKV), optional past_key/past_value [B,kvN,Sp,h] concatenated to
    presents of length Sp+S. ``seqlens_k`` [B] is "total valid length
    minus 1" per row and may be data on the card. Always causal;
    ``local_window_size``, ``softcap`` and ``do_rotary`` (interleaved or
    split-half) follow the kernel conventions. A host
    ``total_sequence_length`` is checked against past+current (the
    share-buffer protocol raises)."""
    num_heads = int(ctx.attr("num_heads"))
    kv_heads = int(ctx.attr("kv_num_heads"))
    scale = ctx.attr("scale")
    scale = float(scale) if scale is not None else None
    softcap = float(ctx.attr("softcap", 0.0))
    local_window = int(ctx.attr("local_window_size", -1))
    if int(ctx.attr("smooth_softmax", 0)):
        raise NotImplementedError(
            "com.microsoft.GroupQueryAttention: smooth_softmax"
        )

    q = _t(ctx, query)
    dev = q.device
    b_sz, s_len = q.shape[0], q.shape[1]
    if key is None:  # packed QKV: [B,S,(N+2*kvN)*h]
        head = q.shape[-1] // (num_heads + 2 * kv_heads)
        qh = num_heads * head
        kh = kv_heads * head
        key = q[..., qh:qh + kh]
        value = q[..., qh + kh:]
        q = q[..., :qh]
    k = _t(ctx, key, q)
    v = _t(ctx, value, q)

    def split(t, n):
        b, s, h = t.shape
        return t.reshape(b, s, n, h // n).permute(0, 2, 1, 3)

    q_, k_, v_ = split(q, num_heads), split(k, kv_heads), split(v, kv_heads)

    past_len = 0 if past_key is None else int(past_key.shape[2])
    if seqlens_k is not None:
        lens = _t(ctx, seqlens_k, q).to(torch.int64) + 1
    else:
        lens = torch.full((b_sz,), past_len + s_len, dtype=torch.int64, device=dev)
    if total_sequence_length is not None and (
        _is_host(total_sequence_length) or total_sequence_length.device.type == "cpu"
    ):
        tot = _static_int(total_sequence_length, "total_sequence_length")
        if tot != past_len + s_len:
            raise NotImplementedError(
                "com.microsoft.GroupQueryAttention: "
                f"total_sequence_length {tot} != past+current "
                f"{past_len + s_len} (past_present_share_buffer protocol)"
            )

    if int(ctx.attr("do_rotary", 0)):
        interleaved = int(ctx.attr("rotary_interleaved", 0))
        ar = torch.arange(s_len, device=dev)[None]
        if past_len == 0:
            pos = ar.expand(b_sz, s_len)
        else:
            pos = torch.clamp_min(lens[:, None] - s_len + ar, 0)
        q_ = _gqa_rotary(ctx, q_, pos, cos_cache, sin_cache, interleaved)
        k_ = _gqa_rotary(ctx, k_, pos, cos_cache, sin_cache, interleaved)

    y, pres_k, pres_v = _mha_core(
        ctx, q_, k_, v_,
        past_key=past_key, past_value=past_value,
        scale=scale, unidirectional=1,
        softcap=softcap, local_window=local_window,
        key_lengths=lens,
    )
    outs = [_merge_heads(y)]
    if ctx.num_outputs > 1:
        outs.append(pres_k)
    if ctx.num_outputs > 2:
        outs.append(pres_v)
    return outs


def _group_norm_core(ctx, x_cl, gamma, beta, *, groups, eps, swish):
    """GroupNorm over channels-last [B, ..., C] input; gamma/beta [C]."""
    c = x_cl.shape[-1]
    if c % groups:
        raise ValueError(
            f"{ctx.op_type}: channels {c} not divisible by groups {groups}"
        )
    b = x_cl.shape[0]
    g = x_cl.reshape(b, -1, groups, c // groups).float()
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = g.var(dim=(1, 3), unbiased=False, keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(x_cl.shape)
    y = y * _t(ctx, gamma, x_cl).float()
    y = y + _t(ctx, beta, x_cl).float()
    if swish:
        y = y * torch.sigmoid(y)
    return y.to(x_cl.dtype)


@ms_op("GroupNorm")
def _ms_group_norm(ctx, x, gamma, beta):
    """GroupNorm of stable-diffusion UNet exports: [B,H,W,C] when
    ``channels_last=1`` (the default) else [B,C,H,W]; ``activation=1``
    fuses swish. Statistics per (batch, group) in float32."""
    groups = int(ctx.attr("groups"))
    eps = float(ctx.attr("epsilon", 1e-5))
    swish = int(ctx.attr("activation", 0))
    x = _t(ctx, x)
    if int(ctx.attr("channels_last", 1)):
        return [_group_norm_core(ctx, x, gamma, beta, groups=groups,
                                 eps=eps, swish=swish)]
    y = _group_norm_core(ctx, x.movedim(1, -1), gamma, beta, groups=groups,
                         eps=eps, swish=swish)
    return [y.movedim(-1, 1)]


@ms_op("SkipGroupNorm")
def _skip_group_norm(ctx, x, gamma, beta, skip, bias=None):
    """GroupNorm(x + skip + bias) over channels-last [B,H,W,C] input;
    ``skip`` broadcasts from [B,H,W,C], [B,1,1,C] or [B,C]. Optional
    output 1 is the pre-norm sum."""
    x = _t(ctx, x)
    sk = _t(ctx, skip, x)
    if sk.ndim == 2:
        sk = sk[:, None, None, :]
    s = x + sk.to(x.dtype)
    if bias is not None:
        s = s + _t(ctx, bias, x).to(x.dtype)
    y = _group_norm_core(
        ctx, s, gamma, beta,
        groups=int(ctx.attr("groups")),
        eps=float(ctx.attr("epsilon", 1e-5)),
        swish=int(ctx.attr("activation", 0)),
    )
    outs = [y]
    if ctx.num_outputs > 1:
        outs.append(s)
    return outs


@ms_op("BiasSplitGelu")
def _bias_split_gelu(ctx, x, bias):
    """Add bias, split the last axis in half, ``first * Gelu(second)``
    (exact erf Gelu). The output has half the input's last-axis width."""
    x = _t(ctx, x)
    s = x + _t(ctx, bias, x).to(x.dtype)
    a, g = torch.chunk(s, 2, dim=-1)
    gf = g.float()
    gelu = 0.5 * gf * (1.0 + torch.erf(gf / np.sqrt(2.0)))
    return [a * gelu.to(s.dtype)]


# ---------------------------------------------------------------------------
# Block-quantized weight ops: MatMulNBits (4/8-bit weight-only
# projections), GatherBlockQuantized (quantized embedding tables)
# ---------------------------------------------------------------------------


def _unpack_nibbles(b: torch.Tensor, *, signed=False) -> torch.Tensor:
    """Unpack uint8 bytes into 4-bit values along the last axis, low
    nibble first (element i in the low nibble of byte i//2 when i is
    even)."""
    b = b.to(torch.uint8)
    lo = (b & 0xF).to(torch.int32)
    hi = (b >> 4).to(torch.int32)
    q = torch.stack([lo, hi], dim=-1).reshape(tuple(b.shape[:-1]) + (-1,))
    if signed:  # two's-complement nibbles
        q = torch.where(q >= 8, q - 16, q)
    return q


@ms_op("MatMulNBits")
def _matmul_nbits(ctx, a, b, scales, zero_points=None, g_idx=None,
                  bias=None):
    """``A @ W.T`` with W [N,K] block-quantized at ``bits`` (4 or 8).

    B is uint8 [N, n_blocks, blob] (nibbles low-first along K); scales
    [N, n_blocks] (flat accepted); zero points packed uint8 nibbles (each
    column padded to a byte), uint8 at 8 bits, or float (``w = (q - zp) *
    scale``); absent: 2^(bits-1). ``g_idx`` [K] (a host value) maps each
    element to its block. ``accuracy_level`` is ignored: the product runs
    under the precision policy."""
    k_dim = int(ctx.attr("K"))
    n_dim = int(ctx.attr("N"))
    bits = int(ctx.attr("bits", 4))
    bs = int(ctx.attr("block_size"))
    if bits not in (4, 8):
        raise NotImplementedError(f"MatMulNBits: bits={bits}")
    n_blocks = (k_dim + bs - 1) // bs

    a = _t(ctx, a)
    b = _t(ctx, b, a)
    if bits == 4:
        q = _unpack_nibbles(b.reshape(n_dim, n_blocks, -1))
    else:
        q = b.reshape(n_dim, n_blocks, -1).to(torch.int32)
    q = q.reshape(n_dim, -1)[:, :k_dim]  # [N, K]

    sc = _t(ctx, scales, a).reshape(n_dim, n_blocks).float()
    if zero_points is None:
        zp = torch.full((n_dim, n_blocks), float(1 << (bits - 1)),
                        dtype=torch.float32, device=a.device)
    else:
        zpt = _t(ctx, zero_points, a)
        if zpt.dtype == torch.uint8 and bits == 4:
            per_col = (n_blocks + 1) // 2
            zp = _unpack_nibbles(zpt.reshape(n_dim, per_col))[:, :n_blocks].float()
        else:
            zp = zpt.reshape(n_dim, n_blocks).float()

    if g_idx is not None:
        gi = np.asarray(_static_ints(g_idx, "MatMulNBits g_idx"), np.int64)
    else:
        gi = np.minimum(np.arange(k_dim) // bs, n_blocks - 1)
    gi = _on_device(gi, a.device)
    w = (q.float() - zp.index_select(1, gi)) * sc.index_select(1, gi)  # [N, K]

    orig = a.dtype
    y = _out_cast(ctx, _acc_product(ctx, a, w.to(orig).t()), orig)
    if bias is not None:
        y = y + _t(ctx, bias, y).to(y.dtype)
    return [y]


def _int_codes(ctx, x, device):
    """A quantized table as codes on ``device``, whether its type is signed
    and whether it packs 4-bit pairs (uint8). The codec's 4-bit tensors
    (``Int4Tensor``: int4 / uint4 values in their 8-bit container) widen to
    int32 codes, unpacked."""
    if isinstance(x, Int4Tensor):
        codes = _on_device(x, device).to(torch.int32)
        return codes, x.data_type == DataType.INT4, False
    if _is_host(x):
        x = _on_device(np.asarray(x), device)
    signed = x.dtype == torch.int8
    return x, signed, x.dtype == torch.uint8


@ms_op("GatherBlockQuantized")
def _gather_block_quantized(ctx, data, indices, scales, zero_points=None):
    """Gather rows of a block-quantized table, dequantized with per-block
    scales along ``quantize_axis``. ``data`` is int4/uint4 or uint8 (packed
    4-bit pairs along the quantize axis, low nibble first); ``zero_points``
    match the scales (absent: 0 signed, 8 unsigned). The gather runs first,
    so only the selected rows dequantize."""
    gather_axis = int(ctx.attr("gather_axis", 0))
    quant_axis = int(ctx.attr("quantize_axis", 1))
    bs = int(ctx.attr("block_size", 128))

    sc = _t(ctx, scales).float()
    dev = sc.device
    d, signed, packed = _int_codes(ctx, data, dev)
    if packed:  # packed 4-bit pairs along quant_axis
        q = _unpack_nibbles(d.movedim(quant_axis, -1)).movedim(-1, quant_axis)
        default_zp = 8.0
    else:
        q = d.to(torch.int32)
        default_zp = 0.0 if signed else 8.0

    if zero_points is None:
        zp = torch.full(sc.shape, default_zp, dtype=torch.float32, device=dev)
    else:
        zpt, _, zp_packed = _int_codes(ctx, zero_points, dev)
        if zp_packed and packed:
            zpt = _unpack_nibbles(zpt.movedim(quant_axis, -1)).movedim(-1, quant_axis)
            zp = zpt[tuple(slice(0, s) for s in sc.shape)].float()
        else:
            zp = zpt.float()

    if gather_axis == quant_axis:
        raise NotImplementedError(
            "GatherBlockQuantized: gather_axis == quantize_axis"
        )
    idx = _t(ctx, indices, sc).long()

    def take(t):
        return t.index_select(gather_axis, idx.reshape(-1)).reshape(
            tuple(t.shape[:gather_axis]) + tuple(idx.shape)
            + tuple(t.shape[gather_axis + 1:]))

    q_g, sc_g, zp_g = take(q), take(sc), take(zp)
    qa = quant_axis + (idx.ndim - 1 if quant_axis > gather_axis else 0)
    k = q_g.shape[qa]
    blk = _on_device(np.minimum(np.arange(k) // bs, sc_g.shape[qa] - 1), dev)
    y = (q_g.float() - zp_g.index_select(qa, blk)) * sc_g.index_select(qa, blk)
    return [y]


# ---------------------------------------------------------------------------
# quantized transformer/classical ops: QGemm / QAttention / QLinearSoftmax,
# plus Inverse and MurmurHash3
# ---------------------------------------------------------------------------


def _dq_weight(ctx, w, w_s, w_zp, per_col_axis, like=None):
    """Dequantize a weight whose scale/zero-point may be scalar or
    per-output-column (1-D along ``per_col_axis``)."""
    wf = _t(ctx, w, like).float()

    def orient(v):
        if v.ndim == 1 and v.shape[0] > 1:
            shape = [1] * wf.ndim
            shape[per_col_axis] = v.shape[0]
            return v.reshape(shape)
        return v

    if w_zp is not None:
        wf = wf - orient(_t(ctx, w_zp, wf).float())
    return wf * orient(_t(ctx, w_s, wf).float())


@ms_op("QGemm")
def _qgemm(ctx, a, a_s, a_zp, b, b_s, b_zp, c=None, y_s=None, y_zp=None):
    """Gemm over quantized A/B. The optional int32 bias C carries the
    implicit scale ``alpha * a_scale * b_scale`` (per-column b_scale
    broadcasts over the output columns); with ``y_scale`` the output
    requantizes to y_zero_point's dtype, else it stays float32."""
    alpha = float(ctx.attr("alpha", 1.0))
    trans_a = int(ctx.attr("transA", 0))
    trans_b = int(ctx.attr("transB", 0))
    af = _dq(ctx, a, a_s, a_zp)
    bf = _dq_weight(ctx, b, b_s, b_zp, 0 if trans_b else 1, af)
    if trans_a:
        af = af.transpose(-1, -2)
    if trans_b:
        bf = bf.transpose(-1, -2)
    y = alpha * _f32_product(ctx, af, bf)
    if c is not None:
        c_scale = alpha * _t(ctx, a_s, y).float() * _t(ctx, b_s, y).float()
        y = y + _t(ctx, c, y).float() * c_scale
    if y_s is None:
        return [y]
    return [_requantize(ctx, y, y_s, _default_zp(y_zp, a))]


@ms_op("QAttention")
def _qattention(ctx, x, w, bias, x_s, w_s, mask_index=None, x_zp=None,
                w_zp=None, past=None):
    """Quantized BERT self-attention: dequantize the int8 input and packed
    QKV weight and run the float contrib Attention (same attributes)."""
    xf = _dq(ctx, x, x_s, x_zp)
    wf = _dq_weight(ctx, w, w_s, w_zp, 1, xf)
    return _ms_attention(ctx, xf, wf, bias, mask_index, past)


@ms_op("QLinearSoftmax")
def _qlinear_softmax(ctx, x, x_s, x_zp, y_s, y_zp=None):
    """Dequantize → softmax → requantize; the ``opset`` attribute selects
    per-axis softmax (>= 13) or the legacy coerce-to-2D form."""
    axis = int(ctx.attr("axis", -1))
    opset = int(ctx.attr("opset", 13))
    xf = _dq(ctx, x, x_s, x_zp)
    ax = axis + xf.ndim if axis < 0 else axis
    if opset >= 13:
        y = torch.softmax(xf, dim=ax)
    else:
        lead = int(np.prod(xf.shape[:ax], dtype=np.int64))
        y = torch.softmax(xf.reshape(lead, -1), dim=-1).reshape(xf.shape)
    return [_requantize(ctx, y, y_s, _default_zp(y_zp, x))]


@ms_op("Inverse")
def _ms_inverse(ctx, x):
    """Batched matrix inverse ([..., M, M]), in float32, cast back."""
    x = _t(ctx, x)
    return [torch.linalg.inv(x.float()).to(x.dtype)]


# -- MurmurHash3 -------------------------------------------------------------
# The hash's uint32 arithmetic in int64 values masked to 32 bits, written
# once for numpy int64 arrays (the host) and int64 tensors (the card). A
# 32-bit product splits the constant into 16-bit halves, so no
# intermediate leaves int64's range.

_M32 = 0xFFFFFFFF


def _mul32(h, c: int):
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _rotl32(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _M32


def _mm3_mix_k(k1):
    return _mul32(_rotl32(_mul32(k1, 0xCC9E2D51), 15), 0x1B873593)


def _mm3_fmix(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _mm3_blocks(blocks, n_bytes: int, seed: int):
    """MurmurHash3_x86_32 over 4-byte little-endian blocks (no tail:
    numeric element widths are multiples of 4)."""
    h = blocks[0] * 0 + seed
    for k1 in blocks:
        h = h ^ _mm3_mix_k(k1)
        h = (_mul32(_rotl32(h, 13), 5) + 0xE6546B64) & _M32
    return _mm3_fmix(h ^ n_bytes)


def _mm3_bytes(data: bytes, seed: int) -> int:
    """MurmurHash3_x86_32 of a byte string (host path for strings)."""
    n = len(data)
    n_blocks = n // 4
    blocks = [int.from_bytes(data[4 * i: 4 * i + 4], "little")
              for i in range(n_blocks)]
    h = seed
    for k1 in blocks:
        h ^= _mm3_mix_k(k1)
        h = (_mul32(_rotl32(h, 13), 5) + 0xE6546B64) & _M32
    tail = data[4 * n_blocks:]
    if tail:
        h ^= _mm3_mix_k(int.from_bytes(tail, "little"))
    return int(_mm3_fmix(h ^ n))


def _host_hash_out(h64: np.ndarray, positive: int, shape) -> np.ndarray:
    out = h64.astype(np.uint32)
    return (out if positive else out.view(np.int32)).reshape(shape)


@ms_op("MurmurHash3")
def _murmurhash3(ctx, x):
    """Per-element MurmurHash3_x86_32 over each element's little-endian
    bytes (strings: utf-8). ``seed`` attribute; ``positive=1`` (default)
    gives uint32, else int32 of the same bits. A tensor of 4-byte elements
    hashes where it lies (int64 arithmetic masked to 32 bits); host values,
    8-byte elements and strings hash on the host in numpy, and an 8-byte
    tensor on the card raises."""
    seed = int(ctx.attr("seed", 0)) & _M32
    positive = int(ctx.attr("positive", 1))

    if isinstance(x, (list, np.ndarray)) and np.asarray(x).dtype.kind in ("U", "S", "O"):
        arr = np.asarray(x)
        flat = [
            _mm3_bytes((s.decode() if isinstance(s, bytes) else str(s)).encode("utf-8"), seed)
            for s in arr.reshape(-1)
        ]
        return [_host_hash_out(np.asarray(flat, np.int64), positive, arr.shape)]

    itemsize = x.element_size() if isinstance(x, torch.Tensor) else np.asarray(x).dtype.itemsize
    if itemsize not in (4, 8):
        raise NotImplementedError(f"MurmurHash3: unsupported element width {itemsize}")
    if itemsize == 8 or _is_host(x):
        arr = np.ascontiguousarray(_host_value(
            x, "MurmurHash3's 8-byte input", "8-byte elements hash on the host"))
        words = arr.reshape(-1).view("<u4").astype(np.int64).reshape(arr.size, -1)
        out = _mm3_blocks([words[:, i] for i in range(words.shape[1])], itemsize, seed)
        return [_host_hash_out(out, positive, arr.shape)]
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _M32
    h = _mm3_blocks([bits], 4, seed)
    h = (h - ((h >> 31) << 32)).to(torch.int32)  # the same 32 bits as int32
    return [h.view(torch.uint32) if positive else h]


@ms_op("QLinearReduceMean")
def _qlinear_reduce_mean(ctx, x, x_s, x_zp, y_s, y_zp=None):
    """Dequantize → ReduceMean (axes/keepdims attributes) → requantize."""
    xf = _dq(ctx, x, x_s, x_zp)
    axes = ctx.attr("axes")
    keepdims = bool(int(ctx.attr("keepdims", 1)))
    if axes is None:
        y = xf.mean(dim=tuple(range(xf.ndim)), keepdim=keepdims)
    else:
        y = xf.mean(dim=tuple(int(a) for a in np.asarray(axes).reshape(-1)),
                    keepdim=keepdims)
    return [_requantize(ctx, y, y_s, _default_zp(y_zp, x))]


# ---------------------------------------------------------------------------
# In-graph generation: GreedySearch, Sampling, BeamSearch and
# WhisperBeamSearch, whose ``decoder`` (and ``encoder``/``init_decoder``)
# attributes hold the per-step subgraphs of a convert_generation.py export.
#
# The GPT branch keeps the JAX lowering's fixed max_length cache buffer:
# each step feeds the whole buffer as ``past`` (the garbage tail masked off
# by the subgraph's own attention_mask input) and scatters the present row
# the step appended at the buffer's end into its true slot. The JAX loop is
# one ``lax.while_loop``; here it is a Python loop of the same steps, whose
# condition reads the card once per step (``_keep_going``).
# ---------------------------------------------------------------------------


def _keep_going(ctx, flag: torch.Tensor) -> bool:
    """The loop's data-dependent condition, read on the host: one read per
    step, counted in ``HOST_READS`` under the op's name."""
    count_launch(HOST_READS, ctx.op_type)
    return bool(flag)


def _gen_subgraph_io(graph, what):
    """Split a decoder subgraph's formal inputs into (input_ids,
    position_ids, attention_mask) + past names, and its outputs into logits
    + present names (the convert_generation.py layout)."""
    in_names = [v.name for v in graph.input]
    out_names = [v.name for v in graph.output]
    if len(in_names) < 3 or len(out_names) < 1:
        raise ValueError(
            f"{what}: decoder subgraph needs >= 3 inputs "
            f"(input_ids, position_ids, attention_mask) and a logits "
            f"output; got {in_names} -> {out_names}"
        )
    n_layers = len(in_names) - 3
    if len(out_names) != 1 + n_layers:
        raise ValueError(
            f"{what}: expected one present per past "
            f"({n_layers}), got outputs {out_names}"
        )
    return in_names[:3], in_names[3:], out_names


def _gen_past_shape(graph, b_sz, what):
    """Static [2, B, heads, 0, head] prefill shape from the first past
    input's declared dims (the seq axis, index 3, may be symbolic)."""
    if len(graph.input) < 4:
        raise NotImplementedError(
            f"{what}: decoder subgraph declares no past inputs "
            "(a KV-cache-less decoder is not a generation step graph)"
        )
    dims = []
    vi = graph.input[3]
    for i, d in enumerate(vi.type.tensor_type.shape.dim):
        if i == 3:
            dims.append(0)
        elif d.dim_value:
            dims.append(int(d.dim_value))
        elif i == 1:
            dims.append(b_sz)
        else:
            raise NotImplementedError(
                f"{what}: past dim {i} of {vi.name!r} must be static "
                f"(or the batch/sequence axis)"
            )
    if len(dims) != 5 or dims[0] != 2:
        raise NotImplementedError(
            f"{what}: past must be the stacked [2,B,heads,seq,head] GPT "
            f"layout; {vi.name!r} declares rank {len(dims)}"
        )
    return tuple(dims)


def _unpadded(ctx, attention_mask, what):
    """Padded prompts raise; the mask must be a host value or CPU tensor
    (the JAX lowering raises on a traced mask)."""
    if attention_mask is None:
        return
    if isinstance(attention_mask, torch.Tensor) and attention_mask.device.type != "cpu":
        raise NotImplementedError(
            f"{what}: the attention_mask must be a compile-time constant "
            "(padded prompts are not implemented)"
        )
    if not np.all(_static_array(attention_mask, what) != 0):
        raise NotImplementedError(
            f"{what}: padded prompts (attention_mask with zeros)"
        )


def _set_column(t: torch.Tensor, col: int, value) -> None:
    """``t[:, col] = value`` with ``.at[].set``'s index rules: a negative
    index counts from the end, one out of range drops the write."""
    n = t.shape[1]
    if -n <= col < n:
        t[:, col] = value


def _gen_process_logits(logits, *, seen, length, min_length, eos,
                        repetition_penalty, vocab_mask):
    """ORT's GPT logits processors: vocab mask, CTRL-style repetition
    penalty over every token already in the sequence, and EOS suppression
    while ``length`` (the length BEFORE the new token, HF's ``cur_len``)
    is under ``min_length`` (a host int)."""
    lf = logits.float()
    if vocab_mask is not None:
        lf = torch.where(vocab_mask[None, :], lf, -np.inf)
    if repetition_penalty is not None:
        p = repetition_penalty
        lf = torch.where(seen, torch.where(lf > 0, lf / p, lf * p), lf)
    if min_length is not None and length < min_length:
        lf = lf.clone() if lf is logits else lf
        _set_column(lf, eos, -np.inf)
    return lf


def _gen_common(ctx, what, min_length, repetition_penalty, vocab_mask, dev):
    """The processors' inputs on the device (and ``min_length`` as a host
    int)."""
    ml = None if min_length is None else _static_int(min_length, f"{what} min_length")
    rp = (None if repetition_penalty is None
          else _t(ctx, repetition_penalty).to(dev).reshape(()).float())
    vm = None if vocab_mask is None else _tensor(ctx, vocab_mask, dev).to(torch.bool)
    return ml, rp, vm


def _mark_seen(seen: torch.Tensor, tok: torch.Tensor) -> None:
    """Set ``seen`` at the tokens ``tok`` (one per row, or [rows, S])."""
    idx = tok.long()
    seen.scatter_(-1, idx if idx.ndim == seen.ndim else idx.unsqueeze(-1), True)


def _pad_to_buf(t, p_buf, rep=1):
    """A prefill present [2,B,h,s,d] as a float32 cache buffer of
    ``p_buf`` slots, its batch axis repeated ``rep`` times per row."""
    t = t.float()
    t = F.pad(t, (0, 0, 0, p_buf - t.shape[3]))
    return t.repeat_interleave(rep, dim=1) if rep > 1 else t


def _step_mask(rows, p_buf, t, dev):
    """Keys of step ``t``: the buffer slots below ``t - 1`` and the
    current token."""
    ar = torch.arange(p_buf + 1, device=dev)
    return ((ar < t - 1) | (ar == p_buf)).to(torch.int32)[None].expand(rows, p_buf + 1)


def _gpt_prefill(ctx, init_decoder, ids0, what):
    init_in, init_past, _ = _gen_subgraph_io(init_decoder, f"{what} init_decoder")
    b_sz, s0 = ids0.shape
    dev = ids0.device
    p_shape = _gen_past_shape(init_decoder, b_sz, what)
    env = {
        init_in[0]: ids0,
        init_in[1]: torch.arange(s0, dtype=torch.int32, device=dev)[None].expand(b_sz, s0),
        init_in[2]: torch.ones((b_sz, s0), dtype=torch.int32, device=dev),
    }
    for name in init_past:
        env[name] = torch.zeros(p_shape, dtype=torch.float32, device=dev)
    return _run_subgraph(ctx, init_decoder, env)


def _gpt_search_loop(ctx, input_ids, max_length, min_length,
                     repetition_penalty, vocab_mask, prefix_vocab_mask,
                     attention_mask, *, select):
    """Shared GPT decode loop for GreedySearch and Sampling: prefill, then
    one decoder step per token over the fixed buffer until every row has
    emitted EOS or ``max_length`` is reached. ``select(logits, t)`` picks
    each next token. Returns ``sequences`` [B, max_length] int32."""
    what = f"com.microsoft.{ctx.op_type}"
    if int(ctx.attr("model_type", 0)) != 0:
        raise NotImplementedError(
            f"{what}: only model_type=0 (GPT) is implemented — "
            "convert_generation.py exports encoder-decoder greedy "
            "decoding as BeamSearch with num_beams=1 (supported)"
        )
    if int(ctx.attr("no_repeat_ngram_size", 0)):
        raise NotImplementedError(f"{what}: no_repeat_ngram_size")
    if prefix_vocab_mask is not None:
        raise NotImplementedError(f"{what}: prefix_vocab_mask")
    eos = int(ctx.attr("eos_token_id"))
    pad = int(ctx.attr("pad_token_id"))
    decoder = ctx.attr("decoder")
    if decoder is None:
        raise ValueError(f"{what}: missing decoder graph")
    init_decoder = ctx.attr("init_decoder") or decoder

    ids0 = _t(ctx, input_ids).to(torch.int32)
    dev = ids0.device
    b_sz, s0 = ids0.shape
    max_len = _static_int(max_length, f"{what} max_length")
    _unpadded(ctx, attention_mask, what)
    ml, rp, vm = _gen_common(ctx, what, min_length, repetition_penalty, vocab_mask, dev)

    out_seq = torch.full((b_sz, max_len), pad, dtype=torch.int32, device=dev)
    if s0 >= max_len:  # nothing to generate: the prompt, truncated
        out_seq[:, :max_len] = ids0[:, :max_len]
        return out_seq
    out_seq[:, :s0] = ids0

    (in_ids_n, in_pos_n, in_mask_n), past_names, _ = _gen_subgraph_io(decoder, what)
    pre = _gpt_prefill(ctx, init_decoder, ids0, what)
    logits0 = _t(ctx, pre[0], ids0)
    vocab = logits0.shape[-1]
    p_buf = max_len  # cache slots; the valid prefix grows, the tail stays masked
    bufs = [_pad_to_buf(_t(ctx, p, ids0), p_buf) for p in pre[1:]]

    def process(logits, seen, length):
        return _gen_process_logits(logits, seen=seen, length=length,
                                   min_length=ml, eos=eos,
                                   repetition_penalty=rp, vocab_mask=vm)

    seen = torch.zeros((b_sz, vocab), dtype=torch.bool, device=dev)
    _mark_seen(seen, ids0)
    first = select(process(logits0[:, -1], seen, s0), s0)
    done = first == eos
    out_seq[:, s0] = first
    _mark_seen(seen, first)

    cur, t = first, s0 + 1
    pos = torch.empty((b_sz, 1), dtype=torch.int32, device=dev)
    while t < max_len and _keep_going(ctx, ~done.all()):
        pos.fill_(t - 1)
        env = {in_ids_n: cur[:, None], in_pos_n: pos,
               in_mask_n: _step_mask(b_sz, p_buf, t, dev)}
        env.update(zip(past_names, bufs))
        outs = _run_subgraph(ctx, decoder, env)
        nxt = select(process(_t(ctx, outs[0], ids0)[:, -1], seen, t), t)
        nxt = torch.where(done, torch.full_like(nxt, pad), nxt)
        done = done | (nxt == eos)
        out_seq[:, t] = nxt
        _mark_seen(seen, nxt)
        # the step appended cur's KV at buffer index p_buf: scatter it into
        # its true slot t-1
        for b, p in zip(bufs, outs[1:]):
            b[:, :, :, t - 1:t] = _t(ctx, p, ids0)[:, :, :, p_buf:p_buf + 1].to(b.dtype)
        cur, t = nxt, t + 1
    return out_seq


def _argmax_select(logits, _t):
    return torch.argmax(logits, dim=-1).to(torch.int32)


@ms_op("GreedySearch")
def _greedy_search(ctx, input_ids, max_length, min_length=None,
                   repetition_penalty=None, vocab_mask=None,
                   prefix_vocab_mask=None, attention_mask=None):
    """GreedySearch (GPT branch of convert_generation.py): ``sequences``
    [B, max_length] int32, the prompt then greedy continuations; rows stop
    at ``eos_token_id`` and pad with ``pad_token_id``. Processors:
    ``vocab_mask`` [V], ``repetition_penalty`` (CTRL form), ``min_length``.
    Scope: ``model_type=0`` with the stacked [2,B,heads,seq,head] past
    layout; other model types, ``no_repeat_ngram_size``,
    ``prefix_vocab_mask`` and padded prompts raise typed errors."""
    return [_gpt_search_loop(
        ctx, input_ids, max_length, min_length, repetition_penalty,
        vocab_mask, prefix_vocab_mask, attention_mask,
        select=_argmax_select,
    )]


def _top_p_filter(logits, top_p, filter_value, min_keep):
    """HF's TopPLogitsWarper over [B, V] logits: keep the smallest prefix
    of the descending softmax whose cumulative probability exceeds
    ``top_p`` (at least ``min_keep`` tokens); the rest get
    ``filter_value``."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # a token is REMOVED when the cumulative probability up to and
    # including the previous token already exceeds top_p
    remove_sorted = (cum - probs) > top_p
    remove_sorted[:, :min_keep] = False
    kth = (~remove_sorted).sum(dim=-1) - 1  # last kept rank
    threshold = torch.gather(sorted_logits, -1, kth[:, None])
    return torch.where(logits >= threshold, logits, filter_value)


def sampling_key(seed: int, t: int) -> int:
    """The host generator's seed for step ``t`` of a Sampling node."""
    return zlib.crc32(f"Sampling:{seed}:{t}".encode()) & 0x7FFFFFFF


@ms_op("Sampling")
def _sampling_search(ctx, input_ids, max_length, min_length=None,
                     repetition_penalty=None, vocab_mask=None,
                     prefix_vocab_mask=None, attention_mask=None,
                     presence_mask=None, seed_input=None):
    """Sampling (GPT branch of convert_generation.py): the GreedySearch
    loop with temperature and top-p sampling instead of argmax.
    ``temperature`` divides the processed logits; ``top_p`` < 1 filters
    to ``filter_value`` keeping ``min_tokens_to_keep``; ``presence_mask``
    [B,V] times ``presence_penalty`` subtracts from the scaled logits. The
    draw is Gumbel-max with noise from a CPU ``torch.Generator`` seeded
    with ``sampling_key(seed, t)``; ``custom=1`` raises."""
    if int(ctx.attr("custom", 0)):
        raise NotImplementedError("com.microsoft.Sampling: custom=1")
    presence_penalty = float(ctx.attr("presence_penalty", 0.0))
    temperature = float(ctx.attr("temperature", 1.0))
    top_p = float(ctx.attr("top_p", 1.0))
    filter_value = float(ctx.attr("filter_value", -np.inf))
    min_keep = int(ctx.attr("min_tokens_to_keep", 1))
    seed = (_static_int(seed_input, "Sampling seed")
            if seed_input is not None else int(ctx.attr("seed", 0)))

    def select(logits, t):
        scaled = logits / np.float32(max(temperature, 1e-6))
        if presence_mask is not None:
            scaled = scaled - (_t(ctx, presence_mask, logits).float() * presence_penalty)
        if top_p < 1.0:
            scaled = _top_p_filter(scaled, top_p, filter_value, min_keep)
        noise = _draw("gumbel", sampling_key(seed, t), tuple(scaled.shape), torch.float32)
        return torch.argmax(scaled + noise.to(scaled.device), dim=-1).to(torch.int32)

    return [_gpt_search_loop(
        ctx, input_ids, max_length, min_length, repetition_penalty,
        vocab_mask, prefix_vocab_mask, attention_mask, select=select,
    )]


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: descending, ties to the lower
    index (a stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _beam_gather(t, idx):
    """take_along_axis over the beam axis, trailing dims broadcast."""
    idx = idx.long()
    while idx.ndim < t.ndim:
        idx = idx[..., None]
    return torch.gather(t, 1, idx.expand(*idx.shape[:2], *t.shape[2:]))


def _beam_state_init(ids0, *, b_sz, n_beams, s0, max_len, pad, vocab):
    """The static-shape beam state: running sequences / scores (beam 0 at
    0, the rest -1e9), finished sequences / scores, finished flags, the
    early-stop gate and the per-beam seen-token mask."""
    dev = ids0.device
    running_seq = torch.full((b_sz, n_beams, max_len), pad, dtype=torch.int32, device=dev)
    running_seq[:, :, :s0] = ids0[:, None]
    running_scores = torch.zeros((b_sz, n_beams), dtype=torch.float32, device=dev)
    running_scores[:, 1:] = -1e9
    seq = torch.full((b_sz, n_beams, max_len), pad, dtype=torch.int32, device=dev)
    beam_scores = torch.full((b_sz, n_beams), -1e9, dtype=torch.float32, device=dev)
    finished = torch.zeros((b_sz, n_beams), dtype=torch.bool, device=dev)
    heuristic = torch.ones((b_sz, 1), dtype=torch.bool, device=dev)
    seen_b = torch.zeros((b_sz, vocab), dtype=torch.bool, device=dev)
    _mark_seen(seen_b, ids0)
    seen = seen_b[:, None].expand(b_sz, n_beams, vocab).clone()
    return (running_seq, running_scores, seq, beam_scores, finished,
            heuristic, seen)


def _make_beam_round(*, b_sz, n_beams, vocab, max_len, eos, early_stop,
                     lp_pen, min_length, repetition_penalty, vocab_mask,
                     extra_processor=None):
    """One beam-search step over (cur_len, last-token logits, state), the
    candidate/running/finished machinery of HF's static-shape generate
    with onnxruntime's lengths (module docstring). Returns (new_state,
    parent beam indices for the cache reordering, continue flag on the
    device)."""
    n_cand = 2 * n_beams

    def one_round(cur_len, logits, state):
        (running_seq, running_scores, seq, beam_scores, finished,
         heuristic, seen) = state
        dev = logits.device
        top_mask = torch.arange(n_cand, device=dev) < n_beams  # EOS from top ranks
        lp = torch.log_softmax(logits.float(), dim=-1)
        lp = _gen_process_logits(
            lp, seen=seen.reshape(b_sz * n_beams, vocab), length=cur_len,
            min_length=min_length, eos=eos,
            repetition_penalty=repetition_penalty, vocab_mask=vocab_mask,
        ).reshape(b_sz, n_beams, vocab)
        if extra_processor is not None:
            lp = extra_processor(lp, running_seq, cur_len)
        total = (lp + running_scores[:, :, None]).reshape(b_sz, -1)
        vals, idx = _top_k(total, n_cand)  # (B, 2K)
        parent = idx // vocab
        tok = (idx % vocab).to(torch.int32)
        cand_seq = _beam_gather(running_seq, parent)
        cand_seq[:, :, cur_len] = tok
        is_eos = tok == eos
        hits = is_eos | (cur_len + 1 >= max_len)

        # running beams for the next iteration
        run_vals = vals + hits.float() * -1e9
        _, idx2 = _top_k(run_vals, n_beams)
        new_running_seq = _beam_gather(cand_seq, idx2)
        new_running_scores = torch.gather(run_vals, 1, idx2)
        parent2 = torch.gather(parent, 1, idx2)  # (B, K)
        tok2 = torch.gather(tok, 1, idx2)
        new_seen = _beam_gather(seen, parent2)
        _mark_seen(new_seen, tok2)

        # finished-beam merge; an EOS hypothesis is as long as the tokens
        # before its EOS, one cut at max_length is max_length long
        did_finish = hits & top_mask[None, :]
        hyp_len = torch.where(is_eos, float(cur_len), float(cur_len + 1))
        fin_scores = vals / (hyp_len ** lp_pen)
        full_and_stop = finished.all(dim=-1, keepdim=True)
        if early_stop:
            fin_scores = fin_scores + full_and_stop.float() * -1e9
        fin_scores = fin_scores + (~heuristic).float() * -1e9
        fin_scores = fin_scores + (~did_finish).float() * -1e9
        merged_seq = torch.cat([seq, cand_seq], dim=1)
        merged_scores = torch.cat([beam_scores, fin_scores], dim=1)
        merged_fin = torch.cat([finished, did_finish], dim=1)
        _, idx3 = _top_k(merged_scores, n_beams)
        new_seq = _beam_gather(merged_seq, idx3)
        new_beam_scores = torch.gather(merged_scores, 1, idx3)
        new_finished = torch.gather(merged_fin, 1, idx3)

        # the early-stop bound (IsDone): the best running score over the
        # current length
        best_possible = new_running_scores[:, :1] / (float(cur_len) ** lp_pen)
        worst_finished = torch.where(
            new_finished, new_beam_scores.min(dim=1, keepdim=True).values,
            torch.full_like(new_beam_scores, -1e9))
        new_heuristic = heuristic & (best_possible > worst_finished).any(dim=-1, keepdim=True)
        cont = new_heuristic.any() & ~hits.all()
        if early_stop:
            cont = cont & ~new_finished.all()
        return (
            (new_running_seq, new_running_scores, new_seq, new_beam_scores,
             new_finished, new_heuristic, new_seen),
            parent2, cont,
        )

    return one_round


def _whisper_timestamp_rules(*, timestamp_begin, no_timestamps, eos,
                             begin_index, max_initial):
    """The whisper timestamp rules (ORT's TimestampLogitsProcessor, from
    openai-whisper / HF's WhisperTimeStampLogitsProcessor) over log-prob
    scores [B, K, V], on the device: suppress <|notimestamps|>; timestamps
    come in pairs; they never decrease; the first generated token is a
    timestamp within ``max_initial`` of the start; when the summed
    timestamp probability beats every text token, text is masked."""

    def apply(lp, running_seq, cur_len):
        b_sz, n_beams, vocab = lp.shape
        dev = lp.device
        s = lp.reshape(b_sz * n_beams, vocab).clone()
        seqs = running_seq.reshape(b_sz * n_beams, -1)
        t = int(cur_len)
        col = torch.arange(vocab, device=dev)[None]
        neg = torch.full((), -np.inf, dtype=s.dtype, device=dev)
        s[:, no_timestamps] = -np.inf
        n = t - begin_index
        if n >= 1:
            sampled = seqs[:, begin_index:t]
            is_ts = sampled >= timestamp_begin
            last_ts = is_ts[:, -1]
            pen_ts = is_ts[:, -2] if n >= 2 else torch.ones_like(last_ts)
            # after a lone timestamp only text or EOS; after a pair no
            # timestamp
            ban = torch.where(pen_ts[:, None], col >= timestamp_begin, col < eos)
            s = torch.where(last_ts[:, None] & ban, neg, s)
            # timestamps never decrease
            any_ts = is_ts.any(dim=1)
            pos = torch.arange(n, device=dev)[None]
            last_pos = torch.where(is_ts, pos, -1).max(dim=1).values.clamp_min(0)
            last_stamp = torch.gather(sampled, 1, last_pos[:, None])[:, 0].long()
            bound = torch.where(last_ts & ~pen_ts, last_stamp, last_stamp + 1)
            ban = (col >= timestamp_begin) & (col < bound[:, None]) & any_ts[:, None]
            s = torch.where(ban, neg, s)
        if t == begin_index:
            s[:, :timestamp_begin] = -np.inf
            if max_initial is not None:
                s[:, timestamp_begin + max_initial + 1:] = -np.inf
        # the probability rule on the masked scores
        logprobs = torch.log_softmax(s, dim=-1)
        ts_lp = torch.logsumexp(logprobs[:, timestamp_begin:], dim=-1)
        max_text = logprobs[:, :timestamp_begin].max(dim=-1).values
        s = torch.where((ts_lp > max_text)[:, None] & (col < timestamp_begin), neg, s)
        return s.reshape(b_sz, n_beams, vocab)

    return apply


def _beam_sizes(ctx, max_length, num_beams, num_return_sequences,
                length_penalty):
    """max_length, num_beams, num_return_sequences and length_penalty as
    host values."""
    what = ctx.op_type
    max_len = _static_int(max_length, f"{what} max_length")
    n_beams = _static_int(num_beams, f"{what} num_beams")
    n_return = (_static_int(num_return_sequences, f"{what} num_return_sequences")
                if num_return_sequences is not None else n_beams)
    if n_return > n_beams:
        raise ValueError(
            f"com.microsoft.{what}: num_return_sequences > num_beams"
        )
    lp_pen = (_static_float(length_penalty, f"{what} length_penalty")
              if length_penalty is not None else 1.0)
    return max_len, n_beams, n_return, lp_pen


def _prompt_only(ctx, ids, b_sz, n_return, max_len):
    out = ids[:, None, :max_len].expand(b_sz, n_return, min(max_len, ids.shape[1]))
    outs = [out.to(torch.int32).contiguous()]
    if ctx.num_outputs > 1:
        outs.append(torch.zeros((b_sz, n_return), dtype=torch.float32, device=ids.device))
    return outs


def _beam_outputs(ctx, state, n_return):
    _, _, seq, beam_scores, *_ = state
    outs = [seq[:, :n_return]]
    if ctx.num_outputs > 1:
        outs.append(beam_scores[:, :n_return])
    return outs


def _flat_parent(parent2, b_sz, n_beams):
    base = torch.arange(b_sz, device=parent2.device)[:, None] * n_beams
    return (base + parent2).reshape(-1)


def _beam_search_encdec(ctx, features, max_length, *, min_length,
                        num_beams, num_return_sequences, length_penalty,
                        repetition_penalty, vocab_mask, prefix_vocab_mask,
                        attention_mask, decoder_input_ids,
                        timestamp_rules=False):
    """Encoder-decoder branch of BeamSearch / WhisperBeamSearch (model_type
    1/2): whisper's 2-input encoder (features, decoder_input_ids) or T5's
    3-input form with encoder_attention_mask between them (bound to ones:
    padded encoder inputs raise). The ``encoder`` (or
    ``encoder_decoder_init``) subgraph runs the encoder and the decoder
    prefill; the ``decoder`` subgraph is the with-past step, its past
    inputs matched to encoder outputs by name (``past_X`` ↔
    ``present_X``): names with ``cross`` are the static cross-attention
    caches, the rest grow by one position per step, as in the JAX lowering.
    A self past without its present among the decoder's outputs raises
    ValueError naming it."""
    what = f"com.microsoft.{ctx.op_type}"
    if int(ctx.attr("no_repeat_ngram_size", 0)):
        raise NotImplementedError(f"{what}: no_repeat_ngram_size")
    if prefix_vocab_mask is not None:
        raise NotImplementedError(f"{what}: prefix_vocab_mask")
    if decoder_input_ids is None:
        raise NotImplementedError(
            f"{what}: decoder_input_ids is required "
            "(decoder_start_token_id synthesis is not implemented)"
        )
    _unpadded(ctx, attention_mask, f"{what}: padded encoder inputs")
    eos = int(ctx.attr("eos_token_id"))
    pad = int(ctx.attr("pad_token_id"))
    early_stop = bool(int(ctx.attr("early_stopping", 0)))
    decoder = ctx.attr("decoder")
    encoder = ctx.attr("encoder") or ctx.attr("encoder_decoder_init")
    if decoder is None or encoder is None:
        raise ValueError(f"{what}: missing encoder/decoder graphs")

    feats = _t(ctx, features)
    dev = feats.device
    dec_ids = _t(ctx, decoder_input_ids, feats).to(torch.int32)
    b_sz, s0 = dec_ids.shape
    max_len, n_beams, n_return, lp_pen = _beam_sizes(
        ctx, max_length, num_beams, num_return_sequences, length_penalty)
    ml, rp, vm = _gen_common(ctx, what, min_length, repetition_penalty, vocab_mask, dev)
    rows = b_sz * n_beams
    if s0 >= max_len:
        return _prompt_only(ctx, dec_ids, b_sz, n_return, max_len)

    enc_in = [v.name for v in encoder.input]
    enc_out = [v.name for v in encoder.output]
    t5_layout = len(enc_in) == 3 and "mask" in enc_in[1].lower()
    if len(enc_in) > 3 or (
        len(enc_in) == 2 and "mask" in enc_in[1].lower()
    ) or (len(enc_in) == 3 and not t5_layout):
        raise NotImplementedError(
            f"{what}: encoder subgraph layout "
            f"{enc_in} is neither the 2-input whisper form (features, "
            "decoder_input_ids) nor the 3-input T5 form (ids, "
            "encoder_attention_mask, decoder_input_ids)"
        )
    enc_env = {enc_in[0]: feats}
    if t5_layout:
        enc_env[enc_in[1]] = torch.ones(tuple(feats.shape[:2]), dtype=torch.int32, device=dev)
        enc_env[enc_in[2]] = dec_ids
    elif len(enc_in) > 1:
        enc_env[enc_in[1]] = dec_ids
    pre = _run_subgraph(ctx, encoder, enc_env)
    logits0 = _t(ctx, pre[0], feats)[:, -1]
    vocab = logits0.shape[-1]
    present_by_name = dict(zip(enc_out[1:], pre[1:]))

    dec_in = [v.name for v in decoder.input]
    dec_mask_name = None
    past_names = []
    for n in dec_in[1:]:
        if "past" in n:
            past_names.append(n)
        elif "mask" in n.lower() and dec_mask_name is None:
            dec_mask_name = n  # T5: encoder_attention_mask per step
        else:
            raise NotImplementedError(
                f"{what}: decoder subgraph input "
                f"{n!r} beyond input_ids + past_* + encoder_attention_mask "
                "(e.g. explicit encoder_hidden_states) is not implemented"
            )
    is_cross = {n: "cross" in n for n in past_names}
    dec_out = [v.name for v in decoder.output]
    out_by_past = {name.replace("present", "past", 1): i + 1
                   for i, name in enumerate(dec_out[1:])}
    for name in past_names:
        if not is_cross[name] and name not in out_by_past:
            raise ValueError(
                f"{what}: the decoder subgraph has no output "
                f"{name.replace('past', 'present', 1)!r} for its input {name!r}"
            )
    pasts = {}
    for name in past_names:
        src_name = name.replace("past", "present", 1)
        if src_name not in present_by_name:
            raise NotImplementedError(
                f"{what}: decoder input {name!r} has "
                f"no matching encoder output {src_name!r}"
            )
        p = _t(ctx, present_by_name[src_name], feats).float()
        pasts[name] = p.repeat_interleave(n_beams, dim=0)  # beam-replicate
    enc_len = next((int(pasts[n].shape[2]) for n in past_names if is_cross[n]), None)
    if dec_mask_name is not None and enc_len is None:
        raise NotImplementedError(
            f"{what}: {dec_mask_name!r} without "
            "cross-attention caches to derive the encoder length from"
        )

    state = _beam_state_init(dec_ids, b_sz=b_sz, n_beams=n_beams, s0=s0,
                             max_len=max_len, pad=pad, vocab=vocab)
    extra = None
    if timestamp_rules:
        no_ts = ctx.attr("no_timestamps_token_id")
        no_ts = int(no_ts) if no_ts is not None else eos + 106
        max_init = ctx.attr("max_initial_timestamp_index")
        max_init = int(max_init) if max_init is not None else 50
        extra = _whisper_timestamp_rules(
            timestamp_begin=no_ts + 1, no_timestamps=no_ts, eos=eos,
            begin_index=s0, max_initial=max_init,
        )
    one_round = _make_beam_round(
        b_sz=b_sz, n_beams=n_beams, vocab=vocab, max_len=max_len,
        eos=eos, early_stop=early_stop, lp_pen=lp_pen,
        min_length=ml, repetition_penalty=rp, vocab_mask=vm,
        extra_processor=extra,
    )

    def reorder(parent2, pasts):
        # cross caches are beam-identical (one encoder pass); only the
        # growing self caches follow their parent beams
        flat = _flat_parent(parent2, b_sz, n_beams)
        return {n: (p if is_cross[n] else p.index_select(0, flat))
                for n, p in pasts.items()}

    logits_bk = logits0.repeat_interleave(n_beams, dim=0)
    state, parent2, cont = one_round(s0, logits_bk, state)
    pasts = reorder(parent2, pasts)
    enc_mask = (None if dec_mask_name is None
                else torch.ones((rows, enc_len), dtype=torch.int32, device=dev))

    t = s0
    while t + 1 < max_len and _keep_going(ctx, cont):
        t += 1
        env = {dec_in[0]: state[0][:, :, t - 1].reshape(rows, 1)}
        if enc_mask is not None:
            env[dec_mask_name] = enc_mask
        env.update(pasts)
        outs = _run_subgraph(ctx, decoder, env)
        for name in past_names:
            if not is_cross[name]:
                pasts[name] = _t(ctx, outs[out_by_past[name]], feats).float()
        state, parent2, cont = one_round(t, _t(ctx, outs[0], feats)[:, -1], state)
        pasts = reorder(parent2, pasts)
    return _beam_outputs(ctx, state, n_return)


@ms_op("BeamSearch", "WhisperBeamSearch")
def _beam_search_op(ctx, input_ids, max_length, min_length=None,
                    num_beams=None, num_return_sequences=None,
                    length_penalty=None, repetition_penalty=None,
                    vocab_mask=None, prefix_vocab_mask=None,
                    attention_mask=None, decoder_input_ids=None,
                    logits_processor=None, *extra_inputs):
    """BeamSearch (convert_generation.py): ``sequences`` [B,
    num_return_sequences, max_length] int32 (prompt + continuation, EOS
    included, pad-filled) and optional ``sequences_scores`` [B,
    num_return_sequences] (length-penalized sums of log-probs, best
    first). The static-shape beam search of HF's generate (2·num_beams
    candidates per step, EOS absorbed from the top num_beams ranks, the
    early-stop bound, per-batch freezing) over fixed max_length caches,
    with onnxruntime's lengths (module docstring). Processors act on
    log-softmax scores: vocab_mask, CTRL repetition penalty per beam
    history, min_length. ``model_type`` 1/2 (and WhisperBeamSearch) run the
    encoder-decoder branch; ``logits_processor=1`` adds the whisper
    timestamp rules there."""
    what = f"com.microsoft.{ctx.op_type}"
    if any(v is not None for v in extra_inputs):
        raise NotImplementedError(
            f"{what}: inputs beyond decoder_input_ids/"
            "logits_processor (cross_qk_layer_head / extra_decoding_ids / "
            "temperature) are not implemented"
        )
    if ctx.num_outputs > 2:
        raise NotImplementedError(
            f"{what}: outputs beyond sequences/"
            "sequences_scores (scores / cross_qk) are not implemented"
        )
    lpv = 0
    if logits_processor is not None:
        lpv = _static_int(logits_processor, f"{what} logits_processor")
    model_type = int(ctx.attr("model_type", 0))
    if ctx.op_type == "WhisperBeamSearch":
        model_type = 2
    if lpv not in (0, 1) or (lpv == 1 and model_type not in (1, 2)):
        raise NotImplementedError(
            f"{what}: logits_processor={lpv} "
            "(timestamp rules apply to the encoder-decoder branch only)"
        )
    if model_type not in (0, 1, 2):
        raise NotImplementedError(f"{what}: model_type={model_type}")
    if model_type in (1, 2):
        return _beam_search_encdec(
            ctx, input_ids, max_length, min_length=min_length,
            num_beams=num_beams, num_return_sequences=num_return_sequences,
            length_penalty=length_penalty,
            repetition_penalty=repetition_penalty, vocab_mask=vocab_mask,
            prefix_vocab_mask=prefix_vocab_mask,
            attention_mask=attention_mask,
            decoder_input_ids=decoder_input_ids,
            timestamp_rules=(lpv == 1),
        )
    if int(ctx.attr("no_repeat_ngram_size", 0)):
        raise NotImplementedError(f"{what}: no_repeat_ngram_size")
    if prefix_vocab_mask is not None:
        raise NotImplementedError(f"{what}: prefix_vocab_mask")
    eos = int(ctx.attr("eos_token_id"))
    pad = int(ctx.attr("pad_token_id"))
    early_stop = bool(int(ctx.attr("early_stopping", 0)))
    decoder = ctx.attr("decoder")
    if decoder is None:
        raise ValueError(f"{what}: missing decoder graph")
    init_decoder = ctx.attr("init_decoder") or decoder

    ids0 = _t(ctx, input_ids).to(torch.int32)
    dev = ids0.device
    b_sz, s0 = ids0.shape
    max_len, n_beams, n_return, lp_pen = _beam_sizes(
        ctx, max_length, num_beams, num_return_sequences, length_penalty)
    _unpadded(ctx, attention_mask, what)
    ml, rp, vm = _gen_common(ctx, what, min_length, repetition_penalty, vocab_mask, dev)
    if s0 >= max_len:
        return _prompt_only(ctx, ids0, b_sz, n_return, max_len)

    (in_ids_n, in_pos_n, in_mask_n), past_names, _ = _gen_subgraph_io(decoder, what)
    rows = b_sz * n_beams
    p_buf = max_len

    # the prefill runs once per batch row, then replicates over the beams
    pre = _gpt_prefill(ctx, init_decoder, ids0, what)
    logits0 = _t(ctx, pre[0], ids0)[:, -1].repeat_interleave(n_beams, dim=0)
    vocab = logits0.shape[-1]
    bufs = [_pad_to_buf(_t(ctx, p, ids0), p_buf, n_beams) for p in pre[1:]]

    state = _beam_state_init(ids0, b_sz=b_sz, n_beams=n_beams, s0=s0,
                             max_len=max_len, pad=pad, vocab=vocab)
    one_round = _make_beam_round(
        b_sz=b_sz, n_beams=n_beams, vocab=vocab, max_len=max_len,
        eos=eos, early_stop=early_stop, lp_pen=lp_pen,
        min_length=ml, repetition_penalty=rp, vocab_mask=vm,
    )
    state, parent2, cont = one_round(s0, logits0, state)
    flat = _flat_parent(parent2, b_sz, n_beams)
    bufs = [b.index_select(1, flat) for b in bufs]

    pos = torch.empty((rows, 1), dtype=torch.int32, device=dev)
    t = s0 + 1
    while t < max_len and _keep_going(ctx, cont):
        pos.fill_(t - 1)
        env = {in_ids_n: state[0][:, :, t - 1].reshape(rows, 1), in_pos_n: pos,
               in_mask_n: _step_mask(rows, p_buf, t, dev)}
        env.update(zip(past_names, bufs))
        outs = _run_subgraph(ctx, decoder, env)
        for b, p in zip(bufs, outs[1:]):
            b[:, :, :, t - 1:t] = _t(ctx, p, ids0)[:, :, :, p_buf:p_buf + 1].to(b.dtype)
        state, parent2, cont = one_round(t, _t(ctx, outs[0], ids0)[:, -1], state)
        flat = _flat_parent(parent2, b_sz, n_beams)
        bufs = [b.index_select(1, flat) for b in bufs]
        t += 1
    return _beam_outputs(ctx, state, n_return)


# ---------------------------------------------------------------------------
# Whisper word-timestamp pair: UnfoldTensor + DynamicTimeWarping
# ---------------------------------------------------------------------------


@ms_op("UnfoldTensor")
def _unfold_tensor(ctx, x):
    """torch.Tensor.unfold: a window of ``size`` slides with ``step`` along
    ``dim``; the window becomes a new trailing axis."""
    dim = int(ctx.attr("dim", -1))
    size = int(ctx.attr("size"))
    step = int(ctx.attr("step", 1))
    x = _t(ctx, x)
    dim = _axis(dim, x.ndim)
    if (x.shape[dim] - size) // step + 1 <= 0:
        raise ValueError(
            f"com.microsoft.UnfoldTensor: size {size} exceeds dim "
            f"{x.shape[dim]}"
        )
    return [x.unfold(dim, size, step)]


@ms_op("DynamicTimeWarping")
def _dynamic_time_warping(ctx, x):
    """Optimal monotone alignment path of a 2-D cost matrix, openai-whisper's
    ``dtw`` (diagonal/up/left moves; on ties the strict comparisons fall
    through to the LEFT move). Output [2, path_len] int32. The path's
    length depends on the data, so the matrix is read on the host: a host
    value or a CPU tensor; one on the card raises."""
    c = _host_value(
        x, "com.microsoft.DynamicTimeWarping input",
        "the path's length depends on the data",
    ).astype(np.float64)
    if c.ndim == 3 and c.shape[0] == 1:
        c = c[0]
    if c.ndim != 2:
        raise ValueError(
            f"com.microsoft.DynamicTimeWarping: expected a 2-D cost "
            f"matrix, got rank {c.ndim}"
        )
    n, m = c.shape
    cost = np.full((n + 1, m + 1), np.inf)
    trace = np.full((n + 1, m + 1), -1, np.int8)
    cost[0, 0] = 0.0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            c0 = cost[i - 1, j - 1]
            c1 = cost[i - 1, j]
            c2 = cost[i, j - 1]
            if c0 < c1 and c0 < c2:
                t, best = 0, c0
            elif c1 < c0 and c1 < c2:
                t, best = 1, c1
            else:
                t, best = 2, c2
            cost[i, j] = c[i - 1, j - 1] + best
            trace[i, j] = t
    i, j = n, m
    path_i, path_j = [], []
    while i > 0 and j > 0:
        path_i.append(i - 1)
        path_j.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return [np.asarray([path_i[::-1], path_j[::-1]], np.int32)]
