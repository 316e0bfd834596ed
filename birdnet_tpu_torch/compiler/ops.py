"""ONNX op → PyTorch lowering registry (the main-path op set).

The counterpart of :mod:`birdnet_tpu.compiler.ops` for the ops a BirdNET
v2.4 graph holds after import: the fused frontend, MBConv and stage-prefix
nodes (the stage prefix runs the B4 kernel under ``fast``/``bf16``), ``Conv`` in its four shapes, ``BatchNormalization``, ``Add``,
``Mul``, ``Log``, ``Sigmoid``, ``GlobalAveragePool``, ``Flatten``,
``Unsqueeze``, ``Transpose``, ``Gemm``, ``MatMul``, ``ReduceSumSquare``,
``MelWeightMatrix`` and ``STFT``; and the int8 set that post-training
quantization (compiler/quantize.py) produces: ``QuantizeLinear``,
``DequantizeLinear``, ``QLinearConv`` (symmetric int8 1x1 convs run the B3
kernel), ``QLinearMatMul``, ``_QLinearGemm``, ``ConvInteger``,
``MatMulInteger`` and ``DynamicQuantizeLinear``. Every other op is a later
port.

Values in the interpreter's environment are torch tensors (activations and
float params) or numpy arrays (small constants, shapes, axes). A lowering
that receives only numpy values may answer in numpy; one that meets a
tensor moves its numpy operands to that tensor's device.

Precision policies, as in the JAX package:

- ``fp32``: everything float32, with TF32 off (see importer.make_forward);
- ``mixed``: bf16 conv/matmul operands, float32 sums and float32
  activations, as the JAX package's ``preferred_element_type=float32``
  gives them: the operands are rounded to bf16 and the product runs in
  float32 (a product of two bf16 values is exact in float32; TF32 is off),
  or, for a CUDA matmul, ``torch.mm``/``torch.bmm`` with
  ``out_dtype=float32`` on the bf16 operands;
- ``fast``: bf16 operands and bf16 activations, float32 accumulation
  inside the product and one rounding of its output; the fused frontends
  and the stage prefix run the CUDA kernels;
- ``bf16``: as ``fast`` (torch accumulates bf16 products in float32).

The polyphase Conv1d keeps its partial products in float32 under ``mixed``
and ``fast`` and rounds once, after the shifted adds (the JAX lowering's
``preferred_element_type``).
"""

from __future__ import annotations

import functools
import os
import threading
from collections import OrderedDict
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..onnx.proto import DataType as _DT
from ..ops.cuda.qconv import EPILOGUE_ACTS as _EPILOGUE_ACTS
from ..ops.cuda.qconv import qconv1x1_requant

_REGISTRY: Dict[str, Callable] = {}


def op(*names):
    def deco(fn):
        for n in names:
            _REGISTRY[n] = fn
        return fn

    return deco


def get_lowering(op_type: str, domain: str = "") -> Callable:
    fn = _REGISTRY.get(op_type) if domain in ("", "ai.onnx") else None
    if fn is None:
        name = f"{domain}.{op_type}" if domain else op_type
        raise NotImplementedError(
            f"ONNX op '{name}' is not supported by the birdnet_tpu_torch "
            f"compiler yet"
        )
    return fn


class OpContext:
    """Per-node lowering context. ``env`` is the enclosing value environment
    (fused nodes interpret their ``body`` against it); ``device`` is where
    the forward runs."""

    __slots__ = ("op_type", "attrs", "opset", "precision", "node_name",
                 "num_outputs", "env", "out_names", "device")

    def __init__(self, op_type, attrs, opset=17, precision="fp32",
                 node_name="", num_outputs=1, env=None, out_names=(),
                 device=torch.device("cpu")):
        self.op_type = op_type
        self.attrs = attrs
        self.opset = opset
        self.precision = precision
        self.node_name = node_name
        self.num_outputs = num_outputs
        self.env = env if env is not None else {}
        self.out_names = tuple(out_names)
        self.device = device

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _ints(x, what: str) -> List[int]:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    try:
        return [int(v) for v in np.asarray(x).reshape(-1)]
    except (TypeError, ValueError) as e:
        raise ValueError(f"{what} must be an integer constant") from e


def _tensor(ctx: OpContext, x, device=None) -> torch.Tensor:
    """``x`` as a tensor on ``device`` (default: the forward's device)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr)
    return torch.from_numpy(arr).to(device if device is not None else ctx.device)


def _promoted(ctx: OpContext, *xs) -> List[torch.Tensor]:
    """Tensors of one common dtype, promoted as jax.numpy promotes arrays
    (a 0-d float32 constant lifts a bf16 tensor to float32, where torch's
    own rule would keep bf16)."""
    device = next(
        (x.device for x in xs if isinstance(x, torch.Tensor)), ctx.device
    )
    ts = [_tensor(ctx, x, device) for x in xs]
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return [t if t.dtype == dtype else t.to(dtype) for t in ts]


_ONNX_TO_NP = {
    _DT.FLOAT: np.float32,
    _DT.DOUBLE: np.float64,
    _DT.FLOAT16: np.float16,
    _DT.INT32: np.int32,
    _DT.INT64: np.int64,
}


# Precision policies (birdnet_tpu/compiler/ops.py:177-205).
_BF16_OPERAND_POLICIES = ("mixed", "fast", "bf16")


def _mxu_operands(ctx: OpContext, *xs):
    """Apply the precision policy to matmul/conv operands."""
    if ctx.precision in _BF16_OPERAND_POLICIES:
        return tuple(
            x.to(torch.bfloat16) if x.is_floating_point() else x for x in xs
        )
    return xs


def _bf16_in_f32(*xs):
    """Floating operands rounded to bf16 and held in float32: an f32 product
    of them is the bf16 product with float32 sums."""
    return tuple(
        x.to(torch.bfloat16).float() if x.is_floating_point() else x for x in xs
    )


def _f32_sum_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of floating operands with bf16-rounded operands and float32
    sums and output. On CUDA a 2-D or batched 3-D product of bf16 operands
    runs ``torch.mm``/``torch.bmm`` with ``out_dtype=float32`` (an
    ``[..., K] @ [K, N]`` product is flattened to 2-D); every other case,
    and every CPU tensor, multiplies the upcast operands in float32."""
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.is_cuda:
        if b.ndim == 2 and a.ndim >= 2:
            y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
            return y.reshape(*a.shape[:-1], b.shape[-1])
        if a.ndim == 3 and b.ndim == 3 and a.shape[0] == b.shape[0]:
            return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def _policy_matmul(ctx: OpContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """MatMul/Gemm product under the precision policy (before _out_cast)."""
    if ctx.precision == "mixed" and a.is_floating_point() and b.is_floating_point():
        return _f32_sum_matmul(a, b)
    a2, b2 = _mxu_operands(ctx, a, b)
    return torch.matmul(a2, b2)


def _out_cast(ctx: OpContext, y: torch.Tensor, orig_dtype) -> torch.Tensor:
    if ctx.precision == "mixed" and y.dtype != orig_dtype:
        return y.to(orig_dtype)
    if ctx.precision == "fast" and y.dtype != torch.bfloat16:
        # Keep activations bf16 between ops; accumulation stayed f32.
        return y.to(torch.bfloat16)
    return y


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------


def _host_scalar(x):
    """``x`` as a 0-d numpy array if it is a host scalar, else None."""
    if isinstance(x, torch.Tensor):
        return None
    arr = np.asarray(x)
    return arr if arr.ndim == 0 else None


def _binary(np_fn, torch_fn):
    def impl(ctx, a, b):
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            return [np_fn(np.asarray(a), np.asarray(b))]
        sa, sb = _host_scalar(a), _host_scalar(b)
        if sa is not None or sb is not None:
            # A host scalar (an epsilon, a threshold) rides along as a
            # Python number: no copy to the device per call. The result
            # dtype follows jax.numpy's promotion of the two arrays.
            t, s = (b, sa) if sa is not None else (a, sb)
            s_dtype = torch.from_numpy(np.empty(0, s.dtype)).dtype
            dtype = torch.promote_types(t.dtype, s_dtype)
            t = t.to(dtype)
            return [torch_fn(s.item(), t) if sa is not None else torch_fn(t, s.item())]
        return [torch_fn(*_promoted(ctx, a, b))]

    return impl


op("Add")(_binary(np.add, torch.add))
op("Mul")(_binary(np.multiply, torch.mul))


def _unary(fn):
    def impl(ctx, x):
        return [fn(_tensor(ctx, x))]

    return impl


op("Log")(_unary(torch.log))
op("Sigmoid")(_unary(torch.sigmoid))


# ---------------------------------------------------------------------------
# matmul / gemm
# ---------------------------------------------------------------------------


@op("MatMul")
def _matmul(ctx, a, b):
    a = _tensor(ctx, a)
    b = _tensor(ctx, b, a.device)
    return [_out_cast(ctx, _policy_matmul(ctx, a, b), a.dtype)]


@op("Gemm")
def _gemm(ctx, a, b, c=None):
    alpha = float(ctx.attr("alpha", 1.0))
    beta = float(ctx.attr("beta", 1.0))
    a = _tensor(ctx, a)
    b = _tensor(ctx, b, a.device)
    if int(ctx.attr("transA", 0)):
        a = a.t()
    if int(ctx.attr("transB", 0)):
        b = b.t()
    y = _out_cast(ctx, _policy_matmul(ctx, a, b), a.dtype)
    if alpha != 1.0:
        y = alpha * y
    if c is not None:
        bias = _tensor(ctx, c, y.device).to(y.dtype)  # the policy's activation dtype
        y = y + (beta * bias if beta != 1.0 else bias)
    return [y]


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------


def _resolve_pads(ctx, x_spatial, kernel, strides, dilations):
    """Return list[(lo, hi)] per spatial dim from pads/auto_pad attrs."""
    nd = len(kernel)
    auto_pad = ctx.attr("auto_pad", "NOTSET")
    if auto_pad in ("NOTSET", "", b"NOTSET"):
        pads = ctx.attr("pads")
        if pads is None:
            return [(0, 0)] * nd
        pads = [int(p) for p in pads]
        return [(pads[i], pads[i + nd]) for i in range(nd)]
    if auto_pad == "VALID":
        return [(0, 0)] * nd
    out = []
    for i in range(nd):
        in_dim = x_spatial[i]
        eff_k = (kernel[i] - 1) * dilations[i] + 1
        out_dim = -(-in_dim // strides[i])  # ceil
        total = max((out_dim - 1) * strides[i] + eff_k - in_dim, 0)
        if auto_pad == "SAME_UPPER":
            out.append((total // 2, total - total // 2))
        elif auto_pad == "SAME_LOWER":
            out.append((total - total // 2, total // 2))
        else:
            raise ValueError(f"unsupported auto_pad {auto_pad!r}")
    return out


def _polyphase_conv1d(ctx, x, w, b, stride, pads, orig):
    """Large-stride single-channel Conv1d as one dense matmul (the learned
    filterbank frontend: kernel 1024, stride 280, C_in=1).

    The polyphase decomposition j = k*s + r turns it into a reshape, ONE
    matmul with contraction depth s, and m = ceil(K/s) shifted adds:

        R = x.reshape(N, rows, s);  P = R @ Wstack[s, m*C]
        out[n, c, i] = sum_k P[n, i+k, k*C + c]
    """
    s = stride
    n, _, length = x.shape
    c_out, _, k = w.shape
    lo, hi = pads
    if lo or hi:
        x = F.pad(x, (lo, hi))
        length += lo + hi
    t = (length - k) // s + 1
    m = -(-k // s)
    rows = t + m - 1
    need = rows * s
    if need > length:
        x = F.pad(x, (0, need - length))
    r = x[:, 0, :need].reshape(n, rows, s)
    # Wstack[r, k*C + c] = w[c, k*s + r] (zero-padded past the true kernel).
    wpad = F.pad(w[:, 0, :], (0, m * s - k))
    wstack = wpad.reshape(c_out, m, s).permute(2, 1, 0).reshape(s, m * c_out)
    if ctx.precision in ("mixed", "fast"):
        # float32 partial products, rounded once after the shifted adds.
        p = _f32_sum_matmul(r, wstack)
    else:
        r2, w2 = _mxu_operands(ctx, r, wstack)
        p = torch.matmul(r2, w2)
    y = p[:, 0:t, 0:c_out]
    for ki in range(1, m):
        y = y + p[:, ki:ki + t, ki * c_out:(ki + 1) * c_out]
    if b is not None:
        y = y + _tensor(ctx, b, y.device).reshape(1, 1, -1).to(y.dtype)
    y = _out_cast(ctx, y, orig)
    return [y.transpose(1, 2)]


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv_geometry(ctx, x, w):
    """Shared Conv/QLinearConv/ConvInteger geometry from the ONNX conv
    attributes: ``(strides, dilations, group, pads)``."""
    nd = x.ndim - 2
    if nd not in _CONV:
        raise NotImplementedError(f"Conv over {nd} spatial dims")
    kernel = [int(v) for v in ctx.attr("kernel_shape", w.shape[2:])]
    strides = [int(s) for s in ctx.attr("strides", [1] * nd)]
    dilations = [int(d) for d in ctx.attr("dilations", [1] * nd)]
    group = int(ctx.attr("group", 1))
    if any(v < 1 for v in strides) or any(v < 1 for v in dilations):
        raise ValueError(
            f"Conv strides/dilations must be >= 1, got strides={strides} "
            f"dilations={dilations}"
        )
    if group < 1 or x.shape[1] % group or w.shape[0] % group:
        raise ValueError(
            f"Conv group={group} must divide input channels {x.shape[1]} "
            f"and output channels {w.shape[0]}"
        )
    pads = _resolve_pads(ctx, x.shape[2:], kernel, strides, dilations)
    return strides, dilations, group, pads


def _conv_nd(x, w, strides, dilations, group, pads):
    """torch convolution with ONNX (lo, hi) pads per spatial dim."""
    if all(lo == hi for lo, hi in pads):
        padding = [lo for lo, _ in pads]
    else:
        # torch pads symmetrically; asymmetric ONNX pads go in first.
        x = F.pad(x, [p for lo, hi in reversed(pads) for p in (lo, hi)])
        padding = 0
    return _CONV[x.ndim - 2](x, w, None, strides, padding, dilations, group)


@op("Conv")
def _conv(ctx, x, w, b=None):
    """Conv in the shapes the BirdNET graphs use: the large-stride C_in=1
    Conv1d filterbank (polyphase matmul), the 3x3 stride-2 stem, 1x1 and
    depthwise convolutions (cuDNN through torch.nn.functional)."""
    x = _tensor(ctx, x)
    w = _tensor(ctx, w, x.device)
    nd = x.ndim - 2
    strides, dilations, group, pads = _conv_geometry(ctx, x, w)
    orig = x.dtype
    if (
        nd == 1
        and group == 1
        and w.shape[1] == 1
        and strides[0] >= 16
        and w.shape[2] >= 16
        and dilations == [1]
        and (x.shape[2] + sum(pads[0]) - w.shape[2]) // strides[0] >= 0
    ):
        return _polyphase_conv1d(ctx, x, w, b, strides[0], pads[0], orig)
    if ctx.precision == "mixed":
        x2, w2 = _bf16_in_f32(x, w)  # float32 sums (TF32 is off for cuDNN)
    else:
        x2, w2 = _mxu_operands(ctx, x, w)
    y = _conv_nd(x2, w2, strides, dilations, group, pads)
    y = _out_cast(ctx, y, orig)
    if b is not None:
        bias = _tensor(ctx, b, y.device).reshape((1, -1) + (1,) * nd)
        y = y + bias.to(y.dtype)
    return [y]


@op("BatchNormalization")
def _batchnorm(ctx, x, scale, bias, mean, var):
    """Inference-form BatchNormalization (graphs where import-time folding
    into the preceding Conv does not apply)."""
    eps = float(ctx.attr("epsilon", 1e-5))
    x = _tensor(ctx, x)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    scale, bias, mean, var = (
        _tensor(ctx, v, x.device).reshape(shape) for v in (scale, bias, mean, var)
    )
    inv = scale * torch.rsqrt(var + eps)
    return [x * inv + (bias - mean * inv)]


# ---------------------------------------------------------------------------
# pooling, shape manipulation, reductions
# ---------------------------------------------------------------------------


@op("GlobalAveragePool")
def _global_avgpool(ctx, x):
    x = _tensor(ctx, x)
    return [x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)]


@op("Flatten")
def _flatten(ctx, x):
    axis = int(ctx.attr("axis", 1))
    if axis < 0:
        axis += x.ndim
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    return [x.reshape(lead, -1)]


def _axes_arg(ctx, axes_input):
    """Resolve axes from attr (opset<13) or input (>=13)."""
    if axes_input is not None:
        return _ints(axes_input, "axes")
    axes = ctx.attr("axes")
    return [int(a) for a in axes] if axes is not None else None


@op("Unsqueeze")
def _unsqueeze(ctx, x, axes=None):
    ax = _axes_arg(ctx, axes)
    out_ndim = x.ndim + len(ax)
    for a in sorted(a + out_ndim if a < 0 else a for a in ax):
        x = x.unsqueeze(a) if isinstance(x, torch.Tensor) else np.expand_dims(x, a)
    return [x]


@op("Transpose")
def _transpose(ctx, x):
    perm = ctx.attr("perm")
    perm = [int(p) for p in perm] if perm is not None else list(range(x.ndim))[::-1]
    if isinstance(x, torch.Tensor):
        return [x.permute(perm)]
    return [np.transpose(x, perm)]


@op("ReduceSumSquare")
def _reduce_sum_square(ctx, x, axes=None):
    x = _tensor(ctx, x)
    if ctx.opset >= 18 or axes is not None:
        ax = _axes_arg(ctx, axes)
    else:
        ax = ctx.attr("axes")
        ax = [int(a) for a in ax] if ax is not None else None
    keepdims = bool(int(ctx.attr("keepdims", 1)))
    if not ax:
        if int(ctx.attr("noop_with_empty_axes", 0)):
            return [x]
        ax = list(range(x.ndim))
    return [torch.sum(x * x, dim=tuple(ax), keepdim=keepdims)]


# ---------------------------------------------------------------------------
# signal ops
# ---------------------------------------------------------------------------


@op("MelWeightMatrix")
def _mel_weight_matrix(ctx, num_mel_bins, dft_length, sample_rate,
                       lower_edge_hertz, upper_edge_hertz):
    """Triangular mel filterbank per the ONNX spec (HTK mel scale), built
    once per device and geometry."""
    return [_mel_matrix(
        _ints(num_mel_bins, "num_mel_bins")[0],
        _ints(dft_length, "dft_length")[0],
        _ints(sample_rate, "sample_rate")[0],
        float(np.asarray(lower_edge_hertz).reshape(-1)[0]),
        float(np.asarray(upper_edge_hertz).reshape(-1)[0]),
        int(ctx.attr("output_datatype", 1)),
        ctx.device,
    )]


@functools.lru_cache(maxsize=8)
def _mel_matrix(m, dft, sr, lo, hi, onnx_dtype, device) -> torch.Tensor:
    from ._melbank import mel_weight_matrix

    arr = mel_weight_matrix(m, dft, sr, lo, hi).astype(_ONNX_TO_NP[onnx_dtype])
    return torch.from_numpy(arr).to(device)


@op("STFT")
def _stft(ctx, signal, frame_step, window=None, frame_length=None):
    """Short-time Fourier transform (ONNX opset 17) of a real signal
    ``[B, L]`` or ``[B, L, 1]``: ``[B, frames, bins, 2]`` (real, imag).

    The DFT is a matmul against a cos/sin basis. Under ``fast``/``bf16``
    the operands are rounded to bf16 and the product accumulates in float32
    (as the JAX lowering's ``preferred_element_type``); ``fp32`` and
    ``mixed`` keep full float32 passes, because spectra cancel.
    """
    x = _tensor(ctx, signal)
    if x.ndim == 3:
        if x.shape[2] != 1:
            raise NotImplementedError("complex STFT input not supported")
        x = x[:, :, 0]
    step = _ints(frame_step, "STFT frame_step")[0]
    if frame_length is not None:
        flen = _ints(frame_length, "STFT frame_length")[0]
    elif window is not None:
        flen = int(window.shape[0])
    else:
        raise ValueError("STFT needs frame_length or window")
    onesided = int(ctx.attr("onesided", 1))
    bins = flen // 2 + 1 if onesided else flen
    n_frames = (x.shape[1] - flen) // step + 1
    if n_frames <= 0:
        return [x.new_zeros((x.shape[0], 0, bins, 2))]
    frames = x.unfold(1, flen, step)  # [B, frames, flen]
    if window is not None:
        win = _tensor(ctx, window, x.device).to(frames.dtype)
        if win.shape[0] < flen:
            # Spec: windows shorter than frame_length are zero-padded.
            win = F.pad(win, (0, flen - win.shape[0]))
        frames = frames * win
    if flen > 4096:
        spec = (torch.fft.rfft if onesided else torch.fft.fft)(frames.float(), dim=-1)
        return [torch.stack([spec.real, spec.imag], dim=-1).to(x.dtype)]
    basis = _dft_basis(flen, bins, x.device)
    frames = frames.float()
    if ctx.precision in ("fast", "bf16"):
        frames = frames.to(torch.bfloat16).float()
        basis = basis.to(torch.bfloat16).float()
    out = torch.matmul(frames, basis)
    return [torch.stack([out[..., :bins], out[..., bins:]], dim=-1).to(x.dtype)]


@functools.lru_cache(maxsize=8)
def _dft_basis(flen: int, bins: int, device: torch.device) -> torch.Tensor:
    """``[flen, 2*bins]`` float32 cos/sin DFT basis on ``device``, built once
    (the JAX lowering builds it at trace time)."""
    ang = (-2.0 * np.pi / flen) * np.outer(np.arange(flen), np.arange(bins))
    basis = np.concatenate([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return torch.from_numpy(basis).to(device)


# ---------------------------------------------------------------------------
# quantize / dequantize and integer compute: the int8 path
#
# Same semantics as birdnet_tpu/compiler/ops.py:1895-2267. torch has no int8
# convolution on CUDA, so the exact int32 accumulators of the integer convs
# and matmuls are computed in float64, exact while every partial sum stays
# below 2^53 (C_in/group * kh * kw * 255^2 terms), then cast to int32.
# Symmetric int8 1x1 convs take the B3 kernel (ops/cuda/qconv.py), which is
# bit-identical to the unfused lowering.
#
# Scales, zero points and biases are host constants (numpy). Each reaches
# the device once (``_on_device``); a host scalar never divides a CUDA
# tensor, because CUDA's true division turns a host-scalar divisor into a
# multiply by its float32 reciprocal, which flips round-half-even ties.
# ---------------------------------------------------------------------------


def _is_host(x) -> bool:
    """True for a host value (numpy or Python), the port's counterpart of
    the JAX package's compile-time static values."""
    return not isinstance(x, torch.Tensor)


@functools.lru_cache(maxsize=4096)
def _device_array(raw: bytes, dtype: str, shape, device) -> torch.Tensor:
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(arr.copy()).to(device)


def _on_device(x, device) -> torch.Tensor:
    """``x`` as a tensor on ``device``. Host arrays are uploaded once per
    value and shared: callers never write to the result."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    arr = np.ascontiguousarray(x)
    return _device_array(arr.tobytes(), arr.dtype.str, arr.shape,
                         torch.device(device))


def _bcast_channel(v: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    """Reshape a 1-D per-channel vector for broadcasting along ``axis``."""
    if v.ndim == 1 and v.shape[0] > 1:
        shape = [1] * ndim
        shape[axis] = -1
        return v.reshape(shape)
    return v


def _qdq_scale_zp(ctx, x, scale, zero_point):
    """A QDQ scale/zero point on ``x``'s device, shaped to broadcast against
    ``x``: per-tensor (scalar), per-axis (1-D along ``axis``) or blocked
    (opset 21 ``block_size``: each block's scale repeats ``block_size`` times
    along ``axis``, tail block clamped)."""
    axis = int(ctx.attr("axis", 1))
    if axis < 0:
        axis += x.ndim
    scale = _on_device(scale, x.device)
    zp = None if zero_point is None else _on_device(zero_point, x.device)
    bs = int(ctx.attr("block_size", 0))
    if bs > 0:
        if scale.ndim != x.ndim:
            raise ValueError(
                f"{ctx.op_type}: blocked quantization needs a scale of "
                f"x's rank ({x.ndim}); got rank {scale.ndim}"
            )
        blk = torch.clamp(
            torch.arange(x.shape[axis], device=x.device) // bs,
            max=scale.shape[axis] - 1,
        )
        scale = scale.index_select(axis, blk)
        if zp is not None:
            zp = zp.index_select(axis, blk)
    elif scale.ndim == 1 and scale.shape[0] > 1:
        scale = _bcast_channel(scale, x.ndim, axis)
        if zp is not None:
            zp = _bcast_channel(zp, x.ndim, axis)
    return scale, zp


_INT_TARGETS = {
    _DT.UINT8: torch.uint8,
    _DT.INT8: torch.int8,
    _DT.INT16: torch.int16,
    _DT.INT32: torch.int32,
}


@op("DequantizeLinear")
def _dequantize_linear(ctx, x, scale, zero_point=None):
    """(x - zero_point) * scale: per-tensor, per-axis or blocked."""
    x = _tensor(ctx, x)
    scale, zp = _qdq_scale_zp(ctx, x, scale, zero_point)
    xf = x.float()
    if zp is not None:
        xf = xf - zp.float()
    return [xf * scale.float()]


@op("QuantizeLinear")
def _quantize_linear(ctx, x, scale, zero_point=None):
    """Saturating round-half-even(x / scale) + zero_point: per-tensor,
    per-axis or blocked. The target type comes from the zero point, the
    ``output_dtype`` attribute (opset 21) or defaults to uint8; float8
    targets are not ported (ROADMAP A8)."""
    x = _tensor(ctx, x).float()
    scale, zp = _qdq_scale_zp(ctx, x, scale, zero_point)
    if zp is not None:
        out_dtype = zp.dtype
    elif ctx.attr("output_dtype") is not None:
        out_dtype = _INT_TARGETS.get(int(ctx.attr("output_dtype")))
        if out_dtype is None:
            raise NotImplementedError(
                f"QuantizeLinear to ONNX type {int(ctx.attr('output_dtype'))} "
                f"is not ported to birdnet_tpu_torch (ROADMAP A8)"
            )
    else:
        out_dtype = torch.uint8
    q = torch.round(x / scale.float())
    if zp is not None:
        q = q + zp.float()
    info = torch.iinfo(out_dtype)
    return [q.clamp(info.min, info.max).to(out_dtype)]


def _quant_pair(q: torch.Tensor, zp):
    """Normalize a quantized tensor to int8: uint8 is shifted down by 128,
    with the zero point shifted to match. Returns ``(q_s8, zp_i32,
    zp_is_statically_zero)``; a host zero point stays on the host."""
    if q.dtype == torch.uint8:
        shift = 128
        q = (q.to(torch.int32) - 128).to(torch.int8)
    elif q.dtype == torch.int8:
        shift = 0
    else:
        raise NotImplementedError(
            f"quantized compute expects int8/uint8 operands, got {q.dtype}"
        )
    base = np.int32(0) if zp is None else zp
    if _is_host(base):
        arr = np.asarray(base).astype(np.int64) - shift
        return q, arr.astype(np.int32), bool(np.all(arr == 0))
    return q, base.to(torch.int32) - shift, False


def _int_conv_acc(ctx, x, w, x_zp, w_zp):
    """Exact int32 accumulator of conv(x - x_zp, w - w_zp), in float64.
    Padded taps contribute (0 - 0), the dequantized zero."""
    x_s8, xzp, xzp_zero = _quant_pair(x, x_zp)
    w_s8, wzp, wzp_zero = _quant_pair(w, w_zp)
    strides, dilations, group, pads = _conv_geometry(ctx, x_s8, w_s8)
    x64, w64 = x_s8.double(), w_s8.double()
    if not xzp_zero:
        x64 = x64 - _bcast_channel(_on_device(xzp, x.device).double(), x64.ndim, 1)
    if not wzp_zero:
        w64 = w64 - _bcast_channel(_on_device(wzp, x.device).double(), w64.ndim, 0)
    return _conv_nd(x64, w64, strides, dilations, group, pads).to(torch.int32)


def _int_matmul_acc(a, b, a_zp, b_zp):
    """Exact int32 accumulator of matmul(a - a_zp, b - b_zp), in float64
    (a 1-D ``a_zp`` is per row of a, a 1-D ``b_zp`` per column of b)."""
    a_s8, azp, azp_zero = _quant_pair(a, a_zp)
    b_s8, bzp, bzp_zero = _quant_pair(b, b_zp)
    a64, b64 = a_s8.double(), b_s8.double()
    if not azp_zero:
        azp = _on_device(azp, a.device).double()
        if azp.ndim == 1 and azp.shape[0] > 1:
            azp = azp.reshape(-1, 1)
        a64 = a64 - azp
    if not bzp_zero:
        b64 = b64 - _on_device(bzp, a.device).double()
    return torch.matmul(a64, b64).to(torch.int32)


def _fused_act(ctx) -> str:
    return ctx.attr("_fused_act", "relu" if int(ctx.attr("_fused_relu", 0)) else "")


def _requantize(ctx, acc_f32, y_scale, y_zp, channel_ndim=None):
    """float accumulator → quantized output (round-half-even, saturating;
    the output type follows the zero point, uint8 without one). The
    ``_fused_act`` attribute applies an activation first, in float32."""
    v = _EPILOGUE_ACTS[_fused_act(ctx)](acc_f32)
    ys = _on_device(y_scale, v.device).float()
    if channel_ndim is not None:
        ys = _bcast_channel(ys, channel_ndim, 1)
    q = torch.round(v / ys)
    if y_zp is not None:
        zp = _on_device(y_zp, v.device)
        out_dtype = zp.dtype
        q = q + zp.float()
    else:
        out_dtype = torch.uint8
    info = torch.iinfo(out_dtype)
    return q.clamp(info.min, info.max).to(out_dtype)


def _qconv1x1_kernel_eligible(ctx, x, w, x_zp, w_zp, y_s, y_zp) -> bool:
    """B3's conditions (birdnet_tpu/compiler/ops.py:2120-2157): symmetric
    int8 1x1 stride-1 ungrouped unpadded conv, every zero point a host int8
    zero, a host scalar output scale. The TPU's lane-multiple rule on the
    spatial size is dropped: B3 takes every N >= 1."""
    if x.ndim != 4 or x.dtype != torch.int8 or w.dtype != torch.int8:
        return False
    if tuple(w.shape[2:]) != (1, 1):
        return False
    if not _is_host(y_s) or np.asarray(y_s).size != 1:
        return False
    if [int(s) for s in ctx.attr("strides", [1, 1])] != [1, 1]:
        return False
    if [int(d) for d in ctx.attr("dilations", [1, 1])] != [1, 1]:
        return False
    if int(ctx.attr("group", 1)) != 1:
        return False
    ap = ctx.attr("auto_pad", "NOTSET")
    if isinstance(ap, bytes):
        ap = ap.decode()
    if ap in ("NOTSET", ""):
        if [int(p) for p in ctx.attr("pads", [0, 0, 0, 0])] != [0, 0, 0, 0]:
            return False
    elif ap != "VALID":
        return False
    for zp in (x_zp, w_zp, y_zp):
        if zp is None or not _is_host(zp):
            return False  # y_zp None means uint8 output
        arr = np.asarray(zp)
        if arr.dtype != np.int8 or not np.all(arr == 0):
            return False
    return True


@op("QLinearConv")
def _qlinear_conv(ctx, x, x_s, x_zp, w, w_s, w_zp, y_s, y_zp=None, b=None):
    """Quantized conv; the optional ``_fused_act`` attribute (relu, sigmoid,
    silu, tanh, set by the QDQ fusion pass) runs in the float32 requantize
    epilogue. Symmetric int8 1x1 convs run the B3 kernel
    (ops/cuda/qconv.py::qconv1x1_requant)."""
    x = _tensor(ctx, x)
    w = _on_device(w, x.device)
    nd = x.ndim - 2
    if _qconv1x1_kernel_eligible(ctx, x, w, x_zp, w_zp, y_s, y_zp):
        n_img, c_in, h, wdim = x.shape
        c_out = w.shape[0]
        scale = (
            _on_device(x_s, x.device).float().reshape(-1)
            * _on_device(w_s, x.device).float().reshape(-1)
        ).expand(c_out).contiguous()
        bias = None if b is None else _on_device(b, x.device).to(torch.int32)
        y = qconv1x1_requant(
            x.reshape(n_img, c_in, h * wdim).contiguous(),
            w.reshape(c_out, c_in).contiguous(),
            bias,
            scale,
            float(np.asarray(y_s).reshape(())),
            act=_fused_act(ctx),
        )
        return [y.reshape(n_img, c_out, h, wdim)]
    acc = _int_conv_acc(ctx, x, w, x_zp, w_zp)
    if b is not None:
        acc = acc + _on_device(b, x.device).to(torch.int32).reshape((1, -1) + (1,) * nd)
    scale = _on_device(x_s, x.device).float() * _bcast_channel(
        _on_device(w_s, x.device).float(), x.ndim, 1
    )
    return [_requantize(ctx, acc.float() * scale, y_s, y_zp, channel_ndim=x.ndim)]


@op("QLinearMatMul")
def _qlinear_matmul(ctx, a, a_s, a_zp, b, b_s, b_zp, y_s, y_zp=None):
    """Quantized matmul (per-tensor a scale, per-tensor or per-column b
    scale)."""
    a = _tensor(ctx, a)
    b = _on_device(b, a.device)
    acc = _int_matmul_acc(a, b, a_zp, b_zp)
    # A 1-D b scale broadcasts along the output's last (column) axis.
    scale = _on_device(a_s, a.device).float() * _on_device(b_s, a.device).float()
    return [_requantize(ctx, acc.float() * scale, y_s, y_zp)]


@op("_QLinearGemm")
def _qlinear_gemm(ctx, a, a_s, a_zp, b, b_s, b_zp, y_s, y_zp=None, bias=None):
    """Internal fused op of the QDQ pass for quantized Gemm (alpha = beta = 1;
    ``bias`` int32 at scale a_s * b_s; transB applies to the stored
    weight, whose per-channel scale then runs along the output columns)."""
    a = _tensor(ctx, a)
    b = _on_device(b, a.device)
    if int(ctx.attr("transA", 0)):
        a = a.t()
    if int(ctx.attr("transB", 0)):
        b = b.t()
    acc = _int_matmul_acc(a, b, a_zp, b_zp)
    if bias is not None:
        acc = acc + _on_device(bias, a.device).to(torch.int32)
    scale = _on_device(a_s, a.device).float() * _on_device(b_s, a.device).float()
    return [_requantize(ctx, acc.float() * scale, y_s, y_zp)]


@op("ConvInteger")
def _conv_integer(ctx, x, w, x_zp=None, w_zp=None):
    x = _tensor(ctx, x)
    return [_int_conv_acc(ctx, x, _on_device(w, x.device), x_zp, w_zp)]


@op("MatMulInteger")
def _matmul_integer(ctx, a, b, a_zp=None, b_zp=None):
    a = _tensor(ctx, a)
    return [_int_matmul_acc(a, _on_device(b, a.device), a_zp, b_zp)]


@op("DynamicQuantizeLinear")
def _dynamic_quantize_linear(ctx, x):
    """Per the ONNX spec: uint8 with the range widened to include zero,
    scale = (max - min) / 255, saturating round-half-even."""
    x = _tensor(ctx, x).float()
    zero, one = x.new_zeros(()), x.new_ones(())
    x_min = torch.minimum(x.min(), zero)
    x_max = torch.maximum(x.max(), zero)
    scale = (x_max - x_min) / x.new_full((), 255.0)
    safe_scale = torch.where(scale == 0, one, scale)
    zp = torch.clamp(torch.round(zero - x_min / safe_scale), 0.0, 255.0)
    y = torch.clamp(torch.round(x / safe_scale) + zp, 0.0, 255.0).to(torch.uint8)
    return [y, scale, zp.to(torch.uint8)]


# ---------------------------------------------------------------------------
# fused nodes (bundled at import by compiler/fuse_*.py)
# ---------------------------------------------------------------------------


def _run_subgraph(ctx: OpContext, graph, extra_env=None):
    """Interpret a subgraph with outer-scope capture: the enclosing
    environment is visible, shadowed by the subgraph's own initializers and
    ``extra_env``."""
    from .importer import interpret_graph

    env = dict(ctx.env)
    for t in graph.initializer:
        env[t.name] = t.to_numpy()
    if extra_env:
        env.update(extra_env)
    return interpret_graph(
        graph, ctx.opset, ctx.precision, env, [v.name for v in graph.output],
        device=ctx.device,
    )


@op("_FusedMBConv")
def _fused_mbconv(ctx, *args):
    """Whole MBConv block: re-interprets the original node chain stored in
    ``body``, identical to the unfused graph."""
    return list(_run_subgraph(ctx, ctx.attr("body")))


_PREFIX_TABLES: "OrderedDict[tuple, tuple]" = OrderedDict()
_PREFIX_TABLES_MAX = 8
_PREFIX_TABLES_LOCK = threading.Lock()


def _stage_prefix_tables(ctx, stem_w, stem_b, block_args, k, device):
    """B4's weight tables for the first ``k`` blocks, built once per device
    and weights (the forward's params and constants live as long as it
    does). The cache holds the source tensors, so their storage, and with
    it the key, cannot be reused while an entry lives."""
    from ..ops.cuda.stage_prefix import BlockGeom, prepare_weights

    sources = tuple(_tensor(ctx, v, device) for v in (stem_w, stem_b) + block_args[:10 * k])
    key = (k, str(device)) + tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in sources)
    with _PREFIX_TABLES_LOCK:
        hit = _PREFIX_TABLES.get(key)
        if hit is not None:
            _PREFIX_TABLES.move_to_end(key)
            return hit[0]
    strides = [int(s) for s in ctx.attr("strides")]
    residuals = [int(r) for r in ctx.attr("residuals")]
    blocks, weights = [], []
    for bi in range(k):
        bw = dict(zip(("w1", "b1", "wd", "bd", "se1", "bse1", "se2", "bse2", "w3", "b3"),
                      sources[2 + 10 * bi:12 + 10 * bi]))
        blocks.append(BlockGeom(
            c_in=bw["w1"].shape[1], c_mid=bw["w1"].shape[0], c_se=bw["se1"].shape[0],
            c_out=bw["w3"].shape[0], stride=strides[bi], residual=bool(residuals[bi]),
        ))
        weights.append(bw)
    tables = prepare_weights(sources[0], sources[1], weights, blocks, torch.bfloat16, device)
    with _PREFIX_TABLES_LOCK:
        _PREFIX_TABLES[key] = (tables, sources)
        while len(_PREFIX_TABLES) > _PREFIX_TABLES_MAX:
            _PREFIX_TABLES.popitem(last=False)
    return tables


@op("_FusedStagePrefix")
def _fused_stage_prefix(ctx, x, stem_w, stem_b, *block_args):
    """Stem + leading MBConv chain (bundled by compiler/fuse_stage_prefix.py)
    as the B4 kernel (ops/cuda/stage_prefix.py::stage_stack_forward), the
    counterpart of the JAX lowering (birdnet_tpu/compiler/ops.py:2310).

    Eligible under ``fast``/``bf16`` for ``x`` of shape ``[N, 1, 96, W]``
    with W in {511, 512}; everything else interprets ``body``, identical to
    the unfused graph. ``BIRDNET_STAGE123_SPLIT=k`` runs the kernel for the
    stem + the first ``k`` blocks and interprets the rest from the kernel's
    output; ``0`` interprets ``body``. Unset, the kernel runs every bundled
    block: the JAX package's default (off) came from a TPU sweep, and on the
    H100 the eager path is bound by host dispatch, which the kernel's dozen
    launches cut (PERF.md has the A/B). Compute type bf16; ``fast_act``
    under ``fast``."""
    x = _tensor(ctx, x)
    n_blocks = len(ctx.attr("strides"))
    body = ctx.attr("body")
    eligible = (
        ctx.precision in ("fast", "bf16")
        and x.ndim == 4
        and x.shape[1] == 1
        and x.shape[2] == 96
        and x.shape[3] in (511, 512)
    )
    split = os.environ.get("BIRDNET_STAGE123_SPLIT")
    k = n_blocks if split is None else max(0, min(n_blocks, int(split)))
    if not eligible or k == 0:
        return list(_run_subgraph(ctx, body))
    from ..ops.cuda.stage_prefix import stage_stack_forward

    tables = _stage_prefix_tables(ctx, stem_w, stem_b, block_args, k, x.device)
    x_k = stage_stack_forward(x.to(torch.bfloat16), tables,
                              fast_act=ctx.precision == "fast")
    if k == n_blocks:
        return [x_k]
    # Partial split: interpret the remaining blocks of the body chain,
    # seeded with the kernel's activation.
    from ..onnx import proto as P

    block_outputs = list(ctx.attr("block_outputs"))
    suffix = P.GraphProto(
        name="stage_prefix_suffix",
        node=body.node[3 + k:],
        initializer=[],
        input=[],
        output=[P.make_value_info(block_outputs[-1], _DT.FLOAT, [])],
    )
    return list(_run_subgraph(ctx, suffix, extra_env={block_outputs[k - 1]: x_k}))


def _frontend_kernel_eligible(ctx, x) -> bool:
    return ctx.precision in ("fast", "bf16") and x.ndim == 2


@op("_FusedFrontend")
def _fused_frontend(ctx, x, w):
    """Conv-form audio frontend (framing + filterbank + power + log). Under
    ``fast``/``bf16`` it runs the B2 kernel
    (ops/cuda/frontend.py::segments_filterbank_logpower) in bf16; under
    ``fp32``/``mixed`` it interprets ``body``."""
    x = _tensor(ctx, x)
    if not _frontend_kernel_eligible(ctx, x):
        return list(_run_subgraph(ctx, ctx.attr("body")))
    from ..ops.cuda.frontend import segments_filterbank_logpower

    out = segments_filterbank_logpower(
        x.to(torch.bfloat16), _tensor(ctx, w, x.device),
        hop=int(ctx.attr("hop")), eps=float(ctx.attr("eps")),
    )  # [N, F, T], the mel-image orientation
    return [out[:, None]]


@op("_FusedStftFrontend")
def _fused_stft_frontend(ctx, x):
    """STFT-form audio frontend (framing + windowed DFT + power + mel +
    log). Under ``fast``/``bf16`` it runs the B1 kernel
    (ops/cuda/frontend.py::segments_stft_melspec) in bf16; under
    ``fp32``/``mixed`` it interprets ``body``."""
    x = _tensor(ctx, x)
    if not _frontend_kernel_eligible(ctx, x):
        return list(_run_subgraph(ctx, ctx.attr("body")))
    from ..ops.cuda.frontend import segments_stft_melspec

    out = segments_stft_melspec(
        x.to(torch.bfloat16),
        ctx.attr("window").to_numpy(),
        ctx.attr("mel").to_numpy(),
        hop=int(ctx.attr("hop")),
        eps=float(ctx.attr("eps")),
    )  # [N, M, T], the mel-image orientation
    return [out[:, None]]
