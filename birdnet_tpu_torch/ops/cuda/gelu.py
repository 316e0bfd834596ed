"""The exact-erf GELU with its prologue in one pass: the CUDA kernels of
``birdnet_tpu_torch/csrc/gelu.cu`` and their plain versions.

``compiler/fuse_gelu.py`` bundles an exported GELU chain (``Div`` by sqrt 2
or ``Mul`` by its inverse, ``Erf``, ``Add`` 1, two ``Mul``s) with the
prologue that feeds it into a ``_FusedGelu`` node, whose lowering calls
these under the bfloat16 policies on the card. Three forms:

- ``bias``: ``v = x + bias`` over the last axis (a transformer's FFN);
- ``bare``: ``v = x`` (no prologue);
- ``channel_ln``: ``x [N, C, T]`` normalized over the channels by
  LayerNormalization between two Transposes (a conv feature encoder),
  its statistics in the activation's type, then the float32 affine;

then ``g = 0.5 v (1 + erf(v / c))`` in the exported order of the Muls.
Every step is the unfused lowering's, in its order and precision: the
LayerNorm's statistics in ``x``'s type, the chain float32 from the bias or
affine on (jax.numpy's promotion). The result is bf16 where every reader of
the node rounds its operand to bf16 anyway, else float32.

A wrapper checks its operands (``x`` bf16, f16 or float32, the vectors
float32; else ValueError), then dispatches on the tensor's device: a CPU
tensor takes the plain PyTorch version (the unfused lowering's ops, one by
one), a CUDA tensor launches the kernel (building it on first use).
``LAUNCHES`` counts kernel launches by form.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .build import check, count_launch, load_library

LAUNCHES = {"bias": 0, "bare": 0, "channel_ln": 0}

# Channels a block of the channel_ln kernel holds (csrc/gelu.cu); the
# import pass bundles no wider channel LayerNorm.
MAX_CHANNELS = 512

# The activation types the kernels take, by the C entry points' ``in_type``,
# and the types they store.
_IN_TYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_OUT_TYPES = (torch.bfloat16, torch.float32)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _gelu_plain(v: torch.Tensor, c: float, divide: bool, half_first: bool) -> torch.Tensor:
    """The chain on float32 ``v`` as the lowerings run it: a divisor is a
    0-d tensor on ``v``'s device (a true division), the other constants
    Python numbers."""
    u = v / torch.full((), c, dtype=torch.float32, device=v.device) if divide else v * c
    e1 = torch.erf(u) + 1.0
    return (v * 0.5) * e1 if half_first else (v * e1) * 0.5


def rows(x: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """``(rows, cols, ld)``: ``x`` as rows of its last axis, row ``r`` at
    element ``r * ld`` (a view sliced along its last axis qualifies); None
    when its leading axes do not collapse so."""
    if x.ndim == 0 or x.numel() == 0:
        return None
    cols = x.shape[-1]
    if x.is_contiguous():
        return x.numel() // cols, cols, cols
    ld = x.stride(-2) if x.ndim > 1 else cols
    if x.stride(-1) != 1 or ld < cols or any(
            x.stride(i) != x.stride(i + 1) * x.shape[i + 1] for i in range(x.ndim - 2)):
        return None
    return x.numel() // cols, cols, ld


def _operand_checks(what: str, x: torch.Tensor, vecs, out_dtype: torch.dtype) -> None:
    """Raise ValueError unless ``x`` is a bf16, f16 or float32 tensor on the
    CPU or a CUDA device, every vector of ``vecs`` a float32 vector on
    ``x``'s device, and ``out_dtype`` bf16 or float32."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {x.device}")
    if x.dtype not in _IN_TYPES:
        raise ValueError(f"{what}: x is {x.dtype}; the kernel takes bfloat16, float16 or "
                         f"float32")
    if out_dtype not in _OUT_TYPES:
        raise ValueError(f"{what}: stores bfloat16 or float32, not {out_dtype}")
    for v in vecs:
        if v.dtype != torch.float32 or v.ndim != 1 or v.device != x.device:
            raise ValueError(f"{what}: takes float32 vectors on {x.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")


def bias_gelu_plain(x, bias, c, divide, half_first, out_dtype):
    """Plain version of :func:`bias_gelu`: the bias Add promotes to
    float32, the chain follows."""
    v = x.float() if bias is None else x.float() + bias
    return _gelu_plain(v, c, divide, half_first).to(out_dtype)


def channel_ln_gelu_plain(x, scale, shift, eps, c, divide, half_first, out_dtype):
    """Plain version of :func:`channel_ln_gelu`: LayerNormalization over
    the channels of ``x [N, C, T]`` as the lowering computes it (float32
    sums, statistics rounded to x's type, the float32 affine), then the
    chain."""
    xt = x.transpose(1, 2)
    mean = xt.float().mean(dim=-1, keepdim=True).to(x.dtype)
    var = xt.float().var(dim=-1, unbiased=False, keepdim=True).to(x.dtype)
    y = (xt - mean) * torch.rsqrt(var + eps)
    v = (y.float() * scale + shift).transpose(1, 2)
    return _gelu_plain(v, c, divide, half_first).to(out_dtype)


def bias_gelu(x: torch.Tensor, bias: Optional[torch.Tensor], c: float, divide: bool,
              half_first: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """``gelu(x + bias)`` (``bias`` None: ``gelu(x)``) of bf16, f16 or
    float32 ``x`` with the float32 ``bias`` vector broadcast over its last
    axis; ``c`` the chain's constant, dividing when ``divide``;
    ``out_dtype`` bf16 or float32. Contiguous, of the broadcast shape. Rows
    that do not collapse (:func:`rows`) are copied first."""
    _operand_checks("bias_gelu", x, [] if bias is None else [bias], out_dtype)
    shape = x.shape
    if bias is not None:
        try:
            shape = torch.broadcast_shapes(x.shape, bias.shape)
        except RuntimeError as e:
            raise ValueError(f"bias_gelu: x {tuple(x.shape)} and bias {tuple(bias.shape)} "
                             f"do not broadcast") from e
    if x.device.type == "cpu":
        return bias_gelu_plain(x, bias, c, divide, half_first, out_dtype)
    out = torch.empty(shape, dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    x = x.expand(shape)
    if x.ndim == 0:
        x = x.reshape(1)
    if rows(x) is None:
        x = x.contiguous()
    n_rows, cols, ld = rows(x)
    if bias is not None:
        bias = bias.expand(cols).contiguous()
    with torch.cuda.device(x.device):
        status = load_library().bn_bias_gelu(
            x.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            n_rows, cols, ld, _IN_TYPES[x.dtype], float(c), int(divide), int(half_first),
            int(out_dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    check(status, "bias_gelu kernel")
    count_launch(LAUNCHES, "bare" if bias is None else "bias")
    return out


def channel_ln_gelu(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float,
                    c: float, divide: bool, half_first: bool,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """``gelu(LayerNorm over C of x [N, C, T])`` of bf16, f16 or float32
    ``x`` with float32 ``scale``, ``shift`` ``[C]`` (C at most
    :data:`MAX_CHANNELS`) and ``eps``; the chain's constant ``c`` as for
    :func:`bias_gelu`. Contiguous ``[N, C, T]``; a strided ``x`` is copied
    first."""
    _operand_checks("channel_ln_gelu", x, [scale, shift], out_dtype)
    if x.ndim != 3 or any(v.shape[0] != x.shape[1] for v in (scale, shift)):
        raise ValueError(f"channel_ln_gelu: takes x [N, C, T] and scale, shift [C], got "
                         f"{tuple(x.shape)}, {tuple(scale.shape)}, {tuple(shift.shape)}")
    if x.shape[1] > MAX_CHANNELS:
        raise ValueError(f"channel_ln_gelu: {x.shape[1]} channels, the kernel holds at most "
                         f"{MAX_CHANNELS}")
    if x.device.type == "cpu":
        return channel_ln_gelu_plain(x, scale, shift, eps, c, divide, half_first, out_dtype)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    x, scale, shift = x.contiguous(), scale.contiguous(), shift.contiguous()
    n, ch, frames = x.shape
    with torch.cuda.device(x.device):
        status = load_library().bn_channel_ln_gelu(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(), n, ch, frames,
            _IN_TYPES[x.dtype], float(eps), float(c), int(divide), int(half_first),
            int(out_dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    check(status, "channel_ln_gelu kernel")
    count_launch(LAUNCHES, "channel_ln")
    return out
