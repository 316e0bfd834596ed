"""ONNX op → PyTorch lowering registry.

The counterpart of :mod:`birdnet_tpu.compiler.ops`, in the same section
order, so that each lowering stands where its JAX counterpart does:

- the ai.onnx core of the JAX file: trivial and elementwise ops, MatMul,
  Gemm, Einsum, Conv, ConvTranspose, the normalizations, pooling, shape
  manipulation, reductions, ``Celu``/``ThresholdedRelu``/``Shrink``/
  ``Trilu``/``EyeLike``, the signal ops (windows, ``MelWeightMatrix``,
  ``STFT``, ``DFT``) and the bitwise/sequence/norm extensions, with
  ``Scatter`` (the deprecated alias of ``ScatterElements``);
- the int8 set that post-training quantization (compiler/quantize.py)
  produces: ``QuantizeLinear``, ``DequantizeLinear``, ``QLinearConv``
  (symmetric int8 1x1 convs run the B3 kernel), ``QLinearMatMul``,
  ``_QLinearGemm``, ``ConvInteger``, ``MatMulInteger`` and
  ``DynamicQuantizeLinear``;
- the fused nodes of the import-time passes (the frontends run B1/B2 and
  the stage prefix runs B4 under ``fast``/``bf16``);
- control flow (``If``, ``Loop``, ``Scan``), the recurrences (``LSTM``,
  ``GRU``, ``RNN``), ``Resize``/``Upsample`` and ``Attention``/
  ``RotaryEmbedding``.

The long tail of the core (``ops_extended.py``, with
``SimplifiedLayerNormalization``, the one ai.onnx name of the JAX
package's ``ops_contrib.py``) registers into this table; the ai.onnx.ml
domain (``ops_ml.py``) and the com.microsoft contrib domain
(``ops_contrib.py``: the fused CNN epilogues, the QLinear* family, the
transformer ops, MatMulNBits and the generation ops) register into the
table keyed by (domain, name) (``contrib_op``); all three are imported at
this module's tail. A ``com.microsoft`` node takes its contrib lowering,
or the core one for the seven spellings that graduated into the core
opset (``_GRADUATED_MS_OPS``); any other name fails at import, naming it
with its domain.

Values in the interpreter's environment are torch tensors (activations and
float params) or host values: numpy arrays (small constants, shapes, axes)
and, for the types numpy cannot hold without ml_dtypes (bfloat16, float8,
int4/uint4), the codec's CPU ``WireTensor``, which a lowering receives as a
tensor on the forward's device (a 4-bit one as an ``Int4Tensor``, which
keeps its type). A lowering whose inputs are all host values answers with
host values (``op(..., fold=True)`` runs it on the host and hands back
numpy arrays, or ``WireTensor``s): the counterpart of the JAX
interpreter's trace-time constant fold, so that an exporter's shape chains
(``Shape → Gather → Unsqueeze → Concat → Reshape``) never touch the card.
A lowering that meets a tensor moves its numpy operands to that tensor's
device once per value (``_tensor``), never per call. No lowering reads a
device tensor back to the host: values the JAX package needs at compile
time (shapes, axes, pads, ``k``, ``depth``, Range's bounds, Resize's
scales) must be host values, and a device tensor there raises "must be a
compile-time constant", as a tracer does in JAX. The one written exception
is Loop's while form (a data-dependent trip count or condition, the JAX
lowering's ``lax.while_loop``): it reads its condition on the host once per
iteration (``HOST_READS``); the generation ops read their early stop once
per step in the same way. An If on a tensor condition runs both branches
and selects, so it reads nothing back.

Dtypes follow the JAX lowering's jax.numpy promotion (``_promoted``), with
three deliberate differences: ONNX int64 and float64 stay 64-bit (the JAX
package runs with x64 off and computes them as int32/float32),
uint16/uint32/uint64, which torch computes only in part, raise
``NotImplementedError`` naming the dtype where torch has no kernel, and a
4-bit value is held in an int8/uint8 container (torch has no 4-bit dtype).

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
``preferred_element_type``). Einsum and ConvTranspose follow the policies
as MatMul and Conv do.
"""

from __future__ import annotations

import functools
import math
import operator
import os
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..onnx.proto import DataType as _DT
from ..onnx.proto import (Int4Tensor, WireTensor, wire_bits, wire_from_bits,
                          wire_tensor)
from ..ops.cuda import gelu as _gelu_kernels
from ..ops.cuda.build import count_launch
from ..ops.cuda.qconv import EPILOGUE_ACTS as _EPILOGUE_ACTS
from ..ops.cuda.qconv import qconv1x1_requant

_REGISTRY: Dict[str, Callable] = {}

# Non-default-domain ops keyed by (domain, op_type): the ai.onnx.ml set of
# ops_ml.py (birdnet_tpu/compiler/ops.py:35-103).
_CONTRIB_REGISTRY: Dict[tuple, Callable] = {}


def _registered(fn, fold: bool):
    return _folding(fn) if fold else functools.wraps(fn)(
        lambda ctx, *args: _checked(fn, ctx, args))


def op(*names, fold: bool = False):
    """Register a lowering under ``names``. ``fold``: the lowering answers
    in numpy when every input is a host value (see ``_folding``)."""

    def deco(fn):
        impl = _registered(fn, fold)
        for n in names:
            _REGISTRY[n] = impl
        return impl

    return deco


def contrib_op(domain: str, *names, fold: bool = False):
    """Register a lowering under ``(domain, name)`` for each of ``names``."""

    def deco(fn):
        impl = _registered(fn, fold)
        for n in names:
            _CONTRIB_REGISTRY[(domain, n)] = impl
        return impl

    return deco


# com.microsoft contrib ops that graduated into the core opset with the
# same signature: only these fall back to the core table
# (birdnet_tpu/compiler/ops.py:60-74). A name-based fallback for the rest
# would mis-dispatch contrib ops whose contract differs from their core
# namesake (com.microsoft Attention and Unique).
_GRADUATED_MS_OPS = frozenset(
    {"Gelu", "LayerNormalization", "Trilu", "Range", "GridSample",
     "QuantizeLinear", "DequantizeLinear"}
)


# The internal nodes of the port's own import-time passes (``_FusedAttention``,
# compiler/fuse_attention.py; ``_FusedGelu``, compiler/fuse_gelu.py), which
# the JAX package does not have: looked up as core names, but left out of
# ``supported_ops()``, the JAX core table.
_PORT_REGISTRY: Dict[str, Callable] = {}


def get_lowering(op_type: str, domain: str = "") -> Callable:
    if domain in ("", "ai.onnx"):
        fn = _REGISTRY.get(op_type) or _PORT_REGISTRY.get(op_type)
    else:
        fn = _CONTRIB_REGISTRY.get((domain, op_type))
        if fn is None and domain == "com.microsoft" and op_type in _GRADUATED_MS_OPS:
            fn = _REGISTRY.get(op_type)
    if fn is None:
        name = f"{domain}.{op_type}" if domain else op_type
        raise NotImplementedError(
            f"ONNX op '{name}' is not supported by the birdnet_tpu_torch "
            f"compiler yet"
        )
    return fn


def supported_ops() -> List[str]:
    return sorted(_REGISTRY)


def supported_contrib_ops() -> List[str]:
    return sorted(f"{d}.{n}" for d, n in _CONTRIB_REGISTRY)


class OpContext:
    """Per-node lowering context. ``env`` is the enclosing value environment
    (fused nodes interpret their ``body`` against it); ``device`` is where
    the forward runs."""

    __slots__ = ("op_type", "attrs", "opset", "precision", "node_name",
                 "num_outputs", "env", "out_names", "device", "subgraph_consts")

    def __init__(self, op_type, attrs, opset=17, precision="fp32",
                 node_name="", num_outputs=1, env=None, out_names=(),
                 device=torch.device("cpu"), subgraph_consts=None):
        self.op_type = op_type
        self.attrs = attrs
        self.opset = opset
        self.precision = precision
        self.node_name = node_name
        self.num_outputs = num_outputs
        self.env = env if env is not None else {}
        # Positional output names ("" = omitted): a lowering may skip work
        # for an output the graph never binds (an ml classifier's labels).
        self.out_names = tuple(out_names)
        self.device = device
        # The forward's subgraph initializers on ``device``
        # (importer.subgraph_consts_to_device), or None.
        self.subgraph_consts = subgraph_consts

    def wants_output(self, position: int) -> bool:
        if not self.out_names:
            return True  # unknown: assume needed
        return position < len(self.out_names) and bool(self.out_names[position])

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def on(self, device) -> "OpContext":
        """A copy of this context for ``device``, without the forward's
        subgraph initializers, which lie on the forward's device."""
        return OpContext(self.op_type, self.attrs, self.opset, self.precision,
                         self.node_name, self.num_outputs, self.env,
                         self.out_names, torch.device(device))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _is_host(x) -> bool:
    """True for a host value (numpy or Python, or a CPU ``WireTensor``: a
    bfloat16, float8 or 4-bit value, which numpy cannot hold), the port's
    counterpart of the JAX package's compile-time static values."""
    return not isinstance(x, torch.Tensor) or (
        isinstance(x, WireTensor) and x.device.type == "cpu")


def _static_array(x, what: str) -> np.ndarray:
    """A value the JAX lowering needs at compile time, as numpy. A tensor
    on the card (data the forward computes) raises, as a tracer does in the
    JAX lowering: reading it back would sync every call and break a CUDA
    graph's capture. A CPU tensor is read."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"{what} must be a compile-time constant")
        return x.numpy()
    return np.asarray(x)


def _static_ints(x, what: str) -> List[int]:
    return [int(v) for v in _static_array(x, what).reshape(-1)]


def _static_int(x, what: str) -> int:
    return _static_ints(x, what)[0]


def _axis(axis: int, ndim: int) -> int:
    """``axis`` in ``[-ndim, ndim)`` as a non-negative axis. Any other axis
    raises numpy's ``AxisError`` (a ValueError and an IndexError), as jnp
    raises: adding the rank once would turn ``[-2 ndim, -ndim)`` into
    another axis."""
    if not -ndim <= axis < ndim:
        raise np.exceptions.AxisError(axis, ndim)
    return axis + ndim if axis < 0 else axis


def _attr_str(ctx, name, default):
    v = ctx.attr(name, default)
    return v.decode() if isinstance(v, bytes) else v


# Host arrays up to this size reach a device once per value and are shared
# (``_on_device``); larger ones are copied per use.
_SHARED_UPLOAD_MAX = 16 << 20


@functools.lru_cache(maxsize=4096)
def _device_array(raw: bytes, dtype: torch.dtype, shape, device) -> torch.Tensor:
    """The bytes ``raw`` as a tensor of ``dtype`` and ``shape`` on
    ``device``: viewed on the host, so that a bfloat16 or float8 value
    uploads as its bits."""
    if not raw:  # a tensor of no bytes has no stride to view by
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.from_numpy(np.frombuffer(raw, dtype=np.uint8).copy())
    return t.view(dtype).reshape(shape).to(device)


def _on_device(x, device) -> torch.Tensor:
    """``x`` as a tensor on ``device``. Host arrays (and a CPU
    ``WireTensor``, by its bits) are uploaded once per value and shared:
    callers never write to the result."""
    if isinstance(x, WireTensor) and x.device.type == "cpu":
        arr, dtype = wire_bits(x), x.dtype
    elif isinstance(x, torch.Tensor):
        return x.to(device)
    else:
        arr = np.asarray(x)  # np.ascontiguousarray would make a 0-d value 1-d
        dtype = _torch_dtype(arr.dtype)
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    if arr.nbytes > _SHARED_UPLOAD_MAX:
        return torch.from_numpy(arr.copy()).to(device).view(dtype)
    from ..ops.cuda.build import hold

    return hold(_device_array(arr.tobytes(), dtype, arr.shape,
                              torch.device(device)))


def _tensor(ctx: OpContext, x, device=None) -> torch.Tensor:
    """``x`` as a tensor on ``device`` (default: the forward's device). A
    host value reaches a CUDA device once per value (``_on_device``), so a
    forward uploads nothing per call after its first and a CUDA graph can
    capture it."""
    if isinstance(x, torch.Tensor) and not _is_host(x):
        return x
    device = torch.device(device if device is not None else ctx.device)
    if isinstance(x, WireTensor):
        return x.as_subclass(torch.Tensor) if device.type == "cpu" else _on_device(x, device)
    if device.type != "cpu":
        return _on_device(x, device)
    arr = np.asarray(x)
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr)
    return torch.from_numpy(arr)


def _device_of(ctx: OpContext, *xs) -> torch.device:
    return next((x.device for x in xs if isinstance(x, torch.Tensor)), ctx.device)


def _promoted(ctx: OpContext, *xs) -> List[torch.Tensor]:
    """Tensors of one common dtype, promoted as jax.numpy promotes arrays
    (a 0-d float32 constant lifts a bf16 tensor to float32, where torch's
    own rule would keep bf16)."""
    device = _device_of(ctx, *xs)
    ts = [_tensor(ctx, x, device) for x in xs]
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return [t if t.dtype == dtype else t.to(dtype) for t in ts]


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


_ONNX_TO_NP = {
    _DT.FLOAT: np.float32,
    _DT.DOUBLE: np.float64,
    _DT.FLOAT16: np.float16,
    _DT.INT32: np.int32,
    _DT.INT64: np.int64,
}

# birdnet_tpu/compiler/ops.py:156-174, with 64-bit types kept 64-bit.
_ONNX_TO_TORCH = {
    _DT.FLOAT: torch.float32,
    _DT.UINT8: torch.uint8,
    _DT.INT8: torch.int8,
    _DT.UINT16: torch.uint16,
    _DT.INT16: torch.int16,
    _DT.INT32: torch.int32,
    _DT.INT64: torch.int64,
    _DT.BOOL: torch.bool,
    _DT.FLOAT16: torch.float16,
    _DT.DOUBLE: torch.float64,
    _DT.UINT32: torch.uint32,
    _DT.UINT64: torch.uint64,
    _DT.BFLOAT16: torch.bfloat16,
    _DT.FLOAT8E4M3FN: torch.float8_e4m3fn,
    _DT.FLOAT8E4M3FNUZ: torch.float8_e4m3fnuz,
    _DT.FLOAT8E5M2: torch.float8_e5m2,
    _DT.FLOAT8E5M2FNUZ: torch.float8_e5m2fnuz,
}

# The 4-bit types: their range and their 8-bit container. torch has no
# 4-bit dtype: on the host an ``Int4Tensor`` carries the type.
_FOUR_BIT = {_DT.INT4: (-8, 7, torch.int8), _DT.UINT4: (0, 15, torch.uint8)}


def _four_bit(y: torch.Tensor, to: int) -> torch.Tensor:
    """A 4-bit result in its container: on the host (a fold, or the CPU
    forward) an ``Int4Tensor`` of type ``to``; on the card the plain
    container."""
    return wire_tensor(y, to) if y.device.type == "cpu" else y


def _onnx_dtype(code: int) -> torch.dtype:
    """The torch dtype of ONNX type ``code``; an unsupported one raises
    naming it."""
    dtype = _ONNX_TO_TORCH.get(code)
    if dtype is None:
        raise NotImplementedError(
            f"ONNX data type {code} has no torch dtype in birdnet_tpu_torch"
        )
    return dtype


_WIDE_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)


def _wide_unsigned(args) -> List[str]:
    found = set()
    for a in args:
        if isinstance(a, torch.Tensor):
            if a.dtype in _WIDE_UNSIGNED:
                found.add(str(a.dtype).replace("torch.", ""))
        elif isinstance(a, np.ndarray) and a.dtype in (np.uint16, np.uint32, np.uint64):
            found.add(str(a.dtype))
    return sorted(found)


def _wire_operand(ctx, a):
    """A host ``WireTensor`` argument as the operand a lowering takes: a
    bfloat16 or float8 one as a plain tensor on the forward's device (numpy
    cannot hold it, so no lowering reads it on the host); a 4-bit one there
    as an ``Int4Tensor``, which keeps its type."""
    if isinstance(a, Int4Tensor):
        if ctx.device.type == "cpu":
            return a
        return _on_device(a, ctx.device).as_subclass(Int4Tensor)
    return _tensor(ctx, a)


def _checked(fn, ctx, args):
    """``fn(ctx, *args)``, with host ``WireTensor`` arguments as their
    operands (``_wire_operand``) and torch's missing kernels for the wide
    unsigned types reported as such (torch computes uint16/32/64 only in
    part; the port computes them in no other dtype)."""
    if any(isinstance(a, WireTensor) and a.device.type == "cpu" for a in args):
        args = [_wire_operand(ctx, a) if isinstance(a, WireTensor) and a.device.type == "cpu"
                else a for a in args]
    try:
        return fn(ctx, *args)
    except NotImplementedError as e:
        wide = _wide_unsigned(args)
        if wide:
            raise NotImplementedError(
                f"ONNX {ctx.op_type} on {', '.join(wide)}: torch has no kernel "
                f"for it ({e})"
            ) from e
        raise


def _fold_result(o):
    """A lowering's CPU result as a host value: numpy, or for a result
    numpy cannot hold (bfloat16, float8) a ``WireTensor``; a 4-bit
    ``Int4Tensor`` stays one."""
    if not isinstance(o, torch.Tensor) or isinstance(o, WireTensor):
        return o
    if o.dtype in _WIRE_FLOAT_DTYPES:
        return wire_tensor(o)
    return o.numpy()


def _folding(fn):
    """The lowering ``fn``, answering with host values when every input is
    one: it runs on the host and its tensors come back as numpy arrays
    (what the JAX interpreter's trace-time fold gives), or, where numpy
    cannot hold them, as CPU ``WireTensor``s."""

    @functools.wraps(fn)
    def impl(ctx, *args):
        if all(_is_host(a) for a in args):
            return [_fold_result(o) for o in _checked(fn, ctx.on("cpu"), args)]
        return _checked(fn, ctx, args)

    return impl


# Precision policies (birdnet_tpu/compiler/ops.py:177-206).
_BF16_OPERAND_POLICIES = ("mixed", "fast", "bf16")
_NARROW_FLOATS = (torch.bfloat16, torch.float16)

# The nodes whose lowerings put a floating operand through ``_mxu_operands``
# (``_policy_operands``, ``_gemm``): under ``fast`` and ``bf16`` each rounds
# the inputs at these positions to bf16 before its product. The GELU
# bundling (compiler/fuse_gelu.py) stores bf16 for a chain that only these
# read.
BF16_OPERAND_INPUTS = {"Conv": (0,), "MatMul": (0, 1), "Gemm": (0, 1)}


def _mxu_operands(ctx: OpContext, *xs):
    """Apply the precision policy to matmul/conv operands. Under ``fp32``
    bfloat16 and float16 operands widen to float32: the JAX lowering's
    ``preferred_element_type=float32`` gives their exact products, float32
    sums and a float32 result."""
    if ctx.precision in _BF16_OPERAND_POLICIES:
        return tuple(
            x.to(torch.bfloat16) if x.is_floating_point() else x for x in xs
        )
    return tuple(x.float() if x.dtype in _NARROW_FLOATS else x for x in xs)


def _bf16_in_f32(*xs):
    """Floating operands rounded to bf16 and held in float32: an f32 product
    of them is the bf16 product with float32 sums."""
    return tuple(
        x.to(torch.bfloat16).float() if x.is_floating_point() else x for x in xs
    )


def _policy_operands(ctx: OpContext, *xs):
    """Conv-like operands under the policy: ``mixed`` holds bf16-rounded
    values in float32 (float32 sums, TF32 off), the others as
    ``_mxu_operands``."""
    if ctx.precision == "mixed" and all(x.is_floating_point() for x in xs):
        return _bf16_in_f32(*xs)
    return _mxu_operands(ctx, *xs)


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


def _jnp_mean(x: torch.Tensor, dims, keepdim: bool = True) -> torch.Tensor:
    """jnp.mean: bf16/float16 summed in float32 and rounded back once,
    integers and bool to float32, float32/float64 kept."""
    if not x.is_floating_point():
        return x.float().mean(dim=dims, keepdim=keepdim)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    return x.to(acc).mean(dim=dims, keepdim=keepdim).to(x.dtype)


def _jnp_var(x: torch.Tensor, dims, keepdim: bool = True) -> torch.Tensor:
    """jnp.var (population variance), promoted as _jnp_mean."""
    if not x.is_floating_point():
        return x.float().var(dim=dims, unbiased=False, keepdim=keepdim)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    return x.to(acc).var(dim=dims, unbiased=False, keepdim=keepdim).to(x.dtype)


# ---------------------------------------------------------------------------
# trivial / elementwise
# ---------------------------------------------------------------------------


@op("Identity")
def _identity(ctx, x):
    return [x]


@op("Dropout", fold=True)
def _dropout(ctx, x, ratio=None, training_mode=None):
    # Inference only: Dropout is identity; the optional mask is all True.
    outs = [x]
    if ctx.num_outputs > 1:
        outs.append(torch.ones(tuple(x.shape), dtype=torch.bool, device=_device_of(ctx, x)))
    return outs


_FLOAT8_DTYPES = (
    torch.float8_e4m3fn, torch.float8_e4m3fnuz,
    torch.float8_e5m2, torch.float8_e5m2fnuz,
)
_WIRE_FLOAT_DTYPES = (torch.bfloat16,) + _FLOAT8_DTYPES

# The bits XLA's float32 -> float8 conversion gives (ml_dtypes' too), which
# the JAX lowerings produce: round to nearest even, and past the largest
# finite value the format's overflow pattern. Per dtype: the magnitude
# from which a value overflows, whether that magnitude itself does (a tie
# rounds to even), the overflow and NaN bits (sign bit clear), and whether
# they carry the value's sign. torch's cast rounds the same way but
# saturates e4m3fn's overflows and spells e5m2's NaN 0x7F, so
# :func:`_to_float8` sets those bits itself.
#
# A NaN's sign is the one bit the host and the card compute differently:
# the host's float32 division keeps a NaN dividend's sign, the card's gives
# a NaN of its own. So a caller that divides names the dividend whose sign
# a NaN result takes (``nan_sign``), and both devices give the host's bits.
_FLOAT8_SPECIALS = {
    torch.float8_e4m3fn: (464.0, False, 0x7F, 0x7F, True),
    torch.float8_e4m3fnuz: (248.0, True, 0x80, 0x80, False),
    torch.float8_e5m2: (61440.0, True, 0x7C, 0x7E, True),
    torch.float8_e5m2fnuz: (61440.0, True, 0x80, 0x80, False),
}


def _to_float8(y: torch.Tensor, target: torch.dtype,
               nan_sign: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float32 ``y`` cast to a float8 ``target`` with XLA's overflow and
    NaN bits (:data:`_FLOAT8_SPECIALS`); a NaN takes the sign of
    ``nan_sign`` (default ``y``)."""
    limit, inclusive, overflow_bits, nan_bits, signed = _FLOAT8_SPECIALS[target]
    bits = y.to(target).view(torch.uint8)
    mag = y.abs()
    overflow = mag >= limit if inclusive else mag > limit

    def sign_of(t):
        return torch.signbit(t).to(torch.uint8) << 7 if signed else torch.zeros_like(bits)

    bits = torch.where(overflow, sign_of(y) | overflow_bits, bits)
    nan_sign = y if nan_sign is None else nan_sign
    bits = torch.where(torch.isnan(y), sign_of(nan_sign) | nan_bits, bits)
    return bits.view(target)


@op("Cast", fold=True)
def _cast(ctx, x):
    to = ctx.attr("to")
    if isinstance(to, (bytes, str)):
        # Opsets 1-5 spell the target as a STRING enum name ("FLOAT").
        name = to.decode() if isinstance(to, bytes) else to
        to = getattr(_DT, name.upper(), None)
        if to is None:
            raise ValueError(f"Cast: unknown legacy dtype name {name!r}")
    to = int(to)
    x = _tensor(ctx, x)
    if to in _FOUR_BIT:
        # 4-bit targets round and saturate per the ONNX spec
        # (birdnet_tpu/compiler/ops.py:245-250), into the 8-bit container.
        lo, hi, container = _FOUR_BIT[to]
        if x.is_floating_point():
            x = torch.round(x.float())
        return [_four_bit(x.clamp(lo, hi).to(container), to)]
    target = _onnx_dtype(to)
    if target in _FLOAT8_DTYPES:
        x = x.float()
        if int(ctx.attr("saturate", 1)):
            # Cast's opset-19 default saturate=1: clamp to the format's
            # finite range (unclamped, an overflow is nan for e4m3fn, inf
            # for e5m2).
            info = torch.finfo(target)
            x = x.clamp(float(info.min), float(info.max))
        return [_to_float8(x, target)]
    return [x.to(target)]


@op("CastLike", fold=True)
def _cast_like(ctx, x, like):
    """``x.astype(like.dtype)`` as jax.numpy converts: float8 targets take
    XLA's bits (no saturation), 4-bit ones (an ``Int4Tensor`` ``like``)
    truncate and saturate a float and wrap an integer into the 4-bit
    range."""
    x = _tensor(ctx, x)
    if isinstance(like, Int4Tensor):
        to = like.data_type
        lo, hi, container = _FOUR_BIT[to]
        if x.is_floating_point():
            y = torch.trunc(x.float()).clamp(lo, hi).to(container)
        else:
            nib = x.to(torch.int64) & 0x0F
            y = (torch.where(nib > hi, nib - 16, nib) if lo else nib).to(container)
        return [_four_bit(y, to)]
    dtype = like.dtype if isinstance(like, torch.Tensor) else _torch_dtype(np.asarray(like).dtype)
    if dtype in _FLOAT8_DTYPES:
        return [_to_float8(x.float(), dtype)]
    return [x.to(dtype)]


@op("Constant")
def _constant(ctx):
    for key in (
        "value", "sparse_value", "value_float", "value_int",
        "value_floats", "value_ints", "value_string", "value_strings",
    ):
        v = ctx.attr(key)
        if v is not None:
            if key == "value":
                return [v.to_numpy()]
            if key == "sparse_value":
                return [v.to_dense()]
            if key == "value_float":
                return [np.float32(v)]
            if key == "value_int":
                return [np.int64(v)]
            if key == "value_floats":
                return [np.asarray(v, dtype=np.float32)]
            if key == "value_string":
                return [np.asarray(v, dtype=object).reshape(())]
            if key == "value_strings":
                return [np.asarray(list(v), dtype=object)]
            return [np.asarray(v, dtype=np.int64)]
    raise ValueError("Constant node without a value attribute")


@op("ConstantOfShape")
def _constant_of_shape(ctx, shape):
    dims = _static_ints(shape, "ConstantOfShape shape")
    v = ctx.attr("value")
    if v is None:
        return [np.zeros(dims, dtype=np.float32)]
    fill = v.to_numpy()
    if isinstance(fill, WireTensor):
        bits = wire_bits(fill).reshape(-1)
        return [wire_from_bits(np.full(dims, bits[0], bits.dtype),
                               fill.data_type, dims)]
    return [np.full(dims, fill.reshape(-1)[0], dtype=fill.dtype)]


def _legacy_broadcast_b(ctx, a, b):
    """Opsets 1-6 binary-op broadcast (birdnet_tpu/compiler/ops.py:306-329):
    with ``broadcast=1`` B aligns to A starting at ``axis``; trailing
    singleton axes on B make numpy broadcasting reproduce that."""
    if ctx.opset > 6 or not int(ctx.attr("broadcast", 0) or 0):
        return b
    a_nd, b_nd = len(a.shape), len(b.shape)
    if b_nd == 0 or a_nd <= b_nd:
        return b
    axis = ctx.attr("axis")
    axis = a_nd - b_nd if axis is None else int(axis)
    if axis < 0:
        axis += a_nd
    trailing = a_nd - axis - b_nd
    if trailing < 0:
        raise ValueError(
            f"legacy broadcast axis {axis} leaves no room for a rank-"
            f"{b_nd} operand against rank {a_nd}"
        )
    return b.reshape(tuple(b.shape) + (1,) * trailing)


def _host_scalar(x):
    """``x`` as a 0-d numpy array if it is a host scalar, else None."""
    if isinstance(x, torch.Tensor):
        return None
    arr = np.asarray(x)
    return arr if arr.ndim == 0 else None


def _binary(torch_fn, scalar: bool = True):
    """Elementwise binary op (registered with ``fold=True``: two host
    operands answer in numpy). A host scalar beside a tensor rides along as
    a Python number when ``scalar`` (no device copy; a divisor never does,
    since torch multiplies by a scalar divisor's reciprocal); the result
    dtype follows jax.numpy's promotion of the two arrays."""

    def impl(ctx, a, b):
        b = _legacy_broadcast_b(ctx, a, b)
        sa, sb = _host_scalar(a), _host_scalar(b)
        if scalar and (sa is None) != (sb is None):
            t, s = (b, sa) if sa is not None else (a, sb)
            t = _tensor(ctx, t)
            dtype = torch.promote_types(t.dtype, _torch_dtype(s.dtype))
            t = t.to(dtype)
            return [torch_fn(s.item(), t) if sa is not None else torch_fn(t, s.item())]
        return [torch_fn(*_promoted(ctx, a, b))]

    return impl


def _div(a, b):
    # ONNX Div on integers truncates toward zero (lax.div); floats divide.
    if not a.is_floating_point() and not a.is_complex() and a.dtype != torch.bool:
        return torch.div(a, b, rounding_mode="trunc")
    return torch.div(a, b)


op("Add", fold=True)(_binary(operator.add))
op("Sub", fold=True)(_binary(operator.sub))
op("Mul", fold=True)(_binary(operator.mul))
op("Div", fold=True)(_binary(_div, scalar=False))
op("Equal", fold=True)(_binary(operator.eq))
op("Greater", fold=True)(_binary(operator.gt))
op("Less", fold=True)(_binary(operator.lt))
op("GreaterOrEqual", fold=True)(_binary(operator.ge))
op("LessOrEqual", fold=True)(_binary(operator.le))
op("And", fold=True)(_binary(torch.logical_and, scalar=False))
op("Or", fold=True)(_binary(torch.logical_or, scalar=False))
op("Xor", fold=True)(_binary(torch.logical_xor, scalar=False))
op("BitwiseAnd", fold=True)(_binary(operator.and_))
op("BitwiseOr", fold=True)(_binary(operator.or_))


@op("Pow", fold=True)
def _pow(ctx, a, b):
    """``jnp.power(a, b.astype(a.dtype))``: the result has the base's dtype
    (a float32 exponent does not lift a bf16 base)."""
    a = _tensor(ctx, a, _device_of(ctx, a, b))
    b = _legacy_broadcast_b(ctx, a, b)
    sb = _host_scalar(b)
    if sb is not None and a.is_floating_point():
        # The exponent rounded to the base's dtype, as astype rounds it.
        e = torch.tensor(sb.item(), dtype=torch.float64).to(a.dtype).item()
        return [torch.pow(a, e)]
    return [torch.pow(a, _tensor(ctx, b, a.device).to(a.dtype))]


@op("Mod", fold=True)
def _mod(ctx, a, b):
    # fmod=1: C fmod (the result takes the dividend's sign), which ONNX
    # mandates for floats; fmod=0: Python mod (the divisor's sign).
    a, b = _promoted(ctx, a, b)
    if int(ctx.attr("fmod", 0)):
        return [torch.fmod(a, b)]
    return [torch.remainder(a, b)]


@op("Min", fold=True)
def _min(ctx, *xs):
    ts = _promoted(ctx, *xs)
    r = ts[0]
    for x in ts[1:]:
        r = torch.minimum(r, x)
    return [r]


@op("Max", fold=True)
def _max(ctx, *xs):
    ts = _promoted(ctx, *xs)
    r = ts[0]
    for x in ts[1:]:
        r = torch.maximum(r, x)
    return [r]


@op("Sum", fold=True)
def _sum_op(ctx, *xs):
    ts = _promoted(ctx, *xs)
    r = ts[0]
    for x in ts[1:]:
        r = r + x
    return [r]


@op("Mean", fold=True)
def _mean_op(ctx, *xs):
    ts = _promoted(ctx, *xs)
    r = ts[0]
    for x in ts[1:]:
        r = r + x
    # A 0-d float32 divisor on the device: true division (a Python divisor
    # would multiply by its reciprocal), the dtype of r kept (or float32
    # for integers), as jax.numpy's weakly typed float gives it.
    return [r / _tensor(ctx, np.float32(len(xs)), r.device)]


def _unary(fn):
    def impl(ctx, x):
        return [fn(_tensor(ctx, x))]

    return impl


op("Sqrt", fold=True)(_unary(torch.sqrt))
op("Exp", fold=True)(_unary(torch.exp))
op("Log")(_unary(torch.log))
op("Abs", fold=True)(_unary(torch.abs))
op("Neg", fold=True)(_unary(torch.neg))
op("Floor", fold=True)(_unary(torch.floor))
op("Ceil", fold=True)(_unary(torch.ceil))
op("Round", fold=True)(_unary(torch.round))  # half to even, as jnp.round
op("Sign", fold=True)(_unary(torch.sign))
op("Not", fold=True)(_unary(torch.logical_not))
op("Reciprocal", fold=True)(_unary(lambda x: 1.0 / x))
op("Sin", fold=True)(_unary(torch.sin))
op("Cos", fold=True)(_unary(torch.cos))
op("Tan", fold=True)(_unary(torch.tan))
op("Asin", fold=True)(_unary(torch.asin))
op("Acos", fold=True)(_unary(torch.acos))
op("Atan", fold=True)(_unary(torch.atan))
op("Sinh", fold=True)(_unary(torch.sinh))
op("Cosh", fold=True)(_unary(torch.cosh))
op("Tanh", fold=True)(_unary(torch.tanh))
op("Erf", fold=True)(_unary(torch.erf))
op("Relu")(_unary(torch.relu))
op("Sigmoid")(_unary(torch.sigmoid))
# jax.nn.softplus is logaddexp(x, 0); torch's softplus returns x above 20.
op("Softplus", fold=True)(_unary(lambda x: torch.logaddexp(x, torch.zeros_like(x))))
op("Softsign", fold=True)(_unary(lambda x: x / (torch.abs(x) + 1)))
op("Mish", fold=True)(_unary(lambda x: x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))))
op("HardSwish", fold=True)(_unary(F.hardswish))
op("IsNaN", fold=True)(_unary(torch.isnan))


@op("IsInf", fold=True)
def _isinf(ctx, x):
    """IsInf with the spec's detect_negative/detect_positive halves."""
    x = _tensor(ctx, x)
    out = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    if int(ctx.attr("detect_positive", 1)):
        out = out | (x == math.inf)
    if int(ctx.attr("detect_negative", 1)):
        out = out | (x == -math.inf)
    return [out]


@op("LeakyRelu", fold=True)
def _leaky_relu(ctx, x):
    alpha = float(ctx.attr("alpha", 0.01))
    x = _tensor(ctx, x)
    return [torch.where(x >= 0, x, alpha * x)]


@op("PRelu", fold=True)
def _prelu(ctx, x, slope):
    x = _tensor(ctx, x, _device_of(ctx, x, slope))
    slope = _tensor(ctx, slope, x.device)
    if (ctx.opset <= 6 and slope.ndim == 1 and x.ndim > 2
            and slope.shape[0] == x.shape[1]):
        # Legacy dialect: a 1-D slope is per channel (NCHW axis 1).
        slope = slope.reshape((1, -1) + (1,) * (x.ndim - 2))
    xs, slope = _promoted(ctx, x, slope)
    return [torch.where(x >= 0, xs, slope * xs)]


@op("Elu", fold=True)
def _elu(ctx, x):
    alpha = float(ctx.attr("alpha", 1.0))
    x = _tensor(ctx, x)
    return [torch.where(x > 0, x, alpha * torch.expm1(x))]


@op("Selu", fold=True)
def _selu(ctx, x):
    alpha = float(ctx.attr("alpha", 1.6732632423543772))
    gamma = float(ctx.attr("gamma", 1.0507009873554805))
    x = _tensor(ctx, x)
    return [gamma * torch.where(x > 0, x, alpha * torch.expm1(x))]


@op("HardSigmoid", fold=True)
def _hard_sigmoid(ctx, x):
    alpha = float(ctx.attr("alpha", 0.2))
    beta = float(ctx.attr("beta", 0.5))
    return [torch.clamp(alpha * _tensor(ctx, x) + beta, 0.0, 1.0)]


@op("Gelu", fold=True)
def _gelu(ctx, x):
    approx = _attr_str(ctx, "approximate", "none")
    return [F.gelu(_tensor(ctx, x), approximate="tanh" if approx == "tanh" else "none")]


def _as_dtype_of(ctx, v, x: torch.Tensor) -> torch.Tensor:
    """``jnp.asarray(v, dtype=x.dtype)`` on x's device."""
    if _is_host(v):
        v = np.asarray(v)
        if v.dtype.kind == "f":
            v = v.astype(np.float64)
    return _tensor(ctx, v, x.device).to(x.dtype)


@op("Clip", fold=True)
def _clip(ctx, x, lo=None, hi=None):
    x = _tensor(ctx, x)
    if ctx.opset < 11:
        lo = ctx.attr("min", -3.402823e38)
        hi = ctx.attr("max", 3.402823e38)
    if lo is not None:
        x = torch.maximum(x, _as_dtype_of(ctx, lo, x))
    if hi is not None:
        x = torch.minimum(x, _as_dtype_of(ctx, hi, x))
    return [x]


@op("Where", fold=True)
def _where(ctx, cond, a, b):
    a, b = _promoted(ctx, a, b)
    return [torch.where(_tensor(ctx, cond, a.device).to(torch.bool), a, b)]


def _softmax_like(fn):
    def impl(ctx, x):
        x = _tensor(ctx, x)
        if ctx.opset >= 13:
            return [fn(x, int(ctx.attr("axis", -1)))]
        # opset < 13: flatten from axis, normalize over the flattened tail.
        axis = int(ctx.attr("axis", 1))
        if axis < 0:
            axis += x.ndim
        flat = x.reshape(tuple(x.shape[:axis]) + (-1,))
        return [fn(flat, -1).reshape(x.shape)]

    return impl


op("Softmax", fold=True)(_softmax_like(lambda x, d: torch.softmax(x, d)))
op("LogSoftmax", fold=True)(_softmax_like(lambda x, d: torch.log_softmax(x, d)))


# ---------------------------------------------------------------------------
# matmul / gemm / einsum
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


@op("Einsum", fold=True)
def _einsum(ctx, *xs):
    eq = "".join(str(_attr_str(ctx, "equation", "")).split())
    xs = _promoted(ctx, *xs)
    orig = xs[0].dtype
    y = torch.einsum(eq, *_policy_operands(ctx, *xs))
    return [_out_cast(ctx, y, orig)]


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


def _pad_spatial(x, pads, value=0.0):
    """``x`` padded by (lo, hi) per spatial dim; negative widths crop."""
    if not any(lo or hi for lo, hi in pads):
        return x
    return F.pad(x, [p for lo, hi in reversed(pads) for p in (lo, hi)], value=value)


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
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


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
        x = _pad_spatial(x, pads)
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
    x2, w2 = _policy_operands(ctx, x, w)  # mixed: float32 sums, TF32 off
    y = _conv_nd(x2, w2, strides, dilations, group, pads)
    y = _out_cast(ctx, y, orig)
    if b is not None:
        bias = _tensor(ctx, b, y.device).reshape((1, -1) + (1,) * nd)
        y = y + bias.to(y.dtype)
    return [y]


@op("ConvTranspose", fold=True)
def _conv_transpose(ctx, x, w, b=None):
    """Transposed convolution (ONNX weight ``[C_in, C_out/group, *k]``, the
    layout torch takes). torch's full output, ``(in - 1) * s + eff_k`` per
    dim, is cropped by the (lo, hi) pads and extended by ``output_padding``,
    which pads asymmetrically as the JAX lowering's transposed padding
    ``(eff_k - 1 - lo, eff_k - 1 - hi + output_padding)`` does. The pads
    come from ``pads`` or ``auto_pad`` as for Conv (``output_shape`` is not
    read, as in the JAX lowering). Under the policies as Conv: the JAX
    lowering convolves the operands as given, which raises under ``fast``
    once activations are bf16 (its weights stay float32); the port rounds
    both operands."""
    x = _tensor(ctx, x, _device_of(ctx, x, w))
    w = _tensor(ctx, w, x.device)
    nd = x.ndim - 2
    if nd not in _CONV_T:
        raise NotImplementedError(f"ConvTranspose over {nd} spatial dims")
    kernel = [int(k) for k in ctx.attr("kernel_shape", w.shape[2:])]
    strides = [int(s) for s in ctx.attr("strides", [1] * nd)]
    dilations = [int(d) for d in ctx.attr("dilations", [1] * nd)]
    group = int(ctx.attr("group", 1))
    output_padding = [int(p) for p in ctx.attr("output_padding", [0] * nd)]
    pads = _resolve_pads(ctx, x.shape[2:], kernel, strides, dilations)
    orig = x.dtype
    x2, w2 = _policy_operands(ctx, x, w)
    y = _CONV_T[nd](x2, w2, None, strides, 0, 0, group, dilations)
    y = _pad_spatial(y, [(-lo, -hi + op_)
                         for (lo, hi), op_ in zip(pads, output_padding)])
    y = _out_cast(ctx, y, orig)
    if b is not None:
        y = y + _tensor(ctx, b, y.device).reshape((1, -1) + (1,) * nd).to(y.dtype)
    return [y]


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


@op("BatchNormalization")
def _batchnorm(ctx, x, scale, bias, mean, var):
    """Inference-form BatchNormalization (graphs where import-time folding
    into the preceding Conv does not apply)."""
    if ctx.opset <= 6:
        # Legacy dialect (birdnet_tpu/compiler/ops.py:810-826): is_test,
        # consumed_inputs and momentum are ignorable for the single-output
        # inference form; the multi-output training form and spatial=0
        # (per-element statistics) raise as the JAX lowering does.
        if ctx.num_outputs > 1:
            raise NotImplementedError(
                "legacy BatchNormalization training form (multiple "
                "outputs, is_test=0) is not supported; inference-only "
                "framework"
            )
        if not int(ctx.attr("spatial", 1)):
            raise NotImplementedError(
                "legacy BatchNormalization spatial=0 is not supported"
            )
    eps = float(ctx.attr("epsilon", 1e-5))
    x = _tensor(ctx, x)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    scale, bias, mean, var = (
        _tensor(ctx, v, x.device).reshape(shape) for v in (scale, bias, mean, var)
    )
    inv = scale * torch.rsqrt(var + eps)
    return [x * inv + (bias - mean * inv)]


def _channel_param(ctx, v, x):
    return _tensor(ctx, v, x.device).reshape((1, -1) + (1,) * (x.ndim - 2))


@op("InstanceNormalization", fold=True)
def _instancenorm(ctx, x, scale, bias):
    eps = float(ctx.attr("epsilon", 1e-5))
    x = _tensor(ctx, x, _device_of(ctx, x, scale, bias))
    axes = tuple(range(2, x.ndim))
    mean, var = _jnp_mean(x, axes), _jnp_var(x, axes)
    y = _channel_param(ctx, scale, x) * (x - mean) * torch.rsqrt(var + eps)
    return [y + _channel_param(ctx, bias, x)]


@op("LayerNormalization", fold=True)
def _layernorm(ctx, x, scale, bias=None):
    """(x - mean) * rsqrt(var + eps) * scale + bias over the axes from
    ``axis``, with Mean and InvStdDev as extra outputs. As in the JAX
    lowering, the statistics keep x's dtype (``stash_type`` is not read) and
    a float32 scale lifts a bf16 activation's result to float32."""
    axis = int(ctx.attr("axis", -1))
    eps = float(ctx.attr("epsilon", 1e-5))
    x = _tensor(ctx, x, _device_of(ctx, x, scale, bias))
    axis = _axis(axis, x.ndim)
    axes = tuple(range(axis, x.ndim))
    mean, var = _jnp_mean(x, axes), _jnp_var(x, axes)
    inv = torch.rsqrt(var + eps)
    y, s = _promoted(ctx, (x - mean) * inv, scale)
    y = y * s
    if bias is not None:
        y, b = _promoted(ctx, y, bias)
        y = y + b
    outs = [y]
    if ctx.num_outputs > 1:
        outs.append(mean)
    if ctx.num_outputs > 2:
        outs.append(inv)
    return outs


@op("GroupNormalization", fold=True)
def _groupnorm(ctx, x, scale, bias):
    """Group statistics, then a per-channel scale and bias. Opset 18 gives
    one scale and bias per group, opset 21 one per channel: a per-group
    vector (before opset 21, ``num_groups`` entries for more channels)
    repeats over its group's channels. The JAX lowering reshapes it per
    channel and raises on broadcasting."""
    eps = float(ctx.attr("epsilon", 1e-5))
    groups = int(ctx.attr("num_groups"))
    x = _tensor(ctx, x, _device_of(ctx, x, scale, bias))
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.ndim))
    xg = (xg - _jnp_mean(xg, axes)) * torch.rsqrt(_jnp_var(xg, axes) + eps)
    y = xg.reshape(x.shape)

    def per_channel(v):
        v = _tensor(ctx, v, x.device).reshape(-1)
        if ctx.opset < 21 and v.shape[0] == groups != c:
            v = v.repeat_interleave(c // groups)
        return v.reshape((1, -1) + (1,) * (x.ndim - 2))

    return [y * per_channel(scale) + per_channel(bias)]


@op("LRN", fold=True)
def _lrn(ctx, x):
    size = int(ctx.attr("size"))
    alpha = float(ctx.attr("alpha", 1e-4))
    beta = float(ctx.attr("beta", 0.75))
    bias = float(ctx.attr("bias", 1.0))
    x = _tensor(ctx, x)
    half = size // 2
    sq = F.pad(x * x, [0, 0] * (x.ndim - 2) + [half, size - 1 - half])
    ssum = sq.unfold(1, size, 1).sum(-1)
    return [x / torch.pow(bias + (alpha / size) * ssum, beta)]


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------


def _pool_common(ctx, x):
    """Window geometry for the pools (birdnet_tpu/compiler/ops.py:913-956):
    ``(kernel, strides, dilations, pads, explicit_pads)`` per spatial dim.
    ``pads`` holds the ceil-mode extension; ``explicit_pads`` only what the
    attributes or auto_pad give, which AveragePool's ``count_include_pad``
    divisor counts (torch and onnxruntime clip the edge windows' divisors
    to real coverage)."""
    nd = x.ndim - 2
    kernel = [int(k) for k in ctx.attr("kernel_shape")]
    strides = [int(s) for s in ctx.attr("strides", [1] * nd)]
    dilations = [int(d) for d in ctx.attr("dilations", [1] * nd)]
    if any(v < 1 for v in kernel + strides + dilations):
        raise ValueError(
            f"pool kernel/strides/dilations must be >= 1, got "
            f"kernel={kernel} strides={strides} dilations={dilations}"
        )
    pads = _resolve_pads(ctx, x.shape[2:], kernel, strides, dilations)
    explicit_pads = pads
    if int(ctx.attr("ceil_mode", 0)):
        # Size the end padding so the window count matches ceil division,
        # except that a window starting in the right padding is dropped
        # (the ONNX opset-19 clarification, as torch and onnxruntime do).
        new_pads, new_explicit = [], []
        for i in range(nd):
            in_dim = x.shape[2 + i]
            eff_k = (kernel[i] - 1) * dilations[i] + 1
            lo, hi = pads[i]
            out_ceil = -(-(in_dim + lo + hi - eff_k) // strides[i]) + 1
            if (out_ceil - 1) * strides[i] >= lo + in_dim:
                out_ceil -= 1
            need = max(0, (out_ceil - 1) * strides[i] + eff_k - in_dim - lo)
            new_pads.append((lo, need))
            new_explicit.append((lo, min(hi, need)))
        pads = new_pads
        explicit_pads = new_explicit
    return kernel, strides, dilations, pads, explicit_pads


def _windows(x, kernel, strides, dilations):
    """The pooling windows of ``x`` as a view ``[N, C, *out, *kernel]``
    (kernel positions row-major), the counterpart of
    ``lax.conv_general_dilated_patches``."""
    for d in range(len(kernel)):
        eff = (kernel[d] - 1) * dilations[d] + 1
        x = x.unfold(2 + d, eff, strides[d])
        if dilations[d] > 1:
            x = x[..., ::dilations[d]]
    return x


def _window_sum(x, kernel, strides, dilations, pads):
    nd = len(kernel)
    w = _windows(_pad_spatial(x, pads), kernel, strides, dilations)
    return w.sum(dim=tuple(range(-nd, 0)))


def _lowest(dtype):
    return -math.inf if dtype.is_floating_point else torch.iinfo(dtype).min


@op("MaxPool", fold=True)
def _maxpool(ctx, x):
    """Max over windows padded with -inf (the integer minimum for integer
    inputs), ``SAME_*``, ``ceil_mode`` and dilations as the JAX lowering
    has them. The optional Indices output is the int64 position in the
    WHOLE input tensor flattened row-major (N and C included), or with the
    spatial block column-major under ``storage_order=1``; ties take the
    first valid kernel position in row-major scan order (ONNX Runtime's
    rule). torch's ``return_indices`` counts per plane, so the indices are
    computed as the JAX lowering computes them, from the windows."""
    x = _tensor(ctx, x)
    kernel, strides, dils, pads, _ = _pool_common(ctx, x)
    nd = x.ndim - 2
    if x.is_floating_point() and nd in (1, 2, 3):
        pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nd - 1]
        y = pool(_pad_spatial(x, pads, -math.inf), kernel, strides, 0, dils)
    else:
        y = _windows(_pad_spatial(x, pads, _lowest(x.dtype)), kernel, strides,
                     dils).amax(dim=tuple(range(-nd, 0)))
    if ctx.num_outputs == 1:
        return [y]
    # Indices: ±inf sanitized to the finite extremes for the index search
    # only (the values above are exact), a validity mask keeping the argmax
    # off padded cells even when a whole window ties at the minimum.
    if x.is_floating_point():
        fin = torch.finfo(x.dtype)
        xi, pad_val = x.clamp(fin.min, fin.max), fin.min
    else:
        xi, pad_val = x, torch.iinfo(x.dtype).min
    k_total = math.prod(kernel)
    patches = _windows(_pad_spatial(xi, pads, pad_val), kernel, strides, dils)
    out_sp = tuple(patches.shape[2:2 + nd])
    patches = patches.reshape(tuple(x.shape[:2]) + out_sp + (k_total,))
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=torch.float32, device=x.device)
    valid = _windows(_pad_spatial(ones, pads), kernel, strides, dils)
    valid = valid.reshape((1, 1) + out_sp + (k_total,)) > 0.5
    masked = torch.where(valid, patches, torch.full((), pad_val, dtype=x.dtype,
                                                    device=x.device))
    vmax = masked.amax(dim=-1, keepdim=True)
    k_best = torch.argmax((valid & (masked == vmax)).to(torch.uint8), dim=-1)

    n_b, n_c = x.shape[0], x.shape[1]
    base = (torch.arange(n_b, device=x.device).reshape((n_b,) + (1,) * (1 + nd)) * n_c
            + torch.arange(n_c, device=x.device).reshape((1, n_c) + (1,) * nd))
    spatial = [x.shape[2 + d] for d in range(nd)]

    def coord(d):
        k_stride = math.prod(kernel[d + 1:])
        off = (k_best // k_stride) % kernel[d]
        pos = torch.arange(out_sp[d], device=x.device) * strides[d] - pads[d][0]
        pos = pos.reshape((1, 1) + tuple(out_sp[d] if i == d else 1 for i in range(nd)))
        return pos + off * dils[d]

    if int(ctx.attr("storage_order", 0)):
        flat, stride = base * math.prod(spatial), 1
        for d in range(nd):
            flat = flat + coord(d) * stride
            stride *= spatial[d]
    else:
        flat = base
        for d in range(nd):
            flat = flat * spatial[d] + coord(d)
    return [y, flat.to(torch.int64)]


@op("MaxUnpool", fold=True)
def _max_unpool(ctx, x, indices, output_shape=None):
    """Inverse of MaxPool: the pooled values scattered back to their
    recorded positions (whole-tensor row-major flat indices, the MaxPool
    Indices convention), zeros elsewhere."""
    x = _tensor(ctx, x, _device_of(ctx, x, indices))
    idx = _tensor(ctx, indices, x.device).to(torch.int64)
    nd = x.ndim - 2
    kernel = [int(k) for k in ctx.attr("kernel_shape")]
    strides = [int(s) for s in ctx.attr("strides", [1] * nd)]
    pads_attr = [int(p) for p in ctx.attr("pads", [0] * (2 * nd))]
    if output_shape is not None:
        out_shape = _static_ints(output_shape, "MaxUnpool output_shape")
    else:
        out_shape = list(x.shape[:2]) + [
            (x.shape[2 + i] - 1) * strides[i] + kernel[i]
            - pads_attr[i] - pads_attr[nd + i]
            for i in range(nd)
        ]
    flat = x.new_zeros(math.prod(out_shape))
    flat = flat.index_put((idx.reshape(-1),), x.reshape(-1))
    return [flat.reshape(out_shape)]


@op("AveragePool", fold=True)
def _avgpool(ctx, x):
    """Window sums over zero padding divided by the count of cells each
    window covers: with ``count_include_pad`` the explicit padding counts
    and the ceil-mode overhang does not (torch's own divisor differs at the
    ceil edge), without it only the input's cells count."""
    x = _tensor(ctx, x)
    kernel, strides, dils, pads, explicit = _pool_common(ctx, x)
    ssum = _window_sum(x, kernel, strides, dils, pads)
    count_include_pad = int(ctx.attr("count_include_pad", 0))
    if count_include_pad and pads == explicit:
        return [ssum / _tensor(ctx, np.float32(math.prod(kernel)), x.device)]
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
    if count_include_pad:
        ones = _pad_spatial(ones, explicit, 1.0)
        pads = [(lo_t - lo_e, hi_t - hi_e)
                for (lo_t, hi_t), (lo_e, hi_e) in zip(pads, explicit)]
    return [ssum / _window_sum(ones, kernel, strides, dils, pads)]


@op("GlobalAveragePool")
def _global_avgpool(ctx, x):
    x = _tensor(ctx, x)
    return [x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)]


@op("GlobalMaxPool", fold=True)
def _global_maxpool(ctx, x):
    x = _tensor(ctx, x)
    return [x.amax(dim=tuple(range(2, x.ndim)), keepdim=True)]


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------


@op("Shape")
def _shape(ctx, x):
    shape = np.asarray(tuple(x.shape), dtype=np.int64)
    start = int(ctx.attr("start", 0))
    end = ctx.attr("end")
    return [shape[start: int(end) if end is not None else None]]


@op("Size")
def _size(ctx, x):
    return [np.int64(math.prod(x.shape))]


@op("Reshape")
def _reshape(ctx, x, shape=None):
    if shape is None:
        # Opsets 1-4 carry the target as a `shape` attribute.
        shape = ctx.attr("shape")
        if shape is None:
            raise ValueError("Reshape without a shape input or attribute")
    dims = _static_ints(shape, "Reshape shape")
    allowzero = int(ctx.attr("allowzero", 0))
    out = [x.shape[i] if d == 0 and not allowzero else d for i, d in enumerate(dims)]
    return [x.reshape(out)]


@op("Transpose")
def _transpose(ctx, x):
    perm = ctx.attr("perm")
    perm = [int(p) for p in perm] if perm is not None else list(range(x.ndim))[::-1]
    if isinstance(x, torch.Tensor):
        return [x.permute(perm)]
    return [np.transpose(x, perm)]


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
        return _static_ints(axes_input, "axes")
    axes = ctx.attr("axes")
    return [int(a) for a in axes] if axes is not None else None


@op("Squeeze")
def _squeeze(ctx, x, axes=None):
    """Drop the listed size-1 axes (attribute before opset 13, input from
    13; negative axes count from the end), or every size-1 axis when none
    are listed. A listed axis of another size raises, as jnp.squeeze does."""
    ax = _axes_arg(ctx, axes)
    if ax is None:
        ax = [i for i, d in enumerate(x.shape) if d == 1]
    ax = {_axis(a, x.ndim) for a in ax}
    bad = [a for a in ax if x.shape[a] != 1]
    if bad:
        raise ValueError(
            f"Squeeze axes {sorted(bad)} are not size-1 axes of shape "
            f"{tuple(x.shape)}"
        )
    shape = [d for i, d in enumerate(x.shape) if i not in ax]
    return [x.reshape(shape)]


@op("Unsqueeze")
def _unsqueeze(ctx, x, axes=None):
    ax = _axes_arg(ctx, axes)
    out_ndim = x.ndim + len(ax)
    for a in sorted(a + out_ndim if a < 0 else a for a in ax):
        x = x.unsqueeze(a) if isinstance(x, torch.Tensor) else np.expand_dims(x, a)
    return [x]


@op("Concat")
def _concat(ctx, *xs):
    axis = ctx.attr("axis")
    if axis is None and ctx.opset <= 3:
        axis = 1  # opsets 1-3: axis optional, default 1
    axis = int(axis)
    if all(_is_host(x) for x in xs):
        return [np.concatenate([np.asarray(x) for x in xs], axis=axis)]
    return [torch.cat(_promoted(ctx, *xs), dim=axis)]


@op("Split", fold=True)
def _split(ctx, x, split=None):
    x = _tensor(ctx, x)
    axis = int(ctx.attr("axis", 0))
    if axis < 0:
        axis += x.ndim
    if split is None:
        split = ctx.attr("split")
    if split is not None:
        sizes = _static_ints(split, "Split sizes")
        return list(torch.split(x, sizes, dim=axis))
    n = ctx.num_outputs
    total = x.shape[axis]
    size = -(-total // n)
    return [x.narrow(axis, min(i * size, total), max(0, min(size, total - i * size)))
            for i in range(n)]


def _slice_axis(x: torch.Tensor, ax: int, st: int, en: int, sp: int) -> torch.Tensor:
    """One axis of an ONNX Slice with its clamping (INT64_MAX/MIN sentinels
    included); torch slices take no negative step, so one reads the flipped
    axis."""
    dim = x.shape[ax]
    if sp > 0:
        st = max(st + dim, 0) if st < 0 else min(st, dim)
        en = max(en + dim, 0) if en < 0 else min(en, dim)
        return x[(slice(None),) * ax + (slice(st, en, sp),)]
    # Negative step: ONNX clamps start into [0, dim-1].
    st = max(st + dim, 0) if st < 0 else min(st, dim - 1)
    en = en + dim if -dim <= en < 0 else en
    picked = range(dim)[slice(st, None if en < 0 else en, sp)]
    if not picked:
        return x.narrow(ax, 0, 0)
    j0 = dim - 1 - picked[0]
    flipped = x.flip(ax)
    return flipped[(slice(None),) * ax + (slice(j0, j0 - sp * (len(picked) - 1) + 1, -sp),)]


@op("Slice", fold=True)
def _slice(ctx, x, starts=None, ends=None, axes=None, steps=None):
    x = _tensor(ctx, x)
    if ctx.opset < 10 or starts is None:
        starts, ends = ctx.attr("starts"), ctx.attr("ends")
        axes, steps = ctx.attr("axes"), None
    starts = _static_ints(starts, "Slice starts")
    ends = _static_ints(ends, "Slice ends")
    axes_l = list(range(len(starts))) if axes is None else _static_ints(axes, "Slice axes")
    steps_l = [1] * len(starts) if steps is None else _static_ints(steps, "Slice steps")
    for st, en, ax, sp in zip(starts, ends, axes_l, steps_l):
        x = _slice_axis(x, _axis(ax, x.ndim), st, en, sp)
    return [x]


def _index(ctx, indices, device, n: int) -> torch.Tensor:
    """Indices as int64 on ``device``, negative ones counted from ``n``."""
    idx = _tensor(ctx, indices, device).to(torch.int64)
    return torch.where(idx < 0, idx + n, idx)


def _take_fill(dtype: torch.dtype):
    """jnp.take's fill for an out-of-range index: NaN, the lowest signed
    integer, the highest unsigned one, True."""
    if dtype.is_floating_point or dtype.is_complex:
        return math.nan
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.max if dtype in (torch.uint8,) + _WIDE_UNSIGNED else info.min


def _checked_index(ctx, indices, device, n: int):
    """(indices as int64 on ``device``, negative ones counted from ``n``
    and out-of-range ones replaced by 0; the in-range mask, or None when
    host indices are all in range). The JAX lowering's jnp.take fills an
    out-of-range position instead of faulting, and so does the port: a
    CUDA index kernel would assert on it, e.g. in the untaken branch of an
    If whose condition is a tensor, where both branches run."""
    if _is_host(indices):
        arr = np.asarray(indices).astype(np.int64)
        arr = np.where(arr < 0, arr + n, arr)
        ok = (arr >= 0) & (arr < n)
        if ok.all():
            return _tensor(ctx, arr, device), None
        return _tensor(ctx, np.where(ok, arr, 0), device), _tensor(ctx, ok, device)
    idx = _index(ctx, indices, device, n)
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, idx, torch.zeros_like(idx)), ok


def _filled(out: torch.Tensor, ok, shape) -> torch.Tensor:
    if ok is None:
        return out
    fill = torch.full((), _take_fill(out.dtype), dtype=out.dtype, device=out.device)
    return torch.where(ok.reshape(shape), out, fill)


@op("Gather", fold=True)
def _gather(ctx, x, indices):
    x = _tensor(ctx, x, _device_of(ctx, x, indices))
    axis = _axis(int(ctx.attr("axis", 0)), x.ndim)
    idx, ok = _checked_index(ctx, indices, x.device, x.shape[axis])
    out = x.index_select(axis, idx.reshape(-1))
    out = out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape) + tuple(x.shape[axis + 1:]))
    return [_filled(out, ok, (1,) * axis + tuple(idx.shape) + (1,) * (x.ndim - axis - 1))]


@op("GatherElements", fold=True)
def _gather_elements(ctx, x, indices):
    x = _tensor(ctx, x, _device_of(ctx, x, indices))
    axis = _axis(int(ctx.attr("axis", 0)), x.ndim)
    idx, ok = _checked_index(ctx, indices, x.device, x.shape[axis])
    return [_filled(torch.gather(x, axis, idx), ok, tuple(idx.shape))]


@op("GatherND", fold=True)
def _gather_nd(ctx, x, indices):
    x = _tensor(ctx, x, _device_of(ctx, x, indices))
    idx = _tensor(ctx, indices, x.device).to(torch.int64)
    b = int(ctx.attr("batch_dims", 0))
    k = idx.shape[-1]
    n_batch = math.prod(x.shape[:b])
    xb = x.reshape((n_batch,) + tuple(x.shape[b:]))
    ib = idx.reshape(n_batch, -1, k)
    coords = [torch.where(ib[..., i] < 0, ib[..., i] + x.shape[b + i], ib[..., i])
              for i in range(k)]
    rows = torch.arange(n_batch, device=x.device).reshape(n_batch, 1)
    out = xb[(rows, *coords)]
    return [out.reshape(tuple(idx.shape[:-1]) + tuple(x.shape[b + k:]))]


def _row_major_strides(shape) -> List[int]:
    strides, acc = [], 1
    for d in reversed(shape):
        strides.append(acc)
        acc *= d
    return strides[::-1]


def _segment_fold(vals: torch.Tensor, seg: torch.Tensor, fn) -> torch.Tensor:
    """Inclusive segmented scan of ``vals`` (``seg`` sorted, equal values
    one segment) in ceil(log2 n) passes of fixed order: each element's last
    value of its segment is the segment's fold. The same elementwise ops in
    the same order on every device, so no result depends on an order of
    atomics."""
    d, n = 1, vals.shape[0]
    while d < n:
        same = seg[d:] == seg[:-d]
        vals = torch.cat([vals[:d], torch.where(same, fn(vals[:-d], vals[d:]), vals[d:])])
        d *= 2
    return vals


_SCATTER_REDUCE = {"add": "sum", "mul": "prod", "min": "amin", "max": "amax"}
_SCATTER_FOLD = {"add": torch.add, "mul": torch.mul}


def _scatter_flat(x: torch.Tensor, dest: torch.Tensor, upd: torch.Tensor,
                  reduction: str) -> torch.Tensor:
    """``x`` with ``upd`` scattered at the flat positions ``dest`` under an
    ONNX reduction. A float sum or product over repeated positions folds
    each position's updates by ``_segment_fold`` after a stable sort, so
    its bits do not depend on CUDA's order of atomics (the reduction's
    order differs from the JAX lowering's sequential one within float
    rounding); min, max and integer sums are exact in any order."""
    flat = x.reshape(-1)
    dest, upd = dest.reshape(-1), upd.reshape(-1).to(x.dtype)
    if reduction in ("none", None):
        return flat.index_put((dest,), upd).reshape(x.shape)
    if reduction not in _SCATTER_REDUCE:
        raise NotImplementedError(f"scatter reduction {reduction!r}")
    if reduction in _SCATTER_FOLD and x.is_floating_point() and dest.numel():
        seg, perm = torch.sort(dest, stable=True)
        folded = _segment_fold(upd[perm], seg, _SCATTER_FOLD[reduction])
        last = torch.ones_like(seg, dtype=torch.bool)
        last[:-1] = seg[1:] != seg[:-1]
        total = flat.shape[0]
        target = torch.where(last, seg, torch.full_like(seg, total))
        out = torch.cat([flat, flat.new_zeros(1)])
        out = out.scatter(0, target, _SCATTER_FOLD[reduction](out[seg], folded))
        return out[:total].reshape(x.shape)
    return flat.scatter_reduce(0, dest, upd, _SCATTER_REDUCE[reduction],
                               include_self=True).reshape(x.shape)


@op("ScatterElements", "Scatter", fold=True)
def _scatter_elements(ctx, x, indices, updates):
    """``Scatter`` is the deprecated (opset 9-10) spelling of the same op
    (birdnet_tpu/compiler/ops_extended.py:161)."""
    device = _device_of(ctx, x, indices, updates)
    x = _tensor(ctx, x, device)
    axis = _axis(int(ctx.attr("axis", 0)), x.ndim)
    idx = _index(ctx, indices, device, x.shape[axis])
    upd = _tensor(ctx, updates, device)
    strides = _row_major_strides(x.shape)
    dest = idx * strides[axis]
    for d in range(x.ndim):
        if d != axis:
            shape = [1] * x.ndim
            shape[d] = idx.shape[d]
            dest = dest + torch.arange(idx.shape[d], device=device).reshape(shape) * strides[d]
    return [_scatter_flat(x, dest, upd, _attr_str(ctx, "reduction", "none"))]


@op("ScatterND", fold=True)
def _scatter_nd(ctx, x, indices, updates):
    device = _device_of(ctx, x, indices, updates)
    x = _tensor(ctx, x, device)
    idx = _tensor(ctx, indices, device).to(torch.int64)
    k = idx.shape[-1]
    rows = idx.reshape(-1, k)
    slice_size = math.prod(x.shape[k:])
    strides = _row_major_strides(x.shape[:k])
    row_lin = torch.zeros(rows.shape[0], dtype=torch.int64, device=device)
    for i in range(k):
        c = rows[:, i]
        row_lin = row_lin + torch.where(c < 0, c + x.shape[i], c) * strides[i]
    dest = row_lin[:, None] * slice_size + torch.arange(slice_size, device=device)
    upd = _tensor(ctx, updates, device)
    return [_scatter_flat(x, dest, upd, _attr_str(ctx, "reduction", "none"))]


@op("Expand", fold=True)
def _expand(ctx, x, shape):
    dims = _static_ints(shape, "Expand shape")
    x = _tensor(ctx, x)
    return [torch.broadcast_to(x, np.broadcast_shapes(tuple(x.shape), tuple(dims)))]


@op("Tile", fold=True)
def _tile(ctx, x, repeats, legacy_axis=None):
    x = _tensor(ctx, x)
    if legacy_axis is not None:
        # Opsets 1-6: (input, tiles, axis), `tiles` repeats along `axis`.
        reps = [1] * x.ndim
        reps[_static_int(legacy_axis, "Tile axis")] = _static_int(repeats, "Tile tiles")
    else:
        reps = _static_ints(repeats, "Tile repeats")
    reps = [1] * (x.ndim - len(reps)) + list(reps)
    return [x.repeat(reps)]


@op("Pad", fold=True)
def _pad(ctx, x, pads=None, constant_value=None, axes=None):
    """constant, reflect, edge and wrap; negative pads crop; ``axes``
    (opset 18) names the padded axes. reflect/edge/wrap gather each padded
    axis by the index map numpy's own pad gives (any rank, any axis)."""
    x = _tensor(ctx, x)
    mode = _attr_str(ctx, "mode", "constant")
    if pads is None:
        pads_attr = ctx.attr("pads")
        if pads_attr is None:
            pads_attr = ctx.attr("paddings")  # opset 1's spelling
        if pads_attr is None:
            raise ValueError("Pad without pads input or pads/paddings attr")
        pads_l = [int(p) for p in pads_attr]
    else:
        pads_l = _static_ints(pads, "Pad pads")
    ax = _static_ints(axes, "Pad axes") if axes is not None else list(range(x.ndim))
    width = [(0, 0)] * x.ndim
    for i, a in enumerate(ax):
        width[a + x.ndim if a < 0 else a] = (pads_l[i], pads_l[i + len(ax)])
    if any(lo < 0 or hi < 0 for lo, hi in width):
        for d, (lo, hi) in enumerate(width):
            start = -lo if lo < 0 else 0
            stop = x.shape[d] + hi if hi < 0 else x.shape[d]
            x = x.narrow(d, start, max(0, stop - start))
        width = [(max(lo, 0), max(hi, 0)) for lo, hi in width]
    if mode == "constant":
        # opset < 11: the `value` attribute; from 11 the constant_value input.
        cv = ctx.attr("value", 0.0)
        if constant_value is not None:
            cv = _static_array(constant_value, "Pad constant_value").reshape(-1)
            cv = cv[0].item() if cv.size else 0
        return [F.pad(x, [p for lo, hi in reversed(width) for p in (lo, hi)], value=cv)]
    if mode not in ("reflect", "edge", "wrap"):
        raise ValueError(f"unsupported Pad mode {mode!r}")
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            src = np.pad(np.arange(x.shape[d]), (lo, hi), mode=mode)
            x = x.index_select(d, _tensor(ctx, src, x.device))
    return [x]


@op("Range")
def _range(ctx, start, limit, delta):
    s = _static_array(start, "Range start").reshape(())
    lim = _static_array(limit, "Range limit").reshape(())
    d = _static_array(delta, "Range delta").reshape(())
    if np.issubdtype(s.dtype, np.floating):
        # ONNX's length ceil((limit - start) / delta); k * delta + start in
        # float64, as the JAX lowering computes it.
        n = max(0, int(np.ceil((float(lim) - float(s)) / float(d))))
        return [(np.arange(n, dtype=np.float64) * float(d) + float(s)).astype(s.dtype)]
    return [np.arange(int(s), int(lim), int(d), dtype=s.dtype)]


@op("OneHot", fold=True)
def _onehot(ctx, indices, depth, values):
    """jax.nn.one_hot: indices equal to 0..depth-1 hit, every other index
    (negative ones too) gives the off value; values ``[off, on]``."""
    d = _static_int(depth, "OneHot depth")
    device = _device_of(ctx, indices, values)
    idx = _tensor(ctx, indices, device)
    vals = _tensor(ctx, values, device)
    axis = _axis(int(ctx.attr("axis", -1)), idx.ndim + 1)
    shape = [1] * (idx.ndim + 1)
    shape[axis] = d
    hit = idx.unsqueeze(axis) == torch.arange(d, device=device).reshape(shape)
    return [hit.to(vals.dtype) * (vals[1] - vals[0]) + vals[0]]


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def _reduce_axes(ctx, x, axes):
    """The axes a Reduce* node reduces (attribute before opset 18, input
    from 18), every axis when none are listed, or None for a no-op
    (``noop_with_empty_axes`` with no axes listed)."""
    ax = _axes_arg(ctx, axes)
    if not ax:
        if int(ctx.attr("noop_with_empty_axes", 0)):
            return None
        return tuple(range(x.ndim))
    bad = [a for a in ax if not -x.ndim <= a < x.ndim]
    if bad:
        # As jnp's reductions do: adding the rank once would turn -r-1 ..
        # -2r into another axis.
        raise ValueError(f"axis {bad[0]} is out of bounds for array of dimension {x.ndim}")
    return tuple(a + x.ndim if a < 0 else a for a in ax)


def _reduce(fn):
    def impl(ctx, x, axes=None):
        x = _tensor(ctx, x)
        ax = _reduce_axes(ctx, x, axes)
        if ax is None:
            return [x]
        return [fn(x, ax, bool(int(ctx.attr("keepdims", 1))))]

    return impl


def _prod(x, dims, keepdim):
    """Product over several axes (torch.prod takes one)."""
    rest = [d for d in range(x.ndim) if d not in dims]
    moved = x.permute(rest + list(dims)).reshape([x.shape[d] for d in rest] + [-1])
    y = moved.prod(dim=-1)
    if keepdim:
        y = y.reshape([1 if d in dims else x.shape[d] for d in range(x.ndim)])
    return y


def _float(x):
    return x if x.is_floating_point() else x.float()


op("ReduceSum", fold=True)(_reduce(lambda x, d, k: torch.sum(x, dim=d, keepdim=k)))
op("ReduceMax", fold=True)(_reduce(lambda x, d, k: torch.amax(x, dim=d, keepdim=k)))
op("ReduceMin", fold=True)(_reduce(lambda x, d, k: torch.amin(x, dim=d, keepdim=k)))
op("ReduceProd", fold=True)(_reduce(_prod))
op("ReduceL1", fold=True)(_reduce(lambda x, d, k: torch.sum(torch.abs(x), dim=d, keepdim=k)))
op("ReduceL2", fold=True)(_reduce(lambda x, d, k: torch.sqrt(torch.sum(x * x, dim=d, keepdim=k))))
op("ReduceLogSum", fold=True)(_reduce(lambda x, d, k: torch.log(torch.sum(x, dim=d, keepdim=k))))
op("ReduceLogSumExp", fold=True)(_reduce(
    lambda x, d, k: torch.logsumexp(_float(x), dim=d, keepdim=k)))


@op("ReduceSumSquare")
def _reduce_sum_square(ctx, x, axes=None):
    x = _tensor(ctx, x)
    ax = _reduce_axes(ctx, x, axes)
    if ax is None:
        return [x]
    keepdims = bool(int(ctx.attr("keepdims", 1)))
    return [torch.sum(x * x, dim=ax, keepdim=keepdims)]


@op("ReduceMean")
def _reduce_mean(ctx, x, axes=None):
    """Mean over the reduced axes, promoted as jnp.mean promotes: a bf16 or
    float16 input is summed and divided in float32 and the mean rounded back
    to its dtype once (under ``fast`` the activations are bf16), an integer
    or bool input gives float32, float32 and float64 keep their dtype."""
    x = _tensor(ctx, x)
    ax = _reduce_axes(ctx, x, axes)
    if ax is None:
        return [x]
    return [_jnp_mean(x, ax, bool(int(ctx.attr("keepdims", 1))))]


def _arg_reduce(fn):
    def impl(ctx, x):
        x = _tensor(ctx, x)
        axis = _axis(int(ctx.attr("axis", 0)), x.ndim)
        if int(ctx.attr("select_last_index", 0)):
            # torch.arg{max,min} give the FIRST tied index: flip the axis
            # and mirror the result for the last.
            y = x.shape[axis] - 1 - fn(x.flip(axis), dim=axis)
        else:
            y = fn(x, dim=axis)
        y = y.to(torch.int64)
        return [y.unsqueeze(axis) if int(ctx.attr("keepdims", 1)) else y]

    return impl


op("ArgMax", fold=True)(_arg_reduce(torch.argmax))
op("ArgMin", fold=True)(_arg_reduce(torch.argmin))


@op("TopK", fold=True)
def _topk(ctx, x, k=None):
    """The k largest (or smallest) along ``axis``, sorted, ties in index
    order (lower index first), as lax.top_k gives them: a stable sort,
    since torch.topk on CUDA leaves the order of ties open."""
    x = _tensor(ctx, x)
    if k is not None:
        kk = _static_int(k, "TopK k")
    else:
        k_attr = ctx.attr("k")  # opset < 10: a required attribute
        if k_attr is None:
            raise ValueError("TopK (opset<10) requires the k attribute")
        kk = int(k_attr)
    axis = _axis(int(ctx.attr("axis", -1)), x.ndim)
    largest = int(ctx.attr("largest", 1))
    vals, idxs = torch.sort(x, dim=axis, descending=bool(largest), stable=True)
    return [vals.narrow(axis, 0, kk), idxs.narrow(axis, 0, kk).to(torch.int64)]


@op("CumSum", fold=True)
def _cumsum(ctx, x, axis):
    ax = _static_int(axis, "CumSum axis")
    x = _tensor(ctx, x)
    if int(ctx.attr("reverse", 0)):
        x = x.flip(ax)
    y = torch.cumsum(x, dim=ax)
    if int(ctx.attr("exclusive", 0)):
        y = y - x  # as the JAX lowering computes it
    if int(ctx.attr("reverse", 0)):
        y = y.flip(ax)
    return [y]


# ---------------------------------------------------------------------------
# signal / misc
#
# Resize and Upsample (birdnet_tpu/compiler/ops.py:1566-1853). Source
# coordinates, nearest indices and the per-axis weight matrices are numpy,
# built on the host from the static shapes and attributes; each reaches the
# device once per value (``_on_device``), so a forward uploads nothing per
# call and reads nothing back.
# ---------------------------------------------------------------------------


def _resize_src_coords(d_in: int, d_out: int, scale: float, coord_mode: str) -> np.ndarray:
    """ONNX Resize output→input coordinate mapping (float, unclamped)."""
    i = np.arange(d_out, dtype=np.float64)
    if coord_mode == "half_pixel":
        return (i + 0.5) / scale - 0.5
    if coord_mode == "pytorch_half_pixel":
        return (i + 0.5) / scale - 0.5 if d_out > 1 else np.zeros(d_out)
    if coord_mode == "asymmetric":
        return i / scale
    if coord_mode == "align_corners":
        return i * ((d_in - 1) / (d_out - 1)) if d_out > 1 else np.zeros(d_out)
    if coord_mode == "half_pixel_symmetric":
        adjustment = d_out / (scale * d_in)
        center = d_in / 2.0
        offset = center * (1.0 - adjustment)
        return offset + (i + 0.5) / scale - 0.5
    raise NotImplementedError(
        f"Resize coordinate_transformation_mode {coord_mode!r} not supported"
    )


def _resize_nearest_idx(src: np.ndarray, d_in: int, nearest_mode: str) -> np.ndarray:
    if nearest_mode == "round_prefer_floor":
        idx = np.ceil(src - 0.5)
    elif nearest_mode == "round_prefer_ceil":
        idx = np.floor(src + 0.5)
    elif nearest_mode == "floor":
        idx = np.floor(src)
    elif nearest_mode == "ceil":
        idx = np.ceil(src)
    else:
        raise NotImplementedError(f"Resize nearest_mode {nearest_mode!r} not supported")
    return np.clip(idx.astype(np.int64), 0, d_in - 1)


def _keys_cubic(t, a: float, xp=np):
    """Keys cubic convolution kernel (ONNX cubic_coeff_a, default -0.75).
    Branchless, so ``xp`` may be numpy or torch."""
    at = xp.abs(t)
    w1 = ((a + 2.0) * at - (a + 3.0)) * at * at + 1.0
    w2 = (((at - 5.0) * at + 8.0) * at - 4.0) * a
    return xp.where(at <= 1.0, w1, xp.where(at < 2.0, w2, xp.zeros_like(at)))


def _resize_weight_matrix(d_in: int, src: np.ndarray, scale: float,
                          mode: str, *, antialias: bool,
                          exclude_outside: bool, cubic_a: float) -> np.ndarray:
    """[d_out, d_in] resampling weights for one axis, built on the host.

    ``antialias=1`` stretches the kernel by 1/scale on downscale (PIL/torch
    style, normalized); ``exclude_outside=1`` zeroes taps outside the input
    and renormalizes; otherwise out-of-range taps clamp to the edge
    (onnxruntime's exclude_outside=0 behaviour)."""
    support = 1.0 if mode == "linear" else 2.0
    kscale = max(1.0, 1.0 / scale) if antialias and scale < 1.0 else 1.0
    if kscale > 1.0:
        # Antialias border handling follows PIL/torch: the stretched window
        # clips to in-bounds taps and renormalizes.
        exclude_outside = True
    W = np.zeros((src.size, d_in), np.float64)
    for i, c in enumerate(src):
        j0 = int(np.ceil(c - support * kscale))
        j1 = int(np.floor(c + support * kscale))
        js = np.arange(j0, j1 + 1)
        t = (js - c) / kscale
        if mode == "linear":
            w = np.maximum(0.0, 1.0 - np.abs(t))
        else:
            w = _keys_cubic(t, cubic_a)
        if exclude_outside:
            w = w * ((js >= 0) & (js < d_in))
        total = w.sum()
        if total != 0.0:
            w = w / total
        np.add.at(W[i], np.clip(js, 0, d_in - 1), w)
    return W.astype(np.float32)


def _apply_axis_weights(ctx, x: torch.Tensor, axis: int, W: np.ndarray) -> torch.Tensor:
    """y[..., i, ...] = sum_j W[i, j] * x[..., j, ...] along ``axis``
    (float32 product, TF32 off; the original dtype restored)."""
    orig = x.dtype
    moved = x.movedim(axis, -1).float()
    y = torch.matmul(moved, _on_device(np.ascontiguousarray(W.T), x.device))
    return y.movedim(-1, axis).to(orig)


def _resize_axis(ctx, x: torch.Tensor, axis: int, src: np.ndarray, linear: bool,
                 nearest_mode: str) -> torch.Tensor:
    """Resample one axis of ``x`` by gathering at source coordinates ``src``."""
    d_in = x.shape[axis]
    if not linear:
        idx = _resize_nearest_idx(src, d_in, nearest_mode)
        return x.index_select(axis, _on_device(idx, x.device))
    # Linear: weights use the unclamped fractional offset; taps clamp to the
    # edge (ONNX Runtime's exclude_outside=0 behaviour).
    lo_f = np.floor(src)
    frac = (src - lo_f).astype(np.float32)
    lo = np.clip(lo_f.astype(np.int64), 0, d_in - 1)
    hi = np.clip(lo_f.astype(np.int64) + 1, 0, d_in - 1)
    shape = [1] * x.ndim
    shape[axis] = src.size
    w = _on_device(frac.reshape(shape), x.device).to(x.dtype)
    xl = x.index_select(axis, _on_device(lo, x.device))
    xh = x.index_select(axis, _on_device(hi, x.device))
    return xl + (xh - xl) * w


def _resize_tf_crop(ctx, x, roi, axes_l, out_shape, mode, nearest_mode):
    """``tf_crop_and_resize``: the normalized per-axis ROI [start..., end...]
    selects the crop; outputs whose source coordinate falls outside the
    input get ``extrapolation_value``. cubic raises, as in the JAX lowering."""
    if mode == "cubic":
        raise NotImplementedError("Resize tf_crop_and_resize with mode=cubic")
    if int(ctx.attr("antialias", 0)) or int(ctx.attr("exclude_outside", 0)):
        raise NotImplementedError(
            "Resize tf_crop_and_resize with antialias/exclude_outside"
        )
    if roi is None or not _is_host(roi):
        raise ValueError(
            "Resize tf_crop_and_resize requires a compile-time-constant roi"
        )
    roi_v = np.asarray(roi, dtype=np.float64).reshape(-1)
    n_ax = len(axes_l)
    if roi_v.size != 2 * n_ax:
        raise ValueError(
            f"Resize roi has {roi_v.size} elements, expected {2 * n_ax}"
        )
    extrap = float(ctx.attr("extrapolation_value", 0.0))
    linear = mode == "linear"
    any_oob = None  # broadcast [.., d_out, ..] bool over the resampled axes
    for pos, axis in enumerate(axes_l):
        d_in = x.shape[axis]
        d_out = out_shape[axis]
        start, end = roi_v[pos], roi_v[n_ax + pos]
        i = np.arange(d_out, dtype=np.float64)
        if d_out > 1:
            src = start * (d_in - 1) + i * (end - start) * (d_in - 1) / (
                d_out - 1
            )
        else:
            src = np.full(1, 0.5 * (start + end) * (d_in - 1))
        oob = (src < 0.0) | (src > d_in - 1)
        x = _resize_axis(ctx, x, axis, src, linear, nearest_mode)
        shape = [1] * x.ndim
        shape[axis] = d_out
        oob = oob.reshape(shape)
        any_oob = oob if any_oob is None else any_oob | oob
    if any_oob is not None:
        x = torch.where(_on_device(any_oob, x.device),
                        torch.full((), extrap, dtype=x.dtype, device=x.device), x)
    return [x]


@op("Resize", fold=True)
def _resize(ctx, x, roi=None, scales=None, sizes=None):
    x = _tensor(ctx, x)
    mode = _attr_str(ctx, "mode", "nearest")
    if ctx.opset < 11:
        # Opset-10 Resize has inputs (X, scales) and fixed legacy semantics:
        # asymmetric coordinates with floor-nearest, like Upsample.
        scales, roi = roi, None
        coord_mode = "asymmetric"
        nearest_mode = "floor"
    else:
        coord_mode = _attr_str(ctx, "coordinate_transformation_mode", "half_pixel")
        nearest_mode = _attr_str(ctx, "nearest_mode", "round_prefer_floor")
    # Per spec both attributes only affect linear/cubic interpolation.
    antialias = bool(int(ctx.attr("antialias", 0)))
    exclude_outside = bool(int(ctx.attr("exclude_outside", 0)))
    cubic_a = float(ctx.attr("cubic_coeff_a", -0.75))

    policy = _attr_str(ctx, "keep_aspect_ratio_policy", "stretch")
    if policy not in ("stretch", "not_larger", "not_smaller"):
        raise NotImplementedError(f"Resize keep_aspect_ratio_policy {policy!r} not supported")

    # Opset-18 axes attribute: scales/sizes apply only to the listed axes.
    axes_attr = ctx.attr("axes")
    if axes_attr is not None:
        axes_l = [int(a) + (x.ndim if int(a) < 0 else 0) for a in axes_attr]
    else:
        axes_l = list(range(x.ndim))

    in_shape = list(x.shape)
    if sizes is not None:
        sz = _static_ints(sizes, "Resize sizes")
        out_shape = list(in_shape)
        if policy != "stretch":
            # One uniform scale over the listed axes (min for not_larger,
            # max for not_smaller); targets are then rounded per the spec.
            ratios = [o / in_shape[ax] for ax, o in zip(axes_l, sz)]
            uniform = min(ratios) if policy == "not_larger" else max(ratios)
            for ax in axes_l:
                out_shape[ax] = int(np.round(uniform * in_shape[ax]))
        else:
            for ax, o in zip(axes_l, sz):
                out_shape[ax] = o
        # The coordinate transform uses the effective scale d_out/d_in.
        sc = [o / d for o, d in zip(out_shape, in_shape)]
    else:
        sc_sub = list(_static_array(scales, "Resize scales").astype(np.float64).reshape(-1))
        sc = [1.0] * x.ndim
        for ax, s in zip(axes_l, sc_sub):
            sc[ax] = s
        out_shape = [int(math.floor(d * s)) for d, s in zip(in_shape, sc)]

    if mode not in ("nearest", "linear", "cubic"):
        raise NotImplementedError(f"Resize mode {mode!r} not supported")

    if coord_mode == "tf_crop_and_resize":
        return _resize_tf_crop(ctx, x, roi, axes_l, out_shape, mode,
                               nearest_mode)

    linear = mode == "linear"
    for axis, (d_out, s) in enumerate(zip(out_shape, sc)):
        if d_out == x.shape[axis] and abs(s - 1.0) < 1e-12:
            continue
        src = _resize_src_coords(x.shape[axis], d_out, float(s), coord_mode)
        if mode == "cubic" or (
            linear and (exclude_outside or (antialias and s < 1.0))
        ):
            # General path: per-axis weight matrix (spec-exact Keys cubic
            # with cubic_coeff_a, antialias stretch, exclude_outside).
            W = _resize_weight_matrix(
                x.shape[axis], src, float(s), "linear" if linear else "cubic",
                antialias=antialias, exclude_outside=exclude_outside,
                cubic_a=cubic_a,
            )
            x = _apply_axis_weights(ctx, x, axis, W)
        else:
            x = _resize_axis(ctx, x, axis, src, linear, nearest_mode)
    return [x]


@op("Upsample", fold=True)
def _upsample(ctx, x, scales=None):
    """Legacy Upsample (deprecated at opset 10): asymmetric coordinates with
    floor-nearest, as ONNX Runtime implements it. Opsets <= 6 spell the
    scales as ``height_scale``/``width_scale`` attributes on NCHW images,
    opset 7 as the ``scales`` attribute, opset 9 as an input."""
    x = _tensor(ctx, x)
    mode = _attr_str(ctx, "mode", "nearest")
    if scales is None:
        scales = ctx.attr("scales")  # opset 7 spelling: attribute
    if scales is None and ctx.opset <= 6:
        h_scale = ctx.attr("height_scale")
        w_scale = ctx.attr("width_scale")
        if h_scale is None or w_scale is None:
            raise ValueError(
                "Upsample (opset<=6) requires height_scale and "
                "width_scale attributes"
            )
        scales = [1.0, 1.0, float(h_scale), float(w_scale)]
    if scales is None:
        raise ValueError("Upsample node carries no scales input or attribute")
    sc = _static_array(scales, "Upsample scales").astype(np.float64).reshape(-1)
    linear = mode in ("linear", "bilinear", "trilinear")
    for axis, s in enumerate(sc):
        d_in = x.shape[axis]
        d_out = int(math.floor(d_in * s))
        if d_out == d_in and s == 1.0:
            continue
        # The asymmetric mapping uses the original scale (x_src = x_out / s),
        # not d_in/d_out: they differ for a fractional d_in * s.
        src = _resize_src_coords(d_in, d_out, float(s), "asymmetric")
        x = _resize_axis(ctx, x, axis, src, linear, "floor")
    return [x]


@op("Celu", fold=True)
def _celu(ctx, x):
    alpha = float(ctx.attr("alpha", 1.0))
    x = _tensor(ctx, x)
    return [torch.clamp(x, min=0) + torch.clamp(alpha * torch.expm1(x / alpha), max=0)]


@op("ThresholdedRelu", fold=True)
def _thresholded_relu(ctx, x):
    alpha = float(ctx.attr("alpha", 1.0))
    x = _tensor(ctx, x)
    return [torch.where(x > alpha, x, 0.0)]


@op("Shrink", fold=True)
def _shrink(ctx, x):
    lambd = float(ctx.attr("lambd", 0.5))
    bias = float(ctx.attr("bias", 0.0))
    x = _tensor(ctx, x)
    return [torch.where(x < -lambd, x + bias, torch.where(x > lambd, x - bias, 0.0))]


@op("Trilu", fold=True)
def _trilu(ctx, x, k=None):
    x = _tensor(ctx, x)
    kk = _static_int(k, "Trilu k") if k is not None else 0
    return [torch.triu(x, kk) if int(ctx.attr("upper", 1)) else torch.tril(x, kk)]


@op("EyeLike", fold=True)
def _eyelike(ctx, x):
    dtype = ctx.attr("dtype")
    device = _device_of(ctx, x)
    dt = _ONNX_TO_TORCH[int(dtype)] if dtype is not None else (
        x.dtype if isinstance(x, torch.Tensor) else _torch_dtype(np.asarray(x).dtype))
    rows = torch.arange(x.shape[0], device=device).reshape(-1, 1)
    cols = torch.arange(x.shape[1], device=device).reshape(1, -1)
    return [(cols - rows == int(ctx.attr("k", 0))).to(dt)]


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


def _float8_zero_point(zero_point) -> Optional[torch.dtype]:
    """The float8 dtype of a zero point (a tensor or a ``WireTensor``),
    else None."""
    dtype = getattr(zero_point, "dtype", None)
    return dtype if dtype in _FLOAT8_DTYPES else None


@op("QuantizeLinear")
def _quantize_linear(ctx, x, scale, zero_point=None):
    """Saturating round-half-even(x / scale) + zero_point: per-tensor,
    per-axis or blocked. The target type comes from the zero point, the
    ``output_dtype`` attribute (opset 21) or defaults to uint8. A float8
    target (opset 19+; its zero point is 0 by the spec and unused, as in
    the JAX lowering) takes ``x / scale``, clamped to the format's finite
    range when ``saturate`` is 1 (the default), cast as XLA casts. A 4-bit
    zero point (an ``Int4Tensor``) saturates into [-8, 7] / [0, 15], held
    in its 8-bit container."""
    x = _tensor(ctx, x).float()
    out_dtype = _float8_zero_point(zero_point)
    if out_dtype is not None:
        zero_point = None
    four_bit = _FOUR_BIT.get(getattr(zero_point, "data_type", None))
    scale, zp = _qdq_scale_zp(ctx, x, scale, zero_point)
    if zp is not None:
        out_dtype = zp.dtype
    elif out_dtype is None and ctx.attr("output_dtype") is not None:
        code = int(ctx.attr("output_dtype"))
        out_dtype = _INT_TARGETS.get(code)
        if _ONNX_TO_TORCH.get(code) in _FLOAT8_DTYPES:
            out_dtype = _ONNX_TO_TORCH[code]
        if out_dtype is None:
            raise NotImplementedError(
                f"QuantizeLinear to ONNX type {code} is not ported to "
                f"birdnet_tpu_torch (ROADMAP A8)"
            )
    elif out_dtype is None:
        out_dtype = torch.uint8
    if out_dtype in _FLOAT8_DTYPES:
        y = x / scale.float()
        if int(ctx.attr("saturate", 1)):
            info = torch.finfo(out_dtype)
            y = y.clamp(float(info.min), float(info.max))
        return [_to_float8(y, out_dtype, nan_sign=x)]
    q = torch.round(x / scale.float())
    if zp is not None:
        q = q + zp.float()
    if four_bit is not None:
        lo, hi, _ = four_bit
    else:
        info = torch.iinfo(out_dtype)
        lo, hi = info.min, info.max
    return [q.clamp(lo, hi).to(out_dtype)]


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
    environment is visible, shadowed by the subgraph's own initializers
    (dense and sparse, densified here as the importer densifies the top
    graph's; float ones with an axis on the forward's device, as the
    importer holds the top graph's) and ``extra_env``.

    The forward decodes and uploads those initializers once and holds them
    for its life (``ctx.subgraph_consts``), so no If, Loop iteration or
    generation step uploads them again, and a captured CUDA graph reads
    tensors nothing else frees. A context without them (a bare one, or one
    moved to the host by ``OpContext.on``) decodes them here.

    The JAX package seeds only the dense ones, so a body that reads a
    sparse initializer passes its import-time reference check and fails
    when it runs; the port runs it."""
    from .importer import graph_consts_to_device, interpret_graph

    owned = (ctx.subgraph_consts or {}).get(id(graph))
    env = dict(ctx.env)
    if owned is not None and owned[0] is graph:
        env.update(owned[1])
    else:
        env.update(graph_consts_to_device(graph, ctx.device))
    if extra_env:
        env.update(extra_env)
    return interpret_graph(
        graph, ctx.opset, ctx.precision, env, [v.name for v in graph.output],
        device=ctx.device, subgraph_consts=ctx.subgraph_consts,
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
    from ..ops.cuda.build import hold

    with _PREFIX_TABLES_LOCK:
        hit = _PREFIX_TABLES.get(key)
        if hit is not None:
            _PREFIX_TABLES.move_to_end(key)
            return hold(hit[0])
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
    return hold(tables)


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


# ---------------------------------------------------------------------------
# control flow (birdnet_tpu/compiler/ops.py:2511-2781)
#
# A host condition or trip count decides on the host, as a static one does
# in the JAX lowering. A tensor one stays on the device: If runs both
# branches and selects with ``torch.where`` (the JAX lowering's
# ``lax.cond``), and Scan and Loop's for form run their steps in Python
# (``lax.scan``). The exceptions are Loop's while form
# (``lax.while_loop``), whose data-dependent condition or trip count is read
# on the host once per iteration, and the generation ops of
# ops_contrib.py, whose early stop is read once per step; ``HOST_READS``
# counts those reads under the op's name.
# ---------------------------------------------------------------------------

HOST_READS = {"Loop": 0, "GreedySearch": 0, "Sampling": 0, "BeamSearch": 0,
              "WhisperBeamSearch": 0}


def _host_truth(v) -> bool:
    return bool(np.asarray(v).reshape(-1)[0])


def _stack(ctx, parts) -> object:
    """Per-step values stacked on a new leading axis: numpy when every one
    is a host value, else a tensor."""
    if all(_is_host(p) for p in parts):
        return np.stack([np.asarray(p) for p in parts])
    return torch.stack(_promoted(ctx, *parts))


@op("If")
def _if(ctx, cond):
    """ONNX If. A host condition picks the branch on the host and only that
    branch runs. A tensor condition runs both branches and selects each
    output with ``torch.where`` on the condition: no host read, so a CUDA
    graph captures it. As with ``lax.cond``, the branches must then give
    outputs of one shape and dtype; a ValueError names the node otherwise.
    An op that faults on data its branch's guard excludes must therefore be
    safe on any data (Gather answers an out-of-range index as jnp.take
    does)."""
    if _is_host(cond):
        branch = (ctx.attr("then_branch") if _host_truth(cond)
                  else ctx.attr("else_branch"))
        return list(_run_subgraph(ctx, branch))
    then_out = _run_subgraph(ctx, ctx.attr("then_branch"))
    else_out = _run_subgraph(ctx, ctx.attr("else_branch"))
    pred = cond.reshape(-1)[0].to(torch.bool)
    outs = []
    for i, (a, b) in enumerate(zip(then_out, else_out)):
        a, b = _tensor(ctx, a, cond.device), _tensor(ctx, b, cond.device)
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(
                f"If node {ctx.node_name!r}: with a data-dependent condition "
                f"both branches must give output {i} one shape and dtype, got "
                f"{tuple(a.shape)} {a.dtype} and {tuple(b.shape)} {b.dtype}"
            )
        outs.append(torch.where(pred, a, b))
    return outs


def _loop_while(ctx, body, body_inputs, start_i, cond0, carried, max_trip):
    """Data-dependent Loop tail, the counterpart of ``lax.while_loop``:
    before each iteration the condition (and ``i < trip count``) is read on
    the host, one sync per iteration when it is a tensor on the card. A CUDA
    graph cannot capture that read. Scan outputs are rejected by the
    caller, as in the JAX lowering."""
    n = len(carried)
    bound = None
    if max_trip is not None:
        if _is_host(max_trip):
            mt = int(np.asarray(max_trip).reshape(()))
            # Exporters spell a pure `while cond` loop as trip_count =
            # INT64_MAX (torch.jit.script does): no bound.
            bound = None if mt >= 2**31 - 1 else mt
        else:
            bound = max_trip.reshape(()).to(torch.int64)
            # A negative runtime bound can only be such a sentinel wrapped
            # (the JAX lowering's int32 cast): no bound.
            bound = torch.where(bound < 0, torch.iinfo(torch.int64).max, bound)
    i, cond = start_i, cond0
    while True:
        keep = cond
        if bound is not None:
            if _is_host(bound):
                if i >= bound:
                    break
            else:
                keep = _tensor(ctx, keep, bound.device).reshape(()).to(torch.bool) & (i < bound)
        if _is_host(keep):
            go = _host_truth(keep)
        else:
            # The one read of a device value inside a lowering (a sync).
            count_launch(HOST_READS, "Loop")
            go = bool(keep.reshape(-1)[0])
        if not go:
            break
        extra = dict(zip(body_inputs, [np.int64(i), np.bool_(True)] + carried))
        outs = _run_subgraph(ctx, body, extra)
        cond = outs[0]
        carried = list(outs[1:1 + n])
        i += 1
    return carried


def _loop_is_for(body) -> bool:
    """True when the body's cond_out is a passthrough of cond_in (the
    exporter pattern for a plain ``for i in range(M)``): the loop can
    never terminate early."""
    if len(body.input) < 2:
        return False
    target = body.output[0].name
    src = body.input[1].name
    aliases = {src}
    for node in body.node:
        if node.op_type == "Identity" and node.input[0] in aliases:
            aliases.add(node.output[0])
    return target in aliases


def _loop_scan(ctx, body, body_inputs, m, v_initial, n_carried):
    """A for-form loop longer than the unroll limit, the counterpart of
    ``lax.scan``: the ``m`` steps run in Python with no host read, and the
    scan outputs are stacked."""
    carried = list(v_initial)
    scans = []
    for i in range(m):
        extra = dict(zip(body_inputs, [np.int64(i), np.bool_(True)] + carried))
        outs = _run_subgraph(ctx, body, extra)
        carried = list(outs[1:1 + n_carried])
        scans.append(outs[1 + n_carried:])
    return carried + [_stack(ctx, parts) for parts in zip(*scans)]


# For-loops at or under this trip count unroll on the host (constants fold
# per iteration, and bodies with iteration-dependent shapes stay legal);
# longer ones take the for form (``_loop_scan``).
_LOOP_UNROLL_LIMIT = 64


@op("Loop")
def _loop(ctx, trip_count=None, cond=None, *v_initial):
    """ONNX Loop, case for case as the JAX lowering: a host trip count and
    condition unroll (scan outputs stacked); a for-form body longer than
    ``_LOOP_UNROLL_LIMIT`` takes ``_loop_scan``; a tensor trip count or
    condition takes ``_loop_while``, also when a tensor ``cond_out`` turns
    up mid-unroll. Scan outputs on the while form raise
    NotImplementedError, as their length is unknowable at compile time in
    the JAX package.

    Body inputs: (iter_num, cond_in, *carried); outputs: (cond_out,
    *carried_out, *scan_outputs), scan outputs stacked on a new leading
    axis."""
    body = ctx.attr("body")
    n_carried = len(v_initial)
    n_scan = ctx.num_outputs - n_carried
    body_inputs = [vi.name for vi in body.input]

    dynamic = (trip_count is not None and not _is_host(trip_count)) or (
        cond is not None and not _is_host(cond)
    )
    if dynamic:
        if n_scan > 0:
            raise NotImplementedError(
                "Loop with a data-dependent trip count/condition and scan "
                "outputs (their stacked shape is unknowable at compile time)"
            )
        cond0 = cond if cond is not None else np.bool_(True)
        return _loop_while(
            ctx, body, body_inputs, 0, cond0, list(v_initial), trip_count
        )

    if cond is not None and not _host_truth(cond):
        # Initially-false condition: zero iterations.
        if n_scan > 0:
            raise NotImplementedError(
                "Loop with zero iterations and scan outputs (their shapes "
                "are unknowable without running the body)"
            )
        return list(v_initial)
    m = (
        _static_int(trip_count, "Loop trip count")
        if trip_count is not None
        else None
    )
    if m is not None and m > _LOOP_UNROLL_LIMIT and _loop_is_for(body):
        if m >= 2**31 - 1:
            # A for-form body can never terminate early, so an INT64_MAX
            # trip count is an infinite loop.
            raise NotImplementedError(
                f"Loop trip count {m} with a pass-through termination "
                f"condition is effectively infinite"
            )
        return _loop_scan(ctx, body, body_inputs, m, v_initial, n_carried)
    if m is not None and m > 256:
        raise NotImplementedError(
            f"Loop trip count {m} too large to unroll (and the body's "
            f"termination condition is not a plain for-loop passthrough)"
        )
    if m == 0:
        if n_scan > 0:
            raise NotImplementedError(
                "Loop with zero iterations and scan outputs (their shapes "
                "are unknowable without running the body)"
            )
        return list(v_initial)

    carried = list(v_initial)
    scan_outputs = None
    i = 0
    while m is None or i < m:
        if m is None and i >= 256:
            raise NotImplementedError(
                "Loop with no trip count ran >256 statically-true "
                "iterations at trace time (likely infinite)"
            )
        extra = dict(zip(body_inputs, [np.int64(i), np.bool_(True)] + carried))
        outs = _run_subgraph(ctx, body, extra)
        # Per the ONNX spec, iteration i's outputs are consumed even when
        # its cond_out is false (the break applies to iteration i+1).
        carried = list(outs[1:1 + n_carried])
        scans = outs[1 + n_carried:]
        if scan_outputs is None:
            scan_outputs = [[s] for s in scans]
        else:
            for dest, s in zip(scan_outputs, scans):
                dest.append(s)
        cond_out = outs[0]
        if not _is_host(cond_out):
            # The termination condition turned out data-dependent: the
            # remaining iterations take the while form.
            if n_scan > 0:
                raise NotImplementedError(
                    "Loop with a data-dependent termination condition and "
                    "scan outputs"
                )
            return _loop_while(
                ctx, body, body_inputs, i + 1, cond_out, carried, m
            )
        if not _host_truth(cond_out):
            break
        i += 1
    return carried + [_stack(ctx, parts) for parts in (scan_outputs or [])]


@op("Scan")
def _scan(ctx, *inputs):
    """ONNX Scan: a Python loop over the scan axis (the JAX lowering's
    ``lax.scan``), with ``scan_input_axes``/``directions`` and
    ``scan_output_axes``/``directions``.

    Node inputs: N initial state values then M scan inputs; body inputs
    mirror that; body outputs: N state values then K scan outputs."""
    body = ctx.attr("body")
    m_scan = int(ctx.attr("num_scan_inputs"))
    n_state = len(inputs) - m_scan
    if n_state < 0:
        raise ValueError("Scan: num_scan_inputs exceeds provided inputs")
    in_axes = [int(a) for a in ctx.attr("scan_input_axes", [0] * m_scan)]
    out_axes_attr = ctx.attr("scan_output_axes")
    in_dirs = [int(d) for d in ctx.attr("scan_input_directions", [0] * m_scan)]
    out_dirs_attr = ctx.attr("scan_output_directions")

    state = list(inputs[:n_state])
    xs = []
    for x, ax, d in zip(inputs[n_state:], in_axes, in_dirs):
        x = _tensor(ctx, x).movedim(ax, 0)
        xs.append(x.flip(0) if d else x)
    steps = xs[0].shape[0] if xs else 0
    body_input_names = [vi.name for vi in body.input]
    k_scan_out = len(body.output) - n_state
    if steps == 0 and k_scan_out:
        raise NotImplementedError("Scan over zero steps with scan outputs")
    per_step = []
    for t in range(steps):
        extra = dict(zip(body_input_names, state + [x[t] for x in xs]))
        outs = _run_subgraph(ctx, body, extra)
        state = list(outs[:n_state])
        per_step.append(outs[n_state:])
    results = state
    out_axes = [int(a) for a in (out_axes_attr or [0] * k_scan_out)]
    out_dirs = [int(d) for d in (out_dirs_attr or [0] * k_scan_out)]
    for k, (ax, d) in enumerate(zip(out_axes, out_dirs)):
        y = _tensor(ctx, _stack(ctx, [s[k] for s in per_step]))
        if d:
            y = y.flip(0)
        results.append(y.movedim(0, ax))
    return results


# ---------------------------------------------------------------------------
# recurrent ops (LSTM / GRU / RNN; birdnet_tpu/compiler/ops.py:2784-3037)
#
# The input projection X·Wᵀ for all time steps is one product under the
# policy's operand rounding (bf16 operands and float32 sums under mixed,
# fast and bf16; the JAX lowering's einsum gets bf16 passes from XLA's
# default precision on the TPU); a Python loop over T then runs the
# [B, H] × [H, G·H] recurrence in the carry's dtype, both directions of a
# bidirectional node in one batched product per step. cuDNN's RNN is not
# used: it has no clip, alpha/beta activations, input_forget or peepholes,
# and its GRU is only linear_before_reset=1.
# ---------------------------------------------------------------------------


def _rnn_act(name, alpha=None, beta=None):
    name = name.decode() if isinstance(name, bytes) else str(name)
    if name == "Sigmoid":
        return torch.sigmoid
    if name == "Tanh":
        return torch.tanh
    if name == "Relu":
        return lambda v: torch.clamp(v, min=0.0)
    if name == "LeakyRelu":
        a = 0.01 if alpha is None else float(alpha)
        return lambda v: torch.where(v >= 0, v, a * v)
    if name == "HardSigmoid":
        a = 0.2 if alpha is None else float(alpha)
        bb = 0.5 if beta is None else float(beta)
        return lambda v: torch.clamp(a * v + bb, 0.0, 1.0)
    if name == "Elu":
        a = 1.0 if alpha is None else float(alpha)
        return lambda v: torch.where(v > 0, v, a * (torch.exp(v) - 1.0))
    if name == "Softsign":
        return lambda v: v / (1.0 + torch.abs(v))
    if name == "Softplus":
        return lambda v: torch.logaddexp(v, torch.zeros_like(v))
    if name == "Affine":
        a = 1.0 if alpha is None else float(alpha)
        bb = 0.0 if beta is None else float(beta)
        return lambda v: a * v + bb
    if name == "ScaledTanh":
        a = 1.0 if alpha is None else float(alpha)
        bb = 1.0 if beta is None else float(beta)
        return lambda v: a * torch.tanh(bb * v)
    if name == "ThresholdedRelu":
        a = 1.0 if alpha is None else float(alpha)
        return lambda v: torch.where(v > a, v, torch.zeros_like(v))
    raise NotImplementedError(f"RNN activation {name!r} not supported")


_RNN_DEFAULT_ACTS = {"LSTM": ("Sigmoid", "Tanh", "Tanh"), "GRU": ("Sigmoid", "Tanh"),
                     "RNN": ("Tanh",)}


def _rnn_acts(ctx, kind: str, dirs: int):
    """One callable per activation slot, applied to ``[dirs, B, H]``: the
    same activation on both directions runs once; different ones run per
    direction."""
    names = ctx.attr("activations")
    alphas = ctx.attr("activation_alpha") or []
    betas = ctx.attr("activation_beta") or []
    per_dir = len(_RNN_DEFAULT_ACTS[kind])
    if not names:
        specs = [[(n, None, None) for n in _RNN_DEFAULT_ACTS[kind]]] * dirs
    else:
        per_dir = len(names) // dirs
        specs = []
        for d in range(dirs):
            row = []
            for k in range(per_dir):
                i = d * per_dir + k
                name = names[i].decode() if isinstance(names[i], bytes) else str(names[i])
                row.append((name, alphas[i] if i < len(alphas) else None,
                            betas[i] if i < len(betas) else None))
            specs.append(row)
    slots = []
    for k in range(per_dir):
        fns = [_rnn_act(*specs[d][k]) for d in range(dirs)]
        if all(specs[d][k] == specs[0][k] for d in range(dirs)):
            slots.append(fns[0])
        else:
            slots.append(lambda v, fns=fns: torch.stack([f(v[d]) for d, f in enumerate(fns)]))
    return slots


def _rnn_prepare(ctx, x, seq_lens):
    """Shared RNN-family plumbing: (x as [T, B, I], one flag per direction
    that says whether it runs reversed, the clip as a function)."""
    if int(ctx.attr("layout", 0)) == 1:  # [B, T, I] → [T, B, I]
        x = x.transpose(0, 1)
    direction = _attr_str(ctx, "direction", "forward")
    dirs = 2 if direction == "bidirectional" else 1
    if seq_lens is not None and direction != "forward":
        raise NotImplementedError(
            "sequence_lens with reverse/bidirectional RNNs"
        )
    rev = [direction == "reverse" or d == 1 for d in range(dirs)]
    clip = ctx.attr("clip")
    if clip is not None:
        c = float(clip)
        pre = lambda g: torch.clamp(g, -c, c)  # noqa: E731
    else:
        pre = lambda g: g  # noqa: E731
    return x, rev, pre


def _rnn_init(ctx, v, dirs: int, batch: int, hidden: int, dtype, device):
    """An initial state as ``[dirs, B, H]`` (layout 0 ``[dirs, B, H]``,
    layout 1 ``[B, dirs, H]``); zeros when absent."""
    if v is None:
        return torch.zeros((dirs, batch, hidden), dtype=dtype, device=device)
    v = _tensor(ctx, v, device)
    if int(ctx.attr("layout", 0)) == 1:
        v = v.transpose(0, 1)
    return v.to(dtype)


def _rnn_scan(xw, step_gates, h0, extra_carry, valid):
    """Run the recurrence over the input projections ``xw`` ``[D, T, B,
    G·H]``. ``step_gates(xw_t, h, extra) -> (h_new, new_extra)``; ``valid``
    (``[T, 1, B, 1]`` bool, or None) freezes the state and zeroes Y past
    each row's sequence length."""
    h, ex = h0, extra_carry
    ys = []
    for t in range(xw.shape[1]):
        h_new, ex_new = step_gates(xw[:, t], h, ex)
        if valid is not None:
            mask = valid[t]
            h_new = torch.where(mask, h_new, h)
            ex_new = tuple(torch.where(mask, n, o) for n, o in zip(ex_new, ex))
            ys.append(torch.where(mask, h_new, torch.zeros_like(h_new)))
        else:
            ys.append(h_new)
        h, ex = h_new, ex_new
    return torch.stack(ys, dim=1), h, ex


def _rnn_family(ctx, kind, x, w, r, b=None, seq_lens=None,
                initial_h=None, initial_c=None, p=None):
    n_gates = {"RNN": 1, "GRU": 3, "LSTM": 4}[kind]
    x = _tensor(ctx, x)
    dev = x.device
    w = _tensor(ctx, w, dev)
    r = _tensor(ctx, r, dev)
    hidden = int(ctx.attr("hidden_size", r.shape[-1]))
    x, rev, pre = _rnn_prepare(ctx, x, seq_lens)
    dirs = len(rev)
    steps, batch = x.shape[0], x.shape[1]
    gh = n_gates * hidden

    # The input projection of every step and direction: [D, T, B, G·H].
    x_d = torch.stack([x.flip(0) if rv else x for rv in rev])
    w_t = w.transpose(1, 2)  # [D, I, G·H]
    if ctx.precision in _BF16_OPERAND_POLICIES and x.is_floating_point():
        xw = _f32_sum_matmul(x_d.reshape(dirs, steps * batch, -1), w_t)
    else:
        xw = torch.matmul(x_d.reshape(dirs, steps * batch, -1), w_t.to(x.dtype))
    xw = xw.reshape(dirs, steps, batch, gh).to(x.dtype)
    if b is not None:
        bd = _tensor(ctx, b, dev)
        wb, rbias = bd[:, :gh], bd[:, gh:]
        xw = xw + wb[:, None, None, :]
    else:
        rbias = torch.zeros((dirs, gh), dtype=x.dtype, device=dev)
    # The carry takes the dtype h @ R promotes to (a float32 R lifts a bf16
    # input), so that every step keeps one dtype.
    dtype = torch.promote_types(xw.dtype, r.dtype)
    xw = xw.to(dtype)
    r_t = r.transpose(1, 2).to(dtype)  # [D, H, G·H]
    rbias = rbias.to(dtype)[:, None, :]  # [D, 1, G·H]
    acts = _rnn_acts(ctx, kind, dirs)
    h0 = _rnn_init(ctx, initial_h, dirs, batch, hidden, dtype, dev)
    valid = None
    if seq_lens is not None:
        lens = _tensor(ctx, seq_lens, dev).reshape(-1).to(torch.int64)
        t_idx = torch.arange(steps, device=dev)[:, None]
        valid = (t_idx < lens[None, :]).reshape(steps, 1, batch, 1)

    def split(g):
        return [g[..., k * hidden:(k + 1) * hidden] for k in range(n_gates)]

    cs = None
    if kind == "LSTM":
        f_act, g_act, h_act = acts
        c0 = _rnn_init(ctx, initial_c, dirs, batch, hidden, dtype, dev)
        peep = None
        if p is not None:
            # Peepholes: P[d] = [Pi, Po, Pf], elementwise against the cell
            # state inside the activation (and the clip).
            pd = _tensor(ctx, p, dev).to(dtype)[:, None, :]
            peep = (pd[..., :hidden], pd[..., hidden:2 * hidden], pd[..., 2 * hidden:])
        coupled = bool(int(ctx.attr("input_forget", 0)))

        def lstm_gates(xw_t, h, ex):
            (c,) = ex
            gi, go, gf, gc = split(xw_t + torch.bmm(h, r_t) + rbias)
            if peep is not None:
                gi, gf = gi + peep[0] * c, gf + peep[2] * c
            i_g = f_act(pre(gi))
            # input_forget couples the forget gate to the input gate
            # (f = 1 - i), as onnxruntime computes it.
            f_g = 1.0 - i_g if coupled else f_act(pre(gf))
            c_new = f_g * c + i_g * g_act(pre(gc))
            # Po couples against the new cell state (ONNX equations).
            if peep is not None:
                go = go + peep[1] * c_new
            o_g = f_act(pre(go))
            return o_g * h_act(c_new), (c_new,)

        ys, h_f, (c_f,) = _rnn_scan(xw, lstm_gates, h0, (c0,), valid)
        cs = c_f
    elif kind == "GRU":
        f_act, g_act = acts
        lbr = int(ctx.attr("linear_before_reset", 0))
        # The reset gate couples into the h-gate recurrence: the z and r
        # columns are one product, the h columns another.
        r_zr, r_h = r_t[..., :2 * hidden], r_t[..., 2 * hidden:]
        rb_zr, rb_h = rbias[..., :2 * hidden], rbias[..., 2 * hidden:]

        def gru_gates(xw_t, h, ex):
            if lbr:
                rec = torch.bmm(h, r_t) + rbias
                rec_zr, rec_h = rec[..., :2 * hidden], rec[..., 2 * hidden:]
            else:
                rec_zr = torch.bmm(h, r_zr) + rb_zr
            gz = f_act(pre(xw_t[..., :hidden] + rec_zr[..., :hidden]))
            gr = f_act(pre(xw_t[..., hidden:2 * hidden] + rec_zr[..., hidden:]))
            if lbr:
                gh_ = g_act(pre(xw_t[..., 2 * hidden:] + gr * rec_h))
            else:
                gh_ = g_act(pre(xw_t[..., 2 * hidden:] + torch.bmm(gr * h, r_h) + rb_h))
            return (1 - gz) * gh_ + gz * h, ()

        ys, h_f, _ = _rnn_scan(xw, gru_gates, h0, (), valid)
    else:  # RNN
        (act,) = acts

        def rnn_gates(xw_t, h, ex):
            return act(pre(xw_t + torch.bmm(h, r_t) + rbias)), ()

        ys, h_f, _ = _rnn_scan(xw, rnn_gates, h0, (), valid)
    if any(rev):
        ys = torch.stack([y.flip(0) if rv else y for y, rv in zip(ys, rev)])
    y = ys.transpose(0, 1)  # [T, dirs, B, H]
    y_h = h_f  # [dirs, B, H]
    layout = int(ctx.attr("layout", 0))
    if layout == 1:
        y = y.permute(2, 0, 1, 3)  # [B, T, dirs, H]
        y_h = y_h.transpose(0, 1)
    outs = [y, y_h]
    if kind == "LSTM":
        outs.append(cs.transpose(0, 1) if layout == 1 else cs)
    return outs


@op("LSTM")
def _lstm(ctx, x, w, r, b=None, seq_lens=None, initial_h=None,
          initial_c=None, p=None):
    """ONNX LSTM (gate order i, o, f, c), with peepholes (P)."""
    return _rnn_family(
        ctx, "LSTM", x, w, r, b, seq_lens, initial_h, initial_c, p
    )


@op("GRU")
def _gru(ctx, x, w, r, b=None, seq_lens=None, initial_h=None):
    """ONNX GRU (gate order z, r, h; both linear_before_reset modes)."""
    return _rnn_family(ctx, "GRU", x, w, r, b, seq_lens, initial_h)


@op("RNN")
def _rnn(ctx, x, w, r, b=None, seq_lens=None, initial_h=None):
    """ONNX vanilla RNN (one gate, default Tanh)."""
    return _rnn_family(ctx, "RNN", x, w, r, b, seq_lens, initial_h)


# ---------------------------------------------------------------------------
# signal ops
# ---------------------------------------------------------------------------


@op("HannWindow", "HammingWindow", "BlackmanWindow")
def _window(ctx, size):
    n = _static_int(size, f"{ctx.op_type} size")
    periodic = int(ctx.attr("periodic", 1))
    denom = n if periodic else n - 1
    w = 2.0 * np.pi * np.arange(n, dtype=np.float64) / denom
    if ctx.op_type == "HannWindow":
        out = 0.5 - 0.5 * np.cos(w)
    elif ctx.op_type == "HammingWindow":
        out = 25.0 / 46.0 - (21.0 / 46.0) * np.cos(w)
    else:  # BlackmanWindow
        out = 0.42 - 0.5 * np.cos(w) + 0.08 * np.cos(2.0 * w)
    dtype = _ONNX_TO_TORCH[int(ctx.attr("output_datatype", 1))]
    try:
        return [out.astype(torch.empty(0, dtype=dtype).numpy().dtype)]
    except TypeError:  # bf16 and float8 have no numpy dtype
        return [_tensor(ctx, out).to(dtype)]


@op("MelWeightMatrix")
def _mel_weight_matrix(ctx, num_mel_bins, dft_length, sample_rate,
                       lower_edge_hertz, upper_edge_hertz):
    """Triangular mel filterbank per the ONNX spec (HTK mel scale), built
    once per device and geometry."""
    from ..ops.cuda.build import hold

    return [hold(_mel_matrix(
        _static_int(num_mel_bins, "num_mel_bins"),
        _static_int(dft_length, "dft_length"),
        _static_int(sample_rate, "sample_rate"),
        float(_static_array(lower_edge_hertz, "lower_edge_hertz").reshape(-1)[0]),
        float(_static_array(upper_edge_hertz, "upper_edge_hertz").reshape(-1)[0]),
        int(ctx.attr("output_datatype", 1)),
        ctx.device,
    ))]


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
    step = _static_int(frame_step, "STFT frame_step")
    if frame_length is not None:
        flen = _static_int(frame_length, "STFT frame_length")
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
    from ..ops.cuda.build import hold

    basis = hold(_dft_basis(flen, bins, x.device))
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


@op("DepthToSpace", fold=True)
def _depth_to_space(ctx, x):
    x = _tensor(ctx, x)
    bs = int(ctx.attr("blocksize"))
    n, c, h, w = x.shape
    if _attr_str(ctx, "mode", "DCR") == "DCR":
        y = x.reshape(n, bs, bs, c // (bs * bs), h, w).permute(0, 3, 4, 1, 5, 2)
    else:
        y = x.reshape(n, c // (bs * bs), bs, bs, h, w).permute(0, 1, 4, 2, 5, 3)
    return [y.reshape(n, c // (bs * bs), h * bs, w * bs)]


@op("SpaceToDepth", fold=True)
def _space_to_depth(ctx, x):
    x = _tensor(ctx, x)
    bs = int(ctx.attr("blocksize"))
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return [y.reshape(n, c * bs * bs, h // bs, w // bs)]


# ---------------------------------------------------------------------------
# bitwise / sequence / norm extensions
# ---------------------------------------------------------------------------

op("BitwiseNot", fold=True)(_unary(torch.bitwise_not))
op("BitwiseXor", fold=True)(_binary(operator.xor))


@op("BitShift", fold=True)
def _bitshift(ctx, x, y):
    direction = _attr_str(ctx, "direction", None)
    x, y = _promoted(ctx, x, y)
    if direction == "LEFT":
        return [torch.bitwise_left_shift(x, y)]
    if direction == "RIGHT":
        return [torch.bitwise_right_shift(x, y)]
    raise ValueError(f"BitShift direction must be LEFT or RIGHT, got {direction!r}")


def _one_hot_of_argmax(x: torch.Tensor, axis: int) -> torch.Tensor:
    """One-hot (x's dtype) of the FIRST maximum along ``axis``."""
    idx = torch.argmax(x, dim=axis, keepdim=True)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    return (torch.arange(x.shape[axis], device=x.device).reshape(shape) == idx).to(x.dtype)


@op("Hardmax", fold=True)
def _hardmax(ctx, x):
    x = _tensor(ctx, x)
    if ctx.opset >= 13:
        return [_one_hot_of_argmax(x, _axis(int(ctx.attr("axis", -1)), x.ndim))]
    # opset < 13: coerce to 2-D from axis (as legacy Softmax), one-hot over
    # the flattened tail.
    axis = _axis(int(ctx.attr("axis", 1)), x.ndim)
    lead = math.prod(x.shape[:axis])
    return [_one_hot_of_argmax(x.reshape(lead, -1), 1).reshape(x.shape)]


@op("LpNormalization", fold=True)
def _lp_normalization(ctx, x):
    x = _tensor(ctx, x)
    axis = int(ctx.attr("axis", -1))
    p = int(ctx.attr("p", 2))
    if p == 1:
        norm = torch.sum(torch.abs(x), dim=axis, keepdim=True)
    elif p == 2:
        norm = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    else:
        raise NotImplementedError("LpNormalization requires p in {1, 2}")
    return [x / norm]


def _lp_root(s: torch.Tensor, p: int) -> torch.Tensor:
    return torch.sqrt(s) if p == 2 else torch.pow(s, 1.0 / p)


def _lp_power(x: torch.Tensor, p: int) -> torch.Tensor:
    return x * x if p == 2 else torch.pow(torch.abs(x), float(p))


@op("LpPool", fold=True)
def _lppool(ctx, x):
    x = _tensor(ctx, x)
    kernel, strides, dils, pads, _ = _pool_common(ctx, x)
    p = int(ctx.attr("p", 2))
    return [_lp_root(_window_sum(_lp_power(x, p), kernel, strides, dils, pads), p)]


@op("GlobalLpPool", fold=True)
def _global_lppool(ctx, x):
    x = _tensor(ctx, x)
    p = int(ctx.attr("p", 2))
    s = torch.sum(_lp_power(x, p), dim=tuple(range(2, x.ndim)), keepdim=True)
    return [_lp_root(s, p)]


@op("ReverseSequence", fold=True)
def _reverse_sequence(ctx, x, seq_lens):
    """The first ``seq_lens[b]`` elements along ``time_axis`` reversed per
    batch row, the rest passed through; the lengths are data, so the source
    positions are computed on the device."""
    x = _tensor(ctx, x, _device_of(ctx, x, seq_lens))
    batch_axis = int(ctx.attr("batch_axis", 1))
    time_axis = int(ctx.attr("time_axis", 0))
    lens = _tensor(ctx, seq_lens, x.device).to(torch.int64)[:, None]
    t = torch.arange(x.shape[time_axis], device=x.device)[None, :]
    src = torch.where(t < lens, lens - 1 - t, t)  # [batch, time]
    xb = x.movedim((batch_axis, time_axis), (0, 1))
    idx = src.reshape(tuple(src.shape) + (1,) * (xb.ndim - 2)).expand(xb.shape)
    return [torch.gather(xb, 1, idx).movedim((0, 1), (batch_axis, time_axis))]


@op("DFT", fold=True)
def _dft(ctx, x, dft_length=None, axis=None):
    """ONNX DFT (opset 17's attribute axis, opset 20's input axis): input
    ``[batch, d1, ..., dn, c]`` with c = 1 (real) or 2 (real, imag); output
    of the same rank with c = 2. ``onesided`` halves the transformed axis
    to ``n // 2 + 1`` (real input, forward only). float32 transforms, as in
    the JAX lowering."""
    x = _tensor(ctx, x)
    inverse = int(ctx.attr("inverse", 0))
    onesided = int(ctx.attr("onesided", 0))
    if axis is not None:
        ax = _static_int(axis, "DFT axis")
    elif ctx.opset >= 20:
        ax = -2
    else:
        ax = int(ctx.attr("axis", 1))
    if ax < 0:
        ax += x.ndim
    if ax == x.ndim - 1:
        raise ValueError("DFT axis cannot be the component (last) dimension")
    comp = x.shape[-1]
    if comp not in (1, 2):
        raise ValueError(f"DFT input last dim must be 1 or 2, got {comp}")
    n = _static_int(dft_length, "DFT dft_length") if dft_length is not None else x.shape[ax]
    out_dtype = x.dtype if x.is_floating_point() else torch.float32
    if onesided:
        if inverse:
            raise ValueError("DFT onesided=1 with inverse=1 is invalid")
        if comp == 2:
            raise NotImplementedError("DFT onesided=1 requires real input")
        spec = torch.fft.rfft(x[..., 0].float(), n=n, dim=ax)
    else:
        sig = x[..., 0].float() if comp == 1 else torch.complex(x[..., 0].float(),
                                                               x[..., 1].float())
        spec = (torch.fft.ifft if inverse else torch.fft.fft)(sig, n=n, dim=ax)
    return [torch.stack([spec.real, spec.imag], dim=-1).to(out_dtype)]


# ---------------------------------------------------------------------------
# attention family (opset 23; birdnet_tpu/compiler/ops.py:3336-3480)
#
# ONNX ``Attention`` keeps the plain chain, torch ops in the JAX lowering's
# order, not ``scaled_dot_product_attention``: for parity with the JAX
# package, whose lowering it follows op for op (the fused backends round and
# order the sums differently under bf16), and because the chain must be
# tapped (``qk_matmul_output_mode``). The port's internal ``_FusedAttention``
# node (compiler/fuse_attention.py: an exported MatMul -> Softmax -> MatMul
# chain) owes the JAX package no parity: on the card under the bfloat16
# policies it runs one flash-attention kernel, which keeps the [B, H, T, S]
# scores and probabilities on chip instead of passing them through device
# memory several times a layer (PyTorch's FlashAttention-2 kernel, the one
# ``sdpa_kernel(SDPBackend.FLASH_ATTENTION)`` selects); everywhere else it
# interprets the chain.
# ---------------------------------------------------------------------------

# Flash-attention kernels launched by ``_FusedAttention`` (a replay adds its
# capture's count, as for the port's own kernels).
ATTENTION_LAUNCHES = {"flash": 0}

# Head sizes the flash kernel takes.
_FLASH_HEAD_DIMS = range(8, 257, 8)


def _fused_attention(ctx, q, k, v):
    """``softmax(scale * Q K^T) V`` of an attention chain bundled at import
    (compiler/fuse_attention.py): Q and V ``[B, H, T, d]``, K ``[B, H, S,
    d]``, or ``[B, S, H, d]`` where ``k_perm`` is ``[0, 2, 3, 1]``.

    On a CUDA tensor under ``fast``/``bf16`` the three are rounded to bf16
    (the policy's product operands) and one flash-attention kernel runs
    (float32 sums and softmax inside, a bf16 output, the chain's output
    type under those policies); it takes no mask, no dropout and a head size
    of 8-256 in steps of 8. Every other case interprets ``body``, the chain
    as exported, identical to the unfused graph."""
    q = _tensor(ctx, q)
    k = _tensor(ctx, k, q.device)
    v = _tensor(ctx, v, q.device)
    if k.ndim == 4 and [int(p) for p in ctx.attr("k_perm")] == [0, 2, 3, 1]:
        k = k.transpose(1, 2)  # [B, S, H, d] -> [B, H, S, d]
    if not (q.is_cuda and ctx.precision in ("fast", "bf16") and q.ndim == 4
            and q.shape[-1] in _FLASH_HEAD_DIMS and k.ndim == 4 and k.shape == v.shape
            and k.shape[:2] == q.shape[:2] and k.shape[3] == q.shape[3]):
        return list(_run_subgraph(ctx, ctx.attr("body")))
    q, k, v = _mxu_operands(ctx, q, k, v)
    out = torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, False, False, scale=float(ctx.attr("scale")))[0]
    count_launch(ATTENTION_LAUNCHES, "flash")
    return [out]


_PORT_REGISTRY["_FusedAttention"] = _registered(_fused_attention, False)


# The port's internal ``_FusedGelu`` node (compiler/fuse_gelu.py: an exported
# exact-erf GELU chain with the bias Add or channel LayerNorm that feeds it)
# runs one kernel of csrc/gelu.cu on the card under the bfloat16 policies,
# with the chain's own arithmetic; everywhere else it interprets the chain.
# ``GELU_LAUNCHES`` counts its launches by form (a replay adds its capture's
# count, as for the port's other kernels).
GELU_LAUNCHES = _gelu_kernels.LAUNCHES


def _fused_gelu(ctx, x, *operands):
    """``0.5 v (1 + erf(v / sqrt 2))`` of ``v = x + b`` (inputs ``[x, b]``),
    of ``v`` the LayerNorm of ``x [N, C, T]`` over its channels (``[x,
    scale, shift]``) or of ``v = x`` (``[x]``), bundled at import.

    On a CUDA tensor under ``fast``/``bf16``, one launch of the kernel
    (``ops/cuda/gelu.py``) computes the chain's steps in their order and
    precision and stores bf16 where every reader rounds its operand to bf16
    (``bf16_out``), else float32, the chain's type; operands the kernel
    does not take raise there. On the CPU and under ``fp32`` and ``mixed``,
    which compute another function, it interprets ``body``, identical to
    the unfused graph."""
    x = _tensor(ctx, x)
    if not (x.is_cuda and ctx.precision in ("fast", "bf16")):
        return list(_run_subgraph(ctx, ctx.attr("body")))
    vecs = [_tensor(ctx, v, x.device) for v in operands]
    args = (float(ctx.attr("c")), bool(ctx.attr("divide")), bool(ctx.attr("half_first")),
            torch.bfloat16 if int(ctx.attr("bf16_out")) else torch.float32)
    if len(vecs) == 2:
        return [_gelu_kernels.channel_ln_gelu(x, *vecs, float(ctx.attr("epsilon")), *args)]
    return [_gelu_kernels.bias_gelu(x, vecs[0] if vecs else None, *args)]


_PORT_REGISTRY["_FusedGelu"] = _registered(_fused_gelu, False)


def _acc_product(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the policy's operands (``_mxu_operands``) and the
    JAX lowering's ``preferred_element_type=_acc_dtype``: float32 sums of
    bf16 operands under mixed and fast, bf16 under bf16."""
    if ctx.precision in ("mixed", "fast") and a.is_floating_point() and b.is_floating_point():
        return _f32_sum_matmul(a, b)
    a2, b2 = _mxu_operands(ctx, a, b)
    return torch.matmul(a2, b2)


@op("Attention")
def _attention(ctx, q, k, v, attn_mask=None, past_key=None, past_value=None):
    """ONNX Attention (opset 23): scaled dot-product attention with an
    optional mask, causality, GQA, a KV cache and softcap.

    Q/K/V are 4-D [B, heads, seq, head] or 3-D [B, seq, heads*head] (the
    3-D form needs q_num_heads/kv_num_heads). The order is the ONNX
    reference's: QK*scale, then the causal/mask bias, softcap, softmax, ·V;
    ``qk_matmul_output_mode`` 0-3 taps the chain after each step.
    present_key/present_value are K/V after the cache concat, before any
    GQA head repetition."""
    q = _tensor(ctx, q)
    dev = q.device
    k = _tensor(ctx, k, dev)
    v = _tensor(ctx, v, dev)
    three_d = q.ndim == 3
    if three_d:
        qh = ctx.attr("q_num_heads")
        kvh = ctx.attr("kv_num_heads")
        if qh is None or kvh is None:
            raise ValueError(
                "Attention with 3D inputs requires q_num_heads/kv_num_heads"
            )
        qh, kvh = int(qh), int(kvh)
        b, qs = q.shape[0], q.shape[1]
        q = q.reshape(b, qs, qh, q.shape[2] // qh).permute(0, 2, 1, 3)
        k = k.reshape(b, k.shape[1], kvh, k.shape[2] // kvh).permute(0, 2, 1, 3)
        v = v.reshape(b, v.shape[1], kvh, v.shape[2] // kvh).permute(0, 2, 1, 3)
    if past_key is not None:
        k = torch.cat([_tensor(ctx, past_key, dev).to(k.dtype), k], dim=2)
    if past_value is not None:
        v = torch.cat([_tensor(ctx, past_value, dev).to(v.dtype), v], dim=2)
    present_k, present_v = k, v
    n_q_heads, n_kv_heads = q.shape[1], k.shape[1]
    if n_q_heads != n_kv_heads:
        if n_q_heads % n_kv_heads:
            raise ValueError(
                f"Attention GQA requires q heads ({n_q_heads}) to be a "
                f"multiple of kv heads ({n_kv_heads})"
            )
        rep = n_q_heads // n_kv_heads
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)

    scale = ctx.attr("scale")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    softcap = float(ctx.attr("softcap", 0.0))
    qk_mode = int(ctx.attr("qk_matmul_output_mode", 0))

    orig = q.dtype
    scores = _acc_product(ctx, q, k.transpose(-1, -2)) * scale
    qk_out = scores
    bias = None
    if int(ctx.attr("is_causal", 0)):
        # Upper-left alignment: query row i may attend key columns j <= i.
        tri = np.tril(np.ones((q.shape[2], k.shape[2]), dtype=bool))
        bias = _on_device(np.where(tri, 0.0, -np.inf).astype(np.float32), dev).to(scores.dtype)
    if attn_mask is not None:
        m = _tensor(ctx, attn_mask, dev)
        if m.dtype == torch.bool:
            m = torch.where(m, torch.zeros((), dtype=scores.dtype, device=dev),
                            torch.full((), -math.inf, dtype=scores.dtype, device=dev))
        else:
            m = m.to(scores.dtype)
        bias = m if bias is None else bias + m
    if bias is not None:
        scores = scores + bias
        if qk_mode == 1:
            qk_out = scores
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
        if qk_mode == 2:
            qk_out = scores
    sp = ctx.attr("softmax_precision")
    sm_dtype = _ONNX_TO_TORCH[int(sp)] if sp is not None else torch.float32
    probs = torch.softmax(scores.to(sm_dtype), dim=-1)
    if qk_mode == 3:
        qk_out = probs
    y = _out_cast(ctx, _acc_product(ctx, probs.to(orig), v), orig)
    if three_d:
        b, h, s, d = y.shape
        y = y.permute(0, 2, 1, 3).reshape(b, s, h * d)
    outs = [y]
    if ctx.num_outputs > 1:
        outs.append(present_k)
    if ctx.num_outputs > 2:
        outs.append(present_v)
    if ctx.num_outputs > 3:
        outs.append(_out_cast(ctx, qk_out, orig))
    return outs


@op("RotaryEmbedding", fold=True)
def _rotary_embedding(ctx, x, cos_cache, sin_cache, position_ids=None):
    """ONNX RotaryEmbedding (opset 23).

    X: [B, heads, seq, head] (4-D) or [B, seq, hidden] (3-D, needs
    num_heads). The caches are [max_pos, rotary_dim/2] with position_ids,
    else [B, seq, rotary_dim/2]. The first rotary_dim components of each
    head are rotated; the tail passes through."""
    x = _tensor(ctx, x)
    dev = x.device
    three_d = x.ndim == 3
    if three_d:
        nh = ctx.attr("num_heads")
        if nh is None:
            raise ValueError("RotaryEmbedding with 3D input requires num_heads")
        nh = int(nh)
        b, s, hidden = x.shape
        x = x.reshape(b, s, nh, hidden // nh).permute(0, 2, 1, 3)
    cos = _tensor(ctx, cos_cache, dev)
    sin = _tensor(ctx, sin_cache, dev)
    if position_ids is not None:
        pos = _tensor(ctx, position_ids, dev).to(torch.int64)  # [B, S]
        cos = cos[pos]  # [B, S, rd/2]
        sin = sin[pos]
    # Broadcast over heads: [B, 1, S, rd/2].
    cos = cos[:, None, :, :].to(x.dtype)
    sin = sin[:, None, :, :].to(x.dtype)
    head = x.shape[-1]
    rd = int(ctx.attr("rotary_embedding_dim", 0)) or 2 * cos.shape[-1]
    rot, tail = x[..., :rd], x[..., rd:]
    interleaved = int(ctx.attr("interleaved", 0))
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
    y = torch.cat([rot_out, tail], dim=-1) if rd < head else rot_out
    if three_d:
        b, h, s, d = y.shape
        y = y.permute(0, 2, 1, 3).reshape(b, s, h * d)
    return [y]


# The long tail of the ai.onnx core (ops_extended.py) and the ai.onnx.ml
# domain (ops_ml.py) register themselves on import; they import helpers
# from here, so this stays at the module's tail.
from . import ops_extended  # noqa: E402,F401  (registration side effect)
from . import ops_ml  # noqa: E402,F401  (ai.onnx.ml classical-ML domain)
from . import ops_contrib  # noqa: E402,F401  (com.microsoft contrib ops)
