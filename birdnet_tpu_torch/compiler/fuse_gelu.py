"""Import-time bundling of exact-erf GELU chains and the prologue that feeds
them.

An exporter writes the exact GELU ``0.5 x (1 + erf(x / sqrt 2))`` as plain
nodes:

    Div(x, sqrt 2) | Mul(x, 1/sqrt 2) -> Erf -> Add(., 1)
        -> Mul(x, .) -> Mul(., 0.5)       (or Mul(x, 0.5) -> Mul(., erf + 1))

with the operands of each Add and Mul on either side. In front of it, a
transformer's FFN adds a bias, ``x = Add(y, b)`` with ``b`` a constant
vector over the last axis, and a conv feature encoder normalizes over
channels, ``x = Transpose(LayerNormalization(Transpose(X)))`` with both
perms ``[0, 2, 1]`` over ``X [N, C, T]`` and a constant scale and shift.
Lowered node by node under the bfloat16 policies, the chain is five to
nine float32 passes over device memory (the float32 bias or scale lifts
the bf16 activation, as jax.numpy promotes).

This pass replaces each chain, with its prologue where it has one, by ONE
``_FusedGelu`` node. Its inputs are ``[y, b]`` (the bias form), ``[X,
scale, shift]`` (the channel LayerNorm form) or ``[x]`` (no prologue); its
attributes carry the constant ``c`` and whether it divides, the order of
the two Muls, LayerNorm's ``epsilon`` and ``bf16_out``: whether every
reader of the result is a product (a Conv's data input, either operand of
a MatMul or Gemm: ``ops.BF16_OPERAND_INPUTS``), which rounds its operand to
bf16 under ``fast`` and ``bf16`` anyway. The original nodes stay as its
``body``. Its lowering (``compiler/ops.py``) runs one kernel
(``csrc/gelu.cu``) on the card under the bfloat16 policies and interprets
``body`` on the CPU and under ``fp32`` and ``mixed``, identical to the
unfused graph.

Every other ``Erf`` (another form, or a chain whose interior tensor is read
elsewhere or kept as a graph output) is left as it is and counted as kept,
its reason on the debug log. A prologue whose output is read elsewhere, or
a LayerNorm whose scale and shift are not one value a channel for at most
512 channels (what the kernel holds), is left out of the chain, which is
then bundled without it. The port's own pass: the JAX package has no such
node.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional

import numpy as np

from ..onnx import proto as P
from ..ops.cuda.gelu import MAX_CHANNELS
from .ops import BF16_OPERAND_INPUTS

_LOG = logging.getLogger(__name__)

_SQRT2 = float(np.float32(math.sqrt(2.0)))
_RSQRT2 = float(np.float32(1.0 / math.sqrt(2.0)))


def _core(node) -> bool:
    return node is not None and node.domain in ("", "ai.onnx")


def _const(name: str, tensors, ndim: Optional[int] = None) -> Optional[np.ndarray]:
    """The float32 initializer ``name`` (of ``ndim`` axes, or of one
    element when ``ndim`` is None), else None."""
    if name not in tensors:
        return None
    arr = np.asarray(tensors[name])
    if arr.dtype != np.float32:
        return None
    if ndim is None:
        return arr if arr.size == 1 else None
    return arr if arr.ndim == ndim else None


def _scalar_is(name: str, tensors, value: float) -> bool:
    arr = _const(name, tensors)
    return arr is not None and float(arr.reshape(())) == value


def _other(node, name: str) -> Optional[str]:
    """The input of a two-input ``node`` beside ``name``."""
    if len(node.input) != 2 or name not in node.input:
        return None
    a, b = node.input
    return b if a == name else a


def _scaled_by(node, tensors, value: float) -> Optional[str]:
    """``x`` when ``node`` is ``Mul(x, value)`` or ``Mul(value, x)``."""
    if not _core(node) or node.op_type != "Mul" or len(node.input) != 2:
        return None
    for x, k in (node.input, node.input[::-1]):
        if x not in tensors and _scalar_is(k, tensors, value):
            return x
    return None


def _match_core(erf, producers, consumers, usage, outputs, tensors):
    """``(members, x, attrs)`` of the GELU around ``erf``, or the reason
    (a string) why it is kept."""
    pre = producers.get(erf.input[0]) if erf.input else None
    if not _core(pre) or pre.op_type not in ("Div", "Mul") or len(pre.input) != 2:
        return "its input is not x / sqrt 2 or x * (1 / sqrt 2)"
    x, k = pre.input
    if pre.op_type == "Div" and _scalar_is(k, tensors, _SQRT2) and x not in tensors:
        c, divide = _SQRT2, 1
    else:
        x = _scaled_by(pre, tensors, _RSQRT2)
        if x is None:
            return "its input is not x / sqrt 2 or x * (1 / sqrt 2)"
        c, divide = _RSQRT2, 0
    readers = consumers.get(erf.output[0], [])
    add = readers[0] if len(readers) == 1 else None
    if not _core(add) or add.op_type != "Add" or not _scalar_is(
            _other(add, erf.output[0]) or "", tensors, 1.0):
        return "erf is not read by one Add of 1"
    readers = consumers.get(add.output[0], [])
    mul = readers[0] if len(readers) == 1 else None
    if not _core(mul) or mul.op_type != "Mul":
        return "erf + 1 is not read by one Mul"
    other = _other(mul, add.output[0])
    if other == x:  # (x * (erf + 1)) * 0.5
        readers = consumers.get(mul.output[0], [])
        last = readers[0] if len(readers) == 1 else None
        if _scaled_by(last, tensors, 0.5) != mul.output[0]:
            return "x * (erf + 1) is not read by one Mul by 0.5"
        members, half_first = [pre, erf, add, mul, last], 0
    else:  # (x * 0.5) * (erf + 1)
        half = producers.get(other) if other else None
        if _scaled_by(half, tensors, 0.5) != x:
            return "erf + 1 is not multiplied by x or by x * 0.5"
        members, half_first, last = [pre, erf, add, half, mul], 1, mul
    for m in members[:-1]:
        if m.output[0] in outputs or usage.get(m.output[0], 0) != 1:
            return f"{m.op_type} output {m.output[0]!r} is read elsewhere"
    return members, x, dict(c=c, divide=divide, half_first=half_first)


def _prologue(x, producers, usage, outputs, tensors):
    """``(members, inputs, attrs)`` of the prologue that makes ``x``, when
    the chain reads ``x`` alone (its Div or Mul and one Mul); else None."""
    if x in outputs or usage.get(x, 0) != 2:
        return None
    p = producers.get(x)
    if not _core(p):
        return None
    if p.op_type == "Add" and len(p.input) == 2:
        for y, b in (p.input, p.input[::-1]):
            if y not in tensors and _const(b, tensors, 1) is not None:
                return [p], [y, b], {}
        return None
    if p.op_type != "Transpose" or [int(v) for v in p.attrs.get("perm", [])] != [0, 2, 1]:
        return None
    ln = producers.get(p.input[0])
    if (not _core(ln) or ln.op_type != "LayerNormalization" or len(ln.input) != 3
            or any(ln.output[1:]) or int(ln.attrs.get("axis", -1)) not in (-1, 2)
            or any(_const(v, tensors, 1) is None for v in ln.input[1:])):
        return None
    # The kernel holds one scale and shift a channel, at most MAX_CHANNELS:
    # another LayerNorm stays outside the chain, which is bundled bare.
    widths = {_const(v, tensors, 1).size for v in ln.input[1:]}
    if len(widths) != 1 or not 2 <= min(widths) <= MAX_CHANNELS:
        return None
    first = producers.get(ln.input[0])
    if (not _core(first) or first.op_type != "Transpose"
            or [int(v) for v in first.attrs.get("perm", [])] != [0, 2, 1]):
        return None
    for t in (first.output[0], ln.output[0]):
        if t in outputs or usage.get(t, 0) != 1:
            return None
    eps = float(ln.attrs.get("epsilon", 1e-5))
    return [first, ln, p], [first.input[0], ln.input[1], ln.input[2]], {"epsilon": eps}


def _bf16_out(name: str, consumers, outputs) -> int:
    """1 when every reader of ``name`` rounds it to bf16 as a product's
    operand under ``fast`` and ``bf16``."""
    readers = consumers.get(name, [])
    return int(bool(readers) and name not in outputs and all(
        _core(r) and r.op_type in BF16_OPERAND_INPUTS
        and all(i in BF16_OPERAND_INPUTS[r.op_type] for i, v in enumerate(r.input) if v == name)
        for r in readers))


def fuse_gelu(graph: P.GraphProto, tensors: Dict) -> tuple:
    """Bundle every exact-erf GELU chain of ``graph``, with its prologue,
    into a ``_FusedGelu`` node. Returns ``(fused, kept)``: the chains
    bundled, and the ``Erf`` nodes left as they were."""
    from .optimize import _usage_counts

    producers = {o: n for n in graph.node for o in n.output if o}
    consumers: Dict[str, List[P.NodeProto]] = {}
    for n in graph.node:
        for i in set(i for i in n.input if i):
            consumers.setdefault(i, []).append(n)
    usage = _usage_counts(graph)
    outputs = {o.name for o in graph.output}
    order = {id(n): i for i, n in enumerate(graph.node)}
    fused_at: Dict[int, P.NodeProto] = {}
    removed = set()
    kept = 0
    for erf in list(graph.node):
        if erf.op_type != "Erf" or not _core(erf):
            continue
        found = _match_core(erf, producers, consumers, usage, outputs, tensors)
        if isinstance(found, str):
            kept += 1
            _LOG.debug("GELU chain at %r kept: %s", erf.name or erf.output[0], found)
            continue
        members, x, attrs = found
        inputs = [x]
        pro = _prologue(x, producers, usage, outputs, tensors)
        if pro is not None:
            members = pro[0] + members
            inputs = pro[1]
            attrs.update(pro[2])
        last = members[-1]
        body = P.GraphProto(
            name="gelu_body",
            node=sorted(members, key=lambda n: order[id(n)]),
            initializer=[],
            input=[],
            output=[P.make_value_info(last.output[0], P.DataType.FLOAT, [])],
        )
        fused_at[id(last)] = P.make_node(
            "_FusedGelu", inputs, [last.output[0]],
            bf16_out=_bf16_out(last.output[0], consumers, outputs), body=body, **attrs,
        )
        removed.update(id(m) for m in members)
    if fused_at:
        graph.node = [fused_at.get(id(n), n) for n in graph.node
                      if id(n) in fused_at or id(n) not in removed]
    return len(fused_at), kept
