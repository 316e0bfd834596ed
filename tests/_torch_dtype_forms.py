"""BirdNET v2.4 re-stored in the weight forms that users ship, without JAX.

Each form rewrites a float ONNX model's weights into a modern ONNX dtype
and puts the node that widens them back to float32 before their consumer:

- ``bf16_store`` (the TF-export idiom): every float initializer with two
  or more dimensions is stored as BFLOAT16 and goes through
  ``Cast(to=FLOAT)``;
- ``fp8_qdq`` (weight-only FP8, opset 19): every Conv and Gemm / MatMul
  weight is stored as FLOAT8E4M3FN with float32 scales per output channel
  (amax / 448) and goes through ``DequantizeLinear`` along that axis
  (axis 0 for Conv and a transposed Gemm);
- ``int4_block`` (weight-only int4, opset 21): the weights of the 1x1
  convs and of the classifier head are stored as INT4 in blocks of 32
  along the input channels (scale amax / 7 per block), with an INT4 zero
  point of 0, and go through ``DequantizeLinear(block_size=32)``;
- ``bf16_direct`` (layers that compute in bfloat16): the squeeze-excite
  convs of the last two MBConv blocks (the last ``DIRECT_LAYERS`` 1x1
  convs with a bias) read their input through ``Cast(to=BFLOAT16)``,
  their BFLOAT16 weight and bias directly, and give their output back
  through ``Cast(to=FLOAT)``. These layers are interior (they neither read
  the graph input nor give a graph output), so the int8 quantizer could
  pick them; both packages leave them float.

For each form, :func:`build_form` also gives the *yardstick*: the same
graph holding the dequantized float32 weights, computed from the same
arrays as ``DequantizeLinear`` computes them, with no widening node (for
``bf16_direct``: the bfloat16 weights and biases as float32, with no
Cast; its activations still round to bfloat16 in those layers, so it is
not within the other forms' distance of its yardstick). The
port's codec (``birdnet_tpu_torch.onnx.proto``) writes every file; the
quantized values come from torch's own casts, so neither ml_dtypes nor
JAX is needed (the card's machine has neither).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from birdnet_tpu_torch.onnx import proto as P

FORMS = ("bf16_store", "fp8_qdq", "int4_block", "bf16_direct")
OPSET = {"bf16_store": 17, "fp8_qdq": 19, "int4_block": 21, "bf16_direct": 17}
DIRECT_LAYERS = 4
BLOCK = 32
FP8_MAX = 448.0  # the largest finite FLOAT8E4M3FN
INT4_MAX = 7.0


def _weight_nodes(graph):
    """{weight initializer name: (consumer node, output-channel axis)} for
    every Conv / Gemm / MatMul whose weight is an initializer."""
    inits = {t.name for t in graph.initializer}
    out = {}
    for node in graph.node:
        if node.op_type in ("Conv", "Gemm", "MatMul") and len(node.input) > 1:
            w = node.input[1]
            if w in inits:
                if node.op_type == "Conv":
                    axis = 0
                elif node.op_type == "Gemm":
                    axis = 0 if int(node.attrs.get("transB", 0)) else 1
                else:
                    axis = 1
                out[w] = (node, axis)
    return out


def _amax(w: np.ndarray, axis: int) -> np.ndarray:
    """max |w| over every axis but ``axis``, kept as a broadcastable array."""
    others = tuple(a for a in range(w.ndim) if a != axis)
    return np.abs(w).max(axis=others, keepdims=True)


def _safe_scale(amax: np.ndarray, top: float) -> np.ndarray:
    scale = (amax / np.float32(top)).astype(np.float32)
    return np.where(scale > 0, scale, np.float32(1.0)).astype(np.float32)


def _bf16(w: np.ndarray):
    """(the BFLOAT16 tensor, its float32 values)."""
    t = torch.from_numpy(np.array(w, np.float32)).to(torch.bfloat16)
    return t, t.float().numpy()


def _fp8(w: np.ndarray, axis: int):
    """(the FLOAT8E4M3FN tensor, its per-channel scale [C], the float32
    values DequantizeLinear gives)."""
    scale = _safe_scale(_amax(w, axis), FP8_MAX)
    q = torch.from_numpy((w / scale).astype(np.float32)).to(torch.float8_e4m3fn)
    deq = (q.float().numpy() * scale).astype(np.float32)
    return q, scale.reshape(-1), deq


def _int4_blocks(w: np.ndarray, in_axis: int):
    """(the INT4 values, the blocked scale, the float32 values
    DequantizeLinear(block_size=BLOCK) gives): blocks of BLOCK along
    ``in_axis``, the last one short."""
    c = w.shape[in_axis]
    nb = -(-c // BLOCK)
    pad = nb * BLOCK - c
    moved = np.moveaxis(w, in_axis, -1)
    padded = np.concatenate(
        [moved, np.zeros(moved.shape[:-1] + (pad,), np.float32)], axis=-1)
    blocks = padded.reshape(moved.shape[:-1] + (nb, BLOCK))
    scale = _safe_scale(np.abs(blocks).max(axis=-1), INT4_MAX)  # [..., nb]
    rep = np.repeat(scale, BLOCK, axis=-1)[..., :c]
    q = np.clip(np.round(moved / rep), -8, 7).astype(np.int8)
    deq = ((q.astype(np.float32) - np.float32(0)) * rep).astype(np.float32)
    return (np.moveaxis(q, -1, in_axis), np.moveaxis(scale, -1, in_axis),
            np.moveaxis(deq, -1, in_axis))


def _is_1x1(node, w: np.ndarray) -> bool:
    return (node.op_type == "Conv" and w.ndim == 4 and w.shape[2:] == (1, 1)
            and int(node.attrs.get("group", 1)) == 1)


def _direct_convs(graph, n_layers: int = DIRECT_LAYERS):
    """The last ``n_layers`` 1x1 convs (group 1) whose weight and bias are
    both initializers."""
    inits = {t.name: t for t in graph.initializer}
    picked = [n for n in graph.node
              if n.op_type == "Conv" and len(n.input) > 2
              and n.input[1] in inits and n.input[2] in inits
              and list(inits[n.input[1]].dims[2:]) == [1, 1]
              and int(n.attrs.get("group", 1)) == 1]
    return picked[-n_layers:]


def _compute_in_bf16(graph, node) -> None:
    """``node`` reads its input through ``Cast(to=BFLOAT16)`` and gives its
    output through ``Cast(to=FLOAT)``."""
    x, y = node.input[0], node.output[0]
    i = graph.node.index(node)
    graph.node.insert(i, P.make_node("Cast", [x], [f"{x}__to_bf16_{node.name}"],
                                     to=P.DataType.BFLOAT16))
    graph.node.insert(i + 2, P.make_node("Cast", [f"{y}__bf16"], [y],
                                         to=P.DataType.FLOAT))
    node.input[0] = f"{x}__to_bf16_{node.name}"
    node.output[0] = f"{y}__bf16"


def _widen(graph, name: str, node) -> None:
    """Put ``node`` (whose output is ``name``) before ``name``'s first
    consumer."""
    for i, n in enumerate(graph.node):
        if name in n.input:
            graph.node.insert(i, node)
            return
    raise ValueError(f"initializer {name!r} has no consumer")


def build_form(model: P.ModelProto, form: str):
    """``(form model, yardstick model)`` of a float ``model`` (not
    modified). Both carry the form's opset."""
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; expected one of {FORMS}")
    stored = copy.deepcopy(model)
    yard = copy.deepcopy(model)
    graph = stored.graph
    inits = {t.name: t for t in graph.initializer}
    weights = _weight_nodes(graph)
    new_inits, yard_values = [], {}
    direct = {}
    if form == "bf16_direct":
        for node in _direct_convs(graph):
            _compute_in_bf16(graph, node)
            direct.update({node.input[1]: node, node.input[2]: node})
    for t in list(graph.initializer):
        w = t.to_numpy()
        if not (isinstance(w, np.ndarray) and w.dtype == np.float32):
            continue
        if form == "bf16_direct" and t.name in direct:
            q, deq = _bf16(w)
            new_inits.append(P.TensorProto.from_numpy(q, f"{t.name}__bf16"))
            node = direct[t.name]
            node.input[:] = [f"{t.name}__bf16" if i == t.name else i for i in node.input]
        elif form == "bf16_store" and w.ndim >= 2:
            q, deq = _bf16(w)
            new_inits.append(P.TensorProto.from_numpy(q, f"{t.name}__bf16"))
            _widen(graph, t.name, P.make_node(
                "Cast", [f"{t.name}__bf16"], [t.name], to=P.DataType.FLOAT))
        elif form == "fp8_qdq" and t.name in weights:
            _, axis = weights[t.name]
            q, scale, deq = _fp8(w, axis)
            new_inits += [P.TensorProto.from_numpy(q, f"{t.name}__fp8"),
                          P.TensorProto.from_numpy(scale, f"{t.name}__scale")]
            _widen(graph, t.name, P.make_node(
                "DequantizeLinear", [f"{t.name}__fp8", f"{t.name}__scale"],
                [t.name], axis=axis))
        elif form == "int4_block" and t.name in weights and (
                _is_1x1(weights[t.name][0], w) or weights[t.name][0].op_type != "Conv"):
            node, out_axis = weights[t.name]
            in_axis = 1 - out_axis if node.op_type != "Conv" else 1
            q, scale, deq = _int4_blocks(w, in_axis)
            zp = P.wire_tensor(torch.zeros(scale.shape, dtype=torch.int8),
                               P.DataType.INT4)
            new_inits += [
                P.TensorProto.from_numpy(P.wire_tensor(torch.from_numpy(q),
                                                       P.DataType.INT4),
                                         f"{t.name}__int4"),
                P.TensorProto.from_numpy(scale, f"{t.name}__scale"),
                P.TensorProto.from_numpy(zp, f"{t.name}__zp"),
            ]
            _widen(graph, t.name, P.make_node(
                "DequantizeLinear",
                [f"{t.name}__int4", f"{t.name}__scale", f"{t.name}__zp"],
                [t.name], axis=in_axis, block_size=BLOCK))
        else:
            continue
        del inits[t.name]
        yard_values[t.name] = deq
    graph.initializer = list(inits.values()) + new_inits
    yard.graph.initializer = [
        P.TensorProto.from_numpy(yard_values[t.name], t.name)
        if t.name in yard_values else t for t in yard.graph.initializer
    ]
    for m in (stored, yard):
        m.opset_import = [P.OperatorSetId(domain="", version=OPSET[form])]
    return stored, yard


def form_bytes(model: P.ModelProto, form: str):
    """``(form bytes, yardstick bytes)``: :func:`build_form`, encoded."""
    stored, yard = build_form(model, form)
    return P.encode_model(stored), P.encode_model(yard)
