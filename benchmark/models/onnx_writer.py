"""The least of the ONNX protobuf wire format that the benchmark's model
generators need: float32/int64 initializers as raw data, nodes with INT,
INTS and FLOAT attributes, typed graph inputs and outputs, one opset.

A frozen copy, so that the measured models do not move when the program's
own ONNX code changes. Field numbers are the public ``onnx.proto``'s.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

FLOAT, INT64 = 1, 7
_DTYPES = {np.dtype(np.float32): FLOAT, np.dtype(np.int64): INT64}
_ATTR_FLOAT, _ATTR_INT, _ATTR_INTS = 1, 2, 7
_VARINT, _LEN, _I32 = 0, 2, 5


def _varint(out: bytearray, value: int) -> None:
    if value < 0:
        value += 1 << 64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _tag(out: bytearray, field: int, wire: int) -> None:
    _varint(out, (field << 3) | wire)


def _bytes(out: bytearray, field: int, payload: bytes) -> None:
    _tag(out, field, _LEN)
    _varint(out, len(payload))
    out.extend(payload)


def _int(out: bytearray, field: int, value: int) -> None:
    _tag(out, field, _VARINT)
    _varint(out, value)


def _packed(out: bytearray, field: int, values) -> None:
    payload = bytearray()
    for v in values:
        _varint(payload, int(v))
    _bytes(out, field, bytes(payload))


def _attribute(name: str, value) -> bytes:
    out = bytearray()
    _bytes(out, 1, name.encode())
    if isinstance(value, float):
        _tag(out, 2, _I32)
        out.extend(struct.pack("<f", value))
        kind = _ATTR_FLOAT
    elif isinstance(value, int):
        _int(out, 3, value)
        kind = _ATTR_INT
    else:
        _packed(out, 8, value)
        kind = _ATTR_INTS
    _int(out, 20, kind)
    return bytes(out)


def _tensor(name: str, arr: np.ndarray) -> bytes:
    out = bytearray()
    if arr.ndim:
        _packed(out, 1, arr.shape)
    _int(out, 2, _DTYPES[arr.dtype])
    _bytes(out, 8, name.encode())
    _bytes(out, 9, np.ascontiguousarray(arr).astype(arr.dtype.newbyteorder("<")).tobytes())
    return bytes(out)


def _value_info(name: str, dims: Sequence) -> bytes:
    shape = bytearray()
    for d in dims:
        dim = bytearray()
        if isinstance(d, str):
            _bytes(dim, 2, d.encode())
        else:
            _int(dim, 1, int(d))
        _bytes(shape, 1, bytes(dim))
    tensor_type = bytearray()
    _int(tensor_type, 1, FLOAT)
    _bytes(tensor_type, 2, bytes(shape))
    type_proto = bytearray()
    _bytes(type_proto, 1, bytes(tensor_type))
    out = bytearray()
    _bytes(out, 1, name.encode())
    _bytes(out, 2, bytes(type_proto))
    return bytes(out)


def _node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
          attrs: Dict[str, object]) -> bytes:
    out = bytearray()
    for s in inputs:
        _bytes(out, 1, s.encode())
    for s in outputs:
        _bytes(out, 2, s.encode())
    _bytes(out, 3, f"{op_type}_{outputs[0]}".encode())
    _bytes(out, 4, op_type.encode())
    for k, v in attrs.items():
        _bytes(out, 5, _attribute(k, v))
    return bytes(out)


def encode_model(name: str, nodes: List[Tuple[str, list, list, dict]],
                 initializers: Dict[str, np.ndarray],
                 inputs: List[Tuple[str, Sequence]], outputs: List[Tuple[str, Sequence]],
                 opset: int = 17) -> bytes:
    """The serialized ModelProto (IR version 8) of a float32 graph."""
    graph = bytearray()
    for op_type, ins, outs, attrs in nodes:
        _bytes(graph, 1, _node(op_type, ins, outs, attrs))
    _bytes(graph, 2, name.encode())
    for tname, arr in initializers.items():
        _bytes(graph, 5, _tensor(tname, arr))
    for vname, dims in inputs:
        _bytes(graph, 11, _value_info(vname, dims))
    for vname, dims in outputs:
        _bytes(graph, 12, _value_info(vname, dims))
    model = bytearray()
    _int(model, 1, 8)
    _bytes(model, 2, b"benchmark")
    _bytes(model, 7, bytes(graph))
    opset_id = bytearray()
    _int(opset_id, 2, opset)
    _bytes(model, 8, bytes(opset_id))
    return bytes(model)
