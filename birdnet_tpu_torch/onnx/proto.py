"""Self-contained ONNX protobuf codec (decoder + encoder).

The reference delegates graph loading to the ONNX Runtime C++ engine
(reference: src/classifier.rs:348-350 ``commit_from_file``). This framework
has no ONNX Runtime; instead this module implements the protobuf *wire
format* directly for the subset of ``onnx.proto`` needed to load and build
models: ModelProto, GraphProto, NodeProto, AttributeProto, TensorProto,
ValueInfoProto, TypeProto and TensorShapeProto.

Zero third-party dependencies. Large weight payloads (``raw_data``) are
sliced, not iterated, so loading a ~50 MB model is fast in pure Python.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# Wire-format primitives
# ---------------------------------------------------------------------------

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _read_signed_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    v, pos = _read_varint(buf, pos)
    if v >= 1 << 63:
        v -= 1 << 64
    return v, pos


def _skip_field(buf: memoryview, pos: int, wire_type: int) -> int:
    if wire_type == _WIRE_VARINT:
        _, pos = _read_varint(buf, pos)
        return pos
    if wire_type == _WIRE_64BIT:
        return pos + 8
    if wire_type == _WIRE_LEN:
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wire_type == _WIRE_32BIT:
        return pos + 4
    raise ValueError(f"unsupported wire type {wire_type}")


def _write_varint(out: bytearray, value: int) -> None:
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


def _write_tag(out: bytearray, field_num: int, wire_type: int) -> None:
    _write_varint(out, (field_num << 3) | wire_type)


def _write_len_field(out: bytearray, field_num: int, payload: bytes) -> None:
    _write_tag(out, field_num, _WIRE_LEN)
    _write_varint(out, len(payload))
    out.extend(payload)


def _write_string(out: bytearray, field_num: int, s: str) -> None:
    _write_len_field(out, field_num, s.encode("utf-8"))


def _write_int_field(out: bytearray, field_num: int, v: int) -> None:
    _write_tag(out, field_num, _WIRE_VARINT)
    _write_varint(out, v)


def _write_float_field(out: bytearray, field_num: int, v: float) -> None:
    _write_tag(out, field_num, _WIRE_32BIT)
    out.extend(struct.pack("<f", v))


def _write_packed_int64(out: bytearray, field_num: int, values) -> None:
    payload = bytearray()
    for v in values:
        _write_varint(payload, int(v))
    _write_len_field(out, field_num, bytes(payload))


def _write_packed_float(out: bytearray, field_num: int, values) -> None:
    _write_len_field(out, field_num, struct.pack(f"<{len(values)}f", *values))


# ---------------------------------------------------------------------------
# ONNX message dataclasses
# ---------------------------------------------------------------------------

# TensorProto.DataType values (public ONNX spec).
class DataType:
    UNDEFINED = 0
    FLOAT = 1
    UINT8 = 2
    INT8 = 3
    UINT16 = 4
    INT16 = 5
    INT32 = 6
    INT64 = 7
    STRING = 8
    BOOL = 9
    FLOAT16 = 10
    DOUBLE = 11
    UINT32 = 12
    UINT64 = 13
    BFLOAT16 = 16
    FLOAT8E4M3FN = 17
    FLOAT8E4M3FNUZ = 18
    FLOAT8E5M2 = 19
    FLOAT8E5M2FNUZ = 20
    UINT4 = 21
    INT4 = 22


# The wire types numpy holds only through ml_dtypes (which ships with jax):
# bfloat16, the four float8 types and int4/uint4. This package never
# imports ml_dtypes, installed or not: such a tensor decodes into a CPU
# torch tensor of class ``WireTensor`` (``Int4Tensor`` for the 4-bit
# types), the same representation on every machine.
import torch  # noqa: E402

# Wire type -> (torch dtype, the numpy type of its bits).
_WIRE_FLOATS = {
    DataType.BFLOAT16: (torch.bfloat16, np.uint16),
    DataType.FLOAT8E4M3FN: (torch.float8_e4m3fn, np.uint8),
    DataType.FLOAT8E4M3FNUZ: (torch.float8_e4m3fnuz, np.uint8),
    DataType.FLOAT8E5M2: (torch.float8_e5m2, np.uint8),
    DataType.FLOAT8E5M2FNUZ: (torch.float8_e5m2fnuz, np.uint8),
}
# The 4-bit wire types and their 8-bit containers.
_WIRE_INT4 = {DataType.INT4: torch.int8, DataType.UINT4: torch.uint8}
_TORCH_TO_WIRE = {dt: code for code, (dt, _) in _WIRE_FLOATS.items()}
# The wire types' names, which are ml_dtypes' (and the .btck format's).
WIRE_NAMES = {
    DataType.BFLOAT16: "bfloat16",
    DataType.FLOAT8E4M3FN: "float8_e4m3fn",
    DataType.FLOAT8E4M3FNUZ: "float8_e4m3fnuz",
    DataType.FLOAT8E5M2: "float8_e5m2",
    DataType.FLOAT8E5M2FNUZ: "float8_e5m2fnuz",
    DataType.INT4: "int4",
    DataType.UINT4: "uint4",
}
_WIRE_BY_NAME = {name: code for code, name in WIRE_NAMES.items()}


class WireTensor(torch.Tensor):
    """A value of a wire type numpy cannot hold: a torch tensor of
    ``torch.bfloat16`` or a ``torch.float8_*`` dtype, viewed from the
    wire's bits. Decoded initializers, Constant values and host folds
    are CPU tensors of this class, which marks them as host values (the
    JAX package's compile-time constants). Operations on it give plain
    tensors."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def data_type(self) -> int:
        return _TORCH_TO_WIRE[self.dtype]


class Int4Tensor(WireTensor):
    """An int4 (``int8`` container, values in [-8, 7]) or uint4 (``uint8``
    container, values in [0, 15]) tensor. torch has no 4-bit dtype, so the
    class carries the wire type: ``QuantizeLinear`` and ``CastLike`` read
    it to saturate into the 4-bit range, and checkpoints name it."""

    @property
    def data_type(self) -> int:
        return DataType.INT4 if self.dtype == torch.int8 else DataType.UINT4


def wire_tensor(t: torch.Tensor, data_type: Optional[int] = None) -> WireTensor:
    """``t`` (a CPU tensor) as a :class:`WireTensor`; a 4-bit
    ``data_type`` (or an ``Int4Tensor`` ``t``) gives an
    :class:`Int4Tensor` of the container's values."""
    if isinstance(t, Int4Tensor) or data_type in _WIRE_INT4:
        if data_type is not None and t.dtype != _WIRE_INT4[data_type]:
            t = t.to(_WIRE_INT4[data_type])
        return t.as_subclass(Int4Tensor)
    if t.dtype not in _TORCH_TO_WIRE:
        raise ValueError(f"no ONNX wire type holds torch dtype {t.dtype}")
    return t.as_subclass(WireTensor)


def wire_from_bits(bits: np.ndarray, data_type: int, shape) -> WireTensor:
    """A bfloat16 / float8 tensor of ``shape`` from its bits (uint16 or
    uint8 values), or a 4-bit tensor from its container's values."""
    if data_type in _WIRE_INT4:
        container = np.int8 if data_type == DataType.INT4 else np.uint8
        t = torch.from_numpy(np.array(bits, dtype=container).reshape(shape))
        return wire_tensor(t, data_type)
    dtype, carrier = _WIRE_FLOATS[data_type]
    n = int(np.prod(shape)) if len(shape) else 1
    flat = np.array(bits, dtype=carrier).reshape(-1)
    if flat.size != n:
        raise ValueError(
            f"{WIRE_NAMES[data_type]} payload holds {flat.size} elements, "
            f"shape {tuple(shape)} needs {n}"
        )
    t = torch.from_numpy(flat).view(dtype).reshape(tuple(shape))
    return t.as_subclass(WireTensor)


def wire_bits(t: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`wire_from_bits`: a bfloat16 / float8 tensor's
    bits as uint16/uint8 values, a 4-bit tensor's container values, in
    ``t``'s shape."""
    t = t.detach().cpu().as_subclass(torch.Tensor).contiguous()
    if t.dtype in (torch.int8, torch.uint8):
        return t.numpy()
    _, carrier = _WIRE_FLOATS[_TORCH_TO_WIRE[t.dtype]]
    return t.reshape(-1).view(torch.uint8).numpy().view(carrier).reshape(t.shape)


def wire_type_of(x) -> Optional[int]:
    """The wire type of a wire value (a ``WireTensor``, a torch tensor of
    bfloat16 or a float8 dtype, or an ml_dtypes numpy array, read by its
    dtype's name without importing ml_dtypes), else None."""
    if isinstance(x, WireTensor):
        return x.data_type
    if isinstance(x, torch.Tensor):
        return _TORCH_TO_WIRE.get(x.dtype)
    dtype = getattr(x, "dtype", None)
    if isinstance(dtype, np.dtype):
        return _WIRE_BY_NAME.get(dtype.name)
    return None


_DTYPE_TO_NUMPY = {
    DataType.FLOAT: np.dtype(np.float32),
    DataType.UINT8: np.dtype(np.uint8),
    DataType.INT8: np.dtype(np.int8),
    DataType.UINT16: np.dtype(np.uint16),
    DataType.INT16: np.dtype(np.int16),
    DataType.INT32: np.dtype(np.int32),
    DataType.INT64: np.dtype(np.int64),
    DataType.BOOL: np.dtype(np.bool_),
    DataType.FLOAT16: np.dtype(np.float16),
    DataType.DOUBLE: np.dtype(np.float64),
    DataType.UINT32: np.dtype(np.uint32),
    DataType.UINT64: np.dtype(np.uint64),
}

_NUMPY_TO_DTYPE = {
    np.dtype(np.float32): DataType.FLOAT,
    np.dtype(np.uint8): DataType.UINT8,
    np.dtype(np.int8): DataType.INT8,
    np.dtype(np.uint16): DataType.UINT16,
    np.dtype(np.int16): DataType.INT16,
    np.dtype(np.int32): DataType.INT32,
    np.dtype(np.int64): DataType.INT64,
    np.dtype(np.bool_): DataType.BOOL,
    np.dtype(np.float16): DataType.FLOAT16,
    np.dtype(np.float64): DataType.DOUBLE,
    np.dtype(np.uint32): DataType.UINT32,
    np.dtype(np.uint64): DataType.UINT64,
}


_DATA_LOCATION_EXTERNAL = 1


@dataclass
class TensorProto:
    name: str = ""
    data_type: int = DataType.UNDEFINED
    dims: List[int] = field(default_factory=list)
    raw_data: bytes = b""
    float_data: List[float] = field(default_factory=list)
    int32_data: List[int] = field(default_factory=list)
    int64_data: List[int] = field(default_factory=list)
    string_data: List[bytes] = field(default_factory=list)
    double_data: List[float] = field(default_factory=list)
    uint64_data: List[int] = field(default_factory=list)
    data_location: int = 0
    external_data: Dict[str, str] = field(default_factory=dict)

    def load_external(self, base_dir: str) -> None:
        """Resolve externally-stored weights (data_location=EXTERNAL) from
        the model's directory into ``raw_data``."""
        import os

        location = self.external_data.get("location")
        if not location:
            raise ValueError(f"tensor {self.name!r} has no external location")
        base = os.path.normpath(base_dir)
        path = os.path.normpath(os.path.join(base, location))
        # commonpath (not a raw prefix test — '/x/m' must not admit
        # '/x/m_secrets') keeps reads inside the model directory.
        if os.path.commonpath([base, path]) != base:
            raise ValueError(f"external data path escapes model dir: {location!r}")
        offset = int(self.external_data.get("offset", 0))
        length = int(self.external_data.get("length", 0))
        with open(path, "rb") as f:
            f.seek(offset)
            self.raw_data = f.read(length) if length else f.read()
        self.data_location = 0

    def to_numpy(self) -> np.ndarray:
        """Materialize this tensor as a numpy array."""
        if self.data_location == _DATA_LOCATION_EXTERNAL:
            raise ValueError(
                f"tensor {self.name!r} stores data externally "
                f"({self.external_data.get('location')!r}); load the model "
                f"by file path so external data can be resolved"
            )
        if self.data_type == DataType.STRING:
            # String tensors (TensorProto.string_data, field 6): one bytes
            # element per tensor element. Materialized as a numpy object
            # array of ``str`` — strings never reach the device; they only
            # feed host-evaluated ops (StringNormalizer, TfIdfVectorizer
            # string pools).
            shape = tuple(self.dims)
            n_expected = int(np.prod(shape)) if shape else 1
            if len(self.string_data) != n_expected:
                raise ValueError(
                    f"tensor {self.name!r}: string payload holds "
                    f"{len(self.string_data)} elements, shape {shape} "
                    f"needs {n_expected}"
                )
            arr = np.asarray(
                [s.decode("utf-8", errors="replace") for s in self.string_data],
                dtype=object,
            )
            return arr.reshape(shape)
        if self.data_type in WIRE_NAMES:
            return self._to_wire()
        if self.data_type not in _DTYPE_TO_NUMPY:
            raise ValueError(f"unsupported tensor data_type {self.data_type}")
        dtype = _DTYPE_TO_NUMPY[self.data_type]
        shape = tuple(self.dims)
        if self.raw_data:
            arr = np.frombuffer(self.raw_data, dtype=dtype)
        elif self.float_data and self.data_type == DataType.FLOAT:
            arr = np.asarray(self.float_data, dtype=np.float32)
        elif self.int64_data and self.data_type == DataType.INT64:
            arr = np.asarray(self.int64_data, dtype=np.int64)
        elif self.int32_data and self.data_type == DataType.FLOAT16:
            # The ONNX spec stores fp16 payloads in int32_data as uint16
            # bit patterns; reinterpret, don't value-convert.
            arr = np.asarray(self.int32_data, dtype=np.uint16).view(np.float16)
        elif self.int32_data and self.data_type in (
            DataType.INT32,
            DataType.INT16,
            DataType.INT8,
            DataType.UINT16,
            DataType.UINT8,
            DataType.BOOL,
        ):
            arr = np.asarray(self.int32_data, dtype=np.int32).astype(dtype)
        elif self.double_data and self.data_type == DataType.DOUBLE:
            arr = np.asarray(self.double_data, dtype=np.float64)
        elif self.uint64_data and self.data_type in (
            DataType.UINT32,
            DataType.UINT64,
        ):
            arr = np.asarray(self.uint64_data, dtype=np.uint64).astype(dtype)
        else:
            n_expected = int(np.prod(shape)) if shape else 0
            if n_expected:
                # An initializer with a non-empty shape but no payload is
                # corrupt (or uses a field this codec doesn't know);
                # returning zeros here would silently poison the weights.
                raise ValueError(
                    f"tensor {self.name!r} (dtype {self.data_type}, shape "
                    f"{shape}) carries no data in any supported field"
                )
            arr = np.zeros(0, dtype=dtype)
        return arr.reshape(shape)

    def _to_wire(self) -> WireTensor:
        """Decode a bfloat16 / float8 / int4 / uint4 tensor into a CPU
        :class:`WireTensor`. bfloat16 and float8 payloads are bit patterns,
        in ``raw_data`` or (the spec's alternative, as for fp16) one per
        ``int32_data`` entry; 4-bit payloads pack two per byte."""
        shape = tuple(self.dims)
        if self.data_type in _WIRE_INT4:
            return wire_from_bits(self._unpack_int4(shape), self.data_type, shape)
        _, carrier = _WIRE_FLOATS[self.data_type]
        if self.raw_data:
            bits = np.frombuffer(self.raw_data, dtype=carrier)
        elif self.int32_data:
            bits = np.asarray(self.int32_data, dtype=np.int64).astype(carrier)
        else:
            n_expected = int(np.prod(shape)) if shape else 0
            if n_expected:
                raise ValueError(
                    f"tensor {self.name!r} (dtype {self.data_type}, shape "
                    f"{shape}) carries no data in any supported field"
                )
            bits = np.zeros(0, dtype=carrier)
        return wire_from_bits(bits, self.data_type, shape)

    def _unpack_int4(self, shape) -> np.ndarray:
        """Decode a packed 4-bit tensor (opset 21): two elements per byte,
        low nibble first, odd element counts padded with a trailing
        nibble. Both storage forms pack — ``raw_data`` bytes and
        ``int32_data`` entries each carry two nibbles (the onnx.helper
        "4bitx2" convention). Returns the values (int8 in [-8, 7] or
        uint8 in [0, 15]) as a flat numpy array."""
        n = int(np.prod(shape)) if shape else 1
        if self.raw_data:
            packed = np.frombuffer(self.raw_data, dtype=np.uint8)
        elif self.int32_data:
            packed = (np.asarray(self.int32_data, dtype=np.int32) & 0xFF).astype(
                np.uint8
            )
        else:
            if n:
                raise ValueError(
                    f"tensor {self.name!r} (int4, shape {tuple(shape)}) "
                    f"carries no data in any supported field"
                )
            packed = np.zeros(0, dtype=np.uint8)
        if packed.size < (n + 1) // 2:
            raise ValueError(
                f"tensor {self.name!r}: int4 payload holds "
                f"{packed.size * 2} nibbles, shape needs {n}"
            )
        nib = np.empty(packed.size * 2, dtype=np.uint8)
        nib[0::2] = packed & 0x0F
        nib[1::2] = packed >> 4
        nib = nib[:n]
        if self.data_type == DataType.INT4:
            arr = nib.astype(np.int8)
            return np.where(arr > 7, arr - 16, arr).astype(np.int8)
        return nib

    @staticmethod
    def from_numpy(arr: np.ndarray, name: str = "") -> "TensorProto":
        # A wire value (a WireTensor, a torch bfloat16 / float8 tensor, or
        # an ml_dtypes array) encodes as its wire type.
        wire = wire_type_of(arr)
        if wire is not None:
            return TensorProto._from_wire(arr, wire, name)
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        # NB: np.ascontiguousarray promotes 0-d arrays to 1-d, which would
        # silently corrupt scalar tensor shapes (Loop trip counts, scalar
        # thresholds) — only invoke it on non-contiguous data.
        arr = np.asarray(arr)
        if arr.dtype.kind in ("U", "S", "O"):
            return TensorProto(
                name=name,
                data_type=DataType.STRING,
                dims=list(arr.shape),
                string_data=[
                    s if isinstance(s, bytes) else str(s).encode("utf-8")
                    for s in arr.reshape(-1)
                ],
            )
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
        if arr.dtype not in _NUMPY_TO_DTYPE:
            raise ValueError(f"unsupported numpy dtype {arr.dtype}")
        return TensorProto(
            name=name,
            data_type=_NUMPY_TO_DTYPE[arr.dtype],
            dims=list(arr.shape),
            raw_data=arr.tobytes(),
        )

    @staticmethod
    def _from_wire(x, data_type: int, name: str) -> "TensorProto":
        """Encode a wire value: bfloat16 / float8 bits as ``raw_data``,
        4-bit values packed two per byte, low nibble first."""
        if isinstance(x, torch.Tensor):
            bits = wire_bits(x)
        else:  # an ml_dtypes array: its bytes are the bits (4-bit: one
            # nibble per byte, the high half clear)
            bits = np.ascontiguousarray(x).view(np.uint16 if x.dtype.itemsize == 2 else np.uint8)
        shape = list(bits.shape)
        if data_type in _WIRE_INT4:
            flat = bits.reshape(-1).astype(np.uint8) & 0x0F
            if flat.size % 2:
                flat = np.concatenate([flat, np.zeros(1, np.uint8)])
            payload = (flat[0::2] | (flat[1::2] << 4)).tobytes()
        else:
            payload = np.ascontiguousarray(bits).tobytes()
        return TensorProto(name=name, data_type=data_type, dims=shape,
                           raw_data=payload)


@dataclass
class SparseTensorProto:
    """COO sparse tensor (onnx.proto ``SparseTensorProto``).

    ``values`` holds the NNZ entries (its ``name`` names the whole sparse
    tensor, per spec); ``indices`` is an int64 tensor of shape
    ``[NNZ, rank]`` (one coordinate row per entry) or ``[NNZ]``
    (C-order linearized offsets); ``dims`` is the dense shape. ONNX
    Runtime densifies these at session load (reference:
    src/classifier.rs:348-350 ``commit_from_file``); so do we, at import
    (compiler/importer.py) — TPU/XLA has no sparse tensor representation,
    and classifier weights are dense on the MXU anyway."""

    values: Optional["TensorProto"] = None
    indices: Optional["TensorProto"] = None
    dims: List[int] = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.values.name if self.values is not None else ""

    def to_dense(self) -> np.ndarray:
        """Materialize as a dense numpy array (zero-fill + scatter); wire
        values (bfloat16, float8, 4-bit) scatter their bits into a dense
        ``WireTensor``."""
        if self.values is None:
            raise ValueError("sparse tensor has no values tensor")
        vals = self.values.to_numpy()
        if isinstance(vals, WireTensor):
            shape = tuple(int(d) for d in self.dims)
            dense = self._scatter(wire_bits(vals).reshape(-1))
            return wire_from_bits(dense, vals.data_type, shape)
        return self._scatter(vals.reshape(-1))

    def _scatter(self, vals: np.ndarray) -> np.ndarray:
        shape = tuple(int(d) for d in self.dims)
        if any(d < 0 for d in shape):
            raise ValueError(
                f"sparse tensor {self.name!r}: negative dim in shape {shape}"
            )
        dense = np.zeros(shape, dtype=vals.dtype)
        if self.indices is None or vals.size == 0:
            if vals.size:
                raise ValueError(
                    f"sparse tensor {self.name!r}: {vals.size} values but "
                    f"no indices tensor"
                )
            return dense
        idx = self.indices.to_numpy()
        if idx.dtype != np.int64:
            raise ValueError(
                f"sparse tensor {self.name!r}: indices must be int64, "
                f"got {idx.dtype}"
            )
        if idx.ndim == 1:
            # Linearized C-order offsets into the dense tensor.
            if idx.shape[0] != vals.size:
                raise ValueError(
                    f"sparse tensor {self.name!r}: {vals.size} values but "
                    f"{idx.shape[0]} linear indices"
                )
            n_total = int(np.prod(shape)) if shape else 1
            if idx.size and (idx.min() < 0 or idx.max() >= n_total):
                raise ValueError(
                    f"sparse tensor {self.name!r}: linear index out of "
                    f"range for shape {shape}"
                )
            dense.reshape(-1)[idx] = vals
            return dense
        if idx.ndim == 2:
            # COO coordinate rows: [NNZ, rank].
            if idx.shape != (vals.size, len(shape)):
                raise ValueError(
                    f"sparse tensor {self.name!r}: COO indices shape "
                    f"{idx.shape} does not match ({vals.size}, {len(shape)})"
                )
            for axis, size in enumerate(shape):
                col = idx[:, axis]
                if col.size and (col.min() < 0 or col.max() >= size):
                    raise ValueError(
                        f"sparse tensor {self.name!r}: coordinate out of "
                        f"range on axis {axis} (dim {size})"
                    )
            dense[tuple(idx[:, a] for a in range(len(shape)))] = vals
            return dense
        raise ValueError(
            f"sparse tensor {self.name!r}: indices must be rank 1 or 2, "
            f"got rank {idx.ndim}"
        )


class AttrType:
    UNDEFINED = 0
    FLOAT = 1
    INT = 2
    STRING = 3
    TENSOR = 4
    GRAPH = 5
    FLOATS = 6
    INTS = 7
    STRINGS = 8
    TENSORS = 9
    GRAPHS = 10
    SPARSE_TENSOR = 11
    SPARSE_TENSORS = 12
    TYPE_PROTO = 13
    TYPE_PROTOS = 14


@dataclass
class AttributeProto:
    name: str = ""
    # Function-body attribute reference: when set, this attribute takes the
    # value of the call-site attribute named ref_attr_name (ONNX
    # FunctionProto semantics); resolved during function inlining.
    ref_attr_name: str = ""
    type: int = AttrType.UNDEFINED
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Optional["TensorProto"] = None
    g: Optional["GraphProto"] = None
    floats: List[float] = field(default_factory=list)
    ints: List[int] = field(default_factory=list)
    strings: List[bytes] = field(default_factory=list)
    tensors: List["TensorProto"] = field(default_factory=list)
    graphs: List["GraphProto"] = field(default_factory=list)
    sparse_tensor: Optional["SparseTensorProto"] = None
    sparse_tensors: List["SparseTensorProto"] = field(default_factory=list)
    tp: Optional["TypeProto"] = None
    type_protos: List["TypeProto"] = field(default_factory=list)

    @property
    def value(self):
        """The attribute payload, as a natural Python value."""
        t = self.type
        if t == AttrType.FLOAT:
            return self.f
        if t == AttrType.INT:
            return self.i
        if t == AttrType.STRING:
            return self.s.decode("utf-8", errors="replace")
        if t == AttrType.TENSOR:
            return self.t
        if t == AttrType.GRAPH:
            return self.g
        if t == AttrType.FLOATS:
            return list(self.floats)
        if t == AttrType.INTS:
            return list(self.ints)
        if t == AttrType.STRINGS:
            return [s.decode("utf-8", errors="replace") for s in self.strings]
        if t == AttrType.TENSORS:
            return list(self.tensors)
        if t == AttrType.GRAPHS:
            return list(self.graphs)
        if t == AttrType.SPARSE_TENSOR:
            return self.sparse_tensor
        if t == AttrType.SPARSE_TENSORS:
            return list(self.sparse_tensors)
        if t == AttrType.TYPE_PROTO:
            return self.tp
        if t == AttrType.TYPE_PROTOS:
            return list(self.type_protos)
        return None


@dataclass
class NodeProto:
    op_type: str = ""
    name: str = ""
    domain: str = ""
    input: List[str] = field(default_factory=list)
    output: List[str] = field(default_factory=list)
    attribute: List[AttributeProto] = field(default_factory=list)

    @property
    def attrs(self) -> Dict[str, object]:
        return {a.name: a.value for a in self.attribute}


@dataclass
class Dimension:
    dim_value: Optional[int] = None
    dim_param: str = ""


@dataclass
class TensorShapeProto:
    dim: List[Dimension] = field(default_factory=list)


@dataclass
class TensorTypeProto:
    elem_type: int = DataType.UNDEFINED
    shape: Optional[TensorShapeProto] = None


@dataclass
class MapTypeProto:
    key_type: int = DataType.UNDEFINED
    value_type: Optional["TypeProto"] = None


@dataclass
class TypeProto:
    """Declared value type. ``tensor_type`` is the common case; the
    container kinds (sequence/map/optional/sparse tensor) are decoded so
    no declared type silently drops — at runtime they flow as trace-time
    containers (compiler/ops_extended.py module docstring)."""

    tensor_type: Optional[TensorTypeProto] = None
    sequence_type: Optional["TypeProto"] = None  # Sequence.elem_type
    map_type: Optional[MapTypeProto] = None
    sparse_tensor_type: Optional[TensorTypeProto] = None
    optional_type: Optional["TypeProto"] = None  # Optional.elem_type

    @property
    def kind(self) -> str:
        if self.tensor_type is not None:
            return "tensor"
        if self.sequence_type is not None:
            return "sequence"
        if self.map_type is not None:
            return "map"
        if self.sparse_tensor_type is not None:
            return "sparse_tensor"
        if self.optional_type is not None:
            return "optional"
        return ""


@dataclass
class ValueInfoProto:
    name: str = ""
    type: Optional[TypeProto] = None

    def shape(self, dynamic: int = 1) -> List[int]:
        """Static shape with symbolic dims replaced by ``dynamic``."""
        if self.type is None or self.type.tensor_type is None:
            return []
        sh = self.type.tensor_type.shape
        if sh is None:
            return []
        out = []
        for d in sh.dim:
            out.append(int(d.dim_value) if d.dim_value is not None else dynamic)
        return out


@dataclass
class GraphProto:
    name: str = ""
    node: List[NodeProto] = field(default_factory=list)
    initializer: List[TensorProto] = field(default_factory=list)
    sparse_initializer: List[SparseTensorProto] = field(default_factory=list)
    input: List[ValueInfoProto] = field(default_factory=list)
    output: List[ValueInfoProto] = field(default_factory=list)
    value_info: List[ValueInfoProto] = field(default_factory=list)


@dataclass
class OperatorSetId:
    domain: str = ""
    version: int = 0


@dataclass
class FunctionProto:
    """Model-local function (ONNX IR ≥ 8): a named subgraph template whose
    call sites are nodes with matching (domain, op_type); inlined at import
    time (compiler/functions.py)."""

    name: str = ""
    domain: str = ""
    overload: str = ""
    input: List[str] = field(default_factory=list)
    output: List[str] = field(default_factory=list)
    attribute: List[str] = field(default_factory=list)
    attribute_proto: List["AttributeProto"] = field(default_factory=list)
    node: List["NodeProto"] = field(default_factory=list)
    opset_import: List["OperatorSetId"] = field(default_factory=list)


@dataclass
class ModelProto:
    ir_version: int = 8
    producer_name: str = ""
    producer_version: str = ""
    domain: str = ""
    model_version: int = 0
    graph: Optional[GraphProto] = None
    opset_import: List[OperatorSetId] = field(default_factory=list)
    functions: List[FunctionProto] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def _iter_fields(buf: memoryview, pos: int, end: int):
    """Yield (field_num, wire_type, value_start, value_end_or_value)."""
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        yield tag >> 3, tag & 7, pos
        pos = _advance(buf, pos, tag & 7)


def _advance(buf: memoryview, pos: int, wire_type: int) -> int:
    return _skip_field(buf, pos, wire_type)


def _decode_repeated_int64(buf: memoryview, pos: int, wire_type: int, dest: List[int]):
    if wire_type == _WIRE_LEN:  # packed
        n, p = _read_varint(buf, pos)
        end = p + n
        while p < end:
            v, p = _read_signed_varint(buf, p)
            dest.append(v)
    else:
        v, _ = _read_signed_varint(buf, pos)
        dest.append(v)


def _decode_repeated_float(buf: memoryview, pos: int, wire_type: int, dest: List[float]):
    if wire_type == _WIRE_LEN:  # packed
        n, p = _read_varint(buf, pos)
        dest.extend(np.frombuffer(bytes(buf[p:p + n]), dtype="<f4").tolist())
    else:
        dest.append(struct.unpack_from("<f", buf, pos)[0])


def _get_bytes(buf: memoryview, pos: int) -> bytes:
    n, p = _read_varint(buf, pos)
    return bytes(buf[p:p + n])


def _get_str(buf: memoryview, pos: int) -> str:
    return _get_bytes(buf, pos).decode("utf-8")


def _submsg(buf: memoryview, pos: int, end: int) -> Tuple[memoryview, int, int]:
    """Bounds of a nested LEN-delimited message. The declared length must
    stay inside the parent message — silently accepting an overrun would
    parse sibling/parent bytes as the child's fields (a conformant protobuf
    parser rejects this)."""
    n, p = _read_varint(buf, pos)
    if p + n > end:
        raise ValueError(
            f"nested message length {n} overruns enclosing message at {pos}"
        )
    return buf, p, p + n


def decode_tensor(buf: memoryview, pos: int, end: int) -> TensorProto:
    t = TensorProto()
    for fnum, wt, vpos in _iter_fields(buf, pos, end):
        if fnum == 1:
            _decode_repeated_int64(buf, vpos, wt, t.dims)
        elif fnum == 2:
            t.data_type, _ = _read_varint(buf, vpos)
        elif fnum == 3:
            # TensorProto.segment: a *slice* of a logically larger tensor
            # split across multiple protos. Decoding the payload without
            # stitching segments would silently truncate the weights, so
            # this is a loud typed rejection (WIRE_POLICY "rejected").
            raise ValueError(
                "TensorProto.segment (field 3, segmented large-tensor "
                "storage) is not supported"
            )
        elif fnum == 4:
            _decode_repeated_float(buf, vpos, wt, t.float_data)
        elif fnum == 5:
            _decode_repeated_int64(buf, vpos, wt, t.int32_data)
        elif fnum == 6:  # string_data: repeated bytes, one per element
            t.string_data.append(_get_bytes(buf, vpos))
        elif fnum == 7:
            _decode_repeated_int64(buf, vpos, wt, t.int64_data)
        elif fnum == 8:
            t.name = _get_str(buf, vpos)
        elif fnum == 9:
            t.raw_data = _get_bytes(buf, vpos)
        elif fnum == 10 and wt == _WIRE_LEN:
            n, p = _read_varint(buf, vpos)
            t.double_data.extend(
                np.frombuffer(bytes(buf[p:p + n]), dtype="<f8").tolist()
            )
        elif fnum == 11:  # uint64_data (UINT32/UINT64 payloads)
            if wt == _WIRE_LEN:
                n, p = _read_varint(buf, vpos)
                e11 = p + n
                while p < e11:
                    v, p = _read_varint(buf, p)
                    t.uint64_data.append(v)
            else:
                v, _ = _read_varint(buf, vpos)
                t.uint64_data.append(v)
        elif fnum == 13:  # external_data: StringStringEntryProto
            b, p, e = _submsg(buf, vpos, end)
            key = value = ""
            for f2, w2, v2 in _iter_fields(b, p, e):
                if f2 == 1:
                    key = _get_str(b, v2)
                elif f2 == 2:
                    value = _get_str(b, v2)
            if key:
                t.external_data[key] = value
        elif fnum == 14:
            t.data_location, _ = _read_varint(buf, vpos)
    return t


def decode_sparse_tensor(buf: memoryview, pos: int, end: int) -> SparseTensorProto:
    s = SparseTensorProto()
    for fnum, wt, vpos in _iter_fields(buf, pos, end):
        if fnum == 1:
            b, p, e = _submsg(buf, vpos, end)
            s.values = decode_tensor(b, p, e)
        elif fnum == 2:
            b, p, e = _submsg(buf, vpos, end)
            s.indices = decode_tensor(b, p, e)
        elif fnum == 3:
            _decode_repeated_int64(buf, vpos, wt, s.dims)
    return s


def decode_attribute(buf: memoryview, pos: int, end: int) -> AttributeProto:
    a = AttributeProto()
    for fnum, wt, vpos in _iter_fields(buf, pos, end):
        if fnum == 1:
            a.name = _get_str(buf, vpos)
        elif fnum == 2:
            a.f = struct.unpack_from("<f", buf, vpos)[0]
        elif fnum == 3:
            a.i, _ = _read_signed_varint(buf, vpos)
        elif fnum == 4:
            a.s = _get_bytes(buf, vpos)
        elif fnum == 5:
            b, p, e = _submsg(buf, vpos, end)
            a.t = decode_tensor(b, p, e)
        elif fnum == 6:
            b, p, e = _submsg(buf, vpos, end)
            a.g = decode_graph(b, p, e)
        elif fnum == 7:
            _decode_repeated_float(buf, vpos, wt, a.floats)
        elif fnum == 8:
            _decode_repeated_int64(buf, vpos, wt, a.ints)
        elif fnum == 9:
            a.strings.append(_get_bytes(buf, vpos))
        elif fnum == 10:
            b, p, e = _submsg(buf, vpos, end)
            a.tensors.append(decode_tensor(b, p, e))
        elif fnum == 11:
            b, p, e = _submsg(buf, vpos, end)
            a.graphs.append(decode_graph(b, p, e))
        elif fnum == 14:
            b, p, e = _submsg(buf, vpos, end)
            a.tp = decode_type(b, p, e)
        elif fnum == 15:
            b, p, e = _submsg(buf, vpos, end)
            a.type_protos.append(decode_type(b, p, e))
        elif fnum == 20:
            a.type, _ = _read_varint(buf, vpos)
        elif fnum == 21:
            a.ref_attr_name = _get_str(buf, vpos)
        elif fnum == 22:
            b, p, e = _submsg(buf, vpos, end)
            a.sparse_tensor = decode_sparse_tensor(b, p, e)
        elif fnum == 23:
            b, p, e = _submsg(buf, vpos, end)
            a.sparse_tensors.append(decode_sparse_tensor(b, p, e))
    if a.type == AttrType.UNDEFINED and not a.ref_attr_name:
        a.type = _infer_attr_type(a)
    return a


def _infer_attr_type(a: AttributeProto) -> int:
    """Some producers omit AttributeProto.type; infer from populated field."""
    if a.floats:
        return AttrType.FLOATS
    if a.ints:
        return AttrType.INTS
    if a.strings:
        return AttrType.STRINGS
    if a.tensors:
        return AttrType.TENSORS
    if a.graphs:
        return AttrType.GRAPHS
    if a.t is not None:
        return AttrType.TENSOR
    if a.g is not None:
        return AttrType.GRAPH
    if a.sparse_tensors:
        return AttrType.SPARSE_TENSORS
    if a.sparse_tensor is not None:
        return AttrType.SPARSE_TENSOR
    if a.type_protos:
        return AttrType.TYPE_PROTOS
    if a.tp is not None:
        return AttrType.TYPE_PROTO
    if a.s:
        return AttrType.STRING
    if a.f != 0.0:
        return AttrType.FLOAT
    return AttrType.INT


def decode_node(buf: memoryview, pos: int, end: int) -> NodeProto:
    n = NodeProto()
    for fnum, wt, vpos in _iter_fields(buf, pos, end):
        if fnum == 1:
            n.input.append(_get_str(buf, vpos))
        elif fnum == 2:
            n.output.append(_get_str(buf, vpos))
        elif fnum == 3:
            n.name = _get_str(buf, vpos)
        elif fnum == 4:
            n.op_type = _get_str(buf, vpos)
        elif fnum == 5:
            b, p, e = _submsg(buf, vpos, end)
            n.attribute.append(decode_attribute(b, p, e))
        elif fnum == 7:
            n.domain = _get_str(buf, vpos)
    return n


def decode_dimension(buf: memoryview, pos: int, end: int) -> Dimension:
    d = Dimension()
    for fnum, wt, vpos in _iter_fields(buf, pos, end):
        if fnum == 1:
            d.dim_value, _ = _read_signed_varint(buf, vpos)
        elif fnum == 2:
            d.dim_param = _get_str(buf, vpos)
    return d


def decode_shape(buf: memoryview, pos: int, end: int) -> TensorShapeProto:
    s = TensorShapeProto()
    for fnum, wt, vpos in _iter_fields(buf, pos, end):
        if fnum == 1:
            b, p, e = _submsg(buf, vpos, end)
            s.dim.append(decode_dimension(b, p, e))
    return s


def _decode_tensor_type(buf: memoryview, pos: int, end: int) -> TensorTypeProto:
    tt = TensorTypeProto()
    for f2, w2, v2 in _iter_fields(buf, pos, end):
        if f2 == 1:
            tt.elem_type, _ = _read_varint(buf, v2)
        elif f2 == 2:
            b2, p2, e2 = _submsg(buf, v2, end)
            tt.shape = decode_shape(b2, p2, e2)
    return tt


def decode_type(buf: memoryview, pos: int, end: int) -> TypeProto:
    t = TypeProto()
    for fnum, wt, vpos in _iter_fields(buf, pos, end):
        if fnum == 1:
            b, p, e = _submsg(buf, vpos, end)
            t.tensor_type = _decode_tensor_type(b, p, e)
        elif fnum == 4:  # TypeProto.Sequence{elem_type=1}
            b, p, e = _submsg(buf, vpos, end)
            for f2, w2, v2 in _iter_fields(b, p, e):
                if f2 == 1:
                    b2, p2, e2 = _submsg(b, v2, e)
                    t.sequence_type = decode_type(b2, p2, e2)
            if t.sequence_type is None:
                t.sequence_type = TypeProto()
        elif fnum == 5:  # TypeProto.Map{key_type=1, value_type=2}
            mt = MapTypeProto()
            b, p, e = _submsg(buf, vpos, end)
            for f2, w2, v2 in _iter_fields(b, p, e):
                if f2 == 1:
                    mt.key_type, _ = _read_varint(b, v2)
                elif f2 == 2:
                    b2, p2, e2 = _submsg(b, v2, e)
                    mt.value_type = decode_type(b2, p2, e2)
            t.map_type = mt
        elif fnum == 8:  # TypeProto.SparseTensor{elem_type=1, shape=2}
            b, p, e = _submsg(buf, vpos, end)
            t.sparse_tensor_type = _decode_tensor_type(b, p, e)
        elif fnum == 9:  # TypeProto.Optional{elem_type=1}
            b, p, e = _submsg(buf, vpos, end)
            for f2, w2, v2 in _iter_fields(b, p, e):
                if f2 == 1:
                    b2, p2, e2 = _submsg(b, v2, e)
                    t.optional_type = decode_type(b2, p2, e2)
            if t.optional_type is None:
                t.optional_type = TypeProto()
    return t


def decode_value_info(buf: memoryview, pos: int, end: int) -> ValueInfoProto:
    v = ValueInfoProto()
    for fnum, wt, vpos in _iter_fields(buf, pos, end):
        if fnum == 1:
            v.name = _get_str(buf, vpos)
        elif fnum == 2:
            b, p, e = _submsg(buf, vpos, end)
            v.type = decode_type(b, p, e)
    return v


def decode_graph(buf: memoryview, pos: int, end: int) -> GraphProto:
    g = GraphProto()
    for fnum, wt, vpos in _iter_fields(buf, pos, end):
        if fnum == 1:
            b, p, e = _submsg(buf, vpos, end)
            g.node.append(decode_node(b, p, e))
        elif fnum == 2:
            g.name = _get_str(buf, vpos)
        elif fnum == 5:
            b, p, e = _submsg(buf, vpos, end)
            g.initializer.append(decode_tensor(b, p, e))
        elif fnum == 15:
            b, p, e = _submsg(buf, vpos, end)
            g.sparse_initializer.append(decode_sparse_tensor(b, p, e))
        elif fnum == 11:
            b, p, e = _submsg(buf, vpos, end)
            g.input.append(decode_value_info(b, p, e))
        elif fnum == 12:
            b, p, e = _submsg(buf, vpos, end)
            g.output.append(decode_value_info(b, p, e))
        elif fnum == 13:
            b, p, e = _submsg(buf, vpos, end)
            g.value_info.append(decode_value_info(b, p, e))
    return g


def _decode_opset(buf: memoryview, pos: int, end: int) -> OperatorSetId:
    opset = OperatorSetId()
    for fnum, wt, vpos in _iter_fields(buf, pos, end):
        if fnum == 1:
            opset.domain = _get_str(buf, vpos)
        elif fnum == 2:
            opset.version, _ = _read_varint(buf, vpos)
    return opset


def decode_function(buf: memoryview, pos: int, end: int) -> FunctionProto:
    f = FunctionProto()
    for fnum, wt, vpos in _iter_fields(buf, pos, end):
        if fnum == 1:
            f.name = _get_str(buf, vpos)
        elif fnum == 4:
            f.input.append(_get_str(buf, vpos))
        elif fnum == 5:
            f.output.append(_get_str(buf, vpos))
        elif fnum == 6:
            f.attribute.append(_get_str(buf, vpos))
        elif fnum == 7:
            b, p, e = _submsg(buf, vpos, end)
            f.node.append(decode_node(b, p, e))
        elif fnum == 9:
            b, p, e = _submsg(buf, vpos, end)
            f.opset_import.append(_decode_opset(b, p, e))
        elif fnum == 10:
            f.domain = _get_str(buf, vpos)
        elif fnum == 11:
            b, p, e = _submsg(buf, vpos, end)
            f.attribute_proto.append(decode_attribute(b, p, e))
        elif fnum == 13:
            f.overload = _get_str(buf, vpos)
    return f


def decode_model(data: Union[bytes, bytearray, memoryview]) -> ModelProto:
    """Decode a serialized ONNX ModelProto."""
    buf = memoryview(bytes(data))
    m = ModelProto()
    end = len(buf)
    for fnum, wt, vpos in _iter_fields(buf, 0, end):
        if fnum == 1:
            m.ir_version, _ = _read_varint(buf, vpos)
        elif fnum == 2:
            m.producer_name = _get_str(buf, vpos)
        elif fnum == 3:
            m.producer_version = _get_str(buf, vpos)
        elif fnum == 4:
            m.domain = _get_str(buf, vpos)
        elif fnum == 5:
            m.model_version, _ = _read_varint(buf, vpos)
        elif fnum == 7:
            b, p, e = _submsg(buf, vpos, end)
            m.graph = decode_graph(b, p, e)
        elif fnum == 8:
            b, p, e = _submsg(buf, vpos, end)
            m.opset_import.append(_decode_opset(b, p, e))
        elif fnum == 25:
            b, p, e = _submsg(buf, vpos, end)
            m.functions.append(decode_function(b, p, e))
    return m


def load_model(path) -> ModelProto:
    """Load and decode an ONNX model file."""
    with open(path, "rb") as f:
        return decode_model(f.read())


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def encode_tensor(t: TensorProto) -> bytes:
    out = bytearray()
    if t.dims:
        _write_packed_int64(out, 1, t.dims)
    if t.data_type:
        _write_int_field(out, 2, t.data_type)
    if t.float_data:
        _write_packed_float(out, 4, t.float_data)
    if t.int32_data:
        _write_packed_int64(out, 5, t.int32_data)
    for s in t.string_data:
        _write_len_field(out, 6, s)
    if t.int64_data:
        _write_packed_int64(out, 7, t.int64_data)
    if t.name:
        _write_string(out, 8, t.name)
    if t.raw_data:
        _write_len_field(out, 9, t.raw_data)
    if t.double_data:
        _write_len_field(
            out, 10, np.asarray(t.double_data, dtype="<f8").tobytes()
        )
    if t.uint64_data:
        _write_packed_int64(out, 11, t.uint64_data)
    for key, value in t.external_data.items():
        entry = bytearray()
        _write_string(entry, 1, key)
        _write_string(entry, 2, value)
        _write_len_field(out, 13, bytes(entry))
    if t.data_location:
        _write_int_field(out, 14, t.data_location)
    return bytes(out)


def encode_sparse_tensor(s: SparseTensorProto) -> bytes:
    out = bytearray()
    if s.values is not None:
        _write_len_field(out, 1, encode_tensor(s.values))
    if s.indices is not None:
        _write_len_field(out, 2, encode_tensor(s.indices))
    if s.dims:
        _write_packed_int64(out, 3, s.dims)
    return bytes(out)


def encode_attribute(a: AttributeProto) -> bytes:
    out = bytearray()
    _write_string(out, 1, a.name)
    if a.type == AttrType.FLOAT:
        _write_float_field(out, 2, a.f)
    elif a.type == AttrType.INT:
        _write_int_field(out, 3, a.i)
    elif a.type == AttrType.STRING:
        _write_len_field(out, 4, a.s)
    elif a.type == AttrType.TENSOR and a.t is not None:
        _write_len_field(out, 5, encode_tensor(a.t))
    elif a.type == AttrType.GRAPH and a.g is not None:
        _write_len_field(out, 6, encode_graph(a.g))
    elif a.type == AttrType.FLOATS:
        _write_packed_float(out, 7, a.floats)
    elif a.type == AttrType.INTS:
        _write_packed_int64(out, 8, a.ints)
    elif a.type == AttrType.STRINGS:
        for s in a.strings:
            _write_len_field(out, 9, s)
    elif a.type == AttrType.TENSORS:
        for t in a.tensors:
            _write_len_field(out, 10, encode_tensor(t))
    elif a.type == AttrType.GRAPHS:
        for g in a.graphs:
            _write_len_field(out, 11, encode_graph(g))
    elif a.type == AttrType.SPARSE_TENSOR and a.sparse_tensor is not None:
        _write_len_field(out, 22, encode_sparse_tensor(a.sparse_tensor))
    elif a.type == AttrType.SPARSE_TENSORS:
        for s in a.sparse_tensors:
            _write_len_field(out, 23, encode_sparse_tensor(s))
    elif a.type == AttrType.TYPE_PROTO and a.tp is not None:
        _write_len_field(out, 14, encode_type(a.tp))
    elif a.type == AttrType.TYPE_PROTOS:
        for tp in a.type_protos:
            _write_len_field(out, 15, encode_type(tp))
    if a.type != AttrType.UNDEFINED:
        _write_int_field(out, 20, a.type)
    if a.ref_attr_name:
        _write_string(out, 21, a.ref_attr_name)
    return bytes(out)


def encode_node(n: NodeProto) -> bytes:
    out = bytearray()
    for s in n.input:
        _write_string(out, 1, s)
    for s in n.output:
        _write_string(out, 2, s)
    if n.name:
        _write_string(out, 3, n.name)
    _write_string(out, 4, n.op_type)
    for a in n.attribute:
        _write_len_field(out, 5, encode_attribute(a))
    if n.domain:
        _write_string(out, 7, n.domain)
    return bytes(out)


def _encode_tensor_type(tt: TensorTypeProto) -> bytes:
    tt_out = bytearray()
    _write_int_field(tt_out, 1, tt.elem_type)
    if tt.shape is not None:
        sh_out = bytearray()
        for d in tt.shape.dim:
            d_out = bytearray()
            if d.dim_value is not None:
                _write_int_field(d_out, 1, d.dim_value)
            elif d.dim_param:
                _write_string(d_out, 2, d.dim_param)
            _write_len_field(sh_out, 1, bytes(d_out))
        _write_len_field(tt_out, 2, bytes(sh_out))
    return bytes(tt_out)


def encode_type(t: TypeProto) -> bytes:
    out = bytearray()
    if t.tensor_type is not None:
        _write_len_field(out, 1, _encode_tensor_type(t.tensor_type))
    elif t.sequence_type is not None:
        seq = bytearray()
        _write_len_field(seq, 1, encode_type(t.sequence_type))
        _write_len_field(out, 4, bytes(seq))
    elif t.map_type is not None:
        mp = bytearray()
        _write_int_field(mp, 1, t.map_type.key_type)
        if t.map_type.value_type is not None:
            _write_len_field(mp, 2, encode_type(t.map_type.value_type))
        _write_len_field(out, 5, bytes(mp))
    elif t.sparse_tensor_type is not None:
        _write_len_field(out, 8, _encode_tensor_type(t.sparse_tensor_type))
    elif t.optional_type is not None:
        opt = bytearray()
        _write_len_field(opt, 1, encode_type(t.optional_type))
        _write_len_field(out, 9, bytes(opt))
    return bytes(out)


def encode_value_info(v: ValueInfoProto) -> bytes:
    out = bytearray()
    _write_string(out, 1, v.name)
    if v.type is not None:
        _write_len_field(out, 2, encode_type(v.type))
    return bytes(out)


def encode_graph(g: GraphProto) -> bytes:
    out = bytearray()
    for n in g.node:
        _write_len_field(out, 1, encode_node(n))
    if g.name:
        _write_string(out, 2, g.name)
    for t in g.initializer:
        _write_len_field(out, 5, encode_tensor(t))
    for s in g.sparse_initializer:
        _write_len_field(out, 15, encode_sparse_tensor(s))
    for v in g.input:
        _write_len_field(out, 11, encode_value_info(v))
    for v in g.output:
        _write_len_field(out, 12, encode_value_info(v))
    for v in g.value_info:
        _write_len_field(out, 13, encode_value_info(v))
    return bytes(out)


def encode_model(m: ModelProto) -> bytes:
    out = bytearray()
    _write_int_field(out, 1, m.ir_version)
    if m.producer_name:
        _write_string(out, 2, m.producer_name)
    if m.producer_version:
        _write_string(out, 3, m.producer_version)
    if m.domain:
        _write_string(out, 4, m.domain)
    if m.model_version:
        _write_int_field(out, 5, m.model_version)
    if m.graph is not None:
        _write_len_field(out, 7, encode_graph(m.graph))
    for opset in m.opset_import:
        _write_len_field(out, 8, _encode_opset(opset))
    for fn in m.functions:
        _write_len_field(out, 25, encode_function(fn))
    return bytes(out)


def _encode_opset(opset: OperatorSetId) -> bytes:
    o = bytearray()
    if opset.domain:
        _write_string(o, 1, opset.domain)
    _write_int_field(o, 2, opset.version)
    return bytes(o)


def encode_function(f: FunctionProto) -> bytes:
    out = bytearray()
    if f.name:
        _write_string(out, 1, f.name)
    for s in f.input:
        _write_string(out, 4, s)
    for s in f.output:
        _write_string(out, 5, s)
    for s in f.attribute:
        _write_string(out, 6, s)
    for n in f.node:
        _write_len_field(out, 7, encode_node(n))
    for opset in f.opset_import:
        _write_len_field(out, 9, _encode_opset(opset))
    if f.domain:
        _write_string(out, 10, f.domain)
    for a in f.attribute_proto:
        _write_len_field(out, 11, encode_attribute(a))
    if f.overload:
        _write_string(out, 13, f.overload)
    return bytes(out)


def save_model(m: ModelProto, path) -> None:
    with open(path, "wb") as f:
        f.write(encode_model(m))


# ---------------------------------------------------------------------------
# Wire-schema field policy
# ---------------------------------------------------------------------------
#
# Every field number of every onnx.proto message this codec touches is
# pinned here as exactly one of:
#   "decoded"  — the decoder materializes it into the dataclass above;
#   "skipped"  — deliberately ignored, with a rationale proving the skip
#                cannot change inference semantics (doc strings, metadata,
#                advisory annotations, training-only payloads);
#   "rejected" — semantically load-bearing but unsupported: the decoder
#                raises loudly instead of dropping it.
# tests/test_wire_schema_audit.py cross-checks this table against a frozen
# transcription of the onnx.proto schema (same discipline as the operator
# spec table, tests/_onnx_spec_table.py), so no semantic field can fall
# through ``_skip_field`` silently again — the failure mode a round-4
# review demonstrated for GraphProto.sparse_initializer. ONNX Runtime
# consumes every "decoded"/"rejected" field at session load (reference:
# src/classifier.rs:348-350).
#
# Format: {message: {field_number: (field_name, status, rationale)}}
# (rationale empty for "decoded").

WIRE_POLICY = {
    "ModelProto": {
        1: ("ir_version", "decoded", ""),
        2: ("producer_name", "decoded", ""),
        3: ("producer_version", "decoded", ""),
        4: ("domain", "decoded", ""),
        5: ("model_version", "decoded", ""),
        6: ("doc_string", "skipped", "documentation only"),
        7: ("graph", "decoded", ""),
        8: ("opset_import", "decoded", ""),
        14: ("metadata_props", "skipped", "free-form key/value metadata"),
        20: (
            "training_info",
            "skipped",
            "training-only (TrainingInfoProto); this engine and the "
            "reference are inference-only (SURVEY §0) and ONNX Runtime "
            "InferenceSession likewise ignores it",
        ),
        25: ("functions", "decoded", ""),
        26: (
            "configuration",
            "skipped",
            "IR v11 multi-device deployment annotation (advisory device "
            "placement hints); this engine shards via jax.sharding "
            "meshes, and plain single-device evaluation of the graph "
            "remains correct when ignored",
        ),
    },
    "GraphProto": {
        1: ("node", "decoded", ""),
        2: ("name", "decoded", ""),
        5: ("initializer", "decoded", ""),
        10: ("doc_string", "skipped", "documentation only"),
        11: ("input", "decoded", ""),
        12: ("output", "decoded", ""),
        13: ("value_info", "decoded", ""),
        14: (
            "quantization_annotation",
            "skipped",
            "advisory tensor-to-quant-parameter name map; quantization "
            "semantics come from the Q/DQ and QLinear* nodes themselves, "
            "which are fully evaluated",
        ),
        15: ("sparse_initializer", "decoded", ""),
        16: ("metadata_props", "skipped", "free-form key/value metadata"),
    },
    "NodeProto": {
        1: ("input", "decoded", ""),
        2: ("output", "decoded", ""),
        3: ("name", "decoded", ""),
        4: ("op_type", "decoded", ""),
        5: ("attribute", "decoded", ""),
        6: ("doc_string", "skipped", "documentation only"),
        7: ("domain", "decoded", ""),
        8: (
            "overload",
            "skipped",
            "selects between same-name model-local function overloads "
            "(IR v10); function inlining matches on (domain, op_type) and "
            "no known exporter emits overloaded functions — a model that "
            "does inlines the first definition, and differing signatures "
            "fail loudly at trace time",
        ),
        9: ("metadata_props", "skipped", "free-form key/value metadata"),
        10: (
            "device_configurations",
            "skipped",
            "IR v11 multi-device annotation (advisory sharding hints "
            "keyed to ModelProto.configuration); see ModelProto field 26",
        ),
    },
    "AttributeProto": {
        1: ("name", "decoded", ""),
        2: ("f", "decoded", ""),
        3: ("i", "decoded", ""),
        4: ("s", "decoded", ""),
        5: ("t", "decoded", ""),
        6: ("g", "decoded", ""),
        7: ("floats", "decoded", ""),
        8: ("ints", "decoded", ""),
        9: ("strings", "decoded", ""),
        10: ("tensors", "decoded", ""),
        11: ("graphs", "decoded", ""),
        13: ("doc_string", "skipped", "documentation only"),
        14: ("tp", "decoded", ""),
        15: ("type_protos", "decoded", ""),
        20: ("type", "decoded", ""),
        21: ("ref_attr_name", "decoded", ""),
        22: ("sparse_tensor", "decoded", ""),
        23: ("sparse_tensors", "decoded", ""),
    },
    "TensorProto": {
        1: ("dims", "decoded", ""),
        2: ("data_type", "decoded", ""),
        3: (
            "segment",
            "rejected",
            "a segment is a *slice* of a logically larger tensor split "
            "across protos; decoding without stitching would silently "
            "truncate weights, so decode_tensor raises",
        ),
        4: ("float_data", "decoded", ""),
        5: ("int32_data", "decoded", ""),
        6: ("string_data", "decoded", ""),
        7: ("int64_data", "decoded", ""),
        8: ("name", "decoded", ""),
        9: ("raw_data", "decoded", ""),
        10: ("double_data", "decoded", ""),
        11: ("uint64_data", "decoded", ""),
        12: ("doc_string", "skipped", "documentation only"),
        13: ("external_data", "decoded", ""),
        14: ("data_location", "decoded", ""),
        16: ("metadata_props", "skipped", "free-form key/value metadata"),
    },
    "SparseTensorProto": {
        1: ("values", "decoded", ""),
        2: ("indices", "decoded", ""),
        3: ("dims", "decoded", ""),
    },
    "TypeProto": {
        1: ("tensor_type", "decoded", ""),
        4: ("sequence_type", "decoded", ""),
        5: ("map_type", "decoded", ""),
        6: ("denotation", "skipped", "semantic documentation tag only"),
        7: (
            "opaque_type",
            "skipped",
            "declares a custom non-tensor type consumed only by custom "
            "ops; any node consuming one is itself rejected by the op "
            "registry (unsupported-op ModelLoadError), so the type "
            "declaration alone is inert",
        ),
        8: ("sparse_tensor_type", "decoded", ""),
        9: ("optional_type", "decoded", ""),
    },
    "TensorShapeProto": {
        1: ("dim", "decoded", ""),
    },
    "TensorShapeProto.Dimension": {
        1: ("dim_value", "decoded", ""),
        2: ("dim_param", "decoded", ""),
        3: ("denotation", "skipped", "semantic documentation tag only"),
    },
    "ValueInfoProto": {
        1: ("name", "decoded", ""),
        2: ("type", "decoded", ""),
        3: ("doc_string", "skipped", "documentation only"),
        4: ("metadata_props", "skipped", "free-form key/value metadata"),
    },
    "OperatorSetIdProto": {
        1: ("domain", "decoded", ""),
        2: ("version", "decoded", ""),
    },
    "StringStringEntryProto": {
        1: ("key", "decoded", ""),
        2: ("value", "decoded", ""),
    },
    "FunctionProto": {
        1: ("name", "decoded", ""),
        4: ("input", "decoded", ""),
        5: ("output", "decoded", ""),
        6: ("attribute", "decoded", ""),
        7: ("node", "decoded", ""),
        8: ("doc_string", "skipped", "documentation only"),
        9: ("opset_import", "decoded", ""),
        10: ("domain", "decoded", ""),
        11: ("attribute_proto", "decoded", ""),
        12: (
            "value_info",
            "skipped",
            "optional declared types for values *inside* a function body; "
            "purely advisory (shape/type hints), inlined bodies infer "
            "types from the actual tensors flowing through",
        ),
        13: ("overload", "decoded", ""),
        14: ("metadata_props", "skipped", "free-form key/value metadata"),
    },
}


# ---------------------------------------------------------------------------
# Convenience builders (used by model generators and tests)
# ---------------------------------------------------------------------------


def make_attr(name: str, value) -> AttributeProto:
    """Build an AttributeProto from a natural Python value."""
    a = AttributeProto(name=name)
    if isinstance(value, TensorProto):
        a.type, a.t = AttrType.TENSOR, value
    elif isinstance(value, GraphProto):
        a.type, a.g = AttrType.GRAPH, value
    elif isinstance(value, float):
        a.type, a.f = AttrType.FLOAT, value
    elif isinstance(value, bool):
        a.type, a.i = AttrType.INT, int(value)
    elif isinstance(value, int):
        a.type, a.i = AttrType.INT, value
    elif isinstance(value, str):
        a.type, a.s = AttrType.STRING, value.encode("utf-8")
    elif isinstance(value, bytes):
        a.type, a.s = AttrType.STRING, value
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, int) for v in value):
            a.type, a.ints = AttrType.INTS, list(value)
        elif all(isinstance(v, (int, float)) for v in value):
            a.type, a.floats = AttrType.FLOATS, [float(v) for v in value]
        elif all(isinstance(v, str) for v in value):
            a.type, a.strings = AttrType.STRINGS, [v.encode("utf-8") for v in value]
        elif all(isinstance(v, TensorProto) for v in value):
            a.type, a.tensors = AttrType.TENSORS, list(value)
        else:
            raise ValueError(f"unsupported attribute list for {name!r}")
    elif isinstance(value, np.ndarray):
        a.type, a.t = AttrType.TENSOR, TensorProto.from_numpy(value)
    else:
        raise ValueError(f"unsupported attribute value for {name!r}: {type(value)}")
    return a


def make_node(op_type: str, inputs, outputs, name: str = "", domain: str = "",
              **attrs) -> NodeProto:
    return NodeProto(
        op_type=op_type,
        name=name or f"{op_type}_{outputs[0]}",
        domain=domain,
        input=list(inputs),
        output=list(outputs),
        attribute=[make_attr(k, v) for k, v in attrs.items()],
    )


def make_value_info(name: str, elem_type: int, shape) -> ValueInfoProto:
    dims = []
    for d in shape:
        if isinstance(d, str):
            dims.append(Dimension(dim_param=d))
        else:
            dims.append(Dimension(dim_value=int(d)))
    return ValueInfoProto(
        name=name,
        type=TypeProto(
            tensor_type=TensorTypeProto(
                elem_type=elem_type, shape=TensorShapeProto(dim=dims)
            )
        ),
    )


def make_model(graph: GraphProto, opset_version: int = 17, ir_version: int = 8) -> ModelProto:
    return ModelProto(
        ir_version=ir_version,
        producer_name="birdnet_tpu",
        producer_version="0.1",
        graph=graph,
        opset_import=[OperatorSetId(domain="", version=opset_version)],
    )
