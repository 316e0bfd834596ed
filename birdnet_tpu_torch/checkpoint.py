"""Imported-model checkpointing: fast native weight cache.

The counterpart of :mod:`birdnet_tpu.checkpoint`, in the same ``.btck``
format (version 2: a zip of ``manifest.json``, the optimized graph's bytes
``graph.pb`` and flat raw tensor entries ``p/<name>`` and ``c/<name>``), so
a file saved by either package loads in the other. ONNX protobuf decode and
the import-time passes (Conv+BN folding, fused-node bundling) run once;
loading skips protobuf tensor materialization and the passes (the
ONNX → weights "serialized once" conversion of SURVEY §5.4; reference
analog: the persisted TensorRT engine, src/tensorrt_config.rs:221-267).

A bfloat16, float8 or 4-bit tensor is written under ml_dtypes' dtype name
(``bfloat16``, ``float8_e4m3fn``, ..., ``int4``, ``uint4``: what the JAX
package writes) and read back into the codec's ``WireTensor`` without
ml_dtypes, bit for bit.

The manifest keeps the model's merged-decoder flag inputs
(``dispatch_inputs``); a manifest without the key predates it, and loading
re-detects the flags from the graph, as the JAX package does.
"""

from __future__ import annotations

import json
import zipfile
from typing import Union

import numpy as np

from .compiler.importer import ImportedModel
from .errors import ModelLoadError
from .onnx import proto as onnx_proto

_FORMAT_VERSION = 2  # v2: flat raw tensor entries (v1 was npz)


def _dtype_name(a) -> str:
    """The manifest's dtype name: numpy's, or for a wire value (bfloat16,
    float8, int4, uint4) ml_dtypes' name, which the JAX package writes."""
    if isinstance(a, onnx_proto.WireTensor):
        return onnx_proto.WIRE_NAMES[a.data_type]
    return str(a.dtype)


def _tensor_bytes(a) -> bytes:
    """An entry's raw bytes: a wire value's bits, a 4-bit value one nibble
    per byte with the high half clear (ml_dtypes' int4/uint4 layout)."""
    if isinstance(a, onnx_proto.Int4Tensor):
        return (onnx_proto.wire_bits(a).astype(np.uint8) & 0x0F).tobytes()
    if isinstance(a, onnx_proto.WireTensor):
        return onnx_proto.wire_bits(a).tobytes()
    return np.ascontiguousarray(a).tobytes()


def _from_bytes(raw: bytes, dtype: str, shape):
    """The inverse of :func:`_tensor_bytes` for the manifest's ``dtype``:
    a wire name gives a ``WireTensor``, without ml_dtypes."""
    code = onnx_proto._WIRE_BY_NAME.get(dtype)
    if code is None:
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
    if code in (onnx_proto.DataType.INT4, onnx_proto.DataType.UINT4):
        nib = np.frombuffer(raw, dtype=np.uint8) & 0x0F
        if code == onnx_proto.DataType.INT4:
            nib = np.where(nib > 7, nib.astype(np.int16) - 16, nib)
        return onnx_proto.wire_from_bits(nib, code, shape)
    carrier = onnx_proto._WIRE_FLOATS[code][1]
    return onnx_proto.wire_from_bits(np.frombuffer(raw, dtype=carrier), code, shape)


def _tensor_meta(arrays) -> dict:
    return {
        name: {"dtype": _dtype_name(a), "shape": list(a.shape)}
        for name, a in arrays.items()
    }


def save_checkpoint(model: ImportedModel, path) -> None:
    """Serialize an imported (already optimized) model."""
    manifest = {
        "format_version": _FORMAT_VERSION,
        "opset": model.opset,
        "input_names": model.input_names,
        "input_shapes": model.input_shapes,
        "output_names": model.output_names,
        "output_shapes": model.output_shapes,
        "params": _tensor_meta(model.params),
        "consts": _tensor_meta(model.consts),
        "dispatch_inputs": list(model.dispatch_inputs),
    }
    # The flat p/ and c/ entries are the authoritative weights; the graph's
    # initializer list still holds the PRE-optimization tensors (BN-fold
    # etc. mutate the tensors dict, not the protos), so persisting it would
    # double the checkpoint size AND record stale weights. Strip it for
    # serialization only.
    initializers = model.graph.initializer
    model.graph.initializer = []
    try:
        graph_bytes = onnx_proto.encode_graph(model.graph)
    finally:
        model.graph.initializer = initializers
    with zipfile.ZipFile(str(path), "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("manifest.json", json.dumps(manifest))
        zf.writestr("graph.pb", graph_bytes)
        # Flat raw-bytes entries: loading is a single read + frombuffer per
        # tensor (no npz header parsing / copies).
        for name, a in model.params.items():
            zf.writestr(f"p/{name}", _tensor_bytes(a))
        for name, a in model.consts.items():
            zf.writestr(f"c/{name}", _tensor_bytes(a))


def load_checkpoint(path) -> ImportedModel:
    """Load a ``.btck`` checkpoint back into an ImportedModel."""
    try:
        with zipfile.ZipFile(str(path), "r") as zf:
            manifest = json.loads(zf.read("manifest.json"))
            if manifest.get("format_version") != _FORMAT_VERSION:
                raise ModelLoadError(
                    f"unsupported checkpoint version {manifest.get('format_version')}"
                )
            graph_bytes = zf.read("graph.pb")

            def _load(prefix, meta):
                out = {}
                for name, info in meta.items():
                    raw = zf.read(f"{prefix}/{name}")
                    out[name] = _from_bytes(raw, info["dtype"], info["shape"])
                return out

            params = _load("p", manifest["params"])
            consts = _load("c", manifest["consts"])
    except (OSError, KeyError, ValueError, zipfile.BadZipFile,
            json.JSONDecodeError) as e:
        raise ModelLoadError(f"invalid checkpoint: {e}") from e

    try:
        graph = onnx_proto.decode_graph(
            memoryview(graph_bytes), 0, len(graph_bytes)
        )
    except Exception as e:
        # Same mapping as the ONNX import path (importer.py): corrupt
        # graph bytes inside a valid zip must surface as ModelLoadError,
        # not a raw IndexError/ValueError traceback.
        raise ModelLoadError(f"invalid checkpoint graph: {e}") from e
    model = ImportedModel(
        graph=graph,
        opset=manifest["opset"],
        params=params,
        consts=consts,
        input_names=manifest["input_names"],
        input_shapes=manifest["input_shapes"],
        output_names=manifest["output_names"],
        output_shapes=manifest["output_shapes"],
    )
    # The list round-trips (so an auto_specialize=False opt-out stays one);
    # a checkpoint without the key re-detects the flags from the graph.
    if "dispatch_inputs" in manifest:
        model.dispatch_inputs = list(manifest["dispatch_inputs"])
    else:
        from .compiler.importer import _find_dispatch_inputs

        model.dispatch_inputs = _find_dispatch_inputs(graph, model.input_names)
    return model


def import_any(source: Union[str, bytes]) -> ImportedModel:
    """Load a model from an ONNX file or a ``.btck`` checkpoint by sniffing
    the format (zip magic = checkpoint)."""
    from .compiler.importer import import_onnx

    if isinstance(source, (bytes, bytearray)):
        return import_onnx(source)
    path = str(source)
    try:
        with open(path, "rb") as f:
            magic = f.read(4)
    except OSError as e:
        raise ModelLoadError(str(e)) from e
    if magic[:2] == b"PK":
        return load_checkpoint(path)
    return import_onnx(path)
