"""Imported-model checkpointing: fast native weight cache.

The counterpart of :mod:`birdnet_tpu.checkpoint`, in the same ``.btck``
format (version 2: a zip of ``manifest.json``, the optimized graph's bytes
``graph.pb`` and flat raw tensor entries ``p/<name>`` and ``c/<name>``), so
a file saved by either package loads in the other. ONNX protobuf decode and
the import-time passes (Conv+BN folding, fused-node bundling) run once;
loading skips protobuf tensor materialization and the passes (the
ONNX → weights "serialized once" conversion of SURVEY §5.4; reference
analog: the persisted TensorRT engine, src/tensorrt_config.rs:221-267).

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


def _tensor_meta(arrays) -> dict:
    return {
        name: {"dtype": str(a.dtype), "shape": list(a.shape)}
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
            zf.writestr(f"p/{name}", np.ascontiguousarray(a).tobytes())
        for name, a in model.consts.items():
            zf.writestr(f"c/{name}", np.ascontiguousarray(a).tobytes())


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
                    out[name] = np.frombuffer(raw, dtype=np.dtype(info["dtype"])).reshape(
                        info["shape"]
                    )
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
