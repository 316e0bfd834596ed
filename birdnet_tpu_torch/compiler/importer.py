"""ONNX graph → eager PyTorch forward.

The counterpart of :mod:`birdnet_tpu.compiler.importer`. The graph is
decoded by :mod:`birdnet_tpu_torch.onnx.proto`, rewritten by the same
import-time passes (Conv+BN folding, the fused frontend / MBConv /
stage-prefix bundling), its float initializers become the params
dictionary, and :func:`make_forward` interprets the node list eagerly
through the op registry in :mod:`birdnet_tpu_torch.compiler.ops`.

Eager tensors are concrete, so there is no trace-time constant fold: a
lowering that sees only numpy constants answers in numpy. Merged-decoder
dispatch, frozen inputs and model-local functions are later ports.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..errors import ModelLoadError
from ..runtime import device_or_default
from ..onnx import proto as onnx_proto
from ..onnx.proto import GraphProto, ModelProto
from . import ops as op_registry

# Float initializers become params; tiny ones (thresholds, exponents,
# epsilon tensors) and all integer tensors stay host constants.
_PARAM_MIN_SIZE = 16
# Quantized (int8/uint8) rank-2+ weight tensors are params too; 1-D int8
# vectors (per-channel zero points) stay constants.
_QPARAM_MIN_SIZE = 1024


@dataclass
class ImportedModel:
    """A decoded ONNX model ready for execution."""

    graph: GraphProto
    opset: int
    params: Dict[str, np.ndarray]  # float weights
    consts: Dict[str, np.ndarray]  # host constants
    input_names: List[str] = field(default_factory=list)
    input_shapes: List[List[Optional[int]]] = field(default_factory=list)
    output_names: List[str] = field(default_factory=list)
    output_shapes: List[List[Optional[int]]] = field(default_factory=list)

    @property
    def num_outputs(self) -> int:
        return len(self.output_names)

    def param_bytes(self) -> int:
        return sum(int(p.nbytes) for p in self.params.values())

    def detection_shapes(self) -> Tuple[List[int], List[List[int]]]:
        """Input/output shapes in the form ``detect_model_type`` expects
        (dynamic dims reported as 1)."""
        inp = [d if d is not None else 1 for d in self.input_shapes[0]]
        outs = [
            [d if d is not None else 1 for d in sh] for sh in self.output_shapes
        ]
        return inp, outs


def split_params(tensors: Dict[str, np.ndarray]):
    """Partition initializers into params (weights) and host constants
    (shape/axis/threshold scalars)."""
    params: Dict[str, np.ndarray] = {}
    consts: Dict[str, np.ndarray] = {}
    for name, arr in tensors.items():
        if np.issubdtype(arr.dtype, np.floating) and arr.size >= _PARAM_MIN_SIZE:
            params[name] = arr
        elif (
            arr.dtype in (np.int8, np.uint8)
            and arr.ndim >= 2
            and arr.size >= _QPARAM_MIN_SIZE
        ):
            params[name] = arr
        else:
            consts[name] = arr
    return params, consts


def import_onnx(source: Union[str, bytes, ModelProto],
                optimize: bool = True) -> ImportedModel:
    """Load an ONNX model from a path, serialized bytes, or ModelProto.

    ``optimize`` runs the import-time graph rewrites of
    :mod:`birdnet_tpu_torch.compiler.optimize` (a byte-identical copy of the
    JAX package's passes)."""
    model_dir = None
    try:
        if isinstance(source, ModelProto):
            model = source
        elif isinstance(source, (bytes, bytearray, memoryview)):
            model = onnx_proto.decode_model(source)
        else:
            model_dir = os.path.dirname(os.path.abspath(str(source)))
            model = onnx_proto.load_model(source)
    except ModelLoadError:
        raise
    except Exception as e:  # noqa: BLE001 - any decode failure of untrusted
        # bytes (IndexError/KeyError/Unicode/Overflow/...) is a load error
        raise ModelLoadError(str(e)) from e

    if model.graph is None:
        raise ModelLoadError("model has no graph")
    graph = model.graph
    if model.functions:
        raise ModelLoadError(
            "model-local ONNX functions are not yet ported to "
            "birdnet_tpu_torch"
        )
    opset = 17
    for imp in model.opset_import:
        if imp.domain in ("", "ai.onnx"):
            opset = imp.version

    try:
        sparse_parts = [
            t
            for sp in graph.sparse_initializer
            for t in (sp.values, sp.indices)
            if t is not None
        ]
        for init in list(graph.initializer) + sparse_parts:
            if init.data_location == onnx_proto._DATA_LOCATION_EXTERNAL:
                if model_dir is None:
                    raise ModelLoadError(
                        "model uses external weight data; load it by file "
                        "path so the side files can be found"
                    )
                init.load_external(model_dir)
        tensors: Dict[str, np.ndarray] = {
            init.name: init.to_numpy() for init in graph.initializer
        }
        for sp in graph.sparse_initializer:
            if not sp.name:
                raise ModelLoadError("sparse initializer has no name")
            if sp.name in tensors:
                raise ModelLoadError(
                    f"initializer name {sp.name!r} appears in both "
                    f"initializer and sparse_initializer"
                )
            tensors[sp.name] = sp.to_dense()
    except ModelLoadError:
        raise
    except Exception as e:  # noqa: BLE001 - any decode failure of untrusted
        # bytes (IndexError/KeyError/Unicode/Overflow/...) is a load error
        raise ModelLoadError(str(e)) from e
    if optimize:
        from .optimize import optimize_graph

        optimize_graph(graph, tensors)

    params, consts = split_params(tensors)

    initializer_names = set(params) | set(consts)
    input_names, input_shapes = [], []
    for vi in graph.input:
        if vi.name in initializer_names:
            continue  # weights listed as graph inputs (older exporters)
        input_names.append(vi.name)
        input_shapes.append(_static_shape(vi))
    imported = ImportedModel(
        graph=graph,
        opset=opset,
        params=params,
        consts=consts,
        input_names=input_names,
        input_shapes=input_shapes,
        output_names=[vi.name for vi in graph.output],
        output_shapes=[_static_shape(vi) for vi in graph.output],
    )
    _validate_ops(imported)
    _validate_outputs(imported)
    _validate_refs(imported)
    return imported


def _validate_refs(model: ImportedModel) -> None:
    """Every node input must resolve to a graph input, an initializer, or
    the output of an *earlier* node (topological order, as ONNX requires).
    Subgraphs validate recursively with ONNX closure capture."""

    def walk(g: GraphProto, available: set, where: str) -> None:
        produced_later = set()
        for n in g.node:
            produced_later.update(o for o in n.output if o)
        avail = set(available)
        for node in g.node:
            for inp in node.input:
                if not inp or inp in avail:
                    continue
                label = f"node {node.name!r} ({node.op_type}){where}"
                if inp in produced_later:
                    raise ModelLoadError(
                        f"graph is not topologically sorted: {label} "
                        f"consumes {inp!r} before the node producing it"
                    )
                raise ModelLoadError(
                    f"{label} references unknown value {inp!r}"
                )
            for sub in _node_subgraphs(node):
                sub_avail = set(avail)
                sub_avail.update(vi.name for vi in sub.input)
                sub_avail.update(t.name for t in sub.initializer)
                sub_avail.update(sp.name for sp in sub.sparse_initializer)
                walk(sub, sub_avail, f" in subgraph {sub.name!r}")
            avail.update(o for o in node.output if o)

    top = set(model.input_names) | set(model.params) | set(model.consts)
    walk(model.graph, top, "")


def _node_subgraphs(node):
    for v in node.attrs.values():
        if isinstance(v, GraphProto):
            yield v
        elif isinstance(v, (list, tuple)):
            for item in v:
                if isinstance(item, GraphProto):
                    yield item


def _static_shape(vi) -> List[Optional[int]]:
    if vi.type is None or vi.type.tensor_type is None or vi.type.tensor_type.shape is None:
        return []
    out = []
    for d in vi.type.tensor_type.shape.dim:
        out.append(int(d.dim_value) if d.dim_value is not None and d.dim_value > 0 else None)
    return out


def _validate_outputs(model: ImportedModel) -> None:
    """Every graph output must be produced by a node or be an input or
    initializer."""
    produced = set(model.input_names) | set(model.params) | set(model.consts)
    for n in model.graph.node:
        produced.update(o for o in n.output if o)
    missing = [o for o in model.output_names if o not in produced]
    if missing:
        raise ModelLoadError(
            f"graph outputs are not produced by any node: "
            f"{', '.join(sorted(missing))}"
        )


def _validate_ops(model: ImportedModel) -> None:
    """Every top-level node must have a lowering in the port's registry."""
    unsupported = set()
    for n in model.graph.node:
        try:
            op_registry.get_lowering(n.op_type, n.domain)
        except NotImplementedError:
            unsupported.add(f"{n.domain}.{n.op_type}" if n.domain else n.op_type)
    if unsupported:
        raise ModelLoadError(
            f"model uses unsupported ops: {', '.join(sorted(unsupported))}"
        )


def interpret_graph(graph: GraphProto, opset: int, precision: str,
                    env: Dict[str, object], output_names, device):
    """Interpret a node list eagerly against a pre-seeded environment.

    Shared by the top-level forward and by fused nodes, whose bodies read
    outer-scope values already present in ``env``."""
    for node in graph.node:
        fn = op_registry.get_lowering(node.op_type, node.domain)
        n_out = len(node.output)
        while n_out and not node.output[n_out - 1]:
            n_out -= 1
        ctx = op_registry.OpContext(
            op_type=node.op_type,
            attrs=node.attrs,
            opset=opset,
            precision=precision,
            node_name=node.name,
            num_outputs=n_out,
            env=env,
            out_names=node.output,
            device=device,
        )
        try:
            args = [env[i] if i else None for i in node.input]
        except KeyError as e:
            raise ModelLoadError(
                f"node {node.name!r} ({node.op_type}) references unknown "
                f"value {e}"
            ) from e
        while args and args[-1] is None:
            args.pop()
        for out_name, out_val in zip(node.output, fn(ctx, *args)):
            if out_name:
                env[out_name] = out_val
    return tuple(env[o] for o in output_names)


def params_to_torch(params: Dict[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """The imported params (numpy, as both packages' ``ImportedModel``
    holds them) as tensors on ``device``."""
    device = torch.device(device)
    # np.array copies: decoded weights are read-only views of the file.
    return {
        name: torch.from_numpy(np.array(arr)).to(device)
        for name, arr in params.items()
    }


def consts_to_device(consts: Dict[str, np.ndarray],
                     device) -> Dict[str, object]:
    """The constants as the interpreter's environment holds them. Float
    constants with at least one axis (small biases) are operands, never
    shapes or axes: they move to ``device`` once, not per call. The rest
    stay host values."""
    return {
        name: torch.from_numpy(np.array(arr)).to(device)
        if np.issubdtype(arr.dtype, np.floating) and arr.ndim else arr
        for name, arr in consts.items()
    }


def make_forward(model: ImportedModel, precision: str = "fp32",
                 device=None):
    """Build the eager forward ``fn(params, *inputs) -> tuple(outputs)``.

    ``params`` is :func:`params_to_torch` of ``model.params`` and the
    inputs are tensors on ``device`` (default ``cuda:0``; without CUDA that
    raises :class:`RuntimeInitError`, so a host run passes ``"cpu"``).
    ``precision``: ``fp32`` | ``mixed`` |
    ``fast`` | ``bf16`` (see :mod:`birdnet_tpu_torch.compiler.ops`).

    TF32 is turned off for matmuls and cuDNN convolutions
    (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``, both process-wide): no policy asks
    for it, ``fp32`` parity with the JAX package's
    ``default_matmul_precision("highest")`` depends on it, and ``mixed``
    keeps full float32 STFT passes.
    """
    if precision not in ("fp32", "mixed", "fast", "bf16"):
        raise ValueError(f"unknown precision policy {precision!r}")
    _validate_ops(model)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = device_or_default(device)
    graph, opset = model.graph, model.opset
    input_names, output_names = model.input_names, model.output_names
    consts = consts_to_device(model.consts, device)

    def forward(params: Dict[str, torch.Tensor], *inputs):
        if len(inputs) != len(input_names):
            raise ValueError(
                f"model expects {len(input_names)} inputs, got {len(inputs)}"
            )
        env: Dict[str, object] = dict(consts)
        env.update(params)
        env.update(zip(input_names, inputs))
        with torch.inference_mode():
            return interpret_graph(graph, opset, precision, env, output_names,
                                   device)

    return forward
