"""ONNX graph → eager PyTorch forward.

The counterpart of :mod:`birdnet_tpu.compiler.importer`. The graph is
decoded by :mod:`birdnet_tpu_torch.onnx.proto`, rewritten by the same
import-time passes (Conv+BN folding, the fused frontend / MBConv /
stage-prefix bundling), its float initializers become the params
dictionary, and :func:`make_forward` interprets the node list eagerly
through the op registry in :mod:`birdnet_tpu_torch.compiler.ops`.

Eager tensors are concrete, so there is no trace-time constant fold: a
lowering that sees only numpy constants answers in numpy. Model-local
functions are inlined at import (:mod:`.functions`, a copy of the JAX
package's); ``freeze_inputs`` turns graph inputs into host constants; a
merged decoder's flag inputs (``dispatch_inputs``) make
:func:`make_forward` dispatch on the flags' values to one specialized
forward per value, as the JAX package's does.
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
    # Scalar flag inputs whose only effect is gating ``If`` branches (the
    # merged-decoder ``use_cache_branch`` pattern). They stay in
    # ``input_names``; ``make_forward`` dispatches on their values (see
    # ``_find_dispatch_inputs``).
    dispatch_inputs: List[str] = field(default_factory=list)

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
        if isinstance(arr, onnx_proto.WireTensor):
            # bfloat16 / float8 weights as float ones, 4-bit ones as int8
            # ones: the JAX package's split leaves its ml_dtypes arrays
            # among the compile-time constants, which its program holds on
            # the device as the port's params are held.
            big = (arr.numel() >= _QPARAM_MIN_SIZE and arr.ndim >= 2
                   if isinstance(arr, onnx_proto.Int4Tensor)
                   else arr.numel() >= _PARAM_MIN_SIZE)
            (params if big else consts)[name] = arr
        elif np.issubdtype(arr.dtype, np.floating) and arr.size >= _PARAM_MIN_SIZE:
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
                optimize: bool = True,
                freeze_inputs: Optional[Dict[str, object]] = None,
                auto_specialize: bool = True) -> ImportedModel:
    """Load an ONNX model from a path, serialized bytes, or ModelProto.

    ``optimize`` runs the import-time graph rewrites of
    :mod:`birdnet_tpu_torch.compiler.optimize` (a byte-identical copy of the
    JAX package's passes), then the port's own attention bundling
    (:mod:`birdnet_tpu_torch.compiler.fuse_attention`) and GELU bundling
    (:mod:`birdnet_tpu_torch.compiler.fuse_gelu`), whose chains fused and
    kept the counters ``birdnet.compiler.attention_fused``,
    ``.attention_kept``, ``.gelu_fused`` and ``.gelu_kept`` add up.

    ``freeze_inputs`` maps graph-input names to fixed values: each becomes
    a host constant (and leaves ``input_names``), so an ``If`` gated on it
    folds on the host and only its branch runs: a merged decoder frozen to
    ``use_cache_branch=True`` or ``False`` is the split pair.

    ``auto_specialize`` (default on) records every scalar bool/int input
    whose only effect is gating ``If`` conditions in ``dispatch_inputs``;
    ``make_forward`` then dispatches on the flag's value to one
    specialized forward per value."""
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
        from .functions import inline_functions

        try:
            inline_functions(graph, model.functions)
        except ModelLoadError:
            raise
        except Exception as e:  # noqa: BLE001 - malformed function defs in
            # untrusted bytes surface as load errors, not internal crashes
            raise ModelLoadError(f"function inlining failed: {e}") from e
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
    if freeze_inputs:
        _freeze_graph_inputs(graph, tensors, freeze_inputs)
    if optimize:
        from ..utils.profiling import count
        from .fuse_attention import fuse_attention
        from .fuse_gelu import fuse_gelu
        from .optimize import optimize_graph

        _stand_in_wire_floats(tensors)
        try:
            optimize_graph(graph, tensors)
        finally:
            _restore_wire_floats(tensors)
        fused, kept = fuse_attention(graph, tensors, opset)
        count("birdnet.compiler.attention_fused", fused)
        count("birdnet.compiler.attention_kept", kept)
        fused, kept = fuse_gelu(graph, tensors)
        count("birdnet.compiler.gelu_fused", fused)
        count("birdnet.compiler.gelu_kept", kept)

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
    # After the reference check: the flag use analysis is sound only on a
    # topologically ordered graph.
    if auto_specialize:
        imported.dispatch_inputs = _find_dispatch_inputs(graph, input_names)
    return imported


class _WireStandIn(np.ndarray):
    """A float32 stand-in for a bfloat16 / float8 initializer while the
    import-time passes (copies of the JAX package's, written for numpy)
    run: its values are exact, and every array computed from it (a folded
    BatchNormalization's weight and bias) carries its ``wire_type``, so it
    goes back to that type, as the JAX package's ml_dtypes arrays do."""

    def __array_finalize__(self, obj):
        self.wire_type = getattr(obj, "wire_type", None)


def _stand_in_wire_floats(tensors: Dict[str, object]) -> None:
    """Each bfloat16 / float8 ``WireTensor`` of ``tensors`` as a
    :class:`_WireStandIn`."""
    for name, t in tensors.items():
        if isinstance(t, onnx_proto.WireTensor) and not isinstance(
                t, onnx_proto.Int4Tensor):
            a = t.float().numpy().view(_WireStandIn)
            a.wire_type = t.data_type
            tensors[name] = a


def _restore_wire_floats(tensors: Dict[str, object]) -> None:
    """Each stand-in (and each float array computed from one) back in its
    wire type, rounded from float32 (ml_dtypes' cast from float64 rounds
    through float32 too)."""
    for name, a in tensors.items():
        if isinstance(a, _WireStandIn) and a.wire_type is not None:
            dtype = onnx_proto._WIRE_FLOATS[a.wire_type][0]
            f32 = torch.from_numpy(np.array(a, dtype=np.float32))
            tensors[name] = onnx_proto.wire_tensor(f32.to(dtype))


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


# Value- (or truthiness-) preserving unary ops through which a dispatch flag
# may pass on its way to an ``If`` condition; only input 0 is the data path.
# Cast qualifies only to BOOL: a narrowing integer cast is not
# truthiness-preserving (int32 256 → uint8 0).
_DISPATCH_PASSTHROUGH = frozenset(
    {"Cast", "Identity", "Not", "Squeeze", "Unsqueeze", "Reshape"}
)
# Element types a dispatch flag may declare.
_DISPATCH_ELEM_TYPES = frozenset(
    {
        onnx_proto.DataType.BOOL,
        onnx_proto.DataType.UINT8,
        onnx_proto.DataType.INT8,
        onnx_proto.DataType.INT16,
        onnx_proto.DataType.INT32,
        onnx_proto.DataType.INT64,
    }
)


def _find_dispatch_inputs(graph: GraphProto, input_names) -> List[str]:
    """Merged-decoder flag inputs (birdnet_tpu/compiler/importer.py:331).

    A graph input qualifies when it declares a bool/int element type with
    an explicit scalar or ``[1]`` shape, and every use of it (across the
    top graph and all nested subgraphs, through chains of
    ``_DISPATCH_PASSTHROUGH`` ops) is as the condition of an ``If``, with
    at least one such ``If``: the outputs then depend only on the flag's
    truthiness, so one specialized forward per value is exact."""
    out: List[str] = []
    for vi in graph.input:
        if vi.name not in input_names:
            continue
        tt = vi.type.tensor_type if vi.type is not None else None
        if tt is None or tt.elem_type not in _DISPATCH_ELEM_TYPES:
            continue
        if tt.shape is None:
            continue  # no declared shape: cannot prove it is a scalar flag
        if _static_shape(vi) not in ([], [1]):
            continue
        if _flag_only_gates_if(graph, vi.name):
            out.append(vi.name)
    return out


def _flag_only_gates_if(graph: GraphProto, flag: str) -> bool:
    """True iff every use of ``flag`` (through passthrough chains, also
    closure-captured uses inside subgraphs) is an ``If`` condition and at
    least one ``If`` consumes it. Any other use, any graph or subgraph
    output exposing a derived value, or a subgraph formal input shadowing
    one, disqualifies the flag."""
    derived = {flag}
    found_if = [False]

    def walk(g: GraphProto) -> bool:
        if any(vi.name in derived for vi in g.output):
            return False
        for node in g.node:
            used = [
                i for i, inp in enumerate(node.input) if inp and inp in derived
            ]
            if used:
                ok_passthrough = (
                    node.op_type in _DISPATCH_PASSTHROUGH and used == [0]
                )
                if ok_passthrough and node.op_type == "Cast":
                    to = node.attrs.get("to")
                    ok_passthrough = (
                        to is not None
                        and int(to) == onnx_proto.DataType.BOOL
                    )
                if node.op_type == "If" and used == [0]:
                    found_if[0] = True
                elif ok_passthrough:
                    derived.update(o for o in node.output if o)
                else:
                    return False
            for sub in _node_subgraphs(node):
                if any(vi.name in derived for vi in sub.input):
                    return False  # formal input shadows a derived name
                if not walk(sub):
                    return False
        # A passthrough inside this graph may have derived one of its
        # outputs.
        return not any(vi.name in derived for vi in g.output)

    return walk(graph) and found_if[0]


def _node_subgraphs(node):
    for v in node.attrs.values():
        if isinstance(v, GraphProto):
            yield v
        elif isinstance(v, (list, tuple)):
            for item in v:
                if isinstance(item, GraphProto):
                    yield item


def _freeze_graph_inputs(graph, tensors, freeze_inputs) -> None:
    """Turn named graph inputs into initializer-style constants, cast to
    the input's declared element type and checked against its static dims
    (birdnet_tpu/compiler/importer.py:400-437)."""
    declared = {vi.name: vi for vi in graph.input}
    for name, value in freeze_inputs.items():
        if name in tensors:
            raise ValueError(
                f"freeze_inputs: {name!r} is an initializer, not a "
                f"runtime graph input"
            )
        vi = declared.get(name)
        if vi is None:
            avail = [n for n in declared if n not in tensors]
            raise ValueError(
                f"freeze_inputs: {name!r} is not a graph input "
                f"(inputs: {avail})"
            )
        arr = np.asarray(value)
        tt = vi.type.tensor_type if vi.type is not None else None
        if tt is not None and tt.elem_type in onnx_proto._DTYPE_TO_NUMPY:
            arr = arr.astype(onnx_proto._DTYPE_TO_NUMPY[tt.elem_type])
        want = _static_shape(vi)
        if arr.ndim == 0 and len(want) == 1 and want[0] in (1, None):
            arr = arr.reshape(1)  # python scalar for a [1]-shaped flag
        if len(want) not in (0, arr.ndim) or any(
            d is not None and d != a for d, a in zip(want, arr.shape)
        ):
            raise ValueError(
                f"freeze_inputs: {name!r} declares shape {want}, got "
                f"{list(arr.shape)}"
            )
        tensors[name] = arr


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


def release_schedule(graph: GraphProto, keep) -> List[Tuple[str, ...]]:
    """Per node of ``graph``, the values its nodes produce that no later
    node reads (inputs, and names read inside a node's subgraphs, count as
    reads of that node), less ``keep`` (the outputs): what
    :func:`interpret_graph` may drop from its environment once the node
    has run, so that a forward holds only its live intermediates."""
    from .optimize import _attr_subgraphs, _collect_used_names

    last: Dict[str, int] = {}
    produced = set()
    for i, node in enumerate(graph.node):
        reads = set(node.input)
        for attr in node.attribute:
            for sub in _attr_subgraphs(attr):
                _collect_used_names(sub, reads)
        for name in reads:
            last[name] = i
        for name in node.output:
            if name:
                produced.add(name)
                last.setdefault(name, i)
    schedule: List[List[str]] = [[] for _ in graph.node]
    for name, i in last.items():
        if name in produced and name not in keep:
            schedule[i].append(name)
    return [tuple(names) for names in schedule]


def interpret_graph(graph: GraphProto, opset: int, precision: str,
                    env: Dict[str, object], output_names, device,
                    subgraph_consts=None, release=None):
    """Interpret a node list eagerly against a pre-seeded environment.

    Shared by the top-level forward and by fused nodes, whose bodies read
    outer-scope values already present in ``env``. ``subgraph_consts``
    (:func:`subgraph_consts_to_device`) holds the initializers of the
    subgraphs that the nodes run. ``release`` (:func:`release_schedule`)
    names, per node, the values to drop from ``env`` once it has run."""
    for i, node in enumerate(graph.node):
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
            subgraph_consts=subgraph_consts,
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
        if release is not None:
            for name in release[i]:
                env.pop(name, None)
    return tuple(env[o] for o in output_names)


def params_to_torch(params: Dict[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """The imported params (numpy, as both packages' ``ImportedModel``
    holds them, or the codec's ``WireTensor`` for bfloat16, float8 and
    4-bit weights) as tensors on ``device``."""
    device = torch.device(device)
    return {name: _host_to_torch(arr, device) for name, arr in params.items()}


def _host_to_torch(arr, device) -> torch.Tensor:
    """A host array as a tensor on ``device``, copied (decoded weights are
    read-only views of the file). A bfloat16 or float8 ``WireTensor``
    becomes a plain tensor of its dtype; a 4-bit one stays an
    ``Int4Tensor`` on ``device``, so that lowerings still read its type."""
    if isinstance(arr, torch.Tensor):
        t = arr.as_subclass(torch.Tensor).to(device, copy=True)
        return t.as_subclass(onnx_proto.Int4Tensor) if isinstance(
            arr, onnx_proto.Int4Tensor) else t
    return torch.from_numpy(np.array(arr)).to(device)


def _is_float_operand(arr) -> bool:
    """A float host constant with at least one axis (bfloat16 and float8
    included): an operand that moves to the device once."""
    if isinstance(arr, onnx_proto.WireTensor):
        return arr.ndim > 0 and not isinstance(arr, onnx_proto.Int4Tensor)
    return np.issubdtype(arr.dtype, np.floating) and arr.ndim > 0


# Inputs that a lowering reads on the host although they are float: the
# resampling scales and ROI of Resize and Upsample.
_HOST_FLOAT_INPUTS = {"Resize": (1, 2), "Upsample": (1,)}


def _host_float_inputs(graph: GraphProto) -> set:
    """The names ``graph`` (and its subgraphs) reads at a position of
    ``_HOST_FLOAT_INPUTS``."""
    names = set()
    for node in graph.node:
        for i in _HOST_FLOAT_INPUTS.get(node.op_type, ()):
            if i < len(node.input) and node.input[i]:
                names.add(node.input[i])
        for sub in _node_subgraphs(node):
            names |= _host_float_inputs(sub)
    return names


def consts_to_device(consts: Dict[str, np.ndarray], device,
                     graph: Optional[GraphProto] = None) -> Dict[str, object]:
    """The constants as the interpreter's environment holds them. Float
    constants with at least one axis (small biases; bfloat16 and float8
    too) are operands: they move to ``device`` once, not per call. The rest
    stay host values (a 4-bit or 0-d wire value as its ``WireTensor``), and
    so do the float constants that ``graph`` reads as Resize/Upsample
    scales or ROI (shapes of the result, needed on the host)."""
    keep = _host_float_inputs(graph) if graph is not None else set()
    return {
        name: _host_to_torch(arr, device)
        if _is_float_operand(arr) and name not in keep
        else arr
        for name, arr in consts.items()
    }


def graph_consts_to_device(graph: GraphProto, device) -> Dict[str, object]:
    """A subgraph's own initializers, dense and sparse (densified), as
    :func:`consts_to_device` holds the top graph's."""
    values = {t.name: t.to_numpy() for t in graph.initializer}
    values.update({sp.name: sp.to_dense() for sp in graph.sparse_initializer})
    return consts_to_device(values, device, graph)


def subgraph_consts_to_device(graph: GraphProto, device) -> Dict[int, tuple]:
    """The initializers of every subgraph under ``graph`` (If branches, Loop
    and Scan bodies, fused bodies, generation encoders and decoders), each
    as ``(subgraph, graph_consts_to_device(subgraph))`` under
    ``id(subgraph)``. A forward builds them once and holds them for its
    life: its If, Loop and generation steps upload nothing, and the tensors
    that a captured CUDA graph reads stay alive as long as the forward."""
    out: Dict[int, tuple] = {}

    def walk(g):
        for node in g.node:
            for sub in _node_subgraphs(node):
                if id(sub) not in out:
                    out[id(sub)] = (sub, graph_consts_to_device(sub, device))
                    walk(sub)

    walk(graph)
    return out


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

    A model with ``dispatch_inputs`` gets a dispatching forward with the
    same signature (see ``_make_dispatching_forward``).
    """
    if precision not in ("fp32", "mixed", "fast", "bf16"):
        raise ValueError(f"unknown precision policy {precision!r}")
    _validate_ops(model)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = device_or_default(device)
    sub_consts = subgraph_consts_to_device(model.graph, device)
    if model.dispatch_inputs:
        return _make_dispatching_forward(model, precision, device, sub_consts)
    return _make_plain_forward(model, precision, device, sub_consts)


def _make_plain_forward(model: ImportedModel, precision: str, device,
                        sub_consts, pinned=None):
    """The forward of one program. ``sub_consts`` is
    :func:`subgraph_consts_to_device` of the model's graph, which the
    forward holds. ``pinned`` maps input names to host values seeded into
    the environment instead of taken from ``*inputs``."""
    graph, opset = model.graph, model.opset
    pinned = dict(pinned) if pinned else {}
    input_names = [n for n in model.input_names if n not in pinned]
    output_names = model.output_names
    consts = consts_to_device(model.consts, device, graph)
    release = release_schedule(graph, set(output_names))

    def forward(params: Dict[str, torch.Tensor], *inputs):
        if len(inputs) != len(input_names):
            raise ValueError(
                f"model expects {len(input_names)} inputs, got {len(inputs)}"
            )
        env: Dict[str, object] = dict(consts)
        env.update(params)
        env.update(pinned)
        env.update(zip(input_names, inputs))
        with torch.inference_mode():
            return interpret_graph(graph, opset, precision, env, output_names,
                                   device, sub_consts, release)

    return forward


def _make_dispatching_forward(model: ImportedModel, precision: str, device,
                              sub_consts):
    """Call-time dispatch over ``model.dispatch_inputs``
    (birdnet_tpu/compiler/importer.py:644-695): one specialized forward per
    observed truthiness of the flags, whose values are pinned as host
    numpy, so each ``If`` they gate folds on the host and runs one branch.

    A flag given as a host value costs nothing. A flag given as a tensor is
    read once, here at the forward's entry and outside every lowering: a
    sync when it lies on the card. (The JAX forward reads a concrete flag
    too; a traced one takes its single-program path, which the port does
    not need.)"""
    flag_names = list(model.dispatch_inputs)
    flag_idx = [model.input_names.index(n) for n in flag_names]
    flag_set = frozenset(flag_idx)
    declared = {vi.name: vi for vi in model.graph.input}
    cache: Dict[Tuple[bool, ...], object] = {}

    def _canonical(name: str, truth: bool) -> np.ndarray:
        vi = declared[name]
        dt = onnx_proto._DTYPE_TO_NUMPY.get(vi.type.tensor_type.elem_type,
                                            np.dtype(np.bool_))
        arr = np.asarray(1 if truth else 0, dtype=dt)
        return arr.reshape(1) if _static_shape(vi) == [1] else arr

    def _truth(flag) -> bool:
        if isinstance(flag, torch.Tensor):
            return bool(flag.reshape(-1)[0])
        return bool(np.asarray(flag).reshape(-1)[0])

    def forward(params: Dict[str, torch.Tensor], *inputs):
        if len(inputs) != len(model.input_names):
            raise ValueError(
                f"model expects {len(model.input_names)} inputs, got "
                f"{len(inputs)}"
            )
        key = tuple(_truth(inputs[i]) for i in flag_idx)
        fn = cache.get(key)
        if fn is None:
            pinned = {n: _canonical(n, t) for n, t in zip(flag_names, key)}
            fn = cache[key] = _make_plain_forward(model, precision, device,
                                                  sub_consts, pinned)
        return fn(params, *(x for i, x in enumerate(inputs) if i not in flag_set))

    return forward
