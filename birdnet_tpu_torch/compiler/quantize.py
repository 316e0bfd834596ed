"""Post-training int8 quantization (PTQ) with activation calibration.

The reference exposes int8 only as a TensorRT flag backed by calibration
tables (reference: src/tensorrt_config.rs:100-160 int8 option); here PTQ is
a first-class model transformation:

1. **Calibrate** — interpret the float graph on calibration batches and
   record per-tensor abs-max for every tensor that will be quantized (the
   interpreter environment exposes all intermediates by name, so no hook
   machinery is needed).
2. **Rewrite to QDQ form** — symmetric int8: activations get per-tensor
   scales (zero point 0), weights per-output-channel scales, biases stay
   float (the fusion pass requantizes them to int32 at scale x_s*w_s).
   Layers producing graph outputs stay float (standard last-layer-fp PTQ:
   logits precision decides top-K order).
3. **Fuse** — the shared QDQ passes (:mod:`.optimize`) turn the sandwiches
   into QLinearConv/QLinearMatMul/_QLinearGemm running on the int8 MXU
   (2x bf16 peak on v5e) and sink pooling/reshapes into the int domain.

Symmetric quantization keeps every zero point statically zero, which the
lowerings turn into pure int8 MXU ops with no correction terms.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..errors import ModelLoadError
from ..onnx.proto import GraphProto, NodeProto, TensorProto, make_node
from .importer import ImportedModel, interpret_graph, split_params
from .optimize import follow_activation, optimize_graph

_QMAX = 127.0  # symmetric int8 in [-127, 127]: avoids the -128 asymmetry


def _eligible_nodes(
    graph: GraphProto,
    tensors: Dict[str, np.ndarray],
    quantize_first_layer: bool = False,
) -> List[Tuple[NodeProto, Optional[NodeProto], int, str]]:
    """(node, activation_chain_nodes, weight_channel_axis, original_x_name)
    for every Conv/MatMul/Gemm that can be quantized: float initializer
    weights, an optional float initializer bias, and a quantization target
    tensor (the output of the foldable activation chain — relu/sigmoid/
    silu/tanh — or the node itself) that is not a graph output."""
    gouts = {o.name for o in graph.output}
    gins = {vi.name for vi in graph.input if vi.name not in tensors}
    producers = {o: n for n in graph.node for o in n.output if o}
    consumers: Dict[str, List[NodeProto]] = {}
    for n in graph.node:
        for i in n.input:
            if i:
                consumers.setdefault(i, []).append(n)

    _LAYOUT = {
        "Reshape", "Transpose", "Flatten", "Squeeze", "Unsqueeze",
        "Identity", "Cast", "Slice", "Pad",
    }

    def _from_graph_input(name: str, depth: int = 8) -> bool:
        """True if the tensor is the raw model input, possibly routed
        through shape/layout ops (the audio frontend pattern)."""
        while depth > 0:
            if name in gins:
                return True
            p = producers.get(name)
            if p is None or p.op_type not in _LAYOUT:
                return False
            name = p.input[0]
            depth -= 1
        return False

    usage = {k: len(v) for k, v in consumers.items()}
    for o in gouts:
        usage[o] = usage.get(o, 0) + 1

    out = []
    for n in graph.node:
        if n.op_type not in ("Conv", "MatMul", "Gemm"):
            continue
        if len(n.input) < 2:
            continue
        if not quantize_first_layer and _from_graph_input(n.input[0]):
            # First-layer-fp (standard PTQ): in the audio models this is
            # the in-graph spectrogram frontend, whose huge dynamic range
            # dominates quantization error while contributing few FLOPs.
            continue
        w = tensors.get(n.input[1])
        if w is None or not np.issubdtype(w.dtype, np.floating) or w.ndim < 2:
            continue
        attrs = n.attrs
        if n.op_type == "Gemm" and (
            float(attrs.get("alpha", 1.0)) != 1.0
            or float(attrs.get("beta", 1.0)) != 1.0
        ):
            continue
        b_name = n.input[2] if len(n.input) > 2 and n.input[2] else ""
        if b_name and (
            b_name not in tensors
            or not np.issubdtype(tensors[b_name].dtype, np.floating)
        ):
            continue
        if n.op_type == "Conv":
            w_axis = 0
        elif n.op_type == "MatMul":
            w_axis = w.ndim - 1
        else:
            w_axis = 0 if int(attrs.get("transB", 0)) else 1
        _, act_nodes, t = follow_activation(n, consumers, usage, gouts)
        if t in gouts:
            continue  # last-layer-fp: keep output-producing layers float
        out.append((n, act_nodes, w_axis, n.input[0]))
    return out


def _collect_absmax(
    model: ImportedModel,
    calibration: Sequence[Tuple],
    names: set,
    graph=None,
    device=None,
) -> Dict[str, float]:
    """Interpret the graph per calibration batch; track abs-max of ``names``.

    Calibration runs eagerly op by op at ``fp32`` on ``device`` (the
    classifier's device; default ``cuda:0``, raising without CUDA), with
    TF32 off as ``make_forward`` sets it; only each tensor's maximum comes
    back to the host."""
    import torch

    from ..runtime import device_or_default
    from .importer import (consts_to_device, params_to_torch,
                           subgraph_consts_to_device)

    device = device_or_default(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    graph = graph if graph is not None else model.graph
    consts = consts_to_device(model.consts, device, graph)
    sub_consts = subgraph_consts_to_device(graph, device)
    params = params_to_torch(model.params, device)
    stats: Dict[str, float] = {}
    for batch in calibration:
        if not isinstance(batch, (tuple, list)):
            batch = (batch,)
        if len(batch) != len(model.input_names):
            raise ValueError(
                f"calibration batch has {len(batch)} inputs; model expects "
                f"{len(model.input_names)}"
            )
        env: Dict[str, object] = dict(consts)
        env.update(params)
        for nm, x in zip(model.input_names, batch):
            env[nm] = torch.from_numpy(np.asarray(x, dtype=np.float32)).to(device)
        with torch.inference_mode():
            interpret_graph(graph, model.opset, "fp32", env,
                            model.output_names, device, sub_consts)
        for nm in names:
            if nm in env:
                v = env[nm]
                if isinstance(v, torch.Tensor):
                    m = v.abs().amax().item()
                else:
                    m = float(np.max(np.abs(np.asarray(v))))
                if np.isfinite(m):
                    stats[nm] = max(stats.get(nm, 0.0), m)
    return stats


def quantize_model(
    model: ImportedModel,
    calibration: Sequence,
    per_channel: bool = True,
    quantize_first_layer: bool = False,
    device=None,
) -> ImportedModel:
    """Return a new int8-quantized :class:`ImportedModel`.

    ``calibration``: iterable of model-input batches (a bare array is
    treated as a single-input batch). The source model is not mutated.
    Layers reading a graph input or producing a graph output stay float
    (first/last-layer-fp, standard PTQ practice).
    """
    graph = deepcopy(model.graph)
    tensors: Dict[str, np.ndarray] = {}
    tensors.update(model.params)
    tensors.update(model.consts)

    # The quantizer works on raw Conv/MatMul nodes; expand any fused
    # stage-prefix / MBConv groups back to their original chains first
    # (prefix first: its body holds _FusedMBConv nodes).
    from .fuse_frontend import unfuse_frontend
    from .fuse_mbconv import unfuse_mbconv
    from .fuse_stage_prefix import unfuse_stage_prefix

    unfuse_frontend(graph)
    unfuse_stage_prefix(graph)
    unfuse_mbconv(graph)

    eligible = _eligible_nodes(graph, tensors, quantize_first_layer)
    if not eligible:
        raise ModelLoadError(
            "no quantizable layers found (Conv/MatMul/Gemm with float "
            "initializer weights not producing a graph output)"
        )
    need = set()
    for n, act_nodes, _, x_name in eligible:
        need.add(x_name)
        need.add((act_nodes[-1] if act_nodes else n).output[0])
    # Stats come from the unfused graph copy (same tensor names; the
    # source model's graph may hold _FusedMBConv groups whose interior
    # tensors never surface in the outer interpreter environment).
    stats = _collect_absmax(model, calibration, need, graph=graph, device=device)

    consumers: Dict[str, List[NodeProto]] = {}
    for n in graph.node:
        for i in n.input:
            if i:
                consumers.setdefault(i, []).append(n)

    insert_before: Dict[int, List[NodeProto]] = {}
    insert_after: Dict[int, List[NodeProto]] = {}
    x_dq_cache: Dict[str, str] = {}
    w_dq_cache: Dict[str, str] = {}
    w_axis_by_name: Dict[str, int] = {}
    w_rewired: Dict[str, int] = {}
    quantized = 0

    for n, act_nodes, w_axis, x_name in eligible:
        # x_name is the tensor's *original* (calibrated) name; a preceding
        # quantized layer may already have rewired n.input[0] to its __dq view
        t_node = act_nodes[-1] if act_nodes else n
        t_name = t_node.output[0]
        sx = stats.get(x_name, 0.0) / _QMAX
        sy = stats.get(t_name, 0.0) / _QMAX
        if sx <= 0.0 or sy <= 0.0:
            continue  # degenerate (all-zero) activations: leave float
        prior_axis = w_axis_by_name.get(n.input[1])
        if prior_axis is not None and prior_axis != w_axis:
            # Weight tied between ops with different channel axes (e.g. a
            # Conv and a MatMul): per-channel scales can only be right for
            # one of them — leave this node float.
            continue

        # -- activation input: Q+DQ pair, shared across consumers of x
        if x_name in x_dq_cache:
            n.input[0] = x_dq_cache[x_name]
        else:
            tensors[f"{x_name}__qs"] = np.float32(sx)
            tensors[f"{x_name}__qzp"] = np.int8(0)
            q = make_node(
                "QuantizeLinear",
                [x_name, f"{x_name}__qs", f"{x_name}__qzp"],
                [f"{x_name}__q8"],
            )
            dq = make_node(
                "DequantizeLinear",
                [f"{x_name}__q8", f"{x_name}__qs", f"{x_name}__qzp"],
                [f"{x_name}__dq"],
            )
            insert_before.setdefault(id(n), []).extend([q, dq])
            x_dq_cache[x_name] = f"{x_name}__dq"
            n.input[0] = f"{x_name}__dq"

        # -- weights: symmetric int8 initializer + DQ
        w_name = n.input[1]
        w_rewired[w_name] = w_rewired.get(w_name, 0) + 1
        w_axis_by_name[w_name] = w_axis
        if w_name in w_dq_cache:
            n.input[1] = w_dq_cache[w_name]
        else:
            w = tensors[w_name].astype(np.float64)
            if per_channel:
                axes = tuple(i for i in range(w.ndim) if i != w_axis)
                amax = np.max(np.abs(w), axis=axes)
            else:
                amax = np.max(np.abs(w)).reshape(())
            sw = np.where(amax == 0.0, 1.0, amax) / _QMAX
            sw_b = sw.reshape(
                [-1 if i == w_axis else 1 for i in range(w.ndim)]
            ) if per_channel else sw
            wq = np.clip(np.rint(w / sw_b), -127, 127).astype(np.int8)
            tensors[f"{w_name}__q8"] = wq
            tensors[f"{w_name}__qs"] = np.asarray(sw, dtype=np.float32)
            tensors[f"{w_name}__qzp"] = (
                np.zeros(sw.shape, np.int8) if per_channel else np.int8(0)
            )
            dq_w = make_node(
                "DequantizeLinear",
                [f"{w_name}__q8", f"{w_name}__qs", f"{w_name}__qzp"],
                [f"{w_name}__dq"],
                axis=w_axis,
            )
            insert_before.setdefault(id(n), []).append(dq_w)
            w_dq_cache[w_name] = f"{w_name}__dq"
            n.input[1] = f"{w_name}__dq"

        # -- output: Q+DQ after the (relu-fused) producer; float consumers
        # read the dequantized view
        tensors[f"{t_name}__qs"] = np.float32(sy)
        tensors[f"{t_name}__qzp"] = np.int8(0)
        q_out = make_node(
            "QuantizeLinear",
            [t_name, f"{t_name}__qs", f"{t_name}__qzp"],
            [f"{t_name}__q8"],
        )
        dq_out = make_node(
            "DequantizeLinear",
            [f"{t_name}__q8", f"{t_name}__qs", f"{t_name}__qzp"],
            [f"{t_name}__dq"],
        )
        insert_after.setdefault(id(t_node), []).extend([q_out, dq_out])
        # Downstream quantized layers reuse this pair instead of minting one.
        x_dq_cache[t_name] = f"{t_name}__dq"
        for c in consumers.get(t_name, []):
            if c is not q_out:
                c.input[:] = [
                    f"{t_name}__dq" if i == t_name else i for i in c.input
                ]
        quantized += 1

    if not quantized:
        raise ModelLoadError(
            "calibration produced no usable activation ranges (all zero?)"
        )

    # Drop replaced float weights — but only when every consumer was
    # rewired to the quantized view (a weight tied to a non-quantized
    # node, e.g. the fp32 last layer, must keep its float copy).
    for w_name, count in w_rewired.items():
        if count == len(consumers.get(w_name, [])) and w_name in tensors:
            del tensors[w_name]

    new_nodes: List[NodeProto] = []
    for n in graph.node:
        new_nodes.extend(insert_before.get(id(n), []))
        new_nodes.append(n)
        new_nodes.extend(insert_after.get(id(n), []))
    graph.node[:] = new_nodes
    optimize_graph(graph, tensors)

    # Rebuild the serialized initializer list from the FINAL tensors dict:
    # this drops replaced float weights AND adds the new __q8/__qs/__qzp
    # entries, so the rewritten graph proto is self-contained (a node must
    # never reference a tensor that exists in no initializer).
    kept = {t.name: t for t in graph.initializer}
    graph.initializer[:] = [
        kept[name] if name in kept else TensorProto.from_numpy(
            np.asarray(arr), name=name
        )
        for name, arr in tensors.items()
    ]

    params, consts = split_params(tensors)
    return ImportedModel(
        graph=graph,
        opset=model.opset,
        params=params,
        consts=consts,
        input_names=list(model.input_names),
        input_shapes=[list(s) for s in model.input_shapes],
        output_names=list(model.output_names),
        output_shapes=[list(s) for s in model.output_shapes],
    )


def calibration_from_samples(
    samples, sample_count: int, max_segments: int = 16, batch_size: int = 4
) -> List[np.ndarray]:
    """Build calibration batches from a raw recording: up to
    ``max_segments`` non-overlapping windows spaced evenly across the
    audio (int16 PCM is scaled to [-1, 1) like the inference path)."""
    x = np.asarray(samples).reshape(-1)
    if x.dtype == np.int16:
        x = x.astype(np.float32) / 32768.0
    x = x.astype(np.float32)
    if x.size < sample_count:
        x = np.pad(x, (0, sample_count - x.size))
    n_avail = x.size // sample_count
    n = max(1, min(max_segments, n_avail))
    starts = np.linspace(0, x.size - sample_count, n).astype(np.int64)
    segs = np.stack([x[s:s + sample_count] for s in starts])
    return [segs[i:i + batch_size] for i in range(0, len(segs), batch_size)]


def synthetic_calibration_segments(
    sample_count: int, batches: int = 4, batch_size: int = 4, seed: int = 0
) -> List[np.ndarray]:
    """Fallback calibration audio when no real recordings are provided:
    white noise at stepped amplitudes plus sine sweeps, in [-1, 1). Real
    field recordings calibrate better; this keeps scales finite and sane."""
    rng = np.random.default_rng(seed)
    out = []
    t = np.arange(sample_count, dtype=np.float32)
    for b in range(batches):
        rows = []
        for i in range(batch_size):
            amp = 0.05 + 0.9 * ((b * batch_size + i) % 7) / 6.0
            if (b + i) % 2 == 0:
                rows.append(
                    (rng.standard_normal(sample_count) * amp * 0.25).astype(
                        np.float32
                    )
                )
            else:
                f0, f1 = 200.0 * (1 + i), 4000.0 * (1 + b)
                phase = t / sample_count
                freq = f0 + (f1 - f0) * phase
                rows.append(
                    (amp * np.sin(2 * np.pi * freq * t / 48000.0)).astype(
                        np.float32
                    )
                )
        out.append(np.clip(np.stack(rows), -1.0, 1.0))
    return out
