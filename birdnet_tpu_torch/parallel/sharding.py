"""Multi-device sharding: data-parallel batches + a column-split classifier
head, on PyTorch.

The counterpart of :mod:`birdnet_tpu.parallel.sharding`. The JAX module
annotates params and activations with ``NamedSharding`` and lets XLA
partition the program and place its collectives. There is no partitioner
here, so the layout is explicit and one process drives every cell:

- **Mesh**: :class:`Mesh` is a 2-D array of ``torch.device`` with axis
  names, ``("data", "model")`` by default. A device may appear more than
  once (eight cells on the host, a 2x2 on one card): each cell is a unit of
  work, not a process.
- **DP**: the segment batch splits over the ``data`` axis; cell ``(d, m)``
  runs the port's ordinary forward on the rows of data index ``d``.
- **TP**: each weight whose dim equals ``num_species`` (the classifier head,
  :func:`param_specs`) splits over the ``model`` axis; cell ``(d, m)``
  holds column (or row) block ``m`` of the species-padded head and whole
  copies of everything else, so the backbone runs once per model-axis cell
  on the same rows, as XLA runs it with replicated params and
  batch-sharded activations. Each cell selects the top-K of its logit
  block; the controller device (``devices[0, 0]``) merges the ``tp * K``
  candidates per row (:func:`~birdnet_tpu_torch.ops.topk.merge_topk`),
  so ties keep the lower index as ``lax.top_k`` does.

A column split is right only while every op downstream of the head is
positionwise on the species axis (XLA partitions any graph correctly).
:func:`_head_partition` walks the graph: a head that feeds anything else
stays whole in every cell and only the cells ``(d, 0)`` run, which gives the
JAX package's answer with the same devices and kernels. A head that needs a
species pad and feeds a cross-position op is refused with
:class:`~birdnet_tpu_torch.errors.ModelLoadError`, as the JAX package
refuses it (:func:`_check_pad_safety`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..onnx.proto import WireTensor, wire_bits, wire_from_bits, wire_tensor
from ..types import ModelConfig


class Mesh:
    """Devices laid out on named axes: ``devices`` is a numpy object array
    of ``torch.device`` with one dimension per name of ``axis_names``;
    ``shape`` maps each name to its extent, as ``jax.sharding.Mesh.shape``
    does."""

    def __init__(self, devices, axis_names: Tuple[str, ...] = ("data", "model")):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh devices have {devices.ndim} dimension(s) for axis names "
                f"{tuple(axis_names)}")
        self.devices = np.vectorize(torch.device, otypes=[object])(devices)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted(set(map(str, self.devices.flat)))})"


def make_mesh(
    devices: Optional[Sequence] = None,
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("data", "model"),
) -> Mesh:
    """Build a (data, model) mesh over the given devices (default: the
    default platform's, :func:`~birdnet_tpu_torch.runtime.platform_devices`).

    Default shape: all devices on ``data`` when the device count is odd or
    small, else a 2-way ``model`` axis (head TP) with the rest on ``data``.
    """
    if devices is None:
        from ..runtime import platform_devices

        devices = platform_devices()
    n = len(devices)
    if shape is None:
        tp = 2 if n % 2 == 0 and n >= 4 else 1
        shape = (n // tp, tp)
    flat = np.empty(n, dtype=object)
    flat[:] = [torch.device(d) for d in devices]
    return Mesh(flat.reshape(shape), axis_names)


def param_specs(
    params: Dict[str, np.ndarray],
    config: ModelConfig,
    model_axis: str = "model",
    model_size: Optional[int] = None,
    mesh: Optional[Mesh] = None,
    num_species: Optional[int] = None,
) -> Dict[str, tuple]:
    """Partition specs per parameter, each the tuple of a ``PartitionSpec``'s
    entries: head weights split over ``model_axis`` (the dimension matching
    ``num_species``: ``(model_axis, None)``, ``(None, model_axis)`` or
    ``(model_axis,)``), everything else whole (``()``).

    ``model_size`` (or ``mesh``, from which it is derived): the mesh's
    model-axis extent — dims that don't divide it evenly stay whole (e.g.
    6,522 species over a 4-way axis). Without either, specs are emitted
    unguarded; prefer passing the mesh. ``num_species`` overrides the
    species-dim extent to match (used by the sharded programs after
    ``_species_pad`` rounds the head up to a divisible width)."""
    if model_size is None and mesh is not None:
        model_size = mesh.shape.get(model_axis)
    n = num_species if num_species is not None else config.num_species

    def fits(dim: int) -> bool:
        return model_size is None or dim % model_size == 0

    specs: Dict[str, tuple] = {}
    for name, p in params.items():
        if p.ndim == 2 and p.shape[0] == n and fits(n):
            specs[name] = (model_axis, None)
        elif p.ndim == 2 and p.shape[1] == n and fits(n):
            specs[name] = (None, model_axis)
        elif p.ndim == 1 and p.shape[0] == n and fits(n):
            specs[name] = (model_axis,)
        else:
            specs[name] = ()
    return specs


def _species_pad(
    params: Dict[str, np.ndarray], config: ModelConfig, model_size: int,
    floats_only: bool = False,
) -> Tuple[Dict[str, np.ndarray], int]:
    """Zero-pad species-dim params so the classifier head TP-shards even
    when ``num_species`` doesn't divide the model axis (Perch v2's 14,795
    classes over any power-of-two axis; JAX NamedSharding requires exact
    divisibility). Exact by construction for the supported families: the
    species axis is *terminal* (it exists only as the output dim of the
    head matmul / its bias / per-class vectors), so zero pad columns add
    new logit positions without touching real ones; the sharded programs
    mask pad positions to -inf before top-K and slice them off returned
    logits. Returns (padded params, padded species extent).

    Scope note: the dim match is by SIZE, so a non-head tensor whose dim
    coincidentally equals ``num_species`` would also pad. Zero-padding
    stays value-exact on real positions through matmul (zero
    contributions), add, and mul; a mismatched interior pad otherwise
    fails the trace loudly with a shape error — silent corruption would
    require a softmax/mean/div over the species axis inside the graph,
    which no supported family has (their logits are raw head outputs).
    At the real class counts (6,522 / 14,795) collisions do not occur."""
    n = config.num_species
    if model_size is None or model_size <= 1 or n % model_size == 0:
        return params, n
    pad = -n % model_size
    out = dict(params)
    for name, p in params.items():
        if floats_only and not _is_float(p):
            continue  # integer consts (axes/shapes/indices) must not pad
        if p.ndim == 2 and p.shape[0] == n:
            out[name] = _zero_pad(p, pad, 0)
        elif p.ndim == 2 and p.shape[1] == n:
            out[name] = _zero_pad(p, pad, 1)
        elif p.ndim == 1 and p.shape[0] == n:
            out[name] = _zero_pad(p, pad, 0)
    return out, n + pad


def _is_float(p) -> bool:
    """A float array, or a ``WireTensor`` (bfloat16, float8, or 4-bit: a
    weight or its zero point, never an axis or a shape)."""
    return isinstance(p, WireTensor) or np.issubdtype(p.dtype, np.floating)


def _zero_pad(p, pad: int, axis: int):
    """``p`` with ``pad`` zeros appended along ``axis``; a ``WireTensor``
    pads its bits (zero bits are zero in every wire type)."""
    if isinstance(p, WireTensor):
        bits = _zero_pad(wire_bits(p), pad, axis)
        return wire_from_bits(bits, p.data_type, bits.shape)
    widths = [(0, 0)] * p.ndim
    widths[axis] = (0, pad)
    return np.pad(p, widths)


# Ops that mix values ACROSS positions of an axis (normalizers, axis
# reductions, axis selections). Zero pad logits are value-exact through
# every positionwise op (matmul contributions, add, mul, sigmoid), but a
# cross-position op over the species axis would let the pads change real
# positions (exp(0)=1 joins a softmax denominator; zero wins an all-negative
# ArgMax/ReduceMax; zero poisons ReduceProd). None of the supported
# families carries one downstream of the head (their logits are raw head
# outputs), so hitting this is a custom-graph safety refusal, not a
# supported-path branch.
_PAD_UNSAFE_OPS = frozenset({
    "Softmax", "LogSoftmax", "Hardmax", "ArgMax", "ArgMin", "TopK",
    "ReduceMean", "ReduceSum", "ReduceProd", "ReduceMin", "ReduceMax",
    "ReduceL1", "ReduceL2", "ReduceLogSum", "ReduceLogSumExp",
    "ReduceSumSquare",
})


def _check_pad_safety(graph, padded_names) -> None:
    """Refuse (typed error) to species-pad when a cross-position op
    consumes a value derived from a padded tensor (advisor finding: a
    softmax-head custom classifier would otherwise be silently wrong —
    zero pad logits contribute exp(0)=1 to the denominator). Conservative
    by design: axis attributes are not inspected (input ranks are unknown
    before trace), so ANY such op downstream of a padded tensor refuses;
    run on an unpadded mesh extent (a model axis dividing num_species)
    to shard such graphs instead."""
    from ..errors import ModelLoadError

    derived = set(padded_names)

    def walk(g) -> None:
        for node in g.node:
            hit = [i for i in node.input if i and i in derived]
            if hit:
                if node.op_type in _PAD_UNSAFE_OPS:
                    raise ModelLoadError(
                        f"cannot species-pad for tensor-parallel sharding: "
                        f"node {node.name!r} ({node.op_type}) consumes "
                        f"{hit[0]!r}, which derives from a zero-padded "
                        f"species tensor — a cross-position op over the "
                        f"padded axis would corrupt real class values. "
                        f"Use a model-axis size that divides num_species, "
                        f"or run unsharded."
                    )
                derived.update(o for o in node.output if o)
            for v in node.attrs.values():
                subs = v if isinstance(v, (list, tuple)) else [v]
                for sub in subs:
                    if hasattr(sub, "node"):
                        walk(sub)

    walk(graph)


def _species_pad_model(imported, config: ModelConfig, model_size: int):
    """Species-pad an ImportedModel for head TP: pads the species dim in
    ``params`` AND in float ``consts`` (tiny per-class vectors — e.g. a
    10-species test head's bias — fall below the importer's param-size
    floor and live in consts; an unpadded per-class const against a padded
    head weight would break the trace). Integer consts are never padded
    (axes/shape/index tensors). Returns (padded ImportedModel clone or the
    original when no padding is needed, padded species extent)."""
    n = config.num_species
    if model_size is None or model_size <= 1 or n % model_size == 0:
        return imported, n
    params, n_padded = _species_pad(imported.params, config, model_size)
    consts, _ = _species_pad(
        imported.consts, config, model_size, floats_only=True
    )
    padded_names = {
        name for name, before in imported.params.items()
        if params[name].shape != before.shape
    }
    padded_names.update(
        name for name, before in imported.consts.items()
        if consts[name].shape != before.shape
    )
    _check_pad_safety(imported.graph, padded_names)
    return (
        dataclasses.replace(imported, params=params, consts=consts),
        n_padded,
    )


def _cell_block(p, spec: tuple, m: int, model_size: int, model_axis: str):
    """Block ``m`` of ``model_size`` of a numpy array or tensor along the
    axis its spec names (the array itself when its spec is ``()``)."""
    if model_axis not in spec:
        return p
    axis = spec.index(model_axis)
    w = p.shape[axis] // model_size
    block = p[m * w:(m + 1) * w] if axis == 0 else p[:, m * w:(m + 1) * w]
    return wire_tensor(block, p.data_type) if isinstance(p, WireTensor) else block


def shard_params(params, config: ModelConfig, mesh: Mesh, model_axis: str = "model",
                 specs: Optional[Dict[str, tuple]] = None):
    """Place numpy params on the mesh's cells: ``{cell: {name: tensor}}``,
    ``cell`` an index of ``mesh.devices``. A param split by its spec
    (``specs``, default :func:`param_specs` on the mesh) is block ``m`` of
    the cell's model coordinate; the rest are whole. A device holds one
    copy of each whole param and of each block, whatever the number of its
    cells."""
    from ..compiler.importer import params_to_torch

    if specs is None:
        specs = param_specs(params, config, model_axis, mesh.shape[model_axis])
    model_size = mesh.shape[model_axis]
    m_dim = mesh.axis_names.index(model_axis)
    whole = {name for name, spec in specs.items() if model_axis not in spec}
    placed: Dict[tuple, Dict[str, torch.Tensor]] = {}
    cells = {}
    for cell in np.ndindex(mesh.devices.shape):
        device, m = mesh.devices[cell], cell[m_dim]
        if (device, None) not in placed:
            placed[device, None] = params_to_torch(
                {name: params[name] for name in whole}, device)
        if (device, m) not in placed:
            placed[device, m] = params_to_torch(
                {name: _cell_block(p, specs[name], m, model_size, model_axis)
                 for name, p in params.items() if name not in whole}, device)
        cells[cell] = {**placed[device, None], **placed[device, m]}
    return cells


# Ops that keep the species axis positionwise when a species-derived value
# feeds them: elementwise arithmetic, activations, casts and per-axis
# (de)quantization. Gemm and MatMul also may take a species param as their
# weight or bias (input 1 or 2): their output then carries the species axis.
_POSITIONWISE_OPS = frozenset({
    "Add", "Sub", "Mul", "Div", "Sigmoid", "Relu", "LeakyRelu", "Elu", "Selu",
    "Tanh", "Softplus", "HardSigmoid", "Exp", "Log", "Neg", "Abs", "Sqrt",
    "Reciprocal", "Pow", "Erf", "Clip", "Identity", "Cast", "Max", "Min",
    "Where", "QuantizeLinear", "DequantizeLinear",
})
_HEAD_OPS = frozenset({"Gemm", "MatMul"})


def _reads(node):
    """Every name ``node`` reads, its subgraphs' reads included."""
    names = [i for i in node.input if i]
    for v in node.attrs.values():
        for sub in v if isinstance(v, (list, tuple)) else [v]:
            if hasattr(sub, "node"):
                for inner in sub.node:
                    names.extend(_reads(inner))
    return names


def _head_names(graph, candidates) -> Optional[set]:
    """The species-dim tensors (of ``candidates``) that form the head: each
    is read only as a Gemm/MatMul weight or bias or by a positionwise op.
    Returns None when a value derived from them reaches anything that is
    not positionwise on the species axis (a contraction, a reshape, a
    cross-position op, a subgraph): the head cannot be split by columns."""
    consumers: Dict[str, list] = {}
    for node in graph.node:
        for pos, name in enumerate(node.input):
            consumers.setdefault(name, []).append((node, pos))
        for name in set(_reads(node)) - set(node.input):
            consumers.setdefault(name, []).append((node, -1))

    def head_read(node, pos) -> bool:
        return (node.op_type in _POSITIONWISE_OPS
                or (node.op_type in _HEAD_OPS and pos in (1, 2)))

    head = {name for name in candidates
            if consumers.get(name)
            and all(head_read(node, pos) for node, pos in consumers[name])}
    derived = set(head)
    for node in graph.node:
        hit = [pos for pos, name in enumerate(node.input) if name in derived]
        if any(name in derived for name in _reads(node)) and not hit:
            return None  # read inside a subgraph
        if not hit:
            continue
        if not (node.op_type in _POSITIONWISE_OPS
                or (node.op_type in _HEAD_OPS and 0 not in hit)):
            return None
        derived.update(o for o in node.output if o)
    return head


@dataclasses.dataclass
class _Head:
    """How the mesh lays out the head: the model each cell's forward is
    built from (species-padded when split), the specs of its params and
    float consts, the selection mask over the padded species (None: every
    species), the padded species extent and whether the head is split."""

    model: object
    specs: Dict[str, tuple]
    const_specs: Dict[str, tuple]
    mask: Optional[np.ndarray]
    n_padded: int
    sharded: bool


def _head_partition(imported, config: ModelConfig, mesh: Mesh,
                    model_axis: str, species_mask) -> _Head:
    """Shared head-TP setup for the sharded programs: species-pad the head to
    a model-axis-divisible width, derive per-param specs on the padded
    shapes, and fold the pad positions into the top-K candidate mask (pad
    logits must never win selection). Refuses, as the JAX package does, a
    pad that a cross-position op would read (:func:`_species_pad_model`).
    Only the head's own tensors (:func:`_head_names`) pad and split: a
    backbone tensor whose dim happens to equal ``num_species`` stays
    whole. A head that cannot be split by columns stays whole, unpadded."""
    n = config.num_species
    model_size = mesh.shape[model_axis]
    _, n_padded = _species_pad_model(imported, config, model_size)
    float_consts = {name: c for name, c in imported.consts.items()
                    if _is_float(c)}
    candidates = [name for tensors in (imported.params, float_consts)
                  for name, spec in param_specs(tensors, config, model_axis).items()
                  if spec]
    head = _head_names(imported.graph, candidates) if model_size > 1 else None
    if not head:
        mask = None if species_mask is None else np.asarray(species_mask, bool)
        return _Head(imported, {name: () for name in imported.params},
                     {name: () for name in imported.consts}, mask, n, False)

    def pad_and_spec(tensors):
        part, _ = _species_pad({k: v for k, v in tensors.items() if k in head},
                               config, model_size)
        specs = param_specs(part, config, model_axis, model_size, num_species=n_padded)
        return ({**tensors, **part},
                {name: specs.get(name, ()) for name in tensors})

    params, specs = pad_and_spec(imported.params)
    consts, const_specs = pad_and_spec(imported.consts)
    mask = None if species_mask is None else np.asarray(species_mask, bool)
    if n_padded != n:
        keep = np.zeros(n_padded, dtype=bool)
        keep[:n] = True if mask is None else mask
        mask = keep
    model = dataclasses.replace(imported, params=params, consts=consts)
    return _Head(model, specs, const_specs, mask, n_padded, True)


def _current(device):
    """The device made current for a cell's work (the card's; nothing on
    the host), so that every launch and allocation lands on it."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class _Done:
    """The CUDA events that mark one step's work on each of its devices,
    with the interface of one event: ``query`` and ``synchronize``."""

    def __init__(self, devices):
        self.events = []
        for device in devices:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            self.events.append(event)

    def query(self) -> bool:
        return all(e.query() for e in self.events)

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()


class _Cells:
    """The mesh's cells as one program: per (device, model coordinate) a
    forward built from the head partition's model with that block of its
    consts, and the selection mask's block; :meth:`run` issues every cell's
    forward and top-K and gathers the results on the controller."""

    def __init__(self, imported, config: ModelConfig, mesh: Mesh, precision: str,
                 data_axis: str = "data", model_axis: str = "model", species_mask=None):
        from .._demux import demux_indices
        from ..compiler.importer import make_forward

        if set(mesh.axis_names) != {data_axis, model_axis}:
            from ..errors import InferenceError

            raise InferenceError(
                f"mesh must have exactly the axes {data_axis!r} and {model_axis!r} "
                f"(got {mesh.axis_names}); build one with "
                f"birdnet_tpu_torch.parallel.make_mesh()")
        self.config = config
        self.axis_names = (data_axis, model_axis)
        self.model_axis = model_axis
        self.head = head = _head_partition(imported, config, mesh, model_axis, species_mask)
        # Cells indexed (data, model) whatever the mesh's axis order.
        self.devices = (mesh.devices if mesh.axis_names == (data_axis, model_axis)
                        else mesh.devices.T)
        self.dp, self.tp = self.devices.shape
        self.controller = mesh.devices.flat[0]
        self.width = head.n_padded // self.tp if head.sharded else head.n_padded
        self.ms = range(self.tp) if head.sharded else range(1)
        self.logits_index, self.embed_index = demux_indices(config.model_type)
        self._forwards = {}
        self._masks = {}
        for d in range(self.dp):
            for m in self.ms:
                key = self.devices[d, m], m
                if key in self._forwards:
                    continue
                consts = {name: self.block(c, head.const_specs[name], m)
                          for name, c in head.model.consts.items()}
                params = {name: self.block(p, head.specs[name], m)
                          for name, p in head.model.params.items()}
                self._forwards[key] = make_forward(
                    dataclasses.replace(head.model, params=params, consts=consts),
                    precision, key[0])
                self._masks[key] = (
                    None if head.mask is None
                    else torch.from_numpy(np.ascontiguousarray(
                        self.block(head.mask, (model_axis,), m))).to(key[0]))
        self.cuda_devices = sorted({dev for dev in mesh.devices.flat if dev.type == "cuda"},
                                   key=str)

    def block(self, p, spec: tuple, m: int):
        return _cell_block(p, spec, m, self.tp if self.head.sharded else 1, self.model_axis)

    def shard(self, params) -> Dict[tuple, Dict[str, torch.Tensor]]:
        """Numpy params (as imported) on the cells, indexed (d, m), padded and
        split as the head partition lays them out."""
        split = {name: p for name, p in params.items()
                 if self.model_axis in self.head.specs.get(name, ())}
        padded, _ = _species_pad(split, self.config, self.tp)
        return shard_params({**params, **padded}, self.config,
                            Mesh(self.devices, self.axis_names), self.model_axis,
                            specs=self.head.specs)

    def done(self) -> Optional[_Done]:
        """Events marking the work issued so far on each card (None: all
        cells on the host, whose work is done when it returns)."""
        return _Done(self.cuda_devices) if self.cuda_devices else None

    @property
    def running(self):
        """The running cells ``(d, m)``, in the order a step issues them."""
        return [(d, m) for d in range(self.dp) for m in self.ms]

    def cell(self, params, frames, d: int, m: int, k: int, with_embeddings: bool, mask):
        """Cell (d, m)'s forward and top-K on its device (made current by
        the caller): (logit block, its top-``k`` values and global species
        indices, or None twice when ``k`` is 0, the embeddings of an
        ``m = 0`` cell with ``with_embeddings`` or None). ``mask``: the
        cell's runtime species mask or None."""
        from ..ops.topk import masked_topk

        device = self.devices[d, m]
        outs = self._forwards[device, m](params[d, m], frames)
        block = outs[self.logits_index]
        emb = outs[self.embed_index] if m == 0 and with_embeddings else None
        if k == 0:
            return block, None, None, emb
        v, i = masked_topk(block, min(k, self.width), self._masks[device, m], mask)
        return block, v, i + m * self.width, emb

    def merge(self, outs, k: int):
        """Gather the cells' results (``outs[d, m]`` as :meth:`cell` returns
        them, on the controller) into (confidences ``[rows, k]``, int32
        indices, logits ``[rows, num_species]``, embeddings or None)."""
        from ..ops.topk import merge_topk

        n = self.config.num_species
        ctrl = self.controller
        confs, idxs, logits, embs = [], [], [], []
        for d in range(self.dp):
            parts = [outs[d, m] for m in self.ms]
            logits.append(torch.cat([p[0] for p in parts], dim=1))
            if parts[0][3] is not None:
                embs.append(parts[0][3])
            if k:
                conf, idx = merge_topk([p[1] for p in parts], [p[2] for p in parts], k)
            else:
                conf = logits[-1].new_zeros((logits[-1].shape[0], 0))
                idx = torch.zeros((logits[-1].shape[0], 0), dtype=torch.int32, device=ctrl)
            confs.append(conf)
            idxs.append(idx)
        logits = torch.cat(logits)
        if self.head.n_padded != n:
            logits = logits[:, :n]
        emb = torch.cat(embs) if embs else None
        return torch.cat(confs), torch.cat(idxs), logits, emb

    def step(self, params, frames_of, masks_of, k: int, with_embeddings: bool = False):
        """One step over every running cell, issued without a host sync:
        each cell's :meth:`cell` on its device, its results copied to the
        controller, then :meth:`merge`. ``frames_of(d, m, device)`` and
        ``masks_of(d, m, device)`` give the cell's rows and runtime mask."""
        ctrl = self.controller
        outs = {}
        for d, m in self.running:
            device = self.devices[d, m]
            with _current(device):
                got = self.cell(params, frames_of(d, m, device), d, m, k, with_embeddings,
                                masks_of(d, m, device))
                outs[d, m] = tuple(None if t is None else t.to(ctrl) for t in got)
        return self.merge(outs, k)

    def run(self, params, frames_of, k: int, with_embeddings: bool = False,
            row_mask: Optional[np.ndarray] = None, call_mask: Optional[np.ndarray] = None):
        """:meth:`step` with the runtime masks given on the host.
        ``frames_of(d, device)`` gives data index ``d``'s rows on ``device``.
        ``row_mask``: bool ``[rows, num_species]``, ``call_mask``: bool
        ``[num_species]``. Returns, on the controller, (confidences
        ``[rows, k]``, int32 indices, logits ``[rows, num_species]``,
        embeddings of the ``m = 0`` cells or None)."""
        pad = self.head.n_padded - self.config.num_species
        if row_mask is not None and pad:
            row_mask = np.pad(row_mask, ((0, 0), (0, pad)))
        if call_mask is not None and pad:
            call_mask = np.pad(call_mask, (0, pad))
        rows = None if row_mask is None else row_mask.shape[0] // self.dp
        return self.step(
            params, lambda d, m, device: frames_of(d, device),
            lambda d, m, device: self._rows_block(row_mask, call_mask, d, rows, m, device),
            k, with_embeddings)

    def spans(self) -> Dict[torch.device, Tuple[int, int]]:
        """Per card of the running cells, ``(first, count)``: the data
        indices from ``first`` to the last one the card runs, whose rows it
        is given (all of them on a mesh of one card)."""
        seen: Dict[torch.device, list] = {}
        for d, m in self.running:
            seen.setdefault(self.devices[d, m], []).append(d)
        return {device: (min(ds), max(ds) - min(ds) + 1) for device, ds in seen.items()}

    def _rows_block(self, row_mask, call_mask, d: int, rows: int, m: int, device):
        """The runtime mask of cell (d, m): its rows and columns of
        ``row_mask``, or its columns of ``call_mask``, on ``device``."""
        if row_mask is not None:
            part = row_mask[d * rows:(d + 1) * rows]
            return torch.from_numpy(np.ascontiguousarray(
                self.block(part, (None, self.model_axis), m))).to(device)
        if call_mask is not None:
            return torch.from_numpy(np.ascontiguousarray(
                self.block(call_mask, (self.model_axis,), m))).to(device)
        return None


def make_sharded_program(
    imported,
    config: ModelConfig,
    mesh: Mesh,
    top_k: int = 10,
    precision: str = "fp32",
    data_axis: str = "data",
    model_axis: str = "model",
    species_mask=None,
    with_embeddings: bool = False,
):
    """Build the multi-device inference step.

    Returns ``(fn, shard_inputs)`` where ``fn(params, x)`` maps a
    batch placed by ``shard_inputs`` to (confidences ``[B, K]``, indices
    ``[B, K]``, logits ``[B, N]``) — plus embeddings ``[B, E]`` when
    ``with_embeddings`` and the family has them (v3.0 at output 0, Perch
    v2's 4-output demux; reference: src/classifier.rs:914-950) — on the
    controller device, and ``shard_inputs(params, x)`` places numpy params
    and a ``[B, S]`` batch onto the mesh. B must be divisible by the
    ``data`` axis size.

    When ``num_species`` doesn't divide the model axis (Perch's 14,795)
    the head is zero-padded to a divisible width (``_species_pad``): pad
    positions are masked out of top-K and sliced off the returned logits.
    """
    cells = _Cells(imported, config, mesh, precision, data_axis, model_axis, species_mask)
    emit_emb = with_embeddings and cells.embed_index is not None
    k = max(0, min(top_k, config.num_species))

    def fn(params, x):
        rows = next(iter(x.values())).shape[0] // cells.dp
        with torch.inference_mode():
            conf, idx, logits, emb = cells.run(
                params, lambda d, device: x[device][d * rows:(d + 1) * rows], k, emit_emb)
        return (conf, idx, logits, emb) if emit_emb else (conf, idx, logits)

    def shard_inputs(params, x):
        x = np.asarray(x, np.float32)
        if x.shape[0] % cells.dp:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by data-axis size {cells.dp}")
        host = torch.from_numpy(np.ascontiguousarray(x))
        return cells.shard(params), {device: host.to(device)
                                     for device in set(cells.devices.flat)}

    return fn, shard_inputs


def make_sharded_stream_program(
    imported,
    config: ModelConfig,
    mesh: Mesh,
    n_tiles: int,
    step: int,
    tile: int = 128,
    top_k: int = 10,
    precision: str = "fp32",
    data_axis: str = "data",
    model_axis: str = "model",
    audio_dtype=None,
    species_mask=None,
):
    """Multi-device version of the streaming whole-recording program
    (compiler/stream.py): a loop over batch tiles where each tile's segment
    batch splits over the ``data`` axis and the classifier head over
    ``model``.

    Audio is replicated on each device (cheap: int16 ≤ ~350 MB/hour), so
    overlapping segments never cross cell boundaries; each cell frames its
    rows of the tile (``frame_tile``) and scales and casts them
    (``prepare_frames``).

    Returns ``(fn, shard_inputs)``; ``fn(params, audio) → (conf [N, K],
    idx [N, K])`` on the controller. ``tile`` must be divisible by the
    data-axis size.
    """
    from ..compiler.stream import audio_device_shape, frame_tile, prepare_frames

    cells = _Cells(imported, config, mesh, precision, data_axis, model_axis, species_mask)
    if tile % cells.dp:
        raise ValueError(f"tile {tile} not divisible by data-axis size {cells.dp}")
    k = max(1, min(top_k, config.num_species))
    S = config.sample_count
    rows = tile // cells.dp

    def fn(params, audio):
        confs, idxs = [], []
        with torch.inference_mode():
            for t in range(n_tiles):
                def frames_of(d, device, t=t):
                    return prepare_frames(
                        frame_tile(audio[device], t * cells.dp + d, rows, step, S), precision)

                conf, idx, _, _ = cells.run(params, frames_of, k)
                confs.append(conf)
                idxs.append(idx)
        return torch.cat(confs), torch.cat(idxs)

    def shard_inputs(params, audio):
        audio = np.asarray(audio)
        need = (n_tiles * tile - 1) * step + S
        if audio.shape[0] < need:
            pad = np.zeros(need - audio.shape[0], dtype=audio.dtype)
            audio = np.concatenate([audio, pad])
        host = torch.from_numpy(np.ascontiguousarray(audio[:need])).reshape(
            audio_device_shape(n_tiles, tile, step, S))
        return cells.shard(params), {device: host.to(device)
                                     for device in set(cells.devices.flat)}

    return fn, shard_inputs
