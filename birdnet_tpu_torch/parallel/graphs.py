"""The mesh's compiled programs: its cells' step captured as CUDA graphs.

Where the JAX ``ShardedEngine`` compiles one XLA executable per batch key
and one ``lax.scan`` program per streaming key, the port captures, per key,
the step that ``_Cells.step`` issues eagerly (parallel/sharding.py):

- per card of the mesh, one ``torch.cuda.CUDAGraph`` of its cells' forwards
  and masked top-K over static per-card inputs (the rows of the data
  indices it runs, a runtime mask), captured after warm calls on a side
  stream into the card's graph pool, as the batch context and the stream's
  tile programs capture one device's;
- the merge on the controller (``devices[0, 0]``: the logits' concat, the
  candidates' top-K merge, the pad slice). On a mesh whose cells all sit on
  one card it is in that card's graph, so a step is one replay. Otherwise
  each other card's results are copied to static buffers on the controller
  after its replay (torch orders a copy between two cards' current
  streams) and a graph of the merge over them is replayed there.

:class:`_MeshBatch` is a batch key's program: a pinned host staging buffer,
per card the static input rows (and the row mask), one step.
:class:`_MeshTiles` is a streaming key's: per slot of the engine's rings
(one :class:`~birdnet_tpu_torch.compiler.stream._Ring` per card, holding the
span of the card's data indices) one step over that slot's device buffers.
A key whose warm calls read the card on the host (a while-form Loop,
``compiler.stream.reads_host``) runs the same step eagerly over the same
buffers; any other failed capture raises :class:`InferenceError`. Kernel
wrappers count their launches in the warm calls; a capture's counts are
taken back and each replay adds them, as the stream's graphs do.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch

from ..compiler.engine import _host, _wait
from ..errors import InferenceError
from .sharding import _current, _Done


class _MeshStep:
    """One step of every running cell over static inputs: captured (per
    card a graph, and the merge) or, for a key that reads the card on the
    host, run eagerly. ``frames_of(d, m, device)`` and ``masks_of(d, m,
    device)`` give a cell's rows and runtime mask (views of static
    buffers)."""

    def __init__(self, eng, k: int, with_embeddings: bool, frames_of, masks_of):
        self._eng = eng
        self._cells = cells = eng._cells
        self._k, self._emb = k, with_embeddings
        self._frames_of, self._masks_of = frames_of, masks_of
        self._by_device = {}
        for d, m in cells.running:
            self._by_device.setdefault(cells.devices[d, m], []).append((d, m))
        self.graphs = []
        self.launches = ()
        self.host_reads = 0
        self.outs = None
        self._copies = []
        self._merge_graph = None
        self._held = []

    @property
    def eager(self) -> bool:
        return not self.graphs

    def body(self):
        """The step run eagerly (the plain version the graphs capture)."""
        return self._cells.step(self._eng.params, self._frames_of, self._masks_of,
                                self._k, self._emb)

    def _on(self, device):
        """The cells of ``device``, on it, as ``_Cells.cell`` returns them."""
        params = self._eng.params
        return {(d, m): self._cells.cell(params, self._frames_of(d, m, device), d, m,
                                         self._k, self._emb, self._masks_of(d, m, device))
                for d, m in self._by_device[device]}

    def warm(self) -> None:
        """Warm calls on each card's side stream (they build the kernels and
        fill every lazy cache), counting the forward's reads of the card on
        the host into ``host_reads``."""
        from ..batch_context import _WARMUP_CALLS
        from ..compiler.stream import reads_host
        from ..ops.cuda.build import tally_launches

        sides = self._eng._sides
        for device in self._by_device:
            sides[device].wait_stream(torch.cuda.current_stream(device))
        with tally_launches() as warm, contextlib.ExitStack() as streams, \
                torch.inference_mode():
            for device in self._by_device:
                streams.enter_context(torch.cuda.stream(sides[device]))
            for _ in range(_WARMUP_CALLS):
                self.body()
        for device in self._by_device:
            torch.cuda.current_stream(device).wait_stream(sides[device])
            torch.cuda.synchronize(device)
        self.host_reads = reads_host(warm)

    def _graph(self, device, fn):
        """``fn()`` captured on ``device``: (graph, its static outputs, the
        launches the capture counted). The step keeps the cached operands
        the graph reads (``build.hold``)."""
        from ..ops.cuda.build import add_launches, holding, tally_launches
        from ..utils.collector import collector_paused

        eng = self._eng
        graph = torch.cuda.CUDAGraph()
        with _current(device), tally_launches() as captured, holding() as held, \
                collector_paused():
            with torch.cuda.graph(graph, pool=eng._pools[device], stream=eng._sides[device],
                                  capture_error_mode="thread_local"), \
                    torch.inference_mode():
                outs = fn()
        # The capture launched nothing: its counts move to the replays.
        add_launches(captured, -1)
        self._held.append(held)
        return graph, outs, tuple(captured)

    def capture(self) -> None:
        """Per card a graph of its cells; the merge in the controller's
        graph when every cell is there, else in a graph of its own over
        static copies of the other cards' results."""
        ctrl = self._cells.controller
        launches = []
        if list(self._by_device) == [ctrl]:
            graph, self.outs, counted = self._graph(ctrl, self.body)
            self.graphs.append((ctrl, graph))
            launches.extend(counted)
        else:
            gathered = {}
            for device in self._by_device:
                graph, outs, counted = self._graph(device, lambda: self._on(device))
                self.graphs.append((device, graph))
                launches.extend(counted)
                for cell, got in outs.items():
                    if device == ctrl:
                        gathered[cell] = got
                        continue
                    copies = tuple(None if t is None else torch.empty(
                        t.shape, dtype=t.dtype, device=ctrl) for t in got)
                    self._copies.extend((dst, src) for dst, src in zip(copies, got)
                                        if src is not None)
                    gathered[cell] = copies
            self._merge_graph, self.outs, counted = self._graph(
                ctrl, lambda: self._cells.merge(gathered, self._k))
            launches.extend(counted)
        self.launches = tuple(launches)

    def run(self):
        """The step: each card's graph replayed on its current stream, the
        other cards' results copied to the controller and the merge
        replayed there (or the eager body). Returns the controller's
        (confidences, indices, logits, embeddings or None)."""
        if not self.graphs:
            return self.body()
        from ..ops.cuda.build import add_launches

        for device, graph in self.graphs:
            with _current(device):
                graph.replay()
        for dst, src in self._copies:
            dst.copy_(src, non_blocking=True)
        if self._merge_graph is not None:
            with _current(self._cells.controller):
                self._merge_graph.replay()
        add_launches(self.launches)
        return self.outs


def _prepare(steps) -> None:
    """Warm the first of ``steps`` (steps of one key over different
    buffers), then capture each, unless the warm calls read the card on the
    host: the key then runs eagerly. One capture at a time in the process
    (``build.one_capture_at_a_time``)."""
    from ..ops.cuda.build import one_capture_at_a_time

    try:
        with one_capture_at_a_time():
            steps[0].warm()
            for step in steps:
                step.host_reads = steps[0].host_reads
                if not step.host_reads:
                    step.capture()
    except InferenceError:
        raise
    except Exception as e:  # noqa: BLE001 - capture refused (a host sync,
        # an unsupported call): the key cannot run on the card
        raise InferenceError(f"CUDA graph capture of the mesh step failed: {e}") from e


class _MeshBatch:
    """A batch key's program on the card: ``[bucket, S]`` float32 rows in,
    per card the rows of its data indices (and, ``with_row_mask``, their
    species mask) in static buffers, one :class:`_MeshStep` captured over
    them. One call at a time (the static buffers are shared)."""

    def __init__(self, eng, bucket: int, with_embeddings: bool, with_row_mask: bool):
        self._cells = cells = eng._cells
        S = eng.config.sample_count
        self.bucket = bucket
        self.rows = rows = bucket // cells.dp
        self._n = eng.config.num_species
        n_padded = cells.head.n_padded
        self._spans = cells.spans()
        self.x = {device: torch.zeros((count * rows, S), dtype=torch.float32, device=device)
                  for device, (_, count) in self._spans.items()}
        self._x_host = torch.zeros((bucket, S), dtype=torch.float32, pin_memory=True)
        self.row_mask = None
        if with_row_mask:
            self.row_mask = {device: torch.ones((count * rows, n_padded), dtype=torch.bool,
                                                device=device)
                             for device, (_, count) in self._spans.items()}
            # Pad columns stay False: pad logits never win.
            self._mask_host = torch.zeros((bucket, n_padded), dtype=torch.bool,
                                          pin_memory=True)
        self._lock = threading.Lock()
        self._last: Optional[_Done] = None
        self.step = _MeshStep(eng, eng.top_k, with_embeddings, self._frames, self._mask)
        _prepare([self.step])

    @property
    def eager(self) -> bool:
        return self.step.eager

    def _frames(self, d, m, device):
        first = self._spans[device][0]
        return self.x[device][(d - first) * self.rows:(d - first + 1) * self.rows]

    def _mask(self, d, m, device):
        if self.row_mask is None:
            return None
        first = self._spans[device][0]
        part = self.row_mask[device][(d - first) * self.rows:(d - first + 1) * self.rows]
        return self._cells.block(part, (None, self._cells.model_axis), m)

    def _staged(self, x) -> torch.Tensor:
        """``x`` as pinned host rows of the bucket: a batch context's pinned
        staging buffer as it is, anything else copied into this program's
        (zero rows past its end)."""
        if isinstance(x, torch.Tensor) and x.is_pinned() and x.shape[0] == self.bucket:
            return x
        src = torch.as_tensor(np.ascontiguousarray(x, np.float32))
        self._x_host[:src.shape[0]].copy_(src)
        self._x_host[src.shape[0]:].zero_()
        return self._x_host

    def __call__(self, x, row_mask: Optional[np.ndarray] = None):
        """Stage ``x`` (``[b <= bucket, S]``) and ``row_mask`` (bool
        ``[bucket, num_species]``), replay: the controller's static
        (confidences, indices, logits, embeddings or None), valid until the
        next call. Returns with the step in flight."""
        if self._last is not None:
            # An abandoned (timed-out, cancelled) call may still read the
            # pinned buffers.
            self._last.synchronize()
        src = self._staged(x)
        if row_mask is not None:
            self._mask_host[:, :self._n].copy_(torch.from_numpy(np.asarray(row_mask, bool)))
        for device, (first, count) in self._spans.items():
            lo, hi = first * self.rows, (first + count) * self.rows
            with _current(device):
                self.x[device].copy_(src[lo:hi], non_blocking=True)
                if row_mask is not None:
                    self.row_mask[device].copy_(self._mask_host[lo:hi], non_blocking=True)
        with torch.inference_mode():
            outs = self.step.run()
        self._last = self._cells.done()
        return outs

    def run(self, x, row_mask, n_valid: int, options):
        """One call: stage, replay, wait (honouring ``options``) and read
        back the first ``n_valid`` rows as numpy."""
        with self._lock:
            outs = self(x, row_mask)
            _wait(self._last, options)
            return rows_on_host(outs, n_valid)


def rows_on_host(outs, n_valid: int):
    """The first ``n_valid`` rows of a step's (confidences, indices, logits,
    embeddings or None), as numpy."""
    return tuple(None if t is None else _host(t[:n_valid]) for t in outs)


class _Layout:
    """A card's share of a streaming key's tile in its ring: the samples
    from ``offset`` (the span of its data indices), as the key's dtype and
    device shape, ``nbytes`` long (the attributes ``_Ring`` reads)."""

    def __init__(self, first: int, count: int, rows: int, step: int, S: int, dtype):
        from ..compiler.stream import audio_device_shape

        self.first = first
        self.offset = first * rows * step
        self.dtype = dtype
        self.shape = audio_device_shape(count, rows, step, S)
        self.nbytes = ((count * rows - 1) * step + S) * dtype.itemsize


class _MeshTiles:
    """A streaming key's program: on the card, per slot of the rings, a
    :class:`_MeshStep` over that slot's device buffers (framing, the int16
    scale and activation cast, the cells' forwards and top-K, the merge),
    and, ``with_mask``, a static per-call mask on each card. On the host
    (or a mesh that names it) there is no step: the engine runs its eager
    tile loop."""

    def __init__(self, eng, tile: int, step: int, dtype: np.dtype,
                 with_embeddings: bool, with_mask: bool):
        from ..compiler.stream import RING_SLOTS, _Ring

        self._cells = cells = eng._cells
        self.tile, self.step = tile, step
        self.with_embeddings = with_embeddings
        self.rows = rows = tile // cells.dp
        self.dtype = torch.from_numpy(np.empty(0, dtype)).dtype
        self.steps = []
        self.mask = None
        if not eng._on_card:
            return
        S = eng.config.sample_count
        self.layouts = {device: _Layout(first, count, rows, step, S, self.dtype)
                        for device, (first, count) in cells.spans().items()}
        if with_mask:
            # Pad columns stay False.
            self.mask = {device: torch.zeros(cells.head.n_padded, dtype=torch.bool,
                                             device=device) for device in self.layouts}
        k = max(1, eng.top_k)
        for i in range(RING_SLOTS):
            audios = {device: _Ring.view(eng._rings[device].devices[i], layout)
                      for device, layout in self.layouts.items()}
            self.steps.append(_MeshStep(eng, k, with_embeddings,
                                        self._frames_of(eng, audios), self._mask_of))
        _prepare(self.steps)

    def _frames_of(self, eng, audios):
        from ..compiler.stream import frame_tile, prepare_frames

        S = eng.config.sample_count

        def frames_of(d, m, device):
            first = self.layouts[device].first
            return prepare_frames(frame_tile(audios[device], d - first, self.rows, self.step, S),
                                  eng.precision)

        return frames_of

    def _mask_of(self, d, m, device):
        if self.mask is None:
            return None
        return self._cells.block(self.mask[device], (self._cells.model_axis,), m)

    @property
    def eager(self) -> bool:
        """True when the tiles run eagerly (the host, an eager key)."""
        return not self.steps or self.steps[0].eager

    @property
    def host_reads(self) -> int:
        return self.steps[0].host_reads if self.steps else 0
