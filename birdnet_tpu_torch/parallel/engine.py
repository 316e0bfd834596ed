"""ShardedEngine: the multi-device counterpart of the single-device engines.

The counterpart of :mod:`birdnet_tpu.parallel.engine`. It exposes the
surface the Classifier drives (``run_batch`` like
compiler/engine.InferenceEngine, ``analyze`` like compiler/stream.
StreamingEngine) but runs over a :class:`~.sharding.Mesh`: segment batches
split over the ``data`` axis, the classifier head over ``model`` (see
parallel/sharding.py for the layout rules), and audio is copied to each
device.

One process drives the mesh, as in the JAX package: a step issues every
cell's forward and top-K without a host sync and gathers the results on
the controller device (``devices[0, 0]``); ``run_batch`` then waits for one
CUDA event per card, honouring the options' timeout and cancellation.

Where the JAX engine compiles a program per key, this one keeps, on a mesh
whose every cell is a card, a program per key captured as CUDA graphs
(parallel/graphs.py): ``compiled(bucket, with_embeddings, donate,
with_row_mask)`` a :class:`~.graphs._MeshBatch` (static per-card inputs,
one graph per card and the merge; a one-card mesh's step is one replay),
and per streaming key ``(tile, step, dtype, with_embeddings, with_mask)`` a
:class:`~.graphs._MeshTiles` over per-card rings of tile buffers, as the
single-device stream keeps its keys (compiler/stream.py). Each cache keeps
at most ``compiler.stream.MAX_PROGRAMS`` keys, the least recently used
dropped first. On the host (or a mesh that names it) the step runs
eagerly, call by call. Differences that follow:

- ``donate`` is accepted and ignored (the key leaves it out), and the key
  counts embeddings only where the family has them.
- ``analyze`` is compiler/stream.streaming_analyze's superchunk loop; the
  host loops over a superchunk's tiles and replays the key's graphs per
  tile, the next tile's upload overlapping the current replay.

Selected via ``Classifier.builder().with_mesh(...)``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..compiler.engine import _host, _wait, default_precision
from ..compiler.importer import ImportedModel
from ..errors import InferenceCancelledError, InferenceError, InferenceTimeoutError
from ..inference_options import InferenceOptions
from ..types import ModelConfig
from .graphs import _MeshBatch, _MeshTiles, rows_on_host
from .sharding import Mesh, _Cells


class ShardedEngine:
    """Mesh-parallel inference engine (DP batches + TP classifier head)."""

    streams_natively = True  # Classifier streams through this engine directly

    def __init__(
        self,
        imported: ImportedModel,
        config: ModelConfig,
        mesh: Mesh,
        precision: Optional[str] = None,
        top_k: int = 10,
        tile: Optional[int] = None,
        data_axis: str = "data",
        model_axis: str = "model",
        species_mask: Optional[np.ndarray] = None,
    ):
        if data_axis not in mesh.shape or model_axis not in mesh.shape:
            raise InferenceError(
                f"mesh must have {data_axis!r} and {model_axis!r} axes "
                f"(got {tuple(mesh.axis_names)}); build one with "
                f"birdnet_tpu_torch.parallel.make_mesh()"
            )
        from ..compiler.stream import CPU_TILE, CUDA_TILE

        self.mesh = mesh
        self.dp = mesh.shape[data_axis]
        self.device = mesh.devices.flat[0]
        self.precision = precision or default_precision(self.device)
        self.config = config
        self.top_k = max(0, min(top_k, config.num_species))
        default_tile = CUDA_TILE if self.device.type == "cuda" else CPU_TILE
        # Tile must split evenly over the data axis.
        self.tile = tile if tile is not None else max(
            self.dp, (default_tile // self.dp) * self.dp
        )
        if self.tile % self.dp:
            raise InferenceError(
                f"tile {self.tile} not divisible by data-axis size {self.dp}"
            )
        self._cells = _Cells(imported, config, mesh, self.precision, data_axis,
                             model_axis, species_mask)
        self.logits_index = self._cells.logits_index
        self.embed_index = self._cells.embed_index
        # False when the head feeds an op that is not positionwise on the
        # species axis: every cell then holds it whole and only the cells
        # (d, 0) run (parallel/sharding.py).
        self.head_sharded = self._cells.head.sharded
        self.params = self._cells.shard(self._cells.head.model.params)
        # The graphs run where every cell is a card; per card a side stream
        # for warm calls and captures, a copy stream for the rings' uploads
        # and a graph pool shared by the card's graphs.
        self._on_card = all(dev.type == "cuda" for dev in mesh.devices.flat)
        cards = self._cells.cuda_devices if self._on_card else []
        self._sides = {dev: torch.cuda.Stream(dev) for dev in cards}
        self._copy_streams = {dev: torch.cuda.Stream(dev) for dev in cards}
        self._pools = {dev: torch.cuda.graph_pool_handle() for dev in cards}
        self._rings: Optional[Dict[torch.device, object]] = None
        self._compiled: "OrderedDict[Tuple, object]" = OrderedDict()
        self._programs: "OrderedDict[Tuple, _MeshTiles]" = OrderedDict()
        self._lock = threading.Lock()
        self._run_lock = threading.Lock()

    def _make_room(self, cache: OrderedDict) -> None:
        """Drop the least recently used keys of ``cache`` until one more
        fits, after the cards finish what may read them."""
        from ..compiler.stream import MAX_PROGRAMS

        if len(cache) < MAX_PROGRAMS:
            return
        for dev in self._cells.cuda_devices:
            torch.cuda.synchronize(dev)
        while len(cache) >= MAX_PROGRAMS:
            cache.popitem(last=False)

    # -- batched path (InferenceEngine-compatible) -------------------------

    def _batch_bucket(self, b: int) -> int:
        """The JAX engine's bucket: ``b`` up to a power of two, then up to a
        multiple of the data axis (sizes 1-32 make at most six keys)."""
        p2 = 1 << (b - 1).bit_length() if b > 1 else 1
        return max(self.dp, -(-p2 // self.dp) * self.dp)

    def compiled(
        self,
        bucket: int,
        with_embeddings: bool = True,
        donate: bool = False,
        with_row_mask: bool = False,
    ):
        """The program of a batch bucket (cached; bucket is normalized up to
        a data-axis multiple so warmup/context keys match run_batch's): on
        the card a :class:`~.graphs._MeshBatch`, captured here on first
        use (a failed capture raises :class:`InferenceError`); on the host
        an :class:`_EagerBatch`. Either is called as ``fn(x)`` or
        ``fn(x, row_mask)`` on a host float32 ``[bucket, S]`` batch and
        bool ``[bucket, num_species]`` masks, returning (conf, idx, logits,
        embeddings or None) on the controller device, and ``fn.run(x,
        row_mask, n_valid, options)`` is one whole call."""
        bucket = -(-bucket // self.dp) * self.dp
        emit_emb = with_embeddings and self.embed_index is not None
        key = (bucket, emit_emb, with_row_mask)
        with self._lock:
            program = self._compiled.get(key)
            if program is not None:
                self._compiled.move_to_end(key)
                return program
            self._make_room(self._compiled)
            if self._on_card:
                program = _MeshBatch(self, bucket, emit_emb, with_row_mask)
            else:
                program = _EagerBatch(self, bucket, emit_emb)
            self._compiled[key] = program
            return program

    def run_batch(
        self,
        segments: np.ndarray,
        options: Optional[InferenceOptions] = None,
        with_embeddings: bool = True,
        bucket: Optional[int] = None,
        donate: bool = False,
        row_masks: Optional[np.ndarray] = None,
        n_valid: Optional[int] = None,
    ):
        """Run a ``[B, S]`` float32 batch (InferenceEngine's contract):
        numpy (conf [b,k], idx [b,k], logits [b,N], embeddings [b,E] or
        None) for its first ``b`` rows (``n_valid`` when the batch arrives
        padded; padded rows get all-True ``row_masks``)."""
        b = n_valid if n_valid is not None else segments.shape[0]
        bkt = bucket if bucket is not None else self._batch_bucket(segments.shape[0])
        if bkt % self.dp:
            bkt = -(-bkt // self.dp) * self.dp
        try:
            fn = self.compiled(
                bkt, with_embeddings, donate, with_row_mask=row_masks is not None
            )
            rows = None
            if row_masks is not None:
                rows = np.ones((bkt, self.config.num_species), dtype=bool)
                rows[:b] = row_masks
            return fn.run(segments, rows, b, options)
        except (InferenceCancelledError, InferenceTimeoutError, InferenceError):
            raise
        except Exception as e:  # noqa: BLE001 - device runtime failures (OOM, …)
            raise InferenceError(str(e)) from e

    # -- streaming path (StreamingEngine-compatible) -----------------------

    def _program(self, step: int, dtype, with_embeddings: bool = False,
                 with_mask: bool = False) -> _MeshTiles:
        """The streaming key's program, made (on the card: captured) on first
        use. Called under ``_run_lock``, with no work of the engine in
        flight but that of an abandoned (timed-out, cancelled) call."""
        dtype = np.dtype(dtype)
        key = (self.tile, step, dtype.name, with_embeddings, with_mask)
        program = self._programs.get(key)
        if program is not None:
            self._programs.move_to_end(key)
            return program
        if self._on_card:
            self._ensure_rings()
        self._make_room(self._programs)
        program = self._programs[key] = _MeshTiles(
            self, self.tile, step, dtype, with_embeddings, with_mask)
        return program

    def _ensure_rings(self) -> None:
        """Per card a ring of tile buffers wide enough for the span of its
        data indices at the current ``tile`` (float32, the widest dtype); a
        larger tile replaces the rings and drops every key, whose graphs
        read the old buffers."""
        from ..compiler.stream import _MAX_ITEMSIZE, _Ring

        rows = self.tile // self.dp
        S = self.config.sample_count
        need = {dev: count * rows * S * _MAX_ITEMSIZE
                for dev, (_, count) in self._cells.spans().items()}
        if self._rings is not None and all(
                self._rings[dev].nbytes >= n for dev, n in need.items()):
            return
        for dev in self._cells.cuda_devices:
            torch.cuda.synchronize(dev)
        self._programs.clear()
        self._rings = None
        self._rings = {dev: _Ring(n, dev) for dev, n in need.items()}

    @property
    def programs(self) -> Dict[Tuple, _MeshTiles]:
        """The streaming programs the engine keeps, least recently used
        first, by key ``(tile, step, dtype name, with_embeddings,
        with_mask)``."""
        return dict(self._programs)

    def _run_tiles(self, samples: torch.Tensor, lo: int, n_tiles: int, program: _MeshTiles,
                   run_mask):
        """One superchunk: ``n_tiles`` tiles from sample ``lo`` of the host
        recording ``samples``. On the card each tile's span of each card's
        data indices goes through that card's ring (staged on the host,
        uploaded on the card's copy stream) and the key's step of the slot
        runs; on the host :meth:`_eager_tiles`. Returns ``(conf
        [n_tiles*tile, k], idx, [emb])`` on the controller and the step's
        events (None on the host)."""
        if not program.steps:
            return self._eager_tiles(samples, lo, n_tiles, program, run_mask)
        tile, step = program.tile, program.step
        compute = {dev: torch.cuda.current_stream(dev) for dev in program.layouts}
        outs = None
        with torch.inference_mode():
            if program.mask is not None:
                n = self.config.num_species
                for mask in program.mask.values():
                    mask[:n].copy_(run_mask)
            for t in range(n_tiles):
                start = lo + t * tile * step
                for dev, layout in program.layouts.items():
                    i = self._rings[dev].stage(samples, start + layout.offset, layout)
                for dev, layout in program.layouts.items():
                    self._rings[dev].upload(i, layout, self._copy_streams[dev], compute[dev])
                conf, idx, _, emb = program.steps[i].run()
                for dev in program.layouts:
                    self._rings[dev].consumed[i].record(compute[dev])
                result = (conf, idx) + ((emb,) if program.with_embeddings else ())
                if outs is None:
                    outs = tuple(r.new_empty((n_tiles * tile,) + tuple(r.shape[1:]))
                                 for r in result)
                for dest, r in zip(outs, result):
                    dest[t * tile:(t + 1) * tile].copy_(r)
        return outs, self._cells.done()

    def _eager_tiles(self, samples: torch.Tensor, lo: int, n_tiles: int, program, run_mask):
        """The superchunk run eagerly, tile by tile: each tile's span is
        copied to every device of the mesh and each cell frames, scales and
        casts its rows (the host's path, and the plain version the card's
        graphs are held to)."""
        from ..compiler.stream import audio_device_shape, frame_tile, prepare_frames

        tile, step, with_embeddings = program.tile, program.step, program.with_embeddings
        S = self.config.sample_count
        span = (tile - 1) * step + S
        rows = tile // self.dp
        k = max(1, self.top_k)
        devices = set(self._cells.devices.flat)
        call_mask = None if run_mask is None else run_mask.cpu().numpy()
        results = []
        with torch.inference_mode():
            for t in range(n_tiles):
                start = lo + t * tile * step
                part = samples[start:start + span]
                chunk = torch.zeros(span, dtype=part.dtype)
                chunk[:part.shape[0]] = part
                chunk = chunk.reshape(audio_device_shape(1, tile, step, S))
                placed = {device: chunk.to(device) for device in devices}

                def frames_of(d, device):
                    return prepare_frames(frame_tile(placed[device], d, rows, step, S),
                                          self.precision)

                conf, idx, _, emb = self._cells.run(
                    self.params, frames_of, k, with_embeddings, call_mask=call_mask)
                results.append((conf, idx) + ((emb,) if with_embeddings else ()))
        outs = tuple(torch.cat(parts) for parts in zip(*results))
        return outs, self._cells.done()

    def _drain(self, outs, n: int):
        """The first ``n`` rows of finished results, on the host."""
        return [_host(o[:n]) for o in outs]

    def analyze(
        self,
        samples: np.ndarray,
        overlap_seconds: float = 0.0,
        options: Optional[InferenceOptions] = None,
        with_embeddings: bool = False,
        n_segments: Optional[int] = None,
        species_mask=None,
    ):
        """Classify every (overlapping) segment of ``samples``, as
        ``StreamingEngine.analyze`` does, over the mesh."""
        from ..compiler.stream import streaming_analyze

        with self._run_lock:
            return streaming_analyze(self, samples, overlap_seconds, options,
                                     with_embeddings, n_segments,
                                     species_mask=species_mask)

    def warmup(self, batch_sizes=(1,)) -> None:
        """Make (on the card: capture) each batch size's program, as the JAX
        method compiles it."""
        for b in batch_sizes:
            self.compiled(self._batch_bucket(b))


class _EagerBatch:
    """A batch key's step on the host (or a mesh that names it): the
    cells' forwards issued call by call on ``[bucket, S]`` rows copied to
    each device."""

    eager = True

    def __init__(self, eng: ShardedEngine, bucket: int, with_embeddings: bool):
        self._eng = eng
        self.bucket = bucket
        self._emb = with_embeddings

    def __call__(self, x, row_mask: Optional[np.ndarray] = None):
        cells = self._eng._cells
        rows = self.bucket // cells.dp
        x = np.asarray(x, np.float32)
        if x.shape[0] < self.bucket:
            pad = np.zeros((self.bucket - x.shape[0], x.shape[1]), dtype=np.float32)
            x = np.concatenate([x, pad], axis=0)
        host = torch.from_numpy(np.ascontiguousarray(x))
        placed = {device: host.to(device, non_blocking=True)
                  for device in set(cells.devices.flat)}
        with torch.inference_mode():
            return cells.run(
                self._eng.params, lambda d, device: placed[device][d * rows:(d + 1) * rows],
                self._eng.top_k, self._emb, row_mask=row_mask)

    def run(self, x, row_mask, n_valid: int, options):
        outs = self(x, row_mask)
        _wait(self._eng._cells.done(), options)
        return rows_on_host(outs, n_valid)
