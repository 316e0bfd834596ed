"""Streaming whole-recording analysis: segment, classify and select top-K for
an entire recording on the device, reading back only ``[N, K]``.

The counterpart of :mod:`birdnet_tpu.compiler.stream`:

- audio goes to the device as int16 (WAV's native width, half the bytes;
  the ``/32768`` scale runs on the device) or float32;
- segments are framed on the device from the uploaded samples, so
  overlapping segments share them;
- each tile runs the model and the fused sigmoid top-K;
- the host reads back only ``[n_segments, K]`` confidences and indices
  (plus embeddings when asked for).

**One program per streaming key.** Where the JAX engine compiles one XLA
program per key ``(n_tiles, step, dtype, with_embeddings, with_mask)``,
a ``lax.scan`` over the tiles, this engine keeps one
:class:`_TileProgram` per key ``(tile, step, dtype, with_embeddings,
with_mask)``: the key without the tile count, since the program runs one
tile and the host loops over the tiles. On the card a program is, for
each slot of the engine's ring, one CUDA graph of the tile's body over
that slot's device buffer: framing, the int16 scale and activation cast,
the forward, the fused top-K and the embeddings.

Every key shares the engine's one :class:`_Ring` of :data:`RING_SLOTS`
slots, each a host tile buffer (pinned on the card) and a device tile
buffer, sized to the largest span of the tile, ``tile * S`` float32
samples; a key views its span, ``(tile - 1) * step + S`` samples of its
dtype, at their start. Per tile the host copies the tile's span into the
next slot's host buffer while the card runs the tile before it, uploads
it on a copy stream after the last replay that read the slot's device
buffer, and the compute stream waits for that upload, replays the key's
graph of the slot and copies its outputs into the superchunk's result
rows. A host buffer is refilled only after its last upload. With a
device buffer per slot the upload of one tile overlaps the replay of the
one before. The engine keeps at most :data:`MAX_PROGRAMS` keys, the least
recently used dropped first, so the keys a client's overlaps make hold
the card's memory to one ring and that many keys' graphs.

Capture follows the batch context: warm calls on a side stream (they
build the kernels and fill every lazy cache), then ``torch.cuda.graph``.
A capture that fails raises :class:`InferenceError`; nothing carries on
eagerly. A forward that reads the card on the host during a call (a Loop
with a tensor trip count counts into ``ops.HOST_READS``) cannot be
captured, though the JAX engine compiles it: the warm calls' count of
such reads decides, before any capture, that the key runs its tile body
eagerly over the same ring ("an eager key"). On the host every key is
eager: the same ring and scheduling with the eager body in place of the
replay. The private ``_use_graphs = False`` makes the card's keys eager
too: the plain version the graphs are held to.

Kernel wrappers count a launch when they run. A graph's capture runs
them once without launching anything, so the capture's counts are taken
back and each replay adds the launches its graph captured.

Differences that follow:

- No bucket padding: XLA padded the tile count to a bucket to bound its
  compile variants; here a superchunk runs ``ceil(n_seg / tile)`` tiles.
  The results are the same rows.
- The graphs keep what the forward read when they were captured: a
  running engine keeps its captured ``BIRDNET_STAGE123_SPLIT``, as a JAX
  executable keeps the value it was traced with.

Superchunks bound device memory for the results and the cancellation/
timeout granularity: options are honoured between superchunks, as the
reference honours them between batches.

The engine times its host steps into the process's recorder
(:mod:`birdnet_tpu_torch.utils.profiling`): a call's ``birdnet.stream.call``
with ``.lock_wait`` inside; per tile ``.stage`` (``.stage_wait`` for the
slot's last upload, then ``.stage_copy``), ``.upload`` and ``.replay``; per
superchunk ``.wait`` and ``.drain`` and the counters ``.tiles``, ``.rows``
and ``.rows_padded`` (rows past the last segment), ``.eager_tiles`` for an
eager key; per captured key ``.capture`` (``.capture_warm``, a
``.capture_graph`` per slot) and the counter ``.captures``.
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .._demux import demux_indices
from ..errors import InferenceError
from ..inference_options import InferenceOptions
from ..types import ModelConfig
from ..utils.profiling import count, span
from .engine import _host, _wait
from .importer import ImportedModel, make_forward, params_to_torch

# Tiles per superchunk, the JAX package's cap: 96 tiles of 128 segments
# are 10.2 h of 3 s audio.
MAX_TILES = 96

# Superchunk cap when a cancellation/timeout monitor is active: a cancel
# can only strand work already committed to the device, so monitored runs
# dispatch 16-tile superchunks (the reference's RunOptions::terminate stops
# within ~10 ms; this bounds the analogous abandoned work, reference:
# src/classifier.rs:527-554).
MONITORED_MAX_TILES = 16

# Segments per tile. The CPU takes the JAX package's host tile. On the H100
# the eager tile loop ran fastest at 128 of 32, 64 and 128 in both frontend
# forms: larger tiles spread the eager forward's ~600 host calls over more
# segments. Replaying graphs over the ring, 128 also ran faster than 32
# (PERF.md, the stream's program per key); a benchmark decides (ROADMAP A5).
CPU_TILE = 32
CUDA_TILE = 128

# Slots of the engine's tile ring: the host fills one slot's host buffer
# while the card runs the tile in the other's device buffer.
RING_SLOTS = 2

# Streaming keys an engine keeps at once; a new key past this drops the
# least recently used, its graphs and static outputs with it. Each distinct
# overlap a request sends makes a key.
MAX_PROGRAMS = 8

# Bytes per sample of the widest streamed dtype (float32): the ring holds
# any key's span of its tile.
_MAX_ITEMSIZE = 4

# Precision policies whose activations are bf16: frames are cast to bf16
# right after the int16 scale.
_BF16_ACTIVATION_POLICIES = frozenset(("fast", "bf16"))


def prepare_frames(frames: torch.Tensor, precision: str) -> torch.Tensor:
    """Scale int16 frames to float32 (× 1/32768), then apply the
    activation-precision cast."""
    if frames.dtype != torch.float32:
        frames = frames.to(torch.float32) * (1.0 / 32768.0)
    if precision in _BF16_ACTIVATION_POLICIES:
        frames = frames.to(torch.bfloat16)
    return frames


def frame_tile(audio: torch.Tensor, tile_idx: int, tile: int, step: int,
               S: int) -> torch.Tensor:
    """One tile's ``[tile, S]`` frames out of the device-resident audio.

    Zero-overlap audio arrives shaped ``[rows, S]`` (a free host-side
    view), so framing is a row slice. Overlapping audio stays 1-D: an
    ``unfold`` view of the tile's span, copied once."""
    if step == S:
        return audio[tile_idx * tile:(tile_idx + 1) * tile]
    start = tile_idx * tile * step
    span = (tile - 1) * step + S
    return audio[start:start + span].unfold(0, S, step).contiguous()


def audio_device_shape(n_tiles: int, tile: int, step: int, S: int):
    """Device-side audio shape for ``n_tiles`` tiles (2-D rows when
    overlap-free); the ring holds one tile."""
    if step == S:
        return (n_tiles * tile, S)
    return ((n_tiles * tile - 1) * step + S,)


def reads_host(tally) -> int:
    """How many of the counts in a :func:`tally_launches` tally are reads
    of a card value on the host (``compiler.ops.HOST_READS``)."""
    from .ops import HOST_READS

    return sum(1 for launches, _ in tally if launches is HOST_READS)


class _Ring:
    """An engine's tile ring, shared by its keys: :data:`RING_SLOTS` slots
    that the host fills in turn, each a host buffer (pinned on the card) of
    ``nbytes`` and, on the card, the device buffer it is uploaded into,
    with the events that order their reuse. Its buffers stay where they
    are while it lives: the keys' graphs read the device buffers."""

    def __init__(self, nbytes: int, device: torch.device):
        on_cuda = device.type == "cuda"
        slots = range(RING_SLOTS)
        self.nbytes = nbytes
        self.hosts = [torch.zeros(nbytes, dtype=torch.uint8, pin_memory=on_cuda)
                      for _ in slots]
        self.devices = ([torch.zeros(nbytes, dtype=torch.uint8, device=device) for _ in slots]
                        if on_cuda else None)
        self.uploaded = [torch.cuda.Event() if on_cuda else None for _ in slots]
        self.consumed = [torch.cuda.Event() if on_cuda else None for _ in slots]
        self._next = 0

    @staticmethod
    def view(buf: torch.Tensor, program: "_TileProgram") -> torch.Tensor:
        """A key's tile audio at the start of a ring buffer."""
        return buf[:program.nbytes].view(program.dtype).view(program.shape)

    def stage(self, samples: torch.Tensor, start: int, program: "_TileProgram") -> int:
        """Copy the key's span at ``start`` of the host recording into the
        next host buffer, zero-padded past the recording's end, once that
        buffer's last upload is done. Returns the buffer's slot."""
        with span("birdnet.stream.stage"):
            i = self._next
            self._next = (i + 1) % RING_SLOTS
            if self.uploaded[i] is not None:
                with span("birdnet.stream.stage_wait"):
                    self.uploaded[i].synchronize()
            with span("birdnet.stream.stage_copy"):
                staging = self.hosts[i][:program.nbytes].view(program.dtype)
                part = samples[start:start + staging.shape[0]]
                # torch's copy splits the span over the intra-op threads
                # (numpy's copies on one: the host step that paced the stream).
                staging[:part.shape[0]].copy_(part)
                staging[part.shape[0]:].zero_()
            return i

    def upload(self, i: int, program: "_TileProgram", copy_stream, compute) -> torch.Tensor:
        """Slot ``i``'s tile audio, which the key's body reads: on the host,
        its host buffer; on the card, its device buffer, into which the
        host buffer is copied on the copy stream after the last replay that
        read the device buffer, the compute stream waiting for the copy."""
        with span("birdnet.stream.upload"):
            if self.devices is None:
                return self.view(self.hosts[i], program)
            copy_stream.wait_event(self.consumed[i])
            with torch.cuda.stream(copy_stream):
                self.devices[i][:program.nbytes].copy_(self.hosts[i][:program.nbytes],
                                                       non_blocking=True)
            self.uploaded[i].record(copy_stream)
            compute.wait_event(self.uploaded[i])
            return self.view(self.devices[i], program)


class _TileProgram:
    """A streaming key's tile body and, on the card unless the key is
    eager, its graph over each of the ring's device buffers with the
    graphs' static outputs and the launches their captures counted."""

    def __init__(self, eng: "StreamingEngine", tile: int, step: int,
                 dtype: np.dtype, with_embeddings: bool, with_mask: bool):
        S = eng.config.sample_count
        self.tile, self.step = tile, step
        self._eng = eng
        self._with_embeddings = with_embeddings
        device = eng.device
        self.mask = (torch.ones(eng.config.num_species, dtype=torch.bool, device=device)
                     if with_mask else None)
        self.dtype = torch.from_numpy(np.empty(0, dtype)).dtype
        self.shape = audio_device_shape(1, tile, step, S)
        self.nbytes = ((tile - 1) * step + S) * dtype.itemsize
        self.graphs = []
        self.outs = []
        self.launches = []
        # Per graph, the cached operands it reads (``build.hold``).
        self.held = []
        self.host_reads = 0
        if device.type == "cuda" and eng._use_graphs:
            self._capture([_Ring.view(buf, self) for buf in eng._ring.devices])

    @property
    def eager(self) -> bool:
        """True when the tile body runs eagerly (the host, an eager key)."""
        return not self.graphs

    def body(self, audio: torch.Tensor):
        """The tile body over one tile's audio: ``(conf [tile, k],
        idx [tile, k])`` and, with embeddings, ``emb [tile, E]``."""
        from ..ops.topk import fused_sigmoid_topk

        eng = self._eng
        frames = prepare_frames(
            frame_tile(audio, 0, self.tile, self.step, eng.config.sample_count),
            eng.precision)
        outs = eng._forward(eng.params, frames)
        result = fused_sigmoid_topk(outs[eng.logits_index], eng.top_k,
                                    eng._mask_dev, self.mask)
        if self._with_embeddings:
            result = result + (outs[eng.embed_index],)
        return result

    def _capture(self, audios) -> None:
        """Warm calls on a side stream, counting host reads; then, unless
        the body read the card on the host, the key's graph over each
        tile audio of ``audios``."""
        from ..batch_context import _WARMUP_CALLS
        from ..ops.cuda.build import add_launches, holding, tally_launches
        from ..utils.collector import collector_paused

        eng = self._eng
        device = eng.device
        side = eng._capture_stream
        side.wait_stream(torch.cuda.current_stream(device))
        try:
            with span("birdnet.stream.capture"):
                with span("birdnet.stream.capture_warm"):
                    with tally_launches() as warm, torch.cuda.stream(side), \
                            torch.inference_mode():
                        for _ in range(_WARMUP_CALLS):
                            self.body(audios[0])
                    torch.cuda.current_stream(device).wait_stream(side)
                    torch.cuda.synchronize(device)
                self.host_reads = reads_host(warm)
                if self.host_reads:
                    return
                for audio in audios:
                    graph = torch.cuda.CUDAGraph()
                    with span("birdnet.stream.capture_graph"), tally_launches() as captured, \
                            holding() as held, collector_paused():
                        with torch.cuda.graph(graph, pool=eng._graph_pool, stream=side,
                                              capture_error_mode="thread_local"), \
                                torch.inference_mode():
                            outs = self.body(audio)
                    # The capture launched nothing: its counts move to the replays.
                    add_launches(captured, -1)
                    self.graphs.append(graph)
                    self.held.append(held)
                    self.outs.append(outs)
                    self.launches.append(tuple(captured))
                    count("birdnet.stream.captures")
        except InferenceError:
            raise
        except Exception as e:  # noqa: BLE001 - capture refused (a host sync,
            # an unsupported call): the key cannot run on the card
            raise InferenceError(
                f"CUDA graph capture of the streaming tile body failed: {e}") from e

    def run(self, i: int, audio: torch.Tensor):
        """The tile body on slot ``i``'s ``audio``: the slot's graph
        replayed (it reads the device buffer ``audio`` views), or run
        eagerly."""
        with span("birdnet.stream.replay"):
            if not self.graphs:
                return self.body(audio)
            from ..ops.cuda.build import add_launches

            self.graphs[i].replay()
            add_launches(self.launches[i])
            return self.outs[i]


class StreamingEngine:
    """Whole-recording analysis on one explicit device, one superchunk at a
    time with two in flight, one tile program per streaming key."""

    def __init__(
        self,
        imported: ImportedModel,
        config: ModelConfig,
        device=None,
        precision: Optional[str] = None,
        top_k: int = 10,
        tile: Optional[int] = None,
        params=None,
        species_mask=None,
    ):
        from ..runtime import resolve_device

        self.device = (torch.device(device) if device is not None
                       else resolve_device(None))
        on_cuda = self.device.type == "cuda"
        # "fast" (bf16 activations, f32 accumulation) is the streaming
        # default on the card, as on the TPU; fp32 on the host.
        self.precision = precision or ("fast" if on_cuda else "fp32")
        self.config = config
        # max(0, …) like InferenceEngine: top_k=0 behaves identically on the
        # predict and analyze paths.
        self.top_k = max(0, min(top_k, config.num_species))
        self.species_mask = (
            None if species_mask is None else np.asarray(species_mask, bool)
        )
        self._mask_dev = (
            None if self.species_mask is None
            else torch.from_numpy(self.species_mask).to(self.device)
        )
        self.tile = tile if tile is not None else (CUDA_TILE if on_cuda else CPU_TILE)
        self._forward = make_forward(imported, self.precision, self.device)
        # Reuse already-resident params when given (no second device copy
        # when sharing with an InferenceEngine).
        self.params = (
            params if params is not None
            else params_to_torch(imported.params, self.device)
        )
        self.logits_index, self.embed_index = demux_indices(config.model_type)
        # On the card: replay each key's captured graphs (False: run every
        # key's tile body eagerly, the plain version the tests hold them to).
        self._use_graphs = on_cuda
        self._copy_stream = torch.cuda.Stream(self.device) if on_cuda else None
        self._capture_stream = torch.cuda.Stream(self.device) if on_cuda else None
        self._graph_pool = torch.cuda.graph_pool_handle() if on_cuda else None
        self._ring: Optional[_Ring] = None
        self._programs: "OrderedDict[Tuple, _TileProgram]" = OrderedDict()
        self._run_lock = threading.Lock()

    # -- programs ----------------------------------------------------------

    def _program(self, step: int, dtype, with_embeddings: bool = False,
                 with_mask: bool = False) -> _TileProgram:
        """The key's tile program, made (and on the card captured) on first
        use. Called under ``_run_lock``, with no work of the engine in
        flight but that of an abandoned (timed-out, cancelled) call."""
        dtype = np.dtype(dtype)
        key = (self.tile, step, dtype.name, with_embeddings, with_mask, self._use_graphs)
        program = self._programs.get(key)
        if program is not None:
            self._programs.move_to_end(key)
            return program
        from ..ops.cuda.build import one_capture_at_a_time

        nbytes = self.tile * self.config.sample_count * _MAX_ITEMSIZE
        grow = self._ring is None or self._ring.nbytes < nbytes
        with one_capture_at_a_time():
            if grow or len(self._programs) >= MAX_PROGRAMS:
                # What is freed may still be read by an abandoned call's work.
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                if grow:
                    # Every graph reads the old ring's device buffers.
                    self._programs.clear()
                    self._ring = None
                    self._ring = _Ring(nbytes, self.device)
                while len(self._programs) >= MAX_PROGRAMS:
                    self._programs.popitem(last=False)
            program = self._programs[key] = _TileProgram(
                self, self.tile, step, dtype, with_embeddings, with_mask)
        return program

    @property
    def programs(self) -> Dict[Tuple, _TileProgram]:
        """The tile programs the engine keeps, least recently used first, by
        key ``(tile, step, dtype name, with_embeddings, with_mask,
        graphs)``; the last field is False for the plain eager version."""
        return dict(self._programs)

    # -- device side -----------------------------------------------------

    def _run_tiles(self, samples: torch.Tensor, lo: int, n_tiles: int,
                   program: _TileProgram, run_mask):
        """One superchunk: ``n_tiles`` tiles from sample ``lo`` of the host
        recording ``samples`` through the ring and the key's program. Returns ``(conf [n_tiles*tile, k], idx, [emb])`` on the
        device and the event that marks them done (None on the host)."""
        tile, step = program.tile, program.step
        ring = self._ring
        compute = (torch.cuda.current_stream(self.device)
                   if self._copy_stream is not None else None)
        outs = None
        if program.eager:
            count("birdnet.stream.eager_tiles", n_tiles)
        with torch.inference_mode():
            if program.mask is not None:
                program.mask.copy_(run_mask)
            for t in range(n_tiles):
                i = ring.stage(samples, lo + t * tile * step, program)
                result = program.run(i, ring.upload(i, program, self._copy_stream, compute))
                if compute is not None:
                    ring.consumed[i].record(compute)
                if outs is None:
                    outs = tuple(r.new_empty((n_tiles * tile,) + tuple(r.shape[1:]))
                                 for r in result)
                for dest, r in zip(outs, result):
                    dest[t * tile:(t + 1) * tile].copy_(r)
        done = None
        if compute is not None:
            done = torch.cuda.Event()
            done.record(compute)
        return outs, done

    def _drain(self, outs, n: int):
        """The first ``n`` rows of finished device results, on the host.
        On CUDA the copy runs on the copy stream, so it does not queue
        behind the next superchunk's compute."""
        with span("birdnet.stream.drain"):
            if self._copy_stream is None:
                return [_host(o[:n]) for o in outs]
            with torch.cuda.stream(self._copy_stream):
                return [_host(o[:n]) for o in outs]

    # -- execution -------------------------------------------------------

    def analyze(
        self,
        samples: np.ndarray,
        overlap_seconds: float = 0.0,
        options: Optional[InferenceOptions] = None,
        with_embeddings: bool = False,
        n_segments: Optional[int] = None,
        species_mask=None,
    ):
        """Classify every (overlapping) segment of ``samples``.

        ``samples``: 1-D float32 (or int16, uploaded raw and scaled on the
        device). Returns ``(confidences [N, K], indices [N, K],
        start_times [N])``, plus ``embeddings [N, E]`` appended when
        ``with_embeddings`` (v3.0/Perch only), with segments in file order.
        ``species_mask``: optional per-call bool [num_species] mask."""
        with span("birdnet.stream.call"):
            with span("birdnet.stream.lock_wait"):
                self._run_lock.acquire()
            try:
                return streaming_analyze(self, samples, overlap_seconds, options,
                                         with_embeddings, n_segments,
                                         species_mask=species_mask)
            finally:
                self._run_lock.release()

    def warmup(self, n_tiles: int = MAX_TILES, overlap_seconds: float = 0.0,
               dtype=np.float32) -> None:
        """Make (on the card: capture) the program of the key an
        ``analyze`` without embeddings or per-call mask takes at this
        overlap and input dtype and the current ``tile``, so that its first
        call captures nothing, unless the key was dropped in between (by
        more than :data:`MAX_PROGRAMS` keys, or a larger ``tile``'s ring).
        ``n_tiles`` is checked (at least 1) and has no other effect: the key
        has no tile count (the JAX method compiles a program of ``n_tiles``
        tiles)."""
        step = self.config.sample_count - int(overlap_seconds * self.config.sample_rate)
        if step <= 0 or overlap_seconds < 0:
            # Same guard as the JAX method: a never-usable variant.
            raise InferenceError(
                "overlap must be in [0, segment duration) seconds"
            )
        if int(n_tiles) < 1:
            raise InferenceError(f"n_tiles must be at least 1, got {n_tiles}")
        with self._run_lock:
            self._program(step, dtype)


def streaming_analyze(
    eng: StreamingEngine,
    samples: np.ndarray,
    overlap_seconds: float,
    options: Optional[InferenceOptions],
    with_embeddings: bool,
    n_segments: Optional[int],
    species_mask=None,
):
    """The superchunk loop: run each superchunk's tiles through the key's
    program, and drain the older of two superchunks in flight while the
    newer one runs."""
    if with_embeddings and eng.embed_index is None:
        raise InferenceError(
            f"{eng.config.model_type.display_name} does not produce embeddings"
        )
    samples = np.asarray(samples)
    if samples.dtype not in (np.float32, np.int16):
        samples = samples.astype(np.float32)
    S = eng.config.sample_count
    rate = eng.config.sample_rate
    step = S - int(overlap_seconds * rate)
    if step <= 0:
        raise InferenceError("overlap must be smaller than the segment duration")
    n_total = samples.shape[0]
    if n_segments is None and n_total > 0:
        n_segments = -(-n_total // step)
    if not n_total or not n_segments:
        k = max(1, eng.top_k)
        empty = (
            np.zeros((0, k), np.float32),
            np.zeros((0, k), np.int32),
            np.zeros(0),
        )
        if with_embeddings:
            empty = empty + (
                np.zeros((0, eng.config.embedding_dim or 0), np.float32),
            )
        return empty
    monitored = options is not None and options.needs_monitor()
    segs_per_chunk = (MONITORED_MAX_TILES if monitored else MAX_TILES) * eng.tile

    pending = []
    try:
        mask_dev = None
        if species_mask is not None:
            mask_dev = torch.from_numpy(np.asarray(species_mask, dtype=bool)).to(eng.device)
        program = eng._program(step, samples.dtype, with_embeddings, mask_dev is not None)
        with warnings.catch_warnings():
            # A read-only recording (a decoded WAV's buffer) is only read.
            warnings.simplefilter("ignore", UserWarning)
            source = torch.from_numpy(samples)
        for seg0 in range(0, n_segments, segs_per_chunk):
            seg1 = min(seg0 + segs_per_chunk, n_segments)
            n_seg = seg1 - seg0
            started = time.monotonic()
            n_tiles = -(-n_seg // eng.tile)
            outs, done = eng._run_tiles(source, seg0 * step, n_tiles, program, mask_dev)
            count("birdnet.stream.tiles", n_tiles)
            count("birdnet.stream.rows", n_tiles * eng.tile)
            count("birdnet.stream.rows_padded", n_tiles * eng.tile - n_seg)
            pending.append((outs, done, started, n_seg))
            # At most two superchunks in flight: chunk c+1 uploads and runs
            # while chunk c drains. This bounds device memory at two chunks'
            # result buffers, and honours
            # cancellation/timeout between superchunks.
            if len(pending) > 1:
                outs_prev, done_prev, started_prev, n_prev = pending[-2]
                with span("birdnet.stream.wait"):
                    _wait(done_prev, options, started_prev)
                pending[-2] = (eng._drain(outs_prev, n_prev), None, None, n_prev)

        collected = None
        for outs, done, started, n_seg in pending:
            if isinstance(outs, list):  # already drained to the host above
                arrays = outs
            else:
                with span("birdnet.stream.wait"):
                    _wait(done, options, started)
                arrays = eng._drain(outs, n_seg)
            if collected is None:
                collected = [[a] for a in arrays]
            else:
                for dest, a in zip(collected, arrays):
                    dest.append(a)
    except InferenceError:
        raise
    except Exception as e:  # noqa: BLE001 - device runtime failures (OOM, …)
        from ..errors import InferenceCancelledError, InferenceTimeoutError

        if isinstance(e, (InferenceCancelledError, InferenceTimeoutError)):
            raise
        raise InferenceError(str(e)) from e
    start_times = np.arange(n_segments, dtype=np.float64) * (step / rate)
    result = tuple(np.concatenate(parts) for parts in collected)
    return result[:2] + (start_times,) + result[2:]
