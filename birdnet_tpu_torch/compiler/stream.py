"""Streaming whole-recording analysis: segment, classify and select top-K for
an entire recording on the device, reading back only ``[N, K]``.

The counterpart of :mod:`birdnet_tpu.compiler.stream`:

- audio uploads ONCE per superchunk, as int16 (WAV's native width, half
  the bytes; the ``/32768`` scale runs on the device) or float32;
- segments are framed on the device from the uploaded samples, so
  overlapping segments share them;
- a loop over tiles runs the model and the fused sigmoid top-K;
- the host reads back only ``[n_segments, K]`` confidences and indices
  (plus embeddings when asked for).

Differences that follow from eager PyTorch:

- The tile loop is a Python loop of eager forwards under
  ``torch.inference_mode()``; one CUDA graph per key (tiles, step, dtype)
  in place of XLA's scan is later work (ROADMAP A4).
- No bucket padding: XLA padded the tile count to a bucket to bound its
  compile variants; here a superchunk runs ``ceil(n_seg / tile)`` tiles.
  The results are the same rows.
- On CUDA each chunk goes from a pinned staging buffer (one per in-flight
  slot, reused) to the device on a copy stream, and an event orders it
  before its compute. One streaming run at a time per engine: the slots
  are the engine's.

Superchunks bound device memory and the cancellation/timeout granularity:
options are honoured between superchunks, as the reference honours them
between batches.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from .._demux import demux_indices
from ..errors import InferenceError
from ..inference_options import InferenceOptions
from ..types import ModelConfig
from .engine import _host, _wait
from .importer import ImportedModel, make_forward, params_to_torch

# Tiles per superchunk, the JAX package's cap: 96 tiles of 128 segments
# are 10.2 h of 3 s audio (3.5 GB of int16 staging per slot, sized to the
# largest superchunk a run uses).
MAX_TILES = 96

# Superchunk cap when a cancellation/timeout monitor is active: a cancel
# can only strand work already committed to the device, so monitored runs
# dispatch 16-tile superchunks (the reference's RunOptions::terminate stops
# within ~10 ms; this bounds the analogous abandoned work, reference:
# src/classifier.rs:527-554).
MONITORED_MAX_TILES = 16

# Segments per tile. The CPU takes the JAX package's host tile. On the H100
# the full-width `fast` stream ran fastest at 128 of 32, 64 and 128 in both
# frontend forms (PERF.md, streaming): larger tiles spread the eager
# forward's ~600 host calls over more segments.
CPU_TILE = 32
CUDA_TILE = 128

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
    """Device-side audio shape for a superchunk (2-D rows when overlap-free)."""
    if step == S:
        return (n_tiles * tile, S)
    return ((n_tiles * tile - 1) * step + S,)


def chunk_to_device_layout(chunk: np.ndarray, step: int, S: int) -> np.ndarray:
    """Host-side reshape matching :func:`audio_device_shape` (free view)."""
    if step == S:
        return chunk.reshape(-1, S)
    return chunk


class StreamingEngine:
    """Whole-recording analysis on one explicit device, one superchunk at a
    time with two in flight."""

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
        self._copy_stream = torch.cuda.Stream(self.device) if on_cuda else None
        self._staging = [None, None]  # pinned bytes, one buffer per slot
        self._run_lock = threading.Lock()

    # -- device side -----------------------------------------------------

    def _place(self, chunk: np.ndarray, n_tiles: int, step: int, slot: int):
        """``chunk`` zero-padded to ``n_tiles`` tiles' samples, in the
        device layout on the device, and the event its compute must wait
        for (None on the CPU, where the tensor is a view of the padded host
        array). On CUDA the samples go straight into the slot's pinned
        buffer, with the padding zeroed there: the recording is copied once
        on the host."""
        S = self.config.sample_count
        audio_len = (n_tiles * self.tile - 1) * step + S
        if self._copy_stream is None:
            if chunk.shape[0] < audio_len:
                pad = np.zeros(audio_len - chunk.shape[0], dtype=chunk.dtype)
                chunk = np.concatenate([chunk, pad])
            return torch.from_numpy(
                np.ascontiguousarray(chunk_to_device_layout(chunk, step, S))), None
        nbytes = audio_len * chunk.itemsize
        host = self._staging[slot]
        if host is None or host.numel() < nbytes:
            host = self._staging[slot] = torch.empty(nbytes, dtype=torch.uint8,
                                                     pin_memory=True)
        staged = host[:nbytes].view(torch.from_numpy(chunk[:0]).dtype)
        view = staged.numpy()
        view[:chunk.shape[0]] = chunk
        view[chunk.shape[0]:] = 0
        with torch.cuda.stream(self._copy_stream):
            audio = staged.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        # Allocated on the copy stream, read on the compute stream.
        audio.record_stream(torch.cuda.current_stream(self.device))
        return audio.view(audio_device_shape(n_tiles, self.tile, step, S)), ready

    def _run_tiles(self, audio: torch.Tensor, ready, n_tiles: int, step: int,
                   with_embeddings: bool, run_mask):
        """The tile loop over one superchunk: ``(conf [n_tiles*tile, k],
        idx, [emb])`` on the device, and the event that marks them done
        (None on the CPU)."""
        from ..ops.topk import fused_sigmoid_topk

        S, tile, k = self.config.sample_count, self.tile, self.top_k
        parts = []
        with torch.inference_mode():
            if ready is not None:
                torch.cuda.current_stream(self.device).wait_event(ready)
            for t in range(n_tiles):
                frames = prepare_frames(frame_tile(audio, t, tile, step, S),
                                        self.precision)
                outs = self._forward(self.params, frames)
                result = fused_sigmoid_topk(outs[self.logits_index], k,
                                            self._mask_dev, run_mask)
                if with_embeddings:
                    result = result + (outs[self.embed_index],)
                parts.append(result)
            outs = tuple(torch.cat(p) for p in zip(*parts))
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return outs, done

    def _drain(self, outs, n: int):
        """The first ``n`` rows of finished device results, on the host.
        On CUDA the copy runs on the copy stream, so it does not queue
        behind the next superchunk's compute."""
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
        with self._run_lock:
            return streaming_analyze(self, samples, overlap_seconds, options,
                                     with_embeddings, n_segments,
                                     species_mask=species_mask)


def streaming_analyze(
    eng: StreamingEngine,
    samples: np.ndarray,
    overlap_seconds: float,
    options: Optional[InferenceOptions],
    with_embeddings: bool,
    n_segments: Optional[int],
    species_mask=None,
):
    """The superchunk loop: upload, run the tiles, and drain the older of
    two superchunks in flight while the newer one runs."""
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
        for i, seg0 in enumerate(range(0, n_segments, segs_per_chunk)):
            seg1 = min(seg0 + segs_per_chunk, n_segments)
            n_seg = seg1 - seg0
            n_tiles = -(-n_seg // eng.tile)
            lo = seg0 * step
            started = time.monotonic()
            audio, ready = eng._place(samples[lo:lo + (n_tiles * eng.tile - 1) * step + S],
                                      n_tiles, step, i % 2)
            outs, done = eng._run_tiles(audio, ready, n_tiles, step,
                                        with_embeddings, mask_dev)
            pending.append((outs, done, started, n_seg))
            # At most two superchunks in flight: chunk c+1 uploads and runs
            # while chunk c drains. This bounds device memory at two chunk
            # buffers (and the staging slots at two), and honours
            # cancellation/timeout between superchunks.
            if len(pending) > 1:
                outs_prev, done_prev, started_prev, n_prev = pending[-2]
                _wait(done_prev, options, started_prev)
                pending[-2] = (eng._drain(outs_prev, n_prev), None, None, n_prev)

        collected = None
        for outs, done, started, n_seg in pending:
            if isinstance(outs, list):  # already drained to the host above
                arrays = outs
            else:
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
