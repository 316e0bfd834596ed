"""Buffer-reusing batch inference context.

The counterpart of :mod:`birdnet_tpu.batch_context`. The reference's
``BatchInferenceContext`` wraps an ONNX Runtime IoBinding with a
pre-allocated host input buffer, so repeated batches run with zero
allocation (reference: src/batch_context.rs:69-122). On the card:

- two pinned host staging buffers of ``max_batch × sample_count`` float32,
  used alternately (the ``input_buffer`` analog, batch_context.rs:122): the
  buffer handed to the device on one call is not refilled until two calls
  later, by which time its results have been read back;
- one device input buffer ``[max_batch, S]`` and one device buffer of
  per-request species masks ``[max_batch, num_species]``;
- one CUDA graph of the forward, the fused sigmoid top-K (which reads the
  mask buffer) and, for v3.0, the embeddings, captured when the context is
  made at ``[max_batch, S]`` after a warm-up on a side stream: the
  counterpart of the JAX package's one fixed-shape donated executable.
  A call copies the staged batch and its masks into the device buffers on
  the current stream and replays the graph, so the interpreter's host work
  (some 600 eager calls per forward) is not repeated;
- short batches are padded to ``max_batch`` and the results sliced, so one
  graph serves every batch size.

If the capture fails, making the context raises :class:`InferenceError`;
a context never runs eagerly on the card. Kernel wrappers count their
launches while the graph is captured; a replay runs the captured kernels
without passing through them.

On the host the context keeps the same staging buffers (not pinned) and
runs the plain eager forward on the padded batch, with no graph. Over a
mesh of cards (``with_mesh``) it replays the engine's program of its
maximum batch (``ShardedEngine.compiled``: one graph per card and the
merge, parallel/graphs.py), captured when the context is made, with the
row-mask program too under ``precompile_row_mask`` (the two executables
the JAX context compiles); the program copies the pinned staging buffer
straight into its per-card inputs. A program that cannot be captured
raises :class:`InferenceError` here too, a forward that reads the card on
the host included. Over a host mesh it runs the sharded step eagerly.

Reference quirks preserved: Perch v2 rejected (batch_context.rs:107-114),
batch-exceeds-max error (batch_context.rs:191-196), per-segment size errors
with index (batch_context.rs:198-206), and the buffer-introspection API
(batch_context.rs:147-159).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from .errors import BatchInputSizeError, InferenceError, RuntimeInitError
from .inference_options import InferenceOptions
from .types import ModelConfig, ModelType

# Eager forwards on a side stream before the capture: they build the CUDA
# kernels and fill the lazy per-device caches (the frontend kernels' packed
# operands, B4's weight tables, the STFT basis, host constants uploaded
# once), so the capture meets no host-to-device copy and no sync.
_WARMUP_CALLS = 2


class BatchInferenceContext:
    """Pre-allocated buffers (and, on the card, one captured CUDA graph)
    for repeated batched inference."""

    def __init__(
        self,
        engine,
        config: ModelConfig,
        max_batch_size: int,
        precompile_row_mask: bool = False,
    ):
        if config.model_type is ModelType.PERCH_V2:
            raise InferenceError(
                "BatchInferenceContext does not yet support PerchV2 models. "
                "Use predict_batch() instead."
            )
        if max_batch_size < 1:
            raise InferenceError("max_batch_size must be >= 1")
        self._engine = engine
        self._config = config
        self._max_batch_size = int(max_batch_size)
        self._with_embeddings = config.model_type is not ModelType.BIRDNET_V24
        self._lock = threading.Lock()
        on_cuda = engine.device.type == "cuda"
        if on_cuda and not torch.cuda.is_available():
            raise RuntimeInitError(
                f"batch context on {engine.device} but "
                f"torch.cuda.is_available() is false"
            )
        # Double-buffered staging: zero per-call allocation (the reference's
        # IoBinding exists precisely to avoid per-call allocation,
        # batch_context.rs:122, :188-226). Pinned on the card, so the copy
        # to the device input buffer is asynchronous.
        shape = (self._max_batch_size, config.sample_count)
        self._staging = tuple(
            torch.zeros(shape, dtype=torch.float32, pin_memory=on_cuda)
            for _ in range(2)
        )
        self._buffers = tuple(t.numpy() for t in self._staging)
        self._active = 0
        self._staged = 0
        self._sharded = getattr(engine, "mesh", None) is not None
        if self._sharded:
            self._graph = None
            if engine._on_card:
                # The engine's programs of this batch, as the JAX context
                # precompiles its executables.
                keys = [False, True] if precompile_row_mask else [False]
                programs = [engine.compiled(self._max_batch_size, self._with_embeddings,
                                            donate=True, with_row_mask=masked)
                            for masked in keys]
                if any(p.eager for p in programs):
                    raise InferenceError(
                        "CUDA graph capture of the mesh step failed: the forward "
                        "reads the card on the host")
                self._graph = programs[0]
        else:
            # Every per-request species mask goes through one device buffer
            # that the graph reads, so ``precompile_row_mask`` (the JAX
            # package's second, masked executable) needs nothing more here.
            self._graph = (_CapturedBatch(engine, shape, self._with_embeddings)
                           if on_cuda else None)

    # -- introspection (batch_context.rs:147-159 analog) -------------------

    @property
    def max_batch_size(self) -> int:
        return self._max_batch_size

    @property
    def graph(self):
        """The captured forward on the card (over a mesh, the engine's
        program of the context's batch); None on the host."""
        return self._graph

    def input_buffer_bytes(self) -> int:
        return int(self._buffers[0].nbytes)

    def output_buffer_bytes(self) -> int:
        logits = self._max_batch_size * self._config.num_species * 4
        emb = (
            self._max_batch_size * (self._config.embedding_dim or 0) * 4
        )
        topk = self._max_batch_size * self._engine.top_k * 8
        return logits + emb + topk

    def total_buffer_bytes(self) -> int:
        return self.input_buffer_bytes() + self.output_buffer_bytes()

    # -- input staging -------------------------------------------------------

    def prepare_input(self, segments) -> Tuple[np.ndarray, int]:
        """Validate + copy segments into the active staging buffer
        (reference: batch_context.rs:188-226). Returns (the padded staging
        buffer itself — no copy is made — and the actual batch size).

        The two staging buffers alternate across calls, so the array handed
        to the device on one call is not touched again until two calls
        later; by then its results have been read back to host."""
        segs: List[np.ndarray] = [
            np.asarray(s, dtype=np.float32).reshape(-1) for s in segments
        ]
        b = len(segs)
        if b > self._max_batch_size:
            raise InferenceError(
                f"batch size {b} exceeds context max {self._max_batch_size}"
            )
        sample_count = self._config.sample_count
        self._staged = self._active
        buf = self._buffers[self._active]
        self._active ^= 1
        for i, s in enumerate(segs):
            if s.shape[0] != sample_count:
                raise BatchInputSizeError(
                    index=i, expected=sample_count, got=s.shape[0]
                )
            buf[i, :] = s
        if b < self._max_batch_size:
            buf[b:, :] = 0.0
        return buf, b

    def clear_inputs(self) -> None:
        """Zero the staging buffers (reference: batch_context.rs:284-286)."""
        for buf in self._buffers:
            buf[:] = 0.0

    # -- execution -------------------------------------------------------------

    def run(self, n_valid: int, options: Optional[InferenceOptions] = None,
            row_masks: Optional[np.ndarray] = None):
        """Run the batch the last :meth:`prepare_input` staged (its first
        ``n_valid`` rows real). ``row_masks``: optional bool
        ``[n_valid, num_species]``. Returns numpy (conf [n,k], idx [n,k],
        logits [n,N], embeddings [n,E] or None), as
        ``InferenceEngine.run_batch`` does."""
        with self._lock:
            if self._sharded:
                # Over cards the program stages the pinned buffer itself.
                return self._engine.run_batch(
                    self._staging[self._staged] if self._graph is not None
                    else self._buffers[self._staged], options=options,
                    with_embeddings=self._with_embeddings, donate=True,
                    row_masks=row_masks, n_valid=n_valid,
                )
            if self._graph is None:
                return self._engine.run_batch(
                    self._buffers[self._staged], options=options,
                    with_embeddings=self._with_embeddings,
                    row_masks=row_masks, n_valid=n_valid,
                )
            return self._graph.run(self._staging[self._staged], n_valid, options, row_masks)


class _CapturedBatch:
    """The forward + fused top-K (+ embeddings) at ``[max_batch, S]``,
    captured once into a CUDA graph over static device buffers."""

    def __init__(self, engine, shape, with_embeddings: bool):
        from .ops.cuda.build import holding, one_capture_at_a_time
        from .utils.collector import collector_paused
        from .ops.topk import fused_sigmoid_topk

        self._engine = engine
        device = engine.device
        n_species = engine.config.num_species
        self.x = torch.zeros(shape, dtype=torch.float32, device=device)
        self.rows = torch.ones((shape[0], n_species), dtype=torch.bool, device=device)
        self._rows_host = torch.ones((shape[0], n_species), dtype=torch.bool,
                                     pin_memory=True)
        self._rows_all_true = True
        embed = engine.embed_index if with_embeddings else None

        def step():
            outs = engine._forward(engine.params, self.x)
            logits = outs[engine.logits_index]
            if engine.top_k > 0:
                conf, idx = fused_sigmoid_topk(logits, engine.top_k,
                                               engine.species_mask, self.rows)
            else:
                conf = logits.new_zeros((logits.shape[0], 0))
                idx = torch.zeros((logits.shape[0], 0), dtype=torch.int32,
                                  device=device)
            return conf, idx, logits, (outs[embed] if embed is not None else None)

        try:
            with one_capture_at_a_time():
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side), torch.inference_mode():
                    for _ in range(_WARMUP_CALLS):
                        step()
                torch.cuda.current_stream(device).wait_stream(side)
                torch.cuda.synchronize(device)
                self.graph = torch.cuda.CUDAGraph()
                # The graph keeps the cached operands it reads
                # (``build.hold``). Thread-local: other threads' calls go on.
                with holding() as self._held, collector_paused(), \
                        torch.cuda.graph(self.graph, stream=side,
                                         capture_error_mode="thread_local"), \
                        torch.inference_mode():
                    self.outs = step()
        except Exception as e:  # noqa: BLE001 - capture refused (a host sync,
            # an unsupported call): the context cannot exist on the card
            raise InferenceError(f"CUDA graph capture of the batch forward failed: {e}") from e

    def run(self, staged: torch.Tensor, n_valid: int,
            options: Optional[InferenceOptions], row_masks):
        from .compiler.engine import _host, _wait
        from .errors import InferenceCancelledError, InferenceTimeoutError

        device = self.x.device
        try:
            stream = torch.cuda.current_stream(device)
            self.x.copy_(staged, non_blocking=True)
            if row_masks is not None:
                self._rows_host[:n_valid] = torch.from_numpy(np.asarray(row_masks, bool))
                self._rows_host[n_valid:] = True
                self.rows.copy_(self._rows_host, non_blocking=True)
                self._rows_all_true = False
            elif not self._rows_all_true:
                self.rows.fill_(True)
                self._rows_all_true = True
            self.graph.replay()
            done = torch.cuda.Event()
            done.record(stream)
            _wait(done, options)
            conf, idx, logits, emb = self.outs
            result = tuple(_host(t[:n_valid]) for t in (conf, idx, logits))
            emb = _host(emb[:n_valid]) if emb is not None else None
        except (InferenceCancelledError, InferenceTimeoutError):
            raise
        except Exception as e:  # noqa: BLE001 - device runtime failures
            raise InferenceError(str(e)) from e
        return result + (emb,)
